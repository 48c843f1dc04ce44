// TFHE parameter optimizer — native grid-search core.
//
// C++ counterpart of tfhe_fbs_map_tpu/optimizer/optimizer.py (the role the
// patched Rust concrete-optimizer plays in the reference pipeline,
// experiments/concrete.patch).  The Python module is the reference
// implementation; this core exists for harness-scale sweeps where thousands
// of (precision, norm2) cells are costed.  Exposed via a C ABI for ctypes.
//
// Build:  g++ -O3 -shared -fPIC -o liboptimizer.so optimizer.cpp
//
// The noise model must stay in lockstep with optimizer/noise.py; the
// differential test tests/test_native_optimizer.py enforces agreement.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

constexpr double Q = 4294967296.0;  // 2^32

double min_noise_std_rel(int n) {
  double v = std::pow(2.0, -0.0245 * n);
  double floor_v = std::pow(2.0, -31);
  return v > floor_v ? v : floor_v;
}

double var_blind_rotate(int n, int k, int N, int l, int base_log,
                        double glwe_std) {
  double b = double(1u << base_log);
  double beta2 = std::pow(b, 2.0 * l);
  double key_term =
      double(n) * l * (k + 1) * N * ((b * b + 2.0) / 12.0) * glwe_std * glwe_std;
  double round_term = double(n) * (1.0 + double(k) * N) / 2.0 * (Q * Q) /
                      (12.0 * beta2);
  return key_term + round_term;
}

double var_keyswitch(int k, int N, int l, int base_log, double lwe_std) {
  double kn = double(k) * N;
  double b = double(1u << base_log);
  double key_term = kn * l * ((b * b) / 12.0) * lwe_std * lwe_std;
  double bl = std::pow(b, double(l));
  double round_term = kn * (Q / bl) * (Q / bl) / 24.0;
  return key_term + round_term;
}

double var_modswitch(int n, int N) {
  double w = Q / (2.0 * N);
  return w * w * (1.0 + n / 2.0) / 12.0;
}

// BSK limb-drop quantization noise: error on the raw key values, so the
// GGSW mask-part error is multiplied by the secret key at decryption —
// the (1 + kN/2) amplification (see optimizer/noise.py, calibrated).
double var_bsk_quantization(int n, int k, int N, int l, int base_log,
                            int dropped_limbs) {
  if (dropped_limbs == 0) return 0.0;
  double b = double(1u << base_log);
  double err_w = std::pow(2.0, 8.0 * dropped_limbs);
  double per_product = ((b * b) / 12.0) * (err_w * err_w / 12.0);
  double mask_amp = 1.0 + double(k) * N / 2.0;
  return double(n) * l * (k + 1) * N * per_product * mask_amp;
}

double p_error_atomic(int p, double sq_norm2, int n, int k, int N, int br_l,
                      int br_b, int ks_l, int ks_b, double lwe_std,
                      double glwe_std, int dropped_limbs) {
  double v_wire = var_blind_rotate(n, k, N, br_l, br_b, glwe_std) +
                  var_bsk_quantization(n, k, N, br_l, br_b, dropped_limbs);
  double v_total = sq_norm2 * v_wire + var_keyswitch(k, N, ks_l, ks_b, lwe_std) +
                   var_modswitch(n, N);
  double sigma = std::sqrt(v_total);
  double margin = Q / (4.0 * p);
  if (sigma == 0.0) return 0.0;
  return std::erfc(margin / (sigma * std::sqrt(2.0)));
}

// NVIDIA H100 SXM roofline (mirror of optimizer.py; source and values in
// tfhe_fbs_map_tpu/optimizer/device.py): int8 tensor cores + HBM.
constexpr double INT8_OPS = 1979e12;
constexpr double HBM_BYTES = 3.35e12;

double bootstrap_cost_us(int n, int k, int N, int br_l, int ks_l,
                         int bsk_limbs) {
  double br_macs =
      double(n) * (k + 1) * (k + 1) * br_l * N * N * double(bsk_limbs);
  double ks_macs = double(k) * N * ks_l * (n + 1) * 4.0;
  double compute_s = 2.0 * (br_macs + ks_macs) / INT8_OPS;
  double acc_bytes = double(n) * 3.0 * (k + 1) * N * 4.0;
  double mem_s = acc_bytes / HBM_BYTES;
  return (compute_s > mem_s ? compute_s : mem_s) * 1e6;
}

// ---------------------------------------------------------------------------
// Staged multi-digit pipeline search (mirror of optimizer.py
// optimize_staged; tfhe/staged.py design).  Enumeration order and pruning
// match the Python reference exactly so results are bit-identical.
// ---------------------------------------------------------------------------

constexpr int SELECT_P = 8;

double p_error_from_var(int p, double v_total) {
  if (v_total <= 0.0) return 0.0;
  return std::erfc((Q / (4.0 * p)) / (std::sqrt(v_total) * std::sqrt(2.0)));
}

struct Cand {
  double cost, vw, ks, ms;
  int k, N, bl, bb, kl, kb;
};

void staged_candidates(int n, int min_N, int big_dim, std::vector<Cand>& out) {
  double lwe_std = min_noise_std_rel(n) * Q;
  const int ks_choices[2] = {1, 2};
  for (int k : ks_choices) {
    if (big_dim % k) continue;
    int N = big_dim / k;
    if (N < 2 * SELECT_P || N < min_N) continue;
    double g = min_noise_std_rel(k * N) * Q;
    double ms = var_modswitch(n, N);
    double best_v[9];
    int best_kb[9];
    for (int kl = 1; kl <= 8; ++kl) best_v[kl] = 1e300, best_kb[kl] = 0;
    for (int kb = 2; kb <= 8; ++kb)
      for (int kl = 1; kl <= 8; ++kl) {
        if (kb * kl > 32) continue;
        double v = var_keyswitch(k, N, kl, kb, lwe_std);
        if (v < best_v[kl]) best_v[kl] = v, best_kb[kl] = kb;
      }
    for (int bb = 4; bb <= 8; ++bb)
      for (int bl = 1; bl <= 5; ++bl) {
        double vw = var_blind_rotate(n, k, N, bl, bb, g);
        for (int kl = 1; kl <= 8; ++kl) {
          if (!best_kb[kl]) continue;
          out.push_back({bootstrap_cost_us(n, k, N, bl, kl, 4), vw,
                         best_v[kl], ms, k, N, bl, bb, kl, best_kb[kl]});
        }
      }
  }
  std::stable_sort(out.begin(), out.end(),
                   [](const Cand& a, const Cand& b) { return a.cost < b.cost; });
}

}  // namespace

extern "C" {

// Individual model functions, exported so the lockstep test can compare
// them pointwise against optimizer/noise.py (not just optimize() outcomes,
// where a compensating-error pair could hide).
double nv_var_blind_rotate(int32_t n, int32_t k, int32_t N, int32_t l,
                           int32_t base_log, double glwe_std) {
  return var_blind_rotate(n, k, N, l, base_log, glwe_std);
}
double nv_var_keyswitch(int32_t k, int32_t N, int32_t l, int32_t base_log,
                        double lwe_std) {
  return var_keyswitch(k, N, l, base_log, lwe_std);
}
double nv_var_modswitch(int32_t n, int32_t N) { return var_modswitch(n, N); }
double nv_var_bsk_quantization(int32_t n, int32_t k, int32_t N, int32_t l,
                               int32_t base_log, int32_t dropped_limbs) {
  return var_bsk_quantization(n, k, N, l, base_log, dropped_limbs);
}
double nv_p_error_atomic(int32_t p, double sq_norm2, int32_t n, int32_t k,
                         int32_t N, int32_t br_l, int32_t br_b, int32_t ks_l,
                         int32_t ks_b, double lwe_std, double glwe_std,
                         int32_t dropped_limbs) {
  return p_error_atomic(p, sq_norm2, n, k, N, br_l, br_b, ks_l, ks_b,
                        lwe_std, glwe_std, dropped_limbs);
}
double nv_bootstrap_cost_us(int32_t n, int32_t k, int32_t N, int32_t br_l,
                            int32_t ks_l, int32_t bsk_limbs) {
  return bootstrap_cost_us(n, k, N, br_l, ks_l, bsk_limbs);
}

struct Solution {
  int32_t lwe_dim, glwe_dim, poly_size;
  int32_t bsk_level, bsk_base_log, ksk_level, ksk_base_log;
  double lwe_noise_std, glwe_noise_std;
  double cost_us, p_error;
  int32_t bsk_limbs;
};

// Returns 1 and fills *out on success, 0 if no parameter set meets the
// error target.
int32_t optimize_params(int32_t p, double sq_norm2, double max_p_error,
                        int32_t fast_path_only, Solution* out) {
  static const int glwe_shapes[][2] = {{1, 1024}, {2, 512},  {1, 2048},
                                       {2, 1024}, {3, 512},  {4, 512},
                                       {2, 2048}, {1, 4096}};
  // int8 digits (fast path) need base <= 2^8; generic fallback goes wider
  const int max_base = fast_path_only ? 8 : 12;
  // limb-drop quantization is a fast-path key layout knob only
  const int max_drop = fast_path_only ? 1 : 0;
  bool found = false;
  double best_cost = 1e300;

  for (const auto& kn : glwe_shapes) {
    int k = kn[0], N = kn[1];
    if (N < 2 * p) continue;
    double glwe_std = min_noise_std_rel(k * N) * Q;
    for (int n = 450; n < 1100; n += 32) {
      double lwe_std = min_noise_std_rel(n) * Q;
      for (int br_b = 4; br_b <= max_base; ++br_b) {
        for (int br_l = 1; br_l <= 4; ++br_l) {
          if (br_b * br_l > 32) continue;
          for (int ks_b = 2; ks_b <= max_base; ++ks_b) {
            for (int ks_l = 1; ks_l <= 8; ++ks_l) {
              if (ks_b * ks_l > 32) continue;
              for (int drop = 0; drop <= max_drop; ++drop) {
                double cost = bootstrap_cost_us(n, k, N, br_l, ks_l,
                                                4 - drop);
                if (found && cost >= best_cost) continue;
                double perr =
                    p_error_atomic(p, sq_norm2, n, k, N, br_l, br_b, ks_l,
                                   ks_b, lwe_std, glwe_std, drop);
                if (perr > max_p_error) continue;
                found = true;
                best_cost = cost;
                out->lwe_dim = n;
                out->glwe_dim = k;
                out->poly_size = N;
                out->bsk_level = br_l;
                out->bsk_base_log = br_b;
                out->ksk_level = ks_l;
                out->ksk_base_log = ks_b;
                out->lwe_noise_std = lwe_std;
                out->glwe_noise_std = glwe_std;
                out->cost_us = cost;
                out->p_error = perr;
                out->bsk_limbs = 4 - drop;
              }
            }
          }
        }
      }
    }
  }
  return found ? 1 : 0;
}

struct StagedSolutionC {
  // family 1 (stage-1 grid p/2, or p itself when p < 32)
  int32_t p1, n, k1, N1, bl1, bb1, kl1, kb1;
  // family 2 (select grid, p = 8)
  int32_t p2, k2, N2, bl2, bb2, kl2, kb2;
  double lwe_noise_std, glwe1_noise_std, glwe2_noise_std;
  double cost_us, p_error;
};

// Mirror of optimizer.py optimize_staged (bit-identical enumeration).
int32_t optimize_staged_params(int32_t p, double sq_norm1, double sq_norm2,
                               double max_p_error, int32_t big_dim,
                               int32_t wires_from_stage2, double weight1,
                               double weight2, StagedSolutionC* out) {
  if (p % 2 || p < 8) return 0;
  const int stage1_p = p >= 2 * SELECT_P * 2 ? p / 2 : p;
  const int select_p = p % SELECT_P == 0 ? SELECT_P : p / 2;
  bool found = false;
  double best_cost = 1e300;
  for (int n = 450; n < 1100; n += 32) {
    double lwe_std = min_noise_std_rel(n) * Q;
    std::vector<Cand> c2s, c1s;
    staged_candidates(n, 2 * select_p, big_dim, c2s);
    staged_candidates(n, 2 * stage1_p, big_dim, c1s);
    if (c2s.empty() || c1s.empty()) continue;
    double min_c1 = c1s.front().cost;
    for (const Cand& c2 : c2s) {
      if (found && weight2 * c2.cost + weight1 * min_c1 >= best_cost) break;
      for (const Cand& c1 : c1s) {
        double tot = weight1 * c1.cost + weight2 * c2.cost;
        if (found && tot >= best_cost) break;
        double vw = wires_from_stage2 ? c2.vw
                                      : (c1.vw > c2.vw ? c1.vw : c2.vw);
        double e1 = p_error_from_var(stage1_p, sq_norm1 * vw + c1.ks + c1.ms);
        if (e1 > max_p_error) continue;
        double e2 = p_error_from_var(
            select_p, c1.vw + sq_norm2 * vw + c2.ks + c2.ms);
        if (e2 > max_p_error) continue;
        found = true;
        best_cost = tot;
        out->p1 = stage1_p;
        out->n = n;
        out->k1 = c1.k, out->N1 = c1.N, out->bl1 = c1.bl, out->bb1 = c1.bb;
        out->kl1 = c1.kl, out->kb1 = c1.kb;
        out->p2 = select_p;
        out->k2 = c2.k, out->N2 = c2.N, out->bl2 = c2.bl, out->bb2 = c2.bb;
        out->kl2 = c2.kl, out->kb2 = c2.kb;
        out->lwe_noise_std = lwe_std;
        out->glwe1_noise_std = min_noise_std_rel(c1.k * c1.N) * Q;
        out->glwe2_noise_std = min_noise_std_rel(c2.k * c2.N) * Q;
        out->cost_us = tot;
        out->p_error = e1 + e2;
        break;  // c1s is cost-sorted: first feasible is best for this c2
      }
    }
  }
  return found ? 1 : 0;
}

}  // extern "C"
