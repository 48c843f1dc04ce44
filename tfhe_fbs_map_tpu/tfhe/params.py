"""TFHE parameter sets for the device executor.

The ciphertext modulus is fixed to ``q = 2**32``: torus elements are native
int32 values and every add/mul wraps exactly — the representation int8
tensor cores and int32 vector units execute at full rate (the reference's
Concrete backend uses q=2**64 f64-FFT arithmetic, a CPU design point).

Security: ``min_noise_std_rel`` encodes the standard 128-bit lattice hardness
curve ``log2(sigma/q) ~= -0.0245 * n`` (the line through the classic TFHE
parameter points n=630 -> 2^-15 and n=1024 -> 2^-25).  The parameter
optimizer (:mod:`tfhe_fbs_map_tpu.optimizer`) picks sets along this curve;
the fixed sets below are hand-validated anchors.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

Q_BITS = 32
Q = 1 << Q_BITS


def min_noise_std_rel(n: int) -> float:
    """Minimal relative noise std for ~128-bit security at LWE dimension n."""
    return max(2.0 ** (-0.0245 * n), 2.0 ** (-31))


@dataclass(frozen=True)
class TFHEParams:
    """All sizes for one functional-bootstrap configuration."""

    p: int                  # plaintext divisions (FBS size / precision)
    lwe_dim: int            # n  — small LWE dimension (blind-rotate length)
    glwe_dim: int           # k
    poly_size: int          # N  — power of two
    bsk_level: int          # gadget levels of the bootstrapping key
    bsk_base_log: int       # log2 of the bootstrapping gadget base
    ksk_level: int          # gadget levels of the key-switch key
    ksk_base_log: int       # log2 of the key-switch gadget base
    lwe_noise_std: float    # absolute std (torus units out of q) of small key
    glwe_noise_std: float   # absolute std of GLWE encryptions

    @property
    def big_dim(self) -> int:
        """Dimension of the sample-extracted (wire-level) LWE key."""
        return self.glwe_dim * self.poly_size

    @property
    def delta(self) -> int:
        """Plaintext scaling: one message step on the torus (q / 2p)."""
        return int(round(Q / (2 * self.p)))

    @property
    def half_window(self) -> int:
        """Decision margin: the max |noise| decodable without error."""
        return self.delta // 2

    def with_p(self, p: int) -> "TFHEParams":
        return replace(self, p=p)


# ---------------------------------------------------------------------------
# Anchor parameter sets
# ---------------------------------------------------------------------------

# Tiny, insecure, fast: CI and CPU differential tests. Noise is still
# non-zero so encodings/rounding paths are genuinely exercised.
TEST_PARAMS = TFHEParams(
    p=4, lwe_dim=16, glwe_dim=1, poly_size=256,
    bsk_level=3, bsk_base_log=7, ksk_level=4, ksk_base_log=4,
    lwe_noise_std=2.0 ** 7, glwe_noise_std=2.0 ** 4,
)

# Classic TFHE-library point (n=630, sigma=2^-15 q; N=1024, sigma=2^-25 q):
# ~128-bit security, supports p <= 8 comfortably with 4-sigma margins.
DEFAULT_PARAMS = TFHEParams(
    p=4, lwe_dim=630, glwe_dim=1, poly_size=1024,
    bsk_level=3, bsk_base_log=7, ksk_level=5, ksk_base_log=3,
    lwe_noise_std=2.0 ** (Q_BITS - 15.0), glwe_noise_std=2.0 ** (Q_BITS - 25.0),
)

# Smaller-N variant whose bootstrapping-key negacyclic matrices fit HBM for
# the precomputed-matmul fast path (see ops/polymul.py).
FAST_PARAMS = TFHEParams(
    p=4, lwe_dim=630, glwe_dim=2, poly_size=512,
    bsk_level=2, bsk_base_log=8, ksk_level=5, ksk_base_log=3,
    lwe_noise_std=2.0 ** (Q_BITS - 15.0), glwe_noise_std=2.0 ** (Q_BITS - 25.0),
)
