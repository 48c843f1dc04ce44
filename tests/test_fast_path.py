"""The int8 fast paths must agree exactly with the generic path."""

import jax.numpy as jnp
import numpy as np
import pytest

from tfhe_fbs_map_tpu.ops.blind_rotate import (external_product_fast,
                                               functional_bootstrap_fast,
                                               key_bytes, pick_orientation,
                                               prepare_fast_keys,
                                               toeplitz_rows)
from tfhe_fbs_map_tpu.ops.polymul import negacyclic_matrix
from tfhe_fbs_map_tpu.tfhe import (TEST_PARAMS, TFHEParams,
                                   build_test_vector, decrypt_values,
                                   encrypt_values, external_product,
                                   functional_bootstrap, generate_keys)


@pytest.fixture(scope="module")
def keys():
    return generate_keys(TEST_PARAMS, seed=13)


@pytest.fixture(scope="module", params=["matmul", "compact"])
def fast(request, keys):
    return prepare_fast_keys(keys, orientation=request.param)


def test_external_product_conv_matches_generic(keys, fast):
    rng = np.random.default_rng(0)
    p = TEST_PARAMS
    diff = rng.integers(0, 1 << 32, (5, p.glwe_dim + 1, p.poly_size),
                        dtype=np.uint32).astype(np.int32)
    diff = jnp.asarray(diff)
    for i in (0, 3, p.lwe_dim - 1):
        want = external_product(diff, keys.bsk[i], p)
        got = external_product_fast(diff, fast.bsk_kernels[i], p,
                                    fast.orientation)
        assert np.array_equal(np.asarray(want).astype(np.uint32),
                              np.asarray(got).astype(np.uint32)), i


def _bootstrap_pair(keys, fast, table, values, rng):
    p = keys.params
    cts = encrypt_values(keys, values, rng)
    tv, post = build_test_vector(table, p)
    tvs = jnp.broadcast_to(jnp.asarray(tv), (len(values), p.poly_size))
    posts = jnp.full((len(values),), np.int32(post))
    want = functional_bootstrap(keys, cts, tvs, posts)
    got = functional_bootstrap_fast(fast, cts, tvs, posts)
    return want, got


def test_fast_bootstrap_matches_generic(keys, fast):
    table = [0, 1, 1, 0, 1]
    want, got = _bootstrap_pair(keys, fast, table, np.arange(len(table)),
                                np.random.default_rng(1))
    # identical ciphertexts: both paths are exact mod 2^32
    assert np.array_equal(np.asarray(want).astype(np.uint32),
                          np.asarray(got).astype(np.uint32))
    assert np.array_equal(decrypt_values(keys, got), np.asarray(table))


@pytest.mark.parametrize("N", [512, 1024, 2048])
def test_toeplitz_rows_matches_negacyclic_matrix(N):
    rng = np.random.default_rng(N)
    polys = jnp.asarray(rng.integers(-128, 128, (2, 3, N)), jnp.int32)
    ext = jnp.concatenate([-polys, polys], axis=-1)
    assert np.array_equal(np.asarray(toeplitz_rows(ext)),
                          np.asarray(negacyclic_matrix(polys)))


@pytest.mark.parametrize("N,k", [(512, 2), (1024, 1), (2048, 1)])
def test_compact_bootstrap_real_poly_sizes(N, k):
    """Compact keys at the production ring sizes (small n keeps the
    generic reference affordable on the CPU)."""
    params = TFHEParams(p=4, lwe_dim=3, glwe_dim=k, poly_size=N,
                        bsk_level=2, bsk_base_log=8, ksk_level=3,
                        ksk_base_log=4, lwe_noise_std=4.0,
                        glwe_noise_std=4.0)
    keys = generate_keys(params, seed=N)
    fast = prepare_fast_keys(keys, orientation="compact")
    assert fast.bsk_kernels.shape == (3, 4 * (k + 1), 2 * (k + 1), 2 * N)
    table = [1, 0, 1, 1]
    want, got = _bootstrap_pair(keys, fast, table, np.arange(4),
                                np.random.default_rng(2))
    assert np.array_equal(np.asarray(want).astype(np.uint32),
                          np.asarray(got).astype(np.uint32))


def _family(n, k, N, l, b=8):
    return TFHEParams(p=4, lwe_dim=n, glwe_dim=k, poly_size=N, bsk_level=l,
                      bsk_base_log=b, ksk_level=4, ksk_base_log=3,
                      lwe_noise_std=1.0, glwe_noise_std=1.0)


def test_key_bytes_of_the_bench_families():
    anchor = _family(546, 2, 512, 2)
    p32 = _family(706, 1, 2048, 3)
    assert key_bytes(anchor, "matmul") == 546 * 4 * 3072 * 1536   # 10.3 GB
    assert key_bytes(anchor, "compact") == 546 * 4 * 3 * 6 * 1024
    assert key_bytes(p32, "matmul") > 140e9                       # > 80 GB
    assert key_bytes(p32, "compact") < 0.2e9


@pytest.mark.parametrize("backend,mem,want", [
    ("cpu", 60e9, None),          # the generic path off the GPU
    ("gpu", 60e9, "matmul"),      # 10.3 GB of matrices fit
    ("gpu", 12e9, "compact"),     # ... but not in 60% of 12 GB
])
def test_pick_orientation_backend_and_memory(backend, mem, want):
    assert pick_orientation([_family(546, 2, 512, 2)], backend, mem) == want


def test_pick_orientation_counts_every_family_held_at_once():
    fam1, fam2 = _family(674, 1, 1024, 3), _family(674, 2, 512, 4)
    mem = 60e9
    assert pick_orientation([fam1], "gpu", mem) == "matmul"
    assert pick_orientation([fam2], "gpu", mem) == "matmul"
    # 34 GB + 25 GB of matrices do not fit together
    assert pick_orientation([fam1, fam2], "gpu", mem) == "compact"
    # digits wider than int8 leave only the generic path
    assert pick_orientation([_family(546, 2, 512, 1, b=10)], "gpu",
                            mem) is None


@pytest.mark.gpu
@pytest.mark.parametrize("N,k", [(512, 2), (2048, 1)])
def test_fast_paths_compiled_for_the_card(gpu, N, k):
    """Both key forms, compiled by XLA for the GPU (cuBLAS int8 GEMMs),
    against the generic path at production ring sizes."""
    params = TFHEParams(p=4, lwe_dim=8, glwe_dim=k, poly_size=N,
                        bsk_level=3, bsk_base_log=7, ksk_level=4,
                        ksk_base_log=3, lwe_noise_std=4.0, glwe_noise_std=4.0)
    keys = generate_keys(params, seed=7)
    for orientation in ("matmul", "compact"):
        fast = prepare_fast_keys(keys, orientation=orientation)
        want, got = _bootstrap_pair(keys, fast, [0, 1, 1, 0],
                                    np.arange(4).repeat(16),
                                    np.random.default_rng(3))
        assert np.array_equal(np.asarray(want).astype(np.uint32),
                              np.asarray(got).astype(np.uint32))
