"""Peak rates of the accelerators this repository is measured on.

One table, keyed by ``jax.devices()[0].device_kind``.  Code that divides a
measurement by a peak looks the device up here; a device that is not in
the table is an error, never a default.

H100 SXM: NVIDIA H100 Tensor Core GPU data sheet (dense rates, no
sparsity): 1,979 TOP/s int8 on the tensor cores, 3.35 TB/s and 80 GB of
HBM3.
"""

from __future__ import annotations

__all__ = ["H100_SXM", "PEAKS", "peaks"]

H100_SXM = {
    "int8_ops": 1979e12,        # ops/s, 2 per MAC
    "hbm_bytes_per_s": 3.35e12,
    "memory_bytes": 80e9,
}

PEAKS = {
    "NVIDIA H100 80GB HBM3": H100_SXM,
}


def peaks(device_kind: str) -> dict:
    """Peak table of ``device_kind``; raises for a device not listed."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(f"no peak rates for device kind {device_kind!r}; "
                       f"known: {sorted(PEAKS)}") from None
