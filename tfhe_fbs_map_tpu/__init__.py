"""tfhe_fbs_map_tpu — TFHE functional-bootstrapping framework.

A from-scratch reimplementation of the capabilities of ``ssmiler/tfhe_fbs_map``
(the circuit-to-FBS mapping heuristic of eprint 2024/1204) extended with the
piece that repository delegates to Zama Concrete: a batched TFHE executor
built on JAX/XLA for NVIDIA GPUs, plus a parameter/cost optimizer.

Layers:

* :mod:`tfhe_fbs_map_tpu.frontend` — circuit IRs, parsers, mapping heuristics
  (CPU, numpy).
* :mod:`tfhe_fbs_map_tpu.tfhe` — TFHE math core: torus types, keygen,
  encryption, gadget decomposition, programmable bootstrap (JAX).
* :mod:`tfhe_fbs_map_tpu.ops` — the int8 fast path (negacyclic key
  matrices on the tensor cores, blind rotation, key switch).
* :mod:`tfhe_fbs_map_tpu.runtime` — levelized batched executor for mapped
  circuits.
* :mod:`tfhe_fbs_map_tpu.parallel` — device-mesh sharding of ciphertext
  batches and key material.
* :mod:`tfhe_fbs_map_tpu.optimizer` — (precision, sq_norm2) → (params, cost,
  p_error) parameter optimizer.
"""

__version__ = "0.1.0"
