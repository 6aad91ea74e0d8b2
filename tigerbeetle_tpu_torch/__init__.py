"""tigerbeetle_tpu_torch: the double-entry state machine on PyTorch and
hand-written CUDA kernels for an NVIDIA H100.

The port of the JAX package `tigerbeetle_tpu` (the reference, which stays
as it is), module for module under the same names. It imports torch and
never jax, and no module of the reference package. Device state is the
reference layout: u128 values as (..., 4) little-endian uint32 limbs.

Entry points run on CUDA unless the caller passes `device="cpu"`, where
every kernel entry runs its plain PyTorch version instead.
"""

from tigerbeetle_tpu_torch import constants, flags, results, types  # noqa: F401
