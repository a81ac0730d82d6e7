"""bn254_tpu_torch — BN254 pairing and BLS batch verification in PyTorch,
with a hand-written CUDA kernel for the leaf Montgomery multiply.

The PyTorch/CUDA port of `bn254_tpu` (JAX), which stays the reference:
every function here has a JAX twin it is tested against, limb for limb.
This package imports neither JAX nor anything of `bn254_tpu`.

Entry points (`api`): `batch_sign` and `batch_verify` run on the CUDA card
unless called with `device="cpu"`; below them every function follows the
device of its input tensors. Importing the package builds nothing: the
kernel is compiled by nvcc at its first use on a CUDA tensor.
"""

from .config import Config

__all__ = ["Config"]
