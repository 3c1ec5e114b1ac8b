"""The compiler ladder in PyTorch: the counterpart of ``idg_tpu/ops/xla``,
the rungs the JAX package writes in jax.numpy and leaves to XLA. Here they
are complex64 torch ops on the device of the staging they are given (CUDA
tensors on the card; no hand-written kernel). A rung is named by swapping
`xla_` for `torch_`. Importing registers them."""

from . import degridder, gridder, separable  # noqa: F401  (registers kernels)
