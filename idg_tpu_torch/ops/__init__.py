"""Kernels, staging and the run API of the PyTorch/CUDA port."""
