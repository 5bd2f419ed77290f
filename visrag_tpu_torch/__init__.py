"""PyTorch/CUDA port of visrag_tpu for NVIDIA Hopper GPUs.

Mirrors visrag_tpu's module paths and class names. Plain tensor code is
PyTorch; each Pallas kernel of visrag_tpu becomes a hand-written CUDA
kernel under csrc/, built on first use (ops/_build.py). Imports torch,
never jax and nothing of visrag_tpu: the jax-free host modules it needs
(config, data, host preprocessing, the native patchify, retrieval metrics
and TREC I/O, the metrics tracker) are its own copies.
"""
