"""PyTorch/CUDA port of visrag_tpu for NVIDIA Hopper GPUs.

Mirrors visrag_tpu's module paths and class names. Plain tensor code is
PyTorch; each Pallas kernel of visrag_tpu becomes a hand-written CUDA
kernel under csrc/, built on first use (ops/_build.py). Imports torch,
never jax; shares visrag_tpu's jax-free host modules (config, data,
preprocess, retrieval metrics and TREC I/O).
"""
