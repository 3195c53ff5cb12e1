"""PyTorch/CUDA port of learninghumanoidwalking_tpu.

Module names mirror the JAX package so each file has an obvious
counterpart. The port imports torch, numpy and scipy only: it never imports
jax or the JAX package, and keeps its own copies of the numpy modules it
needs (robot specs, lowering, mirror tables). Every entry point takes an
explicit ``device`` (default ``"cuda"``); the CPU path runs the plain
PyTorch version of each kernel.
"""
