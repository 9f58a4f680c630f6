"""DDSP-Piano in PyTorch for one NVIDIA H100.

A port of ``ddsp_piano_tpu`` (the JAX package, kept beside it as the
reference). The layout mirrors it -- ``ops/``, ``nn/``, ``processors/``,
``models/``, ``configs/``, ``kernels/``, ``data/`` -- so each module has an
obvious counterpart. The TPU kernels of the render and of the training
step are CUDA C++ kernels under ``csrc/``, built with ``nvcc`` at first
use (``kernels/build.py``); their gradients run through
torch.autograd.Functions in ``kernels/``.

This package imports torch, numpy and scipy only: never jax, and nothing
of ``ddsp_piano_tpu``.
"""
