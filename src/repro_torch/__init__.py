"""PyTorch/CUDA port of the ``repro`` package for one NVIDIA H100.

It keeps the JAX package's module layout, its NHWC/HWIO layouts and its
numerics (XLA SAME padding, batch-statistics BatchNorm, fp32 without TF32),
imports neither ``jax`` nor ``repro``, and runs on ``cuda`` unless the
caller passes ``device="cpu"``.
"""
