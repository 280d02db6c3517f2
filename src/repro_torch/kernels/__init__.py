"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

conv2d_gemm/ - implicit-GEMM convolution (the paper's CNN hot spot)
csrc/        - the CUDA sources, built at first use by build.py
"""
from .conv2d_gemm.ops import conv2d_gemm, conv2d_ref
