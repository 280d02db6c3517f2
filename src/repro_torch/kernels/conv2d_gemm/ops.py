from .conv2d_gemm import conv2d_gemm
from .ref import conv2d_ref

__all__ = ["conv2d_gemm", "conv2d_ref"]
