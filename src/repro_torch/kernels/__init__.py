"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

conv2d_gemm/     - implicit-GEMM convolution (the paper's CNN hot spot)
rmsnorm/         - fused RMSNorm (the LM's norms)
flash_attention/ - FlashAttention-2 forward (the LM's prompt pass)
ssd_scan/        - Mamba-2 SSD chunk computation (the SSM's prompt pass)
csrc/            - the CUDA sources, built at first use by build.py
"""
from .conv2d_gemm.ops import conv2d_gemm, conv2d_ref
from .flash_attention.flash_attention import flash_attention
from .flash_attention.ref import attention_ref
from .rmsnorm.ref import rmsnorm_ref
from .rmsnorm.rmsnorm import rmsnorm
from .ssd_scan.ref import ssd_chunk_ref, ssd_ref
from .ssd_scan.ssd_scan import ssd_chunk
