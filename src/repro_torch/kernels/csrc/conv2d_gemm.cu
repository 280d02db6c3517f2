// Implicit-GEMM 2-D convolution for Hopper (sm_90a), NHWC x HWIO -> NHWC.
//
// Replaces the Pallas kernel src/repro/kernels/conv2d_gemm/conv2d_gemm.py:
// _conv_kernel (launched by conv2d_gemm at :83). That kernel pads the image
// in its wrapper and runs kh*kw shifted (Ho*Wo, C) x (C, F) matmuls per
// (image, filter block). Here the same sum is one GEMM with
//   M = B*Ho*Wo (output pixels), N = F (filters), K = kh*kw*C (taps x channels)
// whose A operand (the im2col matrix) is never formed: each block gathers
// its A tile straight from x, and padding is a bounds check, not a copy.
//
// What bounds it on the H100: the convs of ResNet-50 do 60-500 FLOP per byte
// they must move, far above the card's 20 FLOP/byte fp32 balance point
// (67 TFLOP/s over 3.35 TB/s), so the bound is operations. In fp32 the
// kernel does plain FMAs (no TF32, so it meets the reference's 1e-4 bar),
// whose peak is 67 TFLOP/s; bf16 inputs are widened to fp32 on load and also
// run on the FMA pipes, which caps bf16 at the fp32 rate, far below the
// tensor-core bound. The design spends its effort on operand reuse: a
// 128x64 output tile per block, staged through shared memory in K-slices of
// 16, and an 8x4 register tile per thread (32 accumulators, 3 vector shared
// loads per 32 FMAs). wgmma, TMA and a multi-stage pipeline are later work.
//
// Plain C interface, loaded with ctypes; each entry returns the CUDA error
// code of its launch (0 on success). The caller allocates y and guarantees
// contiguous tensors on the current device and numel < 2^31.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;  // output pixels per block
constexpr int BN = 64;   // filters per block
constexpr int BK = 16;   // K-slice staged in shared memory
constexpr int TM = 8;    // rows per thread
constexpr int TN = 4;    // columns per thread
constexpr int NT = (BM / TM) * (BN / TN);  // 256 threads
constexpr int A_PER_THREAD = BM * BK / NT;  // 8 A elements loaded per slice
constexpr int B_PER_THREAD = BK * BN / NT;  // 4 B elements loaded per slice
constexpr int A_ROW_STEP = NT / BK;         // 16
constexpr int B_ROW_STEP = NT / BN;         // 4
constexpr int A_PAD = 4;  // keeps rows 16-byte aligned, spreads banks

struct ConvShape {
  int B, H, W, C, F, kh, kw, sh, sw, Ho, Wo, pad_top, pad_left;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(NT)
conv2d_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   T* __restrict__ y, ConvShape s) {
  __shared__ __align__(16) float As[BK][BM + A_PAD];  // A^T slice: [k][m]
  __shared__ __align__(16) float Bs[BK][BN];          // B slice:   [k][n]

  const int tid = threadIdx.x;
  const int M = s.B * s.Ho * s.Wo;
  const int K = s.kh * s.kw * s.C;
  const int N = s.F;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // A loader: this thread always fills column a_kk of the slice, rows
  // a_r0 + i*A_ROW_STEP. Neighbouring threads read neighbouring channels.
  const int a_kk = tid % BK;
  const int a_r0 = tid / BK;
  int a_img[A_PER_THREAD], a_h[A_PER_THREAD], a_w[A_PER_THREAD];
#pragma unroll
  for (int i = 0; i < A_PER_THREAD; ++i) {
    const int m = m0 + a_r0 + i * A_ROW_STEP;
    if (m < M) {
      const int b = m / (s.Ho * s.Wo);
      const int r = m - b * s.Ho * s.Wo;
      const int ho = r / s.Wo;
      const int wo = r - ho * s.Wo;
      a_img[i] = b * s.H * s.W * s.C;
      a_h[i] = ho * s.sh - s.pad_top;   // input row of tap di = 0
      a_w[i] = wo * s.sw - s.pad_left;  // input column of tap dj = 0
    } else {
      a_img[i] = 0;
      a_h[i] = -(1 << 29);  // fails the bounds check: a zero row
      a_w[i] = 0;
    }
  }
  // (di, dj, c) of this thread's column k = k0 + a_kk, advanced by BK per
  // slice without divisions (K is ordered di, dj, c as in HWIO)
  int kc = a_kk % s.C;
  int kdj = (a_kk / s.C) % s.kw;
  int kdi = a_kk / (s.C * s.kw);

  const int b_n = tid % BN;
  const int b_k = tid / BN;

  const int ty = tid / (BN / TN);
  const int tx = tid % (BN / TN);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    const bool k_ok = k0 + a_kk < K;
#pragma unroll
    for (int i = 0; i < A_PER_THREAD; ++i) {
      const int h = a_h[i] + kdi;
      const int ww = a_w[i] + kdj;
      float v = 0.f;
      if (k_ok && (unsigned)h < (unsigned)s.H && (unsigned)ww < (unsigned)s.W)
        v = to_float(x[a_img[i] + (h * s.W + ww) * s.C + kc]);
      As[a_kk][a_r0 + i * A_ROW_STEP] = v;
    }
#pragma unroll
    for (int j = 0; j < B_PER_THREAD; ++j) {
      const int kk = b_k + j * B_ROW_STEP;
      const int k = k0 + kk;
      const int n = n0 + b_n;
      Bs[kk][b_n] = (k < K && n < N) ? to_float(w[k * N + n]) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a_lo = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 a_hi = *reinterpret_cast<const float4*>(&As[kk][ty * TM + 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      const float a[TM] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w,
                           a_hi.x, a_hi.y, a_hi.z, a_hi.w};
      const float b[TN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();

    kc += BK;
    while (kc >= s.C) {
      kc -= s.C;
      if (++kdj == s.kw) {
        kdj = 0;
        ++kdi;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n < N) y[m * N + n] = from_float<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, void* y, int B, int H, int W, int C,
           int F, int kh, int kw, int sh, int sw, int Ho, int Wo, int pad_top,
           int pad_left, void* stream) {
  const ConvShape s{B, H, W, C, F, kh, kw, sh, sw, Ho, Wo, pad_top, pad_left};
  const int M = B * Ho * Wo;
  const dim3 grid((M + BM - 1) / BM, (F + BN - 1) / BN);
  conv2d_gemm_kernel<T><<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int conv2d_gemm_f32(const void* x, const void* w, void* y, int B,
                               int H, int W, int C, int F, int kh, int kw,
                               int sh, int sw, int Ho, int Wo, int pad_top,
                               int pad_left, void* stream) {
  return launch<float>(x, w, y, B, H, W, C, F, kh, kw, sh, sw, Ho, Wo,
                       pad_top, pad_left, stream);
}

extern "C" int conv2d_gemm_bf16(const void* x, const void* w, void* y, int B,
                                int H, int W, int C, int F, int kh, int kw,
                                int sh, int sw, int Ho, int Wo, int pad_top,
                                int pad_left, void* stream) {
  return launch<__nv_bfloat16>(x, w, y, B, H, W, C, F, kh, kw, sh, sw, Ho, Wo,
                               pad_top, pad_left, stream);
}
