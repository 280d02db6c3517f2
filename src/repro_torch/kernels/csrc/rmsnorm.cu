// Fused RMSNorm for Hopper (sm_90a): y = x * rsqrt(mean(x^2) + eps) * scale,
// row-wise over the last dim, in fp32, cast back to x's dtype.
//
// Replaces the Pallas kernel src/repro/kernels/rmsnorm/rmsnorm.py:
// _rmsnorm_kernel (launched by rmsnorm at :43). That kernel grids over row
// blocks of up to 256 rows held in VMEM, and pads prime row counts up to a
// whole block. Here every row gets its own block of 256 threads, so rows
// need no padding and any row count runs as it is.
//
// What bounds it on the H100: it does ~4 operations per element it moves
// (2-4 bytes in, as many out), far below the card's balance point, so the
// bound is bytes. The design keeps each row to one read from device memory
// and one write: 16-byte vector loads and stores where the row allows them
// (8 bf16 or 4 fp32 values), the sum of squares in fp32 reduced with warp
// shuffles, then a second pass over the row, which a block has just read and
// which is still in L1/L2 (a 2560-wide bf16 row is 5 KB), to scale it.
//
// Plain C interface, loaded with ctypes; each entry returns the CUDA error
// code of its launch (0 on success). The caller allocates y and guarantees
// contiguous x, y and scale (fp32) on the current device, and, where vec is
// set, 16-byte aligned rows and pointers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;  // threads per block, one block per row

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

// VEC values of T moved as one aligned access (16 bytes where VEC > 1)
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC < 16 ? sizeof(T) * VEC : 16) Pack {
  T v[VEC];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(NT)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               T* __restrict__ y, int D, float eps) {
  const size_t row = blockIdx.x;
  const T* xr = x + row * D;
  T* yr = y + row * D;

  float ss = 0.f;
  for (int i = threadIdx.x * VEC; i < D; i += NT * VEC) {
    const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(xr + i);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float f = to_float(p.v[e]);
      ss = fmaf(f, f, ss);
    }
  }
  __shared__ float part[NT / 32];
  ss = warp_sum(ss);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) part[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    ss = warp_sum(lane < NT / 32 ? part[lane] : 0.f);
    if (lane == 0) part[0] = ss;
  }
  __syncthreads();
  const float r = rsqrtf(part[0] / static_cast<float>(D) + eps);

  for (int i = threadIdx.x * VEC; i < D; i += NT * VEC) {
    const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(xr + i);
    const Pack<float, VEC> s =
        *reinterpret_cast<const Pack<float, VEC>*>(scale + i);
    Pack<T, VEC> out;
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      out.v[e] = from_float<T>(to_float(p.v[e]) * r * s.v[e]);
    *reinterpret_cast<Pack<T, VEC>*>(yr + i) = out;
  }
}

template <typename T>
int launch(const void* x, const void* scale, void* y, int rows, int D,
           float eps, int vec, void* stream) {
  constexpr int V = 16 / sizeof(T);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const T*>(x);
  const auto* sp = static_cast<const float*>(scale);
  auto* yp = static_cast<T*>(y);
  if (vec)
    rmsnorm_kernel<T, V><<<rows, NT, 0, s>>>(xp, sp, yp, D, eps);
  else
    rmsnorm_kernel<T, 1><<<rows, NT, 0, s>>>(xp, sp, yp, D, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rmsnorm_f32(const void* x, const void* scale, void* y, int rows,
                           int D, float eps, int vec, void* stream) {
  return launch<float>(x, scale, y, rows, D, eps, vec, stream);
}

extern "C" int rmsnorm_bf16(const void* x, const void* scale, void* y,
                            int rows, int D, float eps, int vec,
                            void* stream) {
  return launch<__nv_bfloat16>(x, scale, y, rows, D, eps, vec, stream);
}
