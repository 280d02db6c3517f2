// How fast Hopper's tensor cores run the TF32 wgmma shapes the port's 3xTF32
// kernels issue: m64n64k8 and m64n128k8 with A in registers, and m64n64k8
// with A in shared memory, in batches of 12 (or 48) waited for as a group,
// from one or two warpgroups per SM. Every block loops `iters` times over
// one batch on fixed operands; scripts/wgmma_tf32_rate.py times the launch.
// Plain C interface, loaded with ctypes; returns the launch's CUDA error.
#include <cuda_runtime.h>
#include <stdint.h>

#include "../src/repro_torch/kernels/csrc/hopper.cuh"

namespace {

// d += A.B, m64n64k8 tf32, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_tf32_ss_n64(float (&d)[32], uint64_t da,
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// MODE 0: A in registers, n64, batches of 12; 1: the same, batches of 48;
// 2: A in registers, n128, batches of 12; 3: A in shared memory, n64,
// batches of 12
template <int MODE>
__global__ void __launch_bounds__(256, 1)
rate_kernel(float* out, int iters, int warpgroups) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const s = smem_raw + (base - raw);
  for (int i = threadIdx.x; i < 65536 / 4; i += blockDim.x)
    reinterpret_cast<float*>(s)[i] = 0.001f * (i % 7);
  fence_proxy_async();
  __syncthreads();
  if (static_cast<int>(threadIdx.x) / 128 >= warpgroups) return;
  uint32_t a[4][4];
  for (int u = 0; u < 4; ++u)
    for (int q = 0; q < 4; ++q) a[u][q] = tf32_rna(0.01f * (threadIdx.x + u + q));
  float acc[64];
  for (int k = 0; k < 64; ++k) acc[k] = 0.f;
  float(&acc32)[32] = *reinterpret_cast<float(*)[32]>(acc);
  constexpr int GROUPS = MODE == 1 ? 4 : 1;
  for (int it = 0; it < iters; ++it) {
    pin(acc);
    wgmma_fence();
    for (int g = 0; g < GROUPS; ++g)
      for (int u = 0; u < 4; ++u) {
        const uint64_t d = sw128_desc(base + g * 8192 + u * 32, 16, 1024);
        for (int r = 0; r < 3; ++r) {
          if constexpr (MODE == 2)
            wgmma_tf32_n128(acc, a[u], d);
          else if constexpr (MODE == 3)
            wgmma_tf32_ss_n64(acc32,
                              sw128_desc(base + 32768 + u * 32, 16, 1024), d);
          else
            wgmma_tf32_n64(acc32, a[u], d);
        }
      }
    wgmma_commit();
    wgmma_wait_all();
    pin(acc);
  }
  float sum = 0.f;
  for (int k = 0; k < 64; ++k) sum += acc[k];
  out[blockIdx.x * 256 + threadIdx.x] = sum;
}

}  // namespace

extern "C" int wgmma_tf32_rate(int mode, float* out, int iters,
                               int warpgroups, int blocks) {
  const int smem = 65536 + 1024;
  void* const fns[4] = {reinterpret_cast<void*>(rate_kernel<0>),
                        reinterpret_cast<void*>(rate_kernel<1>),
                        reinterpret_cast<void*>(rate_kernel<2>),
                        reinterpret_cast<void*>(rate_kernel<3>)};
  cudaError_t err = cudaFuncSetAttribute(
      fns[mode], cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&out, &iters, &warpgroups};
  err = cudaLaunchKernel(fns[mode], dim3(blocks), dim3(256), args, smem, 0);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
