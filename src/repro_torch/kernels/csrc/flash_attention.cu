// FlashAttention-2 forward for Hopper (sm_90a): o = softmax(q k^T / sqrt(D)) v
// over (B, H, S, D) tensors, causal or not, with an online softmax in fp32.
//
// Replaces the Pallas kernel
// src/repro/kernels/flash_attention/flash_attention.py: _flash_fwd_kernel
// (launched by flash_attention_fwd at :80). Its numerics are kept: every
// product and sum is one of the widened fp32 values (the reference's
// `p.astype(v.dtype)` casts to the widened v's fp32, so P stays fp32 in P·V
// too); masked logits are -1e30, the running max starts at -1e30, and the
// output is o / max(l, 1e-30), cast to q's dtype. What changes with the
// machine: the TPU grid walks (B*H, S/BQ) in order and shrinks its blocks to
// divisors of S; here every (b*h, q tile) is a block of its own, in
// parallel, the ragged last tiles are masked (rows past S are neither read
// nor written), and the q tiles with the most causal work are launched
// first.
//
// What bounds it on the H100: operations. Causal at the Qwen1.5-4B prompt
// shape (4, 20, 2048, 128) it does 85.9 GFLOP of useful work (4·D FLOP per
// causal pair) on 84 MB of q, k, v and o, ~1000 FLOP per byte against a bf16
// balance point of ~295: 0.0869 ms at the tensor cores' 989 TFLOP/s.
//
// bf16 (flash_attention_bf16): a tensor-core kernel.
//   * S = Q·K^T by wgmma, bf16 in and fp32 accumulate. A bf16 x bf16 product
//     is exact in fp32, so S is the reference's fp32 dot of the widened
//     values up to summation order. q is not pre-scaled (q·scale rounded to
//     bf16 would lose bits): scale·log2(e) multiplies the fp32 scores and
//     exp2 stands for exp, one fp32 rounding away from the reference.
//   * The online softmax runs in fp32 on the accumulator's registers: a row
//     lives in a quad of 4 lanes, so its max takes two shuffles; row sums
//     stay per lane until the end.
//   * P·V keeps the reference's fp32 P on bf16 tensor cores: P = P_hi + P_lo
//     with P_hi = bf16(P) and P_lo = bf16(P - P_hi) (P - P_hi is exact in
//     fp32; the pair carries 16 significant bits), and two wgmmas with A in
//     registers accumulate P_hi·V and P_lo·V into one fp32 O. That is 1.5x
//     the tensor work of a kernel that rounds P once (128.9 instead of 85.9
//     GFLOP at the prompt shape), because rounding P once to bf16 (2^-9
//     relative) moves the bf16 output past the bar the kernel is held to
//     (chip_smoke.py's planted fault_p_bf16); the split's error, ~2^-17, is
//     below the output's own rounding.
//   * Copies in flight: one thread starts TMA loads through 4-D tensor maps
//     over (D, S, H, B) with the caller's strides, 128-byte swizzled as the
//     wgmma descriptors read them: the q tile once, then K and V tiles into a
//     ring of two stages, so tile j+1 lands while tile j is multiplied. TMA
//     fills rows past S and columns past D with zeros, so every D <= 128
//     is computed as 128, zero-padded.
//   * Grid: a block of two warpgroups (256 threads) per (b*h, 128-row q
//     tile), 64 rows each, over K/V tiles of 64 keys. Causal K/V tiles
//     wholly above a warpgroup's rows are skipped by it, the tiles crossing
//     the diagonal masked. Two blocks fit an SM (97 KB of shared memory
//     each, 128 registers a thread).
//     Each warpgroup stages its output tile in its own (spent) q rows and
//     writes it with 16-byte stores.
//
// fp32 (flash_attention_f32): the first port's FMA kernel, off the main path
// (the served models are bf16). It keeps the reference's fp32 arithmetic on
// the fp32 FMA pipes (67 TFLOP/s): each block stages its q tile (times the
// scale) once and each K and V tile through shared memory (rows padded by 4
// floats so the 16-byte reads of a quarter-warp hit distinct banks), and
// every thread holds a 4x4 tile of scores and a 4x8 tile of the output.
//
// Each tensor is addressed through its own element strides over b, h and s
// (d is unit-stride), so the model's (B, S, H, D) activations are read and
// written in place through (B, H, S, D) views, with no transposed copies.
//
// Plain C interface, loaded with ctypes; each entry returns 0 on success,
// the CUDA error code of its launch, or 10000 + the CUresult of
// cuTensorMapEncodeTiled when a tensor map cannot be made. The caller
// allocates o and guarantees tensors on the current device whose base and
// strides are multiples of 16 bytes, and D <= 128 and a multiple of 8.
// cuTensorMapEncodeTiled is looked up at run time through the CUDA runtime
// (cudaGetDriverEntryPointByVersion), so the library needs no -lcuda.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int DMAX = 128;  // largest head dim

// element strides of one (B, H, S, D) tensor over b, h and s
struct Strides {
  long long b, h, s;
};
struct Layout {
  Strides q, k, v, o;
};

// ---------------------------------------------------------------------------
// fp32: FMA kernel
namespace fma {

constexpr int BQ = 64;        // q rows per block
constexpr int BK = 64;        // keys per KV tile
constexpr int NT = 256;       // threads: 16 row groups x 16 columns
constexpr int DS = DMAX + 4;  // row stride (floats) of the q and K/V tiles
constexpr int PS = BQ + 4;    // row stride (floats) of the transposed P tile
constexpr int SMEM_BYTES = (BQ * DS + BK * DS + BK * PS) * sizeof(float);

// rows [row0, row0 + 64) of an (S, D) matrix with row stride ld into a
// [64][DS] tile, times mul; rows past S are zero
__device__ __forceinline__ void load_tile(const float* __restrict__ src,
                                          float* dst, int row0, int S, int D,
                                          long long ld, float mul) {
  const int chunks = D / 8;
  for (int idx = threadIdx.x; idx < BQ * chunks; idx += NT) {
    const int r = idx / chunks;
    const int c = (idx - r * chunks) * 8;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    if (row0 + r < S) {
      a = *reinterpret_cast<const float4*>(src + (row0 + r) * ld + c);
      b = *reinterpret_cast<const float4*>(src + (row0 + r) * ld + c + 4);
    }
    float4* d = reinterpret_cast<float4*>(dst + r * DS + c);
    d[0] = make_float4(a.x * mul, a.y * mul, a.z * mul, a.w * mul);
    d[1] = make_float4(b.x * mul, b.y * mul, b.z * mul, b.w * mul);
  }
}

__device__ __forceinline__ float row_max(float v) {  // over 16 lanes
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {  // over 16 lanes
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// DC: the head dim when it is known at compile time (128), else 0 and D is
// read from Drt.
template <int DC>
__global__ void __launch_bounds__(NT, 2)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, Layout L,
                 int H, int S, int Drt, float scale, int causal) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;            // [BQ][DS]  q * scale
  float* KVs = Qs + BQ * DS;   // [BK][DS]  K, then V, of one KV tile
  float* Pt = KVs + BK * DS;   // [BK][PS]  P transposed

  const int D = DC ? DC : Drt;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest tiles first
  const long long bi = blockIdx.x / H, hi = blockIdx.x % H;  // (b, h)
  q += bi * L.q.b + hi * L.q.h;
  k += bi * L.k.b + hi * L.k.h;
  v += bi * L.v.b + hi * L.v.h;
  o += bi * L.o.b + hi * L.o.h;
  const int tid = threadIdx.x;
  const int ty = tid / 16;  // rows ty*4 .. ty*4+3 of the q tile
  const int tx = tid % 16;  // score columns tx + 16j; output dims tx*4 + 64h

  load_tile(q, Qs, q0, S, D, L.q.s, scale);

  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  }

  // causal: KV tiles wholly above the diagonal of this q tile are skipped
  const int kv_end = causal ? min(S, q0 + BQ) : S;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous V tile (and P) are consumed
    load_tile(k, KVs, k0, S, D, L.k.s, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty * 4 + i) * DS + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&KVs[(tx + 16 * j) * DS + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        if (kpos >= S || (causal && kpos > qpos)) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = expf(s[i][j] - m_new);
        sum += p[i][j];
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&Pt[(tx + 16 * j) * PS + ty * 4]) =
          make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);

    __syncthreads();  // every thread is done with K
    load_tile(v, KVs, k0, S, D, L.v.s, 1.f);
    __syncthreads();  // V and P are in place

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float4 pc = *reinterpret_cast<const float4*>(&Pt[c * PS + ty * 4]);
      const float pr[4] = {pc.x, pc.y, pc.z, pc.w};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int d = tx * 4 + 64 * h;
        if (d >= D) continue;
        const float4 vv = *reinterpret_cast<const float4*>(&KVs[c * DS + d]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][4 * h + 0] = fmaf(pr[i], vv.x, acc[i][4 * h + 0]);
          acc[i][4 * h + 1] = fmaf(pr[i], vv.y, acc[i][4 * h + 1]);
          acc[i][4 * h + 2] = fmaf(pr[i], vv.z, acc[i][4 * h + 2]);
          acc[i][4 * h + 3] = fmaf(pr[i], vv.w, acc[i][4 * h + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* out = o + row * L.o.s;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int d = tx * 4 + 64 * h;
      if (d >= D) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) out[d + e] = acc[i][4 * h + e] / denom;
    }
  }
}

template <int DC>
int launch(const float* q, const float* k, const float* v, float* o,
           const Layout& L, int B, int H, int S, int D, float scale,
           int causal, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (S + BQ - 1) / BQ);
  flash_fwd_kernel<DC><<<grid, NT, SMEM_BYTES, stream>>>(
      q, k, v, o, L, H, S, D, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fma

// ---------------------------------------------------------------------------
// bf16: tensor-core kernel
namespace tc {

constexpr int BQ = 128;    // q rows per block: two warpgroups of 64
constexpr int BK = 64;     // keys per K/V tile
constexpr int NT = 256;    // threads
constexpr int STAGES = 2;  // K/V tiles in flight
constexpr int ROW = 128;   // bytes of a swizzled row: 64 bf16 columns

// Shared memory: each tile as NB blocks of 64 columns (the depth, DMAX, zero
// past D), rows of 128 bytes in the 128-byte swizzle (16-byte chunk c of
// row r stored at c ^ (r % 8)), every block 1024-byte aligned.
constexpr int NB = DMAX / 64;                  // column blocks
constexpr int Q_BYTES = NB * BQ * ROW;         // the q tile
constexpr int KV_BYTES = NB * BK * ROW;        // one K or V tile
constexpr int BAR = Q_BYTES + STAGES * 2 * KV_BYTES;  // mbarriers: q, stages
constexpr int SMEM_BYTES = BAR + 8 * (1 + STAGES) + 1024;  // + alignment

// one box of a 4-D tensor map at (d, s, h, b) into shared memory at dst,
// completing on the barrier
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d, int s, int h,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(d), "r"(s), "r"(h), "r"(b),
      "r"(bar)
      : "memory");
}

// d (+)= A·B, m64n64k16: A (64 x 16) and B (16 x 64) K-major in shared
// memory; d is overwritten when accumulate is 0
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d += A·B, m64n128k16: A (64 x 16) in registers, 4 x bf16x2 per thread; B
// (16 x 128) MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, "
      "1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (p0, p1) -> hi = bf16(p) and lo = bf16(p - hi), each packed low-first
__device__ __forceinline__ void split(float p0, float p1, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
}

// Fragments: warp w of a warpgroup holds rows 16w .. 16w+15 of its 64; lane
// t holds rows r = t/4 and r + 8, columns 8i + 2(t%4) + {0, 1} of every
// 8-column chunk i, as d[4i + 2·(row r+8) + {0, 1}]. The accumulator of
// S for keys 16u .. 16u+15 is, in this order, the A operand of P·V's k-step
// u, so P goes from S's registers to P·V's without passing shared memory.
__global__ void __launch_bounds__(NT, 2)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                __nv_bfloat16* __restrict__ o, Strides so, int H, int S, int D,
                float scale_log2, int causal) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sq = (raw + 1023) & ~1023u;  // the swizzle's 1024-byte period
  uint8_t* const sq_ptr = smem_raw + (sq - raw);
  const uint32_t skv = sq + Q_BYTES;  // stage s: K at skv + 2s·KV, V after it
  const uint32_t bar_q = sq + BAR;
  const uint32_t bar_kv = bar_q + 8;  // one per stage

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = tid % 128 / 32, lane = tid % 32;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest tiles first
  const int bi = blockIdx.x / H, hi = blockIdx.x % H;
  const int nt = ((causal ? min(S, q0 + BQ) : S) + BK - 1) / BK;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) mbar_init(bar_kv + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar_q, Q_BYTES);
    for (int c = 0; c < NB; ++c)
      tma_load(sq + c * BQ * ROW, &tq, bar_q, 64 * c, q0, hi, bi);
    for (int j = 0; j < STAGES && j < nt; ++j) {
      const uint32_t st = skv + j * 2 * KV_BYTES, bar = bar_kv + 8 * j;
      mbar_expect_tx(bar, 2 * KV_BYTES);
      for (int c = 0; c < NB; ++c) {
        tma_load(st + c * BK * ROW, &tk, bar, 64 * c, j * BK, hi, bi);
        tma_load(st + KV_BYTES + c * BK * ROW, &tv, bar, 64 * c, j * BK, hi,
                 bi);
      }
    }
  }
  __syncthreads();

  const int qw = q0 + 64 * wg;  // this warpgroup's first row
  const bool active = qw < S;
  const int kv_end = causal ? min(S, qw + 64) : S;
  const int r0 = qw + 16 * warp + lane / 4;  // rows r0 and r0 + 8
  const int c0 = 2 * (lane % 4);             // columns c0, c0 + 1 of a chunk
  const uint32_t qa = sq + 64 * wg * ROW;    // this warpgroup's q rows

  float acc[DMAX / 2];
#pragma unroll
  for (int i = 0; i < DMAX / 2; ++i) acc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  mbar_wait(bar_q, 0);

  for (int j = 0; j < nt; ++j) {
    const int stage = j % STAGES;
    const uint32_t kt = skv + stage * 2 * KV_BYTES, vt = kt + KV_BYTES;
    mbar_wait(bar_kv + 8 * stage, (j / STAGES) & 1);
    const int k0 = j * BK;
    if (active && k0 < kv_end) {
      // S = Q·K^T over DMAX/16 k-steps of 16 columns (32 bytes)
      float s[32];
      pin(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DMAX / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;
        wgmma_ss_n64(s,
                     sw128_desc(qa + kk / 4 * BQ * ROW + col, 16, 8 * ROW),
                     sw128_desc(kt + kk / 4 * BK * ROW + col, 16, 8 * ROW),
                     kk);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(s);

      // scale, mask, online softmax (log2 domain)
      const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > qw);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float t = s[i] * scale_log2;
        if (edge) {
          const int kpos = k0 + 8 * (i / 4) + c0 + i % 2;
          const int qpos = r0 + 8 * (i / 2 % 2);
          if (kpos >= S || (causal && kpos > qpos)) t = NEG_INF;
        }
        s[i] = t;
      }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = NEG_INF;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          mx = fmaxf(mx, fmaxf(s[4 * i + 2 * h], s[4 * i + 2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[h], mx);
        alpha[h] = ex2(m[h] - m_new);
        m[h] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = ex2(s[4 * i + 2 * h + e] - m_new);
            s[4 * i + 2 * h + e] = p;
            sum += p;
          }
        l[h] = l[h] * alpha[h] + sum;
      }
#pragma unroll
      for (int i = 0; i < DMAX / 2; ++i) acc[i] *= alpha[i / 2 % 2];

      // P = P_hi + P_lo as the A operands of P·V's BK/16 k-steps
      uint32_t ph[BK / 16][4], pl[BK / 16][4];
#pragma unroll
      for (int u = 0; u < BK / 16; ++u)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          split(s[8 * u + 2 * x], s[8 * u + 2 * x + 1], ph[u][x], pl[u][x]);

      // O += P_hi·V + P_lo·V; V MN-major: k-step u starts 16 rows in, the
      // second 64-column block lies BK rows further
      pin(acc);
      wgmma_fence();
#pragma unroll
      for (int u = 0; u < BK / 16; ++u) {
        const uint64_t dv = sw128_desc(vt + u * 16 * ROW, BK * ROW, 8 * ROW);
        wgmma_rs(acc, ph[u], dv);
        wgmma_rs(acc, pl[u], dv);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(acc);
    }
    __syncthreads();  // both warpgroups are done with this stage
    if (tid == 0 && j + STAGES < nt) {
      const int jn = j + STAGES;
      const uint32_t bar = bar_kv + 8 * stage;
      mbar_expect_tx(bar, 2 * KV_BYTES);
      for (int c = 0; c < NB; ++c) {
        tma_load(kt + c * BK * ROW, &tk, bar, 64 * c, jn * BK, hi, bi);
        tma_load(vt + c * BK * ROW, &tv, bar, 64 * c, jn * BK, hi, bi);
      }
    }
  }
  if (!active) return;

  // o = acc / max(l, 1e-30), staged as bf16 in this warpgroup's q rows
  // (swizzled, so the 4-byte stores of a warp hit 32 banks), then written
  // to rows < S, columns < D with 16-byte stores
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    l[h] = fmaxf(l[h], 1e-30f);
  }
  uint8_t* const tile = sq_ptr + 64 * wg * ROW;
  const int rw = 16 * warp + lane / 4;
#pragma unroll
  for (int i = 0; i < DMAX / 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rw + 8 * h;
      *reinterpret_cast<__nv_bfloat162*>(
          tile + i / 8 * BQ * ROW + r * ROW + ((i % 8) ^ (r % 8)) * 16 +
          2 * c0) = __floats2bfloat162_rn(acc[4 * i + 2 * h] / l[h],
                                          acc[4 * i + 2 * h + 1] / l[h]);
    }
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  o += bi * so.b + hi * so.h;
  const int chunks = D / 8;  // 16-byte chunks of a row
  const int rows = min(64, S - qw);
  for (int idx = tid % 128; idx < rows * chunks; idx += 128) {
    const int r = idx / chunks, c = idx % chunks;
    const uint4 val = *reinterpret_cast<const uint4*>(
        tile + c / 8 * BQ * ROW + r * ROW + ((c % 8) ^ (r % 8)) * 16);
    *reinterpret_cast<uint4*>(o + (qw + r) * so.s + 8 * c) = val;
  }
}

// a map over one bf16 (B, H, S, D) tensor, dims innermost first (D, S, H,
// B), read in boxes of 64 columns x rows rows, 128-byte swizzled; elements
// outside the tensor read as zero
int make_map(CUtensorMap* map, const void* base, const Strides& st, int B,
             int H, int S, int D, int rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return MAP_ERROR + CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.s) * 2,
                                 static_cast<cuuint64_t>(st.h) * 2,
                                 static_cast<cuuint64_t>(st.b) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : MAP_ERROR + static_cast<int>(r);
}

int launch(const void* q, const void* k, const void* v, void* o,
           const Layout& L, int B, int H, int S, int D, float scale,
           int causal, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int rc = make_map(&mq, q, L.q, B, H, S, D, BQ);
  if (rc == 0) rc = make_map(&mk, k, L.k, B, H, S, D, BK);
  if (rc == 0) rc = make_map(&mv, v, L.v, B, H, S, D, BK);
  if (rc != 0) return rc;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (S + BQ - 1) / BQ);
  const float scale_log2 = static_cast<float>(scale * 1.4426950408889634);
  flash_fwd_wgmma<<<grid, NT, SMEM_BYTES, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), L.o, H, S, D, scale_log2,
      causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// strides: 12 values, (b, h, s) of q, k, v and o in that order
Layout layout(const long long* strides) {
  Layout L;
  Strides* dst[4] = {&L.q, &L.k, &L.v, &L.o};
  for (int i = 0; i < 4; ++i)
    *dst[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  return L;
}

}  // namespace

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   void* o, int B, int H, int S, int D,
                                   const long long* strides, float scale,
                                   int causal, void* stream) {
  const Layout L = layout(strides);
  const auto* qp = static_cast<const float*>(q);
  const auto* kp = static_cast<const float*>(k);
  const auto* vp = static_cast<const float*>(v);
  auto* op = static_cast<float*>(o);
  const auto s = static_cast<cudaStream_t>(stream);
  if (D == DMAX)
    return fma::launch<DMAX>(qp, kp, vp, op, L, B, H, S, D, scale, causal, s);
  return fma::launch<0>(qp, kp, vp, op, L, B, H, S, D, scale, causal, s);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int B, int H,
                                    int S, int D, const long long* strides,
                                    float scale, int causal, void* stream) {
  return tc::launch(q, k, v, o, layout(strides), B, H, S, D, scale, causal,
                    static_cast<cudaStream_t>(stream));
}
