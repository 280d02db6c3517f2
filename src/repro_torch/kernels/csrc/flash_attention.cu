// FlashAttention-2 forward for Hopper (sm_90a): o = softmax(q k^T / sqrt(D)) v
// over (B, H, S, D) tensors, causal or not, with an online softmax in fp32.
//
// Replaces the Pallas kernel
// src/repro/kernels/flash_attention/flash_attention.py: _flash_fwd_kernel
// (launched by flash_attention_fwd at :80). Its numerics are kept:
//   * q is widened to fp32 and multiplied by the scale before q k^T;
//   * k and v are widened to fp32 on load, so every product and sum is fp32
//     (the reference's `p.astype(v.dtype)` casts to the widened v's fp32,
//     so p stays fp32 there too);
//   * masked logits are -1e30, the running max starts at -1e30, and the
//     output is o / max(l, 1e-30), cast to q's dtype.
// What changes with the machine: the TPU grid walks (B*H, S/BQ) in order and
// shrinks its blocks to divisors of S; here every (b*h, 64-row q tile) is a
// block of its own, in parallel, the ragged last tile is masked (rows past S
// are neither read nor written), and the q tiles with the most causal work
// are launched first.
//
// What bounds it on the H100: causal, it does ~S/2 FLOP for every element
// it must move (q, k, v read once, o written once): at S = 2048 that is
// ~500 FLOP per bf16 byte, above the balance point, so the bound is
// operations. This first version keeps the reference's fp32
// arithmetic and so runs on the fp32 FMA pipes (67 TFLOP/s), not the bf16
// tensor cores; its effort goes into reuse: each block stages its q tile once
// and each K and V tile through shared memory (as fp32, rows padded by 4 so
// the 16-byte reads of a quarter-warp hit distinct banks), and every thread
// holds a 4x4 tile of scores and a 4x8 tile of the output in registers.
// wgmma, TMA and a multi-stage pipeline are later work.
//
// Each tensor is addressed through its own element strides over b, h and s
// (d is unit-stride), so the model's (B, S, H, D) activations are read and
// written in place through (B, H, S, D) views, with no transposed copies.
//
// Plain C interface, loaded with ctypes; each entry returns the CUDA error
// code of its launch (0 on success). The caller allocates o and guarantees
// tensors on the current device whose base and rows are 16-byte aligned,
// and D <= 128 and a multiple of 8.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;        // q rows per block
constexpr int BK = 64;        // keys per KV tile
constexpr int NT = 256;       // threads: 16 row groups x 16 columns
constexpr int DMAX = 128;     // largest head dim
constexpr int DS = DMAX + 4;  // row stride (floats) of the q and K/V tiles
constexpr int PS = BQ + 4;    // row stride (floats) of the transposed P tile
constexpr float NEG_INF = -1e30f;
constexpr int SMEM_BYTES = (BQ * DS + BK * DS + BK * PS) * sizeof(float);

// element strides of one (B, H, S, D) tensor over b, h and s
struct Strides {
  long long b, h, s;
};
struct Layout {
  Strides q, k, v, o;
};

// 8 consecutive values, widened to fp32 (one or two 16-byte loads)
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// rows [row0, row0 + 64) of an (S, D) matrix with row stride ld into a
// [64][DS] fp32 tile, times mul; rows past S are zero
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ src,
                                          float* dst, int row0, int S, int D,
                                          long long ld, float mul) {
  const int chunks = D / 8;
  for (int idx = threadIdx.x; idx < BQ * chunks; idx += NT) {
    const int r = idx / chunks;
    const int c = (idx - r * chunks) * 8;
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (row0 + r < S) load8(src + (row0 + r) * ld + c, v);
    float4* d = reinterpret_cast<float4*>(dst + r * DS + c);
    d[0] = make_float4(v[0] * mul, v[1] * mul, v[2] * mul, v[3] * mul);
    d[1] = make_float4(v[4] * mul, v[5] * mul, v[6] * mul, v[7] * mul);
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
template <typename T, int DC>
__global__ void __launch_bounds__(NT, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, Layout L, int H,
                 int S, int Drt, float scale, int causal) {
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
    T* out = o + row * L.o.s;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int d = tx * 4 + 64 * h;
      if (d >= D) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        out[d + e] = from_float<T>(acc[i][4 * h + e] / denom);
    }
  }
}

template <typename T, int DC>
int launch_one(const T* q, const T* k, const T* v, T* o, const Layout& L,
               int B, int H, int S, int D, float scale, int causal,
               cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (S + BQ - 1) / BQ);
  flash_fwd_kernel<T, DC><<<grid, NT, SMEM_BYTES, stream>>>(
      q, k, v, o, L, H, S, D, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// strides: 12 values, (b, h, s) of q, k, v and o in that order
template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int S, int D, const long long* strides, float scale, int causal,
           void* stream) {
  Layout L;
  Strides* dst[4] = {&L.q, &L.k, &L.v, &L.o};
  for (int i = 0; i < 4; ++i)
    *dst[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const auto* qp = static_cast<const T*>(q);
  const auto* kp = static_cast<const T*>(k);
  const auto* vp = static_cast<const T*>(v);
  auto* op = static_cast<T*>(o);
  const auto s = static_cast<cudaStream_t>(stream);
  if (D == DMAX)
    return launch_one<T, DMAX>(qp, kp, vp, op, L, B, H, S, D, scale, causal,
                               s);
  return launch_one<T, 0>(qp, kp, vp, op, L, B, H, S, D, scale, causal, s);
}

}  // namespace

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   void* o, int B, int H, int S, int D,
                                   const long long* strides, float scale,
                                   int causal, void* stream) {
  return launch<float>(q, k, v, o, B, H, S, D, strides, scale, causal,
                       stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int B, int H,
                                    int S, int D, const long long* strides,
                                    float scale, int causal, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, B, H, S, D, strides, scale, causal,
                               stream);
}
