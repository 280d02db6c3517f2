// Implicit-GEMM 2-D convolution for Hopper (sm_90a) on the tensor cores,
// NHWC x HWIO -> NHWC, SAME padding at any stride, or the halo entry (VALID
// over H, SAME over W).
//
// Replaces the Pallas kernel src/repro/kernels/conv2d_gemm/conv2d_gemm.py:
// _conv_kernel (launched by conv2d_gemm at :83). That kernel pads the image
// in its wrapper and runs kh*kw shifted (Ho*Wo, C) x (C, F) matmuls per
// (image, filter block), accumulating in fp32. Here the same sum is one GEMM
//   M = B*Ho*Wo (output pixels), N = F (filters), K = kh*kw*C (taps x channels)
// whose A operand (the im2col matrix) is never formed: each block gathers
// its A tile straight from x, and padding is a bounds check, not a copy.
//
// What bounds it on the H100: operations. ResNet-50's convs do 60-500 FLOP
// per byte they must move. The reference's numerics are fp32 products summed
// in fp32 (|kernel - plain| <= 1e-4 + 1e-4|plain| is the port's bar), which
// one TF32 pass misses by 10x or more at K >= 576. So:
//   * fp32 runs as 3xTF32 on wgmma: each operand x is split into
//     hi = cvt.rna.tf32(x) and lo = x - hi (exact in fp32; the tensor core
//     reads lo as TF32 by dropping its low 13 bits), and every k-step of 8
//     accumulates lo_a*hi_b, hi_a*lo_b, then hi_a*hi_b into fp32 registers
//     (m64nNk8 .tf32). lo*lo (2^-22 relative) is dropped. The bound is the
//     TF32 peak over the three products: 495/3 = 165 TFLOP/s of useful work.
//   * bf16 takes the same mainloop with one product: a bf16 value is exact
//     in TF32 (8 significant bits), so hi = x, lo = 0, and the products are
//     exact and summed in fp32. That caps bf16 at the TF32 rate, half the
//     bf16 tensor-core peak; native bf16 wgmma is later work.
//   * Operand layouts: wgmma takes TF32 operands K-major only. A (im2col of
//     NHWC x) is K-major already: a tap's channels are contiguous. B (HWIO
//     w, K x F with F contiguous) is not, so a prep kernel writes it
//     transposed, (F, Kp) with Kp = K rounded up to 32 and zero padded, as
//     w_hi and w_lo (fp32) into scratch the wrapper allocates.
//   * Loads: a ring of STAGES k-tiles of 32 in shared memory. B comes by
//     TMA (one thread, a 3-D tensor map over the prepped (part, F, Kp)
//     matrix, 128-byte swizzled as the wgmma descriptor reads it, rows past
//     F zero-filled), completing on an mbarrier per stage. A comes by
//     cp.async gathers from all 256 threads, waited on with
//     cp.async.wait_group: 16-byte (pixel, 4 fp32 or 8 bf16 channels) when
//     C allows, zero-filled through src-size 0 for padding pixels, rows past
//     M and columns past K; otherwise element by element (4-byte cp.async
//     for fp32, plain loads for bf16: the stem's C = 3). Each warpgroup
//     reads its A fragments from shared memory, splits them in registers
//     and feeds them as wgmma's register A.
//   * Overlap: while one k-tile's wgmmas run, the threads start the copies
//     of the k-tile STAGES - 1 ahead and read and split the next k-tile's
//     A fragments into a second register set; then they wait. A wgmma with
//     its A in registers holds its warp until the tensor core takes it, so
//     the twelve wgmmas of an fp32 k-tile hold the warps for most of their
//     run, and the copies and fragment loads after them overlap only the
//     tail: the tensor cores idle for part of every k-tile.
//   * Tiles: 128 output pixels (two warpgroups of 64) x BN filters, BN = 128,
//     or 64 where F <= 64 (the stem, stage 1). Stages 3-4 of ResNet-50 have
//     52-98 such tiles for 132 SMs, so the wrapper splits K into `split`
//     ranges of k-tiles (grid z), chosen from (M, N, K); each range writes
//     its partial sums to an fp32 workspace and a reduce kernel adds them in
//     range order and casts. No atomics: the same inputs give bitwise the
//     same output in every call.
//
// Plain C interface, loaded with ctypes; each entry returns the CUDA error
// code of its last launch (0 on success), or 10000 + the CUresult of
// cuTensorMapEncodeTiled when B's tensor map cannot be made (the encoder
// comes through the runtime, so no -lcuda). The caller allocates y and the
// scratch (wt: 2 x F x Kp fp32 for fp32 inputs, F x Kp for bf16, Kp = K
// rounded up to whole k-tiles of BK, passed in and checked against K; ws:
// split x M x F fp32 when split > 1) and guarantees contiguous tensors on
// the current device and fewer than 2^31 elements in each. The wrapper's launch
// counter counts its calls, one per conv, though a call launches the prep,
// the GEMM and, where split > 1, the reduce.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BM = 128;      // output pixels per block: two warpgroups of 64
constexpr int BK = 32;       // K per k-tile: one 128-byte row of fp32
constexpr int NT = 256;      // threads
constexpr int STAGES = 4;    // k-tiles in the ring
constexpr int B_ROW = BK * 4;  // bytes of a B row (fp32, 128B-swizzled)

struct ConvShape {
  int B, H, W, C, F, kh, kw, sh, sw, Ho, Wo, pad_top, pad_left;
};

// Shared memory of one stage: the B parts (hi, and lo for fp32), each
// BN rows of 128 bytes, then the A tile, BM rows of BK elements of T; every
// part 1024-byte aligned.
template <typename T, int BN>
struct Tile {
  static constexpr bool SPLIT = sizeof(T) == 4;   // fp32: 3xTF32
  static constexpr int NB = SPLIT ? 2 : 1;        // B parts
  static constexpr int B_BYTES = BN * B_ROW;
  static constexpr int A_BYTES = BM * BK * static_cast<int>(sizeof(T));
  static constexpr int STAGE = NB * B_BYTES + A_BYTES;
  static constexpr int BARS = STAGES * STAGE;      // an mbarrier per stage
  static constexpr int SMEM = BARS + 8 * STAGES + 1024;  // + alignment
  static constexpr int EPC = 16 / static_cast<int>(sizeof(T));  // per chunk
  static constexpr int CPR = BK / EPC;            // 16-byte chunks of a row
};

// byte offset of 16-byte chunk c of A row r: fp32 rows are 128 bytes, chunk
// c stored at c ^ (r % 8); bf16 rows are 64 bytes, two to a 128-byte line,
// chunk c at c ^ (r / 2 % 4). Either way the fragment loads of a warp (8
// rows, 4 columns) hit 32 distinct banks.
template <typename T>
__device__ __forceinline__ uint32_t a_off(int r, int c);
template <>
__device__ __forceinline__ uint32_t a_off<float>(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}
template <>
__device__ __forceinline__ uint32_t a_off<__nv_bfloat16>(int r, int c) {
  return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// one box of the 3-D tensor map over the prepped B at (k, n, part) into
// shared memory at dst, completing on the barrier
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int k, int n,
                                            int part) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k), "r"(n), "r"(part),
      "r"(bar)
      : "memory");
}

// y (or, with a split K, this range's slice of the workspace) for one
// block: BM output pixels x BN filters over the k-tiles
// [z * kt_per_split, (z + 1) * kt_per_split) of K. VEC: A gathered in
// 16-byte chunks (C a multiple of 16 / sizeof(T)), else element by element.
//
// Fragments (PTX ISA, wgmma .tf32): warp w of a warpgroup holds rows
// 16w .. 16w+15 of its 64; lane t holds A elements (row, k) = (t/4, t%4),
// (t/4 + 8, t%4), (t/4, t%4 + 4), (t/4 + 8, t%4 + 4) of each k-step of 8,
// and accumulator d[4i + 2h + e] = (row t/4 + 8h, column 8i + 2(t%4) + e).
template <typename T, int BN, bool VEC>
__global__ void __launch_bounds__(NT, 1)
conv_tc_kernel(const T* __restrict__ x, const __grid_constant__ CUtensorMap tb,
               T* __restrict__ y, float* __restrict__ ws, ConvShape s, int Kp,
               int kt_per_split) {
  using TL = Tile<T, BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // the swizzle's period
  uint8_t* const base_ptr = smem_raw + (base - raw);

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = tid % 128 / 32, lane = tid % 32;
  const int M = s.B * s.Ho * s.Wo, N = s.F, K = s.kh * s.kw * s.C;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int kt0 = blockIdx.z * kt_per_split;
  const int nk = min(kt_per_split, Kp / BK - kt0);
  const uint32_t bars = base + TL::BARS;  // stage s's barrier at bars + 8 s
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // A loader: this thread fills column a_col (a 16-byte chunk, or one
  // element) of rows a_row0 + i * A_STEP of every A tile
  constexpr int A_ROWS = VEC ? BM * TL::CPR / NT : BM * BK / NT;
  constexpr int A_STEP = VEC ? NT / TL::CPR : NT / BK;
  const int a_col = VEC ? tid % TL::CPR : tid % BK;
  const int a_row0 = VEC ? tid / TL::CPR : tid / BK;
  int a_img[A_ROWS], a_h[A_ROWS], a_w[A_ROWS];
#pragma unroll
  for (int i = 0; i < A_ROWS; ++i) {
    const int m = m0 + a_row0 + i * A_STEP;
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
  // k, and its (di, dj, c), of this thread's A column in the next k-tile to
  // load; k-tiles are loaded in order, so it advances by BK without
  // divisions (K is ordered (di, dj, c) as HWIO)
  int ld_k = kt0 * BK + (VEC ? a_col * TL::EPC : a_col);
  int ld_di = ld_k / s.C, ld_dj, ld_c = ld_k - ld_di * s.C;
  ld_dj = ld_di % s.kw;
  ld_di /= s.kw;

  // k-tile kt into a slot: B by TMA (one thread; rows past F read as
  // zeros), A by every thread's cp.async gathers
  auto load_stage = [&](int kt, int slot) {
    const uint32_t sb = base + slot * TL::STAGE;
    if (tid == 0) {
      mbar_expect_tx(bars + 8 * slot, TL::NB * TL::B_BYTES);
#pragma unroll
      for (int p = 0; p < TL::NB; ++p)
        tma_load_3d(sb + p * TL::B_BYTES, &tb, bars + 8 * slot, kt * BK, n0,
                    p);
    }
    const uint32_t sa = sb + TL::NB * TL::B_BYTES;
    const bool k_ok = ld_k < K;
#pragma unroll
    for (int i = 0; i < A_ROWS; ++i) {
      const int r = a_row0 + i * A_STEP;
      const int h = a_h[i] + ld_di, w = a_w[i] + ld_dj;
      const bool ok =
          k_ok && (unsigned)h < (unsigned)s.H && (unsigned)w < (unsigned)s.W;
      const T* src = ok ? x + a_img[i] + (h * s.W + w) * s.C + ld_c : x;
      if constexpr (VEC) {
        cp16(sa + a_off<T>(r, a_col), src, ok);
      } else {
        const uint32_t off = a_off<T>(r, a_col / TL::EPC) +
                             (a_col % TL::EPC) * static_cast<int>(sizeof(T));
        if constexpr (sizeof(T) == 4) {
          cp4(sa + off, src, ok);
        } else {  // 2-byte elements: no cp.async that small
          const unsigned short v =
              ok ? *reinterpret_cast<const unsigned short*>(src) : 0;
          *reinterpret_cast<unsigned short*>(base_ptr + (sa - base) + off) =
              v;
        }
      }
    }
    ld_k += BK;
    for (ld_c += BK; ld_c >= s.C; ld_c -= s.C)
      if (++ld_dj == s.kw) {
        ld_dj = 0;
        ++ld_di;
      }
  };

  // A fragments of one k-tile, split: the TF32 high parts and (fp32) the
  // remainders, per k-step of 8
  using Frag = uint32_t[BK / 8][4];
  const int fr = wg * 64 + warp * 16 + lane / 4;  // fragment rows fr, fr + 8
  const int fc = lane % 4;                        // columns fc, fc + 4
  auto load_frag = [&](int slot, Frag& hi, Frag& lo) {
    const uint8_t* const ap =
        base_ptr + slot * TL::STAGE + TL::NB * TL::B_BYTES;
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = fr + 8 * (q & 1), kk = ks * 8 + fc + 4 * (q >> 1);
        const float v = widen(*reinterpret_cast<const T*>(
            ap + a_off<T>(r, kk / TL::EPC) +
            (kk % TL::EPC) * static_cast<int>(sizeof(T))));
        if constexpr (TL::SPLIT) {
          hi[ks][q] = tf32_rna(v);
          lo[ks][q] = __float_as_uint(v - __uint_as_float(hi[ks][q]));
        } else {
          hi[ks][q] = __float_as_uint(v);  // bf16: exact in TF32
          lo[ks][q] = 0;
        }
      }
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  // One k-tile: its wgmmas are issued, and while they run the copies of
  // k-tile j + STAGES - 1 are started and k-tile j + 1's fragments are read
  // into the other register set; then the wgmmas are waited for.
  auto step = [&](int j, const Frag& hi, const Frag& lo, Frag& next_hi,
                  Frag& next_lo) {
    const uint32_t sb = base + (j % STAGES) * TL::STAGE;
    pin(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) {
      const uint64_t d_hi = sw128_desc(sb + ks * 32, 16, 8 * B_ROW);
      if constexpr (TL::SPLIT) {
        const uint64_t d_lo =
            sw128_desc(sb + TL::B_BYTES + ks * 32, 16, 8 * B_ROW);
        wgmma_tf32<BN>(acc, lo[ks], d_hi);
        wgmma_tf32<BN>(acc, hi[ks], d_lo);
      }
      wgmma_tf32<BN>(acc, hi[ks], d_hi);
    }
    wgmma_commit();
    if (j + 1 < nk) {
      cp_wait<STAGES - 3>();  // this thread's copies of k-tile j + 1 landed
      mbar_wait(bars + 8 * ((j + 1) % STAGES), (j + 1) / STAGES & 1);  // B
      // everyone's have; every wgmma on k-tile j - 1 is done
      __syncthreads();
      const int jn = j + STAGES - 1;  // refills the slot of k-tile j - 1
      if (jn < nk) load_stage(kt0 + jn, jn % STAGES);
      cp_commit();
      load_frag((j + 1) % STAGES, next_hi, next_lo);
    }
    wgmma_wait_all();
    pin(acc);
  };

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < nk) load_stage(kt0 + i, i);
    cp_commit();
  }
  Frag hi0, lo0, hi1, lo1;
  cp_wait<STAGES - 2>();  // k-tile 0
  mbar_wait(bars, 0);
  __syncthreads();
  load_frag(0, hi0, lo0);
  for (int j = 0; j < nk; j += 2) {
    step(j, hi0, lo0, hi1, lo1);
    if (j + 1 < nk) step(j + 1, hi1, lo1, hi0, lo0);
  }

  // epilogue: y in T, or this K range's fp32 partial sums
  const int z = blockIdx.z;
  const bool pair = N % 2 == 0;  // 2 columns per store stay aligned
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + fr + 8 * h;
    if (m >= M) continue;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int n = n0 + 8 * i + 2 * fc;
      if (n >= N) continue;
      const float v0 = acc[4 * i + 2 * h], v1 = acc[4 * i + 2 * h + 1];
      const int idx = m * N + n;
      if (gridDim.z > 1) {
        float* const out = ws + z * M * N + idx;
        if (pair)
          *reinterpret_cast<float2*>(out) = make_float2(v0, v1);
        else {
          out[0] = v0;
          if (n + 1 < N) out[1] = v1;
        }
      } else if constexpr (sizeof(T) == 4) {
        float* const out = reinterpret_cast<float*>(y) + idx;
        if (pair)
          *reinterpret_cast<float2*>(out) = make_float2(v0, v1);
        else {
          out[0] = v0;
          if (n + 1 < N) out[1] = v1;
        }
      } else {
        __nv_bfloat16* const out = reinterpret_cast<__nv_bfloat16*>(y) + idx;
        if (pair)
          *reinterpret_cast<__nv_bfloat162*>(out) =
              __floats2bfloat162_rn(v0, v1);
        else {
          out[0] = __float2bfloat16(v0);
          if (n + 1 < N) out[1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

// w (K x F, F contiguous) -> wt (F x Kp, K contiguous, zero past K) as hi =
// tf32(w) and, for fp32, lo = w - hi at wt + F * Kp; 32 x 32 tiles
// transposed through shared memory
template <typename T>
__global__ void __launch_bounds__(256)
prep_kernel(const T* __restrict__ w, float* __restrict__ wt, int K, int F,
            int Kp) {
  __shared__ float tile[32][33];
  const int k0 = blockIdx.x * 32, f0 = blockIdx.y * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
#pragma unroll
  for (int r = ty; r < 32; r += 8) {
    const int k = k0 + r, f = f0 + tx;
    tile[r][tx] = k < K && f < F ? widen(w[k * F + f]) : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int r = ty; r < 32; r += 8) {
    const int f = f0 + r, k = k0 + tx;
    if (f >= F) continue;
    const float v = tile[tx][r];
    const float hi = __uint_as_float(tf32_rna(v));
    wt[f * Kp + k] = hi;
    if constexpr (sizeof(T) == 4) wt[(F + f) * Kp + k] = v - hi;
  }
}

// y = sum over the split ranges of the workspace, in range order, cast to T
template <typename T>
__global__ void __launch_bounds__(256)
reduce_kernel(const float* __restrict__ ws, T* __restrict__ y, int split,
              int MN) {
  const int stride = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  if (MN % 4 == 0) {
    for (int i = first; i < MN / 4; i += stride) {
      float4 a = reinterpret_cast<const float4*>(ws)[i];
      for (int z = 1; z < split; ++z) {
        const float4 b = reinterpret_cast<const float4*>(ws + z * MN)[i];
        a.x += b.x;
        a.y += b.y;
        a.z += b.z;
        a.w += b.w;
      }
      if constexpr (sizeof(T) == 4) {
        reinterpret_cast<float4*>(y)[i] = a;
      } else {
        __nv_bfloat162* const out =
            reinterpret_cast<__nv_bfloat162*>(y) + 2 * i;
        out[0] = __floats2bfloat162_rn(a.x, a.y);
        out[1] = __floats2bfloat162_rn(a.z, a.w);
      }
    }
  } else {
    for (int i = first; i < MN; i += stride) {
      float a = ws[i];
      for (int z = 1; z < split; ++z) a += ws[z * MN + i];
      if constexpr (sizeof(T) == 4)
        reinterpret_cast<float*>(y)[i] = a;
      else
        reinterpret_cast<__nv_bfloat16*>(y)[i] = __float2bfloat16(a);
    }
  }
}

int round_up_k(int K) { return (K + BK - 1) / BK * BK; }

// the wrapper allocates wt with rows of Kp; a Kp that is not K rounded up
// to whole k-tiles means the two sides disagree on the layout
template <typename T>
int prep(const void* w, void* wt, int K, int F, int Kp, cudaStream_t stream) {
  if (Kp != round_up_k(K)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(Kp / 32, (F + 31) / 32);
  prep_kernel<T><<<grid, 256, 0, stream>>>(static_cast<const T*>(w),
                                          static_cast<float*>(wt), K, F, Kp);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int reduce(const void* ws, void* y, int split, int MN, cudaStream_t stream) {
  const int vec = MN % 4 == 0 ? MN / 4 : MN;
  const int blocks = min((vec + 255) / 256, 132 * 8);
  reduce_kernel<T><<<blocks, 256, 0, stream>>>(static_cast<const float*>(ws),
                                              static_cast<T*>(y), split, MN);
  return static_cast<int>(cudaGetLastError());
}

// the prepped B, (parts, F, Kp) fp32, as a 3-D tensor map read in boxes of
// 32 k x block_n rows, 128-byte swizzled as the wgmma descriptors read them
int make_b_map(CUtensorMap* map, const void* wt, int parts, int F, int Kp,
               int block_n) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return MAP_ERROR + CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(Kp),
                              static_cast<cuuint64_t>(F),
                              static_cast<cuuint64_t>(parts)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(Kp) * 4,
                                 static_cast<cuuint64_t>(F) * Kp * 4};
  const cuuint32_t box[3] = {BK, static_cast<cuuint32_t>(block_n), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(wt), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : MAP_ERROR + static_cast<int>(r);
}

template <typename T, int BN, bool VEC>
int launch_main(const void* x, const void* wt, void* y, void* ws,
                const ConvShape& s, int Kp, int split, cudaStream_t stream) {
  using TL = Tile<T, BN>;
  CUtensorMap tb;
  const int rc = make_b_map(&tb, wt, TL::NB, s.F, Kp, BN);
  if (rc != 0) return rc;
  auto* kern = conv_tc_kernel<T, BN, VEC>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, TL::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int M = s.B * s.Ho * s.Wo;
  const int kt_per_split = (Kp / BK + split - 1) / split;
  const dim3 grid((M + BM - 1) / BM, (s.F + BN - 1) / BN, split);
  kern<<<grid, NT, TL::SMEM, stream>>>(static_cast<const T*>(x), tb,
                                       static_cast<T*>(y),
                                       static_cast<float*>(ws), s, Kp,
                                       kt_per_split);
  return static_cast<int>(cudaGetLastError());
}

// prep, the main kernel over `split` K ranges, then (split > 1) the reduce
template <typename T>
int run(const void* x, const void* w, void* y, void* wt, void* ws, int B,
        int H, int W, int C, int F, int kh, int kw, int sh, int sw, int Ho,
        int Wo, int pad_top, int pad_left, int Kp, int block_n, int split,
        void* stream) {
  const ConvShape s{B, H, W, C, F, kh, kw, sh, sw, Ho, Wo, pad_top, pad_left};
  const int K = kh * kw * C, k_tiles = round_up_k(K) / BK;
  // every one of the split ranges must hold at least one k-tile
  if (Kp != round_up_k(K) || split < 1 ||
      (split - 1) * ((k_tiles + split - 1) / split) >= k_tiles ||
      (block_n != 64 && block_n != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  int rc = prep<T>(w, wt, K, F, Kp, st);
  if (rc != 0) return rc;
  const bool vec = C % Tile<T, 64>::EPC == 0;
  if (block_n == 64)
    rc = vec ? launch_main<T, 64, true>(x, wt, y, ws, s, Kp, split, st)
             : launch_main<T, 64, false>(x, wt, y, ws, s, Kp, split, st);
  else
    rc = vec ? launch_main<T, 128, true>(x, wt, y, ws, s, Kp, split, st)
             : launch_main<T, 128, false>(x, wt, y, ws, s, Kp, split, st);
  if (rc != 0 || split == 1) return rc;
  return reduce<T>(ws, y, split, B * Ho * Wo * F, st);
}

}  // namespace

extern "C" int conv2d_gemm_f32(const void* x, const void* w, void* y,
                               void* wt, void* ws, int B, int H, int W, int C,
                               int F, int kh, int kw, int sh, int sw, int Ho,
                               int Wo, int pad_top, int pad_left, int Kp,
                               int block_n, int split, void* stream) {
  return run<float>(x, w, y, wt, ws, B, H, W, C, F, kh, kw, sh, sw, Ho, Wo,
                    pad_top, pad_left, Kp, block_n, split, stream);
}

extern "C" int conv2d_gemm_bf16(const void* x, const void* w, void* y,
                                void* wt, void* ws, int B, int H, int W,
                                int C, int F, int kh, int kw, int sh, int sw,
                                int Ho, int Wo, int pad_top, int pad_left,
                                int Kp, int block_n, int split, void* stream) {
  return run<__nv_bfloat16>(x, w, y, wt, ws, B, H, W, C, F, kh, kw, sh, sw,
                            Ho, Wo, pad_top, pad_left, Kp, block_n, split,
                            stream);
}

// the prep and reduce passes alone, for timing them apart
extern "C" int conv2d_gemm_prep_f32(const void* w, void* wt, int K, int F,
                                    int Kp, void* stream) {
  return prep<float>(w, wt, K, F, Kp, static_cast<cudaStream_t>(stream));
}
extern "C" int conv2d_gemm_prep_bf16(const void* w, void* wt, int K, int F,
                                     int Kp, void* stream) {
  return prep<__nv_bfloat16>(w, wt, K, F, Kp,
                             static_cast<cudaStream_t>(stream));
}
extern "C" int conv2d_gemm_reduce_f32(const void* ws, void* y, int split,
                                      int MN, void* stream) {
  return reduce<float>(ws, y, split, MN, static_cast<cudaStream_t>(stream));
}
extern "C" int conv2d_gemm_reduce_bf16(const void* ws, void* y, int split,
                                       int MN, void* stream) {
  return reduce<__nv_bfloat16>(ws, y, split, MN,
                               static_cast<cudaStream_t>(stream));
}
