// Mamba-2 SSD chunk computation for Hopper (sm_90a), fp32. For every
// (batch b, chunk c of Q positions, head h), with cum = cumsum(dt * A) over
// the chunk and L_ij = exp(cum_i - cum_j) for j <= i:
//   y_intra[i, :]  = sum_{j <= i} (C_i . B_j) * L_ij * dt_j * x[j, :]
//   state[:, :]    = sum_j exp(cum_end - cum_j) * dt_j * x[j, :] (x) B[j, :]
//   decay          = exp(cum_end)
//
// Replaces the Pallas kernel src/repro/kernels/ssd_scan/ssd_scan.py:
// _ssd_chunk_kernel (launched by ssd_chunk at :69). Its numerics are kept:
// fp32 throughout, w = scores * L * dt in that order, the state weight
// exp(cum_end - cum_j) * dt_j applied to x before the product with B.
// What changes with the machine:
//   * the TPU program holds one (batch, chunk)'s (H, Q, Q) fp32 scores in
//     VMEM (12 MiB at Q = 256); an H100 block has 227 KB. So the grid is
//     (b * nC * H, Q/64 + 1): blocks y = 0 .. Q/64 - 1 each compute one
//     64-row tile of y_intra (the heaviest, last tile first), walking the
//     64-row j tiles at or below the diagonal; block y = Q/64 computes the
//     chunk state and decay. 1536 x 5 blocks at Mamba-2 780m's prompt pass.
//   * the decay is exp(cum_i - cum_j) per pair, never exp(cum_i) *
//     exp(-cum_j): with A down to -48, cum falls to -10^3 within a chunk
//     and the factorised form overflows to inf, then NaN.
//   * cum is a prefix sum in the block (one warp, 32 positions a step), in
//     another order than torch.cumsum; the kernel's bar covers that.
//   * a ragged chunk (Q = 250 for S = 1000) is masked, not padded.
//
// What bounds it on the H100: per (b, c, h) it does Q(Q+1)/2 * 2N + Q(Q+1)/2
// * 2P + 2QPN FLOP (26 GFLOP a launch at (4, 2048, 48, 64), N 128, Q 256)
// on ~0.26 GB of traffic: ~100 FLOP per byte, so operations, on the fp32
// FMA pipes (67 TFLOP/s; the reference's arithmetic is fp32). Its effort
// goes into reuse: each block stages its C tile once and each B and x tile
// through shared memory (rows padded by 4 floats so the 16-byte reads of a
// quarter-warp hit distinct banks), and every thread keeps a 4x4 tile of
// scores and of y (or a 4x8 tile of the state) in registers. wgmma, TMA and
// split-bf16 are later work.
//
// Each input is addressed through its own element strides over b, s and h
// (the last dim unit-stride; dt any stride), so B and C may be expand views
// with a head stride of 0 (Mamba-2's one group shared by every head). The
// outputs are dense: y (B, S, H, P), states (B, nC, H, P, N), decays
// (B, nC, H).
//
// Plain C interface, loaded with ctypes; the entry returns the CUDA error
// code of its launch (0 on success). The caller allocates the outputs and
// guarantees tensors on the current device, P <= 64, N <= 128, Q <= 8192.
#include <cuda_runtime.h>

namespace {

constexpr int T = 64;         // positions per tile
constexpr int NT = 256;       // threads: 16 row groups x 16 columns
constexpr int NMAX = 128;     // largest state size N
constexpr int PMAX = 64;      // largest head dim P
constexpr int NS = NMAX + 4;  // row stride (floats) of the C and B tiles
constexpr int XS = PMAX + 4;  // row stride (floats) of the x tile
constexpr int WS = T + 4;     // row stride (floats) of the transposed w tile
constexpr int TILE_FLOATS = 2 * T * NS + T * XS + T * WS;

// element strides of one input over b, s and h
struct Strides {
  long long b, s, h;
};
struct Layout {
  Strides x, dt, B, C;
};

// rows [row0, row0 + 64) of a chunk's (Q, cols) matrix with row stride ld
// into a [64][lds] fp32 tile: rows past Q and columns in [cols, fill) are
// zero; with `scale`, row r is multiplied by scale[row0 + r]
__device__ __forceinline__ void load_tile(const float* __restrict__ src,
                                          long long ld, int row0, int Q,
                                          int cols, int fill, float* dst,
                                          int lds, const float* scale) {
  for (int idx = threadIdx.x; idx < T * fill; idx += NT) {
    const int r = idx / fill;
    const int col = idx - r * fill;
    const int row = row0 + r;
    float v = 0.f;
    if (row < Q && col < cols) {
      v = src[row * ld + col];
      if (scale != nullptr) v *= scale[row];
    }
    dst[r * lds + col] = v;
  }
}

__global__ void __launch_bounds__(NT, 2)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const float* __restrict__ Bm,
                 const float* __restrict__ Cm, float* __restrict__ y,
                 float* __restrict__ states, float* __restrict__ decays,
                 Layout L, int nC, int Q, int H, int P, int N) {
  extern __shared__ __align__(16) float smem[];
  float* Cs = smem;            // [T][NS]  C rows of the i tile
  float* Bs = Cs + T * NS;     // [T][NS]  B rows of a j tile
  float* Xs = Bs + T * NS;     // [T][XS]  x rows of a j tile
  float* Wt = Xs + T * XS;     // [T][WS]  w of an (i, j) tile, transposed
  float* cum = Wt + T * WS;    // [Q]      cumsum of dt * A
  float* dts = cum + Q;        // [Q]      dt (the state weights, later)

  const int h = blockIdx.x % H;
  const int c = (blockIdx.x / H) % nC;
  const long long b = blockIdx.x / (H * nC);
  const long long s0 = static_cast<long long>(c) * Q;  // chunk's first position
  x += b * L.x.b + h * L.x.h + s0 * L.x.s;
  dt += b * L.dt.b + h * L.dt.h + s0 * L.dt.s;
  Bm += b * L.B.b + h * L.B.h + s0 * L.B.s;
  Cm += b * L.C.b + h * L.C.h + s0 * L.C.s;
  const int tid = threadIdx.x;
  const int ty = tid / 16;  // rows ty*4 .. ty*4+3 of an output tile
  const int tx = tid % 16;
  const int N4 = (N + 3) & ~3;
  const int P4 = (P + 3) & ~3;

  for (int s = tid; s < Q; s += NT) dts[s] = dt[s * L.dt.s];
  __syncthreads();
  if (tid < 32) {  // inclusive prefix sum of dt * A, 32 positions a step
    const float a = A[h];
    float carry = 0.f;
    for (int base = 0; base < Q; base += 32) {
      const int s = base + tid;
      float v = s < Q ? dts[s] * a : 0.f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float n = __shfl_up_sync(0xffffffffu, v, off);
        if (tid >= off) v += n;
      }
      v += carry;
      if (s < Q) cum[s] = v;
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
  }
  __syncthreads();

  const int nI = (Q + T - 1) / T;
  if (blockIdx.y < nI) {
    // ---- one 64-row tile of y_intra: rows i0 .. i0+63 of the chunk ----
    const int i0 = (nI - 1 - blockIdx.y) * T;  // heaviest tiles first
    load_tile(Cm, L.C.s, i0, Q, N, N4, Cs, NS, nullptr);
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

    for (int j0 = 0; j0 <= i0; j0 += T) {  // j tiles at or below the diagonal
      __syncthreads();  // the previous B, x and w tiles are consumed
      load_tile(Bm, L.B.s, j0, Q, N, N4, Bs, NS, nullptr);
      load_tile(x, L.x.s, j0, Q, P, P4, Xs, XS, nullptr);
      __syncthreads();

      float sc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N4; n += 4) {
        float4 cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          cv[i] = *reinterpret_cast<const float4*>(&Cs[(ty * 4 + i) * NS + n]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bv[j] = *reinterpret_cast<const float4*>(&Bs[(tx + 16 * j) * NS + n]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            sc[i][j] = fmaf(cv[i].x, bv[j].x, sc[i][j]);
            sc[i][j] = fmaf(cv[i].y, bv[j].y, sc[i][j]);
            sc[i][j] = fmaf(cv[i].z, bv[j].z, sc[i][j]);
            sc[i][j] = fmaf(cv[i].w, bv[j].w, sc[i][j]);
          }
      }

      // w_ij = (C_i . B_j) * exp(cum_i - cum_j) * dt_j for j <= i < Q
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int gi = i0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int gj = j0 + tx + 16 * j;
          sc[i][j] = (gj <= gi && gi < Q)
                         ? sc[i][j] * expf(cum[gi] - cum[gj]) * dts[gj]
                         : 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float4*>(&Wt[(tx + 16 * j) * WS + ty * 4]) =
            make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
      __syncthreads();  // w is in place

      if (tx * 4 < P4) {
#pragma unroll 4
        for (int jj = 0; jj < T; ++jj) {
          const float4 wv = *reinterpret_cast<const float4*>(&Wt[jj * WS + ty * 4]);
          const float4 xv = *reinterpret_cast<const float4*>(&Xs[jj * XS + tx * 4]);
          const float wr[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][0] = fmaf(wr[i], xv.x, acc[i][0]);
            acc[i][1] = fmaf(wr[i], xv.y, acc[i][1]);
            acc[i][2] = fmaf(wr[i], xv.z, acc[i][2]);
            acc[i][3] = fmaf(wr[i], xv.w, acc[i][3]);
          }
        }
      }
    }

    // y is dense (B, S, H, P): position s of head h at (s * H + h) * P
    const long long ld = static_cast<long long>(H) * P;
    float* out = y + ((b * nC + c) * Q) * ld + static_cast<long long>(h) * P;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gi = i0 + ty * 4 + i;
      if (gi >= Q) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = tx * 4 + e;
        if (p < P) out[gi * ld + p] = acc[i][e];
      }
    }
    return;
  }

  // ---- the chunk state (P x N) and decay ----
  const float cend = cum[Q - 1];
  for (int s = tid; s < Q; s += NT) dts[s] = expf(cend - cum[s]) * dts[s];
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e] = 0.f;

  for (int j0 = 0; j0 < Q; j0 += T) {
    __syncthreads();  // the weights are written; the previous tiles consumed
    load_tile(x, L.x.s, j0, Q, P, P4, Xs, XS, dts);
    load_tile(Bm, L.B.s, j0, Q, N, N4, Bs, NS, nullptr);
    __syncthreads();
    if (ty * 4 < P4) {
#pragma unroll 4
      for (int jj = 0; jj < T; ++jj) {
        const float4 xv = *reinterpret_cast<const float4*>(&Xs[jj * XS + ty * 4]);
        const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int n0 = tx * 4 + 64 * hh;
          if (n0 >= N4) continue;
          const float4 bv = *reinterpret_cast<const float4*>(&Bs[jj * NS + n0]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][4 * hh + 0] = fmaf(xr[i], bv.x, acc[i][4 * hh + 0]);
            acc[i][4 * hh + 1] = fmaf(xr[i], bv.y, acc[i][4 * hh + 1]);
            acc[i][4 * hh + 2] = fmaf(xr[i], bv.z, acc[i][4 * hh + 2]);
            acc[i][4 * hh + 3] = fmaf(xr[i], bv.w, acc[i][4 * hh + 3]);
          }
        }
      }
    }
  }

  const long long bch = (b * nC + c) * H + h;
  float* st = states + bch * P * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = ty * 4 + i;
    if (p >= P) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = tx * 4 + 64 * hh + e;
        if (n < N) st[p * N + n] = acc[i][4 * hh + e];
      }
  }
  if (tid == 0) decays[bch] = expf(cend);
}

}  // namespace

// strides: 12 values, (b, s, h) of x, dt, Bm and Cm in that order
extern "C" int ssd_chunk_f32(const void* x, const void* dt, const void* A,
                             const void* Bm, const void* Cm, void* y,
                             void* states, void* decays, int B, int nC, int Q,
                             int H, int P, int N, const long long* strides,
                             void* stream) {
  Layout L;
  Strides* dst[4] = {&L.x, &L.dt, &L.B, &L.C};
  for (int i = 0; i < 4; ++i)
    *dst[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const size_t smem = (TILE_FLOATS + 2 * static_cast<size_t>(Q)) * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * nC * H, (Q + T - 1) / T + 1);
  ssd_chunk_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<float*>(y),
      static_cast<float*>(states), static_cast<float*>(decays), L, nC, Q, H,
      P, N);
  return static_cast<int>(cudaGetLastError());
}
