// Mamba-2 SSD chunk computation for Hopper (sm_90a) on the tensor cores,
// fp32 in and out. For every (batch b, chunk c of Q positions, head h), with
// cum = cumsum(dt * A) over the chunk and L_ij = exp(cum_i - cum_j) for
// j <= i:
//   y_intra[i, :]  = sum_{j <= i} (C_i . B_j) * L_ij * dt_j * x[j, :]
//   state[:, :]    = sum_j exp(cum_end - cum_j) * dt_j * x[j, :] (x) B[j, :]
//   decay          = exp(cum_end)
//
// Replaces the Pallas kernel src/repro/kernels/ssd_scan/ssd_scan.py:
// _ssd_chunk_kernel (launched by ssd_chunk at :69). Its numerics are kept:
// fp32 products summed in fp32, w = scores * L * dt in that order, the state
// weight exp(cum_end - cum_j) * dt_j applied before the product, the decay
// exp(cum_i - cum_j) per pair, never exp(cum_i) * exp(-cum_j): with A down to
// -48, cum falls to -10^3 within a chunk and the factorised form overflows
// to inf, then NaN. cum is a prefix sum in one warp, 32 positions a step, in
// another order than torch.cumsum; the bar covers that.
//
// What bounds it on the H100: operations. Per (b, c, h) it does Q(Q+1)/2 *
// 2N + Q(Q+1)/2 * 2P + 2QPN useful FLOP (25.8 GFLOP a launch at (4, 2048, 48,
// 64), N 128, Q 256) on ~0.26 GB of traffic. The three contractions run on
// wgmma (m64n64k8 .tf32, fp32 accumulation) as 3xTF32: each operand v is
// split into hi = cvt.rna.tf32(v) and lo = v - hi (exact in fp32; the tensor
// core reads lo as TF32 by dropping its low 13 bits), and every k-step of 8
// accumulates lo_a*hi_b, hi_a*lo_b, then hi_a*hi_b. One TF32 pass in any one
// of the three reads 2-5x the kernel's fp32 bar (1e-4 of max |plain|)
// (kernels/ssd_scan/emulate.py, the arithmetic in plain torch). The bound is
// the TF32 peak over the three products: 495/3 = 165 TFLOP/s of useful work.
//
// Operand placement. TF32 wgmma reads a shared-memory operand K-major only;
// A alone may come from registers. So:
//   * scores = C_i . B_j^T (64 x 64, K = N): C_i, N-contiguous, is the A
//     operand, loaded and split once into registers; B_j, N-contiguous
//     (K-major as stored), is the shared operand, as its hi and lo parts.
//   * y_i += W . x_j (64 x P, K = the 64 positions j): W = scores * L * dt is
//     formed on the scores accumulator and split there as the A operand. The
//     accumulator holds columns {2t, 2t+1} of each group of 8 (t = lane % 4),
//     an A fragment columns {t, t+4}; so x_j^T's K order is permuted within
//     each group of 8 (physical column t + 4e holds position 2t + e), and W's
//     registers feed the A fragment as they are.
//   * state = (w . x)^T . B (P x N, K = the positions j), the reference's
//     form (the weight on x): A = x[j, p] * w_j, read from the raw x tile
//     and split in registers; the shared operand is B_j^T (rows n, j
//     contiguous) as hi and lo parts, 64 columns n per warpgroup.
// Shared operands are 128-byte swizzled as the wgmma descriptors read them
// (rows of 32 fp32; 16-byte chunk c of row r at c ^ (r % 8)).
//
// Two kernels a call:
//   * prep: per (b, chunk, group of B, 64-position tile j), B_j's and
//     B_j^T's hi and lo parts as the 64 KB images the main kernel's shared
//     memory holds, so a block loads one with bulk copies and splits
//     nothing; with B shared by every head (head stride 0, Mamba-2's one
//     group) that is once per (b, chunk), not per head. And per (b, chunk,
//     head), one warp each: cum, dt and the state weights w_j, zero past Q.
//   * main: blocks of two warpgroups (256 threads), one per SM (226 KB of
//     shared memory), grid (b * nC * H, Q/128 + 1). Blocks y < Q/128 compute
//     128 rows of y_intra, 64 per warpgroup (the heaviest rows first),
//     walking the j tiles at or below their diagonal; block y = Q/128
//     computes the chunk state, n columns 0-63 and 64-127 one warpgroup
//     each, and the decay. A ring of two stages: while tile j is multiplied,
//     tile j+1's image and cum/dt/w slices are in flight by TMA (one
//     thread, completing on the stage's mbarrier) and x_{j+2} by cp.async
//     into one of two raw buffers. The y blocks split x (per head, so in the
//     block: transposed and permuted as above) a tile ahead, each warpgroup
//     its half of x_{j+1} under its scores batch; C_i is split once, so the
//     scores' 48 wgmmas go as one batch: issued, then the split, then waited
//     for (a wgmma with A in registers holds its warp until the tensor core
//     takes it); y's 24 go in two groups of 12; one barrier a step, so one
//     warpgroup's W can run under the other's wgmmas. The state block reads
//     x raw (24 wgmmas a tile, two barriers a step). The y rows and the
//     state have loops of their own, so each keeps only its registers. The
//     exponent in W is the SFU's (__expf: a few ulp where |cum_i - cum_j| <
//     20, where L matters; the prep's state weights use expf).
// Tiles past Q, P or N are zero-filled and computed: a ragged chunk (Q = 250
// for S = 1000) and small P and N are padded to whole 64 x 64 (P) and 128
// (N) tiles. No atomics: the same inputs give bitwise the same outputs in
// every call.
//
// Each input is addressed through its own element strides over b, s and h
// (the last dim unit-stride; dt any stride), so B and C may be expand views
// with a head stride of 0 (Mamba-2's one group shared by every head). The
// outputs are dense: y (B, S, H, P), states (B, nC, H, P, N), decays
// (B, nC, H).
//
// Plain C interface, loaded with ctypes; each entry returns the CUDA error
// code of its last launch (0 on success). The caller allocates the outputs
// and the scratch (bimg: B * nC * G * nJ images of 16384 fp32, G = 1 where
// B's head stride is 0, else H, nJ = ceil(Q / 64); aux: B * nC * H * 3 * nJ
// * 64 fp32, 16-byte aligned) and guarantees tensors on the current device,
// P <= 64, N <= 128. The wrapper's launch counter counts its calls, one per
// chunk computation, though a call launches the prep and the main kernel.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int T = 64;         // positions per tile, rows of every operand tile
constexpr int NT = 256;       // threads of a main block: two warpgroups
constexpr int NMAX = 128;     // largest state size N
constexpr int PMAX = 64;      // largest head dim P
constexpr int ROW = 128;      // bytes of a swizzled row: 32 fp32
constexpr int B_PART = T * NMAX * 4;   // one part (hi or lo) of B_j: 32 KB
constexpr int X_PART = PMAX * T * 4;   // one part of x_j^T: 16 KB
constexpr int B_IMG = 2 * B_PART;      // B_j's (or B_j^T's) image: hi, lo
constexpr int TILE_IMGS = 2 * B_IMG;   // a tile's images in the scratch
constexpr int AUX = 3 * T * 4;         // cum, dt, w of a tile's positions
// a stage: B image, then x_j^T hi and lo (1024-byte aligned); two stages,
// two raw x tiles (64 positions x 64 p), two stages' aux slices, a barrier
// per stage
constexpr int S_XT = B_IMG;
constexpr int STAGE = S_XT + 2 * X_PART;
constexpr int S_RAW = 2 * STAGE;
constexpr int S_AUX = S_RAW + 2 * X_PART;
constexpr int S_BAR = S_AUX + 2 * AUX;
// + room to align a base that is 16-byte aligned: 231,936 of the 232,448
// bytes a block may have
constexpr int SMEM = S_BAR + 16 + 1008;

// element strides of one input over b, s and h
struct Strides {
  long long b, s, h;
};
struct Layout {
  Strides x, dt, B, C;
};

// byte offset of element (r, k) of a K-major tile of `rows` rows in
// shared memory: columns in blocks of 32 of rows x 128 bytes, 128-byte
// swizzled (16-byte chunk c of row r at c ^ (r % 8))
__device__ __forceinline__ uint32_t nat_off(int r, int k, int rows) {
  return (k >> 5) * rows * ROW + r * ROW + ((((k >> 2) & 7) ^ (r & 7)) << 4) +
         ((k & 3) << 2);
}

__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// ---- prep ----

// blocks [0, n_img): B_j's image for (b, c, g, jt), written in image order
// (coalesced); then one warp per (b, c, h): cum, dt and w over the chunk
__global__ void __launch_bounds__(256)
ssd_prep_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                const float* __restrict__ Bm, float* __restrict__ bimg,
                float* __restrict__ aux, Layout L, int Bsz, int nC, int Q,
                int H, int N, int G, int n_img) {
  const int nJ = (Q + T - 1) / T, Qp = nJ * T;
  if (static_cast<int>(blockIdx.x) < n_img) {
    const int jt = blockIdx.x % nJ;
    const int g = blockIdx.x / nJ % G;
    const int c = blockIdx.x / (nJ * G) % nC;
    const long long b = blockIdx.x / (nJ * G * nC);
    const float* src = Bm + b * L.B.b + g * L.B.h +
                       (static_cast<long long>(c) * Q + jt * T) * L.B.s;
    __shared__ float tile[T][NMAX + 1];  // B_j, rows padded: 32 banks
    for (int e = threadIdx.x; e < T * NMAX; e += 256) {
      const int r = e / NMAX, n = e % NMAX;
      tile[r][n] = jt * T + r < Q && n < N ? src[r * L.B.s + n] : 0.f;
    }
    __syncthreads();
    float* const out =
        bimg + static_cast<long long>(blockIdx.x) * (TILE_IMGS / 4);
    for (int o = threadIdx.x; o < B_PART / 4; o += 256) {
      const int w = o % 32;
      uint32_t hi, lo;
      {  // B_j: rows j, K = n
        const int r = o / 32 % T;
        const int n = o / (T * 32) * 32 + ((w / 4) ^ (r & 7)) * 4 + w % 4;
        split(tile[r][n], hi, lo);
        out[o] = __uint_as_float(hi);
        out[B_PART / 4 + o] = __uint_as_float(lo);
      }
      {  // B_j^T: rows n, K = j
        const int n = o / 32 % NMAX;
        const int j = o / (NMAX * 32) * 32 + ((w / 4) ^ (n & 7)) * 4 + w % 4;
        split(tile[j][n], hi, lo);
        out[B_IMG / 4 + o] = __uint_as_float(hi);
        out[B_IMG / 4 + B_PART / 4 + o] = __uint_as_float(lo);
      }
    }
    return;
  }
  const int lane = threadIdx.x % 32;
  const long long bch = (blockIdx.x - n_img) * 8ll + threadIdx.x / 32;
  if (bch >= static_cast<long long>(Bsz) * nC * H) return;
  const int h = bch % H, c = bch / H % nC;
  const long long b = bch / (static_cast<long long>(H) * nC);
  dt += b * L.dt.b + h * L.dt.h + static_cast<long long>(c) * Q * L.dt.s;
  float* const cum = aux + bch * 3 * Qp;
  float* const dts = cum + Qp;
  float* const wts = dts + Qp;
  const float a = A[h];
  float carry = 0.f;
  for (int base = 0; base < Qp; base += 32) {  // inclusive prefix sum of dt*A
    const int i = base + lane;
    const float d = i < Q ? dt[i * L.dt.s] : 0.f;
    float v = d * a;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float n = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += n;
    }
    v += carry;
    cum[i] = i < Q ? v : 0.f;
    dts[i] = d;
    carry = __shfl_sync(0xffffffffu, v, 31);
  }
  __syncwarp();
  const float cend = cum[Q - 1];
  for (int i = lane; i < Qp; i += 32)
    wts[i] = i < Q ? expf(cend - cum[i]) * dts[i] : 0.f;
}

// ---- main ----

// rows [j0, j0 + 64) of a chunk's (Q x cols) matrix with row stride ld, as
// they are, into the raw 64 x 64 tile at dst, zero past Q and cols: 16-byte
// cp.async where vec (cols, ld and the base multiples of 4 floats), else
// 4-byte. The caller commits and waits.
__device__ __forceinline__ void copy_rows(const float* __restrict__ src,
                                          long long ld, int j0, int Q,
                                          int cols, bool vec, uint32_t dst) {
  if (vec) {
    for (int idx = threadIdx.x; idx < T * PMAX / 4; idx += NT) {
      const int r = idx / (PMAX / 4), k = idx % (PMAX / 4) * 4, j = j0 + r;
      const bool ok = j < Q && k < cols;
      cp16(dst + nat_off(r, k, T), ok ? src + j * ld + k : src, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < T * PMAX; idx += NT) {
      const int r = idx / PMAX, k = idx % PMAX, j = j0 + r;
      const bool ok = j < Q && k < cols;
      cp4(dst + nat_off(r, k, T), ok ? src + j * ld + k : src, ok);
    }
  }
}

// half `part` of x_j^T's hi and lo (rows p, K = the positions j, permuted)
// at dst from the raw x tile (rows j, 64 columns p) at src, by one
// warpgroup. Physical chunk c of a row (columns 4c .. 4c+3) holds positions
// 8 (c / 2) + 2u + c % 2, u = 0 .. 3: a thread keeps one row p, reads its
// four positions (a warp: one row j, 32 consecutive p, 32 banks) and writes
// each part with one 16-byte store (a quarter warp: 8 rows p of one chunk,
// distinct banks).
__device__ __forceinline__ void split_x(const uint8_t* src, uint8_t* dst,
                                        int part) {
  const int t = threadIdx.x % 128, p = t % PMAX, odd = t / PMAX;
  const uint8_t* const col = src + (p >> 5) * T * ROW + (p & 3) * 4;
  const int pq = (p >> 2) & 7;
#pragma unroll 1  // one chunk's values at a time: it runs under a wgmma batch
  for (int it = 0; it < 4; ++it) {
    const int c = 8 * part + 2 * it + odd;  // this thread's chunk of row p
    uint4 hi, lo;
    uint32_t* const h = &hi.x;
    uint32_t* const l = &lo.x;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = 8 * (c / 2) + 2 * u + odd;
      split(*reinterpret_cast<const float*>(col + j * ROW +
                                            ((pq ^ (j & 7)) << 4)),
            h[u], l[u]);
    }
    const uint32_t off =
        (c >> 3) * PMAX * ROW + p * ROW + (((c & 7) ^ (p & 7)) << 4);
    *reinterpret_cast<uint4*>(dst + off) = hi;
    *reinterpret_cast<uint4*>(dst + X_PART + off) = lo;
  }
}

// descriptor of k-step ks of a staged operand part of `rows` rows
__device__ __forceinline__ uint64_t kstep_desc(uint32_t part, int ks,
                                               int rows) {
  return sw128_desc(part + (ks / 4) * rows * ROW + (ks % 4) * 32, 16, 8 * ROW);
}

// acc += A . B over four k-steps from k-step ks0: A's raw fp32 fragments
// split in registers, B's hi and lo parts at b_hi and b_hi + part_bytes
__device__ __forceinline__ void mma4(float (&acc)[32], const float (&a)[4][4],
                                     uint32_t b_hi, uint32_t part_bytes,
                                     int ks0, int rows) {
  uint32_t hi[4][4], lo[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int q = 0; q < 4; ++q) split(a[u][q], hi[u][q], lo[u][q]);
  pin(acc);
  wgmma_fence();
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const uint64_t d_hi = kstep_desc(b_hi, ks0 + u, rows);
    const uint64_t d_lo = kstep_desc(b_hi + part_bytes, ks0 + u, rows);
    wgmma_tf32_n64(acc, lo[u], d_hi);
    wgmma_tf32_n64(acc, hi[u], d_lo);
    wgmma_tf32_n64(acc, hi[u], d_hi);
  }
  wgmma_commit();
  wgmma_wait_all();
  pin(acc);
}

// sc += C_i . B_j^T over the 16 k-steps of N, C_i's parts in registers:
// issued and committed, not waited for
__device__ __forceinline__ void scores_issue(float (&sc)[32],
                                             const uint32_t (&ch)[NMAX / 8][4],
                                             const uint32_t (&cl)[NMAX / 8][4],
                                             uint32_t b_hi) {
  pin(sc);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < NMAX / 8; ++ks) {
    const uint64_t d_hi = kstep_desc(b_hi, ks, T);
    const uint64_t d_lo = kstep_desc(b_hi + B_PART, ks, T);
    wgmma_tf32_n64(sc, cl[ks], d_hi);
    wgmma_tf32_n64(sc, ch[ks], d_lo);
    wgmma_tf32_n64(sc, ch[ks], d_hi);
  }
  wgmma_commit();
}

// state (rows p, columns n 64 wg .. 64 wg + 63) += (w . x_j)^T . B_j over
// the 8 k-steps of the tile's positions: A = x[j, p] * w_j from the raw x
// tile at xr, split in registers; B_j^T's image (rows n, K = j) the shared
// operand at sb: issued and committed, not waited for
__device__ __forceinline__ void state_issue(float (&acc)[32],
                                            const uint8_t* xr, uint32_t sb,
                                            const float* wj, int wg, int fr,
                                            int fc) {
  uint32_t hi[T / 8][4], lo[T / 8][4];
#pragma unroll
  for (int ks = 0; ks < T / 8; ++ks)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = 8 * ks + fc + 4 * (q >> 1);
      split(*reinterpret_cast<const float*>(
                xr + nat_off(j, fr + 8 * (q & 1), T)) *
                wj[j],
            hi[ks][q], lo[ks][q]);
    }
  pin(acc);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < T / 8; ++ks) {
    const uint64_t d_hi = kstep_desc(sb + wg * T * ROW, ks, NMAX);
    const uint64_t d_lo = kstep_desc(sb + B_PART + wg * T * ROW, ks, NMAX);
    wgmma_tf32_n64(acc, lo[ks], d_hi);
    wgmma_tf32_n64(acc, hi[ks], d_lo);
    wgmma_tf32_n64(acc, hi[ks], d_hi);
  }
  wgmma_commit();
}

// Fragments (PTX ISA, wgmma .tf32): warp w of a warpgroup holds rows 16w ..
// 16w+15 of its 64; lane t holds A elements (row, physical column) (t/4 +
// 8h, t%4 + 4e) of each k-step as a[h + 2e]; accumulator d[4i + 2h + e] is
// (row t/4 + 8h, column 8i + 2(t%4) + e).
__global__ void __launch_bounds__(NT, 1)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ Cm,
                 const float* __restrict__ bimg, const float* __restrict__ aux,
                 float* __restrict__ y, float* __restrict__ states,
                 float* __restrict__ decays, Layout L, int nC, int Q, int H,
                 int P, int N, int G, bool vec) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // the swizzle's period
  uint8_t* const s = smem_raw + (base - raw);

  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128;
  const int fr = t / 32 * 16 + t % 32 / 4;  // fragment rows fr, fr + 8
  const int fc = t % 4;
  const int h = blockIdx.x % H;
  const int c = blockIdx.x / H % nC;
  const long long b = blockIdx.x / (H * nC);
  const int nJ = (Q + T - 1) / T, Qp = nJ * T, nI = (Q + 2 * T - 1) / (2 * T);
  const bool state_block = static_cast<int>(blockIdx.y) == nI;
  const int i0 = state_block ? 0 : (nI - 1 - blockIdx.y) * 2 * T;  // heaviest
  const int row0 = i0 + T * wg;  // this warpgroup's first row of y
  const int nJb = state_block ? nJ : min(nJ, (i0 + 2 * T - 1) / T + 1);
  x += b * L.x.b + h * L.x.h + static_cast<long long>(c) * Q * L.x.s;
  Cm += b * L.C.b + h * L.C.h + static_cast<long long>(c) * Q * L.C.s;
  const float* const auxb = aux + static_cast<long long>(blockIdx.x) * 3 * Qp;
  // B_j's image for the y rows, B_j^T's for the state
  const float* const bimgb =
      bimg + ((b * nC + c) * G + (G == 1 ? 0 : h)) * nJ * (TILE_IMGS / 4) +
      (state_block ? B_IMG / 4 : 0);
  const uint32_t bars = base + S_BAR;

  if (tid == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // tile jt's B image and aux slices into stage st, by one thread
  auto issue = [&](int jt, int st) {
    const uint32_t sb = base + st * STAGE, bar = bars + 8 * st;
    mbar_expect_tx(bar, B_IMG + AUX);
    for (int k = 0; k < B_IMG / 16384; ++k)
      bulk_load(sb + k * 16384, bimgb + jt * (TILE_IMGS / 4) + k * 4096,
                16384, bar);
    for (int k = 0; k < 3; ++k)
      bulk_load(base + S_AUX + st * AUX + k * T * 4, auxb + k * Qp + jt * T,
                T * 4, bar);
  };
  if (tid == 0) {
    issue(0, 0);
    if (nJb > 1) issue(1, 1);
  }
  // raw x tile t lives in raw buffer t % 2
  for (int k = 0; k < 2; ++k) {
    copy_rows(x, L.x.s, k * T, Q, P, vec, base + S_RAW + k * X_PART);
    cp_commit();
  }
  cp_wait<1>();
  __syncthreads();
  split_x(s + S_RAW, s + S_XT, wg);
  fence_proxy_async();
  cp_wait<0>();
  __syncthreads();

  // Step jt of the y rows: x_{jt+2} is copied into the raw buffer x_jt
  // left; tile jt is multiplied from stage jt % 2 while, under each
  // warpgroup's first wgmma batch, it splits its half of x_{jt+1} into the
  // other stage; at the end, tile jt+2's image and aux slices are issued
  // into this stage. One barrier a step, so one warpgroup's W runs under
  // the other's wgmmas. The state has a loop of its own (below), so C_i's
  // split registers are live in the y rows' only.
  auto step_begin = [&](int jt) {
    if (jt + 2 < nJb) {
      copy_rows(x, L.x.s, (jt + 2) * T, Q, P, vec,
                base + S_RAW + (jt & 1) * X_PART);
      cp_commit();
    }
    mbar_wait(bars + 8 * (jt & 1), (jt >> 1) & 1);  // B image, aux slices
  };
  // x_{jt+1}'s raw tile and its stage (after the last tile the split writes
  // a stage no step reads)
  auto x_raw = [&](int jt) { return s + S_RAW + ((jt & 1) ^ 1) * X_PART; };
  auto x_next = [&](int jt) { return s + ((jt & 1) ^ 1) * STAGE + S_XT; };
  auto step_end = [&](int jt) {
    fence_proxy_async();  // x_{jt+1}'s parts, for the wgmmas
    cp_wait<0>();         // x_{jt+2}'s raw tile
    __syncthreads();  // this stage is consumed; x_{jt+1} and x_{jt+2} are in
    if (tid == 0 && jt + 2 < nJb) issue(jt + 2, jt & 1);
  };
  float acc[32];  // y rows, or state^T rows n = 64 wg + fragment row
#pragma unroll
  for (int k = 0; k < 32; ++k) acc[k] = 0.f;

  if (state_block) {  // x is read raw: no split, two barriers a step
    const bool state_rows = T * wg < N;
    for (int jt = 0; jt < nJb; ++jt) {
      mbar_wait(bars + 8 * (jt & 1), (jt >> 1) & 1);  // B_j^T, aux slices
      if (state_rows) {
        state_issue(acc, s + S_RAW + (jt & 1) * X_PART,
                    base + (jt & 1) * STAGE,
                    reinterpret_cast<const float*>(s + S_AUX +
                                                   (jt & 1) * AUX) + 2 * T,
                    wg, fr, fc);
        wgmma_wait_all();
        pin(acc);
      }
      __syncthreads();  // x_jt's raw tile and this stage are consumed
      if (jt + 2 < nJb)
        copy_rows(x, L.x.s, (jt + 2) * T, Q, P, vec,
                  base + S_RAW + (jt & 1) * X_PART);
      cp_commit();
      if (tid == 0 && jt + 2 < nJb) issue(jt + 2, jt & 1);
      cp_wait<1>();  // x_{jt+1}'s raw tile
      __syncthreads();
    }
    // accumulator column n = 64 wg + 8u + 2fc + e of row p: (n, n + 1) as
    // one 8-byte store where N is even
    float* const out = states + static_cast<long long>(blockIdx.x) * P * N;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int p = fr + 8 * hh;
      if (p >= P) continue;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int n = T * wg + 8 * u + 2 * fc;
        const float v0 = acc[4 * u + 2 * hh], v1 = acc[4 * u + 2 * hh + 1];
        if (N % 2 == 0) {
          if (n < N)
            *reinterpret_cast<float2*>(out + p * N + n) = make_float2(v0, v1);
        } else {
          if (n < N) out[p * N + n] = v0;
          if (n + 1 < N) out[p * N + n + 1] = v1;
        }
      }
    }
    if (tid == 0) decays[blockIdx.x] = expf(auxb[Q - 1]);
    return;
  }

  // y rows: C_i as the A operand, split once (k-step ks at ch[ks] and
  // cl[ks]), and cum at the rows
  const bool y_rows = row0 < Q;
  uint32_t ch[NMAX / 8][4], cl[NMAX / 8][4];
  float ci[2];
#pragma unroll
  for (int ks = 0; ks < NMAX / 8; ++ks)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = row0 + fr + 8 * (q & 1), n = 8 * ks + fc + 4 * (q >> 1);
      split(y_rows && i < Q && n < N ? Cm[i * L.C.s + n] : 0.f, ch[ks][q],
            cl[ks][q]);
    }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = row0 + fr + 8 * hh;
    ci[hh] = y_rows && i < Q ? auxb[i] : 0.f;
  }
  for (int jt = 0; jt < nJb; ++jt) {
    step_begin(jt);
    const int j0 = jt * T;
    const uint32_t sb = base + (jt & 1) * STAGE;
    const float* const cumj =
        reinterpret_cast<const float*>(s + S_AUX + (jt & 1) * AUX);
    const float* const dtj = cumj + T;
    if (y_rows && j0 <= row0) {
      float sc[32];  // scores, then w
#pragma unroll
      for (int k = 0; k < 32; ++k) sc[k] = 0.f;
      scores_issue(sc, ch, cl, sb);
      split_x(x_raw(jt), x_next(jt), wg);
      wgmma_wait_all();
      pin(sc);
      // w_ij = (C_i . B_j) * exp(cum_i - cum_j) * dt_j for j <= i < Q; the
      // mask where the tile crosses the diagonal or rows past Q
      const bool edge = j0 + T > row0 || row0 + T > Q;
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const int hh = k / 2 % 2, r = 8 * (k / 4) + 2 * fc + k % 2;
        const int i = row0 + fr + 8 * hh;
        const float v = sc[k] * __expf(ci[hh] - cumj[r]) * dtj[r];
        sc[k] = !edge || (j0 + r <= i && i < Q) ? v : 0.f;
      }
      // y += w . x_j: k-step u's A fragment a[h + 2e] is sc[4u + 2h + e]
#pragma unroll
      for (int kc = 0; kc < T / 32; ++kc) {
        float a[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            a[u][q] = sc[4 * (4 * kc + u) + 2 * (q & 1) + (q >> 1)];
        mma4(acc, a, sb + S_XT, X_PART, 4 * kc, PMAX);
      }
    } else {
      split_x(x_raw(jt), x_next(jt), wg);
    }
    step_end(jt);
  }
  if (!y_rows) return;
  // y is dense (B, S, H, P): position s of head h at (s * H + h) * P
  const long long ld = static_cast<long long>(H) * P;
  float* out = y + ((b * nC + c) * Q) * ld + static_cast<long long>(h) * P;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = row0 + fr + 8 * hh;
    if (i >= Q) continue;
#pragma unroll
    for (int u = 0; u < 8; ++u)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int p = 8 * u + 2 * fc + e;
        if (p < P) out[i * ld + p] = acc[4 * u + 2 * hh + e];
      }
  }
}

Layout layout(const long long* strides) {
  Layout L;
  Strides* dst[4] = {&L.x, &L.dt, &L.B, &L.C};
  for (int i = 0; i < 4; ++i)
    *dst[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  return L;
}

int prep(const void* dt, const void* A, const void* Bm, void* bimg, void* aux,
         const Layout& L, int B, int nC, int Q, int H, int N,
         cudaStream_t stream) {
  const int G = L.B.h == 0 ? 1 : H;
  const int n_img = B * nC * G * ((Q + T - 1) / T);
  const int n_aux = (B * nC * H + 7) / 8;
  ssd_prep_kernel<<<n_img + n_aux, 256, 0, stream>>>(
      static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const float*>(Bm), static_cast<float*>(bimg),
      static_cast<float*>(aux), L, B, nC, Q, H, N, G, n_img);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: 12 values, (b, s, h) of x, dt, Bm and Cm in that order; vec: x
// may be copied in 16-byte pieces (base, strides and P multiples of 4
// floats); bimg and aux: the scratch described above
extern "C" int ssd_chunk_f32(const void* x, const void* dt, const void* A,
                             const void* Bm, const void* Cm, void* y,
                             void* states, void* decays, void* bimg, void* aux,
                             int B, int nC, int Q, int H, int P, int N,
                             const long long* strides, int vec,
                             void* stream) {
  const Layout L = layout(strides);
  const auto st = static_cast<cudaStream_t>(stream);
  int rc = prep(dt, A, Bm, bimg, aux, L, B, nC, Q, H, N, st);
  if (rc != 0) return rc;
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * nC * H, (Q + 2 * T - 1) / (2 * T) + 1);
  ssd_chunk_kernel<<<grid, NT, SMEM, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(Cm),
      static_cast<const float*>(bimg), static_cast<const float*>(aux),
      static_cast<float*>(y), static_cast<float*>(states),
      static_cast<float*>(decays), L, nC, Q, H, P, N, L.B.h == 0 ? 1 : H,
      vec != 0);
  return static_cast<int>(cudaGetLastError());
}

// the prep kernel alone, for timing it apart
extern "C" int ssd_chunk_prep_f32(const void* dt, const void* A,
                                  const void* Bm, void* bimg, void* aux,
                                  int B, int nC, int Q, int H, int N,
                                  const long long* strides, void* stream) {
  return prep(dt, A, Bm, bimg, aux, layout(strides), B, nC, Q, H, N,
              static_cast<cudaStream_t>(stream));
}
