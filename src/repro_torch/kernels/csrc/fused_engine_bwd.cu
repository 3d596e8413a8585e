// Backward of the epilogue-fused Winograd DeConv engine for Hopper (sm_90a),
// fp32, at the deconv corner (one input phase, stride S, S^2 sub-filters).
//
// Two kernels, each the gradient of fused_engine.cu's products with respect
// to one of its operands.  Both start from the cotangent of the engine's
// pre-epilogue output in the (B, ty, tx, S^2*m^2, M) scratch layout, g, and
// its inverse-transform-weighted form
//     gw[p, t, m] = sum_a inv[p, a] * g[t, s(p)*m^2 + a, m]
// (a fold of at most 4 terms per packed position p of sub-filter s(p)).
//
// bwd_x replaces src/repro/kernels/engine.py::fused_engine_bwd_x (kernel body
// _fused_bwd_x_kernel, the pallas_call at engine.py:1291), phases = 1:
//     dXw[t, pos_p, n] += sum_m gw[p, t, m] * ww[p, n, m]   (p of every
//                          sub-filter that holds Winograd position pos_p)
//     dZ_t = B * dXw_t * B^T                                 (adds only)
//     dcells[cell (j, c), (p, q), n] = sum over the up to 4 tiles (j-dy, c-dx)
//                          whose 4x4 window reads it of dZ[2dy+p][2dx+q][n]
// Its plain version is repro_torch/kernels/ref.py::fused_pre_engine_bwd_x_ref.
//
// bwd_w replaces engine.py::fused_engine_bwd_w (_fused_bwd_w_kernel, the
// pallas_call at engine.py:1427), phases = 1:
//     dww[p, n, m] = sum_t xw[t, pos_p, n] * gw[p, t, m]
// with xw = B^T Z B recomputed from the cell windows, as the forward does.
// Its plain version is ref.py::fused_pre_engine_bwd_w_ref.
//
// What bounds them on an H100: the products, 2*T*C*N*M flops each, at every
// DCGAN layer but the RGB one, on the tensor cores in 3xTF32 (165 TFLOP/s):
// bwd_x held at about a sixth of that rate by the operand work of its
// positions (bwd_x_core.cuh), bwd_w at about a fifth by latency
// (bwd_w_core.cuh); at the RGB layer (M = 3) the bytes of dcells (bwd_x) and
// of the cell windows (bwd_w).
//
// What the design does about it:
//   * bwd_x gathers instead of scattering.  A block owns a range of R output
//     cell rows (rows of all images laid end to end, so one block can cover
//     several small images) by W cell columns and an N-tile of BN channels.
//     It computes dXw for every tile those cells read from, including the
//     one tile row above its first cell row (the q-1 = 1 row halo, computed
//     again by the block above), then dZ, then sums the up to four pieces of
//     each cell in a fixed order: no atomics, no scratch in device memory,
//     and the result does not depend on the order blocks run in.  The
//     contraction over M runs on the tensor cores (bwd_x_core.cuh, shared
//     with domain_engine.cu's bwd_x): chunks of (sub-filter s, 32 channels),
//     every warp holding its position set's products for 64 tile slots x 32
//     channels in registers for the whole loop; dXw then passes through
//     shared memory for dZ and the gather (dz_gather).  64 slots keep the
//     recomputed halo row at 0 / 7 / 13% of the products at deconv0-2 (128
//     slots would keep it under 4%, but a warp tile that covers them ran
//     slower).  Few or ragged channels (RGB) keep the fp32 CUDA-core kernel,
//     whose 4 position groups each keep 4 Winograd positions x 4 tiles x 4
//     channels in registers, gw formed in shared memory once per chunk;
//   * bwd_w runs on the tensor cores too (bwd_w_core.cuh, shared with
//     domain_engine.cu's bwd_w): a block per (packed position, 256-channel N
//     tile, 128-channel M tile) runs over T in chunks of 8 tiles.  Its A
//     operand, xw at the position's Winograd position, is formed in shared
//     memory from the only four entries of each 4x4 cell window that
//     position reads (B^T's rows have two +-1 entries each), so the block
//     stages four planes of the windows by cp.async and forms xw once per M
//     tile: C/16 * M/128 times per value of xw (12.3 / 6.1 / 3.1 at DCGAN's
//     deconv0-2), where the CUDA-core design formed all 16 positions once per
//     sub-filter and 32-channel M tile (64 / 32 / 16).  The T loop is long
//     (10368 tiles at deconv2) where (N, M) fit one block tile, so it splits
//     over blocks: each writes its sums to scratch and the last to arrive
//     adds them in split order (deterministic) and resets its arrival
//     counter to 0, as the forward's N split does.  Few or ragged channels
//     (RGB) keep the fp32 CUDA-core kernel, one block per (sub-filter,
//     64-channel N tile, 4-channel M tile) and a T split of its own, the
//     raw windows and B^T Z B of all 16 positions in shared memory;
//   * M = 3 is not a multiple of 4, so g rows move in 4-byte copies on that
//     path; the tensor is never padded on the host.
// One gw pass shared by both kernels is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bwd_w_core.cuh"
#include "bwd_x_core.cuh"

namespace {

using bwdx::cp_async;
using bwdx::cp_async_commit;
using bwdx::cp_async_wait;
using bwdx::kMaxPos;  // n*n Winograd positions of F(2,3)
using bwdx::kMaxSub;  // S^2 sub-filters, S <= 4

using bwdx::CellBlock;
using bwdx::dz_gather;

// ============================================================== bwd_x
// The fp32 CUDA-core bwd_x for few or ragged channels (M < 8 or M % 4 != 0:
// RGB): G = 4 position groups x (NT_T x NT_N) = (16 x 8) threads; group g
// owns Winograd positions g, g + G, ...; each thread a 4-tile x 4-channel
// micro tile; M in chunks of BM = 4 with 4-byte copies of g and ww.
struct BxCfg {
  static constexpr int G = 4, NT_T = 16, NT_N = 8, BM = 4;
  static constexpr int PG = kMaxPos / G;
  static constexpr int kThreads = G * NT_T * NT_N;
  static constexpr int BT = NT_T * 4;       // tile slots per block
  static constexpr int BN = NT_N * 4;       // input channels per block
  static constexpr int GS = 4 * BM + 8;     // g_s row stride per tile: 16-byte aligned, skewed banks
  static constexpr int XT = BT + 4;         // gw_s row stride
  static constexpr int kG = BT * GS;        // g rows, one stage
  static constexpr int kW = kMaxPos * BM * BN;  // ww slice [k][m][n], one stage
  static constexpr int kGw = kMaxPos * BM * XT;  // gw [pos][m][tile]
  static constexpr int kStage = 2 * (kG + kW) + kGw;
  static constexpr int kRed = kMaxPos * BT * BN;  // dXw, then dZ: [pos][tile][n]
  static constexpr int kBig = kStage > kRed ? kStage : kRed;
  static constexpr int kMaxC = kMaxPos * kMaxSub;
  static constexpr size_t kSmemBytes =
      sizeof(float) * (kBig + kMaxC * 4) + sizeof(int) * (kMaxSub * kMaxPos + kMaxC + kMaxSub + 1 + BT);
};

__global__ void __launch_bounds__(BxCfg::kThreads)
bwd_x_kernel(const float* __restrict__ g, const float* __restrict__ ww, const float* __restrict__ inv,
             const int* __restrict__ pos, const int* __restrict__ sub_off, float* __restrict__ dcells,
             int B, int gy, int gx, int N, int M, int S, int ty, int tx, int R, int W, int TC, int ncb) {
  using K = BxCfg;
  constexpr int G = K::G, NT_T = K::NT_T, NT_N = K::NT_N, BM = K::BM;
  constexpr int PG = K::PG, BT = K::BT, BN = K::BN, GS = K::GS, XT = K::XT, NT = K::kThreads;
  extern __shared__ float4 smem4[];
  float* g_s = reinterpret_cast<float*>(smem4);  // 2 x [BT][GS]
  float* w_s = g_s + 2 * K::kG;                   // 2 x [16][BM][BN]
  float* gw_s = w_s + 2 * K::kW;                  // [16][BM][XT]
  float* red_s = g_s;                             // [16][BT][BN] after the M loop
  float* inv_s = g_s + K::kBig;                   // [C][4]
  int* kmap_s = reinterpret_cast<int*>(inv_s + K::kMaxC * 4);  // [S^2][16] pos -> k or -1
  int* pos_s = kmap_s + kMaxSub * kMaxPos;        // [C]
  int* off_s = pos_s + K::kMaxC;                  // [S^2 + 1]
  int* tile_s = off_s + kMaxSub + 1;              // [BT] flat tile index, -1 if none

  const int tid = threadIdx.x;
  const int grp = tid / (NT_T * NT_N);  // position group, uniform per warp
  const int rem = tid % (NT_T * NT_N);
  const int tt = rem / NT_N, tn = rem % NT_N;
  const int S2 = S * S;
  const int n0 = blockIdx.y * BN;
  const CellBlock cb(blockIdx.x / ncb, blockIdx.x % ncb, B, gy, gx, ty, tx, R, W);
  for (int tl = tid; tl < BT; tl += NT) tile_s[tl] = cb.tile(tl, TC, tx);
  bwdx::load_layout<4>(inv_s, kmap_s, off_s, pos_s, inv, pos, sub_off, S2);

  const int mchunks = (M + BM - 1) / BM;
  const int nchunks = S2 * mchunks;
  const int s2m2 = S2 * 4;

  // one pipeline stage: the g rows of sub-filter s for every tile slot, and
  // ww[lo+k, n0:n0+BN, m0:m0+BM] transposed to [k][m][n]; ragged edges and
  // empty slots zero-filled
  auto stage = [&](int buf, int c) {
    const int s = c / mchunks, m0 = (c % mchunks) * BM;
    const int lo = off_s[s], cnt = off_s[s + 1] - lo;
    float* gd = g_s + buf * K::kG;
    for (int e = tid; e < BT * 4 * BM; e += NT) {
      const int mm = e % BM, a = (e / BM) % 4, tl = e / (BM * 4);
      const int t = tile_s[tl];
      const bool ok = t >= 0 && m0 + mm < M;
      const float* src = ok ? g + ((size_t)t * s2m2 + s * 4 + a) * M + m0 + mm : g;
      cp_async(gd + tl * GS + a * BM + mm, src, ok, 4);
    }
    float* wd = w_s + buf * K::kW;
    for (int e = tid; e < cnt * BN * BM; e += NT) {
      const int mm = e % BM, nn = (e / BM) % BN, k = e / (BM * BN);
      const bool ok = n0 + nn < N && m0 + mm < M;
      const float* src = ok ? ww + ((size_t)(lo + k) * N + n0 + nn) * M + m0 + mm : ww;
      cp_async(wd + (k * BM + mm) * BN + nn, src, ok, 4);
    }
    cp_async_commit();
  };

  float acc[PG][4][4];
#pragma unroll
  for (int kk = 0; kk < PG; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[kk][i][j] = 0.0f;

  if (nchunks > 0) stage(0, 0);
  if (nchunks > 1) stage(1, 1);
  for (int c = 0; c < nchunks; ++c) {
    const int buf = c & 1;
    const int s = c / mchunks;
    const int lo = off_s[s], cnt = off_s[s + 1] - lo;
    if (c + 1 < nchunks) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();

    // gw = inv-weighted fold of g, into gw_s[pos][m][tile]
    const float* gb = g_s + buf * K::kG;
    for (int it = tid; it < BT * BM; it += NT) {
      const int mm = it % BM, tl = it / BM;
      float gv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) gv[a] = gb[tl * GS + a * BM + mm];
      for (int k = 0; k < cnt; ++k) {
        const float* iv = inv_s + (lo + k) * 4;
        gw_s[(pos_s[lo + k] * BM + mm) * XT + tl] =
            fmaf(iv[0], gv[0], fmaf(iv[1], gv[1], fmaf(iv[2], gv[2], iv[3] * gv[3])));
      }
    }
    __syncthreads();

    // dXw += gw . ww^T over this chunk's channels m, per Winograd position
    const float* wb = w_s + buf * K::kW + tn * 4;
#pragma unroll
    for (int kk = 0; kk < PG; ++kk) {
      const int p = kk * G + grp;
      const int k = kmap_s[s * kMaxPos + p];
      if (k >= 0) {
        const float* xp = gw_s + p * BM * XT + tt * 4;
        const float* wp = wb + k * BM * BN;
#pragma unroll
        for (int mm = 0; mm < BM; ++mm) {
          const float4 xa = *reinterpret_cast<const float4*>(xp + mm * XT);
          const float4 wa = *reinterpret_cast<const float4*>(wp + mm * BN);
          const float xv[4] = {xa.x, xa.y, xa.z, xa.w};
          const float wv[4] = {wa.x, wa.y, wa.z, wa.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[kk][i][j] = fmaf(xv[i], wv[j], acc[kk][i][j]);
        }
      }
    }
    __syncthreads();
    if (c + 2 < nchunks) stage(buf, c + 2);
  }

  // dXw of every tile slot in shared memory, then dZ and the gather
#pragma unroll
  for (int kk = 0; kk < PG; ++kk) {
    const int p = kk * G + grp;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(red_s + (p * BT + tt * 4 + i) * BN + tn * 4) =
          make_float4(acc[kk][i][0], acc[kk][i][1], acc[kk][i][2], acc[kk][i][3]);
  }
  __syncthreads();
  dz_gather<BT, BN, NT, BT * BN, BN>(red_s, cb, dcells, gy, gx, ty, tx, N, n0, TC, 4, 0);
}

// bwd_x on the tensor cores (bwd_x_core.cuh): the block's cells as in the
// CUDA-core kernel above, every Winograd position of its BT tile slots x BN
// channels in registers, then dXw into shared memory as [pos][slot][n] and
// dz_gather.  The grid runs N-tiles fastest where g outweighs ww.
template <class K>
__global__ void __launch_bounds__(K::kThreads, K::kMinBlocks)
bwd_x_mma_kernel(const float* __restrict__ g, const float* __restrict__ ww, const float* __restrict__ inv,
                 const int* __restrict__ pos, const int* __restrict__ sub_off, float* __restrict__ dcells,
                 int B, int gy, int gx, int N, int M, int S, int ty, int tx, int R, int W, int TC, int ncb,
                 int n_cb, int n_nb, int n_fast) {
  constexpr int BT = K::BT, BN = K::BN, SS = BN + 4;  // dXw [pos][slot][SS]
  static_assert(16 * BT * SS <= K::kFloats, "dXw fits in the pipeline's shared memory");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);  // the pipeline, then dXw
  float* inv_s = smem + K::kFloats;               // [C][4]
  int* kmap_s = reinterpret_cast<int*>(inv_s + kMaxPos * kMaxSub * 4);  // [S^2][16]
  int* pos_s = kmap_s + kMaxSub * kMaxPos;  // [C]
  int* off_s = pos_s + kMaxSub * kMaxPos;   // [S^2 + 1]
  int* tile_s = off_s + kMaxSub + 1;             // [BT] flat tile index, -1 if none

  const int bid = blockIdx.x;
  const int c = n_fast ? bid / n_nb : bid % n_cb, nb = n_fast ? bid % n_nb : bid / n_cb;
  const CellBlock cb(c / ncb, c % ncb, B, gy, gx, ty, tx, R, W);
  const int n0 = nb * BN;
  for (int tl = threadIdx.x; tl < BT; tl += K::kThreads) tile_s[tl] = cb.tile(tl, TC, tx);
  bwdx::load_layout<4>(inv_s, kmap_s, off_s, pos_s, inv, pos, sub_off, S * S);

  bwdx::Acc<K> acc;
  bwdx::contract<K>(acc, smem, g, ww, tile_s, inv_s, kmap_s, off_s, S * S, M, N, n0);

  float* red = smem;
#pragma unroll
  for (int p = 0; p < K::NPS; ++p)
#pragma unroll
    for (int fa = 0; fa < K::FA; ++fa)
#pragma unroll
      for (int fb = 0; fb < K::FB; ++fb)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          red[(bwdx::position<K>(p) * BT + bwdx::acc_slot<K>(fb, i)) * SS + bwdx::acc_n(fa, i)] = acc[p][fa][fb][i];
  __syncthreads();
  dz_gather<BT, BN, K::kThreads, BT * SS, SS>(red, cb, dcells, gy, gx, ty, tx, N, n0, TC, 4, 0);
}

// ============================================================== bwd_w
// The fp32 CUDA-core bwd_w for few or ragged channels (M < 16 or M % 4 !=
// 0: RGB): G = 8 position groups x (NT_N x NT_M) = (16 x 1) threads; group
// g owns the packed positions k = g, g + G, ... of the block's sub-filter;
// each thread a 4-channel (n) x 4-channel (m) micro tile; BT = 4 tiles per
// T chunk, g rows in 4-byte copies.
struct BwCfg {
  static constexpr int G = 8, NT_N = 16, NT_M = 1, BT = 4;
  static constexpr int PG = kMaxPos / G;
  static constexpr int kThreads = G * NT_N * NT_M;
  static constexpr int BN = NT_N * 4;
  static constexpr int BM = NT_M * 4;
  static constexpr int kZ = BT * 16 * BN;       // raw 4x4 windows, one stage
  static constexpr int kG = BT * 4 * BM;        // g rows, one stage
  static constexpr int kXw = kMaxPos * BT * BN;  // xw [pos][tile][n]
  static constexpr int kGw = kMaxPos * BT * BM;  // gw [k][tile][m]
  static constexpr int kRed = kMaxPos * BN * BM;  // one block's sums, in scratch
  static constexpr size_t kSmemBytes =
      sizeof(float) * (2 * (kZ + kG) + kXw + kGw + kMaxPos * 4) + sizeof(int) * kMaxPos;
};

template <bool SPLIT>
__global__ void __launch_bounds__(BwCfg::kThreads)
bwd_w_kernel(const float* __restrict__ cells, const float* __restrict__ g, const float* __restrict__ inv,
             const int* __restrict__ pos, const int* __restrict__ sub_off, float* __restrict__ dww,
             int B, int Gy, int Gx, int N, int M, int S, int ty, int tx, int splits,
             float* __restrict__ partial, int* __restrict__ counters) {
  using K = BwCfg;
  constexpr int G = K::G, NT_N = K::NT_N, NT_M = K::NT_M, BT = K::BT;
  constexpr int PG = K::PG, BN = K::BN, BM = K::BM, NT = K::kThreads;
  extern __shared__ float4 smem4[];
  float* z_s = reinterpret_cast<float*>(smem4);  // 2 x [BT][16][BN]
  float* gr_s = z_s + 2 * K::kZ;                  // 2 x [BT][4][BM]
  float* xw_s = gr_s + 2 * K::kG;                 // [16][BT][BN]
  float* gw_s = xw_s + K::kXw;                    // [16][BT][BM]
  float* inv_s = gw_s + K::kGw;                   // [16][4]
  int* pos_s = reinterpret_cast<int*>(inv_s + kMaxPos * 4);

  const int n_nt = (N + BN - 1) / BN, n_mt = (M + BM - 1) / BM;
  const int grp_id = blockIdx.x;  // (s, N-tile, M-tile)
  const int s = grp_id / (n_nt * n_mt);
  const int nt = (grp_id / n_mt) % n_nt, mt = grp_id % n_mt;
  const int n0 = nt * BN, m0 = mt * BM;
  const int ks = SPLIT ? blockIdx.y : 0;
  const int lo = sub_off[s], cnt = sub_off[s + 1] - lo;
  const int tid = threadIdx.x;
  const int gq = tid / (NT_N * NT_M);  // position group, uniform per warp
  const int rem = tid % (NT_N * NT_M);
  const int tn = rem / NT_M, tm = rem % NT_M;
  const int T = B * ty * tx;
  const int tpi = ty * tx;
  const int s2m2 = S * S * 4;

  if (tid < kMaxPos * 4) inv_s[tid] = (tid / 4 < cnt) ? inv[(lo + tid / 4) * 4 + tid % 4] : 0.0f;
  if (tid < kMaxPos) pos_s[tid] = tid < cnt ? pos[lo + tid] : 0;
  __syncthreads();

  // this block's share of the T loop: chunks [c_lo, c_lo + n_chunks)
  const int all_chunks = (T + BT - 1) / BT;
  const int c_lo = (int)((long long)ks * all_chunks / (SPLIT ? splits : 1));
  const int n_chunks = cnt > 0 ? (int)((long long)(ks + 1) * all_chunks / (SPLIT ? splits : 1)) - c_lo : 0;

  // one pipeline stage: the raw 4x4 cell window of every tile of the chunk
  // (the line buffer) and its g rows for this sub-filter and M-tile
  auto stage = [&](int buf, int chunk) {
    const int t0 = chunk * BT;
    float* zd = z_s + buf * K::kZ;
    constexpr int kZv = BT * 16 * BN / 4;  // 16-byte copies: N % 4 == 0
    for (int e = tid; e < kZv; e += NT) {
      const int nl = (e % (BN / 4)) * 4, zi = (e / (BN / 4)) % 16, tl = e / (4 * BN);
      const int t = t0 + tl, n = n0 + nl;
      const bool ok = t < T && n < N;
      size_t off = 0;
      if (ok) {
        const int b = t / tpi, rm = t - b * tpi, jy = rm / tx, jx = rm - jy * tx;
        const int a = zi / 4, cc = zi % 4;  // window row / column
        const size_t base = (size_t)(b * Gy + jy) * Gx + jx;
        off = ((base + (a / 2) * Gx + cc / 2) * 4 + (a % 2) * 2 + cc % 2) * N + n;
      }
      cp_async(zd + (tl * 16 + zi) * BN + nl, cells + off, ok, 16);
    }
    float* gd = gr_s + buf * K::kG;
    for (int e = tid; e < BT * 4 * BM; e += NT) {
      const int mm = e % BM, a = (e / BM) % 4, tl = e / (BM * 4);
      const int t = t0 + tl;
      const bool ok = t < T && m0 + mm < M;
      const float* src = ok ? g + ((size_t)t * s2m2 + s * 4 + a) * M + m0 + mm : g;
      cp_async(gd + (tl * 4 + a) * BM + mm, src, ok, 4);
    }
    cp_async_commit();
  };

  float acc[PG][4][4];
#pragma unroll
  for (int kk = 0; kk < PG; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[kk][i][j] = 0.0f;

  if (n_chunks > 0) stage(0, c_lo);
  if (n_chunks > 1) stage(1, c_lo + 1);
  for (int c = 0; c < n_chunks; ++c) {
    const int buf = c & 1;
    if (c + 1 < n_chunks) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();

    // pre-PE: B^T Z B for F(2,3), adds only, into xw_s[pos][tile][n]
    const float* zb = z_s + buf * K::kZ;
    for (int it = tid; it < BT * BN; it += NT) {
      const int nl = it % BN, tl = it / BN;
      float z[4][4];
#pragma unroll
      for (int zi = 0; zi < 16; ++zi) z[zi / 4][zi % 4] = zb[(tl * 16 + zi) * BN + nl];
      float r4[4][4];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        r4[0][cc] = z[0][cc] - z[2][cc];
        r4[1][cc] = z[1][cc] + z[2][cc];
        r4[2][cc] = z[2][cc] - z[1][cc];
        r4[3][cc] = z[1][cc] - z[3][cc];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float* dst = xw_s + ((u * 4) * BT + tl) * BN + nl;
        dst[0 * BT * BN] = r4[u][0] - r4[u][2];
        dst[1 * BT * BN] = r4[u][1] + r4[u][2];
        dst[2 * BT * BN] = r4[u][2] - r4[u][1];
        dst[3 * BT * BN] = r4[u][1] - r4[u][3];
      }
    }
    // gw = inv-weighted fold of g, into gw_s[k][tile][m]
    const float* gb = gr_s + buf * K::kG;
    for (int it = tid; it < BT * BM; it += NT) {
      const int mm = it % BM, tl = it / BM;
      float gv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) gv[a] = gb[(tl * 4 + a) * BM + mm];
      for (int k = 0; k < cnt; ++k) {
        const float* iv = inv_s + k * 4;
        gw_s[(k * BT + tl) * BM + mm] =
            fmaf(iv[0], gv[0], fmaf(iv[1], gv[1], fmaf(iv[2], gv[2], iv[3] * gv[3])));
      }
    }
    __syncthreads();

    // dww[k] += xw[:, pos_k]^T . gw[k] over this chunk's tiles
#pragma unroll
    for (int kk = 0; kk < PG; ++kk) {
      const int k = kk * G + gq;
      if (k < cnt) {
        const float* xp = xw_s + pos_s[k] * BT * BN + tn * 4;
        const float* wp = gw_s + k * BT * BM + tm * 4;
#pragma unroll
        for (int tl = 0; tl < BT; ++tl) {
          const float4 xa = *reinterpret_cast<const float4*>(xp + tl * BN);
          const float4 wa = *reinterpret_cast<const float4*>(wp + tl * BM);
          const float xv[4] = {xa.x, xa.y, xa.z, xa.w};
          const float wv[4] = {wa.x, wa.y, wa.z, wa.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[kk][i][j] = fmaf(xv[i], wv[j], acc[kk][i][j]);
        }
      }
    }
    __syncthreads();
    if (c + 2 < n_chunks) stage(buf, c_lo + c + 2);
  }

  if (SPLIT) {
    // split T: every block of the group writes its sums; the last one to
    // arrive adds them in split order (deterministic), writes dww and
    // leaves the group's counter at 0 for the next launch
    __shared__ int last;
    float* mine = partial + ((size_t)grp_id * splits + ks) * K::kRed;
#pragma unroll
    for (int kk = 0; kk < PG; ++kk) {
      const int k = kk * G + gq;
      if (k < cnt) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          __stcg(reinterpret_cast<float4*>(mine + (k * BN + tn * 4 + i) * BM + tm * 4),
                 make_float4(acc[kk][i][0], acc[kk][i][1], acc[kk][i][2], acc[kk][i][3]));
      }
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      last = atomicAdd(counters + grp_id, 1) == splits - 1;
      if (last) counters[grp_id] = 0;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
#pragma unroll
    for (int kk = 0; kk < PG; ++kk) {
      const int k = kk * G + gq;
      if (k < cnt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          for (int j = 0; j < splits; ++j) {
            const float4 v = __ldcg(reinterpret_cast<const float4*>(
                partial + ((size_t)grp_id * splits + j) * K::kRed + (k * BN + tn * 4 + i) * BM + tm * 4));
            sum.x += v.x;
            sum.y += v.y;
            sum.z += v.z;
            sum.w += v.w;
          }
          acc[kk][i][0] = sum.x;
          acc[kk][i][1] = sum.y;
          acc[kk][i][2] = sum.z;
          acc[kk][i][3] = sum.w;
        }
      }
    }
  }

#pragma unroll
  for (int kk = 0; kk < PG; ++kk) {
    const int k = kk * G + gq;
    if (k >= cnt) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = n0 + tn * 4 + i;
      if (n >= N) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = m0 + tm * 4 + j;
        if (m < M) dww[((size_t)(lo + k) * N + n) * M + m] = acc[kk][i][j];
      }
    }
  }
}


// bwd_w on the tensor cores (bwd_w_core.cuh): one block per (packed position
// p, N tile, M tile) and T split, xw formed at p's Winograd position only
// from the four window planes it reads (bwdw::window_block); the deconv
// corner's cells hold one phase, 4 rows a cell, and g the S^2 sub-filters'
// rows of each tile.
template <class K, bool SPLIT>
__global__ void __launch_bounds__(K::kThreads, 1)
bwd_w_mma_kernel(const float* __restrict__ cells, const float* __restrict__ g, const float* __restrict__ inv,
                 const int* __restrict__ pos, const int* __restrict__ sub_off, float* __restrict__ dww,
                 int B, int Gy, int Gx, int N, int M, int S, int ty, int tx, int splits,
                 float* __restrict__ partial, int* __restrict__ counters) {
  const int n_nt = (N + K::BN - 1) / K::BN, n_mt = (M + K::BM - 1) / K::BM;
  const int grp = blockIdx.x, p = grp / (n_nt * n_mt);
  const int n0 = (grp / n_mt) % n_nt * K::BN, m0 = grp % n_mt * K::BM, ks = SPLIT ? blockIdx.y : 0;
  int s = 0;
  while (sub_off[s + 1] <= p) ++s;  // p's sub-filter
  bwdw::window_block<K, SPLIT, false>(cells, g, inv, dww, grp, p, pos[p], n0, m0, ks, S * S, s, B, Gy, Gx, N, M,
                                      ty, tx, splits, partial, counters);
}

struct BxConf {
  static constexpr bool kMma = false;
  using K = BxCfg;
  static constexpr size_t kSmemBytes = K::kSmemBytes;
};

template <class K_>
struct BxMma {
  static constexpr bool kMma = true;
  using K = K_;
  // the pipeline (then dXw), the layout tables and the tile slots
  static constexpr size_t kSmemBytes =
      sizeof(float) * (K::kFloats + kMaxPos * kMaxSub * 4) +
      sizeof(int) * (2 * kMaxSub * kMaxPos + kMaxSub + 1 + K::BT);
};

// bwd_x block configurations, by number (engine.py's
// INSTANTIATIONS["fused_engine_bwd_x"], in this order): 0 the fp32
// CUDA-core kernel (BxCfg): 64 tile slots x 32 n, 512 threads; 1 the tensor
// cores, 64 tile slots x 32 channels n a block, two position sets of 4
// warps, each warp 32 n x 16 tiles x 8 positions (the set's colour of the
// 4x4 checkerboard).
template <class F>
int with_bx_conf(int conf, F&& f) {
  if (conf == 1) return f(BxMma<bwdx::Core<16, 4, 2, 2, 8, 2>>{});
  return f(BxConf{});
}

// Whether bwd_x instantiation conf takes M output channels: the tensor
// cores where M % 4 == 0 and M >= 8 (g and ww in 16-byte copies: the
// wrapper has checked their alignment)
bool bx_takes(int conf, int M) {
  switch (conf) {
    case 0: return true;                  // cuda_cores
    case 1: return M >= 8 && M % 4 == 0;  // mma_64x32
  }
  return false;
}

// The plan's own choice: the tensor cores wherever they take M (few or
// ragged channels, RGB, on the CUDA cores)
int bx_default(int M) { return bx_takes(1, M) ? 1 : 0; }

// bwd_w configurations, by number (engine.py's
// INSTANTIATIONS["fused_engine_bwd_w"], in this order): 0 the fp32
// CUDA-core kernel (BwCfg): 64 x 4 a block, 128 threads; 1 the tensor cores,
// 256 channels n x 128 channels m a block, 8 warps of 64 x 64, 8 tiles a
// chunk (the four window planes and g rows of two chunks and the split
// operands of two fill 145 KB).
struct BwConf {
  static constexpr bool kMma = false;
  using K = BwCfg;
};
template <class K_>
struct BwMma {
  static constexpr bool kMma = true;
  using K = K_;
};

template <class F>
int with_bw_conf(int conf, F&& f) {
  if (conf == 1) return f(BwMma<bwdw::Core<4, 2, 4, 8, 8, 4, 4>>{});
  return f(BwConf{});
}

// Whether bwd_w instantiation conf takes M output channels: the tensor
// cores where M % 4 == 0 and M >= 16 (g rows in 16-byte copies: the wrapper
// has checked its alignment)
bool bw_takes(int conf, int M) {
  switch (conf) {
    case 0: return true;                   // cuda_cores
    case 1: return M >= 16 && M % 4 == 0;  // mma_256x128
  }
  return false;
}

// The plan's own choice: the tensor cores wherever they take M
int bw_default(int M) { return bw_takes(1, M) ? 1 : 0; }

// The bwd_w kernel of configuration Cf, with or without the T split
template <class Cf, bool SPLIT>
auto bw_kernel() {
  if constexpr (Cf::kMma)
    return bwd_w_mma_kernel<typename Cf::K, SPLIT>;
  else
    return bwd_w_kernel<SPLIT>;
}

}  // namespace

// Plain C entry points (bound with ctypes).  Every pointer is a device pointer.

// bwd_x geometry (bwdx::cell_geometry): a block covers R cell rows (rows of
// all B images end to end) by W cell columns; its BT tile slots are TC tile
// columns by BT/TC tile rows.  want -1 takes the plan's instantiation
// (bx_default), want >= 0 asks for that one (bx_takes' numbering): a request
// M cannot take returns cudaErrorInvalidValue; conf gets the one handed
// out, which fused_engine_bwd_x_f32 takes.  Also raises that kernel's
// shared-memory limit on the current device (call it before the first
// launch for this M).
extern "C" int fused_engine_bwd_x_plan(int B, int gy, int gx, int ty, int tx, int M, int want, int* R, int* W,
                                       int* TC, int* BT, int* conf) {
  *conf = want < 0 ? bx_default(M) : want;
  if (!bx_takes(*conf, M)) return (int)cudaErrorInvalidValue;
  return with_bx_conf(*conf, [&](auto cf) {
    using Cf = decltype(cf);
    using K = typename Cf::K;
    cudaError_t err;
    if constexpr (Cf::kMma)
      err = cudaFuncSetAttribute(bwd_x_mma_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)Cf::kSmemBytes);
    else
      err = cudaFuncSetAttribute(bwd_x_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Cf::kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    bwdx::cell_geometry(B, gy, gx, ty, tx, K::BT, R, W, TC);
    *BT = K::BT;
    return 0;
  });
}

// One bwd_x launch: g (B, ty, tx, S^2*4, M), ww (C, N, M), inv (C, 4),
// pos (C,), sub_off (S^2 + 1,) -> dcells (B, gy, gx, 4, N), every element
// written.  R, W, TC and conf from fused_engine_bwd_x_plan with the same M;
// C the packed positions; where conf runs the tensor cores, g and ww start
// on 16-byte boundaries.  Returns cudaGetLastError().
extern "C" int fused_engine_bwd_x_f32(const float* g, const float* ww, const float* inv, const int* pos,
                                      const int* sub_off, float* dcells, int B, int gy, int gx, int N,
                                      int M, int S, int ty, int tx, int R, int W, int TC, int C, int conf,
                                      void* stream) {
  if (!bx_takes(conf, M)) return (int)cudaErrorInvalidValue;
  return with_bx_conf(conf, [&](auto cf) {
    using Cf = decltype(cf);
    using K = typename Cf::K;
    const int nrb = (B * gy + R - 1) / R, ncb = (gx + W - 1) / W;
    const int n_nb = (N + K::BN - 1) / K::BN;
    if constexpr (Cf::kMma) {
      // N-tiles fastest where g (B*ty*tx*S^2*4 rows of M) outweighs ww (C*N rows)
      const int n_fast = (long long)B * ty * tx * S * S * 4 > (long long)C * N;
      bwd_x_mma_kernel<K><<<nrb * ncb * n_nb, K::kThreads, Cf::kSmemBytes,
                            reinterpret_cast<cudaStream_t>(stream)>>>(
          g, ww, inv, pos, sub_off, dcells, B, gy, gx, N, M, S, ty, tx, R, W, TC, ncb, nrb * ncb, n_nb, n_fast);
    } else {
      bwd_x_kernel<<<dim3(nrb * ncb, n_nb), K::kThreads, Cf::kSmemBytes, reinterpret_cast<cudaStream_t>(stream)>>>(
          g, ww, inv, pos, sub_off, dcells, B, gy, gx, N, M, S, ty, tx, R, W, TC, ncb);
    }
    return (int)cudaGetLastError();
  });
}

// bwd_w plan: the T-loop split and the block tile for this shape.  The
// tensor-core kernel runs a block per (packed position, N tile, M tile)
// group and splits T by bwdw::plan_splits; the CUDA-core kernel a block per
// (sub-filter, N tile, M tile), split over as many blocks as fill the card's
// resident block slots once, at least 4 chunks a split.  want -1 takes the
// plan's instantiation (bw_default), want >= 0 asks for that one (bw_takes'
// numbering), want_splits >= 1 for that T split (at most the T chunks and
// 65535): a request the shape cannot take returns cudaErrorInvalidValue.
// scratch_floats / counters are 0 when the split count is 1; tile gets (BN,
// BM, BT, the instantiation: 0 the CUDA cores, 1 the tensor cores), which
// fused_engine_bwd_w_f32 takes as conf.  Also raises both variants'
// shared-memory limit on the current device (call it before the first
// launch for this shape).
extern "C" int fused_engine_bwd_w_plan(int B, int ty, int tx, int N, int M, int S, int C, int want, int want_splits,
                                       int device, int* splits, long long* scratch_floats, long long* counters,
                                       int* tile) {
  const int conf = want < 0 ? bw_default(M) : want;
  if (!bw_takes(conf, M)) return (int)cudaErrorInvalidValue;
  return with_bw_conf(conf, [&](auto cf) {
    using Cf = decltype(cf);
    using K = typename Cf::K;
    const long long chunks = ((long long)B * ty * tx + K::BT - 1) / K::BT;
    if (want_splits > chunks || want_splits > 65535) return (int)cudaErrorInvalidValue;
    const auto k0 = bw_kernel<Cf, false>(), k1 = bw_kernel<Cf, true>();
    cudaError_t err = cudaFuncSetAttribute(k0, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)K::kSmemBytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)K::kSmemBytes);
    int occ = 0, sms = 0;
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, k1, K::kThreads, K::kSmemBytes);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    const long long slots = (long long)(occ > 0 ? occ : 1) * sms;
    const long long tiles = (long long)((N + K::BN - 1) / K::BN) * ((M + K::BM - 1) / K::BM);
    long long groups, k;
    if constexpr (Cf::kMma) {
      groups = (long long)C * tiles;
      k = bwdw::plan_splits(groups, chunks, slots);
    } else {
      groups = (long long)S * S * tiles;
      k = slots / groups;
      if (k > chunks / 4) k = chunks / 4;
      if (k > 65535) k = 65535;
      if (k < 1) k = 1;
    }
    if (want_splits >= 1) k = want_splits;
    *splits = (int)k;
    *scratch_floats = k > 1 ? groups * k * K::kRed : 0;
    *counters = k > 1 ? groups : 0;
    tile[0] = K::BN;
    tile[1] = K::BM;
    tile[2] = K::BT;
    tile[3] = conf;
    return 0;
  });
}

// One bwd_w launch: cells (B, Gy, Gx, 4, N), g (B, ty, tx, S^2*4, M),
// inv (C, 4), pos (C,), sub_off (S^2 + 1,) -> dww (C, N, M), every element
// written.  C the packed positions; conf, splits, partial and counters from
// fused_engine_bwd_w_plan with the same shape; the counters are zero on
// entry and the kernel leaves them zero; cells (and g where M % 4 == 0 and
// M >= 16) start on 16-byte boundaries.
extern "C" int fused_engine_bwd_w_f32(const float* cells, const float* g, const float* inv, const int* pos,
                                      const int* sub_off, float* dww, int B, int Gy, int Gx, int N, int M,
                                      int S, int ty, int tx, int C, int conf, int splits, float* partial,
                                      int* counters, void* stream) {
  if (!bw_takes(conf, M)) return (int)cudaErrorInvalidValue;
  return with_bw_conf(conf, [&](auto cf) {
    using Cf = decltype(cf);
    using K = typename Cf::K;
    const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    const int tiles = ((N + K::BN - 1) / K::BN) * ((M + K::BM - 1) / K::BM);
    // a block per (packed position or, on the CUDA cores, sub-filter, N tile, M tile) and split
    const dim3 grid((Cf::kMma ? C : S * S) * tiles, splits);
    auto kernel = splits > 1 ? bw_kernel<Cf, true>() : bw_kernel<Cf, false>();
    kernel<<<grid, K::kThreads, K::kSmemBytes, st>>>(cells, g, inv, pos, sub_off, dww, B, Gy, Gx, N, M, S, ty, tx,
                                                     splits, partial, counters);
    return (int)cudaGetLastError();
  });
}
