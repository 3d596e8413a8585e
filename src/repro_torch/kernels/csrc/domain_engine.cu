// The unfused Winograd DeConv engine and its backward for Hopper (sm_90a),
// fp32: the per-layer path whose pre-PE (xw = B^T Z B of every input tile)
// runs outside the kernels, so the transformed tiles xw (T, n^2, N) come
// from device memory.  F(2x2, 3x3): n^2 = 16 Winograd positions, m^2 = 4
// outputs per tile; S^2 sub-filters, sub-filter s holding the packed
// positions [sub_off[s], sub_off[s+1]) (at most 16, distinct).
//
// fwd replaces src/repro/kernels/engine.py::domain_engine (kernel body
// _engine_kernel, the pallas_call at engine.py:381):
//     y[t, s*4 + a, m] = sum_{p in s} inv[p, a] * sum_n xw[t, pos_p, n] * ww[p, n, m]
// Its plain version is repro_torch/kernels/ref.py::engine_ref.
//
// bwd_x replaces engine.py::domain_engine_bwd_x (_engine_bwd_x_kernel, the
// pallas_call at engine.py:995):
//     gw[p, t, m]   = sum_a inv[p, a] * g[t, s(p)*4 + a, m]
//     dxw[t, q, n]  = sum over the packed p with pos_p = q of sum_m gw[p, t, m] * ww[p, n, m]
// with dxw = 0 at the positions no packed p maps to.  Plain: engine_bwd_x_ref.
//
// bwd_w replaces engine.py::domain_engine_bwd_w (_engine_bwd_w_kernel, the
// pallas_call at engine.py:1085):
//     dww[p, n, m] = sum_t xw[t, pos_p, n] * gw[p, t, m]
// Plain: engine_bwd_w_ref.
//
// What bounds them on an H100: the products, 2*T*C*N*M flops each, at
// DCGAN's first three layers (fwd on the fp32 CUDA cores, 67 TFLOP/s; bwd_x
// and bwd_w on the tensor cores in 3xTF32, 165 TFLOP/s, where the operand
// work of its positions holds bwd_x at about a sixth, bwd_x_core.cuh, and
// latency holds bwd_w at about a fifth, bwd_w_core.cuh); at the RGB layer
// (M = 3) the bytes of xw (fwd, bwd_w) and of dxw (bwd_x), 16*T*N floats
// each, 303 MB at batch 128.
//
// What the designs do about it (they are fused_engine.cu's and
// fused_engine_bwd.cu's with the pre-PE taken out; the TPU's 128-lane
// padding of N and M and its (C, T_t, M_t) scratch of accumulators are not
// carried over):
//   * fwd: one block per (T-tile, sub-filter, M-tile).  Its 8 position
//     groups each keep, in registers for the whole N loop, the products of 2
//     of the sub-filter's <= 16 positions for a 4-tile x 4-channel micro
//     tile.  Only the sub-filter's positions of xw are staged, by a two-stage
//     cp.async pipeline with the weight slice; a thread's 4 tiles are NT_T
//     rows apart so that 8 threads reading 4 channels of 8 tiles hit 8
//     distinct bank groups.  After the N loop the products meet in shared
//     memory and fold through inv (0 or +-1: a signed add per nonzero) into
//     the tile's 4 outputs.  Where the grid would underfill the card (few
//     tiles, as DCGAN's first layer at small batch) the N loop splits over
//     blocks, and the last block to arrive sums the partial products in
//     split order, as fused_engine.cu does: the result does not depend on
//     the order blocks run in.  An empty sub-filter (K_D < S) writes zeros;
//   * bwd_x: one block per (T-tile, N-tile) on the tensor cores
//     (bwd_x_core.cuh, shared with fused_engine_bwd.cu's bwd_x): a loop
//     over (sub-filter, 32-channel M chunk) stages g and the sub-filter's
//     weights with 16-byte copies; every warp accumulates its position
//     set's products in 3xTF32 mma.sync, so the packed positions that share
//     a Winograd position add in one fixed order (sub-filter order, then
//     m): no atomics, deterministic.  Few or ragged channels (M = 3, M = 1)
//     keep the fp32 CUDA-core kernel below, which folds gw in shared memory
//     per (sub-filter, 4-channel chunk).  Every position of every tile is
//     written, zeros included: the output is not pre-zeroed;
//   * bwd_w: on the tensor cores (bwd_w_core.cuh, shared with
//     fused_engine_bwd.cu's bwd_w): one block per (packed position, N tile,
//     M tile) looping over T in chunks of 16 tiles, the position's xw rows
//     and its sub-filter's g rows by 16-byte cp.async, split into TF32 halves
//     in fragment order in shared memory; the long, thin T loops (10368
//     tiles at deconv2, 32784-131088 at rank 1) split over blocks with the
//     deterministic last-block sum.  Few or ragged channels (M = 3, M = 1)
//     keep the fp32 CUDA-core kernel, one block per (sub-filter, N tile, M
//     tile) and a T split of its own;
//   * M = 3 rules out 16-byte copies and stores of g, weights and outputs:
//     those paths take 4-byte copies; xw and dxw move in 16-byte copies
//     (N % 4 == 0).
//
// bwd_x and bwd_w also take the rank-1 instantiation of the 1D engine's
// backward (src/repro/kernels/engine.py::winograd_conv1d_fused_bwd_x / _bwd_w
// call the same two pallas_calls with m2 = m = 2 and n2 = phases*n): M2, the
// outputs per tile (4, or 2 for F(2, r) in 1D), is a template parameter, and
// N2, the xw row count (16, or phases*n <= 16), a runtime one.  So g is
// (T, S2*M2, M), inv (C, M2), xw and dxw (T, N2, N); the 2D instantiation
// (M2 = 4, N2 = 16) runs the same arithmetic as before.  In 1D a sub-filter
// keeps at most n2 positions (3 of 4 at the audio decoder's K4S2), so the
// CUDA-core bwd_w's rank-1 blocks take 4 position groups, not 8; the
// tensor-core bwd_w holds one position a block in either rank.
// wgmma and TMA for fwd, and one gw pass shared by both backward kernels,
// are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bwd_w_core.cuh"
#include "bwd_x_core.cuh"

namespace {

using bwdx::cp_async;
using bwdx::cp_async_commit;
using bwdx::cp_async_wait;
using bwdx::kMaxPos;  // n*n Winograd positions of F(2,3); the most xw rows (N2)
using bwdx::kMaxSub;  // S^2 sub-filters, S <= 4

// gw of one packed position from a tile's M2 values of g: the inverse
// transform's row, in the same order of operations for every launch
template <int M2>
__device__ __forceinline__ float fold_g(const float* iv, const float* gv);
template <>
__device__ __forceinline__ float fold_g<4>(const float* iv, const float* gv) {
  return fmaf(iv[0], gv[0], fmaf(iv[1], gv[1], fmaf(iv[2], gv[2], iv[3] * gv[3])));
}
template <>
__device__ __forceinline__ float fold_g<2>(const float* iv, const float* gv) {
  return fmaf(iv[0], gv[0], iv[1] * gv[1]);
}

// ============================================================== fwd
// G warp-uniform position groups x (NT_T x NT_M) threads; group g owns the
// packed positions k = g, g + G, ... of the block's sub-filter, a thread the
// tiles tt + i*NT_T (i < 4) x the channels 4*tm .. 4*tm+3.
template <int G, int NT_T, int NT_M, int BN>
struct FwdCfg {
  static constexpr int PG = kMaxPos / G;  // positions per group
  static constexpr int kThreads = G * NT_T * NT_M;
  static constexpr int BT = NT_T * 4;   // tiles per block
  static constexpr int BM = NT_M * 4;   // output channels per block
  static constexpr int XS = BN + 4;     // xw row stride: 16-byte aligned, 8 rows on distinct banks
  static constexpr int kX = kMaxPos * BT * XS;  // xw [k][tile][n], one stage
  static constexpr int kW = kMaxPos * BN * BM;  // weight slice [k][n][m], one stage
  static constexpr int kStage = 2 * (kX + kW);
  static constexpr int kRed = kMaxPos * BT * BM;  // per-position products, reuses the space
  static constexpr int kBig = kStage > kRed ? kStage : kRed;
  static constexpr size_t kSmemBytes = sizeof(float) * (kBig + kMaxPos * 4) + sizeof(int) * kMaxPos;
};

template <int G, int NT_T, int NT_M, int BN, int VW, bool SPLIT>
__global__ void __launch_bounds__(G * NT_T * NT_M)
domain_fwd_kernel(const float* __restrict__ xw, const float* __restrict__ ww, const float* __restrict__ inv,
                  const int* __restrict__ pos, const int* __restrict__ sub_off, float* __restrict__ out,
                  int T, int N, int M, int S2, int splits, float* __restrict__ partial,
                  int* __restrict__ counters) {
  using K = FwdCfg<G, NT_T, NT_M, BN>;
  constexpr int PG = K::PG, BT = K::BT, BM = K::BM, XS = K::XS, NT = K::kThreads;
  extern __shared__ float4 smem4[];
  float* x_s = reinterpret_cast<float*>(smem4);  // 2 x [16][BT][XS]
  float* w_s = x_s + 2 * K::kX;                  // 2 x [16][BN][BM]
  float* red_s = x_s;                            // [16][BT][BM] after the N loop
  float* inv_s = x_s + K::kBig;                  // [16][4]
  int* pos_s = reinterpret_cast<int*>(inv_s + kMaxPos * 4);

  const int s = blockIdx.y;
  const int t0 = blockIdx.x * BT;
  if (!SPLIT) splits = 1;  // compiled out of the unsplit variant
  const int mt = blockIdx.z / splits, ks = blockIdx.z % splits;  // M-tile, N split
  const int m0 = mt * BM;
  const int lo = sub_off[s], cnt = sub_off[s + 1] - lo;
  const int tid = threadIdx.x;
  const int g = tid / (NT_T * NT_M);  // position group, uniform per warp
  const int rem = tid % (NT_T * NT_M);
  const int tt = rem / NT_M, tm = rem % NT_M;

  if (tid < kMaxPos * 4) inv_s[tid] = (tid / 4 < cnt) ? inv[(lo + tid / 4) * 4 + tid % 4] : 0.0f;
  if (tid < kMaxPos) pos_s[tid] = tid < cnt ? pos[lo + tid] : 0;
  __syncthreads();

  // one pipeline stage: the sub-filter's positions of xw for every tile, and
  // its weight slice ww[lo+k, n0:n0+BN, m0:m0+BM]; ragged edges zero-filled
  auto stage = [&](int buf, int n0) {
    float* xd = x_s + buf * K::kX;
    const int nx = cnt * BT * (BN / 4);  // 16-byte copies: N % 4 == 0
    for (int e = tid; e < nx; e += NT) {
      const int nl = (e % (BN / 4)) * 4, tl = (e / (BN / 4)) % BT, k = e / (BN / 4 * BT);
      const int t = t0 + tl, n = n0 + nl;
      const bool ok = t < T && n < N;
      const float* src = ok ? xw + ((size_t)t * kMaxPos + pos_s[k]) * N + n : xw;
      cp_async(xd + (k * BT + tl) * XS + nl, src, ok, 16);
    }
    float* wd = w_s + buf * K::kW;
    const int nw = cnt * BN * (BM / VW);
    for (int e = tid; e < nw; e += NT) {
      const int mm = (e % (BM / VW)) * VW, nl = (e / (BM / VW)) % BN, k = e / (BM / VW * BN);
      const int n = n0 + nl, mc = m0 + mm;
      const bool ok = n < N && mc < M;
      const float* src = ok ? ww + ((size_t)(lo + k) * N + n) * M + mc : ww;
      cp_async(wd + (k * BN + nl) * BM + mm, src, ok, 4 * VW);
    }
    cp_async_commit();
  };

  float d[PG][4][4];
#pragma unroll
  for (int kk = 0; kk < PG; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) d[kk][i][j] = 0.0f;

  // this block's share of the N loop: chunks [c_lo, c_lo + n_chunks)
  const int all_chunks = (N + BN - 1) / BN;
  const int c_lo = ks * all_chunks / splits;
  const int n_chunks = cnt > 0 ? (ks + 1) * all_chunks / splits - c_lo : 0;
  if (n_chunks > 0) stage(0, c_lo * BN);
  if (n_chunks > 1) stage(1, (c_lo + 1) * BN);
  for (int c = 0; c < n_chunks; ++c) {
    const int buf = c & 1;
    if (c + 1 < n_chunks) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();

    // com-PE: each thread's positions, accumulated over the whole N loop
    const float* xb = x_s + buf * K::kX + tt * XS;
    const float* wb = w_s + buf * K::kW + tm * 4;
#pragma unroll
    for (int kk = 0; kk < PG; ++kk) {
      const int k = kk * G + g;
      if (k < cnt) {
        const float* xp = xb + k * BT * XS;
        const float* wp = wb + k * BN * BM;
#pragma unroll
        for (int n = 0; n < BN; n += 4) {
          float4 xa[4], wa[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) xa[i] = *reinterpret_cast<const float4*>(xp + i * NT_T * XS + n);
#pragma unroll
          for (int q = 0; q < 4; ++q) wa[q] = *reinterpret_cast<const float4*>(wp + (n + q) * BM);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float xv[4] = {xa[i].x, xa[i].y, xa[i].z, xa[i].w};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float wv[4] = {wa[q].x, wa[q].y, wa[q].z, wa[q].w};
#pragma unroll
              for (int j = 0; j < 4; ++j) d[kk][i][j] = fmaf(xv[q], wv[j], d[kk][i][j]);
            }
          }
        }
      }
    }
    __syncthreads();
    if (c + 2 < n_chunks) stage(buf, (c_lo + c + 2) * BN);
  }

  // post-PE: every position's products in shared memory, then the fold
#pragma unroll
  for (int kk = 0; kk < PG; ++kk) {
    const int k = kk * G + g;
    if (k < cnt) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(red_s + (k * BT + tt + i * NT_T) * BM + tm * 4) =
            make_float4(d[kk][i][0], d[kk][i][1], d[kk][i][2], d[kk][i][3]);
    }
  }
  __syncthreads();

  if (SPLIT) {
    // split N: every block of the group writes its products; the last one
    // to arrive sums them in split order (deterministic) and folds, the
    // others leave; it also leaves the group's counter at 0
    __shared__ int last;
    const size_t grp = ((size_t)blockIdx.x * gridDim.y + s) * (gridDim.z / splits) + mt;
    const int nred = cnt * BT * BM;  // a multiple of 4
    float* mine = partial + (grp * splits + ks) * K::kRed;
    for (int e = tid * 4; e < nred; e += NT * 4)
      __stcg(reinterpret_cast<float4*>(mine + e), *reinterpret_cast<const float4*>(red_s + e));
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      last = atomicAdd(counters + grp, 1) == splits - 1;
      if (last) counters[grp] = 0;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    for (int e = tid * 4; e < nred; e += NT * 4) {
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int j = 0; j < splits; ++j) {
        const float4 v = __ldcg(reinterpret_cast<const float4*>(partial + (grp * splits + j) * K::kRed + e));
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
      *reinterpret_cast<float4*>(red_s + e) = acc;
    }
    __syncthreads();
  }

  // fold through inv (0 or +-1: skip the zeros) into the tile's 4 outputs,
  // stored sub-filter-major: out[t, s*4 + a, m]
  for (int idx = tid; idx < BT * BM; idx += NT) {
    const int ml = idx % BM, tl = idx / BM;
    const int t = t0 + tl, mc = m0 + ml;
    if (t >= T || mc >= M) continue;
    float y[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int k = 0; k < cnt; ++k) {
      const float v = red_s[(k * BT + tl) * BM + ml];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float iv = inv_s[k * 4 + a];
        if (iv != 0.0f) y[a] = fmaf(iv, v, y[a]);
      }
    }
    float* o = out + ((size_t)t * S2 * 4 + s * 4) * M + mc;
#pragma unroll
    for (int a = 0; a < 4; ++a) o[(size_t)a * M] = y[a];
  }
}

// ============================================================== bwd_x
// The fp32 CUDA-core bwd_x for few or ragged channels (M < 8 or M % 4 != 0:
// RGB, mono): G = 4 position groups x (NT_T x NT_N) = (16 x 8) threads;
// group g owns Winograd positions g, g + G, ...; each thread a 4-tile x
// 4-channel micro tile; M in chunks of BM = 4 with 4-byte copies of g and
// ww.  M2: outputs per tile (4 in 2D, 2 in 1D).
template <int M2>
struct BxCfg {
  static constexpr int G = 4, NT_T = 16, NT_N = 8, BM = 4;
  static constexpr int PG = kMaxPos / G;
  static constexpr int kThreads = G * NT_T * NT_N;
  static constexpr int BT = NT_T * 4;       // tiles per block
  static constexpr int BN = NT_N * 4;       // input channels per block
  static constexpr int GS = M2 * BM + 8;    // g_s row stride per tile: 16-byte aligned, skewed banks
  static constexpr int XT = BT + 4;         // gw_s row stride
  static constexpr int kG = BT * GS;        // g rows, one stage
  static constexpr int kW = kMaxPos * BM * BN;  // ww slice [k][m][n], one stage
  static constexpr int kGw = kMaxPos * BM * XT;  // gw [pos][m][tile]
  static constexpr int kStage = 2 * (kG + kW) + kGw;
  static constexpr int kMaxC = kMaxPos * kMaxSub;
  static constexpr size_t kSmemBytes =
      sizeof(float) * (kStage + kMaxC * 4) + sizeof(int) * (kMaxSub * kMaxPos + kMaxC + kMaxSub + 1);
};

template <int M2>
__global__ void __launch_bounds__(BxCfg<M2>::kThreads)
domain_bwd_x_kernel(const float* __restrict__ g, const float* __restrict__ ww, const float* __restrict__ inv,
                    const int* __restrict__ pos, const int* __restrict__ sub_off, float* __restrict__ dxw,
                    int T, int N, int M, int S2, int N2) {
  using K = BxCfg<M2>;
  constexpr int G = K::G, NT_T = K::NT_T, NT_N = K::NT_N, BM = K::BM;
  constexpr int PG = K::PG, BT = K::BT, BN = K::BN, GS = K::GS, XT = K::XT, NT = K::kThreads;
  extern __shared__ float4 smem4[];
  float* g_s = reinterpret_cast<float*>(smem4);  // 2 x [BT][GS]
  float* w_s = g_s + 2 * K::kG;                   // 2 x [16][BM][BN]
  float* gw_s = w_s + 2 * K::kW;                  // [16][BM][XT]
  float* inv_s = g_s + K::kStage;                 // [C][M2]
  int* kmap_s = reinterpret_cast<int*>(inv_s + K::kMaxC * 4);  // [S^2][16] pos -> k or -1
  int* pos_s = kmap_s + kMaxSub * kMaxPos;        // [C]
  int* off_s = pos_s + K::kMaxC;                  // [S^2 + 1]

  const int tid = threadIdx.x;
  const int grp = tid / (NT_T * NT_N);  // position group, uniform per warp
  const int rem = tid % (NT_T * NT_N);
  const int tt = rem / NT_N, tn = rem % NT_N;
  const int C = sub_off[S2];
  const int t0 = blockIdx.x * BT, n0 = blockIdx.y * BN;

  for (int i = tid; i < C * M2; i += NT) inv_s[i] = inv[i];
  for (int i = tid; i < C; i += NT) pos_s[i] = pos[i];
  for (int i = tid; i <= S2; i += NT) off_s[i] = sub_off[i];
  for (int i = tid; i < kMaxSub * kMaxPos; i += NT) kmap_s[i] = -1;
  __syncthreads();
  for (int s = tid; s < S2; s += NT)
    for (int k = 0; k < off_s[s + 1] - off_s[s]; ++k) kmap_s[s * kMaxPos + pos_s[off_s[s] + k]] = k;
  __syncthreads();

  const int mchunks = (M + BM - 1) / BM;
  const int nchunks = S2 * mchunks;
  const int s2m2 = S2 * M2;

  // one pipeline stage: the g rows of sub-filter s for every tile, and
  // ww[lo+k, n0:n0+BN, m0:m0+BM] transposed to [k][m][n]; ragged edges
  // zero-filled
  auto stage = [&](int buf, int c) {
    const int s = c / mchunks, m0 = (c % mchunks) * BM;
    const int lo = off_s[s], cnt = off_s[s + 1] - lo;
    float* gd = g_s + buf * K::kG;
    for (int e = tid; e < BT * M2 * BM; e += NT) {
      const int mm = e % BM, a = (e / BM) % M2, tl = e / (BM * M2);
      const int t = t0 + tl;
      const bool ok = t < T && m0 + mm < M;
      const float* src = ok ? g + ((size_t)t * s2m2 + s * M2 + a) * M + m0 + mm : g;
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
      float gv[M2];
#pragma unroll
      for (int a = 0; a < M2; ++a) gv[a] = gb[tl * GS + a * BM + mm];
      for (int k = 0; k < cnt; ++k)
        gw_s[(pos_s[lo + k] * BM + mm) * XT + tl] = fold_g<M2>(inv_s + (lo + k) * M2, gv);
    }
    __syncthreads();

    // dxw += gw . ww^T over this chunk's channels m, per Winograd position
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

  // every Winograd position of every tile is written, zeros included
  const bool vec = (N & 3) == 0;
#pragma unroll
  for (int kk = 0; kk < PG; ++kk) {
    const int p = kk * G + grp;
    if (p >= N2) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + tt * 4 + i, n = n0 + tn * 4;
      if (t >= T || n >= N) continue;
      float* o = dxw + ((size_t)t * N2 + p) * N + n;
      if (vec) {
        *reinterpret_cast<float4*>(o) = make_float4(acc[kk][i][0], acc[kk][i][1], acc[kk][i][2], acc[kk][i][3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < N) o[j] = acc[kk][i][j];
      }
    }
  }
}

// bwd_x on the tensor cores (bwd_x_core.cuh): one block per (T-tile, N-tile)
// holds every Winograd position of its BT tiles x BN channels; the grid runs
// N-tiles fastest where g outweighs ww (ww then stays in L2 while each g
// slab is read by consecutive blocks), T-tiles fastest otherwise.  Every
// position q < N2 of every tile is written, zeros included.
template <class K>
__global__ void __launch_bounds__(K::kThreads, K::kMinBlocks)
domain_bwd_x_mma_kernel(const float* __restrict__ g, const float* __restrict__ ww, const float* __restrict__ inv,
                        const int* __restrict__ pos, const int* __restrict__ sub_off, float* __restrict__ dxw,
                        int T, int N, int M, int S2, int N2, int n_tb, int n_nb, int n_fast) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);   // the pipeline
  float* inv_s = smem + K::kFloats;                // [C][M2]
  int* kmap_s = reinterpret_cast<int*>(inv_s + kMaxPos * kMaxSub * 4);  // [S^2][16]
  int* pos_s = kmap_s + kMaxSub * kMaxPos;  // [C]
  int* off_s = pos_s + kMaxSub * kMaxPos;   // [S^2 + 1]
  int* tile_s = off_s + kMaxSub + 1;             // [BT] tile index, -1 past T

  const int b = blockIdx.x;
  const int tb = n_fast ? b / n_nb : b % n_tb, nb = n_fast ? b % n_nb : b / n_tb;
  const int t0 = tb * K::BT, n0 = nb * K::BN;
  for (int i = threadIdx.x; i < K::BT; i += K::kThreads) tile_s[i] = t0 + i < T ? t0 + i : -1;
  bwdx::load_layout<K::M2>(inv_s, kmap_s, off_s, pos_s, inv, pos, sub_off, S2);

  bwdx::Acc<K> acc;
  bwdx::contract<K>(acc, smem, g, ww, tile_s, inv_s, kmap_s, off_s, S2, M, N, n0);

#pragma unroll
  for (int p = 0; p < K::NPS; ++p) {
    const int q = bwdx::position<K>(p);
    if (q >= N2) continue;
#pragma unroll
    for (int fa = 0; fa < K::FA; ++fa)
#pragma unroll
      for (int fb = 0; fb < K::FB; ++fb)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = t0 + bwdx::acc_slot<K>(fb, i), n = n0 + bwdx::acc_n(fa, i);
          if (t < T && n < N) dxw[((size_t)t * N2 + q) * N + n] = acc[p][fa][fb][i];
        }
  }
}

// ============================================================== bwd_w
// The fp32 CUDA-core bwd_w for few or ragged channels (M < 16 or M % 4 !=
// 0: RGB, mono): G position groups x (NT_N x NT_M) = (16 x 1) threads;
// group g owns the packed positions k = g, g + G, ... of the block's
// sub-filter; each thread a 4-channel (n) x 4-channel (m) micro tile; BT = 4
// tiles per T chunk, g rows in 4-byte copies; M2 outputs per tile.  In 1D
// (M2 = 2) a sub-filter holds at most n2 (3 at K4S2) positions: 4 position
// groups, not 8.
template <int M2>
struct BwCfg {
  static constexpr int kM2 = M2;
  static constexpr int G = M2 == 2 ? 4 : 8, NT_N = 16, NT_M = 1, BT = 4;
  static constexpr int PG = kMaxPos / G;
  static constexpr int kThreads = G * NT_N * NT_M;
  static constexpr int BN = NT_N * 4;
  static constexpr int BM = NT_M * 4;
  static constexpr int kX = kMaxPos * BT * BN;   // xw [k][tile][n], one stage
  static constexpr int kG = BT * M2 * BM;       // g rows, one stage
  static constexpr int kGw = kMaxPos * BT * BM;  // gw [k][tile][m]
  static constexpr int kRed = kMaxPos * BN * BM;  // one block's sums, in scratch
  static constexpr size_t kSmemBytes =
      sizeof(float) * (2 * (kX + kG) + kGw + kMaxPos * 4) + sizeof(int) * kMaxPos;
};

template <int M2, bool SPLIT>
__global__ void __launch_bounds__(BwCfg<M2>::kThreads)
domain_bwd_w_kernel(const float* __restrict__ xw, const float* __restrict__ g, const float* __restrict__ inv,
                    const int* __restrict__ pos, const int* __restrict__ sub_off, float* __restrict__ dww,
                    int T, int N, int M, int S2, int N2, int splits, float* __restrict__ partial,
                    int* __restrict__ counters) {
  using K = BwCfg<M2>;
  constexpr int G = K::G, NT_N = K::NT_N, NT_M = K::NT_M, BT = K::BT;
  constexpr int PG = K::PG, BN = K::BN, BM = K::BM, NT = K::kThreads;
  extern __shared__ float4 smem4[];
  float* x_s = reinterpret_cast<float*>(smem4);  // 2 x [16][BT][BN]
  float* gr_s = x_s + 2 * K::kX;                  // 2 x [BT][M2][BM]
  float* gw_s = gr_s + 2 * K::kG;                 // [16][BT][BM]
  float* inv_s = gw_s + K::kGw;                   // [16][M2]
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
  const int s2m2 = S2 * M2;

  if (tid < kMaxPos * M2) inv_s[tid] = (tid / M2 < cnt) ? inv[(lo + tid / M2) * M2 + tid % M2] : 0.0f;
  if (tid < kMaxPos) pos_s[tid] = tid < cnt ? pos[lo + tid] : 0;
  __syncthreads();

  // this block's share of the T loop: chunks [c_lo, c_lo + n_chunks)
  const int all_chunks = (T + BT - 1) / BT;
  const int c_lo = (int)((long long)ks * all_chunks / (SPLIT ? splits : 1));
  const int n_chunks = cnt > 0 ? (int)((long long)(ks + 1) * all_chunks / (SPLIT ? splits : 1)) - c_lo : 0;

  // one pipeline stage: the sub-filter's positions of xw for every tile of
  // the chunk, and the chunk's g rows for this sub-filter and M-tile
  auto stage = [&](int buf, int chunk) {
    const int t0 = chunk * BT;
    float* xd = x_s + buf * K::kX;
    const int nx = cnt * BT * (BN / 4);  // 16-byte copies: N % 4 == 0
    for (int e = tid; e < nx; e += NT) {
      const int nl = (e % (BN / 4)) * 4, tl = (e / (BN / 4)) % BT, k = e / (BN / 4 * BT);
      const int t = t0 + tl, n = n0 + nl;
      const bool ok = t < T && n < N;
      const float* src = ok ? xw + ((size_t)t * N2 + pos_s[k]) * N + n : xw;
      cp_async(xd + (k * BT + tl) * BN + nl, src, ok, 16);
    }
    float* gd = gr_s + buf * K::kG;
    for (int e = tid; e < BT * M2 * BM; e += NT) {
      const int mm = e % BM, a = (e / BM) % M2, tl = e / (BM * M2);
      const int t = t0 + tl;
      const bool ok = t < T && m0 + mm < M;
      const float* src = ok ? g + ((size_t)t * s2m2 + s * M2 + a) * M + m0 + mm : g;
      cp_async(gd + (tl * M2 + a) * BM + mm, src, ok, 4);
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

    // gw = inv-weighted fold of g, into gw_s[k][tile][m]
    const float* gb = gr_s + buf * K::kG;
    for (int it = tid; it < BT * BM; it += NT) {
      const int mm = it % BM, tl = it / BM;
      float gv[M2];
#pragma unroll
      for (int a = 0; a < M2; ++a) gv[a] = gb[(tl * M2 + a) * BM + mm];
      for (int k = 0; k < cnt; ++k) gw_s[(k * BT + tl) * BM + mm] = fold_g<M2>(inv_s + k * M2, gv);
    }
    __syncthreads();

    // dww[k] += xw[:, pos_k]^T . gw[k] over this chunk's tiles
    const float* xb = x_s + buf * K::kX + tn * 4;
#pragma unroll
    for (int kk = 0; kk < PG; ++kk) {
      const int k = kk * G + gq;
      if (k < cnt) {
        const float* xp = xb + k * BT * BN;
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
// p, N tile, M tile) and T split; its A operand is xw at p's Winograd
// position, staged as rows [tile][n] and split in fragment order.
template <class K, bool SPLIT>
__global__ void __launch_bounds__(K::kThreads, 1)
domain_bwd_w_mma_kernel(const float* __restrict__ xw, const float* __restrict__ g, const float* __restrict__ inv,
                        const int* __restrict__ pos, const int* __restrict__ sub_off, float* __restrict__ dww,
                        int T, int N, int M, int S2, int N2, int splits, float* __restrict__ partial,
                        int* __restrict__ counters) {
  static_assert(K::EA == 1, "one xw plane");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int n_nt = (N + K::BN - 1) / K::BN, n_mt = (M + K::BM - 1) / K::BM;
  const int grp = blockIdx.x, p = grp / (n_nt * n_mt);
  const int n0 = (grp / n_mt) % n_nt * K::BN, m0 = grp % n_mt * K::BM;
  const int ks = SPLIT ? blockIdx.y : 0;
  int s = 0;
  while (sub_off[s + 1] <= p) ++s;  // p's sub-filter
  const int q = pos[p];
  float iv[K::M2];
#pragma unroll
  for (int a = 0; a < K::M2; ++a) iv[a] = inv[p * K::M2 + a];
  const int all = (T + K::BT - 1) / K::BT, nsp = SPLIT ? splits : 1;
  const int c_lo = (int)((long long)ks * all / nsp);
  const int n_chunks = (int)((long long)(ks + 1) * all / nsp) - c_lo;

  // one stage: the chunk's xw rows at q [tile][n], then its g rows
  auto stage = [&](float* raw, int chunk) {
    constexpr int SEG = K::BN / 4;
    const int t0 = chunk * K::BT;
    for (int e = threadIdx.x; e < K::BT * SEG; e += K::kThreads) {
      const int seg = e % SEG, tl = e / SEG, t = t0 + tl, n = n0 + 4 * seg;
      const bool ok = t < T && n < N;
      cp_async(raw + tl * K::RS + 4 * seg, ok ? xw + ((size_t)t * N2 + q) * N + n : xw, ok, 16);
    }
    bwdw::stage_g<K>(raw + K::kRawA, g, t0, T, S2 * K::M2, s * K::M2, M, m0);
    cp_async_commit();
  };
  // the A pass: channels (n, n+1) of tiles (t, t+1), split in fragment order
  auto prep_a = [&](uint32_t* split, const float* raw) {
    for (int slot = threadIdx.x; slot < K::BT * K::BN / 4; slot += K::kThreads) {
      int n, t;
      bwdw::a_slot<K>(slot, n, t);
      const float2 v0 = *reinterpret_cast<const float2*>(raw + t * K::RS + n);
      const float2 v1 = *reinterpret_cast<const float2*>(raw + (t + 1) * K::RS + n);
      bwdw::put_a<K>(split, slot, v0.x, v0.y, v1.x, v1.y);
    }
  };
  bwdw::Acc<K> acc;
  bwdw::contract<K>(acc, smem, c_lo, n_chunks, iv, stage, prep_a);
  bwdw::finish<K, SPLIT>(acc, dww, p, n0, m0, N, M, grp, ks, splits, partial, counters);
}

// ------------------------------------------------------ configurations
template <int G_, int NT_T_, int NT_M_, int BN_, int VW_>
struct FwdConf {
  static constexpr int G = G_, NT_T = NT_T_, NT_M = NT_M_, BN = BN_, VW = VW_;
  using K = FwdCfg<G, NT_T, NT_M, BN>;
};
#define FWD_KERNEL(C, SPLIT) domain_fwd_kernel<C::G, C::NT_T, C::NT_M, C::BN, C::VW, SPLIT>

// fwd block configuration for M: 32 tiles x 32 channels per block, 8
// position groups, 512 threads, weights in 16-byte copies; or, for few or
// ragged M (RGB), 64 tiles x 4 channels, 128 threads, 4-byte weight copies.
template <class F>
int with_fwd_conf(int M, F&& f) {
  if (M >= 32 && M % 4 == 0) return f(FwdConf<8, 8, 8, 16, 4>{});
  return f(FwdConf<8, 16, 1, 8, 1>{});
}

template <int M2_>
struct BxConf {
  static constexpr int M2 = M2_;
  static constexpr bool kMma = false;
  using K = BxCfg<M2>;
};
#define BX_KERNEL(C) domain_bwd_x_kernel<C::M2>

template <class K_>
struct BxMma {
  static constexpr bool kMma = true;
  using K = K_;
};

// bwd_x configuration for (M, M2, N2): the tensor cores where M % 4 == 0
// and M >= 8 (g and ww in 16-byte copies: the wrapper has checked their
// alignment): in 2D 64 tiles x 32 channels n a block, two position sets of
// 4 warps, each warp 32 n x 16 tiles x 8 positions (the set's colour of the
// 4x4 checkerboard); at rank 1 with n2 <= 4 positions 128 tiles x 64 n,
// each warp 64 n x 16 tiles x all positions; rank 1 with more positions as
// 2D with one set.  Otherwise (few or ragged channels: RGB, the audio
// decoder's mono waveform) the fp32 CUDA-core kernel (BxCfg).
template <class F>
int with_bx_conf(int M, int M2, int N2, F&& f) {
  if (M >= 8 && M % 4 == 0) {
    if (M2 == 2 && N2 <= 4) return f(BxMma<bwdx::Core<4, 2, 4, 2, 8>>{});
    if (M2 == 2) return f(BxMma<bwdx::Core<16, 2, 2, 1, 8>>{});
    return f(BxMma<bwdx::Core<16, 4, 2, 2, 8, 2>>{});
  }
  if (M2 == 2) return f(BxConf<2>{});
  return f(BxConf<4>{});
}

// dynamic shared memory of the tensor-core kernel: the pipeline, the layout
// tables and the tile slots
template <class K>
constexpr size_t mma_smem_bytes() {
  return sizeof(float) * (K::kFloats + kMaxPos * kMaxSub * 4) +
         sizeof(int) * (2 * kMaxSub * kMaxPos + kMaxSub + 1 + K::BT);
}

template <int M2_>
struct BwConf {
  static constexpr bool kMma = false;
  using K = BwCfg<M2_>;
};
template <class K_>
struct BwMma {
  static constexpr bool kMma = true;
  using K = K_;
};

// bwd_w configuration for (N, M, M2): the tensor cores where M % 4 == 0 and
// M >= 16 (g rows in 16-byte copies: the wrapper has checked g's
// alignment): 256 channels n x 128 m a block, 8 warps of 64 x 64, 16 tiles
// a chunk (193 KB of shared memory in 2D, 161 KB at rank 1), or at rank 1
// with N < 256 or M < 128 (the audio decoder's 128 -> 64 layer) 128 x 64, 4
// warps of 64 x 32 (81 KB); otherwise (few or ragged channels: RGB, the
// audio decoder's mono waveform) the fp32 CUDA-core kernel (BwCfg).
template <class F>
int with_bw_conf(int N, int M, int M2, F&& f) {
  if (M >= 16 && M % 4 == 0) {
    if (M2 == 4) return f(BwMma<bwdw::Core<4, 2, 4, 8, 16, 4, 1>>{});
    if (N >= 256 && M >= 128) return f(BwMma<bwdw::Core<4, 2, 4, 8, 16, 2, 1>>{});
    return f(BwMma<bwdw::Core<2, 2, 4, 4, 16, 2, 1>>{});
  }
  if (M2 == 2) return f(BwConf<2>{});
  return f(BwConf<4>{});
}

// The bwd_w kernel of configuration Cf, with or without the T split
template <class Cf, bool SPLIT>
auto bw_kernel() {
  if constexpr (Cf::kMma)
    return domain_bwd_w_mma_kernel<typename Cf::K, SPLIT>;
  else
    return domain_bwd_w_kernel<Cf::K::kM2, SPLIT>;
}

}  // namespace

// Plain C entry points (bound with ctypes).  Every pointer is a device
// pointer; xw and dxw are (T, N2, N), g and y are (T, S2*M2, M), ww and dww
// (C, N, M), inv (C, M2), pos (C,), sub_off (S2 + 1,); fwd takes M2 = 4,
// N2 = 16 only, the backward kernels also M2 = 2 with N2 <= 16.  The plan functions
// also raise their kernels' shared-memory limit on the current device,
// which a launch needs: call each for M on that device before its first
// launch.  Every launch returns cudaGetLastError().

// fwd split plan: the split count minimises the waves of blocks over the
// card's resident block slots, times the work per block (1/k), times a 25%
// cost per extra split; at least 4 N chunks per split (fused_engine_plan's
// rule).  scratch_floats / counters are 0 when the split count is 1.
extern "C" int domain_engine_fwd_plan(int T, int N, int M, int S2, int device, int* splits,
                                      long long* scratch_floats, long long* counters) {
  return with_fwd_conf(M, [&](auto conf) {
    using C = decltype(conf);
    using K = typename C::K;
    cudaError_t err = cudaFuncSetAttribute(FWD_KERNEL(C, false), cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)K::kSmemBytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(FWD_KERNEL(C, true), cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)K::kSmemBytes);
    int occ = 0, sms = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, FWD_KERNEL(C, false), K::kThreads, K::kSmemBytes);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    const long long slots = occ > 0 ? (long long)occ * sms : 1;
    const long long groups = (long long)((T + K::BT - 1) / K::BT) * S2 * ((M + K::BM - 1) / K::BM);
    const int chunks = (N + C::BN - 1) / C::BN;
    int best = 1;
    double best_cost = (double)((groups + slots - 1) / slots);
    for (int k = 2; k <= 8 && chunks / k >= 4; ++k) {
      const double cost = (double)((groups * k + slots - 1) / slots) / k * (1.0 + 0.25 * (k - 1));
      if (cost < best_cost - 1e-9) best = k, best_cost = cost;
    }
    *splits = best;
    *scratch_floats = best > 1 ? groups * best * K::kRed : 0;
    *counters = best > 1 ? groups : 0;
    return 0;
  });
}

// One fwd launch -> y (T, S2*4, M), every element written.  splits, partial
// and counters from domain_engine_fwd_plan; the counters are zero on entry
// and the kernel leaves them zero.
extern "C" int domain_engine_fwd_f32(const float* xw, const float* ww, const float* inv, const int* pos,
                                     const int* sub_off, float* y, int T, int N, int M, int S2, int splits,
                                     float* partial, int* counters, void* stream) {
  return with_fwd_conf(M, [&](auto conf) {
    using C = decltype(conf);
    using K = typename C::K;
    auto kernel = splits > 1 ? FWD_KERNEL(C, true) : FWD_KERNEL(C, false);
    dim3 grid((T + K::BT - 1) / K::BT, S2, ((M + K::BM - 1) / K::BM) * splits);
    kernel<<<grid, K::kThreads, K::kSmemBytes, reinterpret_cast<cudaStream_t>(stream)>>>(
        xw, ww, inv, pos, sub_off, y, T, N, M, S2, splits, partial, counters);
    return (int)cudaGetLastError();
  });
}

// Raises the bwd_x kernel's shared-memory limit for (M, M2, N2) on the
// current device (call it before the first launch for this shape).
extern "C" int domain_engine_bwd_x_plan(int M, int M2, int N2) {
  return with_bx_conf(M, M2, N2, [&](auto conf) {
    using Cf = decltype(conf);
    using K = typename Cf::K;
    if constexpr (Cf::kMma)
      return (int)cudaFuncSetAttribute(domain_bwd_x_mma_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)mma_smem_bytes<K>());
    else
      return (int)cudaFuncSetAttribute(BX_KERNEL(Cf), cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)K::kSmemBytes);
  });
}

// One bwd_x launch: g, ww -> dxw (T, N2, N), every element written.  C:
// the packed positions.  Where M % 4 == 0, g and ww start on 16-byte
// boundaries.
extern "C" int domain_engine_bwd_x_f32(const float* g, const float* ww, const float* inv, const int* pos,
                                       const int* sub_off, float* dxw, int T, int N, int M, int S2, int M2,
                                       int N2, int C, void* stream) {
  return with_bx_conf(M, M2, N2, [&](auto conf) {
    using Cf = decltype(conf);
    using K = typename Cf::K;
    const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    const int n_tb = (T + K::BT - 1) / K::BT, n_nb = (N + K::BN - 1) / K::BN;
    if constexpr (Cf::kMma) {
      // N-tiles fastest where g (T*S2*M2 rows of M) outweighs ww (C*N rows)
      const int n_fast = (long long)T * S2 * M2 > (long long)C * N;
      domain_bwd_x_mma_kernel<K><<<n_tb * n_nb, K::kThreads, mma_smem_bytes<K>(), st>>>(
          g, ww, inv, pos, sub_off, dxw, T, N, M, S2, N2, n_tb, n_nb, n_fast);
    } else {
      BX_KERNEL(Cf)<<<dim3(n_tb, n_nb), K::kThreads, K::kSmemBytes, st>>>(g, ww, inv, pos, sub_off, dxw, T, N, M,
                                                                          S2, N2);
    }
    return (int)cudaGetLastError();
  });
}

// bwd_w plan: the T-loop split and the block tile for this shape.  The
// tensor-core kernel runs a block per (packed position, N tile, M tile)
// group and splits T by bwdw::plan_splits; the CUDA-core kernel a block per
// (sub-filter, N tile, M tile), split over as many blocks as fill the card's
// resident block slots once, at least 4 chunks a split
// (fused_engine_bwd_w_plan's rules).  tile gets (BN, BM, BT, 1 for the
// tensor cores or 0).
extern "C" int domain_engine_bwd_w_plan(int T, int N, int M, int S2, int M2, int C, int device, int* splits,
                                        long long* scratch_floats, long long* counters, int* tile) {
  return with_bw_conf(N, M, M2, [&](auto conf) {
    using Cf = decltype(conf);
    using K = typename Cf::K;
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
    const long long chunks = ((long long)T + K::BT - 1) / K::BT;
    long long groups, k;
    if constexpr (Cf::kMma) {
      groups = (long long)C * tiles;
      k = bwdw::plan_splits(groups, chunks, slots);
    } else {
      groups = (long long)S2 * tiles;
      k = slots / groups;
      if (k > chunks / 4) k = chunks / 4;
      if (k > 65535) k = 65535;
      if (k < 1) k = 1;
    }
    *splits = (int)k;
    *scratch_floats = k > 1 ? groups * k * K::kRed : 0;
    *counters = k > 1 ? groups : 0;
    tile[0] = K::BN;
    tile[1] = K::BM;
    tile[2] = K::BT;
    tile[3] = Cf::kMma;
    return 0;
  });
}

// One bwd_w launch: xw, g -> dww (C, N, M), every element written.  C the
// packed positions; splits, partial and counters from
// domain_engine_bwd_w_plan with the same shape; the counters are zero on
// entry and the kernel leaves them zero; xw (and g where M % 4 == 0 and M >=
// 16) start on 16-byte boundaries.
extern "C" int domain_engine_bwd_w_f32(const float* xw, const float* g, const float* inv, const int* pos,
                                       const int* sub_off, float* dww, int T, int N, int M, int S2, int M2,
                                       int N2, int C, int splits, float* partial, int* counters, void* stream) {
  return with_bw_conf(N, M, M2, [&](auto conf) {
    using Cf = decltype(conf);
    using K = typename Cf::K;
    const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    const int tiles = ((N + K::BN - 1) / K::BN) * ((M + K::BM - 1) / K::BM);
    // a block per (packed position or, on the CUDA cores, sub-filter, N tile, M tile) and split
    const dim3 grid((Cf::kMma ? C : S2) * tiles, splits);
    auto kernel = splits > 1 ? bw_kernel<Cf, true>() : bw_kernel<Cf, false>();
    kernel<<<grid, K::kThreads, K::kSmemBytes, st>>>(xw, g, inv, pos, sub_off, dww, T, N, M, S2, N2, splits,
                                                     partial, counters);
    return (int)cudaGetLastError();
  });
}
