// The weight-gradient contraction of the engines, on Hopper's tensor cores
// at fp32 accuracy (3xTF32).  Shared by
//   * domain_engine.cu's bwd_w (replaces src/repro/kernels/engine.py::
//     domain_engine_bwd_w, the pallas_call at engine.py:1085), 2D and rank 1;
//   * fused_engine_bwd.cu's bwd_w at the deconv corner and conv_engine.cu's
//     at the conv corner (replace engine.py::fused_engine_bwd_w, the
//     pallas_call at engine.py:1427, as the two corners instantiate it):
//     one block body for both, window_block, which forms xw from the cell
//     windows.
// For one packed position p of sub-filter s, a BN x BM block of (n, m) and a
// range of tiles t it accumulates
//     dww[p, n, m] = sum_t xw[t, pos_p, n] * gw[p, t, m],
//     gw[p, t, m]  = sum_a inv[p, a] * g[t, s*M2 + a, m],
// in registers: one GEMM per packed position whose K is the tile index.
//
// What bounded the fp32 CUDA-core design it replaces (10-16 TFLOP/s, 15-24%
// of the fp32 peak): each thread held 2 positions x a 4 x 4 micro tile and
// issued two float4 shared loads for every 16 FMAs, 8 tiles between two
// barriers; and at the deconv corner every (tile, channel) of xw was formed
// for all 16 Winograd positions once per sub-filter and 32-channel M tile
// (S^2 * M/32 times: 64 at DCGAN's first layer), on half the block's
// threads.  What this design does:
//   * products on the tensor cores: mma.sync m16n8k8 TF32 with each operand
//     split into hi = tf32(x) and lo = x - hi, lo*hi + hi*lo + hi*hi
//     (bwd_x_core.cuh's split_tf32 and mma_tf32).  A = xw (16 channels n x 8
//     tiles), B = gw (8 tiles x 8 channels m), D = dww (n x m).  K is the
//     tile index, so its order inside a fragment is free: a lane's A values
//     are channels (n, n+1) of tiles (t, t+1), its B values channel m of the
//     same two tiles, and D's rows are read back as that channel pair.  The
//     tensor cores add into their accumulator with truncation, and K runs to
//     thousands of tiles, so each k-step's three products go into registers
//     that start at zero and are added to the fp32 accumulators with rounded
//     fp32 adds (mma_chunk);
//   * the operands are split once, in shared memory, by the pass that forms
//     them from the staged rows: the kernel's own A pass (a relayout of the
//     staged xw rows in domain_engine.cu, B^T Z B of the window's four
//     entries the position reads in fused_engine_bwd.cu) and the gw fold
//     here.  Each pass writes hi and lo in the order the fragment loads read
//     them, a lane's 16 bytes contiguous: the loads, and the passes' stores,
//     are free of bank conflicts with no swizzle.  The inner loop is shared
//     loads and mma only; a warp holds FA x FB fragments (64 n x 64 m), so
//     each operand byte it loads feeds 8 or 4 products;
//   * one packed position a block, every warp on every chunk: the block's
//     warps split its BN x BM tile, so none idles where a sub-filter lacks a
//     position (the grid holds each position's tiles);
//   * a pipeline of two stages: the raw rows of chunk c+2 arrive by
//     16-byte cp.async while chunk c's products run and chunk c+1's operands
//     are split, one barrier a chunk;
//   * the long, thin T loops (DCGAN's deconv2, the audio decoder) split
//     over blocks; each block writes its sums to scratch and the last to
//     arrive adds them in split order and resets its arrival counter: the
//     result does not depend on the order blocks run in, and the sums inside
//     a block go chunk by chunk in tile order.  Two launches on the same
//     inputs are bitwise equal.
// 16-byte copies need M % 4 == 0, N % 4 == 0 and 16-byte-aligned g and xw
// or cells (the Python wrappers refuse misaligned ones); few or ragged
// channels (M < 16 or M % 4 != 0: RGB M = 3, mono M = 1) keep each kernel's
// fp32 CUDA-core kernel.
// What bounds it now (on an H100; PERF.md): latency, at about a fifth of
// the 3xTF32 rate.  One block of 8 warps an SM (the shared memory of two
// stages) runs a chunk's products, then splits the next chunk's operands,
// between barriers; taking out the products, the copies or the operand
// passes each saved a part of the time, none all of it.
// Smaller tiles (128 x 128 at two blocks an SM, or 64 x 32 warp tiles) ran
// 8-54% slower (more bytes through L2 and shared memory per product); a
// third stage of raw rows ran 3% slower at the deconv corner.
// Shared memory: two stages of the split operands (8 bytes an element: BT x
// (BN + BM) x 8) and two of the raw rows (EA planes of BT x (BN + 4) floats
// and BT x (M2 * BM + 4) of g): 193 KB for the 2D configuration (256 x 128,
// 16 tiles), 145 KB at the deconv corner (4 window planes, 8 tiles), 161 KB
// and 81 KB at rank 1, within the 227 KB a block may have.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bwd_x_core.cuh"

namespace bwdw {

using bwdx::cp_async;
using bwdx::cp_async_commit;
using bwdx::cp_async_wait;
using bwdx::mma_tf32;
using bwdx::split_tf32;

// The block's geometry: WN x WM warps, each FA 16-channel (n) x FB 8-channel
// (m) fragments; BT tiles a chunk; M2 rows of g per tile and sub-filter (4 in
// 2D, 2 at rank 1); EA raw planes of the A operand a chunk (1: xw rows, 4:
// the window entries of one Winograd position).
template <int WN_, int WM_, int FA_, int FB_, int BT_, int M2_, int EA_>
struct Core {
  static constexpr int WN = WN_, WM = WM_, FA = FA_, FB = FB_, BT = BT_, M2 = M2_, EA = EA_;
  static_assert(BT % 8 == 0, "a chunk is whole mma k-steps of 8 tiles");
  static constexpr int kThreads = 32 * WN * WM;
  static constexpr int BN = 16 * FA * WN;  // input channels n a block
  static constexpr int BM = 8 * FB * WM;   // output channels m a block
  static constexpr int KS = BT / 8;        // k-steps a chunk
  // split operands of one chunk, in fragment order: A hi and A lo
  // [KS][BN/16][lane][4], then B [KS][BM/8][lane][hi0, hi1, lo0, lo1]
  static constexpr int kA = BT * BN;
  static constexpr int kSplit = 2 * kA + 2 * BT * BM;
  // raw rows of one chunk: EA planes [tile][RS], then g [tile][GS] (a tile's
  // M2 rows of BM); RS and GS are 4 mod 32 words, so a half warp's 8-byte
  // reads of 2 tiles x 4 channel pairs (A) and a warp's 4-byte reads of 4
  // tile pairs x 8 channels (B) fall on distinct banks
  static constexpr int RS = BN + 4;
  static constexpr int GS = M2 * BM + 4;
  static_assert(RS % 32 == 4 && GS % 32 == 4, "raw row strides are 4 mod 32 words");
  static constexpr int kRawA = EA * BT * RS;
  static constexpr int kRaw = kRawA + BT * GS;
  static constexpr int kFloats = 2 * kSplit + 2 * kRaw;
  static constexpr size_t kSmemBytes = sizeof(float) * kFloats;
  static constexpr int kRed = kThreads * FA * FB * 4;  // one block's sums (= BN * BM), in scratch
};

template <class K>
using Acc = float[K::FA][K::FB][4];

// A slot `slot` of a chunk (a lane's 4 values of one fragment): channels
// (n, n+1) of the block, tiles (t, t+1) of the chunk
template <class K>
__device__ __forceinline__ void a_slot(int slot, int& n, int& t) {
  const int lane = slot & 31, f = slot >> 5;
  n = 16 * (f % (K::BN / 16)) + 2 * (lane >> 2);
  t = 8 * (f / (K::BN / 16)) + 2 * (lane & 3);
}

// Write A slot `slot` from its values x(n, t), x(n+1, t), x(n, t+1),
// x(n+1, t+1), split into TF32 halves
template <class K>
__device__ __forceinline__ void put_a(uint32_t* split, int slot, float x0, float x1, float x2, float x3) {
  uint4 h, l;
  split_tf32(x0, h.x, l.x);
  split_tf32(x1, h.y, l.y);
  split_tf32(x2, h.z, l.z);
  split_tf32(x3, h.w, l.w);
  *reinterpret_cast<uint4*>(split + 4 * slot) = h;
  *reinterpret_cast<uint4*>(split + K::kA + 4 * slot) = l;
}

// Stage the chunk's g rows of sub-filter s for channels [m0, m0 + BM): tile
// t0 + tl, row s*M2 + a into graw[tl*GS + a*BM + m]; tiles past T and
// channels past M zero-filled.  16-byte copies (M % 4 == 0).
template <class K>
__device__ __forceinline__ void stage_g(float* graw, const float* __restrict__ g, int t0, int T, int s2m2,
                                        int srow, int M, int m0) {
  constexpr int SEG = K::BM / 4;
  for (int e = threadIdx.x; e < K::BT * K::M2 * SEG; e += K::kThreads) {
    const int seg = e % SEG, a = (e / SEG) % K::M2, tl = e / (SEG * K::M2);
    const int t = t0 + tl, m = m0 + 4 * seg;
    const bool ok = t < T && m < M;
    cp_async(graw + tl * K::GS + a * K::BM + 4 * seg, ok ? g + ((size_t)t * s2m2 + srow + a) * M + m : g, ok, 16);
  }
}

// The gw pass: B slot (k-step j, fragment f, lane) holds gw of channel m =
// 8f + lane/4 at tiles t = 8j + 2(lane%4) and t+1, split into hi and lo
template <class K>
__device__ __forceinline__ void prep_b(uint32_t* split, const float* graw, const float (&iv)[K::M2]) {
  uint32_t* bs = split + 2 * K::kA;
  for (int slot = threadIdx.x; slot < K::BT * K::BM / 2; slot += K::kThreads) {
    const int lane = slot & 31, f = slot >> 5;
    const int m = 8 * (f % (K::BM / 8)) + (lane >> 2), t = 8 * (f / (K::BM / 8)) + 2 * (lane & 3);
    const float* r0 = graw + t * K::GS + m;
    float x0 = 0.0f, x1 = 0.0f;
#pragma unroll
    for (int a = 0; a < K::M2; ++a) {
      x0 = fmaf(iv[a], r0[a * K::BM], x0);
      x1 = fmaf(iv[a], r0[K::GS + a * K::BM], x1);
    }
    uint4 v;
    split_tf32(x0, v.x, v.z);
    split_tf32(x1, v.y, v.w);
    *reinterpret_cast<uint4*>(bs + 4 * slot) = v;
  }
}

// The products of one prepared chunk: warp (wn, wm) takes fragments
// [wn*FA, +FA) of n and [wm*FB, +FB) of m.  Per k-step it loads its A
// fragments, then, two B fragments at a time, runs the three terms (lo*hi,
// hi*lo, hi*hi) of those 2 x FA fragments into registers that start at zero,
// term by term over the fragments, and adds them to the accumulators with
// fp32 adds.  The tensor cores add into their accumulator with truncation;
// a chain of hundreds of such adds over the tiles lost ~1e-5 of the sum on
// the card (25x the fp32 FMA kernel's error), enough to move the per-layer
// train step's metrics past their check.  Adding each k-step's products with
// a rounded fp32 add keeps the kernel within a few fp32 roundings.
template <class K>
__device__ __forceinline__ void mma_chunk(Acc<K>& acc, const uint32_t* split) {
  static_assert(K::FB % 2 == 0, "B fragments in pairs");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wn = warp / K::WM, wm = warp % K::WM;
  const uint32_t* ah = split;
  const uint32_t* al = split + K::kA;
  const uint32_t* bs = split + 2 * K::kA;
#pragma unroll
  for (int j = 0; j < K::KS; ++j) {
    uint4 a_hi[K::FA], a_lo[K::FA];
#pragma unroll
    for (int fa = 0; fa < K::FA; ++fa) {
      const int o = 4 * ((j * (K::BN / 16) + wn * K::FA + fa) * 32 + lane);
      a_hi[fa] = *reinterpret_cast<const uint4*>(ah + o);
      a_lo[fa] = *reinterpret_cast<const uint4*>(al + o);
    }
#pragma unroll
    for (int fb0 = 0; fb0 < K::FB; fb0 += 2) {
      uint4 b[2];
      float p[K::FA][2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        b[h] = *reinterpret_cast<const uint4*>(bs + 4 * ((j * (K::BM / 8) + wm * K::FB + fb0 + h) * 32 + lane));
#pragma unroll
        for (int fa = 0; fa < K::FA; ++fa)
#pragma unroll
          for (int i = 0; i < 4; ++i) p[fa][h][i] = 0.0f;
      }
#pragma unroll
      for (int term = 0; term < 3; ++term)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int fa = 0; fa < K::FA; ++fa) {
            const uint4& a = term == 0 ? a_lo[fa] : a_hi[fa];
            const uint32_t b0 = term == 1 ? b[h].z : b[h].x, b1 = term == 1 ? b[h].w : b[h].y;
            mma_tf32(p[fa][h], a.x, a.y, a.z, a.w, b0, b1);
          }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int fa = 0; fa < K::FA; ++fa)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[fa][fb0 + h][i] += p[fa][h][i];
    }
  }
}

// The whole T loop of a block: chunks [c_lo, c_lo + n_chunks) through the
// two-stage pipeline.  stage(raw, chunk) issues the chunk's copies (the A
// planes, then stage_g) and commits them; prep_a(split, raw) writes every A
// slot from the staged planes; prep_b folds g.  acc holds the sums on return.
template <class K, class Stage, class PrepA>
__device__ __forceinline__ void contract(Acc<K>& acc, float* smem, int c_lo, int n_chunks, const float (&iv)[K::M2],
                                         Stage&& stage, PrepA&& prep_a) {
#pragma unroll
  for (int fa = 0; fa < K::FA; ++fa)
#pragma unroll
    for (int fb = 0; fb < K::FB; ++fb)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[fa][fb][i] = 0.0f;
  // stage b of the split operands and of the raw rows
  auto split = [&](int b) { return reinterpret_cast<uint32_t*>(smem) + b * K::kSplit; };
  auto raw = [&](int b) { return smem + 2 * K::kSplit + b * K::kRaw; };
  if (n_chunks <= 0) return;
  stage(raw(0), c_lo);
  if (n_chunks > 1) {
    stage(raw(1), c_lo + 1);
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();
  prep_a(split(0), raw(0));
  prep_b<K>(split(0), raw(0) + K::kRawA, iv);
  for (int c = 0; c < n_chunks; ++c) {
    const int b = c & 1;
    if (c + 1 < n_chunks) cp_async_wait<0>();  // chunk c+1's rows
    __syncthreads();  // chunk c split; raw(b) and split(b ^ 1) free
    if (c + 2 < n_chunks) stage(raw(b), c_lo + c + 2);
    mma_chunk<K>(acc, split(b));
    if (c + 1 < n_chunks) {
      prep_a(split(b ^ 1), raw(b ^ 1));
      prep_b<K>(split(b ^ 1), raw(b ^ 1) + K::kRawA, iv);
    }
  }
}

// The block's sums into dww[p, n0:n0+BN, m0:m0+BM] (rows past N, channels
// past M dropped; M % 4 == 0, so a channel pair stays inside M).  With a T
// split, every block of the group (grp) writes its sums to scratch, and the
// last to arrive adds the splits in order, writes dww and leaves the
// group's counter at 0 for the next launch.
template <class K, bool SPLIT>
__device__ __forceinline__ void finish(Acc<K>& acc, float* __restrict__ dww, int p, int n0, int m0, int N, int M,
                                       int grp, int ks, int splits, float* __restrict__ partial,
                                       int* __restrict__ counters) {
  const int tid = threadIdx.x;
  if constexpr (SPLIT) {
    __shared__ int last;
    float* mine = partial + ((size_t)grp * splits + ks) * K::kRed;
#pragma unroll
    for (int fa = 0; fa < K::FA; ++fa)
#pragma unroll
      for (int fb = 0; fb < K::FB; ++fb)
        __stcg(reinterpret_cast<float4*>(mine + 4 * ((fa * K::FB + fb) * K::kThreads + tid)),
               make_float4(acc[fa][fb][0], acc[fa][fb][1], acc[fa][fb][2], acc[fa][fb][3]));
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      last = atomicAdd(counters + grp, 1) == splits - 1;
      if (last) counters[grp] = 0;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
#pragma unroll
    for (int fa = 0; fa < K::FA; ++fa)
#pragma unroll
      for (int fb = 0; fb < K::FB; ++fb) {
        float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        for (int j = 0; j < splits; ++j) {
          const float4 v = __ldcg(reinterpret_cast<const float4*>(
              partial + ((size_t)grp * splits + j) * K::kRed + 4 * ((fa * K::FB + fb) * K::kThreads + tid)));
          sum.x += v.x;
          sum.y += v.y;
          sum.z += v.z;
          sum.w += v.w;
        }
        acc[fa][fb][0] = sum.x;
        acc[fa][fb][1] = sum.y;
        acc[fa][fb][2] = sum.z;
        acc[fa][fb][3] = sum.w;
      }
  }
  const int lane = tid & 31, warp = tid >> 5;
  const int wn = warp / K::WM, wm = warp % K::WM;
#pragma unroll
  for (int fa = 0; fa < K::FA; ++fa)
#pragma unroll
    for (int fb = 0; fb < K::FB; ++fb) {
      const int n = n0 + 16 * (wn * K::FA + fa) + 2 * (lane >> 2), m = m0 + 8 * (wm * K::FB + fb) + 2 * (lane & 3);
      if (m >= M) continue;
      float* o = dww + ((size_t)p * N + n) * M + m;
      if (n < N) *reinterpret_cast<float2*>(o) = make_float2(acc[fa][fb][0], acc[fa][fb][1]);
      if (n + 1 < N) *reinterpret_cast<float2*>(o + M) = make_float2(acc[fa][fb][2], acc[fa][fb][3]);
    }
}

// The fused engines' bwd_w (kernel 7, at both corners) for one block: packed
// position p, at Winograd position q = (u, v), N tile n0, M tile m0, T split
// ks.  Its A operand, xw at q, is formed from the four window entries that
// row u and column v of B^T read (B^T = [[1,0,-1,0],[0,1,1,0],[0,-1,1,0],
// [0,1,0,-1]]: two entries a row, each +-1), so the block stages those four
// planes of the cell windows, not all sixteen, and forms only its own
// position: x = sum over the row's (a, ra) and the column's (c, rc) of
// ra*rc*Z[a][c].  The corner fixes the layouts at compile time: the cells
// hold cs rows of N channels a cell, Gy x Gx cells an image, and a tile's
// window entry (a, c) is row sub + 2(a&1) + (c&1) of the cell (a/2, c/2)
// past the tile's first; its g rows are srow .. srow+3 of the s2m2 rows of a
// tile.  At the deconv corner (CONV false) the cells hold one phase (cs = 4,
// sub = 0) and g the S2 sub-filters' rows, s the sub-filter (s2m2 = 4 S2,
// srow = 4s); at the conv corner the cells hold the S2 phases (cs = 4 S2,
// sub = 4s, s the phase) and g one sub-filter (s2m2 = 4, srow = 0).
template <class K, bool SPLIT, bool CONV>
__device__ __forceinline__ void window_block(const float* __restrict__ cells, const float* __restrict__ g,
                                             const float* __restrict__ inv, float* __restrict__ dww, int grp, int p,
                                             int q, int n0, int m0, int ks, int S2, int s, int B, int Gy, int Gx,
                                             int N, int M, int ty, int tx, int splits, float* __restrict__ partial,
                                             int* __restrict__ counters) {
  static_assert(K::EA == 4 && K::M2 == 4, "four window planes, m^2 = 4 rows of g");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tpi = ty * tx, T = B * tpi;
  const int cs = CONV ? 4 * S2 : 4, sub = CONV ? 4 * s : 0;
  float iv[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) iv[a] = inv[p * 4 + a];

  // the window entries of q: rows a0 < a1 of B^T's row u and columns c0 < c1
  // of its row v, entry e = 2i + j at (a_i, c_j), its offset from the tile's
  // first window row in rows of N, and its sign
  const int u = q >> 2, v = q & 3;
  const int a0 = u == 0 ? 0 : 1, a1 = u == 3 ? 3 : 2, c0 = v == 0 ? 0 : 1, c1 = v == 3 ? 3 : 2;
  const float ra0 = u == 2 ? -1.0f : 1.0f, ra1 = (u == 0 || u == 3) ? -1.0f : 1.0f;
  const float rc0 = v == 2 ? -1.0f : 1.0f, rc1 = (v == 0 || v == 3) ? -1.0f : 1.0f;
  auto entry = [&](int a, int c) { return ((a >> 1) * Gx + (c >> 1)) * cs + sub + (a & 1) * 2 + (c & 1); };
  const int eo0 = entry(a0, c0), eo1 = entry(a0, c1), eo2 = entry(a1, c0), eo3 = entry(a1, c1);
  const float sg0 = ra0 * rc0, sg1 = ra0 * rc1, sg2 = ra1 * rc0, sg3 = ra1 * rc1;

  const int all = (T + K::BT - 1) / K::BT, nsp = SPLIT ? splits : 1;
  const int c_lo = (int)((long long)ks * all / nsp);
  const int n_chunks = (int)((long long)(ks + 1) * all / nsp) - c_lo;

  // one stage: the four entry planes [e][tile][n] of the chunk's windows
  // (a tile's copies by TPT threads, its cell found once), then its g rows
  auto stage = [&](float* raw, int chunk) {
    constexpr int TPT = K::kThreads / K::BT, SEG = K::BN / 4;
    static_assert(K::kThreads % K::BT == 0 && (4 * SEG) % TPT == 0, "whole tiles per thread group");
    const int t0 = chunk * K::BT, tl = threadIdx.x / TPT, t = t0 + tl;
    int base = 0;  // the tile's first window cell, in rows of N
    if (t < T) {
      const int b = t / tpi, r = t - b * tpi, jy = r / tx, jx = r - jy * tx;
      base = ((b * Gy + jy) * Gx + jx) * cs;
    }
#pragma unroll
    for (int k = 0; k < 4 * SEG / TPT; ++k) {
      const int i = threadIdx.x % TPT + k * TPT, e = i / SEG, seg = i % SEG, n = n0 + 4 * seg;
      const int eo = e == 0 ? eo0 : e == 1 ? eo1 : e == 2 ? eo2 : eo3;
      const bool ok = t < T && n < N;
      cp_async(raw + (e * K::BT + tl) * K::RS + 4 * seg, ok ? cells + (size_t)(base + eo) * N + n : cells, ok, 16);
    }
    stage_g<K>(raw + K::kRawA, g, t0, T, CONV ? 4 : 4 * S2, CONV ? 0 : 4 * s, M, m0);  // s2m2, srow
    cp_async_commit();
  };
  // the A pass: xw at q of channels (n, n+1), tiles (t, t+1) from the planes
  auto prep_a = [&](uint32_t* split, const float* raw) {
    for (int slot = threadIdx.x; slot < K::BT * K::BN / 4; slot += K::kThreads) {
      int n, t;
      a_slot<K>(slot, n, t);
      const float* r = raw + t * K::RS + n;
      float2 z[4][2];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        z[e][0] = *reinterpret_cast<const float2*>(r + e * K::BT * K::RS);
        z[e][1] = *reinterpret_cast<const float2*>(r + e * K::BT * K::RS + K::RS);
      }
      float x[2][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        x[h][0] = fmaf(sg3, z[3][h].x, fmaf(sg2, z[2][h].x, fmaf(sg1, z[1][h].x, sg0 * z[0][h].x)));
        x[h][1] = fmaf(sg3, z[3][h].y, fmaf(sg2, z[2][h].y, fmaf(sg1, z[1][h].y, sg0 * z[0][h].y)));
      }
      put_a<K>(split, slot, x[0][0], x[0][1], x[1][0], x[1][1]);
    }
  };
  Acc<K> acc;
  contract<K>(acc, smem, c_lo, n_chunks, iv, stage, prep_a);
  finish<K, SPLIT>(acc, dww, p, n0, m0, N, M, grp, ks, splits, partial, counters);
}

// The T split: the block count per (position, N tile, M tile) group that
// minimises the waves of blocks over the card's resident block slots times
// the work per block (1/k), with a 2% cost per extra split; at least 4 chunks
// a split.  Returns the split count.
inline int plan_splits(long long groups, long long chunks, long long slots) {
  int best = 1;
  double best_cost = (double)((groups + slots - 1) / slots);
  for (int k = 2; k <= 256 && chunks / k >= 4; ++k) {
    const double cost = (double)((groups * k + slots - 1) / slots) / k * (1.0 + 0.02 * (k - 1));
    if (cost < best_cost - 1e-9) best = k, best_cost = cost;
  }
  return best;
}

}  // namespace bwdw
