// The forward contraction of the fused engines, on Hopper's tensor cores at
// fp32 accuracy (3xTF32).  Used by engine1d.cu's 1D engine (replaces
// src/repro/kernels/engine.py::winograd_conv1d_fused_engine, both of its
// pallas_calls: scratch at engine.py:1690 and nlc at engine.py:1724), and by
// the two 2D forward kernels of engine.py::fused_engine (its pallas_calls at
// engine.py:739 and :817): fused_engine.cu's fused_epi_mma_kernel at the
// deconv corner and conv_engine.cu's conv_fwd_mma_kernel at the conv corner,
// which share the 2D A operand below (stage_windows, prep_windows).
// domain_engine.cu's forward computes the same contraction and fold.
// For a block of BT tiles t and BM output channels m it computes, for every
// packed position p,
//     dot_p[t, m] = sum_n xw[t, pos_p, n] * ww[p, n, m],
// folded through the inverse transform into the outputs of the group of
// positions that share them (at rank 1 a sub-filter s),
//     y[t, s, a, m] = sum over p in group s of inv[p, a] * dot_p[t, m],
// in registers; the kernel applies the epilogue and stores y.
//
// What bounded the fp32 CUDA-core design it replaces (10-13 TFLOP/s over
// the audio decoder): the products on the fp32 cores, fed by two float4
// shared loads per 16 FMAs; position groups bound to fixed positions (the
// decoder's 6 positions on 4 groups: 2/2/1/1); the products meeting in
// shared memory to fold, with two more barriers; and a block of 32 channels
// m, so that every cell window went through L2 and the B-transform once per
// 32 channels.  What this design does:
//   * products on the tensor cores: mma.sync m16n8k8 TF32 with each operand
//     split into hi = tf32(x) and lo = x - hi, lo*hi + hi*lo + hi*hi
//     (bwd_x_core.cuh's split_tf32 and mma_tf32).  A = xw (16 tiles x 8
//     channels n), B = ww (8 n x 8 m), D = products (tiles x m).  The
//     k-step's 8 channels are free in order: a lane's k = tq and tq + 4 are
//     channels 2tq and 2tq + 1 in both A and B.  The tensor cores add into
//     their accumulator with truncation, so each k-step's three products
//     start from zero and go into the outputs with rounded fp32 adds (as
//     in bwd_w_core.cuh);
//   * the fold at every k-step: a position's products are folded through
//     its inv row into its group's outputs (y[a] += inv[p, a] * products,
//     zeros of inv skipped) as they come off the tensor cores, so a thread
//     holds its outputs and one k-step's products, not an accumulator per
//     position.  That leaves the registers for large warp tiles (32 tiles x
//     16 or 32 channels m): each A and B fragment loaded from shared memory
//     feeds 4-8 mma, and a block spans 64 or 128 channels m, so the cell
//     windows go through L2 and the B-transform once per 128 channels.  (A
//     first design held every position's accumulators for a 16 x 16 warp
//     tile and folded at the end of a pass: 197 registers, 8 warps an SM,
//     and twice the time of this one on an H100; PERF.md);
//   * every warp on every position: the block's WT x WM warps split its BT x
//     BM outputs, so no warp idles where a sub-filter lacks a position.  A
//     pass is at most PMAX positions of at most SMAX fold groups, planned on
//     the host (repro_torch/kernels/engine.py::_fwd_passes); the passes'
//     chunks run in one sequence, so the pipeline never drains between them;
//   * operands split once: the kernel's B-transform (prep_a) writes xw's hi
//     and lo halves at the Winograd positions the pass reads only, in
//     fragment order, for all the block's channels m; the weights, read by
//     few warps each, are split where they are loaded;
//   * a pipeline of two stages, as bwd_w_core.cuh's: the raw A rows of chunk
//     c+2 and the weights of chunk c+1 (16-byte cp.async) arrive while chunk
//     c's products run and chunk c+1's A operand is formed, one barrier a
//     chunk (a chunk: one k-step of 8 channels n of one pass).
// Raw rows sit at strides of 4 or 8 mod 32 words and the split operands in
// fragment order, a lane's 8 or 16 bytes contiguous: the pipeline's shared
// accesses are free of bank conflicts without a swizzle.  16-byte copies
// need N % 4 == 0, M % 4 == 0 and 16-byte-aligned cells and ww (the Python
// wrapper refuses misaligned ones); few or ragged channels (the mono
// waveform M = 1) keep the fp32 CUDA-core kernel.
// What bounds it on an H100 (PERF.md): latency, at 15-23 TFLOP/s of the
// 3xTF32 rate's 165: one block of 8 or 16 warps an SM (the outputs), each
// chunk's B-transform, copies and products between barriers, and at the 2D
// corners the fold (4 outputs a tile: about 2.25 FMAs a product entry a
// k-step, against its 3 mma).  Its grid is 64 tiles a block: below one
// block an SM (the decoder at batch 1, the serving batches) the callers keep
// their CUDA-core kernels, or (the conv corner) split the passes over
// blocks.
// Its sums are fp32-accurate but not bitwise those of the plain versions
// (sequential fp32 FMAs over n): the outputs differ by a few 1e-6 of their
// spread, so an activation input within that of a kink (relu, leaky_relu)
// may take its other side (chip_smoke.py's train and audio checks hold the
// plain run to the kernel run's side of each kink and bound such flips).
// Shared memory: two stages of the split A operand (slots x BT x 8 x 2
// words), the raw A rows and the pass's weights (positions x 8 x (BM + 4)):
// ~64 KB for the audio decoder's deconv1 (6 positions on 3 Winograd
// positions), ~215 KB for a 2D pass of 9 positions on 64 x 128 blocks.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bwd_x_core.cuh"

namespace fwd {

using bwdx::cp_async;
using bwdx::cp_async_commit;
using bwdx::cp_async_wait;
using bwdx::mma_tf32;
using bwdx::split_tf32;

constexpr int kMaxQ = 16;  // Winograd positions a pass may read: the 1D engine's phases*n
constexpr int BN = 8;      // input channels n a chunk: one mma k-step

// The block's geometry: WT x WM warps, each FA 16-tile by FB 8-channel
// fragments; at most PMAX packed positions a pass (the shared memory of its
// operands); M2 outputs a tile and fold group (2 at rank 1), SMAX fold
// groups a pass (sub-filters at rank 1); MINB resident blocks an SM asked of
// the compiler (its register cap).
template <int WT_, int WM_, int FA_, int FB_, int PMAX_, int M2_, int SMAX_, int MINB_>
struct Core {
  static constexpr int WT = WT_, WM = WM_, FA = FA_, FB = FB_, PMAX = PMAX_, M2 = M2_, SMAX = SMAX_;
  static constexpr int kMinBlocks = MINB_;
  static constexpr int kThreads = 32 * WT * WM;
  static constexpr int BT = 16 * FA * WT;  // tiles a block
  static constexpr int BM = 8 * FB * WM;   // output channels a block
  static constexpr int WS = BM + 4;        // weight row stride in shared memory
  static_assert(WS % 8 == 4, "weight rows 4 mod 8 words: a warp's B loads hit 32 distinct banks");
  static constexpr int kY = SMAX * M2 * FA * FB * 4;  // outputs a thread holds
};

template <class K>
using Out = float[K::SMAX][K::M2][K::FA][K::FB][4];

// Shared memory of one launch, in floats: two stages, each the split A
// operand (hi, then lo: [slot][BT/16][lane][4]), the kernel's raw A rows
// (raw_a floats) and the weights ww[p, n0:n0+8, m0:m0+BM] of the pass's
// positions ([position][8][WS], split in registers where they are read).
// nslot / npos: the most Winograd / packed positions of any pass.
struct Layout {
  int a, raw_a, w, stage, floats;
  __host__ __device__ Layout(int BT, int BM, int nslot, int npos, int raw_a_floats) {
    a = nslot * 8 * BT;
    raw_a = (raw_a_floats + 3) / 4 * 4;
    w = npos * BN * (BM + 4);
    stage = 2 * a + raw_a + w;
    floats = 2 * stage;
  }
};

// The host's pass plan as the block reads it (engine.py::_fwd_passes), for
// npass passes of C packed positions:
//   pass_off (npass + 1)  packed-position offsets of the passes;
//   psub (npass x SMAX)   the fold groups (sub-filters) a pass touches, in
//                         order, -1 past the last;
//   isub (C)              each position's index among its pass's psub;
//   islot (C)             each position's Winograd-position slot in its pass;
//   qslot (npass x 16)    each pass's Winograd position -> slot, or -1.
struct Plan {
  const int *pass_off, *psub, *isub, *islot, *qslot;
  __host__ __device__ static int ints(int npass, int C, int smax) {
    return npass + 1 + npass * smax + 2 * C + kMaxQ * npass;
  }
};

// Copies the plan into shared memory at s (Plan::ints ints).
template <class K>
__device__ __forceinline__ Plan load_plan(int* s, const int* __restrict__ fplan, int npass, int C) {
  const int n = Plan::ints(npass, C, K::SMAX);
  for (int i = threadIdx.x; i < n; i += blockDim.x) s[i] = fplan[i];
  Plan p;
  p.pass_off = s;
  p.psub = p.pass_off + npass + 1;
  p.isub = p.psub + npass * K::SMAX;
  p.islot = p.isub + C;
  p.qslot = p.islot + C;
  return p;
}

// Stage the pass's weight slice ww[lo+i, n0:n0+8, m0:m0+BM] for its np
// positions into w[(i*8 + n)*WS + m]; rows past N and channels past M
// zero-filled.  16-byte copies (M % 4 == 0).
template <class K>
__device__ __forceinline__ void stage_w(float* w, const float* __restrict__ ww, int lo, int np, int n0, int m0,
                                        int N, int M) {
  constexpr int SEG = K::BM / 4;
  for (int e = threadIdx.x; e < np * BN * SEG; e += K::kThreads) {
    const int seg = e % SEG, n = (e / SEG) % BN, i = e / (SEG * BN);
    const int m = m0 + 4 * seg;
    const bool ok = n0 + n < N && m < M;
    cp_async(w + (i * BN + n) * K::WS + 4 * seg, ok ? ww + ((size_t)(lo + i) * N + n0 + n) * M + m : ww, ok, 16);
  }
}

// Write A entries of slot sl: tiles 16f + gq and 16f + gq + 8 (x0, x1) of
// channel 2tq + e, lane = 4gq + tq, split into hi and lo (a lane's four A
// values are a0..a3 in order: a0, a1 channel 2tq, a2, a3 channel 2tq + 1)
template <class K>
__device__ __forceinline__ void put_a(uint32_t* split, const Layout& L, int sl, int f, int lane, int e, float x0,
                                      float x1) {
  uint2 h, l;
  split_tf32(x0, h.x, l.x);
  split_tf32(x1, h.y, l.y);
  const int o = ((sl * (K::BT / 16) + f) * 32 + lane) * 4 + 2 * e;
  *reinterpret_cast<uint2*>(split + o) = h;
  *reinterpret_cast<uint2*>(split + L.a + o) = l;
}

// d = a * b with the accumulator starting at zero
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                              uint32_t b0, uint32_t b1) {
  d[0] = d[1] = d[2] = d[3] = 0.0f;
  mma_tf32(d, a0, a1, a2, a3, b0, b1);
}

// One k-step of a pass: for each of its np positions, this warp's FA A
// fragments (its slot's tiles, split) and FB B fragments (the weights, split
// here), the three terms (lo*hi, hi*lo, hi*hi) into registers that start at
// zero, then the fold of those products into the outputs of the position's
// fold group, y[k][a] += inv[p, a] * products, with fp32 FMAs (zeros of inv
// skipped).  iv: the pass's inv rows (np x M2).
template <class K>
__device__ __forceinline__ void mma_fold(Out<K>& y, const uint32_t* split, const float* w, const Layout& L,
                                         const int* islot, const int* isub, const float* iv, int np) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wt = warp / K::WM, wm = warp % K::WM, gq = lane >> 2, tq = lane & 3;
  for (int i = 0; i < np; ++i) {  // uniform over the block
    uint4 ah[K::FA], al[K::FA];
#pragma unroll
    for (int fa = 0; fa < K::FA; ++fa) {
      const int o = ((islot[i] * (K::BT / 16) + wt * K::FA + fa) * 32 + lane) * 4;
      ah[fa] = *reinterpret_cast<const uint4*>(split + o);
      al[fa] = *reinterpret_cast<const uint4*>(split + L.a + o);
    }
    uint32_t bh[K::FB][2], bl[K::FB][2];
#pragma unroll
    for (int fb = 0; fb < K::FB; ++fb) {
      const float* r = w + (i * BN + 2 * tq) * K::WS + (wm * K::FB + fb) * 8 + gq;
      split_tf32(r[0], bh[fb][0], bl[fb][0]);
      split_tf32(r[K::WS], bh[fb][1], bl[fb][1]);
    }
    float p[K::FA][K::FB][4];
#pragma unroll
    for (int fa = 0; fa < K::FA; ++fa)
#pragma unroll
      for (int fb = 0; fb < K::FB; ++fb)
        mma_tf32_zero(p[fa][fb], al[fa].x, al[fa].y, al[fa].z, al[fa].w, bh[fb][0], bh[fb][1]);
#pragma unroll
    for (int fa = 0; fa < K::FA; ++fa)
#pragma unroll
      for (int fb = 0; fb < K::FB; ++fb) mma_tf32(p[fa][fb], ah[fa].x, ah[fa].y, ah[fa].z, ah[fa].w, bl[fb][0], bl[fb][1]);
#pragma unroll
    for (int fa = 0; fa < K::FA; ++fa)
#pragma unroll
      for (int fb = 0; fb < K::FB; ++fb) mma_tf32(p[fa][fb], ah[fa].x, ah[fa].y, ah[fa].z, ah[fa].w, bh[fb][0], bh[fb][1]);
    const int ls = isub[i];
#pragma unroll
    for (int k = 0; k < K::SMAX; ++k) {
      if (ls != k) continue;
#pragma unroll
      for (int a = 0; a < K::M2; ++a) {
        const float c = iv[i * K::M2 + a];
        if (c == 0.0f) continue;
#pragma unroll
        for (int fa = 0; fa < K::FA; ++fa)
#pragma unroll
          for (int fb = 0; fb < K::FB; ++fb)
#pragma unroll
            for (int j = 0; j < 4; ++j) y[k][a][fa][fb][j] = fmaf(c, p[fa][fb][j], y[k][a][fa][fb][j]);
      }
    }
  }
}

template <class K>
__device__ __forceinline__ void zero(float (&y)[K::M2][K::FA][K::FB][4]) {
#pragma unroll
  for (int a = 0; a < K::M2; ++a)
#pragma unroll
    for (int fa = 0; fa < K::FA; ++fa)
#pragma unroll
      for (int fb = 0; fb < K::FB; ++fb)
#pragma unroll
        for (int j = 0; j < 4; ++j) y[a][fa][fb][j] = 0.0f;
}

// Where this thread's entry j of fragment (fa, fb) lands in the block: tile
// row (0 .. BT) and output channel (0 .. BM); entries j and j + 1 (j even)
// are channels m and m + 1 of one tile
template <class K>
__device__ __forceinline__ int out_tile(int fa, int j) {
  return ((threadIdx.x >> 5) / K::WM * K::FA + fa) * 16 + ((threadIdx.x & 31) >> 2) + 8 * (j >> 1);
}
template <class K>
__device__ __forceinline__ int out_m(int fb, int j) {
  return ((threadIdx.x >> 5) % K::WM * K::FB + fb) * 8 + 2 * (threadIdx.x & 3) + (j & 1);
}

// The reduction of a block over its npass passes: chunk c is k-step c % nck
// of pass c / nck, through a two-stage pipeline.  stage_a(raw, c)
// issues chunk c's copies of the kernel's A rows and prep_a(split, raw, c)
// writes every A slot of chunk c from them; pass_end(pass) follows a pass's
// last k-step (it may store and clear outputs).  inv_s: (C, M2) in shared
// memory.  Every thread of the block calls it; it ends on a barrier-free
// tail, so the kernel's epilogue may read only registers and the plan.
template <class K, class StageA, class PrepA, class PassEnd>
__device__ __forceinline__ void contract(Out<K>& y, float* smem, const Layout& L, const Plan& plan, int npass,
                                         int nck, const float* __restrict__ ww, int N, int M, int m0,
                                         const float* inv_s, StageA&& stage_a, PrepA&& prep_a, PassEnd&& pass_end) {
  const int n_chunks = npass * nck;
  if (n_chunks <= 0) return;
  auto split = [&](int b) { return reinterpret_cast<uint32_t*>(smem + b * L.stage); };
  auto raw_a = [&](int b) { return smem + b * L.stage + 2 * L.a; };
  auto wts = [&](int b) { return smem + b * L.stage + 2 * L.a + L.raw_a; };
  auto stage_w_of = [&](int c) {
    const int pass = c / nck, lo = plan.pass_off[pass];
    stage_w<K>(wts(c & 1), ww, lo, plan.pass_off[pass + 1] - lo, c % nck * BN, m0, N, M);
  };
  // chunk c: raw A rows in raw_a(c & 1) two chunks ahead, weights in wts(c & 1)
  // one chunk ahead, both waited for one iteration later
  stage_a(raw_a(0), 0);
  stage_w_of(0);
  cp_async_commit();
  if (n_chunks > 1) stage_a(raw_a(1), 1);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  prep_a(split(0), raw_a(0), 0);
  for (int c = 0; c < n_chunks; ++c) {
    const int b = c & 1, pass = c / nck, lo = plan.pass_off[pass];
    cp_async_wait<0>();
    __syncthreads();  // chunk c split, its weights in; raw_a(b) and wts(b ^ 1), split(b ^ 1) free
    if (c + 2 < n_chunks) stage_a(raw_a(b), c + 2);
    if (c + 1 < n_chunks) stage_w_of(c + 1);
    cp_async_commit();
    mma_fold<K>(y, split(b), wts(b), L, plan.islot + lo, plan.isub + lo, inv_s + lo * K::M2,
                plan.pass_off[pass + 1] - lo);
    if (c % nck == nck - 1) pass_end(pass);
    if (c + 1 < n_chunks) prep_a(split(b ^ 1), raw_a(b ^ 1), c + 1);
  }
}

// The passes [p0, npass) of a plan, as contract reads a plan of its own (a
// block that runs part of the passes: one sub-filter's, or a split's share);
// packed positions keep their indices.
__device__ __forceinline__ Plan from_pass(const Plan& p, int p0, int smax) {
  Plan q = p;
  q.pass_off += p0;
  q.psub += p0 * smax;
  q.qslot += p0 * kMaxQ;
  return q;
}

// ------------------------------------------------ the 2D engines' A operand
// At both 2D corners a tile's A rows are the 4x4 window of one input phase:
// cell rows jy, jy + 1 by cell columns jx, jx + 1 of the phase-major cells
// (B, Gy, Gx, phases*4, N), each cell a 2x2 block of pixels.  The raw rows of
// a chunk: every tile's 16 window entries of its 8 channels, kRT floats a
// tile (tiles 8 mod 32 words apart: prep_windows' loads hit 32 banks).
constexpr int kRT = 16 * BN + 8;

// tile_s[tl]: the first cell (b*Gy + jy)*Gx + jx of tile t0 + tl of the
// B*ty*tx flattened tiles, -1 past them
__device__ __forceinline__ void tile_cells(int* tile_s, int BT, int t0, int T, int ty, int tx, int Gy, int Gx) {
  for (int tl = threadIdx.x; tl < BT; tl += blockDim.x) {
    const int t = t0 + tl, b = t / (ty * tx), rm = t - b * ty * tx, jy = rm / tx, jx = rm - jy * tx;
    tile_s[tl] = t < T ? (b * Gy + jy) * Gx + jx : -1;
  }
}

// Chunk copies of the block's BT windows of phase s, channels n0 .. n0 + 8
// (16-byte copies: N % 4 == 0; tiles past T and channels past N zero-filled)
template <class K>
__device__ __forceinline__ void stage_windows(float* raw, const float* __restrict__ cells, const int* tile_s, int cs,
                                              int s, int n0, int N, int Gx) {
  for (int e = threadIdx.x; e < K::BT * 32; e += K::kThreads) {
    const int seg = e & 1, zi = (e >> 1) & 15, tl = e >> 5;
    const int base = tile_s[tl], n = n0 + 4 * seg, a = zi >> 2, c = zi & 3;
    const bool ok = base >= 0 && n < N;
    const size_t off =
        ok ? ((size_t)(base + (a >> 1) * Gx + (c >> 1)) * cs + s * 4 + (a & 1) * 2 + (c & 1)) * N + n : 0;
    cp_async(raw + tl * kRT + zi * BN + 4 * seg, cells + off, ok, 16);
  }
}

// B^T Z B for F(2,3), B^T = [[1,0,-1,0],[0,1,1,0],[0,-1,1,0],[0,1,0,-1]]:
// adds only.  z[a][c] in, x[u][v] out.
__device__ __forceinline__ void bt_z_b(const float (&z)[4][4], float (&x)[4][4]) {
  float r4[4][4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    r4[0][c] = z[0][c] - z[2][c];
    r4[1][c] = z[1][c] + z[2][c];
    r4[2][c] = z[2][c] - z[1][c];
    r4[3][c] = z[1][c] - z[3][c];
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    x[u][0] = r4[u][0] - r4[u][2];
    x[u][1] = r4[u][1] + r4[u][2];
    x[u][2] = r4[u][2] - r4[u][1];
    x[u][3] = r4[u][1] - r4[u][3];
  }
}

// B^T Z of a window, in place: z[a][c] in, (B^T Z)[u][c] out
__device__ __forceinline__ void bt_rows(float (&z)[4][4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float z0 = z[0][c], z1 = z[1][c], z2 = z[2][c], z3 = z[3][c];
    z[0][c] = z0 - z2;
    z[1][c] = z1 + z2;
    z[2][c] = z2 - z1;
    z[3][c] = z1 - z3;
  }
}
// entry v of a row of B^T Z times B
__device__ __forceinline__ float b_col(const float (&r)[4], int v) {
  return v == 0 ? r[0] - r[2] : v == 1 ? r[1] + r[2] : v == 2 ? r[2] - r[1] : r[1] - r[3];
}

// The A pass of a 2D chunk: xw = B^T Z B of tiles 16f + gq and + 8, channel
// 2tq + e, from the raw windows, into the slot of each Winograd position q
// the pass reads (qs: q -> slot or -1); B^T Z once a window, then each
// position's entry as it is written
template <class K>
__device__ __forceinline__ void prep_windows(uint32_t* split, const Layout& L, const float* raw, const int* qs) {
  for (int it = threadIdx.x; it < 4 * K::BT; it += K::kThreads) {
    const int e = it & 1, lane = (it >> 1) & 31, f = it >> 6;
    const float* r = raw + (16 * f + (lane >> 2)) * kRT + 2 * (lane & 3) + e;
    float z0[4][4], z1[4][4];
#pragma unroll
    for (int zi = 0; zi < 16; ++zi) {
      z0[zi >> 2][zi & 3] = r[zi * BN];
      z1[zi >> 2][zi & 3] = r[8 * kRT + zi * BN];
    }
    bt_rows(z0);
    bt_rows(z1);
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int sl = qs[q];
      if (sl >= 0) put_a<K>(split, L, sl, f, lane, e, b_col(z0[q >> 2], q & 3), b_col(z1[q >> 2], q & 3));
    }
  }
}

// The smem of a 2D kernel's launch, in bytes: the pipeline (nslot / npos:
// its pass plan's most Winograd / packed positions a pass), C rows of inv,
// the BT tiles' first cells and the plan
template <class K>
size_t smem_2d(int C, int npass, int nslot, int npos) {
  const Layout L(K::BT, K::BM, nslot, npos, K::BT * kRT);
  return sizeof(float) * (L.floats + C * K::M2) + sizeof(int) * (K::BT + Plan::ints(npass, C, K::SMAX));
}

}  // namespace fwd
