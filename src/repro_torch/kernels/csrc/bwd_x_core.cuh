// The per-Winograd-position contraction of the engines' input gradient, on
// Hopper's tensor cores at fp32 accuracy (3xTF32).  Shared by
//   * domain_engine.cu's bwd_x (replaces src/repro/kernels/engine.py::
//     domain_engine_bwd_x, the pallas_call at engine.py:995), 2D and rank 1;
//   * fused_engine_bwd.cu's bwd_x at the deconv corner and conv_engine.cu's
//     at the conv corner (replace engine.py::fused_engine_bwd_x, the
//     pallas_call at engine.py:1291, as the two corners instantiate it);
//     the two also share the gather below (CellBlock, dz_gather).
// For a block of BT tile slots and BN input channels n it accumulates, for
// every Winograd position q < NP,
//     dxw[t, q, n] = sum over the packed p with pos_p = q of
//                    sum_m gw[p, t, m] * ww[p, n, m],
//     gw[p, t, m]  = sum_a inv[p, a] * g[t, s(p)*M2 + a, m],
// in registers, and leaves the sums to the kernel's epilogue.
//
// What bounded the fp32 CUDA-core design it replaces (12-13 TFLOP/s, 17-20%
// of the fp32 peak): an M chunk of 8 (4) channels with two barriers and a
// gw fold per chunk, 4-byte weight copies transposed in shared memory, and
// position groups bound to fixed Winograd positions, idle wherever the
// chunk's sub-filter lacks their positions (49 of 64 slots busy at K5S2, 36
// at K4S2, 4 of 16 at rank 1).  What this design does:
//   * products on the tensor cores: mma.sync m16n8k8 TF32 with each operand
//     split into hi = tf32(x) and lo = x - hi, accumulating lo*hi + hi*lo +
//     hi*hi in fp32 registers (3xTF32: about fp32's accuracy; 1xTF32 would
//     keep 10 bits).  A = ww (16 channels n x 8 channels m: (C, N, M) has m
//     contiguous, the K-major layout A takes as it is), B = gw (8 m x 8
//     tiles), D = dxw (n x tiles);
//   * every warp busy every step: the loop runs over (sub-filter s, M
//     chunk), and each warp holds its positions' accumulators for the whole
//     loop, so every warp works on every chunk.  With one position set a
//     warp holds all NP positions; with two (2D), the warps split into two
//     sets of the 4x4 grid's checkerboard colours, which share DCGAN's K5S2
//     sub-filters' positions 8/8, 6/6, 6/6 and 5/4: the sets stay busy
//     alike, and a warp's accumulators for 8 positions cover twice the
//     tiles x channels, halving the operand work per product.  The K of
//     position q is the concatenation over the packed p with pos_p = q of
//     p's M channels, taken in sub-filter order, then m: a fixed order, no
//     atomics, two launches bitwise equal;
//   * gw is folded where B is loaded: each thread reads its tiles' M2 rows
//     of g once per 16 channels (16-byte loads) and forms every position's
//     fragment from them in registers (the inverse transform's row, an
//     fmaf chain), split into hi/lo as it is formed;
//   * M chunks of 32 channels, g rows and ww rows staged with 16-byte
//     cp.async in a 2-stage pipeline, ww kept in its (C, N, M) order; rows
//     XOR-swizzled in 16-byte segments so that every fragment load is free
//     of bank conflicts.  16-byte copies need M % 4 == 0 and 16-byte-aligned
//     g and ww (the Python wrappers refuse misaligned ones); few or ragged
//     channels (RGB M = 3, mono M = 1: a K of a few channels, bound by the
//     bytes of the output) keep each kernel's fp32 CUDA-core kernel.
// What bounds it now (on an H100; PERF.md): not the tensor cores, which
// these kernels use at a small share of their 3xTF32 rate, nor the staging,
// but the operand work of the positions a tile holds: every product needs
// its ww and gw fragments split in registers, and with the accumulators of
// 8-16 positions a thread only 8 warps fit an SM, too few to hide those
// chains.  A wgmma form (ww read by the tensor cores from shared memory, gw
// from registers) was right on the card but no faster: each position's
// products form one short dependent chain, and holding gw's registers until
// they complete costs a wait per position.
// Shared memory: 2 stages of BT*M2*32 + NP*BN*32 floats (192 KB for the 2D
// configuration, 128 KB at rank 1), within the 227 KB a block may have.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bwdx {

constexpr int kMaxPos = 16;  // n*n Winograd positions of F(2,3); the most xw rows
constexpr int kMaxSub = 16;  // S^2 sub-filters, S <= 4
constexpr int BM = 32;       // the M chunk

// global -> shared without passing through registers, 16 or 4 bytes; pred
// false zero-fills the destination without reading src.  The including
// sources' other kernels take these too.
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool pred, int bytes_vec) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes_vec == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(pred ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(pred ? 4 : 0));
  }
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// x = hi + lo: hi rounded to TF32 (half away from zero, by adding half a
// TF32 ulp to the bits and dropping the 13 low ones: two integer operations
// where cvt.rna.tf32 costs five with its NaN and overflow checks, which
// finite operands do not need), lo the exact remainder.  The tensor core
// reads a TF32 operand's top 19 bits, so lo goes in as it is.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 16-byte segment `seg` of shared-memory row `row`, swizzled: odd rows swap
// the two halves of each 128-byte line, so the 8 lanes of a 16-byte load
// phase (two rows, four segments each) hit 32 distinct banks
__device__ __forceinline__ int swz(int row, int seg) { return (seg ^ ((row & 1) << 2)) * 4; }

// The block's geometry.  NP: Winograd positions held (16 in 2D; n2 <= 4 at
// rank 1 in the narrow instantiation); M2: rows of g per tile and
// sub-filter (4 in 2D, 2 at rank 1); a warp owns FA 16-channel x FB 8-tile
// fragments of every position; WT warps side by side on the tile slots.
template <int NP_, int M2_, int FA_, int FB_, int WT_, int PS_ = 1>
struct Core {
  static constexpr int NP = NP_, M2 = M2_, FA = FA_, FB = FB_, WT = WT_, PS = PS_;
  static_assert(PS == 1 || (PS == 2 && NP == 16), "two position sets split the 4x4 grid as a checkerboard");
  static constexpr int kThreads = 32 * WT;
  static constexpr int NPS = NP / PS;      // positions a warp holds
  static constexpr int WS = WT / PS;       // warps of a position set, side by side on the tile slots
  static constexpr int BN = 16 * FA;       // input channels n per block
  static constexpr int BT = 8 * FB * WS;   // tile slots per block
  static constexpr int kG = BT * M2 * BM;  // g rows [slot][a][m], one stage
  static constexpr int kW = NP * BN * BM;  // ww rows [k][n][m] of one sub-filter, one stage
  static constexpr int kStage = kG + kW;
  static constexpr int kFloats = 2 * kStage;  // the pipeline; the epilogue may reuse it
  // resident blocks an SM that the registers allow: the accumulators and
  // about 96 more a thread, against the SM's 64K
  static constexpr int kMinBlocks = kThreads * (NPS * FA * FB * 4 + 96) <= 32768 ? 2 : 1;
};

template <class K>
using Acc = float[K::NPS][K::FA][K::FB][4];

// The Winograd position of this warp's accumulator set i: i itself, or
// with two position sets the i-th position of this warp's colour of the
// 4x4 grid's checkerboard (each colour holds 8, 6, 6 and 5 or 4 of the
// positions of DCGAN's K5S2 sub-filters: the two sets stay busy alike)
template <class K>
__device__ __forceinline__ int position(int i) {
  if constexpr (K::PS == 1) {
    return i;
  } else {
    const int set = (threadIdx.x >> 5) / K::WS, r = i >> 1;
    return 4 * r + 2 * (i & 1) + ((r + set) & 1);
  }
}

// One pipeline stage: the M2 rows of sub-filter s of g for every tile slot
// (tile_s[slot], -1 for an empty slot) and ww[lo+k, n0:n0+BN, m0:m0+32] for
// the sub-filter's cnt positions; ragged edges and empty slots zero-filled.
template <class K>
__device__ __forceinline__ void stage(float* sb, const float* __restrict__ g, const float* __restrict__ ww,
                                      const int* tile_s, int s, int lo, int cnt, int m0, int M, int N, int n0,
                                      int s2m2) {
  const int tid = threadIdx.x;
  constexpr int kGv = K::BT * K::M2 * (BM / 4);
  for (int e = tid; e < kGv; e += K::kThreads) {
    const int seg = e % (BM / 4), a = (e / (BM / 4)) % K::M2, slot = e / (BM / 4 * K::M2);
    const int t = tile_s[slot];
    const int m = m0 + seg * 4;
    const bool ok = t >= 0 && m < M;
    const float* src = ok ? g + ((size_t)t * s2m2 + s * K::M2 + a) * M + m : g;
    cp_async(sb + slot * (K::M2 * BM) + swz(slot, a * (BM / 4) + seg), src, ok, 16);
  }
  float* wd = sb + K::kG;
  const int nw = cnt * K::BN * (BM / 4);
  for (int e = tid; e < nw; e += K::kThreads) {
    const int seg = e % (BM / 4), nn = (e / (BM / 4)) % K::BN, k = e / (BM / 4 * K::BN);
    const int m = m0 + seg * 4;
    const bool ok = n0 + nn < N && m < M;
    const float* src = ok ? ww + ((size_t)(lo + k) * N + n0 + nn) * M + m : ww;
    cp_async(wd + (k * K::BN + nn) * BM + swz(nn, seg), src, ok, 16);
  }
  cp_async_commit();
}

// One position's operands for 16 channels m: A = ww rows n = 16fa + gq
// and + 8 (a[fa][half]), B = gw of tile column gq of each 8-tile fragment
// (b[fb]), the 4 channels m = 4tq .. 4tq+3 each, split hi/lo.  mma e of the
// pair takes m = 4tq + 2e (k = tq) and 4tq + 2e + 1 (k = tq + 4).
template <class K>
struct Operands {
  uint32_t ah[K::FA][2][4], al[K::FA][2][4], bh[K::FB][4], bl[K::FB][4];
};

template <class K>
__device__ __forceinline__ void load_operands(Operands<K>& o, const float4 (&gv)[K::FB][K::M2], const float* iv,
                                              const float* wk, int j, int gq, int tq) {
  // B: the fold of the tile's M2 rows of g through the position's inverse-transform row
  float ivr[K::M2];
  if constexpr (K::M2 == 4) {
    const float4 v = *reinterpret_cast<const float4*>(iv);
    ivr[0] = v.x, ivr[1] = v.y, ivr[2] = v.z, ivr[3] = v.w;
  } else {
#pragma unroll
    for (int a = 0; a < K::M2; ++a) ivr[a] = iv[a];
  }
#pragma unroll
  for (int fb = 0; fb < K::FB; ++fb) {
    float x[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int a = 0; a < K::M2; ++a) {
      x[0] = fmaf(ivr[a], gv[fb][a].x, x[0]);
      x[1] = fmaf(ivr[a], gv[fb][a].y, x[1]);
      x[2] = fmaf(ivr[a], gv[fb][a].z, x[2]);
      x[3] = fmaf(ivr[a], gv[fb][a].w, x[3]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(x[i], o.bh[fb][i], o.bl[fb][i]);
  }
#pragma unroll
  for (int fa = 0; fa < K::FA; ++fa)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = fa * 16 + gq + 8 * h;
      const float4 w = *reinterpret_cast<const float4*>(wk + r * BM + swz(r, 4 * j + tq));
      split_tf32(w.x, o.ah[fa][h][0], o.al[fa][h][0]);
      split_tf32(w.y, o.ah[fa][h][1], o.al[fa][h][1]);
      split_tf32(w.z, o.ah[fa][h][2], o.al[fa][h][2]);
      split_tf32(w.w, o.ah[fa][h][3], o.al[fa][h][3]);
    }
}

// term 0: lo(A) * hi(B), 1: hi(A) * lo(B), 2: hi(A) * hi(B): the small
// terms first, as fixed for every launch
template <class K>
__device__ __forceinline__ void mma_term(float (&acc_q)[K::FA][K::FB][4], const Operands<K>& o, int e, int term) {
#pragma unroll
  for (int fa = 0; fa < K::FA; ++fa)
#pragma unroll
    for (int fb = 0; fb < K::FB; ++fb) {
      const uint32_t(&a0)[4] = term == 0 ? o.al[fa][0] : o.ah[fa][0];
      const uint32_t(&a1)[4] = term == 0 ? o.al[fa][1] : o.ah[fa][1];
      const uint32_t(&b)[4] = term == 1 ? o.bl[fb] : o.bh[fb];
      mma_tf32(acc_q[fa][fb], a0[2 * e], a1[2 * e], a0[2 * e + 1], a1[2 * e + 1], b[2 * e], b[2 * e + 1]);
    }
}

// The products of one staged chunk of sub-filter s: for every position q
// of this warp's set that s holds (kmap[q] = its index k in s, else -1),
// acc += the chunk's 32 channels of ww[lo+k] x gw[lo+k].  inv_s: (C, M2).
template <class K>
__device__ __forceinline__ void chunk_products(Acc<K>& acc, const float* sb, const float* inv_s,
                                               const int* kmap, int lo) {
  const int lane = threadIdx.x & 31, wl = (threadIdx.x >> 5) % K::WS;
  const int gq = lane >> 2, tq = lane & 3;
  const float* gb = sb;
  const float* wb = sb + K::kG;
#pragma unroll
  for (int j = 0; j < BM / 16; ++j) {
    // this thread's 4 channels m = 16j + 4tq .. +3 of its FB tiles' g rows
    float4 gv[K::FB][K::M2];
#pragma unroll
    for (int fb = 0; fb < K::FB; ++fb) {
      const int slot = wl * 8 * K::FB + fb * 8 + gq;
#pragma unroll
      for (int a = 0; a < K::M2; ++a)
        gv[fb][a] = *reinterpret_cast<const float4*>(gb + slot * (K::M2 * BM) + swz(slot, a * (BM / 4) + 4 * j + tq));
    }
#pragma unroll
    for (int i = 0; i < K::NPS; ++i) {
      const int k = kmap[position<K>(i)];
      if (k < 0) continue;  // uniform over the warp
      Operands<K> o;
      load_operands<K>(o, gv, inv_s + (lo + k) * K::M2, wb + k * K::BN * BM, j, gq, tq);
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int term = 0; term < 3; ++term) mma_term<K>(acc[i], o, e, term);
    }
  }
}

// The whole reduction for the block's tile slots (tile_s) and channels
// [n0, n0 + BN): every sub-filter's M chunks in order through the 2-stage
// pipeline.  off_s: (S2 + 1) sub-filter offsets; kmap_s: [S2][16] position
// -> index in its sub-filter or -1; all in shared memory and visible to the
// block on entry.  acc holds the sums on return; the pipeline's shared
// memory is free for the epilogue after a __syncthreads().
template <class K>
__device__ __forceinline__ void contract(Acc<K>& acc, float* smem, const float* __restrict__ g,
                                         const float* __restrict__ ww, const int* tile_s, const float* inv_s,
                                         const int* kmap_s, const int* off_s, int S2, int M, int N, int n0) {
#pragma unroll
  for (int q = 0; q < K::NPS; ++q)
#pragma unroll
    for (int fa = 0; fa < K::FA; ++fa)
#pragma unroll
      for (int fb = 0; fb < K::FB; ++fb)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[q][fa][fb][i] = 0.0f;

  const int mchunks = (M + BM - 1) / BM;
  const int nchunks = S2 * mchunks;
  const int s2m2 = S2 * K::M2;
  auto issue = [&](int buf, int c) {
    const int s = c / mchunks;
    stage<K>(smem + buf * K::kStage, g, ww, tile_s, s, off_s[s], off_s[s + 1] - off_s[s], (c % mchunks) * BM,
             M, N, n0, s2m2);
  };
  if (nchunks > 0) issue(0, 0);
  if (nchunks > 1) issue(1, 1);
  for (int c = 0; c < nchunks; ++c) {
    const int buf = c & 1;
    const int s = c / mchunks;
    if (c + 1 < nchunks) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();
    chunk_products<K>(acc, smem + buf * K::kStage, inv_s, kmap_s + s * kMaxPos, off_s[s]);
    __syncthreads();
    if (c + 2 < nchunks) issue(buf, c + 2);
  }
}

// Where accumulator i of fragment (fa, fb) lands: channel n (within the
// block) and tile slot
__device__ __forceinline__ int acc_n(int fa, int i) { return fa * 16 + ((threadIdx.x & 31) >> 2) + (i >> 1) * 8; }
template <class K>
__device__ __forceinline__ int acc_slot(int fb, int i) {
  return (threadIdx.x >> 5) % K::WS * 8 * K::FB + fb * 8 + 2 * (threadIdx.x & 3) + (i & 1);
}

// The layout tables contract() reads, filled by the whole block: inv (C,
// M2), sub-filter offsets, and kmap [S2][16] (position -> index or -1).
// Ends with a __syncthreads().
template <int M2>
__device__ __forceinline__ void load_layout(float* inv_s, int* kmap_s, int* off_s, int* pos_s,
                                            const float* __restrict__ inv, const int* __restrict__ pos,
                                            const int* __restrict__ sub_off, int S2) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int C = sub_off[S2];
  for (int i = tid; i < C * M2; i += nt) inv_s[i] = inv[i];
  for (int i = tid; i < C; i += nt) pos_s[i] = pos[i];
  for (int i = tid; i <= S2; i += nt) off_s[i] = sub_off[i];
  for (int i = tid; i < kMaxSub * kMaxPos; i += nt) kmap_s[i] = -1;
  __syncthreads();
  for (int s = tid; s < S2; s += nt)
    for (int k = 0; k < off_s[s + 1] - off_s[s]; ++k) kmap_s[s * kMaxPos + pos_s[off_s[s] + k]] = k;
  __syncthreads();
}

// ---------------------------------------------------------------- the gather
// The fused engines' bwd_x (kernel 6, at both corners) gathers instead of
// scattering: a block owns R output cell rows (rows of all B images end to
// end) by W cell columns and computes dXw for every tile those cells read,
// the one tile row above its first cell row included (the halo, computed
// again by the block above); then each cell sums its pieces in a fixed
// order.  No atomics, no scratch, no dependence on block order.

// The cells of one block and the tile slots they read: R cell rows [rho0,
// rho1) by columns [c0, c1); cell row r takes tile rows r-1 and r, so the
// slots hold tile rows (tau = b*ty + j, contiguous) [tau_lo, tau_hi] by
// columns [tc0, tc1], TC columns a slot row.
struct CellBlock {
  int rho0, rho1, c0, c1, tau_lo, tau_hi, tc0, tc1;
  __device__ CellBlock(int rb, int cb, int B, int gy, int gx, int ty, int tx, int R, int W) {
    rho0 = rb * R;
    c0 = cb * W;
    rho1 = min(rho0 + R, B * gy);
    c1 = min(c0 + W, gx);
    tau_lo = 0x7fffffff;
    tau_hi = -1;
    for (int rho = rho0; rho < rho1; ++rho) {
      const int b = rho / gy, r = rho - b * gy;
      const int jlo = max(r - 1, 0), jhi = min(r, ty - 1);
      if (jlo <= jhi) {
        tau_lo = min(tau_lo, b * ty + jlo);
        tau_hi = max(tau_hi, b * ty + jhi);
      }
    }
    if (tau_hi < 0) tau_lo = 0;  // no tile: every slot stays empty
    tc0 = max(c0 - 1, 0);
    tc1 = min(c1 - 1, tx - 1);
  }
  // flat tile index of slot tl, -1 if none
  __device__ int tile(int tl, int TC, int tx) const {
    const int tau = tau_lo + tl / TC, col = tc0 + tl % TC;
    return (tau <= tau_hi && col <= tc1) ? tau * tx + col : -1;
  }
};

// dZ = B dXw B^T in place for every (slot, channel) of red (16 positions,
// position p at red[p * PS]), then the gather: every cell of the block sums
// the dZ pieces of the tiles that read it, in the fixed order (dy, dx) =
// (0,0), (0,1), (1,0), (1,1), into its channel slots [sub, sub + 4) of cs.
// red's element (slot, channel nn) sits at slot * SS + nn.
template <int BT, int BN, int NT, int PS, int SS>
__device__ __forceinline__ void dz_gather(float* red, const CellBlock& cb, float* __restrict__ dcells, int gy, int gx,
                                          int ty, int tx, int N, int n0, int TC, int cs, int sub) {
  const int tid = threadIdx.x;
  for (int it = tid; it < BT * BN; it += NT) {
    float* e = red + (it / BN) * SS + it % BN;
    float d[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) d[u][v] = e[(u * 4 + v) * PS];
    // rows: (B X)[a] = sum_u BT[u][a] X[u], B^T = [[1,0,-1,0],[0,1,1,0],[0,-1,1,0],[0,1,0,-1]]
    float y[4][4];
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      y[0][v] = d[0][v];
      y[1][v] = d[1][v] - d[2][v] + d[3][v];
      y[2][v] = d[1][v] + d[2][v] - d[0][v];
      y[3][v] = -d[3][v];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float* dst = e + (a * 4) * PS;
      dst[0 * PS] = y[a][0];
      dst[1 * PS] = y[a][1] - y[a][2] + y[a][3];
      dst[2 * PS] = y[a][1] + y[a][2] - y[a][0];
      dst[3 * PS] = -y[a][3];
    }
  }
  __syncthreads();

  const int wc = cb.c1 - cb.c0;
  const int items = (cb.rho1 - cb.rho0) * wc * 4 * BN;
  for (int it = tid; it < items; it += NT) {
    const int nn = it % BN, a = (it / BN) % 4, cell = it / (4 * BN);
    const int rho = cb.rho0 + cell / wc, col = cb.c0 + cell % wc;
    const int b = rho / gy, r = rho - b * gy;
    const int pp = a / 2, qq = a % 2;
    float v = 0.0f;
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const int j = r - dy;
      if (j < 0 || j >= ty) continue;
      const int tr = b * ty + j - cb.tau_lo;
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const int tcol = col - dx;
        if (tcol < 0 || tcol >= tx) continue;
        const int slot = tr * TC + tcol - cb.tc0;
        v += red[((2 * dy + pp) * 4 + 2 * dx + qq) * PS + slot * SS + nn];
      }
    }
    if (n0 + nn < N) dcells[(((size_t)rho * gx + col) * cs + sub + a) * N + n0 + nn] = v;
  }
}

// The gather's block geometry for BT tile slots (host code): W is all gx
// columns when two tile rows of tx tiles fit the slots, else one cell row
// and BT/2 - 1 columns; TC tile columns a slot row; R the largest count of
// cell rows whose every block reads at most BT/TC tile rows.
inline void cell_geometry(int B, int gy, int gx, int ty, int tx, int BT, int* R, int* W, int* TC) {
  int w, tc;
  if (2 * tx <= BT) {
    w = gx;
    tc = tx;
  } else {
    w = BT / 2 - 1;
    tc = w + 1;
  }
  const int tr_max = BT / tc;
  const int rows = B * gy;
  int best = 1;
  for (int r = tr_max * gy; r >= 1; --r) {
    bool ok = true;
    for (int rho0 = 0; rho0 < rows && ok; rho0 += r) {
      int lo = 0x7fffffff, hi = -1;
      for (int rho = rho0; rho < rho0 + r && rho < rows; ++rho) {
        const int b = rho / gy, rr = rho - b * gy;
        const int jlo = rr - 1 > 0 ? rr - 1 : 0, jhi = rr < ty - 1 ? rr : ty - 1;
        if (jlo <= jhi) {
          lo = lo < b * ty + jlo ? lo : b * ty + jlo;
          hi = hi > b * ty + jhi ? hi : b * ty + jhi;
        }
      }
      ok = hi < lo || hi - lo + 1 <= tr_max;
    }
    if (ok) {
      best = r;
      break;
    }
  }
  *R = best;
  *W = w;
  *TC = tc;
}

}  // namespace bwdx
