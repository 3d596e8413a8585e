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
// DCGAN's first three layers (all three on the tensor cores in 3xTF32, 165
// TFLOP/s: fwd where its grid fills the card, below; latency holds bwd_x at
// about a sixth, bwd_x_core.cuh, and bwd_w at about a fifth, bwd_w_core.cuh);
// at the RGB layer (M = 3) the bytes of xw (fwd, bwd_w) and of dxw (bwd_x),
// 16*T*N floats each, 303 MB at batch 128.
//
// What the designs do about it (they are fused_engine.cu's and
// fused_engine_bwd.cu's with the pre-PE taken out; the TPU's 128-lane
// padding of N and M and its (C, T_t, M_t) scratch of accumulators are not
// carried over):
//   * fwd, three instantiations, chosen by domain_engine_fwd_plan from the
//     shape and the card:
//     - the tensor cores (domain_fwd_mma_kernel, where M % 4 == 0, M >= 16
//       and its 128-tile x 64-channel blocks fill the SMs: DCGAN's deconv0-2
//       at batch 128): a position-outer grouped GEMM on wgmma, its operands
//       by TMA, B packed K-major in TF32 halves by domain_fwd_pack_kernel;
//       each packed position's whole N loop runs into one accumulator, in
//       chains of k-steps folded into the 4 outputs (see its section);
//     - few channels (domain_fwd_few_kernel, M < 16 or M % 4 != 0, where its
//       grid fills the SMs: the RGB layer at batch 128): bytes-bound, each xw
//       row read from device memory once for every packed position that uses
//       it (see its section);
//     - the fp32 CUDA-core kernel (domain_fwd_kernel) elsewhere, as the
//       serving batches: one block per (T-tile, sub-filter, M-tile).  Its 8
//       position groups each keep, in registers for the whole N loop, the
//       products of 2 of the sub-filter's <= 16 positions for a 4-tile x
//       4-channel micro tile.  Only the sub-filter's positions of xw are
//       staged, by a two-stage cp.async pipeline with the weight slice; a
//       thread's 4 tiles are NT_T rows apart so that 8 threads reading 4
//       channels of 8 tiles hit 8 distinct bank groups.  After the N loop the
//       products meet in shared memory and fold through inv (0 or +-1: a
//       signed add per nonzero) into the tile's 4 outputs.  Where the grid
//       would underfill the card (few tiles, as DCGAN's first layer at small
//       batch) the N loop splits over blocks, and the last block to arrive
//       sums the partial products in split order, as fused_engine.cu does:
//       the result does not depend on the order blocks run in.
//     An empty sub-filter (K_D < S) writes zeros in all three;
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
// One gw pass shared by both backward kernels is later work.

#include <cuda.h>  // CUtensorMap and its enums only: the tensor-map encoder comes through the runtime
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

// ============================================================== fwd, tensor cores
// The redesigned forward for the layers whose tiles fill the card (DCGAN's
// deconv0-2 at batch 128): a position-outer grouped GEMM on wgmma with TMA.
// A block owns 128 tiles x 64 channels m of one sub-filter s and walks its
// packed positions p one after the other; for each it runs the whole K = N
// loop of xw[t, pos_p, :] (128 x N) @ ww[p] (N x 64) and then folds the
// products into the tile's 4 outputs through inv[p, :] (0 or +-1: a signed
// add per nonzero), so the fold runs once per chain of k-steps, not once per
// k-step as in fwd_core.cuh.
//   * warps: two consumer warpgroups (warps 0-7; each owns 64 tiles, a
//     wgmma m64n64 tile) and a producer warpgroup (warps 8-11) whose first
//     lane keeps the TMA loads of a ring of ST stages in flight.  The
//     consumers hold 4 output accumulators, one chain accumulator and a
//     stage's split A fragments (~200 registers): setmaxnreg moves the
//     producer's registers to them (40 / 232 of the 168 a thread that 12
//     warps leave; each SM quarter's register file holds 3 warps of the
//     block, so a 9-warp block is held to 168 and spilled);
//   * a stage is 32 channels n (one 128-byte swizzle row): A = the 128
//     tiles' rows of xw at the position (TMA over (N, 16, T), box
//     (32, 1, 128)), B = the hi and lo halves of ww[p] as (M, N) rows
//     (K-major, which a TF32 wgmma needs: PTX allows it no transpose), from
//     the pack kernel below (TMA over (N, M, 2C), box (32, 64, 1)); both in
//     the 128-byte swizzle;
//   * 3xTF32 as the other cores (bwd_x_core.cuh's split_tf32): A is read
//     from shared memory into the wgmma A fragment registers and split
//     there, B's halves come split; lo*hi + hi*lo + hi*hi per k-step of 8;
//   * the tensor cores' adds truncate: a chain of kFwdChain stages
//     accumulates in the wgmma accumulator (the first k-step of a chain
//     starts it from zero), then goes into the outputs with rounded fp32
//     adds.  kFwdChain comes from a chip measurement of the error share
//     against time (PERF.md);
//   * the grid is (sub-filter, M tile, T tile) with the sub-filters in
//     order of their packed positions, heaviest first (K5S2: 16, 12, 12, 9),
//     so that the card's block scheduler hands the light blocks out last
//     and the last wave idles least.  No split: every output is one block's,
//     summed in one order (two launches agree bit for bit).
// What bounds it: the products in 3xTF32 (165 TFLOP/s), and the operands'
// traffic from L2: a 128 x 64 block reads 32 KB a stage for 128*64*32
// products (a 128 x 128 block would not hold its 4 output accumulators).
// At DCGAN's deconv0-2 on an H100 it reaches about two fifths of that
// rate, the weight pack included (PERF.md §6 names the runs), where one
// wgmma wait a stage per warpgroup also stands between the stages.
namespace tcf {
constexpr int BT = 128;               // tiles a block: two consumer warpgroups of 64
constexpr int BM = 64;                // output channels m a block: wgmma n
constexpr int BK = 32;                // channels n a stage: one 128-byte swizzle row
constexpr int ST = 6;                 // stages in the ring
constexpr int kThreads = 3 * 128;     // 2 consumer warpgroups, 1 producer warpgroup
constexpr int kA = BT * BK * 4;       // bytes of a stage's A tile
constexpr int kB = BM * BK * 4;       // bytes of each B half
constexpr int kStage = kA + 2 * kB;   // 32 KB
constexpr size_t kSmemBytes = 1024 + (size_t)ST * kStage + 2 * ST * sizeof(uint64_t);
// the chain: stages that add in the wgmma accumulator before their sum goes
// into the outputs in fp32.  Measured on an H100 at DCGAN's deconv0-2 by
// tools/fwd_chain_probe.py (PERF.md): chains of 1-4 stages hold the error
// share at 0.009-0.015 of the tolerance (1 and 2 cost 1.9x and 1.2x the
// time of 4), 8 at 0.022 (6% faster than 4), a whole position at up to
// 0.073.  4 keeps the error at the floor of the shorter chains; the
// per-layer train check's step-2 metrics cannot tell chains 1-8 apart
// (each misses it on at most one seed of eight, as the CUDA-core kernel does)
constexpr int kFwdChain = 4;

__device__ __forceinline__ uint32_t smem_u32(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// spins on the barrier's phase; a wait that outlasts ~2^34 cycles (seconds:
// an arrival or a copy that never came) traps, so that the launch fails
// instead of holding the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  const long long start = clock64();
  do {
    if (clock64() - start > (1LL << 34)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// one box of a 3-D tensor map into shared memory; completes on `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// shared-memory matrix descriptor of a K-major operand in the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (SBO); LBO is
// not read for this layout.  A k-step of 8 TF32 values is 32 bytes along
// the row: +2 in the address field.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
// keep the compiler from moving reads of the accumulator above the wait
__device__ __forceinline__ void reg_fence(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A (64 x 8, TF32 fragments in registers) * B (8 x 64, K-major in
// shared memory); scale_d 0 starts d from zero
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// word offset of A's (row r, column c) in a stage's 128-byte-swizzled tile:
// 16-byte chunk c/4 of row r sits at chunk (c/4) ^ (r % 8)
__device__ __forceinline__ int a_off(int r, int c) { return r * BK + ((((c >> 2) ^ (r & 7)) << 2) | (c & 3)); }

// the sub-filter of grid rank `rank`: sub-filters by packed positions,
// most first, ties in index order
__device__ __forceinline__ int sub_of_rank(const int* __restrict__ sub_off, int S2, int rank) {
  int s = 0;
  for (int u = 0; u < S2; ++u) {
    const int cu = sub_off[u + 1] - sub_off[u];
    int r = 0;
    for (int v = 0; v < S2; ++v) {
      const int cv = sub_off[v + 1] - sub_off[v];
      r += cv > cu || (cv == cu && v < u);
    }
    if (r == rank) s = u;
  }
  return s;
}
}  // namespace tcf

// ww (C, N, M) -> wp (2, C, M, N): the hi and lo TF32 halves of the
// weights, K-major for the tensor-core forward's B operand.  Part of TPU
// kernel 1's port (its launches count with the forward's).
__global__ void __launch_bounds__(256) domain_fwd_pack_kernel(const float* __restrict__ ww, float* __restrict__ wp,
                                                              int C, int N, int M) {
  __shared__ float tile[32][33];
  const int p = blockIdx.z, n0 = blockIdx.x * 32, m0 = blockIdx.y * 32;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int n = n0 + i, m = m0 + threadIdx.x;
    tile[i][threadIdx.x] = n < N && m < M ? ww[((size_t)p * N + n) * M + m] : 0.0f;
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int m = m0 + i, n = n0 + threadIdx.x;
    if (m < M && n < N) {
      uint32_t hi, lo;
      bwdx::split_tf32(tile[threadIdx.x][i], hi, lo);
      wp[((size_t)p * M + m) * N + n] = __uint_as_float(hi);
      wp[(((size_t)C + p) * M + m) * N + n] = __uint_as_float(lo);
    }
  }
}

__global__ void __launch_bounds__(tcf::kThreads, 1)
domain_fwd_mma_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                      const float* __restrict__ inv, const int* __restrict__ pos, const int* __restrict__ sub_off,
                      float* __restrict__ out, int T, int N, int M, int S2, int C) {
  using namespace tcf;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzled tiles need 1024-byte alignment
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + ST * kStage);
  uint64_t* empty = full + ST;

  const int n_tb = (T + BT - 1) / BT, n_mb = (M + BM - 1) / BM;
  const int rank = blockIdx.x / (n_tb * n_mb), rem = blockIdx.x % (n_tb * n_mb);
  const int s = sub_of_rank(sub_off, S2, rank);
  const int t0 = (rem % n_tb) * BT, m0 = (rem / n_tb) * BM;
  const int lo = sub_off[s], cnt = sub_off[s + 1] - lo;
  const int nst = (N + BK - 1) / BK;  // stages a position
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(smem_u32(full + i), 1);
      mbar_init(smem_u32(empty + i), 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {  // the producer warpgroup: its registers go to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 8 && lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int k = 0; k < cnt; ++k) {
        const int p = lo + k, q = pos[p];
        for (int c = 0; c < nst; ++c) {
          mbar_wait(smem_u32(empty + stage), phase ^ 1u);
          const uint32_t fb = smem_u32(full + stage), sa = base + stage * kStage;
          mbar_expect_tx(fb, kStage);
          tma_load_3d(sa, &xmap, fb, c * BK, q, t0);
          tma_load_3d(sa + kA, &wmap, fb, c * BK, m0, p);
          tma_load_3d(sa + kA + kB, &wmap, fb, c * BK, m0, C + p);
          if (++stage == ST) stage = 0, phase ^= 1u;
        }
      }
    }
    return;
  }

  // a consumer warpgroup: rows wg*64 + (warp%4)*16 + lane/4 (+8) of the
  // block's 128 tiles, as the wgmma fragments lay them out
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int r0 = (warp >> 2) * 64 + (warp & 3) * 16 + (lane >> 2), cq = lane & 3;
  float y[4][32], acc[32];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) y[a][i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;

  int stage = 0;
  uint32_t phase = 0;
  for (int k = 0; k < cnt; ++k) {
    const float iv[4] = {inv[(lo + k) * 4], inv[(lo + k) * 4 + 1], inv[(lo + k) * 4 + 2], inv[(lo + k) * 4 + 3]};
    for (int c = 0; c < nst; ++c) {
      mbar_wait(smem_u32(full + stage), phase);
      const float* a_s = reinterpret_cast<const float*>(smem + stage * kStage);
      uint32_t ah[4][4], al[4][4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const int col = ks * 8 + cq;
        const float x[4] = {a_s[a_off(r0, col)], a_s[a_off(r0 + 8, col)], a_s[a_off(r0, col + 4)],
                            a_s[a_off(r0 + 8, col + 4)]};
#pragma unroll
        for (int j = 0; j < 4; ++j) bwdx::split_tf32(x[j], ah[ks][j], al[ks][j]);
      }
      const uint64_t dh = desc_sw128(base + stage * kStage + kA), dl = desc_sw128(base + stage * kStage + kA + kB);
      const int fresh = c % kFwdChain == 0;  // a chain's first k-step starts the accumulator from zero
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        wgmma_tf32(acc, al[ks], dh + 2 * ks, !(fresh && ks == 0));
        wgmma_tf32(acc, ah[ks], dl + 2 * ks, 1);
        wgmma_tf32(acc, ah[ks], dh + 2 * ks, 1);
      }
      wg_commit();
      wg_wait0();
      reg_fence(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_u32(empty + stage));
      if (++stage == ST) stage = 0, phase ^= 1u;
      if ((c + 1) % kFwdChain == 0 || c + 1 == nst) {  // the chain's end: fold into the outputs
#pragma unroll
        for (int a = 0; a < 4; ++a)
          if (iv[a] != 0.0f) {
#pragma unroll
            for (int i = 0; i < 32; ++i) y[a][i] = fmaf(iv[a], acc[i], y[a][i]);
          }
      }
    }
  }

  // out[t, s*4 + a, m]: element i of the fragment is row r0 + 8*((i/2)%2),
  // column 8*(i/4) + 2*cq + i%2
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int t = t0 + r0 + 8 * ((i >> 1) & 1), m = m0 + 8 * (i >> 2) + 2 * cq;
    if (t < T && m < M) {
#pragma unroll
      for (int a = 0; a < 4; ++a)
        *reinterpret_cast<float2*>(out + ((size_t)t * S2 * 4 + s * 4 + a) * M + m) = make_float2(y[a][i], y[a][i + 1]);
    }
  }
}

// ============================================================== fwd, few channels
// The bytes-bound forward for few or ragged channels (DCGAN's RGB layer, M
// = 3; M < 16 or M % 4 != 0) where its grid fills the card.  Its bound is
// the bytes of xw (16*T*N floats, 303 MB at deconv3, batch 128): the block
// stages each xw row from device memory once, for all S^2 sub-filters and
// every packed position that reads it (the CUDA-core kernel above stages a
// sub-filter's positions per block: 49 of 16 rows at K5S2).  A block: BT
// tiles x 4 channels m (blockIdx.y the channel chunk), kThreads threads;
// thread items (tile, sub-filter), the sub-filter uniform per warp, IT =
// BT*S^2/kThreads items in turn (one where S^2 <= 4).  xw moves in chunks of
// BN channels n through a ring of ST cp.async stages, a tile's 16 rows at a
// tile stride of 4 mod 32 words (a warp's 32 tiles read one float4 each
// without bank conflicts), with the chunk's weights of every position as
// [p][n][4 m] (one broadcast float4 a (position, n)).  A thread keeps each
// of its sub-filter's positions' dot products in registers for the whole N
// loop (the position loop unrolled, its offsets in registers, so the loads
// of one position overlap the FMAs of the last) and folds them through inv
// once at the end.  Sums are fp32, in another order than the plain version's.
// What holds it above its bound on an H100 (PERF.md): the copies alone take
// ~1.8x the bytes' time (16-byte cp.async of 64-byte row pieces at one block
// an SM), the arithmetic alone ~1.6x (shared loads: a warp's float4 of xw is
// four wavefronts, at 8 warps an SM), and they overlap only in part; xw by
// TMA with two tiles a thread measured slower.
namespace fcf {
constexpr int BT = 64;                  // tiles a block
constexpr int MC = 4;                   // output channels a block
constexpr int BN = 16;                  // channels n a chunk
constexpr int ST = 2;                   // chunks in the cp.async ring
constexpr int kThreads = 256;
constexpr int TS = kMaxPos * BN + 4;    // tile stride in words: 4 mod 32
constexpr int kX = BT * TS;             // one stage of xw
__host__ __device__ constexpr size_t smem_bytes(int C) {
  return sizeof(float) * (ST * (size_t)kX + ST * (size_t)C * BN * MC + (size_t)C * 4) +
         sizeof(int) * ((size_t)C + kMaxSub + 1);
}
}  // namespace fcf

__global__ void __launch_bounds__(fcf::kThreads)
domain_fwd_few_kernel(const float* __restrict__ xw, const float* __restrict__ ww, const float* __restrict__ inv,
                      const int* __restrict__ pos, const int* __restrict__ sub_off, float* __restrict__ out, int T,
                      int N, int M, int S2, int C) {
  using namespace fcf;
  extern __shared__ float4 smem4[];
  float* x_s = reinterpret_cast<float*>(smem4);  // ST x [BT][16][BN] at tile stride TS
  float* w_s = x_s + ST * kX;                    // ST x [C][BN][MC]
  float* inv_s = w_s + ST * C * BN * MC;         // [C][4]
  int* pos_s = reinterpret_cast<int*>(inv_s + C * 4);
  int* off_s = pos_s + C;
  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * BT, m0 = blockIdx.y * MC;
  for (int e = tid; e < C * 4; e += kThreads) inv_s[e] = inv[e];
  for (int e = tid; e < C; e += kThreads) pos_s[e] = pos[e];
  for (int e = tid; e <= S2; e += kThreads) off_s[e] = sub_off[e];
  __syncthreads();

  // one chunk of xw (every tile's 16 rows) and of the weights (every
  // position) into stage buf; ragged edges zero-filled
  auto stage = [&](int buf, int n0) {
    float* xd = x_s + buf * kX;
    for (int e = tid; e < BT * kMaxPos * (BN / 4); e += kThreads) {
      const int nl = (e % (BN / 4)) * 4, q = (e / (BN / 4)) % kMaxPos, tl = e / (BN / 4 * kMaxPos);
      const int t = t0 + tl, n = n0 + nl;
      const bool ok = t < T && n < N;
      cp_async(xd + tl * TS + q * BN + nl, ok ? xw + ((size_t)t * kMaxPos + q) * N + n : xw, ok, 16);
    }
    float* wd = w_s + buf * C * BN * MC;
    for (int e = tid; e < C * BN * MC; e += kThreads) {
      const int mm = e % MC, nl = (e / MC) % BN, p = e / (MC * BN);
      const int n = n0 + nl, m = m0 + mm;
      const bool ok = n < N && m < M;
      cp_async(wd + e, ok ? ww + ((size_t)p * N + n) * M + m : ww, ok, 4);
    }
  };

  const int chunks = (N + BN - 1) / BN;
  const int items = (BT * S2 + kThreads - 1) / kThreads;
  for (int j = 0; j < items; ++j) {
    const int item = tid + j * kThreads, tl = item % BT, s = item / BT;  // s uniform per warp
    const int lo = s < S2 ? off_s[s] : 0, cnt = s < S2 ? off_s[s + 1] - lo : 0;
    int qoff[kMaxPos];
    float d[kMaxPos][MC];
#pragma unroll
    for (int k = 0; k < kMaxPos; ++k) {
      qoff[k] = tl * TS + (k < cnt ? pos_s[lo + k] : 0) * BN;
#pragma unroll
      for (int mm = 0; mm < MC; ++mm) d[k][mm] = 0.0f;
    }
    if (j > 0) __syncthreads();  // the last item's reads of the ring are done
#pragma unroll
    for (int c = 0; c < ST - 1; ++c) {
      if (c < chunks) stage(c, c * BN);
      cp_async_commit();
    }
    for (int c = 0; c < chunks; ++c) {
      cp_async_wait<ST - 2>();
      __syncthreads();
      const int nxt = c + ST - 1;
      if (nxt < chunks) stage(nxt % ST, nxt * BN);
      cp_async_commit();
      const float* xb = x_s + (c % ST) * kX;
      const float* wb = w_s + (c % ST) * C * BN * MC + lo * BN * MC;
#pragma unroll
      for (int k = 0; k < kMaxPos; ++k) {
        if (k < cnt) {
#pragma unroll
          for (int n = 0; n < BN; n += 4) {
            const float4 xv = *reinterpret_cast<const float4*>(xb + qoff[k] + n);
            const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const float4 wv = *reinterpret_cast<const float4*>(wb + (k * BN + n + u) * MC);
              d[k][0] = fmaf(xs[u], wv.x, d[k][0]);
              d[k][1] = fmaf(xs[u], wv.y, d[k][1]);
              d[k][2] = fmaf(xs[u], wv.z, d[k][2]);
              d[k][3] = fmaf(xs[u], wv.w, d[k][3]);
            }
          }
        }
      }
    }
    cp_async_wait<0>();

    // fold through inv (0 or +-1: skip the zeros) into the tile's 4 outputs
    const int t = t0 + tl;
    if (s < S2 && t < T) {
      float y[4][MC] = {};
#pragma unroll
      for (int k = 0; k < kMaxPos; ++k) {
        if (k < cnt) {
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float iv = inv_s[(lo + k) * 4 + a];
            if (iv != 0.0f) {
#pragma unroll
              for (int mm = 0; mm < MC; ++mm) y[a][mm] = fmaf(iv, d[k][mm], y[a][mm]);
            }
          }
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int mm = 0; mm < MC; ++mm)
          if (m0 + mm < M) out[((size_t)t * S2 * 4 + s * 4 + a) * M + m0 + mm] = y[a][mm];
    }
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

constexpr size_t kMaxSmem = 232448;  // the dynamic shared memory a block may have on sm_90

// The most packed positions the few-channel kernel's shared memory holds
constexpr int few_max_c() {
  int c = 0;
  while (fcf::smem_bytes(c + 1) <= kMaxSmem) ++c;
  return c;
}
constexpr int kFewMaxC = few_max_c();

// Whether forward instantiation conf (engine.py's
// INSTANTIATIONS["domain_engine"], in this order: the CUDA-core kernel,
// the tensor cores, few channels) takes M output channels and C packed
// positions: the tensor cores where M % 4 == 0 and M >= 16, the few-channel
// kernel where its shared memory holds the C positions' weights.
bool fwd_takes(int conf, int M, int C) {
  switch (conf) {
    case 0: return true;                  // cuda_cores
    case 1: return M % 4 == 0 && M >= 16;  // mma_128x64
    case 2: return C <= kFewMaxC;          // few_channels
  }
  return false;
}

// The CUDA-core forward's N chunks at (N, M): its N split's most ways
int fwd_chunks(int N, int M) {
  return with_fwd_conf(M, [&](auto cf) { return (N + decltype(cf)::BN - 1) / decltype(cf)::BN; });
}

// cuTensorMapEncodeTiled through the runtime's entry-point query (no -lcuda)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// a 3-D fp32 tensor map in the 128-byte swizzle, zeros outside the tensor;
// 0 or a cudaError
int encode_map(CUtensorMap* map, const void* base, const cuuint64_t* dim, const cuuint64_t* stride,
               const cuuint32_t* box) {
  static EncodeTiledFn encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return (int)cudaErrorSymbolNotFound;
    encode = reinterpret_cast<EncodeTiledFn>(fn);
  }
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(base), dim, stride, box, elem,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
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

// bwd_x configurations, by number (engine.py's
// INSTANTIATIONS["domain_engine_bwd_x"], in this order): 0 the fp32
// CUDA-core kernel (BxCfg) of the rank; the tensor cores: 1 in 2D, 64 tiles
// x 32 channels n a block, two position sets of 4 warps, each warp 32 n x 16
// tiles x 8 positions (the set's colour of the 4x4 checkerboard); 2 at rank
// 1 with n2 <= 4 positions, 128 tiles x 64 n, each warp 64 n x 16 tiles x
// all positions; 3 at rank 1 with more positions, as 2D with one set.
template <class F>
int with_bx_conf(int conf, int M2, F&& f) {
  if (conf == 1) return f(BxMma<bwdx::Core<16, 4, 2, 2, 8, 2>>{});
  if (conf == 2) return f(BxMma<bwdx::Core<4, 2, 4, 2, 8>>{});
  if (conf == 3) return f(BxMma<bwdx::Core<16, 2, 2, 1, 8>>{});
  if (M2 == 2) return f(BxConf<2>{});
  return f(BxConf<4>{});
}

// Whether bwd_x instantiation conf takes (M, M2, N2): the tensor cores
// where M % 4 == 0 and M >= 8 (g and ww in 16-byte copies: the wrapper has
// checked their alignment), each core at its own rank and positions
bool bx_takes(int conf, int M, int M2, int N2) {
  switch (conf) {
    case 0: return true;                                          // cuda_cores
    case 1: return M >= 8 && M % 4 == 0 && M2 == 4;                // mma_64x32
    case 2: return M >= 8 && M % 4 == 0 && M2 == 2 && N2 <= 4;     // mma_rank1_128x64
    case 3: return M >= 8 && M % 4 == 0 && M2 == 2 && N2 > 4;      // mma_rank1_64x32
  }
  return false;
}

// The plan's own choice: the tensor-core core that takes the shape, else
// (few or ragged channels: RGB, the audio decoder's mono waveform) the CUDA
// cores
int bx_default(int M, int M2, int N2) {
  for (int conf = 1; conf <= 3; ++conf)
    if (bx_takes(conf, M, M2, N2)) return conf;
  return 0;
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

// bwd_w configurations, by number (engine.py's
// INSTANTIATIONS["domain_engine_bwd_w"], in this order): 0 the fp32
// CUDA-core kernel (BwCfg) of the rank; the tensor cores: 1 in 2D, 256
// channels n x 128 m a block, 8 warps of 64 x 64, 16 tiles a chunk (193 KB
// of shared memory); at rank 1, 2 the same (161 KB) or 3 128 x 64, 4 warps
// of 64 x 32 (81 KB).
template <class F>
int with_bw_conf(int conf, int M2, F&& f) {
  if (conf == 1) return f(BwMma<bwdw::Core<4, 2, 4, 8, 16, 4, 1>>{});
  if (conf == 2) return f(BwMma<bwdw::Core<4, 2, 4, 8, 16, 2, 1>>{});
  if (conf == 3) return f(BwMma<bwdw::Core<2, 2, 4, 4, 16, 2, 1>>{});
  if (M2 == 2) return f(BwConf<2>{});
  return f(BwConf<4>{});
}

// Whether bwd_w instantiation conf takes (M, M2): the tensor cores where M
// % 4 == 0 and M >= 16 (g rows in 16-byte copies: the wrapper has checked
// g's alignment), each core at its own rank
bool bw_takes(int conf, int M, int M2) {
  switch (conf) {
    case 0: return true;                              // cuda_cores
    case 1: return M >= 16 && M % 4 == 0 && M2 == 4;  // mma_256x128
    case 2: return M >= 16 && M % 4 == 0 && M2 == 2;  // mma_rank1_256x128
    case 3: return M >= 16 && M % 4 == 0 && M2 == 2;  // mma_rank1_128x64
  }
  return false;
}

// The plan's own choice: the tensor cores wherever they take the shape, at
// rank 1 256 x 128 for N >= 256 and M >= 128, else 128 x 64 (the audio
// decoder's 128 -> 64 layer); otherwise (few or ragged channels: RGB, the
// audio decoder's mono waveform) the CUDA cores
int bw_default(int N, int M, int M2) {
  if (!bw_takes(M2 == 4 ? 1 : 2, M, M2)) return 0;
  if (M2 == 4) return 1;
  return N >= 256 && M >= 128 ? 2 : 3;
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

// fwd plan: the instantiation and its launch for this shape on this card.
// tile gets (BT, BM, conf): conf 1 the tensor cores (where M % 4 == 0,
// M >= 16 and their blocks, one an SM, are at least the SMs), 2 the
// few-channel kernel (M < 16 or M % 4 != 0, where its blocks are at least
// the SMs), 0 the CUDA-core kernel.  splits and
// counters: the CUDA-core kernel's N-loop split (1 and 0 elsewhere): the
// count minimises the waves of blocks over the card's resident block slots,
// times the work per block (1/k), times a 25% cost per extra split; at least
// 4 N chunks per split (fused_engine_plan's rule).  scratch_floats: the
// floats of the launch's scratch (the split's partial products; the tensor
// cores' packed weights, 2*C*M*N).  want -1 lets the plan choose; 0, 1 or 2
// asks for that instantiation (fwd_takes), and want_splits >= 1 for that
// many N splits on the CUDA cores (at most its N chunks; the other two run
// unsplit): a request the shape cannot take returns cudaErrorInvalidValue.
// The plan also raises the chosen kernel's shared-memory limit on the
// device.
extern "C" int domain_engine_fwd_plan(int T, int N, int M, int S2, int C, int want, int want_splits, int device,
                                      int* splits, long long* scratch_floats, long long* counters, int* tile) {
  int sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  *splits = 1;
  *scratch_floats = 0;
  *counters = 0;
  const long long tc_blocks = (long long)((T + tcf::BT - 1) / tcf::BT) * ((M + tcf::BM - 1) / tcf::BM) * S2;
  const long long few_blocks = (long long)((T + fcf::BT - 1) / fcf::BT) * ((M + fcf::MC - 1) / fcf::MC);
  const bool tc_shape = fwd_takes(1, M, C), few_fits = fwd_takes(2, M, C);
  if ((want >= 0 && !fwd_takes(want, M, C)) ||
      (want_splits > 1 && (want != 0 || want_splits > fwd_chunks(N, M))))
    return (int)cudaErrorInvalidValue;
  if (want == 1 || (want < 0 && tc_shape && tc_blocks >= sms)) {
    tile[0] = tcf::BT, tile[1] = tcf::BM, tile[2] = 1;
    *scratch_floats = 2LL * C * M * N;
    return (int)cudaFuncSetAttribute(domain_fwd_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)tcf::kSmemBytes);
  }
  if (want == 2 || (want < 0 && !tc_shape && few_blocks >= sms && few_fits)) {
    tile[0] = fcf::BT, tile[1] = fcf::MC, tile[2] = 2;
    return (int)cudaFuncSetAttribute(domain_fwd_few_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)fcf::smem_bytes(C));
  }
  return with_fwd_conf(M, [&](auto conf) {
    using Cf = decltype(conf);
    using K = typename Cf::K;
    cudaError_t e = cudaFuncSetAttribute(FWD_KERNEL(Cf, false), cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)K::kSmemBytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(FWD_KERNEL(Cf, true), cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)K::kSmemBytes);
    int occ = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, FWD_KERNEL(Cf, false), K::kThreads, K::kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    const long long slots = occ > 0 ? (long long)occ * sms : 1;
    const long long groups = (long long)((T + K::BT - 1) / K::BT) * S2 * ((M + K::BM - 1) / K::BM);
    const int chunks = (N + Cf::BN - 1) / Cf::BN;
    int best = 1;
    double best_cost = (double)((groups + slots - 1) / slots);
    for (int k = 2; k <= 8 && chunks / k >= 4; ++k) {
      const double cost = (double)((groups * k + slots - 1) / slots) / k * (1.0 + 0.25 * (k - 1));
      if (cost < best_cost - 1e-9) best = k, best_cost = cost;
    }
    if (want_splits >= 1) best = want_splits;
    *splits = best;
    *scratch_floats = best > 1 ? groups * best * K::kRed : 0;
    *counters = best > 1 ? groups : 0;
    tile[0] = K::BT, tile[1] = K::BM, tile[2] = 0;
    return 0;
  });
}

// One fwd launch -> y (T, S2*4, M), every element written, on the
// instantiation conf of domain_engine_fwd_plan (with its splits and scratch:
// conf 0's partial products, conf 1's packed weights; counters zero on
// entry and left zero).  C: the packed positions.  conf 1 launches the
// weight pack, then the forward.  xw starts on
// a 16-byte boundary (N % 4 == 0); conf 0 with M >= 32 also reads ww in
// 16-byte copies.
extern "C" int domain_engine_fwd_f32(const float* xw, const float* ww, const float* inv, const int* pos,
                                     const int* sub_off, float* y, int T, int N, int M, int S2, int C, int conf,
                                     int splits, float* scratch, int* counters, void* stream) {
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (!fwd_takes(conf, M, C)) return (int)cudaErrorInvalidValue;
  if (conf == 1) {
    if (N % 4 != 0) return (int)cudaErrorInvalidValue;
    CUtensorMap xmap, wmap;
    // xw as (N, 16, T), a box of 32 channels of one position for 128 tiles;
    // the packed halves as (N, M, 2C), a box of 32 channels x 64 m
    const cuuint64_t xdim[3] = {(cuuint64_t)N, 16, (cuuint64_t)T};
    const cuuint64_t xstride[2] = {(cuuint64_t)N * 4, (cuuint64_t)N * 64};
    const cuuint32_t xbox[3] = {tcf::BK, 1, tcf::BT};
    const cuuint64_t wdim[3] = {(cuuint64_t)N, (cuuint64_t)M, 2 * (cuuint64_t)C};
    const cuuint64_t wstride[2] = {(cuuint64_t)N * 4, (cuuint64_t)N * M * 4};
    const cuuint32_t wbox[3] = {tcf::BK, tcf::BM, 1};
    int e = encode_map(&xmap, xw, xdim, xstride, xbox);
    if (e == 0) e = encode_map(&wmap, scratch, wdim, wstride, wbox);
    if (e != 0) return e;
    domain_fwd_pack_kernel<<<dim3((N + 31) / 32, (M + 31) / 32, C), dim3(32, 8), 0, st>>>(ww, scratch, C, N, M);
    const cudaError_t pe = cudaGetLastError();
    if (pe != cudaSuccess) return (int)pe;
    const int blocks = ((T + tcf::BT - 1) / tcf::BT) * ((M + tcf::BM - 1) / tcf::BM) * S2;
    domain_fwd_mma_kernel<<<blocks, tcf::kThreads, tcf::kSmemBytes, st>>>(xmap, wmap, inv, pos, sub_off, y, T, N,
                                                                          M, S2, C);
    return (int)cudaGetLastError();
  }
  if (conf == 2) {
    const dim3 grid((T + fcf::BT - 1) / fcf::BT, (M + fcf::MC - 1) / fcf::MC);
    domain_fwd_few_kernel<<<grid, fcf::kThreads, fcf::smem_bytes(C), st>>>(xw, ww, inv, pos, sub_off, y, T, N, M,
                                                                          S2, C);
    return (int)cudaGetLastError();
  }
  return with_fwd_conf(M, [&](auto conf0) {
    using Cf = decltype(conf0);
    using K = typename Cf::K;
    auto kernel = splits > 1 ? FWD_KERNEL(Cf, true) : FWD_KERNEL(Cf, false);
    dim3 grid((T + K::BT - 1) / K::BT, S2, ((M + K::BM - 1) / K::BM) * splits);
    kernel<<<grid, K::kThreads, K::kSmemBytes, st>>>(xw, ww, inv, pos, sub_off, y, T, N, M, S2, splits, scratch,
                                                     counters);
    return (int)cudaGetLastError();
  });
}

// The bwd_x instantiation for (M, M2, N2): want -1 takes the plan's
// (bx_default), want >= 0 asks for that one (bx_takes' numbering): a request
// the shape cannot take returns cudaErrorInvalidValue.  conf gets the one
// handed out, which domain_engine_bwd_x_f32 takes.  Raises its kernel's
// shared-memory limit on the current device (call it before the first
// launch for this shape).
extern "C" int domain_engine_bwd_x_plan(int M, int M2, int N2, int want, int* conf) {
  *conf = want < 0 ? bx_default(M, M2, N2) : want;
  if (!bx_takes(*conf, M, M2, N2)) return (int)cudaErrorInvalidValue;
  return with_bx_conf(*conf, M2, [&](auto cf) {
    using Cf = decltype(cf);
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
// the packed positions; conf from domain_engine_bwd_x_plan.  Where conf runs
// the tensor cores, g and ww start on 16-byte boundaries.
extern "C" int domain_engine_bwd_x_f32(const float* g, const float* ww, const float* inv, const int* pos,
                                       const int* sub_off, float* dxw, int T, int N, int M, int S2, int M2,
                                       int N2, int C, int conf, void* stream) {
  if (!bx_takes(conf, M, M2, N2)) return (int)cudaErrorInvalidValue;
  return with_bx_conf(conf, M2, [&](auto cf) {
    using Cf = decltype(cf);
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
// (fused_engine_bwd_w_plan's rules).  want -1 takes the plan's
// instantiation (bw_default), want >= 0 asks for that one (bw_takes'
// numbering), want_splits >= 1 for that T split (at most the T chunks and
// 65535): a request the shape cannot take returns cudaErrorInvalidValue.
// tile gets (BN, BM, BT, the instantiation: 0 the CUDA cores, 1-3 the tensor
// cores), which domain_engine_bwd_w_f32 takes as conf.
extern "C" int domain_engine_bwd_w_plan(int T, int N, int M, int S2, int M2, int C, int want, int want_splits,
                                        int device, int* splits, long long* scratch_floats, long long* counters,
                                        int* tile) {
  const int conf = want < 0 ? bw_default(N, M, M2) : want;
  if (!bw_takes(conf, M, M2)) return (int)cudaErrorInvalidValue;
  return with_bw_conf(conf, M2, [&](auto cf) {
    using Cf = decltype(cf);
    using K = typename Cf::K;
    const long long chunks = ((long long)T + K::BT - 1) / K::BT;
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
      groups = (long long)S2 * tiles;
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

// One bwd_w launch: xw, g -> dww (C, N, M), every element written.  C the
// packed positions; conf, splits, partial and counters from
// domain_engine_bwd_w_plan with the same shape; the counters are zero on
// entry and the kernel leaves them zero; xw (and g where M % 4 == 0 and M >=
// 16) start on 16-byte boundaries.
extern "C" int domain_engine_bwd_w_f32(const float* xw, const float* g, const float* inv, const int* pos,
                                       const int* sub_off, float* dww, int T, int N, int M, int S2, int M2,
                                       int N2, int C, int conf, int splits, float* partial, int* counters,
                                       void* stream) {
  if (!bw_takes(conf, M, M2)) return (int)cudaErrorInvalidValue;
  return with_bw_conf(conf, M2, [&](auto cf) {
    using Cf = decltype(cf);
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
