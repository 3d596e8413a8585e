// The Winograd Conv engine for Hopper (sm_90a), fp32: the forward and both
// backward kernels of the fused engine at its strided-conv corner.
//
// Replaces src/repro/kernels/engine.py::fused_engine (nhwc/cells epilogue,
// the pallas_call at engine.py:817), ::fused_engine_bwd_x (engine.py:1291)
// and ::fused_engine_bwd_w (engine.py:1427) as
// src/repro/kernels/winograd_deconv.py::winograd_conv_fused_engine,
// _bwd_x and _bwd_w instantiate them: phases = S^2, stride = 1, padding = 0,
// one sub-filter spanning all C packed positions.  The plain PyTorch
// versions are repro_torch/kernels/ref.py::conv_engine_ref and
// conv_engine_bwd_x_ref / conv_engine_bwd_w_ref.
//
// What they compute, for one stride-S conv layer under F(2x2, 3x3) (m = 2,
// n = 4).  The cells (B, Gy, Gx, S^2*4, N) hold the S^2 de-interleaved input
// phases, phase-major: phase s is channel slots [4s, 4s + 4) of every cell.
// Packed position p (of C; 36 for K4S2) indexes Winograd position pos_p of
// phase s(p) = pos_p / 16, and the positions of one phase are one contiguous
// range [phase_off[s], phase_off[s+1]).
//   forward: for every tile t = (b, j, c) and phase s, xw_s = B^T Z_s B of
//     the tile's 4x4 window of phase-s pixels; dot_p[t, m] = sum_n
//     xw[t, pos_p, n] * ww[p, n, m]; ALL positions sum into one 2x2 output
//     tile, y[t, a, m] = sum_p inv[p, a] * dot_p[t, m]; then act(scale * y +
//     bias).  "nhwc" writes the cropped image (B, H_O, W_O, M); "cells" the
//     exact cells (B, ty, tx, 4, M), zero outside [0, H_O) x [0, W_O).
//   bwd_x: from g (B, ty, tx, 4, M), gw[p, t, m] = sum_a inv[p, a] g[t, a, m],
//     dXw[t, pos_p, n] = sum_m gw[p, t, m] ww[p, n, m] (the 36 positions are
//     distinct, no two share a Winograd position), per phase dZ_s =
//     B dXw_s B^T, and each phase's sub-cell sums the pieces of the up to 4
//     tiles whose windows cover it -> dcells (B, Gy, Gx, S^2*4, N).
//   bwd_w: dww[p, n, m] = sum_t xw[t, pos_p, n] gw[p, t, m], xw recomputed
//     from the cells phase by phase -> (C, N, M).
//
// What bounds them on an H100 (times below: NVIDIA H100 80GB HBM3 at its
// 700 W limit, PERF.md): the products, 2*T*C*N*M flops each, at every DCGAN
// discriminator layer but the first, on the tensor cores in 3xTF32 (165
// TFLOP/s), which all three use at a tenth to an eighth of that rate; at the
// first (N = 3) the bytes of the output cells (forward), of g and dcells
// (bwd_x) and of the cell windows and g (bwd_w).
//
// What the designs do about it:
//   * forward (conv_fwd_mma_kernel): the shared forward core (fwd_core.cuh)
//     on a block of 64 tiles x 128 (or 64) channels m.  A pass holds the at
//     most 9 packed positions of one phase; a chunk stages each tile's 4x4
//     window of that phase (fwd::stage_windows) and forms xw at the pass's
//     Winograd positions (fwd::prep_windows); every k-step's products of all
//     positions fold into the tile's 4 outputs in registers.  Where the grid
//     of (tile block, M tile) blocks leaves SMs idle (conv2-3 at batch 128),
//     the phases' passes split over blocks, summed in split order by the last
//     block to arrive.  0.21-0.27 ms a pass at conv1-3 at batch 128, about
//     half the fp32 CUDA-core kernel's time (PERF.md).  Its sums are not
//     bitwise those of the plain version, whose order the CUDA-core kernel
//     kept; few or ragged channels (conv0's RGB input) keep that kernel,
//     conv_fwd_kernel: the deconv engine's micro tiles (8 position groups, 4
//     tiles x 4 channels each, a two-stage cp.async pipeline of raw windows
//     and weights, the B-transform shared-to-shared), the phases one after
//     another, a phase's at most 16 positions accumulated over the whole N
//     loop, met in shared memory and folded through inv into the tile's 4
//     outputs, which stay in registers across phases;
//   * bwd_x: the deconv corner's gather (bwd_x_core.cuh: a block owns R cell
//     rows x W cell columns x BN channels, computes dXw for every tile its
//     cells read, the one-row halo again, and sums each cell's pieces in a
//     fixed order: no atomics, no scratch, no dependence on block order) on
//     the tensor cores with the phase in the grid: each phase is a problem
//     of one sub-filter (its own positions, kmap and g's 4 rows a tile) for
//     bwdx::contract, and a block writes only its phase's channel slots.
//     The S^2 blocks of one cell block run side by side, so g comes from
//     device memory once and from L2 for the other phases (the CUDA-core
//     design before it ran the phases in one block and staged g four times:
//     0.43-0.87 ms a layer, 64 blocks at conv3);
//   * bwd_w: the deconv corner's tensor-core design (bwd_w_core.cuh): a
//     block per (packed position, N tile, M tile) and T split, xw formed only
//     at the block's Winograd position from the four window planes of its
//     phase that position reads (C * M tiles / 16 formations a value), the T
//     loop split over blocks with the deterministic last-block sum;
//   * few or ragged channels keep fp32 CUDA-core kernels: bwd_x a phase loop
//     of micro tiles (M < 8 or M % 4 != 0), bwd_w one block per (phase,
//     N-tile, M-tile) with a T split (M < 16 or M % 4 != 0, and N % 4 != 0:
//     conv0's RGB input, whose cell windows move in 4-byte copies; there it
//     reads g once per phase where the tensor-core grid would read it once
//     per packed position).  Nothing is padded on the host.
// A gw pass shared by both backward kernels is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bwd_w_core.cuh"
#include "fwd_core.cuh"

namespace {

constexpr int kN2 = 16;         // n*n Winograd positions of one phase
constexpr int kMaxPhases = 16;  // S^2, S <= 4
constexpr int kMaxC = kN2 * kMaxPhases;

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case 1: return v < 0.0f ? 0.0f : v;  // keeps NaN, as torch.clamp_min and jnp.maximum do
    case 2: return v >= 0.0f ? v : 0.2f * v;  // LEAKY_SLOPE
    case 3: return tanhf(v);
    default: return v;
  }
}

// global -> shared copy of V floats (V = 4: 16 bytes, V = 1: 4 bytes) that
// does not pass through registers; pred false zero-fills without reading src
template <int V>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool pred) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (V == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(pred ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(pred ? 4 : 0));
  }
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

using fwd::bt_z_b;

// ============================================================ forward
// G warp-uniform position groups x (NT_T x NT_M) threads; group g owns the
// positions g, g + G, ... of the current phase, each thread a 4-tile x
// 4-channel micro tile.  BN: the N chunk; VZ / VW: floats per cell-window /
// weight copy (4 or 1).
template <int G, int NT_T, int NT_M, int BN, int VZ, int VW>
struct FwdCfg {
  static constexpr int PG = kN2 / G;
  static constexpr int kThreads = G * NT_T * NT_M;
  static constexpr int BT = NT_T * 4, BM = NT_M * 4;
  static constexpr int XT = BT + 4;  // xw row stride: float4-aligned, skewed banks
  static constexpr int kZ = BT * 16 * BN;     // raw 4x4 windows, one stage
  static constexpr int kW = kN2 * BN * BM;    // weight slice, one stage
  static constexpr int kXw = kN2 * BN * XT;   // transformed tiles
  static constexpr int kStage = 2 * (kZ + kW) + kXw;
  static constexpr int kRed = kN2 * BT * BM;  // one phase's products
  static constexpr int kBig = kStage > kRed ? kStage : kRed;
  static constexpr size_t kSmemBytes =
      sizeof(float) * (kBig + kMaxC * 4) + sizeof(int) * (kMaxC + kMaxPhases + 1 + BT);
  static_assert(BT * BM == PG * kThreads, "each thread owns PG tile-channel pairs");
};

template <int G, int NT_T, int NT_M, int BN, int VZ, int VW>
__global__ void __launch_bounds__(G * NT_T * NT_M)
conv_fwd_kernel(const float* __restrict__ cells, const float* __restrict__ ww, const float* __restrict__ inv,
                const int* __restrict__ pos, const int* __restrict__ phase_off, const float* __restrict__ scale,
                const float* __restrict__ bias, float* __restrict__ out, int B, int Gy, int Gx, int N, int M,
                int S2, int ty, int tx, int out_h, int out_w, int out_mode, int act) {
  using K = FwdCfg<G, NT_T, NT_M, BN, VZ, VW>;
  constexpr int PG = K::PG, BT = K::BT, BM = K::BM, XT = K::XT, NT = K::kThreads;
  extern __shared__ float4 smem4[];
  float* z_s = reinterpret_cast<float*>(smem4);  // 2 x [BT][16][BN]
  float* ww_s = z_s + 2 * K::kZ;                 // 2 x [16][BN][BM]
  float* xw_s = ww_s + 2 * K::kW;                // [16][BN][XT]
  float* red_s = z_s;                            // [16][BT][BM] after a phase's N loop
  float* inv_s = z_s + K::kBig;                  // [C][4]
  int* pos_s = reinterpret_cast<int*>(inv_s + kMaxC * 4);  // [C] position within its phase
  int* off_s = pos_s + kMaxC;                    // [S2 + 1]
  int* tile_s = off_s + kMaxPhases + 1;          // [BT] first cell of each tile, -1 past T

  const int t0 = blockIdx.x * BT, m0 = blockIdx.y * BM;
  const int tid = threadIdx.x;
  const int g = tid / (NT_T * NT_M);  // position group, uniform per warp
  const int rem = tid % (NT_T * NT_M);
  const int tt = rem / NT_M, tm = rem % NT_M;
  const int T = B * ty * tx, tpi = ty * tx;
  const int C = phase_off[S2];
  const int cs = S2 * 4;  // channel slots per cell

  for (int i = tid; i < C * 4; i += NT) inv_s[i] = inv[i];
  for (int i = tid; i < C; i += NT) pos_s[i] = pos[i] % kN2;
  for (int i = tid; i <= S2; i += NT) off_s[i] = phase_off[i];
  for (int tl = tid; tl < BT; tl += NT) {
    const int t = t0 + tl;
    const int b = t / tpi, rm = t - b * tpi, jy = rm / tx, jx = rm - jy * tx;
    tile_s[tl] = t < T ? (b * Gy + jy) * Gx + jx : -1;
  }
  __syncthreads();

  // one pipeline stage: the raw 4x4 window of phase s of every tile and the
  // phase's weight slice ww[lo+k, n0:n0+BN, m0:m0+BM]; ragged edges zero-filled
  auto stage = [&](int buf, int s, int lo, int cnt, int n0) {
    float* zd = z_s + buf * K::kZ;
    constexpr int kZv = BT * 16 * BN / VZ;
    for (int e = tid; e < kZv; e += NT) {
      const int nl = (e % (BN / VZ)) * VZ, zi = (e / (BN / VZ)) % 16, tl = e / (16 * (BN / VZ));
      const int base = tile_s[tl], n = n0 + nl;
      const int a = zi / 4, c = zi % 4;  // window row / column
      const bool ok = base >= 0 && n < N;
      const size_t off =
          ok ? ((size_t)(base + (a / 2) * Gx + c / 2) * cs + s * 4 + (a % 2) * 2 + c % 2) * N + n : 0;
      cp_async<VZ>(zd + (tl * 16 + zi) * BN + nl, cells + off, ok);
    }
    float* wd = ww_s + buf * K::kW;
    constexpr int kWv = kN2 * BN * BM / VW;
    for (int e = tid; e < kWv; e += NT) {
      const int mm = (e % (BM / VW)) * VW, nl = (e / (BM / VW)) % BN, k = e / ((BM / VW) * BN);
      if (k < cnt) {
        const int n = n0 + nl, mc = m0 + mm;
        const bool ok = n < N && mc < M;
        cp_async<VW>(wd + (k * BN + nl) * BM + mm, ok ? ww + ((size_t)(lo + k) * N + n) * M + mc : ww, ok);
      }
    }
    cp_async_commit();
  };

  // pre-PE, shared to shared: xw_s[pos][n][tile]
  auto transform = [&](int buf) {
    const float* zb = z_s + buf * K::kZ;
    for (int idx = tid; idx < BT * BN; idx += NT) {
      const int nl = idx % BN, tl = idx / BN;
      float z[4][4], x[4][4];
#pragma unroll
      for (int zi = 0; zi < 16; ++zi) z[zi / 4][zi % 4] = zb[(tl * 16 + zi) * BN + nl];
      bt_z_b(z, x);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) xw_s[((u * 4 + v) * BN + nl) * XT + tl] = x[u][v];
    }
  };

  float y[PG][4];
#pragma unroll
  for (int r = 0; r < PG; ++r)
#pragma unroll
    for (int a = 0; a < 4; ++a) y[r][a] = 0.0f;

  const int n_chunks = (N + BN - 1) / BN;
  for (int s = 0; s < S2; ++s) {
    const int lo = off_s[s], cnt = off_s[s + 1] - lo;
    if (cnt == 0) continue;  // block-uniform
    float d[PG][4][4];
#pragma unroll
    for (int kk = 0; kk < PG; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) d[kk][i][j] = 0.0f;
    int xoff[PG];
#pragma unroll
    for (int kk = 0; kk < PG; ++kk) {
      const int k = kk * G + g;
      xoff[kk] = (k < cnt ? pos_s[lo + k] : 0) * BN * XT + tt * 4;
    }

    stage(0, s, lo, cnt, 0);
    if (n_chunks > 1) stage(1, s, lo, cnt, BN);
    for (int c = 0; c < n_chunks; ++c) {
      const int buf = c & 1;
      if (c + 1 < n_chunks) cp_async_wait<1>(); else cp_async_wait<0>();
      __syncthreads();
      transform(buf);
      __syncthreads();
      const float* wbuf = ww_s + buf * K::kW + tm * 4;
#pragma unroll
      for (int kk = 0; kk < PG; ++kk) {
        const int k = kk * G + g;
        if (k < cnt) {
          const float* xp = xw_s + xoff[kk];
          const float* wp = wbuf + k * BN * BM;
#pragma unroll
          for (int n = 0; n < BN; ++n) {
            const float4 xa = *reinterpret_cast<const float4*>(xp + n * XT);
            const float4 wa = *reinterpret_cast<const float4*>(wp + n * BM);
            const float xv[4] = {xa.x, xa.y, xa.z, xa.w};
            const float wv[4] = {wa.x, wa.y, wa.z, wa.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) d[kk][i][j] = fmaf(xv[i], wv[j], d[kk][i][j]);
          }
        }
      }
      __syncthreads();
      if (c + 2 < n_chunks) stage(buf, s, lo, cnt, (c + 2) * BN);
    }

    // this phase's products meet in shared memory and fold through inv into
    // the tile's 4 outputs, kept in registers across phases
#pragma unroll
    for (int kk = 0; kk < PG; ++kk) {
      const int k = kk * G + g;
      if (k < cnt) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          *reinterpret_cast<float4*>(red_s + (k * BT + tt * 4 + i) * BM + tm * 4) =
              make_float4(d[kk][i][0], d[kk][i][1], d[kk][i][2], d[kk][i][3]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < PG; ++r) {
      const int idx = tid + r * NT;
      const int ml = idx % BM, tl = idx / BM;
      for (int k = 0; k < cnt; ++k) {
        const float v = red_s[(k * BT + tl) * BM + ml];
        const float* iv = inv_s + (lo + k) * 4;
#pragma unroll
        for (int a = 0; a < 4; ++a) y[r][a] = fmaf(iv[a], v, y[r][a]);
      }
    }
    __syncthreads();  // red_s is the next phase's staging space
  }

  // epilogue and store: output pixel (2j + a/2, 2c + a%2) of tile (b, j, c)
#pragma unroll
  for (int r = 0; r < PG; ++r) {
    const int idx = tid + r * NT;
    const int ml = idx % BM, tl = idx / BM;
    const int t = t0 + tl, mc = m0 + ml;
    if (t >= T || mc >= M) continue;
    const int b = t / tpi, rm = t - b * tpi, jy = rm / tx, jx = rm - jy * tx;
    const float sc = scale ? scale[mc] : 1.0f;
    const float bi = bias ? bias[mc] : 0.0f;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float v = activate(y[r][a] * sc + bi, act);
      const int row = 2 * jy + a / 2, col = 2 * jx + a % 2;
      const bool inside = row < out_h && col < out_w;
      if (out_mode == 0) {
        if (inside) out[(((size_t)b * out_h + row) * out_w + col) * M + mc] = v;
      } else {
        out[((size_t)t * 4 + a) * M + mc] = inside ? v : 0.0f;
      }
    }
  }
}

// The forward on the tensor cores (fwd_core.cuh): one block per (BT
// consecutive tiles, BM channels m) and split of the pass plan.  The host
// plans passes of at most PMAX packed positions of one phase each
// (engine.py::_fwd_passes with the phases as its groups); a chunk stages the
// block's 4x4 windows of the pass's phase (fwd::stage_windows) and forms xw
// at the Winograd positions the pass reads (fwd::prep_windows), and every
// k-step's products of every position fold into the tile's 4 outputs.
// Where the grid of (tile block, M tile) blocks would leave SMs idle (conv3
// at batch 128: 32 blocks) the passes are split over `splits` blocks, each
// writing its outputs to the scratch `partial`; the last to arrive sums them
// in split order (the same result on every launch), leaves the group's
// counter at 0 and runs the epilogue.
template <class K, bool SPLIT>
__global__ void __launch_bounds__(K::kThreads, K::kMinBlocks)
conv_fwd_mma_kernel(const float* __restrict__ cells, const float* __restrict__ ww, const float* __restrict__ inv,
                    const int* __restrict__ fplan, const float* __restrict__ scale, const float* __restrict__ bias,
                    float* __restrict__ out, int B, int Gy, int Gx, int N, int M, int S2, int ty, int tx, int out_h,
                    int out_w, int out_mode, int act, int npass, int nslot, int npos, int splits,
                    float* __restrict__ partial, int* __restrict__ counters) {
  constexpr int BT = K::BT, BM = K::BM;
  const int C = fplan[npass];
  const fwd::Layout L(BT, BM, nslot, npos, BT * fwd::kRT);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* inv_s = smem + L.floats;                              // [C][4]
  int* tile_s = reinterpret_cast<int*>(inv_s + C * K::M2);  // [BT]
  int* plan_s = tile_s + BT;

  const int tid = threadIdx.x, T = B * ty * tx, t0 = blockIdx.x * BT;
  if (!SPLIT) splits = 1;  // compiled out of the unsplit variant
  const int mt = blockIdx.y / splits, ks = blockIdx.y % splits, m0 = mt * BM;
  for (int i = tid; i < C * K::M2; i += K::kThreads) inv_s[i] = inv[i];
  fwd::tile_cells(tile_s, BT, t0, T, ty, tx, Gy, Gx);
  const fwd::Plan plan = fwd::from_pass(fwd::load_plan<K>(plan_s, fplan, npass, C), ks * npass / splits, K::SMAX);
  __syncthreads();
  const int nck = (N + fwd::BN - 1) / fwd::BN;
  // each pass's group is its phase
  auto stage_a = [&](float* raw, int c) {
    fwd::stage_windows<K>(raw, cells, tile_s, S2 * 4, plan.psub[c / nck], c % nck * fwd::BN, N, Gx);
  };
  auto prep_a = [&](uint32_t* split, const float* raw, int c) {
    fwd::prep_windows<K>(split, L, raw, plan.qslot + c / nck * fwd::kMaxQ);
  };
  fwd::Out<K> y;
  fwd::zero<K>(y[0]);
  fwd::contract<K>(y, smem, L, plan, (ks + 1) * npass / splits - ks * npass / splits, nck, ww, N, M, m0, inv_s,
                   stage_a, prep_a, [](int) {});

  if (SPLIT) {
    // this split's outputs, register order (float4 i of thread tid at
    // i * kThreads + tid: coalesced); the last block of the group sums all
    // splits' in split order
    __shared__ int last;
    constexpr int kY4 = K::kY / 4;
    const size_t grp = (size_t)blockIdx.x * (gridDim.y / splits) + mt;
    float4* mine = reinterpret_cast<float4*>(partial) + (grp * splits + ks) * kY4 * K::kThreads;
#pragma unroll
    for (int a = 0; a < K::M2; ++a)
#pragma unroll
      for (int fa = 0; fa < K::FA; ++fa)
#pragma unroll
        for (int fb = 0; fb < K::FB; ++fb) {
          const float* v = y[0][a][fa][fb];
          __stcg(mine + ((a * K::FA + fa) * K::FB + fb) * K::kThreads + tid, make_float4(v[0], v[1], v[2], v[3]));
        }
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      last = atomicAdd(counters + grp, 1) == splits - 1;
      if (last) counters[grp] = 0;  // every split has arrived: zero for the next launch
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    const float4* all = reinterpret_cast<const float4*>(partial) + grp * splits * kY4 * K::kThreads;
#pragma unroll
    for (int a = 0; a < K::M2; ++a)
#pragma unroll
      for (int fa = 0; fa < K::FA; ++fa)
#pragma unroll
        for (int fb = 0; fb < K::FB; ++fb) {
          float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          for (int j = 0; j < splits; ++j) {
            const float4 v = __ldcg(all + (j * kY4 + (a * K::FA + fa) * K::FB + fb) * K::kThreads + tid);
            acc.x += v.x;
            acc.y += v.y;
            acc.z += v.z;
            acc.w += v.w;
          }
          y[0][a][fa][fb][0] = acc.x, y[0][a][fa][fb][1] = acc.y, y[0][a][fa][fb][2] = acc.z;
          y[0][a][fa][fb][3] = acc.w;
        }
  }

  // epilogue and store: output pixel (2jy + a/2, 2jx + a%2) of tile (b, jy, jx), channels m, m + 1
#pragma unroll
  for (int fa = 0; fa < K::FA; ++fa)
#pragma unroll
    for (int fb = 0; fb < K::FB; ++fb)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = t0 + fwd::out_tile<K>(fa, 2 * h), m = m0 + fwd::out_m<K>(fb, 0);
        if (t >= T || m >= M) continue;
        const int b = t / (ty * tx), rm = t - b * ty * tx, jy = rm / tx, jx = rm - jy * tx;
        const float2 sc = scale ? make_float2(scale[m], scale[m + 1]) : make_float2(1.0f, 1.0f);
        const float2 bi = bias ? make_float2(bias[m], bias[m + 1]) : make_float2(0.0f, 0.0f);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int row = 2 * jy + a / 2, col = 2 * jx + a % 2;
          const bool inside = row < out_h && col < out_w;
          float2 v = make_float2(activate(y[0][a][fa][fb][2 * h] * sc.x + bi.x, act),
                                 activate(y[0][a][fa][fb][2 * h + 1] * sc.y + bi.y, act));
          if (out_mode == 0) {
            if (inside) *reinterpret_cast<float2*>(out + (((size_t)b * out_h + row) * out_w + col) * M + m) = v;
          } else {
            if (!inside) v = make_float2(0.0f, 0.0f);
            *reinterpret_cast<float2*>(out + ((size_t)t * 4 + a) * M + m) = v;
          }
        }
      }
}

template <int G_, int NT_T_, int NT_M_, int BN_, int VZ_, int VW_>
struct FwdConf {
  static constexpr bool kMma = false;
  static constexpr int G = G_, NT_T = NT_T_, NT_M = NT_M_, BN = BN_, VZ = VZ_, VW = VW_;
  using K = FwdCfg<G, NT_T, NT_M, BN, VZ, VW>;
  static constexpr int BT = K::BT, BM = K::BM, PMAX = 0;
};
template <class K_>
struct FwdMma {
  static constexpr bool kMma = true;
  using K = K_;
  static constexpr int BT = K::BT, BM = K::BM, PMAX = K::PMAX;
};

template <class Cf, bool SPLIT>
auto fwd_kernel() {
  if constexpr (Cf::kMma)
    return conv_fwd_mma_kernel<typename Cf::K, SPLIT>;
  else
    return conv_fwd_kernel<Cf::G, Cf::NT_T, Cf::NT_M, Cf::BN, Cf::VZ, Cf::VW>;
}

// The most packed positions of the phases the tensor-core kernel takes (S <=
// 2: 4 phases of 16): its smem limit holds their inv rows and pass plan
constexpr int kMmaMaxC = 4 * kN2;

// forward block configurations, by number (engine.py's
// INSTANTIATIONS["conv_fused_engine"], in this order): 0 the fp32 CUDA-core
// kernel, which sums in the plain version's order: 32 tiles x 32 channels,
// 512 threads, for M % 4 == 0 and M >= 32, else 64 tiles x 4 channels, 128
// threads; cell windows in 16-byte copies and 16 (8) channel chunks when N
// % 4 == 0, else 4-byte copies and 4-channel chunks (conv0's RGB input).
// The tensor cores: 1, 64 tiles x 128 channels m, 16 warps of 32 x 16; 2,
// 64 x 64, 8 warps of 32 x 16; passes of at most 9 packed positions (one
// K4S2 phase).
template <class F>
int with_fwd_conf(int conf, int N, int M, F&& f) {
  if (conf == 1) return f(FwdMma<fwd::Core<2, 8, 2, 2, 9, 4, 1, 1>>{});
  if (conf == 2) return f(FwdMma<fwd::Core<2, 4, 2, 2, 9, 4, 1, 1>>{});
  const bool wide = M >= 32 && M % 4 == 0;
  if (N % 4 == 0) return wide ? f(FwdConf<8, 8, 8, 16, 4, 4>{}) : f(FwdConf<8, 16, 1, 8, 4, 1>{});
  return wide ? f(FwdConf<8, 8, 8, 4, 1, 4>{}) : f(FwdConf<8, 16, 1, 4, 1, 1>{});
}

// Whether forward instantiation conf takes (N, M, S^2): the tensor cores
// where N % 4 == 0, M % 4 == 0, M >= 16 and S^2 <= 4 (windows and weights in
// 16-byte copies: the wrapper has checked their alignment)
bool fwd_takes(int conf, int N, int M, int S2) {
  switch (conf) {
    case 0: return true;                                                // cuda_cores
    case 1: return N % 4 == 0 && M % 4 == 0 && M >= 16 && S2 <= 4;  // mma_64x128
    case 2: return N % 4 == 0 && M % 4 == 0 && M >= 16 && S2 <= 4;  // mma_64x64
  }
  return false;
}

// The plan's own choice: the tensor cores wherever they take the shape,
// 64 x 128 for M >= 128 (the fastest of three configurations timed on an
// H100 at DCGAN's conv1-3, PERF.md), else 64 x 64; the CUDA cores elsewhere
int fwd_default(int N, int M, int S2) {
  if (!fwd_takes(1, N, M, S2)) return 0;
  return M >= 128 ? 1 : 2;
}

// ============================================================== bwd_x
// The fp32 CUDA-core bwd_x, for few or ragged channels (M < 8 or M % 4 !=
// 0): G position groups x (NT_T x NT_N) threads; group g owns Winograd
// positions g, g + G, ... of the current phase; each thread a 4-tile x
// 4-channel micro tile; M in chunks of BM = 4 with 4-byte copies of g and ww.
template <int G, int NT_T, int NT_N>
struct BxCfg {
  static constexpr int BM = 4;
  static constexpr int PG = kN2 / G;
  static constexpr int kThreads = G * NT_T * NT_N;
  static constexpr int BT = NT_T * 4;        // tile slots per block
  static constexpr int BN = NT_N * 4;        // input channels per block
  static constexpr int GS = 4 * BM + 8;      // g_s row stride per tile
  static constexpr int XT = BT + 4;          // gw_s row stride
  static constexpr int kG = BT * GS;         // g rows, one stage
  static constexpr int kW = kN2 * BM * BN;   // ww slice [k][m][n], one stage
  static constexpr int kGw = kN2 * BM * XT;  // gw [pos][m][tile]
  static constexpr int kStage = 2 * (kG + kW) + kGw;
  static constexpr int kRed = kN2 * BT * BN;  // dXw, then dZ: [pos][tile][n]
  static constexpr int kBig = kStage > kRed ? kStage : kRed;
  static constexpr size_t kSmemBytes =
      sizeof(float) * (kBig + kMaxC * 4) + sizeof(int) * (2 * kMaxC + kMaxPhases + 1 + BT);
};

template <int G, int NT_T, int NT_N>
__global__ void __launch_bounds__(G * NT_T * NT_N)
conv_bwd_x_kernel(const float* __restrict__ g, const float* __restrict__ ww, const float* __restrict__ inv,
                  const int* __restrict__ pos, const int* __restrict__ phase_off, float* __restrict__ dcells,
                  int B, int gy, int gx, int N, int M, int S2, int ty, int tx, int R, int W, int TC, int ncb) {
  using K = BxCfg<G, NT_T, NT_N>;
  constexpr int PG = K::PG, BT = K::BT, BN = K::BN, BM = K::BM, GS = K::GS, XT = K::XT, NT = K::kThreads;
  extern __shared__ float4 smem4[];
  float* g_s = reinterpret_cast<float*>(smem4);  // 2 x [BT][GS]
  float* w_s = g_s + 2 * K::kG;                   // 2 x [16][BM][BN]
  float* gw_s = w_s + 2 * K::kW;                  // [16][BM][XT]
  float* red_s = g_s;                             // [16][BT][BN] after a phase's M loop
  float* inv_s = g_s + K::kBig;                   // [C][4]
  int* kmap_s = reinterpret_cast<int*>(inv_s + kMaxC * 4);  // [S2*16] Winograd pos -> k in phase, or -1
  int* pos_s = kmap_s + kMaxC;                    // [C] position within its phase
  int* off_s = pos_s + kMaxC;                     // [S2 + 1]
  int* tile_s = off_s + kMaxPhases + 1;           // [BT] flat tile index, -1 if none

  const int tid = threadIdx.x;
  const int grp = tid / (NT_T * NT_N);  // position group, uniform per warp
  const int rem = tid % (NT_T * NT_N);
  const int tt = rem / NT_N, tn = rem % NT_N;
  const int C = phase_off[S2];
  const int cs = S2 * 4;
  const int n0 = blockIdx.y * BN;
  const bwdx::CellBlock cb(blockIdx.x / ncb, blockIdx.x % ncb, B, gy, gx, ty, tx, R, W);

  for (int i = tid; i < C * 4; i += NT) inv_s[i] = inv[i];
  for (int i = tid; i < C; i += NT) pos_s[i] = pos[i] % kN2;
  for (int i = tid; i <= S2; i += NT) off_s[i] = phase_off[i];
  for (int i = tid; i < S2 * kN2; i += NT) kmap_s[i] = -1;
  for (int tl = tid; tl < BT; tl += NT) tile_s[tl] = cb.tile(tl, TC, tx);
  __syncthreads();
  for (int i = tid; i < C; i += NT) kmap_s[pos[i]] = i - off_s[pos[i] / kN2];
  __syncthreads();

  const int mchunks = (M + BM - 1) / BM;

  // one pipeline stage: the g rows of every tile slot for channels
  // [m0, m0 + BM), and ww[lo+k, n0:n0+BN, m0:m0+BM] transposed to [k][m][n]
  auto stage = [&](int buf, int lo, int cnt, int c) {
    const int m0 = c * BM;
    float* gd = g_s + buf * K::kG;
    for (int e = tid; e < BT * 4 * BM; e += NT) {
      const int mm = e % BM, a = (e / BM) % 4, tl = e / (BM * 4);
      const int t = tile_s[tl];
      const bool ok = t >= 0 && m0 + mm < M;
      cp_async<1>(gd + tl * GS + a * BM + mm, ok ? g + ((size_t)t * 4 + a) * M + m0 + mm : g, ok);
    }
    float* wd = w_s + buf * K::kW;
    for (int e = tid; e < cnt * BN * BM; e += NT) {
      const int mm = e % BM, nn = (e / BM) % BN, k = e / (BM * BN);
      const bool ok = n0 + nn < N && m0 + mm < M;
      cp_async<1>(wd + (k * BM + mm) * BN + nn, ok ? ww + ((size_t)(lo + k) * N + n0 + nn) * M + m0 + mm : ww,
                  ok);
    }
    cp_async_commit();
  };

  for (int s = 0; s < S2; ++s) {
    const int lo = off_s[s], cnt = off_s[s + 1] - lo;
    float acc[PG][4][4];
#pragma unroll
    for (int kk = 0; kk < PG; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[kk][i][j] = 0.0f;

    stage(0, lo, cnt, 0);
    if (mchunks > 1) stage(1, lo, cnt, 1);
    for (int c = 0; c < mchunks; ++c) {
      const int buf = c & 1;
      if (c + 1 < mchunks) cp_async_wait<1>(); else cp_async_wait<0>();
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
        const int k = kmap_s[s * kN2 + p];
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
      if (c + 2 < mchunks) stage(buf, lo, cnt, c + 2);
    }

    // dXw of every tile slot in shared memory, then dZ and the gather into
    // the phase's channel slots
#pragma unroll
    for (int kk = 0; kk < PG; ++kk) {
      const int p = kk * G + grp;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(red_s + (p * BT + tt * 4 + i) * BN + tn * 4) =
            make_float4(acc[kk][i][0], acc[kk][i][1], acc[kk][i][2], acc[kk][i][3]);
    }
    __syncthreads();
    bwdx::dz_gather<BT, BN, NT, BT * BN, BN>(red_s, cb, dcells, gy, gx, ty, tx, N, n0, TC, cs, s * 4);
    __syncthreads();  // red_s is the next phase's staging space
  }
}

// bwd_x on the tensor cores (bwd_x_core.cuh): one block per (cell block,
// N tile, phase s), the phases of one cell block and N tile adjacent in the
// launch (their blocks read the same g rows: once from device memory, then
// from L2).  Each phase is a problem of one sub-filter, its own positions
// [phase_off[s], phase_off[s+1]) and kmap, g's 4 rows a tile: bwdx::contract
// over it holds every Winograd position of the block's BT tile slots x BN
// channels in registers; dXw then goes to shared memory as [pos][slot][n],
// dZ = B dXw B^T, and the fixed-order gather into the phase's channel slots
// [4s, 4s + 4) (bwdx::dz_gather).  A block writes only its phase's slots: no
// sum across blocks.
template <class K>
__global__ void __launch_bounds__(K::kThreads, K::kMinBlocks)
conv_bwd_x_mma_kernel(const float* __restrict__ g, const float* __restrict__ ww, const float* __restrict__ inv,
                      const int* __restrict__ pos, const int* __restrict__ phase_off, float* __restrict__ dcells,
                      int B, int gy, int gx, int N, int M, int S2, int ty, int tx, int R, int W, int TC, int ncb) {
  constexpr int BT = K::BT, BN = K::BN, SS = BN + 4;  // dXw [pos][slot][SS]
  static_assert(16 * BT * SS <= K::kFloats, "dXw fits in the pipeline's shared memory");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);  // the pipeline, then dXw
  float* inv_s = smem + K::kFloats;               // [C][4]
  int* kmap_s = reinterpret_cast<int*>(inv_s + kMaxC * 4);  // [16] the phase's position -> k, or -1
  int* off_s = kmap_s + kN2;                       // the phase's [first, last + 1) packed positions
  int* tile_s = off_s + 2;                         // [BT] flat tile index, -1 if none

  const int n_nb = (N + BN - 1) / BN;
  const int s = blockIdx.x % S2, nb = blockIdx.x / S2 % n_nb, c = blockIdx.x / (S2 * n_nb);
  const bwdx::CellBlock cb(c / ncb, c % ncb, B, gy, gx, ty, tx, R, W);
  const int n0 = nb * BN, lo = phase_off[s], hi = phase_off[s + 1];
  const int tid = threadIdx.x;
  for (int i = lo * 4 + tid; i < hi * 4; i += K::kThreads) inv_s[i] = inv[i];
  for (int i = tid; i < kN2; i += K::kThreads) kmap_s[i] = -1;
  for (int tl = tid; tl < BT; tl += K::kThreads) tile_s[tl] = cb.tile(tl, TC, tx);
  if (tid == 0) off_s[0] = lo, off_s[1] = hi;
  __syncthreads();
  for (int i = lo + tid; i < hi; i += K::kThreads) kmap_s[pos[i] % kN2] = i - lo;
  __syncthreads();

  bwdx::Acc<K> acc;
  bwdx::contract<K>(acc, smem, g, ww, tile_s, inv_s, kmap_s, off_s, 1, M, N, n0);

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
  bwdx::dz_gather<BT, BN, K::kThreads, BT * SS, SS>(red, cb, dcells, gy, gx, ty, tx, N, n0, TC, S2 * 4, s * 4);
}

// The CUDA-core kernel's configurations
template <int G_, int NT_T_, int NT_N_>
struct BxConf {
  static constexpr bool kMma = false;
  static constexpr int G = G_, NT_T = NT_T_, NT_N = NT_N_;
  using K = BxCfg<G_, NT_T_, NT_N_>;
  static constexpr size_t kSmemBytes = K::kSmemBytes;
};

// The tensor-core kernel's: the pipeline (then dXw), inv, the phase's kmap
// and offsets, the tile slots
template <class K_>
struct BxMma {
  static constexpr bool kMma = true;
  using K = K_;
  static constexpr size_t kSmemBytes = sizeof(float) * (K::kFloats + kMaxC * 4) + sizeof(int) * (kN2 + 2 + K::BT);
};

// bwd_x block configurations, by number (engine.py's
// INSTANTIATIONS["conv_fused_engine_bwd_x"], in this order): 0 the fp32
// CUDA-core kernel: 64 tile slots x 32 channels, 512 threads, or for N <= 4,
// 128 tile slots x 4 channels, 128 threads.  The tensor cores, two position
// sets of 4 warps, each warp 8 positions (its colour of the 4x4
// checkerboard): 1, 128 slots x 16 n, each warp 16 n x 32 tiles (channels
// past N zero-filled); 2, 64 tile slots x 32 channels n a block, each warp 32
// n x 16 tiles.
template <class F>
int with_bx_conf(int conf, int N, F&& f) {
  if (conf == 1) return f(BxMma<bwdx::Core<16, 4, 1, 4, 8, 2>>{});
  if (conf == 2) return f(BxMma<bwdx::Core<16, 4, 2, 2, 8, 2>>{});
  return N > 4 ? f(BxConf<4, 16, 8>{}) : f(BxConf<4, 32, 1>{});
}

// Whether bwd_x instantiation conf takes M output channels: the tensor
// cores where M % 4 == 0 and M >= 8 (g and ww in 16-byte copies: the
// wrapper has checked their alignment)
bool bx_takes(int conf, int M) {
  switch (conf) {
    case 0: return true;                  // cuda_cores
    case 1: return M >= 8 && M % 4 == 0;  // mma_128x16
    case 2: return M >= 8 && M % 4 == 0;  // mma_64x32
  }
  return false;
}

// The plan's own choice: the tensor cores wherever they take M, 128 x 16
// for N <= 16 (conv0's RGB input), else 64 x 32: at every DCGAN layer the
// fastest of the block configurations timed on an H100 (PERF.md)
int bx_default(int N, int M) {
  if (!bx_takes(1, M)) return 0;
  return N <= 16 ? 1 : 2;
}

template <class Cf>
auto bx_kernel() {
  if constexpr (Cf::kMma)
    return conv_bwd_x_mma_kernel<typename Cf::K>;
  else
    return conv_bwd_x_kernel<Cf::G, Cf::NT_T, Cf::NT_N>;
}

// ============================================================== bwd_w
// G position groups x (NT_N x NT_M) threads; group g owns the packed
// positions k = g, g + G, ... of the block's phase; each thread a 4 (n) x 4
// (m) micro tile.  BT tiles per T chunk; VZ / VW: floats per window / g copy.
template <int G, int NT_N, int NT_M, int BT, int VZ, int VW>
struct BwCfg {
  static constexpr int PG = kN2 / G;
  static constexpr int kThreads = G * NT_N * NT_M;
  static constexpr int BN = NT_N * 4, BM = NT_M * 4;
  static constexpr int kZ = BT * 16 * BN;      // raw 4x4 windows, one stage
  static constexpr int kG = BT * 4 * BM;       // g rows, one stage
  static constexpr int kXw = kN2 * BT * BN;    // xw [pos][tile][n]
  static constexpr int kGw = kN2 * BT * BM;    // gw [k][tile][m]
  static constexpr int kRed = kN2 * BN * BM;   // one block's sums, in scratch
  static constexpr size_t kSmemBytes =
      sizeof(float) * (2 * (kZ + kG) + kXw + kGw + kN2 * 4) + sizeof(int) * kN2;
};

template <int G, int NT_N, int NT_M, int BT, int VZ, int VW, bool SPLIT>
__global__ void __launch_bounds__(G * NT_N * NT_M)
conv_bwd_w_kernel(const float* __restrict__ cells, const float* __restrict__ g, const float* __restrict__ inv,
                  const int* __restrict__ pos, const int* __restrict__ phase_off, float* __restrict__ dww,
                  int B, int Gy, int Gx, int N, int M, int S2, int ty, int tx, int splits,
                  float* __restrict__ partial, int* __restrict__ counters) {
  using K = BwCfg<G, NT_N, NT_M, BT, VZ, VW>;
  constexpr int PG = K::PG, BN = K::BN, BM = K::BM, NT = K::kThreads;
  extern __shared__ float4 smem4[];
  float* z_s = reinterpret_cast<float*>(smem4);  // 2 x [BT][16][BN]
  float* gr_s = z_s + 2 * K::kZ;                  // 2 x [BT][4][BM]
  float* xw_s = gr_s + 2 * K::kG;                 // [16][BT][BN]
  float* gw_s = xw_s + K::kXw;                    // [16][BT][BM]
  float* inv_s = gw_s + K::kGw;                   // [16][4]
  int* pos_s = reinterpret_cast<int*>(inv_s + kN2 * 4);

  const int n_nt = (N + BN - 1) / BN, n_mt = (M + BM - 1) / BM;
  const int grp_id = blockIdx.x;  // (phase s, N-tile, M-tile)
  const int s = grp_id / (n_nt * n_mt);
  const int nt = (grp_id / n_mt) % n_nt, mt = grp_id % n_mt;
  const int n0 = nt * BN, m0 = mt * BM;
  const int ks = SPLIT ? blockIdx.y : 0;
  const int lo = phase_off[s], cnt = phase_off[s + 1] - lo;
  const int tid = threadIdx.x;
  const int gq = tid / (NT_N * NT_M);  // position group, uniform per warp
  const int rem = tid % (NT_N * NT_M);
  const int tn = rem / NT_M, tm = rem % NT_M;
  const int T = B * ty * tx, tpi = ty * tx;
  const int cs = S2 * 4;

  for (int i = tid; i < kN2 * 4; i += NT) inv_s[i] = (i / 4 < cnt) ? inv[(lo + i / 4) * 4 + i % 4] : 0.0f;
  for (int i = tid; i < kN2; i += NT) pos_s[i] = i < cnt ? pos[lo + i] % kN2 : 0;
  __syncthreads();

  // this block's share of the T loop: chunks [c_lo, c_lo + n_chunks)
  const int nsplit = SPLIT ? splits : 1;
  const int all_chunks = (T + BT - 1) / BT;
  const int c_lo = (int)((long long)ks * all_chunks / nsplit);
  const int n_chunks = cnt > 0 ? (int)((long long)(ks + 1) * all_chunks / nsplit) - c_lo : 0;

  // one pipeline stage: the raw 4x4 phase-s window of every tile of the
  // chunk and its g rows for this M-tile
  auto stage = [&](int buf, int chunk) {
    const int t0 = chunk * BT;
    float* zd = z_s + buf * K::kZ;
    constexpr int kZv = BT * 16 * BN / VZ;
    for (int e = tid; e < kZv; e += NT) {
      const int nl = (e % (BN / VZ)) * VZ, zi = (e / (BN / VZ)) % 16, tl = e / (16 * (BN / VZ));
      const int t = t0 + tl, n = n0 + nl;
      const bool ok = t < T && n < N;
      size_t off = 0;
      if (ok) {
        const int b = t / tpi, rm = t - b * tpi, jy = rm / tx, jx = rm - jy * tx;
        const int a = zi / 4, cc = zi % 4;
        const size_t base = (size_t)(b * Gy + jy) * Gx + jx;
        off = ((base + (a / 2) * Gx + cc / 2) * cs + s * 4 + (a % 2) * 2 + cc % 2) * N + n;
      }
      cp_async<VZ>(zd + (tl * 16 + zi) * BN + nl, cells + off, ok);
    }
    float* gd = gr_s + buf * K::kG;
    constexpr int kGv = BT * 4 * BM / VW;
    for (int e = tid; e < kGv; e += NT) {
      const int mm = (e % (BM / VW)) * VW, a = (e / (BM / VW)) % 4, tl = e / (BM / VW * 4);
      const int t = t0 + tl;
      const bool ok = t < T && m0 + mm < M;
      cp_async<VW>(gd + (tl * 4 + a) * BM + mm, ok ? g + ((size_t)t * 4 + a) * M + m0 + mm : g, ok);
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

    // pre-PE: xw_s[pos][tile][n]
    const float* zb = z_s + buf * K::kZ;
    for (int it = tid; it < BT * BN; it += NT) {
      const int nl = it % BN, tl = it / BN;
      float z[4][4], x[4][4];
#pragma unroll
      for (int zi = 0; zi < 16; ++zi) z[zi / 4][zi % 4] = zb[(tl * 16 + zi) * BN + nl];
      bt_z_b(z, x);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) xw_s[((u * 4 + v) * BT + tl) * BN + nl] = x[u][v];
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
        gw_s[(k * BT + tl) * BM + mm] = fmaf(iv[0], gv[0], fmaf(iv[1], gv[1], fmaf(iv[2], gv[2], iv[3] * gv[3])));
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
    // arrive adds them in split order (deterministic), writes dww and leaves
    // the group's counter at 0 for the next launch
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
// p, N tile, M tile) and T split, xw formed at p's Winograd position q =
// pos[p] % 16 only, from the four window planes of p's phase s = pos[p] / 16
// that q reads (bwdw::window_block): the conv corner's cells hold the S^2
// phases, 4 rows each, so an entry sits at row 4s + 2(a&1) + (c&1) of its
// cell of 4 S^2 rows; g is one sub-filter, the tile's 4 rows.
template <class K, bool SPLIT>
__global__ void __launch_bounds__(K::kThreads, 1)
conv_bwd_w_mma_kernel(const float* __restrict__ cells, const float* __restrict__ g, const float* __restrict__ inv,
                      const int* __restrict__ pos, const int* __restrict__ phase_off, float* __restrict__ dww,
                      int B, int Gy, int Gx, int N, int M, int S2, int ty, int tx, int splits,
                      float* __restrict__ partial, int* __restrict__ counters) {
  const int n_nt = (N + K::BN - 1) / K::BN, n_mt = (M + K::BM - 1) / K::BM;
  const int grp = blockIdx.x, p = grp / (n_nt * n_mt), q = pos[p];
  bwdw::window_block<K, SPLIT, true>(cells, g, inv, dww, grp, p, q % kN2, (grp / n_mt) % n_nt * K::BN,
                                     grp % n_mt * K::BM, SPLIT ? blockIdx.y : 0, S2, q / kN2, B, Gy, Gx, N, M, ty,
                                     tx, splits, partial, counters);
}

// The CUDA-core kernel's configurations
template <int G_, int NT_N_, int NT_M_, int BT_, int VZ_, int VW_>
struct BwConf {
  static constexpr bool kMma = false;
  static constexpr int G = G_, NT_N = NT_N_, NT_M = NT_M_, BT = BT_, VZ = VZ_, VW = VW_;
  using K = BwCfg<G, NT_N, NT_M, BT, VZ, VW>;
};
// The tensor-core kernel's: a bwdw::Core
template <class K_>
struct BwMma {
  static constexpr bool kMma = true;
  static constexpr int BT = K_::BT;
  using K = K_;
};

// bwd_w block configurations, by number (engine.py's
// INSTANTIATIONS["conv_fused_engine_bwd_w"], in this order): 0 the fp32
// CUDA-core kernel: 64 x 4 (n, m), 128 threads, 4 tiles a chunk (N % 4 == 0);
// for N % 4 != 0 (conv0's RGB input), 4-channel n tiles with 4-byte window
// copies: 4 x 64 (128 threads) or, for few or ragged M, 4 x 16 (32 threads),
// 8 tiles a chunk.  The tensor cores: 1, 128 n x 128 m, 8 warps of 64 x 32,
// 16 tiles a chunk; 2, 128 x 128, 4 warps of 64 x 64, 8 tiles; 3, 64 x 128, 4
// warps of 64 x 32, 8 tiles.
template <class F>
int with_bw_conf(int conf, int N, int M, F&& f) {
  if (conf == 1) return f(BwMma<bwdw::Core<2, 4, 4, 4, 16, 4, 4>>{});
  if (conf == 2) return f(BwMma<bwdw::Core<2, 2, 4, 8, 8, 4, 4>>{});
  if (conf == 3) return f(BwMma<bwdw::Core<1, 4, 4, 4, 8, 4, 4>>{});
  const bool wide = M >= 16 && M % 4 == 0;
  if (N % 4 == 0) return f(BwConf<8, 16, 1, 4, 4, 1>{});
  return wide ? f(BwConf<8, 1, 16, 8, 1, 4>{}) : f(BwConf<8, 1, 4, 8, 1, 1>{});
}

// Whether bwd_w instantiation conf takes (N, M): the tensor cores where N %
// 4 == 0, M % 4 == 0 and M >= 16 (windows and g rows in 16-byte copies: the
// wrapper has checked their alignment)
bool bw_takes(int conf, int N, int M) {
  switch (conf) {
    case 0: return true;                                 // cuda_cores
    case 1: return N % 4 == 0 && M % 4 == 0 && M >= 16;  // mma_128x128_t16
    case 2: return N % 4 == 0 && M % 4 == 0 && M >= 16;  // mma_128x128_t8
    case 3: return N % 4 == 0 && M % 4 == 0 && M >= 16;  // mma_64x128
  }
  return false;
}

// The plan's own choice: the tensor cores wherever they take the shape, the
// block tile by N, each the fastest of the configurations timed on an H100
// at DCGAN's conv1-3 (PERF.md): 1 for N > 128 (conv3, T = 512 tiles), 2 for
// N > 64 (conv2), 3 else (conv1).  The CUDA cores elsewhere (the tensor
// cores at conv0, with 4-byte window copies, ran slower than this kernel on
// an H100 (PERF.md): the grid of one block per packed position reads g 36
// times, the CUDA-core grid of one per phase 4 times).
int bw_default(int N, int M) {
  if (!bw_takes(1, N, M)) return 0;
  return N > 128 ? 1 : N > 64 ? 2 : 3;
}

// The bwd_w kernel of configuration Cf, with or without the T split
template <class Cf, bool SPLIT>
auto bw_kernel() {
  if constexpr (Cf::kMma)
    return conv_bwd_w_mma_kernel<typename Cf::K, SPLIT>;
  else
    return conv_bwd_w_kernel<Cf::G, Cf::NT_N, Cf::NT_M, Cf::BT, Cf::VZ, Cf::VW, SPLIT>;
}

}  // namespace

// Plain C entry points (bound with ctypes).  Every pointer is a device
// pointer.  pos (C,) holds each packed position's index into the S2*16
// phase-major Winograd space, phase_off (S2 + 1,) each phase's first packed
// position.

// The forward's block configuration for (N, M, S^2): want -1 takes the
// plan's (fwd_default), want >= 0 asks for that instantiation (fwd_takes'
// numbering): a request the shape cannot take returns
// cudaErrorInvalidValue.  tile gets (BT, BM, the most packed positions a
// pass, the instantiation: 0 the CUDA cores, 1 or 2 the tensor cores).  The
// caller plans the tensor-core kernel's passes with it
// (engine.py::_fwd_passes, the phases as groups, one a pass) before
// conv_engine_fwd_plan.
extern "C" int conv_engine_fwd_conf(int N, int M, int S2, int want, int* tile) {
  const int conf = want < 0 ? fwd_default(N, M, S2) : want;
  if (!fwd_takes(conf, N, M, S2)) return (int)cudaErrorInvalidValue;
  return with_fwd_conf(conf, N, M, [&](auto cf) {
    using Cf = decltype(cf);
    tile[0] = Cf::BT;
    tile[1] = Cf::BM;
    tile[2] = Cf::PMAX;
    tile[3] = conf;
    return 0;
  });
}

// The forward's plan for B images of ty x tx tiles on instantiation want
// (as conv_engine_fwd_conf takes it): on the tensor cores the split of its
// npass passes (nslot / npos: the most Winograd / packed positions of a
// pass; C packed positions) over blocks, from the card's resident blocks at
// this plan's own shared memory: the count that minimises the waves over
// the block slots times the work a block (1/k), times 25% an extra split for
// the partials' round trip; want_splits >= 1 asks for that many (at most
// npass; the CUDA cores run unsplit): a request the shape cannot take
// returns cudaErrorInvalidValue.  scratch_floats / counters are 0 unsplit.
// Also raises the configuration's shared-memory limit on the current device
// (to the most any launch of it takes): call it before the first launch for
// this shape.
extern "C" int conv_engine_fwd_plan(int B, int ty, int tx, int N, int M, int S2, int C, int npass, int nslot,
                                    int npos, int want, int want_splits, int device, int* splits,
                                    long long* scratch_floats, long long* counters) {
  const int conf = want < 0 ? fwd_default(N, M, S2) : want;
  if (!fwd_takes(conf, N, M, S2) || (want_splits > 1 && (conf == 0 || want_splits > npass)))
    return (int)cudaErrorInvalidValue;
  return with_fwd_conf(conf, N, M, [&](auto cf) {
    using Cf = decltype(cf);
    using K = typename Cf::K;
    *splits = 1;
    *scratch_floats = *counters = 0;
    if constexpr (!Cf::kMma) {
      return (int)cudaFuncSetAttribute(fwd_kernel<Cf, false>(), cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)K::kSmemBytes);
    } else {
      const int most = (int)fwd::smem_2d<K>(kMmaMaxC, 2 * 4, K::PMAX, K::PMAX);
      const auto k0 = fwd_kernel<Cf, false>(), k1 = fwd_kernel<Cf, true>();
      cudaError_t err = cudaFuncSetAttribute(k0, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
      if (err == cudaSuccess) err = cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
      int occ = 0, sms = 0;
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, k1, K::kThreads,
                                                            fwd::smem_2d<K>(C, npass, nslot, npos));
      if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
      if (err != cudaSuccess) return (int)err;
      const long long slots = (long long)(occ > 0 ? occ : 1) * sms;
      const long long groups = (long long)((B * ty * tx + K::BT - 1) / K::BT) * ((M + K::BM - 1) / K::BM);
      int best = 1;
      double best_cost = (double)((groups + slots - 1) / slots);
      for (int k = 2; k <= npass; ++k) {
        const double cost = (double)((groups * k + slots - 1) / slots) / k * (1.0 + 0.25 * (k - 1));
        if (cost < best_cost - 1e-9) best = k, best_cost = cost;
      }
      if (want_splits >= 1) best = want_splits;
      *splits = best;
      *scratch_floats = best > 1 ? groups * best * K::kY * K::kThreads : 0;
      *counters = best > 1 ? groups : 0;
      return 0;
    }
  });
}

// One forward launch: cells (B, Gy, Gx, S2*4, N), ww (C, N, M), inv (C, 4)
// -> out (B, out_h, out_w, M) (out_mode 0) or (B, ty, tx, 4, M) (out_mode 1).
// scale and bias may be null; act: 0 none, 1 relu, 2 leaky_relu, 3 tanh.
// conf: the instantiation conv_engine_fwd_conf handed out.  The tensor-core
// kernel reads fplan (the pass plan of the C packed positions, npass /
// nslot / npos as conv_engine_fwd_plan took them) and, split, partial and
// counters from that plan (the counters zero on entry; the kernel leaves
// them zero); the CUDA-core kernel pos and phase_off.  Returns
// cudaGetLastError().
extern "C" int conv_engine_fwd_f32(const float* cells, const float* ww, const float* inv, const int* pos,
                                   const int* phase_off, const int* fplan, const float* scale, const float* bias,
                                   float* out, int B, int Gy, int Gx, int N, int M, int S2, int ty, int tx,
                                   int out_h, int out_w, int out_mode, int act, int C, int conf, int npass,
                                   int nslot, int npos, int splits, float* partial, int* counters, void* stream) {
  if (!fwd_takes(conf, N, M, S2)) return (int)cudaErrorInvalidValue;
  return with_fwd_conf(conf, N, M, [&](auto cf) {
    using Cf = decltype(cf);
    using K = typename Cf::K;
    const int T = B * ty * tx;
    const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    if constexpr (Cf::kMma) {
      const dim3 grid((T + K::BT - 1) / K::BT, ((M + K::BM - 1) / K::BM) * splits);
      const auto kernel = splits > 1 ? fwd_kernel<Cf, true>() : fwd_kernel<Cf, false>();
      kernel<<<grid, K::kThreads, fwd::smem_2d<K>(C, npass, nslot, npos), st>>>(
          cells, ww, inv, fplan, scale, bias, out, B, Gy, Gx, N, M, S2, ty, tx, out_h, out_w, out_mode, act, npass,
          nslot, npos, splits, partial, counters);
    } else {
      dim3 grid((T + K::BT - 1) / K::BT, (M + K::BM - 1) / K::BM);
      fwd_kernel<Cf, false>()<<<grid, K::kThreads, K::kSmemBytes, st>>>(cells, ww, inv, pos, phase_off, scale, bias,
                                                                       out, B, Gy, Gx, N, M, S2, ty, tx, out_h,
                                                                       out_w, out_mode, act);
    }
    return (int)cudaGetLastError();
  });
}

// bwd_x geometry (bwdx::cell_geometry): a block covers R cell rows (rows of
// all B images end to end) by W cell columns; its BT tile slots are TC tile
// columns by BT/TC tile rows.  want -1 takes the plan's instantiation
// (bx_default), want >= 0 asks for that one (bx_takes' numbering): a request
// M cannot take returns cudaErrorInvalidValue.  tile gets (BT, BN channels n
// a block, the instantiation: 0 the CUDA cores, 1 or 2 the tensor cores),
// which conv_engine_bwd_x_f32 takes as conf.  Also raises the kernel's
// shared-memory limit on the current device (call it before the first
// launch for this (N, M)).
extern "C" int conv_engine_bwd_x_plan(int B, int gy, int gx, int ty, int tx, int N, int M, int want, int* R, int* W,
                                      int* TC, int* tile) {
  const int conf = want < 0 ? bx_default(N, M) : want;
  if (!bx_takes(conf, M)) return (int)cudaErrorInvalidValue;
  return with_bx_conf(conf, N, [&](auto cf) {
    using Cf = decltype(cf);
    using K = typename Cf::K;
    cudaError_t err =
        cudaFuncSetAttribute(bx_kernel<Cf>(), cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Cf::kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    bwdx::cell_geometry(B, gy, gx, ty, tx, K::BT, R, W, TC);
    tile[0] = K::BT;
    tile[1] = K::BN;
    tile[2] = conf;
    return 0;
  });
}

// One bwd_x launch: g (B, ty, tx, 4, M), ww (C, N, M), inv (C, 4) -> dcells
// (B, gy, gx, S2*4, N), every element written.  R, W, TC and conf from
// conv_engine_bwd_x_plan; where conf runs the tensor cores, g and ww start on
// 16-byte boundaries.  Returns cudaGetLastError().
extern "C" int conv_engine_bwd_x_f32(const float* g, const float* ww, const float* inv, const int* pos,
                                     const int* phase_off, float* dcells, int B, int gy, int gx, int N, int M,
                                     int S2, int ty, int tx, int R, int W, int TC, int conf, void* stream) {
  if (!bx_takes(conf, M)) return (int)cudaErrorInvalidValue;
  return with_bx_conf(conf, N, [&](auto cf) {
    using Cf = decltype(cf);
    using K = typename Cf::K;
    const int cblocks = ((B * gy + R - 1) / R) * ((gx + W - 1) / W), ncb = (gx + W - 1) / W;
    const int n_nb = (N + K::BN - 1) / K::BN;
    // the tensor-core kernel: a block per (cell block, N tile, phase), phase fastest
    const dim3 grid = Cf::kMma ? dim3(cblocks * n_nb * S2) : dim3(cblocks, n_nb);
    bx_kernel<Cf>()<<<grid, K::kThreads, Cf::kSmemBytes, reinterpret_cast<cudaStream_t>(stream)>>>(
        g, ww, inv, pos, phase_off, dcells, B, gy, gx, N, M, S2, ty, tx, R, W, TC, ncb);
    return (int)cudaGetLastError();
  });
}

// bwd_w plan: the T-loop split and the block tile for this shape.  The
// tensor-core kernel runs a block per (packed position, N tile, M tile)
// group and splits T by bwdw::plan_splits; the CUDA-core kernel a block per
// (phase, N tile, M tile), split over as many blocks as fill the card's
// resident block slots once, at least 4 chunks a split.  want -1 takes the
// plan's instantiation (bw_default), want >= 0 asks for that one (bw_takes'
// numbering), want_splits >= 1 for that T split (at most the T chunks and
// 65535): a request the shape cannot take returns cudaErrorInvalidValue.
// scratch_floats / counters are 0 when the split count is 1; tile gets (BN,
// BM, BT, the instantiation: 0 the CUDA cores, 1-3 the tensor cores), which
// conv_engine_bwd_w_f32 takes as conf.  Also raises both variants'
// shared-memory limit on the current device (call it before the first
// launch for this shape).
extern "C" int conv_engine_bwd_w_plan(int B, int ty, int tx, int N, int M, int S2, int C, int want, int want_splits,
                                      int device, int* splits, long long* scratch_floats, long long* counters,
                                      int* tile) {
  const int conf = want < 0 ? bw_default(N, M) : want;
  if (!bw_takes(conf, N, M)) return (int)cudaErrorInvalidValue;
  return with_bw_conf(conf, N, M, [&](auto cf) {
    using Cf = decltype(cf);
    using K = typename Cf::K;
    const long long chunks = ((long long)B * ty * tx + Cf::BT - 1) / Cf::BT;
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
    tile[2] = Cf::BT;
    tile[3] = conf;
    return 0;
  });
}

// One bwd_w launch: cells (B, Gy, Gx, S2*4, N), g (B, ty, tx, 4, M),
// inv (C, 4) -> dww (C, N, M), every element written.  C the packed
// positions; conf, splits, partial and counters from conv_engine_bwd_w_plan
// with the same shape; the counters are zero on entry and the kernel leaves
// them zero; where N % 4 == 0, cells (and g where M % 4 == 0 and M >= 16)
// start on 16-byte boundaries.  Returns cudaGetLastError().
extern "C" int conv_engine_bwd_w_f32(const float* cells, const float* g, const float* inv, const int* pos,
                                     const int* phase_off, float* dww, int B, int Gy, int Gx, int N, int M,
                                     int S2, int ty, int tx, int C, int conf, int splits, float* partial,
                                     int* counters, void* stream) {
  if (!bw_takes(conf, N, M)) return (int)cudaErrorInvalidValue;
  return with_bw_conf(conf, N, M, [&](auto cf) {
    using Cf = decltype(cf);
    using K = typename Cf::K;
    const int tiles = ((N + K::BN - 1) / K::BN) * ((M + K::BM - 1) / K::BM);
    // a block per (packed position or, on the CUDA cores, phase, N tile, M tile) and split
    const dim3 grid((Cf::kMma ? C : S2) * tiles, splits);
    auto kernel = splits > 1 ? bw_kernel<Cf, true>() : bw_kernel<Cf, false>();
    kernel<<<grid, K::kThreads, K::kSmemBytes, reinterpret_cast<cudaStream_t>(stream)>>>(
        cells, g, inv, pos, phase_off, dww, B, Gy, Gx, N, M, S2, ty, tx, splits, partial, counters);
    return (int)cudaGetLastError();
  });
}
