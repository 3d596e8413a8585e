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
// What bounds them on an H100: the products, 2*T*C*N*M flops each on the
// fp32 CUDA cores (67 TFLOP/s), at DCGAN's first three layers; at the RGB
// layer (M = 3) the bytes of xw (fwd, bwd_w) and of dxw (bwd_x), 16*T*N
// floats each, 303 MB at batch 128.
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
//   * bwd_x: one block per (T-tile, N-tile); a loop over (sub-filter,
//     M-chunk) stages g and the sub-filter's weights, folds gw in shared
//     memory and accumulates per Winograd position, so the packed positions
//     that share a Winograd position add in one fixed order (sub-filter
//     order, then m): no atomics, deterministic.  Every position of every
//     tile is written, zeros included: the output is not pre-zeroed;
//   * bwd_w: one block per (sub-filter, N-tile, M-tile) looping over T in
//     chunks, xw and g by cp.async; the long, thin T loop of the RGB layer
//     (36992 tiles for 128 x 3 channels at batch 128) splits over blocks with
//     the deterministic last-block sum;
//   * M = 3 rules out 16-byte copies and stores of g, weights and outputs:
//     those paths take 4-byte copies; xw and dxw move in 16-byte copies
//     (N % 4 == 0).
// wgmma (3xTF32), TMA and one gw pass shared by both backward kernels are
// later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPos = 16;  // n*n Winograd positions of F(2,3); xw's row count
constexpr int kMaxSub = 16;  // S^2 sub-filters, S <= 4

__device__ __forceinline__ void cp_async(float* dst, const float* src, bool pred, int bytes_vec) {
  // global -> shared without passing through registers; pred false
  // zero-fills the destination without reading src
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
// G position groups x (NT_T x NT_N) threads; group g owns Winograd positions
// g, g + G, ...; each thread a 4-tile x 4-channel micro tile.  BM: the M
// chunk; VW: 4 for 16-byte g copies (M % 4 == 0), 1 for 4-byte copies.
template <int G, int NT_T, int NT_N, int BM, int VW>
struct BxCfg {
  static constexpr int PG = kMaxPos / G;
  static constexpr int kThreads = G * NT_T * NT_N;
  static constexpr int BT = NT_T * 4;       // tiles per block
  static constexpr int BN = NT_N * 4;       // input channels per block
  static constexpr int GS = 4 * BM + 8;     // g_s row stride per tile: 16-byte aligned, skewed banks
  static constexpr int XT = BT + 4;         // gw_s row stride
  static constexpr int kG = BT * GS;        // g rows, one stage
  static constexpr int kW = kMaxPos * BM * BN;  // ww slice [k][m][n], one stage
  static constexpr int kGw = kMaxPos * BM * XT;  // gw [pos][m][tile]
  static constexpr int kStage = 2 * (kG + kW) + kGw;
  static constexpr int kMaxC = kMaxPos * kMaxSub;
  static constexpr size_t kSmemBytes =
      sizeof(float) * (kStage + kMaxC * 4) + sizeof(int) * (kMaxSub * kMaxPos + kMaxC + kMaxSub + 1);
};

template <int G, int NT_T, int NT_N, int BM, int VW>
__global__ void __launch_bounds__(G * NT_T * NT_N)
domain_bwd_x_kernel(const float* __restrict__ g, const float* __restrict__ ww, const float* __restrict__ inv,
                    const int* __restrict__ pos, const int* __restrict__ sub_off, float* __restrict__ dxw,
                    int T, int N, int M, int S2) {
  using K = BxCfg<G, NT_T, NT_N, BM, VW>;
  constexpr int PG = K::PG, BT = K::BT, BN = K::BN, GS = K::GS, XT = K::XT, NT = K::kThreads;
  extern __shared__ float4 smem4[];
  float* g_s = reinterpret_cast<float*>(smem4);  // 2 x [BT][GS]
  float* w_s = g_s + 2 * K::kG;                   // 2 x [16][BM][BN]
  float* gw_s = w_s + 2 * K::kW;                  // [16][BM][XT]
  float* inv_s = g_s + K::kStage;                 // [C][4]
  int* kmap_s = reinterpret_cast<int*>(inv_s + K::kMaxC * 4);  // [S^2][16] pos -> k or -1
  int* pos_s = kmap_s + kMaxSub * kMaxPos;        // [C]
  int* off_s = pos_s + K::kMaxC;                  // [S^2 + 1]

  const int tid = threadIdx.x;
  const int grp = tid / (NT_T * NT_N);  // position group, uniform per warp
  const int rem = tid % (NT_T * NT_N);
  const int tt = rem / NT_N, tn = rem % NT_N;
  const int C = sub_off[S2];
  const int t0 = blockIdx.x * BT, n0 = blockIdx.y * BN;

  for (int i = tid; i < C * 4; i += NT) inv_s[i] = inv[i];
  for (int i = tid; i < C; i += NT) pos_s[i] = pos[i];
  for (int i = tid; i <= S2; i += NT) off_s[i] = sub_off[i];
  for (int i = tid; i < kMaxSub * kMaxPos; i += NT) kmap_s[i] = -1;
  __syncthreads();
  for (int s = tid; s < S2; s += NT)
    for (int k = 0; k < off_s[s + 1] - off_s[s]; ++k) kmap_s[s * kMaxPos + pos_s[off_s[s] + k]] = k;
  __syncthreads();

  const int mchunks = (M + BM - 1) / BM;
  const int nchunks = S2 * mchunks;
  const int s2m2 = S2 * 4;

  // one pipeline stage: the g rows of sub-filter s for every tile, and
  // ww[lo+k, n0:n0+BN, m0:m0+BM] transposed to [k][m][n]; ragged edges
  // zero-filled
  auto stage = [&](int buf, int c) {
    const int s = c / mchunks, m0 = (c % mchunks) * BM;
    const int lo = off_s[s], cnt = off_s[s + 1] - lo;
    float* gd = g_s + buf * K::kG;
    constexpr int kGv = BT * 4 * BM / VW;
    for (int e = tid; e < kGv; e += NT) {
      const int mm = (e % (BM / VW)) * VW, a = (e / (BM / VW)) % 4, tl = e / (BM / VW * 4);
      const int t = t0 + tl;
      const bool ok = t < T && m0 + mm < M;
      const float* src = ok ? g + ((size_t)t * s2m2 + s * 4 + a) * M + m0 + mm : g;
      cp_async(gd + tl * GS + a * BM + mm, src, ok, 4 * VW);
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
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + tt * 4 + i, n = n0 + tn * 4;
      if (t >= T || n >= N) continue;
      float* o = dxw + ((size_t)t * kMaxPos + p) * N + n;
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

// ============================================================== bwd_w
// G position groups x (NT_N x NT_M) threads; group g owns the packed
// positions k = g, g + G, ... of the block's sub-filter; each thread a
// 4-channel (n) x 4-channel (m) micro tile.  BT tiles per T chunk.
template <int G, int NT_N, int NT_M, int BT, int VW>
struct BwCfg {
  static constexpr int PG = kMaxPos / G;
  static constexpr int kThreads = G * NT_N * NT_M;
  static constexpr int BN = NT_N * 4;
  static constexpr int BM = NT_M * 4;
  static constexpr int kX = kMaxPos * BT * BN;   // xw [k][tile][n], one stage
  static constexpr int kG = BT * 4 * BM;        // g rows, one stage
  static constexpr int kGw = kMaxPos * BT * BM;  // gw [k][tile][m]
  static constexpr int kRed = kMaxPos * BN * BM;  // one block's sums, in scratch
  static constexpr size_t kSmemBytes =
      sizeof(float) * (2 * (kX + kG) + kGw + kMaxPos * 4) + sizeof(int) * kMaxPos;
};

template <int G, int NT_N, int NT_M, int BT, int VW, bool SPLIT>
__global__ void __launch_bounds__(G * NT_N * NT_M)
domain_bwd_w_kernel(const float* __restrict__ xw, const float* __restrict__ g, const float* __restrict__ inv,
                    const int* __restrict__ pos, const int* __restrict__ sub_off, float* __restrict__ dww,
                    int T, int N, int M, int S2, int splits, float* __restrict__ partial,
                    int* __restrict__ counters) {
  using K = BwCfg<G, NT_N, NT_M, BT, VW>;
  constexpr int PG = K::PG, BN = K::BN, BM = K::BM, NT = K::kThreads;
  extern __shared__ float4 smem4[];
  float* x_s = reinterpret_cast<float*>(smem4);  // 2 x [16][BT][BN]
  float* gr_s = x_s + 2 * K::kX;                  // 2 x [BT][4][BM]
  float* gw_s = gr_s + 2 * K::kG;                 // [16][BT][BM]
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
  const int s2m2 = S2 * 4;

  if (tid < kMaxPos * 4) inv_s[tid] = (tid / 4 < cnt) ? inv[(lo + tid / 4) * 4 + tid % 4] : 0.0f;
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
      const float* src = ok ? xw + ((size_t)t * kMaxPos + pos_s[k]) * N + n : xw;
      cp_async(xd + (k * BT + tl) * BN + nl, src, ok, 16);
    }
    float* gd = gr_s + buf * K::kG;
    constexpr int kGv = BT * 4 * BM / VW;
    for (int e = tid; e < kGv; e += NT) {
      const int mm = (e % (BM / VW)) * VW, a = (e / (BM / VW)) % 4, tl = e / (BM / VW * 4);
      const int t = t0 + tl;
      const bool ok = t < T && m0 + mm < M;
      const float* src = ok ? g + ((size_t)t * s2m2 + s * 4 + a) * M + m0 + mm : g;
      cp_async(gd + (tl * 4 + a) * BM + mm, src, ok, 4 * VW);
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

template <int G_, int NT_T_, int NT_N_, int BM_, int VW_>
struct BxConf {
  static constexpr int G = G_, NT_T = NT_T_, NT_N = NT_N_, BM = BM_, VW = VW_;
  using K = BxCfg<G, NT_T, NT_N, BM, VW>;
};
#define BX_KERNEL(C) domain_bwd_x_kernel<C::G, C::NT_T, C::NT_N, C::BM, C::VW>

// bwd_x block configuration for M: 64 tiles x 32 channels n per block, 4
// position groups, 512 threads; M in chunks of 8 with 16-byte g copies, or
// chunks of 4 with 4-byte copies for few or ragged channels (RGB).
template <class F>
int with_bx_conf(int M, F&& f) {
  if (M >= 8 && M % 4 == 0) return f(BxConf<4, 16, 8, 8, 4>{});
  return f(BxConf<4, 16, 8, 4, 1>{});
}

template <int G_, int NT_N_, int NT_M_, int BT_, int VW_>
struct BwConf {
  static constexpr int G = G_, NT_N = NT_N_, NT_M = NT_M_, BT = BT_, VW = VW_;
  using K = BwCfg<G, NT_N, NT_M, BT, VW>;
};
#define BW_KERNEL(C, SPLIT) domain_bwd_w_kernel<C::G, C::NT_N, C::NT_M, C::BT, C::VW, SPLIT>

// bwd_w block configuration for M: 32 x 32 (n, m) per block, 8 position
// groups, 512 threads, 8 tiles per T chunk, 16-byte g copies; or, for few
// or ragged M (RGB), 64 x 4 per block, 128 threads, 4 tiles per chunk and
// 4-byte g copies.
template <class F>
int with_bw_conf(int M, F&& f) {
  if (M >= 16 && M % 4 == 0) return f(BwConf<8, 8, 8, 8, 4>{});
  return f(BwConf<8, 16, 1, 4, 1>{});
}

}  // namespace

// Plain C entry points (bound with ctypes).  Every pointer is a device
// pointer; xw and dxw are (T, 16, N), g and y are (T, S2*4, M), ww and dww
// (C, N, M), inv (C, 4), pos (C,), sub_off (S2 + 1,).  The plan functions
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

extern "C" int domain_engine_bwd_x_plan(int M) {
  return with_bx_conf(M, [&](auto conf) {
    using C = decltype(conf);
    return (int)cudaFuncSetAttribute(BX_KERNEL(C), cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)C::K::kSmemBytes);
  });
}

// One bwd_x launch: g, ww -> dxw (T, 16, N), every element written.
extern "C" int domain_engine_bwd_x_f32(const float* g, const float* ww, const float* inv, const int* pos,
                                       const int* sub_off, float* dxw, int T, int N, int M, int S2,
                                       void* stream) {
  return with_bx_conf(M, [&](auto conf) {
    using C = decltype(conf);
    using K = typename C::K;
    dim3 grid((T + K::BT - 1) / K::BT, (N + K::BN - 1) / K::BN);
    BX_KERNEL(C)<<<grid, K::kThreads, K::kSmemBytes, reinterpret_cast<cudaStream_t>(stream)>>>(
        g, ww, inv, pos, sub_off, dxw, T, N, M, S2);
    return (int)cudaGetLastError();
  });
}

// bwd_w split plan: the T loop is split over as many blocks per (sub-filter,
// N-tile, M-tile) group as fill the card's resident block slots once, with
// at least 4 chunks per split (fused_engine_bwd_w_plan's rule).
extern "C" int domain_engine_bwd_w_plan(int T, int N, int M, int S2, int device, int* splits,
                                        long long* scratch_floats, long long* counters) {
  return with_bw_conf(M, [&](auto conf) {
    using C = decltype(conf);
    using K = typename C::K;
    cudaError_t err = cudaFuncSetAttribute(BW_KERNEL(C, false), cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)K::kSmemBytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(BW_KERNEL(C, true), cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)K::kSmemBytes);
    int occ = 0, sms = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, BW_KERNEL(C, true), K::kThreads, K::kSmemBytes);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    const long long slots = (long long)(occ > 0 ? occ : 1) * sms;
    const long long groups = (long long)S2 * ((N + K::BN - 1) / K::BN) * ((M + K::BM - 1) / K::BM);
    const long long chunks = ((long long)T + C::BT - 1) / C::BT;
    long long k = slots / groups;
    if (k > chunks / 4) k = chunks / 4;
    if (k > 65535) k = 65535;
    if (k < 1) k = 1;
    *splits = (int)k;
    *scratch_floats = k > 1 ? groups * k * K::kRed : 0;
    *counters = k > 1 ? groups : 0;
    return 0;
  });
}

// One bwd_w launch: xw, g -> dww (C, N, M), every element written.  splits,
// partial and counters from domain_engine_bwd_w_plan; the counters are zero
// on entry and the kernel leaves them zero.
extern "C" int domain_engine_bwd_w_f32(const float* xw, const float* g, const float* inv, const int* pos,
                                       const int* sub_off, float* dww, int T, int N, int M, int S2, int splits,
                                       float* partial, int* counters, void* stream) {
  return with_bw_conf(M, [&](auto conf) {
    using C = decltype(conf);
    using K = typename C::K;
    auto kernel = splits > 1 ? BW_KERNEL(C, true) : BW_KERNEL(C, false);
    dim3 grid(S2 * ((N + K::BN - 1) / K::BN) * ((M + K::BM - 1) / K::BM), splits);
    kernel<<<grid, K::kThreads, K::kSmemBytes, reinterpret_cast<cudaStream_t>(stream)>>>(
        xw, g, inv, pos, sub_off, dww, T, N, M, S2, splits, partial, counters);
    return (int)cudaGetLastError();
  });
}
