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
// What bounds them on an H100: the products, 2*T*C*N*M flops each on the
// fp32 CUDA cores (67 TFLOP/s), at every DCGAN layer but the RGB one; there
// (M = 3) the bytes of dcells (bwd_x) and of the cell windows (bwd_w) do.
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
//     contraction over M runs in chunks of (sub-filter s, BM channels); the
//     block's 4 position groups each keep 4 Winograd positions x 4 tiles x 4
//     channels in registers for the whole loop, as the forward keeps its
//     products.  gw is formed in shared memory once per chunk;
//   * bwd_w gives each block one (sub-filter, N-tile, M-tile); its 8
//     position groups each keep 2 packed positions x 4 channels n x 4
//     channels m in registers and run over T in chunks of BT tiles: the
//     chunk's raw 4x4 cell windows and its g rows arrive by cp.async while
//     the previous chunk computes; B^T Z B and the gw fold run shared-to-shared.  The T
//     loop is long (36992 tiles at DCGAN's RGB layer) where (N, M) is small,
//     so it is split over blocks: each writes its sums to scratch and the
//     last to arrive adds them in split order (deterministic) and resets its
//     arrival counter to 0, as the forward's N split does;
//   * M = 3 is not a multiple of 4, so g rows move in 4-byte copies on that
//     path; the tensor is never padded on the host.
// wgmma (3xTF32), TMA and one gw pass shared by both kernels are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPos = 16;  // n*n Winograd positions of F(2,3)
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

// ============================================================== bwd_x
// G position groups x (NT_T x NT_N) threads; group g owns Winograd positions
// g, g + G, ...; each thread a 4-tile x 4-channel micro tile.  BM: the M
// chunk; VW: 4 for 16-byte g copies (M % 4 == 0), 1 for 4-byte copies.
template <int G, int NT_T, int NT_N, int BM, int VW>
struct BxCfg {
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

template <int G, int NT_T, int NT_N, int BM, int VW>
__global__ void __launch_bounds__(G * NT_T * NT_N)
bwd_x_kernel(const float* __restrict__ g, const float* __restrict__ ww, const float* __restrict__ inv,
             const int* __restrict__ pos, const int* __restrict__ sub_off, float* __restrict__ dcells,
             int B, int gy, int gx, int N, int M, int S, int ty, int tx, int R, int W, int TC, int ncb) {
  using K = BxCfg<G, NT_T, NT_N, BM, VW>;
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
  const int C = sub_off[S2];
  const int n0 = blockIdx.y * BN;
  const int rb = blockIdx.x / ncb, cb = blockIdx.x % ncb;
  const int rho0 = rb * R, c0 = cb * W;
  const int rows = B * gy;
  const int rho1 = min(rho0 + R, rows);
  const int c1 = min(c0 + W, gx);

  // the tile rows (tau = b*ty + j, contiguous) and columns this block's
  // cells read from: cell row r takes tile rows r-1 and r
  int tau_lo = 0x7fffffff, tau_hi = -1;
  for (int rho = rho0; rho < rho1; ++rho) {
    const int b = rho / gy, r = rho - b * gy;
    const int jlo = max(r - 1, 0), jhi = min(r, ty - 1);
    if (jlo <= jhi) {
      tau_lo = min(tau_lo, b * ty + jlo);
      tau_hi = max(tau_hi, b * ty + jhi);
    }
  }
  if (tau_hi < 0) tau_lo = 0;  // no tile: every slot stays empty
  const int tc0 = max(c0 - 1, 0), tc1 = min(c1 - 1, tx - 1);

  for (int i = tid; i < C * 4; i += NT) inv_s[i] = inv[i];
  for (int i = tid; i < C; i += NT) pos_s[i] = pos[i];
  for (int i = tid; i <= S2; i += NT) off_s[i] = sub_off[i];
  for (int i = tid; i < kMaxSub * kMaxPos; i += NT) kmap_s[i] = -1;
  for (int tl = tid; tl < BT; tl += NT) {
    const int tr = tl / TC, tc = tl % TC;
    const int tau = tau_lo + tr, col = tc0 + tc;
    tile_s[tl] = (tau <= tau_hi && col <= tc1) ? tau * tx + col : -1;
  }
  __syncthreads();
  for (int s = tid; s < S2; s += NT)
    for (int k = 0; k < off_s[s + 1] - off_s[s]; ++k) kmap_s[s * kMaxPos + pos_s[off_s[s] + k]] = k;
  __syncthreads();

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
    constexpr int kGv = BT * 4 * BM / VW;
    for (int e = tid; e < kGv; e += NT) {
      const int mm = (e % (BM / VW)) * VW, a = (e / (BM / VW)) % 4, tl = e / (BM / VW * 4);
      const int t = tile_s[tl];
      const bool ok = t >= 0 && m0 + mm < M;
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

  // dXw of every tile slot in shared memory, then dZ = B dXw B^T in place
#pragma unroll
  for (int kk = 0; kk < PG; ++kk) {
    const int p = kk * G + grp;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(red_s + (p * BT + tt * 4 + i) * BN + tn * 4) =
          make_float4(acc[kk][i][0], acc[kk][i][1], acc[kk][i][2], acc[kk][i][3]);
  }
  __syncthreads();
  for (int it = tid; it < BT * BN; it += NT) {
    float d[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) d[u][v] = red_s[(u * 4 + v) * BT * BN + it];
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
      float* dst = red_s + (a * 4) * BT * BN + it;
      dst[0 * BT * BN] = y[a][0];
      dst[1 * BT * BN] = y[a][1] - y[a][2] + y[a][3];
      dst[2 * BT * BN] = y[a][1] + y[a][2] - y[a][0];
      dst[3 * BT * BN] = -y[a][3];
    }
  }
  __syncthreads();

  // gather: every cell of the block sums the dZ pieces of the tiles that
  // read it, in the fixed order (dy, dx) = (0,0), (0,1), (1,0), (1,1)
  const int wc = c1 - c0;
  const int items = (rho1 - rho0) * wc * 4 * BN;
  for (int it = tid; it < items; it += NT) {
    const int nn = it % BN, a = (it / BN) % 4, cell = it / (4 * BN);
    const int rho = rho0 + cell / wc, col = c0 + cell % wc;
    const int b = rho / gy, r = rho - b * gy;
    const int pp = a / 2, qq = a % 2;
    float v = 0.0f;
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const int j = r - dy;
      if (j < 0 || j >= ty) continue;
      const int tr = b * ty + j - tau_lo;
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const int tcol = col - dx;
        if (tcol < 0 || tcol >= tx) continue;
        const int slot = tr * TC + tcol - tc0;
        v += red_s[(((2 * dy + pp) * 4 + 2 * dx + qq) * BT + slot) * BN + nn];
      }
    }
    if (n0 + nn < N) dcells[(((size_t)rho * gx + col) * 4 + a) * N + n0 + nn] = v;
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
  static constexpr int kZ = BT * 16 * BN;       // raw 4x4 windows, one stage
  static constexpr int kG = BT * 4 * BM;        // g rows, one stage
  static constexpr int kXw = kMaxPos * BT * BN;  // xw [pos][tile][n]
  static constexpr int kGw = kMaxPos * BT * BM;  // gw [k][tile][m]
  static constexpr int kRed = kMaxPos * BN * BM;  // one block's sums, in scratch
  static constexpr size_t kSmemBytes =
      sizeof(float) * (2 * (kZ + kG) + kXw + kGw + kMaxPos * 4) + sizeof(int) * kMaxPos;
};

template <int G, int NT_N, int NT_M, int BT, int VW, bool SPLIT>
__global__ void __launch_bounds__(G * NT_N * NT_M)
bwd_w_kernel(const float* __restrict__ cells, const float* __restrict__ g, const float* __restrict__ inv,
             const int* __restrict__ pos, const int* __restrict__ sub_off, float* __restrict__ dww,
             int B, int Gy, int Gx, int N, int M, int S, int ty, int tx, int splits,
             float* __restrict__ partial, int* __restrict__ counters) {
  using K = BwCfg<G, NT_N, NT_M, BT, VW>;
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

template <int G_, int NT_T_, int NT_N_, int BM_, int VW_>
struct BxConf {
  static constexpr int G = G_, NT_T = NT_T_, NT_N = NT_N_, BM = BM_, VW = VW_;
  using K = BxCfg<G, NT_T, NT_N, BM, VW>;
};
#define BX_KERNEL(C) bwd_x_kernel<C::G, C::NT_T, C::NT_N, C::BM, C::VW>

// bwd_x block configuration for M: 64 tile slots x 32 channels n per block,
// 4 position groups, 512 threads; M in chunks of 8 with 16-byte g copies,
// or chunks of 4 with 4-byte copies for few or ragged channels (RGB).
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
#define BW_KERNEL(C, SPLIT) bwd_w_kernel<C::G, C::NT_N, C::NT_M, C::BT, C::VW, SPLIT>

// bwd_w block configuration for M: 32 x 32 (n, m) per block, 8 position
// groups, 512 threads, 8 tiles per T chunk, 16-byte g copies; or, for few
// or ragged M (RGB), 64 x 4 per block, 128 threads, 4 tiles per chunk and
// 4-byte g copies.  (N % 4 == 0 is the caller's to check.)
template <class F>
int with_bw_conf(int M, F&& f) {
  if (M >= 16 && M % 4 == 0) return f(BwConf<8, 8, 8, 8, 4>{});
  return f(BwConf<8, 16, 1, 4, 1>{});
}

}  // namespace

// Plain C entry points (bound with ctypes).  Every pointer is a device pointer.

// bwd_x geometry: a block covers R cell rows (rows of all B images end to
// end) by W cell columns; its tile slots are TC tile columns by BT/TC tile
// rows.  W is all gx columns when two tile rows of tx tiles fit the slots,
// else one cell row and BT/2 - 1 columns.  R is the largest count of rows
// whose every block reads at most BT/TC tile rows.  Also raises the
// kernel's shared-memory limit on the current device (call it before the
// first launch for this M).
extern "C" int fused_engine_bwd_x_plan(int B, int gy, int gx, int ty, int tx, int M, int* R, int* W, int* TC) {
  return with_bx_conf(M, [&](auto conf) {
    using C = decltype(conf);
    using K = typename C::K;
    cudaError_t err = cudaFuncSetAttribute(BX_KERNEL(C), cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)K::kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    int w, tc;
    if (2 * tx <= K::BT) {
      w = gx;
      tc = tx;
    } else {
      w = K::BT / 2 - 1;
      tc = w + 1;
    }
    const int tr_max = K::BT / tc;
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
    return 0;
  });
}

// One bwd_x launch: g (B, ty, tx, S^2*4, M), ww (C, N, M), inv (C, 4),
// pos (C,), sub_off (S^2 + 1,) -> dcells (B, gy, gx, 4, N), every element
// written.  R, W, TC from fused_engine_bwd_x_plan.  Returns cudaGetLastError().
extern "C" int fused_engine_bwd_x_f32(const float* g, const float* ww, const float* inv, const int* pos,
                                      const int* sub_off, float* dcells, int B, int gy, int gx, int N,
                                      int M, int S, int ty, int tx, int R, int W, int TC, void* stream) {
  return with_bx_conf(M, [&](auto conf) {
    using C = decltype(conf);
    using K = typename C::K;
    const int nrb = (B * gy + R - 1) / R, ncb = (gx + W - 1) / W;
    dim3 grid(nrb * ncb, (N + K::BN - 1) / K::BN);
    BX_KERNEL(C)<<<grid, K::kThreads, K::kSmemBytes, reinterpret_cast<cudaStream_t>(stream)>>>(
        g, ww, inv, pos, sub_off, dcells, B, gy, gx, N, M, S, ty, tx, R, W, TC, ncb);
    return (int)cudaGetLastError();
  });
}

// bwd_w split plan: the T loop is split over as many blocks per (sub-filter,
// N-tile, M-tile) group as fill the card's resident block slots once, with
// at least 4 chunks per split.  scratch_floats / counters are 0 when the
// split count is 1.  Also raises both variants' shared-memory limit on the
// current device (call it before the first launch for this M).
extern "C" int fused_engine_bwd_w_plan(int B, int ty, int tx, int N, int M, int S, int device, int* splits,
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
    const long long groups = (long long)S * S * ((N + K::BN - 1) / K::BN) * ((M + K::BM - 1) / K::BM);
    const long long chunks = ((long long)B * ty * tx + C::BT - 1) / C::BT;
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

// One bwd_w launch: cells (B, Gy, Gx, 4, N), g (B, ty, tx, S^2*4, M),
// inv (C, 4), pos (C,), sub_off (S^2 + 1,) -> dww (C, N, M), every element
// written.  splits, partial and counters from fused_engine_bwd_w_plan; the
// counters are zero on entry and the kernel leaves them zero.
extern "C" int fused_engine_bwd_w_f32(const float* cells, const float* g, const float* inv, const int* pos,
                                      const int* sub_off, float* dww, int B, int Gy, int Gx, int N, int M,
                                      int S, int ty, int tx, int splits, float* partial, int* counters,
                                      void* stream) {
  return with_bw_conf(M, [&](auto conf) {
    using C = decltype(conf);
    using K = typename C::K;
    auto kernel = splits > 1 ? BW_KERNEL(C, true) : BW_KERNEL(C, false);
    dim3 grid(S * S * ((N + K::BN - 1) / K::BN) * ((M + K::BM - 1) / K::BM), splits);
    kernel<<<grid, K::kThreads, K::kSmemBytes, reinterpret_cast<cudaStream_t>(stream)>>>(
        cells, g, inv, pos, sub_off, dww, B, Gy, Gx, N, M, S, ty, tx, splits, partial, counters);
    return (int)cudaGetLastError();
  });
}
