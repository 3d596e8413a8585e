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
// What bounds them on an H100: the products, 2*T*C*N*M flops each on the
// fp32 CUDA cores (67 TFLOP/s), at every DCGAN discriminator layer but the
// first; there (N = 3) the bytes of the output cells (forward), of g and
// dcells (bwd_x) and of the cell windows and g (bwd_w) do.
//
// What the designs do about it:
//   * forward: one block per (T-tile, M-tile), the deconv engine's micro
//     tiles (8 position groups, 4 tiles x 4 channels each, fed from a
//     two-stage cp.async pipeline of raw windows and weights with the
//     B-transform run shared-to-shared).  36 positions' products do not fit
//     in registers, so the block runs the phases one after another: a phase's
//     at most 16 positions accumulate over the whole N loop, meet in shared
//     memory, and fold through inv into the tile's 4 outputs, which stay in
//     registers (2 tile-channel pairs x 4 outputs a thread) across phases.
//     The epilogue and the store run once, after the last phase;
//   * bwd_x: a gather, as the deconv corner's bwd_x: a block owns R cell rows
//     x W cell columns x BN channels, computes dXw for every tile its cells
//     read (the one-row halo again), and sums each cell's pieces in a fixed
//     order: no atomics, no scratch, no dependence on block order.  The
//     phases run one after another, each writing its own channel slots;
//   * bwd_w: one block per (phase, N-tile, M-tile), the T loop split over
//     blocks with the deterministic last-block sum (conv0 reduces T = 32768
//     tiles into 36 x 3 x 64 outputs);
//   * N = 3 (conv0's RGB input) is not a multiple of 4: cell windows move in
//     4-byte copies and the channel chunk is 4 wide; nothing is padded on the
//     host.
// wgmma (3xTF32), TMA and a gw pass shared by both backward kernels are later
// work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kN2 = 16;         // n*n Winograd positions of one phase
constexpr int kMaxPhases = 16;  // S^2, S <= 4
constexpr int kMaxC = kN2 * kMaxPhases;

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case 1: return fmaxf(v, 0.0f);
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

template <int G_, int NT_T_, int NT_M_, int BN_, int VZ_, int VW_>
struct FwdConf {
  static constexpr int G = G_, NT_T = NT_T_, NT_M = NT_M_, BN = BN_, VZ = VZ_, VW = VW_;
  using K = FwdCfg<G, NT_T, NT_M, BN, VZ, VW>;
};
#define FWD_KERNEL(C) conv_fwd_kernel<C::G, C::NT_T, C::NT_M, C::BN, C::VZ, C::VW>

// forward block configuration: 32 tiles x 32 channels, 512 threads, for
// M % 4 == 0 and M >= 32, else 64 tiles x 4 channels, 128 threads; cell
// windows in 16-byte copies and 16 (8) channel chunks when N % 4 == 0, else
// 4-byte copies and 4-channel chunks
template <class F>
int with_fwd_conf(int N, int M, F&& f) {
  const bool wide = M >= 32 && M % 4 == 0;
  if (N % 4 == 0) return wide ? f(FwdConf<8, 8, 8, 16, 4, 4>{}) : f(FwdConf<8, 16, 1, 8, 4, 1>{});
  return wide ? f(FwdConf<8, 8, 8, 4, 1, 4>{}) : f(FwdConf<8, 16, 1, 4, 1, 1>{});
}

// ============================================================== bwd_x
// G position groups x (NT_T x NT_N) threads; group g owns Winograd positions
// g, g + G, ... of the current phase; each thread a 4-tile x 4-channel micro
// tile.  BM: the M chunk; VW: floats per g copy.
template <int G, int NT_T, int NT_N, int BM, int VW>
struct BxCfg {
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

template <int G, int NT_T, int NT_N, int BM, int VW>
__global__ void __launch_bounds__(G * NT_T * NT_N)
conv_bwd_x_kernel(const float* __restrict__ g, const float* __restrict__ ww, const float* __restrict__ inv,
                  const int* __restrict__ pos, const int* __restrict__ phase_off, float* __restrict__ dcells,
                  int B, int gy, int gx, int N, int M, int S2, int ty, int tx, int R, int W, int TC, int ncb) {
  using K = BxCfg<G, NT_T, NT_N, BM, VW>;
  constexpr int PG = K::PG, BT = K::BT, BN = K::BN, GS = K::GS, XT = K::XT, NT = K::kThreads;
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
  const int rb = blockIdx.x / ncb, cb = blockIdx.x % ncb;
  const int rho0 = rb * R, c0 = cb * W;
  const int rows = B * gy;
  const int rho1 = min(rho0 + R, rows);
  const int c1 = min(c0 + W, gx);

  // the tile rows (tau = b*ty + j) and columns this block's cells read from
  int tau_lo = 0x7fffffff, tau_hi = -1;
  for (int rho = rho0; rho < rho1; ++rho) {
    const int b = rho / gy, r = rho - b * gy;
    const int jlo = max(r - 1, 0), jhi = min(r, ty - 1);
    if (jlo <= jhi) {
      tau_lo = min(tau_lo, b * ty + jlo);
      tau_hi = max(tau_hi, b * ty + jhi);
    }
  }
  if (tau_hi < 0) tau_lo = 0;
  const int tc0 = max(c0 - 1, 0), tc1 = min(c1 - 1, tx - 1);

  for (int i = tid; i < C * 4; i += NT) inv_s[i] = inv[i];
  for (int i = tid; i < C; i += NT) pos_s[i] = pos[i] % kN2;
  for (int i = tid; i <= S2; i += NT) off_s[i] = phase_off[i];
  for (int i = tid; i < S2 * kN2; i += NT) kmap_s[i] = -1;
  for (int tl = tid; tl < BT; tl += NT) {
    const int tr = tl / TC, tc = tl % TC;
    const int tau = tau_lo + tr, col = tc0 + tc;
    tile_s[tl] = (tau <= tau_hi && col <= tc1) ? tau * tx + col : -1;
  }
  __syncthreads();
  for (int i = tid; i < C; i += NT) kmap_s[pos[i]] = i - off_s[pos[i] / kN2];
  __syncthreads();

  const int mchunks = (M + BM - 1) / BM;

  // one pipeline stage: the g rows of every tile slot for channels
  // [m0, m0 + BM), and ww[lo+k, n0:n0+BN, m0:m0+BM] transposed to [k][m][n]
  auto stage = [&](int buf, int lo, int cnt, int c) {
    const int m0 = c * BM;
    float* gd = g_s + buf * K::kG;
    constexpr int kGv = BT * 4 * BM / VW;
    for (int e = tid; e < kGv; e += NT) {
      const int mm = (e % (BM / VW)) * VW, a = (e / (BM / VW)) % 4, tl = e / (BM / VW * 4);
      const int t = tile_s[tl];
      const bool ok = t >= 0 && m0 + mm < M;
      cp_async<VW>(gd + tl * GS + a * BM + mm, ok ? g + ((size_t)t * 4 + a) * M + m0 + mm : g, ok);
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
      float yv[4][4];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        yv[0][v] = d[0][v];
        yv[1][v] = d[1][v] - d[2][v] + d[3][v];
        yv[2][v] = d[1][v] + d[2][v] - d[0][v];
        yv[3][v] = -d[3][v];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        float* dst = red_s + (a * 4) * BT * BN + it;
        dst[0 * BT * BN] = yv[a][0];
        dst[1 * BT * BN] = yv[a][1] - yv[a][2] + yv[a][3];
        dst[2 * BT * BN] = yv[a][1] + yv[a][2] - yv[a][0];
        dst[3 * BT * BN] = -yv[a][3];
      }
    }
    __syncthreads();

    // gather: every cell of the block sums the dZ pieces of the tiles that
    // read it, in the fixed order (dy, dx) = (0,0), (0,1), (1,0), (1,1), into
    // its phase-s channel slots
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
      if (n0 + nn < N) dcells[(((size_t)rho * gx + col) * cs + s * 4 + a) * N + n0 + nn] = v;
    }
    __syncthreads();  // red_s is the next phase's staging space
  }
}

template <int G_, int NT_T_, int NT_N_, int BM_, int VW_>
struct BxConf {
  static constexpr int G = G_, NT_T = NT_T_, NT_N = NT_N_, BM = BM_, VW = VW_;
  using K = BxCfg<G, NT_T, NT_N, BM, VW>;
};
#define BX_KERNEL(C) conv_bwd_x_kernel<C::G, C::NT_T, C::NT_N, C::BM, C::VW>

// bwd_x block configuration: 64 tile slots x 32 channels n, 512 threads; or,
// for N <= 4 (conv0's RGB input), 128 tile slots x 4 channels, 128 threads.
// M in chunks of 8 with 16-byte g copies, or of 4 with 4-byte copies.
template <class F>
int with_bx_conf(int N, int M, F&& f) {
  const bool wide = M >= 8 && M % 4 == 0;
  if (N > 4) return wide ? f(BxConf<4, 16, 8, 8, 4>{}) : f(BxConf<4, 16, 8, 4, 1>{});
  return wide ? f(BxConf<4, 32, 1, 8, 4>{}) : f(BxConf<4, 32, 1, 4, 1>{});
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

template <int G_, int NT_N_, int NT_M_, int BT_, int VZ_, int VW_>
struct BwConf {
  static constexpr int G = G_, NT_N = NT_N_, NT_M = NT_M_, BT = BT_, VZ = VZ_, VW = VW_;
  using K = BwCfg<G, NT_N, NT_M, BT, VZ, VW>;
};
#define BW_KERNEL(C, SPLIT) conv_bwd_w_kernel<C::G, C::NT_N, C::NT_M, C::BT, C::VZ, C::VW, SPLIT>

// bwd_w block configuration: 32 x 32 (n, m), 512 threads, 8 tiles per chunk
// (N % 4 == 0, M % 4 == 0, M >= 16); 64 x 4, 128 threads, 4 tiles (N % 4 ==
// 0, few or ragged M); for N % 4 != 0, 4-channel n tiles with 4-byte window
// copies: 4 x 64 (128 threads) or 4 x 16 (32 threads), 8 tiles per chunk
template <class F>
int with_bw_conf(int N, int M, F&& f) {
  const bool wide = M >= 16 && M % 4 == 0;
  if (N % 4 == 0) return wide ? f(BwConf<8, 8, 8, 8, 4, 4>{}) : f(BwConf<8, 16, 1, 4, 4, 1>{});
  return wide ? f(BwConf<8, 1, 16, 8, 1, 4>{}) : f(BwConf<8, 1, 4, 8, 1, 1>{});
}

}  // namespace

// Plain C entry points (bound with ctypes).  Every pointer is a device
// pointer.  pos (C,) holds each packed position's index into the S2*16
// phase-major Winograd space, phase_off (S2 + 1,) each phase's first packed
// position.

// Raises the forward kernel's shared-memory limit on the current device for
// (N, M)'s block configuration (call before the first launch).
extern "C" int conv_engine_fwd_plan(int N, int M) {
  return with_fwd_conf(N, M, [&](auto conf) {
    using C = decltype(conf);
    return (int)cudaFuncSetAttribute(FWD_KERNEL(C), cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)C::K::kSmemBytes);
  });
}

// One forward launch: cells (B, Gy, Gx, S2*4, N), ww (C, N, M), inv (C, 4)
// -> out (B, out_h, out_w, M) (out_mode 0) or (B, ty, tx, 4, M) (out_mode 1).
// scale and bias may be null; act: 0 none, 1 relu, 2 leaky_relu, 3 tanh.
// Returns cudaGetLastError().
extern "C" int conv_engine_fwd_f32(const float* cells, const float* ww, const float* inv, const int* pos,
                                   const int* phase_off, const float* scale, const float* bias, float* out,
                                   int B, int Gy, int Gx, int N, int M, int S2, int ty, int tx, int out_h,
                                   int out_w, int out_mode, int act, void* stream) {
  return with_fwd_conf(N, M, [&](auto conf) {
    using C = decltype(conf);
    using K = typename C::K;
    const int T = B * ty * tx;
    dim3 grid((T + K::BT - 1) / K::BT, (M + K::BM - 1) / K::BM);
    FWD_KERNEL(C)<<<grid, K::kThreads, K::kSmemBytes, reinterpret_cast<cudaStream_t>(stream)>>>(
        cells, ww, inv, pos, phase_off, scale, bias, out, B, Gy, Gx, N, M, S2, ty, tx, out_h, out_w, out_mode,
        act);
    return (int)cudaGetLastError();
  });
}

// bwd_x geometry, as the deconv corner's: a block covers R cell rows (rows
// of all B images end to end) by W cell columns; its tile slots are TC tile
// columns by BT/TC tile rows.  Also raises the kernel's shared-memory limit
// on the current device.
extern "C" int conv_engine_bwd_x_plan(int B, int gy, int gx, int ty, int tx, int N, int M, int* R, int* W,
                                      int* TC) {
  return with_bx_conf(N, M, [&](auto conf) {
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

// One bwd_x launch: g (B, ty, tx, 4, M), ww (C, N, M), inv (C, 4) -> dcells
// (B, gy, gx, S2*4, N), every element written.  R, W, TC from
// conv_engine_bwd_x_plan.  Returns cudaGetLastError().
extern "C" int conv_engine_bwd_x_f32(const float* g, const float* ww, const float* inv, const int* pos,
                                     const int* phase_off, float* dcells, int B, int gy, int gx, int N, int M,
                                     int S2, int ty, int tx, int R, int W, int TC, void* stream) {
  return with_bx_conf(N, M, [&](auto conf) {
    using C = decltype(conf);
    using K = typename C::K;
    const int nrb = (B * gy + R - 1) / R, ncb = (gx + W - 1) / W;
    dim3 grid(nrb * ncb, (N + K::BN - 1) / K::BN);
    BX_KERNEL(C)<<<grid, K::kThreads, K::kSmemBytes, reinterpret_cast<cudaStream_t>(stream)>>>(
        g, ww, inv, pos, phase_off, dcells, B, gy, gx, N, M, S2, ty, tx, R, W, TC, ncb);
    return (int)cudaGetLastError();
  });
}

// bwd_w split plan: the T loop is split over as many blocks per (phase,
// N-tile, M-tile) group as fill the card's resident block slots once, with
// at least 4 chunks per split.  scratch_floats / counters are 0 when the
// split count is 1.  Also raises both variants' shared-memory limit on the
// current device.
extern "C" int conv_engine_bwd_w_plan(int B, int ty, int tx, int N, int M, int S2, int device, int* splits,
                                      long long* scratch_floats, long long* counters) {
  return with_bw_conf(N, M, [&](auto conf) {
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

// One bwd_w launch: cells (B, Gy, Gx, S2*4, N), g (B, ty, tx, 4, M),
// inv (C, 4) -> dww (C, N, M), every element written.  splits, partial and
// counters from conv_engine_bwd_w_plan; the counters are zero on entry and
// the kernel leaves them zero.  Returns cudaGetLastError().
extern "C" int conv_engine_bwd_w_f32(const float* cells, const float* g, const float* inv, const int* pos,
                                     const int* phase_off, float* dww, int B, int Gy, int Gx, int N, int M,
                                     int S2, int ty, int tx, int splits, float* partial, int* counters,
                                     void* stream) {
  return with_bw_conf(N, M, [&](auto conf) {
    using C = decltype(conf);
    using K = typename C::K;
    auto kernel = splits > 1 ? BW_KERNEL(C, true) : BW_KERNEL(C, false);
    dim3 grid(S2 * ((N + K::BN - 1) / K::BN) * ((M + K::BM - 1) / K::BM), splits);
    kernel<<<grid, K::kThreads, K::kSmemBytes, reinterpret_cast<cudaStream_t>(stream)>>>(
        cells, g, inv, pos, phase_off, dww, B, Gy, Gx, N, M, S2, ty, tx, splits, partial, counters);
    return (int)cudaGetLastError();
  });
}
