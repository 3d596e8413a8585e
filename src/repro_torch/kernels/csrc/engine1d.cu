// The 1D Winograd engine for Hopper (sm_90a), fp32: the rank-1 instantiation
// of the fused engine, for the audio deconv decoder and strided / unit-stride
// conv1d.
//
// Replaces src/repro/kernels/engine.py::winograd_conv1d_fused_engine, both
// of its pallas_calls: out_mode "scratch" (kernel body _fused1d_kernel, the
// pallas_call at engine.py:1690) and out_mode "nlc" (_fused1d_epi_kernel with
// _cells1d_to_xw and _finalize_nlc, the pallas_call at engine.py:1724).  The
// plain PyTorch versions are repro_torch/kernels/ref.py::conv1d_pre_engine_ref
// (scratch) and conv1d_engine_ref plus the epilogue (nlc).
//
// What it computes, under F(2, r) (m = 2 outputs per tile, n = r + 1
// Winograd positions, n = 4 or 5):
//   cells (B, Gy, phases*2, N) hold the padded sequence of each input phase
//   s, two samples per cell row: cells[b, g, 2*s + p, c] = x_s[b, 2*g + p, c].
//   Tile j of phase s is cell rows [j, j + q) cropped to n samples
//   (q = ceil(n/2)), xw[s*n + v] = sum_u B^T[v, u] z[u] (B^T from the
//   caller: F(2,3)'s entries are 0 and +-1, F(2,4)'s are not), and
//     dot_p[t, m]  = sum_c xw[t, pos_p, c] * ww[p, c, m]
//     y[t, s, a, m] = sum_{p in sub-filter s} inv[p, a] * dot_p[t, m]
//   "scratch" stores y as (B, ty, S2*2, M) sub-filter-major; "nlc" applies
//   act(scale * y + bias) and stores the stride-S interleave (B, ty*2*S, M),
//   sub-pixel (rho = s, a) of tile j at row 2*S*j + S*a + rho (S2 == S).
//
// What bounds it on an H100: the packed products, 2*T*C*N*M flops, at the
// audio decoder's first two layers (C = 6, 256 -> 128 and 128 -> 64
// channels); at its mono last layer (M = 1) the bytes of the cells, one read
// of the 64-channel sequence.
//
// What the design does about it: where M % 4 == 0 and M >= 16 and the grid
// fills the card (the decoder's first two layers at batch 4 and more) the
// products run on the tensor cores in 3xTF32 through the shared forward core
// (fwd_core.cuh, engine1d_mma_kernel below): a block of 64 consecutive
// tiles of one sequence by 64 or 128 channels m stages the 64 + q - 1 cell
// rows its tiles read, once each (the line buffer), forms xw at the
// Winograd positions a pass reads (the decoder's 6 packed positions read 3),
// and folds every k-step's products into each sub-filter's 2 outputs in
// registers.  The TPU's 128-lane padding of N and M and its (C, T_t, M_t)
// scratch of accumulators are not carried over.  Few or ragged M (the
// waveform) and grids of fewer tensor-core blocks than SMs (batch 1) take
// the fp32 CUDA-core kernel, fused_engine.cu's design with one axis fewer:
//   * one block per (BT consecutive tiles of one sequence, M-tile of BM
//     channels), looping over N in chunks of BN, the BT + q - 1 cell rows
//     staged once each in one contiguous run of 16-byte cp.async copies per
//     row, with the weight slice, two stages deep;
//   * the one-sided B^T runs shared-to-shared per phase (n^2 multiply-adds
//     per tile and channel), into xw_s[position][channel][tile];
//   * 4 warp-uniform position groups each keep, in registers for the whole N
//     loop, the products of up to 4 of the C <= 16 packed positions for a
//     4-tile x MC-channel micro tile (MC = 1 for M = 1: no dead channels).
//     After the N loop the products meet in shared memory and fold through
//     inv (zeros skipped) once.  Sums run in one fixed order: no atomics, the
//     same result every run;
//   * 16-byte weight copies where M % 4 == 0 and M >= 32, else 4-byte ones.
// In both an empty sub-filter (K_D < S) writes act(bias) in nlc mode, zeros
// in scratch mode, as the reference does.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fwd_core.cuh"

namespace {

constexpr int kM = 2;         // outputs per tile: F(2, r)
constexpr int kMaxPos = 16;   // phases*n Winograd positions; also the most packed positions C
constexpr int kMaxN = 6;      // n = r + 1
constexpr int kMaxQ = 3;      // cell rows per tile window, ceil(n / 2)
constexpr int kMaxPM = 8;     // phases * m
constexpr int kMaxSub = 16;   // sub-filters
constexpr int kG = 4;         // position groups
constexpr int kPG = kMaxPos / kG;  // positions per group

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case 1: return v < 0.0f ? 0.0f : v;  // keeps NaN, as torch.clamp_min and jnp.maximum do
    case 2: return v >= 0.0f ? v : 0.2f * v;  // LEAKY_SLOPE
    case 3: return tanhf(v);
    default: return v;
  }
}

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

// Block geometry: kG position groups x (NT_T x NT_M) threads; a thread owns
// the tiles 4*tt .. 4*tt+3 and the channels MC*tm .. MC*tm+MC-1 (MC = 4, or
// 1 for the mono waveform: no dead channels).
template <int NT_T, int NT_M, int BN, int MC>
struct Cfg {
  static constexpr int kThreads = kG * NT_T * NT_M;
  static constexpr int BT = NT_T * 4;   // tiles per block
  static constexpr int BM = NT_M * MC;  // output channels per block
  static constexpr int XT = BT + 4;    // xw row stride: float4-aligned, skewed banks
};

// Shared memory of one launch, in floats, from its runtime geometry: two
// stages of cell rows [R][PM][BN] and weights [C][BN][BM], the transformed
// tiles [NP][BN][XT], the products [C][BT][BM] (reusing the stages after the
// N loop), then B^T, inv, positions and sub-filter offsets.
struct Smem {
  int z, w, xw, red, big, total_floats;
  __host__ __device__ Smem(int BT, int BM, int BN, int XT, int R, int PM, int C, int NP) {
    z = R * PM * BN;
    w = C * BN * BM;
    xw = NP * BN * XT;
    red = C * BT * BM;
    const int stage = 2 * (z + w) + xw;
    big = stage > red ? stage : red;
    total_floats = big + kMaxN * kMaxN + kMaxPos * kM;
  }
  __host__ __device__ size_t bytes() const { return sizeof(float) * total_floats + sizeof(int) * (kMaxPos + kMaxSub + 1); }
};

template <int NT_T, int NT_M, int BN, int VW, int MC>
__global__ void __launch_bounds__(kG * NT_T * NT_M)
engine1d_kernel(const float* __restrict__ cells, const float* __restrict__ ww, const float* __restrict__ inv,
                const int* __restrict__ pos, const int* __restrict__ sub_off, const float* __restrict__ bt,
                const float* __restrict__ scale, const float* __restrict__ bias, float* __restrict__ out,
                int B, int Gy, int N, int M, int ty, int n, int phases, int S2, int S, int out_mode, int act) {
  using K = Cfg<NT_T, NT_M, BN, MC>;
  constexpr int BT = K::BT, BM = K::BM, XT = K::XT, NT = K::kThreads;
  const int q = (n + kM - 1) / kM;
  const int R = BT + q - 1;  // cell rows a chunk stages
  const int PM = phases * kM, NP = phases * n;
  const int C = sub_off[S2];
  const Smem L(BT, BM, BN, XT, R, PM, C, NP);

  extern __shared__ float4 smem4[];
  float* z_s = reinterpret_cast<float*>(smem4);  // 2 x [R][PM][BN]
  float* w_s = z_s + 2 * L.z;                     // 2 x [C][BN][BM]
  float* xw_s = w_s + 2 * L.w;                    // [NP][BN][XT]
  float* red_s = z_s;                             // [C][BT][BM] after the N loop
  float* bt_s = z_s + L.big;                      // [n][n]
  float* inv_s = bt_s + kMaxN * kMaxN;            // [C][2]
  int* pos_s = reinterpret_cast<int*>(inv_s + kMaxPos * kM);
  int* off_s = pos_s + kMaxPos;                   // [S2 + 1]

  const int tid = threadIdx.x;
  const int g = tid / (NT_T * NT_M);  // position group, uniform per warp
  const int rem = tid % (NT_T * NT_M);
  const int tt = rem / NT_M, tm = rem % NT_M;
  const int nbj = (ty + BT - 1) / BT;
  const int b = blockIdx.x / nbj, j0 = (blockIdx.x % nbj) * BT;
  const int m0 = blockIdx.y * BM;

  for (int i = tid; i < n * n; i += NT) bt_s[i] = bt[i];
  for (int i = tid; i < C * kM; i += NT) inv_s[i] = inv[i];
  for (int i = tid; i < C; i += NT) pos_s[i] = pos[i];
  for (int i = tid; i <= S2; i += NT) off_s[i] = sub_off[i];
  __syncthreads();

  // one pipeline stage: the block's R cell rows (rows past Gy read as zero)
  // and the weight slice ww[:, n0:n0+BN, m0:m0+BM]; ragged edges zero-filled
  const float* crow = cells + ((size_t)b * Gy + j0) * PM * N;
  auto stage = [&](int buf, int n0) {
    float* zd = z_s + buf * L.z;
    const int nz = R * PM * (BN / 4);  // 16-byte copies: N % 4 == 0
    for (int e = tid; e < nz; e += NT) {
      const int nl = (e % (BN / 4)) * 4, rc = e / (BN / 4);  // rc = row * PM + sub-row
      const int nn = n0 + nl;
      const bool ok = j0 + rc / PM < Gy && nn < N;
      cp_async(zd + rc * BN + nl, ok ? crow + (size_t)rc * N + nn : cells, ok, 16);
    }
    float* wd = w_s + buf * L.w;
    const int nw = C * BN * (BM / VW);
    for (int e = tid; e < nw; e += NT) {
      const int mm = (e % (BM / VW)) * VW, nl = (e / (BM / VW)) % BN, k = e / (BM / VW * BN);
      const int nn = n0 + nl, mc = m0 + mm;
      const bool ok = nn < N && mc < M;
      cp_async(wd + (k * BN + nl) * BM + mm, ok ? ww + ((size_t)k * N + nn) * M + mc : ww, ok, 4 * VW);
    }
    cp_async_commit();
  };

  // pre-PE: tile tl of phase s is z[u] = row tl + u/2, sub-row 2*s + u%2
  // (u < n); xw[s*n + v] = sum_u B^T[v, u] z[u], into xw_s[s*n + v][c][tl]
  auto transform = [&](int buf) {
    const float* zb = z_s + buf * L.z;
    for (int idx = tid; idx < BT * phases * BN; idx += NT) {
      const int nl = idx % BN, s = (idx / BN) % phases, tl = idx / (BN * phases);
      float z[kMaxN];
#pragma unroll
      for (int u = 0; u < kMaxN; ++u)
        z[u] = u < n ? zb[((tl + u / kM) * PM + s * kM + u % kM) * BN + nl] : 0.0f;
      for (int v = 0; v < n; ++v) {
        float acc = 0.0f;
#pragma unroll
        for (int u = 0; u < kMaxN; ++u)
          if (u < n) acc = fmaf(bt_s[v * n + u], z[u], acc);
        xw_s[((s * n + v) * BN + nl) * XT + tl] = acc;
      }
    }
  };

  float d[kPG][4][MC];
#pragma unroll
  for (int kk = 0; kk < kPG; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < MC; ++j) d[kk][i][j] = 0.0f;

  const int n_chunks = C > 0 ? (N + BN - 1) / BN : 0;
  if (n_chunks > 0) stage(0, 0);
  if (n_chunks > 1) stage(1, BN);
  for (int c = 0; c < n_chunks; ++c) {
    const int buf = c & 1;
    if (c + 1 < n_chunks) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();
    transform(buf);
    __syncthreads();

    // com-PE: each thread's positions, accumulated over the whole N loop
    const float* wbuf = w_s + buf * L.w + tm * MC;
#pragma unroll
    for (int kk = 0; kk < kPG; ++kk) {
      const int k = kk * kG + g;
      if (k < C) {
        const float* xp = xw_s + pos_s[k] * BN * XT + tt * 4;
        const float* wp = wbuf + k * BN * BM;
#pragma unroll
        for (int nl = 0; nl < BN; ++nl) {
          const float4 xa = *reinterpret_cast<const float4*>(xp + nl * XT);
          const float xv[4] = {xa.x, xa.y, xa.z, xa.w};
          float wv[MC];
          if constexpr (MC == 4) {
            const float4 wa = *reinterpret_cast<const float4*>(wp + nl * BM);
            wv[0] = wa.x, wv[1] = wa.y, wv[2] = wa.z, wv[3] = wa.w;
          } else {
#pragma unroll
            for (int j = 0; j < MC; ++j) wv[j] = wp[nl * BM + j];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < MC; ++j) d[kk][i][j] = fmaf(xv[i], wv[j], d[kk][i][j]);
        }
      }
    }
    __syncthreads();
    if (c + 2 < n_chunks) stage(buf, (c + 2) * BN);
  }

  // post-PE: every position's products in shared memory (the stages are
  // free: the last __syncthreads of the loop has passed), then the fold
#pragma unroll
  for (int kk = 0; kk < kPG; ++kk) {
    const int k = kk * kG + g;
    if (k < C) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < MC; ++j) red_s[(k * BT + tt * 4 + i) * BM + tm * MC + j] = d[kk][i][j];
    }
  }
  __syncthreads();

  for (int idx = tid; idx < BT * BM; idx += NT) {
    const int ml = idx % BM, tl = idx / BM;
    const int j = j0 + tl, mc = m0 + ml;
    if (j >= ty || mc >= M) continue;
    const float sc = scale ? scale[mc] : 1.0f;
    const float bi = bias ? bias[mc] : 0.0f;
    for (int s = 0; s < S2; ++s) {
      float y[kM] = {0.0f, 0.0f};
      for (int k = off_s[s]; k < off_s[s + 1]; ++k) {
        const float v = red_s[(k * BT + tl) * BM + ml];
#pragma unroll
        for (int a = 0; a < kM; ++a) {
          const float iv = inv_s[k * kM + a];
          if (iv != 0.0f) y[a] = fmaf(iv, v, y[a]);
        }
      }
#pragma unroll
      for (int a = 0; a < kM; ++a) {
        if (out_mode == 0) {  // scratch: out[b, j, s*2 + a, m]
          out[(((size_t)b * ty + j) * S2 * kM + s * kM + a) * M + mc] = y[a];
        } else {  // nlc: row 2*S*j + S*a + s of the padded interleave
          out[((size_t)b * ty * kM * S + (size_t)kM * S * j + S * a + s) * M + mc] = activate(y[a] * sc + bi, act);
        }
      }
    }
  }
}

// The 1D engine on the tensor cores (fwd_core.cuh): one block per (BT
// consecutive tiles of one sequence, BM channels m), the M tiles of one tile
// block adjacent in the launch.  A chunk stages the R = BT + q - 1 cell rows
// the block's tiles read (all phases, 8 channels, rows of 12 words) once;
// the A pass forms xw = B^T z per phase at the Winograd positions the pass
// reads (B^T from the caller: F(2,4)'s entries are not +-1).  A pass holds
// at most PMAX packed positions of at most SMAX sub-filters (the decoder's 6
// positions of 2 in one); every k-step's products fold into the outputs of
// their sub-filter, which go to the store once its last position is in (a
// sub-filter split over two passes carries its outputs across).  An empty
// sub-filter (K_D < S) writes act(bias) in nlc mode, zeros in scratch mode.
template <class K>
__global__ void __launch_bounds__(K::kThreads, K::kMinBlocks)
engine1d_mma_kernel(const float* __restrict__ cells, const float* __restrict__ ww, const float* __restrict__ inv,
                    const int* __restrict__ sub_off, const float* __restrict__ bt, const int* __restrict__ fplan,
                    const float* __restrict__ scale, const float* __restrict__ bias, float* __restrict__ out, int B,
                    int Gy, int N, int M, int ty, int n, int phases, int S2, int S, int out_mode, int act,
                    int npass, int nslot, int npos) {
  constexpr int BT = K::BT, RS = fwd::BN + 4;
  const int q = (n + kM - 1) / kM, R = BT + q - 1, PM = phases * kM;
  const int C = fplan[npass];
  const fwd::Layout L(BT, K::BM, nslot, npos, R * PM * RS);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* bt_s = smem + L.floats;                             // [n][n]
  float* inv_s = bt_s + kMaxN * kMaxN;                       // [C][2]
  int* off_s = reinterpret_cast<int*>(inv_s + kMaxPos * kM);  // [S2 + 1]
  int* plan_s = off_s + kMaxSub + 1;

  const int tid = threadIdx.x;
  const int n_mt = (M + K::BM - 1) / K::BM, nbj = (ty + BT - 1) / BT;
  const int tb = blockIdx.x / n_mt, m0 = blockIdx.x % n_mt * K::BM;
  const int b = tb / nbj, j0 = tb % nbj * BT;
  for (int i = tid; i < n * n; i += K::kThreads) bt_s[i] = bt[i];
  for (int i = tid; i < C * kM; i += K::kThreads) inv_s[i] = inv[i];
  for (int i = tid; i <= S2; i += K::kThreads) off_s[i] = sub_off[i];
  const fwd::Plan plan = fwd::load_plan<K>(plan_s, fplan, npass, C);
  __syncthreads();
  const int nck = (N + fwd::BN - 1) / fwd::BN;

  // chunk c's raw rows: cell rows j0 .. j0 + R of sequence b (rows past Gy
  // zero), every sub-row, channels n0 .. n0 + 8, at raw[(row*PM + sub)*RS + n]
  const float* crow = cells + ((size_t)b * Gy + j0) * PM * N;
  auto stage_a = [&](float* raw, int c) {
    const int n0 = c % nck * fwd::BN;
    for (int e = tid; e < R * PM * 2; e += K::kThreads) {
      const int seg = e & 1, rc = e >> 1, nn = n0 + 4 * seg;
      const bool ok = j0 + rc / PM < Gy && nn < N;
      fwd::cp_async(raw + rc * RS + 4 * seg, ok ? crow + (size_t)rc * N + nn : cells, ok, 16);
    }
  };
  // the A pass: tile tl of phase s is z[u] = row tl + u/2, sub-row 2s + u%2
  // (u < n); xw[s*n + v] = sum_u B^T[v, u] z[u] at each Winograd position
  // q = s*n + v the pass reads (n loads and multiply-adds a value), for
  // tiles 16f + gq and + 8, channel 2tq + e, into q's slot
  auto prep_a = [&](uint32_t* split, const float* raw, int c) {
    const int* qs = plan.qslot + c / nck * fwd::kMaxQ;
    for (int it = tid; it < 4 * BT; it += K::kThreads) {
      const int e = it & 1, lane = (it >> 1) & 31, f = it >> 6;
      const float* r = raw + (16 * f + (lane >> 2)) * PM * RS + 2 * (lane & 3) + e;
      for (int q = 0; q < phases * n; ++q) {
        const int sl = qs[q];
        if (sl < 0) continue;  // uniform over the block
        const int s = q / n, v = q - s * n;
        const float* bv = bt_s + v * n;
        float x0 = 0.0f, x1 = 0.0f;
        for (int u = 0; u < n; ++u) {
          const int o = ((u / kM) * PM + s * kM + u % kM) * RS;
          x0 = fmaf(bv[u], r[o], x0);
          x1 = fmaf(bv[u], r[8 * PM * RS + o], x1);
        }
        fwd::put_a<K>(split, L, sl, f, lane, e, x0, x1);
      }
    }
  };
  // sub-filter s's 2 outputs of this thread's tiles and channels m, m + 1
  auto store = [&](int s, const float (&ys)[K::M2][K::FA][K::FB][4]) {
#pragma unroll
    for (int fa = 0; fa < K::FA; ++fa)
#pragma unroll
      for (int fb = 0; fb < K::FB; ++fb)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = j0 + fwd::out_tile<K>(fa, 2 * h), m = m0 + fwd::out_m<K>(fb, 0);
          if (j >= ty || m >= M) continue;
#pragma unroll
          for (int a = 0; a < kM; ++a) {
            float2 v = make_float2(ys[a][fa][fb][2 * h], ys[a][fa][fb][2 * h + 1]);
            size_t o;
            if (out_mode == 0) {  // scratch: out[b, j, s*2 + a, m]
              o = (((size_t)b * ty + j) * S2 * kM + s * kM + a) * M + m;
            } else {  // nlc: row 2*S*j + S*a + s of the padded interleave
              o = ((size_t)b * ty * kM * S + (size_t)kM * S * j + S * a + s) * M + m;
              v.x = activate(v.x * (scale ? scale[m] : 1.0f) + (bias ? bias[m] : 0.0f), act);
              v.y = activate(v.y * (scale ? scale[m + 1] : 1.0f) + (bias ? bias[m + 1] : 0.0f), act);
            }
            *reinterpret_cast<float2*>(out + o) = v;
          }
        }
  };
  fwd::Out<K> y;
#pragma unroll
  for (int k = 0; k < K::SMAX; ++k) fwd::zero<K>(y[k]);
  // a pass's end: each sub-filter whose last position was in it is stored;
  // one that runs on into the next pass moves to its slot 0
  auto pass_end = [&](int pass) {
    const int hi = plan.pass_off[pass + 1];
#pragma unroll
    for (int k = 0; k < K::SMAX; ++k) {
      const int s = plan.psub[pass * K::SMAX + k];
      if (s < 0) continue;
      if (off_s[s + 1] <= hi) {
        store(s, y[k]);
        fwd::zero<K>(y[k]);
      } else if (k > 0) {
#pragma unroll
        for (int a = 0; a < K::M2; ++a)
#pragma unroll
          for (int fa = 0; fa < K::FA; ++fa)
#pragma unroll
            for (int fb = 0; fb < K::FB; ++fb)
#pragma unroll
              for (int j = 0; j < 4; ++j) y[0][a][fa][fb][j] = y[k][a][fa][fb][j];
        fwd::zero<K>(y[k]);
      }
    }
  };
  fwd::contract<K>(y, smem, L, plan, npass, nck, ww, N, M, m0, inv_s, stage_a, prep_a, pass_end);
  for (int s = 0; s < S2; ++s)
    if (off_s[s] == off_s[s + 1]) store(s, y[0]);  // y[0] is zero after the last pass
}

template <int NT_T_, int NT_M_, int BN_, int VW_, int MC_>
struct Conf {
  static constexpr bool kMma = false;
  static constexpr int NT_T = NT_T_, NT_M = NT_M_, BN = BN_, VW = VW_, MC = MC_;
  using K = Cfg<NT_T, NT_M, BN, MC>;
  static constexpr int BT = K::BT, BM = K::BM, PMAX = 0, SMAX = 0;
};
template <class K_>
struct Mma {
  static constexpr bool kMma = true;
  using K = K_;
  static constexpr int BT = K::BT, BM = K::BM, PMAX = K::PMAX, SMAX = K::SMAX;
  // the pipeline, B^T, inv, the sub-filter offsets and the plan
  static size_t smem_bytes(int q, int phases, int C, int npass, int nslot, int npos) {
    const fwd::Layout L(BT, BM, nslot, npos, (BT + q - 1) * phases * kM * (fwd::BN + 4));
    return sizeof(float) * (L.floats + kMaxN * kMaxN + kMaxPos * kM) +
           sizeof(int) * (kMaxSub + 1 + fwd::Plan::ints(npass, C, K::SMAX));
  }
};

template <class Cf>
auto e1_kernel() {
  if constexpr (Cf::kMma)
    return engine1d_mma_kernel<typename Cf::K>;
  else
    return engine1d_kernel<Cf::NT_T, Cf::NT_M, Cf::BN, Cf::VW, Cf::MC>;
}

// The block configurations, by number (engine.py's
// INSTANTIATIONS["winograd_conv1d_fused_engine"], in this order), handed to
// f: 0 the fp32 CUDA-core kernel: 32 tiles x 32 channels, 256 threads,
// 16-byte weight copies where M % 4 == 0 and M >= 32; for few or ragged
// output channels 128 threads and 4-byte weight copies, 128 tiles x 1
// channel for the mono waveform (no dead channels), else 128 tiles x 4
// channels.  The tensor cores, at most 9 packed positions of 2 sub-filters a
// pass (the decoder's K4S2 layers in one): 1, 64 tiles x 128 channels, 8
// warps of 32 x 32; 2, 64 x 64, 8 warps of 32 x 16, two blocks an SM.
template <class F>
int with_conf(int conf, int M, F&& f) {
  if (conf == 1) return f(Mma<fwd::Core<2, 4, 2, 4, 9, 2, 2, 1>>{});
  if (conf == 2) return f(Mma<fwd::Core<2, 4, 2, 2, 9, 2, 2, 2>>{});
  if (M >= 32 && M % 4 == 0) return f(Conf<8, 8, 16, 4, 4>{});
  return M == 1 ? f(Conf<32, 1, 8, 1, 1>{}) : f(Conf<32, 1, 8, 1, 4>{});
}

// Whether instantiation conf takes M output channels: the tensor cores
// where M % 4 == 0 and M >= 16 (weights in 16-byte copies: the wrapper has
// checked their alignment)
bool takes(int conf, int M) {
  switch (conf) {
    case 0: return true;                  // cuda_cores
    case 1: return M % 4 == 0 && M >= 16;  // mma_64x128
    case 2: return M % 4 == 0 && M >= 16;  // mma_64x64
  }
  return false;
}

// The plan's own choice for B sequences of ty tiles and M channels: the
// tensor cores where they take M and their blocks, 64 tiles each, fill
// every SM of the card at least once (64 x 128 for M >= 128, else 64 x 64:
// each the faster of the configurations timed on an H100 at the decoder's
// deconv0 and deconv1, PERF.md).  On fewer (the decoder at batch 1: 33 and
// 65 blocks on 132 SMs) the CUDA-core kernel's 32-tile blocks keep more of
// the card busy and finish first (PERF.md).
int default_conf(int B, int ty, int M) {
  if (!takes(1, M)) return 0;
  const int conf = M >= 128 ? 1 : 2;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
                                                 cudaSuccess)
    return 0;
  const bool fills = with_conf(conf, M, [&](auto cf) {
    using Cf = decltype(cf);
    return (int)((long long)B * ((ty + Cf::BT - 1) / Cf::BT) * ((M + Cf::BM - 1) / Cf::BM) >= sms);
  }) != 0;
  return fills ? conf : 0;
}

}  // namespace

// Plain C entry points (bound with ctypes).  Every pointer is a device
// pointer: cells (B, Gy, phases*2, N), ww (C, N, M), inv (C, 2), pos (C,)
// into the phases*n positions, sub_off (S2 + 1,), bt (n, n) row-major,
// scale and bias (M,) or null, out (B, ty, S2*2, M) in out mode 0
// ("scratch") or (B, ty*2*S, M) in out mode 1 ("nlc", S2 == S).  Takes
// N % 4 == 0, 4 <= n <= 6 (n <= kMaxN, ceil(n/2) <= kMaxQ), phases*2 <= 8,
// phases*n <= 16, C <= 16, S2 <= 16; the wrapper checks them.

// The configuration for B sequences of ty tiles and M channels on the
// current device: want -1 takes the plan's (default_conf), want >= 0 asks
// for that instantiation (takes' numbering): a request M cannot take
// returns cudaErrorInvalidValue.  Its shared-memory limit is raised to the
// most any launch of it takes: call once per (B, ty, M, want, device)
// before the first launch.  tile gets (BT, BM, the most positions and
// sub-filters a pass, the instantiation: 0 the CUDA cores, 1 or 2 the tensor
// cores); engine1d_f32 takes the last as conf.
extern "C" int engine1d_plan(int B, int ty, int M, int want, int* tile) {
  const int conf = want < 0 ? default_conf(B, ty, M) : want;
  if (!takes(conf, M)) return (int)cudaErrorInvalidValue;
  return with_conf(conf, M, [&](auto cf) {
    using Cf = decltype(cf);
    using K = typename Cf::K;
    size_t most;
    if constexpr (Cf::kMma)
      most = Cf::smem_bytes(kMaxQ, kMaxPM / kM, kMaxPos, kMaxPos, Cf::PMAX, Cf::PMAX);
    else
      most = Smem(K::BT, K::BM, Cf::BN, K::XT, K::BT + kMaxQ - 1, kMaxPM, kMaxPos, kMaxPos).bytes();
    tile[0] = Cf::BT;
    tile[1] = Cf::BM;
    tile[2] = Cf::PMAX;
    tile[3] = Cf::SMAX;
    tile[4] = conf;
    return (int)cudaFuncSetAttribute(e1_kernel<Cf>(), cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
  });
}

// One launch.  out_mode: 0 = scratch, 1 = nlc.  act: 0 none, 1 relu,
// 2 leaky_relu, 3 tanh (nlc only).  conf: the instantiation engine1d_plan
// handed out.  The tensor-core kernel reads fplan, the pass plan of the C
// packed positions (npass passes, nslot / npos the most Winograd / packed
// positions of a pass: fwd_core.cuh).  Returns cudaGetLastError().
extern "C" int engine1d_f32(const float* cells, const float* ww, const float* inv, const int* pos,
                            const int* sub_off, const float* bt, const int* fplan, const float* scale,
                            const float* bias, float* out, int B, int Gy, int N, int M, int ty, int n, int phases,
                            int S2, int S, int C, int out_mode, int act, int conf, int npass, int nslot,
                            int npos, void* stream) {
  if (!takes(conf, M)) return (int)cudaErrorInvalidValue;
  return with_conf(conf, M, [&](auto cf) {
    using Cf = decltype(cf);
    using K = typename Cf::K;
    const int q = (n + kM - 1) / kM;
    const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    if constexpr (Cf::kMma) {
      const dim3 grid(B * ((ty + K::BT - 1) / K::BT) * ((M + K::BM - 1) / K::BM));
      engine1d_mma_kernel<K><<<grid, K::kThreads, Cf::smem_bytes(q, phases, C, npass, nslot, npos), st>>>(
          cells, ww, inv, sub_off, bt, fplan, scale, bias, out, B, Gy, N, M, ty, n, phases, S2, S, out_mode, act,
          npass, nslot, npos);
    } else {
      const Smem L(K::BT, K::BM, Cf::BN, K::XT, K::BT + q - 1, phases * kM, C, phases * n);
      const dim3 grid(B * ((ty + K::BT - 1) / K::BT), (M + K::BM - 1) / K::BM);
      e1_kernel<Cf>()<<<grid, K::kThreads, L.bytes(), st>>>(cells, ww, inv, pos, sub_off, bt, scale, bias, out, B,
                                                            Gy, N, M, ty, n, phases, S2, S, out_mode, act);
    }
    return (int)cudaGetLastError();
  });
}
