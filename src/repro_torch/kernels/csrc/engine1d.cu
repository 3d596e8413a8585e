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
// What bounds it on an H100: the packed products, 2*T*C*N*M flops on the fp32
// CUDA cores (67 TFLOP/s), at the audio decoder's first two layers (C = 6,
// 256 -> 128 and 128 -> 64 channels); at its mono last layer (M = 1) the
// bytes of the cells, one read of the 64-channel sequence.
//
// What the design does about it (fused_engine.cu's with one axis fewer; the
// TPU's 128-lane padding of N and M and its (C, T_t, M_t) scratch of
// accumulators are not carried over):
//   * one block per (BT consecutive tiles of one sequence, M-tile of BM
//     channels), looping over N in chunks of BN.  Its tiles' windows overlap
//     by q - 1 cell rows, so a chunk stages the BT + q - 1 cell rows the
//     tiles read, once each (the line buffer), in one contiguous run of 16-byte
//     cp.async copies per row, with the weight slice, two stages deep;
//   * the one-sided B^T runs shared-to-shared per phase (n^2 multiply-adds
//     per tile and channel), into xw_s[position][channel][tile];
//   * 4 warp-uniform position groups each keep, in registers for the whole N
//     loop, the products of up to 4 of the C <= 16 packed positions (every
//     sub-filter's) for a 4-tile x 4-channel micro tile, from one float4 of
//     xw and one of weights per channel.  After the N loop the products meet
//     in shared memory and fold through inv (dot_p summed into the S2*2
//     outputs, zeros skipped) once: no (C, T, M) array in device memory.
//     Sums run in one fixed order: no atomics, the same result every run;
//   * M = 1 (the waveform) and ragged M rule out 16-byte weight copies and
//     wide micro tiles: that configuration takes 128 tiles x 4 channels per
//     block and 4-byte weight copies;
//   * an empty sub-filter (K_D < S) writes act(bias) in nlc mode, zeros in
//     scratch mode, as the reference does.
// wgmma (3xTF32), TMA and an N split for small grids are later work.

#include <cuda_runtime.h>
#include <stdint.h>

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
    case 1: return fmaxf(v, 0.0f);
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
// the tiles 4*tt .. 4*tt+3 and the channels 4*tm .. 4*tm+3.
template <int NT_T, int NT_M, int BN>
struct Cfg {
  static constexpr int kThreads = kG * NT_T * NT_M;
  static constexpr int BT = NT_T * 4;  // tiles per block
  static constexpr int BM = NT_M * 4;  // output channels per block
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

template <int NT_T, int NT_M, int BN, int VW>
__global__ void __launch_bounds__(kG * NT_T * NT_M)
engine1d_kernel(const float* __restrict__ cells, const float* __restrict__ ww, const float* __restrict__ inv,
                const int* __restrict__ pos, const int* __restrict__ sub_off, const float* __restrict__ bt,
                const float* __restrict__ scale, const float* __restrict__ bias, float* __restrict__ out,
                int B, int Gy, int N, int M, int ty, int n, int phases, int S2, int S, int out_mode, int act) {
  using K = Cfg<NT_T, NT_M, BN>;
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

  float d[kPG][4][4];
#pragma unroll
  for (int kk = 0; kk < kPG; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) d[kk][i][j] = 0.0f;

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
    const float* wbuf = w_s + buf * L.w + tm * 4;
#pragma unroll
    for (int kk = 0; kk < kPG; ++kk) {
      const int k = kk * kG + g;
      if (k < C) {
        const float* xp = xw_s + pos_s[k] * BN * XT + tt * 4;
        const float* wp = wbuf + k * BN * BM;
#pragma unroll
        for (int nl = 0; nl < BN; ++nl) {
          const float4 xa = *reinterpret_cast<const float4*>(xp + nl * XT);
          const float4 wa = *reinterpret_cast<const float4*>(wp + nl * BM);
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
        *reinterpret_cast<float4*>(red_s + (k * BT + tt * 4 + i) * BM + tm * 4) =
            make_float4(d[kk][i][0], d[kk][i][1], d[kk][i][2], d[kk][i][3]);
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

template <int NT_T_, int NT_M_, int BN_, int VW_>
struct Conf {
  static constexpr int NT_T = NT_T_, NT_M = NT_M_, BN = BN_, VW = VW_;
  using K = Cfg<NT_T, NT_M, BN>;
};
#define E1_KERNEL(C) engine1d_kernel<C::NT_T, C::NT_M, C::BN, C::VW>

// The block configuration for M, handed to f as a Conf: 32 tiles x 32
// channels, 256 threads, 16-byte weight copies; or, for few or ragged
// output channels (the mono waveform), 128 tiles x 4 channels, 128 threads,
// 4-byte weight copies.
template <class F>
int with_conf(int M, F&& f) {
  if (M >= 32 && M % 4 == 0) return f(Conf<8, 8, 16, 4>{});
  return f(Conf<32, 1, 8, 1>{});
}

}  // namespace

// Plain C entry points (bound with ctypes).  Every pointer is a device
// pointer: cells (B, Gy, phases*2, N), ww (C, N, M), inv (C, 2), pos (C,)
// into the phases*n positions, sub_off (S2 + 1,), bt (n, n) row-major,
// scale and bias (M,) or null, out (B, ty, S2*2, M) in out mode 0
// ("scratch") or (B, ty*2*S, M) in out mode 1 ("nlc", S2 == S).  Takes
// N % 4 == 0, 4 <= n <= 6 (n <= kMaxN, ceil(n/2) <= kMaxQ), phases*2 <= 8,
// phases*n <= 16, C <= 16, S2 <= 16; the wrapper checks them.

// The shared memory a launch needs, and the configuration's limit raised to
// the most any launch of it takes, on the current device: call once per
// (M, device) before the first launch.
extern "C" int engine1d_plan(int M) {
  return with_conf(M, [&](auto conf) {
    using C = decltype(conf);
    using K = typename C::K;
    const Smem most(K::BT, K::BM, C::BN, K::XT, K::BT + kMaxQ - 1, kMaxPM, kMaxPos, kMaxPos);
    return (int)cudaFuncSetAttribute(E1_KERNEL(C), cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most.bytes());
  });
}

// One launch.  out_mode: 0 = scratch, 1 = nlc.  act: 0 none, 1 relu,
// 2 leaky_relu, 3 tanh (nlc only).  Returns cudaGetLastError().
extern "C" int engine1d_f32(const float* cells, const float* ww, const float* inv, const int* pos,
                            const int* sub_off, const float* bt, const float* scale, const float* bias, float* out,
                            int B, int Gy, int N, int M, int ty, int n, int phases, int S2, int S, int C,
                            int out_mode, int act, void* stream) {
  return with_conf(M, [&](auto conf) {
    using Cf = decltype(conf);
    using K = typename Cf::K;
    const int q = (n + kM - 1) / kM;
    const Smem L(K::BT, K::BM, Cf::BN, K::XT, K::BT + q - 1, phases * kM, C, phases * n);
    dim3 grid(B * ((ty + K::BT - 1) / K::BT), (M + K::BM - 1) / K::BM);
    E1_KERNEL(Cf)<<<grid, K::kThreads, L.bytes(), reinterpret_cast<cudaStream_t>(stream)>>>(
        cells, ww, inv, pos, sub_off, bt, scale, bias, out, B, Gy, N, M, ty, n, phases, S2, S, out_mode, act);
    return (int)cudaGetLastError();
  });
}
