// Epilogue-fused Winograd DeConv engine for Hopper (sm_90a), fp32.
//
// Replaces src/repro/kernels/engine.py::fused_engine with out_mode "nhwc" or
// "cells" (kernel body _fused_epi_kernel, the pallas_call at engine.py:817),
// at the deconv corner: one input phase, stride S, S^2 sub-filters whose
// outputs interleave.  The plain PyTorch version is
// repro_torch/kernels/ref.py::fused_epilogue_engine_ref.  Out mode 2
// ("scratch") replaces the same function's out_mode "scratch" (kernel body
// _fused_kernel, the pallas_call at engine.py:739): the same line buffer,
// adder network and contraction, then the folded tile outputs stored as
// they are, (B, ty, tx, S^2*m*m, M) sub-filter-major, with no affine, no
// activation and no depth-to-space; its plain version is
// ref.py::fused_pre_engine_ref.  (The Pallas kernel returns a block-padded
// array; this one the exact shape.)
//
// What it computes, for one deconv layer under F(2x2, 3x3) (m = 2, n = 4):
//   for every tile (b, j, t) of the flattened T = B*ty*tx tiles, read its 2x2
//   window of m x m cells (the line buffer), form xw = B^T Z B (adds only:
//   every entry of B^T is 0 or +-1), contract the packed positions over the
//   input channels, dot_p[t, m] = sum_n xw[t, pos_p, n] * ww[p, n, m], apply
//   the sparse inverse transform y[s(p), a] += inv[p, a] * dot_p, then the
//   epilogue act(scale * y + bias) and the stride-S depth-to-space: sub-pixel
//   (ry, rx, p, q) of tile (j, t) is interleave row m*S*j + S*p + ry, column
//   m*S*t + S*q + rx.  "nhwc" writes the cropped image (B, H_O, W_O, M);
//   "cells" writes the next layer's exact cell layout (B, ty*S, tx*S, m*m, M)
//   with zeros outside [P, P+H_O) x [P, P+W_O); "scratch" writes y itself,
//   out[(b, j, t), s*m*m + a, m].
//
// What bounds it on an H100: at the serving batch sizes the packed weights
// (102.8 MB for DCGAN's first layer, more than the 50 MB L2) set a floor of
// bytes / HBM rate, and at batch 8 the com-PE products (2*T*C*N*M flops on
// the fp32 CUDA cores, 67 TFLOP/s) take longer than that.  So it is bound by
// fp32 operations at batch 8 and by weight bytes at batch 1.
//
// What the design does about it:
//   * one block per (T-tile of BT tiles, sub-filter s, M-tile of BM
//     channels).  A block only touches the packed positions of its own
//     sub-filter (at most n^2 = 16).  Its threads form G = 8 position groups;
//     group g keeps, in registers for the whole N loop, the products of
//     positions g and g + 8 for a 4-tile x 4-channel micro tile, fed by one
//     float4 of xw and one float4 of weights per input channel (16 FMAs per
//     two shared loads).  After the N loop the products meet in shared memory
//     and the sparse inverse transform, the epilogue and the interleaved store
//     run once: no (C, T, M) scratch in device memory.  Splitting by
//     sub-filter also gives S^2 times more blocks when T is small (batch 1);
//   * the N loop is a two-stage cp.async pipeline: while chunk c computes,
//     chunk c+1's raw 4x4 cell windows and weight slice are in flight to
//     shared memory, without passing through registers.  The B-transform then
//     runs shared-to-shared, so no global-load latency sits between two
//     chunks (the first version, with synchronous loads, spent most of its
//     time waiting on them);
//   * when the grid would leave SMs idle or end in a short last wave (batch 1,
//     or DCGAN's first layer, whose 192 blocks make 1.45 waves of one block
//     per SM), the N loop is split over 2-8 blocks; each writes its products
//     to a scratch buffer and the last to arrive sums them in split order, so
//     the result does not depend on arrival order, and resets the group's
//     arrival counter to 0.  fused_engine_plan picks the split from the
//     card's occupancy;
//   * blocks with the same (s, M-tile) and neighbouring T-tiles are adjacent
//     in launch order, so they stream the same weight slice together and the
//     L2 serves the rereads: device-memory weight traffic stays near one pass;
//   * a structurally empty sub-filter (K_D < S) runs no products and writes
//     act(bias), as the reference does (zeros in scratch mode).
// wgmma (3xTF32 for fp32 accuracy), TMA and bf16 are later work; this version
// runs on the fp32 CUDA cores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPos = 16;  // n*n: the most packed positions one sub-filter has

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case 1: return fmaxf(v, 0.0f);
    case 2: return v >= 0.0f ? v : 0.2f * v;  // LEAKY_SLOPE
    case 3: return tanhf(v);
    default: return v;
  }
}

__device__ __forceinline__ void cp_async(float* dst, const float* src, bool pred, int bytes_vec) {
  // global -> shared copy that does not pass through registers; pred false
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

// Block geometry: G warp-uniform position groups x (NT_T x NT_M) threads;
// group g owns the positions k = g, g + G, ... of the block's sub-filter,
// and each thread a TT-tile x TM-channel micro tile.
template <int G, int NT_T, int NT_M, int BN>
struct Cfg {
  static constexpr int PG = kMaxPos / G;  // positions per group
  static constexpr int TT = 4, TM = 4;  // micro tiles are float4 x float4
  static constexpr int kThreads = G * NT_T * NT_M;
  static constexpr int BT = NT_T * TT;  // tiles per block
  static constexpr int BM = NT_M * TM;  // output channels per block
  static constexpr int XT = BT + 4;     // xw row stride: float4-aligned, skewed banks
  static constexpr int kZ = BT * 16 * BN;           // raw 4x4 windows, one stage
  static constexpr int kW = kMaxPos * BN * BM;      // weight slice, one stage
  static constexpr int kXw = kMaxPos * BN * XT;     // transformed tiles
  static constexpr int kStage = 2 * (kZ + kW) + kXw;
  static constexpr int kRed = kMaxPos * BT * BM;    // per-position products, reuses the space
  static constexpr int kBig = kStage > kRed ? kStage : kRed;
  static constexpr size_t kSmemBytes = sizeof(float) * (kBig + kMaxPos * 4) + sizeof(int) * (kMaxPos + BT);
};

template <int G, int NT_T, int NT_M, int BN, int VW, bool SPLIT>
__global__ void __launch_bounds__(G * NT_T * NT_M)
fused_epi_kernel(const float* __restrict__ cells, const float* __restrict__ ww,
                 const float* __restrict__ inv, const int* __restrict__ pos,
                 const int* __restrict__ sub_off, const float* __restrict__ scale,
                 const float* __restrict__ bias, float* __restrict__ out, int B, int Gy,
                 int Gx, int N, int M, int S, int ty, int tx, int P, int out_h, int out_w,
                 int out_mode, int act, int splits, float* __restrict__ partial,
                 int* __restrict__ counters) {
  using K = Cfg<G, NT_T, NT_M, BN>;
  constexpr int PG = K::PG;
  constexpr int BT = K::BT, BM = K::BM, XT = K::XT, NT = K::kThreads, TT = K::TT, TM = K::TM;
  extern __shared__ float4 smem4[];
  float* z_s = reinterpret_cast<float*>(smem4);  // 2 x [BT][16][BN]
  float* ww_s = z_s + 2 * K::kZ;                 // 2 x [16][BN][BM]
  float* xw_s = ww_s + 2 * K::kW;                // [16][BN][XT]
  float* red_s = z_s;                            // [16][BT][BM] after the N loop
  float* inv_s = z_s + K::kBig;                  // [16][4]
  int* pos_s = reinterpret_cast<int*>(inv_s + kMaxPos * 4);
  int* tile_s = pos_s + kMaxPos;                 // [BT] first cell of each tile, -1 past T

  const int s = blockIdx.y;
  const int t0 = blockIdx.x * BT;
  if (!SPLIT) splits = 1;  // compiled out of the unsplit variant
  const int mt = blockIdx.z / splits, ks = blockIdx.z % splits;  // M-tile, N split
  const int m0 = mt * BM;
  const int lo = sub_off[s];
  const int cnt = sub_off[s + 1] - lo;
  const int tid = threadIdx.x;
  const int g = tid / (NT_T * NT_M);  // position group, uniform per warp
  const int rem = tid % (NT_T * NT_M);
  const int tt = rem / NT_M, tm = rem % NT_M;
  const int T = B * ty * tx;
  const int tpi = ty * tx;

  if (tid < kMaxPos * 4) inv_s[tid] = (tid / 4 < cnt) ? inv[(lo + tid / 4) * 4 + tid % 4] : 0.0f;
  if (tid < kMaxPos) pos_s[tid] = tid < cnt ? pos[lo + tid] : 0;
  for (int tl = tid; tl < BT; tl += NT) {
    const int t = t0 + tl;
    const int b = t / tpi, rm = t - b * tpi, jy = rm / tx, jx = rm - jy * tx;
    tile_s[tl] = t < T ? (b * Gy + jy) * Gx + jx : -1;
  }
  __syncthreads();

  // one pipeline stage, asynchronously: the raw 4x4 cell window of every
  // tile (the line buffer) and this sub-filter's weight slice
  // ww[lo+k, n0:n0+BN, m0:m0+BM]; ragged edges are zero-filled
  auto stage = [&](int buf, int n0) {
    constexpr int kZv = BT * 16 * BN / 4;  // 16-byte copies: N % 4 == 0
    static_assert(kZv % NT == 0, "staging must divide evenly");
    float* zd = z_s + buf * K::kZ;
#pragma unroll
    for (int r = 0; r < kZv / NT; ++r) {
      const int e = tid + r * NT;
      const int nl = (e % (BN / 4)) * 4, zi = (e / (BN / 4)) % 16, tl = e / (4 * BN);
      const int base = tile_s[tl], n = n0 + nl;
      const int a = zi / 4, c = zi % 4;  // window row / column
      const bool ok = base >= 0 && n < N;
      const size_t off = ((size_t)(base + (a / 2) * Gx + c / 2) * 4 + (a % 2) * 2 + c % 2) * N + n;
      cp_async(zd + (tl * 16 + zi) * BN + nl, ok ? cells + off : cells, ok, 16);
    }
    constexpr int kWv = kMaxPos * BN * BM / VW;
    static_assert(kWv % NT == 0, "staging must divide evenly");
    float* wd = ww_s + buf * K::kW;
#pragma unroll
    for (int r = 0; r < kWv / NT; ++r) {
      const int e = tid + r * NT;
      const int mm = (e % (BM / VW)) * VW, nl = (e / (BM / VW)) % BN, k = e / (BM / VW * BN);
      const int n = n0 + nl, mc = m0 + mm;
      if (k < cnt) {
        const bool ok = n < N && mc < M;
        const float* src = ok ? ww + ((size_t)(lo + k) * N + n) * M + mc : ww;
        cp_async(wd + (k * BN + nl) * BM + mm, src, ok, 4 * VW);
      }
    }
    cp_async_commit();
  };

  // pre-PE: B^T Z B for F(2,3), B^T = [[1,0,-1,0],[0,1,1,0],[0,-1,1,0],[0,1,0,-1]],
  // adds only, from the staged windows into xw_s[pos][n][tile]
  auto transform = [&](int buf) {
    static_assert((BT * BN) % NT == 0, "transform must divide evenly");
    const float* zb = z_s + buf * K::kZ;
#pragma unroll
    for (int r = 0; r < BT * BN / NT; ++r) {
      const int idx = tid + r * NT;
      const int nl = idx % BN, tl = idx / BN;
      float z[4][4];
#pragma unroll
      for (int zi = 0; zi < 16; ++zi) z[zi / 4][zi % 4] = zb[(tl * 16 + zi) * BN + nl];
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
        float* dst = xw_s + ((u * 4) * BN + nl) * XT + tl;
        dst[0 * BN * XT] = r4[u][0] - r4[u][2];
        dst[1 * BN * XT] = r4[u][1] + r4[u][2];
        dst[2 * BN * XT] = r4[u][2] - r4[u][1];
        dst[3 * BN * XT] = r4[u][1] - r4[u][3];
      }
    }
  };

  float d[PG][TT][TM];
#pragma unroll
  for (int kk = 0; kk < PG; ++kk)
#pragma unroll
    for (int i = 0; i < TT; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j) d[kk][i][j] = 0.0f;

  int xoff[PG];
#pragma unroll
  for (int kk = 0; kk < PG; ++kk) xoff[kk] = pos_s[kk * G + g] * BN * XT + tt * TT;

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
    transform(buf);
    __syncthreads();

    // com-PE: each thread's positions, accumulated over the whole N loop
    const float* wbuf = ww_s + buf * K::kW + tm * TM;
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
          for (int i = 0; i < TT; ++i)
#pragma unroll
            for (int j = 0; j < TM; ++j) d[kk][i][j] = fmaf(xv[i], wv[j], d[kk][i][j]);
        }
      }
    }
    __syncthreads();
    if (c + 2 < n_chunks) stage(buf, (c_lo + c + 2) * BN);
  }

  // post-PE: gather every position's products in shared memory, then the
  // sparse inverse transform, epilogue and depth-to-space store
#pragma unroll
  for (int kk = 0; kk < PG; ++kk) {
    const int k = kk * G + g;
    if (k < cnt) {
#pragma unroll
      for (int i = 0; i < TT; ++i)
        *reinterpret_cast<float4*>(red_s + (k * BT + tt * TT + i) * BM + tm * TM) =
            make_float4(d[kk][i][0], d[kk][i][1], d[kk][i][2], d[kk][i][3]);
    }
  }
  __syncthreads();

  if (SPLIT) {
    // split N: every block of the group writes its products; the last one
    // to arrive sums them in split order (deterministic) and runs the
    // epilogue, the others leave
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
      // every block of the group has arrived: leave the counter at 0 for
      // the next launch, so the caller zeroes the buffer only once
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

  const int ry = s / S, rx = s % S;
  for (int idx = tid; idx < BT * BM; idx += NT) {
    const int ml = idx % BM, tl = idx / BM;
    const int t = t0 + tl, mc = m0 + ml;
    if (t >= T || mc >= M) continue;
    const int b = t / tpi, rm = t - b * tpi;
    const int jy = rm / tx, jx = rm - jy * tx;
    const float sc = scale ? scale[mc] : 1.0f;
    const float bi = bias ? bias[mc] : 0.0f;
    float y[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int k = 0; k < cnt; ++k) {
      const float v = red_s[(k * BT + tl) * BM + ml];
#pragma unroll
      for (int a = 0; a < 4; ++a) y[a] = fmaf(inv_s[k * 4 + a], v, y[a]);
    }
    if (out_mode == 2) {  // scratch: the folded products, no epilogue
      float* o = out + ((size_t)t * S * S * 4 + s * 4) * M + mc;
#pragma unroll
      for (int a = 0; a < 4; ++a) o[(size_t)a * M] = y[a];
      continue;
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float v = activate(y[a] * sc + bi, act);
      const int row = 2 * S * jy + S * (a / 2) + ry;
      const int col = 2 * S * jx + S * (a % 2) + rx;
      if (out_mode == 0) {
        const int orow = row - P, ocol = col - P;
        if (orow >= 0 && orow < out_h && ocol >= 0 && ocol < out_w)
          out[(((size_t)b * out_h + orow) * out_w + ocol) * M + mc] = v;
      } else {
        const bool inside = row >= P && row < P + out_h && col >= P && col < P + out_w;
        const size_t cell = ((size_t)b * (ty * S) + row / 2) * (tx * S) + col / 2;
        out[(cell * 4 + (row % 2) * 2 + col % 2) * M + mc] = inside ? v : 0.0f;
      }
    }
  }
}

template <int G_, int NT_T_, int NT_M_, int BN_, int VW_>
struct Conf {
  static constexpr int G = G_, NT_T = NT_T_, NT_M = NT_M_, BN = BN_, VW = VW_;
  using K = Cfg<G, NT_T, NT_M, BN>;
};
#define FE_KERNEL(C, SPLIT) fused_epi_kernel<C::G, C::NT_T, C::NT_M, C::BN, C::VW, SPLIT>

// The block configuration for M, handed to f as a Conf.  (N % 4 == 0 is the
// caller's to check: cell windows move in 16-byte copies.)
template <class F>
int with_conf(int M, F&& f) {
  // 32 tiles x 32 channels per block, 8 position groups, 512 threads;
  // weights in 16-byte copies
  if (M >= 32 && M % 4 == 0) return f(Conf<8, 8, 8, 16, 4>{});
  // few (or ragged) output channels, as the RGB layer: 64 tiles x 4
  // channels per block, 128 threads, weights in 4-byte copies
  return f(Conf<8, 16, 1, 8, 1>{});
}

}  // namespace

// Plain C entry points (bound with ctypes).  Every pointer is a device pointer.

// How many ways to split the N loop, and the scratch it needs: the split
// count minimises the waves of blocks over the card's resident block slots,
// times the work per block (1/k), times a 25% cost per extra split for the
// partials' round trip and the shorter pipelines; at least 4 chunks per
// split.  scratch_floats / counters are 0 when
// the split count is 1.  It also raises the block configuration's
// shared-memory limit on the current device, which a launch needs: call it
// for M on that device before the first launch.
extern "C" int fused_engine_plan(int B, int ty, int tx, int N, int M, int S, int device,
                                 int* splits, long long* scratch_floats, long long* counters) {
  return with_conf(M, [&](auto conf) {
    using C = decltype(conf);
    using K = typename C::K;
    // both variants' shared-memory limit, here and not at every launch
    cudaError_t err = cudaFuncSetAttribute(FE_KERNEL(C, false), cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)K::kSmemBytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(FE_KERNEL(C, true), cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)K::kSmemBytes);
    int occ = 0, sms = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, FE_KERNEL(C, false), K::kThreads, K::kSmemBytes);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    const long long slots = occ > 0 ? (long long)occ * sms : 1;
    const long long groups = (long long)((B * ty * tx + K::BT - 1) / K::BT) * S * S * ((M + K::BM - 1) / K::BM);
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

// One launch.  scale and bias may be null.  out_mode: 0 = nhwc, 1 = cells,
// 2 = scratch (scale, bias and act unused).
// act: 0 none, 1 relu, 2 leaky_relu, 3 tanh.  splits, partial and counters
// come from fused_engine_plan; the counters are zero on entry and the
// kernel leaves them zero.  Returns cudaGetLastError().
extern "C" int fused_engine_epi_f32(const float* cells, const float* ww, const float* inv,
                                    const int* pos, const int* sub_off, const float* scale,
                                    const float* bias, float* out, int B, int Gy, int Gx,
                                    int N, int M, int S, int ty, int tx, int P, int out_h,
                                    int out_w, int out_mode, int act, int splits, float* partial,
                                    int* counters, void* stream) {
  return with_conf(M, [&](auto conf) {
    using C = decltype(conf);
    using K = typename C::K;
    // the unsplit variant carries no split code at all
    auto kernel = splits > 1 ? FE_KERNEL(C, true) : FE_KERNEL(C, false);
    const int T = B * ty * tx;
    dim3 grid((T + K::BT - 1) / K::BT, S * S, ((M + K::BM - 1) / K::BM) * splits);
    kernel<<<grid, K::kThreads, K::kSmemBytes, reinterpret_cast<cudaStream_t>(stream)>>>(
        cells, ww, inv, pos, sub_off, scale, bias, out, B, Gy, Gx, N, M, S, ty, tx, P, out_h,
        out_w, out_mode, act, splits, partial, counters);
    return (int)cudaGetLastError();
  });
}
