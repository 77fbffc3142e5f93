// Grouped-expert SwiGLU of the dropless MoE FFN, for Hopper (kernel 6).
//
// Replaces no TPU kernel.  The JAX package computes the dropless FFN's
// expert products with XLA einsums over each token's gathered expert
// weights (src/repro/models/moe.py:70-75, `moe_ffn_dropless`): a
// [T, k, d, f_e] copy, 37.7 MB per (token, slot) for qwen3-moe in bf16.
// The port's serving steps run as CUDA graphs, so the FFN needs a
// product whose launch is fixed by shapes and which reads the routing
// from device memory.  For one MoE layer:
//   x [T, d]; order [T*k] int32, the (token, slot) pairs sorted by expert
//   (stable; slot s = token * k + j); offsets [E+1] int32, expert e's
//   sorted rows are [offsets[e], offsets[e+1]); w_gate, w_up [E, d, f];
//   w_down [E, f, d]
//   gate/up launch: act[i] = silu(x[order[i] / k] @ w_gate[e])
//                            * (x[order[i] / k] @ w_up[e])   (sorted rows)
//   down launch:    y[order[i]] = act[i] @ w_down[e]          (slot order)
// The tokens are gathered inside the gate/up launch (no [T*k, d] copy).
// Every row of y is written once, by one CTA, with no atomics and no
// split over the depth: a replay of a captured step equals the eager
// call bit for bit.  The gate-weighted sum over the k slots stays in
// PyTorch, as the reference does it.
//
// Grid, fixed by shapes only: x = the M tiles any routing of the n = T*k
// slots can take, sum_e ceil(n_e / 16) <= (n + min(E, n) * 15) / 16
// (`mg_m_tiles`); y = the 64-column N tiles of the output.  A CTA finds
// its (expert, M tile) from `offsets`: thread e reads expert e's two
// offsets, counts its tiles, and a block scan orders them; a CTA with no
// tile exits.  `offsets` is never read on the host.
//
// What bounds it: bytes.  At decode (4 rows x 8 slots) each active
// expert's 3 * d * f weights are streamed once and the M tile is mostly
// padding: granite-moe hits ~20 of 32 experts (~94 MB a layer, ~28 us at
// 3.35 TB/s), qwen3-moe ~30 of 128 (~1.1 GB, ~0.34 ms).  So the columns
// are split finely (64 a CTA: 8-64 N tiles times the active experts,
// hundreds to thousands of CTAs) and each CTA keeps three 16-byte
// cp.async stages of its weight tiles in flight (a four-stage ring).
// At a 64-token chunk (512 slots) the weights are still the bytes
// (granite: 16 rows an expert on average, one M tile).
//
// bf16 (the serving path): tensor cores, mma.sync m16n8k16 fed by
// ldmatrix (A) and ldmatrix.trans (B, read from the row-major [K][N]
// weight tile), accumulating in f32; 4 warps, each 16 of the tile's 64
// columns (two n8 tiles; the gate/up launch runs both products on one A
// fragment).  Rows are padded by 16 bytes so ldmatrix's eight row reads
// fall on distinct banks.  The activation is rounded to bf16 once.
// float32 (the reduced parity runs): the same schedule on CUDA cores,
// a two-stage ring; each thread owns one column and 8 rows.
#include "attn_common.cuh"

namespace repro {

constexpr int MG_BM = 16;         // rows of an M tile (one mma m16)
constexpr int MG_BN = 64;         // columns of an N tile
constexpr int MG_BK = 32;         // depth of one ring stage
constexpr int MG_THREADS = 128;   // 4 warps
constexpr int MG_MAX_E = MG_THREADS;   // one expert a thread in the lookup

// M tiles any routing of n slots over E experts can take
__host__ __device__ inline long long mg_m_tiles(long long n, int E) {
  const long long m = n < E ? n : E;
  return (n + m * (MG_BM - 1)) / MG_BM;
}

template <typename T> struct MgShape {
  static constexpr int CH = 16 / sizeof(T);          // elements a 16-byte copy
  static constexpr int STAGES = sizeof(T) == 2 ? 4 : 2;
  static constexpr int AS = MG_BK + CH;              // padded A row
  static constexpr int BS = MG_BN + CH;              // padded B row
};

template <typename T, int NB> struct MgSmem {
  using S = MgShape<T>;
  __align__(16) T a[S::STAGES][MG_BM][S::AS];
  __align__(16) T b[S::STAGES][NB][MG_BK][S::BS];
  int src[MG_BM];      // gate/up: the row's token; down: its sorted row
  int dst[MG_BM];      // gate/up: its sorted row; down: its slot (-1: none)
  int warp_tiles[MG_THREADS / 32];
  int expert, row0, row_end;
};

// gate/up (NB 2): a = x, w0 = w_gate, w1 = w_up, out = act, K = d, N = f.
// down (NB 1): a = act, w0 = w_down, out = y, K = f, N = d.
template <typename T> struct MgArgs {
  const T* a;
  const T* w0;
  const T* w1;
  const int* order;
  const int* offsets;
  T* out;
  int K, N, E, top_k;
};

// Which (expert, M tile) this CTA computes; false when the CTA has none.
template <typename T, int NB>
__device__ __forceinline__ bool find_tile(const int* offsets, int E,
                                          MgSmem<T, NB>& sm) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int lo = 0, hi = 0;
  if (tid < E) {
    lo = offsets[tid];
    hi = offsets[tid + 1];
  }
  const int c = (hi - lo + MG_BM - 1) / MG_BM;
  int s = c;                                    // inclusive scan in the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(FULL_MASK, s, o);
    if (lane >= o) s += v;
  }
  if (lane == 31) sm.warp_tiles[warp] = s;
  if (tid == 0) sm.expert = -1;
  __syncthreads();
  int start = s - c;
  for (int w = 0; w < warp; ++w) start += sm.warp_tiles[w];
  const int t = blockIdx.x;
  if (t >= start && t < start + c) {
    sm.expert = tid;
    sm.row0 = lo + (t - start) * MG_BM;
    sm.row_end = hi;
  }
  __syncthreads();
  return sm.expert >= 0;
}

// One ring stage: A rows [BM][k0, k0 + BK) through `src`, the weight
// tiles [k0, k0 + BK) x [n0, n0 + BN); past K or N zero-filled.
template <typename T, int NB>
__device__ __forceinline__ void load_stage(const MgArgs<T>& p,
                                           MgSmem<T, NB>& sm, int st, int k0,
                                           int n0, const T* w0, const T* w1) {
  using S = MgShape<T>;
  constexpr int ACH = MG_BK / S::CH, BCH = MG_BN / S::CH;
  for (int c = threadIdx.x; c < MG_BM * ACH; c += MG_THREADS) {
    const int r = c / ACH, kc = (c % ACH) * S::CH;
    const int row = sm.src[r], k = k0 + kc;
    const bool ok = row >= 0 && k < p.K;
    cp_async_16(&sm.a[st][r][kc], ok ? p.a + (size_t)row * p.K + k : p.a, ok);
  }
  for (int c = threadIdx.x; c < NB * MG_BK * BCH; c += MG_THREADS) {
    const int m = c / (MG_BK * BCH), rem = c % (MG_BK * BCH);
    const int kr = rem / BCH, nc = (rem % BCH) * S::CH;
    const int k = k0 + kr, n = n0 + nc;
    const bool ok = k < p.K && n < p.N;
    const T* w = m == 0 ? w0 : w1;
    cp_async_16(&sm.b[st][m][kr][nc], ok ? w + (size_t)k * p.N + n : w, ok);
  }
}

__device__ __forceinline__ float silu_mul(float g, float u) {
  return g / (1.f + expf(-g)) * u;
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float v0,
                                           float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

template <typename T, bool GATE_UP>
__global__ void __launch_bounds__(MG_THREADS)
    moe_grouped_kernel(const MgArgs<T> p) {
  constexpr int NB = GATE_UP ? 2 : 1;
  using S = MgShape<T>;
  __shared__ MgSmem<T, NB> sm;
  if (!find_tile(p.offsets, p.E, sm)) return;
  const int tid = threadIdx.x;
  if (tid < MG_BM) {
    const int i = sm.row0 + tid;
    const bool ok = i < sm.row_end;
    if constexpr (GATE_UP) {
      sm.src[tid] = ok ? p.order[i] / p.top_k : -1;
      sm.dst[tid] = ok ? i : -1;
    } else {
      sm.src[tid] = ok ? i : -1;
      sm.dst[tid] = ok ? p.order[i] : -1;
    }
  }
  __syncthreads();
  const int n0 = blockIdx.y * MG_BN;
  const size_t expert_w = (size_t)sm.expert * p.K * p.N;
  const T* w0 = p.w0 + expert_w;
  const T* w1 = GATE_UP ? p.w1 + expert_w : w0;
  const int KT = (p.K + MG_BK - 1) / MG_BK;
#pragma unroll
  for (int s = 0; s < S::STAGES - 1; ++s) {
    if (s < KT) load_stage<T, NB>(p, sm, s, s * MG_BK, n0, w0, w1);
    cp_async_commit();
  }
  const int lane = tid & 31, warp = tid >> 5;
  // bf16: acc[m][j] the m16n8 fragment of product m, n8 tile j of the
  // warp's 16 columns.  float32: acc[m][r / 4][r % 4] at row
  // (tid / 64) * 8 + r, column tid % 64.
  float acc[NB][2][4] = {};
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<S::STAGES - 2>();
    __syncthreads();
    const int nk = kt + S::STAGES - 1;
    if (nk < KT)
      load_stage<T, NB>(p, sm, nk % S::STAGES, nk * MG_BK, n0, w0, w1);
    cp_async_commit();
    const int st = kt % S::STAGES;
    if constexpr (sizeof(T) == 2) {
#pragma unroll
      for (int kk = 0; kk < MG_BK; kk += 16) {
        uint32_t af[4];
        ldmatrix_x4(af, &sm.a[st][lane % 16][kk + (lane / 16) * 8]);
#pragma unroll
        for (int m = 0; m < NB; ++m) {
          uint32_t bf[4];
          ldmatrix_x4_trans(
              bf, &sm.b[st][m][kk + lane % 16][warp * 16 + (lane / 16) * 8]);
          mma_16816<false>(acc[m][0], af, bf[0], bf[1]);
          mma_16816<false>(acc[m][1], af, bf[2], bf[3]);
        }
      }
    } else {
      const int col = tid % MG_BN, r0 = (tid / MG_BN) * 8;
#pragma unroll 4
      for (int kk = 0; kk < MG_BK; ++kk) {
        float bv[NB];
#pragma unroll
        for (int m = 0; m < NB; ++m) bv[m] = to_float(sm.b[st][m][kk][col]);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float av = to_float(sm.a[st][r0 + r][kk]);
#pragma unroll
          for (int m = 0; m < NB; ++m)
            acc[m][r >> 2][r & 3] = fmaf(av, bv[m], acc[m][r >> 2][r & 3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  // epilogue: gate/up writes silu(g) * u at the sorted row, down writes
  // the product at the slot's row
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = n0 + warp * 16 + j * 8 + (lane % 4) * 2;
      if (n >= p.N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = sm.dst[lane / 4 + h * 8];
        if (row < 0) continue;
        float v0 = acc[0][j][2 * h], v1 = acc[0][j][2 * h + 1];
        if constexpr (GATE_UP) {
          v0 = silu_mul(v0, acc[NB - 1][j][2 * h]);
          v1 = silu_mul(v1, acc[NB - 1][j][2 * h + 1]);
        }
        store_pair(p.out + (size_t)row * p.N + n, v0, v1);
      }
    }
  } else {
    const int n = n0 + tid % MG_BN, r0 = (tid / MG_BN) * 8;
    if (n < p.N) {
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int row = sm.dst[r0 + r];
        if (row < 0) continue;
        const float g = acc[0][r >> 2][r & 3];
        const float v = GATE_UP ? silu_mul(g, acc[NB - 1][r >> 2][r & 3]) : g;
        p.out[(size_t)row * p.N + n] = from_float<T>(v);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* order, const void* offsets,
                   const void* w_gate, const void* w_up, const void* w_down,
                   void* act, void* y, int n_tokens, int top_k, int E, int d,
                   int f, cudaStream_t stream) {
  const long long mt = mg_m_tiles((long long)n_tokens * top_k, E);
  MgArgs<T> gu{static_cast<const T*>(x), static_cast<const T*>(w_gate),
               static_cast<const T*>(w_up), static_cast<const int*>(order),
               static_cast<const int*>(offsets), static_cast<T*>(act),
               d, f, E, top_k};
  moe_grouped_kernel<T, true>
      <<<dim3(mt, (f + MG_BN - 1) / MG_BN), MG_THREADS, 0, stream>>>(gu);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  MgArgs<T> dn{static_cast<const T*>(act), static_cast<const T*>(w_down),
               nullptr, static_cast<const int*>(order),
               static_cast<const int*>(offsets), static_cast<T*>(y),
               f, d, E, top_k};
  moe_grouped_kernel<T, false>
      <<<dim3(mt, (d + MG_BN - 1) / MG_BN), MG_THREADS, 0, stream>>>(dn);
  return cudaGetLastError();
}

}  // namespace repro

REPRO_EXPORT_ERROR_STRING

// x [n_tokens, d]; order [n_tokens * top_k] int32 (slots sorted by
// expert); offsets [E + 1] int32; w_gate, w_up [E, d, f]; w_down [E, f,
// d]; act [n_tokens * top_k, f] scratch (the sorted rows' activations);
// y [n_tokens * top_k, d] out, in slot order.  dtype: 0 f32, 1 bf16
// (every float operand).  Two launches on `stream`.
extern "C" int repro_moe_grouped(const void* x, const void* order,
                                 const void* offsets, const void* w_gate,
                                 const void* w_up, const void* w_down,
                                 void* act, void* y, int n_tokens, int top_k,
                                 int E, int d, int f, int dtype,
                                 void* stream) {
  using namespace repro;
  if (n_tokens <= 0 || top_k <= 0 || E <= 0 || E > MG_MAX_E || d <= 0 ||
      f <= 0 || d % 8 != 0 || f % 8 != 0 ||
      (long long)n_tokens * top_k > 0x7fffffffLL ||
      (d + MG_BN - 1) / MG_BN > 65535 || (f + MG_BN - 1) / MG_BN > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == F32)
    err = launch<float>(x, order, offsets, w_gate, w_up, w_down, act, y,
                        n_tokens, top_k, E, d, f, s);
  else if (dtype == BF16)
    err = launch<__nv_bfloat16>(x, order, offsets, w_gate, w_up, w_down, act,
                                y, n_tokens, top_k, E, d, f, s);
  return static_cast<int>(err);
}

// The grid's M tiles for n slots over E experts (the host's copy is
// kernels/moe_grouped.py::m_tiles).
extern "C" long long repro_moe_m_tiles(long long n, int E) {
  return repro::mg_m_tiles(n, E);
}
