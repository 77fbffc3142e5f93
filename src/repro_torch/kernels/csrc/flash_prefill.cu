// Dense causal flash attention (whole-prompt prefill), for Hopper.
//
// Replaces the TPU kernel `flash_prefill`
// (src/repro/kernels/flash_prefill.py:82, body `_flash_kernel`):
// q [B, S, H, hd] against k/v [B, S, KV, hd], GQA (query head h reads
// kv head h / group), causal, an optional sliding window, key tiles
// wholly above the diagonal or before the window skipped.  Unlike the
// Pallas kernel, S need not divide the tile sizes: the ragged edge is
// masked.
//
// What bounds it: operations.  4*hd flops per (query, key) pair, half
// the square under the causal mask: at the smoke's 4 x 512 tokens,
// 28/4 heads, hd 128 that is 7.5 GFLOP against 29 MB of operands, far
// above the card's 295 flops per byte.
//
// Design, bf16 (the serving path): the tensor-core tile of
// attn_common.cuh (`tc_attention_kernel` with FlashAddr).  Grid (H, B,
// ceil(S / 64)), the query tiles launched in reverse order so the
// longest causal walks start first; each CTA is one warpgroup holding
// 64 consecutive query positions of one (b, h) plus a producer warp
// (two CTAs an SM at hd 128).  Q is staged by cp.async; K and V arrive
// by TMA through a 4-D tensor map over [B, S, KV, hd] (box 1 x 64 x 1
// x 64, 128-byte swizzle, rows past S read as zeros) into three-stage
// rings.  Masking runs only on tiles that cross the diagonal, the
// window start or S; O leaves through shared memory at hd 96 and 128.
// hd 96 runs the hd 128 tile: the map's inner extent is 96, so the
// second column atom's last 32 columns arrive as zeros
// (attn_common.cuh).
//
// float32 keeps the CUDA-core tile (`tile_step`): grid (ceil(S / 32),
// H, B), 128 threads, 32 query rows per CTA, 16-token key tiles staged
// in shared memory as f32.  TF32 tensor cores would keep about three
// digits, short of the 1e-4 the f32 path is held to.
#include "attn_common.cuh"

namespace repro {

// float32: the CUDA-core tile
template <int HD>
__global__ void __launch_bounds__(TILE_THREADS)
flash_prefill_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out, int S,
                     int H, int KV, int window, float scale) {
  __shared__ __align__(16) TileSmem<HD> sm;
  const int q0 = blockIdx.x * TILE_Q, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);

  load_tile<HD>(sm.q, TILE_Q, [&](int r) -> const float* {
    const int pos = q0 + r;
    return pos < S ? q + (((size_t)b * S + pos) * H + h) * HD : nullptr;
  });

  const int r = threadIdx.x / 4, tx = threadIdx.x % 4;
  const int q_pos = q0 + r;
  const int k_end = min(S, q0 + TILE_Q);   // past the tile's diagonal
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 - window + 1) / TILE_K * TILE_K;

  float m = NEG_INF, l = 0.f, acc[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[kk][j] = 0.f;

  for (int t0 = k_begin; t0 < k_end; t0 += TILE_K) {
    __syncthreads();  // previous tile fully consumed (and q visible)
    auto kv_row = [&](const float* base, int i) -> const float* {
      const int t = t0 + i;
      return t < S ? base + (((size_t)b * S + t) * KV + kvh) * HD : nullptr;
    };
    load_tile<HD>(sm.k, TILE_K, [&](int i) { return kv_row(k, i); });
    load_tile<HD>(sm.v, TILE_K, [&](int i) { return kv_row(v, i); });
    __syncthreads();
    bool keep[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int t = t0 + tx + 4 * kk;
      keep[kk] = t < S && t <= q_pos && (window <= 0 || t > q_pos - window);
    }
    tile_step<HD>(sm, r, tx, keep, scale, m, l, acc);
  }

  if (q_pos < S)
    store_row<HD>(out + (((size_t)b * S + q_pos) * H + h) * HD, tx, l, acc);
}

template <int HD>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out,
                       int B, int S, int H, int KV, int window, float scale,
                       cudaStream_t stream) {
  const dim3 grid((S + TILE_Q - 1) / TILE_Q, H, B);
  flash_prefill_kernel<HD><<<grid, TILE_THREADS, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, H, KV,
      window, scale);
  return cudaGetLastError();
}

// bf16: the tensor-core tile.  Query tile z holds positions
// q0 = 64 * (n_qtiles - 1 - z) .. q0 + 63 of (b, h); key tiles start at
// the window's first key rounded down to 64 and end at the tile's
// diagonal.
struct FlashParams {
  CUtensorMap k_map, v_map;   // [B, S, KV, hd], box [1, 64, 1, 64]
  const bf16* q;
  bf16* out;
  int S, H, KV, window, n_qtiles;
  float scale_log2;
};

template <int HD> struct FlashAddr {
  using Params = FlashParams;
  const Params& p;
  int b, h, kvh, q0, k_begin, k_end;

  __device__ explicit FlashAddr(const Params& prm) : p(prm) {
    h = blockIdx.x;
    b = blockIdx.y;
    q0 = (p.n_qtiles - 1 - static_cast<int>(blockIdx.z)) * TC_ROWS;
    kvh = h / (p.H / p.KV);
    k_end = min(p.S, q0 + TC_ROWS);
    k_begin = p.window > 0 ? max(0, q0 - p.window + 1) / TC_KEYS * TC_KEYS : 0;
  }
  __device__ int n_tiles() const {
    return (k_end - k_begin + TC_KEYS - 1) / TC_KEYS;
  }
  __device__ int key0(int it) const { return k_begin + it * TC_KEYS; }
  __device__ int q_pos(int r) const { return q0 + r; }
  __device__ const bf16* q_row(int r) const {
    const int pos = q0 + r;
    return pos < p.S ? p.q + (((size_t)b * p.S + pos) * p.H + h) * HD
                     : nullptr;
  }
  __device__ bf16* out_row(int r) const {
    const int pos = q0 + r;
    return pos < p.S ? p.out + (((size_t)b * p.S + pos) * p.H + h) * HD
                     : nullptr;
  }
  // does some (row, key) pair of tile `it` fall outside the mask?
  __device__ bool tile_masked(int it) const {
    const int t0 = key0(it);
    return t0 + TC_KEYS - 1 > q0 || t0 + TC_KEYS > p.S ||
           (p.window > 0 && t0 <= q0 + TC_ROWS - 1 - p.window);
  }
  __device__ bool keep(int t, int pos) const {
    return t <= pos && t < p.S && (p.window <= 0 || t > pos - p.window);
  }
  __device__ void load_tile(const CUtensorMap* map, int it,
                            bf16 (*dst)[TC_KEYS * ATOM], uint64_t* bar) const {
#pragma unroll
    for (int a = 0; a < atoms<HD>(); ++a)
      tma_load_4d(dst[a], map, bar, a * ATOM, kvh, key0(it), b);
  }
};

template <int HD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* out, int B, int S, int H, int KV, int window,
                        float scale, cudaStream_t stream) {
  FlashParams p;
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)KV, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)HD * 2, (cuuint64_t)KV * HD * 2,
                                 (cuuint64_t)S * KV * HD * 2};
  const cuuint32_t box[4] = {ATOM, 1, TC_KEYS, 1};
  cudaError_t err = encode_bf16_map(&p.k_map, k, 4, dims, strides, box);
  if (err == cudaSuccess)
    err = encode_bf16_map(&p.v_map, v, 4, dims, strides, box);
  if (err != cudaSuccess) return err;
  p.q = static_cast<const bf16*>(q);
  p.out = static_cast<bf16*>(out);
  p.S = S;
  p.H = H;
  p.KV = KV;
  p.window = window;
  p.n_qtiles = (S + TC_ROWS - 1) / TC_ROWS;
  p.scale_log2 = scale * 1.4426950408889634f;
  return launch_tc<HD, FlashAddr<HD>>(dim3(H, B, p.n_qtiles), p, stream);
}

}  // namespace repro

REPRO_EXPORT_ERROR_STRING

// q [B, S, H, hd]; k/v [B, S, KV, hd]; out [B, S, H, hd]; window <= 0
// means no sliding window.  dtype: 0 f32, 1 bf16.
extern "C" int repro_flash_prefill(const void* q, const void* k,
                                   const void* v, void* out, int B, int S,
                                   int H, int KV, int hd, int window,
                                   int dtype, float scale, void* stream) {
  using namespace repro;
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0 || B > 65535 || H > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == F32 && hd == 64)
    err = launch_f32<64>(q, k, v, out, B, S, H, KV, window, scale, s);
  else if (dtype == F32 && hd == 96)
    err = launch_f32<96>(q, k, v, out, B, S, H, KV, window, scale, s);
  else if (dtype == F32 && hd == 128)
    err = launch_f32<128>(q, k, v, out, B, S, H, KV, window, scale, s);
  else if (dtype == BF16 && hd == 64)
    err = launch_bf16<64>(q, k, v, out, B, S, H, KV, window, scale, s);
  else if (dtype == BF16 && hd == 96)
    err = launch_bf16<96>(q, k, v, out, B, S, H, KV, window, scale, s);
  else if (dtype == BF16 && hd == 128)
    err = launch_bf16<128>(q, k, v, out, B, S, H, KV, window, scale, s);
  return static_cast<int>(err);
}
