// Dense causal flash attention (whole-prompt prefill), for Hopper.
//
// Replaces the TPU kernel `flash_prefill`
// (src/repro/kernels/flash_prefill.py:82, body `_flash_kernel`):
// q [B, S, H, hd] against k/v [B, S, KV, hd], GQA (query head h reads
// kv head h / group), causal, an optional sliding window, key blocks
// wholly above the diagonal or before the window skipped.  Unlike the
// Pallas kernel, S need not divide the block sizes: the ragged edge is
// masked.
//
// What bounds it: operations at prompt lengths of a few hundred tokens
// (4*hd flops per (query, key) pair, half the square under the causal
// mask).  This first version runs them on the CUDA cores in f32, so it
// is far from the card's bf16 tensor-core peak; wgmma/TMA tiles are
// later work.
//
// Design: grid (ceil(S / 32), H, B), 128 threads, 32 query rows per CTA;
// the TPU's sequential k-block axis becomes a loop over 16-token key
// tiles from the window start to the tile's diagonal, each staged in
// shared memory as f32; the online softmax is `tile_step` in
// attn_common.cuh.
#include "attn_common.cuh"

namespace repro {

template <typename T, int HD>
__global__ void __launch_bounds__(TILE_THREADS)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int S,
                     int H, int KV, int window, float scale) {
  __shared__ __align__(16) TileSmem<HD> sm;
  const int q0 = blockIdx.x * TILE_Q, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);

  load_tile<T, HD>(sm.q, TILE_Q, [&](int r) -> const T* {
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
    auto kv_row = [&](const T* base, int i) -> const T* {
      const int t = t0 + i;
      return t < S ? base + (((size_t)b * S + t) * KV + kvh) * HD : nullptr;
    };
    load_tile<T, HD>(sm.k, TILE_K, [&](int i) { return kv_row(k, i); });
    load_tile<T, HD>(sm.v, TILE_K, [&](int i) { return kv_row(v, i); });
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
    store_row<T, HD>(out + (((size_t)b * S + q_pos) * H + h) * HD, tx, l, acc);
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int H, int KV, int window, float scale,
                   cudaStream_t stream) {
  const dim3 grid((S + TILE_Q - 1) / TILE_Q, H, B);
  flash_prefill_kernel<T, HD><<<grid, TILE_THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, H, KV, window,
      scale);
  return cudaGetLastError();
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
    err = launch<float, 64>(q, k, v, out, B, S, H, KV, window, scale, s);
  else if (dtype == F32 && hd == 128)
    err = launch<float, 128>(q, k, v, out, B, S, H, KV, window, scale, s);
  else if (dtype == BF16 && hd == 64)
    err = launch<__nv_bfloat16, 64>(q, k, v, out, B, S, H, KV, window, scale, s);
  else if (dtype == BF16 && hd == 128)
    err = launch<__nv_bfloat16, 128>(q, k, v, out, B, S, H, KV, window, scale, s);
  return static_cast<int>(err);
}
