// Chunked-prefill attention over the unified head-block pool, for Hopper.
//
// Replaces the TPU kernel `fused_paged_flash_prefill`
// (src/repro/kernels/flash_prefill.py:183, body `_paged_prefill_kernel`):
// C query tokens per row at absolute positions q_offset[b] + c attend
// causally to every pool position up to their own (earlier chunks plus
// this chunk's KV, already written).  Query row r = c*group + g of kv
// head h is query head h*group + g at chunk position c, and is masked
// by t <= q_offset + r / group, as in the Pallas kernel.
//
// What bounds it: at the serving shapes (C = 64, group 7, a few hundred
// cached tokens) operations, 4*hd flops per (query, key) pair against
// one read of each key block per row tile.  This first version runs the
// products on the CUDA cores in f32 (tensor-core wgmma is later work),
// so it sits well below the card's bf16 peak.
//
// Design: the Pallas kernel keeps all C*group query rows of a kv head
// in VMEM (448 rows x 128 f32 accumulators at full width, ~229 KB, too
// much for one CTA).  Here the rows are tiled across CTAs: grid
// (B, n_kv, ceil(C*group / 32)), 128 threads, 32 rows per CTA.  The
// block axis becomes a loop over the row's head-blocks (the CTA reads
// phys itself) that stops at the tile's last query position, the
// Pallas kernel's `j*bt <= off + chunk - 1` condition narrowed to the
// tile.  Each key tile is one head-block (16 tokens) staged in shared
// memory as f32; the online softmax is `tile_step` in attn_common.cuh.
#include "attn_common.cuh"

namespace repro {

template <typename T, int HD>
__global__ void __launch_bounds__(TILE_THREADS)
paged_prefill_kernel(const T* __restrict__ q, const T* __restrict__ pool_k,
                     const T* __restrict__ pool_v, const int* __restrict__ phys,
                     const int* __restrict__ q_offset, T* __restrict__ out,
                     int C, int H, int n_kv, int max_blocks, float scale) {
  __shared__ __align__(16) TileSmem<HD> sm;
  const int b = blockIdx.x, h = blockIdx.y;
  const int group = H / n_kv;
  const int rows = C * group;
  const int r0 = blockIdx.z * TILE_Q;
  const int off = q_offset[b];
  const int* ph = phys + ((size_t)b * n_kv + h) * max_blocks;

  auto q_row = [&](int r) -> const T* {
    const int rr = r0 + r;
    if (rr >= rows) return nullptr;
    const int c = rr / group, g = rr % group;
    return q + (((size_t)b * C + c) * H + (size_t)h * group + g) * HD;
  };
  load_tile<T, HD>(sm.q, TILE_Q, q_row);

  const int r = threadIdx.x / 4, tx = threadIdx.x % 4;
  const int q_pos = off + (r0 + r) / group;
  // last query position of this tile bounds the blocks that matter
  const int last = off + (min(rows, r0 + TILE_Q) - 1) / group;
  const int n_blocks = min(last / BLOCK_TOKENS + 1, max_blocks);

  float m = NEG_INF, l = 0.f, acc[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[kk][j] = 0.f;

  for (int j = 0; j < n_blocks; ++j) {
    const size_t base = (size_t)ph[j] * BLOCK_TOKENS;
    __syncthreads();  // previous tile fully consumed (and q visible)
    load_tile<T, HD>(sm.k, TILE_K,
                     [&](int i) -> const T* { return pool_k + (base + i) * HD; });
    load_tile<T, HD>(sm.v, TILE_K,
                     [&](int i) -> const T* { return pool_v + (base + i) * HD; });
    __syncthreads();
    bool keep[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) keep[k] = j * BLOCK_TOKENS + tx + 4 * k <= q_pos;
    tile_step<HD>(sm, r, tx, keep, scale, m, l, acc);
  }

  const int rr = r0 + r;
  if (rr < rows) {
    const int c = rr / group, g = rr % group;
    store_row<T, HD>(out + (((size_t)b * C + c) * H + (size_t)h * group + g) * HD,
                     tx, l, acc);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* pool_k, const void* pool_v,
                   const void* phys, const void* q_offset, void* out, int B,
                   int C, int H, int n_kv, int max_blocks, float scale,
                   cudaStream_t stream) {
  const int rows = C * (H / n_kv);
  const dim3 grid(B, n_kv, (rows + TILE_Q - 1) / TILE_Q);
  paged_prefill_kernel<T, HD><<<grid, TILE_THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pool_k),
      static_cast<const T*>(pool_v), static_cast<const int*>(phys),
      static_cast<const int*>(q_offset), static_cast<T*>(out), C, H, n_kv,
      max_blocks, scale);
  return cudaGetLastError();
}

}  // namespace repro

REPRO_EXPORT_ERROR_STRING

// q [B, C, H, hd]; pool_k/v [N, 16, hd]; phys [B, n_kv, max_blocks]
// int32; q_offset [B] int32; out [B, C, H, hd].  dtype: 0 f32, 1 bf16.
extern "C" int repro_paged_prefill(const void* q, const void* pool_k,
                                   const void* pool_v, const void* phys,
                                   const void* q_offset, void* out, int B,
                                   int C, int H, int n_kv, int max_blocks,
                                   int hd, int dtype, float scale,
                                   void* stream) {
  using namespace repro;
  if (B <= 0 || C <= 0 || n_kv <= 0 || H % n_kv != 0 || max_blocks <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == F32 && hd == 64)
    err = launch<float, 64>(q, pool_k, pool_v, phys, q_offset, out, B, C, H, n_kv, max_blocks, scale, s);
  else if (dtype == F32 && hd == 128)
    err = launch<float, 128>(q, pool_k, pool_v, phys, q_offset, out, B, C, H, n_kv, max_blocks, scale, s);
  else if (dtype == BF16 && hd == 64)
    err = launch<__nv_bfloat16, 64>(q, pool_k, pool_v, phys, q_offset, out, B, C, H, n_kv, max_blocks, scale, s);
  else if (dtype == BF16 && hd == 128)
    err = launch<__nv_bfloat16, 128>(q, pool_k, pool_v, phys, q_offset, out, B, C, H, n_kv, max_blocks, scale, s);
  return static_cast<int>(err);
}
