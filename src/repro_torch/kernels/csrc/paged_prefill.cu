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
// What bounds it: operations.  At the serving shapes (C = 64, group 7,
// a few hundred cached tokens) each key block is read once per kv head
// and used by all C*group = 448 query rows: 4*hd flops per (query,
// key) pair against 16*hd*2 bytes a block, well above the card's 295
// flops per byte.
//
// Design, bf16 (the serving path): the tensor-core tile of
// attn_common.cuh (`tc_attention_kernel` with PagedAddr).  The Pallas
// kernel keeps all C*group rows of a kv head in VMEM; here they are
// tiled 64 to a warpgroup, in the Pallas kernel's packing (at C = 64,
// group 7 the 448 rows are exactly seven tiles): grid (B, n_kv,
// ceil(C*group / 64)), tiles in reverse order so the longest walks
// start first.  A 64-token key tile is four head-blocks gathered
// through phys[b, h, j]: the producer warp reads the ids and issues one
// TMA box (16 tokens x 64 columns, 128-byte swizzle) per block and
// column atom over the pool seen as [N*16, hd], into a three-stage ring.
// The walk stops at the tile's last query position (the Pallas
// kernel's `j*bt <= off + chunk - 1`, narrowed to the tile); blocks
// past it in the last tile repeat the tile's first block and are
// masked.
//
// float32 keeps the CUDA-core tile (`tile_step`): 32 rows per CTA,
// one head-block (16 tokens) per key tile staged in shared memory as
// f32.  TF32 tensor cores would keep about three digits, short of the
// 1e-4 the f32 path is held to.
#include "attn_common.cuh"

namespace repro {

// float32: the CUDA-core tile
template <int HD>
__global__ void __launch_bounds__(TILE_THREADS)
paged_prefill_kernel(const float* __restrict__ q,
                     const float* __restrict__ pool_k,
                     const float* __restrict__ pool_v,
                     const int* __restrict__ phys,
                     const int* __restrict__ q_offset,
                     float* __restrict__ out, int C, int H, int n_kv,
                     int max_blocks, float scale) {
  __shared__ __align__(16) TileSmem<HD> sm;
  const int b = blockIdx.x, h = blockIdx.y;
  const int group = H / n_kv;
  const int rows = C * group;
  const int r0 = blockIdx.z * TILE_Q;
  const int off = q_offset[b];
  const int* ph = phys + ((size_t)b * n_kv + h) * max_blocks;

  auto q_row = [&](int r) -> const float* {
    const int rr = r0 + r;
    if (rr >= rows) return nullptr;
    const int c = rr / group, g = rr % group;
    return q + (((size_t)b * C + c) * H + (size_t)h * group + g) * HD;
  };
  load_tile<HD>(sm.q, TILE_Q, q_row);

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
    load_tile<HD>(sm.k, TILE_K, [&](int i) { return pool_k + (base + i) * HD; });
    load_tile<HD>(sm.v, TILE_K, [&](int i) { return pool_v + (base + i) * HD; });
    __syncthreads();
    bool keep[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) keep[k] = j * BLOCK_TOKENS + tx + 4 * k <= q_pos;
    tile_step<HD>(sm, r, tx, keep, scale, m, l, acc);
  }

  const int rr = r0 + r;
  if (rr < rows) {
    const int c = rr / group, g = rr % group;
    store_row<HD>(out + (((size_t)b * C + c) * H + (size_t)h * group + g) * HD,
                     tx, l, acc);
  }
}

template <int HD>
cudaError_t launch_f32(const void* q, const void* pool_k, const void* pool_v,
                       const void* phys, const void* q_offset, void* out,
                       int B, int C, int H, int n_kv, int max_blocks,
                       float scale, cudaStream_t stream) {
  const int rows = C * (H / n_kv);
  const dim3 grid(B, n_kv, (rows + TILE_Q - 1) / TILE_Q);
  paged_prefill_kernel<HD><<<grid, TILE_THREADS, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(pool_k),
      static_cast<const float*>(pool_v), static_cast<const int*>(phys),
      static_cast<const int*>(q_offset), static_cast<float*>(out), C, H,
      n_kv, max_blocks, scale);
  return cudaGetLastError();
}

// bf16: the tensor-core tile.  Row tile z holds rows r0 .. r0 + 63 of
// kv head h's C*group rows, r0 = 64 * (n_rtiles - 1 - z); key tile it
// holds blocks 4*it .. 4*it + 3 of the row's table, positions
// 64*it .. 64*it + 63.
constexpr int BLOCKS_PER_TILE = TC_KEYS / BLOCK_TOKENS;

struct PagedParams {
  CUtensorMap k_map, v_map;   // pool [N*16, hd], box [16, 64]
  const bf16* q;
  bf16* out;
  const int* phys;
  const int* q_offset;
  int C, H, n_kv, max_blocks, n_rtiles;
  float scale_log2;
};

template <int HD> struct PagedAddr {
  using Params = PagedParams;
  const Params& p;
  int b, h, group, rows, r0, off, n_blocks;
  const int* ph;

  __device__ explicit PagedAddr(const Params& prm) : p(prm) {
    b = blockIdx.x;
    h = blockIdx.y;
    r0 = (p.n_rtiles - 1 - static_cast<int>(blockIdx.z)) * TC_ROWS;
    group = p.H / p.n_kv;
    rows = p.C * group;
    off = p.q_offset[b];
    // the tile's last query position bounds the blocks that matter
    const int last = off + (min(rows, r0 + TC_ROWS) - 1) / group;
    n_blocks = min(last / BLOCK_TOKENS + 1, p.max_blocks);
    ph = p.phys + ((size_t)b * p.n_kv + h) * p.max_blocks;
  }
  __device__ int n_tiles() const {
    return (n_blocks + BLOCKS_PER_TILE - 1) / BLOCKS_PER_TILE;
  }
  __device__ int key0(int it) const { return it * TC_KEYS; }
  __device__ int q_pos(int r) const { return off + (r0 + r) / group; }
  __device__ size_t row_offset(int r) const {   // of row r0 + r in q / out
    const int rr = r0 + r, c = rr / group, g = rr % group;
    return (((size_t)b * p.C + c) * p.H + (size_t)h * group + g) * HD;
  }
  __device__ const bf16* q_row(int r) const {
    return r0 + r < rows ? p.q + row_offset(r) : nullptr;
  }
  __device__ bf16* out_row(int r) const {
    return r0 + r < rows ? p.out + row_offset(r) : nullptr;
  }
  __device__ bool tile_masked(int it) const {
    return key0(it) + TC_KEYS - 1 > q_pos(0) ||
           (it + 1) * BLOCKS_PER_TILE > n_blocks;
  }
  __device__ bool keep(int t, int pos) const {
    return t <= pos && t < n_blocks * BLOCK_TOKENS;
  }
  __device__ void load_tile(const CUtensorMap* map, int it,
                            bf16 (*dst)[TC_KEYS * ATOM], uint64_t* bar) const {
    const int j0 = it * BLOCKS_PER_TILE;
#pragma unroll
    for (int jj = 0; jj < BLOCKS_PER_TILE; ++jj) {
      const int j = j0 + jj < n_blocks ? j0 + jj : j0;
      const int row = ph[j] * BLOCK_TOKENS;
#pragma unroll
      for (int a = 0; a < HD / ATOM; ++a)
        tma_load_2d(dst[a] + jj * BLOCK_TOKENS * ATOM, map, bar, a * ATOM,
                    row);
    }
  }
};

template <int HD>
cudaError_t launch_bf16(const void* q, const void* pool_k, const void* pool_v,
                        const void* phys, const void* q_offset, void* out,
                        int B, int C, int H, int n_kv, int max_blocks,
                        float scale, cudaStream_t stream) {
  PagedParams p;
  // The pool's length is not an argument: the walk reads only blocks
  // that phys names, so the map spans every row a 32-bit coordinate
  // reaches.
  const cuuint64_t dims[2] = {(cuuint64_t)HD, (cuuint64_t)0x7FFFFFF0};
  const cuuint64_t strides[1] = {(cuuint64_t)HD * 2};
  const cuuint32_t box[2] = {ATOM, BLOCK_TOKENS};
  cudaError_t err = encode_bf16_map(&p.k_map, pool_k, 2, dims, strides, box);
  if (err == cudaSuccess)
    err = encode_bf16_map(&p.v_map, pool_v, 2, dims, strides, box);
  if (err != cudaSuccess) return err;
  p.q = static_cast<const bf16*>(q);
  p.out = static_cast<bf16*>(out);
  p.phys = static_cast<const int*>(phys);
  p.q_offset = static_cast<const int*>(q_offset);
  p.C = C;
  p.H = H;
  p.n_kv = n_kv;
  p.max_blocks = max_blocks;
  p.n_rtiles = (C * (H / n_kv) + TC_ROWS - 1) / TC_ROWS;
  p.scale_log2 = scale * 1.4426950408889634f;
  return launch_tc<HD, PagedAddr<HD>>(dim3(B, n_kv, p.n_rtiles), p, stream);
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
    err = launch_f32<64>(q, pool_k, pool_v, phys, q_offset, out, B, C, H, n_kv, max_blocks, scale, s);
  else if (dtype == F32 && hd == 128)
    err = launch_f32<128>(q, pool_k, pool_v, phys, q_offset, out, B, C, H, n_kv, max_blocks, scale, s);
  else if (dtype == BF16 && hd == 64)
    err = launch_bf16<64>(q, pool_k, pool_v, phys, q_offset, out, B, C, H, n_kv, max_blocks, scale, s);
  else if (dtype == BF16 && hd == 128)
    err = launch_bf16<128>(q, pool_k, pool_v, phys, q_offset, out, B, C, H, n_kv, max_blocks, scale, s);
  return static_cast<int>(err);
}
