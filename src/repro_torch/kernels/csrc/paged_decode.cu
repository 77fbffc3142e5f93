// Paged decode attention over the unified head-block pool, for Hopper.
//
// Replaces the TPU kernel `fused_paged_decode_attention`
// (src/repro/kernels/paged_attention.py:79, body `_paged_kernel`):
// one query token per row, GQA, over the arena pool_k/v [N, 16, hd];
// per-row physical block ids phys [B, n_kv, max_blocks] pick the
// blocks, positions >= seq_lens[b] are masked, softmax online in f32.
// Rows may belong to different colocated models: phys already carries
// each row's (model, layer) resolution.
//
// What bounds it: bytes (4 flops per key/value element pair).  The
// Pallas kernel walks a row's blocks in order on one core; here the
// split-KV body of decode_splitkv.cuh spreads each (row, kv head)'s
// tokens over CTAs, streams them through a cp.async ring and merges
// the splits' partial softmax states (see that header).  This file
// binds it to float and bf16 head-blocks: the pool is the paged layout
// with blk_rows 16, tok_rows 1 and phys as the block table.
#include "decode_splitkv.cuh"

namespace repro {

template <typename T, int HD>
cudaError_t launch(const void* q, const void* pool_k, const void* pool_v,
                   const void* seq_lens, void* out, void* ws, int B, int H,
                   int n_kv, int split, int n_splits, float scale,
                   const DecodeLayout& lay, cudaStream_t stream) {
  DecodeArgs<T, FloatKV<T>> a;
  a.q = static_cast<const T*>(q);
  a.kv = FloatKV<T>{static_cast<const T*>(pool_k),
                    static_cast<const T*>(pool_v)};
  a.seq_lens = static_cast<const int*>(seq_lens);
  a.out = static_cast<T*>(out);
  a.ws = static_cast<float*>(ws);
  a.H = H;
  a.n_kv = n_kv;
  a.group = H / n_kv;
  a.split = split;
  a.n_splits = n_splits;
  a.scale = scale;
  a.lay = lay;
  return launch_split_decode<T, FloatKV<T>, HD>(a, B, stream);
}

}  // namespace repro

REPRO_EXPORT_ERROR_STRING

// q [B, H, hd]; pool_k/v [N, 16, hd]; phys [B, n_kv, max_blocks] int32;
// seq_lens [B] int32; out [B, H, hd]; ws the f32 workspace of
// B * n_kv * n_splits * (2 * SK_MAX_GROUP + group * hd) floats (null
// when n_splits is 1); split tokens per split, n_splits * split >= max_blocks * 16.
// dtype: 0 f32, 1 bf16.
extern "C" int repro_paged_decode(const void* q, const void* pool_k,
                                  const void* pool_v, const void* phys,
                                  const void* seq_lens, void* out, void* ws,
                                  int B, int H, int n_kv, int max_blocks,
                                  int hd, int dtype, float scale, int split,
                                  int n_splits, void* stream) {
  using namespace repro;
  if (B <= 0 || n_kv <= 0 || H % n_kv != 0 || H / n_kv > SK_MAX_GROUP ||
      max_blocks <= 0)
    return cudaErrorInvalidValue;
  const DecodeLayout lay{static_cast<const int*>(phys), BLOCK_TOKENS, 0, 0, 1,
                         max_blocks, BLOCK_TOKENS, max_blocks * BLOCK_TOKENS,
                         bt_shift_of(BLOCK_TOKENS)};
  if (!plan_ok(split, n_splits, lay, ws)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == F32 && hd == 64)
    err = launch<float, 64>(q, pool_k, pool_v, seq_lens, out, ws, B, H, n_kv, split, n_splits, scale, lay, s);
  else if (dtype == F32 && hd == 96)
    err = launch<float, 96>(q, pool_k, pool_v, seq_lens, out, ws, B, H, n_kv, split, n_splits, scale, lay, s);
  else if (dtype == F32 && hd == 128)
    err = launch<float, 128>(q, pool_k, pool_v, seq_lens, out, ws, B, H, n_kv, split, n_splits, scale, lay, s);
  else if (dtype == BF16 && hd == 64)
    err = launch<__nv_bfloat16, 64>(q, pool_k, pool_v, seq_lens, out, ws, B, H, n_kv, split, n_splits, scale, lay, s);
  else if (dtype == BF16 && hd == 96)
    err = launch<__nv_bfloat16, 96>(q, pool_k, pool_v, seq_lens, out, ws, B, H, n_kv, split, n_splits, scale, lay, s);
  else if (dtype == BF16 && hd == 128)
    err = launch<__nv_bfloat16, 128>(q, pool_k, pool_v, seq_lens, out, ws, B, H, n_kv, split, n_splits, scale, lay, s);
  return static_cast<int>(err);
}

// The compiled split kernel of (hd, dtype, group) on this card: out[0]
// CTAs an SM, out[1] dynamic shared memory (bytes), out[2] registers a
// thread (decode_splitkv.cuh, split_decode_occupancy).
extern "C" int repro_paged_decode_occupancy(int hd, int dtype, int group,
                                            int* out) {
  using namespace repro;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == F32 && hd == 64)
    err = split_decode_occupancy<float, FloatKV<float>, 64>(group, out);
  else if (dtype == F32 && hd == 96)
    err = split_decode_occupancy<float, FloatKV<float>, 96>(group, out);
  else if (dtype == F32 && hd == 128)
    err = split_decode_occupancy<float, FloatKV<float>, 128>(group, out);
  else if (dtype == BF16 && hd == 64)
    err = split_decode_occupancy<__nv_bfloat16, FloatKV<__nv_bfloat16>, 64>(group, out);
  else if (dtype == BF16 && hd == 96)
    err = split_decode_occupancy<__nv_bfloat16, FloatKV<__nv_bfloat16>, 96>(group, out);
  else if (dtype == BF16 && hd == 128)
    err = split_decode_occupancy<__nv_bfloat16, FloatKV<__nv_bfloat16>, 128>(group, out);
  return static_cast<int>(err);
}
