// Int8 decode attention, for Hopper: one query token per row over a KV
// cache stored as int8 with one f32 scale per (token, kv head).
//
// Replaces the TPU kernel `paged_decode_attention_int8`
// (src/repro/kernels/paged_attention_int8.py:69, body `_paged_kernel_i8`):
// for each row b and kv head h the group = H / n_kv query heads attend
// over the row's int8 keys and values, dequantized as k * sk[token],
// v * sv[token]; scores are scaled by 1/sqrt(hd) and masked at t >=
// seq_len[b]; the softmax is online in f32 and the output is
// acc / max(l, 1e-30) in q's type.  A row whose seq_len is 0 (or less)
// reads nothing and writes 0.
//
// What bounds it: bytes (hd int8 keys and values and two f32 scales per
// token, 4 flops per key/value element pair).  It runs kernel 1's
// split-KV body (decode_splitkv.cuh: splits over CTAs, a cp.async ring,
// a merge of partial softmax states) with the int8 loader: 16-byte
// int8 rows, the key scale applied once to a token's dot product and
// the value scale folded into its probability.
//
// Two callers address the cache differently, and the body's
// DecodeLayout reads both in place, without a copy:
//   * paged pool k/v [N, bt, hd], sk/sv [N, bt], table = physical
//     head-block ids [B, n_kv, max_blocks]: blk_rows = bt, tok_rows = 1,
//     row_rows = head_rows = 0 (the Pallas kernel's addressing);
//   * one layer of the W8/KV8 step's dense cache k/v [B, S, KV, hd],
//     sk/sv [B, S, KV], no table, one block of bt = S tokens:
//     blk_rows = 0, row_rows = S * KV, head_rows = 1, tok_rows = KV.
// max_tok = max_blocks * bt for the pool, S for the dense layer, so
// nothing past a row's cache is read.
#include "decode_splitkv.cuh"

namespace repro {

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* sk,
                   const void* sv, const void* seq_lens, void* out, void* ws,
                   int B, int H, int n_kv, int split, int n_splits,
                   float scale, const DecodeLayout& lay, cudaStream_t stream) {
  DecodeArgs<T, Int8KV> a;
  a.q = static_cast<const T*>(q);
  a.kv = Int8KV{static_cast<const int8_t*>(k), static_cast<const int8_t*>(v),
                static_cast<const float*>(sk), static_cast<const float*>(sv)};
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
  return launch_split_decode<T, Int8KV, HD>(a, B, stream);
}

}  // namespace repro

REPRO_EXPORT_ERROR_STRING

// q [B, H, hd] (f32 or bf16); k/v int8 and sk/sv f32 addressed as set
// out above; table [B, n_kv, max_blocks] int32 or null; seq_lens [B]
// int32; out [B, H, hd] in q's type; ws the f32 workspace of
// B * n_kv * n_splits * (16 + group * hd) floats (null when n_splits is
// 1); split tokens per split, n_splits * split >= max_tok.
// dtype: 0 f32, 1 bf16.
extern "C" int repro_decode_int8(const void* q, const void* k, const void* v,
                                 const void* sk, const void* sv,
                                 const void* table, const void* seq_lens,
                                 void* out, void* ws, int B, int H, int n_kv,
                                 int max_blocks, int bt, int max_tok,
                                 long long blk_rows, long long row_rows,
                                 long long head_rows, long long tok_rows,
                                 int hd, int dtype, float scale, int split,
                                 int n_splits, void* stream) {
  using namespace repro;
  if (B <= 0 || n_kv <= 0 || H % n_kv != 0 || H / n_kv > SK_MAX_GROUP ||
      bt <= 0 || max_tok < 0 || (table != nullptr && max_blocks <= 0))
    return cudaErrorInvalidValue;
  // a block of max_tok tokens or more (the dense layer) is block 0 for
  // every token: t >> 31
  const DecodeLayout lay{static_cast<const int*>(table), blk_rows, row_rows,
                         head_rows, tok_rows, max_blocks, bt, max_tok,
                         bt >= max_tok ? 31 : bt_shift_of(bt)};
  if (!plan_ok(split, n_splits, lay, ws)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == F32 && hd == 64)
    err = launch<float, 64>(q, k, v, sk, sv, seq_lens, out, ws, B, H, n_kv, split, n_splits, scale, lay, s);
  else if (dtype == F32 && hd == 128)
    err = launch<float, 128>(q, k, v, sk, sv, seq_lens, out, ws, B, H, n_kv, split, n_splits, scale, lay, s);
  else if (dtype == BF16 && hd == 64)
    err = launch<__nv_bfloat16, 64>(q, k, v, sk, sv, seq_lens, out, ws, B, H, n_kv, split, n_splits, scale, lay, s);
  else if (dtype == BF16 && hd == 128)
    err = launch<__nv_bfloat16, 128>(q, k, v, sk, sv, seq_lens, out, ws, B, H, n_kv, split, n_splits, scale, lay, s);
  return static_cast<int>(err);
}
