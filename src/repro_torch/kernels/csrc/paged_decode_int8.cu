// Int8 decode attention, for Hopper: one query token per row over a KV
// cache stored as int8 with one f32 scale per (token, kv head).
//
// Replaces the TPU kernel `paged_decode_attention_int8`
// (src/repro/kernels/paged_attention_int8.py:69, body `_paged_kernel_i8`):
// for each row b and kv head h the group = H / n_kv query heads attend
// over the row's int8 keys and values, each dequantized in registers as
// k * sk[token], v * sv[token]; scores are scaled by 1/sqrt(hd) and
// masked at t >= seq_len[b]; the softmax is online in f32 and the output
// is acc / max(l, 1e-30) in q's type.
//
// Two callers address the cache differently, and one body serves both
// without a copy: token t of (row b, kv head h) lives at cache row
//   r = blk * blk_rows + b * row_rows + h * head_rows + (t % bt) * tok_rows,
//   blk = table ? table[b, h, t / bt] : t / bt,
// its hd values at k + r * hd and its scale at sk[r].  A row whose
// seq_len is 0 (or less) reads nothing and writes 0.
//   * paged pool k/v [N, bt, hd], sk/sv [N, bt], table = physical
//     head-block ids [B, n_kv, max_blocks]: blk_rows = bt, tok_rows = 1,
//     row_rows = head_rows = 0 (the Pallas kernel's addressing);
//   * one layer of the W8/KV8 step's dense cache k/v [B, S, KV, hd],
//     sk/sv [B, S, KV], no table, one block of bt = S tokens:
//     blk_rows = 0, row_rows = S * KV, head_rows = 1, tok_rows = KV.
// Tokens at or past min(seq_len[b], max_tok) are neither loaded nor
// counted (max_tok = max_blocks * bt for the pool, S for the dense
// layer), so nothing past a row's cache is read.
//
// What bounds it: bytes.  Each (row, kv head) reads its seq_len x hd
// int8 keys and values and two f32 scales per token once, and does
// 4 flops per key/value element pair, far below the ~295 flops per byte
// the card needs to be compute-bound.  At full-width qwen2-7b (28/4
// heads, hd 128) a decode of 8 rows gives 8 x 4 = 32 CTAs for 132 SMs,
// so the card is underfilled and the latency of each CTA's load chain
// decides the time, as for the bf16 decode kernel (paged_decode.cu);
// splitting each row's keys across CTAs is later work.
//
// Design (kernel 1's, paged_decode.cu, with int8 operands): one CTA per
// (row b, kv head h), 8 warps.  Warp w takes the 32-token chunks w,
// w + 8, ... and stops at seq_len (the Pallas kernel's run condition).
// A lane scores one token: it reads the token's key row in 16-byte
// int8_t vectors (signed), converts them to f32, dots them with the
// group's query heads (resident in shared memory, broadcast reads) and
// applies its token's key scale once to the dot product.  The warp runs
// the online softmax per head with shuffles; each lane folds its
// token's value scale into its probability, and the warp then walks
// the chunk's value rows (coalesced, hd/32 int8 values a lane, 8 rows
// fetched at a time so their loads overlap), the row offsets broadcast
// from the lanes that computed them.  The 8 warp states merge through
// shared memory at the end.
#include "attn_common.cuh"

namespace repro {

constexpr int I8_WARPS = 8;
constexpr int I8_MAX_GROUP = 8;

struct Int8Layout {
  const int* table;  // [B, n_kv, max_blocks] block ids, or null (blk = t / bt)
  long long blk_rows, row_rows, head_rows, tok_rows;
  int max_blocks, bt, max_tok;
};

template <int N> struct I8Vec;
template <> struct I8Vec<2> { using type = short; };
template <> struct I8Vec<4> { using type = int; };
template <> struct I8Vec<16> { using type = int4; };

// N consecutive signed int8 values at p (aligned to N bytes) as floats.
template <int N>
__device__ __forceinline__ void load_i8(const int8_t* p, float (&out)[N]) {
  using V = typename I8Vec<N>::type;
  const V raw = *reinterpret_cast<const V*>(p);
  const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = static_cast<float>(e[i]);
}

template <typename T, int HD>
__global__ void __launch_bounds__(I8_WARPS * 32)
decode_int8_kernel(const T* __restrict__ q, const int8_t* __restrict__ k,
                   const int8_t* __restrict__ v, const float* __restrict__ sk,
                   const float* __restrict__ sv,
                   const int* __restrict__ seq_lens, T* __restrict__ out,
                   int H, int n_kv, int group, float scale, Int8Layout lay) {
  constexpr int KVEC = 16;              // int8 values of one 16-byte load
  constexpr int DPL = HD / 32;          // output dims per lane
  __shared__ __align__(16) float q_s[I8_MAX_GROUP][HD];
  __shared__ float m_s[I8_WARPS][I8_MAX_GROUP];
  __shared__ float l_s[I8_WARPS][I8_MAX_GROUP];
  __shared__ float acc_s[I8_WARPS][I8_MAX_GROUP][HD];

  const int b = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* qb = q + ((size_t)b * H + (size_t)h * group) * HD;
  for (int i = threadIdx.x; i < group * HD; i += blockDim.x)
    q_s[i / HD][i % HD] = to_float(qb[i]);
  __syncthreads();

  const int n_tok = min(seq_lens[b], lay.max_tok);
  const int* tb = lay.table == nullptr
                      ? nullptr
                      : lay.table + ((size_t)b * n_kv + h) * lay.max_blocks;
  const long long row0 = (long long)b * lay.row_rows + (long long)h * lay.head_rows;

  float m[I8_MAX_GROUP], l[I8_MAX_GROUP], acc[I8_MAX_GROUP][DPL];
#pragma unroll
  for (int g = 0; g < I8_MAX_GROUP; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[g][e] = 0.f;
  }

  for (int c0 = warp * 32; c0 < n_tok; c0 += I8_WARPS * 32) {
    // this lane's token: its cache row, its two scales and its scores
    // against every query head of the group
    const int t = c0 + lane;
    long long row = 0;
    float s_v = 0.f;
    float s[I8_MAX_GROUP];
#pragma unroll
    for (int g = 0; g < I8_MAX_GROUP; ++g) s[g] = 0.f;
    if (t < n_tok) {
      const int j = t / lay.bt;
      const long long blk = tb == nullptr ? j : tb[j];
      row = blk * lay.blk_rows + row0 + (long long)(t - j * lay.bt) * lay.tok_rows;
      s_v = sv[row];
      const float s_k = sk[row] * scale;
      const int8_t* krow = k + row * HD;
#pragma unroll
      for (int d = 0; d < HD; d += KVEC) {
        float kv[KVEC];
        load_i8<KVEC>(krow + d, kv);
#pragma unroll
        for (int g = 0; g < I8_MAX_GROUP; ++g) {
          if (g < group) {
#pragma unroll
            for (int e = 0; e < KVEC; e += 4) {
              const float4 qv = *reinterpret_cast<const float4*>(&q_s[g][d + e]);
              s[g] += qv.x * kv[e] + qv.y * kv[e + 1] + qv.z * kv[e + 2] +
                      qv.w * kv[e + 3];
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < I8_MAX_GROUP; ++g) s[g] *= s_k;
    } else {
#pragma unroll
      for (int g = 0; g < I8_MAX_GROUP; ++g) s[g] = NEG_INF;
    }
    // online softmax per head (lane c0 is a valid token, so m_new is
    // finite and masked tokens get p = 0); p carries the token's value
    // scale into P V
    float p[I8_MAX_GROUP];
#pragma unroll
    for (int g = 0; g < I8_MAX_GROUP; ++g) {
      if (g < group) {
        const float m_new = fmaxf(m[g], warp_max(s[g]));
        const float pg = expf(s[g] - m_new);
        const float corr = expf(m[g] - m_new);
        l[g] = l[g] * corr + warp_sum(pg);
        m[g] = m_new;
        p[g] = pg * s_v;
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[g][e] *= corr;
      } else {
        p[g] = 0.f;
      }
    }
    // P V: the warp walks the chunk's tokens, each lane its hd/32 dims
    const int n = min(32, n_tok - c0);
#pragma unroll
    for (int jb = 0; jb < 32; jb += 8) {
      float vv[8][DPL];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const long long rj = __shfl_sync(FULL_MASK, row, jb + u);
        if (jb + u < n) {
          load_i8<DPL>(v + rj * HD + lane * DPL, vv[u]);
        } else {
#pragma unroll
          for (int e = 0; e < DPL; ++e) vv[u][e] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
#pragma unroll
        for (int g = 0; g < I8_MAX_GROUP; ++g) {
          if (g < group) {
            const float pj = __shfl_sync(FULL_MASK, p[g], jb + u);
#pragma unroll
            for (int e = 0; e < DPL; ++e) acc[g][e] += pj * vv[u][e];
          }
        }
      }
    }
  }

  // merge the warps' partial softmax states
#pragma unroll
  for (int g = 0; g < I8_MAX_GROUP; ++g) {
    if (g < group) {
      if (lane == 0) {
        m_s[warp][g] = m[g];
        l_s[warp][g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc_s[warp][g][lane * DPL + e] = acc[g][e];
    }
  }
  __syncthreads();
  T* ob = out + ((size_t)b * H + (size_t)h * group) * HD;
  for (int i = threadIdx.x; i < group * HD; i += blockDim.x) {
    const int g = i / HD, d = i % HD;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < I8_WARPS; ++w) mx = fmaxf(mx, m_s[w][g]);
    // a row with no token (seq_len 0) leaves every warp at the finite
    // m = NEG_INF, l = 0, acc = 0: f = 1 and the output is 0, as the
    // Pallas kernel's acc / max(l, 1e-30)
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < I8_WARPS; ++w) {
      const float f = expf(m_s[w][g] - mx);
      den += l_s[w][g] * f;
      num += acc_s[w][g][d] * f;
    }
    ob[i] = from_float<T>(num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* sk,
                   const void* sv, const void* seq_lens, void* out, int B,
                   int H, int n_kv, float scale, const Int8Layout& lay,
                   cudaStream_t stream) {
  const dim3 grid(B, n_kv);
  decode_int8_kernel<T, HD><<<grid, I8_WARPS * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), static_cast<const float*>(sk),
      static_cast<const float*>(sv), static_cast<const int*>(seq_lens),
      static_cast<T*>(out), H, n_kv, H / n_kv, scale, lay);
  return cudaGetLastError();
}

}  // namespace repro

REPRO_EXPORT_ERROR_STRING

// q [B, H, hd] (f32 or bf16); k/v int8 and sk/sv f32 addressed as set
// out above; table [B, n_kv, max_blocks] int32 or null; seq_lens [B]
// int32; out [B, H, hd] in q's type.  dtype: 0 f32, 1 bf16.
extern "C" int repro_decode_int8(const void* q, const void* k, const void* v,
                                 const void* sk, const void* sv,
                                 const void* table, const void* seq_lens,
                                 void* out, int B, int H, int n_kv,
                                 int max_blocks, int bt, int max_tok,
                                 long long blk_rows, long long row_rows,
                                 long long head_rows, long long tok_rows,
                                 int hd, int dtype, float scale,
                                 void* stream) {
  using namespace repro;
  if (B <= 0 || n_kv <= 0 || H % n_kv != 0 || H / n_kv > I8_MAX_GROUP ||
      bt <= 0 || max_tok < 0 || (table != nullptr && max_blocks <= 0))
    return cudaErrorInvalidValue;
  const Int8Layout lay{static_cast<const int*>(table), blk_rows, row_rows,
                       head_rows, tok_rows, max_blocks, bt, max_tok};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == F32 && hd == 64)
    err = launch<float, 64>(q, k, v, sk, sv, seq_lens, out, B, H, n_kv, scale, lay, s);
  else if (dtype == F32 && hd == 128)
    err = launch<float, 128>(q, k, v, sk, sv, seq_lens, out, B, H, n_kv, scale, lay, s);
  else if (dtype == BF16 && hd == 64)
    err = launch<__nv_bfloat16, 64>(q, k, v, sk, sv, seq_lens, out, B, H, n_kv, scale, lay, s);
  else if (dtype == BF16 && hd == 128)
    err = launch<__nv_bfloat16, 128>(q, k, v, sk, sv, seq_lens, out, B, H, n_kv, scale, lay, s);
  return static_cast<int>(err);
}
