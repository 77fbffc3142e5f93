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
// What bounds it: bytes.  Each (row, kv head) reads its seq_len x hd
// keys and values once and does 4 flops per byte-pair element, far
// below the ~295 flops/byte the card needs to be compute-bound.  At
// full width the fused decode tick has at most 8 rows x 4 kv heads =
// 32 blocks of work for 132 SMs, so the card is underfilled: the cure
// (splitting each row's keys across CTAs and merging) is later work.
//
// Design: one CTA per (row b, kv head h), 8 warps.  The TPU's
// sequential block axis becomes a loop inside the CTA: warp w takes the
// 32-token chunks w, w+8, ... of the row (two head-blocks each, whose
// ids it reads from phys itself, in place of scalar prefetch) and stops
// at seq_len, the run condition of the Pallas kernel.  A lane scores
// one token against the group's resident query heads (q in shared
// memory, broadcast reads), the warp runs the online softmax per head
// with shuffles, and each lane then accumulates hd/32 output dims from
// coalesced value rows, fetched 8 rows at a time so the loads overlap.
// The 8 warp states merge through shared memory at the end.
#include "attn_common.cuh"

namespace repro {

constexpr int DEC_WARPS = 8;
constexpr int DEC_MAX_GROUP = 8;

template <typename T, int HD>
__global__ void __launch_bounds__(DEC_WARPS * 32)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ pool_k,
                    const T* __restrict__ pool_v, const int* __restrict__ phys,
                    const int* __restrict__ seq_lens, T* __restrict__ out,
                    int H, int n_kv, int max_blocks, int group, float scale) {
  constexpr int VEC = 16 / sizeof(T);   // elements of one 16-byte load
  constexpr int DPL = HD / 32;          // output dims per lane
  __shared__ __align__(16) float q_s[DEC_MAX_GROUP][HD];
  __shared__ float m_s[DEC_WARPS][DEC_MAX_GROUP];
  __shared__ float l_s[DEC_WARPS][DEC_MAX_GROUP];
  __shared__ float acc_s[DEC_WARPS][DEC_MAX_GROUP][HD];

  const int b = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* qb = q + ((size_t)b * H + (size_t)h * group) * HD;
  for (int i = threadIdx.x; i < group * HD; i += blockDim.x)
    q_s[i / HD][i % HD] = to_float(qb[i]);
  __syncthreads();

  const int n_tok = min(seq_lens[b], max_blocks * BLOCK_TOKENS);
  const int* ph = phys + ((size_t)b * n_kv + h) * max_blocks;

  float m[DEC_MAX_GROUP], l[DEC_MAX_GROUP], acc[DEC_MAX_GROUP][DPL];
#pragma unroll
  for (int g = 0; g < DEC_MAX_GROUP; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[g][e] = 0.f;
  }

  for (int c0 = warp * 32; c0 < n_tok; c0 += DEC_WARPS * 32) {
    // a 32-token chunk spans exactly two head-blocks (c0 is a multiple
    // of 32); tokens past n_tok are masked, so blk1 may be a dummy
    const int j0 = c0 / BLOCK_TOKENS;
    const int blk0 = ph[j0];
    const int blk1 = j0 + 1 < max_blocks ? ph[j0 + 1] : 0;
    // scores of this lane's token against every query head of the group
    const int t = c0 + lane;
    float s[DEC_MAX_GROUP];
#pragma unroll
    for (int g = 0; g < DEC_MAX_GROUP; ++g) s[g] = 0.f;
    if (t < n_tok) {
      const T* krow = pool_k +
          ((size_t)(lane < BLOCK_TOKENS ? blk0 : blk1) * BLOCK_TOKENS +
           lane % BLOCK_TOKENS) * HD;
#pragma unroll
      for (int d = 0; d < HD; d += VEC) {
        float kv[VEC];
        load_f<T, VEC>(krow + d, kv);
#pragma unroll
        for (int g = 0; g < DEC_MAX_GROUP; ++g) {
          if (g < group) {
#pragma unroll
            for (int e = 0; e < VEC; e += 4) {
              const float4 qv = *reinterpret_cast<const float4*>(&q_s[g][d + e]);
              s[g] += qv.x * kv[e] + qv.y * kv[e + 1] + qv.z * kv[e + 2] +
                      qv.w * kv[e + 3];
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < DEC_MAX_GROUP; ++g) s[g] *= scale;
    } else {
#pragma unroll
      for (int g = 0; g < DEC_MAX_GROUP; ++g) s[g] = NEG_INF;
    }
    // online softmax per head (lane c0 is a valid token, so m_new is
    // finite and masked tokens get p = 0)
    float p[DEC_MAX_GROUP];
#pragma unroll
    for (int g = 0; g < DEC_MAX_GROUP; ++g) {
      if (g < group) {
        const float m_new = fmaxf(m[g], warp_max(s[g]));
        p[g] = expf(s[g] - m_new);
        const float corr = expf(m[g] - m_new);
        l[g] = l[g] * corr + warp_sum(p[g]);
        m[g] = m_new;
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[g][e] *= corr;
      } else {
        p[g] = 0.f;
      }
    }
    // P V: the warp walks the chunk's tokens, each lane its hd/32 dims;
    // value rows are fetched 8 at a time so their loads overlap
    const int n = min(32, n_tok - c0);
#pragma unroll
    for (int jb = 0; jb < 32; jb += 8) {
      float vv[8][DPL];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int j = jb + u;
        if (j < n) {
          load_f<T, DPL>(pool_v +
              ((size_t)(j < BLOCK_TOKENS ? blk0 : blk1) * BLOCK_TOKENS +
               j % BLOCK_TOKENS) * HD + lane * DPL, vv[u]);
        } else {
#pragma unroll
          for (int e = 0; e < DPL; ++e) vv[u][e] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
#pragma unroll
        for (int g = 0; g < DEC_MAX_GROUP; ++g) {
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
  for (int g = 0; g < DEC_MAX_GROUP; ++g) {
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
    for (int w = 0; w < DEC_WARPS; ++w) mx = fmaxf(mx, m_s[w][g]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) {
      const float f = expf(m_s[w][g] - mx);
      den += l_s[w][g] * f;
      num += acc_s[w][g][d] * f;
    }
    ob[i] = from_float<T>(num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* pool_k, const void* pool_v,
                   const void* phys, const void* seq_lens, void* out, int B,
                   int H, int n_kv, int max_blocks, float scale,
                   cudaStream_t stream) {
  const dim3 grid(B, n_kv);
  paged_decode_kernel<T, HD><<<grid, DEC_WARPS * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pool_k),
      static_cast<const T*>(pool_v), static_cast<const int*>(phys),
      static_cast<const int*>(seq_lens), static_cast<T*>(out), H, n_kv,
      max_blocks, H / n_kv, scale);
  return cudaGetLastError();
}

}  // namespace repro

REPRO_EXPORT_ERROR_STRING

// q [B, H, hd]; pool_k/v [N, 16, hd]; phys [B, n_kv, max_blocks] int32;
// seq_lens [B] int32 (>= 1); out [B, H, hd].  dtype: 0 f32, 1 bf16.
extern "C" int repro_paged_decode(const void* q, const void* pool_k,
                                  const void* pool_v, const void* phys,
                                  const void* seq_lens, void* out, int B,
                                  int H, int n_kv, int max_blocks, int hd,
                                  int dtype, float scale, void* stream) {
  using namespace repro;
  if (B <= 0 || n_kv <= 0 || H % n_kv != 0 || H / n_kv > DEC_MAX_GROUP)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == F32 && hd == 64)
    err = launch<float, 64>(q, pool_k, pool_v, phys, seq_lens, out, B, H, n_kv, max_blocks, scale, s);
  else if (dtype == F32 && hd == 128)
    err = launch<float, 128>(q, pool_k, pool_v, phys, seq_lens, out, B, H, n_kv, max_blocks, scale, s);
  else if (dtype == BF16 && hd == 64)
    err = launch<__nv_bfloat16, 64>(q, pool_k, pool_v, phys, seq_lens, out, B, H, n_kv, max_blocks, scale, s);
  else if (dtype == BF16 && hd == 128)
    err = launch<__nv_bfloat16, 128>(q, pool_k, pool_v, phys, seq_lens, out, B, H, n_kv, max_blocks, scale, s);
  return static_cast<int>(err);
}
