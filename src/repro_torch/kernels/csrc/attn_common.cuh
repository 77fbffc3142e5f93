// Shared pieces of the Hopper attention kernels (sm_90a): element
// conversion, 4/8/16-byte vector loads and stores, warp reductions, and
// the row-tile online-softmax step used by the two prefill kernels.
//
// Every kernel accumulates in float32 with the finite NEG_INF = -1e30
// and the max(l, 1e-30) guard of the JAX package's kernels, so padded
// rows (decode rows of length 1 over block 0, chunk rows with table -1)
// produce finite output, as the reference does.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr float NEG_INF = -1e30f;
constexpr int BLOCK_TOKENS = 16;   // tokens of one pool head-block
constexpr unsigned FULL_MASK = 0xffffffffu;

enum DType { F32 = 0, BF16 = 1 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int BYTES> struct VecOf;
template <> struct VecOf<4> { using type = unsigned int; };
template <> struct VecOf<8> { using type = uint2; };
template <> struct VecOf<16> { using type = uint4; };

// N consecutive elements at p (aligned to N*sizeof(T) bytes) as floats.
template <typename T, int N>
__device__ __forceinline__ void load_f(const T* p, float (&out)[N]) {
  using V = typename VecOf<N * sizeof(T)>::type;
  V v = *reinterpret_cast<const V*>(p);
  const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = to_float(e[i]);
}

template <typename T, int N>
__device__ __forceinline__ void store_f(T* p, const float (&in)[N]) {
  using V = typename VecOf<N * sizeof(T)>::type;
  V v;
  T* e = reinterpret_cast<T*>(&v);
#pragma unroll
  for (int i = 0; i < N; ++i) e[i] = from_float<T>(in[i]);
  *reinterpret_cast<V*>(p) = v;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL_MASK, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL_MASK, x, o);
  return x;
}

// ---------------------------------------------------------------------------
// Row tile for the prefill kernels: TQ query rows against key tiles of
// BK = one pool head-block, 128 threads.  Thread (r = tid / 4, tx = tid % 4)
// owns query row r, the keys tx + 4k (k < 4) of each tile, and the output
// dims tx*4 + 16*kk + j.  Rows are padded by 4 floats so the float4 reads
// of a quarter warp fall on distinct banks.
// ---------------------------------------------------------------------------
constexpr int TILE_Q = 32;
constexpr int TILE_K = BLOCK_TOKENS;
constexpr int TILE_THREADS = 128;

template <int HD> struct TileSmem {
  float q[TILE_Q][HD + 4];
  float k[TILE_K][HD + 4];
  float v[TILE_K][HD + 4];
  float p[TILE_Q][TILE_K + 1];
};

// Copy `rows` rows of HD elements into a float tile; row_ptr(i) gives
// row i's address in device memory or nullptr for a zero row.
template <typename T, int HD, typename RowPtr>
__device__ __forceinline__ void load_tile(float (*dst)[HD + 4], int rows,
                                          RowPtr row_ptr) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = HD / VEC;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < rows * CPR; i += TILE_THREADS) {
    const int r = i / CPR, c = (i % CPR) * VEC;
    const T* row = row_ptr(r);
    float tmp[VEC];
    if (row != nullptr) {
      load_f<T, VEC>(row + c, tmp);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) tmp[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) dst[r][c + e] = tmp[e];
  }
}

// One key tile of the online softmax for this thread's row: scores
// q.k * scale where keep[k] (else NEG_INF), running max m, running sum l,
// accumulator acc rescaled and advanced by P V.  The tile's k/v must be
// in shared memory and visible (caller syncs).
template <int HD>
__device__ __forceinline__ void tile_step(TileSmem<HD>& sm, int r, int tx,
                                          const bool (&keep)[4], float scale,
                                          float& m, float& l,
                                          float (&acc)[HD / 16][4]) {
  float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
  for (int d = 0; d < HD; d += 4) {
    const float4 qv = *reinterpret_cast<const float4*>(&sm.q[r][d]);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float4 kv = *reinterpret_cast<const float4*>(&sm.k[tx + 4 * k][d]);
      s[k] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
    }
  }
  float mx = NEG_INF;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    s[k] = keep[k] ? s[k] * scale : NEG_INF;
    mx = fmaxf(mx, s[k]);
  }
  // the 4 threads of a row are adjacent lanes
  mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, 2));
  const float m_new = fmaxf(m, mx);
  const float corr = expf(m - m_new);
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float p = expf(s[k] - m_new);
    sm.p[r][tx + 4 * k] = p;
    sum += p;
  }
  sum += __shfl_xor_sync(FULL_MASK, sum, 1);
  sum += __shfl_xor_sync(FULL_MASK, sum, 2);
  l = l * corr + sum;
  m = m_new;
  __syncwarp();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[kk][j] *= corr;
  }
#pragma unroll 4
  for (int t = 0; t < TILE_K; ++t) {
    const float p = sm.p[r][t];
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const float4 vv =
          *reinterpret_cast<const float4*>(&sm.v[t][tx * 4 + 16 * kk]);
      acc[kk][0] += p * vv.x;
      acc[kk][1] += p * vv.y;
      acc[kk][2] += p * vv.z;
      acc[kk][3] += p * vv.w;
    }
  }
}

template <typename T, int HD>
__device__ __forceinline__ void store_row(T* out_row, int tx, float l,
                                          const float (&acc)[HD / 16][4]) {
  const float den = fmaxf(l, 1e-30f);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const float o[4] = {acc[kk][0] / den, acc[kk][1] / den, acc[kk][2] / den,
                        acc[kk][3] / den};
    store_f<T, 4>(out_row + tx * 4 + 16 * kk, o);
  }
}

}  // namespace repro

// Every library exports its launch functions plus this readable error.
#define REPRO_EXPORT_ERROR_STRING                               \
  extern "C" const char* repro_error_string(int err) {          \
    return cudaGetErrorString(static_cast<cudaError_t>(err));   \
  }
