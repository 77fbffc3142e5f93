// Mamba2 SSD (state-space duality) chunked scan, for Hopper.
//
// Replaces the TPU kernel `ssd_scan` (src/repro/kernels/ssd_scan.py:79,
// body `_ssd_kernel`) and computes what its oracle `ssd_chunked`
// (src/repro/models/mamba2.py:97) computes, carried state included:
//   x [b, S, H, P], dt [b, S, H] f32, a_log [H] f32, B/C [b, S, G, N],
//   d_skip [H] f32, init [b, H, P, N] f32 or null (zeros)
//   -> y [b, S, H, P] in x's dtype, final state [b, H, P, N] f32.
// Head h reads group g = h / (H / G); B and C are never repeated in
// memory, and every tensor stays in the JAX layout (no transposes).
// S need not be a multiple of the chunk: rows past S in the last chunk
// are masked as dt = 0 with zero x/B/C, which neither decays nor feeds
// the state (the padding of the port's `ssd_plain`).
//
// What bounds it: bytes at the served shapes.  Mamba2-2.7b chunk step
// (b = 4 slots, 64-token chunk, H = 80, P = 64, N = 128, G = 1, bf16
// x/B/C) moves about 26 MB, 21 MB of it the f32 state read and
// written, so about 8 us at 3.35 TB/s; its 1.2 GFLOP take about 1.2 us
// on bf16 tensor cores and about 18 us as f32 FMAs on CUDA cores.  This
// first version runs every product as f32 FMAs on the CUDA cores, so it
// sits above both; mma/wgmma tiles are later work.  The zamba2-1.2b
// whole-prompt bucket (H = 64) launches only b * 64 CTAs: at b <= 2
// that is fewer than the card's 132 SMs.
//
// Design: the TPU grid's sequential chunk axis (state carried in VMEM
// scratch) becomes a loop over chunks inside one CTA per (b, h), 256
// threads, with the [P, N] state in shared memory (64 x 128 f32 =
// 32 KB).  Per chunk:
//   1. the cumulative log-decay l = cumsum(dt * a) as a block scan;
//   2. per 64-row query tile i: y = exp(l_i) (C_i . S_prev), then for
//      each key tile j <= i the masked, decayed scores
//      (C_i . B_j) exp(l_i - l_j) (mask before the exp, as the Pallas
//      kernel does) into shared memory and y += scores . (dt x)_j; then
//      y += D x, stored in x's dtype.  Tiling keeps the [Q, Q] term of
//      a 256-token chunk (256 KB in f32) out of shared memory: only the
//      lower-triangular 64 x 64 tiles are formed;
//   3. S = exp(l_last) S_prev + sum_j exp(l_last - l_j) (dt x)_j (x) B_j.
// Thread (ty, tx) of the 16 x 16 block owns rows ty + 16r and columns
// tx + 16c of each 64 x 64 product (and of the 64 x N state), so the
// rows it reads from shared memory (padded by one float) fall on
// distinct banks.
#include "attn_common.cuh"

namespace repro {

constexpr int SSD_P = 64;          // SSM head_dim
constexpr int SSD_T = 64;          // rows of a query / key tile
constexpr int SSD_THREADS = 256;   // 16 x 16
constexpr int SSD_MAX_Q = 256;     // longest chunk (one scan slot a thread)
constexpr int SSD_MAX_N = 128;     // largest d_state
constexpr int SSD_NC = SSD_MAX_N / 16;

// shared floats: state [P][N+1], C tile [T][N+1], B tile [T][N+1],
// x*dt tile [T][P], scores [T][T+1], l [MAX_Q], warp totals [8]
__host__ __device__ constexpr size_t ssd_smem_floats(int N) {
  return (size_t)(SSD_P + 2 * SSD_T) * (N + 1) + SSD_T * SSD_P +
         SSD_T * (SSD_T + 1) + SSD_MAX_Q + SSD_THREADS / 32;
}

// Rows r < SSD_T of width `width` into dst[r * ld + c] as f32; row(r)
// returns the row's first element or nullptr for a masked (zero) row.
template <typename T, typename RowFn>
__device__ __forceinline__ void load_rows(float* dst, int ld, int width,
                                          RowFn row) {
  for (int i = threadIdx.x; i < SSD_T * width; i += SSD_THREADS) {
    const int r = i / width, c = i - r * width;
    const T* src = row(r);
    dst[r * ld + c] = src ? to_float(src[c]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(SSD_THREADS)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a_log, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ d_skip,
                const float* __restrict__ init, T* __restrict__ y,
                float* __restrict__ fstate, int S, int H, int G, int N,
                int Q) {
  extern __shared__ __align__(16) float smem[];
  const int NS = N + 1;
  float* st = smem;                       // [P][N+1] carried state
  float* cs = st + SSD_P * NS;            // [T][N+1] C of the query tile
  float* bs = cs + SSD_T * NS;            // [T][N+1] B of the key tile
  float* xs = bs + SSD_T * NS;            // [T][P]   x * dt (* weight)
  float* sc = xs + SSD_T * SSD_P;         // [T][T+1] decayed scores
  float* ls = sc + SSD_T * (SSD_T + 1);   // [MAX_Q]  cumulative log-decay
  float* wsum = ls + SSD_MAX_Q;           // [8]      warp totals

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int g = h / (H / G);
  const int ncol = N / 16;
  const float a = -expf(a_log[h]);
  const float dskip = d_skip[h];
  const size_t state_off = (size_t)bh * SSD_P * N;

  for (int i = tid; i < SSD_P * N; i += SSD_THREADS) {
    const int p = i / N, n = i - p * N;
    st[p * NS + n] = init ? init[state_off + i] : 0.f;
  }

  auto x_row = [&](int s) { return x + (((size_t)b * S + s) * H + h) * SSD_P; };
  auto dt_at = [&](int s) { return dt[((size_t)b * S + s) * H + h]; };
  auto bc_row = [&](const T* m, int s) {
    return m + (((size_t)b * S + s) * G + g) * N;
  };

  for (int c0 = 0; c0 < S; c0 += Q) {
    const int q = min(Q, S - c0);                  // rows of this chunk
    const int nt = (q + SSD_T - 1) / SSD_T;        // 64-row tiles
    __syncthreads();   // the previous chunk is done with ls and wsum

    // 1. inclusive block scan of dA over 256 slots (0 past the chunk)
    {
      float v = tid < q ? dt_at(c0 + tid) * a : 0.f;
      const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(FULL_MASK, v, o);
        if (lane >= o) v += u;
      }
      if (lane == 31) wsum[warp] = v;
      __syncthreads();
      for (int w = 0; w < warp; ++w) v += wsum[w];
      ls[tid] = v;
    }
    __syncthreads();
    const float ltot = ls[SSD_MAX_Q - 1];

    // 2. outputs, one 64-row query tile at a time
    for (int it = 0; it < nt; ++it) {
      const int i0 = it * SSD_T;
      load_rows<T>(cs, NS, N, [&](int r) -> const T* {
        return i0 + r < q ? bc_row(Cm, c0 + i0 + r) : nullptr;
      });
      __syncthreads();

      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
      // inter-chunk: exp(l_i) * (C_i . S_prev[p])
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = cs[(ty + 16 * r) * NS + n];
#pragma unroll
        for (int c = 0; c < 4; ++c) sv[c] = st[(tx + 16 * c) * NS + n];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(cv[r], sv[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float e = expf(ls[i0 + ty + 16 * r]);
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] *= e;
      }

      // intra-chunk: lower-triangular key tiles
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * SSD_T;
        __syncthreads();   // the previous key tile is consumed
        load_rows<T>(bs, NS, N, [&](int r) -> const T* {
          return j0 + r < q ? bc_row(Bm, c0 + j0 + r) : nullptr;
        });
        for (int i = tid; i < SSD_T * SSD_P; i += SSD_THREADS) {
          const int r = i / SSD_P, p = i - r * SSD_P, s = j0 + r;
          xs[i] = s < q ? to_float(x_row(c0 + s)[p]) * dt_at(c0 + s) : 0.f;
        }
        __syncthreads();
        float sco[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) sco[r][c] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) cv[r] = cs[(ty + 16 * r) * NS + n];
#pragma unroll
          for (int c = 0; c < 4; ++c) bv[c] = bs[(tx + 16 * c) * NS + n];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              sco[r][c] = fmaf(cv[r], bv[c], sco[r][c]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ty + 16 * r;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = j0 + tx + 16 * c;
            // mask before the exp: above the diagonal l_i - l_j > 0
            sc[(ty + 16 * r) * (SSD_T + 1) + tx + 16 * c] =
                j <= i ? sco[r][c] * expf(ls[i] - ls[j]) : 0.f;
          }
        }
        __syncthreads();
        const int jn = min(SSD_T, q - j0);
        for (int jj = 0; jj < jn; ++jj) {
          float sv[4], xv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) sv[r] = sc[(ty + 16 * r) * (SSD_T + 1) + jj];
#pragma unroll
          for (int c = 0; c < 4; ++c) xv[c] = xs[jj * SSD_P + tx + 16 * c];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(sv[r], xv[c], acc[r][c]);
        }
      }

#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty + 16 * r;
        if (i < q) {
          const T* xr = x_row(c0 + i);
          T* yr = y + (((size_t)b * S + c0 + i) * H + h) * SSD_P;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int p = tx + 16 * c;
            yr[p] = from_float<T>(acc[r][c] + dskip * to_float(xr[p]));
          }
        }
      }
      __syncthreads();   // cs is consumed before the next query tile
    }

    // 3. state update: thread owns state rows ty + 16r, columns tx + 16c
    float sacc[4][SSD_NC];
    const float dtot = expf(ltot);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < SSD_NC; ++c)
        sacc[r][c] = c < ncol ? dtot * st[(ty + 16 * r) * NS + tx + 16 * c] : 0.f;
    for (int jt = 0; jt < nt; ++jt) {
      const int j0 = jt * SSD_T;
      __syncthreads();
      load_rows<T>(bs, NS, N, [&](int r) -> const T* {
        return j0 + r < q ? bc_row(Bm, c0 + j0 + r) : nullptr;
      });
      for (int i = tid; i < SSD_T * SSD_P; i += SSD_THREADS) {
        const int r = i / SSD_P, p = i - r * SSD_P, s = j0 + r;
        xs[i] = s < q ? to_float(x_row(c0 + s)[p]) * dt_at(c0 + s) *
                            expf(ltot - ls[s])
                      : 0.f;
      }
      __syncthreads();
      const int jn = min(SSD_T, q - j0);
      for (int jj = 0; jj < jn; ++jj) {
        float u[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) u[r] = xs[jj * SSD_P + ty + 16 * r];
#pragma unroll
        for (int c = 0; c < SSD_NC; ++c) {
          if (c < ncol) {
            const float bv = bs[jj * NS + tx + 16 * c];
#pragma unroll
            for (int r = 0; r < 4; ++r) sacc[r][c] = fmaf(u[r], bv, sacc[r][c]);
          }
        }
      }
    }
    __syncthreads();   // every reader of S_prev is done
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < SSD_NC; ++c)
        if (c < ncol) st[(ty + 16 * r) * NS + tx + 16 * c] = sacc[r][c];
  }

  __syncthreads();
  for (int i = tid; i < SSD_P * N; i += SSD_THREADS) {
    const int p = i / N, n = i - p * N;
    fstate[state_off + i] = st[p * NS + n];
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* a_log,
                   const void* Bm, const void* Cm, const void* d_skip,
                   const void* init, void* y, void* fstate, int batch, int S,
                   int H, int G, int N, int Q, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(ssd_smem_floats(SSD_MAX_N) * sizeof(float)));
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const size_t smem = ssd_smem_floats(N) * sizeof(float);
  ssd_scan_kernel<T><<<batch * H, SSD_THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a_log), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(d_skip),
      static_cast<const float*>(init), static_cast<T*>(y),
      static_cast<float*>(fstate), S, H, G, N, Q);
  return cudaGetLastError();
}

}  // namespace repro

REPRO_EXPORT_ERROR_STRING

// x [batch, S, H, P]; dt [batch, S, H] f32; a_log, d_skip [H] f32;
// B/C [batch, S, G, N]; init [batch, H, P, N] f32 or null (zeros);
// y like x; fstate [batch, H, P, N] f32.  P must be 64, N a multiple of
// 16 up to 128, 0 < chunk <= 256.  dtype (of x, B, C, y): 0 f32, 1 bf16.
extern "C" int repro_ssd_scan(const void* x, const void* dt,
                              const void* a_log, const void* Bm,
                              const void* Cm, const void* d_skip,
                              const void* init, void* y, void* fstate,
                              int batch, int S, int H, int G, int N, int P,
                              int chunk, int dtype, void* stream) {
  using namespace repro;
  if (batch <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 ||
      P != SSD_P || N <= 0 || N % 16 != 0 || N > SSD_MAX_N || chunk <= 0 ||
      chunk > SSD_MAX_Q || (long long)batch * H > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == F32)
    err = launch<float>(x, dt, a_log, Bm, Cm, d_skip, init, y, fstate, batch,
                        S, H, G, N, chunk, s);
  else if (dtype == BF16)
    err = launch<__nv_bfloat16>(x, dt, a_log, Bm, Cm, d_skip, init, y, fstate,
                                batch, S, H, G, N, chunk, s);
  return static_cast<int>(err);
}
