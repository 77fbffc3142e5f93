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
// the state (the padding of the port's `ssd_plain`).  Per chunk of q
// rows, with l = cumsum(dt * a) and w_j = exp(l_last - l_j):
//   y_i   = exp(l_i) (C_i . S_prev) + sum_{j<=i} (C_i . B_j) exp(l_i - l_j)
//           dt_j x_j + D x_i
//   S_new = exp(l_last) S_prev + sum_j (x_j dt_j w_j) (x) B_j.
//
// What bounds it.  The mamba2-2.7b chunk step (b <= 4 slots, 64-token
// chunk, H 80, P 64, N 128, bf16 x/B/C) is bound by bytes: it moves
// about 26 MB at b = 4, 21 MB of it the f32 state read once and written
// once (~8 us at 3.35 TB/s), against ~1.2 GFLOP (~1.2 us on bf16 tensor
// cores).  The zamba2-1.2b whole-prompt bucket (b 2, S 512, chunk 256,
// H 64, N 64) has bytes and math about equal at the card's peaks: 19 MB
// (~5.8 us) and 3.2 GFLOP (~3.3 us), two chunks walked in order.
//
// bf16 (the serving path): tensor cores, `ssd_scan_tc_kernel`.
// * Grid (b, h, P-slice): a CTA owns 64 (or 32) of a head's 64 state rows
//   and y columns; slices are independent and recompute only C.B^T.  The
//   host plans slice and warps from b * H, the chunk, N and the SM count
//   alone (kernels/ssd_scan.py, `plan_launch`): 8 warps (one CTA an SM
//   by its registers) on whole heads; 32-row slices where whole heads
//   fill at most half the SMs or do not fit in shared memory; 4-warp CTAs
//   (two an SM) where whole heads are between one and two CTAs an SM.
//   The chunks of a head are walked in order, the state carried in f32
//   in shared memory.
// * Copies: the f32 state slice (first chunk; the largest read), the
//   chunk's C and B rows and the slice's x columns by 16-byte cp.async,
//   all in flight together, into rows padded by 16 bytes (ldmatrix's
//   eight row reads fall on distinct banks); rows past q zero-filled.
//   The final state leaves in 16-byte stores, y as packed bf16 pairs.
// * l = cumsum(dt a) is kept in log2 units; every exp is one ex2.approx.
// * Products, mma.sync m16n8k16 (bf16 in, f32 accumulate) fed by
//   ldmatrix(.trans); a warp takes 16-row query tiles (balanced over the
//   lower triangle) and walks their key tiles two at a time, the next k
//   step's B fragments loaded before the current products:
//     y_inter = 2^l_i (C_i . S_prev^T): S_prev's operand copy is rounded
//               to bf16, the state itself stays f32;
//     scores  = (C_i . B_j^T) dt_j 2^(l_i - l_j), scaled in f32 on the
//               accumulator fragments and rounded once to bf16 as the A
//               operand of the next product (the accumulators of two n8
//               tiles are one m16k16 A fragment).  Below the diagonal
//               the decay splits at the key tile's last slot e into
//               2^(l_i - l_e) (two ex2 a lane) and dt_j 2^(l_e - l_j)
//               (one per key, per chunk), both <= 1; on the diagonal
//               tile it is masked before the exp (the exponent clamped
//               to <= 0, the entry selected away, no branch);
//     y_intra = scores . x_j (x exact in bf16: dt is in the scores);
//     S_new   = 2^l_last S_prev + (x dt w)^T . B: x dt w is formed in f32
//               and rounded once into shared memory per chunk, read as
//               A fragments by ldmatrix.trans; the accumulators start
//               from 2^l_last S_prev and are written back to the f32
//               state.  With 8 warps and at most 4 query tiles (the
//               chunk step), warps 4-7, which have no tile, take the
//               whole update while 0-3 compute y.
//   What holds it back at the chunk step (PERF.md): a wave's CTAs move
//   through copy, math and state store in lockstep, so device memory
//   idles during the math; a persistent grid with double-buffered copies
//   (cp.async or TMA tiles) and bulk stores of the state did not help.
// float32 (the reduced test models, held at 1e-4, which TF32 cannot
// meet): the CUDA-core body `ssd_scan_kernel` below, one CTA per (b, h),
// 256 threads, the [P, N] state in shared memory; per chunk a block
// scan of l, per 64-row query tile the inter-chunk term and the masked
// lower-triangular 64 x 64 score tiles, then the state update, every
// product an f32 FMA.
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

// ---------------------------------------------------------------------------
// bf16: the tensor-core body (see the note at the top)
// ---------------------------------------------------------------------------
constexpr int SSD_PAD = 8;            // bf16 elements of row padding
constexpr int SSD_FPAD = 4;           // f32 elements of row padding
constexpr int SSD_MAX_KS = SSD_MAX_N / 16;   // k16 steps over N
constexpr float LOG2E = 1.4426950408889634f;

// Shared bytes of one CTA: f32 state [PS][N+4], l, dt, dt*w and dt*u
// [Qp], scan totals [16]; bf16 C and B [Qp][N+8], x and x dt w [Qp][PS+8],
// S_prev operand [PS][N+8].  Every region and row starts on 16 bytes.
// (kernels/ssd_scan.py plans from a copy of this formula; the card tests
// hold it to repro_ssd_tc_smem below.)
__host__ __device__ constexpr size_t ssd_tc_smem_bytes(int Qp, int N, int PS) {
  return (size_t)PS * (N + SSD_FPAD) * 4 + (size_t)4 * Qp * 4 + 16 * 4 +
         ((size_t)2 * Qp * (N + SSD_PAD) + (size_t)2 * Qp * (PS + SSD_PAD) +
          (size_t)PS * (N + SSD_PAD)) * 2;
}
constexpr size_t SSD_MAX_SMEM = 232448;   // an H100's per-block limit

// The (row, unit) pairs of items start, start + step, ... over rows of
// `units` units, advanced without a division in the loop.
struct RowWalk {
  int r, u, dr, du, units;
  __device__ RowWalk(int start, int step, int units_)
      : r(start / units_), u(start % units_), dr(step / units_),
        du(step % units_), units(units_) {}
  __device__ void next() {
    r += dr;
    u += du;
    if (u >= units) {
      u -= units;
      ++r;
    }
  }
};

// On the diagonal key tile: s 2^(li - lj) dtj where key j <= query i,
// else 0 (l in log2 units).  Masked before the exp: the exponent is
// clamped to <= 0, so an entry above the diagonal (li - lj > 0) cannot
// overflow, and is selected away without a branch.
__device__ __forceinline__ float decayed(float s, bool keep, float li,
                                         float lj, float dtj) {
  const float v = s * ex2(fminf(li - lj, 0.f)) * dtj;
  return keep ? v : 0.f;
}

// acc += scores . x over KT 16-key tiles from key j0, for the query rows
// ia and ib = ia + 8 of this lane: scores = (C_i . B_j^T) 2^(l_i - l_j)
// dt_j, rounded to bf16 as the A fragments of the product with x (the
// accumulators of two n8 tiles are one m16k16 A fragment).  Below the
// diagonal (DIAG false, every key before every query row) the decay
// splits at the key tile's last slot e, both factors <= 1:
// 2^(l_i - l_e) (a row factor, two ex2 a lane) times u_j = dt_j 2^(l_e -
// l_j) (precomputed per chunk).  Copies run ahead of the products: B's
// fragments for k step ks + 1 are loaded before the products of ks, x's
// before the decay.
template <int KT, int PS, bool DIAG>
__device__ __forceinline__ void intra_keys(
    float (&acc)[PS / 8][4], const uint32_t (&cf)[SSD_MAX_KS][4], int nk,
    const bf16* bs, const bf16* xs, const float* ls, const float* dts,
    const float* ujs, int LN, int LP, int j0, int ia, int ib, float la,
    float lb, int lane) {
  const int lrow = lane & 15, lcol = (lane >> 4) * 8;
  const int brow = (lane & 7) + ((lane >> 4) << 3);
  const int bcol = ((lane >> 3) & 1) * 8;
  float s[2 * KT][4];
#pragma unroll
  for (int t = 0; t < 2 * KT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
  uint32_t bf[2][KT][4];
#pragma unroll
  for (int kt = 0; kt < KT; ++kt)
    ldmatrix_x4(bf[0][kt], bs + (j0 + 16 * kt + brow) * LN + bcol);
#pragma unroll
  for (int ks = 0; ks < SSD_MAX_KS; ++ks) {
    if (ks < nk) {
      if (ks + 1 < nk) {
#pragma unroll
        for (int kt = 0; kt < KT; ++kt)
          ldmatrix_x4(bf[(ks + 1) & 1][kt],
                      bs + (j0 + 16 * kt + brow) * LN + (ks + 1) * 16 + bcol);
      }
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        mma_16816<false>(s[2 * kt], cf[ks], bf[ks & 1][kt][0],
                         bf[ks & 1][kt][1]);
        mma_16816<false>(s[2 * kt + 1], cf[ks], bf[ks & 1][kt][2],
                         bf[ks & 1][kt][3]);
      }
    }
  }
  uint32_t xf[KT][PS / 16][4];
#pragma unroll
  for (int kt = 0; kt < KT; ++kt)
#pragma unroll
    for (int np = 0; np < PS / 16; ++np)
      ldmatrix_x4_trans(xf[kt][np],
                        xs + (j0 + 16 * kt + lrow) * LP + np * 16 + lcol);
  uint32_t pa[KT][4];
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    // s[2kt] holds keys ja, ja + 1 and s[2kt + 1] ja + 8, ja + 9
    const int ja = j0 + 16 * kt + 2 * (lane & 3);
    float v[8];
    if constexpr (DIAG) {
      const float2 l0 = *reinterpret_cast<const float2*>(ls + ja);
      const float2 l1 = *reinterpret_cast<const float2*>(ls + ja + 8);
      const float2 d0 = *reinterpret_cast<const float2*>(dts + ja);
      const float2 d1 = *reinterpret_cast<const float2*>(dts + ja + 8);
      v[0] = decayed(s[2 * kt][0], ja <= ia, la, l0.x, d0.x);
      v[1] = decayed(s[2 * kt][1], ja + 1 <= ia, la, l0.y, d0.y);
      v[2] = decayed(s[2 * kt][2], ja <= ib, lb, l0.x, d0.x);
      v[3] = decayed(s[2 * kt][3], ja + 1 <= ib, lb, l0.y, d0.y);
      v[4] = decayed(s[2 * kt + 1][0], ja + 8 <= ia, la, l1.x, d1.x);
      v[5] = decayed(s[2 * kt + 1][1], ja + 9 <= ia, la, l1.y, d1.y);
      v[6] = decayed(s[2 * kt + 1][2], ja + 8 <= ib, lb, l1.x, d1.x);
      v[7] = decayed(s[2 * kt + 1][3], ja + 9 <= ib, lb, l1.y, d1.y);
    } else {
      const float le = ls[j0 + 16 * kt + 15];
      const float ra = ex2(la - le), rb = ex2(lb - le);
      const float2 u0 = *reinterpret_cast<const float2*>(ujs + ja);
      const float2 u1 = *reinterpret_cast<const float2*>(ujs + ja + 8);
      v[0] = s[2 * kt][0] * ra * u0.x;
      v[1] = s[2 * kt][1] * ra * u0.y;
      v[2] = s[2 * kt][2] * rb * u0.x;
      v[3] = s[2 * kt][3] * rb * u0.y;
      v[4] = s[2 * kt + 1][0] * ra * u1.x;
      v[5] = s[2 * kt + 1][1] * ra * u1.y;
      v[6] = s[2 * kt + 1][2] * rb * u1.x;
      v[7] = s[2 * kt + 1][3] * rb * u1.y;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) pa[kt][e] = pack_bf16(v[2 * e], v[2 * e + 1]);
  }
#pragma unroll
  for (int kt = 0; kt < KT; ++kt)
#pragma unroll
    for (int np = 0; np < PS / 16; ++np) {
      mma_16816<false>(acc[2 * np], pa[kt], xf[kt][np][0], xf[kt][np][1]);
      mma_16816<false>(acc[2 * np + 1], pa[kt], xf[kt][np][2],
                       xf[kt][np][3]);
    }
}

// S_new = dtot S_prev + (x dt w)^T . B over one chunk's qt key tiles
// (us: x dt w in bf16, [Qp][PS+8]), by the WP warps pw = 0 .. WP - 1.
// Warp pw takes the 16-column groups n16 = pw / gw + k WP / gw (k < NG)
// and, in each, the m16 tiles mt = pw (mod gw): gw = WP / nk warps share
// a group when there are fewer groups than warps.  It reads its state
// elements from, and writes them back to, the f32 state (no other warp
// touches them).
template <int MT, int WP, int PS>
__device__ __forceinline__ void state_update(
    int pw, int lane, float* sf, const bf16* us, const bf16* bs, int LF,
    int LN, int LP, int nk, int qt, float dtot) {
  constexpr int NG = SSD_MAX_KS / WP > 0 ? SSD_MAX_KS / WP : 1;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int lrow = lane & 15, lcol = (lane >> 4) * 8;
  const int brow = (lane & 7) + ((lane >> 4) << 3);
  const int bcol = ((lane >> 3) & 1) * 8;
  // gw is 1, 2, 4 or 8 (WP and nk <= 8): shifts and masks, no division
  const int gw = max(1, WP / nk);
  const int gsh = __ffs(gw) - 1;
  const int n16_0 = pw >> gsh, n16_step = WP >> gsh;
  unsigned mine = 0;                                // m16 tiles of this warp
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    if ((mt & (gw - 1)) == (pw & (gw - 1))) mine |= 1u << mt;
  if (n16_0 >= nk) return;
  float sacc[NG][MT][2][4];                         // [group][m16][n8][4]
#pragma unroll
  for (int k = 0; k < NG; ++k) {
    const int n16 = n16_0 + k * n16_step;
    if (n16 >= nk) continue;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (!(mine >> mt & 1)) continue;
#pragma unroll
      for (int hn = 0; hn < 2; ++hn) {
        const float* r0 = sf + (mt * 16 + g8) * LF + n16 * 16 + hn * 8 + 2 * t4;
        const float2 v0 = *reinterpret_cast<const float2*>(r0);
        const float2 v1 = *reinterpret_cast<const float2*>(r0 + 8 * LF);
        sacc[k][mt][hn][0] = dtot * v0.x;
        sacc[k][mt][hn][1] = dtot * v0.y;
        sacc[k][mt][hn][2] = dtot * v1.x;
        sacc[k][mt][hn][3] = dtot * v1.y;
      }
    }
  }
  for (int ks = 0; ks < qt; ++ks) {
    const int j0 = ks * 16;
    uint32_t af[MT][4], b4[NG][4];      // (x dt w)^T and B fragments
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      if (mine >> mt & 1)
        ldmatrix_x4_trans(af[mt], us + (j0 + brow) * LP + mt * 16 + bcol);
#pragma unroll
    for (int k = 0; k < NG; ++k) {
      const int n16 = n16_0 + k * n16_step;
      if (n16 < nk)
        ldmatrix_x4_trans(b4[k], bs + (j0 + lrow) * LN + n16 * 16 + lcol);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (!(mine >> mt & 1)) continue;
#pragma unroll
      for (int k = 0; k < NG; ++k) {
        if (n16_0 + k * n16_step >= nk) continue;
        mma_16816<false>(sacc[k][mt][0], af[mt], b4[k][0], b4[k][1]);
        mma_16816<false>(sacc[k][mt][1], af[mt], b4[k][2], b4[k][3]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < NG; ++k) {
    const int n16 = n16_0 + k * n16_step;
    if (n16 >= nk) continue;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (!(mine >> mt & 1)) continue;
#pragma unroll
      for (int hn = 0; hn < 2; ++hn) {
        float* r0 = sf + (mt * 16 + g8) * LF + n16 * 16 + hn * 8 + 2 * t4;
        *reinterpret_cast<float2*>(r0) =
            make_float2(sacc[k][mt][hn][0], sacc[k][mt][hn][1]);
        *reinterpret_cast<float2*>(r0 + 8 * LF) =
            make_float2(sacc[k][mt][hn][2], sacc[k][mt][hn][3]);
      }
    }
  }
}

template <int PS, int W>
__global__ void __launch_bounds__(32 * W, W == 8 ? 1 : 2)
ssd_scan_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ a_log, const bf16* __restrict__ Bm,
                   const bf16* __restrict__ Cm,
                   const float* __restrict__ d_skip,
                   const float* __restrict__ init, bf16* __restrict__ y,
                   float* __restrict__ fstate, int S, int H, int G, int N,
                   int Q) {
  constexpr int NSL = SSD_P / PS;          // slices of a head
  constexpr int PT = PS / 8;               // n8 tiles of y's columns
  constexpr int MT = PS / 16;              // m16 tiles of state rows
  constexpr int T = 32 * W;
  constexpr int SLOTS = SSD_MAX_Q / T;     // scan slots a thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Qp = (Q + 15) & ~15;
  const int LN = N + SSD_PAD, LP = PS + SSD_PAD;   // bf16 row strides
  const int LF = N + SSD_FPAD;                     // f32 state row stride
  float* sf = reinterpret_cast<float*>(smem_raw);  // [PS][LF] f32 state
  float* ls = sf + PS * LF;                        // [Qp] l, log2 units
  float* dts = ls + Qp;                            // [Qp] dt (0 past q)
  float* wfs = dts + Qp;                           // [Qp] dt 2^(l_last - l)
  float* ujs = wfs + Qp;                           // [Qp] dt 2^(l_e - l)
  float* wsum = ujs + Qp;                          // [16] warp totals
  bf16* cs = reinterpret_cast<bf16*>(wsum + 16);   // [Qp][LN]
  bf16* bs = cs + Qp * LN;                         // [Qp][LN]
  bf16* xs = bs + Qp * LN;                         // [Qp][LP] x
  bf16* us = xs + Qp * LP;                         // [Qp][LP] x dt w
  bf16* sb = us + Qp * LP;                         // [PS][LN] S_prev, bf16

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.x / NSL, p0 = (blockIdx.x % NSL) * PS;
  const int b = bh / H, h = bh % H;
  const int g = h / (H / G);
  const float a2 = -expf(a_log[h]) * LOG2E;       // log2 decay per dt
  const float dskip = d_skip[h];
  const int nk = N / 16;        // k16 steps over N, and 16-column groups
  const size_t st_off = ((size_t)bh * SSD_P + p0) * N;
  // this lane's ldmatrix row and column in a 16 x 16 block: (lrow, lcol)
  // for an A fragment from [m][k] or a B fragment pair from [k][n]
  // (.trans); (brow, bcol) for a B fragment pair from [n][k] or an A
  // fragment from [k][m] (.trans)
  const int lrow = lane & 15, lcol = (lane >> 4) * 8;
  const int brow = (lane & 7) + ((lane >> 4) << 3);
  const int bcol = ((lane >> 3) & 1) * 8;
  const int upr = N / 8;        // 16-byte units of a B / C row

  for (int c0 = 0; c0 < S; c0 += Q) {
    const bool first = c0 == 0;
    const bool has_state = !first || init != nullptr;
    const int q = min(Q, S - c0);
    const int qt = (q + 15) >> 4;                  // 16-row tiles

    // 1. this thread's dt (slots SLOTS tid + e, 0 past q) first, so
    //    their latency overlaps the copies, then in 16-byte units the
    //    state slice on the first chunk (the largest read, from device
    //    memory), C and B rows and this slice of x for the chunk's tiles
    //    (rows past q zero-filled)
    float d[SLOTS];
#pragma unroll
    for (int e = 0; e < SLOTS; ++e) {
      const int j = SLOTS * tid + e;
      d[e] = j < q ? dt[((size_t)b * S + c0 + j) * H + h] : 0.f;
    }
    if (first) {
      if (init != nullptr) {
        for (RowWalk w(tid, T, N / 4); w.r < PS; w.next())
          cp_async_16(sf + w.r * LF + w.u * 4,
                      init + st_off + (size_t)w.r * N + w.u * 4, true);
      } else {
        for (int i = tid; i < PS * LF; i += T) sf[i] = 0.f;
      }
    }
    const size_t bc0 = ((size_t)b * S + c0) * G + g;
    const bf16* c_rows = Cm + bc0 * N;
    const bf16* b_rows = Bm + bc0 * N;
    for (RowWalk w(tid, T, upr); w.r < qt * 16; w.next()) {
      const bool ok = w.r < q;
      const size_t off = (size_t)(ok ? w.r : 0) * G * N + w.u * 8;
      cp_async_16(cs + w.r * LN + w.u * 8, c_rows + off, ok);
      cp_async_16(bs + w.r * LN + w.u * 8, b_rows + off, ok);
    }
    const bf16* x_rows = x + (((size_t)b * S + c0) * H + h) * SSD_P + p0;
    for (int i = tid; i < qt * 16 * (PS / 8); i += T) {
      const int r = i / (PS / 8), u = i % (PS / 8);
      const bool ok = r < q;
      cp_async_16(xs + r * LP + u * 8,
                  x_rows + (size_t)(ok ? r : 0) * H * SSD_P + u * 8, ok);
    }
    cp_async_commit();

    // 2. l = cumsum(dt * a) in log2 units, then dt 2^(l_last - l) and
    //    dt 2^(l_e - l) (e: the last slot of l's 16-key tile)
    {
      float v[SLOTS];
      float run = 0.f;
#pragma unroll
      for (int e = 0; e < SLOTS; ++e) v[e] = run += d[e] * a2;
      float tot = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(FULL_MASK, tot, o);
        if (lane >= o) tot += u;
      }
      if (lane == 31) wsum[warp] = tot;
      __syncthreads();
      float excl = tot - run;
      for (int w = 0; w < warp; ++w) excl += wsum[w];
#pragma unroll
      for (int e = 0; e < SLOTS; ++e) {
        const int j = SLOTS * tid + e;
        if (j < Qp) {
          ls[j] = excl + v[e];
          dts[j] = d[e];
        }
      }
      __syncthreads();
      const float l_end = ls[Qp - 1];
#pragma unroll
      for (int e = 0; e < SLOTS; ++e) {
        const int j = SLOTS * tid + e;
        if (j < Qp) {
          wfs[j] = d[e] * ex2(l_end - ls[j]);      // 0 past q (dt = 0)
          ujs[j] = d[e] * ex2(ls[j | 15] - ls[j]);
        }
      }
    }
    const float l_last = ls[Qp - 1];               // = l[q - 1]
    cp_async_wait<0>();
    __syncthreads();                               // copies, wfs, ujs
    // the state update's A operand, x dt w formed in f32 and rounded once
    // (rows past q: x and dt are 0), and S_prev's bf16 operand
    for (int i = tid; i < qt * 16 * (PS / 8); i += T) {
      const int r = i / (PS / 8), c = i % (PS / 8) * 8;
      const uint4 xv = *reinterpret_cast<const uint4*>(xs + r * LP + c);
      const uint32_t* xw = reinterpret_cast<const uint32_t*>(&xv);
      const float wr = wfs[r];
      uint4 uv;
      uint32_t* uw = reinterpret_cast<uint32_t*>(&uv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&xw[e]));
        uw[e] = pack_bf16(f.x * wr, f.y * wr);
      }
      *reinterpret_cast<uint4*>(us + r * LP + c) = uv;
    }
    if (has_state) {
      for (RowWalk w(tid, T, N / 4); w.r < PS; w.next()) {
        const float4 v =
            *reinterpret_cast<const float4*>(sf + w.r * LF + w.u * 4);
        uint2 packed;
        packed.x = pack_bf16(v.x, v.y);
        packed.y = pack_bf16(v.z, v.w);
        *reinterpret_cast<uint2*>(sb + w.r * LN + w.u * 4) = packed;
      }
    }
    __syncthreads();

    // 3. y, one 16-row query tile at a time; warp w takes tiles w and
    //    2W - 1 - w of every 2W, so the lower triangle's work is balanced
    for (int k = 0; k < 2 * ((qt + 2 * W - 1) / (2 * W)); ++k) {
      const int it = 2 * W * (k >> 1) + ((k & 1) ? 2 * W - 1 - warp : warp);
      if (it >= qt) continue;
      const int i0 = it * 16;
      const int ia = i0 + g8, ib = ia + 8;          // this lane's rows
      uint32_t cf[SSD_MAX_KS][4];                   // C_i, A fragments
#pragma unroll
      for (int ks = 0; ks < SSD_MAX_KS; ++ks)
        if (ks < nk)
          ldmatrix_x4(cf[ks], cs + (i0 + lrow) * LN + ks * 16 + lcol);
      float acc[PT][4];
#pragma unroll
      for (int t = 0; t < PT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
      const float la = ls[ia], lb = ls[ib];
      if (has_state) {                              // 2^l_i (C_i . S_prev^T)
#pragma unroll
        for (int ks = 0; ks < SSD_MAX_KS; ++ks) {
          if (ks < nk) {
            uint32_t s4[PS / 16][4];
#pragma unroll
            for (int np = 0; np < PS / 16; ++np)
              ldmatrix_x4(s4[np], sb + (np * 16 + brow) * LN + ks * 16 + bcol);
#pragma unroll
            for (int np = 0; np < PS / 16; ++np) {
              mma_16816<false>(acc[2 * np], cf[ks], s4[np][0], s4[np][1]);
              mma_16816<false>(acc[2 * np + 1], cf[ks], s4[np][2], s4[np][3]);
            }
          }
        }
        const float ea = ex2(la), eb = ex2(lb);
#pragma unroll
        for (int t = 0; t < PT; ++t) {
          acc[t][0] *= ea;
          acc[t][1] *= ea;
          acc[t][2] *= eb;
          acc[t][3] *= eb;
        }
      }
      // key tiles below the diagonal two at a time, then the diagonal
      int jt = 0;
      for (; jt + 2 <= it; jt += 2)
        intra_keys<2, PS, false>(acc, cf, nk, bs, xs, ls, dts, ujs, LN, LP,
                                 jt * 16, ia, ib, la, lb, lane);
      if (jt < it)
        intra_keys<1, PS, false>(acc, cf, nk, bs, xs, ls, dts, ujs, LN, LP,
                                 jt * 16, ia, ib, la, lb, lane);
      intra_keys<1, PS, true>(acc, cf, nk, bs, xs, ls, dts, ujs, LN, LP, i0,
                              ia, ib, la, lb, lane);
      // y = acc + D x, as packed bf16 pairs
#pragma unroll
      for (int t = 0; t < PT; ++t) {
        const int p = t * 8 + 2 * t4;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = half ? ib : ia;
          if (i < q) {
            const float2 xv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(xs + i * LP + p));
            *reinterpret_cast<uint32_t*>(
                y + (((size_t)b * S + c0 + i) * H + h) * SSD_P + p0 + p) =
                pack_bf16(acc[t][2 * half] + dskip * xv.x,
                          acc[t][2 * half + 1] + dskip * xv.y);
          }
        }
      }
    }

    // 4. S_new = 2^l_last S_prev + (x dt w)^T . B.  With 8 warps and at
    //    most 4 query tiles, warps 4-7 had no tile: they take the whole
    //    update while warps 0-3 finish theirs; otherwise all warps share it.
    if (W == 8 && qt <= W / 2) {
      if (warp >= W / 2)
        state_update<MT, W / 2, PS>(warp - W / 2, lane, sf, us, bs, LF,
                                    LN, LP, nk, qt, ex2(l_last));
    } else {
      state_update<MT, W, PS>(warp, lane, sf, us, bs, LF, LN, LP, nk,
                              qt, ex2(l_last));
    }
    __syncthreads();   // the chunk's buffers and state are consumed
  }

  for (RowWalk w(tid, T, N / 4); w.r < PS; w.next())
    *reinterpret_cast<float4*>(fstate + st_off + (size_t)w.r * N + w.u * 4) =
        *reinterpret_cast<const float4*>(sf + w.r * LF + w.u * 4);
}

template <int PS, int W>
cudaError_t launch_tc(const void* x, const void* dt, const void* a_log,
                      const void* Bm, const void* Cm, const void* d_skip,
                      const void* init, void* y, void* fstate, int batch,
                      int S, int H, int G, int N, int Q, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_tc_kernel<PS, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SSD_MAX_SMEM);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const size_t smem = ssd_tc_smem_bytes((Q + 15) & ~15, N, PS);
  if (smem > SSD_MAX_SMEM) return cudaErrorInvalidValue;   // plan a slice
  ssd_scan_tc_kernel<PS, W><<<batch * H * (SSD_P / PS), 32 * W, smem,
                              stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a_log), static_cast<const bf16*>(Bm),
      static_cast<const bf16*>(Cm), static_cast<const float*>(d_skip),
      static_cast<const float*>(init), static_cast<bf16*>(y),
      static_cast<float*>(fstate), S, H, G, N, Q);
  return cudaGetLastError();
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
// p_slice and warps, the host's plan: for bf16 (64, 8), (32, 8) or
// (64, 4), the state rows a CTA owns and its warps; for f32 (64, 8), whole
// heads, the CUDA-core body's 256 threads.
extern "C" int repro_ssd_scan(const void* x, const void* dt,
                              const void* a_log, const void* Bm,
                              const void* Cm, const void* d_skip,
                              const void* init, void* y, void* fstate,
                              int batch, int S, int H, int G, int N, int P,
                              int chunk, int dtype, int p_slice, int warps,
                              void* stream) {
  using namespace repro;
  if (batch <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 ||
      P != SSD_P || N <= 0 || N % 16 != 0 || N > SSD_MAX_N || chunk <= 0 ||
      chunk > SSD_MAX_Q || (long long)batch * H * 2 > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto args = [&](auto launcher) {
    return launcher(x, dt, a_log, Bm, Cm, d_skip, init, y, fstate, batch, S,
                    H, G, N, chunk, s);
  };
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == F32 && p_slice == SSD_P && warps == SSD_THREADS / 32)
    err = args(launch<float>);
  else if (dtype == BF16 && p_slice == 64 && warps == 8)
    err = args(launch_tc<64, 8>);
  else if (dtype == BF16 && p_slice == 32 && warps == 8)
    err = args(launch_tc<32, 8>);
  else if (dtype == BF16 && p_slice == 64 && warps == 4)
    err = args(launch_tc<64, 4>);
  return static_cast<int>(err);
}

// The shared bytes one CTA of the bf16 body takes at (chunk, N, p_slice),
// and (chunk 0) the most a CTA may take.
extern "C" long long repro_ssd_tc_smem(int chunk, int N, int p_slice) {
  using namespace repro;
  if (chunk == 0) return (long long)SSD_MAX_SMEM;
  return (long long)ssd_tc_smem_bytes((chunk + 15) & ~15, N, p_slice);
}
