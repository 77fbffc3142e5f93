// Shared pieces of the Hopper kernels (sm_90a): element conversion,
// 4/8/16-byte vector loads, warp reductions, the cp.async, ldmatrix
// and mma.sync (m16n8k16) helpers of the decode and SSD kernels, the
// CUDA-core row-tile online-softmax step of the two prefill kernels'
// float32 instantiations, and the tensor-core (wgmma + TMA) tile of
// their bf16 instantiations.
//
// Every attention kernel accumulates in float32 with the finite NEG_INF
// = -1e30 and the max(l, 1e-30) guard of the JAX package's kernels, so
// padded rows (decode rows of length 1 over block 0, chunk rows with
// table -1) produce finite output, as the reference does.
#pragma once

#include <cuda.h>
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
// Row tile for the prefill kernels' float32 path: TQ query rows against
// key tiles of BK = one pool head-block, 128 threads.  Thread (r = tid /
// 4, tx = tid % 4) owns query row r, the keys tx + 4k (k < 4) of each
// tile, and the output dims tx*4 + 16*kk + j.  Rows are padded by 4
// floats so the float4 reads of a quarter warp fall on distinct banks.
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

// Copy `rows` rows of HD floats into a tile; row_ptr(i) gives row i's
// address in device memory or nullptr for a zero row.
template <int HD, typename RowPtr>
__device__ __forceinline__ void load_tile(float (*dst)[HD + 4], int rows,
                                          RowPtr row_ptr) {
  constexpr int CPR = HD / 4;  // float4 chunks per row
  for (int i = threadIdx.x; i < rows * CPR; i += TILE_THREADS) {
    const int r = i / CPR, c = (i % CPR) * 4;
    const float* row = row_ptr(r);
    *reinterpret_cast<float4*>(&dst[r][c]) =
        row != nullptr ? *reinterpret_cast<const float4*>(row + c)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
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

template <int HD>
__device__ __forceinline__ void store_row(float* out_row, int tx, float l,
                                          const float (&acc)[HD / 16][4]) {
  const float den = fmaxf(l, 1e-30f);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    *reinterpret_cast<float4*>(out_row + tx * 4 + 16 * kk) =
        make_float4(acc[kk][0] / den, acc[kk][1] / den, acc[kk][2] / den,
                    acc[kk][3] / den);
}

// ---------------------------------------------------------------------------
// Tensor-core tile for the bf16 prefill kernels (flash_prefill.cu,
// paged_prefill.cu).  One warpgroup (128 consumer threads) holds a
// 64-row query tile and walks 64-token key/value tiles with an online
// softmax; a producer warp keeps the next tiles' K and V in flight with
// TMA (a three-stage ring each) while the products of the current one
// run, and the walk is software-pipelined so the softmax of tile j
// overlaps the tensor cores' P V of tile j-1:
//
//   S = Q K^T   wgmma m64n64k16, A = Q and B = K from shared memory,
//               both K-major in the 128-byte-swizzled layout (one
//               64-column swizzle atom of 8 KB per 64 head dims);
//   O += P V    wgmma m64n{HD}k16, A = P (bf16) from registers, B = V
//               from shared memory, token-major, read through the
//               descriptor's transpose.
//
// S and O stay in f32 registers.  The only difference between the two
// kernels is an addressing policy `Addr` (which query rows the tile
// holds and their absolute positions, which key rows each tile reads,
// the mask); see FlashAddr and PagedAddr.  The float32 kernels keep
// the CUDA-core `tile_step` above: TF32 tensor cores keep about three
// digits, short of the 1e-4 the f32 path is held to, and the serving
// path on the card is bf16.
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

constexpr int TC_ROWS = 64;          // query rows of a tile (wgmma M)
constexpr int TC_KEYS = 64;          // keys of a K/V tile
constexpr int TC_STAGES = 3;         // K/V ring depth
constexpr int TC_CONSUMERS = 128;    // one warpgroup
constexpr int TC_THREADS = TC_CONSUMERS + 32;   // + the producer warp
constexpr int ATOM = 64;             // bf16 columns of a 128-byte atom
constexpr int ATOM_BYTES = TC_KEYS * ATOM * 2;  // 64 rows x 128 bytes

template <int HD> struct TcSmem {
  bf16 q[HD / ATOM][TC_ROWS * ATOM];
  bf16 k[TC_STAGES][HD / ATOM][TC_KEYS * ATOM];
  bf16 v[TC_STAGES][HD / ATOM][TC_KEYS * ATOM];
  uint64_t full_k[TC_STAGES], full_v[TC_STAGES];
  uint64_t empty_k[TC_STAGES], empty_v[TC_STAGES];
};
// 114,784 bytes at hd 128: two CTAs an SM (228 KB, 1 KB reserved each)
template <int HD> constexpr int tc_smem_bytes() {
  return static_cast<int>(sizeof(TcSmem<HD>));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// mbarrier (shared::cta) -----------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}
// Waits for the phase of `parity` to complete.  A wait that has not
// completed after 2^24 polls (far past any copy's latency) traps: a
// broken protocol then fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P1;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (done) return;
    if (polls == (1u << 24)) __trap();
  }
}

// TMA loads into 128-byte-swizzled shared memory ------------------------
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1) : "memory");
}
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// 16 bytes global -> shared, asynchronous; zero-filled when !valid (src
// is then not read, but must be a mapped address)
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// cp.async groups, ldmatrix and mma.sync (m16n8k16) -------------------
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a b, m16n8k16, bf16 (F16 false) or f16 in, f32 accumulate
template <bool F16>
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  if constexpr (F16)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// wgmma -----------------------------------------------------------------
// Shared-memory matrix descriptor, 128-byte swizzle.  K-major operands
// (Q, K): rows of 128 bytes, 8-row groups 1024 bytes apart (SBO), the
// leading offset unused.  The token-major V: 8-token groups 1024 bytes
// apart (SBO), 64-column atoms ATOM_BYTES apart (LBO).
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keeps the compiler from touching accumulators across the async window
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64x64] (+)= A[64x16] B[64x16]^T, both K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d[64xN] += A[64x16] (bf16 registers) B[16xN] (token-major, transposed)
template <int N> struct WgmmaRs;
template <> struct WgmmaRs<64> {
  static __device__ __forceinline__ void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  }
};
template <> struct WgmmaRs<128> {
  static __device__ __forceinline__ void run(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// Per-thread softmax state of the two rows a thread holds, in log2
// units (scores times scale * log2(e)); l is this lane's partial sum,
// the quad is summed once at the end.
struct RowState {
  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;
};

__device__ __forceinline__ float ex2(float x) {   // 2^x, flushing to 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Accumulator layout (wgmma m64nN, f32): thread (warp w, lane l) holds
// d[4i + j] = row 16w + l/4 + 8*(j/2), column 8i + 2*(l%4) + j%2, so rows
// ra and rb = ra + 8 of the tile, and the four lanes of a quad share
// each row.  Scores s of key tile `it` become probabilities p (bf16, as
// the register A fragment of P V: the accumulator of keys 16kk..+15 is
// exactly the m64k16 A fragment of those keys); returns the factors
// the rows' earlier output must be scaled by.  The scale is folded into
// the exponent's FFMA: max is taken over the raw scores (scale > 0).
//
// In a tile that crosses a mask edge the product is rounded on its own
// (__fmul_rn, never contracted), as the row's max was: a masked score
// then gives exactly 2^0 while its row has seen no valid key (the max is
// fl(NEG_INF * scale_log2) itself) and 2^-huge = 0 after, as the
// CUDA-core tile's expf(NEG_INF - NEG_INF) does.  Inside an FFMA the
// exponent would be that rounding's error instead, up to +-2^71, and
// ex2 of it +inf (hd 64's scale rounds that way).
template <bool EXACT>
__device__ __forceinline__ float exp_score(float s, float scale_log2,
                                           float mn) {
  return EXACT ? ex2(__fmul_rn(s, scale_log2) - mn)
               : ex2(fmaf(s, scale_log2, -mn));
}

template <bool MASKED>
__device__ __forceinline__ void exp_tile(float (&s)[32], float scale_log2,
                                         float mn_a, float mn_b,
                                         float& sum_a, float& sum_b) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    s[4 * i] = exp_score<MASKED>(s[4 * i], scale_log2, mn_a);
    s[4 * i + 1] = exp_score<MASKED>(s[4 * i + 1], scale_log2, mn_a);
    s[4 * i + 2] = exp_score<MASKED>(s[4 * i + 2], scale_log2, mn_b);
    s[4 * i + 3] = exp_score<MASKED>(s[4 * i + 3], scale_log2, mn_b);
    sum_a += s[4 * i] + s[4 * i + 1];
    sum_b += s[4 * i + 2] + s[4 * i + 3];
  }
}

template <class Addr>
__device__ __forceinline__ float2 online_softmax(float (&s)[32],
                                                 uint32_t (&p)[4][4],
                                                 RowState& rs, const Addr& ad,
                                                 int it, int pos_a, int pos_b,
                                                 int cq, float scale_log2) {
  const bool masked = ad.tile_masked(it);
  if (masked) {   // mask only where the tile crosses an edge
    const int t0 = ad.key0(it);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!ad.keep(t0 + 8 * i + cq + (j & 1), j < 2 ? pos_a : pos_b))
          s[4 * i + j] = NEG_INF;
      }
    }
  }
  float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    mx_a = fmaxf(mx_a, fmaxf(s[4 * i], s[4 * i + 1]));
    mx_b = fmaxf(mx_b, fmaxf(s[4 * i + 2], s[4 * i + 3]));
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    mx_a = fmaxf(mx_a, __shfl_xor_sync(FULL_MASK, mx_a, o));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(FULL_MASK, mx_b, o));
  }
  const float mn_a = fmaxf(rs.m_a, __fmul_rn(mx_a, scale_log2));
  const float mn_b = fmaxf(rs.m_b, __fmul_rn(mx_b, scale_log2));
  const float2 corr = make_float2(ex2(rs.m_a - mn_a), ex2(rs.m_b - mn_b));
  rs.m_a = mn_a;
  rs.m_b = mn_b;
  float sum_a = 0.f, sum_b = 0.f;
  if (masked)
    exp_tile<true>(s, scale_log2, mn_a, mn_b, sum_a, sum_b);
  else
    exp_tile<false>(s, scale_log2, mn_a, mn_b, sum_a, sum_b);
  rs.l_a = rs.l_a * corr.x + sum_a;
  rs.l_b = rs.l_b * corr.y + sum_b;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    p[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
  return corr;
}

template <int HD>
__device__ __forceinline__ void issue_qk(float (&s)[32], TcSmem<HD>& sm,
                                         int st) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int a = kk / 4, off = (kk % 4) * 16;
    wgmma_ss_n64(s, sw128_desc(sm.q[a] + off, 16, 1024),
                 sw128_desc(sm.k[st][a] + off, 16, 1024), kk > 0);
  }
}

template <int HD>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2],
                                         const uint32_t (&p)[4][4],
                                         TcSmem<HD>& sm, int st) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    WgmmaRs<HD>::run(o, p[kk],
                     sw128_desc(sm.v[st][0] + kk * 16 * ATOM, ATOM_BYTES,
                                1024));
}

// One warpgroup's walk, software-pipelined across tiles: while the
// softmax of tile j runs on the CUDA cores, the tensor cores run
// O += P(j-1) V(j-1).  K and V stages are released separately (K after
// its S product, V after its P V product), so the producer refills K
// a tile ahead of V.
template <int HD, class Addr>
__device__ __forceinline__ void tc_consume(TcSmem<HD>& sm, const Addr& ad,
                                           int n_tiles, float scale_log2) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ra = warp * 16 + lane / 4, rb = ra + 8;
  const int cq = (lane % 4) * 2;

  // Q tile -> shared memory: every 16-byte chunk in flight at once
  // (cp.async), each at its swizzled place; rows past the operand are
  // zero-filled
  constexpr int CPR = HD / 8;
  const bf16* row0 = ad.q_row(0);   // a tile's first row always exists
#pragma unroll
  for (int i = tid; i < TC_ROWS * CPR; i += TC_CONSUMERS) {
    const int r = i / CPR, c = i % CPR;
    const bf16* src = ad.q_row(r);
    char* atom = reinterpret_cast<char*>(sm.q[c / 8]);
    cp_async_16(atom + r * 128 + (((c % 8) ^ (r % 8)) * 16),
                src != nullptr ? src + c * 8 : row0, src != nullptr);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync 1, %0;\n" :: "n"(TC_CONSUMERS) : "memory");

  const int pos_a = ad.q_pos(ra), pos_b = ad.q_pos(rb);
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  RowState rs;
  float s[32];
  uint32_t p[4][4];

  // tile 0: S, softmax (O is still zero: nothing to rescale)
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  mbar_wait(&sm.full_k[0], 0);
  wgmma_fence();
  issue_qk<HD>(s, sm, 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  mbar_arrive(&sm.empty_k[0]);
  online_softmax(s, p, rs, ad, 0, pos_a, pos_b, cq, scale_log2);

  for (int it = 1; it < n_tiles; ++it) {
    const int st = it % TC_STAGES, pst = (it - 1) % TC_STAGES;
    const uint32_t phase = (it / TC_STAGES) & 1;
    const uint32_t pphase = ((it - 1) / TC_STAGES) & 1;
    mbar_wait(&sm.full_k[st], phase);
    mbar_wait(&sm.full_v[pst], pphase);
    wgmma_fence();
    issue_qk<HD>(s, sm, st);          // S(it) = Q K(it)^T
    wgmma_commit();
    issue_pv<HD>(o, p, sm, pst);      // O += P(it-1) V(it-1)
    wgmma_commit();
    wgmma_wait<1>();                  // S(it) has landed
    fence_regs(s);
    mbar_arrive(&sm.empty_k[st]);
    uint32_t pn[4][4];
    const float2 corr =
        online_softmax(s, pn, rs, ad, it, pos_a, pos_b, cq, scale_log2);
    wgmma_wait<0>();                  // P(it-1) V(it-1) has landed
    fence_regs(o);
    fence_regs(p);
    mbar_arrive(&sm.empty_v[pst]);
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      o[4 * i] *= corr.x;
      o[4 * i + 1] *= corr.x;
      o[4 * i + 2] *= corr.y;
      o[4 * i + 3] *= corr.y;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) p[kk][j] = pn[kk][j];
  }
  {
    const int lst = (n_tiles - 1) % TC_STAGES;
    mbar_wait(&sm.full_v[lst], ((n_tiles - 1) / TC_STAGES) & 1);
    wgmma_fence();
    issue_pv<HD>(o, p, sm, lst);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(p);
    mbar_arrive(&sm.empty_v[lst]);   // every tile's stages released once
  }

#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    rs.l_a += __shfl_xor_sync(FULL_MASK, rs.l_a, o_);
    rs.l_b += __shfl_xor_sync(FULL_MASK, rs.l_b, o_);
  }
  const float inv_a = 1.f / fmaxf(rs.l_a, 1e-30f);
  const float inv_b = 1.f / fmaxf(rs.l_b, 1e-30f);
  if constexpr (HD == 128) {
    // O in bf16 -> the Q tile's shared memory (swizzled as Q: the
    // quad's 4-byte pieces of 8 rows fall on 32 banks), then 16-byte
    // row chunks to device memory: whole sectors, not 4-byte pieces of
    // 8 rows.  9 % faster at hd 128, 8 % slower at hd 64 (PERF.md).
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, %0;\n" :: "n"(TC_CONSUMERS) : "memory");
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      char* at = reinterpret_cast<char*>(sm.q[i / 8]) +
                 (((i % 8) ^ (ra % 8)) * 16) + cq * 2;   // rb % 8 == ra % 8
      *reinterpret_cast<uint32_t*>(at + ra * 128) =
          pack_bf16(o[4 * i] * inv_a, o[4 * i + 1] * inv_a);
      *reinterpret_cast<uint32_t*>(at + rb * 128) =
          pack_bf16(o[4 * i + 2] * inv_b, o[4 * i + 3] * inv_b);
    }
    asm volatile("bar.sync 1, %0;\n" :: "n"(TC_CONSUMERS) : "memory");
#pragma unroll
    for (int i = tid; i < TC_ROWS * CPR; i += TC_CONSUMERS) {
      const int r = i / CPR, c = i % CPR;
      bf16* dst = ad.out_row(r);
      if (dst != nullptr)
        *reinterpret_cast<uint4*>(dst + c * 8) =
            *reinterpret_cast<const uint4*>(
                reinterpret_cast<const char*>(sm.q[c / 8]) + r * 128 +
                (((c % 8) ^ (r % 8)) * 16));
    }
  } else {
    bf16* out_a = ad.out_row(ra);
    bf16* out_b = ad.out_row(rb);
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      if (out_a != nullptr)
        *reinterpret_cast<uint32_t*>(out_a + 8 * i + cq) =
            pack_bf16(o[4 * i] * inv_a, o[4 * i + 1] * inv_a);
      if (out_b != nullptr)
        *reinterpret_cast<uint32_t*>(out_b + 8 * i + cq) =
            pack_bf16(o[4 * i + 2] * inv_b, o[4 * i + 3] * inv_b);
    }
  }
}

// The kernel: barriers, then the producer warp's copies and the
// consumer warpgroup's walk.  `Addr` is built from the parameters and
// blockIdx in every thread.  The producer keeps K one tile ahead of V:
// K(it+1) is issued before V(it), since the consumers need S(it+1)
// before they need V(it).
template <int HD, class Addr>
__global__ void __launch_bounds__(TC_THREADS, 2)
tc_attention_kernel(const __grid_constant__ typename Addr::Params p) {
  // the swizzle period: the Q tile's chunk placement and the wgmma
  // descriptors assume every atom starts 1024-aligned
  extern __shared__ __align__(1024) uint8_t tc_smem_raw[];
  TcSmem<HD>& sm = *reinterpret_cast<TcSmem<HD>*>(tc_smem_raw);
  const Addr ad(p);
  const int n_tiles = ad.n_tiles();
  if (threadIdx.x == 0) {
    if (smem_u32(tc_smem_raw) % 1024 != 0) __trap();
#pragma unroll
    for (int i = 0; i < TC_STAGES; ++i) {
      mbar_init(&sm.full_k[i], 1);
      mbar_init(&sm.full_v[i], 1);
      mbar_init(&sm.empty_k[i], TC_CONSUMERS);
      mbar_init(&sm.empty_v[i], TC_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= TC_CONSUMERS) {
    if (threadIdx.x == TC_CONSUMERS) {
      auto load = [&](const CUtensorMap* map,
                      bf16 (*ring)[HD / ATOM][TC_KEYS * ATOM], uint64_t* full,
                      uint64_t* empty, int it) {
        const int st = it % TC_STAGES;
        if (it >= TC_STAGES)   // the consumers released this stage
          mbar_wait(&empty[st], ((it / TC_STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[st], HD * TC_KEYS * 2);
        ad.load_tile(map, it, ring[st], &full[st]);
      };
      load(&p.k_map, sm.k, sm.full_k, sm.empty_k, 0);
      for (int it = 0; it < n_tiles; ++it) {
        if (it + 1 < n_tiles)
          load(&p.k_map, sm.k, sm.full_k, sm.empty_k, it + 1);
        load(&p.v_map, sm.v, sm.full_v, sm.empty_v, it);
      }
    }
    return;
  }
  tc_consume<HD>(sm, ad, n_tiles, p.scale_log2);
}

// Host side: the TMA encoder `cuTensorMapEncodeTiled`, looked up once
// through the runtime's entry-point query (so the libraries need no
// -lcuda), and the launch.
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

inline EncodeTiledFn tensor_map_encoder() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A bf16 tensor map with 128-byte swizzle; dims and box innermost
// first, strides in bytes for dims 1..rank-1.  Out-of-range box rows
// read as zeros.
inline cudaError_t encode_bf16_map(CUtensorMap* map, const void* base,
                                   int rank, const cuuint64_t* dims,
                                   const cuuint64_t* strides,
                                   const cuuint32_t* box) {
  const EncodeTiledFn enc = tensor_map_encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                         const_cast<void*>(base), dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The dynamic shared-memory opt-in is made once per instantiation, as
// ssd_scan.cu does; every launch after it is the launch alone.
template <int HD, class Addr>
cudaError_t launch_tc(dim3 grid, const typename Addr::Params& p,
                      cudaStream_t stream) {
  constexpr int smem = tc_smem_bytes<HD>();
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        tc_attention_kernel<HD, Addr>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  tc_attention_kernel<HD, Addr><<<grid, TC_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace repro

// Every library exports its launch functions plus this readable error.
#define REPRO_EXPORT_ERROR_STRING                               \
  extern "C" const char* repro_error_string(int err) {          \
    return cudaGetErrorString(static_cast<cudaError_t>(err));   \
  }
