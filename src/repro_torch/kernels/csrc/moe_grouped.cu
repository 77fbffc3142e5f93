// Grouped-expert SwiGLU of the dropless MoE FFN, for Hopper (kernel 6).
//
// Replaces no TPU kernel.  The JAX package computes the dropless FFN's
// expert products with XLA einsums over each token's gathered expert
// weights (src/repro/models/moe.py:70-75, `moe_ffn_dropless`): a
// [T, k, d, f_e] copy, 37.7 MB per (token, slot) for qwen3-moe in bf16.
// The port's serving steps run as CUDA graphs, so the FFN needs a
// product whose launch is fixed by shapes and which reads the routing
// from device memory.  For one MoE layer:
//   x [T, d]; order [T*k] int32, the (token, slot) pairs sorted by expert
//   (stable; slot s = token * k + j); offsets [E+1] int32, expert e's
//   sorted rows are [offsets[e], offsets[e+1]); w_gate, w_up [E, d, f];
//   w_down [E, f, d]
//   gate/up launch: act[i] = silu(x[order[i] / k] @ w_gate[e])
//                            * (x[order[i] / k] @ w_up[e])   (sorted rows)
//   down launch:    y[order[i]] = act[i] @ w_down[e]          (slot order)
// The tokens are gathered inside the gate/up launch (no [T*k, d] copy).
// Every element of act and y is written once, by one CTA, with no
// atomics and no split over the depth: a replay of a captured step
// equals the eager call bit for bit.  The gate-weighted sum over the k
// slots stays in PyTorch, as the reference does it.
//
// Grid, fixed by shapes only: the M tiles any routing of the n = T*k
// slots can take, sum_e ceil(n_e / BM) <= (n + min(E, n) * (BM - 1)) / BM
// (`mg_m_tiles`), times the BN-column N tiles of the output (bf16: one
// CTA each, an M tile's N tiles adjacent; float32: x and y).  A CTA
// finds its (expert, M tile) from `offsets`: thread e reads expert e's
// two offsets, counts its tiles, and a block scan orders them; a CTA
// with no tile exits.  `offsets` is never read on the host.
//
// What bounds it: bytes, the active experts' 3 * d * f weights, at every
// served shape (decode ~94 MB a granite-moe layer, ~1.1 GB qwen3-moe; a
// 4 x 512 qwen3-moe prefill 4.98 GB against 0.62 TFLOP, 1.49 ms against
// 0.63 ms on the H100).  So each expert's weights should cross from
// memory once, whatever its row count, with enough bytes in flight to
// fill the card, and the gathered rows must not hold the stream back.
// The bf16 design:
//   * M tiles of 64 rows (one consumer warpgroup) or 128 (two), on wgmma
//     m64nBNk16 with f32 accumulators, so an expert's weight strip is
//     read once per 64 or 128 rows (16-row mma.sync tiles re-read it per
//     16, 8x at ~128 rows an expert); the tile plan (BM, the gate/up and
//     down BN of 64 or 128) is chosen from (n, E, d, f) alone
//     (`mg_plan`): 128-row tiles where a non-empty expert averages more
//     than 48 rows, 128-column tiles where that still leaves two waves
//     of CTAs on the H100's 132 SMs;
//   * a four-stage ring (full / empty mbarriers) of 64-deep K stages: the
//     weight tiles by TMA through a 3-D map over [E, K, N], so a tile's
//     ragged K and N edges are zero-filled per expert, into
//     128-byte-swizzled 64 x 64 atoms read through the descriptor's
//     transpose (N-major B, as V in the prefill kernels' P V); the down
//     launch's A rows (act, sorted rows contiguous) by TMA through a 2-D
//     map; the gate/up launch's, gathered token rows, by 16-byte cp.async
//     into the same swizzle (chunk c of row r at c ^ (r % 8)), spread
//     over a producer warpgroup, each thread's chunks counted on the
//     stage's barrier as they land (cp.async.mbarrier.arrive.noinc) and
//     the consumers fencing the generic proxy after their wait.  On the
//     H100 one producer warp that waited for its chunks before it
//     signalled held the gate/up launch to ~2 us a stage, and one bulk
//     copy a row was slower still;
//   * an M tile's N tiles are neighbouring CTAs: they read the same A
//     rows, and together whole weight rows, at about the same time;
//   * the weights of a CTA's first stages go out before it reads the
//     routing's rows, and the down launch is a programmatic dependent of
//     the gate/up launch: its CTAs find their tiles and load their first
//     weight stages while the gate/up launch drains, and wait for its end
//     (griddepcontrol.wait) before their first act box.  A CUDA graph
//     captures the dependency as a programmatic edge;
//   * the gate/up launch runs both products on one A tile, and its
//     epilogue rounds silu(g) * u to bf16 once.
// float32 (the reduced parity runs): 16-row M tiles, 64 columns, a
// two-stage cp.async ring on CUDA cores; each thread owns one column and
// 8 rows.
#include "attn_common.cuh"

namespace repro {

// ---- the M-tile lookup, shared by both paths ------------------------------
constexpr int MG_MAX_E = 128;   // one expert a thread of the first 128

// M tiles any routing of n slots over E experts can take at BM rows
__host__ __device__ inline long long mg_m_tiles(long long n, int E, int bm) {
  const long long m = n < E ? n : E;
  return (n + m * (bm - 1)) / bm;
}

struct MgTile {
  int warp_tiles[MG_MAX_E / 32];
  int expert, row0, row_end;
};

// Which expert M tile `b` is (its expert and rows); false when the
// routing has no tile `b`.  Every thread of the block calls it (it syncs
// the block).
template <int BM>
__device__ __forceinline__ bool find_tile(const int* offsets, int E, int b,
                                          MgTile& t) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int lo = 0, hi = 0, c = 0, s = 0;
  if (tid < MG_MAX_E) {
    if (tid < E) {
      lo = offsets[tid];
      hi = offsets[tid + 1];
    }
    c = (hi - lo + BM - 1) / BM;
    s = c;                                      // inclusive scan in the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(FULL_MASK, s, o);
      if (lane >= o) s += v;
    }
    if (lane == 31) t.warp_tiles[warp] = s;
  }
  if (tid == 0) t.expert = -1;
  __syncthreads();
  if (tid < MG_MAX_E) {
    int start = s - c;
    for (int w = 0; w < warp; ++w) start += t.warp_tiles[w];
    if (b >= start && b < start + c) {
      t.expert = tid;
      t.row0 = lo + (b - start) * BM;
      t.row_end = hi;
    }
  }
  __syncthreads();
  return t.expert >= 0;
}

__device__ __forceinline__ float silu_mul(float g, float u) {
  return g / (1.f + expf(-g)) * u;
}

// float32's tile: 16 rows, 64 columns
constexpr int MG_BM = 16;
constexpr int MG_BN = 64;

// ---- bf16: wgmma tiles fed by TMA -------------------------------------------
constexpr int WG_BK = 64;                 // depth of a stage: one swizzle atom
constexpr int WG_STAGES = 4;              // ring depth
constexpr int WG_ATOM = 64 * 64;          // elements of a 64 x 64 atom, 8 KB
constexpr int WG_ATOM_BYTES = WG_ATOM * 2;
constexpr int WG_CTA_TARGET = 2 * 132;    // two waves of the H100's SMs

// The tile plan of a call: M-tile rows and the N tiles of both launches.
struct MgPlan {
  int bm, bn_gu, bn_dn;
};

__host__ __device__ inline long long mg_cdiv(long long a, long long b) {
  return (a + b - 1) / b;
}

// Chosen from the shapes alone.  float32 keeps its one tile.
inline MgPlan mg_plan(long long n, int E, int d, int f, int dtype) {
  if (dtype != BF16) return {MG_BM, MG_BN, MG_BN};
  const long long m = n < E ? n : E;                  // non-empty experts
  const int bm = n * 4 > m * 3 * 64 ? 128 : 64;       // > 48 rows an expert
  const long long tiles = m * mg_cdiv(mg_cdiv(n, m), bm);
  auto bn = [&](int N) {
    return N > 64 && tiles * mg_cdiv(N, 128) >= WG_CTA_TARGET ? 128 : 64;
  };
  return {bm, bn(f), bn(d)};
}

// d[64 x N] (+)= A[64 x 16] B[16 x N]: A K-major and B N-major (read
// through the descriptor's transpose), both in shared memory
template <int N> struct WgmmaSsT;
template <> struct WgmmaSsT<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(desc_a), "l"(desc_b), "r"(1));
  }
};
template <> struct WgmmaSsT<128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t desc_a,
                                             uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 1;\n}\n"
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
        : "l"(desc_a), "l"(desc_b), "r"(1));
  }
};

template <bool GATE_UP, int BM, int BN> struct WgSmem {
  static constexpr int NB = GATE_UP ? 2 : 1;   // weight matrices a stage
  static constexpr int NA = BN / 64;           // 64-column atoms a matrix
  static constexpr int CONSUMERS = BM / 64 * 128;
  // the producer: one warp issues the TMA copies; gate/up gathers its A
  // rows with a whole warpgroup
  static constexpr int PRODUCERS = GATE_UP ? 128 : 32;
  static constexpr int THREADS = CONSUMERS + PRODUCERS;
  static constexpr uint32_t A_BYTES = BM * WG_BK * 2;   // down: a TMA box
  static constexpr uint32_t B_BYTES = NB * NA * WG_ATOM_BYTES;
  bf16 a[WG_STAGES][BM * WG_BK];               // BM rows of 128 bytes
  bf16 b[WG_STAGES][NB][NA][WG_ATOM];          // [64 K rows][64 N] atoms
  uint64_t full[WG_STAGES], empty[WG_STAGES];
  int src[BM];      // gate/up: the row's token
  MgTile tile;
};

// gate/up: a = x (its rows gathered by cp.async), w0 / w1 = w_gate /
// w_up, out = act, K = d, N = f.  down: a_map over act [n, f], w0 =
// w_down, out = y, K = f, N = d.  The weight maps are 3-D over [E, K, N],
// box 64 x 64 x 1.
struct WgParams {
  CUtensorMap w0_map, w1_map, a_map;
  const bf16* a;
  const int* order;
  const int* offsets;
  bf16* out;
  int K, N, E, top_k;
};

template <bool GATE_UP, int BM, int BN>
__global__ void __launch_bounds__(WgSmem<GATE_UP, BM, BN>::THREADS, 1)
    moe_wgmma_kernel(const __grid_constant__ WgParams p) {
  using S = WgSmem<GATE_UP, BM, BN>;
  // the swizzle period: the gathered chunks' placement, TMA's swizzled
  // boxes and the wgmma descriptors assume every stage starts
  // 1024-aligned
  extern __shared__ __align__(1024) uint8_t mg_smem_raw[];
  S& sm = *reinterpret_cast<S*>(mg_smem_raw);
  const int tid = threadIdx.x;
  // gate/up: the down launch may start once every gate/up CTA is under
  // way (a programmatic dependent launch): it finds its tile and loads its
  // first weight stages, and waits for this grid's end before it reads act
  if constexpr (GATE_UP)
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  if (tid == 0) {
    if (smem_u32(mg_smem_raw) % 1024 != 0) __trap();
#pragma unroll
    for (int i = 0; i < WG_STAGES; ++i) {
      // the TMA's expect_tx arrival; gate/up also each producer
      // thread's, once its gathered chunks have landed
      mbar_init(&sm.full[i], GATE_UP ? 1 + S::PRODUCERS : 1);
      mbar_init(&sm.empty[i], S::CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // CTA b computes N tile b % n_tiles of M tile b / n_tiles: an M tile's
  // N tiles run side by side, reading the same A rows and neighbouring
  // columns of the expert's weight rows
  const int n_tiles = (p.N + BN - 1) / BN;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  if (!find_tile<BM>(p.offsets, p.E, blockIdx.x / n_tiles, sm.tile)) return;
  const int expert = sm.tile.expert, row0 = sm.tile.row0;
  const int row_end = sm.tile.row_end;
  const int KT = (p.K + WG_BK - 1) / WG_BK;
  const int first = KT < WG_STAGES ? KT : WG_STAGES;

  if (tid >= S::CONSUMERS) {   // the producer
    const int pt = tid - S::CONSUMERS;
    // the weight boxes (whole, zero-filled past K and N; down: and the
    // A box's bytes)
    auto load_b = [&](int kt) {
      const int st = kt % WG_STAGES;
      mbar_expect_tx(&sm.full[st],
                     S::B_BYTES + (GATE_UP ? 0u : S::A_BYTES));
#pragma unroll
      for (int m = 0; m < S::NB; ++m)
#pragma unroll
        for (int at = 0; at < S::NA; ++at)
          tma_load_3d(sm.b[st][m][at], m == 0 ? &p.w0_map : &p.w1_map,
                      &sm.full[st], n0 + at * 64, kt * WG_BK, expert);
    };
    auto load_a = [&](int kt) {   // down: act's rows, once gate/up ended
      tma_load_2d(sm.a[kt % WG_STAGES], &p.a_map, &sm.full[kt % WG_STAGES],
                  kt * WG_BK, row0);
    };
    // the first stages' weights need nothing from the routing but the
    // expert: in flight before the rows are read
    if (pt == 0)
      for (int kt = 0; kt < first; ++kt) load_b(kt);
    if constexpr (GATE_UP) {
      // the tile's rows of the expert alone: a row past them is computed
      // from whatever the stage holds and never stored (a product row
      // reads its own A row only)
      const int rows = row_end - row0 < BM ? row_end - row0 : BM;
      for (int r = pt; r < rows; r += S::PRODUCERS)
        sm.src[r] = p.order[row0 + r] / p.top_k;
      asm volatile("bar.sync 1, %0;\n" :: "n"(S::PRODUCERS) : "memory");
      for (int kt = 0; kt < KT; ++kt) {
        const int st = kt % WG_STAGES;
        if (kt >= WG_STAGES) {   // the consumers released this stage
          mbar_wait(&sm.empty[st], ((kt / WG_STAGES) & 1) ^ 1);
          if (pt == 0) load_b(kt);
        }
        // [k0, k0 + 64) of the rows: chunk c of row r at c ^ (r % 8);
        // chunks past K zero-filled
        char* at = reinterpret_cast<char*>(sm.a[st]);
        const int k0 = kt * WG_BK;
        for (int i = pt; i < rows * 8; i += S::PRODUCERS) {
          const int r = i / 8, c = i % 8;
          const int k = k0 + c * 8;
          const bool ok = k < p.K;
          cp_async_16(at + r * 128 + ((c ^ (r % 8)) * 16),
                      ok ? p.a + (size_t)sm.src[r] * p.K + k : p.a, ok);
        }
        // the stage's full barrier counts this thread once its chunks land
        asm volatile(
            "cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
            :: "r"(smem_u32(&sm.full[st])) : "memory");
      }
    } else if (pt == 0) {
      asm volatile("griddepcontrol.wait;\n" ::: "memory");
      for (int kt = 0; kt < first; ++kt) load_a(kt);
      for (int kt = WG_STAGES; kt < KT; ++kt) {
        mbar_wait(&sm.empty[kt % WG_STAGES], ((kt / WG_STAGES) & 1) ^ 1);
        load_b(kt);
        load_a(kt);
      }
    }
    return;
  }

  // consumer warpgroup g: rows [64 g, 64 g + 64) of the tile.  Thread
  // (warp w, lane l) holds acc[4 i + j] = row 16 w + l / 4 + 8 (j / 2),
  // column 8 i + 2 (l % 4) + j % 2 of its warpgroup's rows; gate/up
  // writes silu(g) * u at the sorted row, down the product at the slot's
  // row (read here, while the ring fills)
  const int g = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  int out_rows[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = row0 + g * 64 + warp * 16 + lane / 4 + 8 * h;
    out_rows[h] = i >= row_end ? -1 : GATE_UP ? i : p.order[i];
  }
  float acc[S::NB][BN / 2];
#pragma unroll
  for (int m = 0; m < S::NB; ++m)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[m][i] = 0.f;
  for (int kt = 0; kt < KT; ++kt) {
    const int st = kt % WG_STAGES;
    mbar_wait(&sm.full[st], (kt / WG_STAGES) & 1);
    // gate/up: the gathered chunks were written through the generic proxy
    if constexpr (GATE_UP)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk) {
      const uint64_t da = sw128_desc(sm.a[st] + g * 64 * WG_BK + kk * 16, 16,
                                     1024);
#pragma unroll
      for (int m = 0; m < S::NB; ++m)
        WgmmaSsT<BN>::run(acc[m], da,
                          sw128_desc(sm.b[st][m][0] + kk * 16 * 64,
                                     WG_ATOM_BYTES, 1024));
    }
    wgmma_commit();
    wgmma_wait<1>();   // the previous stage's products have landed
    if (kt > 0) mbar_arrive(&sm.empty[(kt - 1) % WG_STAGES]);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int m = 0; m < S::NB; ++m) fence_regs(acc[m]);
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const int n = n0 + 8 * i + 2 * (lane % 4);
    if (n >= p.N) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (out_rows[h] < 0) continue;
      float v0 = acc[0][4 * i + 2 * h], v1 = acc[0][4 * i + 2 * h + 1];
      if constexpr (GATE_UP) {
        v0 = silu_mul(v0, acc[S::NB - 1][4 * i + 2 * h]);
        v1 = silu_mul(v1, acc[S::NB - 1][4 * i + 2 * h + 1]);
      }
      *reinterpret_cast<__nv_bfloat162*>(p.out + (size_t)out_rows[h] * p.N +
                                         n) = __floats2bfloat162_rn(v0, v1);
    }
  }
}

// [E, K, N] bf16 weights as a 3-D map, box 64 (N) x 64 (K) x 1
inline cudaError_t encode_weight_map(CUtensorMap* map, const void* w, int E,
                                     int K, int N) {
  const cuuint64_t dims[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)E};
  const cuuint64_t strides[2] = {(cuuint64_t)N * 2, (cuuint64_t)K * N * 2};
  const cuuint32_t box[3] = {64, WG_BK, 1};
  return encode_bf16_map(map, w, 3, dims, strides, box);
}

// The down launch is a programmatic dependent of the gate/up launch
// before it on the stream (it waits for that grid's end before it reads
// act); a CUDA graph captures the dependency as a programmatic edge.
template <bool GATE_UP, int BM, int BN>
cudaError_t launch_wg(dim3 grid, const WgParams& p, cudaStream_t stream) {
  constexpr int smem = static_cast<int>(sizeof(WgSmem<GATE_UP, BM, BN>));
  static bool attr_set = false;   // the opt-in, once per instantiation
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        moe_wgmma_kernel<GATE_UP, BM, BN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(WgSmem<GATE_UP, BM, BN>::THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute dep[1];
  dep[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  dep[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = dep;
  cfg.numAttrs = GATE_UP ? 0 : 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, moe_wgmma_kernel<GATE_UP, BM, BN>, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <bool GATE_UP, int BM>
cudaError_t launch_wg_bn(int bn, dim3 grid, const WgParams& p,
                         cudaStream_t stream) {
  return bn == 128 ? launch_wg<GATE_UP, BM, 128>(grid, p, stream)
                   : launch_wg<GATE_UP, BM, 64>(grid, p, stream);
}

template <bool GATE_UP>
cudaError_t launch_wg_plan(int bm, int bn, dim3 grid, const WgParams& p,
                           cudaStream_t stream) {
  return bm == 128 ? launch_wg_bn<GATE_UP, 128>(bn, grid, p, stream)
                   : launch_wg_bn<GATE_UP, 64>(bn, grid, p, stream);
}

cudaError_t launch_bf16(const void* x, const void* order, const void* offsets,
                        const void* w_gate, const void* w_up,
                        const void* w_down, void* act, void* y, int n_tokens,
                        int top_k, int E, int d, int f, cudaStream_t stream) {
  const long long n = (long long)n_tokens * top_k;
  const MgPlan pl = mg_plan(n, E, d, f, BF16);
  const long long mt = mg_m_tiles(n, E, pl.bm);
  if (mt * mg_cdiv(f, pl.bn_gu) > 0x7fffffffLL ||
      mt * mg_cdiv(d, pl.bn_dn) > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  WgParams gu{};
  cudaError_t err = encode_weight_map(&gu.w0_map, w_gate, E, d, f);
  if (err == cudaSuccess) err = encode_weight_map(&gu.w1_map, w_up, E, d, f);
  if (err != cudaSuccess) return err;
  gu.a = static_cast<const bf16*>(x);
  gu.order = static_cast<const int*>(order);
  gu.offsets = static_cast<const int*>(offsets);
  gu.out = static_cast<bf16*>(act);
  gu.K = d, gu.N = f, gu.E = E, gu.top_k = top_k;
  err = launch_wg_plan<true>(pl.bm, pl.bn_gu,
                             dim3(mt * mg_cdiv(f, pl.bn_gu)), gu, stream);
  if (err != cudaSuccess) return err;
  WgParams dn{};
  err = encode_weight_map(&dn.w0_map, w_down, E, f, d);
  if (err != cudaSuccess) return err;
  {
    const cuuint64_t dims[2] = {(cuuint64_t)f, (cuuint64_t)n};
    const cuuint64_t strides[1] = {(cuuint64_t)f * 2};
    const cuuint32_t box[2] = {64, (cuuint32_t)pl.bm};
    err = encode_bf16_map(&dn.a_map, act, 2, dims, strides, box);
    if (err != cudaSuccess) return err;
  }
  dn.w1_map = dn.w0_map;
  dn.a = static_cast<const bf16*>(act);
  dn.order = static_cast<const int*>(order);
  dn.offsets = static_cast<const int*>(offsets);
  dn.out = static_cast<bf16*>(y);
  dn.K = f, dn.N = d, dn.E = E, dn.top_k = top_k;
  return launch_wg_plan<false>(pl.bm, pl.bn_dn,
                               dim3(mt * mg_cdiv(d, pl.bn_dn)), dn, stream);
}

// ---- float32: CUDA cores ----------------------------------------------------
constexpr int MG_BK = 32;         // depth of one ring stage
constexpr int MG_THREADS = 128;   // 4 warps
constexpr int MG_STAGES = 2;
constexpr int MG_CH = 4;          // floats a 16-byte copy
constexpr int MG_AS = MG_BK + MG_CH;   // padded A row
constexpr int MG_BS = MG_BN + MG_CH;   // padded B row

template <int NB> struct MgSmem {
  __align__(16) float a[MG_STAGES][MG_BM][MG_AS];
  __align__(16) float b[MG_STAGES][NB][MG_BK][MG_BS];
  int src[MG_BM];      // gate/up: the row's token; down: its sorted row
  int dst[MG_BM];      // gate/up: its sorted row; down: its slot (-1: none)
  MgTile tile;
};

// gate/up (NB 2): a = x, w0 = w_gate, w1 = w_up, out = act, K = d, N = f.
// down (NB 1): a = act, w0 = w_down, out = y, K = f, N = d.
struct MgArgs {
  const float* a;
  const float* w0;
  const float* w1;
  const int* order;
  const int* offsets;
  float* out;
  int K, N, E, top_k;
};

// One ring stage: A rows [BM][k0, k0 + BK) through `src`, the weight
// tiles [k0, k0 + BK) x [n0, n0 + BN); past K or N zero-filled.
template <int NB>
__device__ __forceinline__ void load_stage(const MgArgs& p, MgSmem<NB>& sm,
                                           int st, int k0, int n0,
                                           const float* w0, const float* w1) {
  constexpr int ACH = MG_BK / MG_CH, BCH = MG_BN / MG_CH;
  for (int c = threadIdx.x; c < MG_BM * ACH; c += MG_THREADS) {
    const int r = c / ACH, kc = (c % ACH) * MG_CH;
    const int row = sm.src[r], k = k0 + kc;
    const bool ok = row >= 0 && k < p.K;
    cp_async_16(&sm.a[st][r][kc], ok ? p.a + (size_t)row * p.K + k : p.a, ok);
  }
  for (int c = threadIdx.x; c < NB * MG_BK * BCH; c += MG_THREADS) {
    const int m = c / (MG_BK * BCH), rem = c % (MG_BK * BCH);
    const int kr = rem / BCH, nc = (rem % BCH) * MG_CH;
    const int k = k0 + kr, n = n0 + nc;
    const bool ok = k < p.K && n < p.N;
    const float* w = m == 0 ? w0 : w1;
    cp_async_16(&sm.b[st][m][kr][nc], ok ? w + (size_t)k * p.N + n : w, ok);
  }
}

template <bool GATE_UP>
__global__ void __launch_bounds__(MG_THREADS)
    moe_f32_kernel(const MgArgs p) {
  constexpr int NB = GATE_UP ? 2 : 1;
  __shared__ MgSmem<NB> sm;
  if (!find_tile<MG_BM>(p.offsets, p.E, blockIdx.x, sm.tile)) return;
  const int tid = threadIdx.x;
  if (tid < MG_BM) {
    const int i = sm.tile.row0 + tid;
    const bool ok = i < sm.tile.row_end;
    if constexpr (GATE_UP) {
      sm.src[tid] = ok ? p.order[i] / p.top_k : -1;
      sm.dst[tid] = ok ? i : -1;
    } else {
      sm.src[tid] = ok ? i : -1;
      sm.dst[tid] = ok ? p.order[i] : -1;
    }
  }
  __syncthreads();
  const int n0 = blockIdx.y * MG_BN;
  const size_t expert_w = (size_t)sm.tile.expert * p.K * p.N;
  const float* w0 = p.w0 + expert_w;
  const float* w1 = GATE_UP ? p.w1 + expert_w : w0;
  const int KT = (p.K + MG_BK - 1) / MG_BK;
#pragma unroll
  for (int s = 0; s < MG_STAGES - 1; ++s) {
    if (s < KT) load_stage<NB>(p, sm, s, s * MG_BK, n0, w0, w1);
    cp_async_commit();
  }
  // acc[m][r / 4][r % 4] at row (tid / 64) * 8 + r, column tid % 64
  float acc[NB][2][4] = {};
  const int col = tid % MG_BN, r0 = (tid / MG_BN) * 8;
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<MG_STAGES - 2>();
    __syncthreads();
    const int nk = kt + MG_STAGES - 1;
    if (nk < KT)
      load_stage<NB>(p, sm, nk % MG_STAGES, nk * MG_BK, n0, w0, w1);
    cp_async_commit();
    const int st = kt % MG_STAGES;
#pragma unroll 4
    for (int kk = 0; kk < MG_BK; ++kk) {
      float bv[NB];
#pragma unroll
      for (int m = 0; m < NB; ++m) bv[m] = sm.b[st][m][kk][col];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float av = sm.a[st][r0 + r][kk];
#pragma unroll
        for (int m = 0; m < NB; ++m)
          acc[m][r >> 2][r & 3] = fmaf(av, bv[m], acc[m][r >> 2][r & 3]);
      }
    }
  }
  cp_async_wait<0>();
  // epilogue: gate/up writes silu(g) * u at the sorted row, down writes
  // the product at the slot's row
  const int n = n0 + col;
  if (n < p.N) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int row = sm.dst[r0 + r];
      if (row < 0) continue;
      const float g = acc[0][r >> 2][r & 3];
      p.out[(size_t)row * p.N + n] =
          GATE_UP ? silu_mul(g, acc[NB - 1][r >> 2][r & 3]) : g;
    }
  }
}

cudaError_t launch_f32(const void* x, const void* order, const void* offsets,
                       const void* w_gate, const void* w_up,
                       const void* w_down, void* act, void* y, int n_tokens,
                       int top_k, int E, int d, int f, cudaStream_t stream) {
  const long long mt = mg_m_tiles((long long)n_tokens * top_k, E, MG_BM);
  MgArgs gu{static_cast<const float*>(x), static_cast<const float*>(w_gate),
            static_cast<const float*>(w_up), static_cast<const int*>(order),
            static_cast<const int*>(offsets), static_cast<float*>(act),
            d, f, E, top_k};
  moe_f32_kernel<true>
      <<<dim3(mt, mg_cdiv(f, MG_BN)), MG_THREADS, 0, stream>>>(gu);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  MgArgs dn{static_cast<const float*>(act), static_cast<const float*>(w_down),
            nullptr, static_cast<const int*>(order),
            static_cast<const int*>(offsets), static_cast<float*>(y),
            f, d, E, top_k};
  moe_f32_kernel<false>
      <<<dim3(mt, mg_cdiv(d, MG_BN)), MG_THREADS, 0, stream>>>(dn);
  return cudaGetLastError();
}

}  // namespace repro

REPRO_EXPORT_ERROR_STRING

// x [n_tokens, d]; order [n_tokens * top_k] int32 (slots sorted by
// expert); offsets [E + 1] int32; w_gate, w_up [E, d, f]; w_down [E, f,
// d]; act [n_tokens * top_k, f] scratch (the sorted rows' activations);
// y [n_tokens * top_k, d] out, in slot order.  dtype: 0 f32, 1 bf16
// (every float operand).  Two launches on `stream`.
extern "C" int repro_moe_grouped(const void* x, const void* order,
                                 const void* offsets, const void* w_gate,
                                 const void* w_up, const void* w_down,
                                 void* act, void* y, int n_tokens, int top_k,
                                 int E, int d, int f, int dtype,
                                 void* stream) {
  using namespace repro;
  if (n_tokens <= 0 || top_k <= 0 || E <= 0 || E > MG_MAX_E || d <= 0 ||
      f <= 0 || d % 8 != 0 || f % 8 != 0 ||
      (long long)n_tokens * top_k > 0x7fffffffLL ||
      mg_cdiv(d, 64) > 65535 || mg_cdiv(f, 64) > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == F32)
    return static_cast<int>(launch_f32(x, order, offsets, w_gate, w_up,
                                       w_down, act, y, n_tokens, top_k, E, d,
                                       f, s));
  if (dtype == BF16)
    return static_cast<int>(launch_bf16(x, order, offsets, w_gate, w_up,
                                        w_down, act, y, n_tokens, top_k, E,
                                        d, f, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The tile plan of a call {BM, gate/up BN, down BN} and the grid's M
// tiles at BM rows (the host's copies are kernels/moe_grouped.py::plan
// and ::m_tiles).
extern "C" void repro_moe_plan(long long n, int E, int d, int f, int dtype,
                               int* out) {
  const repro::MgPlan p = repro::mg_plan(n, E, d, f, dtype);
  out[0] = p.bm;
  out[1] = p.bn_gu;
  out[2] = p.bn_dn;
}

extern "C" long long repro_moe_m_tiles(long long n, int E, int bm) {
  return repro::mg_m_tiles(n, E, bm);
}
