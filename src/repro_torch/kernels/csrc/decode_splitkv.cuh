// Split-KV (flash-decoding) body of the two decode attention kernels,
// for Hopper: one query token per row, GQA, the group's query heads
// attending over the row's cached keys and values, softmax online in
// f32, output acc / max(l, 1e-30) in q's type (the Pallas kernels'
// finalize).  paged_decode.cu (float or bf16 head-blocks) and
// paged_decode_int8.cu (int8 K/V with per-token scales) each bind it to
// their own loader (FloatKV, Int8KV below).  Head dims 64, 96 and 128;
// groups of 1 to SK_MAX_GROUP = 16 query heads per kv head.
//
// What bounds it: bytes.  Each (row, kv head) reads its seq_len x hd
// keys and values once and does 4 flops per key/value element pair,
// far below the ~295 flops per byte the card needs to be compute-bound.
// A decode tick has few (row, kv head) pairs (8 x 4 at full-width
// qwen2-7b), so one CTA each leaves most of the 132 SMs idle and
// exposes each CTA's dependent load chain.  The design fills the card
// and streams:
//
// * Grid (split, kv head, row).  Split s of a row covers its tokens
//   [s * split, (s + 1) * split); the host sizes split and the grid
//   from shapes alone (max_tok, never seq_lens).  A split that starts
//   at or past its row's seq_len exits at once: its state is the empty
//   (m = NEG_INF, l = 0, acc = 0), which adds nothing to the merge, so
//   it is not written and the merge does not read it.
// * A CTA (4 warps) loads its group's queries and its split's cache
//   row bases (one block-id load per block) once, then streams the
//   split in chunks through a ring of STAGES stages filled by 16-byte
//   cp.async copies (rows past seq_len are zero-filled, never read), so
//   the next chunks are in flight while one is scored.  Rows are stored
//   with their 16-byte units XOR-swizzled by row (`swizzle`), so the
//   reads below are free of bank conflicts at every row width (8, 16,
//   24 units and the 12 and 6 of hd 96's bf16 and int8 rows).
// * bf16 queries (the serving path): tensor cores.  A 64-token chunk
//   gives each warp 16 tokens: S = Q K^T by mma.sync m16n8k16 (the
//   group's heads are the 16 rows of the A tile: heads 0-7 in rows
//   0-7 and, for a group of 9-16 (NR = 2), heads 8-15 in rows 8-15;
//   a group of <= 8 leaves rows 8-15 zero; Q's fragments held in
//   registers for the whole split), an online softmax per head on the
//   accumulator fragments (a thread keeps one (m, l) per head row it
//   holds), P rounded to bf16 and kept in registers as the A operand of
//   O += P V (the m16n8 accumulators of two key tiles are exactly one
//   m16k16 A fragment).  Each warp keeps its own (m, l, O) and the four
//   merge at the end.  int8 keys and values enter f16 fragments
//   (exact, made by integer operations), the key scale applied to S
//   and the value scale folded into P.
// * float32 queries (the reduced test models): CUDA cores, 32-token
//   chunks, a lane per key in the scores and 4 output dims a thread in
//   P V (TF32 would miss their 1e-4 tolerance).
// * Merge.  A row that fits one split writes its output directly.
//   Otherwise each live split writes its partial (m, l, acc[group][hd])
//   in f32 to a workspace the caller allocates, and a second kernel,
//   launched by the same entry point as a programmatic dependent (its
//   launch overlaps the split kernel), combines the live splits, a
//   thread per output element:
//   out = sum_s acc_s e^(m_s - m) / max(sum_s l_s e^(m_s - m), 1e-30).
//   (Merging in the split kernel's last CTA of each row instead, found
//   through an atomic counter, was slower: one CTA then walks a row's
//   whole merge.)
//
// CTAs an SM of the tensor-core body: its launch bound is
// SkSmem::RESIDENT, from its shared memory (3 for bf16 and int8 K/V at
// hd 64, 96 and 128; the float32 body's score buffers are not part of
// it), and what the compiled kernel gets, registers included, is
// reported by `repro_paged_decode_occupancy` / `repro_decode_int8_occupancy`.
// On an H100 80GB HBM3 (groups 8 and 16 alike): bf16 K/V 3 at hd 64, 96
// and 128 (100-167 registers); int8 K/V 4 at hd 64, 3 at hd 96 and 128.
//
// Addressing (DecodeLayout): token t of (row b, kv head h) is cache row
//   r = blk * blk_rows + b * row_rows + h * head_rows + (t % bt) * tok_rows,
//   blk = table ? table[b, h, t / bt] : t / bt,
// its hd values at k + r * hd, v + r * hd and its scales (int8) at
// sk[r], sv[r].  Tokens at or past min(seq_len[b], max_tok) are neither
// loaded nor counted.
#pragma once

#include <cuda_fp16.h>

#include <type_traits>

#include "attn_common.cuh"

namespace repro {

constexpr int SK_THREADS = 128;      // 4 warps
constexpr int SK_MAX_GROUP = 16;     // query heads per kv head
constexpr int SK_MAX_IDS = 258;      // blocks of one split (split / bt + 2)
constexpr int SK_SPLIT_ALIGN = 64;   // a split is whole chunks of either body
constexpr int SK_VD = 4;             // output dims a thread accumulates (f32)
constexpr int TC_CHUNK = 64;         // tokens a ring stage holds: bf16 body
constexpr int F32_CHUNK = 32;        // and float32 body

struct DecodeLayout {
  const int* table;  // [B, n_kv, max_blocks] block ids, or null (blk = t / bt)
  long long blk_rows, row_rows, head_rows, tok_rows;
  int max_blocks, bt, max_tok;
  int bt_shift;      // log2(bt) when bt is a power of two, else -1
};

__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// Two signed int8 (bytes `sel` of w, after w ^ 0x80808080 made them
// x + 128) as an exact f16x2: 0x64XX is 1024 + XX, less 1152.
__device__ __forceinline__ uint32_t i8x2_f16(uint32_t wx, uint32_t sel) {
  const uint32_t h = __byte_perm(wx, 0x64646464u, sel);
  uint32_t r;
  asm("sub.f16x2 %0, %1, %2;\n" : "=r"(r) : "r"(h), "r"(0x64806480u));
  return r;
}

// Physical 16-byte unit of unit u in ring row r.  Row r starts at bank
// group (r * UNITS) % 8, so rows PER = 8 / G apart start alike, G =
// gcd(UNITS, 8).  XOR-ing u's low log2(G) bits with (r / PER) % G gives
// such rows distinct bank groups for unit u, so 8 lanes reading one
// unit of 8 consecutive rows hit 8 distinct bank groups.  Only bits
// below G change and G divides UNITS, so each row's units are permuted
// among themselves: rows of 8, 16, 24 units XOR with r % 8; 4 and 12
// units (int8 hd 64, bf16 hd 96) with (r / 2) % 4; 6 units (int8 hd 96)
// with (r / 4) % 2.
template <int UNITS>
__device__ __forceinline__ int swizzle(int u, int r) {
  constexpr int G = UNITS % 8 == 0 ? 8 : (UNITS % 4 == 0 ? 4
                                          : (UNITS % 2 == 0 ? 2 : 1));
  return u ^ ((r / (8 / G)) & (G - 1));
}
// Address of byte `byte` of ring row r (rows of ROW bytes).
template <int ROW>
__device__ __forceinline__ const unsigned char* ring_at(
    const unsigned char* base, int r, int byte) {
  return base + r * ROW + swizzle<ROW / 16>(byte / 16, r) * 16 + byte % 16;
}

// ---------------------------------------------------------------------------
// The two loaders: what a cache row holds, how it becomes floats (CUDA
// cores) and how it becomes mma fragments (tensor cores).  A warp's
// tile is 16 ring rows from `tr0`; c = lane % 4, n = lane / 4.
// ---------------------------------------------------------------------------

// Head-blocks of float or bf16 keys and values (kernel 1).
template <typename E> struct FloatKV {
  using Elem = E;
  static constexpr bool kScaled = false;
  static constexpr bool kF16 = false;       // the fragments are bf16
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    return pack_bf16(lo, hi);
  }
  const E* k;
  const E* v;
  template <int N>
  static __device__ __forceinline__ void to_floats(const E* p,
                                                   float (&out)[N]) {
    load_f<E, N>(p, out);
  }
  // dim of k-slot `slot` (0..15) of a 16-dim k-step: the identity
  static __device__ __forceinline__ int k_dim(int slot) { return slot; }
  // B fragments of S = Q K^T for k-step ks: b[j] of key tile j (rows
  // tr0 + 8j ..), by one ldmatrix of four 8x8 matrices
  template <int HD>
  static __device__ __forceinline__ void k_frags(const unsigned char* ks,
                                                 int tr0, int step, int lane,
                                                 uint32_t (&b)[2][2]) {
    const int r = tr0 + (lane / 16) * 8 + lane % 8;
    uint32_t x[4];
    ldmatrix_x4(x, ring_at<HD * (int)sizeof(E)>(ks, r, (step * 16 + ((lane / 8) % 2) * 8) * 2));
    b[0][0] = x[0]; b[0][1] = x[1]; b[1][0] = x[2]; b[1][1] = x[3];
  }
  // B fragments of O += P V for output tiles 2p, 2p + 1 (dims 16p ..
  // 16p + 15), by one transposing ldmatrix
  template <int HD>
  static __device__ __forceinline__ void v_frags(const unsigned char* vs,
                                                 int tr0, int p, int lane,
                                                 uint32_t (&b)[2][2]) {
    const int r = tr0 + ((lane / 8) % 2) * 8 + lane % 8;
    uint32_t x[4];
    ldmatrix_x4_trans(x, ring_at<HD * (int)sizeof(E)>(vs, r, (p * 16 + (lane / 16) * 8) * 2));
    b[0][0] = x[0]; b[0][1] = x[1]; b[1][0] = x[2]; b[1][1] = x[3];
  }
  // output dim of column `col` (0..7) of output tile j
  static __device__ __forceinline__ int o_dim(int j, int col) {
    return j * 8 + col;
  }
};

// int8 keys and values with one f32 scale per (token, kv head) (kernel
// 5): the key scale multiplies the token's score, the value scale its
// probability, so the int8 values enter the products as they are.  The
// fragments are f16, which holds every int8 exactly and is made from
// bytes by integer operations alone (i8x2_f16; bf16 would need the
// quarter-rate int-to-float conversions); q enters scaled by a power
// of two that keeps it inside f16's range.  The fragments permute dims
// so that a thread reads contiguous bytes: k-slots (2c, 2c+1, 2c+8,
// 2c+9) of a k-step are dims 4c .. 4c+3, and output tiles 2p, 2p + 1
// take the even and odd dims of 16p .. 16p + 15.
struct Int8KV {
  using Elem = int8_t;
  static constexpr bool kScaled = true;
  static constexpr bool kF16 = true;
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    return pack_f16(lo, hi);
  }
  const int8_t* k;
  const int8_t* v;
  const float* sk;
  const float* sv;
  template <int N>
  static __device__ __forceinline__ void to_floats(const int8_t* p,
                                                   float (&out)[N]) {
    using V = typename VecOf<N>::type;
    const V raw = *reinterpret_cast<const V*>(p);
    const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = static_cast<float>(e[i]);
  }
  static __device__ __forceinline__ int k_dim(int slot) {
    return (slot % 8) / 2 * 4 + (slot / 8) * 2 + slot % 2;
  }
  template <int HD>
  static __device__ __forceinline__ void k_frags(const unsigned char* ks,
                                                 int tr0, int step, int lane,
                                                 uint32_t (&b)[2][2]) {
    // an 8x8 b16 matrix per key tile: lane gets bytes 4c .. 4c + 3 of
    // key n's 16 dims
    uint32_t x[2];
    ldmatrix_x2(x, ring_at<HD>(ks, tr0 + lane % 16, step * 16));
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const uint32_t wx = 0x80808080u ^ x[j];
      b[j][0] = i8x2_f16(wx, 0x4140);     // dims 4c, 4c + 1
      b[j][1] = i8x2_f16(wx, 0x4342);     // dims 4c + 2, 4c + 3
    }
  }
  template <int HD>
  static __device__ __forceinline__ void v_frags(const unsigned char* vs,
                                                 int tr0, int p, int lane,
                                                 uint32_t (&b)[2][2]) {
    // transposed 8x8 b16 matrices (keys 0-7, then 8-15): lane gets
    // dims 16p + 2n, + 1 of keys 2c (low half) and 2c + 1 (high half)
    uint32_t x[2];
    ldmatrix_x2_trans(x, ring_at<HD>(vs, tr0 + lane % 16, p * 16));
#pragma unroll
    for (int k = 0; k < 2; ++k) {     // keys 2c, 2c+1 (k 0); +8 (k 1)
      const uint32_t wx = 0x80808080u ^ x[k];
      b[0][k] = i8x2_f16(wx, 0x4240);     // tile 2p: dim 16p + 2n
      b[1][k] = i8x2_f16(wx, 0x4341);     // tile 2p + 1: dim 16p + 2n + 1
    }
  }
  static __device__ __forceinline__ int o_dim(int j, int col) {
    return (j / 2) * 16 + col * 2 + j % 2;
  }
};

template <typename T, typename KV> struct DecodeArgs {
  const T* q;            // [B, H, hd]
  KV kv;
  const int* seq_lens;   // [B]
  T* out;                // [B, H, hd]
  float* ws;             // partial states, null when n_splits == 1
  int H, n_kv, group, split, n_splits;
  float scale;
  DecodeLayout lay;
};

// Workspace of the partial states: (m, l) pairs at
// ((bh * n_splits + s) * SK_MAX_GROUP + g) * 2, then acc at
// ml_floats + ((bh * n_splits + s) * group + g) * hd + d.
__host__ __device__ inline long long ws_ml_floats(int bh_count, int n_splits) {
  return (long long)bh_count * n_splits * SK_MAX_GROUP * 2;
}

// Shared memory of one CTA: the ring, then the fixed parts (the
// scores, probabilities and corrections only in the float32 body).  The
// per-thread (f32) or per-warp (bf16) accumulators merge through the
// ring once it is drained.
template <typename KV, int HD, int CHUNK> struct SkSmem {
  using E = typename KV::Elem;
  static constexpr bool kCudaCores = CHUNK == F32_CHUNK;
  static constexpr int ROW_BYTES = HD * (int)sizeof(E);
  static constexpr int UNITS = ROW_BYTES / 16;          // 16-byte units a row
  static constexpr int KV_BYTES = CHUNK * ROW_BYTES;
  static constexpr int STAGE_BYTES =
      2 * KV_BYTES + (KV::kScaled ? 2 * CHUNK * 4 : 0);
  static constexpr int FIT = 65536 / STAGE_BYTES;      // a 64 KB ring
  static constexpr int STAGES = FIT < 2 ? 2 : (FIT > 4 ? 4 : FIT);
  static constexpr int RING = STAGES * STAGE_BYTES;
  static constexpr int RED = 4 * SK_MAX_GROUP * HD * 4;  // 4 partial accs
  static constexpr int Q_OFF = RING > RED ? RING : RED;
  static constexpr int SPART_OFF = Q_OFF + SK_MAX_GROUP * HD * 4;
  static constexpr int P_OFF =
      SPART_OFF + (kCudaCores ? 4 * SK_MAX_GROUP * CHUNK * 4 : 0);
  static constexpr int CORR_OFF =
      P_OFF + (kCudaCores ? SK_MAX_GROUP * CHUNK * 4 : 0);
  static constexpr int M_OFF = CORR_OFF + (kCudaCores ? SK_MAX_GROUP * 4 : 0);
  static constexpr int L_OFF = M_OFF + 4 * SK_MAX_GROUP * 4;
  static constexpr int ROWS_OFF = L_OFF + 4 * SK_MAX_GROUP * 4;
  static constexpr int BYTES = ROWS_OFF + SK_MAX_IDS * 8;
  // CTAs an SM, the tensor-core body's launch bound: as many as an
  // H100's 228 KB of shared memory holds (1 KB of it reserved per CTA),
  // at most 3, which leaves 168 registers a thread.  bf16 and int8 K/V:
  // 3 at hd 64, 96 and 128 (bf16 hd 128: 76,304 bytes a CTA).
  static constexpr int SM_FIT = 228 * 1024 / (BYTES + 1024);
  static constexpr int RESIDENT = SM_FIT < 1 ? 1 : (SM_FIT > 3 ? 3 : SM_FIT);
  static_assert(UNITS >= 4 && UNITS % 2 == 0,
                "a cache row holds an even number (>= 4) of 16-byte units");
  static_assert(HD % 32 == 0 && HD <= 128, "head dims 64, 96, 128");
  static_assert(SK_SPLIT_ALIGN % CHUNK == 0, "a split is whole chunks");
  static_assert(ROWS_OFF % 8 == 0, "the block-row bases are 8-byte words");
};

// What both bodies share: the split's range, the query heads, the
// cache row bases of its blocks, and the ring's copies.
template <typename T, typename KV, int HD, int CHUNK> struct SplitWalk {
  using L = SkSmem<KV, HD, CHUNK>;
  using E = typename KV::Elem;
  const DecodeArgs<T, KV>& a;
  unsigned char* smem;
  int b, h, split, G, n_live, s0, end, n_chunks, j0;

  // Reads the row's length and, without waiting for it, the group's
  // queries (to shared memory, f32) and the first cache row of every
  // block the split can touch: one round trip to memory, not three.
  __device__ SplitWalk(const DecodeArgs<T, KV>& args, unsigned char* sm)
      : a(args), smem(sm) {
    split = blockIdx.x;
    h = blockIdx.y;
    b = blockIdx.z;
    G = a.group;
    s0 = split * a.split;
    j0 = blk_of(s0);
    const int seq_len = a.seq_lens[b];
    const int tid = threadIdx.x;
    const T* qb = a.q + ((size_t)b * a.H + (size_t)h * G) * HD;
    for (int i = tid; i < G * HD; i += SK_THREADS) q_s()[i] = to_float(qb[i]);
    const DecodeLayout& lay = a.lay;
    const int* tb = lay.table == nullptr
                        ? nullptr
                        : lay.table + ((size_t)b * a.n_kv + h) * lay.max_blocks;
    const long long row0 =
        (long long)b * lay.row_rows + (long long)h * lay.head_rows;
    const int s_last = min(s0 + a.split, lay.max_tok) - 1;
    const int n_blk = s_last >= s0 ? blk_of(s_last) - j0 + 1 : 0;
    for (int i = tid; i < n_blk; i += SK_THREADS) {
      const long long blk = tb == nullptr ? j0 + i : tb[j0 + i];
      rows_s()[i] = blk * lay.blk_rows + row0 -
                    (long long)(j0 + i) * lay.bt * lay.tok_rows;
    }
    const int n_tok = min(max(seq_len, 0), lay.max_tok);
    n_live = (n_tok + a.split - 1) / a.split;
    end = min(n_tok, s0 + a.split);       // s0 < end, or a row of no token
    n_chunks = end > s0 ? (end - s0 + CHUNK - 1) / CHUNK : 0;
  }
  __device__ bool empty_split() const { return split > 0 && split >= n_live; }
  __device__ int blk_of(int t) const {
    return a.lay.bt_shift >= 0 ? t >> a.lay.bt_shift : t / a.lay.bt;
  }
  __device__ float* q_s() const { return reinterpret_cast<float*>(smem + L::Q_OFF); }
  __device__ long long* rows_s() const {
    return reinterpret_cast<long long*>(smem + L::ROWS_OFF);
  }
  // cache row of token t (s0 <= t < end)
  __device__ long long row_of(int t) const {
    return rows_s()[blk_of(t) - j0] + (long long)t * a.lay.tok_rows;
  }
  __device__ unsigned char* stage(int c) const {
    return smem + (c % L::STAGES) * L::STAGE_BYTES;
  }
  // chunk c into its ring stage: K and V rows unit by unit, then the
  // scales; rows past `end` zero-filled
  __device__ void issue(int c) const {
    constexpr int U = L::UNITS, EPU = 16 / (int)sizeof(E);
    unsigned char* st = stage(c);
    const int c0 = s0 + c * CHUNK;
    for (int i = threadIdx.x; i < CHUNK * U; i += SK_THREADS) {
      const int r = i / U, u = i % U, t = c0 + r;
      const bool valid = t < end;
      const long long off = valid ? row_of(t) * HD + u * EPU : 0;
      unsigned char* dst = st + r * L::ROW_BYTES + swizzle<U>(u, r) * 16;
      cp_async_16(dst, a.kv.k + off, valid);
      cp_async_16(dst + L::KV_BYTES, a.kv.v + off, valid);
    }
    if constexpr (KV::kScaled) {
      for (int i = threadIdx.x; i < 2 * CHUNK; i += SK_THREADS) {
        const int which = i / CHUNK, r = i % CHUNK, t = c0 + r;
        const bool valid = t < end;
        const float* base = which ? a.kv.sv : a.kv.sk;
        cp_async_4(st + 2 * L::KV_BYTES + i * 4,
                   valid ? base + row_of(t) : base, valid);
      }
    }
  }
  // Write the CTA's state of head g: num(g, d) over dims, m, l.  One
  // split holds the whole row: the output; else the workspace.
  template <typename Num>
  __device__ void finish(const float* m_g, const float* l_g, Num num) const {
    const int bh = b * a.n_kv + h;
    for (int i = threadIdx.x; i < G * HD; i += SK_THREADS) {
      const int g = i / HD, d = i % HD;
      const float x = num(g, d);
      if (n_live <= 1) {
        // (no token: l = 0, acc = 0 -> 0, as the Pallas kernel)
        a.out[((size_t)b * a.H + (size_t)h * G) * HD + i] =
            from_float<T>(x / fmaxf(l_g[g], 1e-30f));
      } else {
        a.ws[ws_ml_floats(gridDim.z * a.n_kv, a.n_splits) +
             (((long long)bh * a.n_splits + split) * G + g) * HD + d] = x;
      }
    }
    if (n_live > 1 && threadIdx.x < G) {
      float* ml = a.ws +
          (((long long)bh * a.n_splits + split) * SK_MAX_GROUP + threadIdx.x) * 2;
      ml[0] = m_g[threadIdx.x];
      ml[1] = l_g[threadIdx.x];
    }
  }
};

// ---------------------------------------------------------------------------
// bf16 queries: tensor cores, 64-token chunks, 16 tokens a warp.  NR
// head rows a thread holds: 1 (group <= 8: head n = lane / 4, rows
// 8-15 of the A tile zero) or 2 (group 9-16: heads n and n + 8).
// ---------------------------------------------------------------------------
template <typename T, typename KV, int HD, int NR>
__global__ void __launch_bounds__(SK_THREADS,
                                  (SkSmem<KV, HD, TC_CHUNK>::RESIDENT))
splitkv_tc_kernel(const __grid_constant__ DecodeArgs<T, KV> a) {
  static_assert(NR == 1 || NR == 2, "one or two 8-head halves of the tile");
  using W = SplitWalk<T, KV, HD, TC_CHUNK>;
  using L = typename W::L;
  constexpr int NT = HD / 8;                    // output tiles
  extern __shared__ __align__(16) unsigned char smem[];
  W w(a, smem);
  // the merge kernel may be placed now: it waits for this grid's end
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  if (w.empty_split()) return;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c = lane % 4, n = lane / 4;         // n: this thread's head row
  __syncthreads();

  // f16 fragments: q times a power of two (exact) that keeps its
  // largest magnitude below 2^14, the score multiplier divided by it
  float qs = 1.f, mult0 = a.scale;
  if constexpr (KV::kF16) {
    float mx = 0.f;
    for (int i = tid; i < w.G * HD; i += SK_THREADS)
      mx = fmaxf(mx, fabsf(w.q_s()[i]));
    mx = warp_max(mx);
    float* red4 = reinterpret_cast<float*>(smem + L::M_OFF);
    if (lane == 0) red4[warp] = mx;
    __syncthreads();
    mx = fmaxf(fmaxf(red4[0], red4[1]), fmaxf(red4[2], red4[3]));
    int e;
    frexpf(mx, &e);                             // mx < 2^e
    if (e > 14) {
      qs = ldexpf(1.f, 14 - e);
      mult0 = a.scale / qs;
    }
  }
  // Q's A fragments per k-step: qa[s][hr] holds k-slots 2c, 2c + 1 and
  // qa[s][2 + hr] k-slots 2c + 8, 2c + 9 of tile row n + 8 hr, the
  // query of head n + 8 hr (zero past the group, and rows 8-15 when
  // NR is 1)
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int g = n + 8 * hr;
    const bool live = hr < NR && g < w.G;
    const float* q = w.q_s() + (live ? g : 0) * HD;
#pragma unroll
    for (int s = 0; s < HD / 16; ++s) {
      const int d0 = s * 16;
      qa[s][hr] = live ? KV::pack(q[d0 + KV::k_dim(2 * c)] * qs,
                                  q[d0 + KV::k_dim(2 * c + 1)] * qs) : 0u;
      qa[s][2 + hr] = live ? KV::pack(q[d0 + KV::k_dim(2 * c + 8)] * qs,
                                      q[d0 + KV::k_dim(2 * c + 9)] * qs) : 0u;
    }
  }

  float m[NR], l[NR];                           // head row n + 8 hr, this
#pragma unroll                                  // thread's part
  for (int hr = 0; hr < NR; ++hr) {
    m[hr] = NEG_INF;
    l[hr] = 0.f;
  }
  float o[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < L::STAGES - 1; ++s) {
    if (s < w.n_chunks) w.issue(s);
    cp_async_commit();
  }
  const int tr0 = warp * 16;                    // this warp's ring rows
  for (int ch = 0; ch < w.n_chunks; ++ch) {
    cp_async_wait<L::STAGES - 2>();
    __syncthreads();             // chunk ch visible; chunk ch - 1 consumed
    if (ch + L::STAGES - 1 < w.n_chunks) w.issue(ch + L::STAGES - 1);
    cp_async_commit();
    const int t0 = w.s0 + ch * TC_CHUNK + tr0;  // this warp's first token
    if (t0 >= w.end) continue;                  // warp-uniform
    const unsigned char* ks = w.stage(ch);
    const unsigned char* vs = ks + L::KV_BYTES;

    // S = Q K^T: two 8-key tiles; s[j][2 hr + e] is head row n + 8 hr's
    // score of key tr0 + 8j + 2c + e
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int st = 0; st < HD / 16; ++st) {
      uint32_t kb[2][2];
      KV::template k_frags<HD>(ks, tr0, st, lane, kb);
      const uint32_t qf[4] = {qa[st][0], qa[st][1], qa[st][2], qa[st][3]};
      mma_16816<KV::kF16>(s[0], qf, kb[0][0], kb[0][1]);
      mma_16816<KV::kF16>(s[1], qf, kb[1][0], kb[1][1]);
    }
    // each key's score multiplier (times its key scale for int8)
    float mult[2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = tr0 + 8 * j + 2 * c + e;
        mult[j][e] = mult0;
        if constexpr (KV::kScaled)
          mult[j][e] *= reinterpret_cast<const float*>(ks + 2 * L::KV_BYTES)[r];
      }
    // online softmax of each head row over the 16 keys (4 a thread,
    // the quad holds the row)
    float corr[NR], p[NR][2][2];
#pragma unroll
    for (int hr = 0; hr < NR; ++hr) {
      float x[2][2];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = tr0 + 8 * j + 2 * c + e;
          x[j][e] = t0 - tr0 + r < w.end ? s[j][2 * hr + e] * mult[j][e]
                                         : NEG_INF;
          mx = fmaxf(mx, x[j][e]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, 2));
      const float m_new = fmaxf(m[hr], mx);     // finite: key t0 is valid
      corr[hr] = expf(m[hr] - m_new);
      m[hr] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          p[hr][j][e] = expf(x[j][e] - m_new);
          sum += p[hr][j][e];
          if constexpr (KV::kScaled)
            p[hr][j][e] *= reinterpret_cast<const float*>(
                ks + 2 * L::KV_BYTES)[TC_CHUNK + tr0 + 8 * j + 2 * c + e];
        }
      l[hr] = l[hr] * corr[hr] + sum;
    }
    // P as the A fragment of the 16 keys (rows 8..15 zero when NR is 1)
    const uint32_t pa[4] = {
        KV::pack(p[0][0][0], p[0][0][1]),
        NR > 1 ? KV::pack(p[NR - 1][0][0], p[NR - 1][0][1]) : 0u,
        KV::pack(p[0][1][0], p[0][1][1]),
        NR > 1 ? KV::pack(p[NR - 1][1][0], p[NR - 1][1][1]) : 0u};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      o[j][0] *= corr[0];
      o[j][1] *= corr[0];
      if constexpr (NR > 1) {
        o[j][2] *= corr[NR - 1];
        o[j][3] *= corr[NR - 1];
      }
    }
#pragma unroll
    for (int pp = 0; pp < NT / 2; ++pp) {
      uint32_t vb[2][2];
      KV::template v_frags<HD>(vs, tr0, pp, lane, vb);
      mma_16816<KV::kF16>(o[2 * pp], pa, vb[0][0], vb[0][1]);
      mma_16816<KV::kF16>(o[2 * pp + 1], pa, vb[1][0], vb[1][1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();               // the ring is free: merge the warps there

  float (*red)[SK_MAX_GROUP][HD] =
      reinterpret_cast<float (*)[SK_MAX_GROUP][HD]>(smem);
  float (*m_w)[SK_MAX_GROUP] = reinterpret_cast<float (*)[SK_MAX_GROUP]>(smem + L::M_OFF);
  float (*l_w)[SK_MAX_GROUP] = reinterpret_cast<float (*)[SK_MAX_GROUP]>(smem + L::L_OFF);
#pragma unroll
  for (int hr = 0; hr < NR; ++hr) {
    float lt = l[hr];
    lt += __shfl_xor_sync(FULL_MASK, lt, 1);
    lt += __shfl_xor_sync(FULL_MASK, lt, 2);
    const int g = n + 8 * hr;
    if (g < w.G) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        red[warp][g][KV::o_dim(j, 2 * c)] = o[j][2 * hr];
        red[warp][g][KV::o_dim(j, 2 * c + 1)] = o[j][2 * hr + 1];
      }
      if (c == 0) {
        m_w[warp][g] = m[hr];
        l_w[warp][g] = lt;
      }
    }
  }
  __syncthreads();
  // the CTA's state per head: the warps' states rescaled to their max
  float* m_g = w.q_s();                         // q is in registers now
  float* l_g = m_g + SK_MAX_GROUP;
  float* f_g = l_g + SK_MAX_GROUP;              // [4][SK_MAX_GROUP]
  if (tid < w.G) {
    float mx = NEG_INF;
#pragma unroll
    for (int k = 0; k < 4; ++k) mx = fmaxf(mx, m_w[k][tid]);
    float den = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float f = expf(m_w[k][tid] - mx);
      f_g[k * SK_MAX_GROUP + tid] = f;
      den += l_w[k][tid] * f;
    }
    m_g[tid] = mx;
    l_g[tid] = den;
  }
  __syncthreads();
  w.finish(m_g, l_g, [&](int g, int d) {
    float x = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) x += red[k][g][d] * f_g[k * SK_MAX_GROUP + g];
    return x;
  });
}

// ---------------------------------------------------------------------------
// float32 queries: CUDA cores, 32-token chunks.
// ---------------------------------------------------------------------------

template <typename T, typename KV, int HD>
__global__ void __launch_bounds__(SK_THREADS)
splitkv_f32_kernel(const __grid_constant__ DecodeArgs<T, KV> a) {
  using W = SplitWalk<T, KV, HD, F32_CHUNK>;
  using L = typename W::L;
  using E = typename KV::Elem;
  constexpr int U = L::UNITS;
  constexpr int EPU = 16 / (int)sizeof(E);      // elements of one unit
  constexpr int UPW = (U + 3) / 4;              // units a warp dots
  constexpr int HPW = SK_MAX_GROUP / 4;         // heads a warp's softmax runs
  constexpr int COLS = HD / SK_VD;              // threads across hd
  constexpr int TG = SK_THREADS / COLS;         // token groups (hd 96: 5,
                                                // threads 120.. idle in P V)
  extern __shared__ __align__(16) unsigned char smem[];
  W w(a, smem);
  // the merge kernel may be placed now: it waits for this grid's end
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  if (w.empty_split()) return;
  float (*q_s)[HD] = reinterpret_cast<float (*)[HD]>(w.q_s());
  float (*s_part)[SK_MAX_GROUP][F32_CHUNK] =
      reinterpret_cast<float (*)[SK_MAX_GROUP][F32_CHUNK]>(smem + L::SPART_OFF);
  float (*p_s)[F32_CHUNK] = reinterpret_cast<float (*)[F32_CHUNK]>(smem + L::P_OFF);
  float* corr_s = reinterpret_cast<float*>(smem + L::CORR_OFF);
  float* m_s = reinterpret_cast<float*>(smem + L::M_OFF);
  float* l_s = reinterpret_cast<float*>(smem + L::L_OFF);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = w.G;
  __syncthreads();

  float m[HPW], l[HPW];                         // heads warp + 4 gi
#pragma unroll
  for (int gi = 0; gi < HPW; ++gi) {
    m[gi] = NEG_INF;
    l[gi] = 0.f;
  }
  float acc[SK_MAX_GROUP][SK_VD];
#pragma unroll
  for (int g = 0; g < SK_MAX_GROUP; ++g)
#pragma unroll
    for (int e = 0; e < SK_VD; ++e) acc[g][e] = 0.f;
  const int col = tid % COLS, tg = tid / COLS;

#pragma unroll
  for (int c = 0; c < L::STAGES - 1; ++c) {
    if (c < w.n_chunks) w.issue(c);
    cp_async_commit();
  }
  for (int c = 0; c < w.n_chunks; ++c) {
    cp_async_wait<L::STAGES - 2>();
    __syncthreads();             // chunk c visible; chunk c - 1 consumed
    if (c + L::STAGES - 1 < w.n_chunks) w.issue(c + L::STAGES - 1);
    cp_async_commit();
    const unsigned char* st = w.stage(c);
    const E* ks = reinterpret_cast<const E*>(st);
    const E* vs = reinterpret_cast<const E*>(st + L::KV_BYTES);
    const int c0 = w.s0 + c * F32_CHUNK;

    // scores: warp w dots units [w UPW, (w+1) UPW) of key `lane`
    {
      float s[SK_MAX_GROUP];
#pragma unroll
      for (int g = 0; g < SK_MAX_GROUP; ++g) s[g] = 0.f;
#pragma unroll
      for (int uu = 0; uu < UPW; ++uu) {
        const int u = warp * UPW + uu;
        if (U % 4 != 0 && u >= U) break;        // warp-uniform
        float kf[EPU];
        KV::template to_floats<EPU>(
            ks + (lane * U + swizzle<U>(u, lane)) * EPU, kf);
#pragma unroll
        for (int g = 0; g < SK_MAX_GROUP; ++g) {
          if (g < G) {
#pragma unroll
            for (int e = 0; e < EPU; e += 4) {
              const float4 qv =
                  *reinterpret_cast<const float4*>(&q_s[g][u * EPU + e]);
              s[g] += qv.x * kf[e] + qv.y * kf[e + 1] + qv.z * kf[e + 2] +
                      qv.w * kf[e + 3];
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < SK_MAX_GROUP; ++g)
        if (g < G) s_part[warp][g][lane] = s[g];
    }
    __syncthreads();

    // online softmax: warp w runs heads w, w + 4, ... (lane = key; the
    // chunk's first key is valid, so m_new is finite and masked keys
    // get p = 0)
#pragma unroll
    for (int gi = 0; gi < HPW; ++gi) {
      const int g = warp + 4 * gi;
      if (g < G) {
        float x = s_part[0][g][lane] + s_part[1][g][lane] +
                  s_part[2][g][lane] + s_part[3][g][lane];
        float mult = a.scale;
        if constexpr (KV::kScaled)
          mult *= reinterpret_cast<const float*>(st + 2 * L::KV_BYTES)[lane];
        x = c0 + lane < w.end ? x * mult : NEG_INF;
        const float m_new = fmaxf(m[gi], warp_max(x));
        float p = expf(x - m_new);
        const float corr = expf(m[gi] - m_new);
        l[gi] = l[gi] * corr + warp_sum(p);
        m[gi] = m_new;
        if constexpr (KV::kScaled)
          p *= reinterpret_cast<const float*>(st + 2 * L::KV_BYTES)[F32_CHUNK + lane];
        p_s[g][lane] = p;
        if (lane == 0) corr_s[g] = corr;
      }
    }
    __syncthreads();

    // P V: dims [4 col, 4 col + 4) of every head over rows tg, tg + TG, ...
#pragma unroll
    for (int g = 0; g < SK_MAX_GROUP; ++g) {
      if (g < G) {
        const float corr = corr_s[g];
#pragma unroll
        for (int e = 0; e < SK_VD; ++e) acc[g][e] *= corr;
      }
    }
    const int nv = min(F32_CHUNK, w.end - c0);
    constexpr int PER_UNIT = EPU / SK_VD;       // threads sharing a unit
    const int u = col / PER_UNIT, off = (col % PER_UNIT) * SK_VD;
    for (int r = tg; r < nv && tg < TG; r += TG) {
      float vf[SK_VD];
      KV::template to_floats<SK_VD>(vs + (r * U + swizzle<U>(u, r)) * EPU + off,
                                    vf);
#pragma unroll
      for (int g = 0; g < SK_MAX_GROUP; ++g) {
        if (g < G) {
          const float p = p_s[g][r];
#pragma unroll
          for (int e = 0; e < SK_VD; ++e) acc[g][e] += p * vf[e];
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();               // the ring is free: reuse it for the merge

  float (*red)[SK_MAX_GROUP][HD] =
      reinterpret_cast<float (*)[SK_MAX_GROUP][HD]>(smem);
  // TG token groups of partial sums: fold groups 4.. into 0..3 first
#pragma unroll
  for (int k = 0; k < TG; k += 4) {
    if (tg >= k && tg < k + 4 && tg < TG) {
#pragma unroll
      for (int g = 0; g < SK_MAX_GROUP; ++g)
        if (g < G)
#pragma unroll
          for (int e = 0; e < SK_VD; ++e) {
            float& slot = red[tg - k][g][col * SK_VD + e];
            slot = k == 0 ? acc[g][e] : slot + acc[g][e];
          }
    }
    __syncthreads();
  }
#pragma unroll
  for (int gi = 0; gi < HPW; ++gi) {
    const int g = warp + 4 * gi;
    if (g < G && lane == 0) {
      m_s[g] = m[gi];
      l_s[g] = l[gi];
    }
  }
  __syncthreads();
  w.finish(m_s, l_s, [&](int g, int d) {
    return red[0][g][d] + red[1][g][d] + red[2][g][d] + red[3][g][d];
  });
}

// The merge, a kernel of its own: one CTA per (head, kv head, row), a
// thread per output dim; rows of two or more live splits are merged.
// It is launched as a programmatic dependent of the split kernel, so
// its CTAs are placed while the split kernel runs, and every CTA waits
// there (griddepcontrol.wait) until the split grid has completed and
// its writes are visible, before it reads or exits: a CTA that exits
// early must wait too, or the merge grid could complete, and release
// the stream's next kernel, before the splits have written ``out``.
template <typename T, int HD>
__global__ void __launch_bounds__(HD)
splitkv_combine_kernel(const float* __restrict__ ws,
                       const int* __restrict__ seq_lens, T* __restrict__ out,
                       int H, int n_kv, int group, int split, int n_splits,
                       int max_tok) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int g = blockIdx.x, h = blockIdx.y, b = blockIdx.z, d = threadIdx.x;
  const int n_tok = min(max(seq_lens[b], 0), max_tok);
  const int n_live = (n_tok + split - 1) / split;
  if (n_live <= 1) return;       // written by its split
  const int bh = b * n_kv + h;
  const float2* ml = reinterpret_cast<const float2*>(ws) +
                     (long long)bh * n_splits * SK_MAX_GROUP + g;
  const float* acc = ws + ws_ml_floats(gridDim.z * n_kv, n_splits) +
                     ((long long)bh * n_splits * group + g) * HD + d;
  // one pass, online: the loads of 8 splits are issued together
  float mx = NEG_INF, den = 0.f, num = 0.f;
#pragma unroll 8
  for (int s = 0; s < n_live; ++s) {
    const float2 st = ml[s * SK_MAX_GROUP];
    const float x = acc[(long long)s * group * HD];
    const float m_new = fmaxf(mx, st.x);
    const float c = expf(mx - m_new), f = expf(st.x - m_new);
    den = den * c + st.y * f;
    num = num * c + x * f;
    mx = m_new;
  }
  out[((size_t)b * H + (size_t)h * group + g) * HD + d] =
      from_float<T>(num / fmaxf(den, 1e-30f));
}

// The split kernel of a launch (tensor cores for bf16 queries, with
// one or two head rows a thread by the group; CUDA cores for f32) and
// its shared memory, the dynamic shared-memory opt-in made once per
// kernel.
template <typename T, typename KV, int HD>
cudaError_t split_decode_kernel(int group, void (**kernel)(const DecodeArgs<T, KV>),
                                int* smem_bytes) {
  constexpr bool tc = std::is_same<T, __nv_bfloat16>::value;
  using Smem = typename std::conditional<tc, SkSmem<KV, HD, TC_CHUNK>,
                                         SkSmem<KV, HD, F32_CHUNK>>::type;
  const int wide = tc && group > 8 ? 1 : 0;
  if constexpr (tc)
    *kernel = wide ? splitkv_tc_kernel<T, KV, HD, 2>
                   : splitkv_tc_kernel<T, KV, HD, 1>;
  else
    *kernel = splitkv_f32_kernel<T, KV, HD>;
  *smem_bytes = Smem::BYTES;
  static bool attr_set[2] = {false, false};
  if (!attr_set[wide]) {
    const cudaError_t err = cudaFuncSetAttribute(
        *kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem::BYTES);
    if (err != cudaSuccess) return err;
    attr_set[wide] = true;
  }
  return cudaSuccess;
}

// The split kernel, then (n_splits > 1) the merge kernel, on one stream.
template <typename T, typename KV, int HD>
cudaError_t launch_split_decode(const DecodeArgs<T, KV>& a, int B,
                                cudaStream_t stream) {
  void (*kernel)(const DecodeArgs<T, KV>);
  int smem = 0;
  cudaError_t err = split_decode_kernel<T, KV, HD>(a.group, &kernel, &smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.n_splits, a.n_kv, B);
  kernel<<<grid, SK_THREADS, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.n_splits == 1) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.group, a.n_kv, B);
  cfg.blockDim = dim3(HD);
  cfg.stream = stream;
  cudaLaunchAttribute pdl;
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &pdl;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, splitkv_combine_kernel<T, HD>,
                           (const float*)a.ws, a.seq_lens, a.out, a.H, a.n_kv,
                           a.group, a.split, a.n_splits, a.lay.max_tok);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// What the compiled split kernel of (T, KV, HD, group) gets on this
// card: out[0] CTAs an SM (registers and shared memory together),
// out[1] its dynamic shared memory in bytes, out[2] registers a thread.
template <typename T, typename KV, int HD>
cudaError_t split_decode_occupancy(int group, int* out) {
  void (*kernel)(const DecodeArgs<T, KV>);
  cudaError_t err = split_decode_kernel<T, KV, HD>(group, &kernel, &out[1]);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel,
                                                      SK_THREADS, out[1]);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  out[2] = attr.numRegs;
  return err;
}

// Host-side check of a plan (the wrapper computes it from shapes).
inline bool plan_ok(int split, int n_splits, const DecodeLayout& lay,
                    const void* ws) {
  if (split <= 0 || split % SK_SPLIT_ALIGN != 0 || n_splits <= 0 ||
      (long long)split * n_splits < lay.max_tok)
    return false;
  if (split / lay.bt + 2 > SK_MAX_IDS) return false;
  return n_splits == 1 || ws != nullptr;
}

// log2(bt) when bt is a power of two, else -1
inline int bt_shift_of(int bt) {
  for (int s = 0; s < 31; ++s)
    if ((1 << s) == bt) return s;
  return -1;
}

}  // namespace repro
