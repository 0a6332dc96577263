// Paged attention for Hopper (sm_90a), prefill-chunk body: causal,
// length-masked GQA attention of the S fresh queries of a chunk over KV
// blocks found through a block table, on the tensor cores.
//
// Replaces, for S * n_rep > T rows (T, the threshold, in
// serving/paged/paged_attention.py), the Pallas TPU kernel
//   paged_attention_pallas  src/repro/serving/paged/paged_attention.py:180
//                           (_paged_attn_kernel :122, its quantized branch
//                           :124-130 and :147-149)
// (csrc/paged_attention.cu, the decode body, serves rows <= T).  The
// contract is the decode body's (csrc/paged_attention.cu:1-20): query i of
// lane b sits at position cursor[b] + i and sees positions j <= cursor[b] +
// i (and j > cursor[b] + i - window when window > 0); position j's K/V is
// row j % bs of physical block tables[b, j / bs]; q head h reads KV head h
// / n_rep; scores are scaled by 1/sqrt(hd) in f32; masked scores are the
// finite -1e30 and the final sum is clamped at 1e-30; out is bf16.  int8
// arenas dequantize position j of KV head h as int8 * scale[j, h] (f32
// scales [n_blocks, bs, KV] found through the same table entry).
//
// Layout (bf16 unless stated; the wrapper checks it):
//   q       [B, S, H, hd]
//   k, v    [n_blocks, bs, KV, hd]   one layer's arena (bf16 or int8)
//   k_scale, v_scale [n_blocks, bs, KV] f32   int8 arenas only
//   tables  [B, nb] int32
//   cursor  [B] int32
//   out     [B, S, H, hd]
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): a 512-token
// chunk at cursor 256 (llama3-8b: H 32, KV 8, hd 128) is bound by
// operations, 4 * H * hd * (visible (query, key) pairs) = 4.3 GFLOP, 4.3
// us on the tensor cores; a 64-token chunk over 4 lanes is bound by the
// bytes of the KV blocks its queries see, 2-3 us.  On the CUDA cores in f32
// (the decode body's way) the 512-token chunk's 2.15 G multiply-adds alone
// take ~70 us, so both products run on the tensor cores here.
//
// Design:
//   * a row is a (query, rep) pair, flattened as in the decode body (row r
//     is query r / n_rep of q head kvh * n_rep + r % n_rep); one block
//     covers BM = 64 or 128 rows (one warpgroup per 64) of one KV head of
//     one lane, so every K/V tile is read once per KV head, not n_rep
//     times; the grid is (row tiles, KV, B).  Each row takes its own causal
//     limit cursor + r / n_rep, so any n_rep works;
//   * a K/V tile is TK = 64 key positions, gathered row by row through the
//     table with 16-byte cp.async into a ring of kStages = 3 slots;
//     each key row resolves its own table entry, so bs need not divide 64.
//     Rows past the last visible position, past nb * bs, or whose table
//     entry lies outside [0, n_arena) are zero-filled (a copy of 0 bytes)
//     and never read from the arena.  The block reads its own table
//     entries; the loop starts at the window's first tile and stops at the
//     tile of the last position the block's rows can see;
//   * S = Q K^T by wgmma m64n64k16 (f32 accumulators), Q loaded once into a
//     128-byte-swizzled tile (64-wide panels), K K-major as stored (hd
//     contiguous), no transpose;  1/sqrt(hd) (and with int8 each column's
//     k_scale) multiplies the f32 scores, so q is not rounded again;
//   * online softmax in registers: a thread holds two rows' 16 columns of
//     each tile, their running max shared with quad shuffles, their sums
//     kept per thread and added over the quad at the end; only the tiles
//     that cross a row's causal limit or window edge apply the mask, and a
//     warp rescales O only where a row's max moved;
//   * a key row's block is found by a multiply-high by a constant of bs
//     (fast_div) outside the table lookup's condition: the first build
//     divided by bs inside it, for every key row of every tile, and took
//     1.3-1.8x the time (PERF.md);
//   * O += P V with A = P from registers: the S accumulator fragment
//     packed into bf16 pairs is the A fragment of the product (as in
//     FlashAttention-3), and B = the V tile MN-major (hd contiguous)
//     through the transpose-B form and an MN-major descriptor over the same
//     swizzled bytes as a K tile; as wgmma m64n128k16 products over each
//     128 columns of hd and m64n64k16 over a last 64 (hd 64 and 192), into
//     their columns' part of the one m64n{hd} accumulator.  With int8, v_scale is
//     folded into P (p'_j = p_j * vs_j) before the rounding to bf16; l sums
//     the unscaled p in f32;
//   * int8 tiles: the int8 K/V rows (and their scales, 4-byte copies) land
//     in the ring; where the layout fits 227 KB (hd 64 and 128, and 192 at
//     BM 64) the threads convert tile t + 1 to bf16 (exact, |v| <= 127)
//     into the other of two swizzled operand buffers while tile t's PV
//     product runs, with one ring slot more than bf16's; at hd 192 with BM
//     128 and at hd 256 they convert tile t into one pair of buffers at the
//     top of its own iteration, behind a barrier.  Either way the proxy
//     fence before the next barrier orders those stores before the wgmma
//     reads;
//   * shared memory at hd 256: bf16 fits BM 64 only (Q 32 KB + 3 slots of
//     64 KB + 1 KB = 230,400 of 232,448 B), so plan takes BM 64 there;
//   * hd 80 (zamba2-2.7b's shared attention) is not a multiple of the
//     64-wide panels: the tiles, the q tile and the O accumulator are laid
//     out at the padded width HDP = 128, as at hd 128.  Only the 80 real
//     columns are copied (int8 rows are stored at 80 bytes and converted
//     to the 80 real columns), Q K^T runs hd / 16 = 5 k16 steps, so the
//     padding columns of Q and K are never read, and P V runs the hd-128
//     m64n128 product, whose columns 80..127 (from the unwritten padding of
//     the V tile) are never stored;
//   * epilogue: O / max(l, 1e-30) in bf16; rows past S * n_rep are not
//     written.  No atomics and no workspace: two calls give the same bits.
//
// Error against the plain version (f32 throughout): P is rounded to bf16
// before the PV product (unit roundoff 2^-8), at most 2^-8 * sum_j p_j
// |v_j| / l on an output, the mean |v| a row sees times 2^-8: ~3e-3 at
// chip_smoke.py's 512-token chunk (randn K/V), below its tolerance of one
// bf16 ulp of the largest output (5.43e-3); the rest is f32 summation order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

using namespace hopper;

constexpr int kTK = 64;                 // key positions a tile
constexpr int kStages = 3;              // ring slots (int8: one more)
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

constexpr int kSmemLimit = 232448;     // dynamic shared memory a block

// Bytes of the block's shared memory: the q tile, the bf16 operand buffers
// (K and V tiles) of an int8 arena, then the ring of K/V slots; bf16 tiles
// at the padded width kHDP (hd 80: 128).  An int8 arena converts each tile
// an iteration ahead, into the other of two operand pairs and with one
// ring slot more, where that fits (kAhead: hd 64, 80 and 128, and 192 at
// BM 64); else (hd 192 at BM 128, hd 256) into one pair,
// at the top of the tile's own iteration.  bf16 at hd 256 fits BM 64 only
// (kFits; plan in serving/paged/paged_attention.py never picks BM 128
// there, and prefill_smem_bytes mirrors these sizes).
template <int HD, int BM, typename T>
struct Layout {
  static constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  static constexpr int kThreads = 2 * BM;         // a warpgroup per 64 rows
  static constexpr int kHDP = (HD + 63) / 64 * 64;   // padded to panels
  static constexpr int kQ = BM * kHDP * 2;        // [HDP / 64][BM][64] bf16
  static constexpr int kTile = kTK * kHDP * 2;    // [HDP / 64][TK][64] bf16
  static constexpr int kRaw = kTK * HD;           // [TK][HD] int8
  // bf16: K tile, V tile; int8: K rows, V rows, 64 k and 64 v scales
  static constexpr int kSlot = kInt8 ? 2 * kRaw + 2 * kTK * 4 : 2 * kTile;
  static constexpr bool kAhead =
      kInt8 && kQ + 4 * kTile + (kStages + 1) * kSlot + 1024 <= kSmemLimit;
  static constexpr int kOpsPairs = kAhead ? 2 : 1;
  static constexpr int kOps = kInt8 ? 2 * kOpsPairs * kTile : 0;
  static constexpr int kSlots = kStages + (kAhead ? 1 : 0);
  // + 1 KB to align the base to the swizzle's 1024-byte period
  static constexpr int kTotal = kQ + kOps + kSlots * kSlot + 1024;
  static constexpr bool kFits = kTotal <= kSmemLimit;
  static_assert(kQ % 1024 == 0 && kTile % 1024 == 0, "aligned tiles");
  static_assert(HD % 16 == 0, "whole k16 steps and 16-byte chunks a row");
};

struct Args {
  const bf16* q;
  const void* k;
  const void* v;
  const float* k_scale;
  const float* v_scale;
  const int32_t* tables;
  const int32_t* cursor;
  bf16* out;
  int S, H, KV, bs, nb, n_arena, window;
  uint32_t bs_mul, bs_shr;   // j / bs as umulhi(j, bs_mul) >> bs_shr
};

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 16 int8 values as 16 bf16 (exact), in two 16-byte chunks, on the integer
// and f32 pipes instead of the conversion unit: byte e ^ 0x80 = e + 128
// permuted into the float 2^23 + (e + 128), 2^23 + 128 subtracted (exact:
// e), and the floats' high halves, which are e's exact bf16 (|e| <= 128
// has at most 8 significant bits), paired by a second permute
__device__ __forceinline__ void int8x16_to_bf16(const uint4& raw, uint4& lo,
                                                uint4& hi) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  uint32_t out[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t u = w[i] ^ 0x80808080u;
    uint32_t f[4];
#pragma unroll
    for (int b = 0; b < 4; ++b)
      f[b] = __float_as_uint(
          __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650u | b)) -
          8388736.f);
    out[2 * i] = __byte_perm(f[0], f[1], 0x7632u);
    out[2 * i + 1] = __byte_perm(f[2], f[3], 0x7632u);
  }
  lo = make_uint4(out[0], out[1], out[2], out[3]);
  hi = make_uint4(out[4], out[5], out[6], out[7]);
}

// j / bs for 0 <= j < 2^31
__device__ __forceinline__ int div_bs(const Args& a, int j) {
  return a.bs == 1 ? j : int(__umulhi(uint32_t(j), a.bs_mul) >> a.bs_shr);
}

// O += P V for one 16-key step, m64 n{HD} k16, as products of 128 columns
// (and a last of 64 at hd 192 or 64) over V's 64-wide panels, which lie kTK
// * 64 elements apart; each product accumulates into its columns' part of
// o, which is laid out as one m64n{HD} accumulator
template <int HD>
__device__ __forceinline__ void pv_step(float (&o)[HD / 2],
                                        const uint32_t (&a)[4],
                                        const bf16* v) {
#pragma unroll
  for (int p = 0; p < HD / 128; ++p)
    wgmma_rs_tb_n128(*reinterpret_cast<float(*)[64]>(o + 64 * p), a,
                     mn_desc(v + 2 * p * (kTK * 64), kTK * 128));
  if constexpr (HD % 128 != 0)
    wgmma_rs_tb_n64(*reinterpret_cast<float(*)[32]>(o + HD / 2 - 32), a,
                    mn_desc(v + (HD / 64 - 1) * (kTK * 64), kTK * 128));
}

template <int HD, int BM, typename T>
__global__ void __launch_bounds__(2 * BM, 1)
paged_prefill_kernel(const Args a) {
  using L = Layout<HD, BM, T>;
  constexpr bool INT8 = L::kInt8;
  constexpr bool AHEAD = L::kAhead;
  constexpr int NT = L::kThreads;
  constexpr int HDP = L::kHDP;
  constexpr int CPR = HD * int(sizeof(T)) / 16;   // 16-byte chunks a row
  constexpr int KCH = kTK * CPR;                  // chunks of a K tile
  constexpr int NSLOT = L::kSlots;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (static_cast<unsigned>(
      __cvta_generic_to_shared(smem_raw)) & 1023)) & 1023);
  bf16* sq = reinterpret_cast<bf16*>(smem);
  // [kOpsPairs][TK * HD] each
  bf16* k_ops = reinterpret_cast<bf16*>(smem + L::kQ);
  bf16* v_ops =
      reinterpret_cast<bf16*>(smem + L::kQ + L::kOpsPairs * L::kTile);
  auto slot = [&](int s) { return smem + L::kQ + L::kOps + s * L::kSlot; };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2;
  const int n_rep = a.H / a.KV;
  const int rows_total = a.S * n_rep;
  const int r0 = blockIdx.x * BM, kvh = blockIdx.y, b = blockIdx.z;
  const int cur = a.cursor[b];
  const int32_t* table = a.tables + size_t(b) * a.nb;
  const T* karena = static_cast<const T*>(a.k);
  const T* varena = static_cast<const T*>(a.v);

  // q tile: rows past S * n_rep are zero and never written out
  for (int it = tid; it < BM * (HD / 8); it += NT) {
    const int r = it / (HD / 8), c = (it % (HD / 8)) * 8;
    const int gr = r0 + r;
    const bool ok = gr < rows_total;
    const bf16* src = a.q;
    if (ok) {
      const int qi = gr / n_rep, h = kvh * n_rep + gr % n_rep;
      src = a.q + ((size_t(b) * a.S + qi) * a.H + h) * HD + c;
    }
    cp_async16(sq + (c >> 6) * (BM * 64) + swz(r, c & 63), src, ok);
  }

  // key positions the block's rows can see: [kv_begin, kv_end), in tiles
  // of TK from kv_begin (a multiple of TK); every row sees [full_lo,
  // full_hi], so a tile inside it needs no mask
  const int first_q = r0 / n_rep;
  const int last_q = (min(r0 + BM, rows_total) - 1) / n_rep;
  const int kv_end = min(a.nb * a.bs, cur + last_q + 1);
  int kv_begin = 0;
  if (a.window > 0) kv_begin = max(0, cur + first_q - a.window + 1) / kTK * kTK;
  const int tiles = kv_end > kv_begin ? (kv_end - kv_begin + kTK - 1) / kTK : 0;
  const int full_hi = min(cur + first_q, kv_end - 1);
  const int full_lo = a.window > 0 ? cur + last_q - a.window + 1 : 0;

  // cp.async of tile t into slot t % NSLOT: K and V rows, 16 bytes a copy,
  // each thread the same chunk of KCH / NT key rows; zero-filled rows past
  // kv_end or with a table entry outside the arena
  auto issue = [&](int t) {
    if (t >= tiles) return;
    const int j0 = kv_begin + t * kTK;
    unsigned char* base = slot(t % NSLOT);
#pragma unroll
    for (int i = 0; i < (KCH + NT - 1) / NT; ++i) {
      const int it = tid + i * NT;
      if (KCH % NT != 0 && it >= KCH) break;
      const int key = it / CPR, c = it % CPR;
      const int j = j0 + key;
      const int jb = div_bs(a, j);
      int blk = -1;
      if (j < kv_end) blk = __ldg(table + jb);
      const bool ok = blk >= 0 && blk < a.n_arena;
      const size_t row =
          ok ? (size_t(blk) * a.bs + (j - jb * a.bs)) * a.KV + kvh : 0;
      const T* ksrc = karena + row * HD + c * (16 / int(sizeof(T)));
      const T* vsrc = varena + row * HD + c * (16 / int(sizeof(T)));
      if constexpr (INT8) {
        cp_async16(base + key * HD + c * 16, ksrc, ok);
        cp_async16(base + L::kRaw + key * HD + c * 16, vsrc, ok);
      } else {
        // chunk c of key row `key`: panel c / 8, swizzled chunk c % 8
        const int off = (c >> 3) * (kTK * 128) + key * 128 +
                        (((c & 7) ^ (key & 7)) << 4);
        cp_async16(base + off, ksrc, ok);
        cp_async16(base + L::kTile + off, vsrc, ok);
      }
    }
    if constexpr (INT8) {
      if (tid < 2 * kTK) {
        const int key = tid & (kTK - 1);
        const int j = j0 + key;
        const int jb = div_bs(a, j);
        int blk = -1;
        if (j < kv_end) blk = __ldg(table + jb);
        const bool ok = blk >= 0 && blk < a.n_arena;
        const size_t row =
            ok ? (size_t(blk) * a.bs + (j - jb * a.bs)) * a.KV + kvh : 0;
        cp_async4(base + 2 * L::kRaw + tid * 4,
                  (tid < kTK ? a.k_scale : a.v_scale) + row, ok);
      }
    }
  };

  // int8: the slot's K/V rows converted to bf16 into operand buffer `buf`,
  // chunk `it` of the tile's K then V chunks
  constexpr int CH = kTK * (HD / 16);             // 16-value chunks a tile
  auto convert_chunk = [&](const unsigned char* base, int buf, int it) {
    const bool is_v = it >= CH;
    const int rem = is_v ? it - CH : it;
    const int key = rem / (HD / 16), c = (rem % (HD / 16)) * 2;
    const uint4 raw = *reinterpret_cast<const uint4*>(
        base + (is_v ? L::kRaw : 0) + key * HD + c * 8);
    uint4 lo, hi;
    int8x16_to_bf16(raw, lo, hi);
    bf16* dst = (is_v ? v_ops : k_ops) + buf * (kTK * HDP) +
                (c >> 3) * (kTK * 64) + key * 64;
    *reinterpret_cast<uint4*>(dst + ((((c & 7)) ^ (key & 7)) << 3)) = lo;
    *reinterpret_cast<uint4*>(dst + ((((c & 7) + 1) ^ (key & 7)) << 3)) = hi;
  };
  // converting in place, o is live across the conversion: two chunks in
  // flight (a full unroll hoisted every chunk's load and spilled at hd 256)
  auto convert = [&](const unsigned char* base, int buf) {
    constexpr int N = (2 * CH + NT - 1) / NT;     // hd 80 at BM 128: 2.5
    if constexpr (AHEAD) {
#pragma unroll
      for (int i = 0; i < N; ++i)
        if (2 * CH % NT == 0 || tid + i * NT < 2 * CH)
          convert_chunk(base, buf, tid + i * NT);
    } else {
#pragma unroll 2
      for (int i = 0; i < N; ++i)
        if (2 * CH % NT == 0 || tid + i * NT < 2 * CH)
          convert_chunk(base, buf, tid + i * NT);
    }
  };

  // this thread's two rows of its warpgroup's 64 (accumulator rows l / 4
  // and l / 4 + 8 of its warp's 16) and their visible key ranges
  const int wrow = wg * 64 + (warp & 3) * 16 + (lane >> 2);
  int lim[2], lo[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gr = min(r0 + wrow + 8 * h, rows_total - 1);
    const int qpos = cur + gr / n_rep;
    lim[h] = min(qpos, kv_end - 1);
    lo[h] = a.window > 0 ? qpos - a.window + 1 : 0;
  }
  const float scale = kLog2e / sqrtf(float(HD));  // scores in log2 units

  float o[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float s[32];                     // the tile's scores, then its P
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;

  // prologue: q and tile 0, then tiles 1 .. NSLOT - 2; int8 ahead converts
  // tile 0 into operand buffer 0
  issue(0);
  cp_async_commit();
#pragma unroll
  for (int u = 1; u + 1 < NSLOT; ++u) {
    issue(u);
    cp_async_commit();
  }
  if constexpr (AHEAD) {
    if (tiles > 0) {
      cp_async_wait<NSLOT - 2>();  // tile 0 (and q) has landed
      __syncthreads();
      convert(slot(0), 0);
    }
  }

  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<kStages - 2>();  // tile t (and q); int8 ahead: tile t + 1
    if constexpr (INT8 && !AHEAD) {
      __syncthreads();             // tile t landed; tile t - 1's products done
      convert(slot(t % NSLOT), 0);
    }
    fence_proxy_async();           // copies, conversions -> the wgmma's reads
    __syncthreads();               // ... for every thread; tile t - 1 done
    issue(t + NSLOT - 1);
    cp_async_commit();
    const unsigned char* base = slot(t % NSLOT);
    const int buf = AHEAD ? (t & 1) : 0;
    const bf16* kt = INT8 ? k_ops + buf * (kTK * HDP)
                          : reinterpret_cast<const bf16*>(base);
    const bf16* vt = INT8 ? v_ops + buf * (kTK * HDP)
                          : reinterpret_cast<const bf16*>(base + L::kTile);
    const int j0 = kv_begin + t * kTK;

    // S = Q K^T: 64 rows of this warpgroup by 64 keys, hd / 16 k16 steps
    // (the real columns only)
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint64_t dq =
          tile_desc(sq + (kk >> 2) * (BM * 64) + wg * 64 * 64) + 2 * (kk & 3);
      const uint64_t dk = tile_desc(kt + (kk >> 2) * (kTK * 64)) + 2 * (kk & 3);
      wgmma_n64(s, dq, dk, kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);

    // column c of this thread's part of the tile: 8 jn + 2 (l % 4) + e;
    // with int8 its k and v scales, read where they are used (kept in
    // registers for the tile, 32 of them pushed hd 256 into spills)
    const float* kscale = reinterpret_cast<const float*>(base + 2 * L::kRaw);
    const float* vscale = kscale + kTK;
    const bool masked = !(j0 >= full_lo && j0 + kTK - 1 <= full_hi);
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kNegInf;
#pragma unroll
      for (int jn = 0; jn < 8; ++jn)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * jn + 2 * h + e;
          const int c = 8 * jn + 2 * (lane & 3) + e;
          float x = s[i] * (INT8 ? scale * kscale[c] : scale);
          if (masked) {
            const int j = j0 + c;
            x = j <= lim[h] && j >= lo[h] ? x : kNegInf;
          }
          s[i] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      alpha[h] = ex2(m[h] - m_new);
      m[h] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int jn = 0; jn < 8; ++jn)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * jn + 2 * h + e;
          s[i] = ex2(s[i] - m_new);
          sum += s[i];
        }
      l[h] = l[h] * alpha[h] + sum;
    }
    // most tiles leave every row's max where it was: then no rescale
    if (__any_sync(0xFFFFFFFFu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int jn = 0; jn < HD / 8; ++jn)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          o[4 * jn + 2 * h] *= alpha[h];
          o[4 * jn + 2 * h + 1] *= alpha[h];
        }
    }

    // P (times v_scale with int8) in bf16 as the A fragments of the four
    // k16 steps: step kk covers S columns jn = 2 kk, 2 kk + 1
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int jn = 2 * kk + half;
          float p0 = s[4 * jn + 2 * h], p1 = s[4 * jn + 2 * h + 1];
          if constexpr (INT8) {
            p0 *= vscale[8 * jn + 2 * (lane & 3)];
            p1 *= vscale[8 * jn + 2 * (lane & 3) + 1];
          }
          pa[kk][2 * half + h] = pack_bf16x2(p0, p1);
        }

    // O += P V: B = the V tile, MN-major, keys 16 kk .. 16 kk + 15
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      pv_step<HDP>(o, pa[kk], vt + kk * 16 * 64);
    wgmma_commit();
    // int8 ahead: the next tile converted into the other buffer while PV
    // runs
    if constexpr (AHEAD) {
      if (t + 1 < tiles) convert(slot((t + 1) % NSLOT), (t + 1) & 1);
    }
    wgmma_wait0();
    fence_regs(o);
  }
  cp_async_wait<0>();

  // epilogue: the quad's partial sums, O / max(l, 1e-30) in bf16
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xFFFFFFFFu, l[h], 1);
    l[h] += __shfl_xor_sync(0xFFFFFFFFu, l[h], 2);
    const int gr = r0 + wrow + 8 * h;
    if (gr >= rows_total) continue;
    const int qi = gr / n_rep, hh = kvh * n_rep + gr % n_rep;
    const float denom = fmaxf(l[h], 1e-30f);
    bf16* dst = a.out + ((size_t(b) * a.S + qi) * a.H + hh) * HD +
                2 * (lane & 3);
#pragma unroll
    for (int jn = 0; jn < HD / 8; ++jn)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * jn) =
          __floats2bfloat162_rn(o[4 * jn + 2 * h] / denom,
                                o[4 * jn + 2 * h + 1] / denom);
  }
}

template <int HD, int BM, typename T>
int launch(const Args& a, int B, cudaStream_t stream) {
  using L = Layout<HD, BM, T>;
  static_assert(L::kFits, "the layout exceeds the block's shared memory");
  auto kernel = paged_prefill_kernel<HD, BM, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kTotal);
  if (err != cudaSuccess) return int(err);
  const int rows = a.S * (a.H / a.KV);
  const dim3 grid((rows + BM - 1) / BM, a.KV, B);
  kernel<<<grid, L::kThreads, L::kTotal, stream>>>(a);
  return int(cudaGetLastError());
}

// BM 128 only where its layout fits on bf16 and int8 arenas alike (not at
// hd 256), as plan chooses it
template <int HD, typename T>
int launch_tile(const Args& a, int B, int bm, cudaStream_t stream) {
  if (bm == 64) return launch<HD, 64, T>(a, B, stream);
  if constexpr (Layout<HD, 128, bf16>::kFits &&
                Layout<HD, 128, int8_t>::kFits)
    return launch<HD, 128, T>(a, B, stream);
  return int(cudaErrorInvalidValue);
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, const void* ks,
              const void* vs, const void* tables, const void* cursor,
              void* out, int B, int S, int H, int KV, int hd, int bs, int nb,
              int n_arena, int window, int bm, void* stream) {
  if ((hd != 64 && hd != 80 && hd != 128 && hd != 192 && hd != 256) ||
      (bm != 64 && bm != 128) || B < 1 ||
      S < 1 || KV < 1 || H % KV || bs < 1 || nb < 1)
    return int(cudaErrorInvalidValue);
  Args a{static_cast<const bf16*>(q), k, v,
         static_cast<const float*>(ks), static_cast<const float*>(vs),
         static_cast<const int32_t*>(tables),
         static_cast<const int32_t*>(cursor), static_cast<bf16*>(out),
         S, H, KV, bs, nb, n_arena, window, 0u, 0u};
  fast_div(bs, a.bs_mul, a.bs_shr);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return launch_tile<64, T>(a, B, bm, st);
    case 80: return launch_tile<80, T>(a, B, bm, st);
    case 128: return launch_tile<128, T>(a, B, bm, st);
    case 192: return launch_tile<192, T>(a, B, bm, st);
    default: return launch_tile<256, T>(a, B, bm, st);
  }
}

}  // namespace

// The wrapper (serving/paged/paged_attention.py) checks device, dtype,
// shapes, contiguity and alignment (q and the arenas 16-byte aligned), that
// hd is 64, 80, 128, 192 or 256, bs a multiple of 8 and H a multiple of KV,
// and passes its plan: `bm` rows a block (64 or 128; 64 only at hd 256 on a
// bf16 arena).
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// a plan it does not take.
extern "C" int paged_attention_prefill_bf16(
    const void* q, const void* k, const void* v, const void* tables,
    const void* cursor, void* out, int B, int S, int H, int KV, int hd, int bs,
    int nb, int n_arena, int window, int bm, void* stream) {
  return launch_hd<bf16>(q, k, v, nullptr, nullptr, tables, cursor, out, B, S,
                         H, KV, hd, bs, nb, n_arena, window, bm, stream);
}

extern "C" int paged_attention_prefill_int8(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* tables, const void* cursor, void* out,
    int B, int S, int H, int KV, int hd, int bs, int nb, int n_arena,
    int window, int bm, void* stream) {
  return launch_hd<int8_t>(q, k, v, k_scale, v_scale, tables, cursor, out, B,
                           S, H, KV, hd, bs, nb, n_arena, window, bm, stream);
}
