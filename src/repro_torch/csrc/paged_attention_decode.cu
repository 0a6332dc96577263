// Paged attention for Hopper (sm_90a), decode body: causal, length-masked
// GQA attention of a few query rows per lane over KV blocks found through a
// block table, with each lane's keys split across blocks (split-KV, as
// FlashDecoding) and the partial softmaxes merged in split order.
//
// Replaces, for S * n_rep <= T rows (T, the threshold, in
// serving/paged/paged_attention.py), the Pallas TPU kernel
//   paged_attention_pallas  src/repro/serving/paged/paged_attention.py:180
//                           (_paged_attn_kernel :122, its quantized branch
//                           :124-130 and :147-149)
// (csrc/paged_attention_prefill.cu serves rows > T).  It computes what the
// Pallas kernel computes: query i of lane b sits at position cursor[b] + i
// and sees positions j <= cursor[b] + i (and j > cursor[b] + i - window
// when window > 0); position j's K/V is row j % bs of physical block
// tables[b, j / bs], and a table entry outside [0, n_arena) reads as zero;
// q head h reads KV head h / n_rep; scores are scaled by 1/sqrt(hd) in f32;
// masked scores are the finite -1e30 and the final sum is clamped at
// 1e-30; out is bf16.  int8 arenas dequantize position j of KV head h as
// int8 * scale[j, h] (f32 scales [n_blocks, bs, KV] found through the same
// table entry).
//
// Layout (bf16 unless stated; the wrapper checks it):
//   q        [B, S, H, hd]
//   k, v     [n_blocks, bs, KV, hd]   one layer's arena (bf16 or int8)
//   k_scale, v_scale [n_blocks, bs, KV] f32   int8 arenas only
//   tables   [B, nb] int32
//   cursor   [B] int32
//   out      [B, S, H, hd]
//   ws       [B, KV, row tiles, splits, R, hd + 2] f32 partials (splits > 1)
//   counters [B, KV, row tiles] int32, 0 between launches
//
// Bound on an H100 SXM (3.35 TB/s): bytes.  A decode step reads every KV
// block its lanes have written once, bs * KV * hd * 2 B * 2 a block (int8:
// hd + 4 B a position and KV head, K and V): 13.6 MB, 4.1 us, for
// llama3-8b's 8 lanes at cursors 15..1000 (int8 2.1 us).  The products,
// 4 * H * hd multiply-adds a visible key, are ~1/80 of the bytes' time on
// the tensor cores.
//
// Design:
//   * grid (splits x row tiles, KV, B), fixed by the shapes (B, S, H, KV,
//     hd, bs, nb) and never by the cursors, so the host needs no cursor
//     value and a launch can be captured in a CUDA graph.  Split s covers
//     the keys [s * kSpan, (s + 1) * kSpan) of the lane's nb * bs, so a
//     lane has ceil(nb * bs / kSpan) splits; a block
//     whose span lies wholly past its rows' last visible key, or before the
//     window, returns at once.  Each block computes, from cursor[b], how
//     many splits of its (lane, KV head, row tile) are live; only those
//     arrive at the tile's counter;
//   * a row is a (query, rep) pair, flattened as in the prefill body (row r
//     is query r / n_rep of q head kvh * n_rep + r % n_rep); a block takes
//     R = 4 or 8 rows of one KV head, so each K/V byte is read once per KV
//     head; a larger S tiles its rows over the grid;
//   * 64-key tiles gathered key row by key row through the table with
//     16-byte cp.async into a ring of kStages slots, so the next tile's
//     bytes are in flight while this one computes; rows past the visible
//     end or behind an out-of-arena entry are zero-filled (a copy of 0
//     bytes); with int8 each row's k and v scales ride with it (4-byte
//     copies).  A K row is padded by 32 bytes so that the score lanes'
//     16-byte loads of 4 key rows fall in 8 distinct bank groups;
//   * both products on the CUDA cores in f32, straight from the bf16 or
//     int8 tile (int8 converted exactly by byte permutes and an f32 add);
//     at R = 4 rows a tensor-core tile would waste 60 of its 64 rows, and
//     the bound is bytes.  Scores: a lane pair takes one key, each lane
//     half of hd (interleaved 16-byte chunks; at hd 80 an int8 row is 5
//     chunks, the even lane takes 3 and the odd 2), for all R rows, summed
//     by one shuffle; 1/sqrt(hd) in log2 units (and with int8 the key's
//     k_scale) scales the f32 sum.  Softmax: a warp per row, a running max
//     and sum per row in f32, exp2; with int8 v_scale is folded into P
//     (l sums the unscaled p).  P V: a thread takes 4 columns and every
//     G-th key (G key groups of hd / 4 threads, the largest power of two
//     of them that fits 128 threads, so G divides a tile's 64 keys: 8, 4,
//     4, 2 and 2 at hd 64, 80, 128, 192 and 256; at hd 80 the last 48
//     threads and at hd 192 the last 32 have no group and idle), the
//     groups' sums added in group order after the split's last tile;
//   * combine: a split that is its tile's only live one writes O / max(l,
//     1e-30) itself; otherwise each live split writes (acc, m, l) in f32
//     to the workspace and the last to arrive merges them in split order
//     (splitk::merge_softmax_splits, csrc/split_reduce.cuh), with no float
//     atomics, and resets the counter: two calls give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "split_reduce.cuh"

typedef __nv_bfloat16 bf16;

namespace {

using namespace hopper;

constexpr int kThreads = 128;
constexpr int kTK = 64;                 // key positions a tile
constexpr int kStages = 2;              // ring slots
constexpr int kSpan = 128;              // keys a split (DECODE_SPAN)
static_assert(kSpan % kTK == 0, "whole tiles a split");
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Bytes of the block's shared memory: the ring of K/V slots (after the
// split's last tile, the key groups' P V sums), then q in f32, the scores
// [R][TK], the probabilities [TK][R] and three [R] rows (alpha, m, l).
template <int HD, int R, typename T>
struct Layout {
  static constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  static constexpr int kEPC = 16 / int(sizeof(T));     // elements a chunk
  static constexpr int kCPR = HD / kEPC;               // chunks a key row
  static constexpr int kCopies = (kTK * kCPR + kThreads - 1) / kThreads;
  static constexpr int kKRow = HD * int(sizeof(T)) + 32;  // padded K row
  static constexpr int kVRow = HD * int(sizeof(T));
  static constexpr int kScales = kTK * (kKRow + kVRow);   // int8: k, v scales
  static constexpr int kSlot = kScales + (kInt8 ? 2 * kTK * 4 : 0);
  // P V key groups of HD / 4 threads, a power of two of them (whole keys
  // a group); at hd 80 the last 48 threads and at hd 192 the last 32 have
  // no group and skip the product
  static constexpr int kGroupsFit = kThreads / (HD / 4);
  static constexpr int kGroups = kGroupsFit >= 8   ? 8
                                 : kGroupsFit >= 4 ? 4
                                 : kGroupsFit >= 2 ? 2
                                                   : 1;
  static constexpr int kRing = kStages * kSlot;
  static constexpr int kRed = kGroups * R * HD * 4;
  static constexpr int kFront = kRing > kRed ? kRing : kRed;
  static constexpr int kTotal = kFront + 4 * (R * HD + 2 * R * kTK + 3 * R);
  static_assert(HD % kEPC == 0 && HD % 16 == 0, "whole chunks a row");
  static_assert(R % 4 == 0 && kSlot % 16 == 0, "aligned rows");
  static_assert(kThreads == 2 * kTK, "a thread a scale");
  static_assert(kGroups >= 1 && kTK % kGroups == 0, "whole keys a group");
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
  float* ws;
  int* counters;
  int S, H, KV, bs, nb, n_arena, window, splits, tiles;
  uint32_t bs_mul, bs_shr;   // j / bs as umulhi(j, bs_mul) >> bs_shr
};

// j / bs for 0 <= j < 2^31
__device__ __forceinline__ int div_bs(const Args& a, int j) {
  return a.bs == 1 ? j : int(__umulhi(uint32_t(j), a.bs_mul) >> a.bs_shr);
}

// four int8 values (one word) as exact floats: byte e ^ 0x80 = e + 128
// permuted into the float 2^23 + (e + 128), 2^23 + 128 subtracted
__device__ __forceinline__ void int8x4_to_f32(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    f[b] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650u | b)) -
           8388736.f;
}

// two bf16 values (one word) as floats
__device__ __forceinline__ void bf16x2_to_f32(uint32_t w, float* f) {
  f[0] = __uint_as_float(w << 16);
  f[1] = __uint_as_float(w & 0xFFFF0000u);
}

// a 16-byte chunk of a K row as kEPC floats
template <typename T>
__device__ __forceinline__ void chunk_to_f32(const uint4& raw, float* f) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (std::is_same<T, int8_t>::value)
      int8x4_to_f32(w[i], f + 4 * i);
    else
      bf16x2_to_f32(w[i], f + 2 * i);
  }
}

// At least 2 blocks an SM (the ring's shared memory allows 2 at hd 128 and
// above): without a minimum ptxas capped hd 192 at R = 4 to 96 registers and
// kept a value on the stack; with it no instance spills (107-168 registers)
template <int HD, int R, typename T>
__global__ void __launch_bounds__(kThreads, 2)
paged_decode_kernel(const Args a) {
  using L = Layout<HD, R, T>;
  constexpr bool INT8 = L::kInt8;
  constexpr int EPC = L::kEPC, CPR = L::kCPR, G = L::kGroups;
  extern __shared__ __align__(128) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem);          // [G][R][HD]
  float* sq = reinterpret_cast<float*>(smem + L::kFront);  // [R][HD]
  float* ss = sq + R * HD;                              // [R][TK]
  float* sp = ss + R * kTK;                             // [TK][R]
  float* salpha = sp + kTK * R;                         // [R]
  float* sm = salpha + R;                               // [R]
  float* sl = sm + R;                                   // [R]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x % a.splits, tile = blockIdx.x / a.splits;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int n_rep = a.H / a.KV;
  const int rows_total = a.S * n_rep;
  const int r0 = tile * R;
  const int cur = a.cursor[b];

  // keys the tile's rows can see, [kv_begin, kv_end), and its live splits
  // [s_lo, s_hi]; an empty range (a window past nb * bs) leaves one split
  // with no tile, which writes zeros
  const int first_q = r0 / n_rep;
  const int last_q = (min(r0 + R, rows_total) - 1) / n_rep;
  const int kv_end = min(a.nb * a.bs, cur + last_q + 1);
  int kv_begin = 0;
  if (a.window > 0) kv_begin = max(0, cur + first_q - a.window + 1);
  const int s_hi = (kv_end - 1) / kSpan;
  const int s_lo = min(kv_begin / kSpan, s_hi);
  if (split < s_lo || split > s_hi) return;
  const int live = s_hi - s_lo + 1;
  const int j_lo = max(split * kSpan, kv_begin / kTK * kTK);
  const int j_hi = min((split + 1) * kSpan, kv_end);
  const int tiles = j_hi > j_lo ? (j_hi - j_lo + kTK - 1) / kTK : 0;

  const int32_t* table = a.tables + size_t(b) * a.nb;
  const T* karena = static_cast<const T*>(a.k);
  const T* varena = static_cast<const T*>(a.v);

  // cp.async of tile t into slot t % kStages: 16-byte chunk c of key row
  // `key`, of K and of V, a thread's chunks kThreads apart; zero-filled rows
  // past kv_end or with a table entry outside the arena; with int8 thread i
  // copies key i's k scale (i < 64) or key i - 64's v scale
  auto issue = [&](int t) {
    if (t >= tiles) return;
    const int j0 = j_lo + t * kTK;
    unsigned char* base = smem + (t % kStages) * L::kSlot;
#pragma unroll
    for (int i = 0; i < L::kCopies; ++i) {
      const int it = tid + i * kThreads;
      if (kTK * CPR % kThreads != 0 && it >= kTK * CPR) break;
      const int key = it / CPR, c = it % CPR;
      const int j = j0 + key;
      const int jb = div_bs(a, j);
      int blk = -1;
      if (j < kv_end) blk = __ldg(table + jb);
      const bool ok = blk >= 0 && blk < a.n_arena;
      const size_t row =
          ok ? (size_t(blk) * a.bs + (j - jb * a.bs)) * a.KV + kvh : 0;
      cp_async16(base + key * L::kKRow + c * 16, karena + row * HD + c * EPC,
                 ok);
      cp_async16(base + kTK * L::kKRow + key * L::kVRow + c * 16,
                 varena + row * HD + c * EPC, ok);
    }
    if constexpr (INT8) {
      const int key = tid & (kTK - 1);
      const int j = j0 + key;
      const int jb = div_bs(a, j);
      int blk = -1;
      if (j < kv_end) blk = __ldg(table + jb);
      const bool ok = blk >= 0 && blk < a.n_arena;
      const size_t row =
          ok ? (size_t(blk) * a.bs + (j - jb * a.bs)) * a.KV + kvh : 0;
      cp_async4(base + L::kScales + tid * 4,
                (tid < kTK ? a.k_scale : a.v_scale) + row, ok);
    }
  };

  // prologue: tiles 0 .. kStages - 2 in flight, then q (rows past S *
  // n_rep are zero and never written out) in f32
#pragma unroll
  for (int u = 0; u + 1 < kStages; ++u) {
    issue(u);
    cp_async_commit();
  }
  for (int it = tid; it < R * (HD / 8); it += kThreads) {
    const int r = it / (HD / 8), c = (it % (HD / 8)) * 8;
    const int gr = r0 + r;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (gr < rows_total) {
      const int qi = gr / n_rep, h = kvh * n_rep + gr % n_rep;
      raw = *reinterpret_cast<const uint4*>(
          a.q + ((size_t(b) * a.S + qi) * a.H + h) * HD + c);
    }
    float f[8];
    chunk_to_f32<bf16>(raw, f);
    reinterpret_cast<float4*>(sq + r * HD + c)[0] =
        make_float4(f[0], f[1], f[2], f[3]);
    reinterpret_cast<float4*>(sq + r * HD + c)[1] =
        make_float4(f[4], f[5], f[6], f[7]);
  }

  // scores: lane pair (key, h), h takes chunks h, h + 2, ... of hd
  const int qk_key = warp * 16 + (lane >> 1), qk_h = lane & 1;
  // P V: 4 columns, keys kg, kg + G, ...; threads with kg >= G idle there
  const int cq = tid % (HD / 4), kg = tid / (HD / 4);
  const bool pv = kg < G;
  const float scale = kLog2e / sqrtf(float(HD));  // scores in log2 units

  float m[R / 4], l[R / 4];          // this warp's rows warp + 4 i
#pragma unroll
  for (int i = 0; i < R / 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  float acc[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<kStages - 2>();    // tile t has landed
    __syncthreads();                 // ... for every thread; tile t - 1 done
    issue(t + kStages - 1);
    cp_async_commit();
    const unsigned char* base = smem + (t % kStages) * L::kSlot;
    const int j0 = j_lo + t * kTK;

    // S = q K^T for the R rows and this lane pair's key
    {
      float s[R];
#pragma unroll
      for (int r = 0; r < R; ++r) s[r] = 0.f;
      const unsigned char* krow = base + qk_key * L::kKRow;
#pragma unroll
      for (int c = 0; c < (CPR + 1) / 2; ++c) {
        const int ch = 2 * c + qk_h;
        if (CPR % 2 != 0 && ch >= CPR) break;   // odd: the even lane's last
        float kf[EPC];
        chunk_to_f32<T>(*reinterpret_cast<const uint4*>(krow + ch * 16), kf);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4* qr =
              reinterpret_cast<const float4*>(sq + r * HD + ch * EPC);
#pragma unroll
          for (int e = 0; e < EPC / 4; ++e) {
            const float4 qv = qr[e];
            s[r] = fmaf(qv.x, kf[4 * e], s[r]);
            s[r] = fmaf(qv.y, kf[4 * e + 1], s[r]);
            s[r] = fmaf(qv.z, kf[4 * e + 2], s[r]);
            s[r] = fmaf(qv.w, kf[4 * e + 3], s[r]);
          }
        }
      }
      float cs = scale;
      if constexpr (INT8)
        cs *= reinterpret_cast<const float*>(base + L::kScales)[qk_key];
#pragma unroll
      for (int r = 0; r < R; ++r) s[r] += __shfl_xor_sync(kFull, s[r], 1);
#pragma unroll
      for (int i = 0; i < R / 2; ++i)   // h = 0 the first R / 2 rows
        ss[(qk_h * (R / 2) + i) * kTK + qk_key] =
            (qk_h ? s[R / 2 + i] : s[i]) * cs;
    }
    __syncthreads();

    // online softmax: warp w takes rows w, w + 4; lane keys lane, lane + 32
#pragma unroll
    for (int i = 0; i < R / 4; ++i) {
      const int r = warp + 4 * i;
      const int qpos = cur + min(r0 + r, rows_total - 1) / n_rep;
      const int lim = min(qpos, kv_end - 1);
      const int lo = a.window > 0 ? qpos - a.window + 1 : 0;
      float x[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = j0 + lane + 32 * e;
        x[e] = j <= lim && j >= lo ? ss[r * kTK + lane + 32 * e] : kNegInf;
      }
      float mx = fmaxf(x[0], x[1]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = ex2(m[i] - m_new);
      const float p0 = ex2(x[0] - m_new), p1 = ex2(x[1] - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(kFull, sum, o);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
      float v0 = 1.f, v1 = 1.f;
      if constexpr (INT8) {
        const float* vs =
            reinterpret_cast<const float*>(base + L::kScales) + kTK;
        v0 = vs[lane];
        v1 = vs[lane + 32];
      }
      sp[lane * R + r] = p0 * v0;
      sp[(lane + 32) * R + r] = p1 * v1;
      if (lane == 0) salpha[r] = alpha;
    }
    __syncthreads();

    // O = O * alpha + P V over this thread's keys and columns
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float al = salpha[r];
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] *= al;
    }
    const unsigned char* vt = base + kTK * L::kKRow;
#pragma unroll 4
    for (int i = 0; i < (pv ? kTK / G : 0); ++i) {
      const int key = kg + G * i;
      float vf[4];
      if constexpr (INT8) {
        int8x4_to_f32(*reinterpret_cast<const uint32_t*>(
                          vt + key * L::kVRow + cq * 4), vf);
      } else {
        const uint2 w = *reinterpret_cast<const uint2*>(
            vt + key * L::kVRow + cq * 8);
        bf16x2_to_f32(w.x, vf);
        bf16x2_to_f32(w.y, vf + 2);
      }
#pragma unroll
      for (int r4 = 0; r4 < R / 4; ++r4) {
        const float4 p = reinterpret_cast<const float4*>(sp + key * R)[r4];
        const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[4 * r4 + u][c] = fmaf(pr[u], vf[c], acc[4 * r4 + u][c]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                   // the ring is free for the group sums

  if (pv) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      reinterpret_cast<float4*>(red + (kg * R + r) * HD)[cq] =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < R / 4; ++i) {
      sm[warp + 4 * i] = m[i];
      sl[warp + 4 * i] = l[i];
    }
  }
  __syncthreads();

  // the key groups' sums in group order: this split's acc; its only live
  // split writes O / max(l, 1e-30), the others go to the workspace
  auto out_row = [&](int r) -> bf16* {
    const int gr = r0 + r;
    if (gr >= rows_total) return nullptr;
    const int qi = gr / n_rep, h = kvh * n_rep + gr % n_rep;
    return a.out + ((size_t(b) * a.S + qi) * a.H + h) * HD;
  };
  const size_t part_floats = size_t(R) * (HD + 2);
  float* tile_ws =
      a.ws + ((size_t(b) * a.KV + kvh) * a.tiles + tile) * a.splits *
                 part_floats;
  float* part = tile_ws + split * part_floats;
  for (int o = tid; o < R * HD / 4; o += kThreads) {
    const int r = o / (HD / 4), d = 4 * (o % (HD / 4));
    float4 sum = reinterpret_cast<const float4*>(red + r * HD + d)[0];
#pragma unroll
    for (int g = 1; g < G; ++g) {
      const float4 x = reinterpret_cast<const float4*>(
          red + (g * R + r) * HD + d)[0];
      sum.x += x.x;
      sum.y += x.y;
      sum.z += x.z;
      sum.w += x.w;
    }
    if (live == 1) {
      bf16* dst = out_row(r);
      if (dst != nullptr) {
        const float den = fmaxf(sl[r], 1e-30f);
        *reinterpret_cast<uint2*>(dst + d) =
            make_uint2(splitk::pack_bf16x2(sum.x / den, sum.y / den),
                       splitk::pack_bf16x2(sum.z / den, sum.w / den));
      }
    } else {
      reinterpret_cast<float4*>(part + r * HD + d)[0] = sum;
    }
  }
  if (live == 1) return;
  if (tid < R) {
    part[R * HD + tid] = sm[tid];
    part[R * HD + R + tid] = sl[tid];
  }
  splitk::merge_softmax_splits(
      tile_ws + s_lo * part_floats,
      a.counters + (size_t(b) * a.KV + kvh) * a.tiles + tile, live, R, HD,
      out_row, kThreads);
}

template <int HD, int R, typename T>
int launch(const Args& a, int B, cudaStream_t stream) {
  using L = Layout<HD, R, T>;
  auto kernel = paged_decode_kernel<HD, R, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kTotal);
  if (err != cudaSuccess) return int(err);
  const dim3 grid(a.splits * a.tiles, a.KV, B);
  kernel<<<grid, kThreads, L::kTotal, stream>>>(a);
  return int(cudaGetLastError());
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, const void* ks,
              const void* vs, const void* tables, const void* cursor,
              void* out, void* ws, void* counters, int B, int S, int H,
              int KV, int hd, int bs, int nb, int n_arena, int window,
              int rows, void* stream) {
  if ((hd != 64 && hd != 80 && hd != 128 && hd != 192 && hd != 256) ||
      (rows != 4 && rows != 8) || B < 1 ||
      S < 1 || KV < 1 || H % KV || bs < 1 || nb < 1 ||
      int64_t(nb) * bs > 0x7FFFFFFF - kSpan)
    return int(cudaErrorInvalidValue);
  const int splits = (nb * bs + kSpan - 1) / kSpan;
  const int tiles = (S * (H / KV) + rows - 1) / rows;
  if (int64_t(splits) * tiles > 0x7FFFFFFF) return int(cudaErrorInvalidValue);
  Args a{static_cast<const bf16*>(q), k, v,
         static_cast<const float*>(ks), static_cast<const float*>(vs),
         static_cast<const int32_t*>(tables),
         static_cast<const int32_t*>(cursor), static_cast<bf16*>(out),
         static_cast<float*>(ws), static_cast<int*>(counters),
         S, H, KV, bs, nb, n_arena, window, splits, tiles, 0u, 0u};
  fast_div(bs, a.bs_mul, a.bs_shr);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return rows == 4 ? launch<64, 4, T>(a, B, st)
                       : launch<64, 8, T>(a, B, st);
    case 80:
      return rows == 4 ? launch<80, 4, T>(a, B, st)
                       : launch<80, 8, T>(a, B, st);
    case 128:
      return rows == 4 ? launch<128, 4, T>(a, B, st)
                       : launch<128, 8, T>(a, B, st);
    case 192:
      return rows == 4 ? launch<192, 4, T>(a, B, st)
                       : launch<192, 8, T>(a, B, st);
    default:
      return rows == 4 ? launch<256, 4, T>(a, B, st)
                       : launch<256, 8, T>(a, B, st);
  }
}

}  // namespace

// The wrapper (serving/paged/paged_attention.py) checks device, dtype,
// shapes, contiguity and alignment (q and the arenas 16-byte aligned), that
// hd is 64, 80, 128, 192 or 256, bs a multiple of 8 and H a multiple of
// KV, and passes its plan: `rows` a block (4 or 8), and the workspace and
// counters it sized for ceil(nb * bs / kSpan) splits of each lane's keys.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// a plan it does not take.
extern "C" int paged_attention_decode_bf16(
    const void* q, const void* k, const void* v, const void* tables,
    const void* cursor, void* out, void* ws, void* counters, int B, int S,
    int H, int KV, int hd, int bs, int nb, int n_arena, int window, int rows,
    void* stream) {
  return launch_hd<bf16>(q, k, v, nullptr, nullptr, tables, cursor, out, ws,
                         counters, B, S, H, KV, hd, bs, nb, n_arena, window,
                         rows, stream);
}

extern "C" int paged_attention_decode_int8(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* tables, const void* cursor, void* out,
    void* ws, void* counters, int B, int S, int H, int KV, int hd, int bs,
    int nb, int n_arena, int window, int rows, void* stream) {
  return launch_hd<int8_t>(q, k, v, k_scale, v_scale, tables, cursor, out, ws,
                           counters, B, S, H, KV, hd, bs, nb, n_arena, window,
                           rows, stream);
}
