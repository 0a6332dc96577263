// Paged attention for Hopper (sm_90a): causal, length-masked GQA attention
// of S fresh queries per lane over KV blocks found through a block table.
//
// The port's first kernel for paged attention, kept to be timed only: the
// wrapper (serving/paged/paged_attention.py) launches it when a caller
// forces Plan("tile"), and its plan never picks it.  Decode steps run the
// split-KV decode body (csrc/paged_attention_decode.cu) and prefill chunks
// the prefill-chunk body (csrc/paged_attention_prefill.cu).
//
// Replaces the Pallas TPU kernel
//   paged_attention_pallas  src/repro/serving/paged/paged_attention.py:180
//                           (_paged_attn_kernel :122, its quantized branch
//                           :124-130 and :147-149)
// with one template over the arena's element type T: bf16 arenas, or int8
// arenas whose position j of KV head h dequantizes as int8 * scale[j, h]
// (f32 scales [n_blocks, bs, KV], found through the same table entry as the
// values and applied as the tile is staged into shared memory, inside the
// online softmax).  It computes what the Pallas kernel computes: query i
// of lane b sits at position cursor[b] + i and sees positions
// j <= cursor[b] + i (and j > cursor[b] + i - window when window > 0);
// position j's K/V is row j % bs of physical block tables[b, j / bs]; q is
// scaled by 1/sqrt(hd) in f32; q head h reads KV head h / n_rep; an online
// softmax keeps a running max, sum and accumulator in f32 and out is
// written in bf16.  Masked scores are the finite -1e30 and the final sum
// is clamped at 1e-30, as in the Pallas kernel, so padded rows give finite
// values, never NaN.
//
// Layout (bf16 unless stated; the wrapper serving/paged/paged_attention.py
// checks it):
//   q       [B, S, H, hd]
//   k, v    [n_blocks, bs, KV, hd]   one layer's arena (bf16 or int8)
//   k_scale, v_scale [n_blocks, bs, KV] f32   int8 arenas only
//   tables  [B, nb] int32            physical block of each bs-token page
//   cursor  [B] int32
//   out     [B, S, H, hd]
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): bytes.  Every
// KV block a lane has written must be read once (bs * KV * hd * 2 B * 2 per
// block), plus q and out.  A llama3-8b decode step over 8 lanes of ~500
// tokens reads 16 MB a layer, 5 us; int8 arenas read 132 B per (position,
// KV head) of K or V instead of 256 B, so 8.3 MB, 2.5 us.  Only a long
// prefill chunk is bound by
// operations: 4 * B * H * S * T * hd (S = 512 at T = 1280: 10.7 GFLOP,
// 11 us on the tensor cores).
//
// Design, the simple correct one first:
//   * one block of 128 threads per (tile of query rows, KV head, lane); a
//     row is a (query, rep) pair, so the n_rep q heads that share a KV head
//     live in one block and each KV tile is read once per KV head, not
//     n_rep times (the head-tiled decomposition of the Pallas kernel);
//   * a loop inside the block over the lane's key positions, TK (8 or 16,
//     dividing bs) at a time, takes the place of the TPU's sequential nb
//     grid axis.  It stops at the last position the tile's queries can see,
//     ceil((cursor + S) / bs) blocks at most, and starts at the window's
//     first block, where the Pallas grid walks all nb blocks;
//   * the block reads its own table entries (no scalar prefetch) and loads
//     the next K/V tile into registers while it computes on the current one;
//     a 16-byte load carries 8 bf16 or 16 int8 elements, and with int8 each
//     thread also loads the scale of the row its chunk belongs to (the
//     chunks of one row share a cache line of scales);
//   * scores and PV run on the CUDA cores in f32 from shared memory: each
//     warp owns RPW rows (1, 4 or 16, picked from S * n_rep so decode wastes
//     no lanes), keeps their running max and sum in registers and their
//     accumulators spread over its lanes (hd / 32 columns a lane).  Query
//     rows are tiled, so a 512-token chunk never holds all of S at once.
//   Decode launches B * KV blocks and is latency-bound well short of the
//   memory bound; tensor cores (mma/wgmma), TMA and split-KV for long
//   decode contexts are later changes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr float NEG_INF = -1e30f;

template <int HD, int RPW, int TK, typename T>
struct Geometry {
  static constexpr int R = NWARPS * RPW;                  // rows per block
  static constexpr int LPR = 32 / RPW;                    // lanes per row (scores)
  static constexpr int KPL = LPR <= TK ? TK / LPR : 1;    // keys per lane
  static constexpr int DS = LPR <= TK ? 1 : LPR / TK;     // lanes sharing one key
  static constexpr int QS = HD + 4;                       // q row stride (floats)
  static constexpr int KS = HD + 4;                       // k row stride
  static constexpr int EPC = 16 / sizeof(T);              // elements per 16-byte chunk
  static constexpr int NCH = TK * HD / EPC;               // 16-byte chunks per K tile
  static constexpr int CPT = (2 * NCH + NTHREADS - 1) / NTHREADS;
  static constexpr int CPL = HD / 32;                     // out columns per lane
  static constexpr size_t SMEM =
      sizeof(float) * (size_t(R) * QS + TK * KS + TK * HD + R * TK + 2 * R);
  static_assert(KPL * LPR == TK * DS, "score lanes cover the key tile");
  static_assert(HD % (4 * DS) == 0, "float4 steps split evenly");
};

__device__ __forceinline__ void bf16x8_to_f32(const uint4& raw, float scale,
                                              float* dst) {
  const bf16* e = reinterpret_cast<const bf16*>(&raw);
  float4 lo, hi;
  lo.x = __bfloat162float(e[0]) / scale;
  lo.y = __bfloat162float(e[1]) / scale;
  lo.z = __bfloat162float(e[2]) / scale;
  lo.w = __bfloat162float(e[3]) / scale;
  hi.x = __bfloat162float(e[4]) / scale;
  hi.y = __bfloat162float(e[5]) / scale;
  hi.z = __bfloat162float(e[6]) / scale;
  hi.w = __bfloat162float(e[7]) / scale;
  reinterpret_cast<float4*>(dst)[0] = lo;
  reinterpret_cast<float4*>(dst)[1] = hi;
}

// 16 int8 elements, sign-extended, times their row's scale
__device__ __forceinline__ void int8x16_to_f32(const uint4& raw, float scale,
                                               float* dst) {
  const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float4 f;
    f.x = static_cast<float>(e[4 * i + 0]) * scale;
    f.y = static_cast<float>(e[4 * i + 1]) * scale;
    f.z = static_cast<float>(e[4 * i + 2]) * scale;
    f.w = static_cast<float>(e[4 * i + 3]) * scale;
    reinterpret_cast<float4*>(dst)[i] = f;
  }
}

template <int HD, int RPW, int TK, typename T>
__global__ void __launch_bounds__(NTHREADS)
paged_attention_kernel(const bf16* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale,
                       const int32_t* __restrict__ tables,
                       const int32_t* __restrict__ cursor,
                       bf16* __restrict__ out, int S, int H, int KV, int bs,
                       int nb, int n_arena, int window) {
  using G = Geometry<HD, RPW, TK, T>;
  constexpr bool INT8 = std::is_same<T, int8_t>::value;
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;                         // [R][QS]   q / sqrt(hd)
  float* sk = sq + G::R * G::QS;            // [TK][KS]
  float* sv = sk + TK * G::KS;              // [TK][HD]
  float* sp = sv + TK * HD;                 // [R][TK]   probabilities
  float* salpha = sp + G::R * TK;           // [R]       rescale of this tile
  float* sl = salpha + G::R;                // [R]       final sums

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_rep = H / KV;
  const int rows_total = S * n_rep;
  const int r0 = blockIdx.x * G::R;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int cur = cursor[b];
  const float sqrt_hd = sqrtf(float(HD));

  // q tile; rows past S * n_rep are zero and never written out
  for (int it = tid; it < G::R * (HD / 8); it += NTHREADS) {
    const int r = it / (HD / 8), c = (it % (HD / 8)) * 8;
    const int gr = r0 + r;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (gr < rows_total) {
      const int qi = gr / n_rep, h = kvh * n_rep + gr % n_rep;
      raw = *reinterpret_cast<const uint4*>(
          q + ((size_t(b) * S + qi) * H + h) * HD + c);
    }
    bf16x8_to_f32(raw, sqrt_hd, sq + r * G::QS + c);
  }

  // key positions this tile can see: [kv_begin, kv_end)
  const int gr_last = min(r0 + G::R, rows_total) - 1;
  const int kv_end = min(nb * bs, cur + gr_last / n_rep + 1);
  int kv_begin = 0;
  if (window > 0) kv_begin = max(0, cur + r0 / n_rep - window + 1) / TK * TK;

  uint4 pre[G::CPT];
  float pre_s[G::CPT];               // int8: the scale of each chunk's row
  auto fetch = [&](int j0) {
    const int blk = tables[size_t(b) * nb + j0 / bs];
    const bool ok = blk >= 0 && blk < n_arena;   // never read past the arena
    const int off = j0 % bs;
#pragma unroll
    for (int i = 0; i < G::CPT; ++i) {
      const int it = tid + i * NTHREADS;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      float sc = 1.0f;
      if (ok && it < 2 * G::NCH) {
        const int rem = it % G::NCH;
        const int t = rem / (HD / G::EPC), c = (rem % (HD / G::EPC)) * G::EPC;
        const size_t pos = (size_t(blk) * bs + off + t) * KV + kvh;
        const T* base = it < G::NCH ? k : v;
        val = *reinterpret_cast<const uint4*>(base + pos * HD + c);
        if (INT8) sc = (it < G::NCH ? k_scale : v_scale)[pos];
      }
      pre[i] = val;
      pre_s[i] = sc;
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int i = 0; i < G::CPT; ++i) {
      const int it = tid + i * NTHREADS;
      if (it < 2 * G::NCH) {
        const int rem = it % G::NCH;
        const int t = rem / (HD / G::EPC), c = (rem % (HD / G::EPC)) * G::EPC;
        float* dst = it < G::NCH ? sk + t * G::KS + c : sv + t * HD + c;
        if (INT8)
          int8x16_to_f32(pre[i], pre_s[i], dst);
        else
          bf16x8_to_f32(pre[i], 1.0f, dst);
      }
    }
  };

  // score-phase geometry: lane -> (row, keys [key0, key0 + KPL), d part)
  const int row_w = lane / G::LPR, sub = lane % G::LPR;
  const int key0 = (sub / G::DS) * G::KPL, dpart = sub % G::DS;
  const int my_r = warp * RPW + row_w;
  const int qpos = cur + min(r0 + my_r, rows_total - 1) / n_rep;
  float m = NEG_INF, l = 0.0f;
  float acc[RPW][G::CPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int c = 0; c < G::CPL; ++c) acc[i][c] = 0.0f;

  if (kv_begin < kv_end) fetch(kv_begin);
  for (int j0 = kv_begin; j0 < kv_end; j0 += TK) {
    __syncthreads();                 // the last tile (and the q tile) is read
    stash();
    __syncthreads();
    if (j0 + TK < kv_end) fetch(j0 + TK);

    float s[G::KPL];
#pragma unroll
    for (int kk = 0; kk < G::KPL; ++kk) s[kk] = 0.0f;
    const float4* qrow = reinterpret_cast<const float4*>(sq + my_r * G::QS);
#pragma unroll 4
    for (int d4 = dpart; d4 < HD / 4; d4 += G::DS) {
      const float4 qv = qrow[d4];
#pragma unroll
      for (int kk = 0; kk < G::KPL; ++kk) {
        const float4 kv = reinterpret_cast<const float4*>(
            sk + (key0 + kk) * G::KS)[d4];
        s[kk] = fmaf(qv.x, kv.x, s[kk]);
        s[kk] = fmaf(qv.y, kv.y, s[kk]);
        s[kk] = fmaf(qv.z, kv.z, s[kk]);
        s[kk] = fmaf(qv.w, kv.w, s[kk]);
      }
    }
#pragma unroll
    for (int o = 1; o < G::DS; o <<= 1)
#pragma unroll
      for (int kk = 0; kk < G::KPL; ++kk)
        s[kk] += __shfl_xor_sync(FULL, s[kk], o);

    float mx = NEG_INF;
#pragma unroll
    for (int kk = 0; kk < G::KPL; ++kk) {
      const int j = j0 + key0 + kk;
      const bool valid = j <= qpos && (window <= 0 || j > qpos - window);
      s[kk] = valid ? s[kk] : NEG_INF;
      mx = fmaxf(mx, s[kk]);
    }
#pragma unroll
    for (int o = G::DS; o < G::LPR; o <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float psum = 0.0f;
#pragma unroll
    for (int kk = 0; kk < G::KPL; ++kk) {
      s[kk] = expf(s[kk] - m_new);
      psum += s[kk];
    }
#pragma unroll
    for (int o = G::DS; o < G::LPR; o <<= 1)
      psum += __shfl_xor_sync(FULL, psum, o);
    m = m_new;
    l = l * alpha + psum;
    if (dpart == 0) {
#pragma unroll
      for (int kk = 0; kk < G::KPL; ++kk) sp[my_r * TK + key0 + kk] = s[kk];
    }
    if (sub == 0) salpha[my_r] = alpha;
    __syncwarp();

    // acc[row][col] = acc * alpha + sum_t p[row][t] * v[t][col]; the warp's
    // rows are the ones whose p and alpha it just wrote
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const float a = salpha[warp * RPW + i];
#pragma unroll
      for (int c = 0; c < G::CPL; ++c) acc[i][c] *= a;
    }
#pragma unroll
    for (int t4 = 0; t4 < TK; t4 += 4) {
      float vv[4][G::CPL];
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int c = 0; c < G::CPL; ++c)
          vv[t][c] = sv[(t4 + t) * HD + lane + 32 * c];
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float4 p = *reinterpret_cast<const float4*>(
            sp + (warp * RPW + i) * TK + t4);
#pragma unroll
        for (int c = 0; c < G::CPL; ++c) {
          acc[i][c] = fmaf(p.x, vv[0][c], acc[i][c]);
          acc[i][c] = fmaf(p.y, vv[1][c], acc[i][c]);
          acc[i][c] = fmaf(p.z, vv[2][c], acc[i][c]);
          acc[i][c] = fmaf(p.w, vv[3][c], acc[i][c]);
        }
      }
    }
    __syncwarp();                    // p and alpha are rewritten next tile
  }

  if (sub == 0) sl[my_r] = l;
  __syncwarp();
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp * RPW + i, gr = r0 + r;
    if (gr < rows_total) {
      const int qi = gr / n_rep, h = kvh * n_rep + gr % n_rep;
      const float denom = fmaxf(sl[r], 1e-30f);
      bf16* o = out + ((size_t(b) * S + qi) * H + h) * HD;
#pragma unroll
      for (int c = 0; c < G::CPL; ++c)
        o[lane + 32 * c] = __float2bfloat16(acc[i][c] / denom);
    }
  }
}

template <int HD, int RPW, int TK, typename T>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* tables, const void* cursor, void* out,
           int B, int S, int H, int KV, int bs, int nb, int n_arena,
           int window, void* stream) {
  using G = Geometry<HD, RPW, TK, T>;
  auto kernel = paged_attention_kernel<HD, RPW, TK, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(G::SMEM));
  if (err != cudaSuccess) return int(err);
  const int rows = S * (H / KV);
  const dim3 grid((rows + G::R - 1) / G::R, KV, B);
  kernel<<<grid, NTHREADS, G::SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int32_t*>(tables),
      static_cast<const int32_t*>(cursor), static_cast<bf16*>(out), S, H, KV,
      bs, nb, n_arena, window);
  return int(cudaGetLastError());
}

template <int HD, int TK, typename T>
int launch_rows(const void* q, const void* k, const void* v, const void* ks,
                const void* vs, const void* tables, const void* cursor,
                void* out, int B, int S, int H, int KV, int bs, int nb,
                int n_arena, int window, void* stream) {
  const int rows = S * (H / KV);
  if (rows <= 4)
    return launch<HD, 1, TK, T>(q, k, v, ks, vs, tables, cursor, out, B, S, H,
                                KV, bs, nb, n_arena, window, stream);
  if (rows <= 16)
    return launch<HD, 4, TK, T>(q, k, v, ks, vs, tables, cursor, out, B, S, H,
                                KV, bs, nb, n_arena, window, stream);
  return launch<HD, 16, TK, T>(q, k, v, ks, vs, tables, cursor, out, B, S, H,
                               KV, bs, nb, n_arena, window, stream);
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, const void* ks,
              const void* vs, const void* tables, const void* cursor,
              void* out, int B, int S, int H, int KV, int hd, int bs, int nb,
              int n_arena, int window, void* stream) {
  const bool tk16 = bs % 16 == 0;
  if (hd == 64 && tk16)
    return launch_rows<64, 16, T>(q, k, v, ks, vs, tables, cursor, out, B, S,
                                  H, KV, bs, nb, n_arena, window, stream);
  if (hd == 64)
    return launch_rows<64, 8, T>(q, k, v, ks, vs, tables, cursor, out, B, S,
                                 H, KV, bs, nb, n_arena, window, stream);
  if (hd == 128 && tk16)
    return launch_rows<128, 16, T>(q, k, v, ks, vs, tables, cursor, out, B, S,
                                   H, KV, bs, nb, n_arena, window, stream);
  if (hd == 128)
    return launch_rows<128, 8, T>(q, k, v, ks, vs, tables, cursor, out, B, S,
                                  H, KV, bs, nb, n_arena, window, stream);
  return int(cudaErrorInvalidValue);
}

}  // namespace

// The wrapper checks device, dtype, shapes, contiguity and alignment, and
// that hd is 64 or 128, bs a multiple of 8 and H a multiple of KV.
// Returns cudaGetLastError() after the launch.
extern "C" int paged_attention_bf16(const void* q, const void* k,
                                    const void* v, const void* tables,
                                    const void* cursor, void* out, int B,
                                    int S, int H, int KV, int hd, int bs,
                                    int nb, int n_arena, int window,
                                    void* stream) {
  return launch_hd<bf16>(q, k, v, nullptr, nullptr, tables, cursor, out, B, S,
                         H, KV, hd, bs, nb, n_arena, window, stream);
}

extern "C" int paged_attention_int8(const void* q, const void* k,
                                    const void* v, const void* k_scale,
                                    const void* v_scale, const void* tables,
                                    const void* cursor, void* out, int B,
                                    int S, int H, int KV, int hd, int bs,
                                    int nb, int n_arena, int window,
                                    void* stream) {
  return launch_hd<int8_t>(q, k, v, k_scale, v_scale, tables, cursor, out, B,
                           S, H, KV, hd, bs, nb, n_arena, window, stream);
}
