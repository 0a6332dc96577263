// Structured-outlier matmul for Hopper (sm_90a): y = x @ O^T, where O holds
// n exact salient values in every 256-wide input group of each row (the
// N:256 pattern of core/outliers.py, n = 4, 8 or 16 in the paper).  Two
// bodies, picked by kernels/outlier_spmm.plan on the rows M of x:
//   * decode (M <= T, and every M for an n other than 4, 8, 16):
//     outlier_decode_kernel, lanes take the outliers;
//   * prefill (M > T): outlier_prefill_kernel, lanes take the rows of x.
// The first kernel (csrc/outlier_spmm_gather8.cu) stays callable to be
// timed beside them.
//
// Replaces the Pallas TPU kernel
//   outlier_spmm  src/repro/kernels/outlier_spmm.py:74
//                 (_kernel :55, _decompress_outlier_tile :44)
// and computes what it computes: exact bf16 products, f32 accumulation, y
// in bf16.
//
// Layout (bf16 values, int32 words read unsigned; K = in, N = out, G =
// K/256):
//   x         [M, K]        16-byte aligned
//   values    [N, G, n]     exact salient values, 8-byte aligned
//   meta      [N, G, n/4]   four 8-bit in-group indices per word: byte j of
//                           word w is the index of value 4w + j (index 255
//                           in the top byte makes the int32 negative)
//   y         [M, N]
//   workspace [S, M, N] f32 per-split partial sums (S > 1)
//   counters  one int32 per output tile, 0 between launches
//
// What bounds it on an H100 SXM.  The outliers are N*G*n*3 bytes (2 B of
// value, 1 B of index), 11.0 MB for 16:256 w_gate [14336, 4096]: 3.3 us at
// 3.35 TB/s, which bounds decode.  The multiply-adds, M*N*G*n, are 1/16 of
// a dense product's at 16:256, but no two output rows share an index, so x
// cannot be reused across rows from registers: each multiply-add reads 2 B
// of x, and on the CUDA cores the ceiling is the shared-memory gather, 128
// B/clk an SM = 64 multiply-adds/clk an SM, 15.4 T/s over 132 SMs at the
// 1.83 GHz of the data sheet's peaks (w_gate at 16:256, M = 512: 0.12 ms).
//
// The decode body (x rows R = 2, 4 or 8 a tile): a block stages its K
// slice of x once, transposed to [column][R rows] with 16-byte loads, and
// covers 32, 64 or 128 output rows in batches of 32 (8 warps x 4 rows).
// In a batch each lane takes one meta word (four indices) and its four
// values of each of its warp's 4 rows, with one 4-byte and one 8-byte load
// coalesced across the warp, and adds v * x[m, col] for the R rows from
// one 4-, 8- or 16-byte shared-memory load.  A reduce-scatter over the
// warp (offsets 16, 8, 4, 2, 1: each step sends half the sums and keeps
// the other half) leaves each (row, m) sum in one lane.  The plan picks
// the block's height and splits K on multiples of 256 so that the grid
// fills one wave of two blocks an SM.
//
// The prefill body (BM = 32 * RL rows of x by BN = 64 * RL output rows, RL
// = 2 or 4): a lane takes RL rows of x and a warp walks the (value, index)
// lists of its 16 output rows, adding v * x[m, idx] for its own rows, so
// the sums stay in registers and nothing is reduced across lanes.  Per
// 256-wide group (a stage):
//   * x is staged once for BN output rows, transposed to [column][BM rows]
//     (a pitch of BM + 4 bf16, which keeps the stores free of bank
//     conflicts), so one 4- (RL = 2) or 8-byte (RL = 4) load gives a lane
//     its rows and the warp's 32 lanes read one run of 128 or 256 bytes;
//   * the lists are decoded once a block on the way in, one index word and
//     its four values a thread, into (value as f32, byte offset of its x
//     column) pairs, so a warp reads two outliers with one broadcast
//     16-byte load and spends one add on each address (decoded in the
//     products, each outlier costs five more integer instructions);
//   * the next stage's x and lists go through registers (16-byte loads of
//     x, two lanes a 32-byte sector) into the other of two slots, a unit a
//     quarter of this stage's products: at RL = 2 loaded before the
//     quarter and stored after it, at RL = 4 (128 registers) both after
//     it; one barrier a stage;
//   * what is left an outlier and RL rows: one load of x, RL conversions
//     of bf16 to f32 and RL multiply-adds, so the issue rate, not the 128
//     bytes a clock of shared memory, sets the pace.
// The plan takes RL = 2 (two 100 KB blocks an SM at 16:256) up to M = 64,
// RL = 4 (one 196 KB block of 16 warps) above, and splits K on multiples
// of 256 only where the output tiles do not fill the card.  The epilogue
// stages the sums through shared memory so y (or the workspace) is written
// row by row.  Compiled for n = 4, 8, 16 (constant shapes).
//
// Split K in both bodies: each split writes its partial sums to the
// workspace and the last block to arrive for an output tile (a counter it
// resets to 0) sums them in split order, 0 + p0 + p1 + ...: no float
// atomics, no memset launch, the same bits every call (csrc/
// split_reduce.cuh, shared with the fused kernels).
//
// The products are exact in f32 (bf16 x bf16), so only the summation order
// differs from the plain version (kernels/ref.outlier_spmm_ref).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "split_reduce.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kGroup = 256;            // input columns per outlier group
constexpr int kWarps = 8;              // decode: 8 warps
constexpr int kThreads = kWarps * 32;
constexpr int kWarpRows = 4;           // decode: output rows a warp a batch
constexpr int kBatchRows = kWarps * kWarpRows;
constexpr int kMaxSliceBytes = 32768;  // decode: staged x slice per block
constexpr int kStages = 2;             // prefill: slots of x and lists

__device__ __forceinline__ float lo_bf16(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float hi_bf16(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// byte q of an index word, unsigned
__device__ __forceinline__ int index_at(uint32_t word, int q) {
  return (word >> (8 * q)) & 0xffu;
}

// ------------------------------------------------------------ decode body
// Column c of the staged slice: x[m0 .. m0 + R - 1, k0 + c], rows in pairs.
template <int R>
struct Col {
  uint32_t w[R / 2];
};

template <int R>
__device__ __forceinline__ Col<R> load_col(const uint32_t* xs, int c) {
  Col<R> out;
  if constexpr (R == 2) {
    out.w[0] = xs[c];
  } else if constexpr (R == 4) {
    const uint2 v = reinterpret_cast<const uint2*>(xs)[c];
    out.w[0] = v.x;
    out.w[1] = v.y;
  } else {
    static_assert(R == 8, "R is 2, 4 or 8");
    const uint4 v = reinterpret_cast<const uint4*>(xs)[c];
    out.w[0] = v.x;
    out.w[1] = v.y;
    out.w[2] = v.z;
    out.w[3] = v.w;
  }
  return out;
}

template <int R>
__device__ __forceinline__ void fma_col(float* acc, float v, const Col<R>& c) {
#pragma unroll
  for (int i = 0; i < R / 2; ++i) {
    acc[2 * i] = fmaf(v, lo_bf16(c.w[i]), acc[2 * i]);
    acc[2 * i + 1] = fmaf(v, hi_bf16(c.w[i]), acc[2 * i + 1]);
  }
}

// One step of reduce_scatter: lane l pairs with lane l ^ off, sends the
// half of its H * 2 sums it gives away and adds the partner's copy of the
// half it keeps (the upper half where bit off of l is set) into v[0 .. H).
template <int H, int V>
__device__ __forceinline__ void halve(float (&v)[V], int lane, int off) {
  const bool upper = lane & off;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const float send = upper ? v[j] : v[j + H];
    const float keep = upper ? v[j + H] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, off);
  }
}

// Sums each of v[0 .. V-1] over the warp's 32 lanes and returns, in lane l,
// the sum of element l / (32 / V).  The step of offset off pairs lane l
// with lane l ^ off, as a butterfly does (offsets 16, 8, 4, 2, 1, so the
// same tree and the same bits), but while more than one element is left
// each lane sends half of them and keeps the other half.  The steps are
// spelled out so that every index is a constant (a loop over them was
// compiled to predicated moves over all V registers).
template <int V>
__device__ __forceinline__ float reduce_scatter(float (&v)[V], int lane) {
  static_assert(V == 8 || V == 16 || V == 32, "V is 8, 16 or 32");
  halve<V / 2>(v, lane, 16);
  halve<V / 4>(v, lane, 8);
  halve<V / 8>(v, lane, 4);
  if constexpr (V >= 16) halve<V / 16>(v, lane, 2);
  if constexpr (V == 32) halve<1>(v, lane, 1);
  float s = v[0];
  if constexpr (V == 8) s += __shfl_xor_sync(0xffffffffu, s, 2);
  if constexpr (V <= 16) s += __shfl_xor_sync(0xffffffffu, s, 1);
  return s;
}

template <int R>
__global__ void __launch_bounds__(kThreads, 2)
outlier_decode_kernel(const bf16* __restrict__ x,
                      const uint16_t* __restrict__ values,
                      const uint32_t* __restrict__ meta,
                      bf16* __restrict__ y, float* __restrict__ ws,
                      int* __restrict__ counters, int M, int K, int N, int n,
                      int bn, int S, int kps) {
  extern __shared__ uint4 dsmem[];
  uint32_t* xs = reinterpret_cast<uint32_t*>(dsmem);  // [cols][R / 2]

  // block -> (x row tile, split, block of bn output rows); the row tile
  // runs fastest so the tiles of one outlier slice run side by side
  const int tiles = (M + R - 1) / R;
  int bid = blockIdx.x;
  const int tile = bid % tiles;
  bid /= tiles;
  const int s = bid % S, rb = bid / S;
  const int m0 = tile * R, k0 = s * kps, cols = min(kps, K - k0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wpg = n >> 2;                           // meta words a group
  const int words = (cols / kGroup) * wpg;          // a row's, in the slice
  const size_t row_words = size_t(K / kGroup) * wpg;
  const size_t w0 = size_t(k0 / kGroup) * wpg;
  const uint2* vals = reinterpret_cast<const uint2*>(values);  // 4 a word

  // the slice of x, transposed to [column][R rows] (rows past M are 0): a
  // thread takes 8 columns of a pair of rows, two 16-byte loads
  for (int t = threadIdx.x; t < (cols / 8) * (R / 2); t += kThreads) {
    const int i = t % (R / 2), c = (t / (R / 2)) * 8;
    const int ma = m0 + 2 * i, mb = ma + 1;
    uint4 a = make_uint4(0u, 0u, 0u, 0u), b = a;
    if (ma < M)
      a = __ldg(reinterpret_cast<const uint4*>(x + size_t(ma) * K + k0 + c));
    if (mb < M)
      b = __ldg(reinterpret_cast<const uint4*>(x + size_t(mb) * K + k0 + c));
    const uint32_t av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      xs[(c + 2 * j) * (R / 2) + i] = __byte_perm(av[j], bv[j], 0x5410);
      xs[(c + 2 * j + 1) * (R / 2) + i] = __byte_perm(av[j], bv[j], 0x7632);
    }
  }
  __syncthreads();

  // lane l ends a batch holding element e = l * R / 8 of the warp's
  // 4 x R sums: output row e / R, x row e % R
  const int e = lane * R / 8;
  for (int b = 0; b < bn / kBatchRows; ++b) {
    const int obase = rb * bn + b * kBatchRows + warp * kWarpRows;
    float acc[kWarpRows * R];
#pragma unroll
    for (int i = 0; i < kWarpRows * R; ++i) acc[i] = 0.f;
    for (int wb = 0; wb < words; wb += 32) {
      const int w = wb + lane;
      uint32_t word[kWarpRows];
      uint2 v[kWarpRows];
#pragma unroll
      for (int r = 0; r < kWarpRows; ++r) {  // all loads first, then FMAs
        const int o = obase + r;
        word[r] = 0u;
        v[r] = make_uint2(0u, 0u);
        if (o < N && w < words) {
          const size_t at = size_t(o) * row_words + w0 + w;
          word[r] = __ldg(meta + at);
          v[r] = __ldg(vals + at);
        }
      }
      if (w < words) {
        const int base = (w / wpg) * kGroup;
#pragma unroll
        for (int r = 0; r < kWarpRows; ++r) {
          float* a = acc + r * R;
          fma_col<R>(a, lo_bf16(v[r].x), load_col<R>(xs, base + index_at(word[r], 0)));
          fma_col<R>(a, hi_bf16(v[r].x), load_col<R>(xs, base + index_at(word[r], 1)));
          fma_col<R>(a, lo_bf16(v[r].y), load_col<R>(xs, base + index_at(word[r], 2)));
          fma_col<R>(a, hi_bf16(v[r].y), load_col<R>(xs, base + index_at(word[r], 3)));
        }
      }
    }
    const float sum = reduce_scatter<kWarpRows * R>(acc, lane);
    const int o = obase + e / R, m = m0 + e % R;
    if (lane % (8 / R) == 0 && o < N && m < M) {
      if (S == 1)
        y[size_t(m) * N + o] = __float2bfloat16(sum);
      else
        ws[(size_t(s) * M + m) * N + o] = sum;
    }
  }
  if (S > 1)
    splitk::reduce_splits(ws, counters + rb * tiles + tile, y, M, N, S, m0,
                          R, rb * bn, bn, kThreads);
}

// ----------------------------------------------------------- prefill body
// RL rows of x a lane and 16 output rows a warp: 4 * RL warps, BM = 32 * RL
// rows of x by BN = 64 * RL output rows a block, 16 * RL sums a thread.
template <int RL, int NT>
struct Prefill {
  static constexpr int kWarps = 4 * RL;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRows = 16;              // output rows a warp
  static constexpr int kBM = 32 * RL;           // x rows a block
  static constexpr int kBN = kWarps * kRows;    // output rows a block
  // words a staged x column: BM rows in pairs, plus 2 words of pad (a
  // pitch of 2 mod 4 words puts the two 8-column chunks a warp stores at
  // once 16 banks apart)
  static constexpr int kPitch = kBM / 2 + 2;
  static constexpr int kXWords = kGroup * kPitch;
  // the lists, decoded: (value as f32, byte offset of its x column) pairs,
  // [BN rows][n]
  static constexpr int kLWords = kBN * NT * 2;
  static constexpr int kSlotWords = kXWords + kLWords;
  static constexpr int kSmem = kStages * kSlotWords * 4;
  // copy units a thread a stage: x, a pair of rows x 8 columns (four);
  // lists, one index word and its four values (n / 8, at least one)
  static constexpr int kUnits = (kBM / 2) * (kGroup / 8) / kThreads;
  static constexpr int kListUnits = NT < 8 ? 1 : NT / 8;
  static constexpr int kTilePitch = kBN + 1;    // the f32 epilogue tile
  static_assert(kUnits == 4, "an x unit a quarter of the products");
  static_assert(kBN * NT / 4 <= kListUnits * kThreads, "lists covered");
  static_assert(kBM * kTilePitch <= kStages * kSlotWords,
                "the epilogue tile fits in the slots");
};

// v * x for the lane's RL rows of x at byte address col of the staged tile
template <int RL>
__device__ __forceinline__ void fma_rows(float (&acc)[RL], float v,
                                         const char* col) {
  if constexpr (RL == 2) {
    const uint32_t xv = *reinterpret_cast<const uint32_t*>(col);
    acc[0] = fmaf(v, lo_bf16(xv), acc[0]);
    acc[1] = fmaf(v, hi_bf16(xv), acc[1]);
  } else {
    static_assert(RL == 4, "RL is 2 or 4");
    const uint2 xv = *reinterpret_cast<const uint2*>(col);
    acc[0] = fmaf(v, lo_bf16(xv.x), acc[0]);
    acc[1] = fmaf(v, hi_bf16(xv.x), acc[1]);
    acc[2] = fmaf(v, lo_bf16(xv.y), acc[2]);
    acc[3] = fmaf(v, hi_bf16(xv.y), acc[3]);
  }
}

template <int RL, int NT>
__global__ void __launch_bounds__(Prefill<RL, NT>::kThreads, 2 / (RL / 2))
outlier_prefill_kernel(const bf16* __restrict__ x,
                       const uint16_t* __restrict__ values,
                       const uint32_t* __restrict__ meta,
                       bf16* __restrict__ y, float* __restrict__ ws,
                       int* __restrict__ counters, int M, int K, int N, int S,
                       int kps) {
  using P = Prefill<RL, NT>;
  extern __shared__ uint4 dsmem[];
  uint32_t* smem = reinterpret_cast<uint32_t*>(dsmem);

  // block -> (x row tile, split, block of BN output rows); the row tile
  // runs fastest so the tiles of one list slice run side by side
  const int mtiles = (M + P::kBM - 1) / P::kBM;
  int bid = blockIdx.x;
  const int mt = bid % mtiles;
  bid /= mtiles;
  const int s = bid % S, nb = bid / S;
  const int m0 = mt * P::kBM, o0 = nb * P::kBN;
  const int G = K / kGroup, g0 = s * (kps / kGroup);
  const int steps = min(G, g0 + kps / kGroup) - g0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  auto xs_of = [&](int slot) { return smem + slot * P::kSlotWords; };
  auto ls_of = [&](int slot) { return xs_of(slot) + P::kXWords; };

  // the lists of group g for the block's rows (rows past N are zeros) go
  // through registers too, list unit k (k < n / 8, at least one) with x
  // unit k: list unit u is index word u % (n / 4) of row u / (n / 4) and
  // its four values, one 4-byte and one 8-byte load; the store decodes them
  // into (value, offset) pairs, two 16-byte stores
  uint2 lv;
  uint32_t lm;
  auto load_lists = [&](int g, auto part) {
    constexpr int k = decltype(part)::value;
    if constexpr (k < P::kListUnits) {
      const int u = threadIdx.x + k * P::kThreads;
      const int r = u / (NT / 4), p = u % (NT / 4);
      lv = make_uint2(0u, 0u);
      lm = 0u;
      if (u < P::kBN * NT / 4 && o0 + r < N) {
        const size_t at = size_t(o0 + r) * G + g;
        lv = __ldg(reinterpret_cast<const uint2*>(values + at * NT) + p);
        lm = __ldg(meta + at * (NT / 4) + p);
      }
    }
  };
  auto store_lists = [&](int slot, auto part) {
    constexpr int k = decltype(part)::value;
    if constexpr (k < P::kListUnits) {
      const int u = threadIdx.x + k * P::kThreads;
      if (u < P::kBN * NT / 4) {
        uint32_t* e = ls_of(slot) + 2 * 4 * u;  // entries 4u .. 4u + 3
        constexpr uint32_t kCol = P::kPitch * 4;  // bytes an x column
        *reinterpret_cast<uint4*>(e) =
            make_uint4(lv.x << 16, index_at(lm, 0) * kCol,
                       lv.x & 0xffff0000u, index_at(lm, 1) * kCol);
        *reinterpret_cast<uint4*>(e + 4) =
            make_uint4(lv.y << 16, index_at(lm, 2) * kCol,
                       lv.y & 0xffff0000u, index_at(lm, 3) * kCol);
      }
    }
  };

  // x unit k of this thread: rows 2i, 2i + 1, columns 8c .. 8c + 7 of the
  // group, c = 2 * cp + b; two neighbouring lanes take the two 16-byte
  // halves of one 32-byte sector of each row
  auto unit = [&](int k, int& i, int& c) {
    const int u = threadIdx.x + k * P::kThreads;
    const int q = u >> 1;
    i = q % (P::kBM / 2);
    c = 2 * (q / (P::kBM / 2)) + (u & 1);
  };
  // the next stage's x goes through registers one unit at a time (two
  // 16-byte loads), each loaded before a quarter of the products and
  // stored after it: 8 registers of x in flight
  uint4 xa, xb;
  auto load_x = [&](int g, auto part) {
    int i, c;
    unit(decltype(part)::value, i, c);
    const int ma = m0 + 2 * i, mb = ma + 1;
    const size_t col = size_t(g) * kGroup + 8 * c;
    xa = make_uint4(0u, 0u, 0u, 0u);
    xb = xa;
    if (ma < M)
      xa = __ldg(reinterpret_cast<const uint4*>(x + size_t(ma) * K + col));
    if (mb < M)
      xb = __ldg(reinterpret_cast<const uint4*>(x + size_t(mb) * K + col));
  };
  auto store_x = [&](int slot, auto part) {
    uint32_t* xs = xs_of(slot);
    int i, c;
    unit(decltype(part)::value, i, c);
    const uint32_t av[4] = {xa.x, xa.y, xa.z, xa.w};
    const uint32_t bv[4] = {xb.x, xb.y, xb.z, xb.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      xs[(8 * c + 2 * j) * P::kPitch + i] = __byte_perm(av[j], bv[j], 0x5410);
      xs[(8 * c + 2 * j + 1) * P::kPitch + i] =
          __byte_perm(av[j], bv[j], 0x7632);
    }
  };

  float acc[P::kRows][RL];
#pragma unroll
  for (int r = 0; r < P::kRows; ++r)
#pragma unroll
    for (int k = 0; k < RL; ++k) acc[r][k] = 0.f;

  // a quarter of the warp's rows: for each pair of list entries one
  // broadcast 16-byte load of their values and offsets, then for each
  // entry one load of the lane's RL rows of x at its column
  auto compute = [&](int slot, auto part) {
    const char* xl =
        reinterpret_cast<const char*>(xs_of(slot) + lane * (RL / 2));
    const uint32_t* ls = ls_of(slot) + warp * P::kRows * NT * 2;
    constexpr int kPart = P::kRows / P::kUnits;
    constexpr int r0 = decltype(part)::value * kPart;
#pragma unroll
    for (int r = r0; r < r0 + kPart; ++r) {
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        const uint4 e = *reinterpret_cast<const uint4*>(ls + (r * NT + j) * 2);
        fma_rows<RL>(acc[r], __uint_as_float(e.x), xl + e.y);
        fma_rows<RL>(acc[r], __uint_as_float(e.z), xl + e.w);
      }
    }
  };

  // stage t: its x and lists were stored during stage t - 1; the next
  // stage's are copied a unit a quarter of stage t's products, into the
  // other slot, which stage t - 1 read before this stage's barrier.  At RL
  // = 2 a unit's loads go out before its quarter and its stores follow it;
  // at RL = 4 (64 sums a thread, 128 registers) registers held across the
  // products spill, so the whole copy follows the quarter
  constexpr bool kEarly = RL == 2;
  const std::integral_constant<int, 0> p0;
  const std::integral_constant<int, 1> p1;
  const std::integral_constant<int, 2> p2;
  const std::integral_constant<int, 3> p3;
  auto load = [&](int g, auto part) {
    load_lists(g, part);
    load_x(g, part);
  };
  auto store = [&](int slot, auto part) {
    store_lists(slot, part);
    store_x(slot, part);
  };
  load(g0, p0);
  store(0, p0);
  load(g0, p1);
  store(0, p1);
  load(g0, p2);
  store(0, p2);
  load(g0, p3);
  store(0, p3);
  for (int t = 0; t < steps; ++t) {
    const int cur = t & 1, g = g0 + t + 1;
    const bool next = t + 1 < steps;
    auto quarter = [&](auto part) {
      if (kEarly && next) load(g, part);
      compute(cur, part);
      if (next) {
        if (!kEarly) load(g, part);
        store(cur ^ 1, part);
      }
    };
    __syncthreads();
    quarter(p0);
    quarter(p1);
    quarter(p2);
    quarter(p3);
  }

  // the sums through shared memory, [BM][BN + 1] f32, so y (or the
  // workspace) is written along its rows
  __syncthreads();
  float* tile = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int r = 0; r < P::kRows; ++r)
#pragma unroll
    for (int k = 0; k < RL; ++k)
      tile[(RL * lane + k) * P::kTilePitch + warp * P::kRows + r] = acc[r][k];
  __syncthreads();
  for (int t = threadIdx.x; t < P::kBM * P::kBN; t += P::kThreads) {
    const int mr = t / P::kBN, oc = t % P::kBN;
    const int m = m0 + mr, o = o0 + oc;
    if (m < M && o < N) {
      const float v = tile[mr * P::kTilePitch + oc];
      if (S == 1)
        y[size_t(m) * N + o] = __float2bfloat16(v);
      else
        ws[(size_t(s) * M + m) * N + o] = v;
    }
  }
  if (S > 1)
    splitk::reduce_splits(ws, counters + nb * mtiles + mt, y, M, N, S, m0,
                          P::kBM, o0, P::kBN, P::kThreads);
}

// ------------------------------------------------------------- launchers
bool valid_split(int K, int S, int kps) {
  return S >= 1 && kps > 0 && kps % kGroup == 0 &&
         size_t(S) * kps >= size_t(K) && size_t(S - 1) * kps < size_t(K);
}

template <int R>
int launch_decode(const bf16* x, const uint16_t* values, const uint32_t* meta,
                  bf16* y, float* ws, int* cnt, int M, int K, int N, int n,
                  int bn, int S, int kps, cudaStream_t stream) {
  const int tiles = (M + R - 1) / R;
  const dim3 grid(tiles * S * ((N + bn - 1) / bn));
  const size_t smem = size_t(kps) * R * 2;  // <= 32 KB
  outlier_decode_kernel<R><<<grid, kThreads, smem, stream>>>(
      x, values, meta, y, ws, cnt, M, K, N, n, bn, S, kps);
  return int(cudaGetLastError());
}

template <int RL, int NT>
int launch_prefill(const bf16* x, const uint16_t* values,
                   const uint32_t* meta, bf16* y, float* ws, int* cnt, int M,
                   int K, int N, int S, int kps, cudaStream_t stream) {
  using P = Prefill<RL, NT>;
  auto kernel = outlier_prefill_kernel<RL, NT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
  if (err != cudaSuccess) return int(err);
  const dim3 grid(((M + P::kBM - 1) / P::kBM) * S *
                  ((N + P::kBN - 1) / P::kBN));
  kernel<<<grid, P::kThreads, P::kSmem, stream>>>(x, values, meta, y, ws, cnt,
                                                  M, K, N, S, kps);
  return int(cudaGetLastError());
}

template <int RL>
int launch_prefill_n(const bf16* x, const uint16_t* values,
                     const uint32_t* meta, bf16* y, float* ws, int* cnt,
                     int M, int K, int N, int n, int S, int kps,
                     cudaStream_t stream) {
  if (n == 4)
    return launch_prefill<RL, 4>(x, values, meta, y, ws, cnt, M, K, N, S, kps,
                                 stream);
  if (n == 8)
    return launch_prefill<RL, 8>(x, values, meta, y, ws, cnt, M, K, N, S, kps,
                                 stream);
  return launch_prefill<RL, 16>(x, values, meta, y, ws, cnt, M, K, N, S, kps,
                                stream);
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

}  // namespace

// The Python wrapper (kernels/outlier_spmm.py) checks device, dtype, shapes
// and contiguity and passes its plan: `rows` x rows a tile (decode R = 2, 4
// or 8; prefill BM = 64 or 128), `cols` output rows a block (decode 32, 64
// or 128; prefill 256), `splits` S and `k_per_split` (a multiple of 256
// with (S - 1) * k_per_split < K <= S * k_per_split), the workspace (S * M
// * N f32, used when S > 1) and the counters (one int32 per output tile,
// all 0; the kernel leaves them 0).  Each returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for a plan or operand it does not
// take (x must be 16-byte aligned, values 8-byte aligned, K % 256 == 0, n
// a positive multiple of 4; the prefill body takes n = 4, 8, 16).
extern "C" int outlier_spmm_decode_bf16(const void* x, const void* values,
                                        const void* meta, void* y,
                                        void* workspace, void* counters,
                                        int M, int K, int N, int n, int rows,
                                        int cols, int splits, int k_per_split,
                                        void* stream) {
  if ((rows != 2 && rows != 4 && rows != 8) ||
      (cols != 32 && cols != 64 && cols != 128) || M < 1 || N < 1 ||
      K < kGroup || K % kGroup || n < 4 || n % 4 || n > kGroup ||
      !valid_split(K, splits, k_per_split) ||
      size_t(k_per_split) * rows * 2 > size_t(kMaxSliceBytes) ||
      !aligned(x, 16) || !aligned(values, 8))
    return int(cudaErrorInvalidValue);
  const bf16* xp = static_cast<const bf16*>(x);
  const uint16_t* vp = static_cast<const uint16_t*>(values);
  const uint32_t* mp = static_cast<const uint32_t*>(meta);
  bf16* yp = static_cast<bf16*>(y);
  float* wp = static_cast<float*>(workspace);
  int* cp = static_cast<int*>(counters);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows == 2)
    return launch_decode<2>(xp, vp, mp, yp, wp, cp, M, K, N, n, cols, splits,
                            k_per_split, st);
  if (rows == 4)
    return launch_decode<4>(xp, vp, mp, yp, wp, cp, M, K, N, n, cols, splits,
                            k_per_split, st);
  return launch_decode<8>(xp, vp, mp, yp, wp, cp, M, K, N, n, cols, splits,
                          k_per_split, st);
}

extern "C" int outlier_spmm_prefill_bf16(const void* x, const void* values,
                                         const void* meta, void* y,
                                         void* workspace, void* counters,
                                         int M, int K, int N, int n, int rows,
                                         int cols, int splits,
                                         int k_per_split, void* stream) {
  if ((rows != 64 && rows != 128) || cols != 2 * rows || M < 1 || N < 1 ||
      K < kGroup || K % kGroup || (n != 4 && n != 8 && n != 16) ||
      !valid_split(K, splits, k_per_split) || !aligned(x, 16) ||
      !aligned(values, 8))
    return int(cudaErrorInvalidValue);
  const bf16* xp = static_cast<const bf16*>(x);
  const uint16_t* vp = static_cast<const uint16_t*>(values);
  const uint32_t* mp = static_cast<const uint32_t*>(meta);
  bf16* yp = static_cast<bf16*>(y);
  float* wp = static_cast<float*>(workspace);
  int* cp = static_cast<int*>(counters);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows == 64)
    return launch_prefill_n<2>(xp, vp, mp, yp, wp, cp, M, K, N, n, splits,
                               k_per_split, st);
  return launch_prefill_n<4>(xp, vp, mp, yp, wp, cp, M, K, N, n, splits,
                             k_per_split, st);
}
