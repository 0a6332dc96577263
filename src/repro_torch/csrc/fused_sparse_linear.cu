// Fused N:M + N:256 outlier linear for Hopper (sm_90a), decode regime:
// y = x @ (W_nm + O)^T for the few rows of x a decode step has (M <= T, the
// threshold in kernels/fused_sparse_linear.py), decompressed in registers
// and split over K.
//
// Replaces, for M <= T, the Pallas TPU kernel
//   fused_sparse_linear  src/repro/kernels/fused_sparse_linear.py:75
//                        (_kernel :31, _kernel_int8 :50)
// which csrc/sparse_linear.cu (OUTLIERS=true, a shared-memory tile and WMMA)
// serves at M > T.  Both compute what the Pallas kernels compute: the kept
// 8:16 values (bf16, or int8 times the row's f32 scale rounded once to
// bf16) and the exact bf16 outliers, unscaled, times x with f32
// accumulation, y in bf16.
//
// Layout (K = in, N = out, G = K/256; int32 words read unsigned):
//   x         [M, K] bf16
//   values    [N, K/m*n]         bf16 (16-byte aligned) or int8 (8-byte)
//   scale     [N] f32            int8 only
//   meta      [N, K/m]           n 4-bit in-block indices per word
//   o_values  [N, G, o_n] bf16   exact salient values
//   o_meta    [N, G, o_n/4]      four 8-bit in-group indices per word
//                                (index 255 makes the word negative)
//   workspace [S, M, N] f32      per-split partial sums (S > 1)
//   counters  [row blocks * row tiles] int32, 0 between launches
//
// Bound on an H100 SXM (3.35 TB/s): decode is bound by the weight bytes,
// 1.4375 B/element with bf16 values and 0.9375 B/element (plus 4 B of scale
// per row) with int8 values: w_gate [14336, 4096] is 84.4 MB or 55.1 MB,
// 25 us or 16 us.  Against that the tile kernel spends about 12 us in every
// 256-wide K step whatever the width: too few blocks, each walking all of K
// through a zero-fill, a 2-byte scatter and a barrier-separated outlier pass.
//
// Design:
//   * no decompressed tile: the lanes of a warp walk consecutive N:M blocks
//     of one output row.  A lane reads the block's meta word (4 B) and its n
//     values in one load (16 B bf16, 8 B int8 at 8:16), coalesced across the
//     warp, and decodes them in registers; for each kept value it gathers x
//     at that column for the block's R rows from a shared-memory slice of x
//     stored as [column][R rows] (one 16-byte load serves 8 rows, as in
//     outlier_spmm.cu) and accumulates in f32.  The slice has one pad
//     column after every 16: the kept indices are stored ascending, so
//     without it the lanes of a phase would all hit one bank group at once;
//   * the outliers in the same pass: in step t lane l also takes outlier
//     entry 32t + l of its row's slice (at 8:16 + 16:256 the 16 lanes of one
//     256-wide group take its 16 outliers), reading its 2-byte value and the
//     meta word that holds its index, and adds o * x[index] to the same
//     accumulator; W_nm is an exact zero at every salient slot, so this is
//     the sum of the Pallas tile;
//   * split-K: the plan (kernels/fused_sparse_linear.plan) cuts K into S
//     slices on multiples of 256, so no N:M block or outlier group is cut,
//     and sizes S so the grid holds enough warps to keep the loads in flight
//     (a block is 8 warps x 4 output rows; each warp keeps the loads of its
//     next kDepth - 1 steps in flight in a ring of registers while it
//     computes the current step);
//   * a deterministic reduction: shuffles within the warp in a fixed
//     butterfly, then, for S > 1, each block writes its partials to the
//     workspace and the last block to arrive for an output tile (a per-tile
//     counter, reset to 0 by that block) sums them in split order, 0 + p0 +
//     p1 + ...: no float atomics, no memset launch, the same bits every call
//     (csrc/split_reduce.cuh);
//   * compile-time shapes: 8:16 with o_n = 16 is one instantiation per R
//     (fused_decode_816_kernel) whose arrays are all indexed by constants;
//     every other n <= 8, m <= 16, o_n (a multiple of 4 up to 256) runs the
//     same body with runtime shapes (fused_decode_kernel);
//   * nm_spmm (src/repro/kernels/nm_spmm.py:86, _kernel :46, _kernel_int8
//     :63), y = x @ W_nm^T, is the same body with no outlier stream (OUT =
//     false: the outlier loads and FMAs are not compiled): 8:16 on aligned
//     values in nm_decode_816_kernel, the rest in nm_decode_kernel.  Its K
//     need only be a multiple of m and of 8: the slices stay multiples of
//     256 but for the last, which is cut at K.
// What bounds it (scripts/fused_decode_ab.py times variants of this source
// side by side; PERF.md): the weight loads alone, with no gathers and no
// FMAs, take about twice the byte bound, and at M = 8 the gathers from
// shared memory and their FMAs add more than half again.  The pad column
// saves a sixth; fewer rows per warp (fewer registers) or a deeper load
// ring do not help.  Tensor-core products on fragments decompressed in registers would
// avoid the gathers (a later change).
//
// The products are exact in f32 (bf16 x bf16), so only the summation order
// differs from the plain version (kernels/ref.fused_sparse_linear_ref).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "split_reduce.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kDepth = 2;  // steps of weight loads a warp keeps in a ring
constexpr int kBlockRows = kWarps * kRowsPerWarp;  // output rows per block
constexpr int kGroup = 256;                        // columns per outlier group
constexpr int kMaxSliceBytes = 32768;              // staged x slice per block

// x column c is staged at c + c / 16: one pad column after every 16.  The
// kept indices of a block are stored ascending, so at its k-th value every
// lane gathers near column 16 l + 2k; the pad turns that into a different
// bank group for each lane of a phase instead of the same one.
__host__ __device__ __forceinline__ int padded(int c) { return c + (c >> 4); }

__device__ __forceinline__ float lo_bf16(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float hi_bf16(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

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

// One lane's loads for one output row in one step.
struct Raw {
  uint32_t word;   // the N:M block's meta word
  uint4 vals;      // its n values: bf16 pairs, or int8 bytes in .x and .y
  uint32_t oval;   // one outlier value (bf16 in the low half)
  uint32_t oword;  // the meta word that holds its index
};

template <typename VT, int NT>
__device__ __forceinline__ uint4 load_vals(const VT* p, int n) {
  if constexpr (std::is_same<VT, bf16>::value) {
    if constexpr (NT == 8) {
      return __ldg(reinterpret_cast<const uint4*>(p));
    } else {
      const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (k < n) w[k / 2] |= uint32_t(__ldg(q + k)) << (16 * (k % 2));
      return make_uint4(w[0], w[1], w[2], w[3]);
    }
  } else {
    if constexpr (NT == 8) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
      return make_uint4(v.x, v.y, 0u, 0u);
    } else {
      const unsigned char* q = reinterpret_cast<const unsigned char*>(p);
      uint32_t w[2] = {0u, 0u};
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (k < n) w[k / 4] |= uint32_t(__ldg(q + k)) << (8 * (k % 4));
      return make_uint4(w[0], w[1], 0u, 0u);
    }
  }
}

// Kept value k of a block: bf16 as it is; int8 sign-extended, times the
// row's scale in f32, rounded once to bf16 (kernels/ref.dequantize).
template <typename VT>
__device__ __forceinline__ float value_at(const uint32_t (&w)[4], int k,
                                          float s) {
  if constexpr (std::is_same<VT, bf16>::value) {
    return (k % 2) ? hi_bf16(w[k / 2]) : lo_bf16(w[k / 2]);
  } else {
    const int8_t q = static_cast<int8_t>(w[k / 4] >> (8 * (k % 4)));
    return __bfloat162float(__float2bfloat16(static_cast<float>(q) * s));
  }
}

// OUT = false is nm_spmm's product, y = x @ W_nm^T: no outlier stream, and
// K need only be a multiple of m and of 8 (the last slice may be ragged).
template <int R, typename VT, int NT, int MT, int ONT, bool OUT>
__device__ __forceinline__ void decode_body(
    const bf16* __restrict__ x, const VT* __restrict__ values,
    const float* __restrict__ scale, const uint32_t* __restrict__ meta,
    const unsigned short* __restrict__ o_values,
    const uint32_t* __restrict__ o_meta, bf16* __restrict__ y,
    float* __restrict__ ws, int* __restrict__ counters, int M, int K, int N,
    int n_rt, int m_rt, int on_rt, int S, int kps) {
  constexpr bool INT8 = std::is_same<VT, int8_t>::value;
  const int n = NT ? NT : n_rt, m = MT ? MT : m_rt, o_n = ONT ? ONT : on_rt;
  extern __shared__ uint4 smem[];
  uint32_t* xs = reinterpret_cast<uint32_t*>(smem);

  // block -> (x row tile, split, block of output rows); the row tile runs
  // fastest so the tiles of one weight slice run side by side
  const int tiles = (M + R - 1) / R;
  int bid = blockIdx.x;
  const int tile = bid % tiles;
  bid /= tiles;
  const int s = bid % S, rb = bid / S;
  const int m0 = tile * R;
  const int k0 = s * kps, cols = min(kps, K - k0);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nblocks = K / m, groups = K / kGroup, owords = o_n / 4;
  const int b0 = k0 / m, nb = cols / m;          // N:M blocks of the slice
  const int g0 = k0 / kGroup;
  const int ne = OUT ? (cols / kGroup) * o_n : 0;  // outliers of the slice
  const int steps = max((nb + 31) / 32, (ne + 31) / 32);
  const int obase = rb * kBlockRows + warp * kRowsPerWarp;

  // step t: lane l takes N:M block 32t + l and outlier entry 32t + l of the
  // slice, for each of the warp's rows; rows past N load zeros
  auto load = [&](int step, Raw (&raw)[kRowsPerWarp]) {
    const int e = step * 32 + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int o = obase + r;
      raw[r].word = 0u;
      raw[r].vals = make_uint4(0u, 0u, 0u, 0u);
      raw[r].oval = 0u;
      raw[r].oword = 0u;
      if (o < N && e < nb) {
        const size_t blk = size_t(o) * nblocks + b0 + e;
        raw[r].word = __ldg(meta + blk);
        raw[r].vals = load_vals<VT, NT>(values + blk * n, n);
      }
      if constexpr (OUT) {
        if (o < N && e < ne) {
          const size_t og = size_t(o) * groups + g0 + e / o_n;
          const int j = e % o_n;
          raw[r].oval = __ldg(o_values + og * o_n + j);
          raw[r].oword = __ldg(o_meta + og * owords + j / 4);
        }
      }
    }
  };
  auto compute = [&](int step, const Raw (&raw)[kRowsPerWarp],
                     float (&acc)[kRowsPerWarp][R],
                     const float (&sc)[kRowsPerWarp]) {
    const int e = step * 32 + lane;
    if (e < nb) {
      const int base = e * m;
      const int pbase = padded(base);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const uint32_t w[4] = {raw[r].vals.x, raw[r].vals.y, raw[r].vals.z,
                               raw[r].vals.w};
        const uint32_t word = raw[r].word;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          if (k < n) {
            const int idx = (word >> (4 * k)) & 0xFu;
            const int c = m == 16 ? pbase + idx : padded(base + idx);
            fma_col<R>(acc[r], value_at<VT>(w, k, sc[r]), load_col<R>(xs, c));
          }
        }
      }
    }
    if constexpr (OUT) {
      if (e < ne) {
        const int gbase = (e / o_n) * kGroup, shift = 8 * ((e % o_n) % 4);
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const int c = padded(gbase + ((raw[r].oword >> shift) & 0xFFu));
          fma_col<R>(acc[r], lo_bf16(raw[r].oval), load_col<R>(xs, c));
        }
      }
    }
  };

  // the first kDepth - 1 steps' weight loads go out before x is staged
  Raw ring[kDepth][kRowsPerWarp];
#pragma unroll
  for (int d = 0; d + 1 < kDepth; ++d)
    if (d < steps) load(d, ring[d]);
  float acc[kRowsPerWarp][R];
  float sc[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
    for (int i = 0; i < R; ++i) acc[r][i] = 0.f;
    sc[r] = (INT8 && obase + r < N) ? __ldg(scale + obase + r) : 1.f;
  }

  // the slice of x, transposed to [column][R rows] (rows past M are 0): a
  // thread takes 8 columns of a pair of rows, two 16-byte loads
  for (int t = threadIdx.x; t < (cols / 8) * (R / 2); t += kThreads) {
    const int i = t % (R / 2), c = (t / (R / 2)) * 8;
    const int ma = m0 + 2 * i, mb = ma + 1;
    uint4 a = make_uint4(0u, 0u, 0u, 0u), b = a;
    if (ma < M) a = __ldg(reinterpret_cast<const uint4*>(x + size_t(ma) * K + k0 + c));
    if (mb < M) b = __ldg(reinterpret_cast<const uint4*>(x + size_t(mb) * K + k0 + c));
    const uint32_t av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      xs[padded(c + 2 * j) * (R / 2) + i] = __byte_perm(av[j], bv[j], 0x5410);
      xs[padded(c + 2 * j + 1) * (R / 2) + i] =
          __byte_perm(av[j], bv[j], 0x7632);
    }
  }
  __syncthreads();

  // while step t computes, the loads of steps t + 1 .. t + kDepth - 1 are
  // in flight; unrolled by kDepth so every ring slot is a constant
  for (int t0 = 0; t0 < steps; t0 += kDepth) {
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      const int step = t0 + d;
      if (step < steps) {
        if (step + kDepth - 1 < steps)
          load(step + kDepth - 1, ring[(d + kDepth - 1) % kDepth]);
        compute(step, ring[d], acc, sc);
      }
    }
  }

  // butterfly: lane l adds lane l ^ off's sum, off = 16, 8, 4, 2, 1
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[r][i] += __shfl_xor_sync(0xffffffffu, acc[r][i], off);

  // lane r * R + i holds output row obase + r, x row m0 + i
  float mine = 0.f;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int i = 0; i < R; ++i)
      if (lane == r * R + i) mine = acc[r][i];
  const int o = obase + lane / R, mm = m0 + lane % R;
  const bool writes = lane < kRowsPerWarp * R && o < N && mm < M;
  if (S == 1) {
    if (writes) y[size_t(mm) * N + o] = __float2bfloat16(mine);
    return;
  }
  if (writes) ws[(size_t(s) * M + mm) * N + o] = mine;
  splitk::reduce_splits(ws, counters + rb * tiles + tile, y, M, N, S, m0, R,
                        rb * kBlockRows, kBlockRows, kThreads);
}

#define DECODE_PARAMS                                                      \
  const bf16 *__restrict__ x, const VT *__restrict__ values,               \
      const float *__restrict__ scale, const uint32_t *__restrict__ meta,  \
      const unsigned short *__restrict__ o_values,                         \
      const uint32_t *__restrict__ o_meta, bf16 *__restrict__ y,           \
      float *__restrict__ ws, int *__restrict__ counters, int M, int K,    \
      int N, int n, int m, int o_n, int S, int kps
#define DECODE_ARGS \
  x, values, scale, meta, o_values, o_meta, y, ws, counters, M, K, N, n, m, \
      o_n, S, kps

// the main path's shape: 8:16 values with 16:256 outliers
template <int R, typename VT>
__global__ void __launch_bounds__(kThreads)
fused_decode_816_kernel(DECODE_PARAMS) {
  decode_body<R, VT, 8, 16, 16, true>(DECODE_ARGS);
}

// every other n <= 8, m <= 16 and o_n the wrapper accepts
template <int R, typename VT>
__global__ void __launch_bounds__(kThreads)
fused_decode_kernel(DECODE_PARAMS) {
  decode_body<R, VT, 0, 0, 0, true>(DECODE_ARGS);
}

// nm_spmm's main shape: 8:16 values, no outliers
template <int R, typename VT>
__global__ void __launch_bounds__(kThreads)
nm_decode_816_kernel(DECODE_PARAMS) {
  decode_body<R, VT, 8, 16, 0, false>(DECODE_ARGS);
}

// nm_spmm at every other n <= 8, m <= 16, or on unaligned bf16 values
template <int R, typename VT>
__global__ void __launch_bounds__(kThreads)
nm_decode_kernel(DECODE_PARAMS) {
  decode_body<R, VT, 0, 0, 0, false>(DECODE_ARGS);
}

template <int R, typename VT, bool OUT>
void launch_r(dim3 grid, size_t smem, cudaStream_t stream, bool main_shape,
              DECODE_PARAMS) {
  auto kernel = OUT ? (main_shape ? fused_decode_816_kernel<R, VT>
                                  : fused_decode_kernel<R, VT>)
                    : (main_shape ? nm_decode_816_kernel<R, VT>
                                  : nm_decode_kernel<R, VT>);
  kernel<<<grid, kThreads, smem, stream>>>(DECODE_ARGS);
}

template <typename VT, bool OUT>
int launch(const void* x, const void* values, const void* scale,
           const void* meta, const void* o_values, const void* o_meta,
           void* y, void* ws, void* counters, int M, int K, int N, int n,
           int m, int o_n, int R, int S, int kps, void* stream) {
  if ((R != 2 && R != 4 && R != 8) || S < 1 || kps <= 0 || kps % kGroup ||
      size_t(kps) * 2 * R > size_t(kMaxSliceBytes) ||
      size_t(S) * kps < size_t(K) || size_t(S - 1) * kps >= size_t(K) ||
      (!OUT && (n < 1 || n > 8 || m < n || m > 16 || K % m || K % 8)))
    return int(cudaErrorInvalidValue);
  const int tiles = (M + R - 1) / R;
  const int row_blocks = (N + kBlockRows - 1) / kBlockRows;
  const dim3 grid(tiles * S * row_blocks);
  const size_t smem = size_t(padded(kps)) * R * 2;  // < 48 KB
  // the 8:16 instances read a block's 8 bf16 values in one 16-byte load
  const bool main_shape =
      n == 8 && m == 16 && (OUT ? o_n == 16
                                : (std::is_same<VT, int8_t>::value ||
                                   (reinterpret_cast<uintptr_t>(values) &
                                    15u) == 0));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xp = static_cast<const bf16*>(x);
  const VT* vp = static_cast<const VT*>(values);
  const float* sp = static_cast<const float*>(scale);
  const uint32_t* mp = static_cast<const uint32_t*>(meta);
  const unsigned short* ovp = static_cast<const unsigned short*>(o_values);
  const uint32_t* omp = static_cast<const uint32_t*>(o_meta);
  bf16* yp = static_cast<bf16*>(y);
  float* wp = static_cast<float*>(ws);
  int* cp = static_cast<int*>(counters);
#define LAUNCH(RR)                                                            \
  launch_r<RR, VT, OUT>(grid, smem, st, main_shape, xp, vp, sp, mp, ovp, omp, \
                        yp, wp, cp, M, K, N, n, m, o_n, S, kps)
  if (R == 2)
    LAUNCH(2);
  else if (R == 4)
    LAUNCH(4);
  else
    LAUNCH(8);
#undef LAUNCH
  return int(cudaGetLastError());
}

}  // namespace

// The Python wrapper (kernels/fused_sparse_linear.py) checks device, dtype,
// shapes, contiguity and alignment (bf16 values 16-byte aligned, int8 values
// 8-byte aligned, K % 256 == 0, o_n a multiple of 4) and passes its plan:
// `rows` x rows per block (2, 4 or 8), `splits` S and `k_per_split` (a
// multiple of 256 with (S - 1) * k_per_split < K <= S * k_per_split), the
// workspace (S * M * N f32, used when S > 1) and the counters (one int32 per
// output tile, all 0; the kernel leaves them 0).  Each returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a plan
// it does not take.
extern "C" int fused_sparse_linear_decode_bf16(
    const void* x, const void* values, const void* meta, const void* o_values,
    const void* o_meta, void* y, void* workspace, void* counters, int M,
    int K, int N, int n, int m, int o_n, int rows, int splits,
    int k_per_split, void* stream) {
  return launch<bf16, true>(x, values, nullptr, meta, o_values, o_meta, y,
                            workspace, counters, M, K, N, n, m, o_n, rows,
                            splits, k_per_split, stream);
}

extern "C" int fused_sparse_linear_decode_int8(
    const void* x, const void* values, const void* meta, const void* o_values,
    const void* o_meta, const void* scale, void* y, void* workspace,
    void* counters, int M, int K, int N, int n, int m, int o_n, int rows,
    int splits, int k_per_split, void* stream) {
  return launch<int8_t, true>(x, values, scale, meta, o_values, o_meta, y,
                              workspace, counters, M, K, N, n, m, o_n, rows,
                              splits, k_per_split, stream);
}

// nm_spmm's decode path (kernels/nm_spmm.py): the same plan, with K a
// multiple of m and of 8 and the last slice ragged where K % 256 != 0.
extern "C" int nm_spmm_decode_bf16(const void* x, const void* values,
                                   const void* meta, void* y, void* workspace,
                                   void* counters, int M, int K, int N, int n,
                                   int m, int rows, int splits,
                                   int k_per_split, void* stream) {
  return launch<bf16, false>(x, values, nullptr, meta, nullptr, nullptr, y,
                             workspace, counters, M, K, N, n, m, 0, rows,
                             splits, k_per_split, stream);
}

extern "C" int nm_spmm_decode_int8(const void* x, const void* values,
                                   const void* meta, const void* scale,
                                   void* y, void* workspace, void* counters,
                                   int M, int K, int N, int n, int m, int rows,
                                   int splits, int k_per_split,
                                   void* stream) {
  return launch<int8_t, false>(x, values, scale, meta, nullptr, nullptr, y,
                               workspace, counters, M, K, N, n, m, 0, rows,
                               splits, k_per_split, stream);
}
