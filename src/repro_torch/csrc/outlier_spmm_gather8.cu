// The first Hopper kernel of the structured-outlier matmul, kept
// to be timed beside its successors and never picked by the plan:
// y = x @ O^T, where O holds n exact salient values in every 256-wide input
// group of each row (the N:256 pattern of core/outliers.py).
// csrc/outlier_spmm.cu's decode and prefill bodies replaced it; the wrapper
// (kernels/outlier_spmm.py) reaches it only through
// force_plan=gather8_plan(...).
//
// It replaced the Pallas TPU kernel
//   outlier_spmm  src/repro/kernels/outlier_spmm.py:74
//                 (_kernel :55, _decompress_outlier_tile :44)
//
// Layout (bf16 values, int32 words; K = in, N = out, G = K/256):
//   x       [M, K]
//   values  [N, G, n]      exact salient values
//   meta    [N, G, n/4]    four 8-bit in-group indices per word (read
//                          unsigned: index 255 makes the word negative)
//   y       [M, N]         bf16, f32 accumulation
//
// Design: a block takes 16 output rows (8 warps, 2 rows each) and 8 rows of
// x, stages x in 2048-column chunks in shared memory transposed to
// [column][8 rows] with 2-byte loads, each lane takes one meta word (four
// indices) and its four values and adds v * x[m, col] for the 8 x rows, and
// a warp shuffle reduction finishes each (row, m) sum.  The grid is
// (N/16, M/8), so x is staged N/16 times: at M = 512 that, not the
// outliers, sets its time (PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 256;                 // input columns per outlier group
constexpr int kBM = 8;                      // x rows per block: 16 bytes a column
constexpr int kKC = 2048;                   // x columns staged per chunk
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 2;
constexpr int kBN = kWarps * kRowsPerWarp;  // output rows per block
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float lo_bf16(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float hi_bf16(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ void fma8(float* acc, float v, const uint4& xv) {
  acc[0] += v * lo_bf16(xv.x);
  acc[1] += v * hi_bf16(xv.x);
  acc[2] += v * lo_bf16(xv.y);
  acc[3] += v * hi_bf16(xv.y);
  acc[4] += v * lo_bf16(xv.z);
  acc[5] += v * hi_bf16(xv.z);
  acc[6] += v * lo_bf16(xv.w);
  acc[7] += v * hi_bf16(xv.w);
}

__global__ void __launch_bounds__(kThreads)
outlier_gather8_kernel(const uint16_t* __restrict__ x,
                    const uint16_t* __restrict__ values,
                    const uint32_t* __restrict__ meta,
                    __nv_bfloat16* __restrict__ y, int M, int K, int N,
                    int n) {
  // xs[c] holds x[m0 .. m0 + 7, k0 + c] as 8 bf16 (zeros past M)
  __shared__ uint4 xs[kKC];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.y * kBM;
  const int o0 = blockIdx.x * kBN + warp * kRowsPerWarp;
  const int wpg = n >> 2;                          // meta words per group
  const long row_words = static_cast<long>(K / kGroup) * wpg;

  float acc[kRowsPerWarp][kBM];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int i = 0; i < kBM; ++i) acc[r][i] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kKC) {
    const int kc = min(kKC, K - k0);
    __syncthreads();                               // previous chunk consumed
    for (int c = threadIdx.x; c < kc; c += kThreads) {
      uint32_t p[kBM / 2];
#pragma unroll
      for (int i = 0; i < kBM / 2; ++i) {
        const int ma = m0 + 2 * i, mb = ma + 1;
        const uint32_t a = ma < M ? x[static_cast<long>(ma) * K + k0 + c] : 0u;
        const uint32_t b = mb < M ? x[static_cast<long>(mb) * K + k0 + c] : 0u;
        p[i] = a | (b << 16);
      }
      xs[c] = make_uint4(p[0], p[1], p[2], p[3]);
    }
    __syncthreads();

    // the chunk covers groups [k0, k0 + kc) / 256, i.e. words [w0, w1)
    const int w0 = (k0 / kGroup) * wpg, w1 = ((k0 + kc) / kGroup) * wpg;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int o = o0 + r;
      if (o >= N) break;                           // uniform in the warp
      const uint32_t* mrow = meta + o * row_words;
      const uint2* vrow =
          reinterpret_cast<const uint2*>(values + o * row_words * 4);
      for (int w = w0 + lane; w < w1; w += 32) {
        const uint32_t word = __ldg(mrow + w);
        const uint2 v = __ldg(vrow + w);
        const int base = (w / wpg) * kGroup - k0;
        fma8(acc[r], lo_bf16(v.x), xs[base + (word & 0xffu)]);
        fma8(acc[r], hi_bf16(v.x), xs[base + ((word >> 8) & 0xffu)]);
        fma8(acc[r], lo_bf16(v.y), xs[base + ((word >> 16) & 0xffu)]);
        fma8(acc[r], hi_bf16(v.y), xs[base + (word >> 24)]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int i = 0; i < kBM; ++i)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[r][i] += __shfl_xor_sync(0xffffffffu, acc[r][i], off);
  // lane r * 8 + i writes y[m0 + i, o0 + r]
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int i = 0; i < kBM; ++i) {
      const int o = o0 + r, m = m0 + i;
      if (lane == r * kBM + i && o < N && m < M)
        y[static_cast<long>(m) * N + o] = __float2bfloat16(acc[r][i]);
    }
}

}  // namespace

// The Python wrapper (kernels/outlier_spmm.py) checks device, dtype, shapes,
// contiguity and alignment (values 8-byte aligned, K % 256 == 0, n % 4 == 0)
// before calling.  Returns cudaGetLastError() after the launch.
extern "C" int outlier_spmm_gather8_bf16(const void* x, const void* values,
                                         const void* meta, void* y, int M,
                                         int K, int N, int n, void* stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  outlier_gather8_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(values),
      static_cast<const uint32_t*>(meta), static_cast<__nv_bfloat16*>(y), M, K,
      N, n);
  return int(cudaGetLastError());
}
