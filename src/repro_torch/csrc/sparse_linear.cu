// Sparse linear kernels for Hopper (sm_90a): y = x @ W^T with W held in the
// deployed compressed layout of models/sparse_serving.py.
//
// Replaces the Pallas TPU kernels
//   fused_sparse_linear  src/repro/kernels/fused_sparse_linear.py:75 (_kernel :31)
//   nm_spmm              src/repro/kernels/nm_spmm.py:86 (_kernel :46, _decompress_tile :34)
// with one template: OUTLIERS=true is the fused N:M + N:256 kernel,
// OUTLIERS=false the plain N:M one.  Both compute what the Pallas kernels
// compute: decompress the packed tile (4-bit N:M indices, and 8-bit
// outlier indices) into fast memory, multiply by x with f32 accumulation,
// write y in x's dtype (bf16).
//
// Layout (bf16 values, int32 words; K = in, N = out):
//   x         [M, K]
//   values    [N, K/m*n]           kept values, row-major by block
//   meta      [N, K/m]             n 4-bit indices per word (m <= 16, n <= 8)
//   o_values  [N, K/256, o_n]      exact salient values
//   o_meta    [N, K/256, o_n/4]    4 8-bit indices per word
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense):
//   decode (M up to ~64) is memory-bound.  8:16+16:256 weights are
//   1.4375 B/element, so w_gate [14336, 4096] is 84.4 MB: about 25 us.
//   A large prefill chunk is compute-bound: 2*M*N*K*(n/m + o_n/256)
//   operations for the stored entries, at most 2*M*N*K on the tensor cores
//   after decompression (M=512, w_gate: 61 us for the dense-equivalent).
//
// Design, the simple correct one first:
//   * one 64-wide tile of outputs per block and a BM-row tile of x
//     (BM = 16 for M <= 16, the decode case, else 64); the kernel masks the
//     ragged M and N edges itself, so any M works (the Pallas wrappers
//     asserted b % block_b == 0);
//   * no state across blocks: each block loops over all of K in 256-wide
//     steps (one outlier group), where the TPU grid carried an accumulator
//     in VMEM across its sequential k axis;
//   * each step zero-fills and decompresses the weight tile into shared
//     memory (one thread per (row, N:M block); the outliers are added after a
//     barrier: indices are distinct inside a group, so no two threads touch
//     one slot), loads the x tile with 16-byte loads, and runs bf16 WMMA
//     16x16x16 with f32 accumulators in registers;
//   * weights stream from device memory once per M tile: for decode that is
//     once, which is what the memory bound asks for.  Decode launches only
//     N/64 blocks (16 for wk/wv) and overlaps no load with compute, so it is
//     well short of the bound; split-K, cp.async/TMA pipelining and wgmma are
//     the next steps (a later change).
//
// W_nm holds exact zeros at the salient slots (core/pipeline.py), so adding
// an outlier to its slot in bf16 is exact; the products are exact in f32 and
// only the summation order differs from the plain version (kernels/ref.py).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BN = 64;         // output features per block
constexpr int BK = 256;        // K step: one outlier group
constexpr int LDS = BK + 8;    // shared row stride in bf16 (keeps WMMA pointers 32-byte aligned)
constexpr int LDC = BN + 8;    // f32 epilogue stride
constexpr int NTHREADS = 128;  // four warps

template <int BM>
constexpr size_t smem_bytes() {
  return size_t(BM + BN) * LDS * sizeof(bf16);
}

template <int BM, bool OUTLIERS>
__global__ void __launch_bounds__(NTHREADS)
sparse_linear_kernel(const bf16* __restrict__ x, const bf16* __restrict__ values,
                     const int32_t* __restrict__ meta,
                     const bf16* __restrict__ o_values,
                     const int32_t* __restrict__ o_meta, bf16* __restrict__ y,
                     int M, int K, int N, int n, int m, int o_n) {
  constexpr int WARPS_M = BM >= 32 ? 2 : 1;
  constexpr int WARPS_N = 4 / WARPS_M;
  constexpr int FM = BM / (16 * WARPS_M);
  constexpr int FN = BN / (16 * WARPS_N);
  static_assert(LDS * (BM + BN) * 2 >= BM * LDC * 4, "epilogue tile fits");

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sx = reinterpret_cast<bf16*>(smem);
  bf16* sw = sx + BM * LDS;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int nblocks = K / m;   // N:M blocks per row
  const int bpr = BK / m;      // N:M blocks per row in one K step
  const int ngroups = K / 256; // outlier groups per row
  const int owords = o_n / 4;  // outlier meta words per group

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x tile, 8 bf16 per 16-byte load; rows past M and columns past K are 0
    for (int it = tid; it < BM * (BK / 8); it += NTHREADS) {
      const int r = it / (BK / 8), c = (it % (BK / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M && k0 + c < K)
        v = *reinterpret_cast<const uint4*>(x + size_t(m0 + r) * K + k0 + c);
      *reinterpret_cast<uint4*>(sx + r * LDS + c) = v;
    }
    // weight tile: each thread zero-fills one N:M block and scatters its
    // n kept values to their slots
    for (int it = tid; it < BN * bpr; it += NTHREADS) {
      const int r = it / bpr, c = it % bpr;
      const int o = n0 + r, b = k0 / m + c;
      bf16* dst = sw + r * LDS + c * m;
      for (int j = 0; j < m; ++j) dst[j] = __float2bfloat16(0.0f);
      if (o < N && b < nblocks) {
        const uint32_t word = static_cast<uint32_t>(meta[size_t(o) * nblocks + b]);
        const bf16* v = values + (size_t(o) * nblocks + b) * n;
        for (int k = 0; k < n; ++k) dst[(word >> (4 * k)) & 0xFu] = v[k];
      }
    }
    if (OUTLIERS) {
      __syncthreads();
      const int g = k0 / 256;
      for (int it = tid; it < BN * o_n; it += NTHREADS) {
        const int r = it / o_n, k = it % o_n, o = n0 + r;
        if (o < N) {
          const size_t og = size_t(o) * ngroups + g;
          const uint32_t word = static_cast<uint32_t>(o_meta[og * owords + k / 4]);
          bf16* dst = sw + r * LDS + ((word >> (8 * (k % 4))) & 0xFFu);
          *dst = __float2bfloat16(__bfloat162float(*dst) +
                                  __bfloat162float(o_values[og * o_n + k]));
        }
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(a[i], sx + ((wm * FM + i) * 16) * LDS + kk, LDS);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(b[j], sw + ((wn * FN + j) * 16) * LDS + kk, LDS);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue through shared memory so the ragged edges can be masked
  float* sc = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(sc + ((wm * FM + i) * 16) * LDC + (wn * FN + j) * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int it = tid; it < BM * BN; it += NTHREADS) {
    const int r = it / BN, c = it % BN;
    if (m0 + r < M && n0 + c < N)
      y[size_t(m0 + r) * N + n0 + c] = __float2bfloat16(sc[r * LDC + c]);
  }
}

template <int BM, bool OUTLIERS>
int launch_tile(const void* x, const void* values, const void* meta,
                const void* o_values, const void* o_meta, void* y, int M, int K,
                int N, int n, int m, int o_n, void* stream) {
  auto kernel = sparse_linear_kernel<BM, OUTLIERS>;
  const size_t smem = smem_bytes<BM>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(values),
      static_cast<const int32_t*>(meta), static_cast<const bf16*>(o_values),
      static_cast<const int32_t*>(o_meta), static_cast<bf16*>(y), M, K, N, n,
      m, o_n);
  return int(cudaGetLastError());
}

template <bool OUTLIERS>
int launch(const void* x, const void* values, const void* meta,
           const void* o_values, const void* o_meta, void* y, int M, int K,
           int N, int n, int m, int o_n, void* stream) {
  if (M <= 16)
    return launch_tile<16, OUTLIERS>(x, values, meta, o_values, o_meta, y, M,
                                     K, N, n, m, o_n, stream);
  return launch_tile<64, OUTLIERS>(x, values, meta, o_values, o_meta, y, M, K,
                                   N, n, m, o_n, stream);
}

}  // namespace

// The Python wrappers (kernels/nm_spmm.py, kernels/fused_sparse_linear.py)
// check device, dtype, shapes, contiguity and alignment before calling.
// Each returns cudaGetLastError() after the launch.
extern "C" int nm_spmm_bf16(const void* x, const void* values, const void* meta,
                            void* y, int M, int K, int N, int n, int m,
                            void* stream) {
  return launch<false>(x, values, meta, nullptr, nullptr, y, M, K, N, n, m, 0,
                       stream);
}

extern "C" int fused_sparse_linear_bf16(const void* x, const void* values,
                                        const void* meta, const void* o_values,
                                        const void* o_meta, void* y, int M,
                                        int K, int N, int n, int m, int o_n,
                                        void* stream) {
  return launch<true>(x, values, meta, o_values, o_meta, y, M, K, N, n, m, o_n,
                      stream);
}
