// The split-K reduction shared by the port's kernels (the decode and
// prefill bodies of csrc/fused_sparse_linear*.cu and csrc/outlier_spmm.cu).
//
// A kernel that splits K writes each split's f32 partial sums of an output
// tile to the workspace, [S, M, N], and calls reduce_splits.  The last
// block to arrive for the tile (a counter per tile, which it resets to 0
// for the next call) sums the S partials in split order, 0 + p0 + p1 + ...,
// and writes y in bf16: no float atomics and no memset launch, so every
// call gives the same bits.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace splitk {

// two floats rounded to bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return uint32_t(__bfloat16_as_ushort(__float2bfloat16(lo))) |
         (uint32_t(__bfloat16_as_ushort(__float2bfloat16(hi))) << 16);
}

// The partials of splits s0 .. s0 + C - 1 at p (C loads in flight), added
// to sum in split order.
template <int C, typename T>
__device__ __forceinline__ void add_splits(T& sum, const T* p, size_t stride,
                                           int s0) {
  T part[C];
#pragma unroll
  for (int i = 0; i < C; ++i) part[i] = __ldcg(p + (s0 + i) * stride);
#pragma unroll
  for (int i = 0; i < C; ++i) {
    if constexpr (std::is_same<T, float4>::value) {
      sum.x += part[i].x;
      sum.y += part[i].y;
      sum.z += part[i].z;
      sum.w += part[i].w;
    } else {
      sum += part[i];
    }
  }
}

// Called by every thread of the block after its partials for the output
// tile (rows [m0, m0 + rows) of x, output columns [o0, o0 + cols) of y) are
// in the workspace.  Once the last split has arrived that block sums the S
// partials in split order into y; four outputs a thread at a time where N
// and cols are multiples of 4 (o0 then is too).
__device__ __forceinline__ void reduce_splits(
    const float* __restrict__ ws, int* __restrict__ counter,
    __nv_bfloat16* y, int M, int N, int S, int m0, int rows, int o0, int cols,
    int threads) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(counter, 1) == S - 1;
    if (last) *counter = 0;  // every split has arrived: ready for next call
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const size_t stride = size_t(M) * N;
  if (N % 4 == 0 && cols % 4 == 0) {
    for (int t = threadIdx.x; t < rows * cols / 4; t += threads) {
      const int m = m0 + t / (cols / 4), o = o0 + 4 * (t % (cols / 4));
      if (m < M && o < N) {
        const float4* p =
            reinterpret_cast<const float4*>(ws + size_t(m) * N + o);
        float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
        int s = 0;
        for (; s + 4 <= S; s += 4) add_splits<4>(sum, p, stride / 4, s);
        for (; s < S; ++s) add_splits<1>(sum, p, stride / 4, s);
        *reinterpret_cast<uint2*>(y + size_t(m) * N + o) = make_uint2(
            pack_bf16x2(sum.x, sum.y), pack_bf16x2(sum.z, sum.w));
      }
    }
    return;
  }
  for (int t = threadIdx.x; t < rows * cols; t += threads) {
    const int m = m0 + t / cols, o = o0 + t % cols;
    if (m < M && o < N) {
      const float* p = ws + size_t(m) * N + o;
      float sum = 0.f;
      int s = 0;
      for (; s + 8 <= S; s += 8) add_splits<8>(sum, p, stride, s);
      for (; s < S; ++s) add_splits<1>(sum, p, stride, s);
      y[size_t(m) * N + o] = __float2bfloat16(sum);
    }
  }
}

}  // namespace splitk
