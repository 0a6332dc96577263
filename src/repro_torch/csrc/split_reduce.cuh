// The split reductions shared by the port's kernels: the split-K sums of
// the decode and prefill bodies of csrc/fused_sparse_linear*.cu and
// csrc/outlier_spmm.cu (reduce_splits), and the split-KV softmax merge of
// csrc/paged_attention_decode.cu (merge_softmax_splits).
//
// A kernel that splits its work writes each split's f32 partials of an
// output tile to the workspace and calls one of them.  The last block to
// arrive for the tile (a counter per tile, which it resets to 0 for the
// next call) combines the partials in split order and writes the output
// in bf16: no float atomics and no memset launch, so every call gives the
// same bits.
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

// Called by every thread of the block once its partials are in the
// workspace: true in the block of the S splits of the tile that arrives
// last (then the other S - 1 partials are visible to it).
__device__ __forceinline__ bool arrive_last(int* __restrict__ counter, int S) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(counter, 1) == S - 1;
    if (last) *counter = 0;  // every split has arrived: ready for next call
  }
  __syncthreads();
  if (!last) return false;
  __threadfence();
  return true;
}

// The split-K sums, [S, M, N] in the workspace.  Called by every thread of
// the block after its partials for the output tile (rows [m0, m0 + rows) of
// x, output columns [o0, o0 + cols) of y) are in the workspace.  Once the
// last split has arrived that block sums the S partials in split order,
// 0 + p0 + p1 + ..., into y; four outputs a thread at a time where N and
// cols are multiples of 4 (o0 then is too).
__device__ __forceinline__ void reduce_splits(
    const float* __restrict__ ws, int* __restrict__ counter,
    __nv_bfloat16* y, int M, int N, int S, int m0, int rows, int o0, int cols,
    int threads) {
  if (!arrive_last(counter, S)) return;
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

// The split-KV merge of partial softmaxes (FlashDecoding's combine).  Split
// s of an output tile of `rows` rows by `cols` columns (rows even, cols a
// multiple of 4, so every row's acc is 16-byte aligned) writes its f32 partial at ws + s * rows * (cols + 2): acc [rows][cols]
// = sum_j 2^(x_j - m) v_j over the split's keys, then m [rows], the largest
// score x_j in log2 units, and l [rows] = sum_j 2^(x_j - m).  Called by
// every thread of the block after its partial is in the workspace.  Once
// the last of the S splits has arrived that block merges them in split
// order, M = max_s m_s, L = sum_s 2^(m_s - M) l_s, O = sum_s 2^(m_s - M)
// acc_s, and writes O / max(L, 1e-30) in bf16 at out(r), the address of
// row r's cols outputs (nullptr: the row is not written).
template <typename RowOut>
__device__ __forceinline__ void merge_softmax_splits(
    const float* __restrict__ ws, int* __restrict__ counter, int S, int rows,
    int cols, RowOut out, int threads) {
  if (!arrive_last(counter, S)) return;
  const size_t stride = size_t(rows) * (cols + 2);
  for (int t = threadIdx.x; t < rows * cols / 4; t += threads) {
    const int r = t / (cols / 4), c = 4 * (t % (cols / 4));
    __nv_bfloat16* dst = out(r);
    if (dst == nullptr) continue;
    const float* m = ws + size_t(rows) * cols + r;
    const float* l = m + rows;
    float M = __ldcg(m);
    for (int s = 1; s < S; ++s) M = fmaxf(M, __ldcg(m + s * stride));
    float L = 0.f;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < S; ++s) {
      const float w = exp2f(__ldcg(m + s * stride) - M);
      const float4 a = __ldcg(
          reinterpret_cast<const float4*>(ws + s * stride + r * cols + c));
      L += w * __ldcg(l + s * stride);
      o.x += w * a.x;
      o.y += w * a.y;
      o.z += w * a.z;
      o.w += w * a.w;
    }
    const float den = fmaxf(L, 1e-30f);
    *reinterpret_cast<uint2*>(dst + c) = make_uint2(
        pack_bf16x2(o.x / den, o.y / den), pack_bf16x2(o.z / den, o.w / den));
  }
}

}  // namespace splitk
