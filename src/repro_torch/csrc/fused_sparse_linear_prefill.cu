// Fused N:M + N:256 outlier linear for Hopper (sm_90a), prefill regime:
// y = x @ (W_nm + O)^T for the M > T rows of a prefill chunk (T, the
// threshold, in kernels/fused_sparse_linear.py), on the tensor cores.
//
// Replaces, for M > T, the Pallas TPU kernel
//   fused_sparse_linear  src/repro/kernels/fused_sparse_linear.py:75
//                        (_kernel :31, _kernel_int8 :50)
// (csrc/fused_sparse_linear.cu serves M <= T; csrc/sparse_linear.cu's
// OUTLIERS=true tile, which served M > T before, stays callable for side by
// side timing only).  It computes what the Pallas kernels compute: the kept
// 8:16 values (bf16, or int8 times the row's f32 scale rounded once to
// bf16) plus the exact bf16 outliers, unscaled, times x with f32
// accumulation, y in bf16.
//
// Layout (K = in, N = out, G = K/256; int32 words read unsigned):
//   x         [M, K] bf16 (16-byte aligned)
//   values    [N, K/m*n]         bf16 or int8
//   scale     [N] f32            int8 only
//   meta      [N, K/m]           n 4-bit in-block indices per word, ascending
//   o_values  [N, G, o_n] bf16   exact salient values
//   o_meta    [N, G, o_n/4]      four 8-bit in-group indices per word,
//                                ascending (index 255 makes the word negative)
//   workspace [S, M, N] f32      per-split partial sums (S > 1)
//   counters  [M tiles * N tiles] int32, 0 between launches
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense):
//   * M ~ 37: bytes.  The 8:16 + 16:256 weights are 1.4375 B/element with
//     bf16 values, 0.9375 with int8: w_gate [14336, 4096] is 84.4 or 55.1
//     MB, 25 or 16 us; the products (2*37*N*K) take 4.4 us.
//   * M = 512: operations.  2*512*N*K on the tensor cores after
//     decompression, 61 us for w_gate at the dense bf16 peak.
//   What this design pays on top is decompression on the integer pipes:
//   a 16-column 8:16 block costs one thread about 160 operations for its
//   N:M values (8 index extractions, 72 compare-selects over the slots a
//   sorted index can reach, 8 packs), ~40 to find its outlier run and ~50
//   for each outlier of the run: 15-20 an element, 0.1-0.15 clock an
//   element and SM at the issue rate, against 256 MACs an element at BM =
//   256 (0.06 clock at the tensor cores' peak).  So the plan keeps BM as
//   tall as M allows and the weight is decompressed ceil(M / BM) times
//   (2 at M = 512, 1 at M <= 64), and the products of a stage run while
//   the next stage is decompressed.  scripts/fused_prefill_ab.py times
//   variants side by side (PERF.md): decompression is about half of the
//   kernel's time, the outlier run most of that; the copies, products and
//   barriers alone (`nodecomp`) take 2-3x the bound.
//
// Design, against the five causes that held csrc/sparse_linear.cu's tile
// at 12-20 us per 256-wide K step:
//   1. scalar, dependent decompression -> one thread takes one 16-column
//      N:M block of one output row per K step: the block's meta word (4 B)
//      and its 8 values (one 16-byte read bf16, one 8-byte read int8) from
//      the staged stream, the 16 weights built in f32 registers by
//      compare-select over constant slot indices (no runtime-indexed array,
//      so no spill), int8 values scaled and rounded once to bf16 (the rule
//      of kernels/ref.dequantize and JAX's sparse_apply), then the outliers
//      whose 8-bit index falls in the block added to the right register (a
//      sorted group makes them one run, found by byte arithmetic on the
//      high nibbles of the group's meta words), and two 16-byte stores of
//      bf16 pairs into the B tile: no zero fill, no 2-byte scatter, no
//      barrier between the N:M values and the outliers, no read-modify-write
//      of shared memory.  W_nm is an exact zero at every salient slot, so
//      the sum is exact;
//   2. no overlap -> a ring of kStages shared-memory slots filled with
//      cp.async (16-byte copies; 8-byte for int8 values, which are only
//      8-byte aligned), each thread copying the same rows and chunks at
//      every K step: slot s holds the x tile of K step s and the compressed
//      weight stream (values, meta, the outlier values and meta of the
//      step's 256-wide group) of step s + 1.  Step t waits for its slot,
//      issues the copies of step t + kStages - 1, issues step t's
//      tensor-core products (asynchronous), decompresses step t + 1 into
//      the other of two B buffers while they run, then waits for them: one
//      barrier per 64-wide K step, kStages - 1 steps of copies in flight;
//   3. small tiles -> BM = 64, 128 or 256 rows of x by BN = 64 or 128
//      output features (256 x 128 above M = 128 where those tiles make a
//      quarter of a wave), 8 warps; every decompressed weight element
//      feeds BM rows;
//   4. too few blocks at mid M -> the plan splits K on multiples of 256 (no
//      N:M block or outlier group cut) where the tiles leave SMs idle,
//      counting waves, and takes BN = 64 where 128-wide tiles cannot fill
//      one; partials go to the f32 workspace and the last block to arrive
//      for a tile (an int32 counter it resets to 0) sums them in split
//      order, 0 + p0 + p1 + ...: no float atomics, no memset launch, the
//      same bits every call (csrc/split_reduce.cuh);
//   5. WMMA from an unswizzled tile -> wgmma.mma_async m64n64k16 (m64n32k16
//      at BM = BN = 64) bf16 -> f32, both operands read by the tensor cores
//      straight from K-major tiles in the 128-byte swizzle (16-byte chunk c
//      of row r at c ^ (r & 7), 1024-byte aligned), which the x copies and
//      the decompressing threads write directly, so their stores hit eight
//      distinct bank groups too; two warpgroups split the tile by rows (BM
//      >= 128) or columns (BM = 64).  A proxy fence makes the copies and
//      stores (generic proxy) visible to the wgmma reads (async proxy).
//      wgmma rather than mma.sync fed by ldmatrix: it runs while the
//      threads decompress the next stage and needs no fragment registers;
//      the mma.sync form of this kernel took 10% more time over the
//      variant script's cases.
// Shapes: 8:16 values with 16:256 outliers on 16-byte aligned buffers is
// compiled with constant shapes and a staged weight stream
// (fused_prefill_816_kernel); every other n <= 8, m in {1, 2, 4, 8, 16} and
// o_n (a multiple of 4 up to 256), or unaligned buffers, run the same body
// with runtime shapes, reading the weight stream straight from device
// memory (fused_prefill_kernel); x is staged in both.
//
// nm_spmm (src/repro/kernels/nm_spmm.py:86, _kernel :46, _kernel_int8 :63),
// y = x @ W_nm^T, is the same body with no outlier stream (OUT = false: no
// outlier copies, no run search, a slot without the outlier bytes):
// nm_prefill_816_kernel for 8:16 on aligned buffers with K % 64 == 0,
// nm_prefill_kernel for the rest.  Its K need only be a multiple of m and
// of 8: the slices stay multiples of 256 but for the last, the last stage
// zero-fills the x columns past K (8-column chunks, whole since K % 8 ==
// 0), and the generic instance builds no N:M block that starts past K.
//
// The products are exact in f32 (bf16 x bf16), so only the summation order
// differs from the plain version (kernels/ref.fused_sparse_linear_ref).
// The cp.async, proxy-fence and wgmma helpers are csrc/hopper.cuh's.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "split_reduce.cuh"

typedef __nv_bfloat16 bf16;

namespace {

using namespace hopper;

constexpr int kThreads = 256;  // 8 warps: two warpgroups
constexpr int kBK = 64;        // K columns per stage
constexpr int kStages = 3;     // ring slots
constexpr int kGroup = 256;    // columns per outlier group

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits) {
  return __uint_as_float(bits << 16);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// int8 value q of a row with scale s: q * s in f32, rounded once to bf16
__device__ __forceinline__ float dequant(int q, float s) {
  return __bfloat162float(__float2bfloat16(static_cast<float>(q) * s));
}

// Adds o to slot `slot` of the 16 registers (constant indices only).
__device__ __forceinline__ void add_at(float (&w)[16], int slot, float o) {
#pragma unroll
  for (int p = 0; p < 16; ++p) w[p] = slot == p ? w[p] + o : w[p];
}

// Bytes of one ring slot and of one B buffer.
template <int BM, int BN, typename VT, bool MAIN, bool OUT>
struct Smem {
  static constexpr int kX = BM * kBK * 2;
  static constexpr int kV = MAIN ? BN * 8 * 4 * int(sizeof(VT)) : 0;
  static constexpr int kMeta = MAIN ? BN * 16 : 0;
  // 16 bf16 outliers a row and their 4 meta words
  static constexpr int kOv = MAIN && OUT ? BN * 32 : 0;
  static constexpr int kOm = MAIN && OUT ? BN * 16 : 0;
  static constexpr int kSlot = kX + kV + kMeta + kOv + kOm;
  static constexpr int kB = BN * kBK * 2;
  // + 1 KB to align the base to the swizzle's 1024-byte period
  static constexpr int kTotal = kStages * kSlot + 2 * kB + 1024;
  static_assert(kSlot % 1024 == 0 && kX % 1024 == 0, "aligned tiles");
};

struct Args {
  const bf16* x;
  const void* values;
  const float* scale;
  const uint32_t* meta;
  const unsigned short* o_values;
  const uint32_t* o_meta;
  bf16* y;
  float* ws;
  int* counters;
  int M, K, N, n, m, o_n, S, kps;
};

// OUT = false is nm_spmm's product, y = x @ W_nm^T: no outlier stream, and
// K need only be a multiple of m and of 8.  The last stage of a ragged K
// zero-fills the x columns past K and builds zero weights there.
template <int BM, int BN, typename VT, bool MAIN, bool OUT>
__device__ __forceinline__ void prefill_body(const Args& a) {
  using L = Smem<BM, BN, VT, MAIN, OUT>;
  constexpr bool INT8 = std::is_same<VT, int8_t>::value;
  // the two warpgroups split the tile by rows (BM >= 128) or by columns
  // (BM = 64); each covers SLABS x 64 rows by PIECES x WI columns, one
  // wgmma.m64n<WI>k16 per (slab, piece) and k16 step
  constexpr int WG_M = BM >= 128 ? BM / 2 : BM;
  constexpr int WG_N = BM >= 128 ? BN : BN / 2;
  constexpr int SLABS = WG_M / 64;
  constexpr int WI = WG_N >= 64 ? 64 : 32;
  constexpr int PIECES = WG_N / WI;
  constexpr int NUNITS = BN * (kBK / 16);  // 16-column blocks of a stage
  constexpr int UNITS = (NUNITS + kThreads - 1) / kThreads;  // a thread's

  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (static_cast<unsigned>(
      __cvta_generic_to_shared(smem_raw)) & 1023)) & 1023);
  bf16* bt = reinterpret_cast<bf16*>(smem + kStages * L::kSlot);

  const int M = a.M, K = a.K, N = a.N;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2;  // warpgroup
  const int wg_row = BM >= 128 ? wg * WG_M : 0;
  const int wg_col = BM >= 128 ? 0 : wg * WG_N;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, s = blockIdx.z;
  const int k0 = s * a.kps, cols = min(a.kps, K - k0);
  const int steps = OUT ? cols / kBK : (cols + kBK - 1) / kBK;
  const int groups = K / kGroup;

  // the output rows and 16-column blocks this thread decompresses
  int urow[UNITS], ublk[UNITS];
  float usc[UNITS];
#pragma unroll
  for (int u = 0; u < UNITS; ++u) {
    const int unit = tid + u * kThreads;
    urow[u] = min(unit >> 2, BN - 1);
    ublk[u] = unit & 3;
    usc[u] = 1.f;
    if (INT8 && n0 + urow[u] < N) usc[u] = __ldg(a.scale + n0 + urow[u]);
  }

  auto x_tile = [&](int slot) {
    return reinterpret_cast<bf16*>(smem + slot * L::kSlot);
  };
  auto raw = [&](int slot) { return smem + slot * L::kSlot + L::kX; };

  // Each thread's copies are the same rows and chunks at every K step:
  // x row xr + 32 j, chunk xc; N:M values row vr + 64 j, chunk vc; then one
  // of: the meta words of row tid, the outlier meta of row tid - BN, or
  // half of the outlier values of row tid / 2.  Rows past M or N are
  // zero-filled from a valid address.
  constexpr int XJ = BM * 8 / kThreads, VJ = BN * 4 / kThreads;
  static_assert(XJ * kThreads == BM * 8 && VJ * kThreads == BN * 4,
                "whole copies a thread");
  const int xr = tid >> 3, xc = (tid & 7) * 8;
  const int vr = tid >> 2, vc = (tid & 3) * 8;
  const bf16* xsrc = a.x + size_t(m0 + xr) * K + xc;
  const VT* vsrc = static_cast<const VT*>(a.values) +
                   size_t(n0 + vr) * (K / 2) + vc;
  const int orow = tid < BN ? tid : tid < 2 * BN ? tid - BN : tid / 2;
  const bool o_ok = n0 + orow < N;
  const size_t obase = size_t(o_ok ? n0 + orow : 0);

  // cp.async of x for K step t (when t < steps) and, for the staged
  // shapes, the weight stream of step t + 1 (when < steps), into `slot`
  auto issue = [&](int slot, int tx, int tw) {
    if (tx < steps) {
      const int kc = k0 + tx * kBK;
      bf16* xs = x_tile(slot);
#pragma unroll
      for (int j = 0; j < XJ; ++j) {
        const int r = xr + j * (kThreads / 8);
        const bool ok = m0 + r < M && (OUT || kc + xc < K);
        cp_async16(xs + swz(r, xc),
                   ok ? xsrc + size_t(j) * (kThreads / 8) * K + kc : a.x, ok);
      }
    }
    if constexpr (MAIN) {
      if (tw < steps) {
        const int kc = k0 + tw * kBK;
        const int g = kc / kGroup;
        unsigned char* p = raw(slot);
        // values: 32 a row per step (64 B bf16, 32 B int8)
#pragma unroll
        for (int j = 0; j < VJ; ++j) {
          const int r = vr + j * (kThreads / 4);
          const bool ok = n0 + r < N;
          const VT* src = ok ? vsrc + size_t(j) * (kThreads / 4) * (K / 2) +
                                   kc / 2
                             : static_cast<const VT*>(a.values);
          VT* dst = reinterpret_cast<VT*>(p) + r * 32 + vc;
          if constexpr (INT8)
            cp_async8(dst, src, ok);
          else
            cp_async16(dst, src, ok);
        }
        p += L::kV;
        if (tid < BN) {  // meta: 4 words a row per step
          cp_async16(p + orow * 16, a.meta + obase * (K / 16) + kc / 16,
                     o_ok);
        } else if (OUT && tid < 2 * BN) {  // the group's 4 outlier meta words
          cp_async16(p + L::kMeta + L::kOv + orow * 16,
                     a.o_meta + (obase * groups + g) * 4, o_ok);
        }
        // the group's 16 outlier values, half a row a thread
        if (OUT && tid < 2 * BN) {
          const int r = tid >> 1, c = tid & 1;
          const bool ok = n0 + r < N;
          const size_t og = size_t(ok ? n0 + r : 0) * groups + g;
          cp_async16(p + L::kMeta + r * 32 + c * 16,
                     a.o_values + og * 16 + c * 8, ok);
        }
      }
    }
  };

  // decompress K step t's weights into B buffer `buf`, from ring `slot`
  // (the staged shapes) or from device memory (the others)
  auto decompress = [&](int slot, int t, int buf) {
    bf16* b = bt + buf * (BN * kBK);
    const int kc = k0 + t * kBK;
#pragma unroll
    for (int u = 0; u < UNITS; ++u) {
      if (NUNITS % kThreads && tid + u * kThreads >= NUNITS) break;
      const int r = urow[u], j = ublk[u];
      const int o = n0 + r;
      const int jj = ((kc & (kGroup - 1)) >> 4) + j;  // block within group
      float w[16];
#pragma unroll
      for (int p = 0; p < 16; ++p) w[p] = 0.f;
      if constexpr (MAIN) {
        const unsigned char* p8 = raw(slot);
        const uint32_t word = reinterpret_cast<const uint32_t*>(
            p8 + L::kV)[r * 4 + j];
        float v[8];
        if constexpr (INT8) {
          const uint2 q = *reinterpret_cast<const uint2*>(
              p8 + r * 32 + j * 8);
#pragma unroll
          for (int k = 0; k < 8; ++k)
            v[k] = dequant(static_cast<int8_t>((k < 4 ? q.x : q.y) >>
                                               (8 * (k & 3))),
                           usc[u]);
        } else {
          const uint4 q = *reinterpret_cast<const uint4*>(
              p8 + r * 64 + j * 16);
          const uint32_t qw[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
          for (int k = 0; k < 8; ++k)
            v[k] = bf16_bits_to_float(k & 1 ? qw[k >> 1] >> 16
                                            : qw[k >> 1] & 0xffffu);
        }
        // kept value k sits at slot idx_k, idx_k in [k, k + 8]: the
        // indices of a block are distinct and ascending
#pragma unroll
        for (int p = 0; p < 16; ++p) {
#pragma unroll
          for (int k = (p > 8 ? p - 8 : 0); k <= (p < 7 ? p : 7); ++k)
            w[p] = ((word >> (4 * k)) & 0xFu) == uint32_t(p) ? v[k] : w[p];
        }
        // the group's outliers with index in [16 jj, 16 jj + 16): sorted,
        // so entries [c, e) of the group
        if constexpr (OUT) {
          const unsigned char* om = p8 + L::kV + L::kMeta + L::kOv + r * 16;
          const unsigned short* ov = reinterpret_cast<const unsigned short*>(
              p8 + L::kV + L::kMeta) + r * 16;
          const uint4 ow = *reinterpret_cast<const uint4*>(om);
          // c = #(block ids < jj), e = c + #(block ids == jj), counted on
          // the high nibbles four bytes at a time: each byte (id | 0x80) - t
          // keeps its borrow inside the byte, its top bit set exactly when
          // id >= t
          const uint32_t tj = 0x01010101u * uint32_t(jj);
          const uint32_t ow4[4] = {ow.x, ow.y, ow.z, ow.w};
          int ge = 0, gt = 0;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const uint32_t h = ((ow4[q] >> 4) & 0x0F0F0F0Fu) | 0x80808080u;
            ge += __popc((h - tj) & 0x80808080u);
            gt += __popc((h - tj - 0x01010101u) & 0x80808080u);
          }
          const int c = 16 - ge, e = 16 - gt;
          for (int i = c; i < e; ++i)
            add_at(w, om[i] & 15, bf16_bits_to_float(ov[i]));
        }
      } else if (o < N) {
        const int n = a.n, m = a.m, o_n = a.o_n;
        const int col0 = kc + 16 * j;
        const size_t nb = size_t(K / m);
        // the N:M blocks of this 16-column block that lie before K
        const int blocks = OUT ? 16 / m : max(0, min(16, K - col0)) / m;
        for (int bb = 0; bb < blocks; ++bb) {
          const size_t blk = size_t(o) * nb + col0 / m + bb;
          const uint32_t word = __ldg(a.meta + blk);
          for (int k = 0; k < n; ++k) {
            float v;
            if constexpr (INT8)
              v = dequant(__ldg(static_cast<const int8_t*>(a.values) +
                                blk * n + k), usc[u]);
            else
              v = bf16_bits_to_float(__ldg(
                  static_cast<const unsigned short*>(a.values) + blk * n +
                  k));
            add_at(w, bb * m + int((word >> (4 * k)) & 0xFu), v);
          }
        }
        if constexpr (OUT) {
          const size_t og = size_t(o) * groups + kc / kGroup;
          for (int i = 0; i < o_n; ++i) {
            const uint32_t ow = __ldg(a.o_meta + og * (o_n / 4) + i / 4);
            const int idx = (ow >> (8 * (i & 3))) & 0xFF;
            if ((idx >> 4) == jj)
              add_at(w, idx & 15,
                     bf16_bits_to_float(__ldg(a.o_values + og * o_n + i)));
          }
        }
      }
      uint32_t pk[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) pk[q] = pack_bf16x2(w[2 * q], w[2 * q + 1]);
      *reinterpret_cast<uint4*>(b + swz(r, 16 * j)) =
          make_uint4(pk[0], pk[1], pk[2], pk[3]);
      *reinterpret_cast<uint4*>(b + swz(r, 16 * j + 8)) =
          make_uint4(pk[4], pk[5], pk[6], pk[7]);
    }
  };

  float acc[SLABS][PIECES][WI / 2];
#pragma unroll
  for (int i = 0; i < SLABS; ++i)
#pragma unroll
    for (int jp = 0; jp < PIECES; ++jp)
#pragma unroll
      for (int q = 0; q < WI / 2; ++q) acc[i][jp][q] = 0.f;

  // issue the tensor-core products of one stage, x tile `xs` times B
  // buffer `b`: asynchronous, waited for after the next stage's
  // decompression
  auto multiply = [&](const bf16* xs, const bf16* b) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int i = 0; i < SLABS; ++i)
#pragma unroll
        for (int jp = 0; jp < PIECES; ++jp) {
          // a k16 step is 32 bytes further along the swizzled rows
          const uint64_t da = tile_desc(xs + (wg_row + i * 64) * kBK) + 2 * kk;
          const uint64_t db =
              tile_desc(b + (wg_col + jp * WI) * kBK) + 2 * kk;
          if constexpr (WI == 64)
            wgmma_n64(acc[i][jp], da, db);
          else
            wgmma_n32(acc[i][jp], da, db);
        }
    wgmma_commit();
  };

  // prologue: step 0's weights into the last slot, then x(s) and the
  // weights of s + 1 into slot s for s < kStages - 1
  issue(kStages - 1, steps, 0);
  cp_async_commit();
#pragma unroll
  for (int sl = 0; sl + 1 < kStages; ++sl) {
    issue(sl, sl, sl + 1);
    cp_async_commit();
  }
  cp_async_wait<kStages - 1>();
  __syncthreads();
  decompress(kStages - 1, 0, 0);

  for (int t = 0; t < steps; ++t) {
    cp_async_wait<kStages - 2>();  // slot t % kStages has landed
    fence_proxy_async();           // copies and stores -> the wgmma's reads
    __syncthreads();               // ... for every thread; step t - 1 done
    const int nxt = t + kStages - 1;
    issue(nxt % kStages, nxt, nxt + 1);
    cp_async_commit();
    multiply(x_tile(t % kStages), bt + (t & 1) * (BN * kBK));
    if (t + 1 < steps) decompress(t % kStages, t + 1, (t + 1) & 1);
    wgmma_wait0();
  }

  // epilogue: in each m64 x n8 part of a wgmma result, thread (warp w of
  // its group, lane l) holds rows 16 w + l / 4 (+ 8) and columns
  // 2 (l % 4) + {0, 1}
  const int rbase = m0 + wg_row + (warp & 3) * 16 + (lane >> 2);
  const int cbase = n0 + wg_col + (lane & 3) * 2;
  const bool pairs = (N & 1) == 0;
  if (a.S == 1) {
#pragma unroll
    for (int i = 0; i < SLABS; ++i)
#pragma unroll
      for (int jp = 0; jp < PIECES; ++jp)
#pragma unroll
        for (int jn = 0; jn < WI / 8; ++jn)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = rbase + i * 64 + h * 8;
            const int col = cbase + jp * WI + jn * 8;
            if (row >= M) continue;
            bf16* dst = a.y + size_t(row) * N + col;
            const float v0 = acc[i][jp][4 * jn + 2 * h];
            const float v1 = acc[i][jp][4 * jn + 2 * h + 1];
            if (pairs && col + 1 < N) {
              *reinterpret_cast<__nv_bfloat162*>(dst) =
                  __floats2bfloat162_rn(v0, v1);
            } else {
              if (col < N) dst[0] = __float2bfloat16(v0);
              if (col + 1 < N) dst[1] = __float2bfloat16(v1);
            }
          }
    return;
  }
#pragma unroll
  for (int i = 0; i < SLABS; ++i)
#pragma unroll
    for (int jp = 0; jp < PIECES; ++jp)
#pragma unroll
      for (int jn = 0; jn < WI / 8; ++jn)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = rbase + i * 64 + h * 8;
          const int col = cbase + jp * WI + jn * 8;
          if (row >= M) continue;
          float* dst = a.ws + (size_t(s) * M + row) * N + col;
          if (col < N) dst[0] = acc[i][jp][4 * jn + 2 * h];
          if (col + 1 < N) dst[1] = acc[i][jp][4 * jn + 2 * h + 1];
        }
  splitk::reduce_splits(a.ws, a.counters + blockIdx.y * gridDim.x + blockIdx.x,
                        a.y, M, N, a.S, m0, BM, n0, BN, kThreads);
}

// the main path's shape: 8:16 values with 16:256 outliers, staged
template <int BM, int BN, typename VT>
__global__ void __launch_bounds__(kThreads, 1)
fused_prefill_816_kernel(Args a) {
  prefill_body<BM, BN, VT, true, true>(a);
}

// every other n <= 8, m <= 16 and o_n the wrapper accepts
template <int BM, int BN, typename VT>
__global__ void __launch_bounds__(kThreads, 1)
fused_prefill_kernel(Args a) {
  prefill_body<BM, BN, VT, false, true>(a);
}

// nm_spmm's main shape: 8:16 values, no outliers, staged (K % 64 == 0)
template <int BM, int BN, typename VT>
__global__ void __launch_bounds__(kThreads, 1)
nm_prefill_816_kernel(Args a) {
  prefill_body<BM, BN, VT, true, false>(a);
}

// nm_spmm at every other n <= 8, m <= 16, K or alignment
template <int BM, int BN, typename VT>
__global__ void __launch_bounds__(kThreads, 1)
nm_prefill_kernel(Args a) {
  prefill_body<BM, BN, VT, false, false>(a);
}

template <int BM, int BN, typename VT, bool OUT>
int launch_tile(const Args& a, bool main_shape, cudaStream_t stream) {
  const dim3 grid((a.M + BM - 1) / BM, (a.N + BN - 1) / BN, a.S);
  auto kernel = OUT ? (main_shape ? fused_prefill_816_kernel<BM, BN, VT>
                                  : fused_prefill_kernel<BM, BN, VT>)
                    : (main_shape ? nm_prefill_816_kernel<BM, BN, VT>
                                  : nm_prefill_kernel<BM, BN, VT>);
  const int smem = main_shape ? Smem<BM, BN, VT, true, OUT>::kTotal
                              : Smem<BM, BN, VT, false, OUT>::kTotal;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return int(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename VT, bool OUT>
int launch(const void* x, const void* values, const void* scale,
           const void* meta, const void* o_values, const void* o_meta,
           void* y, void* ws, void* counters, int M, int K, int N, int n,
           int m, int o_n, int bm, int bn, int S, int kps, void* stream) {
  if ((bm != 64 && bm != 128 && bm != 256) || (bn != 64 && bn != 128) ||
      (bm == 256 && bn != 128) || M < 1 ||
      N < 1 || n < 1 || n > 8 || m < n || m > 16 || 16 % m ||
      (OUT ? K % kGroup || o_n < 4 || o_n > kGroup || o_n % 4
           : K % m || K % 8) ||
      S < 1 || kps <= 0 ||
      kps % kGroup || size_t(S) * kps < size_t(K) ||
      size_t(S - 1) * kps >= size_t(K) || !aligned16(x))
    return int(cudaErrorInvalidValue);
  // the staged instances copy whole 64-column stages with 16-byte (int8
  // values: 8-byte) copies
  const bool main_shape =
      n == 8 && m == 16 && aligned16(meta) &&
      (OUT ? o_n == 16 && aligned16(o_values) && aligned16(o_meta)
           : K % kBK == 0) &&
      (std::is_same<VT, int8_t>::value
           ? (reinterpret_cast<uintptr_t>(values) & 7u) == 0
           : aligned16(values));
  Args a{static_cast<const bf16*>(x),
         values,
         static_cast<const float*>(scale),
         static_cast<const uint32_t*>(meta),
         static_cast<const unsigned short*>(o_values),
         static_cast<const uint32_t*>(o_meta),
         static_cast<bf16*>(y),
         static_cast<float*>(ws),
         static_cast<int*>(counters),
         M, K, N, n, m, o_n, S, kps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bm == 256) return launch_tile<256, 128, VT, OUT>(a, main_shape, st);
  if (bm == 64)
    return bn == 64 ? launch_tile<64, 64, VT, OUT>(a, main_shape, st)
                    : launch_tile<64, 128, VT, OUT>(a, main_shape, st);
  return bn == 64 ? launch_tile<128, 64, VT, OUT>(a, main_shape, st)
                  : launch_tile<128, 128, VT, OUT>(a, main_shape, st);
}

}  // namespace

// The Python wrapper (kernels/fused_sparse_linear.py) checks device, dtype,
// shapes, contiguity and alignment (x and bf16 values 16-byte aligned, int8
// values 8-byte aligned, K % 256 == 0, o_n a multiple of 4) and passes its
// plan: `bm` x rows and `bn` output features per block (64 or 128 each),
// `splits` S and `k_per_split` (a multiple of 256 with (S - 1) *
// k_per_split < K <= S * k_per_split), the workspace (S * M * N f32, used
// when S > 1) and the counters (one int32 per output tile, all 0; the
// kernel leaves them 0).  Each returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue for a plan it does not take.
extern "C" int fused_sparse_linear_prefill_bf16(
    const void* x, const void* values, const void* meta, const void* o_values,
    const void* o_meta, void* y, void* workspace, void* counters, int M,
    int K, int N, int n, int m, int o_n, int bm, int bn, int splits,
    int k_per_split, void* stream) {
  return launch<bf16, true>(x, values, nullptr, meta, o_values, o_meta, y,
                            workspace, counters, M, K, N, n, m, o_n, bm, bn,
                            splits, k_per_split, stream);
}

extern "C" int fused_sparse_linear_prefill_int8(
    const void* x, const void* values, const void* meta, const void* o_values,
    const void* o_meta, const void* scale, void* y, void* workspace,
    void* counters, int M, int K, int N, int n, int m, int o_n, int bm,
    int bn, int splits, int k_per_split, void* stream) {
  return launch<int8_t, true>(x, values, scale, meta, o_values, o_meta, y,
                              workspace, counters, M, K, N, n, m, o_n, bm, bn,
                              splits, k_per_split, stream);
}

// nm_spmm's prefill path (kernels/nm_spmm.py): the same plan, with K a
// multiple of m and of 8 and the last slice ragged where K % 256 != 0.
extern "C" int nm_spmm_prefill_bf16(const void* x, const void* values,
                                    const void* meta, void* y,
                                    void* workspace, void* counters, int M,
                                    int K, int N, int n, int m, int bm, int bn,
                                    int splits, int k_per_split,
                                    void* stream) {
  return launch<bf16, false>(x, values, nullptr, meta, nullptr, nullptr, y,
                             workspace, counters, M, K, N, n, m, 0, bm, bn,
                             splits, k_per_split, stream);
}

extern "C" int nm_spmm_prefill_int8(const void* x, const void* values,
                                    const void* meta, const void* scale,
                                    void* y, void* workspace, void* counters,
                                    int M, int K, int N, int n, int m, int bm,
                                    int bn, int splits, int k_per_split,
                                    void* stream) {
  return launch<int8_t, false>(x, values, scale, meta, nullptr, nullptr, y,
                               workspace, counters, M, K, N, n, m, 0, bm, bn,
                               splits, k_per_split, stream);
}
