// Helpers the port's kernels share: conversion between the io dtype (f32 or
// bf16) and the f32 the math runs in, warp reductions, and one warp's
// matrix product on the tensor cores (bf16 mma.sync m16n8k16 with f32
// accumulators, or the same fragments with f32 FMAs for f32 io). Every
// kernel computes in f32 and rounds to the io dtype only where the TPU
// kernel it replaces rounds.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ptt {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as astype does
}

// v rounded to the io dtype and widened back
template <typename T> __device__ __forceinline__ float round_io(float v) {
  return to_f<T>(from_f<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float sigmoid_f(float v) { return 1.f / (1.f + expf(-v)); }

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// c += A·B for one m16n8k16 bf16 tile with f32 accumulators, in mma.sync's
// fragment layout (a0..a3 of A, b0, b1 of B)
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory: the 16x16 block at `p` of a
// row-major array with rows `ld` elements apart (16-byte aligned rows).
// r[0..3] are rows 0-7 | 8-15 by columns 0-7 | 8-15, in the order
// (0-7, 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15): an A fragment of
// mma_bf16 as it is, or, for B stored N rows of K, b0, b1 of n-tile 0 in
// r[0], r[2] and of n-tile 1 in r[1], r[3].
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p, int ld) {
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* row = p + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// C[16 x 8·NT] += A[16 x K] · B[K x 8·NT] for one warp, in the m16n8k16
// accumulator layout: lane (g = lane/4, q = lane%4) holds, for each n-tile
// j, C[g][8j+2q], C[g][8j+2q+1], C[g+8][8j+2q], C[g+8][8j+2q+1].
// A is row-major in shared memory (A[r][k] = a[r·lda + k]); B is either
// stored as N rows of K (kBnk: B[k][n] = b[n·ldb + k], the Kᵀ and Vᵀ
// operands) or as K rows of N (B[k][n] = b[k·ldb + n], the V, dO, Q and K
// operands of the second product).
template <typename T, int NT, bool kBnk>
struct WarpMma;

template <int NT, bool kBnk>
struct WarpMma<__nv_bfloat16, NT, kBnk> {
  static __device__ __forceinline__ void run(float (&c)[NT][4], const __nv_bfloat16* a, int lda,
                                             const __nv_bfloat16* b, int ldb, int K) {
    const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
    for (int k0 = 0; k0 < K; k0 += 16) {
      const __nv_bfloat16* ar = a + g * lda + k0 + 2 * q;
      const uint32_t a0 = *reinterpret_cast<const uint32_t*>(ar);
      const uint32_t a1 = *reinterpret_cast<const uint32_t*>(ar + 8 * lda);
      const uint32_t a2 = *reinterpret_cast<const uint32_t*>(ar + 8);
      const uint32_t a3 = *reinterpret_cast<const uint32_t*>(ar + 8 * lda + 8);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = 8 * j + g;
        uint32_t b0, b1;
        if (kBnk) {
          const __nv_bfloat16* br = b + n * ldb + k0 + 2 * q;
          b0 = *reinterpret_cast<const uint32_t*>(br);
          b1 = *reinterpret_cast<const uint32_t*>(br + 8);
        } else {
          const __nv_bfloat16* br = b + (k0 + 2 * q) * ldb + n;
          b0 = pack2(br[0], br[ldb]);
          b1 = pack2(br[8 * ldb], br[9 * ldb]);
        }
        mma_bf16(c[j], a0, a1, a2, a3, b0, b1);
      }
    }
  }
};

template <int NT, bool kBnk>
struct WarpMma<float, NT, kBnk> {
  static __device__ __forceinline__ void run(float (&c)[NT][4], const float* a, int lda,
                                             const float* b, int ldb, int K) {
    const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
    for (int k = 0; k < K; ++k) {
      const float a0 = a[g * lda + k], a1 = a[(g + 8) * lda + k];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = 8 * j + 2 * q;
        const float b0 = kBnk ? b[n * ldb + k] : b[k * ldb + n];
        const float b1 = kBnk ? b[(n + 1) * ldb + k] : b[k * ldb + n + 1];
        c[j][0] = fmaf(a0, b0, c[j][0]);
        c[j][1] = fmaf(a0, b1, c[j][1]);
        c[j][2] = fmaf(a1, b0, c[j][2]);
        c[j][3] = fmaf(a1, b1, c[j][3]);
      }
    }
  }
};

// 16 bytes from global to shared memory past L1 (cp.async.cg); src_bytes
// below 16 fills the rest with zeros (0: nothing is read).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

// this thread's copies landed, all but the newest N groups
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A counter in global memory that CTAs of one launch meet at: add with
// release order (this thread's earlier writes, and through a preceding
// __syncthreads its CTA's, are visible before the add), read with acquire
// order (later reads see what the adders wrote before adding).
__device__ __forceinline__ unsigned atomic_add_release(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.add.release.gpu.global.u32 %0, [%1], %2;\n"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
}

// The accumulator's element (j, e) in the tile: row offset, column offset.
__device__ __forceinline__ int frag_row(int e) { return ((threadIdx.x & 31) >> 2) + (e >> 1) * 8; }
__device__ __forceinline__ int frag_col(int j, int e) { return 8 * j + 2 * (threadIdx.x & 3) + (e & 1); }

// What a persistent cooperative launch needs to know of the current device:
// its SM count and the shared memory a block may opt in to.
// cudaErrorNotSupported where the device cannot launch cooperatively.
inline cudaError_t coop_device(int* n_sms, int* smem_max) {
  int dev = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(n_sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  return coop ? cudaSuccess : cudaErrorNotSupported;
}

// The LSTM kernels' hidden units per CTA: the smallest power of two that
// puts at most one CTA on each SM, as gru_fwd.cu chooses its columns.
// 0 when H needs more than 16.
inline int units_per_cta(int H, int n_sms) {
  for (int hc = 1; hc <= 16; hc *= 2)
    if ((H + hc - 1) / hc <= n_sms) return hc;
  return 0;
}

}  // namespace ptt
