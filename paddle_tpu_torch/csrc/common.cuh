// Helpers the port's kernels share: conversion between the io dtype (f32 or
// bf16) and the f32 the math runs in, f32 ops that round one at a time,
// warp reductions, the shared-memory opt-in, one warp's matrix product on
// the tensor cores (bf16 mma.sync m16n8k16 with f32 accumulators, or the
// same fragments with f32 FMAs for f32 io), and Hopper's pieces (wgmma,
// bf16 and s8, and its shared-memory descriptors, mbarriers, tensor copies
// by TMA, bulk loads and stores, the tensor-map encoder, the cluster
// launch). Every kernel computes in f32 and rounds to the io dtype only
// where the TPU kernel it replaces rounds.

#pragma once

#include <cuda.h>
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

// f32 arithmetic written out so that nothing contracts into an FMA: a plain
// version's ops round one at a time
__device__ __forceinline__ float mul(float x, float y) { return __fmul_rn(x, y); }
__device__ __forceinline__ float add(float x, float y) { return __fadd_rn(x, y); }
__device__ __forceinline__ float sub(float x, float y) { return __fsub_rn(x, y); }

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

// The dynamic shared memory a block of `kernel` may take on the current
// device, in `bytes`: the device's opt-in maximum less the kernel's static
// shared memory, the kernel's limit raised to it once a device rather than
// at every launch (cache: the caller's zeroed int[64], one per kernel).
inline cudaError_t smem_opt_in(const void* kernel, int (&cache)[64], int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!cache[dev]) {
    int smem_max = 0;
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, kernel);
    if (err != cudaSuccess) return err;
    const int dyn = smem_max - (int)fa.sharedSizeBytes;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
    if (err != cudaSuccess) return err;
    cache[dev] = dyn;
  }
  *bytes = cache[dev];
  return cudaSuccess;
}

// kernel<<<grid, kThreads, smem, st>>>(args...) in thread-block clusters of
// `cluster` CTAs along x (grid a multiple of it): the CTAs of a cluster run
// at once on neighbouring SMs and read each other's shared memory
// (cooperative_groups::this_cluster(), map_shared_rank).
template <typename... KArgs, typename... Args>
inline cudaError_t launch_cluster(void (*kernel)(KArgs...), int grid, int cluster, size_t smem,
                                  cudaStream_t st, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// The LSTM kernels' hidden units per CTA: the smallest power of two that
// puts at most one CTA on each SM, as gru_fwd.cu chooses its columns.
// 0 when H needs more than 16.
inline int units_per_cta(int H, int n_sms) {
  for (int hc = 1; hc <= 16; hc *= 2)
    if ((H + hc - 1) / hc <= n_sms) return hc;
  return 0;
}

// ----------------------------------------------------------------- Hopper --
// (sm_90a: wgmma exists only for that target)

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// the first 1024-byte aligned address at or past p (the 128-byte swizzle's
// tiles repeat every 1024 bytes)
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// a lane's two bf16 values of one 8-column block, packed (lo in the low half)
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Tiles of 128-byte rows (64 bf16), in the 128-byte swizzle that TMA writes
// and wgmma's descriptors name: 16-byte piece c of row r lies at piece
// c ^ (r mod 8). A tile is 1024-byte aligned, so the pattern repeats every
// 8 rows.
constexpr int kSwRow = 128;

// byte offset of 16-byte piece c of row r
__device__ __forceinline__ int sw128(int r, int c) { return r * kSwRow + ((c ^ (r & 7)) << 4); }

// wgmma descriptor of a K-major (K contiguous) tile at `p`, rows of 64 K
// values, 8-row groups 1024 bytes apart (the leading offset is unused). A
// k16 step further along K adds 32 bytes, 2 in the address field.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// wgmma descriptor of an MN-major (N contiguous) operand at `p`: a row of 64
// N values for each K index, 8-K-row groups 1024 bytes apart, blocks of 64
// N values `block_bytes` apart. A k16 step further along K adds 2048 bytes.
// Taken with kTransB = 1.
__device__ __forceinline__ uint64_t sw128_desc_mn(const void* p, int block_bytes) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(block_bytes >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// D[64 x N] (+)= A[64 x 16] · B[16 x N] for one warpgroup, f32 accumulators
// in mma.sync's layout per 8 columns: d[4j + e] is row g + 8·(e / 2),
// column 8j + 2q + e % 2 of the warp's 16 rows (g = lane / 4, q = lane % 4).
// ss: A from shared memory through a K-major descriptor. rs: A from
// registers, a[0..3] the mma.sync m16n8k16 A fragment of the warp's 16 rows
// (rows g, g+8 by columns 2q, 2q+1, then 2q+8, 2q+9): the layout of two
// 8-column blocks of an accumulator, so a product's f32 result, rounded and
// packed, is the next product's A. B comes through its descriptor: K-major
// (kTransB = 0) or MN-major (kTransB = 1). scale_d 0 overwrites D.
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  template <int kTransB = 0>
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d), "n"(kTransB));
  }
  template <int kTransB = 0>
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(kTransB));
  }
};

template <>
struct Wgmma<128> {
  template <int kTransB = 0>
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
          "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
          "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d), "n"(kTransB));
  }
  template <int kTransB = 0>
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
          "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
          "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(kTransB));
  }
};

template <>
struct Wgmma<256> {
  template <int kTransB = 0>
  static __device__ __forceinline__ void ss(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
        "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
        "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
        "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
        "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
        "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "
        "%125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, %131;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
          "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
          "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
          "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
          "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
          "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
          "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
          "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(scale_d), "n"(kTransB));
  }
};

// The int8 variant: D[64 x N] (+)= A[64 x 32] · B[32 x N], s8 operands from
// shared memory through K-major descriptors (for 8-bit types wgmma takes
// both operands K-major only: it has no transpose), exact s32 accumulators
// in the same layout as the f32 ones above. A k32 step is 32 bytes of K, as
// a bf16 k16 step is. scale_d 0 overwrites D.
template <int N>
struct WgmmaS8;

template <>
struct WgmmaS8<256> {
  static __device__ __forceinline__ void ss(int32_t (&d)[128], uint64_t da, uint64_t db,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
          "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
          "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
          "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
          "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
          "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
          "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
          "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
          "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
          "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
          "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
          "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
          "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
          "+r"(d[126]), "+r"(d[127])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// the warpgroup's products, all but the newest N groups, are done
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses to registers that an asynchronous
// product reads or writes across the points where this stands.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_acc(int32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// this thread's writes to shared memory, visible to the async proxy (wgmma,
// TMA stores)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the named barrier `id` (1-15; 0 is __syncthreads') over `threads` threads
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// the two halves of a cluster barrier (cooperative_groups' cluster.sync()
// is both), each executed by every thread of the cluster's CTAs. The relaxed
// arrival orders no memory: it says that this CTA runs, so a CTA whose wait
// has returned may write into its shared memory (map_shared_rank).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

constexpr long long kMbarSpinCycles = 20000000000LL;  // about 10 s: a copy that never lands traps

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

// after one thread's mbar_inits, before any thread uses the barriers
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// this thread's arrival (releasing its earlier writes)
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// this thread's arrival, and `bytes` more for the tensor copies to bring
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// until the barrier's phase of this parity completed (acquiring what its
// arrivals released and its copies wrote)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const long long start = clock64();
  for (;;) {
    unsigned done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - start > kMbarSpinCycles) __trap();
  }
}

// the box at (c0, c1) of a 2-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar)) : "memory");
}

// the same for a 4-D map, the box at (c0, c1, c2, c3)
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1, int c2,
                                         int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_u32(bar)) : "memory");
}

// a box of shared memory to the 4-D map's box at (c0, c1, c2, c3), by the
// bulk-copy engine (its bulk group); elements outside the tensor are not written
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3) : "memory");
}

// the same for a 2-D map, the box at (c0, c1)
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0), "r"(c1) : "memory");
}

// bytes (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory by the bulk-copy engine, completing on `bar` as the tensor
// copies do (an mbar_expect names the bytes first); the source must not be
// written in the same launch
__device__ __forceinline__ void bulk_load(void* smem, const void* gmem, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(smem)), "l"(gmem), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// the device's nanosecond clock, the same on every SM
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// bytes from shared to global memory by the bulk-copy engine: the copy runs
// on while the thread goes on
__device__ __forceinline__ void bulk_store(void* gmem, const void* smem, int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(gmem), "r"(smem_u32(smem)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// this thread's bulk copies, all but the newest N groups, have read their source
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// this thread's bulk copies are done
__device__ __forceinline__ void bulk_wait() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

// cuTensorMapEncodeTiled, found at run time through cudaGetDriverEntryPoint
// (the libraries link only the CUDA runtime)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tensor of `rank` dimensions (dims innermost first, the innermost
// contiguous; strides in bytes of dimensions 1.., multiples of 16) of
// `dtype` (bf16 unless named) read and written as boxes of `box`, 128-byte
// swizzled as wgmma's descriptors name them (box[0] one 128-byte row: 64
// bf16, 128 int8, 32 int32); elements outside the tensor read as zeros and
// are not written. False where the encoder refuses.
inline bool encode_tiled(CUtensorMap* m, int rank, const void* base, const cuuint64_t* dims,
                         const cuuint64_t* strides, const cuuint32_t* box,
                         CUtensorMapDataType dtype = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  const EncodeTiled fn = tensor_map_encoder();
  if (!fn || rank < 1 || rank > 5) return false;
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return fn(m, dtype, rank, const_cast<void*>(base), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---------------------------------------------------------- dW products --
// The recurrent kernels' weight gradients off the recurrence:
// c[M, N] = Σ_r a[r, :M]ᵀ bm[r, :N] over R rows (h_prevᵀ dgates over all
// T·B rows), bf16 in, f32 accumulators, each element written once and
// rounded once: the same bits on every run. a's rows lie lda apart, bm's
// ldb and c's ldc. A CTA owns a 64 x 128 tile of c and walks every row in
// chunks of 32 (a ring of four, cp.async); warp w computes its 32 x 32
// quarter-strip, m-tile w&1, n w>>1. Both operands are row-major over r, so
// their fragments come transposed by ldmatrix's .trans.
constexpr int kDwM = 64, kDwN = 128, kDwK = 32, kDwStages = 4;
constexpr int kDwLdA = kDwM + 8, kDwLdB = kDwN + 8;  // padded by 16 bytes against bank conflicts
constexpr size_t kDwSmem = (size_t)kDwStages * kDwK * (kDwLdA + kDwLdB) * sizeof(__nv_bfloat16);

// Four 8x8 bf16 matrices from shared memory, each transposed: lane l gives
// the address of row l % 8 of matrix l / 8; r[i] is matrix i.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}

// kVec: the rows copied 16 bytes at a time with cp.async and c written in
// pairs, which needs M, N, lda, ldb and ldc multiples of 8 and 16-byte
// aligned bases; else element by element.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
dw_product_kernel(const __nv_bfloat16* __restrict__ a, int lda, const __nv_bfloat16* __restrict__ bm,
                  int ldb, __nv_bfloat16* __restrict__ c, int ldc, int R, int M, int N) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char dw_smem[];
  bf16* sa = reinterpret_cast<bf16*>(dw_smem);  // [kDwStages][kDwK][kDwLdA]
  bf16* sb = sa + kDwStages * kDwK * kDwLdA;     // [kDwStages][kDwK][kDwLdB]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;
  const int m0 = blockIdx.y * kDwM, n0 = blockIdx.x * kDwN;
  const int nk = (R + kDwK - 1) / kDwK;
  auto stage = [&](int ch) {  // rows [32·ch, 32·ch + 32), zeros past R, M and N
    if (ch < nk) {
      const int r0 = ch * kDwK;
      bf16* da = sa + (ch % kDwStages) * kDwK * kDwLdA;
      bf16* db = sb + (ch % kDwStages) * kDwK * kDwLdB;
      if constexpr (kVec) {
        for (int i = tid; i < kDwK * kDwM / 8; i += kThreads) {
          const int r = i / (kDwM / 8), m = (i % (kDwM / 8)) * 8;
          const bool ok = r0 + r < R && m0 + m < M;
          cp_async16(da + r * kDwLdA + m, ok ? a + (size_t)(r0 + r) * lda + m0 + m : a, ok ? 16 : 0);
        }
        for (int i = tid; i < kDwK * kDwN / 8; i += kThreads) {
          const int r = i / (kDwN / 8), n = (i % (kDwN / 8)) * 8;
          const bool ok = r0 + r < R && n0 + n < N;
          cp_async16(db + r * kDwLdB + n, ok ? bm + (size_t)(r0 + r) * ldb + n0 + n : bm,
                     ok ? 16 : 0);
        }
      } else {
        for (int i = tid; i < kDwK * kDwM; i += kThreads) {
          const int r = i / kDwM, m = i % kDwM;
          da[r * kDwLdA + m] = r0 + r < R && m0 + m < M ? a[(size_t)(r0 + r) * lda + m0 + m]
                                                         : from_f<bf16>(0.f);
        }
        for (int i = tid; i < kDwK * kDwN; i += kThreads) {
          const int r = i / kDwN, n = i % kDwN;
          db[r * kDwLdB + n] = r0 + r < R && n0 + n < N ? bm[(size_t)(r0 + r) * ldb + n0 + n]
                                                         : from_f<bf16>(0.f);
        }
      }
    }
    if constexpr (kVec) cp_async_commit();
  };
#pragma unroll
  for (int ch = 0; ch < kDwStages - 1; ++ch) stage(ch);
  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) zero(acc[mi]);
  const int mat = lane >> 3, rr = lane & 7;  // the matrix and row this lane addresses
  for (int ch = 0; ch < nk; ++ch) {
    cp_async_wait<kDwStages - 2>();
    __syncthreads();  // chunk ch landed for every thread; chunk ch-1's buffers are free
    stage(ch + kDwStages - 1);
    const bf16* ta = sa + (ch % kDwStages) * kDwK * kDwLdA;
    const bf16* tb = sb + (ch % kDwStages) * kDwK * kDwLdB;
#pragma unroll
    for (int kk = 0; kk < kDwK / 16; ++kk) {
      uint32_t fa[2][4], fb[2][4];
      // A[m][k] = a[k][m]: matrix i holds m-block i&1, k-block i>>1
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4_trans(fa[mi], ta + (16 * kk + (mat >> 1) * 8 + rr) * kDwLdA + wm * 32 +
                                      mi * 16 + (mat & 1) * 8);
      // B[k][n] = bm[k][n]: matrix i holds k-block i&1, n-block i>>1, so
      // b0, b1 of n-tile 2ni in r[0], r[1] and of 2ni+1 in r[2], r[3]
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
        ldmatrix_x4_trans(fb[ni], tb + (16 * kk + (mat & 1) * 8 + rr) * kDwLdB + wn * 32 +
                                      ni * 16 + (mat >> 1) * 8);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16(acc[mi][nt], fa[mi][0], fa[mi][1], fa[mi][2], fa[mi][3],
                   fb[nt >> 1][(nt & 1) * 2], fb[nt >> 1][(nt & 1) * 2 + 1]);
    }
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = m0 + wm * 32 + mi * 16 + frag_row(2 * hf);
        const int col = n0 + wn * 32 + frag_col(nt, 0);
        if (row >= M) continue;
        bf16* out = c + (size_t)row * ldc + col;
        if constexpr (kVec) {
          if (col < N)  // N is a multiple of 8: col + 1 < N too
            *reinterpret_cast<uint32_t*>(out) =
                pack_bf16x2(acc[mi][nt][2 * hf], acc[mi][nt][2 * hf + 1]);
        } else {
          if (col < N) out[0] = from_f<bf16>(acc[mi][nt][2 * hf]);
          if (col + 1 < N) out[1] = from_f<bf16>(acc[mi][nt][2 * hf + 1]);
        }
      }
}

// dw_product_kernel on `stream`; vec as its kVec.
inline cudaError_t launch_dw_product(const __nv_bfloat16* a, int lda, const __nv_bfloat16* bm,
                                     int ldb, __nv_bfloat16* c, int ldc, int R, int M, int N,
                                     bool vec, cudaStream_t stream) {
  auto kernel = vec ? dw_product_kernel<true> : dw_product_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kDwSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kDwN - 1) / kDwN, (M + kDwM - 1) / kDwM);
  kernel<<<grid, kThreads, kDwSmem, stream>>>(a, lda, bm, ldb, c, ldc, R, M, N);
  return cudaGetLastError();
}

}  // namespace ptt
