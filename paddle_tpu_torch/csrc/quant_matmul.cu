// The int8 GEMM for Hopper (sm_90a): C[M,N] int32 = A[M,K] int8 · B[K,N] int8,
// an exact integer sum.
//
// Replaces the TPU kernel `_quant_matmul_pallas`
// (paddle_tpu/ops/quant_kernels.py:61, body `_qmm_kernel` :54), which
// tiles C into (block_m, block_n) blocks over full-K panels under the TPU's
// int8 (32, 128) tile and VMEM model and hands other shapes to the XLA
// reference. These kernels take every shape: any M, any N, and any K up to
// 131071 (|C| <= K·128² must stay below 2³¹; the wrapper raises above it).
// The quantize of the activation and the dequant epilogue stay outside, as
// in the reference (ops/quant_kernels.py `_quantize_act`,
// `_dequant_epilogue`).
//
// What bounds it: at the quantized transformer's sites (M = 8192 rows,
// K x N from 2048 x 2048 to 2048 x 32000) the products, 2·M·N·K int8
// operations at 1,979 TOP/s, with the int32 output's bytes (4·M·N, 1.05 GB
// at the head) a close second; at the MLP's (M = 8) the bytes of B, read
// once, and the launch.
//
// Two routes, chosen before the launch by quant_kernels.kernel_route:
//
// quant_matmul_tc_kernel, every shape a tensor map can describe (K % 16 ==
// 0 and N % 4 == 0: a map's row strides are multiples of 16 bytes, and
// 16-byte aligned bases). wgmma m64n256k32 .s32.s8.s8 from 128-byte
// swizzled shared memory. For 8-bit types wgmma takes both operands
// K-major only, so B comes as the weight's K-major copy [N, K] that
// quant_kernels keeps once per weight on the card (the artifact's payload
// stays [K, N]). A CTA is two consumer warpgroups and a producer warp; it
// owns 128 x 256 output tiles, each warpgroup 64 rows of a tile with the
// whole 256 columns in 128 s32 registers a thread. The producer streams a
// tile's K through a ring of 4 stages of 128 bytes of K (16 KB of A + 32 KB
// of B a stage) by TMA, on mbarriers the consumers free after their
// products. A persistent grid of one CTA an SM walks the tiles in groups
// of 8 row panels (the panel index fastest within a group), so the tiles
// running at once share A's and B's panels in L2; the producer runs on
// into the next tile while the consumers finish one. The epilogue stages
// each warpgroup's 64 x 256 int32 in 64 x 32 chunks (one 128-byte swizzled
// row each, two buffers a warpgroup, 32 KB) and writes each once by a TMA
// store, which leaves rows and columns past M and N unwritten; TMA
// zero-fills what it reads past M, N and K, so ragged edges add nothing.
// 4 stages and the staging take 224 KB of shared memory: one CTA an SM.
//
// quant_matmul_kernel, the kept route for the rest (K % 16 != 0, N % 4 !=
// 0, a base that is not 16-byte aligned): a CTA of 8 warps owns a 128 x 128
// block of C; each warp a 64 x 32 part of it, as 4 x 4 tiles of mma.sync
// m16n8k32 (s8 · s8 -> s32). K goes through shared memory 64 at a time,
// two stages deep: cp.async 16 bytes at a time where the rows are 16-byte
// aligned and whole, else byte by byte; rows and columns past M, N and K
// are zero-filled. It reads B as it lies, [K, N] row-major: mma.sync's
// `.col` B operand wants 4 consecutive k of one column in each register
// and there is no ldmatrix.trans for 8-bit data, so B is staged row-major
// (the 16-byte chunks of a row XOR-swizzled by k, so the fragment reads
// below hit distinct banks), and each thread transposes in registers: it
// reads one 32-bit word (4 consecutive columns) from each of 4 rows and
// permutes the 4 x 4 bytes (__byte_perm). For that, the 8 columns of an
// mma's n-tile are not consecutive: fragment column p of the warp's n-tile
// t is column 4p + t of its 32, so one word feeds all 4 n-tiles, and the
// epilogue writes each thread's 4 n-tiles as 4 consecutive int32.
//
// Every output of either route is written once, from one exact sum: the
// same bits on every run.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using ptt::cp_async16;
using ptt::cp_async_commit;
using ptt::cp_async_wait;

constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr int kWarpsM = 2, kWarpsN = 4;
constexpr int kThreads = 32 * kWarpsM * kWarpsN;
constexpr int kWM = kBM / kWarpsM;  // 64 rows a warp
constexpr int kWN = kBN / kWarpsN;  // 32 columns a warp
constexpr int kMT = kWM / 16;       // m16 tiles a warp
constexpr int kNT = kWN / 8;        // n8 tiles a warp
constexpr int kLdA = kBK + 16;      // bytes a row of A: 16-byte aligned, conflict-free reads
constexpr int kABytes = kBM * kLdA;
constexpr int kBBytes = kBK * kBN;
constexpr int kStageBytes = kABytes + kBBytes;

// Byte offset of B[k][n] in a stage: row-major, 16-byte chunk index XORed
// with 2·((k/4) mod 4), so the 4 rows 4q..4q+3 a fragment read touches lie
// in distinct chunks for q = 0..3.
__device__ __forceinline__ int b_off(int k, int n) {
  return k * kBN + ((((n >> 4) ^ (((k >> 2) & 3) << 1)) << 4) | (n & 15));
}

// r[j] holds columns c0..c3 of row j; out[i] holds rows 0..3 of column i
__device__ __forceinline__ void transpose4x4(const uint32_t (&r)[4], uint32_t (&out)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);  // r0.b0 r1.b0 r0.b1 r1.b1
  const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);  // r0.b2 r1.b2 r0.b3 r1.b3
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  out[0] = __byte_perm(t0, t2, 0x5410);
  out[1] = __byte_perm(t0, t2, 0x7632);
  out[2] = __byte_perm(t1, t3, 0x5410);
  out[3] = __byte_perm(t1, t3, 0x7632);
}

// Stage k-tile kt of A (rows m0..) and B (columns n0..) into `stage`.
// kVecA: K % 16 == 0 and A 16-byte aligned; kVecB: N % 16 == 0 and B too.
template <bool kVecA, bool kVecB>
__device__ __forceinline__ void load_stage(int8_t* stage, const int8_t* __restrict__ A,
                                           const int8_t* __restrict__ B, int M, int N, int K,
                                           int m0, int n0, int k0) {
  int8_t* sA = stage;
  int8_t* sB = stage + kABytes;
  const int tid = threadIdx.x;
  if (kVecA) {
    for (int i = tid; i < kBM * kBK / 16; i += kThreads) {
      const int r = i / (kBK / 16), c = (i % (kBK / 16)) * 16;
      const bool ok = m0 + r < M && k0 + c < K;
      cp_async16(sA + r * kLdA + c, ok ? A + (long long)(m0 + r) * K + k0 + c : A, ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, c = i % kBK;
      sA[r * kLdA + c] = (m0 + r < M && k0 + c < K) ? A[(long long)(m0 + r) * K + k0 + c] : 0;
    }
  }
  if (kVecB) {
    for (int i = tid; i < kBK * kBN / 16; i += kThreads) {
      const int k = i / (kBN / 16), c = i % (kBN / 16);
      const bool ok = k0 + k < K && n0 + 16 * c < N;
      cp_async16(sB + b_off(k, 16 * c), ok ? B + (long long)(k0 + k) * N + n0 + 16 * c : B,
                 ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < kBK * kBN; i += kThreads) {
      const int k = i / kBN, n = i % kBN;
      sB[b_off(k, n)] = (k0 + k < K && n0 + n < N) ? B[(long long)(k0 + k) * N + n0 + n] : 0;
    }
  }
}

template <bool kVecA, bool kVecB>
__global__ void __launch_bounds__(kThreads)
    quant_matmul_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
                        int32_t* __restrict__ C, int M, int N, int K) {
  __shared__ __align__(16) int8_t smem[2 * kStageBytes];
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int wm = (warp / kWarpsN) * kWM, wn = (warp % kWarpsN) * kWN;

  int32_t acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  const int n_kt = (K + kBK - 1) / kBK;
  if (n_kt > 0) load_stage<kVecA, kVecB>(smem, A, B, M, N, K, m0, n0, 0);
  cp_async_commit();
  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt)
      load_stage<kVecA, kVecB>(smem + ((kt + 1) & 1) * kStageBytes, A, B, M, N, K, m0, n0,
                               (kt + 1) * kBK);
    cp_async_commit();
    cp_async_wait<1>();  // this stage's group has landed
    __syncthreads();
    const int8_t* sA = smem + (kt & 1) * kStageBytes;
    const int8_t* sB = sA + kABytes;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      // B: rows kk+4q+j (b0) and kk+16+4q+j (b1), columns wn+4g..wn+4g+3
      uint32_t lo[4], hi[4], b0[4], b1[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        lo[j] = *reinterpret_cast<const uint32_t*>(sB + b_off(kk + 4 * q + j, wn + 4 * g));
        hi[j] = *reinterpret_cast<const uint32_t*>(sB + b_off(kk + 16 + 4 * q + j, wn + 4 * g));
      }
      transpose4x4(lo, b0);  // b0[t]: column wn+4g+t, k = kk+4q..kk+4q+3
      transpose4x4(hi, b1);
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const int8_t* ar = sA + (wm + 16 * i + g) * kLdA + kk + 4 * q;
        const uint32_t a0 = *reinterpret_cast<const uint32_t*>(ar);
        const uint32_t a1 = *reinterpret_cast<const uint32_t*>(ar + 8 * kLdA);
        const uint32_t a2 = *reinterpret_cast<const uint32_t*>(ar + 16);
        const uint32_t a3 = *reinterpret_cast<const uint32_t*>(ar + 8 * kLdA + 16);
#pragma unroll
        for (int t = 0; t < kNT; ++t) {
          asm volatile(
              "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
              "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
              : "+r"(acc[i][t][0]), "+r"(acc[i][t][1]), "+r"(acc[i][t][2]), "+r"(acc[i][t][3])
              : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0[t]), "r"(b1[t]));
        }
      }
    }
    __syncthreads();
  }

  // acc[i][t][e] is row wm+16i+g+8(e/2), fragment column p = 2q+(e%2) of
  // n-tile t, which is column wn+4p+t: each (i, e) is 4 consecutive columns
  const bool vec_out = (N & 3) == 0;
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = m0 + wm + 16 * i + g + 8 * (e >> 1);
      const int col = n0 + wn + 4 * (2 * q + (e & 1));
      if (row >= M) continue;
      int32_t* out = C + (long long)row * N + col;
      if (vec_out && col + 3 < N) {
        *reinterpret_cast<int4*>(out) = make_int4(acc[i][0][e], acc[i][1][e], acc[i][2][e],
                                                  acc[i][3][e]);
      } else {
#pragma unroll
        for (int t = 0; t < kNT; ++t)
          if (col + t < N) out[t] = acc[i][t][e];
      }
    }
  }
}

template <bool kVecA, bool kVecB>
int launch(const int8_t* A, const int8_t* B, int32_t* C, int M, int N, int K, cudaStream_t st) {
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  quant_matmul_kernel<kVecA, kVecB><<<grid, kThreads, 0, st>>>(A, B, C, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ wgmma route --
namespace tc {

using namespace ptt;

constexpr int kTM = 128, kTN = 256;  // an output tile
constexpr int kTK = 128;             // bytes of K a stage: one 128-byte swizzled row
constexpr int kStages = 4;
constexpr int kGroupM = 8;           // row panels walked together
constexpr int kConsumers = 256;      // two warpgroups of 64 rows
constexpr int kThreadsTc = kConsumers + 32;  // and the producer warp
constexpr int kATile = kTM * kTK, kBTile = kTN * kTK, kStage = kATile + kBTile;
constexpr int kOutCols = 32;                  // int32 columns of a staged chunk: 128 bytes
constexpr int kOutChunk = 64 * kOutCols * 4;  // a warpgroup's 64 rows of a chunk
constexpr size_t kSmem = 1024 + (size_t)kStages * kStage + 2 * 2 * kOutChunk +
                         2 * kStages * sizeof(uint64_t);

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// The origin of the walk's tile `tile`: groups of kGroupM row panels, the
// row panel fastest within a group (emulated by tests/test_torch_quant.py)
__device__ __forceinline__ void tile_origin(int tile, int tm, int tn, int* m0, int* n0) {
  const int per_group = kGroupM * tn, grp = tile / per_group, first = grp * kGroupM;
  const int rows = min(kGroupM, tm - first), in = tile - grp * per_group;
  *m0 = (first + in % rows) * kTM;
  *n0 = (in / rows) * kTN;
}

__device__ __forceinline__ uint64_t kmajor(const unsigned char* tile, int kk) {
  return sw128_desc(tile + 32 * kk);  // a k32 step: 32 bytes along the swizzled row
}

// grid: one CTA an SM, each walking tiles blockIdx.x, + gridDim.x, ...
__global__ void __launch_bounds__(kThreadsTc, 1)
quant_matmul_tc_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                       const __grid_constant__ CUtensorMap tcm, int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  unsigned char* out = ring + kStages * kStage;  // [warpgroup][2][kOutChunk]
  uint64_t* full = reinterpret_cast<uint64_t*>(out + 4 * kOutChunk);
  uint64_t* empty = full + kStages;
  const int tm = cdiv(M, kTM), tn = cdiv(N, kTN), n_tiles = tm * tn, nk = cdiv(K, kTK);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warp; its lane 0 issues every copy
    if ((threadIdx.x & 31) != 0) return;
    int it = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      int m0, n0;
      tile_origin(tile, tm, tn, &m0, &n0);
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(empty + s, (it / kStages - 1) & 1);
        unsigned char* st = ring + s * kStage;
        mbar_expect(full + s, kStage);  // the whole boxes, zero-filled past the edges included
        tma_load(st, &ta, kt * kTK, m0, full + s);
        tma_load(st + kATile, &tb, kt * kTK, n0, full + s);
      }
    }
    return;
  }

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  const bool leader = (threadIdx.x & 127) == 0;
  int32_t acc[128];
  int it = 0, chunk = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    int m0, n0;
    tile_origin(tile, tm, tn, &m0, &n0);
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % kStages;
      const unsigned char* sa = ring + s * kStage + wg * 64 * kTK;
      const unsigned char* sb = ring + s * kStage + kATile;
      mbar_wait(full + s, (it / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTK / 32; ++kk)
        WgmmaS8<kTN>::ss(acc, kmajor(sa, kk), kmajor(sb, kk), kt > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done: free it
      fence_acc(acc);
      if (kt > 0) mbar_arrive(empty + (it - 1) % kStages);
    }
    wgmma_wait<0>();
    fence_acc(acc);
    mbar_arrive(empty + (it - 1) % kStages);

    // acc[4j + e]: row 16·warp + g + 8·(e/2) of the warpgroup's 64, column
    // 8j + 2q + e%2 of the tile's 256
    const int r0 = 16 * warp + g;
#pragma unroll
    for (int cc = 0; cc < kTN / kOutCols; ++cc, ++chunk) {
      unsigned char* buf = out + (2 * wg + (chunk & 1)) * kOutChunk;
      if (leader) bulk_wait_read<1>();  // the store two chunks back has read this buffer
      bar_sync(1 + wg, 128);
#pragma unroll
      for (int jj = 0; jj < kOutCols / 8; ++jj) {
        const int j = cc * (kOutCols / 8) + jj;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = r0 + 8 * hf;
          *reinterpret_cast<int2*>(buf + sw128(r, 2 * jj + (q >> 1)) + 8 * (q & 1)) =
              make_int2(acc[4 * j + 2 * hf], acc[4 * j + 2 * hf + 1]);
        }
      }
      fence_async_smem();
      bar_sync(1 + wg, 128);
      if (leader) {
        if (m0 + 64 * wg < M && n0 + cc * kOutCols < N)
          tma_store(&tcm, buf, n0 + cc * kOutCols, m0 + 64 * wg);
        // a group every chunk, empty where no store was issued: the
        // bulk_wait_read<1> above then always means "the store two chunks
        // back has read this buffer" (with the commit inside the branch, a
        // skipped chunk let the next write overwrite a buffer still read)
        bulk_commit();
      }
    }
  }
  if (leader) bulk_wait_read<0>();  // the staging outlives no store
}

// The maps (A [M, K] and B's K-major copy [N, K] as bytes, C [M, N] int32),
// then the persistent grid.
int launch(const void* a, const void* bt, void* c, int M, int N, int K, cudaStream_t st) {
  // the device's SM count and the kernel's shared-memory opt-in, once a
  // device: they are host calls on every launch otherwise
  static int ready_dev = -1, n_sms = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev != ready_dev) {
    err = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(quant_matmul_tc_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (err == cudaSuccess) ready_dev = dev;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap maps[3];
  const cuuint64_t a_dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t b_dims[2] = {(cuuint64_t)K, (cuuint64_t)N};
  const cuuint64_t c_dims[2] = {(cuuint64_t)N, (cuuint64_t)M};
  const cuuint64_t k_stride[1] = {(cuuint64_t)K}, c_stride[1] = {(cuuint64_t)N * 4};
  const cuuint32_t a_box[2] = {kTK, kTM}, b_box[2] = {kTK, kTN}, c_box[2] = {kOutCols, 64};
  if (!encode_tiled(&maps[0], 2, a, a_dims, k_stride, a_box, CU_TENSOR_MAP_DATA_TYPE_UINT8) ||
      !encode_tiled(&maps[1], 2, bt, b_dims, k_stride, b_box, CU_TENSOR_MAP_DATA_TYPE_UINT8) ||
      !encode_tiled(&maps[2], 2, c, c_dims, c_stride, c_box, CU_TENSOR_MAP_DATA_TYPE_INT32))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = cdiv(M, kTM) * cdiv(N, kTN);
  quant_matmul_tc_kernel<<<min(n_tiles, n_sms), kThreadsTc, kSmem, st>>>(maps[0], maps[1], maps[2],
                                                                          M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// The kept route. a: [M,K] int8, b: [K,N] int8, c: [M,N] int32 out, all
// row-major and contiguous; M, N >= 1, 0 <= K <= 131071, ceil(N/128) <= 65535.
extern "C" int quant_matmul_launch(const void* a, const void* b, void* c, int M, int N, int K,
                                   void* stream) {
  const int8_t* A = static_cast<const int8_t*>(a);
  const int8_t* B = static_cast<const int8_t*>(b);
  int32_t* C = static_cast<int32_t*>(c);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool va = K % 16 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const bool vb = N % 16 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
  if (va && vb) return launch<true, true>(A, B, C, M, N, K, st);
  if (va) return launch<true, false>(A, B, C, M, N, K, st);
  if (vb) return launch<false, true>(A, B, C, M, N, K, st);
  return launch<false, false>(A, B, C, M, N, K, st);
}

// The wgmma route. a: [M,K] int8, bt: the weight's K-major copy [N,K] int8,
// c: [M,N] int32 out, all row-major, contiguous and 16-byte aligned; M, N
// >= 1, 16 <= K <= 131071 with K % 16 == 0, N % 4 == 0.
extern "C" int quant_matmul_tc_launch(const void* a, const void* bt, void* c, int M, int N, int K,
                                      void* stream) {
  if (M < 1 || N < 1 || K < 16 || K % 16 || N % 4) return static_cast<int>(cudaErrorInvalidValue);
  return tc::launch(a, bt, c, M, N, K, static_cast<cudaStream_t>(stream));
}

extern "C" const char* quant_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
