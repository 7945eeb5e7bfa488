// The fused 1x1 conv + BatchNorm unit, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fused_kernel`, launched by `_pallas_fwd`
// (paddle_tpu/ops/fused_conv_ops.py:106-183): for x [N, Cin] (rows of an
// NHWC activation), the filter W in its checkpoint layout [Cout, Cin] and
// the previous BN's [Cin] f32 vectors pm, pi, ps, pb,
//
//   xn = io((x − pm)·(pi·ps) + pb), then ReLU    the optional prologue, f32
//   y  = io(xn · Wᵀ)                             f32 accumulation
//   s  = Σ_rows y,  sq = Σ_rows y²               f32, of the rounded y
//
// io() rounds to the io dtype (bf16 or f32). The statistics are summed
// from the rounded y, the values its consumers read back, as the TPU
// kernel sums them.
//
// What bounds it: at ResNet-50's shapes (B=128, bf16) it moves N·Cin +
// Cin·Cout + N·Cout elements for 2·N·Cin·Cout operations; stages 1-3 are
// bound by bytes (up to 257 MB, 77 µs, for N = 401408, Cin 64, Cout 256),
// stage 4 by operations (13.2 GFLOP, 13 µs). So x is read once, the
// prologue runs on it once, and the normalised activation never goes to
// memory; y is written once and its statistics come out of the epilogue,
// with no second pass over y and no second launch.
//
// bf16, the slice's dtype, runs on wgmma:
// - A persistent grid of one CTA an SM: (Cout / BN column tiles, chunks),
//   each CTA walking a contiguous chunk of 128-row tiles
//   (fused_conv_kernels.plan). BN = 256 where Cout allows, so for Cout <=
//   256 x is read from memory and prologued once; above 256 (stage 4, N =
//   6272-25088) each column tile re-reads its chunk's x, a few MB from L2.
// - Two consumer warpgroups of 64 rows each run wgmma m64nBNk16 with both
//   operands in shared memory, K-major and 128-byte swizzled: B is W's rows
//   as they lie, so nothing is transposed. A ring stage holds K=64 of the
//   x tile; where all of the column tile's W fits beside the ring (Cin up
//   to 128-512 by BN) it stays in shared memory for the launch, else a
//   stage also holds W's K=64 block. The ring runs on across row tiles.
// - Where x is a contiguous [N, Cin], thread 0 fills the ring with tensor
//   copies (TMA, 2-D maps over x and W made on the host and kept, rows
//   past N read as zeros), each stage completing on its own mbarrier; the
//   CTA's threads issue no loads. The stride-2 projection's subsampled
//   view has no box shape, so there every thread copies its 16-byte pieces
//   with cp.async through x's strides, read in place.
// - The prologue is a pass over the landed x tile in shared memory, each
//   thread on its 16-byte pieces: pi·ps formed first, __fmul_rn/__fadd_rn,
//   no fused multiply-add, so the bits are the plain version's.
// - The epilogue rounds y, stages each warp's 16 rows in shared memory (two
//   buffers where W is resident) and hands each row to the bulk-copy
//   engine, which writes it while the warp goes on. Each lane then sums
//   its columns of the staged, rounded rows in row order, tile after tile,
//   in registers; at the end each CTA sums its 8 warps into one row of a
//   [chunks, Cout] workspace.
// - The statistics' reduce runs in the same launch: the CTA that takes
//   the last ticket of a counter sums the workspace rows in chunk order and
//   resets the counter for the next launch (the wrapper keeps one counter a
//   device; launches on one stream). No float atomics: every sum has a
//   fixed order, so two runs give the same bits.
// What still holds it back: one instruction stream a CTA, so a tile's
// epilogue and the next tile's products do not overlap and y's writes
// drain behind the epilogue; where W is read a stage at a time, each stage
// moves twice x's bytes from L2; the stride-2 calls load with cp.async.
// A producer warp feeding two consumer warpgroups that take turns (one in
// its epilogue while the other multiplies) is the next step.
//
// f32 io keeps the exact path the port had before this kernel: mma.sync's
// fragments with f32 FMAs on 128x64 tiles, grid (Cout / 64, chunks), and
// the same folded reduce.

#include <limits.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace ptt;
using bf16 = __nv_bfloat16;

constexpr int kBM = 128;  // rows of a tile

struct Args {
  int B, H, W;           // x seen as [B, H, W, Cin]
  long long sb, sh, sw;  // its strides in elements; Cin's is 1
  int cin, cout, n, n_tiles, tiles_per_chunk, chunks, prologue, relu;
  const void* x;
  const void* w;
  const float *pm, *pi, *ps, *pb;
  void* y;
  float *part_s, *part_sq;  // [chunks, Cout] workspaces
  float *s, *sq;            // [Cout] out
  unsigned* ticket;         // 0 before the launch, and again after it
};

template <typename T>
__device__ __forceinline__ const T* x_row(const Args& a, int r) {
  const int hw = a.H * a.W;
  const int b = r / hw, rem = r - b * hw, h = rem / a.W, w = rem - h * a.W;
  return static_cast<const T*>(a.x) + b * a.sb + h * a.sh + w * a.sw;
}


// The end of every CTA: after its row of part_s/part_sq is written, the CTA
// that takes the last ticket sums the rows in chunk order into s and sq.
__device__ __forceinline__ void finish_stats(const Args& a) {
  __shared__ bool last;
  __syncthreads();  // this CTA's row is written
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(a.ticket, 1u) == gridDim.x * gridDim.y - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int c = threadIdx.x; c < a.cout; c += blockDim.x) {
    float s = 0.f, q = 0.f;
    for (int k = 0; k < a.chunks; ++k) {
      s += __ldcg(a.part_s + (long long)k * a.cout + c);
      q += __ldcg(a.part_sq + (long long)k * a.cout + c);
    }
    a.s[c] = s;
    a.sq[c] = q;
  }
  if (threadIdx.x == 0) *a.ticket = 0u;
}

// ------------------------------------------------------------------ f32 --
constexpr int kF32BN = 64;  // output channels of a tile
constexpr int kF32BK = 32;  // input channels a K step stages
constexpr int kF32Warps = kBM / 16;
constexpr int kF32Threads = 32 * kF32Warps;
constexpr int kF32NT = kF32BN / 8;  // n-tiles of a warp's fragment
constexpr int kVec = 4;             // floats in 16 bytes
constexpr int kPieces = kF32BK / kVec;
constexpr int kPA = kBM * kPieces / kF32Threads;
constexpr int kPB = kF32BN * kPieces / kF32Threads;
constexpr int kF32Ld = kF32BK + kVec;  // a shared-memory row, padded by 16 bytes

// One thread's 16-byte pieces of a K step: kPA of the x tile, kPB of the
// filter tile.
struct F32Stage {
  uint4 a[kPA];
  uint4 b[kPB];
};

// Global memory to registers: rows [row0, row0 + kBM) of x and rows
// [col0, col0 + kF32BN) of W, channels [k0, k0 + kF32BK).
__device__ __forceinline__ void f32_load(F32Stage& st, const Args& a, int row0, int col0, int k0) {
#pragma unroll
  for (int i = 0; i < kPA; ++i) {
    const int p = threadIdx.x + i * kF32Threads, r = p / kPieces, c = (p % kPieces) * kVec;
    st.a[i] = row0 + r < a.n ? *reinterpret_cast<const uint4*>(x_row<float>(a, row0 + r) + k0 + c)
                             : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int i = 0; i < kPB; ++i) {
    const int p = threadIdx.x + i * kF32Threads, r = p / kPieces, c = (p % kPieces) * kVec;
    st.b[i] = *reinterpret_cast<const uint4*>(static_cast<const float*>(a.w) +
                                              (long long)(col0 + r) * a.cin + k0 + c);
  }
}

// Registers to shared memory, the prologue applied to the x pieces of
// valid rows.
template <bool kPro, bool kRelu>
__device__ __forceinline__ void f32_store(F32Stage& st, float* sA, float* sB, const Args& a,
                                          int row0, int k0) {
#pragma unroll
  for (int i = 0; i < kPA; ++i) {
    const int p = threadIdx.x + i * kF32Threads, r = p / kPieces, c = (p % kPieces) * kVec;
    if (kPro && row0 + r < a.n) {
      float* e = reinterpret_cast<float*>(&st.a[i]);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const int k = k0 + c + j;
        const float g = __fmul_rn(__ldg(a.pi + k), __ldg(a.ps + k));
        float xh = __fadd_rn(__fmul_rn(__fsub_rn(e[j], __ldg(a.pm + k)), g), __ldg(a.pb + k));
        if (kRelu) xh = fmaxf(xh, 0.f);
        e[j] = xh;
      }
    }
    *reinterpret_cast<uint4*>(sA + r * kF32Ld + c) = st.a[i];
  }
#pragma unroll
  for (int i = 0; i < kPB; ++i) {
    const int p = threadIdx.x + i * kF32Threads, r = p / kPieces, c = (p % kPieces) * kVec;
    *reinterpret_cast<uint4*>(sB + r * kF32Ld + c) = st.b[i];
  }
}

// grid (Cout / kF32BN, chunks): blockIdx.y's chunk is row tiles
// [y·tiles_per_chunk, min(n_tiles, (y+1)·tiles_per_chunk)).
template <bool kPro, bool kRelu>
__global__ void __launch_bounds__(kF32Threads) fused_conv_bn_f32_kernel(Args a) {
  __shared__ __align__(16) float sA[kBM * kF32Ld];
  __shared__ __align__(16) float sB[kF32BN * kF32Ld];
  __shared__ float red[2][kF32Warps][kF32BN];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col0 = blockIdx.x * kF32BN;
  const int t0 = blockIdx.y * a.tiles_per_chunk;
  const int t1 = min(a.n_tiles, t0 + a.tiles_per_chunk);
  const int nk = a.cin / kF32BK;
  const int steps = max(t1 - t0, 0) * nk;

  float acc[kF32NT][4];
  zero(acc);
  float cs[kF32NT][2], cq[kF32NT][2];  // this thread's columns 8j+2q, 8j+2q+1
#pragma unroll
  for (int j = 0; j < kF32NT; ++j) cs[j][0] = cs[j][1] = cq[j][0] = cq[j][1] = 0.f;
  F32Stage st;
  if (steps > 0) f32_load(st, a, t0 * kBM, col0, 0);
  for (int it = 0; it < steps; ++it) {
    const int row0 = (t0 + it / nk) * kBM, kt = it % nk;
    __syncthreads();  // every warp is done with the previous step's tiles
    f32_store<kPro, kRelu>(st, sA, sB, a, row0, kt * kF32BK);
    __syncthreads();
    if (it + 1 < steps)
      f32_load(st, a, (t0 + (it + 1) / nk) * kBM, col0, ((it + 1) % nk) * kF32BK);
    WarpMma<float, kF32NT, true>::run(acc, sA + warp * 16 * kF32Ld, kF32Ld, sB, kF32Ld, kF32BK);
    if (kt != nk - 1) continue;
    // the tile's epilogue: store, and sum the values
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const int row = row0 + warp * 16 + frag_row(e);
      if (row >= a.n) continue;
      float* yrow = static_cast<float*>(a.y) + (long long)row * a.cout + col0;
#pragma unroll
      for (int j = 0; j < kF32NT; ++j) {
        const float v0 = acc[j][e], v1 = acc[j][e + 1];
        *reinterpret_cast<float2*>(yrow + frag_col(j, e)) = make_float2(v0, v1);
        cs[j][0] += v0;
        cs[j][1] += v1;
        cq[j][0] = __fadd_rn(cq[j][0], __fmul_rn(v0, v0));
        cq[j][1] = __fadd_rn(cq[j][1], __fmul_rn(v1, v1));
      }
    }
    zero(acc);
  }
  // the 8 lanes of a column (xor over g), then the warps in order
#pragma unroll
  for (int j = 0; j < kF32NT; ++j)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      float s = cs[j][b], q = cq[j][b];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, o);
        q += __shfl_xor_sync(0xffffffffu, q, o);
      }
      if (lane < 4) {
        red[0][warp][8 * j + 2 * lane + b] = s;
        red[1][warp][8 * j + 2 * lane + b] = q;
      }
    }
  __syncthreads();
  if (threadIdx.x < 2 * kF32BN) {
    const int which = threadIdx.x / kF32BN, c = threadIdx.x % kF32BN;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kF32Warps; ++w) v += red[which][w][c];
    (which ? a.part_sq : a.part_s)[(long long)blockIdx.y * a.cout + col0 + c] = v;
  }
  finish_stats(a);
}

cudaError_t launch_f32(const Args& a, cudaStream_t st) {
  const dim3 grid(a.cout / kF32BN, a.chunks);
  if (!a.prologue)
    fused_conv_bn_f32_kernel<false, false><<<grid, kF32Threads, 0, st>>>(a);
  else if (a.relu)
    fused_conv_bn_f32_kernel<true, true><<<grid, kF32Threads, 0, st>>>(a);
  else
    fused_conv_bn_f32_kernel<true, false><<<grid, kF32Threads, 0, st>>>(a);
  return cudaGetLastError();
}

// ----------------------------------------------------------------- bf16 --
constexpr int kBK = 64;               // input channels a stage: one 128-byte row
constexpr int kTcThreads = 256;           // two consumer warpgroups of 64 rows
constexpr int kTcWarps = kTcThreads / 32;
constexpr int kRowStep = kTcThreads / 8;  // rows the CTA's 16-byte pieces cover at once
constexpr int kRowBytes = kBK * 2;    // a swizzled row
constexpr int kABytes = kBM * kRowBytes;

template <int BN, bool kWRes>
struct Tc {
  static constexpr int kWBlock = BN * kRowBytes;  // W's tile of one K stage
  // x's tile and, unless W stays resident, W's tile of one K stage
  static constexpr int kStageBytes = kABytes + (kWRes ? 0 : kWBlock);
  static constexpr int kStages = kWRes ? (BN == 64 ? 6 : 4) : BN == 256 ? 3 : BN == 128 ? 5 : 7;
  // the epilogue stages y a warp at a time, 16 rows by up to 128 columns a
  // pass, rows padded by 16 bytes against bank conflicts; with W resident,
  // in two buffers a warp, so a pass waits for the copies of the pass
  // before last, not of the last (where W is read a stage at a time the
  // K loop is long beside the epilogue, and the ring takes the room)
  static constexpr int kYCols = BN < 128 ? BN : 128;
  static constexpr int kYLd = kYCols * 2 + 16;
  static constexpr int kYBufs = kWRes ? 2 : 1;
  static constexpr int kYWarp = kYBufs * 16 * kYLd;  // a warp's staging bytes
  static constexpr int kYBytes = kTcWarps * kYWarp;
  static constexpr int kStatFloats = kTcWarps * 2 * BN;  // per warp: Σy and Σy² of each column
  static constexpr int kVals = BN / 2;            // a thread's accumulators
  static constexpr int kLaneCols = kYCols / 32;  // columns a lane sums in a staging pass
  // alignment slack, the ring, the y staging rows, the statistics, the
  // ring's and W's mbarriers
  static constexpr int kFixed = 1024 + kStages * kStageBytes + kYBytes + kStatFloats * 4 + 128;
  // W's bytes a CTA can keep for the whole launch beside the rest (the
  // opt-in limit less alignment slack and the static shared memory)
  static constexpr int kWResMax = 232448 - 64 - kFixed;
  // dynamic shared memory for nk K stages: the above and W when resident
  static constexpr int smem(int nk) { return kFixed + (kWRes ? nk * kWBlock : 0); }
};

// grid (Cout / BN, chunks), one CTA an SM: blockIdx.y's chunk is row tiles
// [y·tiles_per_chunk, min(n_tiles, (y+1)·tiles_per_chunk)), its K stages
// in one ring across the tiles. kTma: thread 0 fills the ring with tensor
// copies of x (contiguous, [N, Cin]) and W through the maps tx and tw; else
// every thread copies its 16-byte pieces (x read through its strides).
template <int BN, bool kWRes, bool kTma>
__global__ void __launch_bounds__(kTcThreads, 1)
fused_conv_bn_tc_kernel(Args a, const __grid_constant__ CUtensorMap tx,
                        const __grid_constant__ CUtensorMap tw) {
  using C = Tc<BN, kWRes>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  unsigned char* smem = smem_raw + ((1024 - (base & 1023)) & 1023);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, g = lane >> 2, q = lane & 3;
  const int col0 = blockIdx.x * BN;
  const int t0 = blockIdx.y * a.tiles_per_chunk;
  const int t1 = min(a.n_tiles, t0 + a.tiles_per_chunk);
  const int nk = (a.cin + kBK - 1) / kBK;
  const int steps = max(t1 - t0, 0) * nk;
  const bf16* w = static_cast<const bf16*>(a.w) + (long long)col0 * a.cin;
  unsigned char* wres = smem + C::kStages * C::kStageBytes;  // [nk][BN rows] when resident
  unsigned char* ystage = wres + (kWRes ? nk * C::kWBlock : 0) + warp * C::kYWarp;
  int ypass = 0;  // the warp's staging passes so far
  float* stat = reinterpret_cast<float*>(wres + (kWRes ? nk * C::kWBlock : 0) + C::kYBytes);
  // this lane's columns (kLaneCols of each staging pass) summed over the
  // warp's rows of every tile, in row order: Σy, Σy²
  float cs[BN / 32], cq[BN / 32];
#pragma unroll
  for (int i = 0; i < BN / 32; ++i) cs[i] = cq[i] = 0.f;
  uint64_t* full = reinterpret_cast<uint64_t*>(stat + C::kStatFloats);  // a ring slot's
  uint64_t* wfull = full + C::kStages;                                   // resident W's
  // kTma: stage `it`'s tensor copies, by thread 0
  auto tma_stage = [&](int it) {
    if (it >= steps) return;
    unsigned char* sa = smem + (it % C::kStages) * C::kStageBytes;
    const int row0 = (t0 + it / nk) * kBM, k0 = (it % nk) * kBK;
    mbar_expect(full + it % C::kStages, C::kStageBytes);
    tma_load(sa, &tx, k0, row0, full + it % C::kStages);
    if (!kWRes) tma_load(sa + kABytes, &tw, k0, col0, full + it % C::kStages);
  };
  if constexpr (kTma) {
    if (tid == 0) {
      for (int i = 0; i <= C::kStages; ++i) mbar_init(full + i, 1);
      fence_mbar_init();
    }
    __syncthreads();
    if (tid == 0) {
      if (kWRes) {
        mbar_expect(wfull, nk * C::kWBlock);
        for (int kb = 0; kb < nk; ++kb) tma_load(wres + kb * C::kWBlock, &tw, kb * kBK, col0, wfull);
      }
      for (int it = 0; it < C::kStages - 1; ++it) tma_stage(it);
    }
  } else if (kWRes) {  // every K stage of the column tile's W, once; the first group
    for (int i = tid; i < nk * BN * 8; i += kTcThreads) {
      const int kb = i / (BN * 8), r = (i / 8) % BN, c = i % 8, k = kb * kBK + c * 8;
      if (k < a.cin) cp_async16(wres + kb * C::kWBlock + sw128(r, c), w + (long long)r * a.cin + k, 16);
    }
    cp_async_commit();
  }

  // the 16-byte pieces this thread copies (and prologues): piece lc of rows
  // lr + kRowStep·i of the x tile and of the W tile
  const int lc = tid & 7, lr = tid >> 3;
  auto load = [&](int it) {  // stage `it` into its ring slot; always one group
    if (it < steps) {
      const int row0 = (t0 + it / nk) * kBM, k = (it % nk) * kBK + lc * 8;
      unsigned char* sa = smem + (it % C::kStages) * C::kStageBytes;
      unsigned char* sb = sa + kABytes;
      if (k < a.cin) {
#pragma unroll
        for (int i = 0; i < kBM / kRowStep; ++i) {
          const int r = lr + kRowStep * i, row = row0 + r;
          const bool ok = row < a.n;
          cp_async16(sa + sw128(r, lc), ok ? x_row<bf16>(a, row) + k : a.x, ok ? 16 : 0);
        }
#pragma unroll
        for (int i = 0; i < (kWRes ? 0 : BN / kRowStep); ++i) {
          const int r = lr + kRowStep * i;
          cp_async16(sb + sw128(r, lc), w + (long long)r * a.cin + k, 16);
        }
      }
    }
    cp_async_commit();
  };

  if (!kTma)
#pragma unroll
    for (int s = 0; s < C::kStages - 1; ++s) load(s);
  float acc[C::kVals];
#pragma unroll
  for (int i = 0; i < C::kVals; ++i) acc[i] = 0.f;
  for (int it = 0; it < steps; ++it) {
    const int kt = it % nk, row0 = (t0 + it / nk) * kBM, k0 = kt * kBK;
    unsigned char* sa = smem + (it % C::kStages) * C::kStageBytes;
    if constexpr (kTma) {  // stage `it` (and at first, W) landed
      if (kWRes && it == 0) mbar_wait(wfull, 0);
      mbar_wait(full + it % C::kStages, (it / C::kStages) & 1);
    } else {
      cp_async_wait<C::kStages - 2>();  // this thread's pieces of stage `it` landed
    }
    if (a.prologue && k0 + lc * 8 < a.cin) {
      // xn = io((x − pm)·(pi·ps) + pb), ReLU, on this thread's pieces
      float pm[8], gg[8], pb[8];
      const int k = k0 + lc * 8;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 m4 = __ldg(reinterpret_cast<const float4*>(a.pm + k) + h);
        const float4 i4 = __ldg(reinterpret_cast<const float4*>(a.pi + k) + h);
        const float4 s4 = __ldg(reinterpret_cast<const float4*>(a.ps + k) + h);
        const float4 b4 = __ldg(reinterpret_cast<const float4*>(a.pb + k) + h);
        pm[4 * h] = m4.x, pm[4 * h + 1] = m4.y, pm[4 * h + 2] = m4.z, pm[4 * h + 3] = m4.w;
        pb[4 * h] = b4.x, pb[4 * h + 1] = b4.y, pb[4 * h + 2] = b4.z, pb[4 * h + 3] = b4.w;
        gg[4 * h] = __fmul_rn(i4.x, s4.x), gg[4 * h + 1] = __fmul_rn(i4.y, s4.y);
        gg[4 * h + 2] = __fmul_rn(i4.z, s4.z), gg[4 * h + 3] = __fmul_rn(i4.w, s4.w);
      }
#pragma unroll
      for (int i = 0; i < kBM / kRowStep; ++i) {
        const int r = lr + kRowStep * i;
        if (row0 + r >= a.n) continue;
        uint4* piece = reinterpret_cast<uint4*>(sa + sw128(r, lc));
        uint4 u = *piece;
        bf16* e = reinterpret_cast<bf16*>(&u);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float xh = __fadd_rn(__fmul_rn(__fsub_rn(to_f<bf16>(e[j]), pm[j]), gg[j]), pb[j]);
          if (a.relu) xh = fmaxf(xh, 0.f);
          e[j] = from_f<bf16>(xh);
        }
        *piece = u;
      }
    }
    fence_async_smem();  // this thread's copies and writes, visible to wgmma
    __syncthreads();     // every piece of stage `it`; every wgmma of stage it-1 is done
    if (!kTma)
      load(it + C::kStages - 1);  // into the slot stage it-1 used
    else if (tid == 0)
      tma_stage(it + C::kStages - 1);
    const int ksub = min(kBK, a.cin - k0) / 16;
    const uint64_t da = sw128_desc(sa + wg * 64 * kRowBytes);
    const uint64_t db = sw128_desc(kWRes ? wres + kt * C::kWBlock : sa + kABytes);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      if (kk < ksub) Wgmma<BN>::ss(acc, da + 2 * kk, db + 2 * kk, kt > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    if (kt != nk - 1) continue;

    // the tile's epilogue: round, store, and sum the rounded values
    const int ra = row0 + wg * 64 + (warp & 3) * 16 + g, rb = ra + 8;
    const bool va = ra < a.n, vb = rb < a.n;  // rows past N stay 0, in y's sums too
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        acc[4 * j + e] = va ? round_io<bf16>(acc[4 * j + e]) : 0.f;
        acc[4 * j + 2 + e] = vb ? round_io<bf16>(acc[4 * j + 2 + e]) : 0.f;
      }
    // the warp's 16 rows staged kYCols columns at a time; each row then one
    // bulk copy by lane `row` (rows past N are not copied), and each lane
    // sums its kLaneCols columns of the staged rows
    const long long yrow = (long long)(ra - g + lane) * a.cout + col0;
#pragma unroll
    for (int p = 0; p < BN / C::kYCols; ++p, ++ypass) {
      unsigned char* ybuf = ystage + (ypass % C::kYBufs) * 16 * C::kYLd;
      if (lane < 16) bulk_wait_read<C::kYBufs - 1>();  // this buffer's last copies read it
      __syncwarp();
#pragma unroll
      for (int jj = 0; jj < C::kYCols / 8; ++jj) {
        const int j = p * C::kYCols / 8 + jj;
        unsigned char* cell = ybuf + g * C::kYLd + (8 * jj + 2 * q) * 2;
        *reinterpret_cast<uint32_t*>(cell) = pack_bf16x2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<uint32_t*>(cell + 8 * C::kYLd) = pack_bf16x2(acc[4 * j + 2], acc[4 * j + 3]);
      }
      fence_async_smem();
      __syncwarp();
      if (lane < 16) {
        if (ra - g + lane < a.n)
          bulk_store(static_cast<bf16*>(a.y) + yrow + p * C::kYCols, ybuf + lane * C::kYLd,
                     C::kYCols * 2);
        bulk_commit();
      }
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const bf16* row = reinterpret_cast<const bf16*>(ybuf + r * C::kYLd) + lane * C::kLaneCols;
#pragma unroll
        for (int c = 0; c < C::kLaneCols; ++c) {
          const float v = to_f<bf16>(row[c]);
          cs[p * C::kLaneCols + c] += v;
          cq[p * C::kLaneCols + c] = __fadd_rn(cq[p * C::kLaneCols + c], __fmul_rn(v, v));
        }
      }
    }
  }
  if (lane < 16) bulk_wait();  // the copies are done with the staging rows before exit
#pragma unroll
  for (int i = 0; i < BN / 32; ++i) {
    const int col = (i / C::kLaneCols) * C::kYCols + lane * C::kLaneCols + i % C::kLaneCols;
    stat[(warp * 2) * BN + col] = cs[i];
    stat[(warp * 2 + 1) * BN + col] = cq[i];
  }
  // the CTA's row: its 8 warps in order
  __syncthreads();
  for (int c = tid; c < 2 * BN; c += kTcThreads) {
    const int which = c / BN, col = c % BN;
    float s = 0.f;
#pragma unroll
    for (int w8 = 0; w8 < kTcWarps; ++w8) s += stat[(w8 * 2 + which) * BN + col];
    (which ? a.part_sq : a.part_s)[(long long)blockIdx.y * a.cout + col0 + col] = s;
  }
  finish_stats(a);
}

// a row-major bf16 [rows, cols] matrix read as boxes of box_rows x 64
// columns (common.cuh's encode_tiled); rows past the end read as zeros
bool encode_2d(CUtensorMap* m, const void* base, long long rows, int cols, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows};
  return encode_tiled(m, 2, base, dims, strides, box);
}

template <int BN, bool kWRes, bool kTma>
cudaError_t launch_tc(const Args& a, const CUtensorMap& tx, const CUtensorMap& tw,
                      cudaStream_t st) {
  auto kernel = fused_conv_bn_tc_kernel<BN, kWRes, kTma>;
  const int smem = Tc<BN, kWRes>::smem((a.cin + kBK - 1) / kBK);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.cout / BN, a.chunks), kTcThreads, smem, st>>>(a, tx, tw);
  return cudaGetLastError();
}

// W resident where it fits; tensor copies where x is a contiguous [N, Cin]
// of at least one K stage, else the 16-byte copies (the stride-2 view)
template <int BN>
cudaError_t launch_tc_bn(const Args& a, cudaStream_t st) {
  const bool resident = (a.cin + kBK - 1) / kBK * Tc<BN, true>::kWBlock <= Tc<BN, true>::kWResMax;
  const bool tma = a.cin >= kBK && a.sw == a.cin && a.sh == (long long)a.W * a.cin &&
                   a.sb == (long long)a.H * a.W * a.cin;
  CUtensorMap tx{}, tw{};
  if (tma && !(encode_2d(&tx, a.x, a.n, a.cin, kBM) && encode_2d(&tw, a.w, a.cout, a.cin, BN)))
    return cudaErrorNotSupported;
  if (tma)
    return resident ? launch_tc<BN, true, true>(a, tx, tw, st)
                    : launch_tc<BN, false, true>(a, tx, tw, st);
  return resident ? launch_tc<BN, true, false>(a, tx, tw, st)
                  : launch_tc<BN, false, false>(a, tx, tw, st);
}

}  // namespace

// x: a [B, H, W, Cin] view (strides sb, sh, sw in elements, Cin
// contiguous, rows on 16 bytes); w: [Cout, Cin] contiguous; pm, pi, ps,
// pb: [Cin] f32 (16-byte aligned), or null without the prologue; y:
// [B·H·W, Cout] out; part_s, part_sq: [chunks, Cout] f32 workspaces; s,
// sq: [Cout] f32 out; ticket: a u32 counter at 0, left at 0. col_tile is
// fused_conv_kernels.plan's: 64 in f32; 64, 128 or 256 in bf16.
extern "C" int fused_conv_bn_launch(int io_bf16, int prologue, int relu, int B, int H, int W,
                                    long long sb, long long sh, long long sw, int cin, int cout,
                                    const void* x, const void* w, const void* pm, const void* pi,
                                    const void* ps, const void* pb, void* y, void* part_s,
                                    void* part_sq, void* s, void* sq, void* ticket, int col_tile,
                                    int chunks, int tiles_per_chunk, void* stream) {
  const long long n = (long long)B * H * W;
  const bool tile_ok = io_bf16 ? (col_tile == 64 || col_tile == 128 || col_tile == 256)
                               : col_tile == kF32BN;
  if (B < 1 || H < 1 || W < 1 || n > INT_MAX || cin < 32 || cin % 32 || !tile_ok ||
      cout < col_tile || cout % col_tile || cout / col_tile > 65535 || chunks < 1 ||
      chunks > 65535 || tiles_per_chunk < 1 || !ticket || (prologue && !(pm && pi && ps && pb)))
    return cudaErrorInvalidValue;
  Args a{};
  a.B = B;
  a.H = H;
  a.W = W;
  a.sb = sb;
  a.sh = sh;
  a.sw = sw;
  a.cin = cin;
  a.cout = cout;
  a.n = (int)n;
  a.n_tiles = (int)((n + kBM - 1) / kBM);
  a.tiles_per_chunk = tiles_per_chunk;
  a.chunks = chunks;
  if ((long long)chunks * tiles_per_chunk < a.n_tiles) return cudaErrorInvalidValue;
  a.prologue = prologue;
  a.relu = relu;
  a.x = x;
  a.w = w;
  a.pm = static_cast<const float*>(pm);
  a.pi = static_cast<const float*>(pi);
  a.ps = static_cast<const float*>(ps);
  a.pb = static_cast<const float*>(pb);
  a.y = y;
  a.part_s = static_cast<float*>(part_s);
  a.part_sq = static_cast<float*>(part_sq);
  a.s = static_cast<float*>(s);
  a.sq = static_cast<float*>(sq);
  a.ticket = static_cast<unsigned*>(ticket);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!io_bf16) return launch_f32(a, st);
  switch (col_tile) {
    case 64: return launch_tc_bn<64>(a, st);
    case 128: return launch_tc_bn<128>(a, st);
    default: return launch_tc_bn<256>(a, st);
  }
}

extern "C" const char* fused_conv_bn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
