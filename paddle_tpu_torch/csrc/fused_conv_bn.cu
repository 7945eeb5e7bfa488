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
// prologue runs on it in the load path, and the normalised activation
// never goes to memory; y is written once and its statistics come out of
// the epilogue, with no second pass over y.
//
// Design, simple first. A CTA of 8 warps owns a column tile of 64 output
// channels and a chunk of consecutive 128-row tiles; each warp owns 16
// rows of a tile. The K loop stages 32 input channels at a time: each
// thread loads its 16-byte pieces of the x tile and of the filter tile
// into registers one step ahead, then applies the prologue to the x
// pieces in f32 (pi·ps formed first, no fused multiply-add, so the bits
// are the plain version's) and rounds them into shared memory. The filter
// tile is W's rows as they lie: K contiguous is the column-major B operand
// of mma.sync m16n8k16 (ptt::WarpMma), so nothing is transposed. bf16
// runs on the tensor cores with f32 accumulators; f32 io runs the same
// fragments with f32 FMAs. x is read through its strides ([B, H, W, Cin],
// Cin contiguous), so the stride-2 projection's subsampled view is read in
// place. Tail rows load as zeros, skip the prologue, and are neither
// stored nor summed.
//
// The statistics without float atomics: each thread sums its columns over
// its rows of every tile of the chunk, the 8 lanes that share a column
// reduce by shuffles, the 8 warps through shared memory in warp order, and
// the CTA writes one row of a [chunks, Cout] f32 workspace; a second
// launch sums the chunks in chunk order. Every sum has a fixed order, so
// two runs give the same bits. wgmma, TMA, a pipeline deeper than one
// step and a persistent schedule are later work.

#include "common.cuh"

#include <limits.h>
#include <stdint.h>

namespace {

using namespace ptt;

constexpr int kBM = 128;  // rows of a tile: 8 warps of 16
constexpr int kBN = 64;   // output channels of a tile
constexpr int kBK = 32;   // input channels a K step stages
constexpr int kConvWarps = kBM / 16;
constexpr int kConvThreads = 32 * kConvWarps;
constexpr int kNT = kBN / 8;  // n-tiles of a warp's fragment

struct Args {
  int B, H, W;           // x seen as [B, H, W, Cin]
  long long sb, sh, sw;  // its strides in elements; Cin's is 1
  int cin, cout, n, n_tiles, tiles_per_chunk;
  const void* x;
  const void* w;
  const float *pm, *pi, *ps, *pb;
  void* y;
  float *part_s, *part_sq;
};

// One thread's 16-byte pieces of a K step: kA of the x tile, kB of the
// filter tile.
template <typename T>
struct Stage {
  static constexpr int kVec = 16 / sizeof(T);
  static constexpr int kPieces = kBK / kVec;  // pieces in a staged row
  static constexpr int kA = kBM * kPieces / kConvThreads;
  static constexpr int kB = kBN * kPieces / kConvThreads;
  static constexpr int kLd = kBK + kVec;  // a shared-memory row, padded by 16 bytes
  uint4 a[kA];
  uint4 b[kB];
};

template <typename T>
__device__ __forceinline__ const T* x_row(const Args& a, int r) {
  const int hw = a.H * a.W;
  const int b = r / hw, rem = r - b * hw, h = rem / a.W, w = rem - h * a.W;
  return static_cast<const T*>(a.x) + b * a.sb + h * a.sh + w * a.sw;
}

// Global memory to registers: rows [row0, row0 + kBM) of x and rows
// [col0, col0 + kBN) of W, channels [k0, k0 + kBK).
template <typename T>
__device__ __forceinline__ void load(Stage<T>& st, const Args& a, int row0, int col0, int k0) {
  using S = Stage<T>;
#pragma unroll
  for (int i = 0; i < S::kA; ++i) {
    const int p = threadIdx.x + i * kConvThreads, r = p / S::kPieces;
    const int c = (p % S::kPieces) * S::kVec;
    st.a[i] = row0 + r < a.n ? *reinterpret_cast<const uint4*>(x_row<T>(a, row0 + r) + k0 + c)
                             : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int i = 0; i < S::kB; ++i) {
    const int p = threadIdx.x + i * kConvThreads, r = p / S::kPieces;
    const int c = (p % S::kPieces) * S::kVec;
    st.b[i] = *reinterpret_cast<const uint4*>(static_cast<const T*>(a.w) +
                                              (long long)(col0 + r) * a.cin + k0 + c);
  }
}

// Registers to shared memory, the prologue applied to the x pieces of
// valid rows.
template <typename T, bool kPro, bool kRelu>
__device__ __forceinline__ void store(Stage<T>& st, T* sA, T* sB, const Args& a, int row0,
                                      int k0) {
  using S = Stage<T>;
#pragma unroll
  for (int i = 0; i < S::kA; ++i) {
    const int p = threadIdx.x + i * kConvThreads, r = p / S::kPieces;
    const int c = (p % S::kPieces) * S::kVec;
    if (kPro && row0 + r < a.n) {
      T* e = reinterpret_cast<T*>(&st.a[i]);
#pragma unroll
      for (int j = 0; j < S::kVec; ++j) {
        const int k = k0 + c + j;
        const float g = __fmul_rn(__ldg(a.pi + k), __ldg(a.ps + k));
        float xh = __fadd_rn(__fmul_rn(__fsub_rn(to_f<T>(e[j]), __ldg(a.pm + k)), g),
                             __ldg(a.pb + k));
        if (kRelu) xh = fmaxf(xh, 0.f);
        e[j] = from_f<T>(xh);
      }
    }
    *reinterpret_cast<uint4*>(sA + r * S::kLd + c) = st.a[i];
  }
#pragma unroll
  for (int i = 0; i < S::kB; ++i) {
    const int p = threadIdx.x + i * kConvThreads, r = p / S::kPieces;
    const int c = (p % S::kPieces) * S::kVec;
    *reinterpret_cast<uint4*>(sB + r * S::kLd + c) = st.b[i];
  }
}

template <typename T>
__device__ __forceinline__ void store_pair(T* p, float v0, float v1);
template <>
__device__ __forceinline__ void store_pair<float>(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
template <>
__device__ __forceinline__ void store_pair<__nv_bfloat16>(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// grid (Cout / kBN, chunks): blockIdx.y's chunk is row tiles
// [y·tiles_per_chunk, min(n_tiles, (y+1)·tiles_per_chunk)).
template <typename T, bool kPro, bool kRelu>
__global__ void __launch_bounds__(kConvThreads) fused_conv_bn_kernel(Args a) {
  using S = Stage<T>;
  __shared__ __align__(16) T sA[kBM * S::kLd];
  __shared__ __align__(16) T sB[kBN * S::kLd];
  __shared__ float red[2][kConvWarps][kBN];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col0 = blockIdx.x * kBN;
  const int t0 = blockIdx.y * a.tiles_per_chunk;
  const int t1 = min(a.n_tiles, t0 + a.tiles_per_chunk);
  const int nk = a.cin / kBK;
  const int steps = max(t1 - t0, 0) * nk;

  float acc[kNT][4];
  zero(acc);
  float cs[kNT][2], cq[kNT][2];  // this thread's columns 8j+2q, 8j+2q+1
#pragma unroll
  for (int j = 0; j < kNT; ++j) cs[j][0] = cs[j][1] = cq[j][0] = cq[j][1] = 0.f;
  S st;
  if (steps > 0) load<T>(st, a, t0 * kBM, col0, 0);
  for (int it = 0; it < steps; ++it) {
    const int row0 = (t0 + it / nk) * kBM, kt = it % nk;
    __syncthreads();  // every warp is done with the previous step's tiles
    store<T, kPro, kRelu>(st, sA, sB, a, row0, kt * kBK);
    __syncthreads();
    if (it + 1 < steps) load<T>(st, a, (t0 + (it + 1) / nk) * kBM, col0, ((it + 1) % nk) * kBK);
    WarpMma<T, kNT, true>::run(acc, sA + warp * 16 * S::kLd, S::kLd, sB, S::kLd, kBK);
    if (kt != nk - 1) continue;
    // the tile's epilogue: round, store, and sum the rounded values
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const int row = row0 + warp * 16 + frag_row(e);
      if (row >= a.n) continue;
      T* yrow = static_cast<T*>(a.y) + (long long)row * a.cout + col0;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const float v0 = round_io<T>(acc[j][e]), v1 = round_io<T>(acc[j][e + 1]);
        store_pair<T>(yrow + frag_col(j, e), v0, v1);
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
  for (int j = 0; j < kNT; ++j)
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
  if (threadIdx.x < 2 * kBN) {
    const int which = threadIdx.x / kBN, c = threadIdx.x % kBN;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kConvWarps; ++w) v += red[which][w][c];
    (which ? a.part_sq : a.part_s)[(long long)blockIdx.y * a.cout + col0 + c] = v;
  }
}

// s[c] = Σ_chunk part_s[chunk][c] (and sq), in chunk order: 8 strided
// partial sums a column, then those 8 in order.
constexpr int kRedCols = 32;
__global__ void __launch_bounds__(256)
fused_conv_bn_reduce_kernel(const float* __restrict__ part_s, const float* __restrict__ part_sq,
                            int chunks, int cout, float* __restrict__ s, float* __restrict__ sq) {
  __shared__ float red[2][8][kRedCols];
  const int tx = threadIdx.x % kRedCols, r = threadIdx.x / kRedCols;
  const int col = blockIdx.x * kRedCols + tx;
  float a = 0.f, b = 0.f;
  if (col < cout)
    for (int c = r; c < chunks; c += 8) {
      a += part_s[(long long)c * cout + col];
      b += part_sq[(long long)c * cout + col];
    }
  red[0][r][tx] = a;
  red[1][r][tx] = b;
  __syncthreads();
  if (r == 0 && col < cout) {
    float u = 0.f, v = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      u += red[0][i][tx];
      v += red[1][i][tx];
    }
    s[col] = u;
    sq[col] = v;
  }
}

template <typename T>
cudaError_t launch(const Args& a, bool prologue, bool relu, int chunks, cudaStream_t st) {
  const dim3 grid(a.cout / kBN, chunks);
  if (!prologue)
    fused_conv_bn_kernel<T, false, false><<<grid, kConvThreads, 0, st>>>(a);
  else if (relu)
    fused_conv_bn_kernel<T, true, true><<<grid, kConvThreads, 0, st>>>(a);
  else
    fused_conv_bn_kernel<T, true, false><<<grid, kConvThreads, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// x: a [B, H, W, Cin] view (strides sb, sh, sw in elements, Cin
// contiguous, rows on 16 bytes); w: [Cout, Cin] contiguous; pm, pi, ps,
// pb: [Cin] f32, or null without the prologue; y: [B·H·W, Cout] out;
// part_s, part_sq: [chunks, Cout] f32 workspaces.
extern "C" int fused_conv_bn_launch(int io_bf16, int prologue, int relu, int B, int H, int W,
                                    long long sb, long long sh, long long sw, int cin, int cout,
                                    const void* x, const void* w, const void* pm, const void* pi,
                                    const void* ps, const void* pb, void* y, void* part_s,
                                    void* part_sq, int chunks, int tiles_per_chunk, void* stream) {
  const long long n = (long long)B * H * W;
  if (B < 1 || H < 1 || W < 1 || n > INT_MAX || cin < kBK || cin % kBK || cout < kBN ||
      cout % kBN || cout / kBN > 65535 || chunks < 1 || chunks > 65535 || tiles_per_chunk < 1 ||
      (prologue && !(pm && pi && ps && pb)))
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
  if ((long long)chunks * tiles_per_chunk < a.n_tiles) return cudaErrorInvalidValue;
  a.x = x;
  a.w = w;
  a.pm = static_cast<const float*>(pm);
  a.pi = static_cast<const float*>(pi);
  a.ps = static_cast<const float*>(ps);
  a.pb = static_cast<const float*>(pb);
  a.y = y;
  a.part_s = static_cast<float*>(part_s);
  a.part_sq = static_cast<float*>(part_sq);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return io_bf16 ? launch<__nv_bfloat16>(a, prologue, relu, chunks, st)
                 : launch<float>(a, prologue, relu, chunks, st);
}

// s, sq: [Cout] f32 out, the chunk sums of part_s, part_sq.
extern "C" int fused_conv_bn_reduce_launch(const void* part_s, const void* part_sq, int chunks,
                                           int cout, void* s, void* sq, void* stream) {
  if (chunks < 1 || cout < 1) return cudaErrorInvalidValue;
  fused_conv_bn_reduce_kernel<<<(cout + kRedCols - 1) / kRedCols, 256, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part_s), static_cast<const float*>(part_sq), chunks, cout,
      static_cast<float*>(s), static_cast<float*>(sq));
  return cudaGetLastError();
}

extern "C" const char* fused_conv_bn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
