// Flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel the JAX package calls through `_flash_kernel`
// (paddle_tpu/ops/flash_ops.py:160): the jax library's Pallas flash
// attention (jax/experimental/pallas/ops/tpu/flash_attention.py), whose
// forward pallas_call saves the row max and sum, and whose custom VJP runs
// a dK/dV kernel (`_flash_attention_bwd_dkv`) and a dQ kernel
// (`_flash_attention_bwd_dq`) with Di = Σ(dO∘O) computed outside them.
//
//   flash_fwd      O = softmax(QKᵀ·scale, causal) V, and LSE = m + log(l)
//   flash_bwd_dkv  dV = Pᵀ dO, dK = dSᵀ Q, dS = P∘(dP − Di)·scale
//   flash_bwd_dq   dQ = dS K
//
// Q, K, V, O, dO, dQ, dK and dV are [B,T,H,D] tensors read through their
// strides (d contiguous), the op's own layout, so nothing is transposed;
// LSE and Di are [B,H,T] f32. D is 64 or 128; any T, the tail rows and
// columns masked. The io dtype is bf16 or f32.
//
// What bounds them: at the main path's shapes (B=8, T=1024, H=32, D=64,
// causal) the forward moves about 135 MB for 34 GFLOP and is bound by
// bytes; the two backward kernels do 69 and 52 GFLOP for 200 and 170 MB
// and are bound by their operations. So none of them writes the [T,T]
// scores to memory: each block of scores lives in registers and one
// shared-memory tile, as in the TPU kernel.
//
// Design, simple first. A CTA of 4 warps owns 64 rows (queries for the
// forward and dQ, keys for dK/dV) of one (b, h); each warp owns 16 of
// them. Tiles of 64 rows of the other side are staged in shared memory, one
// after the other, skipping the blocks above the diagonal when causal.
// Both products of a block run on the tensor cores in bf16 (mma.sync
// m16n8k16, f32 accumulators); the scores and softmax are f32 in registers.
// The second product's left operand (P, or dS) goes through the warp's own
// shared-memory rows, rounded to the io dtype there, as the TPU kernel
// casts p and ds to the io dtype before its dots. In f32 io the same
// fragments are computed with f32 FMAs, so f32 runs keep f32 precision.
// Every output element is written by one CTA: no atomics, the same bits on
// every run. wgmma, TMA and a pipelined, warp-specialised schedule are
// later work.

#include "common.cuh"

#include <math.h>
#include <stdint.h>

// A [B,T,H,D] tensor: its data and its strides in elements (d's is 1).
// Outside the anonymous namespace: the C interface below takes it.
struct View {
  void* p;
  long long sb, st, sh;
};

namespace {

using namespace ptt;

constexpr int kRows = 64;         // rows a CTA owns, and rows of a staged tile
constexpr int kFlashWarps = 4;    // each warp owns 16 of the CTA's rows
constexpr int kFlashThreads = 32 * kFlashWarps;
constexpr int kPad = 8;           // elements padding each shared-memory row
constexpr int kLdP = kRows + kPad;

template <typename T>
__device__ __forceinline__ T* row_ptr(const View& v, int b, int t, int h) {
  return static_cast<T*>(v.p) + b * v.sb + t * v.st + h * v.sh;
}

// Rows [t0, t0+64) of head (b, h) into a [64][D+kPad] tile, zeros past T,
// 16 bytes a thread at a time.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* sm, const View& v, int b, int h, int t0, int T_) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = D / kVec;
  constexpr int kLd = D + kPad;
  for (int i = threadIdx.x; i < kRows * kChunks; i += kFlashThreads) {
    const int r = i / kChunks, c = (i % kChunks) * kVec;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (t0 + r < T_) val = *reinterpret_cast<const uint4*>(row_ptr<T>(v, b, t0 + r, h) + c);
    *reinterpret_cast<uint4*>(sm + r * kLd + c) = val;
  }
}

// Rounds the warp's 16 x 64 fragment to the io dtype into its shared rows.
template <typename T>
__device__ __forceinline__ void store_frag(T* s, const float (&c)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[frag_row(e) * kLdP + frag_col(j, e)] = from_f<T>(c[j][e]);
}

// Reduces over the 4 lanes that share a row.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ bool visible(int row, int col, int T_, bool causal) {
  return col < T_ && (!causal || col <= row);
}

// ------------------------------------------------------------ forward --
// One CTA per (q block of 64, h, b). smem: Q, K, V [64][D+kPad], P [64][kLdP].
template <typename T, int D, bool kCausal>
__global__ void __launch_bounds__(kFlashThreads)
flash_fwd_kernel(View q, View k, View v, View o, float* __restrict__ lse, int T_, int H,
                 float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kLd = D + kPad;
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sK = sQ + kRows * kLd;
  T* sV = sK + kRows * kLd;
  T* sP = sV + kRows * kLd;
  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int q0 = qb * kRows, r0 = q0 + warp * 16;
  T* sQw = sQ + warp * 16 * kLd;
  T* sPw = sP + warp * 16 * kLdP;

  load_tile<T, D>(sQ, q, b, h, q0, T_);
  float acc[D / 8][4];
  zero(acc);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g and g+8
  const int n_kb = kCausal ? qb + 1 : (T_ + kRows - 1) / kRows;
  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * kRows;
    __syncthreads();
    load_tile<T, D>(sK, k, b, h, k0, T_);
    load_tile<T, D>(sV, v, b, h, k0, T_);
    __syncthreads();
    float s[8][4];
    zero(s);
    WarpMma<T, 8, true>::run(s, sQw, kLd, sK, kLd, D);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = visible(r0 + frag_row(e), k0 + frag_col(j, e), T_, kCausal);
        s[j][e] = ok ? s[j][e] * scale : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // every row sees key k0 of each block it visits, so m stays finite
      const float m_new = fmaxf(m[i], quad_max(mx[i]));
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m[e >> 1]);
        l[e >> 1] += s[j][e];  // this lane's share of the f32 row sum
      }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];
    store_frag<T>(sPw, s);
    __syncwarp();
    WarpMma<T, D / 8, false>::run(acc, sPw, kLdP, sV, kLd, kRows);
    __syncwarp();
  }
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = quad_sum(l[i]);
    inv[i] = 1.f / l[i];
  }
#pragma unroll
  for (int e = 0; e < 4; e += 2) {
    const int row = r0 + frag_row(e);
    if (row >= T_) continue;
    T* orow = row_ptr<T>(o, b, row, h);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      orow[frag_col(j, e)] = from_f<T>(acc[j][e] * inv[e >> 1]);
      orow[frag_col(j, e) + 1] = from_f<T>(acc[j][e + 1] * inv[e >> 1]);
    }
    if ((threadIdx.x & 3) == 0) lse[((size_t)b * H + h) * T_ + row] = m[e >> 1] + logf(l[e >> 1]);
  }
}

// ------------------------------------------------------- backward dK/dV --
// One CTA per (k block of 64, h, b): walks the q blocks from the diagonal.
// smem: K, V, Q, dO [64][D+kPad], Pᵀ then dSᵀ [64][kLdP], LSE and Di [64] f32.
template <typename T, int D, bool kCausal>
__global__ void __launch_bounds__(kFlashThreads)
flash_bwd_dkv_kernel(View q, View k, View v, View dout, const float* __restrict__ lse,
                     const float* __restrict__ di, View dk, View dv, int T_, int H, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kLd = D + kPad;
  T* sK = reinterpret_cast<T*>(smem_raw);
  T* sV = sK + kRows * kLd;
  T* sQ = sV + kRows * kLd;
  T* sO = sQ + kRows * kLd;  // dO
  T* sP = sO + kRows * kLd;
  float* sL = reinterpret_cast<float*>(sP + kRows * kLdP);
  float* sD = sL + kRows;
  const int kb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int k0 = kb * kRows, r0 = k0 + warp * 16;  // this warp's keys
  T* sPw = sP + warp * 16 * kLdP;
  const float* lse_bh = lse + ((size_t)b * H + h) * T_;
  const float* di_bh = di + ((size_t)b * H + h) * T_;

  load_tile<T, D>(sK, k, b, h, k0, T_);
  load_tile<T, D>(sV, v, b, h, k0, T_);
  float acc_k[D / 8][4], acc_v[D / 8][4];
  zero(acc_k);
  zero(acc_v);
  const int n_qb = (T_ + kRows - 1) / kRows;
  for (int qb = kCausal ? kb : 0; qb < n_qb; ++qb) {
    const int q0 = qb * kRows;
    __syncthreads();
    load_tile<T, D>(sQ, q, b, h, q0, T_);
    load_tile<T, D>(sO, dout, b, h, q0, T_);
    for (int i = threadIdx.x; i < kRows; i += kFlashThreads) {
      sL[i] = q0 + i < T_ ? lse_bh[q0 + i] : 0.f;
      sD[i] = q0 + i < T_ ? di_bh[q0 + i] : 0.f;
    }
    __syncthreads();
    float p[8][4], dp[8][4];  // Sᵀ then Pᵀ, and dPᵀ: [this warp's keys][q]
    zero(p);
    zero(dp);
    WarpMma<T, 8, true>::run(p, sK + warp * 16 * kLd, kLd, sQ, kLd, D);
    WarpMma<T, 8, true>::run(dp, sV + warp * 16 * kLd, kLd, sO, kLd, D);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = frag_col(j, e);
        // the score of (query q0+col, key r0+row)
        const bool ok = visible(q0 + col, r0 + frag_row(e), T_, kCausal) && q0 + col < T_;
        p[j][e] = ok ? expf(p[j][e] * scale - sL[col]) : 0.f;
      }
    store_frag<T>(sPw, p);
    __syncwarp();
    WarpMma<T, D / 8, false>::run(acc_v, sPw, kLdP, sO, kLd, kRows);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[j][e] = (dp[j][e] - sD[frag_col(j, e)]) * p[j][e] * scale;
    store_frag<T>(sPw, dp);
    __syncwarp();
    WarpMma<T, D / 8, false>::run(acc_k, sPw, kLdP, sQ, kLd, kRows);
    __syncwarp();
  }
#pragma unroll
  for (int e = 0; e < 4; e += 2) {
    const int row = r0 + frag_row(e);
    if (row >= T_) continue;
    T* krow = row_ptr<T>(dk, b, row, h);
    T* vrow = row_ptr<T>(dv, b, row, h);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = frag_col(j, e);
      krow[col] = from_f<T>(acc_k[j][e]);
      krow[col + 1] = from_f<T>(acc_k[j][e + 1]);
      vrow[col] = from_f<T>(acc_v[j][e]);
      vrow[col + 1] = from_f<T>(acc_v[j][e + 1]);
    }
  }
}

// ---------------------------------------------------------- backward dQ --
// One CTA per (q block of 64, h, b): walks the k blocks up to the diagonal.
// smem: Q, dO, K, V [64][D+kPad], dS [64][kLdP].
template <typename T, int D, bool kCausal>
__global__ void __launch_bounds__(kFlashThreads)
flash_bwd_dq_kernel(View q, View k, View v, View dout, const float* __restrict__ lse,
                    const float* __restrict__ di, View dq, int T_, int H, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kLd = D + kPad;
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sO = sQ + kRows * kLd;  // dO
  T* sK = sO + kRows * kLd;
  T* sV = sK + kRows * kLd;
  T* sP = sV + kRows * kLd;
  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int q0 = qb * kRows, r0 = q0 + warp * 16;
  T* sPw = sP + warp * 16 * kLdP;
  float row_lse[2], row_di[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + frag_row(2 * i);
    const size_t at = ((size_t)b * H + h) * T_ + row;
    row_lse[i] = row < T_ ? lse[at] : 0.f;
    row_di[i] = row < T_ ? di[at] : 0.f;
  }
  load_tile<T, D>(sQ, q, b, h, q0, T_);
  load_tile<T, D>(sO, dout, b, h, q0, T_);
  float acc[D / 8][4];
  zero(acc);
  const int n_kb = kCausal ? qb + 1 : (T_ + kRows - 1) / kRows;
  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * kRows;
    __syncthreads();
    load_tile<T, D>(sK, k, b, h, k0, T_);
    load_tile<T, D>(sV, v, b, h, k0, T_);
    __syncthreads();
    float p[8][4], dp[8][4];
    zero(p);
    zero(dp);
    WarpMma<T, 8, true>::run(p, sQ + warp * 16 * kLd, kLd, sK, kLd, D);
    WarpMma<T, 8, true>::run(dp, sO + warp * 16 * kLd, kLd, sV, kLd, D);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + frag_row(e);
        const bool ok = visible(row, k0 + frag_col(j, e), T_, kCausal) && row < T_;
        const float pe = ok ? expf(p[j][e] * scale - row_lse[e >> 1]) : 0.f;
        dp[j][e] = (dp[j][e] - row_di[e >> 1]) * pe * scale;
      }
    store_frag<T>(sPw, dp);
    __syncwarp();
    WarpMma<T, D / 8, false>::run(acc, sPw, kLdP, sK, kLd, kRows);
    __syncwarp();
  }
#pragma unroll
  for (int e = 0; e < 4; e += 2) {
    const int row = r0 + frag_row(e);
    if (row >= T_) continue;
    T* qrow = row_ptr<T>(dq, b, row, h);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      qrow[frag_col(j, e)] = from_f<T>(acc[j][e]);
      qrow[frag_col(j, e) + 1] = from_f<T>(acc[j][e + 1]);
    }
  }
}

// -------------------------------------------------------------- launch --
// Shared memory for n_tiles [64][D+kPad] tiles and the P (dS) tile.
template <typename T, int D>
constexpr size_t tile_bytes(int n_tiles) {
  return (size_t)n_tiles * kRows * (D + kPad) * sizeof(T) + (size_t)kRows * kLdP * sizeof(T);
}

struct Args {
  int causal, T, H, B;
  float scale;
  View q, k, v, o, dout, dq, dk, dv;
  const float* lse_in;
  float* lse_out;
  const float* di;
  cudaStream_t st;
  dim3 grid() const { return dim3((T + kRows - 1) / kRows, H, B); }
};

// Opts the kernel in to `smem` bytes of dynamic shared memory.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int D, bool kCausal>
struct Fwd {
  static cudaError_t go(const Args& a) {
    auto kernel = flash_fwd_kernel<T, D, kCausal>;
    const size_t smem = tile_bytes<T, D>(3);
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<a.grid(), kFlashThreads, smem, a.st>>>(a.q, a.k, a.v, a.o, a.lse_out, a.T, a.H,
                                                    a.scale);
    return cudaGetLastError();
  }
};

template <typename T, int D, bool kCausal>
struct Dkv {
  static cudaError_t go(const Args& a) {
    auto kernel = flash_bwd_dkv_kernel<T, D, kCausal>;
    const size_t smem = tile_bytes<T, D>(4) + 2 * kRows * sizeof(float);
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<a.grid(), kFlashThreads, smem, a.st>>>(a.q, a.k, a.v, a.dout, a.lse_in, a.di, a.dk,
                                                    a.dv, a.T, a.H, a.scale);
    return cudaGetLastError();
  }
};

template <typename T, int D, bool kCausal>
struct Dq {
  static cudaError_t go(const Args& a) {
    auto kernel = flash_bwd_dq_kernel<T, D, kCausal>;
    const size_t smem = tile_bytes<T, D>(4);
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<a.grid(), kFlashThreads, smem, a.st>>>(a.q, a.k, a.v, a.dout, a.lse_in, a.di, a.dq,
                                                    a.T, a.H, a.scale);
    return cudaGetLastError();
  }
};

// Picks Run's instance for (io dtype, D, causal).
template <template <typename, int, bool> class Run>
cudaError_t dispatch(int io_bf16, int D, const Args& a) {
  if (a.T < 1 || a.H < 1 || a.B < 1 || a.H > 65535 || a.B > 65535) return cudaErrorInvalidValue;
#define PTT_FLASH_CASE(TY, DD) \
  if (D == DD) return a.causal ? Run<TY, DD, true>::go(a) : Run<TY, DD, false>::go(a);
  if (io_bf16) {
    PTT_FLASH_CASE(__nv_bfloat16, 64)
    PTT_FLASH_CASE(__nv_bfloat16, 128)
  } else {
    PTT_FLASH_CASE(float, 64)
    PTT_FLASH_CASE(float, 128)
  }
#undef PTT_FLASH_CASE
  return cudaErrorInvalidValue;  // D is neither 64 nor 128
}

Args args(int causal, int B, int T, int H, float scale, void* stream) {
  Args a{};
  a.causal = causal;
  a.B = B;
  a.T = T;
  a.H = H;
  a.scale = scale;
  a.st = static_cast<cudaStream_t>(stream);
  return a;
}

}  // namespace

// q, k, v, o: [B,T,H,D] views in the io dtype; lse: [B,H,T] f32 out.
extern "C" int flash_fwd_launch(int io_bf16, int causal, int B, int T, int H, int D,
                                float scale, const View* q, const View* k, const View* v,
                                const View* o, void* lse, void* stream) {
  Args a = args(causal, B, T, H, scale, stream);
  a.q = *q;
  a.k = *k;
  a.v = *v;
  a.o = *o;
  a.lse_out = static_cast<float*>(lse);
  return dispatch<Fwd>(io_bf16, D, a);
}

// as flash_fwd_launch, plus dO in, lse and di [B,H,T] f32 in; dk, dv out
extern "C" int flash_bwd_dkv_launch(int io_bf16, int causal, int B, int T, int H, int D,
                                    float scale, const View* q, const View* k, const View* v,
                                    const View* dout, const void* lse, const void* di,
                                    const View* dk, const View* dv, void* stream) {
  Args a = args(causal, B, T, H, scale, stream);
  a.q = *q;
  a.k = *k;
  a.v = *v;
  a.dout = *dout;
  a.lse_in = static_cast<const float*>(lse);
  a.di = static_cast<const float*>(di);
  a.dk = *dk;
  a.dv = *dv;
  return dispatch<Dkv>(io_bf16, D, a);
}

// as flash_bwd_dkv_launch, with dq out
extern "C" int flash_bwd_dq_launch(int io_bf16, int causal, int B, int T, int H, int D,
                                   float scale, const View* q, const View* k, const View* v,
                                   const View* dout, const void* lse, const void* di,
                                   const View* dq, void* stream) {
  Args a = args(causal, B, T, H, scale, stream);
  a.q = *q;
  a.k = *k;
  a.v = *v;
  a.dout = *dout;
  a.lse_in = static_cast<const float*>(lse);
  a.di = static_cast<const float*>(di);
  a.dq = *dq;
  return dispatch<Dq>(io_bf16, D, a);
}

extern "C" const char* flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
