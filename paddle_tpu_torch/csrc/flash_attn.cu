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
// scores to memory: each block of scores lives in registers, as in the TPU
// kernel.
//
// In f32 io all three kernels are the first design: a CTA of 4 warps owns
// 64 rows (queries for the forward and dQ, keys for dK/dV) of one (b, h);
// each warp owns 16 of them. Tiles of 64 rows of the other side are staged
// in shared memory, one after the other, skipping the blocks above the
// diagonal when causal. Both products of a block run as f32 FMAs on
// mma.sync's fragment layout; the scores and softmax are f32 in registers.
// The second product's left operand (P, or dS) goes through the warp's own
// shared-memory rows.
//
// In bf16 io, the slice's dtype, all three run on wgmma fed by TMA
// (flash_fwd_tc_kernel, flash_bwd_dkv_tc_kernel, flash_bwd_dq_tc_kernel).
// The backward is bound by its 7 products (4 in dK/dV, 3 in dQ: S and dP
// are computed in both, so each output element is written by one CTA, with
// no atomics); the forward by its bytes at the main path's shapes, but with
// 4096 exponentials a block it is the products and the softmax between
// them that set its pace:
// - A backward CTA is one consumer warpgroup, which owns 64 rows (keys for
//   dK/dV, queries for dQ) of one (b, h), and a producer warp; a forward
//   CTA two consumer warpgroups of 64 query rows each, which share every
//   streamed tile. TMA brings the CTA's own tiles once (Q; K and V; Q and
//   dO); they stay in shared memory. The producer streams the other side's
//   64-row tiles (K and V, Q and dO) through a ring of stages, each
//   completing on its mbarrier and freed by the consumers on another, so
//   the next tiles land while this one is multiplied. The dK/dV
//   producer's lanes also copy each query tile's LSE·log2 e and Di rows
//   into the stage. (128-row dK/dV CTAs ran no faster; the forward with
//   one warpgroup a CTA ran 1.15x slower causal, 1.55x full.)
// - The tensor maps are 4-D (D, H, T, B) over the [B,T,H,D] views as
//   they are, boxes of 64 columns (one 128-byte swizzled row) by 64 rows;
//   rows past T read as zeros and are not written.
// - S = Q Kᵀ (Sᵀ = K Qᵀ and dPᵀ = V dOᵀ for dK/dV, dP = dO Vᵀ for dQ) are
//   wgmma m64n64k16 with both operands K-major in shared memory. The
//   forward's online softmax runs in f32 registers in base 2, scale·log2 e
//   folded into the scores, one ex2 an element: the row max m, the sum l
//   of the unrounded P, acc and l rescaled by 2^(m_old − m), as
//   flash_fwd_plain walks its 64-key blocks. P = 2^(s·scale·log2 e −
//   LSE·log2 e) and dS = P∘(dP − Di)·scale in the backward. P and dS are
//   rounded to bf16 into the A fragments of the second products (wgmma's
//   accumulator layout is its A layout per 16 columns): O += P V, dV += Pᵀ
//   dO, dK += dSᵀ Q, dQ += dS K, with V, dO, Q and K MN-major through
//   their descriptors, so P and dS never go to shared memory.
// - Only blocks on the diagonal (causal) or past T evaluate the mask; the
//   walks and the mask flags are ops/flash_kernels.py's bwd_schedule (the
//   forward's q_schedule is its dQ walk: 128-row CTAs, each warpgroup on
//   its own 64-row entry). Causal CTAs with the most blocks launch first
//   (key block 0, the last query block).
// - Each output element is written once, by a TMA store of the rounded
//   accumulator staged in shared memory: the same bits on every run. The
//   forward scales O by 1/l before its one rounding and writes LSE = m·ln 2
//   + log l, f32, for the rows below T.
// What holds them back: a warpgroup waits on its own first product before
// the exponentials and on its second before the next block, so its
// tensor cores idle through the block's 4096 exponentials and their
// arithmetic; only the other warpgroups on the SM fill that time, without
// a schedule. Overlapping one block's softmax with the last block's P·V
// inside a warpgroup (two groups of wgmma in flight) ran 1.67x slower on
// an H100: ptxas serialized the wgmmas (C7515) and spilled. Warpgroups
// that take turns on the tensor cores by named barriers are the way on.

#include "common.cuh"

#include <math.h>
#include <stdint.h>

#include <type_traits>

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

// ------------------------------------------------------- forward, f32 --
// One CTA per (q block of 64, h, b). smem: Q, K, V [64][D+kPad], P [64][kLdP].
template <typename T, int D, bool kCausal>
__global__ void __launch_bounds__(kFlashThreads)
flash_fwd_kernel(View q, View k, View v, View o, float* __restrict__ lse, int T_, int H,
                 float scale) {
  static_assert(std::is_same<T, float>::value, "bf16 runs flash_fwd_tc_kernel");
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

// ------------------------------------------------- backward dK/dV, f32 --
// One CTA per (k block of 64, h, b): walks the q blocks from the diagonal.
// smem: K, V, Q, dO [64][D+kPad], Pᵀ then dSᵀ [64][kLdP], LSE and Di [64] f32.
template <typename T, int D, bool kCausal>
__global__ void __launch_bounds__(kFlashThreads)
flash_bwd_dkv_kernel(View q, View k, View v, View dout, const float* __restrict__ lse,
                     const float* __restrict__ di, View dk, View dv, int T_, int H, float scale) {
  static_assert(std::is_same<T, float>::value, "bf16 runs flash_bwd_dkv_tc_kernel");
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

// ---------------------------------------------------- backward dQ, f32 --
// One CTA per (q block of 64, h, b): walks the k blocks up to the diagonal.
// smem: Q, dO, K, V [64][D+kPad], dS [64][kLdP].
template <typename T, int D, bool kCausal>
__global__ void __launch_bounds__(kFlashThreads)
flash_bwd_dq_kernel(View q, View k, View v, View dout, const float* __restrict__ lse,
                    const float* __restrict__ di, View dq, int T_, int H, float scale) {
  static_assert(std::is_same<T, float>::value, "bf16 runs flash_bwd_dq_tc_kernel");
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

// ------------------------------------------- backward, bf16: wgmma and TMA --
constexpr int kBwdRows = 64;   // rows a CTA owns: its consumer warpgroup's
constexpr int kBwdCols = 64;   // rows of each streamed tile
constexpr int kBwdStages = 3;  // streamed tiles in flight
constexpr int kBwdConsumers = 128;
constexpr int kBwdThreads = kBwdConsumers + 32;  // and the producer warp
constexpr int kBox = 64 * kSwRow;                // a TMA box: 64 rows of 64 bf16
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
static_assert(kBwdRows == 64 && kBwdCols == 64, "a box is 64 rows; a warpgroup owns 64 rows");

// Shared memory of a CTA at head dim D: the resident tiles, the ring (each
// stage two tiles and two rows of 64 f32), the barriers.
template <int D>
struct Bwd {
  static constexpr int kTile = D / 64 * kBox;  // [64][D] in D/64 boxes of 64 columns
  static constexpr int kStage = 2 * kTile + 1024;
  static constexpr int kSmem = 1024 + 2 * kTile + kBwdStages * kStage + 64;  // and alignment slack
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// 2^x, one MUFU op (results below 2^-126 flush to 0, far under P's bf16 rounding)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The walk of ops/flash_kernels.py's bwd_schedule. The dK/dV CTA of key
// block kb walks query tiles dkv_first(kb).. to the last; the dQ CTA of
// query block qb key tiles 0..dq_last(qb). A block evaluates the mask when
// it holds a row or column past T or, causal, a pair above the diagonal
// (a key after its query).
__device__ __forceinline__ int dkv_first(int kb, bool causal) {
  return causal ? kb * kBwdRows / kBwdCols : 0;
}
__device__ __forceinline__ int dq_last(int qb, int T, bool causal) {
  const int last = cdiv(T, kBwdCols) - 1;
  return causal ? min(last, (qb * kBwdRows + kBwdRows - 1) / kBwdCols) : last;
}
__device__ __forceinline__ bool dkv_masked(int k0, int q0, int T, bool causal) {
  return k0 + kBwdRows > T || q0 + kBwdCols > T || (causal && k0 + kBwdRows - 1 > q0);
}
__device__ __forceinline__ bool dq_masked(int q0, int k0, int T, bool causal) {
  return q0 + kBwdRows > T || k0 + kBwdCols > T || (causal && k0 + kBwdCols - 1 > q0);
}

// rows [t0, t0 + 64) of head (b, h) into a tile, completing on `bar`
template <int D>
__device__ __forceinline__ void load_rows(unsigned char* tile, const CUtensorMap* map, int b, int h,
                                          int t0, uint64_t* bar) {
#pragma unroll
  for (int x = 0; x < D / 64; ++x) tma_load(tile + x * kBox, map, x * 64, h, t0, b, bar);
}

// a tile out to rows [t0, t0 + 64) of head (b, h), clipped at T
template <int D>
__device__ __forceinline__ void store_rows(const CUtensorMap* map, const unsigned char* tile, int b,
                                           int h, int t0) {
#pragma unroll
  for (int x = 0; x < D / 64; ++x) tma_store(map, tile + x * kBox, x * 64, h, t0, b);
}

// descriptor of k16 step kk of a [64][D] tile read K-major (K = d)
__device__ __forceinline__ uint64_t kmajor(const unsigned char* tile, int kk) {
  return sw128_desc(tile + kk / 4 * kBox) + 2 * (kk % 4);
}

// descriptor of k16 step kk of a [64][D] tile read MN-major (K = its rows,
// N = d)
__device__ __forceinline__ uint64_t mnmajor(const unsigned char* tile, int kk) {
  return sw128_desc_mn(tile + kk * 16 * kSwRow, kBox);
}

// An m64n64 f32 accumulator rounded to bf16: the A fragments of the four
// k16 steps of a product over its 64 columns.
__device__ __forceinline__ void to_a_frags(uint32_t (&a)[4][4], const float (&c)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16x2(c[8 * kk], c[8 * kk + 1]);
    a[kk][1] = pack_bf16x2(c[8 * kk + 2], c[8 * kk + 3]);
    a[kk][2] = pack_bf16x2(c[8 * kk + 4], c[8 * kk + 5]);
    a[kk][3] = pack_bf16x2(c[8 * kk + 6], c[8 * kk + 7]);
  }
}

// The warpgroup's [64][D] f32 accumulator rounded to bf16 into a tile, in
// the swizzled layout a TMA store reads (warp w % 4 of the warpgroup owns
// rows 16·(w % 4)..).
template <int D>
__device__ __forceinline__ void stage_acc(unsigned char* tile, const float (&acc)[D / 2]) {
  const int warp = (threadIdx.x >> 5) & 3, g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = warp * 16 + g + 8 * hf;
      *reinterpret_cast<uint32_t*>(tile + j / 8 * kBox + sw128(r, j % 8) + 4 * q) =
          pack_bf16x2(acc[4 * j + 2 * hf], acc[4 * j + 2 * hf + 1]);
    }
}

// grid (B·H, key blocks), block 0 first. Each consumer thread holds rows
// key_a = k0 + 16·warp + g and key_a + 8 of Sᵀ, dPᵀ, dK and dV.
template <int D, bool kCausal>
__global__ void __launch_bounds__(kBwdThreads, D == 64 ? 2 : 1)
flash_bwd_dkv_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                        const __grid_constant__ CUtensorMap tdk, const __grid_constant__ CUtensorMap tdv,
                        const float* __restrict__ lse, const float* __restrict__ di, int T_, int H,
                        float scale) {
  using S = Bwd<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sK = align1024(smem_raw);
  unsigned char* sV = sK + S::kTile;
  unsigned char* ring = sV + S::kTile;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kBwdStages * S::kStage);
  uint64_t* empty = full + kBwdStages;
  uint64_t* resident = empty + kBwdStages;
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int kb = blockIdx.y, k0 = kb * kBwdRows;
  const int first = dkv_first(kb, kCausal);
  const int n_blocks = cdiv(T_, kBwdCols) - first;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(full + s, 32);  // the producer's lanes; lane 0's arrival also expects the tiles
      mbar_init(empty + s, kBwdConsumers);
    }
    mbar_init(resident, 1);
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= kBwdConsumers) {  // the producer warp
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      mbar_expect(resident, 2 * S::kTile);
      load_rows<D>(sK, &tk, b, h, k0, resident);
      load_rows<D>(sV, &tv, b, h, k0, resident);
    }
    const float* lse_bh = lse + (size_t)bh * T_;
    const float* di_bh = di + (size_t)bh * T_;
    for (int i = 0; i < n_blocks; ++i) {
      const int s = i % kBwdStages, q0 = (first + i) * kBwdCols;
      if (i >= kBwdStages) mbar_wait(empty + s, (i / kBwdStages - 1) & 1);
      unsigned char* st = ring + s * S::kStage;
      float* rows = reinterpret_cast<float*>(st + 2 * S::kTile);  // LSE·log2 e, then Di
      for (int r = lane; r < kBwdCols; r += 32) {
        const bool ok = q0 + r < T_;
        rows[r] = ok ? lse_bh[q0 + r] * kLog2e : 0.f;
        rows[kBwdCols + r] = ok ? di_bh[q0 + r] : 0.f;
      }
      if (lane == 0) {
        mbar_expect(full + s, 2 * S::kTile);
        load_rows<D>(st, &tq, b, h, q0, full + s);
        load_rows<D>(st + S::kTile, &tdo, b, h, q0, full + s);
      } else {
        mbar_arrive(full + s);
      }
    }
    return;
  }

  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  const int key_a = k0 + warp * 16 + g;
  const float scale_log2 = scale * kLog2e;
  float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
  mbar_wait(resident, 0);
  for (int i = 0; i < n_blocks; ++i) {
    const int s = i % kBwdStages, q0 = (first + i) * kBwdCols;
    const unsigned char* sQ = ring + s * S::kStage;
    const unsigned char* sO = sQ + S::kTile;  // dO
    const float* rows = reinterpret_cast<const float*>(sO + S::kTile);
    mbar_wait(full + s, (i / kBwdStages) & 1);
    float sc[32], dp[32];  // Sᵀ then Pᵀ, and dPᵀ then dSᵀ: [this thread's keys][queries]
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) Wgmma<64>::ss(sc, kmajor(sK, kk), kmajor(sQ, kk), kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) Wgmma<64>::ss(dp, kmajor(sV, kk), kmajor(sO, kk), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(sc);
    fence_acc(dp);
    const bool masked = dkv_masked(k0, q0, T_, kCausal);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * q + (e & 1);  // query q0 + col
        float p = ex2(fmaf(sc[4 * j + e], scale_log2, -rows[col]));
        if (masked) {
          const int key = key_a + 8 * (e >> 1), qr = q0 + col;
          if (qr >= T_ || key >= T_ || (kCausal && key > qr)) p = 0.f;
        }
        sc[4 * j + e] = p;
        dp[4 * j + e] = (dp[4 * j + e] - rows[kBwdCols + col]) * p * scale;
      }
    uint32_t pa[4][4], da[4][4];
    to_a_frags(pa, sc);
    to_a_frags(da, dp);
    fence_acc(acc_v);
    fence_acc(acc_k);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) Wgmma<D>::template rs<1>(acc_v, pa[kk], mnmajor(sO, kk), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) Wgmma<D>::template rs<1>(acc_k, da[kk], mnmajor(sQ, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc_v);
    fence_acc(acc_k);
    fence_regs(pa);
    fence_regs(da);
    mbar_arrive(empty + s);
  }
  bar_sync(1, kBwdConsumers);  // every warp is past its last product on K and V
  stage_acc<D>(sK, acc_k);
  stage_acc<D>(sV, acc_v);
  fence_async_smem();
  bar_sync(1, kBwdConsumers);
  if (threadIdx.x == 0) {
    store_rows<D>(&tdk, sK, b, h, k0);
    store_rows<D>(&tdv, sV, b, h, k0);
    bulk_commit();
    bulk_wait_read<0>();  // the copies have read the tiles before the CTA ends
  }
}

// grid (B·H, query blocks), the last block first. Each consumer thread
// holds rows q0 + 16·warp + g and + 8 of S, dP and dQ.
template <int D, bool kCausal>
__global__ void __launch_bounds__(kBwdThreads, D == 64 ? 2 : 1)
flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                       const __grid_constant__ CUtensorMap tdq, const float* __restrict__ lse,
                       const float* __restrict__ di, int T_, int H, float scale) {
  using S = Bwd<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sQ = align1024(smem_raw);
  unsigned char* sO = sQ + S::kTile;  // dO
  unsigned char* ring = sO + S::kTile;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kBwdStages * S::kStage);
  uint64_t* empty = full + kBwdStages;
  uint64_t* resident = empty + kBwdStages;
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int qb = cdiv(T_, kBwdRows) - 1 - (int)blockIdx.y, q0 = qb * kBwdRows;
  const int n_blocks = dq_last(qb, T_, kCausal) + 1;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kBwdConsumers);
    }
    mbar_init(resident, 1);
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= kBwdConsumers) {  // the producer warp; its lane 0 issues every copy
    if ((threadIdx.x & 31) != 0) return;
    mbar_expect(resident, 2 * S::kTile);
    load_rows<D>(sQ, &tq, b, h, q0, resident);
    load_rows<D>(sO, &tdo, b, h, q0, resident);
    for (int i = 0; i < n_blocks; ++i) {
      const int s = i % kBwdStages, k0 = i * kBwdCols;
      if (i >= kBwdStages) mbar_wait(empty + s, (i / kBwdStages - 1) & 1);
      unsigned char* st = ring + s * S::kStage;
      mbar_expect(full + s, 2 * S::kTile);
      load_rows<D>(st, &tk, b, h, k0, full + s);
      load_rows<D>(st + S::kTile, &tv, b, h, k0, full + s);
    }
    return;
  }

  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  const int row_a = q0 + warp * 16 + g;
  const float scale_log2 = scale * kLog2e;
  float lse2[2], dii[2];  // rows row_a and row_a + 8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_a + 8 * i;
    lse2[i] = row < T_ ? lse[(size_t)bh * T_ + row] * kLog2e : 0.f;
    dii[i] = row < T_ ? di[(size_t)bh * T_ + row] : 0.f;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  mbar_wait(resident, 0);
  for (int i = 0; i < n_blocks; ++i) {
    const int s = i % kBwdStages, k0 = i * kBwdCols;
    const unsigned char* sK = ring + s * S::kStage;
    const unsigned char* sV = sK + S::kTile;
    mbar_wait(full + s, (i / kBwdStages) & 1);
    float sc[32], dp[32];  // S then P, and dP then dS: [this thread's queries][keys]
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) Wgmma<64>::ss(sc, kmajor(sQ, kk), kmajor(sK, kk), kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) Wgmma<64>::ss(dp, kmajor(sO, kk), kmajor(sV, kk), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(sc);
    fence_acc(dp);
    const bool masked = dq_masked(q0, k0, T_, kCausal);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ex2(fmaf(sc[4 * j + e], scale_log2, -lse2[e >> 1]));
        if (masked) {
          const int key = k0 + 8 * j + 2 * q + (e & 1), row = row_a + 8 * (e >> 1);
          if (row >= T_ || key >= T_ || (kCausal && key > row)) p = 0.f;
        }
        dp[4 * j + e] = (dp[4 * j + e] - dii[e >> 1]) * p * scale;
      }
    uint32_t da[4][4];
    to_a_frags(da, dp);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) Wgmma<D>::template rs<1>(acc, da[kk], mnmajor(sK, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    fence_regs(da);
    mbar_arrive(empty + s);
  }
  bar_sync(1, kBwdConsumers);  // every warp is past its last product on Q
  stage_acc<D>(sQ, acc);
  fence_async_smem();
  bar_sync(1, kBwdConsumers);
  if (threadIdx.x == 0) {
    store_rows<D>(&tdq, sQ, b, h, q0);
    bulk_commit();
    bulk_wait_read<0>();
  }
}

// ------------------------------------------- forward, bf16: wgmma and TMA --
// The forward's CTA: two consumer warpgroups of 64 query rows each, which
// share every streamed K and V tile (one warpgroup a CTA ran 1.15x slower
// causal, 1.55x full, on an H100), and the producer warp.
constexpr int kFwdWGs = 2;
constexpr int kFwdRows = 64 * kFwdWGs;  // query rows a CTA owns
constexpr int kFwdConsumers = 128 * kFwdWGs;
constexpr int kFwdThreads = kFwdConsumers + 32;

// Shared memory of a CTA at head dim D: the warpgroups' Q tiles, the ring
// (each stage K and V), the barriers. Three stages at D=64 (two CTAs an
// SM), two at D=128 (one).
template <int D>
struct FwdSmem {
  static constexpr int kTile = D / 64 * kBox;
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr int kStage = 2 * kTile;
  static constexpr int kSmem = 1024 + kFwdWGs * kTile + kStages * kStage + 64;
};

// The online softmax of one 64-key block, rows row_a and row_a + 8 of this
// thread: sc holds the block's scores and becomes the unrounded P; the
// row max m (base 2) and the lane's share of l are updated, and alpha =
// 2^(m_old − m) is returned for the accumulator.
template <bool kCausal>
__device__ __forceinline__ void softmax_block(float (&sc)[32], float (&m)[2], float (&l)[2],
                                              float (&alpha)[2], bool masked, int k0, int row_a,
                                              int T_, float scale_log2) {
  const int q = threadIdx.x & 3;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (masked) {
        const int key = k0 + 8 * j + 2 * q + (e & 1), row = row_a + 8 * (e >> 1);
        if (key >= T_ || (kCausal && key > row)) sc[4 * j + e] = -INFINITY;
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // every row sees key k0 of each block it visits (rows past T too: only
    // keys past T or after the row are masked), so m is finite from the
    // first block on
    const float m_new = fmaxf(m[r], quad_max(mx[r]) * scale_log2);
    alpha[r] = ex2(m[r] - m_new);  // 0 at the first block (m = -inf)
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(fmaf(sc[4 * j + e], scale_log2, -m[e >> 1]));
      l[e >> 1] += p;
      sc[4 * j + e] = p;
    }
}

// grid (B·H, query blocks of kFwdRows), the last block first: the walk of
// the dQ kernel at 128 rows (q_schedule). Consumer warpgroup w owns rows
// q0 + 64·w.. and walks its own 64-row block's key tiles over the shared
// ring (causal: one fewer for w = 0), with its own mask flags; each of its
// threads holds rows 16·warp + g and + 8 of S, P and O, and their m and
// its share of l.
template <int D, bool kCausal>
__global__ void __launch_bounds__(kFwdThreads, D == 64 ? 2 : 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                    float* __restrict__ lse, int T_, int H, float scale) {
  using S = FwdSmem<D>;
  constexpr int kSt = S::kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sQ = align1024(smem_raw);
  unsigned char* ring = sQ + kFwdWGs * S::kTile;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kSt * S::kStage);
  uint64_t* empty = full + kSt;
  uint64_t* resident = empty + kSt;
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int qb = cdiv(T_, kFwdRows) - 1 - (int)blockIdx.y, q0 = qb * kFwdRows;
  const int n_blocks = dq_last(q0 / 64 + kFwdWGs - 1, T_, kCausal) + 1;  // the last warpgroup's
  if (threadIdx.x == 0) {
    for (int s = 0; s < kSt; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kFwdConsumers);
    }
    mbar_init(resident, 1);
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= kFwdConsumers) {  // the producer warp; its lane 0 issues every copy
    if ((threadIdx.x & 31) != 0) return;
    mbar_expect(resident, kFwdWGs * S::kTile);
#pragma unroll
    for (int w = 0; w < kFwdWGs; ++w)
      load_rows<D>(sQ + w * S::kTile, &tq, b, h, q0 + 64 * w, resident);
    for (int i = 0; i < n_blocks; ++i) {
      const int s = i % kSt, k0 = i * kBwdCols;
      if (i >= kSt) mbar_wait(empty + s, (i / kSt - 1) & 1);
      unsigned char* st = ring + s * S::kStage;
      mbar_expect(full + s, 2 * S::kTile);
      load_rows<D>(st, &tk, b, h, k0, full + s);
      load_rows<D>(st + S::kTile, &tv, b, h, k0, full + s);
    }
    return;
  }

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  const int q0w = q0 + 64 * wg, row_a = q0w + warp * 16 + g;
  // this warpgroup's blocks; a block past them (causal, w = 0) is the
  // CTA's last, whose stage no copy reuses
  const int my_blocks = dq_last(q0w / 64, T_, kCausal) + 1;
  unsigned char* sQw = sQ + wg * S::kTile;
  const float scale_log2 = scale * kLog2e;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  mbar_wait(resident, 0);
  for (int i = 0; i < my_blocks; ++i) {
    const int s = i % kSt, k0 = i * kBwdCols;
    const unsigned char* sK = ring + s * S::kStage;
    const unsigned char* sV = sK + S::kTile;
    mbar_wait(full + s, (i / kSt) & 1);
    float sc[32];  // S, then P: [this thread's queries][keys]
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) Wgmma<64>::ss(sc, kmajor(sQw, kk), kmajor(sK, kk), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(sc);
    float alpha[2];
    softmax_block<kCausal>(sc, m, l, alpha, dq_masked(q0w, k0, T_, kCausal), k0, row_a, T_,
                           scale_log2);
    uint32_t pa[4][4];
    to_a_frags(pa, sc);
    fence_acc(acc);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[4 * j + e] *= alpha[e >> 1];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) Wgmma<D>::template rs<1>(acc, pa[kk], mnmajor(sV, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    fence_regs(pa);
    mbar_arrive(empty + s);
  }
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    inv[r] = 1.f / l[r];
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[4 * j + e] *= inv[e >> 1];
  if (q == 0)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row_a + 8 * r < T_) lse[(size_t)bh * T_ + row_a + 8 * r] = m[r] * kLn2 + logf(l[r]);
  bar_sync(1 + wg, 128);  // every warp of the warpgroup is past its last product on its Q
  stage_acc<D>(sQw, acc);
  fence_async_smem();
  bar_sync(1 + wg, 128);
  if ((threadIdx.x & 127) == 0 && q0w < T_) {
    store_rows<D>(&to, sQw, b, h, q0w);
    bulk_commit();
    bulk_wait_read<0>();
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
  int n_ctas;  // CTAs a head, from q_schedule and bwd_schedule
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

// The 4-D map (D, H, T, B) over a [B,T,H,D] bf16 view, in boxes of 64
// columns by 64 rows of one head.
bool view_map(CUtensorMap* m, const View& v, const Args& a, int D) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)a.H, (cuuint64_t)a.T, (cuuint64_t)a.B};
  const cuuint64_t strides[3] = {(cuuint64_t)v.sh * 2, (cuuint64_t)v.st * 2, (cuuint64_t)v.sb * 2};
  const cuuint32_t box[4] = {64, 1, kBwdRows, 1};
  return encode_tiled(m, 4, v.p, dims, strides, box);
}

// The maps over `views`, then the bf16 kernel on grid (B·H, n_ctas), with
// `threads` threads and `smem` bytes of shared memory a CTA.
template <int D, int N, typename Kernel, typename... Rest>
cudaError_t launch_tc(Kernel kernel, int threads, int smem, const Args& a,
                      const View* const (&views)[N], Rest... rest) {
  CUtensorMap m[N];
  for (int i = 0; i < N; ++i)
    if (!view_map(&m[i], *views[i], a, D)) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, a.n_ctas);
  if constexpr (N == 6)
    kernel<<<grid, threads, smem, a.st>>>(m[0], m[1], m[2], m[3], m[4], m[5], rest...);
  else if constexpr (N == 5)
    kernel<<<grid, threads, smem, a.st>>>(m[0], m[1], m[2], m[3], m[4], rest...);
  else
    kernel<<<grid, threads, smem, a.st>>>(m[0], m[1], m[2], m[3], rest...);
  return cudaGetLastError();
}

// f32 io: flash_fwd_kernel; bf16: flash_fwd_tc_kernel
template <typename T, int D, bool kCausal>
struct Fwd {
  static cudaError_t go(const Args& a) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      const View* const views[4] = {&a.q, &a.k, &a.v, &a.o};
      return launch_tc<D>(flash_fwd_tc_kernel<D, kCausal>, kFwdThreads, FwdSmem<D>::kSmem, a,
                          views, a.lse_out, a.T, a.H, a.scale);
    } else {
      auto kernel = flash_fwd_kernel<T, D, kCausal>;
      const size_t smem = tile_bytes<T, D>(3);
      cudaError_t err = allow_smem(kernel, smem);
      if (err != cudaSuccess) return err;
      kernel<<<a.grid(), kFlashThreads, smem, a.st>>>(a.q, a.k, a.v, a.o, a.lse_out, a.T, a.H,
                                                      a.scale);
      return cudaGetLastError();
    }
  }
};

// f32 io: flash_bwd_dkv_kernel; bf16: flash_bwd_dkv_tc_kernel
template <typename T, int D, bool kCausal>
struct Dkv {
  static cudaError_t go(const Args& a) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      const View* const views[6] = {&a.q, &a.k, &a.v, &a.dout, &a.dk, &a.dv};
      return launch_tc<D>(flash_bwd_dkv_tc_kernel<D, kCausal>, kBwdThreads, Bwd<D>::kSmem, a,
                          views, a.lse_in, a.di, a.T, a.H, a.scale);
    } else {
      auto kernel = flash_bwd_dkv_kernel<T, D, kCausal>;
      const size_t smem = tile_bytes<T, D>(4) + 2 * kRows * sizeof(float);
      cudaError_t err = allow_smem(kernel, smem);
      if (err != cudaSuccess) return err;
      kernel<<<a.grid(), kFlashThreads, smem, a.st>>>(a.q, a.k, a.v, a.dout, a.lse_in, a.di,
                                                      a.dk, a.dv, a.T, a.H, a.scale);
      return cudaGetLastError();
    }
  }
};

// f32 io: flash_bwd_dq_kernel; bf16: flash_bwd_dq_tc_kernel
template <typename T, int D, bool kCausal>
struct Dq {
  static cudaError_t go(const Args& a) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      const View* const views[5] = {&a.q, &a.k, &a.v, &a.dout, &a.dq};
      return launch_tc<D>(flash_bwd_dq_tc_kernel<D, kCausal>, kBwdThreads, Bwd<D>::kSmem, a,
                          views, a.lse_in, a.di, a.T, a.H, a.scale);
    } else {
      auto kernel = flash_bwd_dq_kernel<T, D, kCausal>;
      const size_t smem = tile_bytes<T, D>(4);
      cudaError_t err = allow_smem(kernel, smem);
      if (err != cudaSuccess) return err;
      kernel<<<a.grid(), kFlashThreads, smem, a.st>>>(a.q, a.k, a.v, a.dout, a.lse_in, a.di,
                                                      a.dq, a.T, a.H, a.scale);
      return cudaGetLastError();
    }
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

// The checks of every launch: the CTAs a head the schedule counts are the
// kernel's (each owns `rows` rows), and the bf16 grid's B·H fits.
cudaError_t grid_ok(const Args& a, int rows = kBwdRows) {
  if (a.T < 1 || a.n_ctas != cdiv(a.T, rows) || a.n_ctas > 65535 ||
      (long long)a.B * a.H > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  return cudaSuccess;
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

// q, k, v, o: [B,T,H,D] views in the io dtype; lse: [B,H,T] f32 out;
// n_ctas: q_schedule's CTAs a head (128-row CTAs in bf16, 64-row in f32).
// bf16 views: 16-byte aligned, strides multiples of 8 elements (tensor
// maps).
extern "C" int flash_fwd_launch(int io_bf16, int causal, int B, int T, int H, int D,
                                float scale, int n_ctas, const View* q, const View* k,
                                const View* v, const View* o, void* lse, void* stream) {
  Args a = args(causal, B, T, H, scale, stream);
  a.n_ctas = n_ctas;
  if (grid_ok(a, io_bf16 ? kFwdRows : kRows) != cudaSuccess) return cudaErrorInvalidValue;
  a.q = *q;
  a.k = *k;
  a.v = *v;
  a.o = *o;
  a.lse_out = static_cast<float*>(lse);
  return dispatch<Fwd>(io_bf16, D, a);
}

// as flash_fwd_launch, n_ctas from bwd_schedule, with dO in,
// lse and di [B,H,T] f32 in; dk, dv out. bf16 views: 16-byte aligned, strides
// multiples of 8 elements (tensor maps).
extern "C" int flash_bwd_dkv_launch(int io_bf16, int causal, int B, int T, int H, int D,
                                    float scale, int n_ctas, const View* q, const View* k,
                                    const View* v, const View* dout, const void* lse,
                                    const void* di, const View* dk, const View* dv, void* stream) {
  Args a = args(causal, B, T, H, scale, stream);
  a.n_ctas = n_ctas;
  if (grid_ok(a) != cudaSuccess) return cudaErrorInvalidValue;
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
                                   float scale, int n_ctas, const View* q, const View* k,
                                   const View* v, const View* dout, const void* lse,
                                   const void* di, const View* dq, void* stream) {
  Args a = args(causal, B, T, H, scale, stream);
  a.n_ctas = n_ctas;
  if (grid_ok(a) != cudaSuccess) return cudaErrorInvalidValue;
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
