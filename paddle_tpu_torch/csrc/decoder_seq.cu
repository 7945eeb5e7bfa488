// The NMT attention-GRU decoder's whole-sequence forward and backward for
// Hopper (sm_90a), one launch each per training step.
//
// Replace the TPU kernels of paddle_tpu/ops/bahdanau_kernels.py:
//   decoder_seq_fwd  `_decoder_seq_kernel` (:347, launched by
//                    `_decoder_seq_fwd` :399): for t = 0..T-1,
//                      dp   = h · wa_dec                      f32, not rounded
//                      α    = softmax_S(masked Σ_A tanh(ep + dp)·v)
//                      ctx  = io(Σ_S io(α)·enc)
//                      xp   = io(xpx_t + io(ctx · wx_c))      two roundings
//                      u, r = sigmoid(xp[:2H] + io(h · w_ur))
//                      c    = tanh(xp[2H:] + io(io(r·h) · w_c))
//                      h'   = (1-u)·h + u·c, the masked carry
//                    the GRU cell op by op in the io dtype, as the TPU
//                    kernel's jnp ops round; outputs h_seq [T,B,H], alpha
//                    [T,B,S] f32, ctx [T,B,C].
//   decoder_seq_bwd  `_decoder_seq_bwd_kernel` (:460, launched by
//                    `_decoder_seq_bwd` :568): for t = T-1..0, the GRU
//                    cell's backward, the attention's backward and the
//                    d(enc_proj)/dv accumulation, with the dh carry in f32;
//                    each product's left operand is rounded to the io dtype
//                    (it is read from the io-typed output it was written
//                    to), its sum taken in f32. Outputs dxp [T,B,3H], dctx
//                    [T,B,C], ddp [T,B,A], dh0 [B,H], dep [B,S,A] (summed
//                    in f32 and rounded once) and dv [A] f32.
// with ep [B,S,A], enc [B,S,C], xpx [T,B,3H] (trg · wx[:E] + bias, hoisted
// by the caller), h0 [B,H] and the weights wa_dec [H,A], v [A], wx_c
// [C,3H], w_ur [H,2H], w_c [H,H] in the io dtype (f32 or bf16); the source
// mask [B,S] and the target mask [T,B] f32.
//
// What bounds them: the T dependent steps. Each step needs all of h (dh)
// from the step before, through three products and the attention, so the
// whole card meets at a grid barrier four times a step:
//   forward   after dp, after ctx, after u/r (r·h), after h;
//   backward  after dc_pre, after dur, after dctx, after ddp.
// The bytes (ep and enc read once a step from L2, about 39 MB at B=256,
// S=50, A=512, C=1024 in bf16) and the operations are far below what the
// card does in that time. As csrc/gru_fwd.cu does, each CTA owns HC hidden
// units and keeps the weights those units need in shared memory for the
// whole launch, so they are read from device memory once:
//   forward   wx_c's 3·HC columns of the units, w_ur's 2·HC and w_c's HC,
//             and a slice of wa_dec's A columns (4 KB + 24 KB + 8 KB + 4 KB
//             at H = 512, HC = 4, bf16);
//   backward  the units' rows of w_c, w_ur and wa_dec (the transposed
//             products) and a slice of wx_c's C rows (40 KB in all).
// The attention runs one batch row at a time on a whole CTA (rows dealt
// round-robin over the CTAs), as csrc/bahdanau_attn.cu's per-step kernels
// do; a row's α stays in shared memory. Values another CTA wrote in this
// launch (h, dp, ctx, r·h, dxp, dctx, ddp) go through global buffers that
// stay in L2, read with ld.cg (past L1, which is not coherent across SMs);
// a cooperative launch keeps every CTA resident, so grid.sync() is safe.
// The backward's d(enc_proj) [B,S,A] does not fit on chip (26 MB in f32 at
// bench widths): each batch row's owner adds its step's term to an f32
// global buffer in a fixed order (t newest first) and rounds it once at the
// end. dv is summed per CTA in shared memory and the CTAs' partials summed
// in CTA order by one CTA after a last barrier: no float atomics, the same
// bits on every run.
//
// Shared memory (bytes), at the launch's HC units, AC = ceil(A / CTAs) and
// CC = ceil(C / CTAs) each rounded up to 4, item the io dtype's size:
//   forward   (AC·H + 3·HC·C + 3·HC·H)·item + (2·B·HC + 2·A + S)·4
//   backward  (HC·(3·H + A) + CC·3·H)·item + (3·B·HC + C + 3·A + S)·4
// 53 KB and 64 KB at bench widths in bf16, 94 KB and 104 KB in f32; a shape
// past the card's 227 KB is refused. Registers: 512 threads a CTA leave each
// at most 128; the products keep 5·HC f32 sums a thread (20 at HC = 4).
//
// Simple first: f32 FMAs on CUDA cores, one warp per batch row with the
// lanes splitting the reduction, 16 warps a CTA. Tensor cores, fewer
// barriers and keeping ep/enc rows on chip are later work.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace ptt;

constexpr int kSeqThreads = 512;  // 16 warps a CTA: more rows' loads in flight
constexpr int kSeqWarps = kSeqThreads / 32;
constexpr float kNeg = -1e9f;     // the masked score, as the TPU kernel's
constexpr int kChunk = 4;         // columns a warp sums at once in a sliced product
constexpr int kLoads = 8;         // x values a lane has in flight in warp_rows
constexpr int kCols = 4;          // ctx columns a thread sums at once

int round4(int n) { return (n + kChunk - 1) / kChunk * kChunk; }

// acc[n] = Σ_k x[k]·w[n·K + k] for n < N, on every lane of the warp: x a
// row another CTA may have written in this launch (read past L1), w rows of
// K values in shared memory, the lanes splitting k. A lane issues kLoads
// loads of x before it uses one, so a row costs K/(32·kLoads) trips to L2
// rather than K/32.
template <typename T, int N>
__device__ __forceinline__ void warp_rows(const T* x, const T* w, int K, float (&acc)[N]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < N; ++n) acc[n] = 0.f;
  int k0 = 0;
  for (; k0 + 32 * kLoads <= K; k0 += 32 * kLoads) {
    float xv[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) xv[u] = to_f<T>(__ldcg(x + k0 + 32 * u + lane));
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int k = k0 + 32 * u + lane;
#pragma unroll
      for (int n = 0; n < N; ++n) acc[n] += xv[u] * to_f<T>(w[(size_t)n * K + k]);
    }
  }
  for (int k = k0 + lane; k < K; k += 32) {
    const float xv = to_f<T>(__ldcg(x + k));
#pragma unroll
    for (int n = 0; n < N; ++n) acc[n] += xv * to_f<T>(w[(size_t)n * K + k]);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) acc[n] = warp_sum(acc[n]);
}

// jax.nn.sigmoid and tanh as the JAX package's ops compute them in the io
// dtype: 1/(1+exp(-x)) rounded after each op (activation_ops.sigmoid)
template <typename T>
__device__ __forceinline__ float sigmoid_io(float x) {
  return round_io<T>(1.f / round_io<T>(1.f + round_io<T>(expf(-x))));
}

template <typename T>
__device__ __forceinline__ float tanh_io(float x) {
  return round_io<T>(tanhf(x));
}

size_t fwd_smem(int B, int S, int A, int C, int H, int hc, int ac, size_t item) {
  return ((size_t)ac * H + 3 * (size_t)hc * C + 3 * (size_t)hc * H) * item +
         (2 * (size_t)B * hc + 2 * (size_t)A + S) * sizeof(float);
}

size_t bwd_smem(int B, int S, int A, int C, int H, int hc, int cc, size_t item) {
  return ((size_t)hc * (3 * H + A) + (size_t)cc * 3 * H) * item +
         (3 * (size_t)B * hc + C + 3 * (size_t)A + S) * sizeof(float);
}

// ------------------------------------------------------------------ forward --
template <typename T, int HC>
__global__ void __launch_bounds__(kSeqThreads)
decoder_seq_fwd_kernel(const T* __restrict__ ep, const T* __restrict__ enc,
                       const float* __restrict__ mask, const T* __restrict__ xpx,
                       const float* __restrict__ tmask, const T* __restrict__ h0,
                       const T* __restrict__ wa_dec, const T* __restrict__ v,
                       const T* __restrict__ wx_c, const T* __restrict__ w_ur,
                       const T* __restrict__ w_c, T* h_seq, float* __restrict__ alpha,
                       T* ctx_seq, float* dpbuf, T* rhbuf, int n_steps, int B, int S, int A,
                       int C, int H, int ac) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* u_sh = reinterpret_cast<float*>(smem_raw);  // [B][HC] u of this CTA's units
  float* xc_sh = u_sh + (size_t)B * HC;              // [B][HC] xp's candidate part
  float* dp_sh = xc_sh + (size_t)B * HC;             // [A] one row's dp
  float* v_sh = dp_sh + A;                           // [A]
  float* sc = v_sh + A;                              // [S] scores, then io(α)
  T* wad_sh = reinterpret_cast<T*>(sc + S);          // [ac][H]: wa_dec's columns a0..
  T* wxc_sh = wad_sh + (size_t)ac * H;               // [3][HC][C]: wx_c's unit columns
  T* wur_sh = wxc_sh + (size_t)3 * HC * C;           // [2][HC][H]
  T* wc_sh = wur_sh + (size_t)2 * HC * H;            // [HC][H]

  const int j0 = blockIdx.x * HC, a0 = blockIdx.x * ac;
  const int H2 = 2 * H, H3 = 3 * H;
  for (int i = threadIdx.x; i < ac * H; i += blockDim.x) {
    const int k = i % H, a = a0 + i / H;
    wad_sh[i] = a < A ? wa_dec[(size_t)k * A + a] : from_f<T>(0.f);
  }
  for (int i = threadIdx.x; i < 3 * HC * C; i += blockDim.x) {
    const int k = i % C, jj = (i / C) % HC, g = i / (C * HC), j = j0 + jj;
    wxc_sh[i] = j < H ? wx_c[(size_t)k * H3 + g * H + j] : from_f<T>(0.f);
  }
  for (int i = threadIdx.x; i < 3 * HC * H; i += blockDim.x) {
    const int k = i % H, jj = (i / H) % HC, g = i / (H * HC), j = j0 + jj;
    const T w = j >= H ? from_f<T>(0.f) : g < 2 ? w_ur[(size_t)k * H2 + g * H + j]
                                                 : w_c[(size_t)k * H + j];
    (g < 2 ? wur_sh : wc_sh)[g < 2 ? i : i - 2 * HC * H] = w;
  }
  for (int a = threadIdx.x; a < A; a += blockDim.x) v_sh[a] = to_f<T>(v[a]);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int t = 0; t < n_steps; ++t) {
    const T* hp = t == 0 ? h0 : h_seq + (size_t)(t - 1) * B * H;
    T* ctx_t = ctx_seq + (size_t)t * B * C;

    // phase A: dp = h · wa_dec for this CTA's columns of A, in f32
    for (int b = warp; b < B; b += kSeqWarps) {
      for (int c0 = 0; c0 < ac; c0 += kChunk) {
        float acc[kChunk];
        warp_rows<T, kChunk>(hp + (size_t)b * H, wad_sh + (size_t)c0 * H, H, acc);
#pragma unroll
        for (int n = 0; n < kChunk; ++n)
          if (lane == n && a0 + c0 + n < A) dpbuf[(size_t)b * A + a0 + c0 + n] = acc[n];
      }
    }
    grid.sync();

    // phase B: the attention of this CTA's batch rows, a row at a time
    for (int b = blockIdx.x; b < B; b += gridDim.x) {
      for (int a = threadIdx.x; a < A; a += blockDim.x)
        dp_sh[a] = __ldcg(dpbuf + (size_t)b * A + a);
      __syncthreads();
      for (int s = warp; s < S; s += kSeqWarps) {
        const T* row = ep + ((size_t)b * S + s) * A;
        float acc = 0.f;
#pragma unroll 8
        for (int a = lane; a < A; a += 32) acc += tanhf(to_f<T>(row[a]) + dp_sh[a]) * v_sh[a];
        acc = warp_sum(acc);
        if (lane == 0) sc[s] = mask[(size_t)b * S + s] > 0.f ? acc : kNeg;
      }
      __syncthreads();
      if (warp == 0) {
        float m = -3.0e38f;
        for (int s = lane; s < S; s += 32) m = fmaxf(m, sc[s]);
        m = warp_max(m);
        float sum = 0.f;
        for (int s = lane; s < S; s += 32) {
          const float e = expf(sc[s] - m);
          sc[s] = e;
          sum += e;
        }
        sum = warp_sum(sum);
        for (int s = lane; s < S; s += 32) {
          const float al = sc[s] / sum;
          alpha[((size_t)t * B + b) * S + s] = al;
          sc[s] = round_io<T>(al);  // ctx weighs enc by α in the io dtype
        }
      }
      __syncthreads();
      // each thread sums kCols columns at once, so that many loads of enc
      // are in flight rather than one
      for (int c0 = threadIdx.x; c0 < C; c0 += kSeqThreads * kCols) {
        float acc[kCols];
#pragma unroll
        for (int u = 0; u < kCols; ++u) acc[u] = 0.f;
#pragma unroll 5
        for (int s = 0; s < S; ++s) {
          const T* er = enc + ((size_t)b * S + s) * C;
          const float w = sc[s];
#pragma unroll
          for (int u = 0; u < kCols; ++u)
            if (c0 + u * kSeqThreads < C) acc[u] += w * to_f<T>(er[c0 + u * kSeqThreads]);
        }
#pragma unroll
        for (int u = 0; u < kCols; ++u)
          if (c0 + u * kSeqThreads < C)
            ctx_t[(size_t)b * C + c0 + u * kSeqThreads] = from_f<T>(acc[u]);
      }
      __syncthreads();  // dp_sh and sc are the next row's
    }
    grid.sync();

    // phase C: xp for the units' three gates, u and r, and r·h
    for (int b = warp; b < B; b += kSeqWarps) {
      float xc[3 * HC], hu[2 * HC];
      warp_rows<T, 3 * HC>(ctx_t + (size_t)b * C, wxc_sh, C, xc);
      warp_rows<T, 2 * HC>(hp + (size_t)b * H, wur_sh, H, hu);
      const T* xrow = xpx + ((size_t)t * B + b) * H3;
#pragma unroll
      for (int jj = 0; jj < HC; ++jj) {
        const int j = j0 + jj;
        if (lane == jj && j < H) {
          const float xu = round_io<T>(to_f<T>(xrow[j]) + round_io<T>(xc[jj]));
          const float xr = round_io<T>(to_f<T>(xrow[H + j]) + round_io<T>(xc[HC + jj]));
          const float u = sigmoid_io<T>(round_io<T>(xu + round_io<T>(hu[jj])));
          const float r = sigmoid_io<T>(round_io<T>(xr + round_io<T>(hu[HC + jj])));
          u_sh[b * HC + jj] = u;
          xc_sh[b * HC + jj] = round_io<T>(to_f<T>(xrow[2 * H + j]) + round_io<T>(xc[2 * HC + jj]));
          rhbuf[(size_t)b * H + j] = from_f<T>(r * to_f<T>(__ldcg(hp + (size_t)b * H + j)));
        }
      }
    }
    grid.sync();

    // phase D: c from the full r·h row, the new h and the masked carry
    for (int b = warp; b < B; b += kSeqWarps) {
      float ac_[HC];
      warp_rows<T, HC>(rhbuf + (size_t)b * H, wc_sh, H, ac_);
      const float m = round_io<T>(tmask[(size_t)t * B + b]);
#pragma unroll
      for (int jj = 0; jj < HC; ++jj) {
        const int j = j0 + jj;
        if (lane == jj && j < H) {
          const float c = tanh_io<T>(round_io<T>(xc_sh[b * HC + jj] + round_io<T>(ac_[jj])));
          const float h = to_f<T>(__ldcg(hp + (size_t)b * H + j));
          const float u = u_sh[b * HC + jj];
          const float hn = round_io<T>(round_io<T>(round_io<T>(1.f - u) * h) + round_io<T>(u * c));
          const float ho =
              round_io<T>(round_io<T>(m * hn) + round_io<T>(round_io<T>(1.f - m) * h));
          h_seq[((size_t)t * B + b) * H + j] = from_f<T>(ho);
        }
      }
    }
    grid.sync();
  }
}

// ----------------------------------------------------------------- backward --
template <typename T, int HC>
__global__ void __launch_bounds__(kSeqThreads)
decoder_seq_bwd_kernel(const T* __restrict__ ep, const T* __restrict__ enc,
                       const float* __restrict__ mask, const T* __restrict__ g_seq,
                       const float* __restrict__ tmask, const T* __restrict__ hp_seq,
                       const T* __restrict__ u_seq, const T* __restrict__ r_seq,
                       const T* __restrict__ c_seq, const T* __restrict__ dp_seq,
                       const float* __restrict__ alpha, const T* __restrict__ v,
                       const T* __restrict__ w_c, const T* __restrict__ w_ur,
                       const T* __restrict__ wx_c, const T* __restrict__ wa_dec, T* dxp_seq,
                       T* dctx_seq, T* ddp_seq, T* __restrict__ dh0, T* __restrict__ dep,
                       float* dv, float* dep_acc, float* dv_part, int n_steps, int B, int S,
                       int A, int C, int H, int cc) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* dh_sh = reinterpret_cast<float*>(smem_raw);  // [B][HC] the f32 dh carry
  float* dhp_sh = dh_sh + (size_t)B * HC;             // [B][HC] dh_prev being summed
  float* du_sh = dhp_sh + (size_t)B * HC;             // [B][HC]
  float* dctx_sh = du_sh + (size_t)B * HC;            // [C] one row's io(dctx)
  float* dp_sh = dctx_sh + C;                         // [A]
  float* v_sh = dp_sh + A;                            // [A]
  float* dv_sh = v_sh + A;                            // [A] this CTA's Σ tanh·dsc
  float* ds = dv_sh + A;                              // [S] dα, then dsc
  T* wc_sh = reinterpret_cast<T*>(ds + S);            // [HC][H]: w_c's rows of the units
  T* wur_sh = wc_sh + (size_t)HC * H;                 // [HC][2H]
  T* wad_sh = wur_sh + (size_t)HC * 2 * H;            // [HC][A]
  T* wxc_sh = wad_sh + (size_t)HC * A;                // [cc][3H]: wx_c's rows c0..

  const int j0 = blockIdx.x * HC, c0 = blockIdx.x * cc;
  const int H2 = 2 * H, H3 = 3 * H;
  for (int i = threadIdx.x; i < HC * H; i += blockDim.x) {
    const int j = j0 + i / H;
    wc_sh[i] = j < H ? w_c[(size_t)j * H + i % H] : from_f<T>(0.f);
  }
  for (int i = threadIdx.x; i < HC * H2; i += blockDim.x) {
    const int j = j0 + i / H2;
    wur_sh[i] = j < H ? w_ur[(size_t)j * H2 + i % H2] : from_f<T>(0.f);
  }
  for (int i = threadIdx.x; i < HC * A; i += blockDim.x) {
    const int j = j0 + i / A;
    wad_sh[i] = j < H ? wa_dec[(size_t)j * A + i % A] : from_f<T>(0.f);
  }
  for (int i = threadIdx.x; i < cc * H3; i += blockDim.x) {
    const int c = c0 + i / H3;
    wxc_sh[i] = c < C ? wx_c[(size_t)c * H3 + i % H3] : from_f<T>(0.f);
  }
  for (int a = threadIdx.x; a < A; a += blockDim.x) {
    v_sh[a] = to_f<T>(v[a]);
    dv_sh[a] = 0.f;
  }
  for (int i = threadIdx.x; i < B * HC; i += blockDim.x) dh_sh[i] = 0.f;
  for (int b = blockIdx.x; b < B; b += gridDim.x)
    for (size_t i = threadIdx.x; i < (size_t)S * A; i += blockDim.x)
      dep_acc[(size_t)b * S * A + i] = 0.f;
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int t = n_steps - 1; t >= 0; --t) {
    const size_t tb = (size_t)t * B;
    T* dxp_t = dxp_seq + tb * H3;
    T* dctx_t = dctx_seq + tb * C;
    T* ddp_t = ddp_seq + tb * A;

    // phase 1: the cell's local terms; io(dc_pre) for every CTA
    for (int i = threadIdx.x; i < B * HC; i += blockDim.x) {
      const int b = i / HC, j = j0 + i % HC;
      if (j >= H) continue;
      const size_t row = (tb + b) * H + j;
      const float hp = to_f<T>(hp_seq[row]), u = to_f<T>(u_seq[row]), c = to_f<T>(c_seq[row]);
      const float m = tmask[tb + b];
      const float dh = dh_sh[i] + to_f<T>(g_seq[row]);
      const float dh_cell = dh * m;
      dhp_sh[i] = dh * (1.f - m) + dh_cell * (1.f - u);
      du_sh[i] = dh_cell * (c - hp);
      dxp_t[(size_t)b * H3 + H2 + j] = from_f<T>(dh_cell * u * (1.f - c * c));
    }
    grid.sync();

    // phase 2: drh = io(dc_pre) · w_cᵀ for the units; dur
    for (int b = warp; b < B; b += kSeqWarps) {
      float acc[HC];
      warp_rows<T, HC>(dxp_t + (size_t)b * H3 + H2, wc_sh, H, acc);
#pragma unroll
      for (int jj = 0; jj < HC; ++jj) {
        const int j = j0 + jj;
        if (lane == jj && j < H) {
          const int i = b * HC + jj;
          const size_t row = (tb + b) * H + j;
          const float hp = to_f<T>(hp_seq[row]), u = to_f<T>(u_seq[row]);
          const float r = to_f<T>(r_seq[row]), drh = acc[jj];
          dhp_sh[i] += drh * r;
          T* d = dxp_t + (size_t)b * H3;
          d[j] = from_f<T>(du_sh[i] * u * (1.f - u));
          d[H + j] = from_f<T>(drh * hp * r * (1.f - r));
        }
      }
    }
    grid.sync();

    // phase 3: dh_prev += io(dur) · w_urᵀ; dctx = io(dxp) · wx_cᵀ for this
    // CTA's rows of C
    for (int b = warp; b < B; b += kSeqWarps) {
      const T* d = dxp_t + (size_t)b * H3;
      float acc[HC];
      warp_rows<T, HC>(d, wur_sh, H2, acc);
#pragma unroll
      for (int jj = 0; jj < HC; ++jj)
        if (lane == jj && j0 + jj < H) dhp_sh[b * HC + jj] += acc[jj];
      for (int k0 = 0; k0 < cc; k0 += kChunk) {
        float dc[kChunk];
        warp_rows<T, kChunk>(d, wxc_sh + (size_t)k0 * H3, H3, dc);
#pragma unroll
        for (int n = 0; n < kChunk; ++n)
          if (lane == n && c0 + k0 + n < C) dctx_t[(size_t)b * C + c0 + k0 + n] = from_f<T>(dc[n]);
      }
    }
    grid.sync();

    // phase 4: the attention's backward for this CTA's batch rows, a row at
    // a time; d(enc_proj) and dv summed on
    for (int b = blockIdx.x; b < B; b += gridDim.x) {
      for (int c = threadIdx.x; c < C; c += blockDim.x)
        dctx_sh[c] = to_f<T>(__ldcg(dctx_t + (size_t)b * C + c));
      for (int a = threadIdx.x; a < A; a += blockDim.x)
        dp_sh[a] = to_f<T>(dp_seq[(tb + b) * A + a]);
      __syncthreads();
      for (int s = warp; s < S; s += kSeqWarps) {
        const T* row = enc + ((size_t)b * S + s) * C;
        float acc = 0.f;
#pragma unroll 8
        for (int c = lane; c < C; c += 32) acc += dctx_sh[c] * to_f<T>(row[c]);
        acc = warp_sum(acc);
        if (lane == 0) ds[s] = acc;
      }
      __syncthreads();
      if (warp == 0) {
        const float* al = alpha + (tb + b) * S;
        float tot = 0.f;
        for (int s = lane; s < S; s += 32) tot += al[s] * ds[s];
        tot = warp_sum(tot);
        for (int s = lane; s < S; s += 32)
          ds[s] = mask[(size_t)b * S + s] > 0.f ? al[s] * (ds[s] - tot) : 0.f;
      }
      __syncthreads();
      for (int a = threadIdx.x; a < A; a += blockDim.x) {
        const float dpa = dp_sh[a], va = v_sh[a];
        const T* col = ep + (size_t)b * S * A + a;
        float* acc_col = dep_acc + (size_t)b * S * A + a;
        float sum = 0.f, dvp = 0.f;
#pragma unroll 5
        for (int s = 0; s < S; ++s) {
          const float th = tanhf(to_f<T>(col[(size_t)s * A]) + dpa);
          const float term = ds[s] * (1.f - th * th);
          sum += term;
          acc_col[(size_t)s * A] += term * va;
          dvp += th * ds[s];
        }
        ddp_t[(size_t)b * A + a] = from_f<T>(sum * va);
        dv_sh[a] += dvp;
      }
      __syncthreads();  // dctx_sh, dp_sh and ds are the next row's
    }
    grid.sync();

    // phase 5: dh_prev += io(ddp) · wa_decᵀ, the new f32 carry
    for (int b = warp; b < B; b += kSeqWarps) {
      float acc[HC];
      warp_rows<T, HC>(ddp_t + (size_t)b * A, wad_sh, A, acc);
#pragma unroll
      for (int jj = 0; jj < HC; ++jj) {
        const int j = j0 + jj;
        if (lane == jj && j < H) {
          const int i = b * HC + jj;
          const float dh = dhp_sh[i] + acc[jj];
          dh_sh[i] = dh;
          if (t == 0) dh0[(size_t)b * H + j] = from_f<T>(dh);
        }
      }
    }
    __syncthreads();  // phase 1 reads dh_sh from other threads
  }

  for (int b = blockIdx.x; b < B; b += gridDim.x)
    for (size_t i = threadIdx.x; i < (size_t)S * A; i += blockDim.x)
      dep[(size_t)b * S * A + i] = from_f<T>(dep_acc[(size_t)b * S * A + i]);
  for (int a = threadIdx.x; a < A; a += blockDim.x) dv_part[(size_t)blockIdx.x * A + a] = dv_sh[a];
  grid.sync();
  if (blockIdx.x == 0) {
    for (int a = threadIdx.x; a < A; a += blockDim.x) {
      float sum = 0.f;
      for (int k = 0; k < (int)gridDim.x; ++k) sum += __ldcg(dv_part + (size_t)k * A + a);
      dv[a] = sum;
    }
  }
}

// ----------------------------------------------------------------- launches --
template <typename Kernel>
cudaError_t coop_launch(Kernel kernel, int grid, size_t smem, void** args, int n_sms,
                        cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kSeqThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm * n_sms < grid) return cudaErrorCooperativeLaunchTooLarge;
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                                    dim3(kSeqThreads), args, smem, st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

struct Dims {
  int steps, B, S, A, C, H;
};

template <typename T, int HC>
cudaError_t fwd(void* const* p, const Dims& d, int n_sms, size_t smem_max, cudaStream_t st) {
  const int grid = (d.H + HC - 1) / HC, ac = round4((d.A + grid - 1) / grid);
  const size_t smem = fwd_smem(d.B, d.S, d.A, d.C, d.H, HC, ac, sizeof(T));
  if (smem > smem_max) return cudaErrorInvalidValue;
  const T *ep = static_cast<const T*>(p[0]), *enc = static_cast<const T*>(p[1]);
  const float* mask = static_cast<const float*>(p[2]);
  const T* xpx = static_cast<const T*>(p[3]);
  const float* tmask = static_cast<const float*>(p[4]);
  const T *h0 = static_cast<const T*>(p[5]), *wa_dec = static_cast<const T*>(p[6]);
  const T *v = static_cast<const T*>(p[7]), *wx_c = static_cast<const T*>(p[8]);
  const T *w_ur = static_cast<const T*>(p[9]), *w_c = static_cast<const T*>(p[10]);
  T* h_seq = static_cast<T*>(p[11]);
  float* alpha = static_cast<float*>(p[12]);
  T* ctx = static_cast<T*>(p[13]);
  float* dpbuf = static_cast<float*>(p[14]);
  T* rhbuf = static_cast<T*>(p[15]);
  int T_ = d.steps, B = d.B, S = d.S, A = d.A, C = d.C, H = d.H, ac_ = ac;
  void* args[] = {&ep, &enc, &mask, &xpx, &tmask, &h0, &wa_dec, &v, &wx_c, &w_ur, &w_c,
                  &h_seq, &alpha, &ctx, &dpbuf, &rhbuf, &T_, &B, &S, &A, &C, &H, &ac_};
  return coop_launch(decoder_seq_fwd_kernel<T, HC>, grid, smem, args, n_sms, st);
}

template <typename T, int HC>
cudaError_t bwd(void* const* p, const Dims& d, int n_sms, size_t smem_max, cudaStream_t st) {
  const int grid = (d.H + HC - 1) / HC, cc = round4((d.C + grid - 1) / grid);
  const size_t smem = bwd_smem(d.B, d.S, d.A, d.C, d.H, HC, cc, sizeof(T));
  if (smem > smem_max) return cudaErrorInvalidValue;
  const T *ep = static_cast<const T*>(p[0]), *enc = static_cast<const T*>(p[1]);
  const float* mask = static_cast<const float*>(p[2]);
  const T* g = static_cast<const T*>(p[3]);
  const float* tmask = static_cast<const float*>(p[4]);
  const T *hp = static_cast<const T*>(p[5]), *u = static_cast<const T*>(p[6]);
  const T *r = static_cast<const T*>(p[7]), *c = static_cast<const T*>(p[8]);
  const T* dp = static_cast<const T*>(p[9]);
  const float* alpha = static_cast<const float*>(p[10]);
  const T *v = static_cast<const T*>(p[11]), *w_c = static_cast<const T*>(p[12]);
  const T *w_ur = static_cast<const T*>(p[13]), *wx_c = static_cast<const T*>(p[14]);
  const T* wa_dec = static_cast<const T*>(p[15]);
  T *dxp = static_cast<T*>(p[16]), *dctx = static_cast<T*>(p[17]);
  T *ddp = static_cast<T*>(p[18]), *dh0 = static_cast<T*>(p[19]);
  T* dep = static_cast<T*>(p[20]);
  float *dv = static_cast<float*>(p[21]), *dep_acc = static_cast<float*>(p[22]);
  float* dv_part = static_cast<float*>(p[23]);
  int T_ = d.steps, B = d.B, S = d.S, A = d.A, C = d.C, H = d.H, cc_ = cc;
  void* args[] = {&ep, &enc, &mask, &g, &tmask, &hp, &u, &r, &c, &dp, &alpha, &v, &w_c,
                  &w_ur, &wx_c, &wa_dec, &dxp, &dctx, &ddp, &dh0, &dep, &dv, &dep_acc,
                  &dv_part, &T_, &B, &S, &A, &C, &H, &cc_};
  return coop_launch(decoder_seq_bwd_kernel<T, HC>, grid, smem, args, n_sms, st);
}

template <typename T, bool kFwd>
cudaError_t dispatch(int hc, void* const* p, const Dims& d, int n_sms, size_t smem_max,
                     cudaStream_t st) {
  switch (hc) {
#define PTT_CASE(N) \
  case N: return kFwd ? fwd<T, N>(p, d, n_sms, smem_max, st) : bwd<T, N>(p, d, n_sms, smem_max, st);
    PTT_CASE(1) PTT_CASE(2) PTT_CASE(4) PTT_CASE(8) PTT_CASE(16)
#undef PTT_CASE
    default: return cudaErrorInvalidValue;
  }
}

template <bool kFwd>
int launch(int io_bf16, void* const* p, int n_steps, int B, int S, int A, int C, int H,
           void* stream) {
  if (n_steps < 1 || B < 1 || S < 1 || A < 1 || C < 1 || H < 1) return cudaErrorInvalidValue;
  int n_sms = 0, smem_max = 0;
  const cudaError_t err = coop_device(&n_sms, &smem_max);
  if (err != cudaSuccess) return err;
  const int hc = units_per_cta(H, n_sms);
  if (hc == 0) return cudaErrorInvalidValue;
  const Dims d{n_steps, B, S, A, C, H};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (io_bf16) return dispatch<__nv_bfloat16, kFwd>(hc, p, d, n_sms, smem_max, st);
  return dispatch<float, kFwd>(hc, p, d, n_sms, smem_max, st);
}

}  // namespace

// p: ep [B,S,A], enc [B,S,C], mask [B,S] f32, xpx [T,B,3H], tmask [T,B] f32,
// h0 [B,H], wa_dec [H,A], v [A], wx_c [C,3H], w_ur [H,2H], w_c [H,H]; out
// h_seq [T,B,H], alpha [T,B,S] f32, ctx [T,B,C]; scratch dpbuf [B,A] f32,
// rhbuf [B,H]. io dtype bf16 when io_bf16, else f32; all contiguous.
// Returns a cudaError_t: cudaErrorInvalidValue where the shape is out of
// the kernel's range (H past 16 units a CTA, or shared memory past the
// card's).
extern "C" int decoder_seq_fwd_launch(int io_bf16, void* const* p, int n_steps, int B, int S,
                                      int A, int C, int H, void* stream) {
  return launch<true>(io_bf16, p, n_steps, B, S, A, C, H, stream);
}

// p: ep, enc, mask, g_seq [T,B,H], tmask, hp_seq, u_seq, r_seq, c_seq
// [T,B,H], dp_seq [T,B,A], alpha [T,B,S] f32, v, w_c, w_ur, wx_c, wa_dec;
// out dxp [T,B,3H], dctx [T,B,C], ddp [T,B,A], dh0 [B,H], dep [B,S,A], dv
// [A] f32; scratch dep_acc [B,S,A] f32 and dv_part [ceil(H/hc),A] f32
// (decoder_seq_ctas rows).
extern "C" int decoder_seq_bwd_launch(int io_bf16, void* const* p, int n_steps, int B, int S,
                                      int A, int C, int H, void* stream) {
  return launch<false>(io_bf16, p, n_steps, B, S, A, C, H, stream);
}

// The CTAs a launch at this H takes on the current device (dv_part's rows);
// 0 where H is out of range.
extern "C" int decoder_seq_ctas(int H) {
  int n_sms = 0, smem_max = 0;
  if (coop_device(&n_sms, &smem_max) != cudaSuccess) return 0;
  const int hc = units_per_cta(H, n_sms);
  return hc ? (H + hc - 1) / hc : 0;
}

extern "C" const char* decoder_seq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
