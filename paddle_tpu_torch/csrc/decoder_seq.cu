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
// CTAs meet at a barrier four times a step:
//   forward   after dp, after ctx, after u/r (r·h), after h;
//   backward  after [du | dc], after dr, after dctx, after ddp.
// The bytes (ep and enc read once a step from L2, about 39 MB at B=256,
// S=50, A=512, C=1024 in bf16) and the operations are far below what the
// card does in that time.
//
// The backward in bf16, the slice's dtype, runs on the tensor cores on
// csrc/gru_bwd.cu's partition, with the attention added:
// - The grid is unit groups x batch groups. A CTA owns 16 hidden units and
//   the batch rows of one group (32-row sub-tiles; a group takes several
//   where the card cannot hold a CTA for each: 2 at B=256, H=512), and a
//   slice of cs columns of C (C / 32 = 32 at bench widths). A cooperative
//   launch keeps every CTA resident; a release/acquire counter a batch
//   group replaces the grid barrier (a counter that never fills traps).
//   Its weights stay in shared memory for the whole walk: its units' rows
//   of [w_u | w_r | w_c] and of wa_dec, and its slice's rows of wx_c, each
//   K-contiguous and padded as the exchanges are (48 + 16 + 96 KB at bench
//   widths), or are read through L1 where they do not fit.
// - Warps 0-3 own the (row, unit) pairs as mma.sync's accumulator lanes;
//   warps 4-7 compute beside them. Per step, newest first:
//   (A) the owners' gate math from local values (the f32 dh carry, the
//       step's g, u, r, c, h_prev, loaded before the barriers): du and dc
//       published rounded into the exchange [B, 3·Hp] (du at 0, dr at Hp,
//       dc at 2·Hp, the padding zero) and written to dxp. Barrier.
//   (B) the owners take drh = io(dc)·w_cᵀ, then dr, published rounded;
//       warps 4-7 take io(du)·w_uᵀ, the du part of dur·w_urᵀ. Barrier.
//   (C) the owners carry dur·w_urᵀ on over dr·w_rᵀ and add it to dh_prev;
//       every warp takes its n-tiles of dctx = io(dxp)·wx_cᵀ for the CTA's
//       slice of C, published rounded into the dctx output. Barrier.
//   (D) the attention's backward for the group's rows the CTA takes (row i
//       of the group to its CTA i mod 32): dα = enc·io(dctx) over the row's
//       [S, C], dsc (written to a [T, B, S] f32 buffer), and ddp = io(Σ_S
//       dsc·(1-t²)·v) over its [S, A] of ep, published into a padded
//       exchange and the ddp output. Barrier.
//   (E) the owners' dh = dh_prev + io(ddp)·wa_decᵀ, the new f32 carry. The
//       next step's (A) is local, so (E) needs no barrier after it.
//   Every product's left operand is rounded where decoder_seq_bwd_plain
//   rounds it, and each k16 product goes into a fresh fragment, added in
//   f32 in k order (the tensor core's own accumulation truncates); the
//   exchanged rows are staged with cp.async.cg (past L1, which is not
//   coherent across SMs) in chunks of 64 columns of two slots in (B) and
//   128 of one in (C) and (E), a ring of three chunks; a chunk's fragments
//   are loaded, then its products issued back to back, then added in k
//   order. The exchanges are double-buffered by step parity.
// - d(enc_proj) and dv are off the recurrence (they feed nothing in the
//   carry): after the walk, csrc/bahdanau_attn.cu's attn_dep_kernel (B7's
//   kernel, newest step first) sums each dep[b,s,a] over t with the plain
//   version's term (dsc·(1-th²))·v and one rounding, skipping the terms
//   with dsc = 0, and dv[a] in a fixed order: each element written once,
//   the same bits on every run; no [B,S,A] buffer is read and written a
//   step.
// What still holds it back: the chain of each phase (the barrier's round
// trip through L2, the staged rows, the products, the attention's reads
// of enc and ep, the stores before the next release), four phases with a
// barrier a step.
//
// The forward in bf16 runs on the same partition (decoder_seq_fwd_tc_kernel):
// - The grid is unit groups x batch groups, placed by the backward's plan
//   search on the forward's own shared memory (`fwd_plan`). A CTA owns 16
//   hidden units, its group's 32-row sub-tiles and a slice of `as` columns
//   of A for dp (A over the unit groups, rounded up to a whole n-tile: 16
//   at bench widths). Its weights stay in shared memory for the whole walk:
//   its units' 48 columns of [w_u | w_r | w_c] and of wx_c, and its slice's
//   columns of wa_dec, each K-contiguous and padded by 16 bytes (49 + 97 +
//   16 KB at bench widths), or are read through L1 where they do not fit.
// - Four phases a step, each ending at its batch group's counter barrier:
//   (1) stage h(t-1); dp for the slice (warps 4-7), f32 and not rounded,
//       into an exchange [B, n_ug·as]; io(h·w_u) and io(h·w_r) of the
//       owners' pairs (warps 0-3), kept.
//   (2) the attention of the group's rows dealt to the CTAs (row i of the
//       group to CTA i mod n_ug), by csrc/attn_row.cuh's routine on the
//       row's dp read past L1: S streamed through the products' ring (and
//       whatever shared memory is left where a CTA has an SM to itself);
//       alpha, and ctx into its output and a padded exchange [B, Cp].
//   (3) stage ctx; io(ctx·wx_c) for the units' 48 columns, xp = io(xpx_t +
//       ·); u and r (owners) by sigmoid_io, io(r·h) published into an
//       exchange; the candidate part of xp (warps 4-7), kept.
//   (4) stage r·h; c = tanh_io(io(xp_c + io(rh·w_c))), h' and the masked
//       carry (owners), rounded where decoder_seq_fwd_plain rounds; h_seq[t]
//       and the h exchange (double-buffered by step parity) written.
//   Every product is mma.sync m16n8k16 on rows staged with cp.async.cg
//   through the backward's ring, each k16 product a fresh fragment added in
//   f32 in k order. No float atomics: the same bits on every run. A second
//   instance (kTimed) records each phase's end by the SM's clock for
//   attention_kernels.decoder_seq_fwd_phase_us; the executor never launches
//   it.
// - attention_kernels.seq_fwd_route sends a shape the plan cannot place (a
//   slice of A past 64 columns, C past the row routine's 8192, rows the ring
//   cannot stage, more unit groups than the card holds) to the first design
//   below, before any launch.
//
// The forward in f32, and the backward in f32, keep the first design: each CTA
// owns HC hidden units and keeps the weights those units need in shared
// memory for the whole launch, so they are read from device memory once:
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
// The f32 backward's d(enc_proj) [B,S,A] does not fit on chip (26 MB in
// f32 at bench widths): each batch row's owner adds its step's term to an
// f32 global buffer in a fixed order (t newest first) and rounds it once at
// the end. dv is summed per CTA in shared memory and the CTAs' partials
// summed in CTA order by one CTA after a last barrier: no float atomics,
// the same bits on every run.
//
// Shared memory (bytes) of the first design, at the launch's HC units, AC =
// ceil(A / CTAs) and CC = ceil(C / CTAs) each rounded up to 4, item the io
// dtype's size:
//   forward   (AC·H + 3·HC·C + 3·HC·H)·item + (2·B·HC + 2·A + S)·4
//   backward  (HC·(3·H + A) + CC·3·H)·item + (3·B·HC + C + 3·A + S)·4
// 53 KB and 64 KB at bench widths in bf16, 94 KB and 104 KB in f32; a shape
// past the card's 227 KB is refused. Registers: 512 threads a CTA leave each
// at most 128; the products keep 5·HC f32 sums a thread (20 at HC = 4).
// Simple first: f32 FMAs on CUDA cores, one warp per batch row with the
// lanes splitting the reduction, 16 warps a CTA, four grid barriers a step.

#include <cooperative_groups.h>

#include "attn_row.cuh"
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

// ---------------------------------------------- bf16 backward on tensor cores --
// decoder_seq_bwd_tc_kernel and the post-walk d(enc_proj)/dv pass; see the
// note at the top of the file.
namespace tcb {

using bf16 = __nv_bfloat16;

constexpr int kUnits = 16;              // hidden units a CTA owns (lstm_kernels.UNITS_PER_CTA)
constexpr int kRows = 32;               // batch rows of a sub-tile (ROWS_PER_TILE)
constexpr int kPairs = kRows * kUnits;  // (row, unit) pairs of a sub-tile: four an owner lane
constexpr int kKc = 64;                 // k of a staged chunk of two slots
constexpr int kKcWide = 2 * kKc;        // k of a staged chunk of one slot
constexpr int kStages = 3;              // chunks in the ring
constexpr int kLdg = kKc + 8;           // a staged row, padded by 16 bytes against bank conflicts
constexpr int kSlot = kRows * kLdg;     // one slot's rows of a chunk
constexpr int kStage = 2 * kSlot;       // a chunk: two slots, or one wide slot
static_assert(kRows * (kKcWide + 8) <= kStage, "a wide chunk fits a stage");
constexpr size_t kRingBytes = (size_t)kStages * kStage * sizeof(bf16);
// a sub-tile's state, one float a pair each: the f32 dh carry, r, h_prev,
// dh_prev's running sum, and the dur·w_urᵀ product so far
constexpr int kFields = 5;
constexpr size_t kStateBytes = (size_t)kFields * kPairs * sizeof(float);
constexpr int kCtxTiles = 4;                    // dctx n-tiles a warp at most
constexpr int kMaxSlice = 4 * kCtxTiles * 8;    // columns of C a CTA at most
constexpr long long kSpinCycles = 20000000000LL;  // about 10 s: a barrier that never fills traps

struct Args {
  const bf16 *ep, *enc;         // [B,S,A], [B,S,C]
  const float* mask;            // [B,S]
  const bf16* g;                // [T,B,H]
  const float* tmask;           // [T,B]
  const bf16 *hp, *u, *r, *c;   // [T,B,H]
  const bf16* dp;               // [T,B,A]
  const float* alpha;           // [T,B,S]
  const bf16* v;                // [A]
  const bf16 *wu, *wad, *wxc;   // [Hp,3Hp], [Hp,Ap], [n_ug·cs,3Hp], padded
  bf16 *dxp, *dctx, *ddp, *dh0;  // [T,B,3H], [T,B,C], [T,B,A], [B,H]
  float* dsc;                   // [T,B,S]
  bf16 *ex, *dex;               // [2,B,3Hp], [2,B,Ap], zeroed
  unsigned* bar;                // [groups], zeroed
  int T, B, S, A, C, H, Hp, Ap, cs, n_tiles, tiles_per_group;
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline size_t round16(size_t n) { return (n + 15) / 16 * 16; }

// the attention's scratch: one row's io(dctx) [C], dp [A], v [A] and dsc [S], f32
__host__ __device__ inline size_t scratch_bytes(int S, int A, int C) {
  return round16((size_t)(C + 2 * A + S) * sizeof(float));
}

// the CTA's weights in shared memory: its 16 units' rows of [w_u | w_r | w_c]
// and of wa_dec, and its cs rows of wx_c, each row padded by 16 bytes
__host__ __device__ inline size_t w_bytes(int Hp, int Ap, int cs) {
  return ((size_t)(kUnits + cs) * (3 * Hp + 8) + (size_t)kUnits * (Ap + 8)) * sizeof(bf16);
}

inline size_t tc_smem(int tiles_per_group, int S, int A, int C, int Hp, int Ap, int cs,
                      bool w_smem) {
  return kRingBytes + (size_t)tiles_per_group * kStateBytes + scratch_bytes(S, A, C) +
         (w_smem ? w_bytes(Hp, Ap, cs) : 0);
}

// An owner lane's four pairs' inputs to a step's (A), which do not depend
// on the carry: kept raw until used, so the loads stay in flight. Pair e is
// row g + 8·(e>>1), unit 2q + (e&1) of the warp's tile.
struct Pre {
  bf16 u[4], r[4], c[4], hp[4], g[4];
  float m[2];
};

__device__ __forceinline__ void prefetch(Pre& p, const Args& a, int s, int b0, int j0) {
  const int t = a.T - 1 - s;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int b = b0 + 8 * rr;
    if (b >= a.B) continue;
    const size_t row = (size_t)t * a.B + b;
    p.m[rr] = a.tmask[row];
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int e = 2 * rr + cc, j = j0 + cc;
      if (j >= a.H) continue;
      const size_t i = row * a.H + j;
      p.u[e] = a.u[i];
      p.r[e] = a.r[i];
      p.c[e] = a.c[i];
      p.hp[e] = a.hp[i];
      p.g[e] = a.g[i];
    }
  }
}

// The tensor-core kernels' shared pieces (the backward's and the bf16
// forward's).

// rows x cols (a multiple of 8) from src, rows cols apart, into dst, rows
// cols + 8 apart (16 bytes of padding against bank conflicts)
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src, int rows, int cols) {
  const int pieces = cols / 8;
  for (int i = threadIdx.x; i < rows * pieces; i += kThreads) {
    const int n = i / pieces, pc = i - n * pieces;
    *reinterpret_cast<uint4*>(dst + (size_t)n * (cols + 8) + pc * 8) =
        *reinterpret_cast<const uint4*>(src + (size_t)n * cols + pc * 8);
  }
}

// The k-th barrier of the launch among the CTAs of one batch group (a
// counter in global memory; one that never fills traps).
__device__ __forceinline__ void group_barrier(unsigned* bar, unsigned k) {
  __syncthreads();
  if (threadIdx.x == 0) {  // release covers the CTA's writes before the __syncthreads
    atomic_add_release(bar, 1u);
    const unsigned target = k * gridDim.x;
    const long long start = clock64();
    while (load_acquire(bar) < target)
      if (clock64() - start > kSpinCycles) __trap();
  }
  __syncthreads();
}

// Stages rows [r0, r0 + kRows) of src0 (and of src1 where it is not null)
// into the ring, rows ld apart, over k in [0, klen) in chunks of kKc (two
// slots) or kKcWide (one), kStages - 1 chunks in flight, and calls body(its
// first k, slot0, slot1, its k, the slots' row pitch) after each landed for
// every thread, slot0 and slot1 at the warp's m-tile mt. Rows past B read
// as zeros; k past klen is not staged (klen is a multiple of 16, and body
// reads below it only). No copy is in flight when it returns.
template <class Body>
__device__ __forceinline__ void walk(bf16* ring, const bf16* src0, const bf16* src1, int ld, int r0,
                                     int B, int klen, int mt, Body&& body) {
  const int tid = threadIdx.x;
  const int kcw = src1 ? kKc : kKcWide, ldg = kcw + 8, pieces = kcw / 8;
  const int nkc = cdiv(klen, kcw);
  auto stage = [&](int ch) {
    if (ch < nkc) {
      bf16* st = ring + (size_t)(ch % kStages) * kStage;
      for (int i = tid; i < kRows * pieces; i += kThreads) {
        const int row = i / pieces, pc = i - row * pieces;
        const int kc = ch * kcw + pc * 8, b = r0 + row;
        if (kc >= klen) continue;
        const bool ok = b < B;
        bf16* dst = st + row * ldg + pc * 8;
        cp_async16(dst, ok ? src0 + (size_t)b * ld + kc : src0, ok ? 16 : 0);
        if (src1) cp_async16(dst + kSlot, ok ? src1 + (size_t)b * ld + kc : src1, ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };
  __syncthreads();  // every warp is done with the ring's last chunks
#pragma unroll
  for (int ch = 0; ch < kStages - 1; ++ch) stage(ch);
  for (int ch = 0; ch < nkc; ++ch) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk ch landed for every thread; chunk ch-1's buffers are free
    stage(ch + kStages - 1);
    const bf16* s0 = ring + (size_t)(ch % kStages) * kStage + mt * 16 * ldg;
    body(ch * kcw, s0, s0 + kSlot, min(kcw, klen - ch * kcw), ldg);
  }
}

// The chunk's A fragments of the warp's 16 staged rows (kn columns from
// rows, row pitch ldg), loaded before any product uses them.
constexpr int kPieces = kKcWide / 16;  // k16 pieces of a chunk at most
__device__ __forceinline__ void load_frags(uint32_t (&fa)[kPieces][4], const bf16* rows, int ldg,
                                           int kn) {
#pragma unroll
  for (int j = 0; j < kPieces; ++j)
    if (16 * j < kn) ldmatrix_x4(fa[j], rows + 16 * j, ldg);
}

// acc[e] += the chunk's product with the column row `w` at k0.., over the
// k16 pieces j where use(j): each piece's product a fragment of its own,
// issued back to back, then added in k order in f32 (the tensor core's
// own accumulation truncates)
template <class Use>
__device__ __forceinline__ void k16_sum(float (&acc)[4], const uint32_t (&fa)[kPieces][4],
                                        const bf16* w, int k0, int kn, Use&& use) {
  const int q = threadIdx.x & 3;
  float p[kPieces][4];
#pragma unroll
  for (int j = 0; j < kPieces; ++j) {
    p[j][0] = p[j][1] = p[j][2] = p[j][3] = 0.f;
    if (16 * j < kn && use(j)) {
      const bf16* wk = w + k0 + 16 * j + 2 * q;
      mma_bf16(p[j], fa[j][0], fa[j][1], fa[j][2], fa[j][3],
               *reinterpret_cast<const uint32_t*>(wk), *reinterpret_cast<const uint32_t*>(wk + 8));
    }
  }
#pragma unroll
  for (int j = 0; j < kPieces; ++j)
    if (16 * j < kn && use(j))
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[e] += p[j][e];
}

struct Every {
  __device__ bool operator()(int) const { return true; }
};

// grid (Hp / kUnits unit groups, batch groups). Warp w computes m-tile w&1;
// warps 0-3 own the (row, unit) pairs of units 8·(w>>1) .. +7, warps 4-7
// compute the du part of the same pairs' carry beside them; in (C) warp w
// also takes dctx n-tiles (w>>1) + 4i of the CTA's slice of C.
template <bool kWSmem>
__global__ void __launch_bounds__(kThreads, 1) decoder_seq_bwd_tc_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tpg = a.tiles_per_group;
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);                  // [kStages][kStage]
  float* state = reinterpret_cast<float*>(smem_raw + kRingBytes);  // [tiles][kFields][kPairs]
  float* dct = state + (size_t)tpg * kFields * kPairs;             // [C]
  float* dps = dct + a.C;                                          // [A]
  float* vs = dps + a.A;                                           // [A]
  float* ds = vs + a.A;                                            // [S]
  bf16* wsh = reinterpret_cast<bf16*>(smem_raw + kRingBytes + (size_t)tpg * kStateBytes +
                                      scratch_bytes(a.S, a.A, a.C));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mt = warp & 1, nt = (warp >> 1) & 1, cg_ = warp >> 1, g = lane >> 2, q = lane & 3;
  const bool owner = warp < 4;
  const int Hp = a.Hp, K3 = 3 * Hp, Ap = a.Ap, B = a.B, H = a.H;
  const int ldu = kWSmem ? K3 + 8 : K3, ldd = kWSmem ? Ap + 8 : Ap;
  const int j0 = blockIdx.x * kUnits, c0 = blockIdx.x * a.cs;
  const bf16* wu_src = a.wu + (size_t)j0 * K3;
  const bf16* wad_src = a.wad + (size_t)j0 * Ap;
  const bf16* wxc_src = a.wxc + (size_t)c0 * K3;
  bf16* wu_sh = wsh;                                  // [kUnits][K3 + 8]
  bf16* wad_sh = wu_sh + (size_t)kUnits * (K3 + 8);   // [kUnits][Ap + 8]
  bf16* wxc_sh = wad_sh + (size_t)kUnits * (Ap + 8);  // [cs][K3 + 8]
  if (kWSmem) {
    copy_rows(wu_sh, wu_src, kUnits, K3);
    copy_rows(wad_sh, wad_src, kUnits, Ap);
    copy_rows(wxc_sh, wxc_src, a.cs, K3);
  }
  // the B columns this lane loads: unit nt·8 + g of the group, for the
  // carry's products; row 8·n-tile + g of the C slice for dctx
  const bf16* urow = (kWSmem ? wu_sh : wu_src) + (size_t)(nt * 8 + g) * ldu;
  const bf16* drow = (kWSmem ? wad_sh : wad_src) + (size_t)(nt * 8 + g) * ldd;
  const bf16* xbase = kWSmem ? wxc_sh : wxc_src;
  for (int i = tid; i < a.A; i += kThreads) vs[i] = to_f<bf16>(a.v[i]);
  const int tile0 = blockIdx.y * tpg;
  const int n_mine = min(a.n_tiles, tile0 + tpg) - tile0;
  unsigned* bar = a.bar + blockIdx.y;
  const int ul = nt * 8 + 2 * q;                // the lane's first unit in the group
  auto pair = [&](int e) { return (mt * 16 + g + 8 * (e >> 1)) * kUnits + ul + (e & 1); };

  for (int i = tid; i < tpg * kFields * kPairs; i += kThreads) state[i] = 0.f;
  __syncthreads();  // the state is zero before any owner writes its pairs' fields
  Pre pre;
  if (owner) prefetch(pre, a, 0, tile0 * kRows + mt * 16 + g, j0 + ul);

  const Every every{};

  for (int s = 0; s < a.T; ++s) {
    const int t = a.T - 1 - s;
    const size_t tb = (size_t)t * B;
    bf16* exs = a.ex + (size_t)(s & 1) * B * K3;  // this step's [du | dr | dc] exchange
    bf16* dexs = a.dex + (size_t)(s & 1) * B * Ap;  // and its ddp exchange

    // (A) the owners' gate math, from local values; du and dc published
    for (int tl = 0; tl < n_mine && owner; ++tl) {
      float* st = state + (size_t)tl * kFields * kPairs;
      const int r0 = (tile0 + tl) * kRows;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int b = r0 + mt * 16 + g + 8 * (e >> 1), j = j0 + ul + (e & 1);
        if (b >= B || j >= H) continue;
        const int p = pair(e);
        const float u = to_f<bf16>(pre.u[e]), r = to_f<bf16>(pre.r[e]);
        const float c = to_f<bf16>(pre.c[e]), hp = to_f<bf16>(pre.hp[e]), m = pre.m[e >> 1];
        const float dh = add(st[p], to_f<bf16>(pre.g[e]));
        const float dh_cell = mul(dh, m);
        const float run = add(mul(dh, sub(1.f, m)), mul(dh_cell, sub(1.f, u)));
        const float du = mul(dh_cell, sub(c, hp));
        const float dpc = mul(mul(dh_cell, u), sub(1.f, mul(c, c)));
        const bf16 duq = from_f<bf16>(mul(mul(du, u), sub(1.f, u)));
        const bf16 dcq = from_f<bf16>(dpc);
        bf16* dxr = a.dxp + (tb + b) * 3 * H + j;
        dxr[0] = duq;
        dxr[2 * H] = dcq;
        bf16* er = exs + (size_t)b * K3 + j;
        er[0] = duq;
        er[2 * Hp] = dcq;
        st[kPairs + p] = r;
        st[2 * kPairs + p] = hp;
        st[3 * kPairs + p] = run;
      }
      // the next (A)'s inputs: the next sub-tile's, or the next step's
      const int tl1 = tl + 1 < n_mine ? tl + 1 : 0, s1 = tl + 1 < n_mine ? s : s + 1;
      if (s1 < a.T) prefetch(pre, a, s1, (tile0 + tl1) * kRows + mt * 16 + g, j0 + ul);
    }
    group_barrier(bar, 4 * s + 1);

    // (B) drh = dc·w_cᵀ (owners) and the du part of dur·w_urᵀ (warps 4-7)
    for (int tl = 0; tl < n_mine; ++tl) {
      float* st = state + (size_t)tl * kFields * kPairs;
      const int r0 = (tile0 + tl) * kRows;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      walk(ring, exs + 2 * Hp, exs, K3, r0, B, Hp, mt,
           [&](int k0, const bf16* s0, const bf16* s1, int kn, int ldg) {
             uint32_t fa[kPieces][4];
             load_frags(fa, owner ? s0 : s1, ldg, kn);
             k16_sum(acc, fa, urow, owner ? 2 * Hp + k0 : k0, kn, every);
           });
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int b = r0 + mt * 16 + g + 8 * (e >> 1), j = j0 + ul + (e & 1);
        const int p = pair(e);
        if (!owner) {
          st[4 * kPairs + p] = acc[e];
          continue;
        }
        if (b >= B || j >= H) continue;
        const float drh = acc[e], r = st[kPairs + p], hp = st[2 * kPairs + p];
        const bf16 drq = from_f<bf16>(mul(mul(mul(drh, hp), r), sub(1.f, r)));
        a.dxp[(tb + b) * 3 * H + H + j] = drq;
        exs[(size_t)b * K3 + Hp + j] = drq;
        st[3 * kPairs + p] = add(st[3 * kPairs + p], mul(drh, r));
      }
    }
    group_barrier(bar, 4 * s + 2);

    // (C) the dr part of dur·w_urᵀ, carried on from the du part (owners),
    // and dctx = dxp·wx_cᵀ for the CTA's slice of C (every warp)
    for (int tl = 0; tl < n_mine; ++tl) {
      float* st = state + (size_t)tl * kFields * kPairs;
      const int r0 = (tile0 + tl) * kRows;
      float urp[4], cacc[kCtxTiles][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) urp[e] = owner ? st[4 * kPairs + pair(e)] : 0.f;
#pragma unroll
      for (int i = 0; i < kCtxTiles; ++i) cacc[i][0] = cacc[i][1] = cacc[i][2] = cacc[i][3] = 0.f;
      walk(ring, exs, nullptr, K3, r0, B, K3, mt,
           [&](int k0, const bf16* s0, const bf16*, int kn, int ldg) {
        uint32_t fa[kPieces][4];
        load_frags(fa, s0, ldg, kn);
#pragma unroll
        for (int i = 0; i < kCtxTiles; ++i) {
          const int n8 = 8 * (cg_ + 4 * i);
          if (n8 >= a.cs) break;
          k16_sum(cacc[i], fa, xbase + (size_t)(n8 + g) * ldu, k0, kn, every);
        }
        if (owner)  // the dr part: the pieces in [Hp, 2·Hp)
          k16_sum(urp, fa, urow, k0, kn,
                  [&](int j) { return k0 + 16 * j >= Hp && k0 + 16 * j < 2 * Hp; });
      });
      if (owner)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = pair(e);
          st[3 * kPairs + p] = add(st[3 * kPairs + p], urp[e]);  // dh_prev
        }
#pragma unroll
      for (int i = 0; i < kCtxTiles; ++i) {
        const int n8 = 8 * (cg_ + 4 * i);
        if (n8 >= a.cs) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int b = r0 + mt * 16 + frag_row(e), col = c0 + n8 + frag_col(0, e);
          if (b < B && col < a.C) a.dctx[(tb + b) * a.C + col] = from_f<bf16>(cacc[i][e]);
        }
      }
    }
    group_barrier(bar, 4 * s + 3);

    // (D) the attention's backward for the group's rows this CTA takes
    // (row i of the group goes to the group's CTA i mod gridDim.x):
    // dα = enc·io(dctx), dsc, and ddp = io(Σ_S dsc·(1-t²)·v)
    for (int li = blockIdx.x; li < n_mine * kRows; li += gridDim.x) {
      const int b = tile0 * kRows + li;
      if (b >= B) break;
      const size_t row = tb + b;
      for (int i = tid; i < a.C; i += kThreads) dct[i] = to_f<bf16>(__ldcg(a.dctx + row * a.C + i));
      for (int i = tid; i < a.A; i += kThreads) dps[i] = to_f<bf16>(a.dp[row * a.A + i]);
      __syncthreads();
      // two source positions a warp at once, the lanes over C: more loads
      // of enc in flight
      const bool vec = (a.C & 7) == 0 && (reinterpret_cast<uintptr_t>(a.enc) & 15) == 0;
      for (int s0 = warp; s0 < a.S; s0 += 2 * kWarps) {
        const bool two = s0 + kWarps < a.S;
        const bf16* e0 = a.enc + ((size_t)b * a.S + s0) * a.C;
        const bf16* e1 = two ? e0 + (size_t)kWarps * a.C : e0;
        float acc0 = 0.f, acc1 = 0.f;
        if (vec) {
#pragma unroll 4
          for (int i = 8 * lane; i < a.C; i += 256) {
            const uint4 r0 = *reinterpret_cast<const uint4*>(e0 + i);
            const uint4 r1 = *reinterpret_cast<const uint4*>(e1 + i);
            const bf16* x0 = reinterpret_cast<const bf16*>(&r0);
            const bf16* x1 = reinterpret_cast<const bf16*>(&r1);
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              acc0 += to_f<bf16>(x0[k]) * dct[i + k];
              acc1 += to_f<bf16>(x1[k]) * dct[i + k];
            }
          }
        } else {
#pragma unroll 4
          for (int i = lane; i < a.C; i += 32) {
            acc0 += to_f<bf16>(e0[i]) * dct[i];
            acc1 += to_f<bf16>(e1[i]) * dct[i];
          }
        }
        acc0 = warp_sum(acc0);
        acc1 = warp_sum(acc1);
        if (lane == 0) {
          ds[s0] = acc0;
          if (two) ds[s0 + kWarps] = acc1;
        }
      }
      __syncthreads();
      if (warp == 0) {
        const float* al = a.alpha + row * a.S;
        float tot = 0.f;
        for (int sp = lane; sp < a.S; sp += 32) tot += al[sp] * ds[sp];
        tot = warp_sum(tot);
        for (int sp = lane; sp < a.S; sp += 32) {
          const float d = a.mask[(size_t)b * a.S + sp] > 0.f ? mul(al[sp], sub(ds[sp], tot)) : 0.f;
          ds[sp] = d;
          a.dsc[row * a.S + sp] = d;
        }
      }
      __syncthreads();
      // two columns of A a thread at once, each summed over S in order
      for (int i0 = tid; i0 < a.A; i0 += 2 * kThreads) {
        const int i1 = i0 + kThreads;
        const bool two = i1 < a.A;
        const bf16* col = a.ep + (size_t)b * a.S * a.A + i0;
        const float dp0 = dps[i0], dp1 = two ? dps[i1] : 0.f;
        float sum0 = 0.f, sum1 = 0.f;
#pragma unroll 5
        for (int sp = 0; sp < a.S; ++sp) {
          const float x0 = to_f<bf16>(col[(size_t)sp * a.A]);
          const float x1 = two ? to_f<bf16>(col[(size_t)sp * a.A + kThreads]) : 0.f;
          const float d = ds[sp];
          const float th0 = tanhf(add(x0, dp0)), th1 = tanhf(add(x1, dp1));
          sum0 = add(sum0, mul(d, sub(1.f, mul(th0, th0))));
          sum1 = add(sum1, mul(d, sub(1.f, mul(th1, th1))));
        }
        const bf16 q0 = from_f<bf16>(mul(sum0, vs[i0]));
        a.ddp[row * a.A + i0] = q0;
        dexs[(size_t)b * Ap + i0] = q0;
        if (two) {
          const bf16 q1 = from_f<bf16>(mul(sum1, vs[i1]));
          a.ddp[row * a.A + i1] = q1;
          dexs[(size_t)b * Ap + i1] = q1;
        }
      }
      __syncthreads();  // dct, dps and ds are the next row's
    }
    group_barrier(bar, 4 * s + 4);

    // (E) dh = dh_prev + io(ddp)·wa_decᵀ, the new f32 carry (owners)
    for (int tl = 0; tl < n_mine; ++tl) {
      float* st = state + (size_t)tl * kFields * kPairs;
      const int r0 = (tile0 + tl) * kRows;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      walk(ring, dexs, nullptr, Ap, r0, B, Ap, mt,
           [&](int k0, const bf16* s0, const bf16*, int kn, int ldg) {
        if (!owner) return;
        uint32_t fa[kPieces][4];
        load_frags(fa, s0, ldg, kn);
        k16_sum(acc, fa, drow, k0, kn, every);
      });
      if (!owner) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int b = r0 + mt * 16 + g + 8 * (e >> 1), j = j0 + ul + (e & 1);
        const int p = pair(e);
        const float dh = add(st[3 * kPairs + p], acc[e]);
        st[p] = dh;
        if (t == 0 && b < B && j < H) a.dh0[(size_t)b * H + j] = from_f<bf16>(dh);
      }
    }
  }
}

// ---------------------------------------------- bf16 forward on tensor cores --
// decoder_seq_fwd_tc_kernel; see the note at the top of the file.
constexpr int kGateRows = 3 * kUnits;  // a unit group's columns of [w_u | w_r | w_c] and of wx_c
constexpr int kMaxAs = 64;             // columns of dp a CTA at most: 4 n-tiles a warp
constexpr int kDpTiles = kMaxAs / 16;
// a sub-tile's state, one float a pair each: h (its io value, carried),
// io(h·w_u), io(h·w_r), u, and xp's candidate part
constexpr int kFFields = 5;
enum { kFH = 0, kFHu = 1, kFHr = 2, kFU = 3, kFXc = 4 };
constexpr size_t kFStateBytes = (size_t)kFFields * kPairs * sizeof(float);

struct FArgs {
  const bf16 *ep, *enc;       // [B,S,A], [B,S,C]
  const float* mask;          // [B,S]
  const bf16* xpx;            // [T,B,3H]
  const float* tmask;         // [T,B]
  const bf16* h0;             // [B,H]
  const bf16* v;              // [A]
  const bf16 *wg, *wx, *wa;   // [n_ug·48, Hp], [n_ug·48, Cp], [n_ug·as, Hp], padded
  bf16* h_seq;                // [T,B,H]
  float* alpha;               // [T,B,S]
  bf16* ctx;                  // [T,B,C]
  bf16 *hx, *rx, *cx;         // exchanges [2,B,Hp] (slot 0: h0), [B,Hp], [B,Cp]; padding zero
  float* dpx;                 // [B, n_ug·as]
  unsigned* bar;              // [groups], zeroed
  long long* clk;             // the timed instance's [grid][4T + 3]
  int T, B, S, A, C, H, Hp, Cp, as, n_tiles, tiles_per_group, stage_bytes, bulk;
};

// the CTA's weights in shared memory: its 16 units' columns of [w_u | w_r |
// w_c] and its as columns of wa_dec over Hp, its units' 48 columns of wx_c
// over Cp, each K-contiguous and padded by 16 bytes
__host__ __device__ inline size_t fwd_w_bytes(int Hp, int Cp, int as) {
  return ((size_t)(kGateRows + as) * (Hp + 8) + (size_t)kGateRows * (Cp + 8)) * sizeof(bf16);
}

inline size_t fwd_smem(int tiles_per_group, int S, int A, int Hp, int Cp, int as, bool w_smem,
                       int stage_bytes) {
  return attn_row::fixed_bytes(S, A) + (size_t)tiles_per_group * kFStateBytes +
         (w_smem ? fwd_w_bytes(Hp, Cp, as) : 0) + stage_bytes;
}

// grid (Hp / kUnits unit groups, batch groups). Warp w computes m-tile w&1;
// warps 0-3 own the (row, unit) pairs of units 8·((w>>1)&1) .. +7 (u and r
// in (1) and (3), c and the cell in (4)); warps 4-7 compute dp's n-tiles
// ((w>>1)&1) + 2i of the CTA's slice of A in (1) and the candidate part of
// xp for the same pairs as warp w-4 in (3). kTimed: thread 0 records its
// SM's clock at every barrier, and the device's nanosecond clock at the
// start and the end, into a.clk.
template <bool kWSmem, bool kTimed>
__global__ void __launch_bounds__(kThreads, 1) decoder_seq_fwd_tc_kernel(FArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tpg = a.tiles_per_group, Hp = a.Hp, Cp = a.Cp, as = a.as, B = a.B, H = a.H;
  const int lda = attn_row::pad8(a.A), Ad = gridDim.x * as;
  attn_row::Bufs rb;
  rb.bar = reinterpret_cast<uint64_t*>(smem_raw);
  rb.count = reinterpret_cast<int*>(smem_raw + 16);
  rb.dp = reinterpret_cast<float*>(smem_raw + 32);
  rb.v = rb.dp + lda;
  rb.sc = rb.v + lda;
  rb.idx = reinterpret_cast<int*>(rb.sc + a.S);
  const size_t fixed = attn_row::fixed_bytes(a.S, a.A);
  float* state = reinterpret_cast<float*>(smem_raw + fixed);  // [tiles][kFFields][kPairs]
  bf16* wsh = reinterpret_cast<bf16*>(smem_raw + fixed + (size_t)tpg * kFStateBytes);
  rb.stage = reinterpret_cast<unsigned char*>(wsh) + (kWSmem ? fwd_w_bytes(Hp, Cp, as) : 0);
  rb.stage_bytes = a.stage_bytes;
  bf16* ring = reinterpret_cast<bf16*>(rb.stage);  // the products' ring, the attention's stage
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mt = warp & 1, nt = (warp >> 1) & 1, g = lane >> 2, q = lane & 3;
  const bool owner = warp < 4;
  const int x = blockIdx.x, j0 = x * kUnits, a0 = x * as;
  const int ldh = kWSmem ? Hp + 8 : Hp, ldx = kWSmem ? Cp + 8 : Cp;
  const bf16* wg_src = a.wg + (size_t)x * kGateRows * Hp;
  const bf16* wa_src = a.wa + (size_t)a0 * Hp;
  const bf16* wx_src = a.wx + (size_t)x * kGateRows * Cp;
  bf16* wg_sh = wsh;                                     // [48][Hp + 8]
  bf16* wa_sh = wg_sh + (size_t)kGateRows * (Hp + 8);   // [as][Hp + 8]
  bf16* wx_sh = wa_sh + (size_t)as * (Hp + 8);          // [48][Cp + 8]
  if (kWSmem) {
    copy_rows(wg_sh, wg_src, kGateRows, Hp);
    copy_rows(wa_sh, wa_src, as, Hp);
    copy_rows(wx_sh, wx_src, kGateRows, Cp);
  }
  const bf16* wg = kWSmem ? wg_sh : wg_src;
  const bf16* wa = kWSmem ? wa_sh : wa_src;
  const bf16* wx = kWSmem ? wx_sh : wx_src;
  // the B columns this lane loads: gate q's column of unit 8·nt + g
  const bf16* gu = wg + (size_t)(nt * 8 + g) * ldh;
  const bf16* gr = wg + (size_t)(kUnits + nt * 8 + g) * ldh;
  const bf16* gc = wg + (size_t)(2 * kUnits + nt * 8 + g) * ldh;
  const bf16* xu = wx + (size_t)(nt * 8 + g) * ldx;
  const bf16* xr = wx + (size_t)(kUnits + nt * 8 + g) * ldx;
  const bf16* xc = wx + (size_t)(2 * kUnits + nt * 8 + g) * ldx;
  for (int i = tid; i < lda; i += kThreads) rb.v[i] = i < a.A ? to_f<bf16>(a.v[i]) : 0.f;
  if (tid == 0) {
    mbar_init(&rb.bar[0], 1);
    mbar_init(&rb.bar[1], 1);
    fence_mbar_init();
  }
  const int tile0 = blockIdx.y * tpg;
  const int n_mine = min(a.n_tiles, tile0 + tpg) - tile0;
  unsigned* bar = a.bar + blockIdx.y;
  const int ul = nt * 8 + 2 * q;  // the lane's first unit in the group
  auto pair = [&](int e) { return (mt * 16 + g + 8 * (e >> 1)) * kUnits + ul + (e & 1); };
  auto row_of = [&](int r0, int e) { return r0 + mt * 16 + g + 8 * (e >> 1); };
  const Every every{};

  for (int i = tid; i < tpg * kFFields * kPairs; i += kThreads) state[i] = 0.f;
  __syncthreads();  // the state is zero before any owner writes its pairs' fields
  if (owner)
    for (int tl = 0; tl < n_mine; ++tl)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int b = row_of((tile0 + tl) * kRows, e), j = j0 + ul + (e & 1);
        if (b < B && j < H)
          state[(size_t)tl * kFFields * kPairs + kFH * kPairs + pair(e)] =
              to_f<bf16>(a.h0[(size_t)b * H + j]);
      }
  long long* clk = kTimed ? a.clk + ((size_t)blockIdx.y * gridDim.x + x) * (4 * a.T + 3) : nullptr;
  if (kTimed && tid == 0) {
    clk[0] = global_ns();
    clk[1] = clock64();
  }
  auto barrier = [&](unsigned k) {
    group_barrier(bar, k);
    if (kTimed && tid == 0) clk[1 + k] = clock64();
  };
  unsigned ph[2] = {0u, 0u};

  for (int s = 0; s < a.T; ++s) {
    const size_t tb = (size_t)s * B;
    const bf16* hx = a.hx + (size_t)(s & 1) * B * Hp;           // h(t-1)
    bf16* hx_next = a.hx + (size_t)((s + 1) & 1) * B * Hp;

    // (1) dp for the CTA's slice of A (warps 4-7), f32 and not rounded;
    // io(h·w_u) and io(h·w_r) of the owners' pairs
    for (int tl = 0; tl < n_mine; ++tl) {
      float* st = state + (size_t)tl * kFFields * kPairs;
      const int r0 = (tile0 + tl) * kRows;
      float au[4] = {0.f, 0.f, 0.f, 0.f}, ar[4] = {0.f, 0.f, 0.f, 0.f}, ad[kDpTiles][4];
#pragma unroll
      for (int i = 0; i < kDpTiles; ++i) ad[i][0] = ad[i][1] = ad[i][2] = ad[i][3] = 0.f;
      walk(ring, hx, nullptr, Hp, r0, B, Hp, mt,
           [&](int k0, const bf16* s0, const bf16*, int kn, int ldg) {
             uint32_t fa[kPieces][4];
             load_frags(fa, s0, ldg, kn);
             if (owner) {
               k16_sum(au, fa, gu, k0, kn, every);
               k16_sum(ar, fa, gr, k0, kn, every);
             } else {
#pragma unroll
               for (int i = 0; i < kDpTiles; ++i) {
                 const int n8 = 8 * (nt + 2 * i);
                 if (n8 >= as) break;
                 k16_sum(ad[i], fa, wa + (size_t)(n8 + g) * ldh, k0, kn, every);
               }
             }
           });
      if (owner) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          st[kFHu * kPairs + pair(e)] = round_io<bf16>(au[e]);
          st[kFHr * kPairs + pair(e)] = round_io<bf16>(ar[e]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < kDpTiles; ++i) {
          const int n8 = 8 * (nt + 2 * i);
          if (n8 >= as) break;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int b = r0 + mt * 16 + frag_row(e);
            if (b < B) a.dpx[(size_t)b * Ad + a0 + n8 + frag_col(0, e)] = ad[i][e];
          }
        }
      }
    }
    barrier(4 * s + 1);

    // (2) the attention of the group's rows this CTA takes (row i of the
    // group to its CTA i mod gridDim.x): alpha, and ctx into its output and
    // the exchange
    for (int li = x; li < n_mine * kRows; li += gridDim.x) {
      const int b = tile0 * kRows + li;
      if (b >= B) break;
      __syncthreads();  // the last row's routine is done with dp
      for (int i = tid; i < lda; i += kThreads)
        rb.dp[i] = i < a.A ? __ldcg(a.dpx + (size_t)b * Ad + i) : 0.f;
      attn_row::attend<kThreads>(a.ep + (size_t)b * a.S * a.A, a.enc + (size_t)b * a.S * a.C,
                                 a.mask + (size_t)b * a.S, a.S, a.A, a.C, a.bulk != 0, rb, ph,
                                 a.alpha + (tb + b) * a.S, a.ctx + (tb + b) * a.C,
                                 a.cx + (size_t)b * Cp);
    }
    barrier(4 * s + 2);

    // (3) xp = io(xpx + io(ctx·wx_c)) for the units' three gates: u and r
    // (owners), io(r·h) published; the candidate part (warps 4-7) kept
    for (int tl = 0; tl < n_mine; ++tl) {
      float* st = state + (size_t)tl * kFFields * kPairs;
      const int r0 = (tile0 + tl) * kRows;
      bf16 x0[4], x1[4];  // xpx of the lane's pairs, loaded before the walk
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x0[e] = x1[e] = from_f<bf16>(0.f);
        const int b = row_of(r0, e), j = j0 + ul + (e & 1);
        if (b >= B || j >= H) continue;
        const bf16* xr_ = a.xpx + (tb + b) * 3 * H + j;
        if (owner) {
          x0[e] = xr_[0];
          x1[e] = xr_[H];
        } else {
          x0[e] = xr_[2 * H];
        }
      }
      float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
      walk(ring, a.cx, nullptr, Cp, r0, B, Cp, mt,
           [&](int k0, const bf16* s0, const bf16*, int kn, int ldg) {
             uint32_t fa[kPieces][4];
             load_frags(fa, s0, ldg, kn);
             if (owner) {
               k16_sum(c0, fa, xu, k0, kn, every);
               k16_sum(c1, fa, xr, k0, kn, every);
             } else {
               k16_sum(c0, fa, xc, k0, kn, every);
             }
           });
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int b = row_of(r0, e), j = j0 + ul + (e & 1), p = pair(e);
        if (b >= B || j >= H) continue;
        if (owner) {
          const float xu_ = round_io<bf16>(to_f<bf16>(x0[e]) + round_io<bf16>(c0[e]));
          const float xr_ = round_io<bf16>(to_f<bf16>(x1[e]) + round_io<bf16>(c1[e]));
          const float u = sigmoid_io<bf16>(round_io<bf16>(xu_ + st[kFHu * kPairs + p]));
          const float r = sigmoid_io<bf16>(round_io<bf16>(xr_ + st[kFHr * kPairs + p]));
          st[kFU * kPairs + p] = u;
          a.rx[(size_t)b * Hp + j] = from_f<bf16>(r * st[kFH * kPairs + p]);
        } else {
          st[kFXc * kPairs + p] = round_io<bf16>(to_f<bf16>(x0[e]) + round_io<bf16>(c0[e]));
        }
      }
    }
    barrier(4 * s + 3);

    // (4) c = tanh(xp_c + io(io(r·h)·w_c)), h' and the masked carry (owners)
    for (int tl = 0; tl < n_mine; ++tl) {
      float* st = state + (size_t)tl * kFFields * kPairs;
      const int r0 = (tile0 + tl) * kRows;
      float m[2] = {0.f, 0.f};
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int b = row_of(r0, 2 * rr);
        if (owner && b < B) m[rr] = a.tmask[tb + b];
      }
      float cc[4] = {0.f, 0.f, 0.f, 0.f};
      walk(ring, a.rx, nullptr, Hp, r0, B, Hp, mt,
           [&](int k0, const bf16* s0, const bf16*, int kn, int ldg) {
             if (!owner) return;
             uint32_t fa[kPieces][4];
             load_frags(fa, s0, ldg, kn);
             k16_sum(cc, fa, gc, k0, kn, every);
           });
      if (!owner) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int b = row_of(r0, e), j = j0 + ul + (e & 1), p = pair(e);
        if (b >= B || j >= H) continue;
        const float c = tanh_io<bf16>(round_io<bf16>(st[kFXc * kPairs + p] + round_io<bf16>(cc[e])));
        const float h = st[kFH * kPairs + p], u = st[kFU * kPairs + p];
        const float mm = round_io<bf16>(m[e >> 1]);
        const float hn = round_io<bf16>(round_io<bf16>(round_io<bf16>(1.f - u) * h) +
                                        round_io<bf16>(u * c));
        const float ho = round_io<bf16>(round_io<bf16>(mm * hn) +
                                        round_io<bf16>(round_io<bf16>(1.f - mm) * h));
        const bf16 hv = from_f<bf16>(ho);
        a.h_seq[(tb + b) * H + j] = hv;
        hx_next[(size_t)b * Hp + j] = hv;
        st[kFH * kPairs + p] = ho;
      }
    }
    barrier(4 * s + 4);
  }
  if (kTimed && tid == 0) clk[4 * a.T + 2] = global_ns();
}

// How the card takes a launch: CTAs an SM, batch groups, sub-tiles a
// group, the columns of C (backward) or of A (forward) a CTA owns, whether
// the weights' slices are in shared memory, and the forward's stage.
struct Plan {
  int per_sm, groups, tiles_per_group, cs, w_smem, stage;
  size_t smem;
};

cudaError_t occupancy(const void* kernel, int* per_sm, size_t smem, int smem_max) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, kThreads, smem);
}

// The search both tensor-core kernels share. The weights' slices in shared
// memory where they fit beside one sub-tile's state and the rest
// (smem_of(tiles, w_smem)), else read through L1; then the most CTAs an SM
// for which the card holds every unit group times as many batch groups as
// it can, none empty, with their sub-tiles' state. kernel_of(w_smem) is the
// kernel whose occupancy counts. cudaErrorCooperativeLaunchTooLarge for a
// shape the card cannot hold.
template <class SmemOf, class KernelOf>
cudaError_t search(int n_ug, int n_tiles, int n_sms, int smem_max, SmemOf&& smem_of,
                   KernelOf&& kernel_of, Plan* p) {
  for (int w_smem = 1; w_smem >= 0; --w_smem) {
    if (smem_of(1, w_smem) > (size_t)smem_max) continue;
    int most = 0;
    cudaError_t err = occupancy(kernel_of(w_smem), &most, smem_of(1, w_smem), smem_max);
    if (err != cudaSuccess) return err;
    for (int per_sm = most; per_sm >= 1; --per_sm) {
      const int cap = per_sm * n_sms;
      if (n_ug > cap) break;
      int groups = min(n_tiles, cap / n_ug);
      const int tpg = cdiv(n_tiles, groups);
      groups = cdiv(n_tiles, tpg);
      const size_t smem = smem_of(tpg, w_smem);
      if (smem > (size_t)smem_max) continue;
      int got = 0;
      err = occupancy(kernel_of(w_smem), &got, smem, smem_max);
      if (err != cudaSuccess) return err;
      if (got * n_sms < n_ug * groups) continue;
      *p = Plan{got, groups, tpg, 0, w_smem, 0, smem};
      return cudaSuccess;
    }
  }
  return cudaErrorCooperativeLaunchTooLarge;
}

// The backward's plan. Refuses (cudaErrorInvalidValue) a slice of C past
// kMaxSlice columns, and (cudaErrorCooperativeLaunchTooLarge) a shape the
// card cannot hold.
cudaError_t plan(int B, int S, int A, int C, int H, Plan* p) {
  int n_sms = 0, smem_max = 0;
  cudaError_t err = coop_device(&n_sms, &smem_max);
  if (err != cudaSuccess) return err;
  if (B < 1 || S < 1 || A < 1 || C < 1 || H < 1) return cudaErrorInvalidValue;
  const int Hp = cdiv(H, kUnits) * kUnits, n_ug = Hp / kUnits, Ap = cdiv(A, 16) * 16;
  const int cs = cdiv(cdiv(C, n_ug), 8) * 8;
  if (cs > kMaxSlice) return cudaErrorInvalidValue;
  err = search(
      n_ug, cdiv(B, kRows), n_sms, smem_max,
      [&](int tpg, int w_smem) { return tc_smem(tpg, S, A, C, Hp, Ap, cs, w_smem); },
      [](int w_smem) {
        return w_smem ? reinterpret_cast<const void*>(decoder_seq_bwd_tc_kernel<true>)
                      : reinterpret_cast<const void*>(decoder_seq_bwd_tc_kernel<false>);
      },
      p);
  p->cs = cs;
  return err;
}

// The forward's widths: Hp and Cp (H and C rounded up to 16), the unit
// groups, and each CTA's slice of A for dp (as: A over the unit groups,
// rounded up to a whole n-tile of 8).
struct FWidths {
  int Hp, Cp, n_ug, as;
};

__host__ __device__ inline FWidths fwd_widths(int A, int C, int H) {
  FWidths w;
  w.Hp = cdiv(H, kUnits) * kUnits;
  w.Cp = cdiv(C, 16) * 16;
  w.n_ug = w.Hp / kUnits;
  w.as = cdiv(cdiv(A, w.n_ug), 8) * 8;
  return w;
}

const void* fwd_kernel(bool w_smem, bool timed) {
  if (timed)
    return w_smem ? reinterpret_cast<const void*>(decoder_seq_fwd_tc_kernel<true, true>)
                  : reinterpret_cast<const void*>(decoder_seq_fwd_tc_kernel<false, true>);
  return w_smem ? reinterpret_cast<const void*>(decoder_seq_fwd_tc_kernel<true, false>)
                : reinterpret_cast<const void*>(decoder_seq_fwd_tc_kernel<false, false>);
}

// The forward's plan: B10's search on the forward's shared memory, the
// products' ring as the attention's stage; where a CTA has an SM to itself
// the stage takes whatever shared memory is left. Refuses
// (cudaErrorInvalidValue) a slice of A past kMaxAs columns, a C past the
// row routine's, or rows the ring cannot stage; the rule in
// attention_kernels.seq_fwd_route sends those shapes to the first design
// before any launch.
cudaError_t fwd_plan(int B, int S, int A, int C, int H, Plan* p) {
  int n_sms = 0, smem_max = 0;
  cudaError_t err = coop_device(&n_sms, &smem_max);
  if (err != cudaSuccess) return err;
  if (B < 1 || S < 1 || A < 1 || C < 1 || H < 1) return cudaErrorInvalidValue;
  const FWidths w = fwd_widths(A, C, H);
  if (w.as > kMaxAs || C > 8 * attn_row::kMaxG * kThreads ||
      !attn_row::stage_fits(A, C, (int)kRingBytes))
    return cudaErrorInvalidValue;
  err = search(
      w.n_ug, cdiv(B, kRows), n_sms, smem_max,
      [&](int tpg, int w_smem) {
        return fwd_smem(tpg, S, A, w.Hp, w.Cp, w.as, w_smem, (int)kRingBytes);
      },
      [](int w_smem) { return fwd_kernel(w_smem, false); }, p);
  if (err != cudaSuccess) return err;
  p->cs = w.as;
  p->stage = (int)kRingBytes;
  if (p->per_sm == 1) {
    p->stage += (int)((size_t)smem_max - p->smem) / 16 * 16;
    p->smem = fwd_smem(p->tiles_per_group, S, A, w.Hp, w.Cp, w.as, p->w_smem, p->stage);
  }
  return cudaSuccess;
}

cudaError_t launch(void* const* p, int T, int B, int S, int A, int C, int H, cudaStream_t st) {
  Plan pl{};
  cudaError_t err = plan(B, S, A, C, H, &pl);
  if (err != cudaSuccess) return err;
  Args a{};
  a.ep = static_cast<const bf16*>(p[0]);
  a.enc = static_cast<const bf16*>(p[1]);
  a.mask = static_cast<const float*>(p[2]);
  a.g = static_cast<const bf16*>(p[3]);
  a.tmask = static_cast<const float*>(p[4]);
  a.hp = static_cast<const bf16*>(p[5]);
  a.u = static_cast<const bf16*>(p[6]);
  a.r = static_cast<const bf16*>(p[7]);
  a.c = static_cast<const bf16*>(p[8]);
  a.dp = static_cast<const bf16*>(p[9]);
  a.alpha = static_cast<const float*>(p[10]);
  a.v = static_cast<const bf16*>(p[11]);
  a.wu = static_cast<const bf16*>(p[12]);
  a.wad = static_cast<const bf16*>(p[13]);
  a.wxc = static_cast<const bf16*>(p[14]);
  a.dxp = static_cast<bf16*>(p[15]);
  a.dctx = static_cast<bf16*>(p[16]);
  a.ddp = static_cast<bf16*>(p[17]);
  a.dh0 = static_cast<bf16*>(p[18]);
  a.dsc = static_cast<float*>(p[19]);
  a.ex = static_cast<bf16*>(p[20]);
  a.dex = static_cast<bf16*>(p[21]);
  a.bar = static_cast<unsigned*>(p[22]);
  a.T = T;
  a.B = B;
  a.S = S;
  a.A = A;
  a.C = C;
  a.H = H;
  a.Hp = cdiv(H, kUnits) * kUnits;
  a.Ap = cdiv(A, 16) * 16;
  a.cs = pl.cs;
  a.n_tiles = cdiv(B, kRows);
  a.tiles_per_group = pl.tiles_per_group;
  void* args[] = {&a};
  const void* kernel = pl.w_smem ? reinterpret_cast<const void*>(decoder_seq_bwd_tc_kernel<true>)
                                 : reinterpret_cast<const void*>(decoder_seq_bwd_tc_kernel<false>);
  err = cudaLaunchCooperativeKernel(kernel, dim3(a.Hp / kUnits, pl.groups), dim3(kThreads), args,
                                    pl.smem, st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// p: ep, enc, mask, xpx, tmask, h0, v, wg, wx, wa (the weights as
// attention_kernels.seq_fwd_weights lays them out), h_seq, alpha, ctx, the
// exchanges hx, rx, cx, dpx, the counters, clk (the timed instance's).
cudaError_t fwd_launch(void* const* p, int T, int B, int S, int A, int C, int H, bool timed,
                       cudaStream_t st) {
  Plan pl{};
  cudaError_t err = fwd_plan(B, S, A, C, H, &pl);
  if (err != cudaSuccess) return err;
  const FWidths w = fwd_widths(A, C, H);
  FArgs a{};
  a.ep = static_cast<const bf16*>(p[0]);
  a.enc = static_cast<const bf16*>(p[1]);
  a.mask = static_cast<const float*>(p[2]);
  a.xpx = static_cast<const bf16*>(p[3]);
  a.tmask = static_cast<const float*>(p[4]);
  a.h0 = static_cast<const bf16*>(p[5]);
  a.v = static_cast<const bf16*>(p[6]);
  a.wg = static_cast<const bf16*>(p[7]);
  a.wx = static_cast<const bf16*>(p[8]);
  a.wa = static_cast<const bf16*>(p[9]);
  a.h_seq = static_cast<bf16*>(p[10]);
  a.alpha = static_cast<float*>(p[11]);
  a.ctx = static_cast<bf16*>(p[12]);
  a.hx = static_cast<bf16*>(p[13]);
  a.rx = static_cast<bf16*>(p[14]);
  a.cx = static_cast<bf16*>(p[15]);
  a.dpx = static_cast<float*>(p[16]);
  a.bar = static_cast<unsigned*>(p[17]);
  a.clk = static_cast<long long*>(p[18]);
  a.T = T;
  a.B = B;
  a.S = S;
  a.A = A;
  a.C = C;
  a.H = H;
  a.Hp = w.Hp;
  a.Cp = w.Cp;
  a.as = w.as;
  a.n_tiles = cdiv(B, kRows);
  a.tiles_per_group = pl.tiles_per_group;
  a.stage_bytes = pl.stage;
  // the attention's rows by the bulk-copy engine where they are a multiple
  // of 16 bytes (attention_kernels.seq_fwd_bulk), else by plain loads
  a.bulk = (A % 8 == 0) && (C % 8 == 0);
  if (a.bulk && ((reinterpret_cast<uintptr_t>(a.ep) | reinterpret_cast<uintptr_t>(a.enc)) & 15))
    return cudaErrorMisalignedAddress;
  if (timed && !a.clk) return cudaErrorInvalidValue;
  const void* kernel = fwd_kernel(pl.w_smem, timed);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
  if (err != cudaSuccess) return err;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(kernel, dim3(w.n_ug, pl.groups), dim3(kThreads), args, pl.smem,
                                    st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace tcb

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

// The bf16 forward on tensor cores. p: ep [B,S,A], enc [B,S,C], mask [B,S]
// f32, xpx [T,B,3H], tmask [T,B] f32, h0 [B,H], v [A]; the weights padded as
// attention_kernels.seq_fwd_weights lays them out: wg [n_ug·48, Hp] (row
// 48x + 16q + i: gate q's column of unit 16x + i of [w_u | w_r | w_c]), wx
// [n_ug·48, Cp] (the same of wx_c), wa [n_ug·as, Hp] (row a: wa_dec's column
// a); out h_seq [T,B,H], alpha [T,B,S] f32, ctx [T,B,C]; zeroed workspace:
// the exchanges hx [2,B,Hp] bf16 with h0 in slot 0, rx [B,Hp] and cx
// [B,Cp] bf16, dpx [B, n_ug·as] f32, the batch groups' counters [groups]
// u32; clk [grid][4T + 3] int64 where timed (else unused). Hp is H and Cp
// is C rounded up to 16, n_ug = Hp / 16, as from the plan.
extern "C" int decoder_seq_fwd_tc_launch(void* const* p, int n_steps, int B, int S, int A, int C,
                                         int H, int timed, void* stream) {
  if (n_steps < 1) return cudaErrorInvalidValue;
  return tcb::fwd_launch(p, n_steps, B, S, A, C, H, timed != 0, static_cast<cudaStream_t>(stream));
}

// The bf16 forward's plan at these widths on the current device: out[0..6]
// = CTAs an SM, batch groups, 32-row sub-tiles a group, columns of A a
// CTA, the weights' slices in shared memory (0/1), the attention's stage
// bytes, the shared memory bytes a CTA.
extern "C" int decoder_seq_fwd_tc_plan(int B, int S, int A, int C, int H, int* out) {
  tcb::Plan pl{};
  const cudaError_t err = tcb::fwd_plan(B, S, A, C, H, &pl);
  if (err != cudaSuccess) return err;
  out[0] = pl.per_sm;
  out[1] = pl.groups;
  out[2] = pl.tiles_per_group;
  out[3] = pl.cs;
  out[4] = pl.w_smem;
  out[5] = pl.stage;
  out[6] = (int)pl.smem;
  return cudaSuccess;
}

// The bf16 backward on tensor cores. p: ep, enc, mask, g_seq, tmask, hp_seq,
// u_seq, r_seq, c_seq, dp_seq, alpha, v as decoder_seq_bwd_launch's; then
// the weights padded as attention_kernels.seq_bwd_weights lays them out: wu
// [Hp,3Hp] (row j: unit j's w_u | w_r | w_c, gate q's columns at q·Hp), wad
// [Hp,Ap] (row j: unit j's wa_dec), wxc [n_ug·cs,3Hp] (row c: wx_c's row c,
// the gates padded as wu's); out dxp [T,B,3H], dctx [T,B,C], ddp [T,B,A],
// dh0 [B,H], dsc [T,B,S] f32; zeroed workspace: the exchanges ex [2,B,3Hp]
// and dex [2,B,Ap] bf16, the batch groups' counters [groups] u32. Hp is H
// and Ap is A rounded up to 16, n_ug = Hp / 16, cs from the plan. dep and
// dv come from bahdanau_attn.cu's attn_dep_launch on dsc after it.
extern "C" int decoder_seq_bwd_tc_launch(void* const* p, int n_steps, int B, int S, int A, int C,
                                         int H, void* stream) {
  if (n_steps < 1) return cudaErrorInvalidValue;
  return tcb::launch(p, n_steps, B, S, A, C, H, static_cast<cudaStream_t>(stream));
}

// The bf16 backward's plan at these widths on the current device: out[0..4]
// = CTAs an SM, batch groups, 32-row sub-tiles a group, columns of C a CTA,
// the weights' slices in shared memory (0/1).
extern "C" int decoder_seq_bwd_tc_plan(int B, int S, int A, int C, int H, int* out) {
  tcb::Plan pl{};
  const cudaError_t err = tcb::plan(B, S, A, C, H, &pl);
  if (err != cudaSuccess) return err;
  out[0] = pl.per_sm;
  out[1] = pl.groups;
  out[2] = pl.tiles_per_group;
  out[3] = pl.cs;
  out[4] = pl.w_smem;
  return cudaSuccess;
}

extern "C" const char* decoder_seq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
