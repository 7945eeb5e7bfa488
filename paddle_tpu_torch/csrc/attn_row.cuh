// One batch row of the Bahdanau attention in bf16, forward and backward: the
// row routines csrc/bahdanau_attn.cu's attn_fwd_row_kernel (B5) and
// csrc/decoder_seq.cu's bf16 forward (B9, its phase 2) call (`attend`), and
// csrc/bahdanau_attn.cu's attn_bwd_row_kernel (B6) calls on each rank of a
// thread-block cluster (`attend_bwd`). Both are built from the same pieces:
// the listing of a row's positions (`list_flagged`), the stage's plan
// (`chunks`) and the walk that streams the listed rows through the stage
// (`stream`).
//
// `attend` computes for the row b what `_attn_fwd_kernel`
// (paddle_tpu/ops/bahdanau_kernels.py:170) computes: the scores Σ_A
// tanh(ep + dp)·v in f32, the masked softmax over S (a masked score is
// -1e9), alpha [S] f32 and ctx = io(Σ_S io(α)·enc) [C].
//
// What bounds it: the bytes of the row's ep [S, A] and enc [S, C]. So
// - the row's valid positions are listed first (the mask need not be a
//   prefix), and only their rows of ep and enc are read: a masked score is
//   replaced by -1e9, whose α is exactly 0 in f32. A fully masked row keeps
//   the plain answer, α = 1/S at every position, so there every position's
//   enc row is read (and no ep row: every score is -1e9);
// - the listed rows are staged into shared memory, a row a copy. Rows of a
//   multiple of 16 bytes (A and C multiples of 8: `bulk`) go by the
//   bulk-copy engine (cp.async.bulk, completing on an mbarrier), issued by
//   the lanes of warp 0; any other row is copied by every thread with
//   plain loads, zero-padded to a multiple of 8 elements. Where the valid
//   rows of ep and enc fit the stage together, both are issued at entry, so
//   enc is in flight while the scores are computed; where they do not, S
//   is streamed through a ring of two halves of the stage, ep's chunks for
//   the scores, then enc's for ctx, the next chunk in flight while one is
//   read (`chunks`, mirrored by attention_kernels.attn_row_chunks);
// - a warp takes a position's score, its lanes reading 16 bytes (8 values)
//   at a time; for ctx a thread owns 8 columns and a class of positions
//   (i mod splits), its sums in registers across the chunks, and the
//   classes' sums are added in class order at the end through the stage:
//   a fixed order, the same bits on every run.
//
// `attend_bwd` computes one rank's share of what `_attn_bwd_kernel`
// (bahdanau_kernels.py:190) computes for the row: dα = enc·dctx, dsc =
// α(dα − Σα·dα) masked to 0, ddp = io(v·Σ_S dsc·(1−t²)), t = tanh(ep + dp).
// Nothing in it needs the whole row in one CTA (unlike ctx, which rounds α
// after the softmax over the whole row), so the row's list is cut into the
// cluster's ranks' contiguous ranges. Each rank stages its range's rows of
// enc (pass 0, for dα) and of ep (pass 1, in flight while dα is computed),
// pushes its partial Σα·dα into every rank's slots through distributed
// shared memory (each adds the ranks' partials in rank order), forms dsc
// for its range, and sums a partial ddp over its positions (8 columns a
// thread by position class, the classes added in order), which it pushes
// into rank 0's receive buffer; rank 0 adds the ranks' partials in rank
// order. Two cluster barriers a row, pushes rather than remote loads; the
// first push waits on a relaxed cluster arrival made at entry, so no rank
// writes into a CTA's shared memory before that CTA is known to run. A
// fixed order throughout: the same bits on every run.
//
// Shared memory the caller lays out (`fixed_bytes`, `bwd_fixed_bytes`): two
// mbarriers, the list's length (and a rank's partial Σα·dα), dp and v
// padded to lda with zeros (f32), the scores (the backward's flags) [S] f32
// and the list [S]; for the backward then dctx [ldc], α [S], dα (then dsc)
// [S], the ranks' Σα·dα [kMaxRanks] and rank 0's receive buffer [ranks −
// 1][lda] f32; and a stage of at least kMinStage bytes, 16-byte aligned.

#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace ptt {
namespace attn_row {

using bf16 = __nv_bfloat16;

constexpr int kMaxSplit = 8;   // position classes of the ctx and ddp sums at most
constexpr int kMaxG = 4;       // 8-column groups of ctx (ddp) a thread at most
constexpr int kMinStage = 8192;  // bytes: the classes' sums at the end, at 256 threads
constexpr int kMaxRanks = 4;     // CTAs of the backward's cluster at most

__host__ __device__ inline int pad8(int n) { return (n + 7) / 8 * 8; }
__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// bytes before the stage: mbarriers (16), the list's length and a rank's
// partial (16), dp and v [lda] f32, the scores [S] f32 and the list [S]
// int, rounded up to 16
__host__ __device__ inline size_t fixed_bytes(int S, int A) {
  return ((size_t)32 + 8 * (size_t)pad8(A) + 8 * (size_t)S + 15) / 16 * 16;
}

// the backward's on `ranks` ranks: the same, then dctx [ldc], α [S], dα
// [S], the Σα·dα slots [kMaxRanks] and the receive buffer [ranks − 1][lda]
// f32, rounded up to 16
__host__ __device__ inline size_t bwd_fixed_bytes(int S, int A, int C, int ranks) {
  return fixed_bytes(S, A) +
         (4 * ((size_t)pad8(C) + 2 * (size_t)S + kMaxRanks + (size_t)(ranks - 1) * pad8(A)) +
          15) / 16 * 16;
}

// The stage's plan for n listed positions read in two passes, rows of ld0
// then of ld1 bf16: whole (both passes' rows together, pass 1's at byte
// off1) or two halves (pass 0's chunks of p0 positions, then pass 1's of
// p1, alternating between the halves at 0 and off1); n0 and n1 chunks.
// `first` false: no pass 0. The forward's passes are ep (the scores) and
// enc (ctx); the backward's enc (dα) and ep (ddp).
struct Chunks {
  int whole, p0, p1, n0, n1, off1;
};

__host__ __device__ inline Chunks chunks(int n, bool first, int ld0, int ld1, int stage_bytes) {
  Chunks k{};
  if (n < 1) return k;  // an empty range: no chunk
  const long long e0 = first ? (long long)n * ld0 * 2 : 0, e1 = (long long)n * ld1 * 2;
  if (e0 + e1 <= stage_bytes) {
    k.whole = 1;
    k.p0 = k.p1 = n;
    k.off1 = (int)e0;
  } else {
    const int half = stage_bytes / 32 * 16;
    k.p0 = half / (ld0 * 2);
    k.p1 = half / (ld1 * 2);
    k.off1 = half;
  }
  k.n0 = first ? cdiv(n, k.p0) : 0;
  k.n1 = cdiv(n, k.p1);
  return k;
}

// the stage holds a chunk of one position of each in either half, and the
// classes' sums
__host__ __device__ inline bool stage_fits(int A, int C, int stage_bytes) {
  const int half = stage_bytes / 32 * 16;
  return stage_bytes >= kMinStage && half >= 2 * pad8(A) && half >= 2 * pad8(C);
}

struct Bufs {
  unsigned char* stage;
  int stage_bytes;
  uint64_t* bar;  // [2], initialised with a count of 1
  int* count;     // the list's length
  float *dp, *v;  // [lda]: the row's dp and v, zero past A
  float* sc;      // [S]: flags, then the scores and io(α), by list index (the backward: flags)
  int* idx;       // [S]: the listed positions
  float *al, *ds;  // the backward's [S]: α by position, dα then dsc by list index
  float *tots, *recv;  // the backward's Σα·dα slots and rank 0's receive buffer
};

// Warp 0's list of the positions s < S with flag[s] > 0, in order, into idx;
// returns their count on every lane.
__device__ inline int list_flagged(const float* flag, int S, int* idx) {
  const int lane = threadIdx.x & 31;
  int n = 0;
  for (int s0 = 0; s0 < S; s0 += 32) {
    const int s = s0 + lane;
    const bool ok = s < S && flag[s] > 0.f;
    const unsigned bal = __ballot_sync(0xffffffffu, ok);
    if (ok) idx[n + __popc(bal & ((1u << lane) - 1u))] = s;
    n += __popc(bal);
  }
  return n;
}

// Streams the rows idx[0..n) of two sources through the stage as `k` plans
// them: pass 0 the rows of src0 (width w0; none where k.n0 is 0), then pass
// 1 those of src1 (w1), each staged at a pitch of pad8(width) bf16 (zero
// past the width where copied by loads; ld0 and ld1 of `chunks`). Called by
// every thread of a kT-thread CTA (the sources not written in this launch);
// body(pass, i0, i1, rows) runs on every thread once the chunk of list
// entries [i0, i1) has landed at `rows`, and between() once between the
// passes, behind a barrier on either side (also where a pass is empty).
// ph: the mbarriers' phases, carried by the caller from row to row.
template <int kT, class Body, class Between>
__device__ void stream(const Chunks& k, int n, const int* idx, const bf16* src0, int w0,
                       const bf16* src1, int w1, bool bulk, const Bufs& r, unsigned (&ph)[2],
                       Body body, Between between) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int items = k.n0 + k.n1;
  auto span = [&](int it, int& i0, int& i1) {
    const bool first = it < k.n0;
    const int p = first ? k.p0 : k.p1;
    i0 = (first ? it : it - k.n0) * p;
    i1 = min(n, i0 + p);
  };
  auto buf = [&](int it) { return reinterpret_cast<bf16*>(r.stage + ((it & 1) ? k.off1 : 0)); };
  auto issue = [&](int it) {
    if (it >= items) return;
    int i0, i1;
    span(it, i0, i1);
    const bool first = it < k.n0;
    const int width = first ? w0 : w1, pitch = pad8(width);
    const bf16* src = first ? src0 : src1;
    bf16* dst = buf(it);
    if (bulk) {
      if (warp == 0) {
        if (lane == 0) mbar_expect(&r.bar[it & 1], (unsigned)((i1 - i0) * width * 2));
        __syncwarp();
        for (int i = i0 + lane; i < i1; i += 32)
          bulk_load(dst + (size_t)(i - i0) * pitch, src + (size_t)idx[i] * width,
                    (unsigned)width * 2, &r.bar[it & 1]);
      }
    } else {
      const int rows = i1 - i0;
      for (int e = tid; e < rows * pitch; e += kT) {
        const int i = e / pitch, col = e - i * pitch;
        dst[e] = col < width ? src[(size_t)idx[i0 + i] * width + col] : from_f<bf16>(0.f);
      }
    }
  };

  issue(0);
  issue(1);
  for (int it = 0; it <= items; ++it) {
    if (it == k.n0) {  // pass 0 is done
      __syncthreads();
      between();
      __syncthreads();
    }
    if (it == items) break;
    if (bulk) {
      mbar_wait(&r.bar[it & 1], ph[it & 1]);
      ph[it & 1] ^= 1u;
    } else {
      __syncthreads();
    }
    int i0, i1;
    span(it, i0, i1);
    body(it < k.n0 ? 0 : 1, i0, i1, static_cast<const bf16*>(buf(it)));
    __syncthreads();  // every thread is done with this chunk's half
    issue(it + 2);
  }
}

// The position classes of a sum over positions into `width` columns, 8 a
// thread (kG groups of 8 at most): where the columns' groups leave threads
// over, the positions go to classes i mod splits (at most kMaxSplit), added
// in class order at the end.
template <int kT>
__device__ __forceinline__ int class_splits(int width) {
  const int G = pad8(width) / 8;
  return G * 2 <= kT ? min(kMaxSplit, kT / G) : 1;
}

// The classes' sums of acc (each thread's 8-column groups gi + kT·gg, its
// class sp) added in class order through `part` (free shared memory of
// (splits − 1)·ld floats); out(gg, grp, tot[8]) runs on the class-0 threads
// for each of their groups. Every thread calls it.
template <int kT, int kG, class Out>
__device__ void add_classes(float (&acc)[kG][8], int width, float* part, Out out) {
  const int ld = pad8(width), G = ld / 8, tid = threadIdx.x;
  const int splits = class_splits<kT>(width);
  const int gi = splits > 1 ? tid % G : tid, sp = splits > 1 ? tid / G : 0;
  const bool active = sp < splits;
  if (active && sp > 0)  // splits > 1: one group a thread
#pragma unroll
    for (int e = 0; e < 8; ++e) part[(size_t)(sp - 1) * ld + 8 * gi + e] = acc[0][e];
  __syncthreads();
  if (!active || sp > 0) return;
#pragma unroll
  for (int gg = 0; gg < kG; ++gg) {
    const int grp = gi + gg * kT;
    if (grp >= G) break;
    float tot[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      tot[e] = acc[gg][e];
#pragma unroll 1  // unrolled, this sum was the largest block of B9's code
      for (int c = 1; c < splits; ++c) tot[e] += part[(size_t)(c - 1) * ld + 8 * grp + e];
    }
    out(gg, grp, tot);
  }
}

// Called by every thread of a kT-thread CTA. ep [S, A], enc [S, C] and mask
// [S] are the row's (ep and enc not written in this launch); alpha [S] and
// out0 [C] its outputs, out1 [C] a second copy of ctx where not null. ph:
// the mbarriers' phases, carried by the caller from row to row.
template <int kT>
__device__ void attend(const bf16* ep, const bf16* enc, const float* mask, int S, int A, int C,
                       bool bulk, const Bufs& r, unsigned (&ph)[2], float* alpha, bf16* out0,
                       bf16* out1) {
  constexpr int kW = kT / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lda = pad8(A), ldc = pad8(C);
  // the mask's flags, loaded by every thread while the caller's loads of dp
  // are in flight (no thread reads the scores after the last row's final
  // barrier)
  for (int s = tid; s < S; s += kT) r.sc[s] = mask[s] > 0.f ? 1.f : 0.f;
  fence_async_smem();  // this thread's generic writes to the stage, before bulk copies into it
  __syncthreads();     // the stage and the list are free, the flags and dp in place
  if (warp == 0) {
    int n = list_flagged(r.sc, S, r.idx);
    if (n == 0)
      for (int s = lane; s < S; s += 32) r.idx[s] = s;
    if (lane == 0) *r.count = n;
  }
  __syncthreads();
  const int nv = *r.count;
  const bool scores = nv > 0;
  const int n = scores ? nv : S;
  const Chunks k = chunks(n, scores, lda, ldc, r.stage_bytes);

  // ctx: a thread owns 8-column groups gi (+ kT·gg) and the positions of
  // class sp
  const int G = ldc / 8;
  const int splits = class_splits<kT>(C);
  const int gi = splits > 1 ? tid % G : tid, sp = splits > 1 ? tid / G : 0;
  const bool active = sp < splits;
  float acc[kMaxG][8];
#pragma unroll
  for (int gg = 0; gg < kMaxG; ++gg)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[gg][e] = 0.f;

  auto softmax = [&] {  // every score is in: the softmax, by warp 0
    if (warp == 0) {
      if (scores) {
        float m = -3.0e38f;
        for (int i = lane; i < n; i += 32) m = fmaxf(m, r.sc[i]);
        m = warp_max(m);
        float sum = 0.f;
        for (int i = lane; i < n; i += 32) {
          const float e = expf(r.sc[i] - m);
          r.sc[i] = e;
          sum += e;
        }
        sum = warp_sum(sum);
        for (int i = lane; i < n; i += 32) {
          const float al = r.sc[i] / sum;
          alpha[r.idx[i]] = al;
          r.sc[i] = round_io<bf16>(al);  // ctx weighs enc by α in the io dtype
        }
      } else {  // every score -1e9: exp(0) at every position, over S
        const float al = 1.f / (float)S;
        for (int i = lane; i < n; i += 32) {
          alpha[i] = al;
          r.sc[i] = round_io<bf16>(al);
        }
      }
    } else if (scores) {  // the masked positions' α, exactly 0
      for (int s = tid - 32; s < S; s += kT - 32)
        if (!(mask[s] > 0.f)) alpha[s] = 0.f;
    }
  };
  auto body = [&](int pass, int i0, int i1, const bf16* rows) {
    if (pass == 0) {  // the scores of positions [i0, i1), a warp each
      for (int i = i0 + warp; i < i1; i += kW) {
        const bf16* row = rows + (size_t)(i - i0) * lda;
        float s = 0.f;
        for (int p8 = lane; p8 < lda / 8; p8 += 32) {
          const uint4 raw = *reinterpret_cast<const uint4*>(row + 8 * p8);
          const bf16* x = reinterpret_cast<const bf16*>(&raw);
          const float* d = r.dp + 8 * p8;
          const float* w = r.v + 8 * p8;
#pragma unroll
          for (int e = 0; e < 8; ++e) s += tanhf(to_f<bf16>(x[e]) + d[e]) * w[e];
        }
        s = warp_sum(s);
        if (lane == 0) r.sc[i] = s;
      }
    } else if (active) {  // ctx over this class's positions of [i0, i1)
      for (int i = i0 + ((sp - i0 % splits) + splits) % splits; i < i1; i += splits) {
        const float w = r.sc[i];
        const bf16* row = rows + (size_t)(i - i0) * ldc;
#pragma unroll
        for (int gg = 0; gg < kMaxG; ++gg) {
          const int grp = gi + gg * kT;
          if (grp >= G) break;
          const uint4 raw = *reinterpret_cast<const uint4*>(row + 8 * grp);
          const bf16* x = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[gg][e] += w * to_f<bf16>(x[e]);
        }
      }
    }
  };
  stream<kT>(k, n, r.idx, ep, A, enc, C, bulk, r, ph, body, softmax);

  // the classes' sums, in class order, through the stage (free now)
  add_classes<kT, kMaxG>(acc, C, reinterpret_cast<float*>(r.stage),
                         [&](int, int grp, const float(&tot)[8]) {
    const int c0 = 8 * grp;
    if (bulk) {  // C is a multiple of 8: 16-byte stores
      uint4 o;
      uint32_t* ow = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
      for (int e = 0; e < 4; ++e) ow[e] = pack_bf16x2(tot[2 * e], tot[2 * e + 1]);
      *reinterpret_cast<uint4*>(out0 + c0) = o;
      if (out1) *reinterpret_cast<uint4*>(out1 + c0) = o;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (c0 + e >= C) break;
        const bf16 o = from_f<bf16>(tot[e]);
        out0[c0 + e] = o;
        if (out1) out1[c0 + e] = o;
      }
    }
  });
}

// The backward of one row on one rank of a cluster of `ranks` CTAs, each
// calling it with the same row. Called by every thread of a kT-thread CTA;
// kG: the 8-column groups of ddp a thread at most (A up to 8·kG·kT). ep
// [S, A], enc [S, C], mask and alpha [S] are the row's (none written in this
// launch). The caller has set r.dp, r.v (dp and v) and dctx_s (the row's
// dctx in f32, zero past C), each thread's stores before any barrier, and
// passes `live_dctx`, whether any dctx value this thread stored is nonzero.
// Outputs: ddp [A] bf16 (rank 0 writes it) and dsc [S] f32 (each rank its
// range; rank 0 the unlisted positions' zeros). Skips a dead row: where
// dctx is all zero, or no position is valid, ddp = 0 and dsc = 0, the plain
// version's answers for finite inputs (nothing of ep or enc is read, so a
// NaN there is not propagated). Otherwise the list holds the positions with
// mask > 0 and any masked position whose α ≠ 0 (whose dα enters Σα·dα; its
// dsc is 0): so Σα·dα over the list is the plain version's sum. kTimed
// (the timed instance): thread 0 records the device's ns clock in clk at 1
// the list, 2 dα in, 3 the Σα·dα exchange, 4 ddp's partial, 5 the end (6 a
// dead row's end).
template <int kT, int kG, bool kTimed>
__device__ void attend_bwd(const bf16* ep, const bf16* enc, const float* mask, const float* alpha,
                           const float* dctx_s, bool live_dctx, int S, int A, int C, bool bulk,
                           const Bufs& r, unsigned (&ph)[2], bf16* ddp, float* dsc,
                           long long* clk) {
  namespace cg = cooperative_groups;
  constexpr int kW = kT / 32;
  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lda = pad8(A), ldc = pad8(C);
  auto stamp = [&](int i) {
    if constexpr (kTimed)
      if (tid == 0) clk[i] = global_ns();
  };
  // flags: 2 a valid position, 1 a masked one with α ≠ 0, 0 unlisted; α
  // kept in shared memory: these loads go out with the caller's of dctx
  bool any_valid = false;
  for (int s = tid; s < S; s += kT) {
    const bool ok = mask[s] > 0.f;
    const float al = alpha[s];
    r.al[s] = al;
    r.sc[s] = ok ? 2.f : (al != 0.f ? 1.f : 0.f);
    any_valid |= ok;
  }
  fence_async_smem();  // this thread's generic writes to the stage, before bulk copies into it
  // every rank of the cluster reads the same row, so all skip it or none
  const bool live = __syncthreads_or(live_dctx) != 0;
  if (!__syncthreads_or(any_valid) || !live) {
    if (rank == 0) {
      for (int s = tid; s < S; s += kT) dsc[s] = 0.f;
      for (int a = tid; a < A; a += kT) ddp[a] = from_f<bf16>(0.f);
    }
    stamp(6);
    return;
  }
  // this CTA runs: the others may push into its shared memory once their
  // wait returns (no rank pushes before; the wait hides behind pass 0)
  cluster_arrive_relaxed();
  if (warp == 0) {
    const int n = list_flagged(r.sc, S, r.idx);
    if (lane == 0) *r.count = n;
  }
  if (rank == 0)
    for (int s = tid; s < S; s += kT)
      if (r.sc[s] == 0.f) dsc[s] = 0.f;
  __syncthreads();  // the list is in
  stamp(1);
  const int n = *r.count, per = cdiv(n, ranks);
  const int j0 = min(n, rank * per), nr = min(n, j0 + per) - j0;  // this rank's range
  const int* idx = r.idx + j0;
  float* dal = r.ds + j0;  // dα, then dsc, of the range's entries
  const Chunks k = chunks(nr, true, ldc, lda, r.stage_bytes);

  // ddp: a thread owns 8-column groups gi (+ kT·gg) of A and the positions
  // of class sp
  const int G = lda / 8;
  const int splits = class_splits<kT>(A);
  const int gi = splits > 1 ? tid % G : tid, sp = splits > 1 ? tid / G : 0;
  const bool active = sp < splits;
  float acc[kG][8];
#pragma unroll
  for (int gg = 0; gg < kG; ++gg)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[gg][e] = 0.f;

  auto softmax_bwd = [&] {  // every dα of the range is in
    stamp(2);
    cluster_wait();  // every rank of the cluster runs
    if (warp == 0) {  // the range's Σα·dα, lanes in list order, then a warp sum
      float p = 0.f;
      for (int j = lane; j < nr; j += 32) p += r.al[idx[j]] * dal[j];
      p = warp_sum(p);
      if (lane < ranks) *cluster.map_shared_rank(r.tots + rank, lane) = p;  // into every rank
    }
    cluster.sync();  // every rank's partial is in every rank's slots
    stamp(3);
    float tot = 0.f;
    for (int q = 0; q < ranks; ++q) tot += r.tots[q];
    for (int j = tid; j < nr; j += kT) {
      const int s = idx[j];
      const float d = r.sc[s] == 2.f ? r.al[s] * (dal[j] - tot) : 0.f;
      dsc[s] = d;
      dal[j] = d;
    }
  };
  auto body = [&](int pass, int i0, int i1, const bf16* rows) {
    if (pass == 0) {  // dα of entries [i0, i1), a warp each
      for (int i = i0 + warp; i < i1; i += kW) {
        const bf16* row = rows + (size_t)(i - i0) * ldc;
        float s = 0.f;
        for (int p8 = lane; p8 < ldc / 8; p8 += 32) {
          const uint4 raw = *reinterpret_cast<const uint4*>(row + 8 * p8);
          const bf16* x = reinterpret_cast<const bf16*>(&raw);
          const float* d = dctx_s + 8 * p8;
#pragma unroll
          for (int e = 0; e < 8; ++e) s += to_f<bf16>(x[e]) * d[e];
        }
        s = warp_sum(s);
        if (lane == 0) dal[i] = s;
      }
    } else if (active) {  // Σ dsc·(1−t²) over this class's entries of [i0, i1)
      for (int i = i0 + ((sp - i0 % splits) + splits) % splits; i < i1; i += splits) {
        const float d = dal[i];
        if (d == 0.f) continue;  // a listed masked position: its term is 0
        const bf16* row = rows + (size_t)(i - i0) * lda;
#pragma unroll
        for (int gg = 0; gg < kG; ++gg) {
          const int grp = gi + gg * kT;
          if (grp >= G) break;
          const uint4 raw = *reinterpret_cast<const uint4*>(row + 8 * grp);
          const bf16* x = reinterpret_cast<const bf16*>(&raw);
          const float* dpg = r.dp + 8 * grp;
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float th = tanhf(to_f<bf16>(x[e]) + dpg[e]);
            acc[gg][e] += d * (1.f - th * th);
          }
        }
      }
    }
  };
  stream<kT>(k, nr, idx, enc, C, ep, A, bulk, r, ph, body, softmax_bwd);
  stamp(4);

  // this rank's partial ddp (before v), its classes added in order through
  // the stage (free now): rank 0 keeps its own in registers, every other
  // rank pushes its into rank 0's receive buffer, slot rank − 1
  float own[kG][8];
  float* to0 = rank == 0 ? nullptr : cluster.map_shared_rank(r.recv, 0) + (size_t)(rank - 1) * lda;
  add_classes<kT, kG>(acc, A, reinterpret_cast<float*>(r.stage),
                      [&](int gg, int grp, const float(&tot)[8]) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      own[gg][e] = tot[e];
      if (to0) to0[8 * grp + e] = tot[e];
    }
  });
  cluster.sync();  // every rank's partial is in rank 0's buffer; the others are done
  if (rank == 0 && active && sp == 0) {  // ddp = io((Σ partials in rank order)·v)
#pragma unroll
    for (int gg = 0; gg < kG; ++gg) {
      const int grp = gi + gg * kT;
      if (grp >= G) break;
      float o[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float sum = own[gg][e];
        for (int q = 1; q < ranks; ++q) sum += r.recv[(size_t)(q - 1) * lda + 8 * grp + e];
        o[e] = sum * r.v[8 * grp + e];
      }
      if (bulk) {  // A is a multiple of 8: a 16-byte store
        uint4 w;
        uint32_t* ww = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
        for (int e = 0; e < 4; ++e) ww[e] = pack_bf16x2(o[2 * e], o[2 * e + 1]);
        *reinterpret_cast<uint4*>(ddp + 8 * grp) = w;
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (8 * grp + e < A) ddp[8 * grp + e] = from_f<bf16>(o[e]);
      }
    }
  }
  stamp(5);
}

}  // namespace attn_row
}  // namespace ptt
