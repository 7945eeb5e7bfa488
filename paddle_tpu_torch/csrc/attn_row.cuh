// One batch row of the Bahdanau attention's forward in bf16, on a whole
// CTA: the row routine csrc/bahdanau_attn.cu's attn_fwd_row_kernel (B5)
// and csrc/decoder_seq.cu's bf16 forward (B9, its phase 2) both call.
//
// For the row b it computes what `_attn_fwd_kernel`
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
// Shared memory the caller lays out (`fixed_bytes`): two mbarriers, the
// list's length, dp and v padded to lda with zeros (f32), the scores [S]
// f32 and the list [S]; and a stage of at least kMinStage bytes, 16-byte
// aligned.

#pragma once

#include "common.cuh"

namespace ptt {
namespace attn_row {

using bf16 = __nv_bfloat16;

constexpr int kMaxSplit = 8;   // position classes of the ctx sums at most
constexpr int kMaxG = 4;       // 8-column groups of ctx a thread at most
constexpr int kMinStage = 8192;  // bytes: the classes' sums at the end, at 256 threads

__host__ __device__ inline int pad8(int n) { return (n + 7) / 8 * 8; }
__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// bytes before the stage: mbarriers (16), the list's length (16), dp and v
// [lda] f32, the scores [S] f32 and the list [S] int, rounded up to 16
__host__ __device__ inline size_t fixed_bytes(int S, int A) {
  return ((size_t)32 + 8 * (size_t)pad8(A) + 8 * (size_t)S + 15) / 16 * 16;
}

// The stage's plan for a row of n listed positions: whole (ep's and enc's
// rows together, enc at byte off1) or two halves (ep's chunks of pa
// positions, then enc's of pc, alternating between the halves at 0 and
// off1); na and nc chunks. `scores` false: a fully masked row, no ep.
struct Chunks {
  int whole, pa, pc, na, nc, off1;
};

__host__ __device__ inline Chunks chunks(int n, bool scores, int lda, int ldc, int stage_bytes) {
  Chunks k{};
  const long long ea = scores ? (long long)n * lda * 2 : 0, ec = (long long)n * ldc * 2;
  if (ea + ec <= stage_bytes) {
    k.whole = 1;
    k.pa = k.pc = n;
    k.off1 = (int)ea;
  } else {
    const int half = stage_bytes / 32 * 16;
    k.pa = half / (lda * 2);
    k.pc = half / (ldc * 2);
    k.off1 = half;
  }
  k.na = scores ? cdiv(n, k.pa) : 0;
  k.nc = cdiv(n, k.pc);
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
  float* sc;      // [S]: the scores, then io(α), by list index
  int* idx;       // [S]: the listed positions
};

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
    int n = 0;
    for (int s0 = 0; s0 < S; s0 += 32) {
      const int s = s0 + lane;
      const bool ok = s < S && r.sc[s] > 0.f;
      const unsigned bal = __ballot_sync(0xffffffffu, ok);
      if (ok) r.idx[n + __popc(bal & ((1u << lane) - 1u))] = s;
      n += __popc(bal);
    }
    if (n == 0)
      for (int s = lane; s < S; s += 32) r.idx[s] = s;
    if (lane == 0) *r.count = n;
  }
  __syncthreads();
  const int nv = *r.count;
  const bool scores = nv > 0;
  const int n = scores ? nv : S;
  const Chunks k = chunks(n, scores, lda, ldc, r.stage_bytes);
  const int items = k.na + k.nc;
  auto span = [&](int it, int& i0, int& i1) {
    const bool isa = it < k.na;
    const int p = isa ? k.pa : k.pc;
    i0 = (isa ? it : it - k.na) * p;
    i1 = min(n, i0 + p);
  };
  auto buf = [&](int it) { return reinterpret_cast<bf16*>(r.stage + ((it & 1) ? k.off1 : 0)); };
  auto issue = [&](int it) {
    if (it >= items) return;
    int i0, i1;
    span(it, i0, i1);
    const bool isa = it < k.na;
    const int pitch = isa ? lda : ldc, width = isa ? A : C;
    const bf16* src = isa ? ep : enc;
    bf16* dst = buf(it);
    if (bulk) {
      if (warp == 0) {
        if (lane == 0) mbar_expect(&r.bar[it & 1], (unsigned)((i1 - i0) * width * 2));
        __syncwarp();
        for (int i = i0 + lane; i < i1; i += 32)
          bulk_load(dst + (size_t)(i - i0) * pitch, src + (size_t)r.idx[i] * width,
                    (unsigned)width * 2, &r.bar[it & 1]);
      }
    } else {
      const int rows = i1 - i0;
      for (int e = tid; e < rows * pitch; e += kT) {
        const int i = e / pitch, col = e - i * pitch;
        dst[e] = col < width ? src[(size_t)r.idx[i0 + i] * width + col] : from_f<bf16>(0.f);
      }
    }
  };

  // ctx: a thread owns 8-column groups gi (+ kT·gg) and the positions of
  // class sp
  const int G = ldc / 8;
  const int splits = G * 2 <= kT ? min(kMaxSplit, kT / G) : 1;
  const int gi = splits > 1 ? tid % G : tid, sp = splits > 1 ? tid / G : 0;
  const bool active = sp < splits;
  float acc[kMaxG][8];
#pragma unroll
  for (int gg = 0; gg < kMaxG; ++gg)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[gg][e] = 0.f;

  issue(0);
  issue(1);
  for (int it = 0; it < items; ++it) {
    if (it == k.na) {  // every score is in: the softmax, by warp 0
      __syncthreads();
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
      __syncthreads();
    }
    if (bulk) {
      mbar_wait(&r.bar[it & 1], ph[it & 1]);
      ph[it & 1] ^= 1u;
    } else {
      __syncthreads();
    }
    int i0, i1;
    span(it, i0, i1);
    const bf16* rows = buf(it);
    if (it < k.na) {  // the scores of positions [i0, i1), a warp each
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
    __syncthreads();  // every thread is done with this chunk's half
    issue(it + 2);
  }

  // the classes' sums, in class order, through the stage (free now)
  float* part = reinterpret_cast<float*>(r.stage);  // [splits - 1][ldc]
  if (active && sp > 0)
#pragma unroll
    for (int e = 0; e < 8; ++e) part[(size_t)(sp - 1) * ldc + 8 * gi + e] = acc[0][e];
  __syncthreads();
  if (!active || sp > 0) return;
#pragma unroll
  for (int gg = 0; gg < kMaxG; ++gg) {
    const int grp = gi + gg * kT;
    if (grp >= G) break;
    float tot[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      tot[e] = acc[gg][e];
      for (int c = 1; c < splits; ++c) tot[e] += part[(size_t)(c - 1) * ldc + 8 * grp + e];
    }
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
  }
}

}  // namespace attn_row
}  // namespace ptt
