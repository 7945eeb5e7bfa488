// The three per-step Bahdanau attention kernels of the NMT decoder's
// training step, for Hopper (sm_90a).
//
// Replace the TPU kernels of paddle_tpu/ops/bahdanau_kernels.py:
//   attn_fwd       `_attn_fwd_kernel` (:170, launched by `_attn_fwd` :257)
//   attn_bwd_step  `_attn_bwd_kernel` (:190, `_attn_bwd_step` :285)
//   attn_phase2    `_attn_phase2_kernel` (:217, `_attn_phase2` :315)
// with ep [B,S,A] = enc @ WaEnc, enc [B,S,C], dp [B,A] = h @ WaDec and v [A]
// in the io dtype (f32 or bf16), the source mask [B,S] f32, and all score,
// softmax and gradient math in f32.
//
// What bounds them: bytes, and for attn_phase2 its tanh. Each step's call
// reads at most [B,S,A] and [B,S,C] once (about 39 MB at B=256, S=50,
// A=512, C=1024 in bf16) and does a few operations per element, far below
// the card's ~295 operations per byte. So none materialises [B,S,A]:
// tanh(ep+dp) is recomputed where it is needed and reduced on the spot.
//   attn_fwd       in bf16 where the rows allow (`attn_fwd_row_kernel`,
//                  attention_kernels.attn_fwd_path): one CTA per batch row,
//                  two CTAs an SM, running csrc/attn_row.cuh's `attend`:
//                  the row's valid positions listed, only their rows of ep
//                  and enc staged (by the bulk-copy engine where rows are a
//                  multiple of 16 bytes, else by plain loads), enc in flight
//                  while the scores are computed, S streamed through a ring
//                  where the valid rows pass the 96 KB stage, rows read 16
//                  bytes at a time.
//   attn_bwd_step  in bf16 where the rows allow (`attn_bwd_row_kernel`,
//                  attention_kernels.attn_bwd_path): a thread-block cluster
//                  of attention_kernels.attn_bwd_cluster(S) CTAs a batch
//                  row (2 at S=50), four CTAs an SM (512 CTAs in one wave
//                  at B=256), running attn_row.cuh's `attend_bwd`. A dead
//                  row (dctx all zero: a target step past the row's length;
//                  or no valid position) writes ddp = dsc = 0 and reads no
//                  ep or enc: in the backward's walk, newest step first,
//                  most rows of the late steps are dead. A live row's list
//                  (its valid positions, and any masked one with α ≠ 0) is
//                  cut into the ranks' ranges; each rank stages its range's
//                  enc rows (dα) and ep rows (in flight during dα) as the
//                  forward stages its rows (whole up to 15 positions in its
//                  45 KB stage, else streamed), pushes its partial Σα·dα
//                  into every rank's shared memory, writes dsc for its
//                  range, and sums a partial ddp by position class, pushed
//                  into rank 0's; rank 0 adds the partials in rank order.
//                  Its time is the chain of each live CTA (loads, staging,
//                  two cluster barriers), not its bytes: a timed instance
//                  (attention_kernels.attn_bwd_step_phase_us) splits it.
//   attn_phase2    `attn_dep_kernel<T, newest>`, in both io dtypes and
//                  for every shape up to 16384 source positions, and for
//                  the whole-sequence backward's d(enc_proj)/dv pass
//                  (decoder_seq_dep, newest step first): dep[b,s,a] =
//                  io(Σ_t (dsc·(1−th²))·v) summed by one thread in the plain
//                  version's order over t, each op rounded as the plain
//                  version's (no FMA), so dep differs from it only where
//                  tanhf differs from torch.tanh. A term with dsc = 0 adds
//                  nothing and is skipped: each CTA takes one row, a block
//                  of 16 of its positions (the positions with a nonzero dsc
//                  at some step listed first, so a row of 50 valid
//                  positions spreads over four CTAs) and 256 columns of A,
//                  two a thread (read as pairs), ep for its positions in
//                  registers; it walks the steps in chunks of 32, lists the
//                  chunk's steps with a nonzero dsc at one of its positions,
//                  stages their dsc compactly and its columns of dp_seq
//                  (each read once a block, not once a position), and skips
//                  a zero dsc (uniform over the CTA: dsc depends on t, b, s
//                  only). dv: each CTA's Σ th·dsc partial per column, then
//                  `attn_dv_kernel` adds the (row, block) partials in a
//                  fixed order: the same bits on every run. The tanh is
//                  the cost (about 118 M nonzero terms on the main path),
//                  kept as tanhf: tanh.approx's 2^-11 would not hold the
//                  plain version's order.
// In f32, and in bf16 past the row routines' C or shared memory, attn_fwd
// and attn_bwd_step keep their first designs (`attn_fwd_kernel`,
// `attn_bwd_step_kernel`: a warp per position over all S, f32 FMAs on
// CUDA cores, plain loads). attn_phase2's first design
// (`attn_phase2_kernel`: a thread per (row, a) over every (t, s)) is no
// wrapper's route: chip_smoke.py launches it, as the other two, beside the
// new design. Fusing the per-step kernels into the decoder's step loop is
// later work.

#include "attn_row.cuh"
#include "common.cuh"

namespace {

using namespace ptt;

constexpr int kPhase2A = 128;  // values of A per phase-2 CTA
constexpr float kNeg = -1e9f;  // the masked score, as the TPU kernel's

// smem: dp [A] f32, v [A] f32, scores then alpha [S] f32
template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const T* __restrict__ ep, const T* __restrict__ enc, const T* __restrict__ dp,
                const T* __restrict__ v, const float* __restrict__ mask, T* __restrict__ ctx,
                float* __restrict__ alpha, int S, int A, int C) {
  extern __shared__ float sm[];
  float* dp_sh = sm;
  float* v_sh = dp_sh + A;
  float* sc = v_sh + A;
  const int b = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int a = threadIdx.x; a < A; a += blockDim.x) {
    dp_sh[a] = to_f<T>(dp[(size_t)b * A + a]);
    v_sh[a] = to_f<T>(v[a]);
  }
  __syncthreads();
  for (int s = warp; s < S; s += kWarps) {
    const T* row = ep + ((size_t)b * S + s) * A;
    float acc = 0.f;
    for (int a = lane; a < A; a += 32) acc += tanhf(to_f<T>(row[a]) + dp_sh[a]) * v_sh[a];
    acc = warp_sum(acc);
    if (lane == 0) sc[s] = mask[(size_t)b * S + s] > 0.f ? acc : kNeg;
  }
  __syncthreads();
  if (warp == 0) {
    float m = -3.0e38f;  // below every score, masked ones included
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
      alpha[(size_t)b * S + s] = al;
      sc[s] = to_f<T>(from_f<T>(al));  // ctx weighs enc by α in the io dtype
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const T* col = enc + (size_t)b * S * C + c;
    float acc = 0.f;
    for (int s = 0; s < S; ++s) acc += sc[s] * to_f<T>(col[(size_t)s * C]);
    ctx[(size_t)b * C + c] = from_f<T>(acc);
  }
}

// The bf16 forward on staged rows: one CTA a row, attn_row::attend. smem:
// attn_row::fixed_bytes, then the stage.
constexpr int kRowStage = 96 * 1024;  // two CTAs an SM: 2 x (96 KB + the rest) of its 228 KB

__global__ void __launch_bounds__(kThreads, 2)
attn_fwd_row_kernel(const __nv_bfloat16* __restrict__ ep, const __nv_bfloat16* __restrict__ enc,
                    const __nv_bfloat16* __restrict__ dp, const __nv_bfloat16* __restrict__ v,
                    const float* __restrict__ mask, __nv_bfloat16* __restrict__ ctx,
                    float* __restrict__ alpha, int S, int A, int C, int bulk) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x, lda = attn_row::pad8(A);
  attn_row::Bufs r;
  r.bar = reinterpret_cast<uint64_t*>(smem_raw);
  r.count = reinterpret_cast<int*>(smem_raw + 16);
  r.dp = reinterpret_cast<float*>(smem_raw + 32);
  r.v = r.dp + lda;
  r.sc = r.v + lda;
  r.idx = reinterpret_cast<int*>(r.sc + S);
  r.stage = smem_raw + attn_row::fixed_bytes(S, A);
  r.stage_bytes = kRowStage;
  for (int a = threadIdx.x; a < lda; a += kThreads) {
    r.dp[a] = a < A ? to_f<bf16>(dp[(size_t)b * A + a]) : 0.f;
    r.v[a] = a < A ? to_f<bf16>(v[a]) : 0.f;
  }
  if (threadIdx.x == 0) {
    mbar_init(&r.bar[0], 1);
    mbar_init(&r.bar[1], 1);
    fence_mbar_init();
  }
  unsigned ph[2] = {0u, 0u};
  attn_row::attend<kThreads>(ep + (size_t)b * S * A, enc + (size_t)b * S * C, mask + (size_t)b * S,
                             S, A, C, bulk != 0, r, ph, alpha + (size_t)b * S,
                             ctx + (size_t)b * C, nullptr);
}

// smem: dctx [C], dp [A], v [A], dalpha then dsc [S], all f32
template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_bwd_step_kernel(const T* __restrict__ ep, const T* __restrict__ enc,
                     const T* __restrict__ dp, const T* __restrict__ v,
                     const float* __restrict__ mask, const T* __restrict__ dctx,
                     const float* __restrict__ alpha, T* __restrict__ ddp,
                     float* __restrict__ dsc, int S, int A, int C) {
  extern __shared__ float sm[];
  float* dctx_sh = sm;
  float* dp_sh = dctx_sh + C;
  float* v_sh = dp_sh + A;
  float* ds = v_sh + A;
  const int b = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c = threadIdx.x; c < C; c += blockDim.x) dctx_sh[c] = to_f<T>(dctx[(size_t)b * C + c]);
  for (int a = threadIdx.x; a < A; a += blockDim.x) {
    dp_sh[a] = to_f<T>(dp[(size_t)b * A + a]);
    v_sh[a] = to_f<T>(v[a]);
  }
  __syncthreads();
  for (int s = warp; s < S; s += kWarps) {
    const T* row = enc + ((size_t)b * S + s) * C;
    float acc = 0.f;
    for (int c = lane; c < C; c += 32) acc += dctx_sh[c] * to_f<T>(row[c]);
    acc = warp_sum(acc);
    if (lane == 0) ds[s] = acc;
  }
  __syncthreads();
  if (warp == 0) {
    const float* al = alpha + (size_t)b * S;
    float tot = 0.f;
    for (int s = lane; s < S; s += 32) tot += al[s] * ds[s];
    tot = warp_sum(tot);
    for (int s = lane; s < S; s += 32) {
      const float d = mask[(size_t)b * S + s] > 0.f ? al[s] * (ds[s] - tot) : 0.f;
      ds[s] = d;
      dsc[(size_t)b * S + s] = d;
    }
  }
  __syncthreads();
  for (int a = threadIdx.x; a < A; a += blockDim.x) {
    const T* col = ep + (size_t)b * S * A + a;
    float acc = 0.f;
    for (int s = 0; s < S; ++s) {
      const float th = tanhf(to_f<T>(col[(size_t)s * A]) + dp_sh[a]);
      acc += ds[s] * (1.f - th * th);
    }
    ddp[(size_t)b * A + a] = from_f<T>(acc * v_sh[a]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kPhase2A)
attn_phase2_kernel(const T* __restrict__ ep, const T* __restrict__ dp_seq,
                   const float* __restrict__ dsc_seq, const T* __restrict__ v,
                   T* __restrict__ dep, float* __restrict__ dv, float* dv_part,
                   unsigned int* done, int n_steps, int B, int S, int A) {
  __shared__ bool last;
  const int b = blockIdx.x, a = blockIdx.y * kPhase2A + threadIdx.x;
  if (a < A) {
    const float vv = to_f<T>(v[a]);
    float dvp = 0.f;
    for (int s = 0; s < S; ++s) {
      const float e = to_f<T>(ep[((size_t)b * S + s) * A + a]);
      float acc = 0.f;
      for (int t = 0; t < n_steps; ++t) {
        const size_t tb = (size_t)t * B + b;
        const float d = dsc_seq[tb * S + s];
        const float th = tanhf(e + to_f<T>(dp_seq[tb * A + a]));
        acc += d * (1.f - th * th) * vv;
        dvp += th * d;
      }
      dep[((size_t)b * S + s) * A + a] = from_f<T>(acc);
    }
    dv_part[(size_t)b * A + a] = dvp;
  }
  // the last CTA to finish sums the partials over b, in order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(done, 1u) == gridDim.x * gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int aa = threadIdx.x; aa < A; aa += blockDim.x) {
    float sum = 0.f;
    for (int bb = 0; bb < B; ++bb) sum += __ldcg(dv_part + (size_t)bb * A + aa);
    dv[aa] = sum;
  }
}

// The bf16 backward on staged rows: a cluster of `ranks` CTAs a row (grid
// B·ranks along x), attn_row::attend_bwd on each; kG groups of 8 columns of
// ddp a thread at most. smem: attn_row::bwd_fixed_bytes, then the stage of
// kBwdStage bytes: at one group (A up to 2048) four CTAs an SM fit (4 x
// (45 KB + 11 KB at the main path's widths) of its 228 KB, at most 64
// registers a thread), so the 512 CTAs of B = 256 rows on 2 ranks run in
// one wave on 132 SMs. A rank's range of up to 15 positions is staged
// whole; a longer one streams through the stage's halves. kTimed (the
// timed instance): clk holds each CTA's 8 clock slots (attend_bwd's, and 0
// at its start); the untimed instance never reads it.
constexpr int kBwdStage = 45 * 1024;

template <int kG, bool kTimed>
__global__ void __launch_bounds__(kThreads, kG == 1 ? 4 : 2)
attn_bwd_row_kernel(const __nv_bfloat16* __restrict__ ep, const __nv_bfloat16* __restrict__ enc,
                    const __nv_bfloat16* __restrict__ dp, const __nv_bfloat16* __restrict__ v,
                    const float* __restrict__ mask, const __nv_bfloat16* __restrict__ dctx,
                    const float* __restrict__ alpha, __nv_bfloat16* __restrict__ ddp,
                    float* __restrict__ dsc, int S, int A, int C, int ranks, int bulk,
                    long long* __restrict__ clk) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if constexpr (kTimed) {
    clk += (size_t)blockIdx.x * 8;
    if (threadIdx.x == 0) clk[0] = global_ns();
  }
  const int b = blockIdx.x / ranks, lda = attn_row::pad8(A), ldc = attn_row::pad8(C);
  attn_row::Bufs r;
  r.bar = reinterpret_cast<uint64_t*>(smem_raw);
  r.count = reinterpret_cast<int*>(smem_raw + 16);
  r.dp = reinterpret_cast<float*>(smem_raw + 32);
  r.v = r.dp + lda;
  r.sc = r.v + lda;
  r.idx = reinterpret_cast<int*>(r.sc + S);
  float* dctx_s = reinterpret_cast<float*>(smem_raw + attn_row::fixed_bytes(S, A));
  r.al = dctx_s + ldc;
  r.ds = r.al + S;
  r.tots = r.ds + S;
  r.recv = r.tots + attn_row::kMaxRanks;
  r.stage = smem_raw + attn_row::bwd_fixed_bytes(S, A, C, ranks);
  r.stage_bytes = kBwdStage;
  // dctx, dp and v into shared memory; no barrier until attend_bwd's, after
  // its loads of the mask and α are out too
  bool live = false;  // any nonzero (or NaN) dctx
  for (int c = threadIdx.x; c < ldc; c += kThreads) {
    const float x = c < C ? to_f<bf16>(dctx[(size_t)b * C + c]) : 0.f;
    dctx_s[c] = x;
    live |= x != 0.f;
  }
  for (int a = threadIdx.x; a < lda; a += kThreads) {
    r.dp[a] = a < A ? to_f<bf16>(dp[(size_t)b * A + a]) : 0.f;
    r.v[a] = a < A ? to_f<bf16>(v[a]) : 0.f;
  }
  if (threadIdx.x == 0) {
    mbar_init(&r.bar[0], 1);
    mbar_init(&r.bar[1], 1);
    fence_mbar_init();
  }
  unsigned ph[2] = {0u, 0u};
  attn_row::attend_bwd<kThreads, kG, kTimed>(
      ep + (size_t)b * S * A, enc + (size_t)b * S * C, mask + (size_t)b * S,
      alpha + (size_t)b * S, dctx_s, live, S, A, C, bulk != 0, r, ph, ddp + (size_t)b * A,
      dsc + (size_t)b * S, clk);
}

// attn_dep_kernel's walk: a CTA's threads (two halves of kDepPairs), its
// columns of A (two a thread), its listed positions (kDepHalf a half), and
// the steps a chunk (a warp's lanes); attn_dv_kernel's columns a CTA and
// its ranges of partial rows
constexpr int kDepPairs = 128;
constexpr int kDepThreads = 2 * kDepPairs;
constexpr int kDepTile = 2 * kDepPairs;
constexpr int kDepPos = 16;
constexpr int kDepHalf = kDepPos / 2;
constexpr int kDepSteps = 32;
constexpr int kDvCols = 32, kDvRanges = 8;

// two neighbouring values of the io dtype at p as f32, by one load where
// `pair` (p aligned to two values), else one by one; x1 only where has1
template <typename T>
__device__ __forceinline__ void load2(const T* p, bool pair, bool has0, bool has1, float& x0,
                                      float& x1) {
  if (pair && has1) {
    if constexpr (sizeof(T) == 2) {
      const __nv_bfloat162 q = *reinterpret_cast<const __nv_bfloat162*>(p);
      x0 = __low2float(q);
      x1 = __high2float(q);
    } else {
      const float2 q = *reinterpret_cast<const float2*>(p);
      x0 = q.x;
      x1 = q.y;
    }
    return;
  }
  x0 = has0 ? to_f<T>(p[0]) : 0.f;
  x1 = has1 ? to_f<T>(p[1]) : 0.f;
}

template <typename T>
__device__ __forceinline__ void store2(T* p, bool pair, bool has0, bool has1, float x0, float x1) {
  if (pair && has1) {
    if constexpr (sizeof(T) == 2) {
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
    } else {
      *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
    }
    return;
  }
  if (has0) p[0] = from_f<T>(x0);
  if (has1) p[1] = from_f<T>(x1);
}

// grid B·blocks·tiles along x (blocks = ceil(S / kDepPos), tiles =
// ceil(A / kDepTile)), the tile fastest, then the block, then the row, so a
// row's CTAs are neighbours. dsc_seq [T,B,S] f32; dv_part [B, blocks, A]
// f32 out. smem: the row's order of positions
// [S] and their flags [S] (ints). kNewest: t from T-1 down to 0
// (decoder_seq_dep_plain's order), else up (attn_phase2_plain's). Thread
// (h, p) owns columns a0, a0 + 1 (pair p) of positions h·kDepHalf + j of
// the block: half the block's positions a thread keeps its registers few
// (ep's and the sums' 32; 64 in all, four CTAs an SM), and the warps many,
// to hide tanhf's latency.
template <typename T, bool kNewest>
__global__ void __launch_bounds__(kDepThreads, 4)
attn_dep_kernel(const T* __restrict__ ep, const T* __restrict__ dp_seq,
                const float* __restrict__ dsc_seq, const T* __restrict__ v, T* __restrict__ dep,
                float* __restrict__ dv_part, int n_steps, int B, int S, int A, int pair) {
  extern __shared__ int order[];
  int* live = order + S;
  __shared__ float dsc_raw[kDepSteps][kDepPos];
  __shared__ float dsc_c[kDepSteps][kDepPos];    // the chunk's listed steps, compact
  __shared__ float2 dp_s[kDepSteps][kDepPairs];  // their dp at the CTA's columns
  __shared__ float2 dv_s[kDepPairs];              // half 1's dv, added after half 0's
  __shared__ int step_s[kDepSteps], full_s[kDepSteps], pos_s[kDepPos], n_live_s, nk_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, T_ = n_steps;
  const int pi = tid % kDepPairs, h = tid / kDepPairs;
  const int tiles = attn_row::cdiv(A, kDepTile), blocks = attn_row::cdiv(S, kDepPos);
  const int tile = blockIdx.x % tiles, blk = blockIdx.x / tiles % blocks;
  const int b = blockIdx.x / tiles / blocks, p0 = blk * kDepPos, a0 = tile * kDepTile + 2 * pi;
  const bool has0 = a0 < A, has1 = a0 + 1 < A, pr = pair != 0;
  // a position is live where some step's dsc is nonzero
  for (int s = tid; s < S; s += kDepThreads) {
    bool any = false;
    for (int t = 0; t < T_; ++t) any |= dsc_seq[((size_t)t * B + b) * S + s] != 0.f;
    live[s] = any;
  }
  __syncthreads();
  if (warp == 0) {  // the row's order: the live positions, then the rest, each ascending
    int n = 0, nl = 0;
    for (int pass = 0; pass < 2; ++pass) {
      for (int s0 = 0; s0 < S; s0 += 32) {
        const int s = s0 + lane;
        const bool ok = s < S && (live[s] != 0) == (pass == 0);
        const unsigned bal = __ballot_sync(0xffffffffu, ok);
        if (ok) order[n + __popc(bal & ((1u << lane) - 1u))] = s;
        n += __popc(bal);
      }
      if (pass == 0) nl = n;
    }
    if (lane == 0) n_live_s = nl;
  }
  __syncthreads();
  const int np = min(kDepPos, S - p0);            // the block's positions
  const int nl = max(0, min(np, n_live_s - p0));  // of them live: the first nl
  const int nlh = max(0, min(kDepHalf, nl - h * kDepHalf));  // this half's live ones
  if (tid < kDepPos) pos_s[tid] = tid < np ? order[p0 + tid] : 0;
  __syncthreads();
  float v0, v1, dv0 = 0.f, dv1 = 0.f, e[kDepHalf][2], acc[kDepHalf][2];
  load2<T>(v + a0, false, has0, has1, v0, v1);
#pragma unroll
  for (int j = 0; j < kDepHalf; ++j) {
    acc[j][0] = acc[j][1] = e[j][0] = e[j][1] = 0.f;
    if (j < nlh)
      load2<T>(ep + ((size_t)b * S + pos_s[h * kDepHalf + j]) * A + a0, pr, has0, has1, e[j][0],
               e[j][1]);
  }
  auto term = [&](int j, float d, float2 d2) {  // (dsc·(1−th²))·v, op by op
    const float th0 = tanhf(e[j][0] + d2.x), th1 = tanhf(e[j][1] + d2.y);
    acc[j][0] = add(acc[j][0], mul(mul(d, sub(1.f, mul(th0, th0))), v0));
    acc[j][1] = add(acc[j][1], mul(mul(d, sub(1.f, mul(th1, th1))), v1));
    dv0 = add(dv0, mul(th0, d));
    dv1 = add(dv1, mul(th1, d));
  };
  for (int u0 = 0; nl > 0 && u0 < T_; u0 += kDepSteps) {  // lane l visits step u0 + l
    for (int k = tid; k < kDepSteps * kDepPos; k += kDepThreads) {
      const int l = k / kDepPos, i = k - l * kDepPos, u = u0 + l;
      const int t = kNewest ? T_ - 1 - u : u;
      dsc_raw[l][i] = u < T_ && i < nl ? dsc_seq[((size_t)t * B + b) * S + pos_s[i]] : 0.f;
    }
    __syncthreads();
    if (warp == 0) {  // the chunk's steps with a nonzero dsc at a block position, in order
      bool any = false, all0 = true, all1 = true;
#pragma unroll
      for (int i = 0; i < kDepPos; ++i) {
        const bool nz = dsc_raw[lane][i] != 0.f;
        any |= nz;
        if (i < kDepHalf) all0 &= nz;
        else all1 &= nz;
      }
      const unsigned bal = __ballot_sync(0xffffffffu, any);
      if (any) {
        const int k = __popc(bal & ((1u << lane) - 1u)), u = u0 + lane;
        step_s[k] = kNewest ? T_ - 1 - u : u;
        full_s[k] = (all0 ? 1 : 0) | (all1 ? 2 : 0);  // a half's every term nonzero
#pragma unroll
        for (int i = 0; i < kDepPos; ++i) dsc_c[k][i] = dsc_raw[lane][i];
      }
      if (lane == 0) nk_s = __popc(bal);
    }
    __syncthreads();
    const int nk = nk_s;
    for (int k = h; k < nk; k += 2) {  // the CTA's columns of dp at those steps
      float x0, x1;
      load2<T>(dp_seq + ((size_t)step_s[k] * B + b) * A + a0, pr, has0, has1, x0, x1);
      dp_s[k][pi] = make_float2(x0, x1);
    }
    __syncthreads();
    for (int k = 0; k < nk; ++k) {
      const float2 d2 = dp_s[k][pi];
      const float* dk = dsc_c[k] + h * kDepHalf;
      if (nlh == kDepHalf && (full_s[k] >> h & 1)) {  // no term to skip: no branch between positions
#pragma unroll
        for (int j = 0; j < kDepHalf; ++j) term(j, dk[j], d2);
      } else {
#pragma unroll
        for (int j = 0; j < kDepHalf; ++j) {
          if (j >= nlh) break;
          const float d = dk[j];
          if (d == 0.f) continue;  // the same for the whole warp: dsc depends on (t, b, s)
          term(j, d, d2);
        }
      }
    }
    __syncthreads();  // every thread is done with the chunk's dsc and dp
  }
  const int nph = max(0, min(kDepHalf, np - h * kDepHalf));  // this half's positions
#pragma unroll
  for (int j = 0; j < kDepHalf; ++j) {
    if (j >= nph) break;
    store2<T>(dep + ((size_t)b * S + pos_s[h * kDepHalf + j]) * A + a0, pr, has0, has1,
              acc[j][0], acc[j][1]);
  }
  if (h == 1) dv_s[pi] = make_float2(dv0, dv1);
  __syncthreads();
  if (h == 1) return;
  float* part = dv_part + ((size_t)b * blocks + blk) * A + a0;
  if (has0) part[0] = add(dv0, dv_s[pi].x);
  if (has1) part[1] = add(dv1, dv_s[pi].y);
}

// dv[a] = Σ over the rows of part [rows, A] (a row a (batch row, block)
// pair, blocks within a batch row, batch rows in order): kDvRanges
// contiguous ranges of rows each summed in order, then the ranges in order;
// grid ceil(A / kDvCols)
__global__ void __launch_bounds__(kDvCols* kDvRanges)
attn_dv_kernel(const float* __restrict__ part, float* __restrict__ dv, int rows, int A) {
  __shared__ float sums[kDvRanges][kDvCols];
  const int c = threadIdx.x % kDvCols, j = threadIdx.x / kDvCols, a = blockIdx.x * kDvCols + c;
  const int per = (rows + kDvRanges - 1) / kDvRanges, r0 = min(rows, j * per);
  const int r1 = min(rows, r0 + per);
  float s = 0.f;
  if (a < A)
    for (int r = r0; r < r1; ++r) s = add(s, part[(size_t)r * A + a]);
  sums[j][c] = s;
  __syncthreads();
  if (j > 0 || a >= A) return;
  float tot = sums[0][c];
  for (int q = 1; q < kDvRanges; ++q) tot = add(tot, sums[q][c]);
  dv[a] = tot;
}

cudaError_t set_smem(const void* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T>
cudaError_t fwd(const void* ep, const void* enc, const void* dp, const void* v,
                const float* mask, void* ctx, float* alpha, int B, int S, int A, int C,
                cudaStream_t st) {
  const size_t smem = (2 * (size_t)A + S) * sizeof(float);
  cudaError_t err = set_smem(reinterpret_cast<const void*>(attn_fwd_kernel<T>), smem);
  if (err != cudaSuccess) return err;
  attn_fwd_kernel<T><<<B, kThreads, smem, st>>>(
      static_cast<const T*>(ep), static_cast<const T*>(enc), static_cast<const T*>(dp),
      static_cast<const T*>(v), mask, static_cast<T*>(ctx), alpha, S, A, C);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_step(const void* ep, const void* enc, const void* dp, const void* v,
                     const float* mask, const void* dctx, const float* alpha, void* ddp,
                     float* dsc, int B, int S, int A, int C, cudaStream_t st) {
  const size_t smem = ((size_t)C + 2 * (size_t)A + S) * sizeof(float);
  cudaError_t err = set_smem(reinterpret_cast<const void*>(attn_bwd_step_kernel<T>), smem);
  if (err != cudaSuccess) return err;
  attn_bwd_step_kernel<T><<<B, kThreads, smem, st>>>(
      static_cast<const T*>(ep), static_cast<const T*>(enc), static_cast<const T*>(dp),
      static_cast<const T*>(v), mask, static_cast<const T*>(dctx), alpha,
      static_cast<T*>(ddp), dsc, S, A, C);
  return cudaGetLastError();
}

template <typename T>
cudaError_t phase2(const void* ep, const void* dp_seq, const float* dsc_seq, const void* v,
                   void* dep, float* dv, float* dv_part, unsigned int* done, int n_steps,
                   int B, int S, int A, cudaStream_t st) {
  const dim3 grid(B, (A + kPhase2A - 1) / kPhase2A);
  attn_phase2_kernel<T><<<grid, kPhase2A, 0, st>>>(
      static_cast<const T*>(ep), static_cast<const T*>(dp_seq), dsc_seq,
      static_cast<const T*>(v), static_cast<T*>(dep), dv, dv_part, done, n_steps, B, S, A);
  return cudaGetLastError();
}

bool bad_shape(int B, int S, int A, int C) { return B < 1 || S < 1 || A < 1 || C < 1; }

constexpr int kDepMaxS = 16384;  // the walk's order and flags of a row: 128 KB

template <typename T, bool kNewest>
cudaError_t dep_walk(const void* ep, const void* dp_seq, const float* dsc_seq, const void* v,
                     void* dep, float* dv, float* dv_part, int n_steps, int B, int S, int A,
                     cudaStream_t st) {
  static int opt_in[64];
  int smem_max = 0;
  cudaError_t err = smem_opt_in(reinterpret_cast<const void*>(attn_dep_kernel<T, kNewest>),
                                opt_in, &smem_max);
  if (err != cudaSuccess) return err;
  const size_t smem = 8 * (size_t)S;
  if (smem > (size_t)smem_max) return cudaErrorInvalidValue;
  // pairs of values by one load where A is even and every base is aligned
  const uintptr_t mis = reinterpret_cast<uintptr_t>(ep) | reinterpret_cast<uintptr_t>(dp_seq) |
                        reinterpret_cast<uintptr_t>(dep);
  const int pair = A % 2 == 0 && mis % (2 * sizeof(T)) == 0;
  const int blocks = attn_row::cdiv(S, kDepPos);
  const long long grid = (long long)B * blocks * attn_row::cdiv(A, kDepTile);
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  attn_dep_kernel<T, kNewest><<<(unsigned)grid, kDepThreads, smem, st>>>(
      static_cast<const T*>(ep), static_cast<const T*>(dp_seq), dsc_seq,
      static_cast<const T*>(v), static_cast<T*>(dep), dv_part, n_steps, B, S, A, pair);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_dv_kernel<<<attn_row::cdiv(A, kDvCols), kDvCols * kDvRanges, 0, st>>>(dv_part, dv,
                                                                         B * blocks, A);
  return cudaGetLastError();
}

template <int kG, bool kTimed>
cudaError_t bwd_row(const void* ep, const void* enc, const void* dp, const void* v,
                    const void* mask, const void* dctx, const void* alpha, void* ddp, void* dsc,
                    int B, int S, int A, int C, int ranks, int bulk, long long* clk,
                    cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  const size_t smem = attn_row::bwd_fixed_bytes(S, A, C, ranks) + kBwdStage;
  static int opt_in[64];
  int smem_max = 0;
  cudaError_t err =
      smem_opt_in(reinterpret_cast<const void*>(attn_bwd_row_kernel<kG, kTimed>), opt_in,
                  &smem_max);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)smem_max) return cudaErrorInvalidValue;
  err = launch_cluster(attn_bwd_row_kernel<kG, kTimed>, B * ranks, ranks, smem, st,
                       static_cast<const bf16*>(ep), static_cast<const bf16*>(enc),
                       static_cast<const bf16*>(dp), static_cast<const bf16*>(v),
                       static_cast<const float*>(mask), static_cast<const bf16*>(dctx),
                       static_cast<const float*>(alpha), static_cast<bf16*>(ddp),
                       static_cast<float*>(dsc), S, A, C, ranks, bulk, clk);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// ep [B,S,A], enc [B,S,C], dp [B,A], v [A], ctx [B,C]: io dtype (bf16 when
// io_bf16, else f32), contiguous; mask and alpha [B,S] f32. Each returns a
// cudaError_t.
extern "C" int attn_fwd_launch(int io_bf16, const void* ep, const void* enc, const void* dp,
                               const void* v, const void* mask, void* ctx, void* alpha, int B,
                               int S, int A, int C, void* stream) {
  if (bad_shape(B, S, A, C)) return cudaErrorInvalidValue;
  const float* m = static_cast<const float*>(mask);
  float* al = static_cast<float*>(alpha);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (io_bf16) return fwd<__nv_bfloat16>(ep, enc, dp, v, m, ctx, al, B, S, A, C, st);
  return fwd<float>(ep, enc, dp, v, m, ctx, al, B, S, A, C, st);
}

// as attn_fwd_launch, plus dctx [B,C] io dtype, alpha [B,S] f32 in;
// ddp [B,A] io dtype and dsc [B,S] f32 out
extern "C" int attn_bwd_step_launch(int io_bf16, const void* ep, const void* enc,
                                    const void* dp, const void* v, const void* mask,
                                    const void* dctx, const void* alpha, void* ddp, void* dsc,
                                    int B, int S, int A, int C, void* stream) {
  if (bad_shape(B, S, A, C)) return cudaErrorInvalidValue;
  const float* m = static_cast<const float*>(mask);
  const float* al = static_cast<const float*>(alpha);
  float* ds = static_cast<float*>(dsc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (io_bf16)
    return bwd_step<__nv_bfloat16>(ep, enc, dp, v, m, dctx, al, ddp, ds, B, S, A, C, st);
  return bwd_step<float>(ep, enc, dp, v, m, dctx, al, ddp, ds, B, S, A, C, st);
}

// ep [B,S,A], dp_seq [T,B,A], v [A], dep [B,S,A]: io dtype; dsc_seq
// [T,B,S], dv [A] and scratch dv_part [B,A] f32; done: one uint32 set to 0
extern "C" int attn_phase2_launch(int io_bf16, const void* ep, const void* dp_seq,
                                  const void* dsc_seq, const void* v, void* dep, void* dv,
                                  void* dv_part, void* done, int n_steps, int B, int S, int A,
                                  void* stream) {
  if (n_steps < 1 || bad_shape(B, S, A, 1)) return cudaErrorInvalidValue;
  const float* ds = static_cast<const float*>(dsc_seq);
  float* dvp = static_cast<float*>(dv);
  float* part = static_cast<float*>(dv_part);
  unsigned int* d = static_cast<unsigned int*>(done);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (io_bf16)
    return phase2<__nv_bfloat16>(ep, dp_seq, ds, v, dep, dvp, part, d, n_steps, B, S, A, st);
  return phase2<float>(ep, dp_seq, ds, v, dep, dvp, part, d, n_steps, B, S, A, st);
}

// The bf16 forward on staged rows (attn_fwd_row_kernel): ep, enc, dp, v,
// ctx bf16 and mask, alpha f32 as attn_fwd_launch's. bulk: rows by the
// bulk-copy engine, which needs A and C multiples of 8 and ep, enc 16-byte
// aligned (cudaErrorMisalignedAddress otherwise); else plain loads.
// cudaErrorInvalidValue where C passes the routine's 8 columns x kMaxG
// groups a thread, or the stage or shared memory does not take the row.
extern "C" int attn_fwd_row_launch(const void* ep, const void* enc, const void* dp,
                                   const void* v, const void* mask, void* ctx, void* alpha, int B,
                                   int S, int A, int C, int bulk, void* stream) {
  if (bad_shape(B, S, A, C) || C > 8 * attn_row::kMaxG * kThreads ||
      !attn_row::stage_fits(A, C, kRowStage))
    return cudaErrorInvalidValue;
  if (bulk && ((A | C) % 8 != 0 || (reinterpret_cast<uintptr_t>(ep) & 15) ||
               (reinterpret_cast<uintptr_t>(enc) & 15)))
    return cudaErrorMisalignedAddress;
  const size_t smem = attn_row::fixed_bytes(S, A) + kRowStage;
  static int opt_in[64];
  int smem_max = 0;
  cudaError_t err =
      smem_opt_in(reinterpret_cast<const void*>(attn_fwd_row_kernel), opt_in, &smem_max);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)smem_max) return cudaErrorInvalidValue;
  attn_fwd_row_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(ep), static_cast<const __nv_bfloat16*>(enc),
      static_cast<const __nv_bfloat16*>(dp), static_cast<const __nv_bfloat16*>(v),
      static_cast<const float*>(mask), static_cast<__nv_bfloat16*>(ctx),
      static_cast<float*>(alpha), S, A, C, bulk);
  return cudaGetLastError();
}

// The bf16 backward on staged rows (attn_bwd_row_kernel) in clusters of
// `ranks` CTAs a row (1 to 4: attention_kernels.attn_bwd_cluster): ep, enc,
// dp, v, dctx, ddp bf16 and mask, alpha, dsc f32 as attn_bwd_step_launch's.
// bulk: rows by the bulk-copy engine, which needs A and C multiples of 8
// and ep, enc 16-byte aligned (cudaErrorMisalignedAddress otherwise); else
// plain loads. cudaErrorInvalidValue where A passes the routine's 8 columns
// x kMaxG groups a thread, or the stage or shared memory does not take the
// row.
static int bwd_row_check(const void* ep, const void* enc, int B, int S, int A, int C,
                         int ranks, int bulk) {
  if (bad_shape(B, S, A, C) || ranks < 1 || ranks > attn_row::kMaxRanks ||
      A > 8 * attn_row::kMaxG * kThreads || !attn_row::stage_fits(A, C, kBwdStage))
    return cudaErrorInvalidValue;
  if (bulk && ((A | C) % 8 != 0 || (reinterpret_cast<uintptr_t>(ep) & 15) ||
               (reinterpret_cast<uintptr_t>(enc) & 15)))
    return cudaErrorMisalignedAddress;
  return cudaSuccess;
}

extern "C" int attn_bwd_row_launch(const void* ep, const void* enc, const void* dp,
                                   const void* v, const void* mask, const void* dctx,
                                   const void* alpha, void* ddp, void* dsc, int B, int S, int A,
                                   int C, int ranks, int bulk, void* stream) {
  const int bad = bwd_row_check(ep, enc, B, S, A, C, ranks, bulk);
  if (bad) return bad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (A <= 8 * kThreads)  // one group of 8 columns a thread
    return bwd_row<1, false>(ep, enc, dp, v, mask, dctx, alpha, ddp, dsc, B, S, A, C, ranks, bulk,
                             nullptr, st);
  return bwd_row<attn_row::kMaxG, false>(ep, enc, dp, v, mask, dctx, alpha, ddp, dsc, B, S, A, C,
                                         ranks, bulk, nullptr, st);
}

// The same kernel's timed instance, at A up to 8 columns a thread
// (attention_kernels.attn_bwd_step_phase_us): clk [B·ranks, 8] int64.
extern "C" int attn_bwd_row_timed_launch(const void* ep, const void* enc, const void* dp,
                                         const void* v, const void* mask, const void* dctx,
                                         const void* alpha, void* ddp, void* dsc, int B, int S,
                                         int A, int C, int ranks, int bulk, void* clk,
                                         void* stream) {
  const int bad = bwd_row_check(ep, enc, B, S, A, C, ranks, bulk);
  if (bad) return bad;
  if (A > 8 * kThreads) return cudaErrorInvalidValue;
  return bwd_row<1, true>(ep, enc, dp, v, mask, dctx, alpha, ddp, dsc, B, S, A, C, ranks, bulk,
                          static_cast<long long*>(clk), static_cast<cudaStream_t>(stream));
}

// attn_phase2 on the walk over the nonzero terms (attn_dep_kernel, then
// attn_dv_kernel), and the whole-sequence backward's pass on it: ep [B,S,A],
// dp_seq [T,B,A], v [A], dep [B,S,A] in the io dtype; dsc_seq [T,B,S] and dv
// [A] f32; scratch dv_part [B·ceil(S/16), A] f32. newest: t summed from T-1
// down (decoder_seq_dep_plain's order), else up (attn_phase2_plain's).
// cudaErrorInvalidValue past S = 16384 positions (the row's order in shared
// memory) or a grid of 2^31 CTAs.
extern "C" int attn_dep_launch(int io_bf16, int newest, const void* ep, const void* dp_seq,
                               const void* dsc_seq, const void* v, void* dep, void* dv,
                               void* dv_part, int n_steps, int B, int S, int A, void* stream) {
  if (n_steps < 1 || bad_shape(B, S, A, 1) || S > kDepMaxS) return cudaErrorInvalidValue;
  const float* ds = static_cast<const float*>(dsc_seq);
  float *dvp = static_cast<float*>(dv), *part = static_cast<float*>(dv_part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (io_bf16)
    return newest ? dep_walk<__nv_bfloat16, true>(ep, dp_seq, ds, v, dep, dvp, part, n_steps, B,
                                                  S, A, st)
                  : dep_walk<__nv_bfloat16, false>(ep, dp_seq, ds, v, dep, dvp, part, n_steps,
                                                   B, S, A, st);
  return newest ? dep_walk<float, true>(ep, dp_seq, ds, v, dep, dvp, part, n_steps, B, S, A, st)
                : dep_walk<float, false>(ep, dp_seq, ds, v, dep, dvp, part, n_steps, B, S, A, st);
}

extern "C" const char* attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
