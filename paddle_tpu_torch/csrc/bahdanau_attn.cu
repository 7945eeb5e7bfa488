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
// What bounds them: bytes. Each call reads [B,S,A] and [B,S,C] once
// (about 39 MB at B=256, S=50, A=512, C=1024 in bf16) and does a few
// operations per element, far below the card's ~295 operations per byte.
// So none materialises [B,S,A]: tanh(ep+dp) is recomputed where it is
// needed and reduced on the spot.
//   attn_fwd       in bf16 where the rows allow (`attn_fwd_row_kernel`,
//                  attention_kernels.attn_fwd_path): one CTA per batch row,
//                  two CTAs an SM (256 rows at B=256 in one wave on 132
//                  SMs), running csrc/attn_row.cuh's row routine: the row's
//                  valid positions listed, only their rows of ep and enc
//                  staged (by the bulk-copy engine where rows are a
//                  multiple of 16 bytes, else by plain loads), enc in flight
//                  while the scores are computed, S streamed through a ring
//                  where the valid rows pass the 96 KB stage, rows read 16
//                  bytes at a time. In f32, and in bf16 past the routine's
//                  C or shared memory, the first design (`attn_fwd_kernel`):
//                  a warp per source position reduces tanh(ep+dp)·v over A;
//                  one warp takes the masked softmax; the threads split C
//                  for ctx = io(α)·enc.
//   attn_bwd_step  one CTA per batch row: a warp per position reduces
//                  dα = dctx·enc over C; one warp forms dsc = α(dα - Σα·dα);
//                  the threads split A for ddp = v·Σ_S dsc·(1-t²).
//   attn_phase2    one CTA per (batch row, 128 values of A): each thread owns
//                  one a and sums dsc·(1-t²)·v over T in f32 for every s,
//                  writing d(enc_proj) once; its Σ tanh·dsc goes to a
//                  per-(b,a) partial, and the last CTA to finish (an integer
//                  counter, no float atomics) sums the partials over b in a
//                  fixed order, so dv has the same bits on every run.
//
// attn_bwd_step and attn_phase2 are the first design: f32 FMAs on CUDA
// cores, plain loads. Fusing the per-step kernels into the decoder's step
// loop is later work.

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
  // the shared memory a block may opt in to, queried and the kernel's limit
  // raised to it once a device rather than at every launch
  static int opt_in[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!opt_in[dev]) {
    int smem_max = 0;
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    err = set_smem(reinterpret_cast<const void*>(attn_fwd_row_kernel), smem_max);
    if (err != cudaSuccess) return err;
    opt_in[dev] = smem_max;
  }
  if (smem > (size_t)opt_in[dev]) return cudaErrorInvalidValue;
  attn_fwd_row_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(ep), static_cast<const __nv_bfloat16*>(enc),
      static_cast<const __nv_bfloat16*>(dp), static_cast<const __nv_bfloat16*>(v),
      static_cast<const float*>(mask), static_cast<__nv_bfloat16*>(ctx),
      static_cast<float*>(alpha), S, A, C, bulk);
  return cudaGetLastError();
}

extern "C" const char* attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
