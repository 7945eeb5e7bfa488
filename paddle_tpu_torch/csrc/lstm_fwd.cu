// Whole-sequence masked LSTM forward for Hopper (sm_90a), one launch per
// sequence.
//
// Replaces the TPU kernel `_lstm_kernel`, launched by `_lstm_pallas_raw`
// (paddle_tpu/ops/pallas_kernels.py:155-229). Same function, gate order
// [i, f, g, o] in the 4H columns:
//   gates = x_t + h @ W                 f32, the product not rounded
//   i, f, o = sigmoid(.), g = tanh(.)
//   c' = f * c + i * g,  h' = o * tanh(c')
//   masked carry h = m*h' + (1-m)*h, c likewise, both rounded to the io dtype
// with x [T,B,4H] (bias already added), mask [T,B] f32, W [H,4H], io dtype
// f32 or bf16; outputs h_seq, c_seq [T,B,H] (c_seq is the backward's
// residual) and h_T, c_T [B,H]. `reverse` walks t from T-1 down to 0, which
// equals flipping x and the mask in and h_seq out as lstm_fused does.
//
// What bounds it: the T dependent steps. Each step is a [B,H]x[H,4H]
// product that needs all of h from the step before; the bytes (x in, h_seq
// and c_seq out) and the FLOPs are far below what the card could do in
// that time. Each CTA owns HC hidden units and keeps the 4*HC columns of W
// they need (i, f, g, o of each unit) in shared memory for the whole
// launch, so W is read from device memory once (at H = 512 in bf16 W is
// 2 MB: 16 KB a CTA). Unlike the GRU, a unit's new h and c depend only on
// its own four gates, so c never leaves the CTA (shared memory) and one
// grid barrier a step suffices: h is published into one of two small
// global buffers (read with ld.cg, past L1, which is not coherent across
// SMs), and the barrier after step s orders every read of buffer s&1
// before any write to it at step s+1. A cooperative launch guarantees all
// CTAs are resident, so grid.sync() is safe.
//
// Simple first: f32 FMAs on CUDA cores, one warp per batch row with the
// lanes splitting H. Tensor cores, TMA and h staged in shared memory are
// later work.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace ptt;

template <typename T, int HC>
__global__ void __launch_bounds__(kThreads)
lstm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ mask,
                const T* __restrict__ w, T* __restrict__ h_seq, T* __restrict__ c_seq,
                T* __restrict__ h_T, T* __restrict__ c_T, T* hbuf, int n_steps, int B,
                int H, int reverse) {
  cg::grid_group grid = cg::this_grid();
  constexpr int G = 4 * HC;  // this CTA's gate columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* c_sh = reinterpret_cast<float*>(smem_raw);  // [B][HC] io-rounded c
  T* w_sh = reinterpret_cast<T*>(c_sh + (size_t)B * HC);  // [4][HC][H], k fastest

  const int j0 = blockIdx.x * HC;
  const int H4 = 4 * H;
  for (int i = threadIdx.x; i < G * H; i += blockDim.x) {
    const int k = i % H, jj = (i / H) % HC, q = i / (H * HC);
    const int j = j0 + jj;
    w_sh[i] = j < H ? w[(size_t)k * H4 + q * H + j] : from_f<T>(0.f);
  }
  for (int i = threadIdx.x; i < B * HC; i += blockDim.x) c_sh[i] = 0.f;
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int s = 0; s < n_steps; ++s) {
    const int t = reverse ? n_steps - 1 - s : s;
    const T* hp = hbuf + (size_t)(s & 1) * B * H;
    T* hn = hbuf + (size_t)((s + 1) & 1) * B * H;

    for (int b = warp; b < B; b += kWarps) {
      const T* hrow = hp + (size_t)b * H;
      float acc[G];
#pragma unroll
      for (int q = 0; q < G; ++q) acc[q] = 0.f;
      for (int k = lane; k < H; k += 32) {
        const float hv = to_f<T>(__ldcg(hrow + k));
#pragma unroll
        for (int q = 0; q < G; ++q) acc[q] += hv * to_f<T>(w_sh[q * H + k]);
      }
#pragma unroll
      for (int q = 0; q < G; ++q) acc[q] = warp_sum(acc[q]);
      const T* xrow = x + ((size_t)t * B + b) * H4;
      const float m = mask[(size_t)t * B + b];
#pragma unroll
      for (int jj = 0; jj < HC; ++jj) {
        const int j = j0 + jj;
        if (lane == jj && j < H) {
          const float gi = sigmoid_f(to_f<T>(xrow[j]) + acc[jj]);
          const float gf = sigmoid_f(to_f<T>(xrow[H + j]) + acc[HC + jj]);
          const float gg = tanhf(to_f<T>(xrow[2 * H + j]) + acc[2 * HC + jj]);
          const float go = sigmoid_f(to_f<T>(xrow[3 * H + j]) + acc[3 * HC + jj]);
          const float cp = c_sh[b * HC + jj];
          const float hpv = to_f<T>(__ldcg(hrow + j));
          const float c = gf * cp + gi * gg;
          const float h = go * tanhf(c);
          const T hv = from_f<T>(m * h + (1.f - m) * hpv);
          const T cv = from_f<T>(m * c + (1.f - m) * cp);
          c_sh[b * HC + jj] = to_f<T>(cv);
          hn[(size_t)b * H + j] = hv;
          const size_t o = ((size_t)t * B + b) * H + j;
          h_seq[o] = hv;
          c_seq[o] = cv;
          if (s == n_steps - 1) {
            h_T[(size_t)b * H + j] = hv;
            c_T[(size_t)b * H + j] = cv;
          }
        }
      }
    }
    grid.sync();
  }
}

size_t smem_bytes(int B, int H, int hc, size_t item) {
  return (size_t)B * hc * sizeof(float) + (size_t)4 * hc * H * item;
}

template <typename T, int HC>
cudaError_t launch(const void* x, const float* mask, const void* w, void* const* out,
                   void* hbuf, int n_steps, int B, int H, int reverse, int n_sms,
                   cudaStream_t stream) {
  auto kernel = lstm_fwd_kernel<T, HC>;
  const int grid = (H + HC - 1) / HC;
  const size_t smem = smem_bytes(B, H, HC, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm * n_sms < grid) return cudaErrorCooperativeLaunchTooLarge;
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* hs = static_cast<T*>(out[0]);
  T* cs = static_cast<T*>(out[1]);
  T* ht = static_cast<T*>(out[2]);
  T* ct = static_cast<T*>(out[3]);
  T* hb = static_cast<T*>(hbuf);
  void* args[] = {&xp, &mask, &wp, &hs, &cs, &ht, &ct, &hb, &n_steps, &B, &H, &reverse};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(grid),
                                    dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hc(int hc, const void* x, const float* mask, const void* w,
                      void* const* out, void* hbuf, int n_steps, int B, int H, int reverse,
                      int n_sms, cudaStream_t st) {
  switch (hc) {
    case 1: return launch<T, 1>(x, mask, w, out, hbuf, n_steps, B, H, reverse, n_sms, st);
    case 2: return launch<T, 2>(x, mask, w, out, hbuf, n_steps, B, H, reverse, n_sms, st);
    case 4: return launch<T, 4>(x, mask, w, out, hbuf, n_steps, B, H, reverse, n_sms, st);
    case 8: return launch<T, 8>(x, mask, w, out, hbuf, n_steps, B, H, reverse, n_sms, st);
    case 16: return launch<T, 16>(x, mask, w, out, hbuf, n_steps, B, H, reverse, n_sms, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x [T,B,4H], w [H,4H], h_seq, c_seq [T,B,H], h_T, c_T [B,H], hbuf [2,B,H]
// (zeroed): io dtype (bf16 when io_bf16, else f32), contiguous; mask [T,B]
// f32. Returns a cudaError_t: cudaErrorInvalidValue where the shape is out
// of the kernel's range (W's slice must fit one SM's shared memory).
extern "C" int lstm_fwd_launch(int io_bf16, const void* x, const void* mask, const void* w,
                               void* h_seq, void* c_seq, void* h_T, void* c_T, void* hbuf,
                               int n_steps, int B, int H, int reverse, void* stream) {
  int n_sms = 0, smem_max = 0;
  const cudaError_t err = ptt::coop_device(&n_sms, &smem_max);
  if (err != cudaSuccess) return err;
  const int hc = ptt::units_per_cta(H, n_sms);
  const size_t item = io_bf16 ? sizeof(__nv_bfloat16) : sizeof(float);
  if (hc == 0 || n_steps < 1 || B < 1 || smem_bytes(B, H, hc, item) > (size_t)smem_max)
    return cudaErrorInvalidValue;
  void* out[] = {h_seq, c_seq, h_T, c_T};
  const float* m = static_cast<const float*>(mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (io_bf16)
    return launch_hc<__nv_bfloat16>(hc, x, m, w, out, hbuf, n_steps, B, H, reverse, n_sms, st);
  return launch_hc<float>(hc, x, m, w, out, hbuf, n_steps, B, H, reverse, n_sms, st);
}

extern "C" const char* lstm_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
