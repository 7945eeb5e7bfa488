// Whole-sequence masked GRU forward for Hopper (sm_90a), one launch per
// sequence.
//
// Replaces the TPU kernel `_gru_kernel`, launched by `_gru_pallas_raw`
// (paddle_tpu/ops/pallas_kernels.py:457-515). Same function:
//   u, r = sigmoid(x_ur + h @ W_ur)          gate math in f32
//   rh   = io(r * h)                          rounded to the io dtype
//   c    = tanh(x_c + rh @ W_c)
//   h'   = (1 - u) * h + u * c, masked carry, rounded to the io dtype
// with x [T,B,3H] (bias already added), mask [T,B] f32, W [H,3H], io dtype
// f32 or bf16; outputs h_seq [T,B,H] and h_T [B,H]. `reverse` walks t
// from T-1 down to 0, which equals flipping x and the mask in and h_seq
// out as gru_fused does.
//
// What bounds it: the T dependent steps. Each step is a [B,H]x[H,3H]
// product that needs all of h from the step before, so the whole card
// must meet at a barrier twice a step (after rh, after h'); the bytes
// (x in, h_seq out) and the FLOPs are far below what the card could do
// in that time. The TPU kernel keeps W in VMEM for all T steps; here each
// CTA owns HC hidden units and keeps its 3*HC columns of W in shared
// memory for the whole launch, so W is read from device memory once. h
// and rh live in small global buffers that stay in L2 and are read with
// ld.cg (past L1, which is not coherent across SMs). A cooperative launch
// guarantees all CTAs are resident, so grid.sync() is safe.
//
// Simple first: f32 FMAs on CUDA cores, one warp per batch row with the
// lanes splitting H. Tensor cores, TMA and fewer barriers are later work.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace ptt;

template <typename T, int HC>
__global__ void __launch_bounds__(kThreads)
gru_fwd_kernel(const T* __restrict__ x, const float* __restrict__ mask,
               const T* __restrict__ w, T* __restrict__ h_seq, T* __restrict__ h_T,
               T* hbuf, T* rh, int n_steps, int B, int H, int reverse) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* u_sh = reinterpret_cast<float*>(smem_raw);     // [B][HC]
  T* w_sh = reinterpret_cast<T*>(u_sh + B * HC);         // [3][HC][H], k fastest

  const int j0 = blockIdx.x * HC;
  const int H3 = 3 * H;
  for (int i = threadIdx.x; i < 3 * HC * H; i += blockDim.x) {
    const int k = i % H, jj = (i / H) % HC, g = i / (H * HC);
    const int j = j0 + jj;
    w_sh[i] = j < H ? w[(size_t)k * H3 + g * H + j] : from_f<T>(0.f);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* wu = w_sh;
  const T* wr = w_sh + HC * H;
  const T* wc = w_sh + 2 * HC * H;

  for (int s = 0; s < n_steps; ++s) {
    const int t = reverse ? n_steps - 1 - s : s;
    const T* hp = hbuf + (size_t)(s & 1) * B * H;
    T* hn = hbuf + (size_t)((s + 1) & 1) * B * H;

    // phase 1: u and r for this CTA's columns; rh for those columns
    for (int b = warp; b < B; b += kWarps) {
      const T* hrow = hp + (size_t)b * H;
      float au[HC], ar[HC];
#pragma unroll
      for (int jj = 0; jj < HC; ++jj) au[jj] = ar[jj] = 0.f;
      for (int k = lane; k < H; k += 32) {
        const float hv = to_f<T>(__ldcg(hrow + k));
#pragma unroll
        for (int jj = 0; jj < HC; ++jj) {
          au[jj] += hv * to_f<T>(wu[jj * H + k]);
          ar[jj] += hv * to_f<T>(wr[jj * H + k]);
        }
      }
#pragma unroll
      for (int jj = 0; jj < HC; ++jj) {
        au[jj] = warp_sum(au[jj]);
        ar[jj] = warp_sum(ar[jj]);
      }
      const T* xrow = x + ((size_t)t * B + b) * H3;
#pragma unroll
      for (int jj = 0; jj < HC; ++jj) {
        const int j = j0 + jj;
        if (lane == jj && j < H) {
          const float u = sigmoid_f(to_f<T>(xrow[j]) + au[jj]);
          const float r = sigmoid_f(to_f<T>(xrow[H + j]) + ar[jj]);
          u_sh[b * HC + jj] = u;
          rh[(size_t)b * H + j] = from_f<T>(r * to_f<T>(__ldcg(hrow + j)));
        }
      }
    }
    grid.sync();

    // phase 2: c from the full rh row; the masked carry for these columns
    for (int b = warp; b < B; b += kWarps) {
      const T* rrow = rh + (size_t)b * H;
      float ac[HC];
#pragma unroll
      for (int jj = 0; jj < HC; ++jj) ac[jj] = 0.f;
      for (int k = lane; k < H; k += 32) {
        const float rv = to_f<T>(__ldcg(rrow + k));
#pragma unroll
        for (int jj = 0; jj < HC; ++jj) ac[jj] += rv * to_f<T>(wc[jj * H + k]);
      }
#pragma unroll
      for (int jj = 0; jj < HC; ++jj) ac[jj] = warp_sum(ac[jj]);
      const T* xrow = x + ((size_t)t * B + b) * H3;
      const float m = mask[(size_t)t * B + b];
#pragma unroll
      for (int jj = 0; jj < HC; ++jj) {
        const int j = j0 + jj;
        if (lane == jj && j < H) {
          const float c = tanhf(to_f<T>(xrow[2 * H + j]) + ac[jj]);
          const float hpv = to_f<T>(__ldcg(hp + (size_t)b * H + j));
          const float u = u_sh[b * HC + jj];
          float h = (1.f - u) * hpv + u * c;
          h = m * h + (1.f - m) * hpv;
          const T hv = from_f<T>(h);
          hn[(size_t)b * H + j] = hv;
          h_seq[((size_t)t * B + b) * H + j] = hv;
          if (s == n_steps - 1) h_T[(size_t)b * H + j] = hv;
        }
      }
    }
    grid.sync();
  }
}

template <typename T, int HC>
cudaError_t launch(const void* x, const float* mask, const void* w, void* h_seq,
                   void* h_T, void* hbuf, void* rh, int n_steps, int B, int H,
                   int reverse, int n_sms, cudaStream_t stream) {
  auto kernel = gru_fwd_kernel<T, HC>;
  const int grid = (H + HC - 1) / HC;
  const size_t smem = (size_t)B * HC * sizeof(float) + (size_t)3 * HC * H * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm * n_sms < grid) return cudaErrorCooperativeLaunchTooLarge;
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* hs = static_cast<T*>(h_seq);
  T* ht = static_cast<T*>(h_T);
  T* hb = static_cast<T*>(hbuf);
  T* rp = static_cast<T*>(rh);
  void* args[] = {&xp, &mask, &wp, &hs, &ht, &hb, &rp, &n_steps, &B, &H, &reverse};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(grid),
                                    dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hc(int hc, const void* x, const float* mask, const void* w,
                      void* h_seq, void* h_T, void* hbuf, void* rh, int n_steps,
                      int B, int H, int reverse, int n_sms, cudaStream_t stream) {
  switch (hc) {
    case 1: return launch<T, 1>(x, mask, w, h_seq, h_T, hbuf, rh, n_steps, B, H, reverse, n_sms, stream);
    case 2: return launch<T, 2>(x, mask, w, h_seq, h_T, hbuf, rh, n_steps, B, H, reverse, n_sms, stream);
    case 4: return launch<T, 4>(x, mask, w, h_seq, h_T, hbuf, rh, n_steps, B, H, reverse, n_sms, stream);
    case 8: return launch<T, 8>(x, mask, w, h_seq, h_T, hbuf, rh, n_steps, B, H, reverse, n_sms, stream);
    case 16: return launch<T, 16>(x, mask, w, h_seq, h_T, hbuf, rh, n_steps, B, H, reverse, n_sms, stream);
    case 32: return launch<T, 32>(x, mask, w, h_seq, h_T, hbuf, rh, n_steps, B, H, reverse, n_sms, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Columns per CTA: the smallest power of two that puts at most one CTA on
// each SM, so every CTA reads h once per phase for as many columns as it
// can. Returns 0 when H needs more than 32 columns per CTA.
extern "C" int gru_fwd_columns_per_cta(int H, int n_sms) {
  for (int hc = 1; hc <= 32; hc *= 2)
    if ((H + hc - 1) / hc <= n_sms) return hc;
  return 0;
}

// x, w, h_seq, h_T, hbuf [2,B,H] (zeroed), rh [B,H]: io dtype (bf16 when
// io_bf16, else f32), contiguous; mask [T,B] f32. Returns a cudaError_t.
extern "C" int gru_fwd_launch(int io_bf16, const void* x, const void* mask, const void* w,
                              void* h_seq, void* h_T, void* hbuf, void* rh, int n_steps,
                              int B, int H, int reverse, void* stream) {
  int dev = 0, n_sms = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  const int hc = gru_fwd_columns_per_cta(H, n_sms);
  if (hc == 0 || n_steps < 1 || B < 1) return cudaErrorInvalidValue;
  const float* m = static_cast<const float*>(mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (io_bf16)
    return launch_hc<__nv_bfloat16>(hc, x, m, w, h_seq, h_T, hbuf, rh, n_steps, B, H,
                                    reverse, n_sms, st);
  return launch_hc<float>(hc, x, m, w, h_seq, h_T, hbuf, rh, n_steps, B, H, reverse,
                          n_sms, st);
}

extern "C" const char* gru_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
