// Whole-sequence masked GRU backward for Hopper (sm_90a), one launch per
// sequence.
//
// Replaces the TPU kernel `_gru_bwd_kernel`, launched by `_gru_bwd_pallas`
// (paddle_tpu/ops/pallas_kernels.py:518-673). It walks the steps of the
// forward in reverse (t = T-1 down to 0; 0 up to T-1 for `reverse`) and
// carries dh. Per step, with u, r, c from the pre-activations the wrapper
// recomputed in batched products:
//   dh      = dh_seq[t] + carry;  dh_raw = m * dh
//   dc_pre  = dh_raw * u * (1 - c^2)                   rounded to io
//   du_pre  = dh_raw * (c - h_prev) * u * (1 - u)      rounded to io
//   drh     = dc_pre @ W_c^T                           f32
//   dr_pre  = drh * h_prev * r * (1 - r)               rounded to io
//   carry'  = io((1-m)*dh + dh_raw*(1-u) + drh*r + [du_pre|dr_pre] @ W_ur^T)
//   dx[t]   = [du_pre | dr_pre | dc_pre]
//   dW     += [h_prev^T du_pre | h_prev^T dr_pre | rh^T dc_pre]   f32
// with gate math in f32 and the roundings where the TPU kernel has them; dW
// is rounded once at the end. Above H = 640 the wrapper computes dW outside
// (`acc_dw` = 0), as the TPU kernel does.
//
// What bounds it: the T dependent steps. Unit j's dh_prev needs dc_pre and
// dur of every unit, so the card meets at a grid barrier twice a step
// (after dc_pre, after dur); the bytes (the [T,B,·] inputs once, dx once)
// and FLOPs are far below what the card does in that time. Each CTA owns HC
// hidden units, keeps the HC rows of W they need for both products in
// shared memory for the whole launch, carries their dh in shared memory,
// and accumulates dW for its own 3*HC gate columns over all T in shared
// memory (H x 3HC f32, 24 KB at H = 512, HC = 4). dc_pre and dur, which
// every CTA reads, go through small global buffers that stay in L2 and are
// read with ld.cg (past L1, which is not coherent across SMs). A
// cooperative launch guarantees all CTAs are resident, so grid.sync() is
// safe.
//
// Simple first: f32 FMAs on CUDA cores, one warp per batch row with the
// lanes splitting the inner dimension. Tensor cores and fewer barriers are
// later work.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace ptt;

constexpr int kMaxDwColumns = 8;  // HC with the in-kernel dW accumulator

template <typename T, int HC>
__global__ void __launch_bounds__(kThreads)
gru_bwd_kernel(const T* __restrict__ ur_pre, const T* __restrict__ c_pre,
               const T* __restrict__ h_prev, const T* __restrict__ rh,
               const T* __restrict__ dh_seq, const float* __restrict__ mask,
               const T* __restrict__ w, const T* __restrict__ dhT, T* __restrict__ dx,
               T* __restrict__ dw, T* dcp, T* dur, int n_steps, int B, int H,
               int reverse, int acc_dw) {
  cg::grid_group grid = cg::this_grid();
  constexpr int G = 3 * HC;  // this CTA's gate columns: u, r, c of each unit
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* g_sh = reinterpret_cast<float*>(smem_raw);  // [B][G] io-rounded dgates
  float* carry = g_sh + (size_t)B * G;               // [B][HC] dh, io-rounded
  float* part = carry + (size_t)B * HC;              // [B][HC] dh_prev so far
  float* r_sh = part + (size_t)B * HC;               // [B][HC]
  float* hp_sh = r_sh + (size_t)B * HC;              // [B][HC]
  float* dw_sh = hp_sh + (size_t)B * HC;             // [H][G] when acc_dw
  T* w_sh = reinterpret_cast<T*>(dw_sh + (acc_dw ? (size_t)H * G : 0));  // [HC][3H]

  const int j0 = blockIdx.x * HC;
  const int H2 = 2 * H, H3 = 3 * H;
  for (int i = threadIdx.x; i < HC * H3; i += blockDim.x) {
    const int jj = i / H3, g = i % H3, j = j0 + jj;
    w_sh[i] = j < H ? w[(size_t)j * H3 + g] : from_f<T>(0.f);
  }
  for (int i = threadIdx.x; i < B * HC; i += blockDim.x) {
    const int b = i / HC, j = j0 + i % HC;
    carry[i] = j < H ? to_f<T>(dhT[(size_t)b * H + j]) : 0.f;
  }
  if (acc_dw)
    for (int i = threadIdx.x; i < H * G; i += blockDim.x) dw_sh[i] = 0.f;
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int s = 0; s < n_steps; ++s) {
    const int t = reverse ? s : n_steps - 1 - s;
    const size_t tb = (size_t)t * B;

    // phase 1: dc_pre and du_pre of this CTA's units, from local values
    for (int i = threadIdx.x; i < B * HC; i += blockDim.x) {
      const int b = i / HC, jj = i % HC, j = j0 + jj;
      float* g = g_sh + (size_t)b * G;
      if (j >= H) {
        g[jj] = g[HC + jj] = g[2 * HC + jj] = 0.f;
        continue;
      }
      const size_t row = tb + b;
      const float u = sigmoid_f(to_f<T>(ur_pre[row * H2 + j]));
      const float r = sigmoid_f(to_f<T>(ur_pre[row * H2 + H + j]));
      const float c = tanhf(to_f<T>(c_pre[row * H + j]));
      const float hp = to_f<T>(h_prev[row * H + j]);
      const float m = mask[row];
      const float dh = to_f<T>(dh_seq[row * H + j]) + carry[i];
      const float dh_raw = m * dh;
      part[i] = (1.f - m) * dh + dh_raw * (1.f - u);
      const T dcq = from_f<T>(dh_raw * u * (1.f - c * c));
      const T duq = from_f<T>(dh_raw * (c - hp) * u * (1.f - u));
      dcp[(size_t)b * H + j] = dcq;
      dx[row * H3 + j] = duq;
      dx[row * H3 + H2 + j] = dcq;
      g[jj] = to_f<T>(duq);
      g[2 * HC + jj] = to_f<T>(dcq);
      r_sh[i] = r;
      hp_sh[i] = hp;
    }
    grid.sync();

    // phase 2: drh = dc_pre @ W_c^T for these units needs every unit's dc_pre
    for (int b = warp; b < B; b += kWarps) {
      const T* drow = dcp + (size_t)b * H;
      float acc[HC];
#pragma unroll
      for (int jj = 0; jj < HC; ++jj) acc[jj] = 0.f;
      for (int k = lane; k < H; k += 32) {
        const float v = to_f<T>(__ldcg(drow + k));
#pragma unroll
        for (int jj = 0; jj < HC; ++jj) acc[jj] += v * to_f<T>(w_sh[jj * H3 + H2 + k]);
      }
#pragma unroll
      for (int jj = 0; jj < HC; ++jj) acc[jj] = warp_sum(acc[jj]);
#pragma unroll
      for (int jj = 0; jj < HC; ++jj) {
        const int j = j0 + jj;
        if (lane == jj && j < H) {
          const int i = b * HC + jj;
          const float r = r_sh[i], drh = acc[jj];
          part[i] += drh * r;
          const T drq = from_f<T>(drh * hp_sh[i] * r * (1.f - r));
          float* g = g_sh + (size_t)b * G;
          dur[(size_t)b * H2 + j] = from_f<T>(g[jj]);
          dur[(size_t)b * H2 + H + j] = drq;
          dx[(tb + b) * H3 + H + j] = drq;
          g[HC + jj] = to_f<T>(drq);
        }
      }
    }
    grid.sync();

    // phase 3: the carry, dh_prev + dur @ W_ur^T over every unit's dur
    for (int b = warp; b < B; b += kWarps) {
      const T* drow = dur + (size_t)b * H2;
      float acc[HC];
#pragma unroll
      for (int jj = 0; jj < HC; ++jj) acc[jj] = 0.f;
      for (int k = lane; k < H2; k += 32) {
        const float v = to_f<T>(__ldcg(drow + k));
#pragma unroll
        for (int jj = 0; jj < HC; ++jj) acc[jj] += v * to_f<T>(w_sh[jj * H3 + k]);
      }
#pragma unroll
      for (int jj = 0; jj < HC; ++jj) acc[jj] = warp_sum(acc[jj]);
#pragma unroll
      for (int jj = 0; jj < HC; ++jj) {
        const int i = b * HC + jj;
        if (lane == jj && j0 + jj < H) carry[i] = round_io<T>(part[i] + acc[jj]);
      }
    }
    // dW of this CTA's gate columns: each thread owns whole rows k of dW
    if constexpr (HC <= kMaxDwColumns) {
      if (acc_dw) {
        for (int k = threadIdx.x; k < H; k += blockDim.x) {
          float a[G];
#pragma unroll
          for (int q = 0; q < G; ++q) a[q] = dw_sh[(size_t)k * G + q];
          for (int b = 0; b < B; ++b) {
            const float hv = to_f<T>(h_prev[(tb + b) * H + k]);
            const float rv = to_f<T>(rh[(tb + b) * H + k]);
            const float* g = g_sh + (size_t)b * G;
#pragma unroll
            for (int q = 0; q < 2 * HC; ++q) a[q] += hv * g[q];
#pragma unroll
            for (int q = 2 * HC; q < G; ++q) a[q] += rv * g[q];
          }
#pragma unroll
          for (int q = 0; q < G; ++q) dw_sh[(size_t)k * G + q] = a[q];
        }
      }
    }
    __syncthreads();  // g_sh and carry are rewritten by other threads next step
  }

  if (acc_dw) {
    for (int i = threadIdx.x; i < H * G; i += blockDim.x) {
      const int k = i / G, q = i % G, gate = q / HC, j = j0 + q % HC;
      if (j < H) dw[(size_t)k * H3 + gate * H + j] = from_f<T>(dw_sh[i]);
    }
  }
}

size_t smem_bytes(int B, int H, int hc, int acc_dw, size_t item) {
  return ((size_t)B * 3 * hc + (size_t)4 * B * hc + (acc_dw ? (size_t)H * 3 * hc : 0)) *
             sizeof(float) +
         (size_t)hc * 3 * H * item;
}

template <typename T, int HC>
cudaError_t launch(const void* const* in, const float* mask, void* dx, void* dw,
                   void* dcp, void* dur, int n_steps, int B, int H, int reverse,
                   int acc_dw, int n_sms, cudaStream_t stream) {
  auto kernel = gru_bwd_kernel<T, HC>;
  const int grid = (H + HC - 1) / HC;
  const size_t smem = smem_bytes(B, H, HC, acc_dw, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm * n_sms < grid) return cudaErrorCooperativeLaunchTooLarge;
  const T* ur = static_cast<const T*>(in[0]);
  const T* cp = static_cast<const T*>(in[1]);
  const T* hp = static_cast<const T*>(in[2]);
  const T* rp = static_cast<const T*>(in[3]);
  const T* dh = static_cast<const T*>(in[4]);
  const T* wp = static_cast<const T*>(in[5]);
  const T* dhT = static_cast<const T*>(in[6]);
  T* dxp = static_cast<T*>(dx);
  T* dwp = static_cast<T*>(dw);
  T* dcpp = static_cast<T*>(dcp);
  T* durp = static_cast<T*>(dur);
  void* args[] = {&ur, &cp, &hp, &rp, &dh, &mask, &wp, &dhT, &dxp, &dwp, &dcpp, &durp,
                  &n_steps, &B, &H, &reverse, &acc_dw};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(grid),
                                    dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hc(int hc, const void* const* in, const float* mask, void* dx, void* dw,
                      void* dcp, void* dur, int n_steps, int B, int H, int reverse,
                      int acc_dw, int n_sms, cudaStream_t st) {
  switch (hc) {
    case 1: return launch<T, 1>(in, mask, dx, dw, dcp, dur, n_steps, B, H, reverse, acc_dw, n_sms, st);
    case 2: return launch<T, 2>(in, mask, dx, dw, dcp, dur, n_steps, B, H, reverse, acc_dw, n_sms, st);
    case 4: return launch<T, 4>(in, mask, dx, dw, dcp, dur, n_steps, B, H, reverse, acc_dw, n_sms, st);
    case 8: return launch<T, 8>(in, mask, dx, dw, dcp, dur, n_steps, B, H, reverse, acc_dw, n_sms, st);
    case 16: return launch<T, 16>(in, mask, dx, dw, dcp, dur, n_steps, B, H, reverse, acc_dw, n_sms, st);
    case 32: return launch<T, 32>(in, mask, dx, dw, dcp, dur, n_steps, B, H, reverse, acc_dw, n_sms, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Units per CTA: the smallest power of two that puts at most one CTA on
// each SM, as gru_fwd.cu chooses. Returns 0 when H needs more than 32.
extern "C" int gru_bwd_columns_per_cta(int H, int n_sms) {
  for (int hc = 1; hc <= 32; hc *= 2)
    if ((H + hc - 1) / hc <= n_sms) return hc;
  return 0;
}

// ur_pre [T,B,2H], c_pre, h_prev, rh, dh_seq [T,B,H], w [H,3H], dhT [B,H],
// dx [T,B,3H], dw [H,3H], scratch dcp [B,H] and dur [B,2H]: io dtype (bf16
// when io_bf16, else f32), contiguous; mask [T,B] f32. dw is written only
// when acc_dw. Returns a cudaError_t.
extern "C" int gru_bwd_launch(int io_bf16, const void* ur_pre, const void* c_pre,
                              const void* h_prev, const void* rh, const void* dh_seq,
                              const void* mask, const void* w, const void* dhT, void* dx,
                              void* dw, void* dcp, void* dur, int n_steps, int B, int H,
                              int reverse, int acc_dw, void* stream) {
  int dev = 0, n_sms = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  const int hc = gru_bwd_columns_per_cta(H, n_sms);
  if (hc == 0 || n_steps < 1 || B < 1 || (acc_dw && hc > kMaxDwColumns))
    return cudaErrorInvalidValue;
  const void* in[] = {ur_pre, c_pre, h_prev, rh, dh_seq, w, dhT};
  const float* m = static_cast<const float*>(mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (io_bf16)
    return launch_hc<__nv_bfloat16>(hc, in, m, dx, dw, dcp, dur, n_steps, B, H, reverse,
                                    acc_dw, n_sms, st);
  return launch_hc<float>(hc, in, m, dx, dw, dcp, dur, n_steps, B, H, reverse, acc_dw,
                          n_sms, st);
}

extern "C" const char* gru_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
