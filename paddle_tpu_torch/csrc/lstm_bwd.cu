// Whole-sequence masked LSTM backward for Hopper (sm_90a), one launch per
// sequence.
//
// Replaces the TPU kernel `_lstm_bwd_kernel` / `_lstm_bwd_kernel_nodw`,
// launched by `_lstm_bwd_pallas` (paddle_tpu/ops/pallas_kernels.py:
// 232-389). It walks the steps of the forward in reverse (t = T-1 down to
// 0; 0 up to T-1 for `reverse`) and carries dh and dc. Per step, with i, f,
// g, o from the pre-activations the wrapper recomputed in one batched
// product (gates_pre = x + io(h_prev @ W)):
//   tc      = tanh(f * c_prev + i * g)
//   dh      = dh_seq[t] + dh_carry;  dh_raw = m * dh
//   dc_raw  = m * dc_carry + dh_raw * o * (1 - tc^2)
//   dgates  = io([dc_raw*g*i(1-i) | dc_raw*c_prev*f(1-f) | dc_raw*i(1-g^2)
//                 | dh_raw*tc*o(1-o)])                        dx[t]
//   dh_carry' = io(dgates @ W^T + (1-m) * dh)
//   dc_carry' = io(dc_raw * f + (1-m) * dc_carry)
//   dW     += h_prev^T dgates                                 f32
// with gate math in f32 and the roundings where the TPU kernel has them; dW
// is rounded once at the end. Above H = 640 the wrapper computes dW outside
// (`acc_dw` = 0), as the TPU kernel does.
//
// What bounds it: the T dependent steps. Unit j's dh carry needs the
// dgates of all 4H columns times row j of W, so the card meets at a grid
// barrier once a step; the bytes (the [T,B,.] inputs once, dx once) and
// FLOPs are far below what the card does in that time. Each CTA owns HC
// hidden units: it keeps the HC rows of W they need (all 4H columns) in
// shared memory for the whole launch, carries their dh and dc in shared
// memory, and accumulates dW for its own 4*HC gate columns over all T in
// f32 shared memory (H x 4HC, 32 KB at H = 512, HC = 4), each thread owning
// whole rows k of dW: no atomics, no second pass. The dgates every CTA
// reads go through one of two small global buffers (read with ld.cg, past
// L1, which is not coherent across SMs); the barrier of step s orders every
// read of buffer s&1 before its next write at step s+2. A cooperative
// launch guarantees all CTAs are resident, so grid.sync() is safe.
//
// Simple first: f32 FMAs on CUDA cores, one warp per batch row with the
// lanes splitting the 4H columns. Tensor cores are later work.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace ptt;

constexpr int kMaxDwUnits = 8;  // HC with the in-kernel dW accumulator

template <typename T, int HC>
__global__ void __launch_bounds__(kThreads)
lstm_bwd_kernel(const T* __restrict__ gates_pre, const T* __restrict__ c_prev,
                const T* __restrict__ h_prev, const T* __restrict__ dh_seq,
                const float* __restrict__ mask, const T* __restrict__ w,
                const T* __restrict__ dhT, const T* __restrict__ dcT, T* __restrict__ dx,
                T* __restrict__ dw, T* dgbuf, int n_steps, int B, int H, int reverse,
                int acc_dw) {
  cg::grid_group grid = cg::this_grid();
  constexpr int G = 4 * HC;       // this CTA's gate columns: i, f, g, o of each unit
  constexpr int DWS = G + 1;      // dW row stride in shared memory (odd: no bank conflicts)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* g_sh = reinterpret_cast<float*>(smem_raw);  // [B][G] io-rounded dgates
  float* dh_c = g_sh + (size_t)B * G;                // [B][HC] dh carry, io-rounded
  float* dc_c = dh_c + (size_t)B * HC;               // [B][HC] dc carry, io-rounded
  float* part = dc_c + (size_t)B * HC;               // [B][HC] (1-m) * dh
  float* dw_sh = part + (size_t)B * HC;              // [H][DWS] when acc_dw
  T* w_sh = reinterpret_cast<T*>(dw_sh + (acc_dw ? (size_t)H * DWS : 0));  // [HC][4H]

  const int j0 = blockIdx.x * HC;
  const int H4 = 4 * H;
  for (int i = threadIdx.x; i < HC * H4; i += blockDim.x) {
    const int jj = i / H4, k = i % H4, j = j0 + jj;
    w_sh[i] = j < H ? w[(size_t)j * H4 + k] : from_f<T>(0.f);
  }
  for (int i = threadIdx.x; i < B * HC; i += blockDim.x) {
    const int b = i / HC, j = j0 + i % HC;
    dh_c[i] = j < H ? to_f<T>(dhT[(size_t)b * H + j]) : 0.f;
    dc_c[i] = j < H ? to_f<T>(dcT[(size_t)b * H + j]) : 0.f;
  }
  if (acc_dw)
    for (int i = threadIdx.x; i < H * DWS; i += blockDim.x) dw_sh[i] = 0.f;
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int s = 0; s < n_steps; ++s) {
    const int t = reverse ? s : n_steps - 1 - s;
    const size_t tb = (size_t)t * B;
    T* dg = dgbuf + (size_t)(s & 1) * B * H4;

    // phase 1: the dgates of this CTA's units and their dc carry, from local values
    for (int i = threadIdx.x; i < B * HC; i += blockDim.x) {
      const int b = i / HC, jj = i % HC, j = j0 + jj;
      float* gq = g_sh + (size_t)b * G;
      if (j >= H) {
        gq[jj] = gq[HC + jj] = gq[2 * HC + jj] = gq[3 * HC + jj] = 0.f;
        continue;
      }
      const size_t row = tb + b;
      const T* gp = gates_pre + row * H4;
      const float gi = sigmoid_f(to_f<T>(gp[j]));
      const float gf = sigmoid_f(to_f<T>(gp[H + j]));
      const float gg = tanhf(to_f<T>(gp[2 * H + j]));
      const float go = sigmoid_f(to_f<T>(gp[3 * H + j]));
      const float cp = to_f<T>(c_prev[row * H + j]);
      const float m = mask[row];
      const float tc = tanhf(gf * cp + gi * gg);
      const float dh = to_f<T>(dh_seq[row * H + j]) + dh_c[i];
      const float dc = dc_c[i];
      const float dh_raw = m * dh;
      const float dc_raw = m * dc + dh_raw * go * (1.f - tc * tc);
      const T d[4] = {from_f<T>(dc_raw * gg * gi * (1.f - gi)),
                      from_f<T>(dc_raw * cp * gf * (1.f - gf)),
                      from_f<T>(dc_raw * gi * (1.f - gg * gg)),
                      from_f<T>(dh_raw * tc * go * (1.f - go))};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        dx[row * H4 + q * H + j] = d[q];
        dg[(size_t)b * H4 + q * H + j] = d[q];
        gq[q * HC + jj] = to_f<T>(d[q]);
      }
      dc_c[i] = round_io<T>(dc_raw * gf + (1.f - m) * dc);
      part[i] = (1.f - m) * dh;
    }
    grid.sync();

    // phase 2: the dh carry, dgates @ W^T over every unit's dgates
    for (int b = warp; b < B; b += kWarps) {
      const T* drow = dg + (size_t)b * H4;
      float acc[HC];
#pragma unroll
      for (int jj = 0; jj < HC; ++jj) acc[jj] = 0.f;
      for (int k = lane; k < H4; k += 32) {
        const float v = to_f<T>(__ldcg(drow + k));
#pragma unroll
        for (int jj = 0; jj < HC; ++jj) acc[jj] += v * to_f<T>(w_sh[jj * H4 + k]);
      }
#pragma unroll
      for (int jj = 0; jj < HC; ++jj) acc[jj] = warp_sum(acc[jj]);
#pragma unroll
      for (int jj = 0; jj < HC; ++jj) {
        const int i = b * HC + jj;
        if (lane == jj && j0 + jj < H) dh_c[i] = round_io<T>(acc[jj] + part[i]);
      }
    }
    // dW of this CTA's gate columns: each thread owns whole rows k of dW
    if constexpr (HC <= kMaxDwUnits) {
      if (acc_dw) {
        for (int k = threadIdx.x; k < H; k += blockDim.x) {
          float a[G];
#pragma unroll
          for (int q = 0; q < G; ++q) a[q] = dw_sh[(size_t)k * DWS + q];
          for (int b = 0; b < B; ++b) {
            const float hv = to_f<T>(h_prev[(tb + b) * H + k]);
            const float* gq = g_sh + (size_t)b * G;
#pragma unroll
            for (int q = 0; q < G; ++q) a[q] += hv * gq[q];
          }
#pragma unroll
          for (int q = 0; q < G; ++q) dw_sh[(size_t)k * DWS + q] = a[q];
        }
      }
    }
    __syncthreads();  // g_sh and the carries are rewritten by other threads next step
  }

  if (acc_dw) {
    for (int i = threadIdx.x; i < H * G; i += blockDim.x) {
      const int k = i / G, q = i % G, gate = q / HC, j = j0 + q % HC;
      if (j < H) dw[(size_t)k * H4 + gate * H + j] = from_f<T>(dw_sh[(size_t)k * DWS + q]);
    }
  }
}

size_t smem_bytes(int B, int H, int hc, int acc_dw, size_t item) {
  return ((size_t)B * 4 * hc + (size_t)3 * B * hc + (acc_dw ? (size_t)H * (4 * hc + 1) : 0)) *
             sizeof(float) +
         (size_t)hc * 4 * H * item;
}

template <typename T, int HC>
cudaError_t launch(const void* const* in, const float* mask, void* dx, void* dw, void* dgbuf,
                   int n_steps, int B, int H, int reverse, int acc_dw, int n_sms,
                   cudaStream_t stream) {
  auto kernel = lstm_bwd_kernel<T, HC>;
  const int grid = (H + HC - 1) / HC;
  const size_t smem = smem_bytes(B, H, HC, acc_dw, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm * n_sms < grid) return cudaErrorCooperativeLaunchTooLarge;
  const T* gp = static_cast<const T*>(in[0]);
  const T* cp = static_cast<const T*>(in[1]);
  const T* hp = static_cast<const T*>(in[2]);
  const T* dh = static_cast<const T*>(in[3]);
  const T* wp = static_cast<const T*>(in[4]);
  const T* dhT = static_cast<const T*>(in[5]);
  const T* dcT = static_cast<const T*>(in[6]);
  T* dxp = static_cast<T*>(dx);
  T* dwp = static_cast<T*>(dw);
  T* dgp = static_cast<T*>(dgbuf);
  void* args[] = {&gp, &cp, &hp, &dh, &mask, &wp, &dhT, &dcT, &dxp, &dwp, &dgp,
                  &n_steps, &B, &H, &reverse, &acc_dw};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(grid),
                                    dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hc(int hc, const void* const* in, const float* mask, void* dx, void* dw,
                      void* dgbuf, int n_steps, int B, int H, int reverse, int acc_dw,
                      int n_sms, cudaStream_t st) {
  switch (hc) {
    case 1: return launch<T, 1>(in, mask, dx, dw, dgbuf, n_steps, B, H, reverse, acc_dw, n_sms, st);
    case 2: return launch<T, 2>(in, mask, dx, dw, dgbuf, n_steps, B, H, reverse, acc_dw, n_sms, st);
    case 4: return launch<T, 4>(in, mask, dx, dw, dgbuf, n_steps, B, H, reverse, acc_dw, n_sms, st);
    case 8: return launch<T, 8>(in, mask, dx, dw, dgbuf, n_steps, B, H, reverse, acc_dw, n_sms, st);
    case 16: return launch<T, 16>(in, mask, dx, dw, dgbuf, n_steps, B, H, reverse, acc_dw, n_sms, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// gates_pre [T,B,4H], c_prev, h_prev, dh_seq [T,B,H], w [H,4H], dhT, dcT
// [B,H], dx [T,B,4H], dw [H,4H], scratch dgbuf [2,B,4H]: io dtype (bf16 when
// io_bf16, else f32), contiguous; mask [T,B] f32. dw is written only when
// acc_dw. Returns a cudaError_t: cudaErrorInvalidValue where the shape is
// out of the kernel's range (W's rows and the dW accumulator must fit one
// SM's shared memory).
extern "C" int lstm_bwd_launch(int io_bf16, const void* gates_pre, const void* c_prev,
                               const void* h_prev, const void* dh_seq, const void* mask,
                               const void* w, const void* dhT, const void* dcT, void* dx,
                               void* dw, void* dgbuf, int n_steps, int B, int H, int reverse,
                               int acc_dw, void* stream) {
  int n_sms = 0, smem_max = 0;
  const cudaError_t err = ptt::coop_device(&n_sms, &smem_max);
  if (err != cudaSuccess) return err;
  const int hc = ptt::units_per_cta(H, n_sms);
  const size_t item = io_bf16 ? sizeof(__nv_bfloat16) : sizeof(float);
  if (hc == 0 || n_steps < 1 || B < 1 || (acc_dw && hc > kMaxDwUnits) ||
      smem_bytes(B, H, hc, acc_dw, item) > (size_t)smem_max)
    return cudaErrorInvalidValue;
  const void* in[] = {gates_pre, c_prev, h_prev, dh_seq, w, dhT, dcT};
  const float* m = static_cast<const float*>(mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (io_bf16)
    return launch_hc<__nv_bfloat16>(hc, in, m, dx, dw, dgbuf, n_steps, B, H, reverse,
                                    acc_dw, n_sms, st);
  return launch_hc<float>(hc, in, m, dx, dw, dgbuf, n_steps, B, H, reverse, acc_dw, n_sms,
                          st);
}

extern "C" const char* lstm_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
