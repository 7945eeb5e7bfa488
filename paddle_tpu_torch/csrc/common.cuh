// Helpers the port's kernels share: conversion between the io dtype (f32 or
// bf16) and the f32 the math runs in, and warp reductions. Every kernel
// computes in f32 and rounds to the io dtype only where the TPU kernel it
// replaces rounds.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ptt {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as astype does
}

// v rounded to the io dtype and widened back
template <typename T> __device__ __forceinline__ float round_io(float v) {
  return to_f<T>(from_f<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float sigmoid_f(float v) { return 1.f / (1.f + expf(-v)); }

// What a persistent cooperative launch needs to know of the current device:
// its SM count and the shared memory a block may opt in to.
// cudaErrorNotSupported where the device cannot launch cooperatively.
inline cudaError_t coop_device(int* n_sms, int* smem_max) {
  int dev = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(n_sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  return coop ? cudaSuccess : cudaErrorNotSupported;
}

// The LSTM kernels' hidden units per CTA: the smallest power of two that
// puts at most one CTA on each SM, as gru_fwd.cu chooses its columns.
// 0 when H needs more than 16.
inline int units_per_cta(int H, int n_sms) {
  for (int hc = 1; hc <= 16; hc *= 2)
    if ((H + hc - 1) / hc <= n_sms) return hc;
  return 0;
}

}  // namespace ptt
