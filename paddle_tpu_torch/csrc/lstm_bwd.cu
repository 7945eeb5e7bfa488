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
// dgates of all 4H columns times row j of W, so the CTAs meet at a barrier
// once a step; the bytes (the [T,B,.] inputs once, dx once) and FLOPs are
// far below what the card does in that time.
//
// bf16, the slice's dtype, runs on the tensor cores, on the forward's plan
// (csrc/lstm_fwd.cu):
// - The grid is unit groups x batch groups. A CTA owns 16 hidden units and
//   the batch rows of one group (32 rows a sub-tile; a group takes several
//   sub-tiles only where the card cannot hold a CTA for each). A cooperative
//   launch keeps every CTA resident.
// - The gate math is local to the CTA's (row, unit) pairs, two a thread,
//   in f32 with the roundings where lstm_bwd_plain has them; the dh and dc
//   carries stay in shared memory, owned by the thread that updates them.
//   gates_pre, c_prev, dh_seq and the mask of a step are loaded before the
//   barrier of the step before: they do not depend on the carries. The CTA
//   writes its rounded dgates to dx and to one of two exchange buffers
//   [B, 4·Hp] (gate q's columns at q·Hp, Hp = H rounded up to 16, the
//   padding zero).
// - The barrier is among the CTAs of one batch group only (rows never
//   depend on each other): a counter in global memory, added to with
//   release and polled with acquire order after a __syncthreads; one that
//   does not fill within seconds traps. The barrier after step s orders
//   every read of buffer s&1 before any write to it at step s+2.
// - The dh carry, dgates[32 rows, 4H] · Wᵀ[4H, 16 units], is mma.sync
//   m16n8k16: warp w takes m-tile w&1 and gate (k quarter) w>>1, and
//   streams its rows of the exchange through a private ring of 64-column
//   chunks copied with cp.async.cg (past L1, which is not coherent across
//   SMs), so no CTA-wide barrier stands inside the product. The CTA's 16
//   rows of W, padded as the exchange is ([Hp, 4·Hp] from lstm_kernels.
//   pad_w_bwd: row j is the K-contiguous B column of unit j, nothing
//   transposed), stay in shared memory (64 KB at H=512), or are read
//   through L1 where they do not fit (H above about 1500). Each k16 product
//   goes into a fresh fragment, added in f32 in k order (the tensor core's
//   own accumulation truncates); the four quarters' sums are added in
//   order, then (1-m)·dh, and rounded once.
// - dW is off the recurrence: for H <= 640 (the TPU kernel's in-kernel
//   product, LSTM_FUSED_DW_MAX_H) a second kernel behind the same launch
//   computes dW = Σ_t h_prev[t]ᵀ dgates[t] as one product over all T·B rows
//   of h_prev and dx (common.cuh's dw_product_kernel), mma.sync with f32
//   accumulators, each element written once, rounded once: the same bits
//   on every run. Above 640 the wrapper
//   computes it outside (`acc_dw` = 0), as the TPU kernel does.
// The exchange is four times the forward's: B·4H·2 bytes for each unit
// group a step (16 MB at the slice's shapes, through L2).
// What still holds it back: the chain of one step (the barrier's round
// trip through L2, the exchanged dgates' staging, the product, the gate
// math's transcendental functions, the stores that must land before the
// next release).
//
// f32 io keeps the exact f32 kernel on CUDA cores (no TF32) the port had
// before: each CTA owns HC hidden units, keeps their HC rows of W (all 4H
// columns) in shared memory, carries their dh and dc there and accumulates
// dW for its own 4·HC gate columns over all T in f32 shared memory, each
// thread owning whole rows k of dW: no atomics, no second pass. The dgates
// every CTA reads go through one of two global buffers (read with ld.cg);
// one warp a batch row with the lanes splitting the 4H columns; a whole-grid
// barrier (grid.sync()) a step.

#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace ptt;
using bf16 = __nv_bfloat16;

// ------------------------------------------------------------------ f32 --
constexpr int kMaxDwUnits = 8;  // HC with the in-kernel dW accumulator

template <typename T, int HC>
__global__ void __launch_bounds__(kThreads)
lstm_bwd_f32_kernel(const T* __restrict__ gates_pre, const T* __restrict__ c_prev,
                    const T* __restrict__ h_prev, const T* __restrict__ dh_seq,
                    const float* __restrict__ mask, const T* __restrict__ w,
                    const T* __restrict__ dhT, const T* __restrict__ dcT, T* __restrict__ dx,
                    T* __restrict__ dw, T* dgbuf, int n_steps, int B, int H, int reverse,
                    int acc_dw) {
  static_assert(std::is_same<T, float>::value, "bf16 runs lstm_bwd_tc_kernel");
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
  auto kernel = lstm_bwd_f32_kernel<T, HC>;
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

// ----------------------------------------------------------------- bf16 --
constexpr int kUnits = 16;              // hidden units a CTA owns (lstm_kernels.UNITS_PER_CTA)
constexpr int kRows = 32;               // batch rows of a sub-tile (ROWS_PER_TILE)
constexpr int kPairs = kRows * kUnits;  // (row, unit) pairs of a sub-tile: two a thread
constexpr int kKc = 64;                 // k of a staged chunk of dgates
constexpr int kStages = 6;              // chunks in each warp's ring
constexpr int kLdg = kKc + 8;           // a staged row, padded by 16 bytes against bank conflicts
constexpr long long kSpinCycles = 20000000000LL;  // about 10 s: a barrier that never fills traps
constexpr size_t kRingBytes = (size_t)kWarps * kStages * 16 * kLdg * sizeof(bf16);
constexpr size_t kPartBytes = (size_t)4 * kPairs * sizeof(float);

struct TcArgs {
  const bf16* gates_pre;  // [T, B, 4H]
  const bf16* c_prev;     // [T, B, H]
  const bf16* dh_seq;     // [T, B, H]
  const float* mask;      // [T, B]
  const bf16* wp;         // [Hp, 4·Hp], padded
  const bf16 *dhT, *dcT;  // [B, H]
  bf16* dx;               // [T, B, 4H]
  bf16* dg;               // [2, B, 4·Hp], zeroed
  unsigned* bar;          // [groups], zeroed
  int n_steps, B, H, Hp, reverse, n_tiles, tiles_per_group;
};

// One (batch row, unit) pair's inputs to a step that do not depend on the
// carries, kept raw until used so the loads stay in flight.
struct Pre {
  bf16 g[4], cp, dh;
  float m;
};

__device__ __forceinline__ void prefetch(Pre& p, const TcArgs& a, int s, int b, int j) {
  if (b >= a.B || j >= a.H) return;
  const int t = a.reverse ? s : a.n_steps - 1 - s;
  const size_t row = (size_t)t * a.B + b;
  const bf16* gp = a.gates_pre + row * 4 * a.H + j;
#pragma unroll
  for (int q = 0; q < 4; ++q) p.g[q] = gp[(size_t)q * a.H];
  p.cp = a.c_prev[row * a.H + j];
  p.dh = a.dh_seq[row * a.H + j];
  p.m = a.mask[row];
}

// Shared memory: the warps' rings, the quarters' partial products, the
// carries (dh, dc and (1-m)·dh of each pair of each sub-tile), W's rows.
size_t tc_smem(int tiles_per_group, size_t w_bytes) {
  return kRingBytes + kPartBytes + (size_t)tiles_per_group * 3 * kPairs * sizeof(float) + w_bytes;
}

// grid (Hp / kUnits unit groups, batch groups). Thread tid owns pairs
// p = tid and tid + 256 of each sub-tile: row p / 16, unit p % 16.
template <bool kWSmem>
__global__ void __launch_bounds__(kThreads) lstm_bwd_tc_kernel(TcArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);                // [kWarps][kStages][16][kLdg]
  float* part = reinterpret_cast<float*>(smem_raw + kRingBytes);  // [4][kRows][kUnits]
  float* carry = part + 4 * kPairs;  // [tiles_per_group][dh, dc, (1-m)·dh][kPairs]
  bf16* wsh = reinterpret_cast<bf16*>(carry + (size_t)a.tiles_per_group * 3 * kPairs);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mt = warp & 1, kq = warp >> 1;  // the warp's m-tile and k quarter (gate)
  const int Hp = a.Hp, K4 = 4 * Hp, ldw = kWSmem ? K4 + 8 : K4;
  const int j0 = blockIdx.x * kUnits;
  const bf16* wsrc = a.wp + (size_t)j0 * K4;
  if (kWSmem) {  // [kUnits][K4 + 8]
    const int pieces = K4 / 8;
    for (int i = tid; i < kUnits * pieces; i += kThreads) {
      const int n = i / pieces, pc = i - n * pieces;
      *reinterpret_cast<uint4*>(wsh + n * ldw + pc * 8) =
          *reinterpret_cast<const uint4*>(wsrc + (size_t)n * K4 + pc * 8);
    }
  }
  const bf16* wb = kWSmem ? wsh : wsrc;
  const int tile0 = blockIdx.y * a.tiles_per_group;
  const int n_mine = min(a.n_tiles, tile0 + a.tiles_per_group) - tile0;
  unsigned* bar = a.bar + blockIdx.y;
  bf16* ringw = ring + (size_t)warp * kStages * 16 * kLdg;
  const int j = j0 + (tid & 15), rl = tid >> 4;  // this thread's unit; its rows rl, rl + 16

  for (int tl = 0; tl < n_mine; ++tl) {
    float* c = carry + (size_t)tl * 3 * kPairs;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int p = tid + kThreads * i, b = (tile0 + tl) * kRows + rl + 16 * i;
      const bool ok = b < a.B && j < a.H;
      c[p] = ok ? to_f<bf16>(a.dhT[(size_t)b * a.H + j]) : 0.f;
      c[kPairs + p] = ok ? to_f<bf16>(a.dcT[(size_t)b * a.H + j]) : 0.f;
    }
  }
  Pre pre[2];
  prefetch(pre[0], a, 0, tile0 * kRows + rl, j);
  prefetch(pre[1], a, 0, tile0 * kRows + rl + 16, j);

  for (int s = 0; s < a.n_steps; ++s) {
    const int t = a.reverse ? s : a.n_steps - 1 - s;
    bf16* dgs = a.dg + (size_t)(s & 1) * a.B * K4;
    // the gate math of each sub-tile, from local values
    for (int tl = 0; tl < n_mine; ++tl) {
      float* c = carry + (size_t)tl * 3 * kPairs;
      const int r0 = (tile0 + tl) * kRows;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int p = tid + kThreads * i, b = r0 + rl + 16 * i;
        if (b >= a.B || j >= a.H) continue;
        const Pre& pr = pre[i];
        const float gi = sigmoid_f(to_f<bf16>(pr.g[0]));
        const float gf = sigmoid_f(to_f<bf16>(pr.g[1]));
        const float gg = tanhf(to_f<bf16>(pr.g[2]));
        const float go = sigmoid_f(to_f<bf16>(pr.g[3]));
        const float cp = to_f<bf16>(pr.cp), m = pr.m;
        const float tc = tanhf(gf * cp + gi * gg);
        const float dh = to_f<bf16>(pr.dh) + c[p];
        const float dc = c[kPairs + p];
        const float dh_raw = m * dh;
        const float dc_raw = m * dc + dh_raw * go * (1.f - tc * tc);
        const bf16 d[4] = {from_f<bf16>(dc_raw * gg * gi * (1.f - gi)),
                           from_f<bf16>(dc_raw * cp * gf * (1.f - gf)),
                           from_f<bf16>(dc_raw * gi * (1.f - gg * gg)),
                           from_f<bf16>(dh_raw * tc * go * (1.f - go))};
        bf16* dxr = a.dx + ((size_t)t * a.B + b) * 4 * a.H + j;
        bf16* dgr = dgs + (size_t)b * K4 + j;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          dxr[(size_t)q * a.H] = d[q];
          dgr[q * Hp] = d[q];
        }
        c[kPairs + p] = round_io<bf16>(dc_raw * gf + (1.f - m) * dc);
        c[2 * kPairs + p] = (1.f - m) * dh;
      }
      // the next sub-tile's inputs, or the next step's, ahead of the barrier
      const int s1 = tl + 1 < n_mine ? s : s + 1;
      if (s1 < a.n_steps) {
        const int b1 = (tile0 + (tl + 1 < n_mine ? tl + 1 : 0)) * kRows + rl;
        prefetch(pre[0], a, s1, b1, j);
        prefetch(pre[1], a, s1, b1 + 16, j);
      }
    }
    if (s + 1 == a.n_steps) break;  // the last step's carry is no output

    __syncthreads();
    if (tid == 0) {  // the group's barrier; release covers the CTA's writes before the __syncthreads
      atomic_add_release(bar, 1u);
      const unsigned target = (unsigned)(s + 1) * gridDim.x;
      const long long start = clock64();
      while (load_acquire(bar) < target)
        if (clock64() - start > kSpinCycles) __trap();
    }
    __syncthreads();

    // the dh carry of each sub-tile: dgates · Wᵀ
    const int nkc = (Hp + kKc - 1) / kKc;
    for (int tl = 0; tl < n_mine; ++tl) {
      const int rw = (tile0 + tl) * kRows + mt * 16;  // the warp's first row
      const bf16* src = dgs + (size_t)kq * Hp;         // gate kq's columns
      auto stage = [&](int ch) {  // chunk ch of the warp's 16 rows; always one group
        if (ch < nkc)
          for (int i = lane; i < 16 * (kKc / 8); i += 32) {
            const int r = i / (kKc / 8), k = ch * kKc + (i % (kKc / 8)) * 8, b = rw + r;
            if (k < Hp)
              cp_async16(ringw + ((ch % kStages) * 16 + r) * kLdg + (k - ch * kKc),
                         b < a.B ? src + (size_t)b * K4 + k : src, b < a.B ? 16 : 0);
          }
        cp_async_commit();
      };
#pragma unroll
      for (int ch = 0; ch < kStages - 1; ++ch) stage(ch);
      float acc[2][4];
      zero(acc);
      for (int ch = 0; ch < nkc; ++ch) {
        cp_async_wait<kStages - 2>();
        __syncwarp();  // chunk ch landed for every lane; chunk ch-1's buffer is free
        stage(ch + kStages - 1);
        const bf16* hs = ringw + (ch % kStages) * 16 * kLdg;
        const int kc = min(kKc, Hp - ch * kKc);
        // each k16 product into a fresh fragment, then added to acc in k
        // order in f32: the tensor core's own accumulation truncates
        float pt[kKc / 16][2][4];
#pragma unroll
        for (int kk = 0; kk < kKc / 16; ++kk) {
          if (16 * kk >= kc) continue;
          zero(pt[kk]);
          const int k = kq * Hp + ch * kKc + 16 * kk;
          if constexpr (kWSmem) {
            uint32_t fa[4], fb[4];
            ldmatrix_x4(fa, hs + 16 * kk, kLdg);
            ldmatrix_x4(fb, wb + k, ldw);
            mma_bf16(pt[kk][0], fa[0], fa[1], fa[2], fa[3], fb[0], fb[2]);
            mma_bf16(pt[kk][1], fa[0], fa[1], fa[2], fa[3], fb[1], fb[3]);
          } else {
            WarpMma<bf16, 2, true>::run(pt[kk], hs + 16 * kk, kLdg, wb + k, ldw, 16);
          }
        }
#pragma unroll
        for (int kk = 0; kk < kKc / 16; ++kk) {
          if (16 * kk >= kc) continue;
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[n][e] += pt[kk][n][e];
        }
      }
      // the warp's quarter: rows 16·mt + g (+8), units 8·n + 2q (+1)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          part[kq * kPairs + (mt * 16 + frag_row(e)) * kUnits + frag_col(n, e)] = acc[n][e];
      __syncthreads();
      float* c = carry + (size_t)tl * 3 * kPairs;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int p = tid + kThreads * i;
        const float sum = ((part[p] + part[kPairs + p]) + part[2 * kPairs + p]) + part[3 * kPairs + p];
        c[p] = round_io<bf16>(sum + c[2 * kPairs + p]);
      }
      __syncthreads();  // part is rewritten by the next sub-tile
    }
  }
}

template <bool kWSmem>
cudaError_t launch_tc(TcArgs a, size_t w_bytes, int n_sms, int smem_max, cudaStream_t stream) {
  auto kernel = lstm_bwd_tc_kernel<kWSmem>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
  if (err != cudaSuccess) return err;
  const int n_ug = a.Hp / kUnits;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                      tc_smem(1, w_bytes));
  if (err != cudaSuccess) return err;
  const int cap = per_sm * n_sms;
  if (n_ug > cap) return cudaErrorCooperativeLaunchTooLarge;
  // as many batch groups as the card holds beside the unit groups, none empty
  int groups = min(a.n_tiles, cap / n_ug);
  a.tiles_per_group = (a.n_tiles + groups - 1) / groups;
  groups = (a.n_tiles + a.tiles_per_group - 1) / a.tiles_per_group;
  const size_t smem = tc_smem(a.tiles_per_group, w_bytes);
  if (smem > (size_t)smem_max) return cudaErrorInvalidValue;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm * n_sms < n_ug * groups) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(n_ug, groups),
                                    dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// gates_pre [T,B,4H], c_prev, h_prev, dh_seq [T,B,H], dhT, dcT [B,H], dx
// [T,B,4H], dw [H,4H]: io dtype (bf16 when io_bf16, else f32), contiguous;
// mask [T,B] f32. dw is written only when acc_dw.
//   f32:  w [H,4H]; dgbuf [2,B,4H] scratch; bar unused.
//   bf16: w padded [Hp,4Hp] (lstm_kernels.pad_w_bwd, Hp = H rounded up to
//         16); dgbuf [2,B,4Hp] zeroed; bar [ceil(B/32)] u32 zeroed.
// Returns a cudaError_t: cudaErrorInvalidValue where the shape is out of
// the kernel's range.
extern "C" int lstm_bwd_launch(int io_bf16, const void* gates_pre, const void* c_prev,
                               const void* h_prev, const void* dh_seq, const void* mask,
                               const void* w, const void* dhT, const void* dcT, void* dx,
                               void* dw, void* dgbuf, void* bar, int n_steps, int B, int H,
                               int reverse, int acc_dw, void* stream) {
  int n_sms = 0, smem_max = 0;
  cudaError_t err = ptt::coop_device(&n_sms, &smem_max);
  if (err != cudaSuccess) return err;
  if (n_steps < 1 || B < 1 || H < 1) return cudaErrorInvalidValue;
  const float* m = static_cast<const float*>(mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!io_bf16) {
    const int hc = ptt::units_per_cta(H, n_sms);
    if (hc == 0 || (acc_dw && hc > kMaxDwUnits) ||
        smem_bytes(B, H, hc, acc_dw, sizeof(float)) > (size_t)smem_max)
      return cudaErrorInvalidValue;
    const void* in[] = {gates_pre, c_prev, h_prev, dh_seq, w, dhT, dcT};
    return launch_hc<float>(hc, in, m, dx, dw, dgbuf, n_steps, B, H, reverse, acc_dw, n_sms, st);
  }
  TcArgs a{};
  a.gates_pre = static_cast<const bf16*>(gates_pre);
  a.c_prev = static_cast<const bf16*>(c_prev);
  a.dh_seq = static_cast<const bf16*>(dh_seq);
  a.mask = m;
  a.wp = static_cast<const bf16*>(w);
  a.dhT = static_cast<const bf16*>(dhT);
  a.dcT = static_cast<const bf16*>(dcT);
  a.dx = static_cast<bf16*>(dx);
  a.dg = static_cast<bf16*>(dgbuf);
  a.bar = static_cast<unsigned*>(bar);
  a.n_steps = n_steps;
  a.B = B;
  a.H = H;
  a.Hp = (H + kUnits - 1) / kUnits * kUnits;
  a.reverse = reverse;
  a.n_tiles = (B + kRows - 1) / kRows;
  const size_t w_bytes = (size_t)kUnits * (4 * a.Hp + 8) * sizeof(bf16);
  err = tc_smem(1, w_bytes) <= (size_t)smem_max ? launch_tc<true>(a, w_bytes, n_sms, smem_max, st)
                                                 : launch_tc<false>(a, 0, n_sms, smem_max, st);
  if (err != cudaSuccess || !acc_dw) return err;
  return launch_dw_product(static_cast<const bf16*>(h_prev), H, a.dx, 4 * H,
                           static_cast<bf16*>(dw), 4 * H, n_steps * B, H, 4 * H, H % 8 == 0, st);
}

extern "C" const char* lstm_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
