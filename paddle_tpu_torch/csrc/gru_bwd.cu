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
// What bounds it: the T dependent steps. Unit j's drh needs dc_pre of every
// unit, its dr_pre needs drh, and its carry needs du_pre and dr_pre of every
// unit, so CTAs that own different units meet twice a step; the bytes (the
// [T,B,·] inputs once, dx once) and operations are far below what the card
// does in that time.
//
// bf16, the slice's dtype, runs on the tensor cores, on csrc/lstm_bwd.cu's
// plan:
// - The grid is unit groups x batch groups. A CTA owns 16 hidden units and
//   the batch rows of one group (32 rows a sub-tile; a group takes several
//   sub-tiles only where the card cannot hold a CTA for each). A cooperative
//   launch keeps every CTA resident. The CTA's 16 rows of W, padded as the
//   exchange is ([Hp, 3·Hp] from rnn_kernels.pad_w_bwd: row j is the
//   K-contiguous B column of unit j for all three products, nothing
//   transposed), stay in shared memory (48 KB at H=512), or are read
//   through L1 where they do not fit.
// - Warps 0-3 own the (row, unit) pairs: warp w takes m-tile w&1 and units
//   8·(w>>1) .. +7, lane (g, q) rows g, g+8 and units 2q, 2q+1 of them,
//   the pairs of its mma.sync accumulator fragment. Warps 4-7 compute the
//   du part of the carry beside them. Per step:
//   (A) the owners' gate math from local values: dh, dh_raw, dc_pre and
//       du_pre, published rounded into the exchange [B, 3·Hp] (du at 0, dr
//       at Hp, dc at 2·Hp, the padding zero) and written to dx. Barrier.
//   (B) the owners take drh = dc[32, Hp] · W_c[own rows]ᵀ, then dr_pre,
//       published rounded; warps 4-7 take du[32, Hp] · W_u[own rows]ᵀ, the
//       du part of the carry, into shared memory. Barrier.
//   (C) the owners take dr[32, Hp] · W_r[own rows]ᵀ and build the carry
//       ((((1-m)·dh + dh_raw·(1-u)) + drh·r) + du part) + dr part, rounded
//       once. The next step's (A) is local, so (C) needs no barrier after it.
//   A phase's exchanged rows are staged in 64-wide chunks with cp.async.cg
//   (past L1, which is not coherent across SMs), three chunks in flight.
//   Each k16 product goes into a fresh fragment, added in f32 in k order
//   (the tensor core's own accumulation truncates). ur_pre, c_pre, h_prev,
//   dh_seq and the mask of the next step are loaded before the barriers:
//   they do not depend on the exchange. The pairs' carry, r, h_prev, the
//   carry's running sum and the du part stay in shared memory, one set a
//   sub-tile.
// - The barrier: a counter per batch group in global memory, added to with
//   release and polled with acquire order after a __syncthreads; a counter
//   that does not fill within seconds traps. The exchange is double-
//   buffered by step parity: buffer s&1 is written in (A) and (B) of step s
//   and read in (B) and (C); it is written again in (A) of step s+2, behind
//   the barriers after (A) and (B) of step s+1, which every CTA reaches
//   only after its (C) of step s. (The barrier after (B) of step s already
//   orders every read of the du and dc slots before their next write, and
//   the barrier after (A) of step s+1 every read of the dr slot, so one
//   buffer would do; the parity keeps each step's exchange whole.)
// - dW is off the recurrence: for H <= 640 (the TPU kernel's in-kernel
//   product, GRU_FUSED_DW_MAX_H) two products behind the same launch
//   compute dW = [h_prevᵀ dx_ur | rhᵀ dx_c] over all T·B rows
//   (common.cuh's dw_product_kernel), each element written once, rounded
//   once: the same bits on every run.
// What still holds it back: the chain of one phase (the barrier's round
// trip through L2, the staged rows, the product, the gate math, the stores
// that must land before the next release), three phases and two barriers a
// step.
//
// f32 io keeps the exact f32 kernel on CUDA cores (no TF32) the port had
// before: each CTA owns HC hidden units, keeps the HC rows of W they need
// for both products in shared memory, carries their dh in shared memory,
// and accumulates dW for its own 3*HC gate columns over all T in shared
// memory. dc_pre and dur, which every CTA reads, go through small global
// buffers that stay in L2 and are read with ld.cg; one warp a batch row
// with the lanes splitting the inner dimension; a whole-grid barrier
// (grid.sync()) twice a step.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace ptt;
using bf16 = __nv_bfloat16;

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

// ----------------------------------------------------------------- bf16 --
constexpr int kUnits = 16;              // hidden units a CTA owns (lstm_kernels.UNITS_PER_CTA)
constexpr int kRows = 32;               // batch rows of a sub-tile (ROWS_PER_TILE)
constexpr int kPairs = kRows * kUnits;  // (row, unit) pairs of a sub-tile: four an owner lane
constexpr int kKc = 64;                 // k of a staged chunk
constexpr int kStages = 3;              // chunks in the ring
constexpr int kLdg = kKc + 8;           // a staged row, padded by 16 bytes against bank conflicts
constexpr int kSlot = kRows * kLdg;     // one exchange slot's rows of a chunk
constexpr long long kSpinCycles = 20000000000LL;  // about 10 s: a barrier that never fills traps
constexpr size_t kRingBytes = (size_t)kStages * 2 * kSlot * sizeof(bf16);
// a sub-tile's state: each pair's carry, r, h_prev, the carry's running
// sum and the du part of its carry
constexpr int kFields = 5;
constexpr size_t kStateBytes = (size_t)kFields * kPairs * sizeof(float);

struct TcArgs {
  const bf16* ur_pre;  // [T, B, 2H]
  const bf16 *c_pre, *h_prev, *dh_seq;  // [T, B, H]
  const float* mask;   // [T, B]
  const bf16* wp;      // [Hp, 3·Hp], padded
  const bf16* dhT;     // [B, H]
  bf16* dx;            // [T, B, 3H]
  bf16* ex;            // [2, B, 3·Hp], zeroed: du at 0, dr at Hp, dc at 2·Hp
  unsigned* bar;       // [n_tiles], zeroed
  int n_steps, B, H, Hp, reverse, n_tiles, tiles_per_group;
};

// An owner lane's four pairs' inputs to a step's (A), which do not depend
// on the carry: kept raw until used, so the loads stay in flight. Pair e is
// row g + 8·(e>>1), unit 2q + (e&1) of the warp's tile.
struct Pre {
  bf16 u[4], r[4], c[4], hp[4], dh[4];
  float m[2];
};

__device__ __forceinline__ void prefetch(Pre& p, const TcArgs& a, int s, int b0, int j0) {
  const int t = a.reverse ? s : a.n_steps - 1 - s;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int b = b0 + 8 * rr;
    if (b >= a.B) continue;
    const size_t row = (size_t)t * a.B + b;
    p.m[rr] = a.mask[row];
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int e = 2 * rr + cc, j = j0 + cc;
      if (j >= a.H) continue;
      p.u[e] = a.ur_pre[row * 2 * a.H + j];
      p.r[e] = a.ur_pre[row * 2 * a.H + a.H + j];
      p.c[e] = a.c_pre[row * a.H + j];
      p.hp[e] = a.h_prev[row * a.H + j];
      p.dh[e] = a.dh_seq[row * a.H + j];
    }
  }
}

// Shared memory: the ring (two exchange slots a chunk), the sub-tiles'
// state, W's rows.
size_t tc_smem(int tiles_per_group, size_t w_bytes) {
  return kRingBytes + (size_t)tiles_per_group * kStateBytes + w_bytes;
}

// grid (Hp / kUnits unit groups, batch groups). Warp w computes m-tile
// w&1 and units 8·((w>>1)&1) .. +7 of each sub-tile: warps 0-3 own those
// pairs, warps 4-7 compute the du part of their carries.
template <bool kWSmem>
__global__ void __launch_bounds__(kThreads, 2) gru_bwd_tc_kernel(TcArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);                 // [kStages][2][kRows][kLdg]
  float* state = reinterpret_cast<float*>(smem_raw + kRingBytes);  // [tiles][kFields][kPairs]
  bf16* wsh = reinterpret_cast<bf16*>(state + (size_t)a.tiles_per_group * kFields * kPairs);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mt = warp & 1, nt = (warp >> 1) & 1, g = lane >> 2, q = lane & 3;
  const bool owner = warp < 4;
  const int Hp = a.Hp, K3 = 3 * Hp, ldw = kWSmem ? K3 + 8 : K3;
  const int j0 = blockIdx.x * kUnits;
  const bf16* wsrc = a.wp + (size_t)j0 * K3;
  if (kWSmem) {  // [kUnits][K3 + 8]
    const int pieces = K3 / 8;
    for (int i = tid; i < kUnits * pieces; i += kThreads) {
      const int n = i / pieces, pc = i - n * pieces;
      *reinterpret_cast<uint4*>(wsh + n * ldw + pc * 8) =
          *reinterpret_cast<const uint4*>(wsrc + (size_t)n * K3 + pc * 8);
    }
  }
  // the B column this lane loads: unit nt·8 + g of the group
  const bf16* wrow = (kWSmem ? wsh : wsrc) + (size_t)(nt * 8 + g) * ldw;
  const int tile0 = blockIdx.y * a.tiles_per_group;
  const int n_mine = min(a.n_tiles, tile0 + a.tiles_per_group) - tile0;
  unsigned* bar = a.bar + blockIdx.y;
  const int ul = nt * 8 + 2 * q;                // the lane's first unit in the group
  const int srow = tid >> 3, spiece = tid & 7;  // the 16 bytes of a slot this thread stages
  auto pair = [&](int e) { return (mt * 16 + g + 8 * (e >> 1)) * kUnits + ul + (e & 1); };

  if (owner)
    for (int tl = 0; tl < n_mine; ++tl)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int b = (tile0 + tl) * kRows + mt * 16 + g + 8 * (e >> 1), j = j0 + ul + (e & 1);
        state[(size_t)tl * kFields * kPairs + pair(e)] =
            b < a.B && j < a.H ? to_f<bf16>(a.dhT[(size_t)b * a.H + j]) : 0.f;
      }
  Pre pre;
  if (owner) prefetch(pre, a, 0, tile0 * kRows + mt * 16 + g, j0 + ul);

  auto group_barrier = [&](unsigned k) {  // the k-th barrier of the launch
    __syncthreads();
    if (tid == 0) {  // release covers the CTA's writes before the __syncthreads
      atomic_add_release(bar, 1u);
      const unsigned target = k * gridDim.x;
      const long long start = clock64();
      while (load_acquire(bar) < target)
        if (clock64() - start > kSpinCycles) __trap();
    }
    __syncthreads();
  };

  const int nkc = (Hp + kKc - 1) / kKc;
  for (int s = 0; s < a.n_steps; ++s) {
    const int t = a.reverse ? s : a.n_steps - 1 - s;
    bf16* exs = a.ex + (size_t)(s & 1) * a.B * K3;  // this step's exchange
    // acc = the warp's 16 rows of exchange slot `mine` (the columns from k0,
    // or k1 for slot 1) times its 8 units' rows of W at the same columns:
    // the rows of n_slots slots staged, every warp taking part; a warp with
    // mine < 0 only stages
    auto product = [&](float (&acc)[4], int r0, int n_slots, int k0, int k1, int mine) {
      auto stage = [&](int ch) {  // chunk ch of the slots' rows [r0, r0 + kRows)
        const int kc = ch * kKc + spiece * 8, b = r0 + srow;
        if (kc < Hp)
          for (int sl = 0; sl < n_slots; ++sl) {
            const bf16* src = exs + (sl ? k1 : k0);
            cp_async16(ring + ((ch % kStages) * 2 + sl) * kSlot + srow * kLdg + spiece * 8,
                       b < a.B ? src + (size_t)b * K3 + kc : src, b < a.B ? 16 : 0);
          }
        cp_async_commit();
      };
      __syncthreads();  // every warp is done with the ring's last chunks
#pragma unroll
      for (int ch = 0; ch < kStages - 1; ++ch) stage(ch);
      acc[0] = acc[1] = acc[2] = acc[3] = 0.f;
      const int kw = mine > 0 ? k1 : k0;
      for (int ch = 0; ch < nkc; ++ch) {
        cp_async_wait<kStages - 2>();
        __syncthreads();  // chunk ch landed for every thread; chunk ch-1's buffers are free
        stage(ch + kStages - 1);
        if (mine < 0) continue;
        // each k16 product into a fresh fragment, then added to acc in k
        // order in f32: the tensor core's own accumulation truncates
        const bf16* hs = ring + ((ch % kStages) * 2 + mine) * kSlot + mt * 16 * kLdg;
        const int kc = min(kKc, Hp - ch * kKc);
        float part[kKc / 16][4];
#pragma unroll
        for (int kk = 0; kk < kKc / 16; ++kk) {
          if (16 * kk >= kc) continue;
          part[kk][0] = part[kk][1] = part[kk][2] = part[kk][3] = 0.f;
          const int kx = kw + ch * kKc + 16 * kk;
          uint32_t fa[4];
          ldmatrix_x4(fa, hs + 16 * kk, kLdg);
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(wrow + kx + 2 * q);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(wrow + kx + 8 + 2 * q);
          mma_bf16(part[kk], fa[0], fa[1], fa[2], fa[3], b0, b1);
        }
#pragma unroll
        for (int kk = 0; kk < kKc / 16; ++kk) {
          if (16 * kk >= kc) continue;
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[e] += part[kk][e];
        }
      }
    };

    // (A) the owners' gate math, from local values
    for (int tl = 0; tl < n_mine && owner; ++tl) {
      float* st = state + (size_t)tl * kFields * kPairs;
      const int r0 = (tile0 + tl) * kRows;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int b = r0 + mt * 16 + g + 8 * (e >> 1), j = j0 + ul + (e & 1);
        if (b >= a.B || j >= a.H) continue;
        const int p = pair(e);
        const float u = sigmoid_f(to_f<bf16>(pre.u[e])), r = sigmoid_f(to_f<bf16>(pre.r[e]));
        const float c = tanhf(to_f<bf16>(pre.c[e])), hp = to_f<bf16>(pre.hp[e]);
        const float m = pre.m[e >> 1];
        const float dh = to_f<bf16>(pre.dh[e]) + st[p];
        const float dh_raw = m * dh;
        const bf16 dcq = from_f<bf16>(dh_raw * u * (1.f - c * c));
        const bf16 duq = from_f<bf16>(dh_raw * (c - hp) * u * (1.f - u));
        bf16* dxr = a.dx + ((size_t)t * a.B + b) * 3 * a.H + j;
        dxr[0] = duq;
        dxr[2 * a.H] = dcq;
        bf16* er = exs + (size_t)b * K3 + j;
        er[0] = duq;
        er[2 * Hp] = dcq;
        st[kPairs + p] = r;
        st[2 * kPairs + p] = hp;
        st[3 * kPairs + p] = (1.f - m) * dh + dh_raw * (1.f - u);
      }
      // the next (A)'s inputs: the next sub-tile's, or the next step's
      const int tl1 = tl + 1 < n_mine ? tl + 1 : 0, s1 = tl + 1 < n_mine ? s : s + 1;
      if (s1 < a.n_steps) prefetch(pre, a, s1, (tile0 + tl1) * kRows + mt * 16 + g, j0 + ul);
    }
    group_barrier(2 * s + 1);

    // (B) drh (owners, from dc) and the du part of the carry (warps 4-7, from du)
    for (int tl = 0; tl < n_mine; ++tl) {
      float* st = state + (size_t)tl * kFields * kPairs;
      const int r0 = (tile0 + tl) * kRows;
      float acc[4];
      product(acc, r0, 2, 2 * Hp, 0, owner ? 0 : 1);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int b = r0 + mt * 16 + g + 8 * (e >> 1), j = j0 + ul + (e & 1);
        const int p = pair(e);
        if (!owner) {
          st[4 * kPairs + p] = acc[e];
          continue;
        }
        if (b >= a.B || j >= a.H) continue;
        const float drh = acc[e], r = st[kPairs + p], hp = st[2 * kPairs + p];
        const bf16 drq = from_f<bf16>(drh * hp * r * (1.f - r));
        a.dx[((size_t)t * a.B + b) * 3 * a.H + a.H + j] = drq;
        exs[(size_t)b * K3 + Hp + j] = drq;
        st[3 * kPairs + p] += drh * r;
      }
    }
    if (s + 1 == a.n_steps) break;  // the last step's carry is no output
    group_barrier(2 * s + 2);

    // (C) the dr part, then the carry, rounded once
    for (int tl = 0; tl < n_mine; ++tl) {
      float* st = state + (size_t)tl * kFields * kPairs;
      const int r0 = (tile0 + tl) * kRows;
      float acc[4];
      product(acc, r0, 1, Hp, 0, owner ? 0 : -1);
      if (!owner) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int b = r0 + mt * 16 + g + 8 * (e >> 1), j = j0 + ul + (e & 1);
        if (b >= a.B || j >= a.H) continue;
        const int p = pair(e);
        st[p] = round_io<bf16>((st[3 * kPairs + p] + st[4 * kPairs + p]) + acc[e]);
      }
    }
  }
}

// How the card takes a launch: CTAs an SM, batch groups, sub-tiles a group,
// and whether W's rows are in shared memory.
struct TcPlan {
  int per_sm, groups, tiles_per_group, w_smem;
  size_t smem;
};

template <bool kWSmem>
cudaError_t occupancy(int* per_sm, size_t smem, int smem_max) {
  auto kernel = gru_bwd_tc_kernel<kWSmem>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, kThreads, smem);
}

// W's rows in shared memory where they fit beside the ring and one
// sub-tile's state, else through L1; then the most CTAs an SM for which the
// card holds every unit group times as many batch groups as it can, none
// empty, with their sub-tiles' state.
cudaError_t tc_plan(int B, int H, TcPlan* p) {
  int n_sms = 0, smem_max = 0;
  cudaError_t err = coop_device(&n_sms, &smem_max);
  if (err != cudaSuccess) return err;
  if (B < 1 || H < 1) return cudaErrorInvalidValue;
  const int Hp = (H + kUnits - 1) / kUnits * kUnits, n_ug = Hp / kUnits;
  const int n_tiles = (B + kRows - 1) / kRows;
  for (int w_smem = 1; w_smem >= 0; --w_smem) {
    const size_t w_bytes = w_smem ? (size_t)kUnits * (3 * Hp + 8) * sizeof(bf16) : 0;
    if (tc_smem(1, w_bytes) > (size_t)smem_max) continue;
    auto occ = [&](int* n, size_t smem) {
      return w_smem ? occupancy<true>(n, smem, smem_max) : occupancy<false>(n, smem, smem_max);
    };
    int most = 0;
    err = occ(&most, tc_smem(1, w_bytes));
    if (err != cudaSuccess) return err;
    for (int per_sm = most; per_sm >= 1; --per_sm) {
      const int cap = per_sm * n_sms;
      if (n_ug > cap) break;
      int groups = min(n_tiles, cap / n_ug);
      const int tpg = (n_tiles + groups - 1) / groups;
      groups = (n_tiles + tpg - 1) / tpg;
      const size_t smem = tc_smem(tpg, w_bytes);
      if (smem > (size_t)smem_max) continue;
      int got = 0;
      err = occ(&got, smem);
      if (err != cudaSuccess) return err;
      if (got * n_sms < n_ug * groups) continue;
      *p = TcPlan{got, groups, tpg, w_smem, smem};
      return cudaSuccess;
    }
  }
  return cudaErrorCooperativeLaunchTooLarge;
}

cudaError_t launch_tc(TcArgs a, cudaStream_t stream) {
  TcPlan p{};
  cudaError_t err = tc_plan(a.B, a.H, &p);
  if (err != cudaSuccess) return err;
  a.tiles_per_group = p.tiles_per_group;
  void* args[] = {&a};
  const void* kernel = p.w_smem ? reinterpret_cast<const void*>(gru_bwd_tc_kernel<true>)
                                : reinterpret_cast<const void*>(gru_bwd_tc_kernel<false>);
  err = cudaLaunchCooperativeKernel(kernel, dim3(a.Hp / kUnits, p.groups), dim3(kThreads), args,
                                    p.smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Units per CTA of the f32 kernel: the smallest power of two that puts at
// most one CTA on each SM, as gru_fwd.cu chooses. Returns 0 when H needs
// more than 32.
extern "C" int gru_bwd_columns_per_cta(int H, int n_sms) {
  for (int hc = 1; hc <= 32; hc *= 2)
    if ((H + hc - 1) / hc <= n_sms) return hc;
  return 0;
}

// The bf16 kernel's plan at (B, H) on the current device: out[0..3] = CTAs
// an SM, batch groups, sub-tiles a group, W's rows in shared memory (0/1).
extern "C" int gru_bwd_tc_plan(int B, int H, int* out) {
  TcPlan p{};
  const cudaError_t err = tc_plan(B, H, &p);
  if (err != cudaSuccess) return err;
  out[0] = p.per_sm;
  out[1] = p.groups;
  out[2] = p.tiles_per_group;
  out[3] = p.w_smem;
  return cudaSuccess;
}

// ur_pre [T,B,2H], c_pre, h_prev, rh, dh_seq [T,B,H], dhT [B,H], dx
// [T,B,3H], dw [H,3H]: io dtype (bf16 when io_bf16, else f32), contiguous;
// mask [T,B] f32. dw is written only when acc_dw.
//   f32:  w [H,3H]; ws = scratch dcp [B,H] f32, then dur [B,2H] f32.
//   bf16: w padded [Hp,3Hp] (rnn_kernels.pad_w_bwd, Hp = H rounded up to
//         16); ws zeroed = the exchange [2,B,3Hp] bf16, then the barrier
//         counters [ceil(B/32)] u32.
// Returns a cudaError_t: cudaErrorInvalidValue where the shape is out of
// the kernel's range.
extern "C" int gru_bwd_launch(int io_bf16, const void* ur_pre, const void* c_pre,
                              const void* h_prev, const void* rh, const void* dh_seq,
                              const void* mask, const void* w, const void* dhT, void* dx,
                              void* dw, void* ws, int n_steps, int B, int H, int reverse,
                              int acc_dw, void* stream) {
  int n_sms = 0, smem_max = 0;
  cudaError_t err = ptt::coop_device(&n_sms, &smem_max);
  if (err != cudaSuccess) return err;
  if (n_steps < 1 || B < 1 || H < 1) return cudaErrorInvalidValue;
  const float* m = static_cast<const float*>(mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!io_bf16) {
    const int hc = gru_bwd_columns_per_cta(H, n_sms);
    if (hc == 0 || (acc_dw && hc > kMaxDwColumns)) return cudaErrorInvalidValue;
    const void* in[] = {ur_pre, c_pre, h_prev, rh, dh_seq, w, dhT};
    float* dcp = static_cast<float*>(ws);
    return launch_hc<float>(hc, in, m, dx, dw, dcp, dcp + (size_t)B * H, n_steps, B, H, reverse,
                            acc_dw, n_sms, st);
  }
  TcArgs a{};
  a.ur_pre = static_cast<const bf16*>(ur_pre);
  a.c_pre = static_cast<const bf16*>(c_pre);
  a.h_prev = static_cast<const bf16*>(h_prev);
  a.dh_seq = static_cast<const bf16*>(dh_seq);
  a.mask = m;
  a.wp = static_cast<const bf16*>(w);
  a.dhT = static_cast<const bf16*>(dhT);
  a.dx = static_cast<bf16*>(dx);
  a.n_steps = n_steps;
  a.B = B;
  a.H = H;
  a.Hp = (H + kUnits - 1) / kUnits * kUnits;
  a.reverse = reverse;
  a.n_tiles = (B + kRows - 1) / kRows;
  a.ex = static_cast<bf16*>(ws);
  a.bar = reinterpret_cast<unsigned*>(a.ex + (size_t)2 * B * 3 * a.Hp);
  err = launch_tc(a, st);
  if (err != cudaSuccess || !acc_dw) return err;
  // dW = [h_prevᵀ dx_ur | rhᵀ dx_c] over the T·B rows
  const int R = n_steps * B;
  const bool vec = H % 8 == 0;
  bf16* dwp = static_cast<bf16*>(dw);
  err = launch_dw_product(a.h_prev, H, a.dx, 3 * H, dwp, 3 * H, R, H, 2 * H, vec, st);
  if (err != cudaSuccess) return err;
  return launch_dw_product(static_cast<const bf16*>(rh), H, a.dx + 2 * H, 3 * H, dwp + 2 * H,
                           3 * H, R, H, H, vec, st);
}

extern "C" const char* gru_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
