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
// What bounds it: the T dependent steps, not bytes or operations (at T=50,
// B=256, H=512 in bf16 the products are 20 GFLOP, 20 µs at the card's
// peak). Each step has two dependent products: u and r need all of h from
// the step before, and c needs all of rh = io(r·h), which needs r of every
// unit. So CTAs that own different hidden units meet twice a step.
//
// bf16, the slice's dtype, runs on the tensor cores, on csrc/lstm_fwd.cu's
// plan:
// - The grid is unit groups x batch groups. A CTA owns 16 hidden units and
//   the batch rows of one group (32 rows a sub-tile; a group takes several
//   sub-tiles only where the card cannot hold a CTA for each). Its 48
//   columns of W (u, r and c of its units) stay in shared memory for the
//   whole launch (48 KB at H=512), in the layout rnn_kernels.pack_w packs
//   them to: K contiguous, the column-major B operand of mma.sync
//   m16n8k16, so nothing is transposed. Where the slice does not fit, or
//   the card cannot then hold every CTA, the same fragments are read from
//   device memory through L1.
// - u and r of one unit are neighbouring columns of one n-tile (packed
//   columns 8·uq + 2r and 8·uq + 2r + 1 hold u and r of unit 4·uq + r), so
//   warp (m-tile, uq)'s accumulator lane r holds both for rows g and g+8.
//   c's 16 columns are kept apart; in the c product lane g of the n-tile
//   reads c of unit 4·uq + g/2 for even g and a zero column for odd g, so
//   the same lane gets c of the same unit. Each lane owns two (row, unit)
//   pairs through both phases; h and u stay in its registers (through
//   h_seq and a u scratch where a CTA walks several sub-tiles).
// - Two exchanges a step, each behind a barrier among the CTAs of one batch
//   group: (a) stage the group's h rows, the [32, Hp] x [Hp, 32] u, r
//   product, publish io(r·h) for the CTA's units, barrier; (b) stage the rh
//   rows, the [32, Hp] x [Hp, 16] c product, the masked carry in registers,
//   write h_seq, publish h, barrier. One exchange a step would need every
//   CTA to compute r for all H units, with all of W_r (512 KB at H=512):
//   it neither fits in shared memory nor is cheap to stream from L2 every
//   step. So the design takes two.
// - Each k16 product goes into a fresh fragment and the fragments are
//   added in f32, in k order: the tensor core's own accumulation truncates,
//   and over H terms that bias would move h past the plain version's
//   rounding.
// - A phase's rows are staged in 64-wide chunks copied 16 bytes at a time
//   with cp.async.cg (past L1, which is not coherent across SMs), three
//   chunks in flight. x, the mask and the carried values of the next phase
//   are loaded before each barrier: they do not depend on the exchange.
// - The barrier: a counter per batch group in global memory, added to with
//   release and polled with acquire order after a __syncthreads; a counter
//   that does not fill within seconds traps rather than hangs. A
//   cooperative launch keeps every CTA resident, so the counters cannot
//   deadlock. The exchanges are double-buffered by step parity: h is
//   written into hbuf[(s+1)&1] in phase (b) of step s and read in phase
//   (a) of step s+1; rh into rhbuf[s&1] in (a) and read in (b) of step s.
//   A buffer is written again two steps later, behind at least the three
//   barriers between: the barrier after (a) of step s+1 orders every read
//   of hbuf[(s+1)&1] before its next write in (b) of step s+2, and the
//   barrier after (b) of step s orders every read of rhbuf[s&1] before its
//   next write in (a) of step s+2. (Each read of a phase is also ordered
//   before the next write of the same buffer by the barrier that ends the
//   phase, so one buffer each would do; the parity keeps each step's
//   exchange whole for the reader.)
// What still holds it back: the chain of one phase (the barrier's round
// trip through L2, the staged rows, the product, the transcendental
// functions, the stores that must land before the next release), twice a
// step.
//
// f32 io keeps the exact f32 kernel on CUDA cores (no TF32) the port had
// before: each CTA owns HC hidden units and keeps their 3*HC columns of W
// in shared memory; h and rh live in small global buffers that stay in L2
// and are read with ld.cg; one warp a batch row with the lanes splitting
// H; a whole-grid barrier (grid.sync()) twice a step.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace ptt;
using bf16 = __nv_bfloat16;

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

// ----------------------------------------------------------------- bf16 --
constexpr int kUnits = 16;           // hidden units a CTA owns (lstm_kernels.UNITS_PER_CTA)
constexpr int kUrCols = 2 * kUnits;  // their u and r columns, packed in pairs
constexpr int kCols = 3 * kUnits;    // and c's 16 (rnn_kernels.PACKED_COLUMNS)
constexpr int kRows = 32;            // batch rows of a sub-tile: two m-tiles of 16
constexpr int kKc = 64;              // k of a staged chunk
constexpr int kStages = 3;           // chunks in the ring
constexpr int kLdh = kKc + 8;        // a staged row, padded by 16 bytes against bank conflicts
constexpr long long kSpinCycles = 20000000000LL;  // about 10 s: a barrier that never fills traps
constexpr size_t kStageBytes = (size_t)kStages * kRows * kLdh * sizeof(bf16);

struct TcArgs {
  const bf16* x;      // [T, B, 3H]
  const float* mask;  // [T, B]
  const bf16* wp;     // [n_ug, kCols, Hp], packed
  bf16 *h_seq, *h_T;
  bf16 *hbuf, *rhbuf;  // [2, B, Hp] each, zeroed
  float* ubuf;         // [B, Hp]: u from (a) to (b) where a CTA walks several sub-tiles
  unsigned* bar;       // [n_tiles], zeroed
  int n_steps, B, H, Hp, reverse, n_tiles, tiles_per_group;
};

// One (batch row, unit) pair's inputs to a phase that do not depend on the
// exchange: (a) x_u and x_r; (b) x_c, the mask and u; both the carried h
// (io-rounded). Where the CTA walks one sub-tile, h and u stay in the
// lane's registers instead (`carried`).
struct Pre {
  bf16 x0, x1;  // kept raw: converted at their use, so the loads stay in flight
  float m, h, u;
};

__device__ __forceinline__ void prefetch(Pre& p, const TcArgs& a, int s, int ph, int b, int j,
                                         bool carried) {
  if (b >= a.B || j >= a.H) return;
  const int t = a.reverse ? a.n_steps - 1 - s : s;
  const bf16* xr = a.x + ((size_t)t * a.B + b) * 3 * a.H + j;
  if (ph == 0) {
    p.x0 = xr[0];
    p.x1 = xr[a.H];
  } else {
    p.x0 = xr[2 * a.H];
    p.m = a.mask[(size_t)t * a.B + b];
    if (!carried) p.u = a.ubuf[(size_t)b * a.Hp + j];  // this lane's own store in (a)
  }
  if (carried) return;
  if (s == 0) {
    p.h = 0.f;
  } else {  // h_seq of the step before, which this lane wrote
    const int tp = a.reverse ? t + 1 : t - 1;
    p.h = to_f<bf16>(a.h_seq[((size_t)tp * a.B + b) * a.H + j]);
  }
}

// grid (Hp / kUnits unit groups, batch groups); warp w computes rows
// 16·(w/4) + {g, g+8} of each sub-tile for units 4·(w%4) + q of the group.
template <bool kWSmem>
__global__ void __launch_bounds__(kThreads, 2) gru_fwd_tc_kernel(TcArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* hst = reinterpret_cast<bf16*>(smem_raw);  // [kStages][kRows][kLdh]
  bf16* wsh = hst + kStages * kRows * kLdh;       // [kCols][Hp + 8] when kWSmem
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mt = warp >> 2, uq = warp & 3, g = lane >> 2, q = lane & 3;
  const int j = blockIdx.x * kUnits + uq * 4 + q;  // this lane's hidden unit
  const int Hp = a.Hp, ldw = kWSmem ? Hp + 8 : Hp;
  const bf16* wsrc = a.wp + (size_t)blockIdx.x * kCols * Hp;
  if (kWSmem) {
    const int pieces = Hp / 8;
    for (int i = tid; i < kCols * pieces; i += kThreads) {
      const int n = i / pieces, p = i - n * pieces;
      *reinterpret_cast<uint4*>(wsh + n * ldw + p * 8) =
          *reinterpret_cast<const uint4*>(wsrc + (size_t)n * Hp + p * 8);
    }
  }
  const bf16* wb = kWSmem ? wsh : wsrc;
  // the B column this lane loads (n = g of the warp's n-tile): (a) packed
  // column 8·uq + g; (b) c of unit 4·uq + g/2 for even g, a zero for odd g
  const bf16* w_ur = wb + (size_t)(uq * 8 + g) * ldw;
  const bf16* w_c = wb + (size_t)(kUrCols + uq * 4 + (g >> 1)) * ldw;
  const int tile0 = blockIdx.y * a.tiles_per_group;
  const int n_mine = min(a.n_tiles, tile0 + a.tiles_per_group) - tile0;
  const bool carried = n_mine == 1;
  const int n_items = 2 * a.n_steps * n_mine;  // (step, phase, sub-tile), in that order
  const int nkc = (Hp + kKc - 1) / kKc;
  unsigned* bar = a.bar + blockIdx.y;
  const int srow = tid >> 3, spiece = tid & 7;  // the 16 bytes this thread stages

  float hcar[2] = {0.f, 0.f}, ucar[2] = {0.f, 0.f};
  Pre pre[2];
  prefetch(pre[0], a, 0, 0, tile0 * kRows + mt * 16 + g, j, carried);
  prefetch(pre[1], a, 0, 0, tile0 * kRows + mt * 16 + g + 8, j, carried);
  for (int it = 0; it < n_items; ++it) {
    const int s = it / (2 * n_mine), ph = (it / n_mine) & 1, tl = it % n_mine;
    const int r0 = (tile0 + tl) * kRows;
    const int t = a.reverse ? a.n_steps - 1 - s : s;
    const bf16* src = (ph == 0 ? a.hbuf : a.rhbuf) + (size_t)(s & 1) * a.B * Hp;
    auto stage = [&](int c) {  // chunk c of rows [r0, r0 + kRows); always one group
      const int k = c * kKc + spiece * 8, b = r0 + srow;
      if (k < Hp)
        cp_async16(hst + ((c % kStages) * kRows + srow) * kLdh + spiece * 8,
                   b < a.B ? src + (size_t)b * Hp + k : src, b < a.B ? 16 : 0);
      cp_async_commit();
    };
    __syncthreads();  // W is in place; every warp is done with the ring's last chunks
#pragma unroll
    for (int c = 0; c < kStages - 1; ++c) stage(c);
    const bf16* wrow = ph == 0 ? w_ur : w_c;
    const bool live = ph == 0 || (g & 1) == 0;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int c = 0; c < nkc; ++c) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // chunk c landed for every thread; chunk c-1's buffer is free
      stage(c + kStages - 1);
      // each k16 product into a fresh fragment, the four of a chunk
      // independent, then added to acc in k order in f32
      const bf16* hs = hst + ((c % kStages) * kRows + mt * 16) * kLdh;
      const int kc = min(kKc, Hp - c * kKc);
      float part[kKc / 16][4];
#pragma unroll
      for (int kk = 0; kk < kKc / 16; ++kk) {
        if (16 * kk >= kc) continue;
        part[kk][0] = part[kk][1] = part[kk][2] = part[kk][3] = 0.f;
        const int k = c * kKc + 16 * kk;
        uint32_t fa[4];
        ldmatrix_x4(fa, hs + 16 * kk, kLdh);
        const uint32_t b0 = live ? *reinterpret_cast<const uint32_t*>(wrow + k + 2 * q) : 0u;
        const uint32_t b1 = live ? *reinterpret_cast<const uint32_t*>(wrow + k + 8 + 2 * q) : 0u;
        mma_bf16(part[kk], fa[0], fa[1], fa[2], fa[3], b0, b1);
      }
#pragma unroll
      for (int kk = 0; kk < kKc / 16; ++kk) {
        if (16 * kk >= kc) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[e] += part[kk][e];
      }
    }
    // acc[2·rr] and acc[2·rr + 1] are columns 2q, 2q + 1 of row g + 8·rr:
    // (a) u and r of unit j; (b) c of unit j and a zero
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int b = r0 + mt * 16 + g + 8 * rr;
      if (b >= a.B || j >= a.H) continue;
      const Pre& p = pre[rr];
      const float h = carried ? hcar[rr] : p.h;
      if (ph == 0) {
        const float u = sigmoid_f(to_f<bf16>(p.x0) + acc[2 * rr]);
        const float r = sigmoid_f(to_f<bf16>(p.x1) + acc[2 * rr + 1]);
        a.rhbuf[(size_t)(s & 1) * a.B * Hp + (size_t)b * Hp + j] = from_f<bf16>(r * h);
        if (carried)
          ucar[rr] = u;
        else
          a.ubuf[(size_t)b * Hp + j] = u;
      } else {
        const float u = carried ? ucar[rr] : p.u;
        const float c = tanhf(to_f<bf16>(p.x0) + acc[2 * rr]);
        const float hn = (1.f - u) * h + u * c;
        const bf16 hv = from_f<bf16>(p.m * hn + (1.f - p.m) * h);
        if (carried) hcar[rr] = to_f<bf16>(hv);
        a.hbuf[(size_t)((s + 1) & 1) * a.B * Hp + (size_t)b * Hp + j] = hv;
        a.h_seq[((size_t)t * a.B + b) * a.H + j] = hv;
        if (s == a.n_steps - 1) a.h_T[(size_t)b * a.H + j] = hv;
      }
    }
    if (it + 1 == n_items) break;
    {  // the next item's inputs, ahead of the barrier
      const int i1 = it + 1, s1 = i1 / (2 * n_mine), ph1 = (i1 / n_mine) & 1;
      const int b1 = (tile0 + i1 % n_mine) * kRows + mt * 16 + g;
      prefetch(pre[0], a, s1, ph1, b1, j, carried);
      prefetch(pre[1], a, s1, ph1, b1 + 8, j, carried);
    }
    if (tl == n_mine - 1) {  // the group's barrier, after each phase
      __syncthreads();
      if (tid == 0) {  // release covers the CTA's writes before the __syncthreads
        atomic_add_release(bar, 1u);
        const unsigned target = (unsigned)(2 * s + ph + 1) * gridDim.x;
        const long long start = clock64();
        while (load_acquire(bar) < target)
          if (clock64() - start > kSpinCycles) __trap();
      }
      __syncthreads();
    }
  }
}

// How the card takes a launch: CTAs a SM, batch groups, sub-tiles a group,
// and whether W's slice is in shared memory.
struct TcPlan {
  int per_sm, groups, tiles_per_group, w_smem;
  size_t smem;
};

template <bool kWSmem>
cudaError_t occupancy(int* per_sm, size_t smem) {
  auto kernel = gru_fwd_tc_kernel<kWSmem>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, kThreads, smem);
}

// W's slice in shared memory where it fits and the card then holds every
// unit group; as many batch groups as the card holds beside the unit
// groups, none empty. Two CTAs an SM where they fit (launch bounds), which
// at B=256, H=512 gives every sub-tile a CTA.
cudaError_t tc_plan(int B, int H, TcPlan* p) {
  int n_sms = 0, smem_max = 0;
  cudaError_t err = coop_device(&n_sms, &smem_max);
  if (err != cudaSuccess) return err;
  if (B < 1 || H < 1) return cudaErrorInvalidValue;
  const int Hp = (H + kUnits - 1) / kUnits * kUnits, n_ug = Hp / kUnits;
  const int n_tiles = (B + kRows - 1) / kRows;
  const size_t w_bytes = (size_t)kCols * (Hp + 8) * sizeof(bf16);
  p->w_smem = 0;
  if (kStageBytes + w_bytes <= (size_t)smem_max) {
    err = occupancy<true>(&p->per_sm, kStageBytes + w_bytes);
    if (err != cudaSuccess) return err;
    p->w_smem = p->per_sm * n_sms >= n_ug;
  }
  p->smem = kStageBytes + (p->w_smem ? w_bytes : 0);
  if (!p->w_smem) {
    err = occupancy<false>(&p->per_sm, p->smem);
    if (err != cudaSuccess) return err;
  }
  const int cap = p->per_sm * n_sms;
  if (n_ug > cap) return cudaErrorCooperativeLaunchTooLarge;
  p->groups = min(n_tiles, cap / n_ug);
  p->tiles_per_group = (n_tiles + p->groups - 1) / p->groups;
  p->groups = (n_tiles + p->tiles_per_group - 1) / p->tiles_per_group;
  return cudaSuccess;
}

cudaError_t launch_tc(TcArgs a, cudaStream_t stream) {
  TcPlan p{};
  cudaError_t err = tc_plan(a.B, a.H, &p);
  if (err != cudaSuccess) return err;
  a.tiles_per_group = p.tiles_per_group;
  void* args[] = {&a};
  const void* kernel = p.w_smem ? reinterpret_cast<const void*>(gru_fwd_tc_kernel<true>)
                                : reinterpret_cast<const void*>(gru_fwd_tc_kernel<false>);
  const dim3 grid(a.Hp / kUnits, p.groups);
  err = cudaLaunchCooperativeKernel(kernel, grid, dim3(kThreads), args, p.smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Columns per CTA of the f32 kernel: the smallest power of two that puts
// at most one CTA on each SM, so every CTA reads h once per phase for as
// many columns as it can. Returns 0 when H needs more than 32 columns per
// CTA.
extern "C" int gru_fwd_columns_per_cta(int H, int n_sms) {
  for (int hc = 1; hc <= 32; hc *= 2)
    if ((H + hc - 1) / hc <= n_sms) return hc;
  return 0;
}

// The bf16 kernel's plan at (B, H) on the current device: out[0..3] = CTAs
// an SM, batch groups, sub-tiles a group, W's slice in shared memory (0/1).
extern "C" int gru_fwd_tc_plan(int B, int H, int* out) {
  TcPlan p{};
  const cudaError_t err = tc_plan(B, H, &p);
  if (err != cudaSuccess) return err;
  out[0] = p.per_sm;
  out[1] = p.groups;
  out[2] = p.tiles_per_group;
  out[3] = p.w_smem;
  return cudaSuccess;
}

// x [T,B,3H], h_seq [T,B,H], h_T [B,H]: io dtype (bf16 when io_bf16, else
// f32), contiguous; mask [T,B] f32; ws a zeroed workspace:
//   f32:  w [H,3H]; ws = hbuf [2,B,H] f32, then rh [B,H] f32.
//   bf16: w packed [Hp/16, 48, Hp] (rnn_kernels.pack_w, Hp = H rounded up
//         to 16); ws = hbuf [2,B,Hp] bf16, rhbuf [2,B,Hp] bf16, ubuf
//         [B,Hp] f32, then the barrier counters [ceil(B/32)] u32.
// Returns a cudaError_t: cudaErrorInvalidValue where the shape is out of
// the kernel's range.
extern "C" int gru_fwd_launch(int io_bf16, const void* x, const void* mask, const void* w,
                              void* h_seq, void* h_T, void* ws, int n_steps, int B, int H,
                              int reverse, void* stream) {
  int n_sms = 0, smem_max = 0;
  const cudaError_t err = ptt::coop_device(&n_sms, &smem_max);
  if (err != cudaSuccess) return err;
  if (n_steps < 1 || B < 1 || H < 1) return cudaErrorInvalidValue;
  const float* m = static_cast<const float*>(mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!io_bf16) {
    const int hc = gru_fwd_columns_per_cta(H, n_sms);
    if (hc == 0) return cudaErrorInvalidValue;
    float* hbuf = static_cast<float*>(ws);
    return launch_hc<float>(hc, x, m, w, h_seq, h_T, hbuf, hbuf + (size_t)2 * B * H, n_steps, B,
                            H, reverse, n_sms, st);
  }
  TcArgs a{};
  a.x = static_cast<const bf16*>(x);
  a.mask = m;
  a.wp = static_cast<const bf16*>(w);
  a.h_seq = static_cast<bf16*>(h_seq);
  a.h_T = static_cast<bf16*>(h_T);
  a.n_steps = n_steps;
  a.B = B;
  a.H = H;
  a.Hp = (H + kUnits - 1) / kUnits * kUnits;
  a.reverse = reverse;
  a.n_tiles = (B + kRows - 1) / kRows;
  const size_t plane = (size_t)B * a.Hp;
  a.hbuf = static_cast<bf16*>(ws);
  a.rhbuf = a.hbuf + 2 * plane;
  a.ubuf = reinterpret_cast<float*>(a.rhbuf + 2 * plane);
  a.bar = reinterpret_cast<unsigned*>(a.ubuf + plane);
  return launch_tc(a, st);
}

extern "C" const char* gru_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
