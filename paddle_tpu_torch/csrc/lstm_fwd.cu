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
// What bounds it: the T dependent steps, not bytes or operations (at T=100,
// B=128, H=512 in bf16 the product is 13.4 GFLOP, 14 µs at the card's
// peak). Each step's [B,H]x[H,4H] product needs all of h from the step
// before, so CTAs that own different hidden units meet once a step, and a
// step costs at least one barrier among them plus one round trip through
// L2 of the h they exchange: a few µs, some hundreds of µs a launch.
//
// bf16, the slice's dtype, runs on the tensor cores:
// - The grid is unit groups x batch groups. A CTA owns 16 hidden units (64
//   gate columns) and the batch rows of one group (32 rows a sub-tile; a
//   group takes several sub-tiles only where the card cannot hold a CTA for
//   each). Its slice of W stays in shared memory for the whole launch (64
//   KB at H=512), in the layout the wrapper packs it to (lstm_kernels.
//   pack_w): K contiguous, the column-major B operand of mma.sync m16n8k16,
//   read with ldmatrix, so nothing is transposed. Where the slice does not
//   fit (H above about 1650), the same fragments are read from device
//   memory through L1.
// - The columns are ordered so that one thread's accumulator fragment
//   holds i, f, g and o of one hidden unit for two batch rows (g and g+8):
//   columns 2q, 2q+1 of a warp's first n-tile are i and f of its unit q,
//   of the second n-tile g and o. The cell update then runs in registers on
//   every lane, no shuffles; c and h are carried in registers (through
//   c_seq and h_seq, which the same thread wrote, where a CTA walks several
//   sub-tiles).
// - Each k16 product goes into a fresh fragment and the fragments are
//   added in f32, in k order: the tensor core's own accumulation truncates,
//   and over H terms that bias would move h past the plain version's
//   rounding (on an H100, about twice as many bf16 flips of h_seq at the
//   slice's shapes).
// - h is staged once a step, the CTA's 32 rows in 64-wide chunks copied
//   16 bytes at a time with cp.async.cg (past L1, which is not coherent
//   across SMs), three chunks in flight. L2 traffic is B·H·2 bytes times
//   the unit groups: 4 MB a step at the slice's shapes.
// - x_t and the mask of the next step are loaded before the barrier and
//   kept raw until used; they do not depend on the exchanged h.
// - The barrier is among the CTAs of one batch group only (rows never
//   depend on each other): a counter in global memory, added to with
//   release and polled with acquire order after a __syncthreads. h is
//   published into one of two buffers; the barrier after step s orders
//   every read of buffer s&1 before any write to it at step s+1. A
//   cooperative launch keeps every CTA resident, so the counters are safe;
//   a counter that does not fill within seconds traps rather than hangs.
// What still holds it back: the chain of one step (the barrier's round
// trip through L2, the staged h's, the product, the cell's transcendental
// functions, the stores that must land before the next release): 10-13 µs
// a step on an H100 at the slice's shapes, where the product alone needs
// under one.
//
// f32 io keeps the exact f32 product on CUDA cores (no TF32) the port had
// before this kernel: one warp per batch row with the lanes splitting H,
// 4·HC columns of W in shared memory, c in shared memory, one grid
// barrier a step.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace ptt;
using bf16 = __nv_bfloat16;

// ------------------------------------------------------------------ f32 --
template <int HC>
__global__ void __launch_bounds__(kThreads)
lstm_fwd_f32_kernel(const float* __restrict__ x, const float* __restrict__ mask,
                    const float* __restrict__ w, float* __restrict__ h_seq,
                    float* __restrict__ c_seq, float* __restrict__ h_T, float* __restrict__ c_T,
                    float* hbuf, int n_steps, int B, int H, int reverse) {
  cg::grid_group grid = cg::this_grid();
  constexpr int G = 4 * HC;  // this CTA's gate columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* c_sh = reinterpret_cast<float*>(smem_raw);  // [B][HC] carried c
  float* w_sh = c_sh + (size_t)B * HC;                 // [4][HC][H], k fastest

  const int j0 = blockIdx.x * HC;
  const int H4 = 4 * H;
  for (int i = threadIdx.x; i < G * H; i += blockDim.x) {
    const int k = i % H, jj = (i / H) % HC, q = i / (H * HC);
    const int j = j0 + jj;
    w_sh[i] = j < H ? w[(size_t)k * H4 + q * H + j] : 0.f;
  }
  for (int i = threadIdx.x; i < B * HC; i += blockDim.x) c_sh[i] = 0.f;
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int s = 0; s < n_steps; ++s) {
    const int t = reverse ? n_steps - 1 - s : s;
    const float* hp = hbuf + (size_t)(s & 1) * B * H;
    float* hn = hbuf + (size_t)((s + 1) & 1) * B * H;

    for (int b = warp; b < B; b += kWarps) {
      const float* hrow = hp + (size_t)b * H;
      float acc[G];
#pragma unroll
      for (int q = 0; q < G; ++q) acc[q] = 0.f;
      for (int k = lane; k < H; k += 32) {
        const float hv = __ldcg(hrow + k);
#pragma unroll
        for (int q = 0; q < G; ++q) acc[q] += hv * w_sh[q * H + k];
      }
#pragma unroll
      for (int q = 0; q < G; ++q) acc[q] = warp_sum(acc[q]);
      const float* xrow = x + ((size_t)t * B + b) * H4;
      const float m = mask[(size_t)t * B + b];
#pragma unroll
      for (int jj = 0; jj < HC; ++jj) {
        const int j = j0 + jj;
        if (lane == jj && j < H) {
          const float gi = sigmoid_f(xrow[j] + acc[jj]);
          const float gf = sigmoid_f(xrow[H + j] + acc[HC + jj]);
          const float gg = tanhf(xrow[2 * H + j] + acc[2 * HC + jj]);
          const float go = sigmoid_f(xrow[3 * H + j] + acc[3 * HC + jj]);
          const float cp = c_sh[b * HC + jj];
          const float hpv = __ldcg(hrow + j);
          const float c = gf * cp + gi * gg;
          const float h = go * tanhf(c);
          const float hv = m * h + (1.f - m) * hpv;
          const float cv = m * c + (1.f - m) * cp;
          c_sh[b * HC + jj] = cv;
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

size_t f32_smem_bytes(int B, int H, int hc) {
  return (size_t)B * hc * sizeof(float) + (size_t)4 * hc * H * sizeof(float);
}

template <int HC>
cudaError_t launch_f32(const float* x, const float* mask, const float* w, float* const* out,
                       float* hbuf, int n_steps, int B, int H, int reverse, int n_sms,
                       cudaStream_t stream) {
  auto kernel = lstm_fwd_f32_kernel<HC>;
  const int grid = (H + HC - 1) / HC;
  const size_t smem = f32_smem_bytes(B, H, HC);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm * n_sms < grid) return cudaErrorCooperativeLaunchTooLarge;
  float *hs = out[0], *cs = out[1], *ht = out[2], *ct = out[3];
  void* args[] = {&x, &mask, &w, &hs, &cs, &ht, &ct, &hbuf, &n_steps, &B, &H, &reverse};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(grid),
                                    dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

cudaError_t launch_f32_hc(int hc, const float* x, const float* mask, const float* w,
                          float* const* out, float* hbuf, int n_steps, int B, int H, int reverse,
                          int n_sms, cudaStream_t st) {
  switch (hc) {
    case 1: return launch_f32<1>(x, mask, w, out, hbuf, n_steps, B, H, reverse, n_sms, st);
    case 2: return launch_f32<2>(x, mask, w, out, hbuf, n_steps, B, H, reverse, n_sms, st);
    case 4: return launch_f32<4>(x, mask, w, out, hbuf, n_steps, B, H, reverse, n_sms, st);
    case 8: return launch_f32<8>(x, mask, w, out, hbuf, n_steps, B, H, reverse, n_sms, st);
    case 16: return launch_f32<16>(x, mask, w, out, hbuf, n_steps, B, H, reverse, n_sms, st);
    default: return cudaErrorInvalidValue;
  }
}

// ----------------------------------------------------------------- bf16 --
constexpr int kUnits = 16;         // hidden units a CTA owns (lstm_kernels.UNITS_PER_CTA)
constexpr int kCols = 4 * kUnits;  // their gate columns, packed
constexpr int kRows = 32;          // batch rows of a sub-tile: two m-tiles of 16
constexpr int kKc = 64;            // k of a staged chunk of h
constexpr int kStages = 3;         // chunks in the ring
constexpr int kLdh = kKc + 8;      // a staged row, padded by 16 bytes against bank conflicts
constexpr long long kSpinCycles = 20000000000LL;  // about 10 s: a barrier that never fills traps
constexpr size_t kStageBytes = (size_t)kStages * kRows * kLdh * sizeof(bf16);

struct TcArgs {
  const bf16* x;     // [T, B, 4H]
  const float* mask; // [T, B]
  const bf16* wp;    // [n_ug, kCols, Hp], packed
  bf16 *h_seq, *c_seq, *h_T, *c_T;
  bf16* hbuf;        // [2, B, Hp], zeroed
  unsigned* bar;     // [groups], zeroed
  int n_steps, B, H, Hp, reverse, n_tiles, tiles_per_group;
};

// One (batch row, unit) pair's inputs to a step that do not depend on the
// exchanged h: its four gate inputs, the mask, and the carried h and c
// (io-rounded, from h_seq and c_seq of the step before, which this thread
// wrote).
struct Pre {
  bf16 x[4];  // kept raw: converted at its use, so the load stays in flight
  float m, c, h;
};

__device__ __forceinline__ void prefetch(Pre& p, const TcArgs& a, int s, int b, int j,
                                         bool carried) {
  if (b >= a.B || j >= a.H) return;
  const int t = a.reverse ? a.n_steps - 1 - s : s;
  const bf16* xr = a.x + ((size_t)t * a.B + b) * 4 * a.H + j;
#pragma unroll
  for (int q = 0; q < 4; ++q) p.x[q] = xr[(size_t)q * a.H];
  p.m = a.mask[(size_t)t * a.B + b];
  if (carried) return;  // p.c and p.h hold the step before's, in registers
  if (s == 0) {
    p.c = p.h = 0.f;
  } else {
    const size_t o = ((size_t)(a.reverse ? t + 1 : t - 1) * a.B + b) * a.H + j;
    p.c = to_f<bf16>(a.c_seq[o]);
    p.h = to_f<bf16>(a.h_seq[o]);
  }
}

// grid (Hp / kUnits unit groups, batch groups); warp w updates rows
// 16·(w/4) + {g, g+8} of each sub-tile and unit 4·(w%4) + q of the group.
template <bool kWSmem>
__global__ void __launch_bounds__(kThreads) lstm_fwd_tc_kernel(TcArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* hst = reinterpret_cast<bf16*>(smem_raw);  // [kStages][kRows][kLdh]
  bf16* wsh = hst + kStages * kRows * kLdh;       // [kCols][Hp + 8] when kWSmem
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mt = warp >> 2, uq = warp & 3, g = lane >> 2;
  const int j = blockIdx.x * kUnits + uq * 4 + (lane & 3);  // this thread's hidden unit
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
  const bf16* wb = (kWSmem ? wsh : wsrc) + uq * 16 * ldw;  // the warp's 16 packed columns
  const int tile0 = blockIdx.y * a.tiles_per_group;
  const int n_mine = min(a.n_tiles, tile0 + a.tiles_per_group) - tile0;
  const int n_items = a.n_steps * n_mine;  // (step, sub-tile), step-major
  const int nkc = (Hp + kKc - 1) / kKc;
  unsigned* bar = a.bar + blockIdx.y;
  const int srow = tid >> 3, spiece = tid & 7;  // the 16 bytes this thread stages

  Pre pre[2];
  prefetch(pre[0], a, 0, tile0 * kRows + mt * 16 + g, j, false);
  prefetch(pre[1], a, 0, tile0 * kRows + mt * 16 + g + 8, j, false);
  for (int it = 0; it < n_items; ++it) {
    const int s = it / n_mine, r0 = (tile0 + it % n_mine) * kRows;
    const int t = a.reverse ? a.n_steps - 1 - s : s;
    const bf16* hp = a.hbuf + (size_t)(s & 1) * a.B * Hp;
    bf16* hn = a.hbuf + (size_t)((s + 1) & 1) * a.B * Hp;
    auto stage = [&](int c) {  // chunk c of rows [r0, r0 + kRows); always one group
      const int k = c * kKc + spiece * 8, b = r0 + srow;
      if (k < Hp)
        cp_async16(hst + ((c % kStages) * kRows + srow) * kLdh + spiece * 8,
                   b < a.B ? hp + (size_t)b * Hp + k : hp, b < a.B ? 16 : 0);
      cp_async_commit();
    };
    __syncthreads();  // W is in place; every warp is done with the ring's last chunks
#pragma unroll
    for (int c = 0; c < kStages - 1; ++c) stage(c);
    float acc[2][4];
    zero(acc);
    for (int c = 0; c < nkc; ++c) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // chunk c landed for every thread; chunk c-1's buffer is free
      stage(c + kStages - 1);
      // each k16 product into a fresh fragment, the four of a chunk
      // independent, then added to acc in k order in f32: the tensor core's
      // own accumulation truncates, and over H terms that bias would move h
      // past the plain version's rounding
      const bf16* hs = hst + ((c % kStages) * kRows + mt * 16) * kLdh;
      const int kc = min(kKc, Hp - c * kKc);
      float part[kKc / 16][2][4];
#pragma unroll
      for (int kk = 0; kk < kKc / 16; ++kk) {
        if (16 * kk >= kc) continue;
        zero(part[kk]);
        const int k = c * kKc + 16 * kk;
        if constexpr (kWSmem) {
          uint32_t fa[4], fb[4];
          ldmatrix_x4(fa, hs + 16 * kk, kLdh);
          ldmatrix_x4(fb, wb + k, ldw);
          mma_bf16(part[kk][0], fa[0], fa[1], fa[2], fa[3], fb[0], fb[2]);
          mma_bf16(part[kk][1], fa[0], fa[1], fa[2], fa[3], fb[1], fb[3]);
        } else {
          WarpMma<bf16, 2, true>::run(part[kk], hs + 16 * kk, kLdh, wb + k, ldw, 16);
        }
      }
#pragma unroll
      for (int kk = 0; kk < kKc / 16; ++kk) {
        if (16 * kk >= kc) continue;
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] += part[kk][n][e];
      }
    }
    // the cell update: acc[0] holds i, f and acc[1] g, o of unit j, rows g
    // (elements 0, 1) and g+8 (2, 3)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int b = r0 + mt * 16 + g + 8 * rr;
      if (b >= a.B || j >= a.H) continue;
      const Pre p = pre[rr];
      const float gi = sigmoid_f(to_f<bf16>(p.x[0]) + acc[0][2 * rr]);
      const float gf = sigmoid_f(to_f<bf16>(p.x[1]) + acc[0][2 * rr + 1]);
      const float gg = tanhf(to_f<bf16>(p.x[2]) + acc[1][2 * rr]);
      const float go = sigmoid_f(to_f<bf16>(p.x[3]) + acc[1][2 * rr + 1]);
      const float c = gf * p.c + gi * gg;
      const float h = go * tanhf(c);
      const bf16 hv = from_f<bf16>(p.m * h + (1.f - p.m) * p.h);
      const bf16 cv = from_f<bf16>(p.m * c + (1.f - p.m) * p.c);
      if (n_mine == 1) {  // the next item is this sub-tile's next step
        pre[rr].h = to_f<bf16>(hv);
        pre[rr].c = to_f<bf16>(cv);
      }
      hn[(size_t)b * Hp + j] = hv;
      const size_t o = ((size_t)t * a.B + b) * a.H + j;
      a.h_seq[o] = hv;
      a.c_seq[o] = cv;
      if (s == a.n_steps - 1) {
        a.h_T[(size_t)b * a.H + j] = hv;
        a.c_T[(size_t)b * a.H + j] = cv;
      }
    }
    if (it + 1 < n_items) {  // the next item's inputs, ahead of the barrier
      const int s1 = (it + 1) / n_mine, b1 = (tile0 + (it + 1) % n_mine) * kRows + mt * 16 + g;
      prefetch(pre[0], a, s1, b1, j, n_mine == 1);
      prefetch(pre[1], a, s1, b1 + 8, j, n_mine == 1);
    }
    if (it % n_mine == n_mine - 1 && s + 1 < a.n_steps) {  // the group's barrier
      __syncthreads();
      if (tid == 0) {  // release covers the CTA's writes before the __syncthreads
        atomic_add_release(bar, 1u);
        const unsigned target = (unsigned)(s + 1) * gridDim.x;
        const long long start = clock64();
        while (load_acquire(bar) < target)
          if (clock64() - start > kSpinCycles) __trap();
      }
      __syncthreads();
    }
  }
}

template <bool kWSmem>
cudaError_t launch_tc(TcArgs a, size_t smem, int n_sms, cudaStream_t stream) {
  auto kernel = lstm_fwd_tc_kernel<kWSmem>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  const int n_ug = a.Hp / kUnits, cap = per_sm * n_sms;
  if (n_ug > cap) return cudaErrorCooperativeLaunchTooLarge;
  // as many batch groups as the card holds beside the unit groups, none empty
  int groups = min(a.n_tiles, cap / n_ug);
  a.tiles_per_group = (a.n_tiles + groups - 1) / groups;
  groups = (a.n_tiles + a.tiles_per_group - 1) / a.tiles_per_group;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(n_ug, groups),
                                    dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// x [T,B,4H], h_seq, c_seq [T,B,H], h_T, c_T [B,H]: io dtype (bf16 when
// io_bf16, else f32), contiguous; mask [T,B] f32.
//   f32:  w [H,4H]; hbuf [2,B,H] zeroed; bar unused.
//   bf16: w packed [Hp/16, 64, Hp] (lstm_kernels.pack_w, Hp = H rounded up
//         to 16); hbuf [2,B,Hp] zeroed; bar [ceil(B/32)] u32 zeroed.
// Returns a cudaError_t: cudaErrorInvalidValue where the shape is out of
// the kernel's range.
extern "C" int lstm_fwd_launch(int io_bf16, const void* x, const void* mask, const void* w,
                               void* h_seq, void* c_seq, void* h_T, void* c_T, void* hbuf,
                               void* bar, int n_steps, int B, int H, int reverse, void* stream) {
  int n_sms = 0, smem_max = 0;
  const cudaError_t err = ptt::coop_device(&n_sms, &smem_max);
  if (err != cudaSuccess) return err;
  if (n_steps < 1 || B < 1 || H < 1) return cudaErrorInvalidValue;
  const float* m = static_cast<const float*>(mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!io_bf16) {
    const int hc = ptt::units_per_cta(H, n_sms);
    if (hc == 0 || f32_smem_bytes(B, H, hc) > (size_t)smem_max) return cudaErrorInvalidValue;
    float* out[] = {static_cast<float*>(h_seq), static_cast<float*>(c_seq),
                    static_cast<float*>(h_T), static_cast<float*>(c_T)};
    return launch_f32_hc(hc, static_cast<const float*>(x), m, static_cast<const float*>(w), out,
                         static_cast<float*>(hbuf), n_steps, B, H, reverse, n_sms, st);
  }
  TcArgs a{};
  a.x = static_cast<const bf16*>(x);
  a.mask = m;
  a.wp = static_cast<const bf16*>(w);
  a.h_seq = static_cast<bf16*>(h_seq);
  a.c_seq = static_cast<bf16*>(c_seq);
  a.h_T = static_cast<bf16*>(h_T);
  a.c_T = static_cast<bf16*>(c_T);
  a.hbuf = static_cast<bf16*>(hbuf);
  a.bar = static_cast<unsigned*>(bar);
  a.n_steps = n_steps;
  a.B = B;
  a.H = H;
  a.Hp = (H + kUnits - 1) / kUnits * kUnits;
  a.reverse = reverse;
  a.n_tiles = (B + kRows - 1) / kRows;
  const size_t w_bytes = (size_t)kCols * (a.Hp + 8) * sizeof(bf16);
  if (kStageBytes + w_bytes <= (size_t)smem_max)
    return launch_tc<true>(a, kStageBytes + w_bytes, n_sms, st);
  return launch_tc<false>(a, kStageBytes, n_sms, st);
}

extern "C" const char* lstm_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
