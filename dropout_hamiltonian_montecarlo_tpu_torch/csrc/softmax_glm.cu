// Fused multi-chain softmax-GLM log-likelihood and gradient, for Hopper (sm_90a).
//
// Replaces the TPU kernel dropout_hamiltonian_montecarlo_tpu/ops/pallas_glm.py::_kernel
// (launched by softmax_value_and_grad).  For C chains at once it computes, over
// the dataset X (N, D) with one-hot labels Y (N, K):
//
//     Z  = X W + b                     (per chain: W (D, K), b (K,))
//     ll = sum_n sum_k y_nk (z_nk - logsumexp_k z_n)
//     R  = Y - softmax(Z)              (rows >= N masked to 0)
//     gW = X^T R,  gb = sum_n R_n
//
// The Gaussian prior is added by the Python wrapper, as on the TPU.
//
// Precision.  The value feeds the MH accept and the gradients must stay
// f32-accurate, so the GEMMs run on the bf16 tensor cores on exact bf16
// pieces of their operands (cut by the wrapper): X is exact in bf16 on the
// 8-bit grid (X = X_hi; an off-grid X adds X_lo), W is cut into 3 pieces for
// the value variant and 2 for grad-only, R into 2.  Every product of bf16
// pieces is exact in the f32 accumulators:
//     Z  = X_hi (W_0 + W_1 [+ W_2]) [+ X_lo W_0]
//     gW = X_hi^T (R_hi + R_lo) [+ X_lo^T R_hi]
// The tensor cores add with truncation, so accumulation chains are kept
// short: the value variant adds each product into f32 registers with
// round-to-nearest adds ("promotion", see consume), and the gradient GEMM's
// reduction over N is cut into slices of at most 160 steps (the wrapper).
//
// What bounds it.  One call is 4 (grad-only) or 5 (value) bf16 GEMM passes
// of 2*N*D*(C*K) FLOP (120 GFLOP each at N=60000, D=784, K=10, C=128).  A
// 128 x 160 output tile reads ~56 KB of A and B tiles per 64-deep step, so
// the GEMM main loops run at the rate at which L2 feeds the SMs: on an H100
// SXM (700 W) the gradient GEMM moves ~6.6 TB/s of tiles, ~55% of the bf16
// peak.  Each stage therefore loads its A tile once for all the B pieces it
// multiplies, the forward's items of a row tile run next to each other (X
// from HBM once, from L2 after), and a ring needs 3 stages in flight to keep
// a 160-wide main loop fed (with 2 it runs at half speed).  The forward's
// epilogue (Z staging, softmax, R^T stores) would take about as long as its
// main loop again if it ran after it in the same block, so it runs under the
// next item's main loop.  Per item at the bench shape (clock64, H100 SXM at
// 700 W, cycles / 1.98 GHz): grad-only 12.9 us of main loop against 8.1 us of
// epilogue work; value 11.6 us against 6.3.  The forward is bound by its main
// loops, within ~15% (grad-only) and ~20% (value) of the time the same TMA
// loads take with no arithmetic at all.
//
// Design: three kernels, no atomics, deterministic.
//   1. glm_forward_kernel: persistent, one block of 512 threads an SM (at
//      most one per work item), walking work items (128-row tile, chain group
//      of 16 chains; 8 for the value variant from K = 8 and grad-only from K =
//      12) b, b + grid, ...  Warp roles, with registers split by setmaxnreg
//      (128 a thread at launch):
//        - warpgroup 3, 40 registers: one thread streams stages (X tile + every
//          W piece tile of a 64-wide D step) through a ring in shared memory
//          with TMA (128-byte swizzle; the ragged D and N edges read as
//          zeros); one warp copies the next item's labels (transposed) and
//          bias into one of two buffers;
//        - warpgroups 0-1 (MMA), 184 registers: wgmma m64n(G*K)k16 into f32
//          registers, then the item's logits into Z in shared memory in two
//          column halves (one where a half would not end at a chain's edge
//          and a multiple of 8 columns): the first right after the main loop,
//          the second held in registers and handed over halfway through the
//          next item's main loop, so Z needs half a tile of room;
//        - warpgroup 2 (epilogue), 104 registers: per Z part, each lane takes
//          a (chain, 64-row half) unit's rows 2l and 2l + 1: the stable
//          softmax per (row, chain), the rows' ll terms (summed per tile and
//          chain in a fixed order), and R written straight from its registers
//          as bf16 hi and lo pairs into R^T (2, C*K, N): the layout the
//          gradient GEMM reads K-major.
//      Shared memory (grad-only, K = 10): 3 stages of 56 KB, Z 41.3 KB
//      (transposed: 80 x 132 floats, conflict-free writes and float2 reads),
//      2 x 5.1 KB of labels, 2 x 640 B of bias: 222 KB; the value variant
//      (80 wide, 3 W pieces): 4 stages of 46 KB.  Barriers: the ring's
//      full/empty per stage, Z full/empty, labels full/empty per buffer.
//   2. glm_backward_kernel: gW_aug (D+1, C*K) = X_aug^T R, a wgmma GEMM with
//      A = X^T (D+1, N) and B = R^T (C*K, N), both K-major over N.  Row D of
//      X_aug^T is all ones, so row D of the product is gb.  Output tiles are
//      128 x 160; the N reduction is cut into S slices (the tiles fill the SMs
//      and each chain stays short), each slice writing its own partial.
//   3. glm_finish_kernel: sums the S partials and the per-tile ll partials in
//      a fixed order, in double, and writes gW in the (C, D, K) layout.
// Scratch per call: R^T (2 x C*K x N bf16, 307 MB at the bench shape), S
// partials of (D+1) x C*K floats (S = 7 there: 28 MB), and N/128 x C floats.
// The kernels allocate nothing and do not synchronise.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "wgmma.cuh"

namespace {

constexpr int kBM = 128;                 // rows of A per tile: two warpgroups of 64
constexpr int kBK = 64;                  // reduction step: 64 bf16 = one 128-byte row
constexpr int kConsumerThreads = 256;    // two MMA warpgroups
constexpr int kThreads = kConsumerThreads + 32;   // backward: + one producer warp
constexpr int kEpiThreads = 128;         // forward: one epilogue warpgroup
constexpr int kFwdThreads = kConsumerThreads + kEpiThreads + 128;   // + a producer warpgroup
constexpr int kBwdBN = 160;              // output columns per backward block
constexpr int kSmemMax = 232448;         // shared memory a block can have
constexpr int kMaxStages = 6;

// Registers a thread of each forward warpgroup keeps after setmaxnreg: the
// 512 threads start with 128 each (all 65,536 of the SM); the producer gives
// most of its share to the MMA warpgroups, whose accumulators (BN/2 floats,
// twice that for the value variant's promotion) and held second Z part (BN/4)
// need it.
constexpr int kProducerRegs = 40;
constexpr int kMmaRegs = 184;
constexpr int kEpiRegs = 104;
static_assert(kProducerRegs + 2 * kMmaRegs + kEpiRegs <= 65536 / 128, "register file");

// A ring of stages in shared memory, each holding one A tile (128 x 64 bf16)
// and the NB B tiles (pieces, BN x 64 bf16) that multiply it, followed by a
// full and an empty barrier a stage.  As many stages as `budget` bytes hold,
// at least 2 and at most kMaxStages.
template <int BN_, int NB_, int budget>
struct Ring {
  static constexpr int BN = BN_;
  static constexpr int NB = NB_;
  static constexpr int a_bytes = kBM * kBK * 2;
  static constexpr int b_bytes = BN * kBK * 2;
  static constexpr int stage_bytes = a_bytes + NB * b_bytes;
  static constexpr int stages =
      budget / stage_bytes < kMaxStages ? budget / stage_bytes : kMaxStages;
  static constexpr int ring_bytes = stages * stage_bytes;
  static constexpr int bar_offset = ring_bytes;
  static constexpr int end = bar_offset + 2 * stages * 8;
  static_assert(stages >= 2, "a ring needs two stages");
  static_assert(BN % 8 == 0 && BN >= 32 && BN <= 256, "wgmma width");
  static_assert(b_bytes % 1024 == 0, "128-byte swizzled tiles must start 1024-byte aligned");
};

// The forward block's shared memory: [ring] [its barriers] [Z full, Z empty,
// labels full x 2, labels empty x 2] [Z: one part of an item's logits,
// transposed: zcols x 132 floats] [2 x the item's labels, transposed: K x
// 128 floats] [2 x its bias: BN floats] [value only: the rows' log-likelihood
// terms, G x 128 floats]; the ring takes what the rest leaves.  Z lies
// outside the ring, so the MMA warpgroups run the next item's main loop while
// the epilogue reads this item's Z.  It holds half the columns where the half
// ends at a chain's edge and a multiple of 8 columns (the MMA warpgroups hand
// the second half over from registers, halfway through the next main loop):
// with the full Z, a 160-wide tile would leave room for 2 stages, which do
// not keep enough bytes in flight to feed its main loop.
template <int K, int G, int NB, bool VALUE>
struct FwdLayout {
  static constexpr int BN = G * K;
  static constexpr int zparts = (G / 2) * K % 8 == 0 ? 2 : 1;
  static constexpr int zcols = BN / zparts;
  static constexpr int zpitch = kBM + 4;   // conflict-free Z writes, float2 reads
  static constexpr int ys_floats = K * kBM;
  static constexpr int ll_floats = VALUE ? G * kBM : 0;
  static constexpr int rest = 6 * 8 + (zcols * zpitch + 2 * (ys_floats + BN) + ll_floats) * 4;
  using R = Ring<BN, NB, kSmemMax - 1024 - rest - 2 * kMaxStages * 8>;
  static constexpr int zbar_offset = R::end;
  static constexpr int zs_offset = zbar_offset + 6 * 8;
  static constexpr int ys_offset = zs_offset + zcols * zpitch * 4;
  static constexpr int bs_offset = ys_offset + 2 * ys_floats * 4;
  static constexpr int ll_offset = bs_offset + 2 * BN * 4;
  static constexpr int smem_bytes = 1024 + ll_offset + ll_floats * 4;   // +1024: alignment
  static_assert(smem_bytes <= kSmemMax, "shared memory per block");
};

// The backward block's: [ring] [its barriers].  One block fills an SM: two
// would leave 96 registers a thread, fewer than the 80 accumulators of a
// 160-wide tile need.
using BwdRing = Ring<kBwdBN, 2, 196608>;   // the R pieces; 192 KB: 3 stages
constexpr int kBwdSmemBytes = 1024 + BwdRing::end;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Returns once the barrier's phase of the given parity has completed.  A wait
// that never ends (a pipeline bug) traps after ~2^28 polls, so it surfaces as
// a launch error instead of a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 28)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma matrix descriptor of a K-major tile of 128-byte rows, 128-byte
// swizzled (as TMA writes it): 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)   // start address
         | (static_cast<uint64_t>(1) << 16)              // leading offset (unused here)
         | (static_cast<uint64_t>(1024 >> 4) << 32)      // stride offset: 8 rows
         | (static_cast<uint64_t>(1) << 62);             // 128-byte swizzle
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma statements.
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void epilogue_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kEpiThreads) : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// full[s]: the stage's loads landed; empty[s]: its consumers are done.
template <class R>
__device__ __forceinline__ void init_ring_barriers(uint64_t* full, uint64_t* empty) {
  for (int s = 0; s < R::stages; ++s) {
    mbar_init(smem_u32(&full[s]), 1);
    mbar_init(smem_u32(&empty[s]), kConsumerThreads / 32);   // one arrival per consumer warp
  }
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// The ring's stages are used in one sequence over all the block's work:
// stage use g (counted from 0 at the block's start) lands in stage g % stages
// in round g / stages.  produce and consume each take the first use of their
// n_iter, g0.
//
// Producer: for iteration it, waits for the stage to be free, then
// load(it, stage address, barrier) announces the stage's bytes on the barrier
// and starts its TMA loads (A at the stage address, B_j after it).
template <class R, class Load>
__device__ __forceinline__ void produce(uint8_t* ring, uint64_t* full, uint64_t* empty,
                                        uint32_t g0, int n_iter, Load load) {
  for (int it = 0; it < n_iter; ++it) {
    const uint32_t g = g0 + it;
    const int s = g % R::stages;
    mbar_wait(smem_u32(&empty[s]), ((g / R::stages) & 1) ^ 1);
    load(it, smem_u32(ring + s * R::stage_bytes), smem_u32(&full[s]));
  }
}

// Consumers: acc (64 rows of this warpgroup x BN) = sum over the stages of
// A_stage[64 wg .. 64 wg + 63] * (B_0 + ... + B_{n-1})^T, where a stage
// holds n = n_prod(it) products.  Every stage is handed back when its wgmma
// are done.  hook(it) runs once stage it's wgmma are issued (and, promoted,
// done); it must not touch acc.
//
// The tensor cores add into their f32 accumulators with truncation, so a
// long chain of wgmma into one accumulator drifts toward zero by about half
// an ulp of the running sum per step (measured at the bench shape: 0.14 nat
// of value error over the 39 products of the value variant's logits).  With
// PROMOTE each product goes into a fresh accumulator, which is added into acc
// by ordinary round-to-nearest f32 adds: the truncation then acts only on one
// product's partial sum.  It costs BN/2 registers and a wait per product (the
// other warpgroup's wgmma fill it), so only the value variant's forward takes
// it; the gradients are well inside their bound without it.
template <class R, bool PROMOTE, class NProd, class Hook>
__device__ __forceinline__ void consume(uint8_t* ring, uint64_t* full, uint64_t* empty,
                                        uint32_t g0, int n_iter, NProd n_prod,
                                        float (&acc)[R::BN / 2], Hook hook) {
  constexpr int BN = R::BN;
  const uint32_t wg_a = (threadIdx.x / 128) * (64 * kBK * 2);
  const bool warp_leader = threadIdx.x % 32 == 0;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  if constexpr (PROMOTE) {
    float part[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) part[i] = 0.f;
    for (int it = 0; it < n_iter; ++it) {
      const uint32_t g = g0 + it;
      const int s = g % R::stages;
      mbar_wait(smem_u32(&full[s]), (g / R::stages) & 1);
      const uint32_t stage = smem_u32(ring + s * R::stage_bytes);
      const uint64_t da = sw128_desc(stage + wg_a);
      const int n = n_prod(it);
#pragma unroll
      for (int j = 0; j < R::NB; ++j) {
        if (j < n) {
          const uint64_t db = sw128_desc(stage + R::a_bytes + j * R::b_bytes);
          fence_operands(part);
          asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
          for (int kk = 0; kk < kBK / 16; ++kk)   // the first overwrites part
            Wgmma<BN>::mma(part, da + 2 * kk, db + 2 * kk, kk > 0);
          asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
          asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
          fence_operands(part);
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
        }
      }
      hook(it);
      if (warp_leader) mbar_arrive(smem_u32(&empty[s]));
    }
  } else {
    for (int it = 0; it < n_iter; ++it) {
      const uint32_t g = g0 + it;
      const int s = g % R::stages;
      mbar_wait(smem_u32(&full[s]), (g / R::stages) & 1);
      const uint32_t stage = smem_u32(ring + s * R::stage_bytes);
      const uint64_t da = sw128_desc(stage + wg_a);
      const int n = n_prod(it);
      fence_operands(acc);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int j = 0; j < R::NB; ++j) {
        if (j < n) {
          const uint64_t db = sw128_desc(stage + R::a_bytes + j * R::b_bytes);
#pragma unroll
          for (int kk = 0; kk < kBK / 16; ++kk)   // 16 bf16 = 32 bytes = 2 descriptor units
            Wgmma<BN>::mma(acc, da + 2 * kk, db + 2 * kk, 1);
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      hook(it);
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      fence_operands(acc);
      // the previous stage's wgmma are done: hand its buffers back
      if (it > 0 && warp_leader) mbar_arrive(smem_u32(&empty[(g - 1) % R::stages]));
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_operands(acc);
    if (n_iter > 0 && warp_leader) mbar_arrive(smem_u32(&empty[(g0 + n_iter - 1) % R::stages]));
  }
}

// Row and column (within the block's 128 x BN tile) of acc[4 j + e] for
// consumer thread t: see wgmma.cuh.
__device__ __forceinline__ int acc_row(int t, int e) {
  return 64 * (t / 128) + 16 * ((t % 128) / 32) + (t % 32) / 4 + 8 * (e / 2);
}
__device__ __forceinline__ int acc_col(int t, int j, int e) { return 8 * j + 2 * (t % 4) + e % 2; }

// ---- 1. forward + softmax epilogue -----------------------------------------
// Chains per work item: 16, or 8 where a 16-chain item's Z and two stages
// would not fit in shared memory (grad-only from K = 12) or its promoted
// and held accumulators in the MMA warpgroups' registers (the value variant
// from K = 8).
template <int K, bool VALUE>
__host__ __device__ constexpr int chain_group() { return K >= (VALUE ? 8 : 12) ? 8 : 16; }

template <int K, bool VALUE>
using FwdLayoutOf = FwdLayout<K, chain_group<K, VALUE>(), VALUE ? 3 : 2, VALUE>;   // the W pieces

// Z use w of a block (its items' parts in order): waits for the epilogue to
// let go of use w - 1, writes v's first 8 NQ columns of this thread's
// accumulator layout into Z (transposed: column-major, ZPITCH floats a
// column), announces them.
template <int NQ, int ZPITCH, int NV>
__device__ __forceinline__ void hand_over_z(float* zs, uint64_t* zfull, uint64_t* zempty,
                                            uint32_t w, const float (&v)[NV]) {
  const int t = threadIdx.x;
  mbar_wait(smem_u32(zempty), (w & 1) ^ 1);
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) zs[acc_col(t, q, e) * ZPITCH + acc_row(t, e)] = v[4 * q + e];
  mbar_arrive(smem_u32(zfull));
}

// Persistent: block b does the work items b, b + gridDim.x, ...; item i is
// (row tile i / n_groups, chain group i % n_groups), so the groups of a row
// tile run at once on neighbouring blocks.  Warpgroups: 0-1 MMA (main loop,
// then Z into shared memory), 2 the epilogue (softmax, ll partials, R^T
// stores), 3 the producer (a thread issues the TMA loads, a warp copies the
// labels and bias an item ahead).  The epilogue of item j runs while the MMA
// warpgroups run item j + 1's main loop.
template <int K, bool VALUE>
__global__ void __launch_bounds__(kFwdThreads, 1)
glm_forward_kernel(const __grid_constant__ CUtensorMap tm_x,    // X_hi (N, D)
                   const __grid_constant__ CUtensorMap tm_xlo,  // X_lo (N, D), or tm_x
                   const __grid_constant__ CUtensorMap tm_w,    // W pieces (NB, C*K, D)
                   const float* __restrict__ Y,                 // (N, K)
                   const float* __restrict__ b2,                // (C*K,)
                   __nv_bfloat16* __restrict__ rt,              // (2, C*K, ldr)
                   float* __restrict__ ll_part,                 // (n_tiles, C), VALUE only
                   int N, int D, int C, int ldr, int has_xlo) {
  constexpr int G = chain_group<K, VALUE>();
  constexpr int BN = G * K;
  using L = FwdLayoutOf<K, VALUE>;
  using R = typename L::R;
  constexpr int ZP = L::zparts;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + R::bar_offset);
  uint64_t* empty = full + R::stages;
  uint64_t* zfull = reinterpret_cast<uint64_t*>(ring + L::zbar_offset);
  uint64_t* zempty = zfull + 1;
  uint64_t* yfull = zfull + 2;    // [2]: the labels and bias of buffer b landed
  uint64_t* yempty = zfull + 4;   // [2]: the epilogue is done with buffer b
  float* zs = reinterpret_cast<float*>(ring + L::zs_offset);
  float* ys = reinterpret_cast<float*>(ring + L::ys_offset);
  float* bs = reinterpret_cast<float*>(ring + L::bs_offset);
  float* llrow = reinterpret_cast<float*>(ring + L::ll_offset);

  const int n_groups = (C + G - 1) / G;
  const int n_items = ((N + kBM - 1) / kBM) * n_groups;
  const int CK = C * K;
  // stages per D step: X_hi with every W piece, then (off the grid) X_lo
  // with W_0
  const int per_step = 1 + has_xlo;
  const int n_iter = ((D + kBK - 1) / kBK) * per_step;
  auto n_prod = [&](int it) { return it % per_step == 0 ? R::NB : 1; };

  if (threadIdx.x == 0) {
    init_ring_barriers<R>(full, empty);
    mbar_init(smem_u32(zfull), kConsumerThreads);   // every MMA thread wrote its Z
    mbar_init(smem_u32(zempty), kEpiThreads);       // every epilogue thread is done with it
    for (int b = 0; b < 2; ++b) {
      mbar_init(smem_u32(&yfull[b]), 32);           // the loader warp
      mbar_init(smem_u32(&yempty[b]), kEpiThreads);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);   // warp-uniform
  if (role == 3) {
    setmaxnreg_dec<kProducerRegs>();
    const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
    if (warp == 0 && lane == 0) {
      // ---- producer
      uint32_t g = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x, g += n_iter) {
        const int m0 = (item / n_groups) * kBM;
        const int grp = item % n_groups;
        produce<R>(ring, full, empty, g, n_iter, [&](int it, uint32_t stage, uint32_t bar) {
          const int kd = (it / per_step) * kBK;
          const int n = n_prod(it);
          mbar_expect_tx(bar, R::a_bytes + n * R::b_bytes);
          tma_load_2d(stage, n == R::NB ? &tm_x : &tm_xlo, bar, kd, m0);
          for (int j = 0; j < n; ++j)
            tma_load_3d(stage + R::a_bytes + j * R::b_bytes, &tm_w, bar, kd, grp * BN, j);
        });
      }
    } else if (warp == 1) {
      // ---- labels (transposed, zero past the last row) and bias, an item
      // ahead of the epilogue
      uint32_t j = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++j) {
        const int b = j & 1;
        const int m0 = (item / n_groups) * kBM;
        const int grp = item % n_groups;
        mbar_wait(smem_u32(&yempty[b]), ((j >> 1) & 1) ^ 1);
        const int rows_k = min(kBM, N - m0) * K;
        const float* y = Y + static_cast<size_t>(m0) * K;
        float* yb = ys + b * L::ys_floats;
#pragma unroll 8
        for (int i = lane; i < kBM * K; i += 32) yb[(i % K) * kBM + i / K] = i < rows_k ? y[i] : 0.f;
        for (int i = lane; i < BN; i += 32)
          bs[b * BN + i] = grp * BN + i < CK ? b2[grp * BN + i] : 0.f;
        mbar_arrive(smem_u32(&yfull[b]));
      }
    }
    return;
  }

  if (role < 2) {
    // ---- MMA: each item's logits into registers, then Z part by part; a
    // second part waits in `hold` until halfway through the next main loop
    setmaxnreg_inc<kMmaRegs>();
    constexpr int NQ = BN / 8 / ZP;   // 8-column groups of a Z part
    float hold[ZP == 2 ? 4 * NQ : 1];
    uint32_t g = 0, w = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x, g += n_iter) {
      const bool pending = item != static_cast<int>(blockIdx.x);
      float acc[BN / 2];
      consume<R, VALUE>(ring, full, empty, g, n_iter, n_prod, acc, [&](int it) {
        if constexpr (ZP == 2)
          if (pending && it == n_iter / 2) hand_over_z<NQ, L::zpitch>(zs, zfull, zempty, w++, hold);
      });
      hand_over_z<NQ, L::zpitch>(zs, zfull, zempty, w++, acc);
      if constexpr (ZP == 2) {
#pragma unroll
        for (int i = 0; i < 4 * NQ; ++i) hold[i] = acc[4 * NQ + i];
      }
    }
    if constexpr (ZP == 2) hand_over_z<NQ, L::zpitch>(zs, zfull, zempty, w++, hold);
    return;
  }

  // ---- epilogue.  A Z part holds GP chains x 128 rows; warp w takes the
  // (chain, 64-row half) units w, w + 4, ..., lane l rows 2l and 2l + 1 of
  // the half: their stable softmax, then R = Y - softmax straight from the
  // registers into R^T as bf16 pairs, hi = bf16(R) and lo = bf16(R - hi)
  setmaxnreg_dec<kEpiRegs>();
  constexpr int GP = G / ZP;
  const int u = threadIdx.x - kConsumerThreads;
  const int warp = u / 32, lane = u % 32;
  __nv_bfloat16* rt_lo = rt + static_cast<size_t>(CK) * ldr;
  uint32_t w = 0, j = 0;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++j) {
    const int tile = item / n_groups;
    const int grp = item % n_groups;
    const int m0 = tile * kBM;
    const int b = j & 1;
    const float* yb = ys + b * L::ys_floats;
    const float* bb = bs + b * BN;
    mbar_wait(smem_u32(&yfull[b]), (j >> 1) & 1);
    for (int p = 0; p < ZP; ++p, ++w) {
      mbar_wait(smem_u32(zfull), w & 1);
#pragma unroll 1
      for (int n = warp; n < 2 * GP; n += kEpiThreads / 32) {
        const int cl = n / 2;
        const int c = p * GP + cl;
        const int r0 = 64 * (n % 2) + 2 * lane;
        if (grp * G + c >= C) continue;
        float e[2][K], yv[2][K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float2 z = *reinterpret_cast<const float2*>(zs + (cl * K + k) * L::zpitch + r0);
          const float2 y = *reinterpret_cast<const float2*>(yb + k * kBM + r0);
          const float bias = bb[c * K + k];
          e[0][k] = z.x + bias;
          e[1][k] = z.y + bias;
          yv[0][k] = y.x;
          yv[1][k] = y.y;
        }
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          float m = -INFINITY;
#pragma unroll
          for (int k = 0; k < K; ++k) m = fmaxf(m, e[a][k]);
          float s = 0.f;
          if constexpr (VALUE) {
            // ll_row = sum_k y_k (z_k - m) - (sum_k y_k) log sum_k exp(z_k - m)
            float yz = 0.f, ysum = 0.f;
#pragma unroll
            for (int k = 0; k < K; ++k) {
              const float zm = e[a][k] - m;
              yz = fmaf(yv[a][k], zm, yz);
              ysum += yv[a][k];
              e[a][k] = expf(zm);
              s += e[a][k];
            }
            llrow[c * kBM + r0 + a] = fmaf(-ysum, logf(s), yz);
          } else {
            // no value: the fast exp (relative error ~2^-21) is far inside
            // the 2^-17 of R's bf16 pieces
#pragma unroll
            for (int k = 0; k < K; ++k) {
              e[a][k] = __expf(e[a][k] - m);
              s += e[a][k];
            }
          }
          const float inv = m0 + r0 + a < N ? 1.f / s : 0.f;   // a padded row has no residual
          // R = y - e inv with one rounding: written as FMAs, since the
          // compiler contracts a product and a difference only where both
          // land in one basic block, and the division's slow path splits them
#pragma unroll
          for (int k = 0; k < K; ++k) e[a][k] = fmaf(-e[a][k], inv, yv[a][k]);
        }
        const int gr = m0 + r0;
        if (gr < N) {   // gr + 1 < ldr: ldr is N rounded up to a multiple of 8
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const __nv_bfloat162 hi = __floats2bfloat162_rn(e[0][k], e[1][k]);
            const float2 hf = __bfloat1622float2(hi);
            const __nv_bfloat162 lo = __floats2bfloat162_rn(e[0][k] - hf.x, e[1][k] - hf.y);
            const size_t off = static_cast<size_t>(grp * BN + c * K + k) * ldr + gr;
            *reinterpret_cast<__nv_bfloat162*>(rt + off) = hi;
            *reinterpret_cast<__nv_bfloat162*>(rt_lo + off) = lo;
          }
        }
      }
      mbar_arrive(smem_u32(zempty));   // this thread is done with Z
    }
    if constexpr (VALUE) {
      // ll_part of chain u: the rows' terms summed in the order of a
      // 256-thread epilogue in which thread q G + u sums rows q + (256 / G) i
      // over i, and the chains' partials over q
      constexpr int kRowStride = kConsumerThreads / G;
      epilogue_sync();   // every row's term is written
      if (u < G && grp * G + u < C) {
        float s = 0.f;
        for (int q = 0; q < kRowStride; ++q) {
          float sq = 0.f;
#pragma unroll
          for (int i = 0; i < kBM / kRowStride; ++i) sq += llrow[u * kBM + q + kRowStride * i];
          s += sq;
        }
        ll_part[static_cast<size_t>(tile) * C + grp * G + u] = s;
      }
      epilogue_sync();   // and read
    }
    mbar_arrive(smem_u32(&yempty[b]));   // this thread is done with the labels and bias
  }
}

// ---- 2. backward GEMM: gW_aug = X_aug^T R, one N slice per block ----------
__global__ void __launch_bounds__(kThreads, 1)
glm_backward_kernel(const __grid_constant__ CUtensorMap tm_xt,    // X_hi^T (D+1, N)
                    const __grid_constant__ CUtensorMap tm_xtlo,  // X_lo^T (D+1, N), or tm_xt
                    const __grid_constant__ CUtensorMap tm_rt,    // R^T pieces (2, C*K, N)
                    float* __restrict__ part,                     // (S, D+1, C*K)
                    int N, int Daug, int CK, int has_xlo, int n_ctiles, int n_dtiles,
                    int k_per_slice) {
  constexpr int BN = kBwdBN;
  using R = BwdRing;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + R::bar_offset);
  uint64_t* empty = full + R::stages;

  const int ct = blockIdx.x % n_ctiles;
  const int dt = (blockIdx.x / n_ctiles) % n_dtiles;
  const int slice = blockIdx.x / (n_ctiles * n_dtiles);
  const int nk = (N + kBK - 1) / kBK;
  const int k0 = slice * k_per_slice;
  const int k1 = min(nk, k0 + k_per_slice);
  // stages per N step: X_hi^T with R_hi and R_lo, then (off the grid) X_lo^T
  // with R_hi
  const int per_step = 1 + has_xlo;
  const int n_iter = k1 > k0 ? (k1 - k0) * per_step : 0;
  auto n_prod = [&](int it) { return it % per_step == 0 ? R::NB : 1; };

  if (threadIdx.x == 0) {
    init_ring_barriers<R>(full, empty);
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {
    if (threadIdx.x == kConsumerThreads) {
      produce<R>(ring, full, empty, 0, n_iter, [&](int it, uint32_t stage, uint32_t bar) {
        const int kn = (k0 + it / per_step) * kBK;
        const int n = n_prod(it);
        mbar_expect_tx(bar, R::a_bytes + n * R::b_bytes);
        tma_load_2d(stage, n == R::NB ? &tm_xt : &tm_xtlo, bar, kn, dt * kBM);
        for (int j = 0; j < n; ++j)
          tma_load_3d(stage + R::a_bytes + j * R::b_bytes, &tm_rt, bar, kn, ct * BN, j);
      });
    }
    return;
  }

  float acc[BN / 2];
  consume<R, false>(ring, full, empty, 0, n_iter, n_prod, acc, [](int) {});

  const int t = threadIdx.x;
  float* out = part + static_cast<size_t>(slice) * Daug * CK;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = dt * kBM + acc_row(t, e);
      const int col = ct * BN + acc_col(t, j, e);
      if (d < Daug && col < CK) out[static_cast<size_t>(d) * CK + col] = acc[4 * j + e];
    }
}

// ---- 3. fixed-order sums ---------------------------------------------------
// gw (C, D, K) and gb (C*K) from the S partials; ll (C) from the per-tile
// partials.  In double: the value is a sum of N/128 tile partials of a total
// ~1e5 nat, where f32 accumulation would drift by ~0.1 nat.
__global__ void glm_finish_kernel(const float* __restrict__ part, int n_slices, int D, int K,
                                  int C, const float* __restrict__ ll_part, int n_tiles,
                                  float* __restrict__ gw, float* __restrict__ gb,
                                  float* __restrict__ ll) {
  const long long CK = static_cast<long long>(C) * K;
  const long long n_gw = static_cast<long long>(D) * CK;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n_gw + CK) {
    const long long d = i / CK, col = i - d * CK;   // d == D: the bias row
    double s = 0.0;
    for (int q = 0; q < n_slices; ++q) s += static_cast<double>(part[(q * (D + 1LL) + d) * CK + col]);
    if (d < D) {
      const long long c = col / K, k = col - c * K;
      gw[(c * D + d) * K + k] = static_cast<float>(s);
    } else {
      gb[col] = static_cast<float>(s);
    }
  } else if (ll != nullptr && i < n_gw + CK + C) {
    const long long c = i - n_gw - CK;
    double s = 0.0;
    for (int q = 0; q < n_tiles; ++q) s += static_cast<double>(ll_part[q * static_cast<long long>(C) + c]);
    ll[c] = static_cast<float>(s);
  }
}

// ---- host side ---------------------------------------------------------------
// Errors of our own, beside the CUDA runtime's (which are >= 0).
constexpr int kErrNoEncoder = -1;     // cuTensorMapEncodeTiled not found in libcuda
constexpr int kErrTensorMap = -2;     // libcuda refused a tensor map
constexpr int kErrClasses = -3;       // K outside [2, 16]

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's tensor-map encoder, from the libcuda the process already has
// loaded (no link-time dependency on libcuda).
EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr) fn = reinterpret_cast<EncodeTiledFn>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// A bf16 tensor of `rank` dims (dims[0] contiguous; strides in bytes of dims
// 1..rank-1), read in boxes of 64 x rows (x 1), 128-byte swizzled, with
// reads outside the tensor filled with zeros.
int make_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
             const cuuint64_t* strides, uint32_t box_rows) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return kErrNoEncoder;
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kBK), box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base),
                          dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kErrTensorMap;
}

// Calls f(std::integral_constant<int, K>(), std::bool_constant<value>()):
// the forward variant of K classes; kErrClasses for K outside [2, 16].
template <int KK = 2, class F>
int with_variant(int K, bool value, F f) {
  if constexpr (KK > 16) {
    return kErrClasses;
  } else {
    if (K != KK) return with_variant<KK + 1>(K, value, f);
    return value ? f(std::integral_constant<int, KK>(), std::true_type())
                 : f(std::integral_constant<int, KK>(), std::false_type());
  }
}

template <int K, bool VALUE>
cudaError_t allow_forward_smem() {
  return cudaFuncSetAttribute(glm_forward_kernel<K, VALUE>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              FwdLayoutOf<K, VALUE>::smem_bytes);
}

// The W map's boxes are one chain group wide, so it is made here.
template <int K, bool VALUE>
int launch_forward(const CUtensorMap& mx, const CUtensorMap& mxlo, const void* w, int ldx,
                   int n_w, const float* Y, const float* b2, __nv_bfloat16* rt, float* ll_part,
                   int N, int D, int C, int ldr, int has_xlo, int grid, cudaStream_t stream) {
  constexpr int G = chain_group<K, VALUE>();
  using L = FwdLayoutOf<K, VALUE>;
  const int n_items = ((N + kBM - 1) / kBM) * ((C + G - 1) / G);
  if (n_w != L::R::NB || grid < 1 || grid > n_items) return cudaErrorInvalidValue;
  CUtensorMap mw;
  const cuuint64_t CK = static_cast<cuuint64_t>(C) * K;
  const cuuint64_t wdims[3] = {static_cast<cuuint64_t>(D), CK, static_cast<cuuint64_t>(n_w)};
  const cuuint64_t wstrides[2] = {static_cast<cuuint64_t>(ldx) * 2, CK * ldx * 2};
  const int merr = make_map(&mw, w, 3, wdims, wstrides, G * K);
  if (merr != 0) return merr;
  const cudaError_t err = allow_forward_smem<K, VALUE>();
  if (err != cudaSuccess) return err;
  glm_forward_kernel<K, VALUE><<<grid, kFwdThreads, L::smem_bytes, stream>>>(
      mx, mxlo, mw, Y, b2, rt, ll_part, N, D, C, ldr, has_xlo);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* dhmc_cuda_error_string(int err) {
  switch (err) {
    case kErrNoEncoder: return "cuTensorMapEncodeTiled not found in libcuda.so.1";
    case kErrTensorMap: return "cuTensorMapEncodeTiled refused a tensor map";
    case kErrClasses: return "the kernel takes 2 to 16 classes";
    default: return cudaGetErrorString(static_cast<cudaError_t>(err));
  }
}

// Chains of a forward work item for K classes, of the value variant (value
// not 0) or grad-only; 0 for K outside [2, 16].
int dhmc_glm_forward_group(int K, int value) {
  const int g = with_variant(K, value != 0, [](auto k, auto v) {
    return chain_group<decltype(k)::value, decltype(v)::value>();
  });
  return g > 0 ? g : 0;
}

// Forward blocks that run at once on the device, the most the persistent
// grid takes: the SMs times the blocks per SM.  0 on error.
int dhmc_glm_forward_slots(int K, int value, int device) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) return 0;
  if (cudaSetDevice(device) != cudaSuccess) return 0;
  const int per_sm = with_variant(K, value != 0, [](auto k, auto v) {
    constexpr int KK = decltype(k)::value;
    constexpr bool V = decltype(v)::value;
    int n = 0;
    if (allow_forward_smem<KK, V>() != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, glm_forward_kernel<KK, V>, kFwdThreads,
                                                      FwdLayoutOf<KK, V>::smem_bytes) !=
            cudaSuccess)
      return 0;
    return n;
  });
  return per_sm > 0 ? sms * per_sm : 0;
}

// Stage 1.  x, xlo (N rows, leading dimension ldx; xlo may be null), w
// (n_w, C*K, ldx) bf16; Y (N, K), b2 (C*K) f32; writes rt (2, C*K, ldr) bf16.
// The value variant (ll_part not null, n_w = 3) also writes ll_part
// (ceil(N/128), C).  grid: persistent blocks, 1 to the work items (row tiles
// x chain groups).  Returns a cudaError_t, or one of the negative codes above.
int dhmc_glm_forward(const void* x, const void* xlo, int ldx, const void* w, int n_w,
                     const float* Y, const float* b2, void* rt, int ldr, float* ll_part, int N,
                     int D, int K, int C, int grid, int device, void* stream_ptr) {
  cudaError_t cerr = cudaSetDevice(device);
  if (cerr != cudaSuccess) return cerr;
  if (K < 2 || K > 16) return kErrClasses;
  CUtensorMap mx, mxlo;
  const cuuint64_t xdims[2] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(N)};
  const cuuint64_t xstrides[1] = {static_cast<cuuint64_t>(ldx) * 2};
  int err = make_map(&mx, x, 2, xdims, xstrides, kBM);
  if (err == 0 && xlo != nullptr) err = make_map(&mxlo, xlo, 2, xdims, xstrides, kBM);
  if (err != 0) return err;
  const int has_xlo = xlo != nullptr;
  return with_variant(K, ll_part != nullptr, [&](auto k, auto v) {
    return launch_forward<decltype(k)::value, decltype(v)::value>(
        mx, has_xlo ? mxlo : mx, w, ldx, n_w, Y, b2, static_cast<__nv_bfloat16*>(rt), ll_part,
        N, D, C, ldr, has_xlo, grid, reinterpret_cast<cudaStream_t>(stream_ptr));
  });
}

// Stage 2.  xt, xtlo (D+1 rows, leading dimension ldr; xtlo may be null),
// rt (2, CK, ldr) bf16; writes part (n_slices, D+1, CK) f32.
int dhmc_glm_backward(const void* xt, const void* xtlo, const void* rt, int ldr, float* part,
                      int n_slices, int N, int D, int CK, int device, void* stream_ptr) {
  cudaError_t cerr = cudaSetDevice(device);
  if (cerr != cudaSuccess) return cerr;
  const int Daug = D + 1;
  CUtensorMap mxt, mxtlo, mrt;
  const cuuint64_t xdims[2] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(Daug)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ldr) * 2,
                                 static_cast<cuuint64_t>(CK) * ldr * 2};
  int err = make_map(&mxt, xt, 2, xdims, strides, kBM);
  if (err == 0 && xtlo != nullptr) err = make_map(&mxtlo, xtlo, 2, xdims, strides, kBM);
  const cuuint64_t rdims[3] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(CK), 2};
  if (err == 0) err = make_map(&mrt, rt, 3, rdims, strides, kBwdBN);
  if (err != 0) return err;
  cerr = cudaFuncSetAttribute(glm_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kBwdSmemBytes);
  if (cerr != cudaSuccess) return cerr;
  const int n_ctiles = (CK + kBwdBN - 1) / kBwdBN;
  const int n_dtiles = (Daug + kBM - 1) / kBM;
  const int nk = (N + kBK - 1) / kBK;
  const int k_per_slice = (nk + n_slices - 1) / n_slices;
  const int has_xlo = xtlo != nullptr;
  glm_backward_kernel<<<n_ctiles * n_dtiles * n_slices, kThreads, kBwdSmemBytes,
                        reinterpret_cast<cudaStream_t>(stream_ptr)>>>(
      mxt, has_xlo ? mxtlo : mxt, mrt, part, N, Daug, CK, has_xlo, n_ctiles, n_dtiles,
      k_per_slice);
  return cudaGetLastError();
}

// Backward blocks that run at once on the device: the SMs times the blocks
// per SM (the wrapper sizes the N slices with it).  0 on error.
int dhmc_glm_backward_slots(int device) {
  int sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) return 0;
  if (cudaSetDevice(device) != cudaSuccess) return 0;
  if (cudaFuncSetAttribute(glm_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kBwdSmemBytes) != cudaSuccess)
    return 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, glm_backward_kernel, kThreads,
                                                    kBwdSmemBytes) != cudaSuccess)
    return 0;
  return sms * per_sm;
}

// Stage 3.  gw (C, D, K), gb (C*K), and ll (C) when ll is not null.
int dhmc_glm_finish(const float* part, int n_slices, int D, int K, int C, const float* ll_part,
                    int n_tiles, float* gw, float* gb, float* ll, int device, void* stream_ptr) {
  cudaError_t cerr = cudaSetDevice(device);
  if (cerr != cudaSuccess) return cerr;
  const long long total = (static_cast<long long>(D) + 1) * C * K + C;
  const int threads = 256;
  glm_finish_kernel<<<static_cast<unsigned>((total + threads - 1) / threads), threads, 0,
                      reinterpret_cast<cudaStream_t>(stream_ptr)>>>(
      part, n_slices, D, K, C, ll_part, n_tiles, gw, gb, ll);
  return cudaGetLastError();
}

}  // extern "C"
