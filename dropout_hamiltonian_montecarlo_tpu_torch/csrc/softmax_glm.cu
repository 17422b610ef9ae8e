// Fused multi-chain softmax-GLM log-likelihood and gradient, for Hopper (sm_90a).
//
// Replaces the TPU kernel dropout_hamiltonian_montecarlo_tpu/ops/pallas_glm.py::_kernel
// (launched by softmax_value_and_grad).  For C chains at once it computes, over
// the dataset X (N, D) with one-hot labels Y (N, K):
//
//     Z  = X W + b                     (per chain: W (D, K), b (K,))
//     ll = sum_n sum_k y_nk (z_nk - logsumexp_k z_n)
//     R  = Y - softmax(Z)
//     gW = X^T R,  gb = sum_n R_n
//
// The Gaussian prior is added by the Python wrapper, as on the TPU.
//
// What bounds it: one call is two GEMMs of 2*N*D*(C*K) FLOP each (about
// 240 GFLOP at N=60000, D=784, K=10, C=128) against one read of X (188 MB in
// f32), so it is compute-bound.  This first version keeps everything in f32
// FMA on the CUDA cores (the value feeds the MH accept and must be f32
// accurate); moving the GEMMs to wgmma tensor cores is later work.
//
// Layout: the wrapper passes W as W2 (D, C*K) with chain-major columns
// c*K + k, so one chain's K logits are adjacent and one thread owns them.
//
// Reduction design.  On the TPU the grid ran in order and summed into output
// blocks revisited across grid steps.  Here blocks run in parallel in no
// order, so the grid is (row tile x chain group) and every block writes its
// partial sums into its OWN slice of a scratch buffer:
//     gw_part (n_tiles, D, C*K), gb_part (n_tiles, C*K), ll_part (n_tiles, C).
// A second small kernel sums the slices in a fixed order.  The result is
// deterministic (no atomics), which keeps every parity check exact from run
// to run.  Inside a block:
//   1. Z tile (128 rows x 16 chains x K) over the full D, X and W staged
//      through shared memory in 16-wide D slices; each thread owns 8 rows of
//      one chain (8*K accumulators in registers).
//   2. Per-(row, chain) stable softmax in registers; ll and R = Y - p; R goes
//      to shared memory.  Rows >= N are masked here (X is never padded).
//   3. gW partial = X_tile^T R over 128-wide D chunks, X re-read (from L2)
//      through shared memory in 16-row slices; each thread owns 8 d-rows of
//      one chain.
// The kernel allocates nothing and does not synchronise.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChains = 16;                 // chains per block (chain group)
constexpr int kGroups = kThreads / kChains; // 16 row groups / d groups
constexpr int kRowsPerThread = 8;
constexpr int kTileRows = kRowsPerThread * kGroups;  // 128 rows per block
constexpr int kDStep = 16;                  // D slice per stage in step 1
constexpr int kXsPitch = kTileRows + 4;     // transposed X slice pitch (16B aligned)
constexpr int kDPerThread = 8;
constexpr int kDChunk = kDPerThread * kGroups;  // 128 gW rows per pass in step 3
constexpr int kRowStep = 16;                // rows per stage in step 3

template <int K>
struct Layout {
  static constexpr int GK = kChains * K;                  // columns per block
  static constexpr int rs = 0;                            // R tile (kTileRows, GK)
  static constexpr int ys = rs + kTileRows * GK;          // Y tile (kTileRows, K)
  static constexpr int un = ys + ((kTileRows * K + 3) / 4) * 4;
  // union: step 1 uses xs (kDStep, kXsPitch) + ws (kDStep, GK);
  //        step 3 uses xb (kRowStep, kDChunk)
  static constexpr int xs = un;
  static constexpr int ws = xs + kDStep * kXsPitch;
  static constexpr int xb = un;
  static constexpr int un_size_1 = kDStep * kXsPitch + kDStep * GK;
  static constexpr int un_size_3 = kRowStep * kDChunk;
  static constexpr int un_size = un_size_1 > un_size_3 ? un_size_1 : un_size_3;
  static constexpr int red = un + ((un_size + 3) / 4) * 4;  // (kGroups, kChains)
  static constexpr int total = red + kGroups * kChains;
  static constexpr size_t bytes = sizeof(float) * (size_t)total;
};

template <int K, bool WITH_VALUE>
__global__ void __launch_bounds__(kThreads, 2)
softmax_glm_tile_kernel(const float* __restrict__ X,   // (N, D)
                        const float* __restrict__ Y,   // (N, K)
                        const float* __restrict__ W2,  // (D, C*K)
                        const float* __restrict__ b2,  // (C*K,)
                        float* __restrict__ ll_part,   // (n_tiles, C)
                        float* __restrict__ gw_part,   // (n_tiles, D, C*K)
                        float* __restrict__ gb_part,   // (n_tiles, C*K)
                        int N, int D, int C) {
  using L = Layout<K>;
  constexpr int GK = L::GK;
  extern __shared__ __align__(16) float smem[];
  float* Rs = smem + L::rs;
  float* Ys = smem + L::ys;
  float* Xs = smem + L::xs;
  float* Ws = smem + L::ws;
  float* Xb = smem + L::xb;
  float* red = smem + L::red;

  const int tid = threadIdx.x;
  const int c = tid % kChains;   // chain within the group
  const int g = tid / kChains;   // row group (step 1) / d group (step 3)
  const int tile = blockIdx.x;
  const int row0 = tile * kTileRows;
  const int CK = C * K;
  const int col0 = blockIdx.y * GK;   // first global column of this block
  const int chain = blockIdx.y * kChains + c;

  // Y tile: rows >= N load as 0, which also zeroes their ll terms.
  for (int i = tid; i < kTileRows * K; i += kThreads) {
    const int r = i / K;
    const int gr = row0 + r;
    Ys[i] = gr < N ? Y[(size_t)gr * K + (i - r * K)] : 0.f;
  }

  // ---- step 1: Z = X_tile W over the full D ------------------------------
  float acc[kRowsPerThread][K];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int k = 0; k < K; ++k) acc[i][k] = 0.f;

  for (int d0 = 0; d0 < D; d0 += kDStep) {
    for (int i = tid; i < kTileRows * kDStep; i += kThreads) {
      const int r = i / kDStep, dd = i - r * kDStep;
      const int gr = row0 + r, gd = d0 + dd;
      Xs[dd * kXsPitch + r] = (gr < N && gd < D) ? X[(size_t)gr * D + gd] : 0.f;
    }
    for (int i = tid; i < kDStep * GK; i += kThreads) {
      const int dd = i / GK, j = i - dd * GK;
      const int gd = d0 + dd, gc = col0 + j;
      Ws[i] = (gd < D && gc < CK) ? W2[(size_t)gd * CK + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int dd = 0; dd < kDStep; ++dd) {
      const float4 xa = *reinterpret_cast<const float4*>(&Xs[dd * kXsPitch + g * kRowsPerThread]);
      const float4 xc = *reinterpret_cast<const float4*>(&Xs[dd * kXsPitch + g * kRowsPerThread + 4]);
      const float xr[kRowsPerThread] = {xa.x, xa.y, xa.z, xa.w, xc.x, xc.y, xc.z, xc.w};
      float wr[K];
#pragma unroll
      for (int k = 0; k < K; ++k) wr[k] = Ws[dd * GK + c * K + k];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int k = 0; k < K; ++k) acc[i][k] = fmaf(xr[i], wr[k], acc[i][k]);
    }
    __syncthreads();
  }

  // ---- step 2: per-(row, chain) softmax, ll and R ------------------------
  float bias[K];
#pragma unroll
  for (int k = 0; k < K; ++k) bias[k] = chain < C ? b2[chain * K + k] : 0.f;

  float ll = 0.f;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = g * kRowsPerThread + i;
    const float valid = (row0 + r < N) ? 1.f : 0.f;
    float z[K];
    float m = -INFINITY;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      z[k] = acc[i][k] + bias[k];
      m = fmaxf(m, z[k]);
    }
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      z[k] -= m;               // z - max
      s += expf(z[k]);
    }
    const float log_s = logf(s);
    const float inv = 1.f / s;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float y = Ys[r * K + k];
      if (WITH_VALUE) ll = fmaf(y, z[k] - log_s, ll);
      Rs[r * GK + c * K + k] = valid * (y - expf(z[k]) * inv);
    }
  }
  if (WITH_VALUE) red[g * kChains + c] = ll;
  __syncthreads();

  if (WITH_VALUE && tid < kChains) {
    float s = 0.f;
    for (int q = 0; q < kGroups; ++q) s += red[q * kChains + tid];
    const int ch = blockIdx.y * kChains + tid;
    if (ch < C) ll_part[(size_t)tile * C + ch] = s;
  }
  for (int j = tid; j < GK; j += kThreads) {
    float s = 0.f;
    for (int r = 0; r < kTileRows; ++r) s += Rs[r * GK + j];
    if (col0 + j < CK) gb_part[(size_t)tile * CK + col0 + j] = s;
  }

  // ---- step 3: gW partial = X_tile^T R -----------------------------------
  for (int dc = 0; dc < D; dc += kDChunk) {
    float acc2[kDPerThread][K];
#pragma unroll
    for (int i = 0; i < kDPerThread; ++i)
#pragma unroll
      for (int k = 0; k < K; ++k) acc2[i][k] = 0.f;

    for (int r0 = 0; r0 < kTileRows; r0 += kRowStep) {
      __syncthreads();   // previous users of the union / Xb are done
      for (int i = tid; i < kRowStep * kDChunk; i += kThreads) {
        const int rr = i / kDChunk, j = i - rr * kDChunk;
        const int gr = row0 + r0 + rr, gd = dc + j;
        Xb[i] = (gr < N && gd < D) ? X[(size_t)gr * D + gd] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int rr = 0; rr < kRowStep; ++rr) {
        const float4 xa = *reinterpret_cast<const float4*>(&Xb[rr * kDChunk + g * kDPerThread]);
        const float4 xc = *reinterpret_cast<const float4*>(&Xb[rr * kDChunk + g * kDPerThread + 4]);
        const float xr[kDPerThread] = {xa.x, xa.y, xa.z, xa.w, xc.x, xc.y, xc.z, xc.w};
        float rv[K];
#pragma unroll
        for (int k = 0; k < K; ++k) rv[k] = Rs[(r0 + rr) * GK + c * K + k];
#pragma unroll
        for (int i = 0; i < kDPerThread; ++i)
#pragma unroll
          for (int k = 0; k < K; ++k) acc2[i][k] = fmaf(xr[i], rv[k], acc2[i][k]);
      }
    }

    if (chain < C) {
#pragma unroll
      for (int i = 0; i < kDPerThread; ++i) {
        const int d = dc + g * kDPerThread + i;
        if (d < D) {
          float* out = gw_part + ((size_t)tile * D + d) * CK + col0 + c * K;
#pragma unroll
          for (int k = 0; k < K; ++k) out[k] = acc2[i][k];
        }
      }
    }
  }
}

// out[i] = sum_t in[t * len + i], summed in order t = 0, 1, ... in double:
// the value is a sum of ~N/128 tile partials of a total ~1e5 nat, where f32
// accumulation would drift by ~0.1 nat.  The pass is memory-bound, so the
// double adds cost nothing.
__global__ void sum_slices_kernel(const float* __restrict__ in, float* __restrict__ out,
                                  int n_slices, long long len) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= len) return;
  double s = 0.0;
  for (int t = 0; t < n_slices; ++t) s += (double)in[(size_t)t * len + i];
  out[i] = (float)s;
}

cudaError_t sum_slices(const float* in, float* out, int n_slices, long long len,
                       cudaStream_t stream) {
  const int threads = 256;
  const long long blocks = (len + threads - 1) / threads;
  sum_slices_kernel<<<(unsigned)blocks, threads, 0, stream>>>(in, out, n_slices, len);
  return cudaGetLastError();
}

template <int K, bool WITH_VALUE>
cudaError_t launch_tiles(const float* X, const float* Y, const float* W2, const float* b2,
                         float* ll_part, float* gw_part, float* gb_part,
                         int N, int D, int C, int n_tiles, cudaStream_t stream) {
  using L = Layout<K>;
  auto kernel = softmax_glm_tile_kernel<K, WITH_VALUE>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L::bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_tiles, (C + kChains - 1) / kChains);
  kernel<<<grid, kThreads, L::bytes, stream>>>(X, Y, W2, b2, ll_part, gw_part, gb_part, N, D, C);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows of X per block: the wrapper sizes the scratch slices with it.
int dhmc_softmax_glm_tile_rows() { return kTileRows; }

const char* dhmc_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Likelihood value (optional) and gradient for all chains.  Returns a
// cudaError_t (0 on success).  ll_part/ll_out may be null when with_value == 0.
int dhmc_softmax_glm(const float* X, const float* Y, const float* W2, const float* b2,
                     float* ll_part, float* gw_part, float* gb_part,
                     float* ll_out, float* gw_out, float* gb_out,
                     int N, int D, int K, int C, int with_value, int device,
                     void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (K != 10 || N <= 0 || D <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const int n_tiles = (N + kTileRows - 1) / kTileRows;
  err = with_value
      ? launch_tiles<10, true>(X, Y, W2, b2, ll_part, gw_part, gb_part, N, D, C, n_tiles, stream)
      : launch_tiles<10, false>(X, Y, W2, b2, ll_part, gw_part, gb_part, N, D, C, n_tiles, stream);
  if (err != cudaSuccess) return (int)err;
  const long long CK = (long long)C * K;
  err = sum_slices(gw_part, gw_out, n_tiles, (long long)D * CK, stream);
  if (err != cudaSuccess) return (int)err;
  err = sum_slices(gb_part, gb_out, n_tiles, CK, stream);
  if (err != cudaSuccess) return (int)err;
  if (with_value) err = sum_slices(ll_part, ll_out, n_tiles, C, stream);
  return (int)err;
}

}  // extern "C"
