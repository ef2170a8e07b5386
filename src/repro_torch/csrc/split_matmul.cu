// DOS parameter-split matmul (the paper's §4.2.2, Equation 1) for Hopper
// (sm_90a):
//   y = x @ W + b, with W cut into (block_k, block_n) tiles
//   x (M, K), W (K, N), b (N,), all fp32 -> y (M, N) fp32.
//
// Replaces the Pallas TPU kernel
//   split_matmul  src/repro/kernels/split_matmul/split_matmul.py:33
//                 (body _kernel :20)
//
// Arithmetic, as the plain version (kernels/split_matmul/ops.py) states
// it: N tiles (the paper's output-channel split) are independent; K tiles
// (the inC split, with the extra reduction the paper warns about) are
// summed in order into one fp32 accumulator: tile 0's product plus the
// bias, then each later tile's product added.  IEEE fp32 FFMA, no TF32.
//
// What bounds it on the H100: at the CNN path's shapes (bert_s at seq 128,
// d 768, whose FFN matmuls the planner splits three ways under the DSP
// spec) the operations.  (128,768)@(768,3072): 0.60 GFLOP, ~9.0 us at
// 67 TFLOP/s of fp32 FFMA, against 11.4 MB, ~3.4 us at 3.35 TB/s.
//
// What the design does about it: a tiled fp32 GEMM.  A thread block
// computes a 64 x 64 block of y (256 threads, each a 4 x 4 register
// tile, x and W through shared memory 16 k at a time) where such blocks
// fill at least half the 132 SMs, else a 32 x 32 block (2 x 2 a thread,
// 64 k at a time: four times the blocks, a quarter of the steps).  Each
// step issues the next step's loads before its multiply.  The plan's N
// tiles map onto the grid's columns (each N tile is covered by whole
// blocks, masked at its edge), and the plan's K tiles are the block's
// sequential loop: each tile's product is formed in registers and then
// added into the accumulator, in tile order.  Every
// edge is masked (M, N, K, block_n and block_k need not divide anything).
// The launch allocates nothing and never synchronizes, so it can be
// captured into a CUDA graph.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;    // 16 x 16 threads, each a TT x TT tile
constexpr int kSMs = 132;        // H100 SXM streaming multiprocessors

// A block computes a (16 TT) x (16 TT) block of y, BK k at a time, with
// the next step's tiles loaded into registers while this one multiplies.
template <int TT, int BK>
__global__ void __launch_bounds__(kThreads)
split_matmul_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ b, float* __restrict__ y,
                    int M, int N, int K, int block_n, int block_k,
                    int sub_tiles) {
  constexpr int kB = 16 * TT;                 // rows and columns of y
  constexpr int kXL = kB * BK / kThreads;     // x tile loads a thread
  constexpr int kWL = BK * kB / kThreads;     // W tile loads a thread
  static_assert(kB * BK % kThreads == 0, "tiles split evenly");
  // k-major x tile (a thread reads its TT rows together); the pad spreads
  // the transposing stores over the banks
  __shared__ __align__(16) float xs[BK][kB + 4];
  __shared__ __align__(16) float ws[BK][kB];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.x * kB;
  const int tile_n = blockIdx.y / sub_tiles;          // the plan's N tile
  const int n_lo = tile_n * block_n;
  const int n_hi = min(N, n_lo + block_n);
  const int n0 = n_lo + (blockIdx.y % sub_tiles) * kB;
  if (n0 >= n_hi) return;

  float acc[TT][TT], part[TT][TT];
#pragma unroll
  for (int i = 0; i < TT; ++i)
#pragma unroll
    for (int j = 0; j < TT; ++j) acc[i][j] = part[i][j] = 0.f;

  float xr[kXL], wr[kWL];
  // x element e: row e / BK, column e % BK; W element e: row e / kB,
  // column e % kB; zero past M, past the step's K tile, past the N tile
  auto fetch = [&](int k0, int k_hi) {
#pragma unroll
    for (int i = 0; i < kXL; ++i) {
      const int e = tid + i * kThreads;
      const int gm = m0 + e / BK, gk = k0 + e % BK;
      xr[i] = gm < M && gk < k_hi ? x[static_cast<size_t>(gm) * K + gk] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kWL; ++i) {
      const int e = tid + i * kThreads;
      const int gk = k0 + e / kB, gn = n0 + e % kB;
      wr[i] = gk < k_hi && gn < n_hi ? w[static_cast<size_t>(gk) * N + gn]
                                     : 0.f;
    }
  };

  // steps: the plan's K tiles [k_lo, k_hi) in order, each BK at a time
  int k_lo = 0, k_hi = min(K, block_k), k0 = 0;
  fetch(k0, k_hi);
  while (true) {
    __syncthreads();                  // the last step's tiles are read
#pragma unroll
    for (int i = 0; i < kXL; ++i) {
      const int e = tid + i * kThreads;
      xs[e % BK][e / BK] = xr[i];
    }
#pragma unroll
    for (int i = 0; i < kWL; ++i) {
      const int e = tid + i * kThreads;
      ws[e / kB][e % kB] = wr[i];
    }
    __syncthreads();
    int nk0 = k0 + BK, nlo = k_lo, nhi = k_hi;
    const bool tile_end = nk0 >= k_hi;
    if (tile_end) {
      nlo = k_hi;
      nhi = min(K, nlo + block_k);
      nk0 = nlo;
    }
    const bool more = nk0 < K;
    if (more) fetch(nk0, nhi);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TT], wv[TT];
#pragma unroll
      for (int i = 0; i < TT; ++i) av[i] = xs[kk][ty * TT + i];
#pragma unroll
      for (int j = 0; j < TT; ++j) wv[j] = ws[kk][tx * TT + j];
#pragma unroll
      for (int i = 0; i < TT; ++i)
#pragma unroll
        for (int j = 0; j < TT; ++j)
          part[i][j] = fmaf(av[i], wv[j], part[i][j]);
    }
    if (tile_end) {                   // fold the K tile into y, in order
      const bool first = k_lo == 0;
#pragma unroll
      for (int j = 0; j < TT; ++j) {
        const int gn = n0 + tx * TT + j;
        const float bias = first && gn < n_hi ? b[gn] : 0.f;
#pragma unroll
        for (int i = 0; i < TT; ++i) {
          acc[i][j] = first ? part[i][j] + bias : acc[i][j] + part[i][j];
          part[i][j] = 0.f;
        }
      }
    }
    if (!more) break;
    k0 = nk0;
    k_lo = nlo;
    k_hi = nhi;
  }

#pragma unroll
  for (int i = 0; i < TT; ++i) {
    const int gm = m0 + ty * TT + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TT; ++j) {
      const int gn = n0 + tx * TT + j;
      if (gn < n_hi) y[static_cast<size_t>(gm) * N + gn] = acc[i][j];
    }
  }
}

template <int TT, int BK>
cudaError_t launch(const float* x, const float* w, const float* b, float* y,
                   int M, int N, int K, int block_n, int block_k,
                   cudaStream_t stream) {
  constexpr int kB = 16 * TT;
  const int bn = min(block_n, N);
  const int sub_tiles = (bn + kB - 1) / kB;
  const long long cols =
      static_cast<long long>((N + block_n - 1) / block_n) * sub_tiles;
  if (cols > 65535) return cudaErrorInvalidValue;
  split_matmul_kernel<TT, BK>
      <<<dim3((M + kB - 1) / kB, static_cast<unsigned>(cols)), kThreads, 0,
         stream>>>(x, w, b, y, M, N, K, bn, block_k, sub_tiles);
  return cudaGetLastError();
}

}  // namespace

// x (M,K), w (K,N), b (N,), y (M,N): contiguous fp32 on one device;
// 1 <= block_n, 1 <= block_k.  64 x 64 blocks 16 k deep where they fill
// half the SMs or more, else 32 x 32 blocks 64 k deep (four times the
// blocks, a quarter of the steps, but twice the shared-memory reads per
// multiply).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_split_matmul(const void* x, const void* w, const void* b,
                                  void* y, int M, int N, int K, int block_n,
                                  int block_k, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || block_n <= 0 || block_k <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xp = static_cast<const float*>(x);
  const float* wp = static_cast<const float*>(w);
  const float* bp = static_cast<const float*>(b);
  float* yp = static_cast<float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long big = static_cast<long long>((M + 63) / 64) *
                        ((N + block_n - 1) / block_n) *
                        ((min(block_n, N) + 63) / 64);
  const cudaError_t err =
      2 * big >= kSMs
          ? launch<4, 16>(xp, wp, bp, yp, M, N, K, block_n, block_k, st)
          : launch<2, 64>(xp, wp, bp, yp, M, N, K, block_n, block_k, st);
  return static_cast<int>(err);
}
