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
// What the design does about it: a register-tiled fp32 GEMM that keeps
// the FFMA pipes fed, with the contraction split over a thread block
// cluster so that a small M still fills the card.
//   * A CTA computes a BM x 64 block of y (BM = 64 or 32), each thread an
//     8 x 4 register tile: rows ty + i BM/8, columns 4 tx .. 4 tx + 3.
//     Per 4 k it reads 8 x rows and 4 W rows as float4 (12 shared loads
//     for 128 FFMA).  With KH = 2 the CTA has twice the threads, each half
//     taking half of every step's k, so that an SM holds enough warps to
//     hide the FFMA and load latencies; the halves' products are summed at
//     each K tile's end.
//   * x and W tiles 32 k deep stream through a 3-stage shared-memory ring
//     filled by cp.async (16-byte copies where K, N, block_n and block_k
//     are multiples of 4 and the pointers 16-byte aligned, else 4-byte
//     copies); copies past M, the K tile or the N tile are zero-filled.
//     One block barrier a step.
//   * Each of the plan's K tiles is cut into CL pieces of whole 32-k steps,
//     one per CTA of a cluster (gridDim.z = CL).  At the tile's end the
//     cluster's rank 0 sums the pieces' products, its own first, then
//     ranks 1 .. CL-1 in order, read through distributed shared memory,
//     and folds that tile's product into y in tile order.  Only rank 0
//     stores y.  No atomics: two launches give the same bits.
//   * The Python planner (kernels/split_matmul/ops.py, ``split_plan``)
//     picks BM, KH and CL from M, N, the plan's tiles and the device's SM
//     count, and passes them in.
// Every edge is masked (M, N, K, block_n and block_k need not divide
// anything).  The launch allocates nothing and never synchronizes, so it
// can be captured into a CUDA graph.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBK = 32;          // k per step
constexpr int kStages = 3;       // shared-memory ring depth
constexpr int kTM = 8;           // y rows a thread
constexpr int kTN = 4;           // y columns a thread
constexpr int kBN = 64;          // y columns a CTA: 16 column groups
constexpr int kXS = kBK + 4;     // x tile row stride (floats): spreads banks

// A CTA: BM rows x 64 columns of y, KH x (BM / 8) x 16 threads.  Thread
// (kh, ty, tx) holds an 8 x 4 tile, rows ty + i BM/8 and columns 4 tx ..
// 4 tx + 3, over k half kh of every step (KH = 2: the halves are summed,
// half 0 first, at each K tile's end).
template <int BM, int KH>
struct Shape {
  static constexpr int kGroup = (BM / kTM) * (kBN / kTN);  // one k half
  static constexpr int kThreads = KH * kGroup;
  static constexpr int kRG = BM / kTM;            // row groups (ty)
  static constexpr int kXStage = BM * kXS;        // floats
  static constexpr int kStage = kXStage + kBK * kBN;
  // the ring, then a partial tile for the k halves and the cluster
  static constexpr size_t smem_bytes(int cl) {
    return sizeof(float) * (static_cast<size_t>(kStages) * kStage +
                            (cl > 1 || KH > 1 ? kGroup * kTM * kTN : 0));
  }
};

// 16 bytes (VEC) or 4 bytes global -> shared, bypassing registers;
// src_bytes < size zero-fills the rest
template <bool VEC>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (VEC)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rank r's steps of a K tile [k_lo, k_hi): [s0, s1) of its ceil(len / kBK)
// steps.  (ops.py's ``piece_steps`` is the same formula.)
__device__ __forceinline__ void piece(int k_lo, int k_hi, int rank, int cl,
                                      int& s0, int& s1) {
  const int steps = (k_hi - k_lo + kBK - 1) / kBK;
  s0 = rank * steps / cl;
  s1 = (rank + 1) * steps / cl;
}

// Where the producer is: the K tile [k_lo, k_hi) and the step s of this
// rank's piece [s, s1); valid until the last tile's piece is issued.
struct Cursor {
  int k_lo, k_hi, s, s1;
  bool valid;
  __device__ __forceinline__ void skip_empty(int K, int block_k, int rank,
                                             int cl) {
    while (valid && s >= s1) {
      k_lo = k_hi;
      if (k_lo >= K) {
        valid = false;
        return;
      }
      k_hi = min(K, k_lo + block_k);
      piece(k_lo, k_hi, rank, cl, s, s1);
    }
  }
};

template <int BM, int KH, int CL, bool VEC>
__global__ void __launch_bounds__(Shape<BM, KH>::kThreads)
split_matmul_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ b, float* __restrict__ y,
                    int M, int N, int K, int block_n, int block_k,
                    int sub_tiles) {
  using S = Shape<BM, KH>;
  constexpr int kThreads = S::kThreads;
  constexpr int kG = S::kGroup;
  extern __shared__ __align__(16) float smem[];
  float* red = smem + kStages * S::kStage;          // [kTM][kG] float4s

  const int tid = threadIdx.x;
  const int kh = tid / kG;                          // k half
  const int tg = tid % kG;
  const int tx = tg % (kBN / kTN);
  const int ty = tg / (kBN / kTN);
  const int m0 = blockIdx.x * BM;
  const int tile_n = blockIdx.y / sub_tiles;          // the plan's N tile
  const int n_lo = tile_n * block_n;
  const int n_hi = min(N, n_lo + block_n);
  const int n0 = n_lo + (blockIdx.y % sub_tiles) * kBN;
  const int rank = CL > 1 ? static_cast<int>(blockIdx.z) : 0;
  // every CTA of a cluster shares n0, so all or none return here
  if (n0 >= n_hi) return;

  // step (k0, k_hi) into ring slot `slot`: x rows m0.., W columns n0..
  auto issue = [&](int k0, int k_hi, int slot) {
    float* xs = smem + slot * S::kStage;
    float* ws = xs + S::kXStage;
    if constexpr (VEC) {
      for (int c = tid; c < BM * (kBK / 4); c += kThreads) {
        const int r = c / (kBK / 4), kk = (c % (kBK / 4)) * 4;
        const int gm = m0 + r, gk = k0 + kk;
        const bool ok = gm < M && gk < k_hi;
        cp_async<true>(xs + r * kXS + kk,
                       ok ? x + static_cast<size_t>(gm) * K + gk : x,
                       ok ? 16 : 0);
      }
      for (int c = tid; c < kBK * (kBN / 4); c += kThreads) {
        const int kk = c / (kBN / 4), nn = (c % (kBN / 4)) * 4;
        const int gk = k0 + kk, gn = n0 + nn;
        const bool ok = gk < k_hi && gn < n_hi;
        cp_async<true>(ws + kk * kBN + nn,
                       ok ? w + static_cast<size_t>(gk) * N + gn : w,
                       ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < BM * kBK; e += kThreads) {
        const int r = e / kBK, kk = e % kBK;
        const int gm = m0 + r, gk = k0 + kk;
        const bool ok = gm < M && gk < k_hi;
        cp_async<false>(xs + r * kXS + kk,
                        ok ? x + static_cast<size_t>(gm) * K + gk : x,
                        ok ? 4 : 0);
      }
      for (int e = tid; e < kBK * kBN; e += kThreads) {
        const int kk = e / kBN, nn = e % kBN;
        const int gk = k0 + kk, gn = n0 + nn;
        const bool ok = gk < k_hi && gn < n_hi;
        cp_async<false>(ws + kk * kBN + nn,
                        ok ? w + static_cast<size_t>(gk) * N + gn : w,
                        ok ? 4 : 0);
      }
    }
  };

  Cursor prod;
  prod.k_lo = 0;
  prod.k_hi = min(K, block_k);
  prod.valid = true;
  piece(prod.k_lo, prod.k_hi, rank, CL, prod.s, prod.s1);
  prod.skip_empty(K, block_k, rank, CL);
  auto issue_next = [&](int slot) {
    if (prod.valid) {
      issue(prod.k_lo + prod.s * kBK, prod.k_hi, slot);
      ++prod.s;
      prod.skip_empty(K, block_k, rank, CL);
    }
    cp_async_commit();               // empty groups keep the count aligned
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue_next(i);

  float acc[kTM][kTN], part[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  int slot = 0;
  for (int k_lo = 0; k_lo < K; k_lo += block_k) {
    const int k_hi = min(K, k_lo + block_k);
    int s0, s1;
    piece(k_lo, k_hi, rank, CL, s0, s1);
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) part[i][j] = 0.f;
    for (int s = s0; s < s1; ++s) {
      cp_async_wait<kStages - 2>();
      __syncthreads();     // this step landed; the last slot is free again
      issue_next((slot + kStages - 1) % kStages);
      const float* xs = smem + slot * S::kStage;
      const float* ws = xs + S::kXStage;
#pragma unroll
      for (int k4 = 0; k4 < kBK / KH; k4 += 4) {
        const int kk = kh * (kBK / KH) + k4;
        float4 a[kTM], bq[4];
#pragma unroll
        for (int i = 0; i < kTM; ++i)
          a[i] = *reinterpret_cast<const float4*>(
              xs + (ty + i * S::kRG) * kXS + kk);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          bq[q] = *reinterpret_cast<const float4*>(ws + (kk + q) * kBN +
                                                   tx * kTN);
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          const float av[4] = {a[i].x, a[i].y, a[i].z, a[i].w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            part[i][0] = fmaf(av[q], bq[q].x, part[i][0]);
            part[i][1] = fmaf(av[q], bq[q].y, part[i][1]);
            part[i][2] = fmaf(av[q], bq[q].z, part[i][2]);
            part[i][3] = fmaf(av[q], bq[q].w, part[i][3]);
          }
        }
      }
      slot = (slot + 1) % kStages;
    }

    // a partial tile through `red`, as float4s: thread tg's row i at
    // float4 i kG + tg
    auto red_at = [&](float* base, int i) {
      return reinterpret_cast<float4*>(base) + i * kG + tg;
    };
    if constexpr (KH > 1) {
      // half 1's product of this K tile added to half 0's
      if (kh == 1)
#pragma unroll
        for (int i = 0; i < kTM; ++i)
          *red_at(red, i) =
              make_float4(part[i][0], part[i][1], part[i][2], part[i][3]);
      __syncthreads();
      if (kh == 0)
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          const float4 q = *red_at(red, i);
          part[i][0] += q.x;
          part[i][1] += q.y;
          part[i][2] += q.z;
          part[i][3] += q.w;
        }
      __syncthreads();     // red is read before it is reused
    }
    if constexpr (CL > 1) {
      // rank 0 sums the cluster's pieces of this K tile in rank order;
      // every thread of every CTA reaches both barriers
      cg::cluster_group cluster = cg::this_cluster();
      if (rank > 0 && kh == 0) {
#pragma unroll
        for (int i = 0; i < kTM; ++i)
          *red_at(red, i) =
              make_float4(part[i][0], part[i][1], part[i][2], part[i][3]);
      }
      cluster.sync();
      if (rank == 0 && kh == 0) {
        for (int r = 1; r < CL; ++r) {
          float* src = cluster.map_shared_rank(red, r);
#pragma unroll
          for (int i = 0; i < kTM; ++i) {
            const float4 q = *red_at(src, i);
            part[i][0] += q.x;
            part[i][1] += q.y;
            part[i][2] += q.z;
            part[i][3] += q.w;
          }
        }
      }
      cluster.sync();      // the pieces are read before red is reused
    }
    if (rank == 0 && kh == 0) {   // fold the K tile into y, in tile order
      const bool first = k_lo == 0;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int gn = n0 + tx * kTN + j;
        const float bias = first && gn < n_hi ? b[gn] : 0.f;
#pragma unroll
        for (int i = 0; i < kTM; ++i)
          acc[i][j] = first ? part[i][j] + bias : acc[i][j] + part[i][j];
      }
    }
  }
  cp_async_wait<0>();
  if (rank != 0 || kh != 0) return;

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gm = m0 + ty + i * S::kRG;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gn = n0 + tx * kTN + j;
      if (gn < n_hi) y[static_cast<size_t>(gm) * N + gn] = acc[i][j];
    }
  }
}

template <int BM, int KH, int CL, bool VEC>
cudaError_t launch(const float* x, const float* w, const float* b, float* y,
                   int M, int N, int K, int block_n, int block_k,
                   cudaStream_t stream) {
  using S = Shape<BM, KH>;
  auto kern = split_matmul_kernel<BM, KH, CL, VEC>;
  const size_t smem = S::smem_bytes(CL);
  static bool attr_set = false;    // once per instantiation
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const int bn = min(block_n, N);
  const int sub_tiles = (bn + kBN - 1) / kBN;
  const long long cols =
      static_cast<long long>((N + block_n - 1) / block_n) * sub_tiles;
  const long long rows = (M + BM - 1) / BM;
  if (cols > 65535 || rows > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows), static_cast<unsigned>(cols),
                     CL);
  cfg.blockDim = dim3(S::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = CL;
  cfg.attrs = &cluster;
  cfg.numAttrs = CL > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, x, w, b, y, M, N, K,
                                             bn, block_k, sub_tiles);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int BM, int KH, bool VEC>
cudaError_t launch_cl(int cl, const float* x, const float* w, const float* b,
                      float* y, int M, int N, int K, int block_n, int block_k,
                      cudaStream_t st) {
  switch (cl) {
    case 1: return launch<BM, KH, 1, VEC>(x, w, b, y, M, N, K, block_n,
                                          block_k, st);
    case 2: return launch<BM, KH, 2, VEC>(x, w, b, y, M, N, K, block_n,
                                          block_k, st);
    case 4: return launch<BM, KH, 4, VEC>(x, w, b, y, M, N, K, block_n,
                                          block_k, st);
    case 8: return launch<BM, KH, 8, VEC>(x, w, b, y, M, N, K, block_n,
                                          block_k, st);
    default: return cudaErrorInvalidValue;
  }
}

// the CTA shapes (bm rows, kh k halves): (64, 1), (64, 2), (32, 2)
template <bool VEC>
cudaError_t launch_shape(int bm, int kh, int cl, const float* x,
                         const float* w, const float* b, float* y, int M,
                         int N, int K, int block_n, int block_k,
                         cudaStream_t st) {
  if (bm == 64 && kh == 1)
    return launch_cl<64, 1, VEC>(cl, x, w, b, y, M, N, K, block_n, block_k,
                                 st);
  if (bm == 64 && kh == 2)
    return launch_cl<64, 2, VEC>(cl, x, w, b, y, M, N, K, block_n, block_k,
                                 st);
  if (bm == 32 && kh == 2)
    return launch_cl<32, 2, VEC>(cl, x, w, b, y, M, N, K, block_n, block_k,
                                 st);
  return cudaErrorInvalidValue;
}

}  // namespace

// x (M,K), w (K,N), b (N,), y (M,N): contiguous fp32 on one device;
// 1 <= block_n, 1 <= block_k.  (bm, kh): rows and k halves a CTA, (64,
// 1), (64, 2) or (32, 2); cl (1, 2, 4 or 8) CTAs a cluster splitting each
// K tile: ops.py's planner.  vec: 1 for 16-byte copies (K,
// N, block_n, block_k multiples of 4, pointers 16-byte aligned), 0 for
// 4-byte copies.  Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_split_matmul(const void* x, const void* w, const void* b,
                                  void* y, int M, int N, int K, int block_n,
                                  int block_k, int bm, int kh, int cl,
                                  int vec, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || block_n <= 0 || block_k <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xp = static_cast<const float*>(x);
  const float* wp = static_cast<const float*>(w);
  const float* bp = static_cast<const float*>(b);
  float* yp = static_cast<float*>(y);
  if (vec) {
    const size_t addr = reinterpret_cast<size_t>(x) |
                        reinterpret_cast<size_t>(w);
    if (K % 4 || N % 4 || block_n % 4 || block_k % 4 || (addr & 15))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      vec ? launch_shape<true>(bm, kh, cl, xp, wp, bp, yp, M, N, K, block_n,
                               block_k, st)
          : launch_shape<false>(bm, kh, cl, xp, wp, bp, yp, M, N, K,
                                block_n, block_k, st);
  return static_cast<int>(err);
}
