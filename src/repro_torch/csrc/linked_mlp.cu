// Linked SwiGLU MLP (the paper's Matmul->Matmul operator linking, Table 1)
// for Hopper (sm_90a):
//   y = (silu(x @ Wg) * (x @ Wu)) @ Wd
//   x (M, d), Wg and Wu (d, ff), Wd (ff, d), all fp32 or all bf16,
//   -> y (M, d) in x's type.
//
// Replaces the Pallas TPU kernel
//   linked_mlp  src/repro/kernels/linked_matmul/linked_matmul.py:42
//               (body _kernel :24)
//
// Arithmetic, as the plain version (kernels/linked_matmul/ops.py) states
// it: both up-projections accumulate in fp32; h = silu(g) * u is rounded
// to x's type before the down-projection (the Pallas body's
// h.astype(x.dtype)); the down-projection accumulates in fp32 and y is
// cast to x's type once, at the end.  (The Pallas kernel accumulates y in
// the output block's type, so in bf16 it rounds every ff block's partial
// sum; the port does not.)  bf16 products are exact in fp32, so the
// tensor cores' fp32 accumulation keeps this arithmetic; no TF32.
//
// What bounds it on the H100: decode, M = 8, d 2048, ff 6144, bf16: 3 *
// 2048 * 6144 * 2 B = 75.5 MB of weights against 0.60 GFLOP: ~22.5 us at
// 3.35 TB/s (bytes).  Batched prefill, M = 8 x 544 = 4352: 329 GFLOP,
// ~0.33 ms at the bf16 tensor-core peak (operations); on the fp32 FFMA
// pipes (67 TFLOP/s) the same work takes 4.9 ms.  The large dense
// decoders: chatglm3-6b's (d 4096, ff 13696) 0.1005 ms at decode (bytes),
// 1.48 ms at M 4352 (operations); chameleon-34b's (8192, 22016) 0.323 /
// 4.76 ms.
//
// Two kernels (the tensor-core one with three bodies), chosen per call by
// ops.py's planner (``mlp_plan``), which
// also picks every grid size from the shapes, the device's SM count and
// the clusters of the tensor-core kernel it runs at once.
// Both keep the operator linking: the hidden activation h (M x ff) is
// produced and consumed on chip and never written to device memory.
//
// linked_mlp_tc (bf16, d and ff multiples of 8, 16-byte aligned tensors):
// the tensor cores, through wgmma (bf16 in, fp32 out), both operands read
// from shared memory by descriptor.
//   * Grid: (column blocks of y, grouped C to a cluster) x (M tiles of 64
//     rows) x (S splits of ff).  CTA x along the first axis owns y's
//     columns [256 x, 256 x + 256) and keeps that 64 x 256 fp32 block in
//     registers (two warpgroups, 64 x 128 each) over the whole ff walk;
//     cluster rank c of cluster q is CTA x = q C + c.  The grid's first
//     axis is ceil(d / 256) rounded up to a multiple of C (a CTA past d
//     owns no column but still computes its h blocks for its cluster).
//     With n = ceil(d / (256 C)) > 1 clusters split d, each computing
//     every h block of its split again: (2n + 1) / 3 of the FLOPs, and
//     Wg / Wu read n times (the n clusters of a split are adjacent in the
//     grid, so they run together and share those reads through L2).  C
//     is at most 16, a non-portable cluster size past 8 (H100 SXM: one
//     such cluster a GPC), so n can stay at 2 up to d 8192; ops.py's
//     planner chooses C (n from 1 up to the portable clusters' ceil(d /
//     2048)) by its model of waves x rounds x steps a round, from the
//     occupancy calculator's clusters a wave.  (A 128-row tile over 16
//     ranks of 128 columns spilled and timed slower: PERF.md.)
//   * The split's ff blocks (64 columns) are dealt to the cluster's CTAs
//     round robin.  In a round each CTA computes [g | u] for its block
//     (64 x 128, K = d; warpgroup 0 g, warpgroup 1 u, which it hands over
//     through shared memory) and forms h = silu(g) * u, rounded to bf16,
//     in its own shared memory; after a cluster barrier every CTA reads
//     the round's h blocks through distributed shared memory, two buffers
//     deep (block j + 1 loads while block j multiplies), and adds h_blk @
//     Wd[blk, its columns] into its y block, in block order.  So each
//     Wd byte is read once per M tile (Wg and Wu n times), and h stays in
//     shared memory (two buffers of the CTA's own, so one cluster barrier
//     a round).
//   * x, Wg, Wu (64 x 64 tiles) and Wd (64 x 256, as four 64 x 64 blocks)
//     stream through a 4-stage ring of 32 KB stages filled by 16-byte
//     cp.async copies, zero-filled past M, d and ff; each thread's copy
//     addresses are fixed for the walk.  Every tile is in the 128-byte
//     swizzle's canonical layout (see desc).  One block barrier a 64-deep
//     step.  (An mma.sync + ldmatrix version was slower at every prefill
//     shape and faster at decode, where it skipped the m16 tiles past M:
//     PERF.md.)
//   * The tensor core sums each 64-deep step from zero; IEEE fp32 adds
//     fold the step into the accumulators.
//   * S = 1 (as many M tiles as clusters a wave): y is cast and stored
//     directly.  S > 1 (decode, chunked prefill): each split writes its
//     partial y into an (S, M, d) fp32 workspace and linked_mlp_reduce
//     sums the S partials in split order.  No atomics: two launches give
//     the same bits.
//
// linked_mlp_tc_prefill (the same shapes, from ops.py's PREFILL_ROWS rows
// on): the tensor-core kernel's prefill body.  The decode body runs each
// 64-deep step as a chain nothing overlaps (cp.async, a block barrier,
// one m64n64 product a warpgroup, a wait to zero) and feeds each weight
// tile to 64 rows; at M 4352 it took ~0.7 us a step, 3-5x the tensor
// cores' time.  This body:
//   * Tiles of 128 rows: warpgroups 1 and 2 each take 64 rows against the
//     same weight tiles; an up step is one m64n128 product a warpgroup
//     ([g | u]: Wg's 64 columns, then Wu's, side by side in the stage).
//     A CTA owns 128 columns of y, so a cluster of up to 16 covers d 2048
//     (past it, clusters split d as the decode body's do).
//   * A TMA ring (4 stages of 32 KB, 128-byte swizzle, zero fill past M,
//     d and ff) with full / empty mbarriers, filled by one thread of
//     warpgroup 0.  The x tile is the same for every rank of a cluster:
//     each rank loads its share of 8-row boxes and multicasts them to all,
//     so a stage is free only when every rank's consumers released it
//     (the empty barrier counts 2 C arrivals).
//   * h crosses the cluster by bulk copies: at down step j rank i
//     multiplies block (i + j) % nblk, whose rank pushes its h (16 KB)
//     into the free half of rank i's stage, counted by that stage's full
//     barrier; each rank sends one block a step, not all at once.  A
//     round's h is published with release-arrivals on every rank's hready
//     barrier after a proxy fence; the wait acquires.
//   * The two consumer warpgroups take turns issuing their products (two
//     named barriers), so one folds and waits while the tensor core runs
//     the other's step.  Each 64-deep step is summed from zero and folded
//     by IEEE fp32 adds, as in the decode body (the same bits where the
//     plan is the same).
//   * 168 registers a thread (three warps share each SM sub-partition):
//     y (64), the fold (64) and a step's product (64) do not fit at once,
//     so y is parked in shared memory over the up-projection.
// S = 1 stores y directly, S > 1 goes through the workspace and
// linked_mlp_reduce, as the decode body.  The host encodes the four
// tensor maps at each launch (kernel parameters, so a CUDA graph keeps
// them).
//
// linked_mlp_tc_swap (the same shapes, at decode rows: ops.py's tc_body):
// the tensor-core kernel's swap body.  Past d 2048 the decode body's
// clusters split d, each computing every h block of its ff split again
// ((2n + 1) / 3 of the FLOPs, Wg and Wu read n times), because a CTA's
// 64 x 256 fp32 y block in registers (56 of 64 rows padding at 8 rows)
// caps it at 256 columns.  This body swaps the operands: g^T = Wg^T x^T,
// u^T = Wu^T x^T, then y^T += Wd^T h^T, so wgmma's M runs over ff and d
// (64 a product) and its N over the rows, M padded to N = 8, 16, 32 or 64.
//   * A y tile is 64 columns x N rows: N / 2 fp32 registers a thread.  A
//     rank owns T tiles (at most 16, and 256 / N: 64 registers of y), so
//     one cluster of C <= 16 ranks owns all of d up to 16384 columns at 8
//     rows: every h block is computed once, every weight byte read once.
//     Grid: (C, 1, S), one cluster a split of ff; S fills the card.
//   * Per round each rank computes its own ff block's g^T (warpgroup 1)
//     and u^T (warpgroup 2), A = the Wg / Wu tile (64 k x 64 ff, MN-major:
//     transposed), B = x's tile (N rows x 64 k, K-major), each 64-deep
//     step summed from zero and folded by IEEE fp32 adds (the decode
//     body's arithmetic); h = silu(g) * u, rounded to bf16, lands in the
//     rank's own buffer in the K-major layout of a down product's B.
//     After the round barrier (mbarriers, release / acquire at cluster
//     scope) each rank pulls the round's h blocks through distributed
//     shared memory, two buffers deep, in the order (rank + j) % nblk, and
//     adds Wd[block, tile]^T h^T into its tiles, two tiles a step (one a
//     warpgroup), the tensor core chaining y over the whole ff walk.
//   * One thread of warpgroup 0 feeds a TMA ring of 6 stages (Wg, Wu and
//     x's tiles of an up step; two Wd tiles of a down step), running
//     ahead across rounds; 4 and 8 stages timed slower (PERF.md).
//   * S = 1 stores y directly, S > 1 goes through the workspace and
//     linked_mlp_reduce, as the other bodies.
//
// linked_mlp_partial (fp32, and bf16 shapes the tensor-core kernel does
// not take): the FFMA kernel.  Each thread block computes one (BM <= 8
// rows) x (64 ff columns) block of h on chip and consumes it there, and
// reads every weight byte once per M tile.
//   * Grid: (M tiles of BM rows) x (S splits of ff).  S fills the SMs (at
//     decode M = 8 is one M tile, so the CTAs come from the ff split).
//     CTAs that share an ff split are adjacent in the grid, so they read
//     the same weights through L2 together.
//   * Each CTA keeps its x tile (fp32, k-major, so one k reads the BM rows
//     as float4 broadcasts) and an fp32 partial y (BM x d) in shared
//     memory: 128 KB at BM = 8, d = 2048, above the 48 KB default, so
//     dynamic (cudaFuncSetAttribute).  It walks its ff range in blocks of
//     64.  Phase A: warps 0-3 compute the g block, warps 4-7 the u block,
//     each warp one slice of d, its lanes reading whole block rows with
//     16-byte loads (8 bf16 or 4 fp32 a lane, 4 or 2 rows a warp); the
//     partial sums meet through warp shuffles and shared memory in a fixed
//     order; silu, product, h rounded to x's type.  Phase B adds h_blk @
//     Wd[blk, :] into the partial y, each thread owning 8 (bf16) or 4
//     (fp32) columns.  Rows that are not 16-byte aligned (d or ff not a
//     multiple of 8 in bf16, 4 in fp32) take the same code with 2 elements
//     a lane and scalar loads.
//   * A lane issues the loads of 8 weight rows before it multiplies any:
//     with one load in flight the serving shapes were latency-bound at
//     ~0.1 ms per 64-column block (H100 SXM, 700 W).
//   * Each CTA writes its partial y into the (S, M, d) fp32 workspace;
//     linked_mlp_reduce sums the S partials in split order and casts.
// Ragged M, d and ff are masked (rows past M, columns past d or ff are
// zero).  The launches allocate nothing and never synchronize, so they
// can be captured into a CUDA graph.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stddef.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBF = 64;                 // ff columns per block
constexpr int kMaxSmem = 227 * 1024;    // per-block opt-in shared memory

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// The BM x-values of one k (k-major tile): float4 broadcasts where BM
// allows.
template <int BM>
__device__ __forceinline__ void load_rows(const float* src, float (&v)[BM]) {
  if constexpr (BM % 4 == 0) {
#pragma unroll
    for (int r = 0; r < BM; r += 4) {
      const float4 q = *reinterpret_cast<const float4*>(src + r);
      v[r] = q.x; v[r + 1] = q.y; v[r + 2] = q.z; v[r + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < BM; ++r) v[r] = src[r];
  }
}

// V consecutive elements of T, loaded now and converted later, so that a
// lane can have several loads in flight before it uses any.  n is how
// many of them are valid (n <= 0: none); an invalid load reads ``safe``
// instead and converts to zeros.  When V elements are 16 bytes it is one
// 16-byte load, and n is then a multiple of V (the launch checks that d
// and ff are).
template <typename T, int V, bool kVec = V * sizeof(T) == 16>
struct Chunk;

template <typename T, int V>
struct Chunk<T, V, true> {
  uint4 q;
  __device__ __forceinline__ void load(const T* p, const T* safe, int n) {
    q = __ldg(reinterpret_cast<const uint4*>(n >= V ? p : safe));
  }
  __device__ __forceinline__ void get(int n, float (&v)[V]) const {
    const unsigned w[4] = {q.x, q.y, q.z, q.w};
    const bool ok = n >= V;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (sizeof(T) == 2) {     // bf16: the high half of a float
        v[2 * i] = ok ? __uint_as_float(w[i] << 16) : 0.f;
        v[2 * i + 1] = ok ? __uint_as_float(w[i] & 0xffff0000u) : 0.f;
      } else {
        v[i] = ok ? __uint_as_float(w[i]) : 0.f;
      }
    }
  }
};

template <typename T, int V>
struct Chunk<T, V, false> {
  T e[V];
  __device__ __forceinline__ void load(const T* p, const T* safe, int n) {
#pragma unroll
    for (int j = 0; j < V; ++j) e[j] = *(j < n ? p + j : safe);
  }
  __device__ __forceinline__ void get(int n, float (&v)[V]) const {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = j < n ? to_float(e[j]) : 0.f;
  }
};

// xs (d x bm) + ys (bm x d) + red (kWarps x bm x kBF) + hs (kBF x bm)
constexpr size_t smem_bytes(int bm, int d) {
  return sizeof(float) * (2 * static_cast<size_t>(bm) * d +
                          kWarps * bm * kBF + kBF * bm);
}

// BM rows per M tile.  V: elements a lane loads at once, 16 / sizeof(T)
// (one 16-byte load) when d and ff are multiples of it and the weights
// 16-byte aligned, else 2 (scalar loads).
template <typename T, int BM, int V>
__global__ void __launch_bounds__(kThreads)
linked_mlp_partial(const T* __restrict__ x, const T* __restrict__ wg,
                   const T* __restrict__ wu, const T* __restrict__ wd,
                   float* __restrict__ part, int M, int d, int ff,
                   int n_blocks, int S) {
  constexpr int kLPR = kBF / V;          // phase A: lanes across a block row
  constexpr int kRPW = 32 / kLPR;        // block rows a warp reads at once
  constexpr int kSlices = kWarps / 2;    // d slices per up-projection
  constexpr int kU = 8;                  // loads a lane keeps in flight
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                           // [d][BM]
  float* ys = xs + static_cast<size_t>(BM) * d;   // [BM][d]
  float* red = ys + static_cast<size_t>(BM) * d;  // [kWarps][BM][kBF]
  float* hs = red + kWarps * BM * kBF;        // [kBF][BM]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int m0 = blockIdx.x * BM;
  const int s = blockIdx.y;
  const int rows = min(BM, M - m0);
  // this split's ff blocks: [jb0, jb1), balanced over the S splits
  const int jb0 = static_cast<int>(static_cast<long long>(s) * n_blocks / S);
  const int jb1 =
      static_cast<int>(static_cast<long long>(s + 1) * n_blocks / S);

  // x tile, k-major, zero past M; partial y zeroed
  for (int e = tid; e < BM * d; e += kThreads) {
    const int r = e / d, k = e % d;
    xs[static_cast<size_t>(k) * BM + r] =
        r < rows ? to_float(x[static_cast<size_t>(m0 + r) * d + k]) : 0.f;
    ys[e] = 0.f;
  }
  __syncthreads();

  // phase A: warps [0, kSlices) compute x @ Wg, the others x @ Wu; each
  // takes one d slice [k0, k1), its lanes kRPW rows at a time, lane
  // columns [c, c + V)
  const T* w_up = warp < kSlices ? wg : wu;
  const int slice = warp % kSlices;
  const int kper = (d + kSlices - 1) / kSlices;
  const int k0 = min(d, slice * kper), k1 = min(d, k0 + kper);
  const int rg = lane / kLPR;
  const int c = (lane % kLPR) * V;

  for (int jb = jb0; jb < jb1; ++jb) {
    const int f0 = jb * kBF;
    const int nc = ff - f0 - c;             // valid columns from c on
    float acc[BM][V];
#pragma unroll
    for (int r = 0; r < BM; ++r)
#pragma unroll
      for (int j = 0; j < V; ++j) acc[r][j] = 0.f;
    const T* pw = w_up + f0 + c;
    // kU rows of the slice a step: all kU loads are issued first
#pragma unroll 1
    for (int k = k0 + rg; k < k1; k += kU * kRPW) {
      Chunk<T, V> ch[kU];
      int nv[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int kk = k + u * kRPW;
        nv[u] = kk < k1 ? nc : 0;
        ch[u].load(pw + static_cast<size_t>(min(kk, k1 - 1)) * ff, w_up,
                   nv[u]);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        float wv[V];
        ch[u].get(nv[u], wv);
        float xv[BM];
        load_rows<BM>(xs + static_cast<size_t>(min(k + u * kRPW, k1 - 1)) *
                               BM, xv);
#pragma unroll
        for (int r = 0; r < BM; ++r)
#pragma unroll
          for (int j = 0; j < V; ++j)
            acc[r][j] = fmaf(xv[r], wv[j], acc[r][j]);
      }
    }
    // sum the warp's row groups (lanes kLPR apart) in a fixed pattern
#pragma unroll
    for (int off = kLPR; off < 32; off <<= 1)
#pragma unroll
      for (int r = 0; r < BM; ++r)
#pragma unroll
        for (int j = 0; j < V; ++j)
          acc[r][j] += __shfl_xor_sync(0xffffffffu, acc[r][j], off);
    if (rg == 0) {
      float* dst = red + warp * BM * kBF;
#pragma unroll
      for (int r = 0; r < BM; ++r)
#pragma unroll
        for (int j = 0; j < V; ++j) dst[r * kBF + c + j] = acc[r][j];
    }
    __syncthreads();
    // sum the d slices in slice order; h = silu(g) * u, rounded to T
    for (int e = tid; e < BM * kBF; e += kThreads) {
      float g = 0.f, u = 0.f;
#pragma unroll
      for (int w = 0; w < kSlices; ++w) {
        g += red[w * BM * kBF + e];
        u += red[(kSlices + w) * BM * kBF + e];
      }
      const float h = g / (1.f + expf(-g)) * u;
      const int r = e / kBF, cc = e % kBF;
      hs[cc * BM + r] = to_float(from_float<T>(h));
    }
    __syncthreads();

    // phase B: ys[:, cols] += h_blk @ Wd[f0 : f0 + nf, cols]; each thread
    // owns columns [cb, cb + V) for cb = V * tid + V * kThreads * i
    const int nf = min(kBF, ff - f0);
    for (int cb = V * tid; cb < d; cb += V * kThreads) {
      float yb[BM][V];
#pragma unroll
      for (int r = 0; r < BM; ++r)
#pragma unroll
        for (int j = 0; j < V; ++j) yb[r][j] = 0.f;
      const T* pd = wd + static_cast<size_t>(f0) * d + cb;
      const int ncol = d - cb;
#pragma unroll 1
      for (int f = 0; f < nf; f += kU) {
        Chunk<T, V> ch[kU];
        int nv[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          nv[u] = f + u < nf ? ncol : 0;
          ch[u].load(pd + static_cast<size_t>(min(f + u, nf - 1)) * d, wd,
                     nv[u]);
        }
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          float wv[V];
          ch[u].get(nv[u], wv);
          float hv[BM];
          load_rows<BM>(hs + min(f + u, nf - 1) * BM, hv);
#pragma unroll
          for (int r = 0; r < BM; ++r)
#pragma unroll
            for (int j = 0; j < V; ++j)
              yb[r][j] = fmaf(hv[r], wv[j], yb[r][j]);
        }
      }
#pragma unroll
      for (int r = 0; r < BM; ++r)
#pragma unroll
        for (int j = 0; j < V; ++j)
          if (cb + j < d) ys[static_cast<size_t>(r) * d + cb + j] += yb[r][j];
    }
  }
  __syncthreads();

  // this split's partial y -> part[s, m0 : m0 + rows, :]
  float* dst = part + (static_cast<size_t>(s) * M + m0) * d;
  for (int e = tid; e < rows * d; e += kThreads) dst[e] = ys[e];
}

// out[i] = T(sum_s part[s, i]), summed in split order
template <typename T>
__global__ void __launch_bounds__(kThreads)
linked_mlp_reduce(const float* __restrict__ part, T* __restrict__ out,
                  size_t n, int S) {
  const size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  float acc = 0.f;
  int s = 0;
  for (; s + 8 <= S; s += 8) {       // 8 loads in flight, summed in order
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = part[static_cast<size_t>(s + u) * n + i];
#pragma unroll
    for (int u = 0; u < 8; ++u) acc += v[u];
  }
  for (; s < S; ++s) acc += part[static_cast<size_t>(s) * n + i];
  out[i] = from_float<T>(acc);
}

// The FFMA kernel's smem_bytes(bm, d) must fit; v must be 16 / sizeof(T)
// (16-byte loads: d and ff multiples of it, weights 16-byte aligned) or 2.
template <typename T, int BM, int V>
cudaError_t launch(const T* x, const T* wg, const T* wu, const T* wd,
                   float* part, int M, int d, int ff, int S,
                   cudaStream_t stream) {
  static bool attr_set = false;    // once per instantiation: max opt-in
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        linked_mlp_partial<T, BM, V>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  linked_mlp_partial<T, BM, V>
      <<<dim3((M + BM - 1) / BM, S), kThreads, smem_bytes(BM, d), stream>>>(
          x, wg, wu, wd, part, M, d, ff, (ff + kBF - 1) / kBF, S);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch_bm(int bm, const T* x, const T* wg, const T* wu,
                      const T* wd, float* part, int M, int d, int ff, int S,
                      cudaStream_t st) {
  switch (bm) {
    case 8: return launch<T, 8, V>(x, wg, wu, wd, part, M, d, ff, S, st);
    case 4: return launch<T, 4, V>(x, wg, wu, wd, part, M, d, ff, S, st);
    case 2: return launch<T, 2, V>(x, wg, wu, wd, part, M, d, ff, S, st);
    case 1: return launch<T, 1, V>(x, wg, wu, wd, part, M, d, ff, S, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t reduce(const float* part, void* out, size_t n, int S,
                   cudaStream_t stream) {
  linked_mlp_reduce<T><<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                         kThreads, 0, stream>>>(part, static_cast<T*>(out), n,
                                                S);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(int bm, int v, const void* x, const void* wg,
                     const void* wu, const void* wd, void* part, void* out,
                     int M, int d, int ff, int S, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(wg);
  const T* up = static_cast<const T*>(wu);
  const T* dp = static_cast<const T*>(wd);
  float* pp = static_cast<float*>(part);
  constexpr int kVec = 16 / sizeof(T);
  const size_t addr = reinterpret_cast<size_t>(wg) |
                      reinterpret_cast<size_t>(wu) |
                      reinterpret_cast<size_t>(wd);
  if (v == kVec && (d % kVec || ff % kVec || (addr & 15)))
    return cudaErrorInvalidValue;
  const cudaError_t err =
      v == kVec ? launch_bm<T, kVec>(bm, xp, gp, up, dp, pp, M, d, ff, S,
                                     stream)
      : v == 2  ? launch_bm<T, 2>(bm, xp, gp, up, dp, pp, M, d, ff, S, stream)
                : cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  return reduce<T>(pp, out, static_cast<size_t>(M) * d, S, stream);
}

// ---------------------------------------------------------------------------
// linked_mlp_tc: bf16 on the tensor cores
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 256;       // 2 warpgroups
constexpr int kBF = 64;             // ff columns of a block
constexpr int kBK = 64;             // d (k) per up-projection step
constexpr int kStages = 4;
constexpr int kStage = 64 * 256;    // bf16 elements of a ring stage (32 KB)

// Tiles: 64 rows an M tile; a cluster rank owns 256 columns of y.
// Warpgroup 0 computes g, warpgroup 1 u (64 x 64 each) in the
// up-projection; warpgroup w holds y columns 128 w .. 128 w + 127 of the
// rank's slice.
constexpr int kBM = 64;
constexpr int kDS = 256;
constexpr int kMaxCluster = 16;             // non-portable past 8
constexpr int kH = kBM * kBF;               // bf16 elements of an h block
static_assert((kBM + 2 * kBK) * kBF <= kStage && kBF * kDS <= kStage,
              "a ring stage holds either step's tiles");
// ring, own h (two buffers), the streamed h blocks (two buffers), u on
// its way to warpgroup 0 (fp32), and slack to align the base to 1024
// bytes (the 128-byte swizzle's period)
constexpr size_t kSmemBytes =
    sizeof(bf16) * (static_cast<size_t>(kStages) * kStage + 4 * kH) +
    sizeof(float) * kBM * kBF + 1024;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zero-filled (nothing read)
// when !pred
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets, 128-byte swizzle.  Every tile here is laid out in
// that swizzle's canonical form: rows of 128 bytes (64 bf16), 16-byte
// chunk c of row r stored at chunk c ^ (r & 7), 8-row groups 1024 bytes
// apart (the stride offset).  A (x, h) is K-major: a 16-deep k slice
// starts 32 bytes further.  B (Wg, Wu, Wd; N contiguous) is MN-major
// (transposed): a k slice starts 16 rows (2048 bytes) further, and
// 64-column blocks of a wider B lie 8192 bytes apart (the leading
// offset).
__device__ __forceinline__ uint64_t desc(unsigned addr, unsigned lbo,
                                         unsigned sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}
// wgmma.fence before the first MMA of a step; commit and wait for the
// step's group; a fence from the generic proxy (cp.async, st.shared) to
// the async proxy (wgmma's operand reads) before a step's barrier
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keep the compiler from moving accumulator uses across the wait
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// d (64 x N fp32, the warpgroup's fragments) = A @ B (scale_d = 0) or +=
// A @ B, bf16 in; A K-major, B MN-major
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Where the copies are: round r, phase 0 (up-projection step i of the
// CTA's own block) or 1 (down-projection of the round's block i).
struct Cursor {
  int r, ph, i;
};

// x (M,d), wg/wu (d,ff), wd (ff,d) bf16; part (S,M,d) fp32 (S > 1) or out
// (M,d) bf16 (S == 1).  gridDim = (n C, M tiles, S), cluster (C, 1, 1).
__global__ void __launch_bounds__(kThreads, 1)
linked_mlp_tc(const bf16* __restrict__ x, const bf16* __restrict__ wg,
              const bf16* __restrict__ wu, const bf16* __restrict__ wd,
              float* __restrict__ part, bf16* __restrict__ out, int M, int d,
              int ff, int C, int S) {
  constexpr int kKS = kBK / 16;               // k16 slices a step
  static_assert(kBF == kBK, "up and down steps are both 64 deep");
  extern __shared__ __align__(1024) unsigned char tc_smem_raw[];
  unsigned char* tc_smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<size_t>(tc_smem_raw) + 1023) & ~size_t(1023));
  bf16* ring = reinterpret_cast<bf16*>(tc_smem);
  bf16* hbuf = ring + kStages * kStage;       // [2][64][64]: own h
  bf16* hall = hbuf + 2 * kH;                 // [2][64][64]: the round's
  float* ex = reinterpret_cast<float*>(hall + 2 * kH);   // [32][128]: u
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(blockIdx.x) % C;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wgi = warp >> 2, w4 = warp & 3, tg = tid & 127;
  const int m0 = blockIdx.y * kBM;
  const int s = blockIdx.z;
  const int col0 = static_cast<int>(blockIdx.x) * kDS;
  const int nb = (ff + kBF - 1) / kBF;
  const int jb0 = static_cast<int>(static_cast<long long>(s) * nb / S);
  const int jb1 = static_cast<int>(static_cast<long long>(s + 1) * nb / S);
  const int R = (jb1 - jb0 + C - 1) / C;       // rounds
  const int n_up = (d + kBK - 1) / kBK;        // up steps of a block

  // the next valid step at or after c (c.r == R: none left)
  auto settle = [&](Cursor& c) {
    while (c.r < R) {
      const int base = jb0 + c.r * C;
      if (c.ph == 0) {
        if (base + rank < jb1 && c.i < n_up) return;
        c.ph = 1;
        c.i = 0;
      }
      if (c.i < C && base + c.i < jb1) return;
      ++c.r;
      c.ph = 0;
      c.i = 0;
    }
  };
  // Each thread's copies keep their shared-memory offsets and row bases
  // for the whole walk; a step moves only k0 or the ff block.  16-byte
  // chunks, swizzled: chunk ch of tile row r lands at chunk ch ^ (r & 7).
  // x and Wg/Wu tiles (rows of 64): rows xr + 32 i, chunk xc.
  const int xr = tid >> 3, xc = tid & 7;
  const int sw_off = xr * 64 + ((xc ^ (xr & 7)) << 3);
  const int x_rows = max(0, min(kBM / 32, (M - m0 - xr + 31) / 32));
  const bf16* xb = x + (static_cast<size_t>(m0 + xr) * d + xc * 8);
  const size_t x_step = static_cast<size_t>(32) * d;
  const size_t w_row = static_cast<size_t>(xr) * ff + xc * 8;
  const size_t w_step = static_cast<size_t>(32) * ff;
  // Wd tiles (64 x kDS as kDS / 64 blocks of 64 columns, 8 KB apart):
  // rows dr + kDRows i, chunk dc (block dc / 8)
  constexpr int kCh = kDS / 8, kDRows = kThreads / kCh;
  const int dr = tid / kCh, dc = tid % kCh;
  const int d_sm = (dc >> 3) * 4096 + dr * 64 + (((dc & 7) ^ (dr & 7)) << 3);
  const bool d_col = col0 + dc * 8 < d;
  const size_t d_row = static_cast<size_t>(dr) * d + col0 + dc * 8;
  const size_t d_step = static_cast<size_t>(kDRows) * d;
  // c's tiles into ring slot `slot`; zero-filled past M, d and ff
  auto issue = [&](const Cursor& c, int slot) {
    bf16* st = ring + slot * kStage;
    const int base = jb0 + c.r * C;
    if (c.ph == 0) {
      const int f0 = (base + rank) * kBF, k0 = c.i * kBK;
      const bool kx = k0 + xc * 8 < d;
#pragma unroll
      for (int i = 0; i < kBM / 32; ++i) {
        const bool ok = kx && i < x_rows;
        cp_async16(st + sw_off + i * 32 * kBK, ok ? xb + i * x_step + k0 : x,
                   ok);
      }
      bf16* sg = st + kBM * kBK;
      const bool fw = f0 + xc * 8 < ff;
      const size_t wo = w_row + static_cast<size_t>(k0) * ff + f0;
#pragma unroll
      for (int i = 0; i < kBK / 32; ++i) {
        const bool ok = fw && k0 + xr + 32 * i < d;
        const size_t src = wo + i * w_step;
        cp_async16(sg + sw_off + i * 32 * kBF, ok ? wg + src : wg, ok);
        cp_async16(sg + kBK * kBF + sw_off + i * 32 * kBF,
                   ok ? wu + src : wu, ok);
      }
    } else {
      const int f0 = (base + c.i) * kBF;
      const size_t dof = d_row + static_cast<size_t>(f0) * d;
#pragma unroll
      for (int i = 0; i < kBF / kDRows; ++i) {
        const bool ok = d_col && f0 + dr + kDRows * i < ff;
        cp_async16(st + d_sm + i * kDRows * 64,
                   ok ? wd + dof + i * d_step : wd, ok);
      }
    }
  };

  Cursor prod{0, 0, 0};
  settle(prod);
  auto issue_next = [&](int slot) {
    if (prod.r < R) {
      issue(prod, slot);
      ++prod.i;
      settle(prod);
    }
    cp_async_commit();               // empty groups keep the count aligned
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue_next(i);
  int slot = 0;
  // wait for the consumer's next step; refill the slot the last one freed
  auto next_step = [&]() {
    cp_async_wait<kStages - 2>();
    fence_async_smem();
    __syncthreads();
    issue_next((slot + kStages - 1) % kStages);
  };

  // y: warpgroup wgi holds columns 128 wgi .. of the rank's slice
  float yacc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) yacc[e] = 0.f;

  // one h block of rank j's own buffer `hb` through distributed shared
  // memory: this thread's chunks, loaded now and stored later
  constexpr int kHC = kH / 8 / kThreads;       // 16-byte chunks a thread
  auto h_load = [&](const bf16* hb, int j, uint4 (&v)[kHC]) {
    const uint4* src =
        reinterpret_cast<const uint4*>(cluster.map_shared_rank(hb, j));
#pragma unroll
    for (int u = 0; u < kHC; ++u) v[u] = src[u * kThreads + tid];
  };
  auto h_store = [&](bf16* dst, const uint4 (&v)[kHC]) {
#pragma unroll
    for (int u = 0; u < kHC; ++u)
      reinterpret_cast<uint4*>(dst)[u * kThreads + tid] = v[u];
  };

  for (int r = 0; r < R; ++r) {
    const int base = jb0 + r * C;
    bf16* hown = hbuf + (r & 1) * kH;
    if (base + rank < jb1) {
      // warpgroup 0: g = x @ Wg, warpgroup 1: u = x @ Wu (64 x 64 each)
      float uacc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) uacc[e] = 0.f;
      for (int i = 0; i < n_up; ++i) {
        next_step();
        const unsigned st = smem_u32(ring + slot * kStage);
        const unsigned wb = st + 2 * kBM * kBK + wgi * 2 * kBK * kBF;
        // the tensor core sums the step's 64 k from zero; IEEE adds fold
        // the step into uacc.  Chaining uacc through the tensor core over
        // all of d kept its own accumulation throughout, whose error from
        // the fp64 sum measured up to 2.2x the plain version's (H100 SXM,
        // 700 W).
        float t[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) t[e] = 0.f;
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < kKS; ++ks)
          wgmma_n64(t, desc(st + ks * 32, 0, 1024),
                    desc(wb + ks * 2048, 8192, 1024), ks);
        wg_commit();
        wg_wait0();
        reg_fence(t);
#pragma unroll
        for (int e = 0; e < 32; ++e) uacc[e] += t[e];
        slot = (slot + 1) % kStages;
      }
      // u to warpgroup 0 through shared memory, then h = silu(g) * u,
      // rounded to bf16, into this round's own buffer
      if (wgi == 1)
#pragma unroll
        for (int e = 0; e < 32; ++e) ex[e * 128 + tg] = uacc[e];
      __syncthreads();
      if (wgi == 0)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = 16 * w4 + (lane >> 2) + 8 * half;
            const int e = 4 * j + 2 * half;
            const float g0 = uacc[e], g1 = uacc[e + 1];
            const float h0 = g0 / (1.f + expf(-g0)) * ex[e * 128 + tg];
            const float h1 = g1 / (1.f + expf(-g1)) * ex[(e + 1) * 128 + tg];
            *reinterpret_cast<__nv_bfloat162*>(
                hown + row * kBF + ((j ^ (row & 7)) << 3) + 2 * (lane & 3)) =
                __floats2bfloat162_rn(h0, h1);
          }
    }
    // every rank's h of this round is written (release / acquire)
    cluster.sync();
    // y[:, col0 ..] += h_j @ Wd[block j, col0 ..], j in rank order; h_j
    // comes through distributed shared memory into hall[j & 1], block j+1
    // loaded while block j multiplies.  Each step's proxy fence and block
    // barrier order the stores before the next step's wgmma reads them.
    const int nblk = min(C, jb1 - base);
    {
      uint4 v[kHC];
      h_load(hown, 0, v);
      h_store(hall, v);
    }
    for (int j = 0; j < nblk; ++j) {
      next_step();
      uint4 v[kHC];
      const bool more = j + 1 < nblk;
      if (more) h_load(hown, j + 1, v);
      {
        // this warpgroup's two 64-column blocks of the Wd tile
        const unsigned st = smem_u32(ring + slot * kStage) + wgi * 16384;
        const unsigned ha = smem_u32(hall + (j & 1) * kH);
        float t[64];
#pragma unroll
        for (int e = 0; e < 64; ++e) t[e] = 0.f;
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < kKS; ++ks)
          wgmma_n128(t, desc(ha + ks * 32, 0, 1024),
                     desc(st + ks * 2048, 8192, 1024), ks);
        wg_commit();
        wg_wait0();
        reg_fence(t);
#pragma unroll
        for (int e = 0; e < 64; ++e) yacc[e] += t[e];
      }
      if (more) h_store(hall + ((j + 1) & 1) * kH, v);
      slot = (slot + 1) % kStages;
    }
  }
  cp_async_wait<0>();
  cluster.sync();        // no CTA leaves while another reads its h

  // y block: cast and store (S == 1) or this split's fp32 partial
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int gm = m0 + 16 * w4 + (lane >> 2) + 8 * half;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int gc = col0 + 128 * wgi + 8 * j + 2 * (lane & 3);
      if (gc >= d) continue;
      const float v0 = yacc[4 * j + 2 * half];
      const float v1 = yacc[4 * j + 2 * half + 1];
      if (S == 1)
        *reinterpret_cast<__nv_bfloat162*>(
            out + static_cast<size_t>(gm) * d + gc) =
            __floats2bfloat162_rn(v0, v1);
      else
        *reinterpret_cast<float2*>(
            part + (static_cast<size_t>(s) * M + gm) * d + gc) =
            make_float2(v0, v1);
    }
  }
}

// CTAs along the grid's first axis: d's column blocks, rounded up to
// whole clusters of C
int grid_x(int d, int C) {
  const int blocks = (d + kDS - 1) / kDS;
  return (blocks + C - 1) / C * C;
}

// Launch configuration of a (gx, M, C, S) call; numAttrs 1 (the cluster).
struct Config {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  Config(int gx, int M, int C, int S, cudaStream_t stream) {
    cfg.gridDim = dim3(gx, (M + kBM - 1) / kBM, S);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = kSmemBytes;
    cfg.stream = stream;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = C;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
};

cudaError_t prepare() {
  // once: max opt-in shared memory, and clusters past the portable 8
  static bool attr_set = false;
  if (attr_set) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      linked_mlp_tc, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        linked_mlp_tc, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) attr_set = true;
  return err;
}

cudaError_t launch(const bf16* x, const bf16* wg, const bf16* wu,
                   const bf16* wd, float* part, bf16* out, int M, int d,
                   int ff, int C, int S, cudaStream_t stream) {
  cudaError_t err = prepare();
  if (err != cudaSuccess) return err;
  Config c(grid_x(d, C), M, C, S, stream);
  err = cudaLaunchKernelEx(&c.cfg, linked_mlp_tc, x, wg, wu, wd, part, out,
                           M, d, ff, C, S);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return err;
  return reduce<bf16>(part, out, static_cast<size_t>(M) * d, S, stream);
}

// clusters of C CTAs the current device runs at once; -1 on error
int max_clusters(int C) {
  if (prepare() != cudaSuccess) return -1;
  Config c(C, kBM, C, 1, nullptr);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, linked_mlp_tc, &c.cfg) !=
      cudaSuccess)
    return -1;
  return n;
}

}  // namespace tc

// ---------------------------------------------------------------------------
// linked_mlp_tc_prefill: bf16 on the tensor cores, 128-row tiles
// ---------------------------------------------------------------------------

namespace tp {

using bf16 = __nv_bfloat16;
using tc::desc;
using tc::reg_fence;
using tc::smem_u32;
using tc::wg_commit;
using tc::wg_fence;
using tc::wg_wait0;
using tc::wgmma_n128;

// Warpgroup 0 loads (one thread), warpgroups 1 and 2 compute.  Three
// warps share each SM sub-partition's registers: 168 a thread.
constexpr int kThreads = 384;
constexpr int kBM = 128;            // rows an M tile: 64 a consumer
constexpr int kBF = 64;             // ff columns a block
constexpr int kBK = 64;             // d (k) an up-projection step
constexpr int kDS = 128;            // y columns a CTA owns
constexpr int kMaxCluster = 16;     // non-portable past 8
constexpr int kStages = 4;
constexpr int kStage = 32768;       // bytes: an up step's x (128 x 64) and
                                    // Wg, Wu (64 x 64); a down step's Wd
                                    // (64 x 128) and the h block it takes
constexpr int kH = kBM * kBF * 2;   // bytes of an h block (128 x 64 bf16)
constexpr int kXBox = 8;            // x rows a multicast box
constexpr int kY = kBM * kDS * 4;   // bytes of y's fp32 block
// 1024 of alignment slack, the ring, own h (two buffers), y parked over
// the up-projection, the full, empty and two hready barriers
constexpr size_t kSmemBytes = 1024 + static_cast<size_t>(kStages) * kStage +
                              2 * kH + kY + (2 * kStages + 2) * 8;
static_assert(kSmemBytes <= 232448, "fits one CTA's opt-in shared memory");
// a wait longer than this (~9 s) is a protocol fault: trap, not hang
constexpr long long kHangCycles = 1ll << 34;

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
// ``kCluster``: acquire at cluster scope (what other ranks wrote before
// their release-arrivals is visible after the wait)
template <bool kCluster = false>
__device__ __forceinline__ bool mbar_try_wait(unsigned bar, unsigned parity) {
  unsigned ok;
  if (kCluster)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(bar), "r"(parity)
        : "memory");
  else
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(bar), "r"(parity)
        : "memory");
  return ok != 0;
}
template <bool kCluster = false>
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  if (mbar_try_wait<kCluster>(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait<kCluster>(bar, parity))
    if (clock64() - t0 > kHangCycles) __trap();
}
// Arrive on the barrier at `bar`'s offset in cluster rank `rank`.
// ``kRelease``: release at cluster scope, so that this CTA's writes made
// before it (ordered by a block barrier) reach the rank's readers; a
// membar over the whole device, so once a round, never a step.
template <bool kRelease = false>
__device__ __forceinline__ void mbar_arrive_rank(unsigned bar, unsigned rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(bar), "r"(rank));
  if (kRelease)
    asm volatile(
        "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::
            "r"(remote)
        : "memory");
  else
    asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(
                     remote)
                 : "memory");
}
// a 2-D tile of `map` at (c0 inner, c1 outer) into this CTA's `dst`
__device__ __forceinline__ void tma_load(unsigned dst, const CUtensorMap* map,
                                         unsigned bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
// the same into `dst` of every rank in `mask`, each signalling its own
// barrier at `bar`'s offset
__device__ __forceinline__ void tma_load_multicast(unsigned dst,
                                                   const CUtensorMap* map,
                                                   unsigned bar, int c0,
                                                   int c1,
                                                   unsigned short mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "h"(mask)
      : "memory");
}
// `bytes` of this CTA's shared memory at `src` into `dst` of cluster rank
// `rank`, signalling the barrier at `bar`'s offset there
__device__ __forceinline__ void push_rank(unsigned dst, unsigned src,
                                          unsigned bytes, unsigned bar,
                                          unsigned rank) {
  unsigned rdst, rbar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(rdst)
               : "r"(dst), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(rbar)
               : "r"(bar), "r"(rank));
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(rdst),
      "r"(src), "r"(bytes), "r"(rbar)
      : "memory");
}
// the cluster barrier: every thread of every rank
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_barrier(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// Tensor maps (128-byte swizzle, zero fill past the edges): x (d, M) in
// boxes of 64 x kXBox, wg / wu (ff, d) and wd (d, ff) in boxes of 64 x 64;
// part (S, M, d) fp32 (S > 1) or out (M, d) bf16 (S == 1).  gridDim = (n
// C, ceil(M / 128), S), cluster (C, 1, 1).
__global__ void __launch_bounds__(kThreads, 1)
linked_mlp_tc_prefill(const __grid_constant__ CUtensorMap tm_x,
                      const __grid_constant__ CUtensorMap tm_g,
                      const __grid_constant__ CUtensorMap tm_u,
                      const __grid_constant__ CUtensorMap tm_d,
                      float* __restrict__ part, bf16* __restrict__ out,
                      int M, int d, int ff, int C, int S) {
  extern __shared__ __align__(1024) unsigned char tp_smem_raw[];
  unsigned char* base_ptr = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<size_t>(tp_smem_raw) + 1023) & ~size_t(1023));
  const unsigned ring = smem_u32(base_ptr);
  unsigned char* hown_ptr = base_ptr + kStages * kStage;   // [2][128][64]
  const unsigned hown = ring + kStages * kStage;
  float* ypark = reinterpret_cast<float*>(hown_ptr + 2 * kH);  // [2][64][128]
  const unsigned bars = ring + kStages * kStage + 2 * kH + kY;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  // hready[b]: every consumer warpgroup of every rank has written its h
  // of a round r with r % 2 == b (and read the round before's)
  auto hready = [&](int b) { return bars + 8 * (2 * kStages + b); };

  const int rank = static_cast<int>(blockIdx.x) % C;
  const int m0 = blockIdx.y * kBM;
  const int s = blockIdx.z;
  const int col0 = static_cast<int>(blockIdx.x) * kDS;
  const int nb = (ff + kBF - 1) / kBF;
  const int jb0 = static_cast<int>(static_cast<long long>(s) * nb / S);
  const int jb1 = static_cast<int>(static_cast<long long>(s + 1) * nb / S);
  const int R = (jb1 - jb0 + C - 1) / C;       // rounds
  const int n_up = (d + kBK - 1) / kBK;        // up steps a round

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full(i), 1);
      // every consumer warpgroup of every rank releases each stage: the
      // x multicast writes all ranks' copies of it
      mbar_init(empty(i), 2 * C);
    }
    mbar_init(hready(0), 2 * C);
    mbar_init(hready(1), 2 * C);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();              // every rank's barriers exist before any
                               // copy or arrival reaches them

  if (threadIdx.x < 128) {
    // ---- producer: one thread keeps the ring full ----
    if (threadIdx.x != 0) return;
    const unsigned short mask = static_cast<unsigned short>((1u << C) - 1);
    int n = 0;                 // steps issued
    for (int r = 0; r < R; ++r) {
      const int blk0 = jb0 + r * C;
      // this rank's block; past jb1 it is computed (zero past ff) and
      // never read, so every rank walks the same steps
      const int f0 = (blk0 + rank) * kBF;
      for (int i = 0; i < n_up; ++i, ++n) {
        const int slot = n % kStages;
        mbar_wait(empty(slot), ((n / kStages) & 1) ^ 1);
        const unsigned st = ring + slot * kStage;
        mbar_expect_tx(full(slot), kStage);
        for (int g = rank; g < kBM / kXBox; g += C)
          tma_load_multicast(st + g * kXBox * 128, &tm_x, full(slot),
                             i * kBK, m0 + g * kXBox, mask);
        tma_load(st + 16384, &tm_g, full(slot), f0, i * kBK);
        tma_load(st + 24576, &tm_u, full(slot), f0, i * kBK);
      }
      // down step j of rank i takes block (i + j) % nblk: at every step
      // each rank's h goes to one rank (ceil(C / nblk) in a short last
      // round), not to all at once
      const int nblk = min(C, jb1 - blk0);
      for (int j = 0; j < nblk; ++j, ++n) {
        const int slot = n % kStages;
        mbar_wait(empty(slot), ((n / kStages) & 1) ^ 1);
        const unsigned st = ring + slot * kStage;
        // Wd's 64 x 128 tile, and the block's h from its rank's push
        mbar_expect_tx(full(slot), kStage);
        const int f = (blk0 + (rank + j) % nblk) * kBF;
        tma_load(st, &tm_d, full(slot), col0, f);
        tma_load(st + 8192, &tm_d, full(slot), col0 + 64, f);
        if (rank < nblk) {
          // this rank's h of the round is written (its consumers' proxy
          // fences and release-arrivals): push it into the stage of every
          // rank i that takes it now, (i + j) % nblk == rank, whose slot
          // every rank has released (the empty barrier counts them all)
          if (j == 0) mbar_wait<true>(hready(r & 1), (r >> 1) & 1);
          for (int q = ((rank - j) % nblk + nblk) % nblk; q < C; q += nblk)
            push_rank(st + 16384, hown + (r & 1) * kH, kH, full(slot), q);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup w takes rows 64 w .. 64 w + 63 ----
  const int w = threadIdx.x / 128 - 1;
  const int tg = threadIdx.x & 127, lane = tg & 31, w4 = tg >> 5;
  // release stage `slot` to every rank's producer (thread q signals rank
  // q); the warp meets again before its next .aligned instruction
  auto release = [&](int slot) {
    if (tg < C) mbar_arrive_rank(empty(slot), tg);
    __syncwarp();
  };
  // The round barrier over the consumers of every rank (the producer
  // runs ahead): the warpgroup's h stores are ordered by its block
  // barrier before thread q's release-arrival on rank q's hready[b]; the
  // wait acquires every rank's.
  auto round_sync = [&](int r) {
    tc::fence_async_smem();    // h's stores reach the pushes' reads
    wg_barrier(1 + w);
    if (tg < C) mbar_arrive_rank<true>(hready(r & 1), tg);
    mbar_wait<true>(hready(r & 1), (r >> 1) & 1);
    __syncwarp();
  };
  // a stage's data has landed (each lane polls; the warp meets again)
  auto await = [&](int slot, int n) {
    mbar_wait(full(slot), (n / kStages) & 1);
    __syncwarp();
  };
  // y (64 registers), the fold (64) and a step's product (64) do not fit
  // in 168 at once (ptxas allocates a kernel under its launch bound;
  // setmaxnreg's larger count for the consumers spilled the same).  So y
  // lives in registers over the down-projection only and is parked in
  // shared memory (this thread's 64 values, 128 apart) over the
  // up-projection.
  float* ymine = ypark + w * 64 * 128 + tg;
  // The two warpgroups take turns issuing their products (named
  // barriers 3 and 4, both warpgroups' 256 threads): the tensor core
  // runs one's step while the other folds and waits, instead of both
  // issuing together and both folding while it idles.  Warpgroup 0 goes
  // first.
  auto take_turn = [&]() {
    asm volatile("bar.sync %0, 256;\n" ::"r"(3 + w) : "memory");
  };
  auto pass_turn = [&]() {
    asm volatile("bar.arrive %0, 256;\n" ::"r"(4 - w) : "memory");
  };
  if (w == 1) pass_turn();
  float yacc[64];
  int n = 0;                   // steps consumed
  for (int r = 0; r < R; ++r) {
    const int blk0 = jb0 + r * C;
    {
      // [g | u] of this rank's block for 64 rows: the tensor core sums
      // each 64-deep step from zero (m64n128: Wg's 64 columns, then
      // Wu's); IEEE fp32 adds fold the steps in k order
      float acc[64];
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e] = 0.f;
      for (int i = 0; i < n_up; ++i, ++n) {
        const int slot = n % kStages;
        await(slot, n);
        const unsigned st = ring + slot * kStage;
        float t[64];
#pragma unroll
        for (int e = 0; e < 64; ++e) t[e] = 0.f;
        take_turn();
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < kBK / 16; ++ks)
          wgmma_n128(t, desc(st + w * 8192 + ks * 32, 0, 1024),
                     desc(st + 16384 + ks * 2048, 8192, 1024), ks);
        wg_commit();
        pass_turn();
        wg_wait0();
        reg_fence(t);
        release(slot);
#pragma unroll
        for (int e = 0; e < 64; ++e) acc[e] += t[e];
      }
      // h = silu(g) * u, rounded to bf16, into this round's own buffer
      bf16* hb =
          reinterpret_cast<bf16*>(hown_ptr + (r & 1) * kH) + 64 * 64 * w;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = 16 * w4 + (lane >> 2) + 8 * half;
          const int e = 4 * j + 2 * half;
          const float g0 = acc[e], g1 = acc[e + 1];
          const float h0 = g0 / (1.f + expf(-g0)) * acc[32 + e];
          const float h1 = g1 / (1.f + expf(-g1)) * acc[32 + e + 1];
          *reinterpret_cast<__nv_bfloat162*>(
              hb + row * kBF + ((j ^ (row & 7)) << 3) + 2 * (lane & 3)) =
              __floats2bfloat162_rn(h0, h1);
        }
    }
    // every rank's h of this round is written
    round_sync(r);
#pragma unroll
    for (int e = 0; e < 64; ++e) yacc[e] = r == 0 ? 0.f : ymine[e * 128];
    // y[rows, col0 ..] += h_b @ Wd[block b, col0 ..] for the round's
    // blocks b = (rank + j) % nblk, j = 0, 1, ...: block b's rank pushed
    // its h into the free half of this rank's stage (the stage's full
    // barrier counts those bytes too)
    const int nblk = min(C, jb1 - blk0);
    for (int j = 0; j < nblk; ++j, ++n) {
      const int slot = n % kStages;
      await(slot, n);
      const unsigned st = ring + slot * kStage;
      float t[64];
#pragma unroll
      for (int e = 0; e < 64; ++e) t[e] = 0.f;
      take_turn();
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < kBF / 16; ++ks)
        wgmma_n128(t, desc(st + 16384 + w * 8192 + ks * 32, 0, 1024),
                   desc(st + ks * 2048, 8192, 1024), ks);
      wg_commit();
      pass_turn();
      wg_wait0();
      reg_fence(t);
      release(slot);
#pragma unroll
      for (int e = 0; e < 64; ++e) yacc[e] += t[e];
    }
    if (r + 1 < R)
#pragma unroll
      for (int e = 0; e < 64; ++e) ymine[e * 128] = yacc[e];
  }
  // no CTA leaves while another reads its h
  round_sync(R);
  if (w == 0) take_turn();     // warpgroup 1's last turn

  // y block: cast and store (S == 1) or this split's fp32 partial
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int gm = m0 + 64 * w + 16 * w4 + (lane >> 2) + 8 * half;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int gc = col0 + 8 * j + 2 * (lane & 3);
      if (gc >= d) continue;
      const float v0 = yacc[4 * j + 2 * half];
      const float v1 = yacc[4 * j + 2 * half + 1];
      if (S == 1)
        *reinterpret_cast<__nv_bfloat162*>(
            out + static_cast<size_t>(gm) * d + gc) =
            __floats2bfloat162_rn(v0, v1);
      else
        *reinterpret_cast<float2*>(
            part + (static_cast<size_t>(s) * M + gm) * d + gc) =
            make_float2(v0, v1);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, through the runtime's entry-point query (no
// -lcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a row-major bf16 (rows, cols) tensor in boxes of (box_rows, 64 columns:
// one 128-byte swizzle row)
bool tensor_map(CUtensorMap* map, const void* ptr, int rows, int cols,
                int box_rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int grid_x(int d, int C) {
  const int blocks = (d + kDS - 1) / kDS;
  return (blocks + C - 1) / C * C;
}

struct Config {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  Config(int gx, int M, int C, int S, cudaStream_t stream) {
    cfg.gridDim = dim3(gx, (M + kBM - 1) / kBM, S);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = kSmemBytes;
    cfg.stream = stream;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = C;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
};

cudaError_t prepare() {
  static bool attr_set = false;
  if (attr_set) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      linked_mlp_tc_prefill, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(linked_mlp_tc_prefill,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  if (err == cudaSuccess) attr_set = true;
  return err;
}

cudaError_t launch(const bf16* x, const bf16* wg, const bf16* wu,
                   const bf16* wd, float* part, bf16* out, int M, int d,
                   int ff, int C, int S, cudaStream_t stream) {
  cudaError_t err = prepare();
  if (err != cudaSuccess) return err;
  CUtensorMap mx, mg, mu, md;
  if (!tensor_map(&mx, x, M, d, kXBox) || !tensor_map(&mg, wg, d, ff, 64) ||
      !tensor_map(&mu, wu, d, ff, 64) || !tensor_map(&md, wd, ff, d, 64))
    return cudaErrorInvalidValue;
  Config c(grid_x(d, C), M, C, S, stream);
  err = cudaLaunchKernelEx(&c.cfg, linked_mlp_tc_prefill, mx, mg, mu, md,
                           part, out, M, d, ff, C, S);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return err;
  return reduce<bf16>(part, out, static_cast<size_t>(M) * d, S, stream);
}

}  // namespace tp

// ---------------------------------------------------------------------------
// linked_mlp_tc_swap: bf16 on the tensor cores at decode rows, the operands
// swapped
// ---------------------------------------------------------------------------

namespace ts {

using bf16 = __nv_bfloat16;
using tc::desc;
using tc::fence_async_smem;
using tc::reg_fence;
using tc::smem_u32;
using tc::wg_commit;
using tc::wg_fence;
using tc::wg_wait0;
using tp::cluster_sync;
using tp::mbar_arrive_rank;
using tp::mbar_expect_tx;
using tp::mbar_init;
using tp::mbar_wait;
using tp::tma_load;
using tp::wg_barrier;

// d (64 x N fp32, the warpgroup's fragments) = A @ B (scale_d = 0) or +=
// A @ B, bf16 in, the operands swapped: A (64 rows of ff or of y's
// columns) MN-major, B (x or h, N rows) K-major; one overload an N
__device__ __forceinline__ void wgmma_t(float (&d)[4], uint64_t da,
                                        uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_t(float (&d)[8], uint64_t da,
                                        uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_t(float (&d)[16], uint64_t da,
                                        uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_t(float (&d)[32], uint64_t da,
                                        uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Warpgroup 0 loads (one thread), warpgroups 1 and 2 compute.
constexpr int kThreads = 384;
constexpr int kBF = 64;             // ff rows of an up product: an h block
constexpr int kBK = 64;             // d an up step
constexpr int kTile = 64;           // y columns of a down product
constexpr int kMaxCluster = 16;     // non-portable past 8
constexpr int kMaxRows = 64;        // rows the body takes (wgmma's N)
constexpr int kW = 8192;            // bytes of a 64 x 64 bf16 weight tile

// The sizes that follow from N, the rows padded to 8, 16, 32 or 64.
template <int N>
struct Shape {
  // x's tile (N rows x 64 of d) in a stage, whole 1024-byte swizzle
  // periods
  static constexpr int kX = N * 128 < 1024 ? 1024 : N * 128;
  // an up step: Wg's and Wu's 64 x 64 tiles and x's; a down step: two
  // 64 x 64 tiles of Wd
  static constexpr int kStage = 2 * kW + kX;
  static constexpr int kH = N * 128;          // bytes of an h block
  static constexpr int kEx = N * 256;         // u on its way: 64 x N fp32
  // alignment slack, own h and the pulled h (two buffers each), u
  static constexpr int kFixed = 1024 + 4 * kH + kEx;
  static constexpr int kFit = (232448 - kFixed - 18 * 8) / kStage;
  static constexpr int kStages = kFit < 6 ? kFit : 6;
  // y tiles a rank owns at most: a warpgroup holds half of them, N / 2
  // fp32 registers a tile, 64 registers in all
  static constexpr int kMaxTiles = 256 / N < 16 ? 256 / N : 16;
  static constexpr int kTW = (kMaxTiles + 1) / 2;
  static constexpr size_t kSmem =
      kFixed + static_cast<size_t>(kStages) * kStage + (2 * kStages + 2) * 8;
  static_assert(kStages >= 4 && kSmem <= 232448, "fits one CTA");
};

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Tensor maps (128-byte swizzle, zero fill past the edges): x (d, M) in
// boxes of 64 x N, wg / wu (ff, d) and wd (d, ff) in boxes of 64 x 64;
// part (S, M, d) fp32 (S > 1) or out (M, d) bf16 (S == 1).  gridDim = (C,
// 1, S), cluster (C, 1, 1); rank c owns y's columns [64 T c, 64 T (c + 1)).
template <int N>
__global__ void __launch_bounds__(kThreads, 1)
linked_mlp_tc_swap(const __grid_constant__ CUtensorMap tm_x,
                   const __grid_constant__ CUtensorMap tm_g,
                   const __grid_constant__ CUtensorMap tm_u,
                   const __grid_constant__ CUtensorMap tm_d,
                   float* __restrict__ part, bf16* __restrict__ out, int M,
                   int d, int ff, int C, int T, int S) {
  using Sh = Shape<N>;
  constexpr int kStages = Sh::kStages, kStage = Sh::kStage;
  extern __shared__ __align__(1024) unsigned char ts_smem_raw[];
  unsigned char* base_ptr = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<size_t>(ts_smem_raw) + 1023) & ~size_t(1023));
  const unsigned ring = smem_u32(base_ptr);
  unsigned char* hown_ptr = base_ptr + kStages * kStage;    // [2][N][64]
  unsigned char* hall_ptr = hown_ptr + 2 * Sh::kH;          // [2][N][64]
  float* ex = reinterpret_cast<float*>(hall_ptr + 2 * Sh::kH);
  const unsigned bars = smem_u32(ex) + Sh::kEx;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  // hready[b]: every consumer warpgroup of every rank has written its h of
  // a round r with r % 2 == b (and pulled the round before's)
  auto hready = [&](int b) { return bars + 8 * (2 * kStages + b); };
  cg::cluster_group cluster = cg::this_cluster();

  const int rank = static_cast<int>(blockIdx.x) % C;
  const int s = blockIdx.z;
  const int col0 = rank * T * kTile;
  // y tiles this rank owns (the last ranks of a ragged d fewer, or none),
  // and its down steps a block: two tiles a step, one a warpgroup
  const int Tr = max(0, min(T, (d - col0 + kTile - 1) / kTile));
  const int P = (Tr + 1) / 2;
  const int nb = (ff + kBF - 1) / kBF;
  const int jb0 = static_cast<int>(static_cast<long long>(s) * nb / S);
  const int jb1 = static_cast<int>(static_cast<long long>(s + 1) * nb / S);
  const int R = (jb1 - jb0 + C - 1) / C;       // rounds
  const int n_up = (d + kBK - 1) / kBK;        // up steps a round

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full(i), 1);
      mbar_init(empty(i), 2);  // one arrival a consumer warpgroup
    }
    mbar_init(hready(0), 2 * C);
    mbar_init(hready(1), 2 * C);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();              // every rank's barriers exist before any
                               // arrival reaches them

  if (threadIdx.x < 128) {
    // ---- producer: one thread keeps the ring full, in the consumers'
    // order: a round's up steps (its own block, if it has one), then
    // its down steps, block by block ----
    if (threadIdx.x != 0) return;
    int n = 0;                 // steps issued
    for (int r = 0; r < R; ++r) {
      const int blk0 = jb0 + r * C;
      if (blk0 + rank < jb1) {
        const int f0 = (blk0 + rank) * kBF;
        for (int i = 0; i < n_up; ++i, ++n) {
          const int slot = n % kStages;
          mbar_wait(empty(slot), ((n / kStages) & 1) ^ 1);
          const unsigned st = ring + slot * kStage;
          mbar_expect_tx(full(slot), 2 * kW + N * 128);
          tma_load(st, &tm_g, full(slot), f0, i * kBK);
          tma_load(st + kW, &tm_u, full(slot), f0, i * kBK);
          tma_load(st + 2 * kW, &tm_x, full(slot), i * kBK, 0);
        }
      }
      // down step (j, p) of rank i: block (i + j) % nblk of the round,
      // Wd's tiles 2p and 2p + 1 of the rank's columns
      const int nblk = min(C, jb1 - blk0);
      for (int j = 0; j < nblk; ++j) {
        const int f = (blk0 + (rank + j) % nblk) * kBF;
        for (int p = 0; p < P; ++p, ++n) {
          const int slot = n % kStages;
          mbar_wait(empty(slot), ((n / kStages) & 1) ^ 1);
          const unsigned st = ring + slot * kStage;
          const bool two = 2 * p + 1 < Tr;
          mbar_expect_tx(full(slot), two ? 2 * kW : kW);
          tma_load(st, &tm_d, full(slot), col0 + 2 * p * kTile, f);
          if (two)
            tma_load(st + kW, &tm_d, full(slot), col0 + (2 * p + 1) * kTile,
                     f);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup w computes g (w 0) or u (w 1) of the own
  // block, and y's tiles 2p + w of the rank's columns ----
  const int w = threadIdx.x / 128 - 1;
  const int tg = threadIdx.x & 127, lane = tg & 31, w4 = tg >> 5;
  const int ct = threadIdx.x - 128;            // 0 .. 255
  auto release = [&](int slot) {
    if (tg == 0) mbar_arrive(empty(slot));
  };
  auto await = [&](int slot, int n) {
    mbar_wait(full(slot), (n / kStages) & 1);
    __syncwarp();
  };
  // both consumer warpgroups (named barrier 1)
  auto both = [&]() { asm volatile("bar.sync 1, 256;\n" ::: "memory"); };
  // The round barrier over the consumers of every rank (the producer runs
  // ahead): the warpgroup's writes are ordered by its block barrier
  // before thread q's release-arrival on rank q's hready[b]; the wait
  // acquires every rank's.
  auto round_sync = [&](int r) {
    wg_barrier(2 + w);
    if (tg < C) mbar_arrive_rank<true>(hready(r & 1), tg);
    mbar_wait<true>(hready(r & 1), (r >> 1) & 1);
    __syncwarp();
  };
  // an h block through distributed shared memory: 16-byte chunks, this
  // thread's loaded now and stored later
  constexpr int kChunks = N * 8;
  constexpr int kPer = (kChunks + 255) / 256;
  auto pull = [&](const unsigned char* src_local, int b, uint4 (&v)[kPer]) {
    const uint4* src =
        reinterpret_cast<const uint4*>(cluster.map_shared_rank(src_local, b));
#pragma unroll
    for (int u = 0; u < kPer; ++u)
      if (ct + 256 * u < kChunks) v[u] = src[ct + 256 * u];
  };
  auto put = [&](int buf, const uint4 (&v)[kPer]) {
    uint4* dst = reinterpret_cast<uint4*>(hall_ptr + buf * Sh::kH);
#pragma unroll
    for (int u = 0; u < kPer; ++u)
      if (ct + 256 * u < kChunks) dst[ct + 256 * u] = v[u];
  };

  // y^T: the warpgroup's tiles 2p + w, 64 of y's columns x N rows each,
  // summed by the tensor core over the whole ff walk
  float y[Sh::kTW][N / 2];
#pragma unroll
  for (int p = 0; p < Sh::kTW; ++p)
#pragma unroll
    for (int e = 0; e < N / 2; ++e) y[p][e] = 0.f;
  int n = 0;                   // steps consumed
  for (int r = 0; r < R; ++r) {
    const int blk0 = jb0 + r * C;
    unsigned char* hb = hown_ptr + (r & 1) * Sh::kH;
    if (blk0 + rank < jb1) {
      // g^T (w 0) or u^T (w 1) of the own block, 64 ff x N rows: the tensor
      // core sums each 64-deep step from zero; IEEE fp32 adds fold the
      // steps in k order (the decode body's arithmetic)
      float acc[N / 2];
#pragma unroll
      for (int e = 0; e < N / 2; ++e) acc[e] = 0.f;
      for (int i = 0; i < n_up; ++i, ++n) {
        const int slot = n % kStages;
        await(slot, n);
        const unsigned st = ring + slot * kStage;
        float t[N / 2];
#pragma unroll
        for (int e = 0; e < N / 2; ++e) t[e] = 0.f;
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < kBK / 16; ++ks)
          wgmma_t(t, desc(st + w * kW + ks * 2048, 8192, 1024),
                  desc(st + 2 * kW + ks * 32, 0, 1024), ks);
        wg_commit();
        wg_wait0();
        reg_fence(t);
        release(slot);
#pragma unroll
        for (int e = 0; e < N / 2; ++e) acc[e] += t[e];
      }
      // u to warpgroup 0 through shared memory, then h = silu(g) * u,
      // rounded to bf16, into this round's own buffer (N rows of 64, the
      // 128-byte swizzle's K-major layout: the down products' B)
      if (w == 1)
#pragma unroll
        for (int e = 0; e < N / 2; ++e) ex[e * 128 + tg] = acc[e];
      both();
      if (w == 0) {
        bf16* h = reinterpret_cast<bf16*>(hb);
#pragma unroll
        for (int e = 0; e < N / 2; ++e) {
          const int f = 16 * w4 + (lane >> 2) + 8 * ((e >> 1) & 1);
          const int m = 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
          const float g = acc[e];
          h[m * 64 + (((f >> 3) ^ (m & 7)) << 3) + (f & 7)] =
              __float2bfloat16(g / (1.f + expf(-g)) * ex[e * 128 + tg]);
        }
      }
    }
    // every rank's h of this round is written
    round_sync(r);
    // y^T[rank's tiles] += Wd[block b, tile]^T h_b^T for the round's blocks b
    // = (rank + j) % nblk: h_b comes from rank b through distributed
    // shared memory into hall[j & 1], block j + 1 loaded while block j
    // multiplies
    const int nblk = min(C, jb1 - blk0);
    if (P > 0) {
      {
        uint4 v[kPer];
        pull(hb, rank % nblk, v);
        put(0, v);
      }
      fence_async_smem();
      both();
      for (int j = 0; j < nblk; ++j) {
        const bool more = j + 1 < nblk;
        uint4 v[kPer];
        if (more) pull(hb, (rank + j + 1) % nblk, v);
        const unsigned hl = smem_u32(hall_ptr + (j & 1) * Sh::kH);
#pragma unroll
        for (int p = 0; p < Sh::kTW; ++p) {
          if (p < P) {
            const int slot = n % kStages;
            await(slot, n);
            if (2 * p + w < Tr) {
              const unsigned st = ring + slot * kStage + w * kW;
              wg_fence();
#pragma unroll
              for (int ks = 0; ks < kBF / 16; ++ks)
                wgmma_t(y[p], desc(st + ks * 2048, 8192, 1024),
                        desc(hl + ks * 32, 0, 1024), 1);
              wg_commit();
              wg_wait0();
              reg_fence(y[p]);
            }
            release(slot);
            ++n;
          }
        }
        if (more) {
          put((j + 1) & 1, v);
          fence_async_smem();
        }
        both();
      }
    }
  }
  // no CTA leaves while another reads its h
  round_sync(R);

  // y^T tiles: cast and store (S == 1) or this split's fp32 partial
#pragma unroll
  for (int p = 0; p < Sh::kTW; ++p) {
    const int tile = 2 * p + w;
    if (tile >= Tr) continue;
#pragma unroll
    for (int e = 0; e < N / 2; ++e) {
      const int c = col0 + tile * kTile + 16 * w4 + (lane >> 2) +
                    8 * ((e >> 1) & 1);
      const int m = 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
      if (m >= M || c >= d) continue;
      if (S == 1)
        out[static_cast<size_t>(m) * d + c] = __float2bfloat16(y[p][e]);
      else
        part[(static_cast<size_t>(s) * M + m) * d + c] = y[p][e];
    }
  }
}

// N: M padded to wgmma's 8, 16, 32 or 64 rows (0: more than 64)
int rows_n(int M) {
  return M <= 8 ? 8 : M <= 16 ? 16 : M <= 32 ? 32 : M <= kMaxRows ? 64 : 0;
}
int max_tiles(int N) {
  switch (N) {
    case 8: return Shape<8>::kMaxTiles;
    case 16: return Shape<16>::kMaxTiles;
    case 32: return Shape<32>::kMaxTiles;
    case 64: return Shape<64>::kMaxTiles;
    default: return 0;
  }
}

template <int N>
cudaError_t prepare() {
  static bool attr_set = false;
  if (attr_set) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      linked_mlp_tc_swap<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Shape<N>::kSmem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(linked_mlp_tc_swap<N>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  if (err == cudaSuccess) attr_set = true;
  return err;
}

template <int N>
cudaError_t launch_n(const bf16* x, const bf16* wg, const bf16* wu,
                     const bf16* wd, float* part, bf16* out, int M, int d,
                     int ff, int C, int T, int S, cudaStream_t stream) {
  cudaError_t err = prepare<N>();
  if (err != cudaSuccess) return err;
  CUtensorMap mx, mg, mu, md;
  if (!tp::tensor_map(&mx, x, M, d, N) || !tp::tensor_map(&mg, wg, d, ff, 64) ||
      !tp::tensor_map(&mu, wu, d, ff, 64) ||
      !tp::tensor_map(&md, wd, ff, d, 64))
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cfg.gridDim = dim3(C, 1, S);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Shape<N>::kSmem;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, linked_mlp_tc_swap<N>, mx, mg, mu, md, part,
                           out, M, d, ff, C, T, S);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return err;
  return reduce<bf16>(part, out, static_cast<size_t>(M) * d, S, stream);
}

cudaError_t launch(const bf16* x, const bf16* wg, const bf16* wu,
                   const bf16* wd, float* part, bf16* out, int M, int d,
                   int ff, int C, int T, int S, cudaStream_t stream) {
  switch (rows_n(M)) {
    case 8:
      return launch_n<8>(x, wg, wu, wd, part, out, M, d, ff, C, T, S, stream);
    case 16:
      return launch_n<16>(x, wg, wu, wd, part, out, M, d, ff, C, T, S,
                          stream);
    case 32:
      return launch_n<32>(x, wg, wu, wd, part, out, M, d, ff, C, T, S,
                          stream);
    case 64:
      return launch_n<64>(x, wg, wu, wd, part, out, M, d, ff, C, T, S,
                          stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace ts

}  // namespace

// The FFMA kernel: x (M,d), wg/wu (d,ff), wd (ff,d), out (M,d): contiguous,
// one type on one device (dtype 0 = float32, 1 = bfloat16); part: an (S,
// M, d) fp32 workspace.  bm (8, 4, 2 or 1) rows an M tile, v elements a
// lane loads, S ff splits (1 <= S <= ceil(ff / 64)): ops.py's planner.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int repro_linked_mlp(int dtype, const void* x, const void* wg,
                                const void* wu, const void* wd, void* part,
                                void* out, int M, int d, int ff, int bm,
                                int v, int S, void* stream) {
  if (M <= 0 || d <= 0 || ff <= 0 || S < 1 || S > (ff + kBF - 1) / kBF ||
      (dtype != 0 && dtype != 1) ||
      smem_bytes(bm, d) > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0
          ? launch_t<float>(bm, v, x, wg, wu, wd, part, out, M, d, ff, S, st)
          : launch_t<__nv_bfloat16>(bm, v, x, wg, wu, wd, part, out, M, d, ff,
                                    S, st);
  return static_cast<int>(err);
}

// The tensor-core kernel: bf16 x (M,d), wg/wu (d,ff), wd (ff,d), out
// (M,d), contiguous and 16-byte aligned on one device, d and ff multiples
// of 8; cl CTAs a cluster (1 <= cl <= 16, at most d's ceil(d / 256)
// column blocks), ceil(d / (256 cl)) clusters splitting d; S ff splits
// (1 <= S <= ceil(ff / 64)); part: an (S, M, d) fp32 workspace when S > 1
// (unused, may be null, when S == 1).  Returns the cudaError_t of the
// launches.
extern "C" int repro_linked_mlp_tc(const void* x, const void* wg,
                                   const void* wu, const void* wd, void* part,
                                   void* out, int M, int d, int ff, int cl,
                                   int S, void* stream) {
  const size_t addr = reinterpret_cast<size_t>(x) |
                      reinterpret_cast<size_t>(wg) |
                      reinterpret_cast<size_t>(wu) |
                      reinterpret_cast<size_t>(wd);
  if (M <= 0 || d <= 0 || ff <= 0 || d % 8 || ff % 8 || (addr & 15) ||
      cl < 1 || cl > (d + tc::kDS - 1) / tc::kDS || cl > tc::kMaxCluster ||
      S < 1 ||
      S > (ff + tc::kBF - 1) / tc::kBF || (S > 1 && part == nullptr) ||
      (M + tc::kBM - 1) / tc::kBM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  using tc::bf16;
  return static_cast<int>(tc::launch(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wg),
      static_cast<const bf16*>(wu), static_cast<const bf16*>(wd),
      static_cast<float*>(part), static_cast<bf16*>(out), M, d, ff, cl, S,
      static_cast<cudaStream_t>(stream)));
}

// Clusters of cl CTAs of the tensor-core kernel that the current device
// runs at once (cudaOccupancyMaxActiveClusters); -1 on error.
extern "C" int repro_linked_mlp_tc_clusters(int cl) {
  if (cl < 1 || cl > tc::kMaxCluster) return -1;
  return tc::max_clusters(cl);
}

// The tensor-core kernel's prefill body: the same operands and checks as
// repro_linked_mlp_tc, 128-row tiles, cl CTAs of 128 columns a cluster (1
// <= cl <= 16, at most ceil(d / 128)), ceil(d / (128 cl)) clusters
// splitting d.  Returns the cudaError_t of the launches (an invalid value
// where cuTensorMapEncodeTiled is missing or refuses a tensor).
extern "C" int repro_linked_mlp_tc_prefill(const void* x, const void* wg,
                                           const void* wu, const void* wd,
                                           void* part, void* out, int M,
                                           int d, int ff, int cl, int S,
                                           void* stream) {
  const size_t addr = reinterpret_cast<size_t>(x) |
                      reinterpret_cast<size_t>(wg) |
                      reinterpret_cast<size_t>(wu) |
                      reinterpret_cast<size_t>(wd);
  if (M <= 0 || d <= 0 || ff <= 0 || d % 8 || ff % 8 || (addr & 15) ||
      cl < 1 || cl > (d + tp::kDS - 1) / tp::kDS || cl > tp::kMaxCluster ||
      S < 1 || S > (ff + tp::kBF - 1) / tp::kBF ||
      (S > 1 && part == nullptr) || (M + tp::kBM - 1) / tp::kBM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  using tp::bf16;
  return static_cast<int>(tp::launch(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wg),
      static_cast<const bf16*>(wu), static_cast<const bf16*>(wd),
      static_cast<float*>(part), static_cast<bf16*>(out), M, d, ff, cl, S,
      static_cast<cudaStream_t>(stream)));
}

// The tensor-core kernel's swapped decode body: the same operands and
// checks as repro_linked_mlp_tc, 1 <= M <= 64 rows, one cluster of cl CTAs
// (1 <= cl <= 16) over all of d, rank c owning y's columns [64 T c, 64 T
// (c + 1)) for T = ceil(ceil(d / 64) / cl), at most 16 tiles and 256 / N
// (N: M padded to 8, 16, 32 or 64); S ff splits (1 <= S <= ceil(ff /
// 64)).  Returns the cudaError_t of the launches (an invalid value where
// cuTensorMapEncodeTiled is missing or refuses a tensor).
extern "C" int repro_linked_mlp_tc_swap(const void* x, const void* wg,
                                        const void* wu, const void* wd,
                                        void* part, void* out, int M, int d,
                                        int ff, int cl, int S, void* stream) {
  const size_t addr = reinterpret_cast<size_t>(x) |
                      reinterpret_cast<size_t>(wg) |
                      reinterpret_cast<size_t>(wu) |
                      reinterpret_cast<size_t>(wd);
  if (M <= 0 || M > ts::kMaxRows || d <= 0 || ff <= 0 || d % 8 || ff % 8 ||
      (addr & 15) || cl < 1 || cl > ts::kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  const int T = ((d + ts::kTile - 1) / ts::kTile + cl - 1) / cl;
  if (T > ts::max_tiles(ts::rows_n(M)) || S < 1 ||
      S > (ff + ts::kBF - 1) / ts::kBF || (S > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  using ts::bf16;
  return static_cast<int>(ts::launch(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wg),
      static_cast<const bf16*>(wu), static_cast<const bf16*>(wd),
      static_cast<float*>(part), static_cast<bf16*>(out), M, d, ff, cl, T, S,
      static_cast<cudaStream_t>(stream)));
}
