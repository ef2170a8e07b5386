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
// sum; the port does not.)  IEEE fp32 FFMA throughout (bf16 products are
// exact in fp32), no TF32.
//
// What bounds it on the H100: at the serving shapes it is the weights.
// Decode, M = 8, d 2048, ff 6144, bf16: 3 * 2048 * 6144 * 2 B = 75.5 MB
// of weights against 0.60 GFLOP: ~22.5 us at 3.35 TB/s (bytes).  Prefill,
// M = 8 * 32 = 256: the same bytes against 19.3 GFLOP, ~19.5 us at the
// bf16 tensor-core peak, so still the bytes; on the fp32 FFMA pipes this
// kernel uses (67 TFLOP/s) the same work takes ~0.29 ms.
//
// What the design does about it: the operator linking itself.  The
// hidden activation h (M x ff) never reaches device memory: each thread
// block computes one (BM rows) x (64 ff columns) block of h on chip and
// consumes it there, and reads every weight byte once per M tile.
//   * Grid: (M tiles of BM <= 8 rows) x (S splits of ff).  S fills the
//     132 SMs (at decode M = 8 is one M tile, so the CTAs come from the ff
//     split).  CTAs that share an ff split are adjacent in the grid, so
//     they read the same weights through L2 together.
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
//   * Each CTA writes its partial y into an (S, M, d) fp32 workspace that
//     the wrapper allocates; a second kernel sums the S partials in split
//     order and casts.  No atomics: a token stream does not change from
//     run to run.
// Ragged M, d and ff are masked (rows past M, columns past d or ff are
// zero).  The launch allocates nothing and never synchronizes, so it can
// be captured into a CUDA graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBF = 64;                 // ff columns per block
constexpr int kSMs = 132;               // H100 SXM streaming multiprocessors
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

// How a call runs: bm rows per M tile (the largest of 8, 4, 2, 1 whose
// shared memory fits at this d; rows past M are masked), v elements a
// lane (16-byte loads where every weight row is 16-byte aligned, else 2),
// and S ff splits that fill the SMs, at most one per ff block.  S == 0:
// not even one row fits.
struct Plan {
  int bm, v, S;
};

Plan make_plan(int dtype, int M, int d, int ff, const void* wg,
               const void* wu, const void* wd) {
  Plan p{0, 2, 0};
  for (int bm = 8; bm >= 1 && p.bm == 0; bm /= 2)
    if (smem_bytes(bm, d) <= static_cast<size_t>(kMaxSmem)) p.bm = bm;
  if (p.bm == 0) return p;
  const int vec = dtype == 0 ? 4 : 8;       // 16 bytes of the type
  const size_t addr = reinterpret_cast<size_t>(wg) |
                      reinterpret_cast<size_t>(wu) |
                      reinterpret_cast<size_t>(wd);
  if (d % vec == 0 && ff % vec == 0 && (addr & 15) == 0) p.v = vec;
  const int m_tiles = (M + p.bm - 1) / p.bm;
  const int n_blocks = (ff + kBF - 1) / kBF;
  p.S = max(1, min(n_blocks, kSMs / m_tiles));
  return p;
}

template <typename T, int BM, int V>
cudaError_t launch(const Plan& p, const T* x, const T* wg, const T* wu,
                   const T* wd, float* part, int M, int d, int ff,
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
      <<<dim3((M + BM - 1) / BM, p.S), kThreads, smem_bytes(BM, d),
         stream>>>(x, wg, wu, wd, part, M, d, ff, (ff + kBF - 1) / kBF,
                   p.S);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch_bm(const Plan& p, const T* x, const T* wg, const T* wu,
                      const T* wd, float* part, int M, int d, int ff,
                      cudaStream_t st) {
  switch (p.bm) {
    case 8: return launch<T, 8, V>(p, x, wg, wu, wd, part, M, d, ff, st);
    case 4: return launch<T, 4, V>(p, x, wg, wu, wd, part, M, d, ff, st);
    case 2: return launch<T, 2, V>(p, x, wg, wu, wd, part, M, d, ff, st);
    case 1: return launch<T, 1, V>(p, x, wg, wu, wd, part, M, d, ff, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_t(const Plan& p, const void* x, const void* wg,
                     const void* wu, const void* wd, void* part, void* out,
                     int M, int d, int ff, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(wg);
  const T* up = static_cast<const T*>(wu);
  const T* dp = static_cast<const T*>(wd);
  float* pp = static_cast<float*>(part);
  constexpr int kVec = 16 / sizeof(T);
  const cudaError_t err =
      p.v == kVec
          ? launch_bm<T, kVec>(p, xp, gp, up, dp, pp, M, d, ff, stream)
          : launch_bm<T, 2>(p, xp, gp, up, dp, pp, M, d, ff, stream);
  if (err != cudaSuccess) return err;
  const size_t n = static_cast<size_t>(M) * d;
  linked_mlp_reduce<T><<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                         kThreads, 0, stream>>>(pp, static_cast<T*>(out), n,
                                                p.S);
  return cudaGetLastError();
}

}  // namespace

// The ff splits S of an (M, d, ff) call with these weights: the wrapper
// sizes the (S, M, d) fp32 workspace with it.  0: d is too wide for even
// one row's shared memory.  dtype: 0 = float32, 1 = bfloat16.
extern "C" int repro_linked_mlp_splits(int dtype, int M, int d, int ff,
                                       const void* wg, const void* wu,
                                       const void* wd) {
  return make_plan(dtype, M, d, ff, wg, wu, wd).S;
}

// x (M,d), wg/wu (d,ff), wd (ff,d), out (M,d): contiguous, one type on one
// device; part: an (S, M, d) fp32 workspace, S from
// repro_linked_mlp_splits.  Returns the cudaError_t of the launches (0 on
// success).
extern "C" int repro_linked_mlp(int dtype, const void* x, const void* wg,
                                const void* wu, const void* wd, void* part,
                                void* out, int M, int d, int ff, int S,
                                void* stream) {
  const Plan p = make_plan(dtype, M, d, ff, wg, wu, wd);
  if (M <= 0 || d <= 0 || ff <= 0 || p.S <= 0 || p.S != S ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0
          ? launch_t<float>(p, x, wg, wu, wd, part, out, M, d, ff, st)
          : launch_t<__nv_bfloat16>(p, x, wg, wu, wd, part, out, M, d, ff,
                                    st);
  return static_cast<int>(err);
}
