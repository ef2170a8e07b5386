// Linked CBR-AvgPool (the paper's cbra op, Figure 4) for Hopper (sm_90a):
//   out = avgpool2x2(relu(x @ w + b))
//   x (N, H, W, C) NHWC fp32, w (C, OC) fp32, b (OC,) fp32
//   -> (N, H/2, W/2, OC) fp32, odd H or W floored (the last row or column
//   is dropped, as the reference's VALID reduce_window does).
//
// Replaces the Pallas TPU kernel
//   cbr_avgpool  src/repro/kernels/linked_cbr_pool/linked_cbr_pool.py:33
//                (body _kernel :20)
//
// What bounds it on the H100: it depends on the shape.  Counting each
// input read once and the pooled output written once, at 3.35 TB/s and
// 67 TFLOP/s of fp32 FFMA:
//   * (1,8,8,1024) @ (1024,1024): ~4.3 MB (the weights) ~1.3 us, and
//     134 MFLOP ~2.0 us -> bound by operations;
//   * (1,224,224,24) @ (24,224): ~4.8 MB in + 11.2 MB out ~4.8 us, and
//     0.54 GFLOP ~8.0 us -> bound by operations.
// The unlinked form (conv, then pool) also writes and reads the pre-pool
// map (45 MB at the second shape); linking removes that traffic.
//
// What the design does about it: one thread block owns one output row
// pair (input rows 2*ho and 2*ho+1) of one image, a tile of 2*SQ input
// columns (SQ pooled columns) and a tile of 32 output channels.  It loops
// over C in shared-memory tiles of 32 channels and accumulates the
// 2 x 2*SQ x 32 pre-pool block in fp32 registers: each thread holds one
// 2x2 pooling square for 4 output channels (16 accumulators, one float4 of
// w per channel).  The epilogue adds the bias, applies the ReLU and
// averages each square in registers, so the pre-pool map never reaches
// device memory (Figure 4's zigzag write order, on chip).  IEEE fp32 FFMA,
// no TF32: the engine holds the routed path to the plain one at 2e-5.
//
// Launch shapes, picked on the host:
//   * SQ = 16: wide maps (the 224x224 shape: 5488 blocks, one C tile each
//     at C = 24);
//   * SQ = 4, KS = 4 warps per block: small maps, where row pairs x OC
//     tiles alone do not fill 132 SMs (the 8x8 shape: 4 row pairs x 32 OC
//     tiles = 128 blocks, 32 C tiles each).  Each warp accumulates a
//     quarter of every C tile (summed through shared memory before the
//     epilogue), and each thread loads its share of the next C tile into
//     registers before it multiplies the current one.  C is also split
//     over a thread block cluster of CL = 2..8 blocks (Hopper): block z of
//     the cluster takes C tiles z, z + CL, ...; the cluster's rank 0 sums
//     the partial pre-pool blocks through distributed shared memory, so
//     they never reach device memory either (the 8x8 shape: CL = 8, 1024
//     blocks of 4 C tiles).
// Both hold at most 64 registers (__launch_bounds__(128, 8)), so 8 blocks
// sit on an SM.  Masks cover every edge: columns past 2*(W/2), channels
// past C (C = 3 or C = 24 leave most of a tile zero), output channels past
// OC, and pooled columns past W/2.  N > 1 is a grid dimension.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCT = 32;             // input channels per shared-memory tile
constexpr int kOCT = 32;            // output channels per block
constexpr int kOCV = 4;             // output channels per thread (one float4)
constexpr int kOCG = kOCT / kOCV;   // thread columns across the OC tile
constexpr int kSMs = 132;           // H100 SXM streaming multiprocessors
constexpr int kMaxCluster = 8;      // portable thread block cluster size

template <int SQ, int KS, int CL>
__global__ void __launch_bounds__(SQ * kOCG * KS, 8)
cbr_avgpool_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ b, float* __restrict__ out,
                   int H, int W, int C, int OC, int Ho, int Wo,
                   int col_tiles) {
  constexpr int kThreads = SQ * kOCG * KS;
  constexpr int kGroup = SQ * kOCG;   // threads per C slice
  constexpr int kPix = 4 * SQ;        // pre-pool pixels: 2 rows x 2*SQ cols
  constexpr int kXS = kCT + 1;        // padded pixel row: no bank conflicts
  constexpr int kCS = kCT / KS;       // channels of a tile per slice
  constexpr int kXL = kPix * kCT / kThreads;   // x tile loads per thread
  constexpr int kWL = kCT * kOCT / kThreads;   // w tile loads per thread
  // narrow tiles walk many C tiles each: they prefetch the next one;
  // wide tiles (often one C tile) spend no registers on it
  constexpr bool kPrefetch = SQ == 4;
  static_assert(kPix * kCT % kThreads == 0 && kCT * kOCT % kThreads == 0,
                "tiles must split evenly over the threads");

  __shared__ float xs[kPix * kXS];
  __shared__ __align__(16) float ws[kCT * kOCT];
  // partial pre-pool blocks: slot s > 0 holds C slice s for the in-block
  // sum, slot 0 this block's total for the cluster's rank 0
  __shared__ float red[KS > 1 || CL > 1 ? KS * kGroup * 16 : 1];

  const int tid = threadIdx.x;
  const int slice = tid / kGroup;
  const int lane = tid % kGroup;
  const int og = lane % kOCG;         // float4 column of the OC tile
  const int sq = lane / kOCG;         // pooling square within the tile

  const int tile = blockIdx.x;        // (n * Ho + ho) * col_tiles + ct
  const int ct = tile % col_tiles;
  const int row = tile / col_tiles;   // n * Ho + ho
  const int ho = row % Ho;
  const int n = row / Ho;
  const int oc0 = blockIdx.y * kOCT;
  const int col0 = 2 * SQ * ct;       // first input column of the tile
  const int cols = min(2 * SQ, 2 * Wo - col0);
  const size_t row_base = (static_cast<size_t>(n) * H + 2 * ho) * W;

  float acc[4][kOCV];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int j = 0; j < kOCV; ++j) acc[p][j] = 0.f;

  // the four pixels of this thread's square: (row 0 | row 1) x (2sq | 2sq+1)
  const float* x0 = xs + (2 * sq) * kXS;
  const float* x1 = x0 + kXS;
  const float* x2 = x0 + 2 * SQ * kXS;
  const float* x3 = x2 + kXS;
  auto mac = [&]() {
#pragma unroll
    for (int cc = 0; cc < kCS; ++cc) {
      const int c = slice * kCS + cc;
      const float4 wv =
          *reinterpret_cast<const float4*>(ws + c * kOCT + og * kOCV);
      const float xv[4] = {x0[c], x1[c], x2[c], x3[c]};
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        acc[p][0] = fmaf(xv[p], wv.x, acc[p][0]);
        acc[p][1] = fmaf(xv[p], wv.y, acc[p][1]);
        acc[p][2] = fmaf(xv[p], wv.z, acc[p][2]);
        acc[p][3] = fmaf(xv[p], wv.w, acc[p][3]);
      }
    }
  };

  const int c_first = (CL > 1 ? static_cast<int>(blockIdx.z) : 0) * kCT;
  // x tile element e: pixel p = e / kCT (input row 2*ho + p / (2*SQ),
  // column col0 + p % (2*SQ)), channel e % kCT; w tile element e: channel
  // e / kOCT, output channel e % kOCT.  Masked elements are zero.
  auto x_at = [&](int c0, int e) {
    const int p = e / kCT, c = e % kCT;
    const int r = p / (2 * SQ), j = p % (2 * SQ);
    return (j < cols && c0 + c < C)
        ? x[(row_base + static_cast<size_t>(r) * W + col0 + j) * C + c0 + c]
        : 0.f;
  };
  auto w_at = [&](int c0, int e) {
    const int c = e / kOCT, o = e % kOCT;
    return (c0 + c < C && oc0 + o < OC)
        ? w[static_cast<size_t>(c0 + c) * OC + oc0 + o] : 0.f;
  };
  if constexpr (kPrefetch) {
    // the next tile's loads are in flight while this one is multiplied
    float xr[kXL], wr[kWL];
    auto fetch = [&](int c0) {
#pragma unroll
      for (int i = 0; i < kXL; ++i) xr[i] = x_at(c0, tid + i * kThreads);
#pragma unroll
      for (int i = 0; i < kWL; ++i) wr[i] = w_at(c0, tid + i * kThreads);
    };
    if (c_first < C) fetch(c_first);
    for (int c0 = c_first; c0 < C; c0 += CL * kCT) {
      __syncthreads();                // the last tile is no longer read
#pragma unroll
      for (int i = 0; i < kXL; ++i) {
        const int e = tid + i * kThreads;
        xs[(e / kCT) * kXS + e % kCT] = xr[i];
      }
#pragma unroll
      for (int i = 0; i < kWL; ++i) ws[tid + i * kThreads] = wr[i];
      __syncthreads();
      if (c0 + CL * kCT < C) fetch(c0 + CL * kCT);
      mac();
    }
  } else {
    // loaded straight into shared memory: staging the tile in registers
    // made the wide variant 3.2x slower under the 64-register cap (at
    // (1,224,224,24)@(24,224), H100 SXM at 700 W)
    for (int c0 = c_first; c0 < C; c0 += CL * kCT) {
      __syncthreads();
      for (int e = tid; e < kPix * kCT; e += kThreads)
        xs[(e / kCT) * kXS + e % kCT] = x_at(c0, e);
      for (int e = tid; e < kCT * kOCT; e += kThreads) ws[e] = w_at(c0, e);
      __syncthreads();
      mac();
    }
  }

  if constexpr (KS > 1) {
    // sum the C slices' partial blocks into slice 0
    if (slice > 0) {
      float* dst = red + (slice * kGroup + lane) * 16;
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int j = 0; j < kOCV; ++j) dst[p * kOCV + j] = acc[p][j];
    }
    __syncthreads();
    if (slice == 0) {
#pragma unroll
      for (int s = 1; s < KS; ++s) {
        const float* src = red + (s * kGroup + lane) * 16;
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int j = 0; j < kOCV; ++j) acc[p][j] += src[p * kOCV + j];
      }
    }
  }

  if constexpr (CL > 1) {
    // sum the cluster's partial blocks in rank 0, through distributed
    // shared memory; every thread of every block reaches both barriers
    cg::cluster_group cluster = cg::this_cluster();
    if (slice == 0) {
      float* dst = red + lane * 16;
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int j = 0; j < kOCV; ++j) dst[p * kOCV + j] = acc[p][j];
    }
    cluster.sync();
    const bool leader = cluster.block_rank() == 0;
    if (leader && slice == 0) {
      for (int r = 1; r < CL; ++r) {
        const float* src = cluster.map_shared_rank(red, r) + lane * 16;
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int j = 0; j < kOCV; ++j) acc[p][j] += src[p * kOCV + j];
      }
    }
    cluster.sync();                   // keep every block's slot 0 alive
    if (!leader) return;
  }
  if (slice != 0) return;

  // epilogue: bias, ReLU, and the 2x2 average, all in registers
  const int wo = ct * SQ + sq;
  if (wo >= Wo) return;
  float* o = out + ((static_cast<size_t>(n) * Ho + ho) * Wo + wo) * OC;
#pragma unroll
  for (int j = 0; j < kOCV; ++j) {
    const int oc = oc0 + og * kOCV + j;
    if (oc >= OC) continue;
    const float bias = b[oc];
    const float s = fmaxf(acc[0][j] + bias, 0.f) + fmaxf(acc[1][j] + bias, 0.f)
                    + fmaxf(acc[2][j] + bias, 0.f)
                    + fmaxf(acc[3][j] + bias, 0.f);
    o[oc] = 0.25f * s;
  }
}

template <int SQ, int KS, int CL>
cudaError_t launch(const float* x, const float* w, const float* b, float* out,
                   int N, int H, int W, int C, int OC, cudaStream_t stream) {
  const int Ho = H / 2, Wo = W / 2;
  const int col_tiles = (Wo + SQ - 1) / SQ;
  const long long rows = static_cast<long long>(N) * Ho * col_tiles;
  const int oc_tiles = (OC + kOCT - 1) / kOCT;
  if (rows > 0x7fffffffLL || oc_tiles > 65535) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows), oc_tiles, CL);
  cfg.blockDim = dim3(SQ * kOCG * KS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = CL;
  cfg.attrs = &cluster;
  cfg.numAttrs = CL > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, cbr_avgpool_kernel<SQ, KS, CL>, x, w, b, out, H, W, C, OC, Ho,
      Wo, col_tiles);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// x (N,H,W,C), w (C,OC), b (OC,), out (N,H/2,W/2,OC): contiguous fp32 on
// one device.  Returns the cudaError_t of the launch
// (0 on success).
extern "C" int repro_cbr_avgpool(const void* x, const void* w, const void* b,
                                 void* out, int N, int H, int W, int C, int OC,
                                 void* stream) {
  if (N <= 0 || H < 2 || W < 2 || C <= 0 || OC <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xp = static_cast<const float*>(x);
  const float* wp = static_cast<const float*>(w);
  const float* bp = static_cast<const float*>(b);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int Ho = H / 2, Wo = W / 2;
  const long long oc_tiles = (OC + kOCT - 1) / kOCT;
  const long long wide_blocks =
      static_cast<long long>(N) * Ho * ((Wo + 15) / 16) * oc_tiles;
  // wide tiles only where they are mostly full and fill the card twice over
  if (Wo >= 12 && wide_blocks >= 2 * kSMs)
    return static_cast<int>(launch<16, 1, 1>(xp, wp, bp, op, N, H, W, C, OC,
                                             s));
  // narrow tiles: split C over a cluster until ~4 blocks sit on each SM,
  // keeping at least one C tile per block
  const long long blocks =
      static_cast<long long>(N) * Ho * ((Wo + 3) / 4) * oc_tiles;
  const int c_tiles = (C + kCT - 1) / kCT;
  int cl = 1;
  while (cl < kMaxCluster && blocks * cl < 4 * kSMs && 2 * cl <= c_tiles)
    cl *= 2;
  cudaError_t err;
  switch (cl) {
    case 8: err = launch<4, 4, 8>(xp, wp, bp, op, N, H, W, C, OC, s); break;
    case 4: err = launch<4, 4, 4>(xp, wp, bp, op, N, H, W, C, OC, s); break;
    case 2: err = launch<4, 4, 2>(xp, wp, bp, op, N, H, W, C, OC, s); break;
    default: err = launch<4, 4, 1>(xp, wp, bp, op, N, H, W, C, OC, s);
  }
  return static_cast<int>(err);
}
