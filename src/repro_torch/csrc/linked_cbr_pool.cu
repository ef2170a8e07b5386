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
// What the design does about it: a register-tiled fp32 GEMM whose rows are
// 2x2 pooling squares, so the pool is an epilogue on registers.
//   * A pooled output q = (n, ho, wo) is a square of four pre-pool pixels.
//     A CTA computes BSQ = TSQ TYN consecutive squares (flattened over n,
//     ho, wo, so any map fills whole tiles) x BN = 8 TXN output channels;
//     each thread TSQ squares x 8 channels (TSQ = 2: 64 fp32 accumulators,
//     both squares' four corners), channels 4 tx .. 4 tx + 3 and
//     BN/2 + 4 tx .. + 3.  Per 4 channels of C it reads its 4 TSQ pixels
//     and 4 rows of w as float4 (16 shared loads for 256 FFMA at TSQ = 2).
//   * x and w stream through a ring of 1-3 stages of 32 channels filled by
//     cp.async (16-byte copies where C and OC are multiples of 4 and x, w
//     are 16-byte aligned, else 4-byte copies); squares past the map,
//     channels past C and output channels past OC are zero-filled.  A step
//     multiplies only the channels it holds, rounded up to 4: C = 24 is one
//     24-deep step, not a 32-channel tile a quarter zeros, and its w tile
//     is copied once.  The x tile is corner-major (row c BSQ + s is corner
//     c of square s) with rows of 36 floats, so a warp's float4 loads hit
//     distinct banks; each CTA tabulates its tiles' pixel indices once.
//   * CTAs with no split below walk square tiles bx, bx + gridDim.x, ...
//     (up to kWalkMax; the planner spreads the tiles over the CTAs the SMs
//     hold at once), so the ring's next tile is in flight while this one
//     is multiplied and pooled.
//   * KH = 2 or 4 splits each step's channels between parts of the CTA's
//     threads (more warps where a CTA is alone on its SM); the parts'
//     partials are summed in shared memory, part 0 first, then 1, 2, 3.
//     Three CTA shapes (TXN, TYN, KH, TSQ) are built: mid (8, 16, 1, 2)
//     for big maps, small (4, 8, 2, 2) and tiny (4, 8, 4, 1) for small
//     ones.
//   * Small maps split C over a thread block cluster (gridDim.z = CL, up to
//     16): rank r takes steps [r S / CL, (r + 1) S / CL) of the S = C / 32
//     steps; every rank then reduces its share of the tile's outputs over
//     the ranks' partial pre-pool blocks, in rank order, through
//     distributed shared memory, so the pre-pool block never reaches device
//     memory (Figure 4's zigzag write order, on chip).
//   * The epilogue adds the bias, applies the ReLU and averages each
//     square: in registers where neither split is on, else from the
//     reduced block.  IEEE fp32 FFMA, no TF32: the engine holds the routed
//     path to the plain one at 2e-5.
//   * The Python planner (kernels/linked_cbr_pool/ops.py, ``cbra_plan``)
//     picks the CTA shape (TXN, TYN, KH, TSQ), CL, the CTAs along the
//     square tiles and the ring depth from the shapes and the SM count, and
//     passes them in.
// No atomics: two launches give the same bits.  The launch allocates
// nothing and never synchronizes, so it can be captured into a CUDA graph.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBK = 32;          // channels of C a step
constexpr int kXS = kBK + 4;     // x tile row stride (floats): spreads banks
constexpr int kTN = 8;           // output channels a thread
constexpr int kWalkMax = 8;      // square tiles a walking CTA may take

template <int TXN, int TYN, int KH, int TSQ>
struct Tile {
  static constexpr int kBN = kTN * TXN;          // output channels a CTA
  static constexpr int kBSQ = TSQ * TYN;         // squares a CTA
  static constexpr int kPix = 4 * kBSQ;          // pre-pool pixels a CTA
  static constexpr int kGroup = TXN * TYN;       // threads of one k part
  static constexpr int kThreads = KH * kGroup;
  // ops.py's cbra_ctas_per_sm: 3 CTAs an SM at 128 threads, 6 at 64
  static constexpr int kMinBlocks = kThreads >= 128 ? 3 : 6;
  static constexpr int kXStage = kPix * kXS;     // floats
  static constexpr int kStage = kXStage + kBK * kBN;
  static constexpr int kRed = 4 * kBSQ * kBN;    // one partial block
  static constexpr size_t smem_bytes(int stages, bool reduce) {
    const int ring = stages * kStage;
    return sizeof(float) *
           static_cast<size_t>(reduce && kRed > ring ? kRed : ring);
  }
};

// 16 bytes (VEC) or 4 bytes global -> shared, bypassing registers;
// src_bytes 0 zero-fills
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

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ float pool4(float a, float b, float c, float d,
                                       float bias) {
  return 0.25f * (fmaxf(a + bias, 0.f) + fmaxf(b + bias, 0.f) +
                  fmaxf(c + bias, 0.f) + fmaxf(d + bias, 0.f));
}

template <int TXN, int TYN, int KH, int TSQ, int CL, bool VEC>
__global__ void __launch_bounds__(Tile<TXN, TYN, KH, TSQ>::kThreads,
                                  Tile<TXN, TYN, KH, TSQ>::kMinBlocks)
cbr_avgpool_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ b, float* __restrict__ out,
                   int H, int W, int C, int OC, int Ho, int Wo, int Q,
                   int stages) {
  using T = Tile<TXN, TYN, KH, TSQ>;
  constexpr int kBSQ = T::kBSQ, kBN = T::kBN, kThreads = T::kThreads;
  // CTAs without a split keep bias, ReLU and pool in registers and may
  // walk several square tiles
  constexpr bool kWalk = KH == 1 && CL == 1;
  extern __shared__ __align__(16) float smem[];
  // pixel index (n H + h) W + w of row p of tile j, -1 past Q
  __shared__ int pix[(kWalk ? kWalkMax : 1) * T::kPix];

  const int tid = threadIdx.x;
  const int kh = tid / T::kGroup;
  const int tg = tid % T::kGroup;
  const int tx = tg % TXN;
  const int ty = tg / TXN;
  const int oc0 = blockIdx.y * kBN;
  const int rank = CL > 1 ? static_cast<int>(blockIdx.z) : 0;

  // this rank's steps [s0, s1) of ceil(C / kBK) (ops.py's ``cbra_steps``)
  const int steps = (C + kBK - 1) / kBK;
  const int s0 = rank * steps / CL, s1 = (rank + 1) * steps / CL;
  const int n_steps = s1 - s0;
  // this CTA's square tiles blockIdx.x + j gridDim.x (one where a split
  // is on: the grid then holds every tile); work item i is step
  // s0 + i % n_steps of tile j = i / n_steps
  const int sq_tiles = (Q + kBSQ - 1) / kBSQ;
  const int n_tiles =
      kWalk ? (sq_tiles - static_cast<int>(blockIdx.x) +
               static_cast<int>(gridDim.x) - 1) / static_cast<int>(gridDim.x)
            : 1;
  const int n_items = n_tiles * n_steps;
  auto tile_q0 = [&](int j) {
    return (static_cast<int>(blockIdx.x) + j * static_cast<int>(gridDim.x)) *
           kBSQ;
  };
  // the table: row p = c BSQ + s of a tile is corner c (dy = c / 2,
  // dx = c % 2) of its square s
  for (int e = tid; e < n_tiles * T::kPix; e += kThreads) {
    const int p = e % T::kPix;
    const int c = p / kBSQ, q = tile_q0(e / T::kPix) + p % kBSQ;
    int idx = -1;
    if (q < Q) {
      const int n = q / (Ho * Wo), r = q % (Ho * Wo);
      const int ho = r / Wo, wo = r % Wo;
      idx = (n * H + 2 * ho + (c >> 1)) * W + 2 * wo + (c & 1);
    }
    pix[e] = idx;
  }
  __syncthreads();

  // a single step of C has one w tile: copied once, into slot 0
  const bool w_once = n_steps == 1;
  auto x_slot = [&](int slot) { return smem + slot * T::kStage; };
  auto w_slot = [&](int slot) {
    return smem + (w_once ? 0 : slot) * T::kStage + T::kXStage;
  };

  // work item `item` into ring slot `slot`: only its step's kc channels
  // (rounded up to 4, the rest zero) are copied, since only those are
  // multiplied
  auto issue = [&](int item, int slot) {
    float* xs = x_slot(slot);
    float* ws = w_slot(slot);
    const int* tp = pix + (item / n_steps) * T::kPix;
    const int k0 = (s0 + item % n_steps) * kBK;
    const int kc = min(kBK, C - k0);
    const bool copy_w = !w_once || item == 0;
    if constexpr (VEC) {              // C % 4 == 0: kc too
      for (int e = tid; e < T::kPix * (kBK / 4); e += kThreads) {
        const int p = e / (kBK / 4), kk = (e % (kBK / 4)) * 4;
        if (kk >= kc) continue;
        const int idx = tp[p];
        cp_async<true>(xs + p * kXS + kk,
                       idx >= 0 ? x + static_cast<size_t>(idx) * C + k0 + kk
                                : x,
                       idx >= 0 ? 16 : 0);
      }
      if (copy_w)
        for (int e = tid; e < kBK * (kBN / 4); e += kThreads) {
          const int kk = e / (kBN / 4), nn = (e % (kBN / 4)) * 4;
          if (kk >= kc) continue;
          const bool ok = oc0 + nn < OC;
          cp_async<true>(ws + kk * kBN + nn,
                         ok ? w + static_cast<size_t>(k0 + kk) * OC + oc0 + nn
                            : w,
                         ok ? 16 : 0);
        }
    } else {
      const int kc4 = (kc + 3) & ~3;
      for (int e = tid; e < T::kPix * kBK; e += kThreads) {
        const int p = e / kBK, kk = e % kBK;
        if (kk >= kc4) continue;
        const int idx = tp[p];
        const bool ok = idx >= 0 && kk < kc;
        cp_async<false>(xs + p * kXS + kk,
                        ok ? x + static_cast<size_t>(idx) * C + k0 + kk : x,
                        ok ? 4 : 0);
      }
      if (copy_w)
        for (int e = tid; e < kBK * kBN; e += kThreads) {
          const int kk = e / kBN, nn = e % kBN;
          if (kk >= kc4) continue;
          const bool ok = kk < kc && oc0 + nn < OC;
          cp_async<false>(ws + kk * kBN + nn,
                          ok ? w + static_cast<size_t>(k0 + kk) * OC + oc0 +
                                   nn
                             : w,
                          ok ? 4 : 0);
        }
    }
  };

  // acc[j][c][m]: square ty + j TYN, corner c, channel m (m < 4: 4 tx + m;
  // m >= 4: BN/2 + 4 tx + m - 4)
  float acc[TSQ][4][kTN];
  auto zero = [&]() {
#pragma unroll
    for (int j = 0; j < TSQ; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int m = 0; m < kTN; ++m) acc[j][c][m] = 0.f;
  };
  zero();

  auto mac = [&](int slot, int kc4) {
    const float* xs = x_slot(slot);
    const float* ws = w_slot(slot);
    constexpr int kPart = kBK / KH;
#pragma unroll
    for (int k4 = 0; k4 < kPart; k4 += 4) {
      const int kk = kh * kPart + k4;
      if (kk >= kc4) break;
      float4 a[TSQ][4];
#pragma unroll
      for (int j = 0; j < TSQ; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          a[j][c] = *reinterpret_cast<const float4*>(
              xs + (c * kBSQ + ty + j * TYN) * kXS + kk);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* wr = ws + (kk + i) * kBN + 4 * tx;
        const float4 w0 = *reinterpret_cast<const float4*>(wr);
        const float4 w1 = *reinterpret_cast<const float4*>(wr + kBN / 2);
        const float wv[kTN] = {w0.x, w0.y, w0.z, w0.w,
                               w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int j = 0; j < TSQ; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float av = comp(a[j][c], i);
#pragma unroll
            for (int m = 0; m < kTN; ++m)
              acc[j][c][m] = fmaf(av, wv[m], acc[j][c][m]);
          }
      }
    }
  };

  // epilogue in registers (no split): bias, ReLU and the 2x2 average of
  // the tile at q0, then the accumulators start again; the bias of this
  // CTA's channels is read once
  float bias[kTN];
#pragma unroll
  for (int m = 0; m < kTN; ++m) {
    const int ch = oc0 + (m / 4) * (kBN / 2) + 4 * tx + m % 4;
    bias[m] = kWalk && ch < OC ? b[ch] : 0.f;
  }
  auto store_tile = [&](int q0) {
#pragma unroll
    for (int j = 0; j < TSQ; ++j) {
      const int q = q0 + ty + j * TYN;
      if (q >= Q) continue;
      float* o = out + static_cast<size_t>(q) * OC;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ch = oc0 + h * (kBN / 2) + 4 * tx;
        float v[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int mm = 4 * h + m;
          v[m] = pool4(acc[j][0][mm], acc[j][1][mm], acc[j][2][mm],
                       acc[j][3][mm], bias[mm]);
        }
        if (VEC && ch + 3 < OC) {
          *reinterpret_cast<float4*>(o + ch) = make_float4(v[0], v[1], v[2],
                                                           v[3]);
        } else {
#pragma unroll
          for (int m = 0; m < 4; ++m)
            if (ch + m < OC) o[ch + m] = v[m];
        }
      }
    }
    zero();
  };

  // the ring: `stages` slots (1 to 3) of work items, one block barrier an
  // item; the next tile's copies are in flight while this one is
  // multiplied and stored
  for (int i = 0; i < stages - 1; ++i) {
    if (i < n_items) issue(i, i);
    cp_async_commit();
  }
  int i = 0, slot = 0;
  for (int j = 0; j < n_tiles; ++j) {
    for (int s = s0; s < s1; ++s, ++i) {
      if (stages == 1) {
        issue(i, 0);
        cp_async_commit();
      }
      if (stages == 3)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncthreads();      // item i landed; the slot of item i - 1 is free
      if (stages > 1) {
        const int nx = i + stages - 1;
        if (nx < n_items) issue(nx, nx % stages);
        cp_async_commit();  // empty groups keep the count aligned
      }
      const int kc = min(kBK, C - s * kBK);
      mac(slot, (kc + 3) & ~3);
      if (stages == 1) __syncthreads();
      slot = slot + 1 == stages ? 0 : slot + 1;
    }
    if constexpr (kWalk) store_tile(tile_q0(j));
  }
  cp_async_wait<0>();

  if constexpr (!kWalk) {
    const int q0 = tile_q0(0);
    // the partial pre-pool block through shared memory (the ring is free):
    // red[(c BSQ + s) BN + ch], corner c of square s, channel ch
    __syncthreads();
    float* red = smem;
    auto slot4 = [&](int j, int c, int h) {
      return reinterpret_cast<float4*>(
          red + (c * kBSQ + ty + j * TYN) * kBN + h * (kBN / 2) + 4 * tx);
    };
    // the k parts' products added to part 0's, part 1 first
    for (int part = 1; part < KH; ++part) {
      if (kh == part)
#pragma unroll
        for (int j = 0; j < TSQ; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              *slot4(j, c, h) =
                  make_float4(acc[j][c][4 * h], acc[j][c][4 * h + 1],
                              acc[j][c][4 * h + 2], acc[j][c][4 * h + 3]);
      __syncthreads();
      if (kh == 0)
#pragma unroll
        for (int j = 0; j < TSQ; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float4 t = *slot4(j, c, h);
              acc[j][c][4 * h] += t.x;
              acc[j][c][4 * h + 1] += t.y;
              acc[j][c][4 * h + 2] += t.z;
              acc[j][c][4 * h + 3] += t.w;
            }
      __syncthreads();
    }
    if (kh == 0)                      // this CTA's block (its own slots)
#pragma unroll
      for (int j = 0; j < TSQ; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *slot4(j, c, h) =
                make_float4(acc[j][c][4 * h], acc[j][c][4 * h + 1],
                            acc[j][c][4 * h + 2], acc[j][c][4 * h + 3]);
    if constexpr (CL > 1)
      cg::this_cluster().sync();
    else
      __syncthreads();
    // rank r reduces groups [r G / CL, (r + 1) G / CL) of the tile's G
    // float4 groups of outputs over the ranks' blocks, in rank order
    constexpr int kGroups = kBSQ * kBN / 4;
    const int g0 = rank * kGroups / CL, g1 = (rank + 1) * kGroups / CL;
    for (int g = g0 + tid; g < g1; g += kThreads) {
      const int s = g / (kBN / 4), ch = (g % (kBN / 4)) * 4;
      float4 v[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) v[c] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int r = 0; r < CL; ++r) {
        const float* src = red;
        if constexpr (CL > 1) src = cg::this_cluster().map_shared_rank(red, r);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float4 t = *reinterpret_cast<const float4*>(
              src + (c * kBSQ + s) * kBN + ch);
          v[c].x += t.x;
          v[c].y += t.y;
          v[c].z += t.z;
          v[c].w += t.w;
        }
      }
      const int q = q0 + s;
      if (q >= Q) continue;
      float* o = out + static_cast<size_t>(q) * OC + oc0 + ch;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int oc = oc0 + ch + m;
        if (oc < OC)
          o[m] = pool4(comp(v[0], m), comp(v[1], m), comp(v[2], m),
                       comp(v[3], m), b[oc]);
      }
    }
    if constexpr (CL > 1)
      cg::this_cluster().sync();      // no block exits while it is read
  }
}

// the launch arguments past the template parameters
struct Args {
  const float *x, *w, *b;
  float* out;
  int N, H, W, C, OC, sq_ctas, stages;
  cudaStream_t stream;
};

template <int TXN, int TYN, int KH, int TSQ, int CL, bool VEC>
cudaError_t run(const Args& a) {
  using T = Tile<TXN, TYN, KH, TSQ>;
  auto kern = cbr_avgpool_kernel<TXN, TYN, KH, TSQ, CL, VEC>;
  constexpr bool kWalk = KH == 1 && CL == 1;
  static bool attr_set = false;      // once per instantiation
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(T::smem_bytes(3, !kWalk)));
    if (err == cudaSuccess && CL > 8)
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const int Ho = a.H / 2, Wo = a.W / 2;
  const long long Q = static_cast<long long>(a.N) * Ho * Wo;
  const long long sq_tiles = (Q + T::kBSQ - 1) / T::kBSQ;
  const int oc_tiles = (a.OC + T::kBN - 1) / T::kBN;
  if (static_cast<long long>(a.N) * a.H * a.W > 0x7fffffffLL ||
      oc_tiles > 65535 || a.sq_ctas < 1 || a.sq_ctas > sq_tiles ||
      (sq_tiles + a.sq_ctas - 1) / a.sq_ctas > (kWalk ? kWalkMax : 1))
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(a.sq_ctas), oc_tiles, CL);
  cfg.blockDim = dim3(T::kThreads);
  cfg.dynamicSmemBytes = T::smem_bytes(a.stages, !kWalk);
  cfg.stream = a.stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = CL;
  cfg.attrs = &cluster;
  cfg.numAttrs = CL > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kern, a.x, a.w, a.b, a.out, a.H, a.W, a.C, a.OC, Ho, Wo,
      static_cast<int>(Q), a.stages);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int TXN, int TYN, int KH, int TSQ, bool VEC>
cudaError_t run_cl(int cl, const Args& a) {
  switch (cl) {
    case 1: return run<TXN, TYN, KH, TSQ, 1, VEC>(a);
    case 2: return run<TXN, TYN, KH, TSQ, 2, VEC>(a);
    case 4: return run<TXN, TYN, KH, TSQ, 4, VEC>(a);
    case 8: return run<TXN, TYN, KH, TSQ, 8, VEC>(a);
    case 16: return run<TXN, TYN, KH, TSQ, 16, VEC>(a);
    default: return cudaErrorInvalidValue;
  }
}

// the CTA shapes (TXN, TYN, KH, TSQ) of ops.py's SHAPES: mid (8, 16, 1, 2)
// walks square tiles without a cluster; small (4, 8, 2, 2) and tiny (4, 8,
// 4, 1) split k and take clusters of 1-16
template <bool VEC>
cudaError_t run_shape(int txn, int tyn, int kh, int tsq, int cl,
                      const Args& a) {
  if (txn == 8 && tyn == 16 && kh == 1 && tsq == 2 && cl == 1)
    return run<8, 16, 1, 2, 1, VEC>(a);
  if (txn == 4 && tyn == 8 && kh == 2 && tsq == 2)
    return run_cl<4, 8, 2, 2, VEC>(cl, a);
  if (txn == 4 && tyn == 8 && kh == 4 && tsq == 1)
    return run_cl<4, 8, 4, 1, VEC>(cl, a);
  return cudaErrorInvalidValue;
}

}  // namespace

// x (N,H,W,C), w (C,OC), b (OC,), out (N,H/2,W/2,OC): contiguous fp32 on
// one device, N H W < 2^31.  (txn, tyn, kh, tsq): the CTA shape; cl: CTAs a
// cluster splitting C; sq_ctas: CTAs along the square tiles (every tile
// where kh or cl splits, else each CTA walks tiles bx, bx + sq_ctas, ...,
// at most 8); stages: the ring's depth (1 to 3): ops.py's planner.  vec: 1
// for 16-byte copies (C and OC multiples of 4, x, w and out 16-byte
// aligned).  Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_cbr_avgpool(const void* x, const void* w, const void* b,
                                 void* out, int N, int H, int W, int C, int OC,
                                 int txn, int tyn, int kh, int tsq, int cl,
                                 int sq_ctas, int stages, int vec,
                                 void* stream) {
  if (N <= 0 || H < 2 || W < 2 || C <= 0 || OC <= 0 || stages < 1 ||
      stages > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec && (C % 4 || OC % 4 ||
              ((reinterpret_cast<size_t>(x) | reinterpret_cast<size_t>(w) |
                reinterpret_cast<size_t>(out)) & 15)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(x), static_cast<const float*>(w),
               static_cast<const float*>(b), static_cast<float*>(out),
               N, H, W, C, OC, sq_ctas, stages,
               static_cast<cudaStream_t>(stream)};
  const cudaError_t err = vec ? run_shape<true>(txn, tyn, kh, tsq, cl, a)
                              : run_shape<false>(txn, tyn, kh, tsq, cl, a);
  return static_cast<int>(err);
}
