// GQA flash-decoding for Hopper (sm_90a): one query token per sequence
// attends over a dense ring-buffer KV cache or a block-paged KV pool.
//
// Replaces the Pallas TPU kernels
//   gqa_decode        src/repro/kernels/decode_attention/decode_attention.py:135
//                     (body _kernel :23)
//   gqa_decode_paged  src/repro/kernels/decode_attention/decode_attention.py:91
//                     (body _paged_kernel :54)
//
// What bounds it on the H100: bytes.  Each attended slot costs 2*K*D*2 B of
// K+V (bf16) for 4*H*D flops, about one flop per byte, far under the
// card's ~295 flop/byte ridge.  The least time is the K/V bytes the call
// must read over 3.35 TB/s.
//
// What the design does about it:
//   * flash-decoding split: one CTA per (batch, kv head, head group, W
//     split).  Without the split, B*K = 64 CTAs would leave half of the
//     132 SMs idle; the split gives ~4 CTAs per SM, and a second small
//     kernel combines the splits' (max, denominator, accumulator).
//   * the G = H/K query heads of a group share every K/V row a CTA loads
//     (GQA reuse), held in registers: each lane owns D/32 dims.
//   * each warp keeps U = 4 rows in flight, vector loads per lane.
//   * only the slots the softmax can weigh are read: an invalid slot's
//     weight is exp(-1e30 - m) = 0, so it is skipped — unless the whole row
//     has no valid slot, where the reference's masked softmax yields the
//     mean of V over every slot it reads, and then every slot is read.
//     Paged rows stop at their length.
//   * the ragged W tail is masked here (the Pallas wrapper fell back to the
//     reference instead).
//
// Semantics (the reference's): scores q.k / sqrt(D) in fp32, invalid slots
// -1e30, online softmax in fp32, output acc / max(l, 1e-30) in q's type.
// Paged: logical slot t of row b lives in pool block block_tables[b, t/bs]
// (-1 clamped to block 0) at offset t % bs, valid iff t < lengths[b].

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kMaskScore = -1e30f;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 4;

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

template <int BYTES> struct VecOf;
template <> struct VecOf<2> { using type = unsigned short; };
template <> struct VecOf<4> { using type = unsigned int; };
template <> struct VecOf<8> { using type = uint2; };
template <> struct VecOf<16> { using type = uint4; };

// N consecutive elements, one vector load, widened to fp32
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* p, float (&f)[N]) {
  using V = typename VecOf<sizeof(T) * N>::type;
  V raw = *reinterpret_cast<const V*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < N; ++j) f[j] = to_float(e[j]);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// One CTA: batch row b, kv head kh, query heads [hg*GT, hg*GT+GT) of the
// group, slots [split*split_len, +split_len).  Writes the split's partial
// softmax state: part_m / part_l (B, H, S) and part_acc (B, H, S, D).
template <typename T, int D, int GT, bool PAGED>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const bool* __restrict__ valid,
                    const int* __restrict__ tables,
                    const int* __restrict__ lengths,
                    float* __restrict__ part_acc, float* __restrict__ part_m,
                    float* __restrict__ part_l, int K, int G, int W,
                    int split_len, int bs, int M, float sqrt_d) {
  constexpr int DPL = D / 32;
  const int n_hg = G / GT;
  const int hg = blockIdx.x % n_hg;
  const int kh = (blockIdx.x / n_hg) % K;
  const int b = blockIdx.x / (n_hg * K);
  const int split = blockIdx.y;
  const int S = gridDim.y;
  const int H = K * G;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const int t_begin = split * split_len;
  int t_end = min(W, t_begin + split_len);
  int len = W;
  bool row_any;
  if (PAGED) {
    len = lengths[b];
    row_any = len > 0;
    if (row_any) t_end = min(t_end, len);
  } else {
    int any = 0;
    for (int t = threadIdx.x; t < W; t += kThreads)
      any |= valid[(size_t)b * W + t] ? 1 : 0;
    row_any = __syncthreads_or(any) != 0;
  }

  const int h0 = kh * G + hg * GT;
  float qf[GT][DPL];
#pragma unroll
  for (int g = 0; g < GT; ++g)
    load_vec<T, DPL>(q + ((size_t)b * H + h0 + g) * D + lane * DPL, qf[g]);

  float m[GT], l[GT], acc[GT][DPL];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = kMaskScore;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[g][j] = 0.f;
  }

  for (int base = t_begin + warp; base < t_end; base += kWarps * kUnroll) {
    float kf[kUnroll][DPL], vf[kUnroll][DPL];
    bool use[kUnroll], masked[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + u * kWarps;
      bool ok = false;
      use[u] = false;
      if (t < t_end) {
        ok = PAGED ? (t < len) : valid[(size_t)b * W + t];
        use[u] = ok || !row_any;
      }
      masked[u] = !ok;
      if (use[u]) {
        size_t row;
        if (PAGED) {
          int blk = tables[(size_t)b * M + t / bs];
          blk = blk < 0 ? 0 : blk;
          row = ((size_t)blk * bs + t % bs) * K + kh;
        } else {
          row = ((size_t)b * W + t) * K + kh;
        }
        load_vec<T, DPL>(k + row * D + lane * DPL, kf[u]);
        load_vec<T, DPL>(v + row * D + lane * DPL, vf[u]);
      } else {
#pragma unroll
        for (int j = 0; j < DPL; ++j) { kf[u][j] = 0.f; vf[u][j] = 0.f; }
      }
    }
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float sc[kUnroll];
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < DPL; ++j) part += qf[g][j] * kf[u][j];
        part = warp_sum(part);
        sc[u] = !use[u] ? -INFINITY : (masked[u] ? kMaskScore : part / sqrt_d);
        mx = fmaxf(mx, sc[u]);
      }
      const float corr = expf(m[g] - mx);
      l[g] *= corr;
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[g][j] *= corr;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (use[u]) {
          const float p = expf(sc[u] - mx);
          l[g] += p;
#pragma unroll
          for (int j = 0; j < DPL; ++j) acc[g][j] += p * vf[u][j];
        }
      }
      m[g] = mx;
    }
  }

  // combine the CTA's warps, then write the split's partial state
  __shared__ float sm_m[kWarps][GT];
  __shared__ float sm_l[kWarps][GT];
  __shared__ float sm_acc[kWarps][GT][D];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int j = 0; j < DPL; ++j) sm_acc[warp][g][lane * DPL + j] = acc[g][j];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < GT * D; idx += kThreads) {
    const int g = idx / D, d = idx % D;
    float mm = kMaskScore;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, sm_m[w][g]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm_m[w][g] - mm);
      ll += sm_l[w][g] * c;
      aa += sm_acc[w][g][d] * c;
    }
    const size_t pi = ((size_t)b * H + h0 + g) * S + split;
    part_acc[pi * D + d] = aa;
    if (d == 0) {
      part_m[pi] = mm;
      part_l[pi] = ll;
    }
  }
}

// One CTA of D threads per (batch, query head): merge the S splits.
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ part_acc,
                                      const float* __restrict__ part_m,
                                      const float* __restrict__ part_l,
                                      T* __restrict__ out, int S, int D) {
  const size_t bh = blockIdx.x;
  const int d = threadIdx.x;
  float mm = kMaskScore;
  for (int s = 0; s < S; ++s) mm = fmaxf(mm, part_m[bh * S + s]);
  float ll = 0.f, aa = 0.f;
  for (int s = 0; s < S; ++s) {
    const float c = expf(part_m[bh * S + s] - mm);
    ll += part_l[bh * S + s] * c;
    aa += part_acc[(bh * S + s) * D + d] * c;
  }
  out[bh * D + d] = from_float<T>(aa / fmaxf(ll, 1e-30f));
}

template <typename T, int D, int GT, bool PAGED>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         const void* valid, const void* tables,
                         const void* lengths, void* out, void* part_acc,
                         void* part_m, void* part_l, int B, int H, int K,
                         int W, int n_split, int split_len, int bs, int M,
                         cudaStream_t stream) {
  const int G = H / K;
  dim3 grid(B * K * (G / GT), n_split);
  decode_split_kernel<T, D, GT, PAGED><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const bool*>(valid),
      static_cast<const int*>(tables), static_cast<const int*>(lengths),
      static_cast<float*>(part_acc), static_cast<float*>(part_m),
      static_cast<float*>(part_l), K, G, W, split_len, bs, M,
      sqrtf(static_cast<float>(D)));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T><<<B * H, D, 0, stream>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_m),
      static_cast<const float*>(part_l), static_cast<T*>(out), n_split, D);
  return cudaGetLastError();
}

template <typename T, int D, bool PAGED>
cudaError_t launch_d(int G, const void* q, const void* k, const void* v,
                     const void* valid, const void* tables,
                     const void* lengths, void* out, void* part_acc,
                     void* part_m, void* part_l, int B, int H, int K, int W,
                     int n_split, int split_len, int bs, int M,
                     cudaStream_t stream) {
#define REPRO_LAUNCH_GT(GT)                                                   \
  return launch_typed<T, D, GT, PAGED>(q, k, v, valid, tables, lengths, out, \
                                       part_acc, part_m, part_l, B, H, K, W, \
                                       n_split, split_len, bs, M, stream)
  if (G % 8 == 0) REPRO_LAUNCH_GT(8);
  if (G % 4 == 0) REPRO_LAUNCH_GT(4);
  if (G % 2 == 0) REPRO_LAUNCH_GT(2);
  REPRO_LAUNCH_GT(1);
#undef REPRO_LAUNCH_GT
}

template <typename T, bool PAGED>
cudaError_t launch_t(int D, int G, const void* q, const void* k,
                     const void* v, const void* valid, const void* tables,
                     const void* lengths, void* out, void* part_acc,
                     void* part_m, void* part_l, int B, int H, int K, int W,
                     int n_split, int split_len, int bs, int M,
                     cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_d<T, 32, PAGED>(G, q, k, v, valid, tables, lengths, out,
                                    part_acc, part_m, part_l, B, H, K, W,
                                    n_split, split_len, bs, M, stream);
    case 64:
      return launch_d<T, 64, PAGED>(G, q, k, v, valid, tables, lengths, out,
                                    part_acc, part_m, part_l, B, H, K, W,
                                    n_split, split_len, bs, M, stream);
    case 128:
      return launch_d<T, 128, PAGED>(G, q, k, v, valid, tables, lengths, out,
                                     part_acc, part_m, part_l, B, H, K, W,
                                     n_split, split_len, bs, M, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point.  dtype: 0 = float32, 1 = bfloat16.  paged = 0 reads
// k/v as (B, W, K, D) caches masked by valid (B, W); paged = 1 reads them as
// (P, bs, K, D) pools through tables (B, M) and lengths (B,), W = M * bs.
// Scratch: part_acc (B, H, n_split, D), part_m / part_l (B, H, n_split),
// all float32.  Returns the launch's cudaError_t.
extern "C" int repro_gqa_decode(int paged, int dtype, const void* q,
                                const void* k, const void* v,
                                const void* valid, const void* tables,
                                const void* lengths, void* out,
                                void* part_acc, void* part_m, void* part_l,
                                int B, int H, int K, int D, int W,
                                int n_split, int split_len, int bs, int M,
                                void* stream) {
  if (K <= 0 || H % K != 0 || n_split <= 0 || split_len <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = H / K;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = paged ? launch_t<float, true>(D, G, q, k, v, valid, tables, lengths,
                                        out, part_acc, part_m, part_l, B, H,
                                        K, W, n_split, split_len, bs, M, s)
                : launch_t<float, false>(D, G, q, k, v, valid, tables,
                                         lengths, out, part_acc, part_m,
                                         part_l, B, H, K, W, n_split,
                                         split_len, bs, M, s);
  } else if (dtype == 1) {
    err = paged ? launch_t<__nv_bfloat16, true>(
                      D, G, q, k, v, valid, tables, lengths, out, part_acc,
                      part_m, part_l, B, H, K, W, n_split, split_len, bs, M, s)
                : launch_t<__nv_bfloat16, false>(
                      D, G, q, k, v, valid, tables, lengths, out, part_acc,
                      part_m, part_l, B, H, K, W, n_split, split_len, bs, M,
                      s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
