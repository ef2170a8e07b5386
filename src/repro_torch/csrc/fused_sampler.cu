// Sort-free top-k / top-p support filter for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   fused_mask  src/repro/kernels/fused_sampler/fused_sampler.py:79
//               (body _kernel :39, key _monotone_key :33)
//
// What bounds it on the H100: bytes.  The least traffic is one read of the
// (B, V) fp32 logits and one write of the masked rows: at V = 151,936 and
// B = 8 that is 9.7 MB, ~2.9 us at 3.35 TB/s.
//
// What the design does about it: one CTA of 1024 threads per row.  A
// 600 KB fp32 row does not fit in the 227 KB of shared memory a block may
// use, so every pass streams the row again; after the first pass it comes
// from the 50 MB L2 (8 rows are 4.9 MB).  The reference's two 32-step
// MSB-first key searches become radix selects over 8-bit digits of the
// same order-preserving uint32 key, 4 passes each, with a shared-memory
// histogram per pass:
//   * top-k: the k-th largest key, found digit by digit from exact integer
//     counts — the same threshold as the reference's search for the largest
//     t with count(key >= t) >= k, so the same support (ties at the k-th
//     key all survive);
//   * top-p: the largest key u with mass(key >= u) >= p over the top-k
//     survivors — the reference's boundary c is u - 1 and its survivors
//     key > c are exactly key >= u.
// A row then costs 10 passes (4 top-k + 1 denominator + 4 top-p + 1 write)
// when both filters are on, and 1 pass when neither is (k <= 0, p >= 1).
//
// Rules (the reference's): T <= 0 scales by 1; k <= 0 keeps every token,
// else k is clipped to [1, V]; p is floored at 1e-6.  Survivors keep
// row / T, every other entry is -inf.  The keyed draw stays outside the
// kernel.
//
// Two deliberate departures from the reference, both on the nucleus
// boundary only (the top-k support is the reference's exactly):
//   * masses (exp and sums) are fp64, where the reference sums in fp32.  No
//     kernel can repeat the reference's fp32 summation order, so a token
//     whose strictly-greater mass lies within fp32 rounding of p may be
//     decided either way; in fp64 the decision is fixed unless the exact
//     mass lies within ~1e-15 of p, and does not depend on the order the
//     atomics land in;
//   * p >= 1 keeps every top-k survivor.  The reference's search at p = 1
//     cuts the tail whose mass its fp32 sum loses, a set that changes with
//     the summation order.
// The plain version (ops.py, fused_mask_plain) is the reference's fp32
// search; the check against it admits differences only on the tokens
// ops.py's nucleus_boundary marks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ uint32_t monotone_key(float x) {
  const uint32_t u = __float_as_uint(x);
  return (u >> 31) ? ~u : (u | 0x80000000u);
}

struct Shared {
  unsigned int count[256];
  double mass[256];
  float red[kWarps];
  double red64[kWarps];
  unsigned int digit;
  unsigned int remaining;
  double above;
};

__device__ float block_max(float x, Shared& sh) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) sh.red[warp] = x;
  __syncthreads();
  float r = sh.red[0];
  for (int w = 1; w < kWarps; ++w) r = fmaxf(r, sh.red[w]);
  return r;
}

__device__ double block_sum(double x, Shared& sh) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) sh.red64[warp] = x;
  __syncthreads();
  double r = 0.0;
  for (int w = 0; w < kWarps; ++w) r += sh.red64[w];
  return r;
}

// Warp 0 scans the 256 integer bins from the highest digit down and picks
// the digit holding the `remaining`-th largest key.
__device__ void pick_count_digit(Shared& sh) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  unsigned int c[8];
  unsigned int mine = 0;
  for (int j = 0; j < 8; ++j) {
    c[j] = sh.count[255 - lane * 8 - j];
    mine += c[j];
  }
  unsigned int incl = mine;
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  const unsigned int before = incl - mine;
  const unsigned int want = sh.remaining;
  const bool here = before < want && want <= incl;
  const unsigned int ballot = __ballot_sync(0xffffffffu, here);
  if (here && lane == __ffs(ballot) - 1) {
    unsigned int cum = before;
    for (int j = 0; j < 8; ++j) {
      if (cum + c[j] >= want) {
        sh.digit = 255 - lane * 8 - j;
        sh.remaining = want - cum;
        break;
      }
      cum += c[j];
    }
  }
}

// Warp 0 scans the 256 mass bins from the highest digit down and picks the
// largest digit d with above + mass(digit >= d) >= target.  At the top
// level no such digit means the whole mass rounds below p (reported as
// 256: keep every survivor); at a lower level it means this level's
// re-summed group mass rounded a hair below the level above, and the
// boundary is the group's bottom (digit 0).
__device__ void pick_mass_digit(Shared& sh, double denom, double target,
                                bool top) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  double c[8];
  double mine = 0.0;
  for (int j = 0; j < 8; ++j) {
    c[j] = sh.mass[255 - lane * 8 - j];
    mine += c[j];
  }
  double incl = mine;
  for (int o = 1; o < 32; o <<= 1) {
    const double y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  const double before = incl - mine;
  const double above = sh.above;
  const bool reach = (above + incl) / denom >= target;
  const unsigned int ballot = __ballot_sync(0xffffffffu, reach);
  if (lane == 0 && ballot == 0) sh.digit = top ? 256u : 0u;
  if (ballot != 0 && lane == __ffs(ballot) - 1) {
    double cum = before;
    for (int j = 0; j < 8; ++j) {
      cum += c[j];
      if ((above + cum) / denom >= target) {
        sh.digit = 255 - lane * 8 - j;
        sh.above = above + cum - c[j];
        break;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
fused_mask_kernel(const float* __restrict__ rows, int row_stride,
                  const float* __restrict__ temperature,
                  const int* __restrict__ top_k,
                  const float* __restrict__ top_p, float* __restrict__ out,
                  int V) {
  __shared__ Shared sh;
  const int b = blockIdx.x;
  const float* row = rows + (size_t)b * row_stride;
  float* o = out + (size_t)b * V;
  const float t = temperature[b];
  const float safe_t = t > 0.f ? t : 1.f;
  const int k = top_k[b];
  const float p_eff = fmaxf(top_p[b], 1e-6f);
  const bool do_k = k > 0 && k < V;   // k <= 0 and k >= V keep every token
  const bool do_p = p_eff < 1.f;

  // ---- top-k: radix select of the k-th largest key ----------------------
  uint32_t tk = 0;                    // key >= 0 keeps all
  if (do_k) {
    uint32_t prefix = 0, mask = 0;
    if (threadIdx.x == 0) sh.remaining = (unsigned int)k;
    for (int shift = 24; shift >= 0; shift -= 8) {
      for (int i = threadIdx.x; i < 256; i += kThreads) sh.count[i] = 0;
      __syncthreads();
      for (int i = threadIdx.x; i < V; i += kThreads) {
        const uint32_t key = monotone_key(row[i] / safe_t);
        if ((key & mask) == prefix) atomicAdd(&sh.count[(key >> shift) & 255u], 1u);
      }
      __syncthreads();
      pick_count_digit(sh);
      __syncthreads();
      prefix |= sh.digit << shift;
      mask |= 255u << shift;
    }
    tk = prefix;
  }

  // ---- top-p over the top-k survivors -----------------------------------
  uint32_t up = 0;                    // key >= 0 keeps every survivor
  if (do_p) {
    // the row maximum always survives top-k: it is the survivors' maximum
    float mx = -INFINITY;
    for (int i = threadIdx.x; i < V; i += kThreads)
      mx = fmaxf(mx, row[i] / safe_t);
    mx = block_max(mx, sh);
    double part = 0.0;
    for (int i = threadIdx.x; i < V; i += kThreads) {
      const float x = row[i] / safe_t;
      if (monotone_key(x) >= tk) part += exp((double)x - (double)mx);
    }
    const double denom = block_sum(part, sh);
    uint32_t prefix = 0, mask = 0;
    if (threadIdx.x == 0) sh.above = 0.0;
    bool none = false;
    for (int shift = 24; shift >= 0; shift -= 8) {
      for (int i = threadIdx.x; i < 256; i += kThreads) sh.mass[i] = 0.0;
      __syncthreads();
      for (int i = threadIdx.x; i < V; i += kThreads) {
        const float x = row[i] / safe_t;
        const uint32_t key = monotone_key(x);
        if (key >= tk && (key & mask) == prefix)
          atomicAdd(&sh.mass[(key >> shift) & 255u],
                    exp((double)x - (double)mx));
      }
      __syncthreads();
      pick_mass_digit(sh, denom, (double)p_eff, shift == 24);
      __syncthreads();
      if (sh.digit == 256) {          // total mass rounds below p: keep all
        none = true;
        break;
      }
      prefix |= sh.digit << shift;
      mask |= 255u << shift;
    }
    up = none ? 0u : prefix;
  }

  const uint32_t thresh = tk > up ? tk : up;
  for (int i = threadIdx.x; i < V; i += kThreads) {
    const float x = row[i] / safe_t;
    o[i] = monotone_key(x) >= thresh ? x : -INFINITY;
  }
}

}  // namespace

// Plain C entry point.  rows: (B, V) float32 with row stride row_stride
// elements; temperature, top_p: (B,) float32; top_k: (B,) int32; out:
// (B, V) float32, contiguous.  Returns the launch's cudaError_t.
extern "C" int repro_fused_mask(const void* rows, int row_stride,
                                const void* temperature, const void* top_k,
                                const void* top_p, void* out, int B, int V,
                                void* stream) {
  if (B <= 0 || V <= 0 || row_stride < V)
    return static_cast<int>(cudaErrorInvalidValue);
  fused_mask_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), row_stride,
      static_cast<const float*>(temperature),
      static_cast<const int*>(top_k), static_cast<const float*>(top_p),
      static_cast<float*>(out), V);
  return static_cast<int>(cudaGetLastError());
}
