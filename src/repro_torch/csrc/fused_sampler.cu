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
// What the design does about it: a thread block cluster of CL CTAs per row
// (one row a cluster), each CTA holding a slice of chunk elements (a
// multiple of 4) in its shared memory for the whole kernel, so the row is
// read from device memory once and written once.  The slices are filled by
// cp.async (16-byte copies where the row stride and V are multiples of 4
// and the pointer is 16-byte aligned) and turned in place into the
// order-preserving uint32 key of x = row / T.  The Python planner
// (kernels/fused_sampler/ops.py, ``mask_plan``) picks CL from B, V, the
// SM count and the clusters the card holds one CTA an SM
// (``repro_fused_mask_solo_clusters``): 8 at the served B = 8, 64 CTAs,
// each a 74 KB slice beside ~17 KB of histograms and lists, since the
// H100 holds only 7 clusters of 16 one CTA an SM.  Every search is
// a radix select over 8-bit digits, most significant first; each CTA
// histograms its slice, the cluster sums the histograms through
// distributed shared memory (every CTA reads every rank's bins, in rank
// order, and picks the same digit: no broadcast), with two histogram
// buffers so one cluster barrier a round suffices.  Float keys crowd into
// a few exponents, so many lanes add to one bin: every histogram update is
// a native 32-bit shared-memory atomic (a 64-bit mass is added as two, its
// low word's carry going to the high word), never a compare-and-swap loop
// that contention would make retry.
//   * top-k: the k-th largest key tk from exact integer counts, the same
//     threshold as the reference's search for the largest t with
//     count(key >= t) >= k, so the same support (ties at the k-th key all
//     survive).  A round whose chosen bucket must survive whole ends the
//     search early (tk = the bucket's lowest key).
//   * top-p over the top-k survivors: the largest attained key u with
//     mass(key >= u) / mass(all) >= p (the reference's boundary c is u - 1
//     and its survivors key > c are exactly key >= u).  Each survivor's
//     mass is e = exp((double)x - (double)max) in fp64, rounded to the
//     nearest multiple of 2^-43 (0, with no exp taken, where x - max <
//     -31) and summed as a 64-bit integer: the sums are exact, so they do
//     not depend on the order in which they are taken, and both ways below
//     give the same u; u is the largest key whose (double)mass(key >= u) /
//     (double)mass(all) >= p.
//       - At most ``cap`` survivors (the served top-k 50): each CTA lists
//         its survivors' keys, every CTA gathers the cluster's list, and
//         each survivor's mass(key >= its key) is summed over the list.
//       - More (k <= 0, a large k, or ties at the k-th key): the same
//         radix select over the masses, in four rounds over the slices in
//         shared memory; e is computed in a round only for the survivors
//         whose key still matches the chosen digits.
//   * the output is written from shared memory: survivors keep x, every
//     other entry is -inf.  With neither filter on (k <= 0 or k >= V, and
//     p >= 1) the kernel is one streaming pass: read, divide, write.
// No atomics touch a float: the same inputs give the same bits on every
// run.  The launch allocates nothing and never synchronizes, and every
// policy is read on the card, so it replays under CUDA-graph capture.
//
// Rules (the reference's): T <= 0 scales by 1; k <= 0 keeps every token,
// else k is clipped to [1, V]; p is floored at 1e-6.  Survivors keep
// row / T, every other entry is -inf.  The keyed draw stays outside the
// kernel.
//
// Two deliberate departures from the reference, both on the nucleus
// boundary only (the top-k support is the reference's exactly):
//   * masses are exp in fp64 summed exactly in units of 2^-43 (each e
//     rounded to the nearest unit), where the reference sums fp32 exps in
//     fp32.  No kernel can repeat the reference's fp32 summation order, so
//     a token whose strictly-greater mass lies within fp32 rounding of p
//     may be decided either way; here the decision is fixed unless the
//     exact mass lies within ~1e-8 of p (V = 151,936 rounding errors of
//     2^-44 at most, against a total of at least 1);
//   * p >= 1 keeps every top-k survivor.  The reference's search at p = 1
//     cuts the tail whose mass its fp32 sum loses, a set that changes with
//     the summation order.
// The plain version (ops.py, fused_mask_plain) is the reference's fp32
// search; the check against it admits differences only on the tokens
// ops.py's nucleus_boundary marks.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kBins = 256;
constexpr int kCapMax = 512;        // survivors the gathered list may hold
constexpr double kMassUnit = 8796093022208.0;   // 2^43 units per unit mass

__device__ __forceinline__ uint32_t monotone_key(float x) {
  const uint32_t u = __float_as_uint(x);
  return (u >> 31) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(uint32_t key) {
  return __uint_as_float((key >> 31) ? (key & 0x7fffffffu) : ~key);
}

// e = exp(x - max) in fp64, in units of 2^-43, rounded to nearest; below
// x - max = -31, e < 2^-44.7 rounds to 0 and no exp is taken
__device__ __forceinline__ unsigned long long mass_of(uint32_t key,
                                                       double mx) {
  const double d = (double)key_value(key) - mx;
  return d < -31.0 ? 0ull : __double2ull_rn(exp(d) * kMassUnit);
}

struct Shared {
  unsigned int count[2][kBins];          // top-k histograms (two buffers)
  unsigned int mass_lo[2][kBins];        // top-p histograms (two buffers):
  unsigned int mass_hi[2][kBins];        // hi 2^32 + lo
  unsigned int gcount[kBins];            // the cluster's sums of a round
  unsigned long long gmass[kBins];
  uint32_t cand[kCapMax];                // this CTA's survivors' keys
  uint32_t gkey[kCapMax];                // the cluster's survivors' keys
  unsigned long long gE[kCapMax];        // and their masses
  unsigned long long wtotal[kThreads / 32];      // the warps' list masses
  unsigned long long above, total;
  unsigned int ncand, kmax, mxkey, up;
  unsigned int digit, remaining, bucket;
  unsigned int offs[17];
};

constexpr int kStaticSmem = static_cast<int>(sizeof(Shared));

template <int CL>
__device__ __forceinline__ void cluster_sync() {
  if constexpr (CL > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

// rank r's copy of this CTA's shared variable p
template <int CL, typename T>
__device__ __forceinline__ T* at_rank(T* p, int r) {
  if constexpr (CL > 1)
    return cg::this_cluster().map_shared_rank(p, r);
  else
    return p;
}

// A CTA may not exit while another rank still reads its shared memory:
// arrive after this CTA's last remote read, wait before it exits.
template <int CL>
__device__ __forceinline__ void cluster_arrive() {
  if constexpr (CL > 1) asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}
template <int CL>
__device__ __forceinline__ void cluster_wait() {
  if constexpr (CL > 1) asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// Adds a 64-bit mass to bin `bin` of the (hi, lo) pair histogram as two
// native 32-bit atomics: the low word's carry goes to the high word, so the
// pair holds the exact sum whatever order the lanes land in.
__device__ __forceinline__ void add_mass(unsigned int* lo, unsigned int* hi,
                                         unsigned int bin,
                                         unsigned long long e) {
  const unsigned int e_lo = static_cast<unsigned int>(e);
  const unsigned int old = atomicAdd(&lo[bin], e_lo);
  const unsigned int carry = old + e_lo < old ? 1u : 0u;
  const unsigned int e_hi = static_cast<unsigned int>(e >> 32) + carry;
  if (e_hi) atomicAdd(&hi[bin], e_hi);
}

template <bool VEC>
__device__ __forceinline__ void cp_async(uint32_t* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (VEC)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src));
}

// Warp 0 scans the cluster's 256 integer bins from the highest digit down
// and picks the digit holding the `remaining`-th largest key; `bucket` is
// that digit's count.
__device__ void pick_count_digit(Shared& sh) {
  const int lane = threadIdx.x;
  const unsigned int want = sh.remaining;   // read before any lane writes
  unsigned int c[8];
  unsigned int mine = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    c[j] = sh.gcount[255 - lane * 8 - j];
    mine += c[j];
  }
  unsigned int incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  const unsigned int before = incl - mine;
  if (before < want && want <= incl) {      // exactly one lane
    unsigned int cum = before;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (cum + c[j] >= want) {
        sh.digit = 255 - lane * 8 - j;
        sh.remaining = want - cum;
        sh.bucket = c[j];
        break;
      }
      cum += c[j];
    }
  }
}

// Warp 0 scans the cluster's 256 mass bins from the highest digit down and
// picks the largest digit d with above + mass(digit >= d) >= p * total
// (compared as (above + mass) / total >= p in fp64).  The sums are exact,
// so the whole bucket chosen a round earlier always reaches it again and
// some digit is always found; `top` (the first round) also sets the total.
__device__ void pick_mass_digit(Shared& sh, double p, bool top) {
  const int lane = threadIdx.x;
  const unsigned long long above = sh.above;   // read before any lane writes
  const unsigned long long prev_total = sh.total;
  unsigned long long c[8];
  unsigned long long mine = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    c[j] = sh.gmass[255 - lane * 8 - j];
    mine += c[j];
  }
  unsigned long long incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  const unsigned long long total =
      top ? __shfl_sync(0xffffffffu, incl, 31) : prev_total;
  if (top && lane == 0) sh.total = total;
  const unsigned long long before = incl - mine;
  const double denom = static_cast<double>(total);
  const bool reach = static_cast<double>(above + incl) / denom >= p;
  const unsigned int ballot = __ballot_sync(0xffffffffu, reach);
  if (ballot == 0) {                   // unreachable: the sums are exact
    if (lane == 0) sh.digit = 0;
    return;
  }
  if (lane == __ffs(ballot) - 1) {
    unsigned long long cum = before;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      cum += c[j];
      if (static_cast<double>(above + cum) / denom >= p) {
        sh.digit = 255 - lane * 8 - j;
        sh.above = above + cum - c[j];
        break;
      }
    }
  }
}

template <int CL, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
fused_mask_kernel(const float* __restrict__ rows, int row_stride,
                  const float* __restrict__ temperature,
                  const int* __restrict__ top_k,
                  const float* __restrict__ top_p, float* __restrict__ out,
                  int V, int chunk, int cap) {
  extern __shared__ __align__(16) uint32_t skey[];   // this CTA's slice
  __shared__ Shared sh;
  const int tid = threadIdx.x;
  const int rank = CL > 1 ? static_cast<int>(cg::this_cluster().block_rank())
                          : 0;
  const int b = blockIdx.x / CL;
  const int lo = min(V, rank * chunk);
  const int n = min(V, lo + chunk) - lo;   // VEC: a multiple of 4
  const float* row = rows + static_cast<size_t>(b) * row_stride + lo;
  float* o = out + static_cast<size_t>(b) * V + lo;
  const float t = temperature[b];
  const float safe_t = t > 0.f ? t : 1.f;
  const int k = top_k[b];
  const float p_eff = fmaxf(top_p[b], 1e-6f);
  const bool do_k = k > 0 && k < V;   // k <= 0 and k >= V keep every token
  const bool do_p = p_eff < 1.f;

  if (!do_k && !do_p) {               // one read, one write
    if constexpr (VEC) {
#pragma unroll 4
      for (int i = 4 * tid; i < n; i += 4 * kThreads) {
        float4 v = *reinterpret_cast<const float4*>(row + i);
        v.x = v.x / safe_t;
        v.y = v.y / safe_t;
        v.z = v.z / safe_t;
        v.w = v.w / safe_t;
        *reinterpret_cast<float4*>(o + i) = v;
      }
    } else {
      for (int i = tid; i < n; i += kThreads) o[i] = row[i] / safe_t;
    }
    return;
  }

  // ---- the slice into shared memory, as keys; round 0 of top-k ---------
  if constexpr (VEC) {
    for (int i = 4 * tid; i < n; i += 4 * kThreads)
      cp_async<true>(skey + i, row + i);
  } else {
    for (int i = tid; i < n; i += kThreads) cp_async<false>(skey + i, row + i);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  for (int i = tid; i < 2 * kBins; i += kThreads) {
    (&sh.count[0][0])[i] = 0u;
    (&sh.mass_lo[0][0])[i] = 0u;
    (&sh.mass_hi[0][0])[i] = 0u;
  }
  if (tid == 0) {
    sh.ncand = 0u;
    sh.kmax = 0u;
    sh.up = 0u;
    sh.above = 0ull;
    sh.remaining = static_cast<unsigned int>(k);
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  uint32_t kmax = 0u;
  for (int i = tid; i < n; i += kThreads) {
    const uint32_t key = monotone_key(__uint_as_float(skey[i]) / safe_t);
    skey[i] = key;
    kmax = max(kmax, key);
    if (do_k) atomicAdd(&sh.count[0][key >> 24], 1u);
  }
  kmax = __reduce_max_sync(0xffffffffu, kmax);
  if ((tid & 31) == 0) atomicMax(&sh.kmax, kmax);
  cluster_sync<CL>();
  if (tid == 0) {                     // the row's largest key
    uint32_t m = 0u;
#pragma unroll
    for (int r = 0; r < CL; ++r) m = max(m, *at_rank<CL>(&sh.kmax, r));
    sh.mxkey = m;
  }
  if (do_k && tid < kBins) {
    unsigned int s = 0u;
#pragma unroll
    for (int r = 0; r < CL; ++r) s += *at_rank<CL>(&sh.count[0][tid], r);
    sh.gcount[tid] = s;
  }
  __syncthreads();

  // ---- top-k: radix select of the k-th largest key ----------------------
  uint32_t tk = 0u;                   // key >= 0 keeps all
  unsigned int n_surv = static_cast<unsigned int>(V);
  if (do_k) {
    uint32_t prefix = 0u, mask = 0u;
    for (int d = 0; d < 4; ++d) {
      const int shift = 24 - 8 * d;
      if (d > 0) {
        unsigned int* cnt = sh.count[d & 1];
        for (int i = tid; i < n; i += kThreads) {
          const uint32_t key = skey[i];
          if ((key & mask) == prefix)
            atomicAdd(&cnt[(key >> shift) & 255u], 1u);
        }
        cluster_sync<CL>();
        if (tid < kBins) {
          unsigned int s = 0u;
#pragma unroll
          for (int r = 0; r < CL; ++r) s += *at_rank<CL>(&cnt[tid], r);
          sh.gcount[tid] = s;
          // the other buffer's last remote reads were a round ago
          sh.count[(d + 1) & 1][tid] = 0u;
        }
        __syncthreads();
      }
      if (tid < 32) pick_count_digit(sh);
      __syncthreads();
      prefix |= sh.digit << shift;
      mask |= 255u << shift;
      if (sh.remaining == sh.bucket) break;   // the whole bucket survives
    }
    tk = prefix;
    n_surv = static_cast<unsigned int>(k) - sh.remaining + sh.bucket;
  }

  // ---- top-p over the top-k survivors -----------------------------------
  uint32_t thresh = tk;
  if (do_p) {
    const double mx = static_cast<double>(key_value(sh.mxkey));
    const double p = static_cast<double>(p_eff);
    if (n_surv <= static_cast<unsigned int>(cap)) {
      // the survivors, listed, gathered by every CTA of the cluster
      for (int i = tid; i < n; i += kThreads) {
        const uint32_t key = skey[i];
        if (key >= tk) sh.cand[atomicAdd(&sh.ncand, 1u)] = key;
      }
      cluster_sync<CL>();
      if (tid == 0) {
        unsigned int off = 0u;
        for (int r = 0; r < CL; ++r) {
          sh.offs[r] = off;
          off += *at_rank<CL>(&sh.ncand, r);
        }
        sh.offs[CL] = off;
      }
      __syncthreads();
      const int m = static_cast<int>(sh.offs[CL]);    // == n_surv
      for (int j = tid; j < m; j += kThreads) {
        int r = 0;
        while (j >= static_cast<int>(sh.offs[r + 1])) ++r;
        sh.gkey[j] = *at_rank<CL>(&sh.cand[j - sh.offs[r]], r);
      }
      __syncthreads();
      cluster_arrive<CL>();
      unsigned long long part = 0ull;
      for (int j = tid; j < m; j += kThreads) {
        const unsigned long long e = mass_of(sh.gkey[j], mx);
        sh.gE[j] = e;
        part += e;
      }
      for (int o = 16; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      if ((tid & 31) == 0) sh.wtotal[tid >> 5] = part;
      __syncthreads();
      unsigned long long total = 0ull;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) total += sh.wtotal[w];
      const double denom = static_cast<double>(total);
      for (int j = tid; j < m; j += kThreads) {
        const uint32_t key = sh.gkey[j];
        unsigned long long ge = 0ull;
        for (int i = 0; i < m; ++i)
          if (sh.gkey[i] >= key) ge += sh.gE[i];
        if (static_cast<double>(ge) / denom >= p) atomicMax(&sh.up, key);
      }
      __syncthreads();
      thresh = max(tk, sh.up);
    } else {
      // radix select over the masses of the slices in shared memory
      uint32_t prefix = 0u, mask = 0u;
      for (int d = 0; d < 4; ++d) {
        const int shift = 24 - 8 * d;
        unsigned int* lo = sh.mass_lo[d & 1];
        unsigned int* hi = sh.mass_hi[d & 1];
        for (int i = tid; i < n; i += kThreads) {
          const uint32_t key = skey[i];
          if (key >= tk && (key & mask) == prefix) {
            const unsigned long long e = mass_of(key, mx);
            if (e) add_mass(lo, hi, (key >> shift) & 255u, e);
          }
        }
        cluster_sync<CL>();
        if (tid < kBins) {
          unsigned long long s = 0ull;
#pragma unroll
          for (int r = 0; r < CL; ++r)
            s += (static_cast<unsigned long long>(
                      *at_rank<CL>(&hi[tid], r)) << 32) +
                 *at_rank<CL>(&lo[tid], r);
          sh.gmass[tid] = s;
          sh.mass_lo[(d + 1) & 1][tid] = 0u;
          sh.mass_hi[(d + 1) & 1][tid] = 0u;
        }
        __syncthreads();
        if (d == 3) cluster_arrive<CL>();
        if (tid < 32) pick_mass_digit(sh, p, d == 0);
        __syncthreads();
        prefix |= sh.digit << shift;
        mask |= 255u << shift;
      }
      thresh = max(tk, prefix);
    }
  } else {
    cluster_arrive<CL>();
  }

  // ---- the output, from shared memory -----------------------------------
  const float ninf = -INFINITY;
  if constexpr (VEC) {
    for (int i = 4 * tid; i < n; i += 4 * kThreads) {
      const uint4 kk = *reinterpret_cast<const uint4*>(skey + i);
      float4 v;
      v.x = kk.x >= thresh ? key_value(kk.x) : ninf;
      v.y = kk.y >= thresh ? key_value(kk.y) : ninf;
      v.z = kk.z >= thresh ? key_value(kk.z) : ninf;
      v.w = kk.w >= thresh ? key_value(kk.w) : ninf;
      *reinterpret_cast<float4*>(o + i) = v;
    }
  } else {
    for (int i = tid; i < n; i += kThreads) {
      const uint32_t key = skey[i];
      o[i] = key >= thresh ? key_value(key) : ninf;
    }
  }
  cluster_wait<CL>();
}

// the most dynamic shared memory a CTA may take beside the static part
constexpr int kMaxDynamic = 232448 - kStaticSmem;

// the kernel's attributes, set once per instantiation
template <int CL, bool VEC>
cudaError_t prepare() {
  static bool attr_set = false;
  if (attr_set) return cudaSuccess;
  auto kern = fused_mask_kernel<CL, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynamic);
  if (err == cudaSuccess && CL > 8)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  attr_set = err == cudaSuccess;
  return err;
}

// a launch of B clusters of CL CTAs, each with `dynamic` bytes
struct Config {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute cluster;
  Config(int CL, int B, size_t dynamic, cudaStream_t stream) {
    cfg.gridDim = dim3(static_cast<unsigned>(B) * CL);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = dynamic;
    cfg.stream = stream;
    cluster.id = cudaLaunchAttributeClusterDimension;
    cluster.val.clusterDim.x = CL;
    cluster.val.clusterDim.y = 1;
    cluster.val.clusterDim.z = 1;
    cfg.attrs = &cluster;
    cfg.numAttrs = CL > 1 ? 1 : 0;
  }
};

template <int CL, bool VEC>
cudaError_t launch(const float* rows, int row_stride, const float* t,
                   const int* k, const float* p, float* out, int B, int V,
                   int chunk, int cap, cudaStream_t stream) {
  cudaError_t err = prepare<CL, VEC>();
  if (err != cudaSuccess) return err;
  Config c(CL, B, static_cast<size_t>(chunk) * sizeof(uint32_t), stream);
  err = cudaLaunchKernelEx(&c.cfg, fused_mask_kernel<CL, VEC>, rows,
                           row_stride, t, k, p, out, V, chunk, cap);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// clusters of CL CTAs the current device holds at once with one CTA an SM
// (a CTA taking all the shared memory it may): the GPCs' SMs are dealt to
// whole clusters, so at CL = 16 this is fewer than the SM count / 16
template <int CL>
int solo_clusters() {
  if (prepare<CL, false>() != cudaSuccess) return -1;
  Config c(CL, 1, kMaxDynamic, nullptr);
  c.cfg.numAttrs = 1;                // the occupancy query wants a cluster
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, fused_mask_kernel<CL, false>,
                                     &c.cfg) != cudaSuccess)
    return -1;
  return n;
}

template <bool VEC>
cudaError_t launch_cl(int cl, const float* rows, int row_stride,
                      const float* t, const int* k, const float* p,
                      float* out, int B, int V, int chunk, int cap,
                      cudaStream_t st) {
  switch (cl) {
    case 1: return launch<1, VEC>(rows, row_stride, t, k, p, out, B, V,
                                  chunk, cap, st);
    case 2: return launch<2, VEC>(rows, row_stride, t, k, p, out, B, V,
                                  chunk, cap, st);
    case 4: return launch<4, VEC>(rows, row_stride, t, k, p, out, B, V,
                                  chunk, cap, st);
    case 8: return launch<8, VEC>(rows, row_stride, t, k, p, out, B, V,
                                  chunk, cap, st);
    case 16: return launch<16, VEC>(rows, row_stride, t, k, p, out, B, V,
                                    chunk, cap, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Bytes of static shared memory a CTA of the kernel holds beside its slice
// (ops.py's planner budgets the slice against the rest).
extern "C" int repro_fused_mask_static_smem() { return kStaticSmem; }

// Clusters of cl (1, 2, 4, 8 or 16) CTAs the current device holds at once
// with one CTA an SM (cudaOccupancyMaxActiveClusters): ops.py's planner.
// -1 on error.
extern "C" int repro_fused_mask_solo_clusters(int cl) {
  switch (cl) {
    case 1: return solo_clusters<1>();
    case 2: return solo_clusters<2>();
    case 4: return solo_clusters<4>();
    case 8: return solo_clusters<8>();
    case 16: return solo_clusters<16>();
    default: return -1;
  }
}

// rows: (B, V) float32 with row stride row_stride elements; temperature,
// top_p: (B,) float32; top_k: (B,) int32; out: (B, V) float32, contiguous.
// cl (1, 2, 4, 8 or 16) CTAs a row, each holding chunk elements (a multiple
// of 4, cl * chunk >= V); cap (<= 512) survivors the top-p list takes
// before the radix path: ops.py's planner.  vec: 1 for 16-byte copies
// (row_stride and V multiples of 4, rows 16-byte aligned).  Returns the
// launch's cudaError_t.
extern "C" int repro_fused_mask(const void* rows, int row_stride,
                                const void* temperature, const void* top_k,
                                const void* top_p, void* out, int B, int V,
                                int cl, int chunk, int cap, int vec,
                                void* stream) {
  if (B <= 0 || V <= 0 || row_stride < V || chunk <= 0 || chunk % 4 ||
      static_cast<long long>(chunk) * cl < V || cap < 0 || cap > kCapMax ||
      static_cast<long long>(chunk) * 4 > kMaxDynamic)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec && (row_stride % 4 || V % 4 ||
              (reinterpret_cast<size_t>(rows) & 15)))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* r = static_cast<const float*>(rows);
  const float* t = static_cast<const float*>(temperature);
  const int* k = static_cast<const int*>(top_k);
  const float* p = static_cast<const float*>(top_p);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      vec ? launch_cl<true>(cl, r, row_stride, t, k, p, o, B, V, chunk, cap,
                            st)
          : launch_cl<false>(cl, r, row_stride, t, k, p, o, B, V, chunk, cap,
                             st);
  return static_cast<int>(err);
}
