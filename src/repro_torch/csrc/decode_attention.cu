// GQA flash-decoding for Hopper (sm_90a): one query token per sequence
// attends over a dense ring-buffer KV cache or a block-paged KV pool.
//
// Replaces the Pallas TPU kernels
//   gqa_decode        src/repro/kernels/decode_attention/decode_attention.py:135
//                     (body _kernel :23)
//   gqa_decode_paged  src/repro/kernels/decode_attention/decode_attention.py:91
//                     (body _paged_kernel :54)
// and two earlier designs of this file.  The first split W (not the live
// span) evenly, put a per-slot index load in front of every K/V load and
// merged the splits in a second launch.  The second (the "heads" body
// below) gave a CTA at most two query heads, so a kv head's rows were read
// G/2 times at G > 2, and capped a row's splits at what one merge could
// stage in the 48 KB ring (24 at D = 256), so one row at B*K = 1 filled a
// third of the card.
//
// What bounds it on the H100: bytes.  Each attended slot costs 2*K*D*2 B of
// K+V (bf16) for 4*H*D flops, about G flops per byte, far under the card's
// ~295 flop/byte ridge.  The least time is the valid K/V bytes over
// 3.35 TB/s (5.5 us for 8 rows of ~560 slots at 8 kv heads of 128; 9.7 us
// for gemma3's one row of 31,776 slots at one kv head of 256).  At the
// serving shapes the kernel is also a chain of latencies: launch, the
// span's loads, the K/V stream, the merge's round trips through L2.
//
// Two bodies, one launch each, chosen by the wrapper's plan (decode_grid
// in kernels/decode_attention/ops.py) from the shapes alone:
//   * "heads" (fp32 and bf16): one CTA of 128 threads per (row b, kv head
//     kh, GT = 2 query heads (1 for odd G), split s), fp32 FFMA from shared
//     memory.  A slot is LPS = D / DPL lanes (DPL = 16 bf16 / 8 fp32 dims a
//     lane, two 16-byte chunks), a lane group takes two slots a tile and
//     scores reduce over log2(LPS) shuffles.  q carries log2(e) / sqrt(D),
//     so weights are exp2f of the score.  fp32 always takes it (IEEE fp32,
//     no TF32), with the split count it took before the group body
//     existed, so its bits are unchanged.
//   * "group" (bf16 only, G <= 16): one CTA per (row b, kv head kh, split
//     s) over all G query heads, so a K/V tile crosses from device memory
//     once for its whole group.  The heads are the rows of a tensor-core
//     tile: S = Q K^T runs as mma.m16n8k16 (bf16 in, fp32 out) with G
//     padded to 16 rows, eight slots a mma, the K tile read by ldmatrix
//     from a swizzled ring (16-byte chunk c of slot row r sits at c ^ (r &
//     7), so the eight rows of a matrix hit eight bank groups).  Scores are
//     scaled by log2(e) / sqrt(D) in fp32.  The online softmax stays fp32
//     per head, a quad of lanes holding a head's eight scores.  P.V runs
//     as O^T += V^T P^T on mma.m16n8k8: V^T by ldmatrix.trans, P^T straight
//     from the score mma's accumulator layout, carried as two bf16 terms
//     (hi = bf16(p), lo = bf16(p - hi): ~16 bits of p), so the weights
//     lose no more than fp32 FFMA would at bf16 tolerance.  O^T keeps one
//     accumulator per (dim, head) with no padded rows: 2 * D / 8 fp32
//     registers a lane at G <= 8.  Tiles: 32 slots (8 KB of K at D = 128,
//     16 KB at 256; 128 / 64 slots at D = 32 / 64), a warp owning 8 of
//     them (32 / 16 at D = 32 / 64), 3 stages (2 at D = 256: 64 KB).
//   Both bodies keep the reference max of a head until a score passes it
//   by 8 (log2 units), so accumulators are rescaled rarely.
//
// Shared by both:
//   * Live span, found on the device.  Paged: [0, lengths[b]).  Dense: the
//     CTA reads its row of the (B, W) mask with one 16-byte load a thread
//     (W = 2048 is one load each), keeps it in shared memory and reduces the
//     first and last valid slot.  A row with no valid slot takes [0, W):
//     every slot is read and weighs exp(-1e30 - -1e30) = 1, so the output is
//     the mean of V, as the reference's masked softmax gives.
//   * Partition: split s of S covers
//         [lo + (s * n) / S, lo + ((s + 1) * n) / S),   n = hi - lo,
//     integer division (64-bit).  The pieces cover [lo, hi) exactly once
//     and differ in length by at most one slot, so every CTA has work
//     whatever the lengths.  tests/test_torch_decode_split.py holds a
//     mirror of this formula.
//   * Ring: K and V tiles in a shared-memory ring filled by cp.async
//     16-byte copies (L2 only) with commit groups.  Each warp copies and
//     computes only its own rows of a tile, so the loop has no CTA barrier.
//     No K/V copy waits on a per-slot index load: a paged CTA loads its
//     row's block-table entries into shared memory once; a dense CTA
//     already holds its mask row.  An invalid slot inside the span of a
//     row that has a valid one is zero-filled, not read.
//   * The merge, one launch, two levels in a fixed order.  The warps of a
//     CTA merge through shared memory in warp order into the CTA's piece
//     (max, denominator, accumulator).  With S = 1 that is the output.
//     Otherwise each piece goes to scratch, and the S splits of a unit fall
//     into NG = ceil(S / cap) groups of ceil(S / NG) consecutive splits,
//     cap = min(32, ring bytes / (GT * D * 4)): what one CTA stages in its
//     ring.  The last CTA of a group to finish (an atomic ticket a group,
//     reset by that CTA for the next call) stages the group's pieces and
//     merges them in split order; with NG = 1 it writes the output, which
//     is exactly the single merge of the earlier design.  Otherwise it
//     writes the group's partial, and the last group to finish (a ticket a
//     unit) merges the NG groups in group order.  No CTA stages more than
//     cap pieces (<= 64 KB), S is at most cap^2, and two calls give the
//     same bits.
//   * The grid depends on shapes alone (the plan: body, GT, S), so a CUDA
//     graph replays the launch after the lengths or the mask change.
//
// The plan (decode_grid; set from launch/decode_timing.py --sweep at the
// shapes chip_smoke.py times, PERF.md).  units = B * K * G / GT, S =
// min(wave / units, ceil(W / 16), limit), at least 1.
//   * fp32: the heads body, a wave of 2 CTAs an SM, limit = cap (one
//     merge): the plan it had before the group body, so the same bits.
//   * bf16: the group body where 2 <= G <= 16 and D <= 128 (at G = 2 its
//     tensor-core tile still ran ahead of the heads body), or D = 256 and
//     the heads body's one-merge grid holds fewer CTAs than SMs (gemma3's
//     one long row: 48); a wave of 2 CTAs an SM.  Else the heads body at
//     1 CTA an SM (G = 1; gemma3's 8 rows, where the group's 64 KB merges
//     of 4 KB pieces cost more than reading its one kv head twice).
//     limit = cap, unless one merge covers less than half the SMs
//     (2 * units * cap < SMs): then cap^2, two merge levels.
//   Fewer, longer CTAs win at the serving shapes: each CTA pays the span's
//   loads and a piece's merge, round trips through L2 that the K/V stream
//   does not hide.  A concat-TP rank holding K / shards kv heads takes
//   the plan one device takes at the full K, so its pieces and merge
//   order, and its bits, are one device's.
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
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;
constexpr int kTileBytes = 8192;  // one K or one V tile (heads body)
constexpr int kRingBytes = kStages * 2 * kTileBytes;
constexpr int kMaxSplits = 32;    // pieces one merge stages, at most
constexpr int kMaxGT = 2;         // heads body
constexpr int kMaxGroup = 16;     // group body: two 8-head blocks
// a head keeps its reference max until a score passes it by this much
// (log2 units): its weights stay <= 2^8 and the rescale is rare
constexpr float kRescale = 8.f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;

enum Body { kHeads = 0, kGroup = 1 };

// the group body's ring: 32-slot tiles (8 KB of K up to D = 128 at
// 128 / 64 / 32 slots), 3 stages, 2 at D = 256
__host__ __device__ constexpr int group_stages(int D) {
  return D == 256 ? 2 : 3;
}
__host__ __device__ constexpr int group_tile_slots(int D) {
  return D >= 128 ? 32 : 8192 / (2 * D);
}
__host__ __device__ constexpr int ring_bytes(int body, int D) {
  return body == kGroup ? group_stages(D) * 2 * group_tile_slots(D) * D * 2
                        : kRingBytes;
}
// pieces one merge stages in the ring (decode_attention/ops.py's merge_cap)
__host__ __device__ constexpr int merge_cap(int body, int D, int GT) {
  return ring_bytes(body, D) / (GT * D * 4) < kMaxSplits
             ? ring_bytes(body, D) / (GT * D * 4)
             : kMaxSplits;
}
// merge groups of S splits, and the splits a group holds (the last fewer)
__host__ __device__ inline int merge_groups(int S, int cap) {
  return (S + cap - 1) / cap;
}
__host__ __device__ inline int group_len(int S, int cap) {
  const int ng = merge_groups(S, cap);
  return (S + ng - 1) / ng;
}

__device__ __forceinline__ void unpack(const uint4& r, float (&f)[4]) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !pred
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 16 : 0));
}
// 16 bytes global -> shared through L1: the CTAs of a row on one SM read
// its mask row once from L2
__device__ __forceinline__ void cp_async16_ca(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
// 4 bytes global -> shared (through L1: the only form of that size)
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 b16 matrices from shared memory (lane l: row l % 8 of matrix
// l / 8); .trans hands each lane a column pair instead of a row pair
__device__ __forceinline__ void ldsm_x4(unsigned addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(unsigned addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
// c += a b: m16n8k16 and m16n8k8, bf16 in, fp32 accumulate
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma1688(float (&c)[4], uint32_t a0,
                                        uint32_t a1, uint32_t b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}
// (x0, x1) as bf16 pairs hi = bf16(x), lo = bf16(x - hi), x0 in the low half
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// Scratch layout (repro_gqa_decode_scratch_bytes gives its size), NG merge
// groups a unit:
//   tickets  int32  [units][NG + 1], padded to 16 bytes, zero between calls
//   part_ml  float2 [units][S][GT]     (max, denominator), padded to 16 B
//   part_acc float  [units][S][GT][D]
//   grp_ml   float2 [units][NG][GT]    (NG > 1 only), padded to 16 B
//   grp_acc  float  [units][NG][GT][D] (NG > 1 only)
__host__ __device__ inline size_t pad16(size_t n) {
  return (n + 15) & ~size_t(15);
}
struct Layout {
  size_t ml, acc, grp_ml, grp_acc, total;
};
__host__ __device__ inline Layout scratch_layout(int units, int S, int GT,
                                                 int D, int NG) {
  const size_t u = static_cast<size_t>(units);
  const size_t ng = NG > 1 ? NG : 0;
  Layout l;
  l.ml = pad16(sizeof(int) * u * (NG + 1));
  l.acc = l.ml + pad16(sizeof(float2) * u * S * GT);
  l.grp_ml = l.acc + sizeof(float) * u * S * GT * D;
  l.grp_acc = l.grp_ml + pad16(sizeof(float2) * u * ng * GT);
  l.total = l.grp_acc + sizeof(float) * u * ng * GT * D;
  return l;
}

// True in the CTA that takes the last of n tickets at *t, which resets it.
// The barrier orders the CTA's partial writes before thread 0's release;
// the acquire makes every other CTA's writes visible to the last one.
__device__ __forceinline__ bool last_of(int* t, int n, int* s_flag) {
  __syncthreads();
  if (threadIdx.x == 0) {
    int ticket;
    asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;\n"
                 : "=r"(ticket) : "l"(t) : "memory");
    *s_flag = ticket == n - 1;
    if (*s_flag) *t = 0;  // ready for the next call
  }
  __syncthreads();
  return *s_flag;
}

// Merge n partials of gt heads in order, staged from L2 into `stage`:
// the output in q's type at out + row * D, or (out null) the merged
// partial at ml_dst / acc_dst.  s_sm (the maxima, then the weights) and
// s_sl hold n * gt floats.
template <typename T, int D>
__device__ void merge_pieces(const float2* ml, const float* acc, int n,
                             int gt, float* stage, float* s_sm, float* s_sl,
                             T* out, size_t row, float2* ml_dst,
                             float* acc_dst) {
  const int tid = threadIdx.x;
  for (int c = tid; c < n * gt * D / 4; c += kThreads)
    cp_async16(stage + 4 * c, acc + 4 * c, true);
  cp_async_commit();
  for (int i = tid; i < n * gt; i += kThreads) {
    const float2 v = __ldcg(ml + i);
    s_sm[i] = v.x;
    s_sl[i] = v.y;
  }
  // each head's max over the pieces, then each piece's weight, once
  __shared__ float s_mx[kMaxGroup];
  __syncthreads();
  for (int g = tid; g < gt; g += kThreads) {
    float mm = kMaskScore;
    for (int s = 0; s < n; ++s) mm = fmaxf(mm, s_sm[s * gt + g]);
    s_mx[g] = mm;
  }
  __syncthreads();
  for (int i = tid; i < n * gt; i += kThreads)
    s_sm[i] = exp2f(s_sm[i] - s_mx[i % gt]);
  cp_async_wait<0>();
  __syncthreads();
  for (int idx = tid; idx < gt * D; idx += kThreads) {
    const int g = idx / D, d = idx % D;
    const float mm = s_mx[g];
    float ll = 0.f, aa = 0.f;
    for (int s = 0; s < n; ++s) {
      const float w = s_sm[s * gt + g];
      ll += s_sl[s * gt + g] * w;
      aa += stage[(s * gt + g) * D + d] * w;
    }
    if (out != nullptr) {
      out[(row + g) * D + d] = from_float<T>(aa / fmaxf(ll, 1e-30f));
    } else {
      acc_dst[idx] = aa;
      if (d == 0) ml_dst[g] = make_float2(mm, ll);
    }
  }
}

// After a body: the warps' partials (s_m, s_l [warp][gt], wacc [warp][gt][D]
// in shared memory) merge in warp order into the CTA's piece, then the
// pieces merge in two levels (the header's "merge").
template <typename T, int D>
__device__ void finish(int body, int gt, const float* s_m, const float* s_l,
                       float* wacc, T* out, unsigned char* scratch, int b,
                       int H, int h0, int unit, int units, int split, int S,
                       float* s_sm, float* s_sl, int* s_flag) {
  const int tid = threadIdx.x;
  const int cap = merge_cap(body, D, gt);
  const int NG = merge_groups(S, cap), SG = group_len(S, cap);
  const Layout lay = scratch_layout(units, S, gt, D, NG);
  float2* part_ml = reinterpret_cast<float2*>(scratch + lay.ml);
  float* part_acc = reinterpret_cast<float*>(scratch + lay.acc);
  float2* grp_ml = reinterpret_cast<float2*>(scratch + lay.grp_ml);
  float* grp_acc = reinterpret_cast<float*>(scratch + lay.grp_acc);
  const size_t row = static_cast<size_t>(b) * H + h0;
  for (int idx = tid; idx < gt * D; idx += kThreads) {
    const int g = idx / D, d = idx % D;
    float mm = kMaskScore, ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, s_m[w * gt + g]);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = exp2f(s_m[w * gt + g] - mm);
      ll += s_l[w * gt + g] * wt;
      aa += wacc[(w * gt + g) * D + d] * wt;
    }
    if (S == 1) {
      out[(row + g) * D + d] = from_float<T>(aa / fmaxf(ll, 1e-30f));
    } else {
      part_acc[((size_t)unit * S + split) * gt * D + idx] = aa;
      if (d == 0)
        part_ml[((size_t)unit * S + split) * gt + g] = make_float2(mm, ll);
    }
  }
  if (S == 1) return;

  // level 1: the last CTA of this split's group merges the group
  const int grp = split / SG, first = grp * SG;
  const int n = min(S, first + SG) - first;
  int* tickets = reinterpret_cast<int*>(scratch) + (size_t)unit * (NG + 1);
  if (!last_of(tickets + grp, n, s_flag)) return;
  const size_t p0 = (size_t)unit * S + first;
  const size_t g0 = (size_t)unit * NG + grp;
  merge_pieces<T, D>(part_ml + p0 * gt, part_acc + p0 * gt * D, n, gt, wacc,
                     s_sm, s_sl, NG == 1 ? out : nullptr, row,
                     grp_ml + g0 * gt, grp_acc + g0 * gt * D);
  if (NG == 1) return;
  // level 2: the last group to finish merges the groups
  if (!last_of(tickets + NG, NG, s_flag)) return;
  merge_pieces<T, D>(grp_ml + (size_t)unit * NG * gt,
                     grp_acc + (size_t)unit * NG * gt * D, NG, gt, wacc,
                     s_sm, s_sl, out, row, nullptr, nullptr);
}

// The row's live span [lo, hi) and whether it has a valid slot (header:
// "Live span").  Dense: the mask row lands in aux, at offset moff.
template <bool PAGED>
__device__ __forceinline__ void find_span(const unsigned char* valid,
                                          const int* lengths,
                                          unsigned char* aux, int b, int W,
                                          int (*s_red)[kWarps], int& lo,
                                          int& hi, bool& row_any, int& moff) {
  const int tid = threadIdx.x;
  moff = 0;
  if (PAGED) {
    const int len = min(max(__ldg(lengths + b), 0), W);
    row_any = len > 0;
    lo = 0;
    hi = row_any ? len : W;
    return;
  }
  // stage the row's mask bytes, 16-byte aligned, into shared memory: every
  // copy in flight at once (one round trip to L2), then reduce
  const unsigned char* row = valid + (size_t)b * W;
  const uintptr_t a0 = reinterpret_cast<uintptr_t>(row) & ~uintptr_t(15);
  moff = static_cast<int>(reinterpret_cast<uintptr_t>(row) - a0);
  const int nchunk = (moff + W + 15) / 16;
  for (int c = tid; c < nchunk; c += kThreads)
    cp_async16_ca(aux + 16 * c, reinterpret_cast<const uint4*>(a0) + c);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  int first = W, last = -1;
  for (int c = tid; c < nchunk; c += kThreads) {
    const uint4 r = reinterpret_cast<const uint4*>(aux)[c];
    const unsigned char* by = reinterpret_cast<const unsigned char*>(&r);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int t = c * 16 + i - moff;
      if (t >= 0 && t < W && by[i]) {
        first = min(first, t);
        last = max(last, t);
      }
    }
  }
  first = __reduce_min_sync(kFull, first);
  last = __reduce_max_sync(kFull, last);
  if ((tid & 31) == 0) {
    s_red[0][tid >> 5] = first;
    s_red[1][tid >> 5] = last;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    first = min(first, s_red[0][w]);
    last = max(last, s_red[1][w]);
  }
  row_any = last >= 0;
  lo = row_any ? first : 0;
  hi = row_any ? last + 1 : W;
}

// The heads body: unit (b, kh, hg) = blockIdx.x, split s = blockIdx.y of S.
template <typename T, int D, int GT, bool PAGED>
__global__ void __launch_bounds__(kThreads, 4)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const unsigned char* __restrict__ valid,
              const int* __restrict__ tables, const int* __restrict__ lengths,
              T* __restrict__ out, unsigned char* __restrict__ scratch, int K,
              int G, int W, int bs, int M, float q_scale) {
  constexpr int EPC = 16 / sizeof(T);         // elements a 16-byte chunk
  constexpr int DPL = 2 * EPC;                // dims a lane
  constexpr int LPS = D / DPL;                // lanes a slot (a lane group)
  constexpr int GPW = 32 / LPS;               // lane groups a warp
  constexpr int GROUPS = kThreads / LPS;      // lane groups a CTA
  constexpr int SPG = 2;                      // slots a group takes a tile
  constexpr int WSLOTS = GPW * SPG;           // slots a warp owns a tile
  constexpr int TS = GROUPS * SPG;            // slots a tile
  constexpr int ROW_BYTES = D * sizeof(T);
  constexpr int ROW_CHUNKS = ROW_BYTES / 16;  // = 2 * LPS
  // a copy step of a warp covers RPC rows (rows of at most 32 chunks) or a
  // row takes CPL steps (fp32 D = 256: 64 chunks, 2 steps)
  constexpr int RPC = ROW_CHUNKS <= 32 ? 32 / ROW_CHUNKS : 1;
  constexpr int CPL = ROW_CHUNKS <= 32 ? 1 : ROW_CHUNKS / 32;
  constexpr int COPIES = WSLOTS * CPL / RPC;  // copy steps a tile, K and V
  static_assert(TS * ROW_BYTES == kTileBytes, "a tile is 8 KB");
  static_assert(LPS >= 1 && LPS <= 32 && (LPS & (LPS - 1)) == 0, "LPS");
  static_assert(kWarps * GT * D * 4 <= kRingBytes, "warp merge fits");
  static_assert(merge_cap(kHeads, D, GT) >= 1, "a merge stages a piece");

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* aux = smem + kRingBytes;  // dense: mask row; paged: blocks
  int* tbl = reinterpret_cast<int*>(aux);
  __shared__ float s_m[kWarps * GT], s_l[kWarps * GT];
  __shared__ float s_sm[kMaxSplits * GT], s_sl[kMaxSplits * GT];
  __shared__ int s_red[2][kWarps];
  __shared__ int s_flag;

  const int n_hg = G / GT;
  const int unit = blockIdx.x;
  const int hg = unit % n_hg;
  const int kh = (unit / n_hg) % K;
  const int b = unit / (n_hg * K);
  const int split = blockIdx.y;
  const int S = gridDim.y;
  const int H = K * G;
  const int h0 = kh * G + hg * GT;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int grp = tid / LPS;  // this lane's group
  const int j = tid % LPS;    // the lane's place in its group

  // paged: the row's block ids, in flight beside q and the length, so
  // that no load waits on the length (clamped at 0 where they are used)
  if (PAGED) {
    for (int i = tid; i < M; i += kThreads)
      cp_async4(tbl + i, tables + (size_t)b * M + i);
    cp_async_commit();
  }

  // q first: its loads land while the span is found.  Lane j owns chunks
  // j and j + LPS of each row (conflict-free shared-memory reads later).
  // q carries log2(e) / sqrt(D): scores come out in log2 units for exp2f.
  float qf[GT][DPL];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    const uint4* qr =
        reinterpret_cast<const uint4*>(q + ((size_t)b * H + h0 + g) * D);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float f[EPC];
      unpack(__ldg(qr + c * LPS + j), f);
#pragma unroll
      for (int e = 0; e < EPC; ++e) qf[g][c * EPC + e] = f[e] * q_scale;
    }
  }

  int lo, hi, moff;
  bool row_any;
  find_span<PAGED>(valid, lengths, aux, b, W, s_red, lo, hi, row_any, moff);
  const unsigned char* mask = aux + moff;  // dense: mask[t] for t in [0, W)

  // -- this split's piece [t0, t1) of the span ------------------------------
  const long long n = hi - lo;
  const int t0 = lo + static_cast<int>((split * n) / S);
  const int t1 = lo + static_cast<int>(((split + 1) * n) / S);
  if (PAGED) {  // the block ids are in shared memory
    cp_async_wait<0>();
    __syncthreads();
  }

  // -- the ring ---------------------------------------------------------------
  // Warp w owns rows [w * WSLOTS, +WSLOTS) of every tile: it copies them
  // (lane: 16-byte chunk lane % ROW_CHUNKS of rows lane / ROW_CHUNKS +
  // c * RPC) and its lane groups compute them (group g of the warp: rows
  // u * GPW + g), so a warp waits on no other warp: __syncwarp, not
  // __syncthreads.  Slot row i of k starts at element i * K * D + kh * D.
  const int KD = K * D;
  const T* kb = k + (size_t)kh * D + (lane % ROW_CHUNKS) * EPC;
  const T* vb = v + (size_t)kh * D + (lane % ROW_CHUNKS) * EPC;
  const size_t row0 = PAGED ? 0 : (size_t)b * W;  // dense: slot t is row row0 + t
  const int wrow = warp * WSLOTS;
  const int ntiles = (t1 - t0 + TS - 1) / TS;
  auto issue = [&](int tile) {
    unsigned char* st = smem + (tile % kStages) * 2 * kTileBytes;
#pragma unroll
    for (int c = 0; c < COPIES; ++c) {
      const int r = wrow + lane / ROW_CHUNKS + (c / CPL) * RPC;
      const int part = (c % CPL) * 32;  // the row's chunks past the first 32
      const int t = t0 + tile * TS + r;
      bool use = t < t1;
      size_t row = 0;
      if (use) {
        if (PAGED) {
          const int blk = t / bs;
          row = (size_t)max(tbl[blk], 0) * bs + (t - blk * bs);
        } else {
          use = !row_any || mask[t];
          row = row0 + t;
        }
      }
      const size_t off = use ? row * KD : 0;
      unsigned char* dst =
          st + r * ROW_BYTES + (lane % ROW_CHUNKS + part) * 16;
      cp_async16(dst, kb + off + part * EPC, use);
      cp_async16(dst + kTileBytes, vb + off + part * EPC, use);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles) issue(s);
    cp_async_commit();
  }

  float m[GT], l[GT], acc[GT][DPL];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = kMaskScore;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[g][e] = 0.f;
  }

  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<kStages - 2>();
    __syncwarp();  // the warp's rows of tile it landed; tile it-1 is consumed
    if (it + kStages - 1 < ntiles) issue(it + kStages - 1);
    cp_async_commit();

    // scores of the group's SPG slots, two FFMA chains each
    const unsigned char* st = smem + (it % kStages) * 2 * kTileBytes;
    float part[SPG][GT];
    bool use[SPG], masked[SPG];
    int rows[SPG];
#pragma unroll
    for (int u = 0; u < SPG; ++u) {
      rows[u] = wrow + u * GPW + grp % GPW;
      const int t = t0 + it * TS + rows[u];
      use[u] = t < t1;
      masked[u] = !row_any;
      if (!PAGED && use[u]) {
        masked[u] = !mask[t];
        use[u] = !masked[u] || !row_any;
      }
      const uint4* kr = reinterpret_cast<const uint4*>(st + rows[u] * ROW_BYTES);
      float a0[GT], a1[GT];
#pragma unroll
      for (int g = 0; g < GT; ++g) a0[g] = a1[g] = 0.f;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float f[EPC];
        unpack(kr[c * LPS + j], f);
#pragma unroll
        for (int g = 0; g < GT; ++g)
#pragma unroll
          for (int e = 0; e < EPC; e += 2) {
            a0[g] += qf[g][c * EPC + e] * f[e];
            a1[g] += qf[g][c * EPC + e + 1] * f[e + 1];
          }
      }
#pragma unroll
      for (int g = 0; g < GT; ++g) part[u][g] = a0[g] + a1[g];
    }
#pragma unroll
    for (int o = LPS / 2; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < SPG; ++u)
#pragma unroll
        for (int g = 0; g < GT; ++g)
          part[u][g] += __shfl_xor_sync(kFull, part[u][g], o);

    // weights against the group's reference max, rescaled only when a
    // score passes it by kRescale
    float p[SPG][GT];
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float sc[SPG], mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < SPG; ++u) {
        sc[u] = !use[u] ? -INFINITY : (masked[u] ? kMaskScore : part[u][g]);
        mx = fmaxf(mx, sc[u]);
      }
      if (mx > m[g] + kRescale) {
        const float corr = exp2f(m[g] - mx);
        l[g] *= corr;
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[g][e] *= corr;
        m[g] = mx;
      }
#pragma unroll
      for (int u = 0; u < SPG; ++u) {
        p[u][g] = exp2f(sc[u] - m[g]);
        l[g] += p[u][g];
      }
    }
#pragma unroll
    for (int u = 0; u < SPG; ++u) {
      const uint4* vr =
          reinterpret_cast<const uint4*>(st + kTileBytes + rows[u] * ROW_BYTES);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float f[EPC];
        unpack(vr[c * LPS + j], f);
#pragma unroll
        for (int g = 0; g < GT; ++g)
#pragma unroll
          for (int e = 0; e < EPC; ++e) acc[g][c * EPC + e] += p[u][g] * f[e];
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: reuse it for the merges

  // -- merge the lane groups in each warp by shuffles (a fixed tree), then
  // -- hand the warps' partials to finish()
#pragma unroll
  for (int o = LPS; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const float om = __shfl_xor_sync(kFull, m[g], o);
      const float ol = __shfl_xor_sync(kFull, l[g], o);
      const float mm = fmaxf(m[g], om);
      const float wa = exp2f(m[g] - mm), wb = exp2f(om - mm);
      l[g] = l[g] * wa + ol * wb;
#pragma unroll
      for (int e = 0; e < DPL; ++e)
        acc[g][e] = acc[g][e] * wa + __shfl_xor_sync(kFull, acc[g][e], o) * wb;
      m[g] = mm;
    }
  }
  float* wacc = reinterpret_cast<float*>(smem);  // [kWarps][GT][D]
  if (lane < LPS) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      if (j == 0) {
        s_m[warp * GT + g] = m[g];
        s_l[warp * GT + g] = l[g];
      }
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int e = 0; e < EPC; e += 4)
          *reinterpret_cast<float4*>(
              wacc + (warp * GT + g) * D + (c * LPS + j) * EPC + e) =
              make_float4(acc[g][c * EPC + e], acc[g][c * EPC + e + 1],
                          acc[g][c * EPC + e + 2], acc[g][c * EPC + e + 3]);
    }
  }
  __syncthreads();
  finish<T, D>(kHeads, GT, s_m, s_l, wacc, out, scratch, b, H, h0, unit,
               gridDim.x, split, S, s_sm, s_sl, &s_flag);
}

// chunk c of slot row r in the group body's swizzled tiles: rows of at
// least 8 chunks XOR c with r % 8, rows of 4 (D = 32) with (r / 2) % 4, so
// the eight rows an ldmatrix reads sit in eight different bank groups
template <int ROW_CHUNKS>
__device__ __forceinline__ int swz(int r, int c) {
  return ROW_CHUNKS >= 8 ? c ^ (r & 7) : c ^ ((r >> 1) & 3);
}

// The group body (bf16): unit (b, kh) = blockIdx.x, split s = blockIdx.y of
// S, all G <= 16 query heads of kv head kh; NB 8-head blocks (G <= 8: 1).
template <int D, int NB, bool PAGED>
__global__ void __launch_bounds__(kThreads, 2)
group_kernel(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v,
             const unsigned char* __restrict__ valid,
             const int* __restrict__ tables, const int* __restrict__ lengths,
             __nv_bfloat16* __restrict__ out, unsigned char* __restrict__ scratch,
             int K, int G, int W, int bs, int M, float q_scale) {
  using T = __nv_bfloat16;
  constexpr int STAGES = group_stages(D);
  constexpr int TS = group_tile_slots(D);      // slots a tile
  constexpr int ROW_BYTES = D * 2;
  constexpr int ROW_CHUNKS = ROW_BYTES / 16;   // 4 .. 32
  constexpr int TILE = TS * ROW_BYTES;         // one K or one V tile
  constexpr int RING = STAGES * 2 * TILE;
  constexpr int WROWS = TS / kWarps;           // slots a warp owns a tile
  constexpr int CHUNKS = WROWS / 8;            // its 8-slot chunks
  constexpr int COPIES = WROWS * ROW_CHUNKS / 32;  // copies a lane, K and V
  constexpr int KSTEPS = D / 16;               // k steps of Q K^T
  constexpr int MT = D / 16;                   // 16-dim tiles of O^T
  static_assert(RING == ring_bytes(kGroup, D), "the ring");
  static_assert(WROWS % 8 == 0 && COPIES >= 1 &&
                    (WROWS * ROW_CHUNKS) % 32 == 0, "a warp's rows");
  static_assert(kWarps * kMaxGroup * D * 4 <= RING, "warp merge fits");
  static_assert(NB == 1 || NB == 2, "NB");

  extern __shared__ __align__(128) unsigned char gsm[];
  unsigned char* const smem = gsm;
  unsigned char* aux = smem + RING;  // dense: mask row; paged: blocks
  int* tbl = reinterpret_cast<int*>(aux);
  __shared__ float s_m[kWarps * kMaxGroup], s_l[kWarps * kMaxGroup];
  __shared__ float s_sm[kMaxSplits * kMaxGroup], s_sl[kMaxSplits * kMaxGroup];
  __shared__ int s_red[2][kWarps];
  __shared__ int s_flag;

  const int unit = blockIdx.x;
  const int kh = unit % K;
  const int b = unit / K;
  const int split = blockIdx.y;
  const int S = gridDim.y;
  const int H = K * G;
  const int h0 = kh * G;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;  // the mma fragments' row, pair

  if (PAGED) {
    for (int i = tid; i < M; i += kThreads)
      cp_async4(tbl + i, tables + (size_t)b * M + i);
    cp_async_commit();
  }

  // Q as the A operand of m16n8k16: rows gq and gq + 8 (head; zero past G
  // and, at NB = 1, at gq + 8), dims 16 kk + 2 tq (+1) and (+8, +9)
  uint32_t qa[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = gq + (i & 1) * 8;
      const int col = 16 * kk + 2 * tq + (i >> 1) * 8;
      qa[kk][i] = (NB == 2 || (i & 1) == 0) && r < G
                      ? __ldg(reinterpret_cast<const unsigned int*>(
                            q + ((size_t)b * H + h0 + r) * D + col))
                      : 0u;
    }

  int lo, hi, moff;
  bool row_any;
  find_span<PAGED>(valid, lengths, aux, b, W, s_red, lo, hi, row_any, moff);
  const unsigned char* mask = aux + moff;

  const long long n = hi - lo;
  const int t0 = lo + static_cast<int>((split * n) / S);
  const int t1 = lo + static_cast<int>(((split + 1) * n) / S);
  if (PAGED) {
    cp_async_wait<0>();
    __syncthreads();
  }

  // Warp w owns rows [w * WROWS, +WROWS) of every tile, copies them (lane:
  // chunk (lane + 32 c) % ROW_CHUNKS of row (lane + 32 c) / ROW_CHUNKS) and
  // computes them eight slots at a time.
  const int KD = K * D;
  const T* kb = k + (size_t)kh * D;
  const T* vb = v + (size_t)kh * D;
  const size_t row0 = PAGED ? 0 : (size_t)b * W;
  const int wrow = warp * WROWS;
  const int ntiles = (t1 - t0 + TS - 1) / TS;
  auto issue = [&](int tile) {
    unsigned char* st = smem + (tile % STAGES) * 2 * TILE;
#pragma unroll
    for (int c = 0; c < COPIES; ++c) {
      const int i = lane + 32 * c;
      const int r = wrow + i / ROW_CHUNKS, ch = i % ROW_CHUNKS;
      const int t = t0 + tile * TS + r;
      bool use = t < t1;
      size_t row = 0;
      if (use) {
        if (PAGED) {
          const int blk = t / bs;
          row = (size_t)max(tbl[blk], 0) * bs + (t - blk * bs);
        } else {
          use = !row_any || mask[t];
          row = row0 + t;
        }
      }
      const size_t off = use ? row * KD + ch * 8 : 0;
      unsigned char* dst = st + r * ROW_BYTES + swz<ROW_CHUNKS>(r, ch) * 16;
      cp_async16(dst, kb + off, use);
      cp_async16(dst + TILE, vb + off, use);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles) issue(s);
    cp_async_commit();
  }

  // rows gq (i = 0) and gq + 8 (i = 1): the reference max (the same in a
  // quad) and this lane's share of the denominator; O^T (dim 16 mt + gq
  // (+8), head 8 i + 2 tq (+1)) in mma accumulator order
  float m[2] = {kMaskScore, kMaskScore}, l[2] = {0.f, 0.f};
  float acc[MT][NB][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < NB; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][i][e] = 0.f;

  const int lrow = lane & 7;  // the ldmatrix row this lane addresses
  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncwarp();
    if (it + STAGES - 1 < ntiles) issue(it + STAGES - 1);
    cp_async_commit();
    const unsigned kbase = static_cast<unsigned>(
        __cvta_generic_to_shared(smem + (it % STAGES) * 2 * TILE));
#pragma unroll
    for (int ch = 0; ch < CHUNKS; ++ch) {
      const int r0 = wrow + ch * 8;
      const int tbase = t0 + it * TS + r0;
      if (tbase >= t1) break;  // the warp's remaining rows lie past the piece
      const int r = r0 + lrow;
      // S = Q K^T for the chunk's 8 slots: c[2i + u] is (head gq + 8 i,
      // slot tbase + 2 tq + u)
      float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int jj = 0; jj < D / 32; ++jj) {
        uint32_t kf[4];
        ldsm_x4(kbase + r * ROW_BYTES +
                    swz<ROW_CHUNKS>(r, 4 * jj + (lane >> 3)) * 16,
                kf);
        mma16816(c, qa[2 * jj], kf[0], kf[1]);
        mma16816(c, qa[2 * jj + 1], kf[2], kf[3]);
      }
      float sc[2][2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int t = tbase + 2 * tq + u;
        bool use = t < t1, masked = !row_any;
        if (!PAGED && use) {
          masked = !mask[t];
          use = !masked || !row_any;
        }
#pragma unroll
        for (int i = 0; i < NB; ++i)
          sc[i][u] = !use ? -INFINITY
                          : (masked ? kMaskScore : c[2 * i + u] * q_scale);
      }
      // weights against each head's reference max, rescaled only when a
      // score passes it by kRescale; P^T as bf16 hi and lo B fragments
      float corr[2] = {1.f, 1.f};
      uint32_t phi[NB], plo[NB];
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        float mx = fmaxf(sc[i][0], sc[i][1]);
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
        if (mx > m[i] + kRescale) {
          corr[i] = exp2f(m[i] - mx);
          l[i] *= corr[i];
          m[i] = mx;
        }
        const float p0 = exp2f(sc[i][0] - m[i]), p1 = exp2f(sc[i][1] - m[i]);
        l[i] += p0;
        l[i] += p1;
        split_bf16(p0, p1, phi[i], plo[i]);
      }
      if (__any_sync(kFull, corr[0] != 1.f || corr[1] != 1.f)) {
        // O^T's heads 8 i + 2 tq (+1) take the corrections of rows 2 tq
        // (+1), held by lanes 8 tq (+4)
#pragma unroll
        for (int i = 0; i < NB; ++i) {
          const float c0 = __shfl_sync(kFull, corr[i], 8 * tq);
          const float c1 = __shfl_sync(kFull, corr[i], 8 * tq + 4);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            acc[mt][i][0] *= c0;
            acc[mt][i][1] *= c1;
            acc[mt][i][2] *= c0;
            acc[mt][i][3] *= c1;
          }
        }
      }
      // O^T += V^T P^T: V^T's 16-dim tiles by ldmatrix.trans, k = 8 slots
#pragma unroll
      for (int jj = 0; jj < D / 32; ++jj) {
        uint32_t vf[4];
        ldsm_x4_t(kbase + TILE + r * ROW_BYTES +
                      swz<ROW_CHUNKS>(r, 4 * jj + (lane >> 3)) * 16,
                  vf);
#pragma unroll
        for (int i = 0; i < NB; ++i) {
          mma1688(acc[2 * jj][i], vf[0], vf[1], phi[i]);
          mma1688(acc[2 * jj][i], vf[0], vf[1], plo[i]);
          mma1688(acc[2 * jj + 1][i], vf[2], vf[3], phi[i]);
          mma1688(acc[2 * jj + 1][i], vf[2], vf[3], plo[i]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: reuse it for the merges

  // the warp's partial: denominators summed over the quad (the same bits
  // in each of its lanes), then [warp][head][dim] in shared memory
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    l[i] += __shfl_xor_sync(kFull, l[i], 1);
    l[i] += __shfl_xor_sync(kFull, l[i], 2);
  }
  float* wacc = reinterpret_cast<float*>(smem);  // [kWarps][G][D]
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    const int h = gq + 8 * i;
    if (tq == 0 && h < G) {
      s_m[warp * G + h] = m[i];
      s_l[warp * G + h] = l[i];
    }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < NB; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = 8 * i + 2 * tq + (e & 1);
        const int d = 16 * mt + gq + 8 * (e >> 1);
        if (h < G) wacc[(warp * G + h) * D + d] = acc[mt][i][e];
      }
  __syncthreads();
  finish<T, D>(kGroup, G, s_m, s_l, wacc, out, scratch, b, H, h0, unit,
               gridDim.x, split, S, s_sm, s_sl, &s_flag);
}

// dynamic shared memory: the body's ring, then the dense mask row (16-byte
// aligned window) or the paged row's M block ids
size_t smem_bytes(int body, int D, bool paged, int W, int M) {
  return ring_bytes(body, D) +
         pad16(paged ? sizeof(int) * (size_t)M : (size_t)W + 15);
}

struct Args {
  const void *q, *k, *v, *valid, *tables, *lengths;
  void *out, *scratch;
  int units, K, G, W, S, bs, M;
  cudaStream_t stream;
};

// Launch a body's instantiation on the grid (units, S), raising its
// shared-memory limit above the 48 KB default once per device (allowed:
// the instantiation's own record).
template <typename T, typename F>
cudaError_t launch(F kernel, int body, int D, bool paged, const Args& a,
                   size_t (&allowed)[kMaxDevices]) {
  const size_t smem = smem_bytes(body, D, paged, a.W, a.M);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || smem > allowed[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) allowed[dev] = smem;
  }
  kernel<<<dim3(a.units, a.S), kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const unsigned char*>(a.valid),
      static_cast<const int*>(a.tables), static_cast<const int*>(a.lengths),
      static_cast<T*>(a.out), static_cast<unsigned char*>(a.scratch), a.K,
      a.G, a.W, a.bs, a.M, 1.4426950408889634f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

template <typename T, int D, int GT, bool PAGED>
cudaError_t launch_heads(const Args& a) {
  static size_t allowed[kMaxDevices] = {};
  return launch<T>(decode_kernel<T, D, GT, PAGED>, kHeads, D, PAGED, a,
                   allowed);
}

template <int D, int NB, bool PAGED>
cudaError_t launch_group(const Args& a) {
  static size_t allowed[kMaxDevices] = {};
  return launch<__nv_bfloat16>(group_kernel<D, NB, PAGED>, kGroup, D, PAGED,
                               a, allowed);
}

template <typename T, int D, bool PAGED>
cudaError_t launch_d(int body, int GT, const Args& a) {
  if (body == kGroup) {
    if constexpr (sizeof(T) == 2)
      return a.G > 8 ? launch_group<D, 2, PAGED>(a)
                     : launch_group<D, 1, PAGED>(a);
    return cudaErrorInvalidValue;
  }
  return GT == 2 ? launch_heads<T, D, 2, PAGED>(a)
                 : launch_heads<T, D, 1, PAGED>(a);
}

template <typename T, bool PAGED>
cudaError_t launch_t(int D, int body, int GT, const Args& a) {
  switch (D) {
    case 32:
      return launch_d<T, 32, PAGED>(body, GT, a);
    case 64:
      return launch_d<T, 64, PAGED>(body, GT, a);
    case 128:
      return launch_d<T, 128, PAGED>(body, GT, a);
    case 256:
      return launch_d<T, 256, PAGED>(body, GT, a);
    default:
      return cudaErrorInvalidValue;
  }
}

bool valid_plan(int dtype, int body, int H, int K, int D, int GT,
                int n_split) {
  if (K <= 0 || H % K != 0 || n_split <= 0 || D <= 0) return false;
  const int G = H / K;
  if (body == kGroup) {
    if (dtype != 1 || GT != G || G > kMaxGroup) return false;
  } else if (body != kHeads || (GT != 1 && GT != kMaxGT) || G % GT != 0) {
    return false;
  }
  const int cap = merge_cap(body, D, GT);
  return cap >= 1 && n_split <= cap * cap;
}

}  // namespace

// Plain C entry point.  dtype: 0 = float32, 1 = bfloat16.  paged = 0 reads
// k/v as (B, W, K, D) caches masked by valid (B, W) bool; paged = 1 reads
// them as (P, bs, K, D) pools through tables (B, M) and lengths (B,),
// W = M * bs.  D is 32, 64, 128 or 256.  The plan: body 0 (heads: GT = 1
// or 2 query heads a CTA, dividing H / K) or 1 (group, bf16: GT = H / K <=
// 16), n_split pieces per row (1 .. cap^2, cap = merge_cap(body, D, GT)).
// scratch: scratch_bytes bytes laid out as above, its tickets zero; the
// kernel leaves them zero.  Returns the launch's cudaError_t.
extern "C" size_t repro_gqa_decode_scratch_bytes(int body, int B, int H,
                                                  int D, int GT,
                                                  int n_split) {
  if (B <= 0 || H <= 0 || D <= 0 || GT <= 0 || n_split <= 0 ||
      merge_cap(body, D, GT) < 1)
    return 0;
  const int units = B * (H / GT);
  const int NG = merge_groups(n_split, merge_cap(body, D, GT));
  return scratch_layout(units, n_split, GT, D, NG).total;
}

extern "C" int repro_gqa_decode(int paged, int dtype, int body, const void* q,
                                const void* k, const void* v,
                                const void* valid, const void* tables,
                                const void* lengths, void* out, void* scratch,
                                long long scratch_size, int B, int H, int K,
                                int D, int W, int GT, int n_split, int bs,
                                int M, void* stream) {
  if (B <= 0 || W <= 0 || bs <= 0 ||
      !valid_plan(dtype, body, H, K, D, GT, n_split) ||
      static_cast<size_t>(scratch_size) <
          repro_gqa_decode_scratch_bytes(body, B, H, D, GT, n_split))
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = H / K;
  Args a{q,   k,       v, valid, tables, lengths, out, scratch,
         B * K * (G / GT), K, G, W, n_split, bs, M,
         static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  if (dtype == 0)
    err = paged ? launch_t<float, true>(D, body, GT, a)
                : launch_t<float, false>(D, body, GT, a);
  else if (dtype == 1)
    err = paged ? launch_t<__nv_bfloat16, true>(D, body, GT, a)
                : launch_t<__nv_bfloat16, false>(D, body, GT, a);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
