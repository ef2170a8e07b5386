// GQA flash-decoding for Hopper (sm_90a): one query token per sequence
// attends over a dense ring-buffer KV cache or a block-paged KV pool.
//
// Replaces the Pallas TPU kernels
//   gqa_decode        src/repro/kernels/decode_attention/decode_attention.py:135
//                     (body _kernel :23)
//   gqa_decode_paged  src/repro/kernels/decode_attention/decode_attention.py:91
//                     (body _paged_kernel :54)
// and this file's first version, which split W (not the live span) evenly,
// so that at the serving shapes ~2/3 of its CTAs held no valid slot; put a
// per-slot index load (the mask byte, the block-table entry) in front of
// every K/V load; kept ~8 KB of K/V in flight per CTA; and merged the
// splits in a second launch.
//
// What bounds it on the H100: bytes.  Each attended slot costs 2*K*D*2 B of
// K+V (bf16) for 4*H*D flops, about one flop per byte, far under the card's
// ~295 flop/byte ridge.  The least time is the valid K/V bytes over
// 3.35 TB/s: 18.5 MB, 5.5 us, for 8 rows of ~560 slots at 8 kv heads of
// 128.  At that size the kernel is also a chain of latencies: launch, the
// span's loads, the K/V stream, the merge's round trips through L2.
//
// The design:
//   * Work unit: one CTA of 128 threads per (row b, kv head kh, group of
//     GT = 2 query heads (1 for odd G), split s).  A kv head's slot row is
//     D*2 = 256 B, eight full 32-byte sectors; q and the accumulators of
//     the GT heads stay in registers.  The grid depends on shapes alone:
//     units = B*K*G/GT, S = min(2 * SMs / units, ceil(W / 16), cap) (the
//     wrapper's decode_grid): one wave, so a CUDA graph replays the launch.
//     The cap is max_splits(D, GT) = min(32, kRingBytes / (GT*D*4)): the
//     last CTA merges the S pieces' accumulators in the ring's 48 KB, so
//     D = 256 at GT = 2 takes at most 24 splits (32 everywhere else).
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
//   * Ring: K and V tiles of TS slots (8 KB each: TS = 32 at bf16 D = 128,
//     16 at bf16 D = 256, 8 at fp32 D = 256, whose 1 KB rows take a warp
//     two copy steps each) in a 3-stage shared-memory ring filled by
//     cp.async 16-byte copies
//     (L2 only) with commit groups: tiles s+1 and s+2 are in flight while
//     tile s is computed.  Each warp copies and computes only its own rows
//     of a tile, so the loop has no CTA barrier.  No K/V copy waits on a
//     per-slot index load: a paged CTA loads its row's block-table
//     entries into shared memory once, beside q and the length; a dense
//     CTA already holds its mask row.  An invalid slot inside the span of
//     a row that has a valid one is zero-filled, not read.
//   * Compute from shared memory in fp32 FFMA, no tensor cores: G = 2 query
//     rows give mma nothing to fill, and the reference's P.V is fp32.  A
//     slot is LPS = D / DPL lanes (DPL = 16 bf16 / 8 fp32 dims a lane, two
//     16-byte chunks, conflict-free at D = 128) and a lane group takes two
//     slots a tile; scores reduce over log2(LPS) shuffles.  A lane holds
//     DPL dims whatever D is, so D = 256 only widens the lane group (LPS 16
//     bf16, 32 fp32) and costs no registers.  q carries
//     log2(e) / sqrt(D), so weights are exp2f of the score; a group keeps
//     its reference max until a score passes it by 8 (log2 units), so the
//     accumulators are rescaled rarely, not every slot.  The groups merge
//     by shuffles within a warp, then the 4 warps through shared memory.
//   * One launch: each CTA of a split row writes its (max, denominator,
//     accumulator) to scratch; the last CTA of a unit to finish (an atomic
//     ticket in the same scratch, which it resets for the next call) merges
//     the S pieces in split order and writes the output.  Fixed orders
//     throughout, so two calls give the same bits.  With S = 1 the CTA
//     writes the output itself.  (A cluster of the S pieces merging in
//     distributed shared memory measured slower: PERF.md.)
//
// Semantics (the reference's): scores q.k / sqrt(D) in fp32, invalid slots
// -1e30, online softmax in fp32, P.V in fp32, output acc / max(l, 1e-30) in
// q's type.  Paged: logical slot t of row b lives in pool block
// block_tables[b, t/bs] (-1 clamped to block 0) at offset t % bs, valid iff
// t < lengths[b].

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kMaskScore = -1e30f;
constexpr int kThreads = 128;
constexpr int kStages = 3;
constexpr int kTileBytes = 8192;  // one K or one V tile
constexpr int kRingBytes = kStages * 2 * kTileBytes;
constexpr int kMaxSplits = 32;
constexpr int kMaxGT = 2;
// a group keeps its reference max until a score passes it by this much
// (log2 units): its weights stay <= 2^8 and the rescale is rare
constexpr float kRescale = 8.f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;

// the most splits of a row: the last CTA's merge holds S x GT x D fp32
// accumulators in the ring (decode_attention/ops.py's max_splits)
__host__ __device__ constexpr int max_splits(int D, int GT) {
  return kRingBytes / (GT * D * 4) < kMaxSplits ? kRingBytes / (GT * D * 4)
                                                : kMaxSplits;
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
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Scratch layout (repro_gqa_decode_scratch_bytes gives its size):
//   tickets  int32  [units], padded to 16 bytes, zero between calls
//   part_ml  float2 [units][S][GT]     (max, denominator), padded to 16 B
//   part_acc float  [units][S][GT][D]
__host__ __device__ inline size_t pad16(size_t n) {
  return (n + 15) & ~size_t(15);
}
__host__ __device__ inline size_t ml_offset(int units) {
  return pad16(sizeof(int) * (size_t)units);
}
__host__ __device__ inline size_t acc_offset(int units, int S, int GT) {
  return ml_offset(units) + pad16(sizeof(float2) * (size_t)units * S * GT);
}

// One CTA: unit (b, kh, hg) = blockIdx.x, split s = blockIdx.y of S.
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
  static_assert(kThreads / 32 * GT * D * 4 <= kRingBytes, "warp merge fits");
  static_assert(max_splits(D, GT) >= 1 &&
                    max_splits(D, GT) * GT * D * 4 <= kRingBytes,
                "split merge fits the ring");

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* aux = smem + kRingBytes;  // dense: mask row; paged: blocks
  int* tbl = reinterpret_cast<int*>(aux);
  __shared__ float s_m[(kThreads / 32) * GT], s_l[(kThreads / 32) * GT];
  __shared__ float s_sm[kMaxSplits * kMaxGT], s_sl[kMaxSplits * kMaxGT];
  __shared__ int s_red[2][kThreads / 32];
  __shared__ int s_last;

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

  // paged: the row's block ids, loaded beside q and the length, so that no
  // load waits on the length
  if (PAGED)
    for (int i = tid; i < M; i += kThreads)
      tbl[i] = max(__ldg(tables + (size_t)b * M + i), 0);

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

  // -- the row's live span [lo, hi) ----------------------------------------
  int lo, hi, moff = 0;
  bool row_any;
  if (PAGED) {
    const int len = min(max(__ldg(lengths + b), 0), W);
    row_any = len > 0;
    lo = 0;
    hi = row_any ? len : W;
  } else {
    // stage the row's mask bytes, 16-byte aligned, into shared memory
    const unsigned char* row = valid + (size_t)b * W;
    const uintptr_t a0 = reinterpret_cast<uintptr_t>(row) & ~uintptr_t(15);
    moff = static_cast<int>(reinterpret_cast<uintptr_t>(row) - a0);
    const int nchunk = (moff + W + 15) / 16;
    int first = W, last = -1;
    for (int c = tid; c < nchunk; c += kThreads) {
      const uint4 r = __ldg(reinterpret_cast<const uint4*>(a0) + c);
      reinterpret_cast<uint4*>(aux)[c] = r;
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
    for (int w = 0; w < kThreads / 32; ++w) {
      first = min(first, s_red[0][w]);
      last = max(last, s_red[1][w]);
    }
    row_any = last >= 0;
    lo = row_any ? first : 0;
    hi = row_any ? last + 1 : W;
  }
  const unsigned char* mask = aux + moff;  // dense: mask[t] for t in [0, W)

  // -- this split's piece [t0, t1) of the span ------------------------------
  const long long n = hi - lo;
  const int t0 = lo + static_cast<int>((split * n) / S);
  const int t1 = lo + static_cast<int>(((split + 1) * n) / S);
  if (PAGED) __syncthreads();  // the block ids are in shared memory

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
          row = (size_t)tbl[blk] * bs + (t - blk * bs);
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

  // -- merge the lane groups: in each warp by shuffles (a fixed tree), then
  // -- the warps through shared memory, in warp order
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
  constexpr int WARPS = kThreads / 32;
  float* wacc = reinterpret_cast<float*>(smem);  // [WARPS][GT][D]
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

  unsigned char* scr = scratch;
  const int units = gridDim.x;
  float2* part_ml = reinterpret_cast<float2*>(scr + ml_offset(units));
  float* part_acc = reinterpret_cast<float*>(scr + acc_offset(units, S, GT));
  for (int idx = tid; idx < GT * D; idx += kThreads) {
    const int g = idx / D, d = idx % D;
    float mm = kMaskScore, ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mm = fmaxf(mm, s_m[w * GT + g]);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float wt = exp2f(s_m[w * GT + g] - mm);
      ll += s_l[w * GT + g] * wt;
      aa += wacc[(w * GT + g) * D + d] * wt;
    }
    if (S == 1) {
      out[((size_t)b * H + h0 + g) * D + d] =
          from_float<T>(aa / fmaxf(ll, 1e-30f));
    } else {
      part_acc[((size_t)unit * S + split) * GT * D + idx] = aa;
      if (d == 0)
        part_ml[((size_t)unit * S + split) * GT + g] = make_float2(mm, ll);
    }
  }
  if (S == 1) return;

  // -- the last CTA of the unit merges the S pieces, in split order -----------
  __syncthreads();
  if (tid == 0) {
    // release: publishes the CTA's partial (its writes precede this through
    // the barrier); acquire: the last CTA then sees every other piece
    int* ticket_ptr = reinterpret_cast<int*>(scr) + unit;
    int ticket;
    asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;\n"
                 : "=r"(ticket) : "l"(ticket_ptr) : "memory");
    s_last = ticket == S - 1;
    if (s_last) *ticket_ptr = 0;  // ready for the next call
  }
  __syncthreads();
  if (!s_last) return;

  float* pacc = reinterpret_cast<float*>(smem);  // [S][GT][D]
  const float* src = part_acc + (size_t)unit * S * GT * D;
  for (int c = tid; c < S * GT * D / 4; c += kThreads)
    cp_async16(pacc + 4 * c, src + 4 * c, true);
  cp_async_commit();
  if (tid < S * GT) {
    const float2 ml = __ldcg(part_ml + (size_t)unit * S * GT + tid);
    s_sm[tid] = ml.x;
    s_sl[tid] = ml.y;
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int idx = tid; idx < GT * D; idx += kThreads) {
    const int g = idx / D, d = idx % D;
    float mm = kMaskScore, ll = 0.f, aa = 0.f;
    for (int s = 0; s < S; ++s) mm = fmaxf(mm, s_sm[s * GT + g]);
    for (int s = 0; s < S; ++s) {
      const float w = exp2f(s_sm[s * GT + g] - mm);
      ll += s_sl[s * GT + g] * w;
      aa += pacc[(s * GT + g) * D + d] * w;
    }
    out[((size_t)b * H + h0 + g) * D + d] =
        from_float<T>(aa / fmaxf(ll, 1e-30f));
  }
}

// dynamic shared memory: the ring, then the dense mask row (16-byte aligned
// window) or the paged row's M block ids
size_t smem_bytes(bool paged, int W, int M) {
  return kRingBytes + pad16(paged ? sizeof(int) * (size_t)M : (size_t)W + 15);
}

template <typename T, int D, int GT, bool PAGED>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         const void* valid, const void* tables,
                         const void* lengths, void* out, void* scratch,
                         int units, int K, int G, int W, int S, int bs, int M,
                         cudaStream_t stream) {
  auto kernel = decode_kernel<T, D, GT, PAGED>;
  const size_t smem = smem_bytes(PAGED, W, M);
  // above the 48 KB default: raise the kernel's limit once per device
  static size_t allowed[kMaxDevices] = {};
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
  kernel<<<dim3(units, S), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const unsigned char*>(valid),
      static_cast<const int*>(tables), static_cast<const int*>(lengths),
      static_cast<T*>(out), static_cast<unsigned char*>(scratch), K, G, W, bs,
      M, 1.4426950408889634f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

template <typename T, int D, bool PAGED>
cudaError_t launch_d(int GT, const void* q, const void* k, const void* v,
                     const void* valid, const void* tables,
                     const void* lengths, void* out, void* scratch, int units,
                     int K, int G, int W, int S, int bs, int M,
                     cudaStream_t stream) {
  if (GT == 2)
    return launch_typed<T, D, 2, PAGED>(q, k, v, valid, tables, lengths, out,
                                        scratch, units, K, G, W, S, bs, M,
                                        stream);
  return launch_typed<T, D, 1, PAGED>(q, k, v, valid, tables, lengths, out,
                                      scratch, units, K, G, W, S, bs, M,
                                      stream);
}

template <typename T, bool PAGED>
cudaError_t launch_t(int D, int GT, const void* q, const void* k,
                     const void* v, const void* valid, const void* tables,
                     const void* lengths, void* out, void* scratch, int units,
                     int K, int G, int W, int S, int bs, int M,
                     cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_d<T, 32, PAGED>(GT, q, k, v, valid, tables, lengths, out,
                                    scratch, units, K, G, W, S, bs, M, stream);
    case 64:
      return launch_d<T, 64, PAGED>(GT, q, k, v, valid, tables, lengths, out,
                                    scratch, units, K, G, W, S, bs, M, stream);
    case 128:
      return launch_d<T, 128, PAGED>(GT, q, k, v, valid, tables, lengths,
                                     out, scratch, units, K, G, W, S, bs, M,
                                     stream);
    case 256:
      return launch_d<T, 256, PAGED>(GT, q, k, v, valid, tables, lengths,
                                     out, scratch, units, K, G, W, S, bs, M,
                                     stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point.  dtype: 0 = float32, 1 = bfloat16.  paged = 0 reads
// k/v as (B, W, K, D) caches masked by valid (B, W) bool; paged = 1 reads
// them as (P, bs, K, D) pools through tables (B, M) and lengths (B,),
// W = M * bs.  D is 32, 64, 128 or 256.  GT query heads per CTA (1 or 2,
// dividing H / K), n_split pieces per row (1..max_splits(D, GT)).  scratch: scratch_bytes bytes laid out as above,
// its tickets zero; the kernel leaves them zero.  Returns the launch's
// cudaError_t.
extern "C" size_t repro_gqa_decode_scratch_bytes(int B, int H, int D, int GT,
                                                  int n_split) {
  const int units = B * (H / GT);
  return acc_offset(units, n_split, GT) +
         sizeof(float) * (size_t)units * n_split * GT * D;
}

extern "C" int repro_gqa_decode(int paged, int dtype, const void* q,
                                const void* k, const void* v,
                                const void* valid, const void* tables,
                                const void* lengths, void* out, void* scratch,
                                long long scratch_size, int B, int H, int K,
                                int D, int W, int GT, int n_split, int bs,
                                int M, void* stream) {
  if (B <= 0 || K <= 0 || H % K != 0 || W <= 0 || bs <= 0 ||
      (GT != 1 && GT != kMaxGT) || (H / K) % GT != 0 || n_split <= 0 ||
      D <= 0 || n_split > max_splits(D, GT) ||
      static_cast<size_t>(scratch_size) <
          repro_gqa_decode_scratch_bytes(B, H, D, GT, n_split))
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = H / K;
  const int units = B * K * (G / GT);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = paged ? launch_t<float, true>(D, GT, q, k, v, valid, tables,
                                        lengths, out, scratch, units, K, G, W,
                                        n_split, bs, M, s)
                : launch_t<float, false>(D, GT, q, k, v, valid, tables,
                                         lengths, out, scratch, units, K, G,
                                         W, n_split, bs, M, s);
  } else if (dtype == 1) {
    err = paged ? launch_t<__nv_bfloat16, true>(D, GT, q, k, v, valid, tables,
                                                lengths, out, scratch, units,
                                                K, G, W, n_split, bs, M, s)
                : launch_t<__nv_bfloat16, false>(D, GT, q, k, v, valid,
                                                 tables, lengths, out, scratch,
                                                 units, K, G, W, n_split, bs,
                                                 M, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
