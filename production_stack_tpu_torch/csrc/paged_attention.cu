// Paged causal GQA attention for Hopper (sm_90a): the two kernels that
// replace the Pallas TPU kernels of production_stack_tpu/ops/pallas_paged.py.
//
//   paged_decode_attention  <- _paged_decode_kernel / paged_decode_attention
//                              (pallas_paged.py:325-510): query windows of
//                              T <= 8 tokens (decode steps).
//   paged_attention         <- _paged_kernel / paged_attention
//                              (pallas_paged.py:75-272): prefill chunks of
//                              any T, tiled over the query axis.
//
// Contract (identical for both): q [B, T, H, D]; K/V pool [N, Hkv, Bs, D]
// (head-major, a (block, head) panel is a contiguous [Bs, D] tile); block
// tables [B, MB] int32; starts [B] int32 = absolute position of q[:, 0].
// Query t of row b sits at starts[b] + t and attends virtual positions
// <= its own through tables[b], reading only blocks j <= jmax =
// (start + last query) / Bs and j < nb. f32 online softmax and f32
// accumulation; output acc / max(l, 1e-30) in q's dtype; the scores are
// scaled by `scale` in f32, as the Pallas kernels scale q in f32.
//
// Two optional branches, off at 0 as in Pallas (Gemma-2 runs both):
// - `window` W > 0 (sliding-window layers): a query at p attends keys in
//   (p - W, p]. Blocks before the earliest query's window, jmin =
//   (first query's position - (W - 1)) / Bs (pallas_paged.py:113-119,
//   :359-366), are skipped, not read and masked. The -1e30 sentinel,
//   never -inf, marks a masked score.
// - `softcap` c > 0: s = c * tanh(s / c) on the scaled raw score,
//   before the mask (pallas_paged.py:135-137, :387-388).
//
// int8 pools (pallas_paged.py:91-93,128-131 and :343-346,381-383): K/V
// int8 [N, Hkv, Bs, D] with f32 scales [N, Hkv, Bs], one per (token,
// head), value = float(int8) * scale, for q in bf16 or f32. Every kernel
// reads a key's scale through the same clamped table lookup as its
// payload (key_index) and dequantizes in f32; the int8 panel is half the
// bf16 panel's bytes. How each kernel does it is at the kernel.
//
// Hazards the TPU hid, handled here: a TPU DMA clamps, a GPU read past the
// end faults — every block index is clamped to [0, MB-1] and every block
// id read from the table to [0, N-1]; blocks past nb are never read; fully
// masked rows return acc / max(l, 1e-30). A row parked at start >= MB*Bs
// (an idle slot, whose output the engine discards) reads nothing and
// returns zeros: the Pallas kernels attend such a row over all nb blocks.
//
// DECODE. What bounds it on an H100: it reads every live K/V byte once,
// and the bytes do not grow with the query window, so device-memory
// bytes bound it (3.35 TB/s) at any T <= 8. A grid of one block per
// (row, kv head), as the first design had, is 32 blocks at batch 4 on 132
// SMs, each walking its row's blocks one after another. So the KV axis
// is split over thread blocks: split s attends blocks [s*bps,
// (s+1)*bps) of its row. The plan (bps, splits) depends on nb alone
// (ops/paged_attention.py decode_split_plan: at most 32 splits), since
// the host never reads `starts` during a decode window; 32 splits put a
// 4,600-token row (72 blocks of 64) on 18 splits x 8 kv heads = 144
// blocks, more than the card has SMs, and a 512-token bucket (nb = 8) on
// one block per split. A split wholly past its row's last block, or
// wholly before its window, attends nothing (the empty partial: m =
// -1e30, l = 0). Each split streams K/V panels in the pool's own dtype
// through a ring of up to 3 stages (no more than the split has panels),
// the next panels in flight while one is used: at bf16 q a row of a
// panel is one bulk copy (cp.async.bulk) and the stages are handed
// between copies and warps on mbarriers, so a warp waits only for the
// panels whose keys it owns; at f32 q every thread copies 16-byte chunks
// (cp.async) and the block syncs on each panel.
//
// bf16 q (paged_decode_mma_kernel): the block's T*G query rows (r = t*G
// + g) are the M of tensor-core products, padded to m16 tiles: S = Q K^T
// and O += P V run as mma.sync m16n8k16 (bf16 in, f32 accumulate), so a
// window of T*G = 8..64 rows per kv head costs about what one row does.
// Rows on the CUDA cores, as the split kernel below computes them, cost
// a warp-sum dot per (row, key) and a pass over the V panel per row:
// time grew with T*G while the bytes did not (a Llama-3-8B verify window
// of 4 took 2.3x the single step). The warps of a tile each take every
// kw-th 16-key chunk with their own (m, l, O) in registers (flash-decoding
// inside the block) and are combined once at the end; q is read raw in
// bf16 and scale, softcap and masks act on the f32 accumulator, as in
// the wgmma prefill; over an int8 pool the panels are converted to bf16
// in registers (exact), each key's scale multiplies its S column and each
// value's scale its p before p is rounded to bf16; p enters P V as its
// bf16 rounding plus the bf16 of what that left (two products), which
// keeps ~16 bits of p as the f32 kernel's products do. The merge is folded
// into the same launch. Only a row's live splits take part, those with a
// block to attend, a contiguous range every block computes from the
// row's start: an empty split exits at once, a row with no live split
// gets its zeros from split 0 and one with a single live split its
// output from that split directly. Otherwise a live split writes its f32
// partial (m, l, acc) for its rows, then counts its arrival on the (row,
// kv head)'s counter (__threadfence, atomicAdd); the last to arrive
// merges the live splits in split order — weights exp(m_s - m) / l with
// l = sum exp(m_s - m) * l_s, a split whose m is the sentinel weighing 0
// — so the result does not depend on which block came last, and resets
// the counter to 0. One wrapper call is one launch. A row's arithmetic
// does not depend on the other rows of its tile: at the same nb a query
// row at T = 1 and inside a T = 4 window (one m16 tile at G <= 4) are
// bit-equal (a lone live split's output is the merge's arithmetic at
// weight 1).
//
// float32 q (paged_decode_kernel, then paged_decode_merge_kernel):
// mma.sync has no full-f32 form, so the dots run in f32 on the CUDA
// cores, each warp on a quarter of the panel's keys (16 KB of K and 16
// KB of V a panel) with the key rows in registers and the dots of a query
// row as independent warp sums; a split writes its f32 partial and a
// second launch merges a row's splits, one output value a thread.
//
// PREFILL, bf16. What bounds it: a 512-token chunk does ~T/2 operations
// per K/V byte, so arithmetic bounds it. One consumer warpgroup (128
// threads) owns a 64-row query tile, 64/G positions of the G query heads
// of one kv head (rows r = t*G + g), and runs S = Q.K^T and O += P.V as
// bf16 wgmma (m64n64k16) with f32 accumulators in registers. Q is staged
// once in shared memory; K and V panels of 64 keys come through a
// 3-stage ring that a producer warpgroup fills with 16-byte cp.async
// copies straight into the 128-byte swizzled layout wgmma reads, each
// stage's arrival and release signalled on mbarriers, so the consumer
// spends no instruction on loads and the next panels land while it works
// on this one. V is read MN-major (the transpose bit); P goes to bf16 in
// registers as the A operand of P.V. Scale, softcap, masks and the online
// softmax work on the accumulator registers. 64-row tiles keep every
// live tile of a chunk with three rows parked on its own SM (128 tiles
// at Gemma-2's shapes on 132 SMs).
//
// PREFILL, float32: wgmma has no full-f32 form (TF32 would not hold the
// f32 checks), so f32 chunks run the f32 FMA tile of attention_tile.cuh,
// chosen by dtype.
//
// Plain C interface (built with nvcc -shared, loaded with ctypes). Each
// entry point launches on the given stream, allocates nothing, never
// synchronises, and returns cudaGetLastError() (or a negative code for
// arguments it refuses).

#include "attention_tile.cuh"
#include "hopper.cuh"

#include <type_traits>

namespace {

constexpr int kThreads = 128;          // decode, merge, wgmma prefill
constexpr int kTileThreads = 256;      // float32 prefill tile
constexpr int kMaxSplits = 32;         // one lane per split in the merge
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  TileArgs tile;
  const void* k_pool;
  const void* v_pool;
  const float* k_scales;   // [N, Hkv, Bs] f32 with an int8 pool, else null
  const float* v_scales;
  const int* tables;
  const int* starts;
  int B, Bs, MB, nb, N;
};

struct DecodeArgs {
  Args a;
  float* part_ml;    // [B, Hkv, splits, T*G, 2] f32: (m, l)
  float* part_acc;   // [B, Hkv, splits, T*G, D] f32
  int* counters;     // bf16 q: [B, Hkv, row groups] arrivals, 0 between calls
  int bps, splits;
  int stages;        // bf16 q: the ring's stages (MmaDecodeGeometry)
};

// Index of key `key` (virtual position in row b) of kv head h in the
// [N, Hkv, Bs] scales of an int8 pool: through the table, block index and
// id clamped. key_offset is its element offset in the [N, Hkv, Bs, D]
// pool, so payload and scale go through the one clamped lookup.
__device__ __forceinline__ size_t key_index(const Args& a, const int* table,
                                            int h, int key) {
  const int j = key / a.Bs;
  const int blk = min(max(table[min(max(j, 0), a.MB - 1)], 0), a.N - 1);
  return ((size_t)blk * a.tile.Hkv + h) * a.Bs + (key - j * a.Bs);
}
__device__ __forceinline__ size_t key_offset(const Args& a, const int* table,
                                             int h, int key, int D) {
  return key_index(a, table, h, key) * D;
}

// ------------------------------------------------------------ decode

// KV: the pool's element type (q's type, or int8_t with scales)
template <typename KV, int D>
struct DecodeGeometry {
  static constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  static constexpr int kVec = 16 / sizeof(KV);     // values per 16 bytes
  // keys per panel: 16 KB of K and 16 KB of V, at most 32 (one lane per
  // key in the softmax)
  static constexpr int kKeys =
      16384 / (D * (int)sizeof(KV)) > 32 ? 32 : 16384 / (D * (int)sizeof(KV));
  static constexpr int kRowStep = kThreads / (D / kVec);   // loader rows
  static constexpr int kStages = 3;
  // each stage's K and V scales (int8 pool only)
  static constexpr int kScaleFloats = kQuant ? kStages * kKeys : 0;
  static int smem_bytes(int R) {
    return kStages * kKeys * 2 * D * (int)sizeof(KV)   // K, V ring
           + 2 * kScaleFloats * 4                       // their scales
           + R * D * 4           // q (pre-scaled)
           + R * D * 4           // acc
           + 2 * R * kKeys * 4   // scores, probabilities of one panel
           + 3 * R * 4;          // m, l, correction
  }
};

// N values of type T (N * sizeof(T) in 2, 4, 8, 16 or 32 bytes) from
// shared memory as f32, in 16-byte or narrower vector loads
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* src, float (&dst)[N]) {
  constexpr int kBytes = N * (int)sizeof(T);
  constexpr int kUnit = kBytes >= 16 ? 16 : kBytes;
  using U = typename std::conditional<
      kUnit == 16, uint4,
      typename std::conditional<
          kUnit == 8, uint2,
          typename std::conditional<kUnit == 4, unsigned,
                                    unsigned short>::type>::type>::type;
  U buf[kBytes / kUnit];
#pragma unroll
  for (int u = 0; u < kBytes / kUnit; ++u)
    buf[u] = reinterpret_cast<const U*>(src)[u];
  if constexpr (std::is_same<T, int8_t>::value) {
    unsigned w[(kBytes + 3) / 4];
    if constexpr (kBytes >= 4) {
#pragma unroll
      for (int i = 0; i < kBytes / 4; ++i)
        w[i] = reinterpret_cast<const unsigned*>(buf)[i];
    } else {
      w[0] = buf[0];
    }
#pragma unroll
    for (int e = 0; e < N; ++e) dst[e] = int8_byte_to_f32(w[e / 4], e % 4);
  } else {
    const T* v = reinterpret_cast<const T*>(buf);
#pragma unroll
    for (int e = 0; e < N; ++e) dst[e] = to_f32(v[e]);
  }
}

// One (batch row, kv head, split): attends the split's blocks for all
// T*G query rows and writes the f32 partial (m, l, acc). T: q's type; KV:
// the pool's, T or int8_t (then each panel brings its keys' f32 scales
// too, and a value is float(int8) * scale, as pallas_paged.py:381-383).
template <typename T, typename KV, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(DecodeArgs da) {
  using Geo = DecodeGeometry<KV, D>;
  constexpr bool kQuant = Geo::kQuant;
  constexpr int kVec = Geo::kVec, kKeys = Geo::kKeys;
  constexpr int kStages = Geo::kStages;
  constexpr int kSlice = D / 32;   // values of a key row a lane holds
  constexpr int kWarps = kThreads / 32;
  constexpr int kPerWarp = kKeys / kWarps;   // keys of a warp in a panel
  extern __shared__ __align__(16) unsigned char raw_smem[];
  const Args& a = da.a;
  const int b = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T_ = a.tile.T, H = a.tile.H, Hkv = a.tile.Hkv;
  const int G = H / Hkv, R = T_ * G;
  const int start = a.starts[b];
  const int Bs = a.Bs;
  const size_t part = ((size_t)b * Hkv + h) * da.splits + s;
  float* pml = da.part_ml + part * R * 2;
  float* pacc = da.part_acc + part * R * D;

  const int jend = min((start + T_ - 1) / Bs, a.nb - 1);
  const int jmin = a.tile.window > 0
                       ? max(start - (a.tile.window - 1), 0) / Bs : 0;
  const int jlo = max(s * da.bps, jmin);
  const int jhi = min((s + 1) * da.bps - 1, jend);
  if (start >= a.MB * Bs || jlo > jhi) {   // uniform across the block
    for (int r = tid; r < R; r += kThreads) {
      pml[2 * r] = kNegInf;
      pml[2 * r + 1] = 0.f;
    }
    return;
  }
  const int k_lo = jlo * Bs, k_hi = (jhi + 1) * Bs;
  const int n_panels = (k_hi - k_lo + kKeys - 1) / kKeys;

  KV* kst = reinterpret_cast<KV*>(raw_smem);
  KV* vst = kst + kStages * kKeys * D;
  float* kss = reinterpret_cast<float*>(vst + kStages * kKeys * D);
  float* vss = kss + Geo::kScaleFloats;   // (both empty without int8)
  float* qs = vss + Geo::kScaleFloats;
  float* acc = qs + R * D;
  float* sc = acc + R * D;
  float* ps = sc + R * kKeys;
  float* m = ps + R * kKeys;
  float* l = m + R;
  float* corr = l + R;

  const KV* kp = static_cast<const KV*>(a.k_pool);
  const KV* vp = static_cast<const KV*>(a.v_pool);
  const int* table = a.tables + (size_t)b * a.MB;
  // a thread copies 16-byte chunk lc of rows lr, lr + kRowStep, ...; the
  // rows' table lookups are all issued before the copies, so their
  // latencies overlap. With an int8 pool threads 0..kKeys-1 also copy the
  // panel's K scales, kKeys..2*kKeys-1 its V scales, in the same group.
  constexpr int kRowStep = Geo::kRowStep;
  const int lc = tid % (D / kVec), lr = tid / (D / kVec);
  auto load_panel = [&](int i, int st) {
    KV* K = kst + st * kKeys * D;
    KV* V = vst + st * kKeys * D;
    if constexpr (kQuant) {
      if (tid < 2 * kKeys) {
        const int c = tid % kKeys;
        const int key = k_lo + i * kKeys + c;
        const bool ok = key < k_hi;
        const size_t idx = ok ? key_index(a, table, h, key) : 0;
        float* dst = (tid < kKeys ? kss : vss) + st * kKeys + c;
        cp_async4(smem_u32(dst), (tid < kKeys ? a.k_scales : a.v_scales) + idx,
                  ok);
      }
    }
    size_t off[kKeys / kRowStep];
#pragma unroll
    for (int it = 0; it < kKeys / kRowStep; ++it) {
      const int key = k_lo + i * kKeys + lr + it * kRowStep;
      off[it] = key < k_hi ? key_offset(a, table, h, key, D) + lc * kVec : 0;
    }
#pragma unroll
    for (int it = 0; it < kKeys / kRowStep; ++it) {
      const int r = lr + it * kRowStep;
      const bool ok = k_lo + i * kKeys + r < k_hi;
      cp_async16(smem_u32(K + r * D + lc * kVec), kp + off[it], ok);
      cp_async16(smem_u32(V + r * D + lc * kVec), vp + off[it], ok);
    }
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_panels) load_panel(st, st);
    cp_async_commit();
  }

  // rows ordered r = t * G + g; head of row r is h * G + g
  const T* q = static_cast<const T*>(a.tile.q);
  for (int idx = tid; idx < R * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int t = r / G, g = r % G;
    qs[idx] = to_f32(q[(((size_t)b * T_ + t) * H + h * G + g) * D + d]) *
              a.tile.scale;
    acc[idx] = 0.f;
  }
  for (int r = tid; r < R; r += kThreads) {
    m[r] = kNegInf;
    l[r] = 0.f;
  }

  const int limit = a.nb * Bs;
  for (int i = 0; i < n_panels; ++i) {
    const int nxt = i + kStages - 1;
    if (nxt < n_panels) load_panel(nxt, nxt % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const int st = i % kStages;
    const KV* K = kst + st * kKeys * D;
    const KV* V = vst + st * kKeys * D;
    const float* ksc = kss + st * kKeys;
    const float* vsc = vss + st * kKeys;
    const int kbase = k_lo + i * kKeys;

    // scores: warp w takes keys w, w + 4, ... (kPerWarp of them), a lane
    // kSlice values of each key row and of the query row; the kPerWarp
    // dots of a row are independent warp sums, and lane kk caps and
    // masks the dot of the warp's kk-th key. Over an int8 pool a key's
    // scale multiplies its f32 dot once, and a value's scale its
    // probability once (ps), not every element: the Pallas f32 dequant
    // (q . (k8 * ks), p . (v8 * vs)) up to the order of f32 products.
    {
      float kv[kPerWarp][kSlice];
#pragma unroll
      for (int kk = 0; kk < kPerWarp; ++kk)
        load_f32<KV, kSlice>(K + (warp + kk * kWarps) * D + lane * kSlice,
                             kv[kk]);
      const int c = warp + lane * kWarps;   // the key lane kk < kPerWarp caps
      const int k_pos = kbase + c;
      const float k_scale = kQuant && lane < kPerWarp ? ksc[c] : 1.f;
      for (int r = 0; r < R; ++r) {
        float qv[kSlice];
        load_f32<float, kSlice>(qs + r * D + lane * kSlice, qv);
        float dot[kPerWarp];
#pragma unroll
        for (int kk = 0; kk < kPerWarp; ++kk) {
          dot[kk] = 0.f;
#pragma unroll
          for (int e = 0; e < kSlice; ++e)
            dot[kk] = fmaf(qv[e], kv[kk][e], dot[kk]);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
#pragma unroll
          for (int kk = 0; kk < kPerWarp; ++kk)
            dot[kk] += __shfl_xor_sync(0xffffffffu, dot[kk], o);
        float x = dot[0];
#pragma unroll
        for (int kk = 1; kk < kPerWarp; ++kk)
          if (lane == kk) x = dot[kk];
        if (lane < kPerWarp) {
          if constexpr (kQuant) x *= k_scale;
          if (a.tile.softcap != 0.f)
            x = a.tile.softcap * tanhf(x / a.tile.softcap);
          const int q_pos = start + r / G;
          const bool live = k_pos < k_hi && k_pos < limit &&
                            k_pos <= q_pos &&
                            (a.tile.window <= 0 ||
                             k_pos > q_pos - a.tile.window);
          sc[r * kKeys + c] = live ? x : kNegInf;
        }
      }
    }
    __syncthreads();

    // online softmax: a warp per row, a lane per key; a masked key has
    // p = 0, so a row with no live key keeps m = -1e30, l = 0
    const float v_scale = kQuant && lane < kKeys ? vsc[lane] : 1.f;
    for (int r = warp; r < R; r += kWarps) {
      const float x = lane < kKeys ? sc[r * kKeys + lane] : kNegInf;
      const bool live = x != kNegInf;
      float mx = x;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p = live ? expf(x - m_new) : 0.f;
      float sum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane < kKeys) ps[r * kKeys + lane] = p * v_scale;
      if (lane == 0) {
        const float cr = expf(m_prev - m_new);
        corr[r] = cr;
        l[r] = l[r] * cr + sum;
        m[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V: a thread owns 4 neighbouring values of a
    // row. Keys past the range have p = 0 and zero-filled V rows, so the
    // loop runs over the whole panel and unrolls.
    for (int idx = tid; idx < R * (D / 4); idx += kThreads) {
      const int r = idx / (D / 4), d = (idx % (D / 4)) * 4;
      const float cr = corr[r];
      float4 x = *reinterpret_cast<float4*>(acc + r * D + d);
      x.x *= cr; x.y *= cr; x.z *= cr; x.w *= cr;
      const float* pr = ps + r * kKeys;
#pragma unroll
      for (int cc = 0; cc < kKeys; ++cc) {
        const float p = pr[cc];
        float v4[4];
        load_f32<KV, 4>(V + cc * D + d, v4);
        x.x = fmaf(p, v4[0], x.x);
        x.y = fmaf(p, v4[1], x.y);
        x.z = fmaf(p, v4[2], x.z);
        x.w = fmaf(p, v4[3], x.w);
      }
      *reinterpret_cast<float4*>(acc + r * D + d) = x;
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  for (int r = tid; r < R; r += kThreads) {
    pml[2 * r] = m[r];
    pml[2 * r + 1] = l[r];
  }
  for (int idx = tid; idx < R * D; idx += kThreads) pacc[idx] = acc[idx];
}

// Merges the splits' partials of one (batch row, kv head) into kThreads
// output values of its [T*G, D] rows (grid z), one value a thread.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_merge_kernel(DecodeArgs da) {
  // the block's rows: D divides kThreads or kThreads divides D
  constexpr int kRows = kThreads >= D ? kThreads / D : 1;
  __shared__ float wts[kRows * kMaxSplits];   // their splits' weights
  const Args& a = da.a;
  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T_ = a.tile.T, H = a.tile.H, Hkv = a.tile.Hkv;
  const int G = H / Hkv, R = T_ * G, S = da.splits;
  const size_t part0 = ((size_t)b * Hkv + h) * S;
  const int idx0 = blockIdx.z * kThreads;
  const int r_lo = idx0 / D, r_hi = min((idx0 + kThreads - 1) / D, R - 1);
  for (int r = r_lo + warp; r <= r_hi; r += kThreads / 32) {
    float ms = kNegInf, ls = 0.f;
    if (lane < S) {
      ms = da.part_ml[((part0 + lane) * R + r) * 2];
      ls = da.part_ml[((part0 + lane) * R + r) * 2 + 1];
    }
    float mx = ms;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    // a split with no live key for this row carries the sentinel: 0
    const float w = ms == kNegInf ? 0.f : expf(ms - mx);
    float lsum = w * ls;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      lsum += __shfl_xor_sync(0xffffffffu, lsum, o);
    wts[(r - r_lo) * kMaxSplits + lane] = w / fmaxf(lsum, 1e-30f);
  }
  __syncthreads();
  const int idx = idx0 + tid;
  if (idx >= R * D) return;
  const int r = idx / D, d = idx % D;
  const float* wr = wts + (r - r_lo) * kMaxSplits;
  float x = 0.f;
  // the splits' values are loaded 8 at a time, independent of each
  // other; an empty split's acc was never written, its weight selects 0
#pragma unroll 8
  for (int s = 0; s < S; ++s) {
    const float v = da.part_acc[((part0 + s) * R + r) * D + d];
    x += wr[s] != 0.f ? wr[s] * v : 0.f;
  }
  const int t = r / G, g = r % G;
  T* out = static_cast<T*>(a.tile.out);
  out[(((size_t)b * T_ + t) * H + h * G + g) * D + d] = from_f32<T>(x);
}

// ------------------------------------------------------ decode, bf16 q

constexpr int kRowGroup = 64;   // query rows of a block: four m16 tiles
constexpr int kWarps = kThreads / 32;

// KV: the pool's element type, bf16 or int8_t. Shared memory: the K/V
// ring (rows padded by 16 bytes) and the int8 pool's scales, and after
// the loop the same bytes for the warps' (m, l, O) and the merge's
// weights; then Q, bf16, q_rows padded rows, and the ring's mbarriers (64
// bytes). The ring has up to kMaxStages stages, no more than a split has
// panels (a 512-token bucket's split of one 64-key block has one), so a
// short split's block takes less shared memory and more fit on an SM.
template <typename KV, int D>
struct MmaDecodeGeometry {
  static constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  static constexpr int kKeys = D == 256 ? 32 : 64;   // keys of a panel
  static constexpr int kChunks = kKeys / 16;         // its 16-key mma steps
  static constexpr int kMaxStages = 3;
  static constexpr int kRowBytes = D * (int)sizeof(KV) + 16;
  static constexpr int kQRowBytes = D * 2 + 16;
  static constexpr int kStageBytes =   // K and V rows, their scales
      2 * kKeys * kRowBytes + (kQuant ? 2 * kKeys * 4 : 0);
  static constexpr int kOStride = D + 4;   // floats of a row of a warp's O
  static constexpr int kCombineBytes = kWarps * 16 * (kOStride + 2) * 4;
  static constexpr int kMergeBytes = kRowGroup * kMaxSplits * 4;
  static int stages(int bps, int Bs) {   // panels of a split, at most 3
    const int panels = (bps * Bs + kKeys - 1) / kKeys;
    return panels < kMaxStages ? panels : kMaxStages;
  }
  __host__ __device__ static int region_bytes(int stages) {
    int bytes = stages * kStageBytes;
    if (bytes < kCombineBytes) bytes = kCombineBytes;
    return bytes < kMergeBytes ? kMergeBytes : bytes;
  }
  static int smem_bytes(int stages, int q_rows) {
    return region_bytes(stages) + q_rows * kQRowBytes + 64;
  }
};

// x * scale as four bf16 at out (8-byte aligned)
__device__ __forceinline__ void store_bf16x4(__nv_bfloat16* out, float4 x,
                                             float scale) {
  uint2 v;
  v.x = pack_bf16x2(x.x * scale, x.y * scale);
  v.y = pack_bf16x2(x.z * scale, x.w * scale);
  *reinterpret_cast<uint2*>(out) = v;
}

// The decode kernel's merge of a row group's live splits (s0 = the
// first one's partial index): every 4-value group of the group's rows
// is the weighed sum of its splits' partials (weights mw [64][32], 0
// past n_live) in split order, written as bf16. A thread takes kG
// groups and kB splits of loads at a time.
template <int kG, int kB, int D, typename Out>
__device__ __forceinline__ void merge_groups(const float* mw,
                                             const float* part_acc,
                                             size_t s0, int R, int row0,
                                             int rows, int n_live,
                                             const Out& out_at) {
  const int n_groups = rows * D / 4;
  for (int g0 = threadIdx.x; g0 < n_groups; g0 += kThreads * kG) {
    float4 x[kG];
    const float* acc[kG];
    const float* wr[kG];
#pragma unroll
    for (int gi = 0; gi < kG; ++gi) {
      x[gi] = make_float4(0.f, 0.f, 0.f, 0.f);
      const int g = min(g0 + gi * kThreads, n_groups - 1);
      const int r = g * 4 / D, d = g * 4 % D;
      acc[gi] = part_acc + (s0 * R + row0 + r) * D + d;
      wr[gi] = mw + r * kMaxSplits;
    }
    for (int k = 0; k < n_live; k += kB) {
      float4 v[kG][kB];
#pragma unroll
      for (int gi = 0; gi < kG; ++gi)
#pragma unroll
        for (int u = 0; u < kB; ++u)
          v[gi][u] = k + u < n_live
                         ? __ldcg(reinterpret_cast<const float4*>(
                               acc[gi] + (size_t)(k + u) * R * D))
                         : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int gi = 0; gi < kG; ++gi)
#pragma unroll
        for (int u = 0; u < kB; ++u) {
          const float w = wr[gi][k + u];
          x[gi].x += w * v[gi][u].x; x[gi].y += w * v[gi][u].y;
          x[gi].z += w * v[gi][u].z; x[gi].w += w * v[gi][u].w;
        }
    }
#pragma unroll
    for (int gi = 0; gi < kG; ++gi) {
      const int g = g0 + gi * kThreads;
      if (g < n_groups)
        store_bf16x4(out_at(g * 4 / D) + g * 4 % D, x[gi], 1.f);
    }
  }
}

// word i (0..3) of a 16-byte vector (i a compile-time constant where it
// is called, so the vector stays in registers)
__device__ __forceinline__ uint32_t word_of(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// One (batch row, kv head, split, row group of up to 64 query rows) for
// a bf16 q: the split's blocks for the group's rows on the tensor cores,
// then, if it is the last of the row's live splits to finish, their
// merge (the header's DECODE note).
//
// Warps and rows: the group's rows are n_mt m16 tiles (rows r = t*G + g,
// padded with zero rows); kw = 4 / n_mt warps (4, 2 or 1; a fourth tile
// for 3) share a tile, each taking every kw-th 16-key chunk of the
// split's keys with its own (m, l, O) for the tile's 16 rows in
// registers. A lane holds O for rows g and g + 8 (g = lane / 4): D / 2
// floats. The warps' partials are combined once, after the loop.
//
// Fragments (mma.sync m16n8k16, hopper.cuh): S = Q K^T takes the D axis
// in blocks of 4 * kVec values (kVec = 16 bytes of the pool's type), of
// which lane c = lane % 4 holds the kVec values from c * kVec on, as A
// (Q) and as B (K) columns alike: k-step s of a block pairs k-indices
// 2c, 2c+1, 2c+8, 2c+9 with values c * kVec + 4s + 0..3. A dot product
// does not care in which order its terms come, and so a lane reads each
// operand with one 16-byte load (bf16: 8 values, 2 k-steps; int8: 16
// values, 4 k-steps, converted to bf16 exactly) instead of a strided
// gather. O += P V takes the chunk's 16 keys as k and output column n of
// n-tile j as value d = n * D / 8 + j, so a lane's B operand is D / 8
// contiguous values of each of its four V rows. P comes from the S
// accumulators as bf16 A fragments in registers (its rounding and the
// residual, each through P V).
template <typename KV, int D>
__global__ void __launch_bounds__(kThreads, 2)
paged_decode_mma_kernel(DecodeArgs da) {
  using Geo = MmaDecodeGeometry<KV, D>;
  constexpr bool kQuant = Geo::kQuant;
  constexpr int kKeys = Geo::kKeys;
  constexpr int kRowB = Geo::kRowBytes, kQRowB = Geo::kQRowBytes;
  constexpr int kVec = 16 / (int)sizeof(KV);   // pool values a 16-byte load
  constexpr int kBlk = 4 * kVec;               // D values of an S block
  constexpr int kNT = D / 8;                   // n-tiles of O
  constexpr int kOS = Geo::kOStride;
  extern __shared__ __align__(16) unsigned char raw_smem[];
  __shared__ int is_last;
  const Args& a = da.a;
  const int b = blockIdx.x, h = blockIdx.y;
  const int S = da.splits;
  const int s = blockIdx.z % S, rg = blockIdx.z / S;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, cq = lane & 3;
  const int T_ = a.tile.T, H = a.tile.H, Hkv = a.tile.Hkv;
  const int G = H / Hkv, R = T_ * G;
  const int n_rg = (R + kRowGroup - 1) / kRowGroup;
  const int row0 = rg * kRowGroup;
  const int rows = min(kRowGroup, R - row0);
  const int n_mt = (rows + 15) / 16;
  const int kw = n_mt == 1 ? 4 : n_mt == 2 ? 2 : 1;
  const int mt = warp / kw, kg = warp % kw;
  // the split's first table entry (its first block without a window)
  // heads for L1 while the row's start is read
  prefetch_l1(a.tables + (size_t)b * a.MB + min(s * da.bps, a.MB - 1));
  const int start = a.starts[b];
  const int Bs = a.Bs;
  const size_t part0 = ((size_t)b * Hkv + h) * S;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.tile.out);
  // element d of block row r (query row row0 + r) in out, [B, T, H, D]
  auto out_at = [&](int r) {
    const int rr = row0 + r, t = rr / G, g = rr % G;
    return out + (((size_t)b * T_ + t) * H + h * G + g) * D;
  };

  const int jend = min((start + T_ - 1) / Bs, a.nb - 1);
  const int jmin = a.tile.window > 0
                       ? max(start - (a.tile.window - 1), 0) / Bs : 0;
  const int jlo = max(s * da.bps, jmin);
  const int jhi = min((s + 1) * da.bps - 1, jend);
  // the row's live splits, s_lo..s_hi: those with a block to attend
  // (none for a parked row, or a window wholly past the nb blocks)
  const int s_lo = jmin / da.bps;
  const int n_live =
      start >= a.MB * Bs || jmin > jend ? 0 : jend / da.bps - s_lo + 1;
  if (start >= a.MB * Bs || jlo > jhi) {   // uniform across the block
    // nothing to attend: split 0 writes the zeros of a row with no live
    // split; another empty split takes no part in the merge
    if (n_live == 0 && s == 0)
      for (int idx = tid; idx < rows * D; idx += kThreads)
        out_at(idx / D)[idx % D] = __float2bfloat16_rn(0.f);
    return;
  }
  {
    const int k_lo = jlo * Bs, k_hi = (jhi + 1) * Bs;
    const int n_panels = (k_hi - k_lo + kKeys - 1) / kKeys;
    const int stages = da.stages;
    unsigned char* ring = raw_smem;
    float* kss = reinterpret_cast<float*>(ring + stages * 2 * kKeys * kRowB);
    float* vss = kss + stages * kKeys;   // (both empty without int8)
    unsigned char* qsm = raw_smem + Geo::region_bytes(stages);
    // the ring's mbarriers, after Q: full[st] completes when every
    // thread has arrived and its copies into stage st have landed,
    // empty[st] when every warp is done with it
    const uint32_t full = smem_u32(qsm + n_mt * 16 * kQRowB);
    const uint32_t empty = full + 8 * stages;
    if (tid == 0) {
      for (int st = 0; st < stages; ++st) {
        mbar_init(full + 8 * st, kThreads);
        mbar_init(empty + 8 * st, kWarps);
      }
      mbar_init_fence();
    }   // (full[st] and empty[st] for st < 3: 48 of the 64 bytes)
    __syncthreads();
    const KV* kp = static_cast<const KV*>(a.k_pool);
    const KV* vp = static_cast<const KV*>(a.v_pool);
    const int* table = a.tables + (size_t)b * a.MB;

    // A stage holds its panel's kKeys K rows, then its kKeys V rows
    // (padded). Thread t < 2 * kKeys brings row t % kKeys of K (t <
    // kKeys) or of V with one bulk copy (cp.async.bulk: the copy engine
    // moves the row, its bytes counted on full[st]), or writes zeros where
    // the row lies past the split's keys; with an int8 pool it also
    // copies that key's K or V scale (cp.async, tracked on full[st]). The
    // row's table lookup (panel_offsets) is issued an iteration before its
    // copy (issue_panel), so its latency overlaps the panel in use.
    struct PanelOffsets {
      size_t row;   // the key's index in the [N, Hkv, Bs] pool rows
      bool ok;      // the key is the split's
    };
    // key_index's lookup, with a shift for the block where Bs is a power
    // of two (as the engine's block sizes are) in place of a division
    const int bs_shift = (Bs & (Bs - 1)) == 0 ? __ffs(Bs) - 1 : -1;
    auto key_row = [&](int key) -> size_t {
      const int j = bs_shift >= 0 ? key >> bs_shift : key / Bs;
      const int blk = min(max(table[min(j, a.MB - 1)], 0), a.N - 1);
      return ((size_t)blk * Hkv + h) * Bs + (key - j * Bs);
    };
    auto panel_offsets = [&](int i, PanelOffsets& po) {
      const int key = k_lo + i * kKeys + tid % kKeys;
      po.ok = tid < 2 * kKeys && key < k_hi;
      po.row = po.ok ? key_row(key) : 0;
    };
    auto issue_panel = [&](int i, int st, const PanelOffsets& po) {
      const uint32_t bar = full + 8 * st;
      if (tid >= 2 * kKeys) {
        mbar_arrive(bar);
        return;
      }
      const bool is_v = tid >= kKeys;
      const int r = tid % kKeys;
      const uint32_t dst =
          smem_u32(ring + ((st * 2 + is_v) * kKeys + r) * kRowB);
      if constexpr (kQuant) {
        float* sdst = (is_v ? vss : kss) + st * kKeys + r;
        cp_async4(smem_u32(sdst),
                  (is_v ? a.v_scales : a.k_scales) + po.row, po.ok);
        cp_async_mbar_track(bar);
      }
      constexpr uint32_t kBytes = D * sizeof(KV);
      if (po.ok) {
        mbar_arrive_expect_tx(bar, kBytes);
        bulk_copy_g2s(dst, (is_v ? vp : kp) + po.row * D, kBytes, bar);
      } else {
        for (uint32_t c = 0; c < kBytes; c += 16)
          st_shared16(dst + c, make_uint4(0, 0, 0, 0));
        fence_proxy_async();   // before a later bulk copy to the row
        mbar_arrive(bar);
      }
    };

    // Q raw in bf16 (zero rows pad the last tile), before the first
    // panels
    {
      const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.tile.q);
      constexpr int kQChunks = D / 8;
      for (int idx = tid; idx < n_mt * 16 * kQChunks; idx += kThreads) {
        const int r = idx / kQChunks, c = idx % kQChunks;
        const int rr = row0 + r, t = rr / G, g = rr % G;
        const bool ok = r < rows;
        const size_t off =
            ok ? (((size_t)b * T_ + t) * H + h * G + g) * D + c * 8 : 0;
        cp_async16(smem_u32(qsm + r * kQRowB + c * 16), q + off, ok);
      }
    }
    PanelOffsets po;
#pragma unroll 1
    for (int st = 0; st < stages - 1; ++st) {
      if (st < n_panels) {
        panel_offsets(st, po);
        issue_panel(st, st, po);
      }
    }
    // every warp reads every Q row of its tile, but waits only on the
    // stages of the chunks it owns (at D = 256 with one tile, warps 2
    // and 3 own none of panel 0's): Q lands and is shared here, with
    // the first panels already in flight
    cp_async_wait_all();
    __syncthreads();

    const bool active = mt < n_mt;
    const int ra = mt * 16 + gq, rb = ra + 8;   // this lane's block rows
    const int qpos_a = start + (row0 + ra) / G;
    const int qpos_b = start + (row0 + rb) / G;
    const int limit = a.nb * Bs;
    const float scale = a.tile.scale, cap = a.tile.softcap;
    const float cap_k = cap != 0.f ? 2.f * kLog2e / cap : 0.f;
    const int window = a.tile.window;
    float o[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
    float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;

    // No block-wide barrier in the loop: a warp waits for a stage's
    // copies only where it owns a chunk, and the copies of panel i + 2
    // wait for every warp to be done with panel i - 1 (its stage), so
    // warps that own the chunks of different panels work on them at once
    for (int i = 0; i < n_panels; ++i) {
      const int nxt = i + stages - 1;
      if (nxt < n_panels) {
        panel_offsets(nxt, po);
        if (nxt >= stages)
          mbar_wait(empty + 8 * (nxt % stages), (nxt / stages - 1) & 1);
        issue_panel(nxt, nxt % stages, po);
      }
      const int st = i % stages;
      bool landed = false;
      const unsigned char* K = ring + st * 2 * kKeys * kRowB;
      const unsigned char* V = K + kKeys * kRowB;
      const float* ksc = kss + st * kKeys;
      const float* vsc = vss + st * kKeys;
      // one copy of the chunk's code (not unrolled): a block runs it a
      // few times, and a smaller kernel keeps its code in the cache
#pragma unroll 1
      for (int c = 0; c < Geo::kChunks; ++c) {
        if (!active || (i * Geo::kChunks + c) % kw != kg) continue;
        if (!landed) {
          mbar_wait(full + 8 * st, (i / stages) & 1);
          landed = true;
        }
        const int kc = c * 16;   // the chunk's first key in the panel
        const int kbase = k_lo + i * kKeys + kc;

        // S = Q K^T: n-tile nt is keys kc + 8 nt .. + 7, this lane's B
        // column key kc + 8 nt + gq
        // even and odd blocks accumulate apart (two mma chains of half
        // the length), added at the end
        float sacc[2][2][4];
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) sacc[u][nt][e] = 0.f;
#pragma unroll
        for (int blk = 0; blk < D / kBlk; ++blk) {
          const int q_off = (blk * kBlk + cq * kVec) * 2;
          uint32_t qa[kVec / 2], qb[kVec / 2];
#pragma unroll
          for (int u = 0; u < kVec / 8; ++u) {
            const uint4 x = *reinterpret_cast<const uint4*>(
                qsm + ra * kQRowB + q_off + 16 * u);
            const uint4 y = *reinterpret_cast<const uint4*>(
                qsm + rb * kQRowB + q_off + 16 * u);
            qa[4 * u] = x.x; qa[4 * u + 1] = x.y;
            qa[4 * u + 2] = x.z; qa[4 * u + 3] = x.w;
            qb[4 * u] = y.x; qb[4 * u + 1] = y.y;
            qb[4 * u + 2] = y.z; qb[4 * u + 3] = y.w;
          }
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const uint4 w = *reinterpret_cast<const uint4*>(
                K + (kc + nt * 8 + gq) * kRowB +
                (blk * kBlk + cq * kVec) * (int)sizeof(KV));
            uint32_t kb[kVec / 2];
            if constexpr (kQuant) {
              const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                kb[2 * e] = int8_pair_to_bf16x2(ws[e], 0, ws[e], 1);
                kb[2 * e + 1] = int8_pair_to_bf16x2(ws[e], 2, ws[e], 3);
              }
            } else {
              kb[0] = w.x; kb[1] = w.y; kb[2] = w.z; kb[3] = w.w;
            }
#pragma unroll
            for (int ks = 0; ks < kVec / 4; ++ks) {
              const uint32_t af[4] = {qa[2 * ks], qb[2 * ks], qa[2 * ks + 1],
                                      qb[2 * ks + 1]};
              mma_m16n8k16(sacc[blk & 1][nt], af, kb[2 * ks],
                           kb[2 * ks + 1]);
            }
          }
        }
        float sc[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[nt][e] = sacc[0][nt][e] + sacc[1][nt][e];

        // scale (and the int8 pool's K scale), cap, mask on the f32
        // accumulator; sc[nt][e] is key kc + 8 nt + 2 cq + e % 2 of row
        // ra (e < 2) or rb
        float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = nt * 8 + 2 * cq + (e & 1);
            const int k_pos = kbase + col;
            const int qp = e < 2 ? qpos_a : qpos_b;
            float x = sc[nt][e] * scale;
            if constexpr (kQuant) x *= ksc[kc + col];
            if (cap != 0.f) {
              const float ex = exp2f(x * cap_k);
              x = cap * (1.f - __fdividef(2.f, ex + 1.f));
            }
            const bool live = k_pos < k_hi && k_pos < limit && k_pos <= qp &&
                              (window <= 0 || k_pos > qp - window);
            x = live ? x : kNegInf;
            sc[nt][e] = x;
            if (e < 2) mx_a = fmaxf(mx_a, x); else mx_b = fmaxf(mx_b, x);
          }
#pragma unroll
        for (int o2 = 1; o2 <= 2; o2 <<= 1) {
          mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o2));
          mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o2));
        }
        const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
        const float c_a = exp2f((m_a - mn_a) * kLog2e);
        const float c_b = exp2f((m_b - mn_b) * kLog2e);
        m_a = mn_a;
        m_b = mn_b;
        // a masked key has p = 0, so a row with no live key keeps
        // m = -1e30, l = 0, O = 0; V's scale goes on P before bf16. P
        // enters P V as two bf16 fragments, its rounding (pf) and what
        // that rounding left (pl), so P V keeps P to ~16 bits where one
        // bf16 would keep 8, as an f32 product would (the value rows
        // are exact in bf16)
        uint32_t pf[4], pl[4];
        float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          float p[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float mn = e < 2 ? mn_a : mn_b;
            p[e] = sc[nt][e] == kNegInf ? 0.f
                                        : exp2f((sc[nt][e] - mn) * kLog2e);
          }
          sum_a += p[0] + p[1];
          sum_b += p[2] + p[3];
          float v0 = 1.f, v1 = 1.f;
          if constexpr (kQuant) {
            v0 = vsc[kc + nt * 8 + 2 * cq];
            v1 = vsc[kc + nt * 8 + 2 * cq + 1];
          }
          const float a0 = p[0] * v0, a1 = p[1] * v1;   // row ra
          const float b0 = p[2] * v0, b1 = p[3] * v1;   // row rb
          pf[2 * nt] = pack_bf16x2(a0, a1);
          pf[2 * nt + 1] = pack_bf16x2(b0, b1);
          pl[2 * nt] = bf16x2_residual(pf[2 * nt], a0, a1);
          pl[2 * nt + 1] = bf16x2_residual(pf[2 * nt + 1], b0, b1);
        }
        l_a = l_a * c_a + sum_a;
        l_b = l_b * c_b + sum_b;
        if (!__all_sync(0xffffffffu, c_a == 1.f && c_b == 1.f)) {
#pragma unroll
          for (int j = 0; j < kNT; ++j) {
            o[j][0] *= c_a; o[j][1] *= c_a;
            o[j][2] *= c_b; o[j][3] *= c_b;
          }
        }

        // O += P V: this lane's B rows are keys kc + 2cq, +1, +8, +9, its
        // column of n-tile j value gq * kNT + j; 8 n-tiles a step
        const unsigned char* vr = V + (kc + 2 * cq) * kRowB +
                                  gq * kNT * (int)sizeof(KV);
#pragma unroll
        for (int jg = 0; jg < kNT / 8; ++jg) {
          if constexpr (kQuant) {
            uint2 w[4];
#pragma unroll
            for (int e = 0; e < 4; ++e)
              w[e] = *reinterpret_cast<const uint2*>(
                  vr + (e & 1) * kRowB + (e >> 1) * 8 * kRowB + jg * 8);
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) {
              const int k = jj & 3;
              const uint32_t x0 = jj < 4 ? w[0].x : w[0].y;
              const uint32_t x1 = jj < 4 ? w[1].x : w[1].y;
              const uint32_t x2 = jj < 4 ? w[2].x : w[2].y;
              const uint32_t x3 = jj < 4 ? w[3].x : w[3].y;
              const uint32_t v01 = int8_pair_to_bf16x2(x0, k, x1, k);
              const uint32_t v23 = int8_pair_to_bf16x2(x2, k, x3, k);
              mma_m16n8k16(o[jg * 8 + jj], pf, v01, v23);
              mma_m16n8k16(o[jg * 8 + jj], pl, v01, v23);
            }
          } else {
            uint4 w[4];
#pragma unroll
            for (int e = 0; e < 4; ++e)
              w[e] = *reinterpret_cast<const uint4*>(
                  vr + (e & 1) * kRowB + (e >> 1) * 8 * kRowB + jg * 16);
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) {
              const int wi = jj >> 1;
              const unsigned sel = (jj & 1) ? 0x7632u : 0x5410u;
              const uint32_t x0 = word_of(w[0], wi), x1 = word_of(w[1], wi);
              const uint32_t x2 = word_of(w[2], wi), x3 = word_of(w[3], wi);
              const uint32_t v01 = __byte_perm(x0, x1, sel);
              const uint32_t v23 = __byte_perm(x2, x3, sel);
              mma_m16n8k16(o[jg * 8 + jj], pf, v01, v23);
              mma_m16n8k16(o[jg * 8 + jj], pl, v01, v23);
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * st);   // this warp is done
    }
    cp_async_wait_all();
#pragma unroll
    for (int o2 = 1; o2 <= 2; o2 <<= 1) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, o2);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, o2);
    }
    __syncthreads();   // the ring is free: the combine reuses its bytes

    // the warps' partials: O [warp][16][kOS], m and l [warp][16]
    float* co = reinterpret_cast<float*>(raw_smem);
    float* cm = co + kWarps * 16 * kOS;
    float* cl = cm + kWarps * 16;
    if (active) {   // the rows of the group, not the tile's padding
      float* ow = co + warp * 16 * kOS;
      const bool a_in = ra < rows, b_in = rb < rows;
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = (2 * cq + e) * kNT + j;
          if (a_in) ow[gq * kOS + d] = o[j][e];
          if (b_in) ow[(gq + 8) * kOS + d] = o[j][2 + e];
        }
      if (cq == 0) {
        cm[warp * 16 + gq] = m_a;
        cm[warp * 16 + gq + 8] = m_b;
        cl[warp * 16 + gq] = l_a;
        cl[warp * 16 + gq + 8] = l_b;
      }
    }
    __syncthreads();
    // four neighbouring values a thread: the block's O, its tile's kw
    // warps weighed by exp(m_w - m), as the output (one live split) or
    // as its partial, with the row's (m, l) beside the row's first values;
    // the one split's output is x * (1 / l), the merge's arithmetic at
    // weight 1
    for (int idx = tid * 4; idx < rows * D; idx += kThreads * 4) {
      const int r = idx / D, d = idx % D;
      const int w0 = (r / 16) * kw, rr = r % 16;
      float mx = kNegInf;
      for (int k = 0; k < kw; ++k) mx = fmaxf(mx, cm[(w0 + k) * 16 + rr]);
      float l = 0.f;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int k = 0; k < kw; ++k) {
        const float mk = cm[(w0 + k) * 16 + rr];
        const float w = mk == kNegInf ? 0.f : exp2f((mk - mx) * kLog2e);
        l += w * cl[(w0 + k) * 16 + rr];
        const float4 v = *reinterpret_cast<const float4*>(
            co + ((w0 + k) * 16 + rr) * kOS + d);
        x.x += w * v.x; x.y += w * v.y; x.z += w * v.z; x.w += w * v.w;
      }
      if (n_live == 1) {
        store_bf16x4(out_at(r) + d, x, 1.f / fmaxf(l, 1e-30f));
      } else {
        const size_t row = (part0 + s) * R + row0 + r;
        __stcg(reinterpret_cast<float4*>(da.part_acc + row * D + d), x);
        if (d == 0)
          __stcg(reinterpret_cast<float2*>(da.part_ml + row * 2),
                 make_float2(mx, l));
      }
    }
  }
  if (n_live == 1) return;

  // The last of the row's live splits to arrive merges them all, in
  // split order s_lo..s_hi whichever arrives last, and resets the counter
  // to 0 for the next call. Partials are written and read at L2 (st.cg /
  // ld.cg), past any stale L1 line; the merge issues its loads before it
  // uses them (every row's (m, l), then 4 values x 4 splits a thread).
  __threadfence();
  __syncthreads();
  int* counter = da.counters + ((size_t)b * Hkv + h) * n_rg + rg;
  if (tid == 0) is_last = atomicAdd(counter, 1) == n_live - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  float* mw = reinterpret_cast<float*>(raw_smem);   // [64][kMaxSplits]
  {
    // a warp's rows four at a time, their loads issued together
#pragma unroll 1
    for (int r0 = warp; r0 < rows; r0 += 4 * kWarps) {
      float2 ml[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = r0 + k * kWarps;
        ml[k] = make_float2(kNegInf, 0.f);
        if (r < rows && lane < n_live)
          ml[k] = __ldcg(reinterpret_cast<const float2*>(
              da.part_ml + ((part0 + s_lo + lane) * R + row0 + r) * 2));
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = r0 + k * kWarps;
        if (r >= rows) break;   // uniform across the warp
        float mx = ml[k].x;
#pragma unroll
        for (int o2 = 16; o2 > 0; o2 >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o2));
        const float w = ml[k].x == kNegInf ? 0.f
                                           : exp2f((ml[k].x - mx) * kLog2e);
        float lsum = w * ml[k].y;
#pragma unroll
        for (int o2 = 16; o2 > 0; o2 >>= 1)
          lsum += __shfl_xor_sync(0xffffffffu, lsum, o2);
        mw[r * kMaxSplits + lane] = w / fmaxf(lsum, 1e-30f);
      }
    }
  }
  __syncthreads();
  // the thread's 4-value groups g = tid, tid + 128, ...: wide rows (at
  // least 2 groups a thread) 4 groups x 4 splits of loads in flight at
  // once, else 1 group x 16 splits; each value sums its splits in split
  // order either way (past n_live a load is off and its weight 0)
  const int n_groups = rows * D / 4;
  if (n_groups > kThreads)
    merge_groups<4, 4, D>(mw, da.part_acc, part0 + s_lo, R, row0, rows,
                          n_live, out_at);
  else
    merge_groups<1, 16, D>(mw, da.part_acc, part0 + s_lo, R, row0, rows,
                           n_live, out_at);
  if (tid == 0) *counter = 0;
}

// ------------------------------------------------------------ prefill

constexpr int kTileRows = 64;   // query rows of a wgmma tile (its M)
constexpr int kPanelKeys = 64;  // keys of a K/V panel (N of S = Q K^T)

// KV: the pool's element type, bf16 or int8_t
template <typename KV, int D>
struct PrefillGeometry {
  static constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  static constexpr int kStages = 3;
  static constexpr int kTileBytes = kTileRows * D * 2;   // [64, D] bf16
  // each stage's 64 K and 64 V scales (int8 pool only)
  static constexpr int kScaleBytes = kQuant ? kStages * 2 * kPanelKeys * 4 : 0;
  // the ring's 2 * kStages mbarriers (128 bytes), 1 KB of slack for the
  // alignment the 128-byte swizzle needs, Q, kStages (K, V) panels, then
  // the scales
  static constexpr int kSmemBytes =
      128 + 1024 + kTileBytes * (1 + 2 * kStages) + kScaleBytes;
  static_assert(kSmemBytes <= kMaxSmemBytes, "prefill tile too large");
};

// grid (B, Hkv, ceil(T / block_q)), block_q = 64 / G query positions;
// 256 threads: warpgroup 0 consumes (wgmma, softmax, output), warpgroup
// 1 produces (cp.async copies of Q and the K/V panels into the ring).
// Stage st of the ring has two mbarriers: full[st] completes when the
// producer's 128 threads' copies into it have landed, empty[st] when the
// consumer's 128 threads are done reading it.
//
// Over an int8 pool (KV = int8_t) wgmma still multiplies bf16: int8 ->
// bf16 is exact for -127..127, so the producer loads each 16-byte int8
// chunk into registers, casts it to two bf16 chunks and stores them into
// the same swizzled tile, with the panel's 64 K and 64 V scales beside
// the ring; its stores are generic-proxy writes, so each thread fences
// them to the async proxy and arrives on full[st] with an ordinary
// (release) arrive. The consumer applies the scales in f32 on its
// registers: score column j times ks[j] before the softcap and the mask
// (the cap acts on the dequantized raw score, pallas_paged.py:128-137),
// P column j times vs[j] just before P is rounded to bf16 for P.V (l
// sums the unscaled P). That is the Pallas f32 dequant up to the order of
// the f32 products, where rounding k8 * ks to bf16 would not be.
template <typename KV, int D>
__global__ void __launch_bounds__(2 * kThreads, 1)
paged_prefill_kernel(Args a) {
  using Geo = PrefillGeometry<KV, D>;
  constexpr bool kQuant = Geo::kQuant;
  constexpr int kStages = Geo::kStages, kTile = Geo::kTileBytes;
  constexpr int kChunks = D / 8;   // 16-byte chunks of a row
  extern __shared__ __align__(16) unsigned char raw_smem[];
  const uint32_t bars = smem_u32(raw_smem);
  const uint32_t base = (bars + 128u + 1023u) & ~1023u;
  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x;
  const int T_ = a.tile.T, H = a.tile.H, Hkv = a.tile.Hkv;
  const int G = H / Hkv, bq = a.tile.block_q;
  const int rows = bq * G;   // live rows of the tile, <= 64
  const int t0 = blockIdx.z * bq;
  const int last_t = min(t0 + bq, T_) - 1;
  const int start = a.starts[b];
  const int Bs = a.Bs;
  const int jend = min((start + last_t) / Bs, a.nb - 1);
  const int jmin = a.tile.window > 0
                       ? max(start + t0 - (a.tile.window - 1), 0) / Bs : 0;
  const int k_lo = jmin * Bs;
  const int k_hi = start >= a.MB * Bs ? k_lo : (jend + 1) * Bs;
  const int n_panels = k_hi > k_lo ? (k_hi - k_lo + kPanelKeys - 1) / kPanelKeys
                                   : 0;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.tile.q);
  // the scales of stage st: K at [st * 128, + 64), V at [st * 128 + 64, + 64)
  float* scl = reinterpret_cast<float*>(raw_smem + (base - bars) +
                                        kTile * (1 + 2 * kStages));

  if (tid == 0) {
    for (int st = 0; st < 2 * kStages; ++st) mbar_init(bars + 8 * st, kThreads);
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kThreads) {
    // producer: a thread copies 16-byte chunk `lc` of every kRowStep-th
    // row; Q goes with panel 0, so full[0] covers it
    constexpr int kRowStep = kThreads / kChunks;
    const int lc = (tid - kThreads) % kChunks, lr = (tid - kThreads) / kChunks;
    const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(a.k_pool);
    const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(a.v_pool);
    const int* table = a.tables + (size_t)b * a.MB;
    if (n_panels > 0) {
#pragma unroll
      for (int it = 0; it < kTileRows / kRowStep; ++it) {
        const int r = lr + it * kRowStep;
        const int t = t0 + r / G, g = r % G;
        const bool ok = r < rows && t < T_;
        const size_t off =
            ok ? (((size_t)b * T_ + t) * H + h * G + g) * D + lc * 8 : 0;
        cp_async16(base + sw128(r, lc), q + off, ok);
      }
      // the int8 panels arrive by plain stores: Q must have landed first
      if constexpr (kQuant) cp_async_wait<0>();
    }
    for (int i = 0; i < n_panels; ++i) {
      const int st = i % kStages;
      if (i >= kStages)   // the consumer is done with panel i - kStages
        mbar_wait(bars + 8 * (kStages + st), (i / kStages - 1) & 1);
      const uint32_t ks = base + kTile * (1 + 2 * st), vs = ks + kTile;
      if constexpr (kQuant) {
        const int ptid = tid - kThreads;
        {   // thread ptid brings K (ptid < 64) or V scale of key ptid % 64
          const int key = k_lo + i * kPanelKeys + (ptid & 63);
          const float* src = ptid < kPanelKeys ? a.k_scales : a.v_scales;
          scl[st * 2 * kPanelKeys + ptid] =
              key < k_hi ? src[key_index(a, table, h, key)] : 0.f;
        }
        // a thread takes 16-byte int8 chunk c8 (16 values) of every
        // kRowStep8-th row: loaded into registers, all issued first
        constexpr int kChunks8 = D / 16;
        constexpr int kRowStep8 = kThreads / kChunks8;
        constexpr int kRows8 = kPanelKeys / kRowStep8;
        const int c8 = ptid % kChunks8, r8 = ptid / kChunks8;
        const int8_t* kp8 = static_cast<const int8_t*>(a.k_pool);
        const int8_t* vp8 = static_cast<const int8_t*>(a.v_pool);
        uint4 kr[kRows8], vr[kRows8];
#pragma unroll
        for (int it = 0; it < kRows8; ++it) {
          const int key = k_lo + i * kPanelKeys + r8 + it * kRowStep8;
          kr[it] = vr[it] = make_uint4(0, 0, 0, 0);
          if (key < k_hi) {
            const size_t off = key_offset(a, table, h, key, D) + c8 * 16;
            kr[it] = __ldg(reinterpret_cast<const uint4*>(kp8 + off));
            vr[it] = __ldg(reinterpret_cast<const uint4*>(vp8 + off));
          }
        }
#pragma unroll
        for (int it = 0; it < kRows8; ++it) {
          const int r = r8 + it * kRowStep8;
          uint4 lo, hi;
          int8x16_to_bf16(kr[it], lo, hi);
          st_shared16(ks + sw128(r, 2 * c8), lo);
          st_shared16(ks + sw128(r, 2 * c8 + 1), hi);
          int8x16_to_bf16(vr[it], lo, hi);
          st_shared16(vs + sw128(r, 2 * c8), lo);
          st_shared16(vs + sw128(r, 2 * c8 + 1), hi);
        }
        fence_proxy_async();
        mbar_arrive(bars + 8 * st);
      } else {
        // the rows' table lookups first, so their latencies overlap
        size_t off[kPanelKeys / kRowStep];
#pragma unroll
        for (int it = 0; it < kPanelKeys / kRowStep; ++it) {
          const int key = k_lo + i * kPanelKeys + lr + it * kRowStep;
          off[it] = key < k_hi ? key_offset(a, table, h, key, D) + lc * 8 : 0;
        }
#pragma unroll
        for (int it = 0; it < kPanelKeys / kRowStep; ++it) {
          const int r = lr + it * kRowStep;
          const bool ok = k_lo + i * kPanelKeys + r < k_hi;
          cp_async16(ks + sw128(r, lc), kp + off[it], ok);
          cp_async16(vs + sw128(r, lc), vp + off[it], ok);
        }
        cp_async_mbar_arrive(bars + 8 * st);
      }
    }
    cp_async_wait<0>();
    return;
  }

  // consumer warpgroup
  const int lane = tid & 31, warp = tid >> 5;
  // accumulator rows of this thread: ra and ra + 8
  const int ra = warp * 16 + lane / 4, rb = ra + 8;
  const int qpos_a = start + t0 + ra / G, qpos_b = start + t0 + rb / G;
  float o[D / 64][32];
#pragma unroll
  for (int n = 0; n < D / 64; ++n)
#pragma unroll
    for (int j = 0; j < 32; ++j) o[n][j] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;

  {
    const int limit = a.nb * Bs;
    const float scale = a.tile.scale, cap = a.tile.softcap;
    const float cap_k = cap != 0.f ? 2.f * kLog2e / cap : 0.f;
    const int window = a.tile.window;
    // S = Q K^T of panel i over D in steps of 16, issued, not waited for
    auto issue_scores = [&](int i, float (&acc)[32]) {
      const int st = i % kStages;
      mbar_wait(bars + 8 * st, (i / kStages) & 1);
      fence_proxy_async();
      const uint32_t ks = base + kTile * (1 + 2 * st);
#pragma unroll
      for (int j = 0; j < 32; ++j) acc[j] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk >> 2) * 8192 + (kk & 3) * 32;
        wgmma_m64n64k16_ss(acc, wgmma_desc(base + off, 16, 1024),
                           wgmma_desc(ks + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
    };
    float s[32];
    if (n_panels > 0) {
      issue_scores(0, s);
      wgmma_wait_all();
      fence_regs(s);
    }
    for (int i = 0; i < n_panels; ++i) {
      const int st = i % kStages;
      const uint32_t vs = base + kTile * (2 + 2 * st);
      // the next panel's scores run on the tensor cores while this
      // panel's softmax runs on the CUDA cores
      float s_next[32];
      const bool more = i + 1 < n_panels;
      if (more) issue_scores(i + 1, s_next);

      // scale (and the int8 pool's K scale), cap, mask; column of s[j]:
      // 8*(j/4) + 2*(lane%4) + j%2, row ra for (j/2)%2 == 0, else rb
      const int kbase = k_lo + i * kPanelKeys;
      const float* ksm = scl + st * 2 * kPanelKeys;   // int8 pool only
      const float* vsm = ksm + kPanelKeys;
      float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int col = 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
        const int k_pos = kbase + col;
        const int qp = (j & 2) ? qpos_b : qpos_a;
        float x = s[j] * scale;
        if constexpr (kQuant) x *= ksm[col];
        if (cap != 0.f) {
          // cap * tanh(x / cap) as cap * (1 - 2 / (e^(2x/cap) + 1)):
          // absolute error ~1e-7 of the tanh, a few instructions
          const float e = exp2f(x * cap_k);
          x = cap * (1.f - __fdividef(2.f, e + 1.f));
        }
        const bool live = k_pos <= qp && k_pos < limit &&
                          (window <= 0 || k_pos > qp - window);
        x = live ? x : kNegInf;
        s[j] = x;
        if (j & 2) mx_b = fmaxf(mx_b, x); else mx_a = fmaxf(mx_a, x);
      }
#pragma unroll
      for (int o2 = 1; o2 <= 2; o2 <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o2));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o2));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      // a panel wholly masked for a row so far gives p = 1 over it; the
      // correction exp(-1e30 - m) = 0 at the row's first live key wipes it
      const float c_a = exp2f((m_a - mn_a) * kLog2e);
      const float c_b = exp2f((m_b - mn_b) * kLog2e);
      m_a = mn_a;
      m_b = mn_b;
      // P in bf16 as the A operand of P V: the accumulator's columns
      // 16kk..16kk+15 are exactly A's registers for k-step kk
      uint32_t p[4][4];
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 8 * kk + 2 * e;
          const float mn = (e & 1) ? mn_b : mn_a;
          const float p0 = exp2f((s[j] - mn) * kLog2e);
          const float p1 = exp2f((s[j + 1] - mn) * kLog2e);
          if (e & 1) sum_b += p0 + p1; else sum_a += p0 + p1;
          if constexpr (kQuant) {   // V's scales on P's columns
            const int c0 = 16 * kk + 8 * (e >> 1) + 2 * (lane & 3);
            p[kk][e] = pack_bf16x2(p0 * vsm[c0], p1 * vsm[c0 + 1]);
          } else {
            p[kk][e] = pack_bf16x2(p0, p1);
          }
        }
      l_a = l_a * c_a + sum_a;
      l_b = l_b * c_b + sum_b;
#pragma unroll
      for (int n = 0; n < D / 64; ++n)
#pragma unroll
        for (int j = 0; j < 32; ++j) o[n][j] *= (j & 2) ? c_b : c_a;

      // O += P V: 16 keys a step, V MN-major, 64 output columns a call
#pragma unroll
      for (int n = 0; n < D / 64; ++n) fence_regs(o[n]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs(p[kk]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int n = 0; n < D / 64; ++n)
          wgmma_m64n64k16_rs_tb(
              o[n], p[kk], wgmma_desc(vs + n * 8192 + kk * 2048, 8192, 1024));
      wgmma_commit();
      wgmma_wait_all();   // this panel's P V and the next panel's S
#pragma unroll
      for (int n = 0; n < D / 64; ++n) fence_regs(o[n]);
      mbar_arrive(bars + 8 * (kStages + st));   // the stage may refill
      if (more) {
        fence_regs(s_next);
#pragma unroll
        for (int j = 0; j < 32; ++j) s[j] = s_next[j];
      }
    }
  }

  // row sums over the 4 lanes that share a row
#pragma unroll
  for (int o2 = 1; o2 <= 2; o2 <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, o2);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, o2);
  }
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f);
  const float inv_b = 1.f / fmaxf(l_b, 1e-30f);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.tile.out);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? rb : ra;
    const int t = t0 + r / G, g = r % G;
    if (r >= rows || t >= T_) continue;
    const float inv = half ? inv_b : inv_a;
    __nv_bfloat16* orow = out + (((size_t)b * T_ + t) * H + h * G + g) * D;
#pragma unroll
    for (int n = 0; n < D / 64; ++n)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int d = n * 64 + 8 * jj + 2 * (lane & 3);
        const int j = 4 * jj + 2 * half;
        *reinterpret_cast<__nv_bfloat162*>(orow + d) =
            __floats2bfloat162_rn(o[n][j] * inv, o[n][j + 1] * inv);
      }
  }
}

// float32 prefill: the f32 FMA tile over the row's [Bs, D] panels.
// Panel j of one (batch row, kv head): pool block tables[b, j], a
// contiguous [Bs, D] tile, block index and id clamped. KV: the pool's
// element type, float or int8_t; an int8 panel is staged as float(k8) *
// ks, its f32 scales read through the same clamped block id
// (pallas_paged.py:125-131 dequantizes every panel in f32).
template <typename KV, int D>
struct PagedPanel {
  static constexpr int kKeys = 0;   // Bs, a runtime value
  const KV* k_pool;
  const KV* v_pool;
  const float* k_scales;   // int8 pool only
  const float* v_scales;
  const int* table;   // row b of the block tables
  int h, Hkv, MB, N;
  int keys;           // Bs
  int limit;          // nb * Bs: the loop never reaches a block past nb

  template <int kThreads>
  __device__ void load(int j, float* ks, float* vs, int tid) const {
    const int jj = min(max(j, 0), MB - 1);
    const int blk = min(max(table[jj], 0), N - 1);
    const size_t row0 = ((size_t)blk * Hkv + h) * (size_t)keys;
    const KV* kb = k_pool + row0 * D;
    const KV* vb = v_pool + row0 * D;
    for (int idx = tid; idx < keys * D; idx += kThreads) {
      const int c = idx / D, d = idx - (idx / D) * D;
      if constexpr (std::is_same<KV, int8_t>::value) {
        ks[c * (D + 1) + d] = to_f32(kb[idx]) * k_scales[row0 + c];
        vs[idx] = to_f32(vb[idx]) * v_scales[row0 + c];
      } else {
        ks[c * (D + 1) + d] = kb[idx];
        vs[idx] = vb[idx];
      }
    }
  }
};

// grid (B, Hkv, ceil(T / block_q)); a parked row has no panel to read
template <typename KV, int D>
__global__ void __launch_bounds__(kTileThreads)
paged_prefill_tile_kernel(Args a) {
  const int b = blockIdx.x, h = blockIdx.y;
  const int start = a.starts[b];
  const PagedPanel<KV, D> panel{
      static_cast<const KV*>(a.k_pool), static_cast<const KV*>(a.v_pool),
      a.k_scales, a.v_scales, a.tables + (size_t)b * a.MB, h, a.tile.Hkv,
      a.MB, a.N, a.Bs, a.nb * a.Bs};
  attend_tile<float, D, kTileThreads>(a.tile, panel, b, h, blockIdx.z, start,
                                      start >= a.MB * a.Bs ? 0 : a.nb);
}

// T: q's type; KV: the pool's (T or int8_t). bf16 q: one launch of the
// tensor-core kernel (grid z: splits x row groups); float32 q: the f32
// kernel, then the merge kernel.
template <typename T, typename KV, int D>
int launch_decode(const DecodeArgs& da, cudaStream_t stream) {
  const Args& a = da.a;
  const int R = a.tile.T * (a.tile.H / a.tile.Hkv);
  if constexpr (sizeof(T) == 2) {
    const int n_rg = (R + kRowGroup - 1) / kRowGroup;
    const int q_rows = ((R < kRowGroup ? R : kRowGroup) + 15) / 16 * 16;
    using Geo = MmaDecodeGeometry<KV, D>;
    DecodeArgs db = da;
    db.stages = Geo::stages(da.bps, a.Bs);
    return launch_tile_kernel<paged_decode_mma_kernel<KV, D>>(
        dim3(a.B, a.tile.Hkv, da.splits * n_rg), kThreads,
        Geo::smem_bytes(db.stages, q_rows), db, stream);
  } else {
    int rc = launch_tile_kernel<paged_decode_kernel<T, KV, D>>(
        dim3(a.B, a.tile.Hkv, da.splits), kThreads,
        DecodeGeometry<KV, D>::smem_bytes(R), da, stream);
    if (rc != 0) return rc;
    return launch_tile_kernel<paged_decode_merge_kernel<T, D>>(
        dim3(a.B, a.tile.Hkv, (R * D + kThreads - 1) / kThreads), kThreads,
        0, da, stream);
  }
}

template <typename T, typename KV, int D>
int launch_prefill(const Args& a, cudaStream_t stream) {
  const dim3 grid(a.B, a.tile.Hkv,
                  (a.tile.T + a.tile.block_q - 1) / a.tile.block_q);
  if constexpr (sizeof(T) == 2) {
    if (a.tile.block_q * (a.tile.H / a.tile.Hkv) > kTileRows)
      return kBadShape;
    return launch_tile_kernel<paged_prefill_kernel<KV, D>>(
        grid, 2 * kThreads, PrefillGeometry<KV, D>::kSmemBytes, a, stream);
  } else {
    const int rows = a.tile.block_q * (a.tile.H / a.tile.Hkv);
    return launch_tile_kernel<paged_prefill_tile_kernel<KV, D>>(
        grid, kTileThreads, tile_smem_floats(rows, D, a.Bs) * 4, a, stream);
  }
}

template <typename T, typename KV>
int dispatch_decode(int D, const DecodeArgs& da, cudaStream_t stream) {
  if (D == 64) return launch_decode<T, KV, 64>(da, stream);
  if (D == 128) return launch_decode<T, KV, 128>(da, stream);
  if (D == 256) return launch_decode<T, KV, 256>(da, stream);
  return kBadHeadDim;
}

template <typename T, typename KV>
int dispatch_prefill(int D, const Args& a, cudaStream_t stream) {
  if (D == 64) return launch_prefill<T, KV, 64>(a, stream);
  if (D == 128) return launch_prefill<T, KV, 128>(a, stream);
  if (D == 256) return launch_prefill<T, KV, 256>(a, stream);
  return kBadHeadDim;
}

// dtype codes: 0 = float32, 1 = bfloat16 (q and out), kv_dtype the
// pool's: q's own, or 2 = int8 with both scales. 0 if the pair is
// taken, else the error code.
int check_dtypes(int dtype, int kv_dtype, const float* k_scales,
                 const float* v_scales) {
  if (dtype != 0 && dtype != 1) return kBadDtype;
  if (kv_dtype == 2) return k_scales && v_scales ? 0 : kBadScales;
  if (kv_dtype != dtype) return kBadDtype;
  return k_scales || v_scales ? kBadScales : 0;
}

bool bad_shape(int B, int T, int H, int Hkv, int Bs, int MB, int nb, int N,
               int window, float softcap) {
  return B <= 0 || T <= 0 || Hkv <= 0 || H % Hkv || Bs <= 0 || MB <= 0 ||
         nb <= 0 || nb > MB || N <= 0 || window < 0 || softcap < 0.f;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q and out); kv_dtype: the pools',
// the same as dtype (k_scales, v_scales null) or 2 = int8 with k_scales
// and v_scales [N, Hkv, Bs] f32; window 0 and softcap 0 turn those
// branches off. part_ml / part_acc:
// f32 scratch of [B, Hkv, splits, T*H/Hkv, 2] and [.., D] values (the
// latter 16-byte aligned); the
// plan (bps, splits) must cover blocks 0..nb-1 with at most 32 splits.
// counters (bf16 q): n_counters ints, at least B * Hkv * ceil(T*H/Hkv /
// 64), all 0, which every call leaves 0 again; calls that share them must
// not run at once (one stream). bf16 q: one launch, whose last block of a
// row's splits merges them; float32 q: the split kernel, then the merge
// kernel.
int paged_decode_attention(const void* q, const void* k_pool,
                           const void* v_pool, const float* k_scales,
                           const float* v_scales, const int* tables,
                           const int* starts, void* out, float* part_ml,
                           float* part_acc, int* counters, int dtype,
                           int kv_dtype, int B, int T, int H, int Hkv, int D,
                           int Bs, int MB, int nb, int N, int bps, int splits,
                           int n_counters, float scale, int window,
                           float softcap, void* stream) {
  if (bad_shape(B, T, H, Hkv, Bs, MB, nb, N, window, softcap) || bps <= 0 ||
      splits <= 0 || splits > kMaxSplits || splits * bps < nb ||
      (splits - 1) * bps >= nb)
    return kBadShape;
  const int rc = check_dtypes(dtype, kv_dtype, k_scales, v_scales);
  if (rc != 0) return rc;
  const long n_rg = (T * (H / Hkv) + kRowGroup - 1) / kRowGroup;
  if (dtype == 1 && (!counters || (long)B * Hkv * n_rg > n_counters))
    return kBadShape;
  const DecodeArgs da{{{q, out, T, H, Hkv, T, scale, window, softcap},
                       k_pool, v_pool, k_scales, v_scales, tables, starts, B,
                       Bs, MB, nb, N},
                      part_ml, part_acc, counters, bps, splits, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool q8 = kv_dtype == 2;
  if (dtype == 0)
    return q8 ? dispatch_decode<float, int8_t>(D, da, s)
              : dispatch_decode<float, float>(D, da, s);
  return q8 ? dispatch_decode<__nv_bfloat16, int8_t>(D, da, s)
            : dispatch_decode<__nv_bfloat16, __nv_bfloat16>(D, da, s);
}

// block_q: query positions per tile (bf16: 64 / G, the wgmma tile; f32:
// the f32 tile's, ops/paged_attention.py tile_block_q)
int paged_prefill_attention(const void* q, const void* k_pool,
                            const void* v_pool, const float* k_scales,
                            const float* v_scales, const int* tables,
                            const int* starts, void* out, int dtype,
                            int kv_dtype, int B, int T, int H, int Hkv, int D,
                            int Bs, int MB, int nb, int N, int block_q,
                            float scale, int window, float softcap,
                            void* stream) {
  if (bad_shape(B, T, H, Hkv, Bs, MB, nb, N, window, softcap) ||
      block_q <= 0)
    return kBadShape;
  const int rc = check_dtypes(dtype, kv_dtype, k_scales, v_scales);
  if (rc != 0) return rc;
  const Args a{{q, out, T, H, Hkv, block_q, scale, window, softcap},
               k_pool, v_pool, k_scales, v_scales, tables, starts, B, Bs, MB,
               nb, N};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool q8 = kv_dtype == 2;
  if (dtype == 0)
    return q8 ? dispatch_prefill<float, int8_t>(D, a, s)
              : dispatch_prefill<float, float>(D, a, s);
  return q8 ? dispatch_prefill<__nv_bfloat16, int8_t>(D, a, s)
            : dispatch_prefill<__nv_bfloat16, __nv_bfloat16>(D, a, s);
}

const char* paged_attention_error_string(int code) {
  return error_string(code);
}

}  // extern "C"
