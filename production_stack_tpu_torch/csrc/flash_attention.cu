// Causal GQA over a contiguous KV cache for Hopper (sm_90a): the kernel
// that replaces _flash_kernel / flash_attention_with_cache of
// production_stack_tpu/ops/pallas_attention.py:120-246.
//
// Contract: q [B, T, H, D]; k/v cache [B, S, Hkv, D] in their native
// layout (the cache already holds the chunk's own K/V); starts [B] int32
// = absolute position of q[:, 0]. Query t of row b sits at starts[b] + t
// and attends cache slots s <= its position (and s < S). Scale D**-0.5,
// f32 online softmax and f32 accumulation; output acc / max(l, 1e-30) in
// q's dtype. A row whose position is past S - 1 attends all S slots, as
// the jnp path does (the caller discards it).
//
// BFLOAT16: flash_kernel. What bounds it on an H100: at a 512-token
// chunk over a 1024-slot cache it does ~T/2 operations per K/V byte, so
// the tensor cores would (16.1 GFLOP, 0.0163 ms at q [4, 512, 32, 128]).
// Measured, the CUDA cores' softmax sets the pace instead: per 128-key
// panel a warpgroup's softmax takes longer than the other warpgroup's
// products (PERF.md, PR 4). Neither the L2 nor shared memory does.
//
// - A thread block owns a tile of 128 flattened query rows r = t*G + g of
//   one (row, kv head) (the Pallas kernel's order, :139-141): any G,
//   including one that does not divide 128, every row masked by its own
//   position. Two consumer warpgroups run S = Q K^T and O += P V as bf16
//   wgmma on 64 rows each, f32 accumulators in registers, the online
//   softmax on the accumulator registers (P to bf16 as the register A
//   operand, V the MN-major B operand). Both read the same K/V panel, so
//   a panel feeds 128 rows.
// - The warpgroups take turns at the tensor cores (two named barriers):
//   each issues S(i) and P(i-1) V(i-1) together and hands the turn on, so
//   its softmax(i) runs while the other warpgroup's products do.
// - One producer thread issues the panels by TMA from the native layout:
//   one 4-D tensor map per cache, dims (D, Hkv, S, B), box (64, 1, keys,
//   1) with the 128-byte swizzle, so a box lands as one [keys, 64 values]
//   column block exactly as wgmma's descriptor reads it (hopper.cuh
//   sw128). Slots past S arrive as zeros: no bounds code. A ring of
//   stages, each a K and a V panel with their own full (expect_tx) and
//   empty mbarriers: K is released once its scores are done, V once its
//   product is, so the ring refills K while V is still read.
// - Panels are 128 keys (an m64n128k16 score product) at D <= 128 and 64
//   at D = 256, where a thread's 128 accumulator registers leave room for
//   no more scores.
// - Q is loaded by each consumer warpgroup with per-row cp.async into the
//   same swizzled layout (rows t >= T zero-filled).
// - Key panels past the tile's last position are not read (:146-148), and
//   the tiles with the most panels start first.
// - The softmax works in the log2 domain, the scale folded into one FFMA
//   a score before ex2.approx; only a panel that may hold a dead key for
//   some row of the warpgroup is masked, one compare a score.
// - Registers: the producer warpgroup drops to 40 a thread and the
//   consumers rise to 232 (setmaxnreg); ptxas reports the launch's 168.
// - Shared memory: FlashGeometry, mirrored by ops/flash_attention.py
//   flash_tile.
// - Tried and measured slower (PERF.md, PR 4): a 2-CTA cluster
//   multicasting each panel to two tiles, a persistent grid (a static and
//   an atomic tile walk), three consumer warpgroups on 192-row tiles.
//
// FLOAT32: wgmma has no full-f32 form (TF32 would not hold the f32
// checks), so f32 runs flash_tile_kernel, the f32 FMA tile of
// attention_tile.cuh over [64, D] panels read strided over Hkv from the
// native layout, the last one ragged and bounds-checked.
//
// Plain C interface (nvcc -shared, loaded with ctypes). The entry point
// encodes the tensor maps on the host (cuTensorMapEncodeTiled through the
// runtime's driver entry point, so the library links no -lcuda),
// launches on the given stream, allocates nothing, never synchronises,
// and returns cudaGetLastError() (or a negative code for arguments it
// refuses).

#include <cuda.h>

#include "attention_tile.cuh"
#include "hopper.cuh"

namespace {

constexpr int kTileThreads = 256;   // float32 tile
constexpr int kBlockK = 64;         // keys per float32 panel
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTensorMapFailed = -6;

// 2^x, one MUFU.EX2 (flushes denormals; exp2f adds range handling)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------------------------ float32

struct Args {
  TileArgs tile;
  const void* k;
  const void* v;
  const int* starts;
  int B, S;
};

// Panel j of one (batch row, kv head): cache slots j*keys .. j*keys +
// keys - 1, each a row of D contiguous values Hkv*D apart; slots past S
// are zeros (and masked by the tile).
template <int D>
struct StridedPanel {
  static constexpr int kKeys = kBlockK;
  const float* k;   // slot 0 of kv head h in row b
  const float* v;
  size_t stride;    // Hkv * D
  int keys;         // kBlockK
  int limit;        // S

  template <int kThreads>
  __device__ void load(int j, float* ks, float* vs, int tid) const {
    for (int idx = tid; idx < kKeys * D; idx += kThreads) {
      const int c = idx / D, d = idx - (idx / D) * D;
      const int s = j * kKeys + c;
      float kx = 0.f, vx = 0.f;
      if (s < limit) {
        const size_t off = (size_t)s * stride + d;
        kx = k[off];
        vx = v[off];
      }
      ks[c * (D + 1) + d] = kx;
      vs[idx] = vx;
    }
  }
};

// grid (B, Hkv, ceil(T / block_q)): kv head blockIdx.y of batch row
// blockIdx.x, query tile blockIdx.z
template <int D>
__global__ void __launch_bounds__(kTileThreads) flash_tile_kernel(Args a) {
  const int b = blockIdx.x, h = blockIdx.y;
  const size_t stride = (size_t)a.tile.Hkv * D;
  const size_t base = (size_t)b * a.S * stride + (size_t)h * D;
  const StridedPanel<D> panel{static_cast<const float*>(a.k) + base,
                              static_cast<const float*>(a.v) + base, stride,
                              kBlockK, a.S};
  attend_tile<float, D, kTileThreads>(a.tile, panel, b, h, blockIdx.z,
                                      a.starts[b],
                                      (a.S + kBlockK - 1) / kBlockK);
}

// ------------------------------------------------------------ bfloat16

struct FlashArgs {
  const __nv_bfloat16* q;   // [B, T, H, D]
  __nv_bfloat16* out;       // [B, T, H, D]
  const int* starts;        // [B]
  int B, T, H, Hkv, S;
  float scale;
};

template <int D>
struct FlashGeometry {
  static constexpr int kConsumers = 2;              // warpgroups, 64 rows each
  static constexpr int kRows = 64 * kConsumers;     // query rows of a tile
  static constexpr int kThreads = 128 * (kConsumers + 1);
  // keys of a K/V panel: 128 (the N of an m64n128k16 score product) where
  // the registers allow it, 64 at D = 256
  static constexpr int kKeys = D == 256 ? 64 : 128;
  static constexpr int kTileBytes = 64 * D * 2;     // a warpgroup's Q
  static constexpr int kPanelBytes = kKeys * D * 2;
  static constexpr int kStages = D == 64 ? 4 : D == 128 ? 3 : 2;
  // the ring's 4 * kStages mbarriers (128 bytes), 1 KB of slack for the
  // alignment the 128-byte swizzle needs, the consumers' Q, then kStages
  // (K, V) panels
  static constexpr int kSmemBytes = 128 + 1024 + kTileBytes * kConsumers +
                                    2 * kStages * kPanelBytes;
  static_assert(kSmemBytes <= kMaxSmemBytes, "flash tile too large");
  static_assert(4 * kStages * 8 <= 128, "the ring's barriers take 128 B");
};

// grid (B * Hkv, tiles): (row, kv head) blockIdx.x, query tile
// gridDim.y - 1 - blockIdx.y (the hardware starts blocks in index order,
// so the longest tiles first). Warpgroups 0 and 1 consume, warpgroup 2
// produces. Stage st of the ring holds a K and a V panel, each with two
// mbarriers: full completes when its bytes have landed, empty when both
// consumer warpgroups have released it. K and V are released apart: a K
// panel once its scores are done, a V panel once its product is, so the
// ring refills K while V is still read. Named barriers 1 and 2 gather a
// consumer warpgroup's Q copies; 3 and 4 are the consumers' turns to
// issue wgmma.
template <int D>
__global__ void __launch_bounds__(FlashGeometry<D>::kThreads, 1)
flash_kernel(const __grid_constant__ CUtensorMap k_map,
             const __grid_constant__ CUtensorMap v_map, const FlashArgs a) {
  using Geo = FlashGeometry<D>;
  constexpr int kStages = Geo::kStages, kTile = Geo::kTileBytes;
  constexpr int kRows = Geo::kRows, kConsumers = Geo::kConsumers;
  constexpr int kKeys = Geo::kKeys, kPanel = Geo::kPanelBytes;
  constexpr int kBlock = kKeys * 128;   // a panel's [kKeys, 64] column block
  extern __shared__ __align__(16) unsigned char raw_smem[];
  const uint32_t bars = smem_u32(raw_smem);
  const uint32_t base = (bars + 128u + 1023u) & ~1023u;
  const uint32_t ring = base + kConsumers * kTile;
  const int tid = threadIdx.x;
  const int T_ = a.T, H = a.H, Hkv = a.Hkv, S = a.S;
  const int G = H / Hkv, R = T_ * G;
  const int b = blockIdx.x / Hkv, h = blockIdx.x % Hkv;
  const int z = gridDim.y - 1 - blockIdx.y;
  const int start = a.starts[b];
  // panels the tile reads: keys up to its last row's position, within S
  const int last_t = (min(z * kRows + kRows, R) - 1) / G;
  const int kmax = min(start + last_t, S - 1);
  const int n_panels = kmax >= 0 ? kmax / kKeys + 1 : 0;

  // barriers of stage st: full K, full V, empty K, empty V
  auto bar = [&](int kind, int st) {
    return bars + 8 * (kind * kStages + st);
  };
  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar(0, st), 1);
      mbar_init(bar(1, st), 1);
      mbar_init(bar(2, st), kConsumers);
      mbar_init(bar(3, st), kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 128 * kConsumers) {
    // producer: one thread issues every copy, K then V of each panel
    setmaxnreg_dec<40>();
    if (tid == 128 * kConsumers) {
      for (int i = 0; i < n_panels; ++i) {
        const int st = i % kStages;
#pragma unroll
        for (int kind = 0; kind < 2; ++kind) {
          if (i >= kStages)   // both warpgroups are done with i - kStages
            mbar_wait(bar(2 + kind, st), (i / kStages - 1) & 1);
          const uint32_t full = bar(kind, st);
          const uint32_t dst = ring + (2 * st + kind) * kPanel;
          mbar_arrive_expect_tx(full, kPanel);
#pragma unroll
          for (int cb = 0; cb < D / 64; ++cb)
            tma_load_4d(dst + cb * kBlock, kind ? &v_map : &k_map, full,
                        cb * 64, h, i * kKeys, b);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: tile rows wg*64 .. wg*64 + 63
  setmaxnreg_inc<232>();
  const int wg = tid >> 7, ct = tid & 127;
  const int lane = ct & 31, warp = ct >> 5;
  const int r0 = z * kRows + wg * 64;   // its first flattened row
  const uint32_t qs = base + wg * kTile;
  {
    // Q, zero past T: thread ct copies 16-byte chunk lc of every
    // kRowStep-th row
    constexpr int kChunks = D / 8, kRowStep = 128 / kChunks;
    const int lc = ct % kChunks, lr = ct / kChunks;
#pragma unroll
    for (int it = 0; it < 64 / kRowStep; ++it) {
      const int r = lr + it * kRowStep;
      const int t = (r0 + r) / G, g = (r0 + r) - t * G;
      const bool ok = t < T_;
      const size_t off =
          ok ? (((size_t)b * T_ + t) * H + h * G + g) * D + lc * 8 : 0;
      cp_async16(qs + sw128(r, lc), a.q + off, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    fence_proxy_async();
    named_barrier_sync(1 + wg, 128);
  }

  // accumulator rows of this thread: ra and ra + 8
  const int ra = warp * 16 + lane / 4, rb = ra + 8;
  const int qpos_a = start + (r0 + ra) / G, qpos_b = start + (r0 + rb) / G;
  float o[D / 64][32];
#pragma unroll
  for (int n = 0; n < D / 64; ++n)
#pragma unroll
    for (int j = 0; j < 32; ++j) o[n][j] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
  float c_a = 1.f, c_b = 1.f;   // the last softmax's corrections
  constexpr int kS = kKeys / 2;   // score registers of a thread
  float s[kS];                    // scores, then exp(scores - m)
  uint32_t p[kKeys / 16][4];      // the last panel's P in bf16

  // The two warpgroups take turns to issue their products (barrier 3 +
  // wg is this one's turn): S(i) and P(i-1) V(i-1) are issued together,
  // the turn passes, and softmax(i) runs on the CUDA cores while the
  // other warpgroup's products run on the tensor cores. A tile issues
  // n_panels + 1 times; warpgroup 1 gives warpgroup 0 the first turn and
  // does not pass its last one on.
  const int my_turn = 3 + wg, next_turn = 3 + (wg ^ 1);
  auto take_turn = [&]() { named_barrier_sync(my_turn, 256); };
  auto pass_turn = [&]() { named_barrier_arrive(next_turn, 256); };
  const float scale_log2 = a.scale * kLog2e;
  // keys up to this one are live for every row of the warpgroup
  const int k_whole = min(start + r0 / G, S - 1);
  // S = Q K^T of panel i over D in steps of 16, issued and committed
  auto issue_scores = [&](int i) {
    const uint32_t ks = ring + 2 * (i % kStages) * kPanel;
#pragma unroll
    for (int j = 0; j < kS; ++j) s[j] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint64_t qd =
          wgmma_desc(qs + (kk >> 2) * 8192 + (kk & 3) * 32, 16, 1024);
      const uint64_t kd =
          wgmma_desc(ks + (kk >> 2) * kBlock + (kk & 3) * 32, 16, 1024);
      if constexpr (kKeys == 128)
        wgmma_m64n128k16_ss(s, qd, kd, kk > 0);
      else
        wgmma_m64n64k16_ss(s, qd, kd, kk > 0);
    }
    wgmma_commit();
  };
  // O = O * c + P V of panel i: 16 keys a step, V MN-major, 64 output
  // columns a call, issued and committed
  auto issue_pv = [&](int i) {
    const uint32_t vs = ring + (2 * (i % kStages) + 1) * kPanel;
#pragma unroll
    for (int n = 0; n < D / 64; ++n)
#pragma unroll
      for (int j = 0; j < 32; ++j) o[n][j] *= (j & 2) ? c_b : c_a;
#pragma unroll
    for (int n = 0; n < D / 64; ++n) fence_regs(o[n]);
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) fence_regs(p[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
#pragma unroll
      for (int n = 0; n < D / 64; ++n)
        wgmma_m64n64k16_rs_tb(
            o[n], p[kk],
            wgmma_desc(vs + n * kBlock + kk * 2048, kBlock, 1024));
    wgmma_commit();
  };
  // softmax of panel i's raw scores in s, in the log2 domain (the scale
  // folds into one FFMA a score): mask only a panel that may hold a dead
  // key for some row of the warpgroup (past its position or past S), one
  // compare a score; online max and sum in two chains a row; leaves
  // exp(scale * (s - m)) in s and the corrections in c_a, c_b. Column of
  // s[j]: 8*(j/4) + 2*(lane%4) + j%2, row ra for (j/2)%2 == 0, else rb
  auto softmax = [&](int i) {
    const int kbase = i * kKeys;
    if (kbase + kKeys - 1 > k_whole) {
      const int lim_a = min(qpos_a, S - 1) - kbase - 2 * (lane & 3);
      const int lim_b = min(qpos_b, S - 1) - kbase - 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < kS; ++j)
        if (8 * (j >> 2) + (j & 1) > ((j & 2) ? lim_b : lim_a))
          s[j] = kNegInf;
    }
    float mx[4] = {kNegInf, kNegInf, kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kS; ++j) {
      const int c = (j & 2) + ((j >> 2) & 1);   // row and chain
      mx[c] = fmaxf(mx[c], s[j]);
    }
    float mx_a = fmaxf(mx[0], mx[1]), mx_b = fmaxf(mx[2], mx[3]);
#pragma unroll
    for (int o2 = 1; o2 <= 2; o2 <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o2));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    c_a = fast_exp2((m_a - mn_a) * scale_log2);
    c_b = fast_exp2((m_b - mn_b) * scale_log2);
    m_a = mn_a;
    m_b = mn_b;
    // a row with no live key yet keeps p = 0 (its m is the sentinel)
    const float off_a = mn_a == kNegInf ? 0.f : -mn_a * scale_log2;
    const float off_b = mn_b == kNegInf ? 0.f : -mn_b * scale_log2;
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kS; ++j) {
      const float e =
          fast_exp2(fmaf(s[j], scale_log2, (j & 2) ? off_b : off_a));
      s[j] = e;
      sum[(j & 2) + ((j >> 2) & 1)] += e;
    }
    l_a = l_a * c_a + (sum[0] + sum[1]);
    l_b = l_b * c_b + (sum[2] + sum[3]);
  };
  // P in bf16 as the A operand of P V: the accumulator's columns
  // 16kk..16kk+15 are exactly A's registers for k-step kk
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[kk][e] = pack_bf16x2(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
  };
  // kind 0 = K, 1 = V of panel i: wait until it has landed; free it
  // once the warpgroup's wgmma have read it (one arrival)
  auto wait_full = [&](int kind, int i) {
    mbar_wait(bar(kind, i % kStages), (i / kStages) & 1);
  };
  auto release = [&](int kind, int i) {
    if (ct == 0) mbar_arrive(bar(2 + kind, i % kStages));
  };

  if (n_panels > 0) {
    if (wg == 1) named_barrier_arrive(3, 256);
    wait_full(0, 0);
    take_turn();
    issue_scores(0);
    pass_turn();
    wgmma_wait<0>();
    fence_regs(s);
    release(0, 0);
    softmax(0);
    pack_p();
    for (int i = 1; i < n_panels; ++i) {
      wait_full(0, i);
      wait_full(1, i - 1);
      take_turn();
      issue_scores(i);
      issue_pv(i - 1);
      pass_turn();
      wgmma_wait<1>();   // S(i); P(i-1) V(i-1) may still run
      fence_regs(s);
      release(0, i);
      softmax(i);
      wgmma_wait<0>();
#pragma unroll
      for (int n = 0; n < D / 64; ++n) fence_regs(o[n]);
      release(1, i - 1);
      pack_p();
    }
    wait_full(1, n_panels - 1);
    take_turn();
    issue_pv(n_panels - 1);
    if (wg == 0) pass_turn();
    wgmma_wait<0>();
#pragma unroll
    for (int n = 0; n < D / 64; ++n) fence_regs(o[n]);
    release(1, n_panels - 1);
  }

  // row sums over the 4 lanes that share a row
#pragma unroll
  for (int o2 = 1; o2 <= 2; o2 <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, o2);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, o2);
  }
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f);
  const float inv_b = 1.f / fmaxf(l_b, 1e-30f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + (half ? rb : ra);
    const int t = r / G, g = r - t * G;
    if (t >= T_) continue;
    const float inv = half ? inv_b : inv_a;
    __nv_bfloat16* orow = a.out + (((size_t)b * T_ + t) * H + h * G + g) * D;
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

// cuTensorMapEncodeTiled, reached through the runtime so the library
// needs no -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

int encode_tiled(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return static_cast<int>(err);
    if (found != cudaDriverEntryPointSuccess || p == nullptr)
      return kTensorMapFailed;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return 0;
}

// A cache [B, S, Hkv, D] bf16 as a 4-D tensor map, dims innermost first
// (D, Hkv, S, B), box (64, 1, keys, 1): one [keys, 64 values] block of
// one kv head, 128-byte swizzled, zeros past S.
int encode_kv_map(CUtensorMap* map, const void* cache, int B, int S,
                  int Hkv, int D, int keys) {
  EncodeTiled fn;
  const int rc = encode_tiled(&fn);
  if (rc != 0) return rc;
  if (reinterpret_cast<uintptr_t>(cache) % 16) return kBadShape;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)Hkv, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)Hkv * D * 2,
                                 (cuuint64_t)S * Hkv * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)keys, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(cache), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapFailed;
}

template <int D>
int launch_flash(const FlashArgs& a, const void* k, const void* v,
                 cudaStream_t stream) {
  using Geo = FlashGeometry<D>;
  static int opted_in[kMaxDevices] = {0};
  CUtensorMap k_map, v_map;
  int rc = encode_kv_map(&k_map, k, a.B, a.S, a.Hkv, D, Geo::kKeys);
  if (rc == 0) rc = encode_kv_map(&v_map, v, a.B, a.S, a.Hkv, D, Geo::kKeys);
  if (rc != 0) return rc;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return kBadDevice;
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(flash_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Geo::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in[dev] = 1;
  }
  const dim3 grid(a.B * a.Hkv,
                  (a.T * (a.H / a.Hkv) + Geo::kRows - 1) / Geo::kRows);
  flash_kernel<D><<<grid, Geo::kThreads, Geo::kSmemBytes, stream>>>(
      k_map, v_map, a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const Args& a, cudaStream_t stream) {
  const int rows = a.tile.block_q * (a.tile.H / a.tile.Hkv);
  const int smem = tile_smem_floats(rows, D, kBlockK) * (int)sizeof(float);
  const dim3 grid(a.B, a.tile.Hkv,
                  (a.tile.T + a.tile.block_q - 1) / a.tile.block_q);
  return launch_tile_kernel<flash_tile_kernel<D>>(grid, kTileThreads, smem,
                                                  a, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, caches and out share it).
// block_q: query positions per float32 tile; for bfloat16 the flattened
// rows of a tile, which must equal the kernel's (ops flash_tile).
int flash_attention_with_cache(const void* q, const void* k, const void* v,
                               const int* starts, void* out, int dtype,
                               int B, int T, int H, int Hkv, int D, int S,
                               int block_q, float scale, void* stream) {
  if (B <= 0 || T <= 0 || Hkv <= 0 || H % Hkv || S <= 0 || block_q <= 0)
    return kBadShape;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const Args a{{q, out, T, H, Hkv, block_q, scale, 0, 0.f}, k, v, starts,
                 B, S};
    if (D == 64) return launch_f32<64>(a, s);
    if (D == 128) return launch_f32<128>(a, s);
    if (D == 256) return launch_f32<256>(a, s);
    return kBadHeadDim;
  }
  if (dtype != 1) return kBadDtype;
  if (block_q != FlashGeometry<64>::kRows) return kBadShape;
  const FlashArgs a{static_cast<const __nv_bfloat16*>(q),
                    static_cast<__nv_bfloat16*>(out), starts, B, T, H, Hkv,
                    S, scale};
  if (D == 64) return launch_flash<64>(a, k, v, s);
  if (D == 128) return launch_flash<128>(a, k, v, s);
  if (D == 256) return launch_flash<256>(a, k, v, s);
  return kBadHeadDim;
}

const char* flash_attention_error_string(int code) {
  if (code == kTensorMapFailed)
    return "cuTensorMapEncodeTiled refused the K/V cache layout";
  return error_string(code);
}

}  // extern "C"
