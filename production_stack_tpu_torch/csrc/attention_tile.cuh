// The f32 FMA attention tile that the float32 paged prefill kernel
// (paged_attention.cu) and the flash kernel (flash_attention.cu) run, with
// the dtype helpers, error codes and launch helper every kernel of both
// sources uses: one thread block attends the G query heads of one
// kv head over block_q query positions of one batch row, streaming K/V
// panels of `keys` rows through shared memory (as f32) with an f32 online
// softmax, and keeping the tile's (m, l, acc) in shared memory. The dots
// are plain f32 FMA on the CUDA cores.
//
// Where a panel comes from is the caller's: a Panel type stages panel j
// (keys j*keys .. j*keys + keys - 1) into shared memory, K padded to
// D + 1 floats a row (conflict-free column reads), V dense. The paged
// prefill reads a [Bs, D] panel through a block table; the flash kernel a
// strided, bounds-checked one from a contiguous cache.
//
// A Panel provides:
//   static constexpr int kKeys;   // keys per panel if fixed, else 0
//   int keys;                     // keys per panel
//   int limit;                    // keys past this are masked
//   template <int kThreads>
//   __device__ void load(int j, float* ks, float* vs, int tid) const;
// The thread count and a fixed panel length are compile-time constants
// so that the tile's loops unroll (a panel's loads are then issued
// together).
//
// Include inside an anonymous namespace's translation unit only: every
// definition here is internal to the including source.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxSmemBytes = 232448;   // 227 KB opt-in per block
constexpr int kMaxDevices = 16;

enum ErrorCode {
  kBadDtype = -1,
  kBadHeadDim = -2,
  kBadShape = -3,
  kSmemTooLarge = -4,
  kBadDevice = -5,
  kBadScales = -6,
};

const char* error_string(int code) {
  switch (code) {
    case kBadDtype: return "unsupported dtype (float32 or bfloat16)";
    case kBadHeadDim: return "unsupported head dim (64, 128 or 256)";
    case kBadShape: return "invalid shape arguments";
    case kSmemTooLarge: return "tile needs more than 227 KB shared memory";
    case kBadDevice: return "device ordinal past the kernels' table";
    case kBadScales:
      return "an int8 pool needs both scales, and scales an int8 pool";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// What a tile attends with, beyond where its K/V panels come from.
struct TileArgs {
  const void* q;   // [B, T, H, D]
  void* out;       // [B, T, H, D]
  int T, H, Hkv;
  int block_q;     // query positions per tile
  float scale;     // q is multiplied by it before the dot
  int window;      // sliding window in positions, 0 = full causal
  float softcap;   // tanh cap on the scaled scores, 0 = off
};

// Shared-memory floats for one tile of `rows` = block_q * G query rows
// over panels of `keys` keys.
__host__ __device__ inline int tile_smem_floats(int rows, int D, int keys) {
  return 2 * rows * D          // q (pre-scaled), acc
         + keys * (D + 1)      // K panel, padded: conflict-free column reads
         + keys * D            // V panel
         + rows * keys         // scores / probabilities
         + 3 * rows;           // m, l, correction
}

// One tile: kv head h of batch row b, query positions qi*block_q ..
// qi*block_q + block_q - 1 (clipped to T), all G query heads of h. Query t
// sits at start + t and attends keys k <= start + t, k < panel.limit and,
// with a window W, k > start + t - W. The block loop runs over panels
// jmin .. min(last query's panel, num_panels - 1): with a window it starts
// at the earliest query's window panel, so the panels before the window
// are skipped, not read and masked. The rows of one tile have different
// windows, so a panel may be wholly masked for some of them: the -1e30
// sentinel gives p = 1 over such a panel and the correction
// exp(-1e30 - m) = 0 at the row's first live key wipes it (-inf would give
// NaN). A tile with no panel to read (num_panels 0: a parked row) writes
// zeros and reads nothing. Output acc / max(l, 1e-30) in T. Launched
// with kThreads threads a block.
template <typename T, int D, int kThreads, typename Panel>
__device__ void attend_tile(const TileArgs& a, const Panel& panel, int b,
                            int h, int qi, int start, int num_panels) {
  extern __shared__ float smem[];
  const int G = a.H / a.Hkv;
  const int rows = a.block_q * G;
  const int P = Panel::kKeys > 0 ? Panel::kKeys : panel.keys;
  float* qs = smem;
  float* acc = qs + rows * D;
  float* ks = acc + rows * D;
  float* vs = ks + P * (D + 1);
  float* sc = vs + P * D;
  float* m = sc + rows * P;
  float* l = m + rows;
  float* corr = l + rows;

  constexpr int nthreads = kThreads;
  constexpr int nwarps = kThreads >> 5;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int t0 = qi * a.block_q;
  const int last_t = min(t0 + a.block_q, a.T) - 1;
  const int jend = min((start + last_t) / P, num_panels - 1);
  // first panel inside the earliest query's window (0 without one)
  const int jmin = a.window > 0 ? max(start + t0 - (a.window - 1), 0) / P
                                : 0;
  T* out = static_cast<T*>(a.out);
  if (num_panels <= 0) {   // uniform across the block
    for (int idx = tid; idx < rows * D; idx += nthreads) {
      const int r = idx / D, d = idx - (idx / D) * D;
      const int t = t0 + r / G, g = r % G;
      if (t < a.T)
        out[(((size_t)b * a.T + t) * a.H + h * G + g) * D + d] =
            from_f32<T>(0.f);
    }
    return;
  }
  const T* q = static_cast<const T*>(a.q);

  // rows ordered r = t_local * G + g; head of row r is h * G + g
  for (int idx = tid; idx < rows * D; idx += nthreads) {
    const int r = idx / D, d = idx - (idx / D) * D;
    const int t = t0 + r / G, g = r % G;
    float x = 0.f;
    if (t < a.T)
      x = to_f32(q[(((size_t)b * a.T + t) * a.H + h * G + g) * D + d])
          * a.scale;
    qs[idx] = x;
    acc[idx] = 0.f;
  }
  for (int r = tid; r < rows; r += nthreads) {
    m[r] = kNegInf;
    l[r] = 0.f;
  }
  __syncthreads();

  for (int j = jmin; j <= jend; ++j) {
    panel.template load<kThreads>(j, ks, vs, tid);
    __syncthreads();

    // scores: neighbouring threads take neighbouring keys
    for (int idx = tid; idx < rows * P; idx += nthreads) {
      const int r = idx / P, c = idx - (idx / P) * P;
      const float* qr = qs + r * D;
      const float* kr = ks + c * (D + 1);
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      if (a.softcap != 0.f) s = a.softcap * tanhf(s / a.softcap);
      const int q_pos = start + t0 + r / G;
      const int k_pos = j * P + c;
      const bool live = k_pos <= q_pos && k_pos < panel.limit &&
                        (a.window <= 0 || k_pos > q_pos - a.window);
      sc[idx] = live ? s : kNegInf;
    }
    __syncthreads();

    // online softmax, one warp per row
    for (int r = warp; r < rows; r += nwarps) {
      const float m_prev = m[r];
      float mx = kNegInf;
      for (int c = lane; c < P; c += 32) mx = fmaxf(mx, sc[r * P + c]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < P; c += 32) {
        const float p = expf(sc[r * P + c] - m_new);
        sc[r * P + c] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float cr = expf(m_prev - m_new);
        corr[r] = cr;
        l[r] = l[r] * cr + sum;
        m[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V; neighbouring threads take neighbouring d
    for (int idx = tid; idx < rows * D; idx += nthreads) {
      const int r = idx / D, d = idx - (idx / D) * D;
      const float* pr = sc + r * P;
      float x = acc[idx] * corr[r];
      for (int c = 0; c < P; ++c) x = fmaf(pr[c], vs[c * D + d], x);
      acc[idx] = x;
    }
    __syncthreads();
  }

  for (int idx = tid; idx < rows * D; idx += nthreads) {
    const int r = idx / D, d = idx - (idx / D) * D;
    const int t = t0 + r / G, g = r % G;
    if (t < a.T)
      out[(((size_t)b * a.T + t) * a.H + h * G + g) * D + d] =
          from_f32<T>(acc[idx] / fmaxf(l[r], 1e-30f));
  }
}

// Launches `kernel` (one instantiation per template argument, so each
// keeps its own table) with `smem` bytes of dynamic shared memory. The
// opt-in past 48 KB is set once per device for the largest size asked so
// far, not before every launch (a decode step launches once per layer).
template <auto kernel, typename A>
int launch_tile_kernel(dim3 grid, int threads, int smem, const A& a,
                       cudaStream_t stream) {
  static int opted_in[kMaxDevices] = {0};
  if (smem > kMaxSmemBytes) return kSmemTooLarge;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return kBadDevice;
  if (smem > opted_in[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in[dev] = smem;
  }
  kernel<<<grid, threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
