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
// accumulation; output acc / max(l, 1e-30) in q's dtype; q is multiplied
// by `scale` before the dot, as the Pallas kernels do.
//
// What bounds them on an H100: decode reads every live KV byte once and
// does ~2 flops per byte per query row, so it is bound by device-memory
// bandwidth (3.35 TB/s); prefill at a 512-token chunk does ~T/2 times more
// work per byte and is bound by arithmetic. This first version is the
// simple, right one: one thread block per (row, kv head[, query tile])
// streams each [Bs, D] K and V panel through shared memory (converted to
// f32), keeps the tile's (m, l, acc) in shared memory, and does the dots
// with plain f32 FMA on the CUDA cores. It reads each KV byte a tile needs
// once per tile. Tensor cores (wgmma), TMA/cp.async double buffering and a
// split-KV reduction for small batches are later work.
//
// Hazards the TPU hid, handled here: a TPU DMA clamps, a GPU read past the
// end faults — every block index is clamped to [0, MB-1] and every block
// id read from the table to [0, N-1]; blocks past nb are never read; fully
// masked rows return acc / max(l, 1e-30). A row parked at start >= MB*Bs
// (an idle slot, whose output the engine discards) reads nothing and
// returns zeros: the Pallas kernels attend such a row over all nb blocks,
// which in a prefill chunk with idle slots was most of the launch's work.
//
// Plain C interface (built with nvcc -shared, loaded with ctypes). Each
// entry point launches on the given stream, allocates nothing, never
// synchronises, and returns cudaGetLastError() (or a negative code for
// arguments it refuses).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kDecodeThreads = 128;
constexpr int kPrefillThreads = 256;
constexpr int kMaxSmemBytes = 232448;   // 227 KB opt-in per block

enum ErrorCode {
  kBadDtype = -1,
  kBadHeadDim = -2,
  kBadShape = -3,
  kSmemTooLarge = -4,
  kBadDevice = -5,
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Args {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const int* tables;
  const int* starts;
  void* out;
  int B, T, H, Hkv, Bs, MB, nb, N;
  int block_q;  // query positions per tile (decode: T)
  float scale;
};

// Shared-memory floats for one tile of `rows` = block_q * G query rows.
__host__ __device__ inline int smem_floats(int rows, int D, int Bs) {
  return 2 * rows * D          // q (pre-scaled), acc
         + Bs * (D + 1)        // K panel, padded: conflict-free column reads
         + Bs * D              // V panel
         + rows * Bs           // scores / probabilities
         + 3 * rows;           // m, l, correction
}

// One tile: kv head h of batch row b, query positions qi*block_q ..
// qi*block_q + block_q - 1 (clipped to T), all G query heads of h.
template <typename T, int D>
__device__ void attend_tile(const Args& a, int b, int h, int qi) {
  extern __shared__ float smem[];
  const int G = a.H / a.Hkv;
  const int rows = a.block_q * G;
  const int Bs = a.Bs;
  float* qs = smem;
  float* acc = qs + rows * D;
  float* ks = acc + rows * D;
  float* vs = ks + Bs * (D + 1);
  float* sc = vs + Bs * D;
  float* m = sc + rows * Bs;
  float* l = m + rows;
  float* corr = l + rows;

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;
  const int t0 = qi * a.block_q;
  const int start = a.starts[b];
  T* out = static_cast<T*>(a.out);
  if (start >= a.MB * Bs) {   // parked row: uniform across the block
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
  const T* kp = static_cast<const T*>(a.k_pool);
  const T* vp = static_cast<const T*>(a.v_pool);

  // rows ordered r = t_local * G + g; head of row r is h * G + g
  for (int idx = tid; idx < rows * D; idx += nthreads) {
    const int r = idx / D, d = idx - (idx / D) * D;
    const int t = t0 + r / G, g = r % G;
    float v = 0.f;
    if (t < a.T) {
      v = to_f32(q[(((size_t)b * a.T + t) * a.H + h * G + g) * D + d])
          * a.scale;
    }
    qs[idx] = v;
    acc[idx] = 0.f;
  }
  for (int r = tid; r < rows; r += nthreads) {
    m[r] = kNegInf;
    l[r] = 0.f;
  }

  const int last_t = min(t0 + a.block_q, a.T) - 1;
  const int jmax = (start + last_t) / Bs;   // truncating, as lax.div
  const int jend = min(jmax, a.nb - 1);
  const size_t panel = (size_t)Bs * D;
  __syncthreads();

  for (int j = 0; j <= jend; ++j) {
    const int jj = min(max(j, 0), a.MB - 1);
    int blk = a.tables[(size_t)b * a.MB + jj];
    blk = min(max(blk, 0), a.N - 1);
    const T* kb = kp + ((size_t)blk * a.Hkv + h) * panel;
    const T* vb = vp + ((size_t)blk * a.Hkv + h) * panel;
    for (int idx = tid; idx < Bs * D; idx += nthreads) {
      const int c = idx / D, d = idx - (idx / D) * D;
      ks[c * (D + 1) + d] = to_f32(kb[idx]);
      vs[idx] = to_f32(vb[idx]);
    }
    __syncthreads();

    // scores: neighbouring threads take neighbouring keys
    for (int idx = tid; idx < rows * Bs; idx += nthreads) {
      const int r = idx / Bs, c = idx - (idx / Bs) * Bs;
      const float* qr = qs + r * D;
      const float* kr = ks + c * (D + 1);
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      const int q_pos = start + t0 + r / G;
      const int k_pos = j * Bs + c;
      sc[idx] = (k_pos <= q_pos) ? s : kNegInf;
    }
    __syncthreads();

    // online softmax, one warp per row
    for (int r = warp; r < rows; r += nwarps) {
      const float m_prev = m[r];
      float mx = kNegInf;
      for (int c = lane; c < Bs; c += 32) mx = fmaxf(mx, sc[r * Bs + c]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < Bs; c += 32) {
        const float p = expf(sc[r * Bs + c] - m_new);
        sc[r * Bs + c] = p;
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
      const float* pr = sc + r * Bs;
      float v = acc[idx] * corr[r];
      for (int c = 0; c < Bs; ++c) v = fmaf(pr[c], vs[c * D + d], v);
      acc[idx] = v;
    }
    __syncthreads();
  }

  for (int idx = tid; idx < rows * D; idx += nthreads) {
    const int r = idx / D, d = idx - (idx / D) * D;
    const int t = t0 + r / G, g = r % G;
    if (t < a.T) {
      out[(((size_t)b * a.T + t) * a.H + h * G + g) * D + d] =
          from_f32<T>(acc[idx] / fmaxf(l[r], 1e-30f));
    }
  }
}

// grid (B, Hkv): the whole T-token window of one row and kv head
template <typename T, int D>
__global__ void __launch_bounds__(kDecodeThreads)
paged_decode_kernel(Args a) {
  attend_tile<T, D>(a, blockIdx.x, blockIdx.y, 0);
}

// grid (B, Hkv, ceil(T / block_q)): one query tile per block
template <typename T, int D>
__global__ void __launch_bounds__(kPrefillThreads)
paged_prefill_kernel(Args a) {
  attend_tile<T, D>(a, blockIdx.x, blockIdx.y, blockIdx.z);
}

constexpr int kMaxDevices = 16;

// Launches kernel<T, D> of one kind. The dynamic shared-memory opt-in is
// set once per device for the largest size asked so far, not before every
// launch (a decode step launches once per layer).
template <typename T, int D, bool kDecode>
int launch(dim3 grid, int smem, const Args& a, cudaStream_t stream) {
  static int opted_in[kMaxDevices] = {0};
  if (smem > kMaxSmemBytes) return kSmemTooLarge;
  void (*kernel)(Args) =
      kDecode ? paged_decode_kernel<T, D> : paged_prefill_kernel<T, D>;
  const int threads = kDecode ? kDecodeThreads : kPrefillThreads;
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

template <typename T>
int dispatch(bool decode, int D, const Args& a, cudaStream_t stream) {
  const int rows = a.block_q * (a.H / a.Hkv);
  const int smem = smem_floats(rows, D, a.Bs) * (int)sizeof(float);
  if (decode) {
    dim3 grid(a.B, a.Hkv);
    if (D == 64) return launch<T, 64, true>(grid, smem, a, stream);
    if (D == 128) return launch<T, 128, true>(grid, smem, a, stream);
    return kBadHeadDim;
  }
  dim3 grid(a.B, a.Hkv, (a.T + a.block_q - 1) / a.block_q);
  if (D == 64) return launch<T, 64, false>(grid, smem, a, stream);
  if (D == 128) return launch<T, 128, false>(grid, smem, a, stream);
  return kBadHeadDim;
}

int run(bool decode, const void* q, const void* k_pool, const void* v_pool,
        const int* tables, const int* starts, void* out, int dtype, int B,
        int T, int H, int Hkv, int D, int Bs, int MB, int nb, int N,
        int block_q, float scale, void* stream) {
  if (B <= 0 || T <= 0 || Hkv <= 0 || H % Hkv || Bs <= 0 || MB <= 0 ||
      nb <= 0 || nb > MB || N <= 0 || block_q <= 0)
    return kBadShape;
  Args a{q, k_pool, v_pool, tables, starts, out,
         B, T, H, Hkv, Bs, MB, nb, N, block_q, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(decode, D, a, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(decode, D, a, s);
  return kBadDtype;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, pools and out share it)
int paged_decode_attention(const void* q, const void* k_pool,
                           const void* v_pool, const int* tables,
                           const int* starts, void* out, int dtype, int B,
                           int T, int H, int Hkv, int D, int Bs, int MB,
                           int nb, int N, float scale, void* stream) {
  return run(true, q, k_pool, v_pool, tables, starts, out, dtype, B, T, H,
             Hkv, D, Bs, MB, nb, N, T, scale, stream);
}

int paged_prefill_attention(const void* q, const void* k_pool,
                            const void* v_pool, const int* tables,
                            const int* starts, void* out, int dtype, int B,
                            int T, int H, int Hkv, int D, int Bs, int MB,
                            int nb, int N, int block_q, float scale,
                            void* stream) {
  return run(false, q, k_pool, v_pool, tables, starts, out, dtype, B, T, H,
             Hkv, D, Bs, MB, nb, N, block_q, scale, stream);
}

const char* paged_attention_error_string(int code) {
  switch (code) {
    case kBadDtype: return "unsupported dtype (float32 or bfloat16)";
    case kBadHeadDim: return "unsupported head dim (64 or 128)";
    case kBadShape: return "invalid shape arguments";
    case kSmemTooLarge: return "tile needs more than 227 KB shared memory";
    case kBadDevice: return "device ordinal past the kernels' table";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
