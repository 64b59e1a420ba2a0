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
// Where the Pallas kernel needed other shapes, this one does not:
// - it reads K/V strided over Hkv, a [block_k, D] panel of one kv head
//   gathering block_k rows of D contiguous values, so the head-major copy
//   of the whole cache the Pallas wrapper makes (:222-223) is not needed;
// - the Pallas wrapper halves block_k until it divides S, so a clamped
//   read cannot relabel keys; here the last key block is ragged and every
//   key past S is zero-filled in shared memory and masked.
// Key blocks past the q tile's last position are skipped (:146-148).
//
// What bounds it on an H100: at a 512-token chunk over a 1024-slot cache
// it does ~T/2 operations per KV byte and is bound by arithmetic. This
// first version is the simple, right one, the tile the paged kernels run
// (attention_tile.cuh): one thread block per (row, kv head, query tile)
// streams [block_k, D] K and V panels through shared memory (as f32),
// keeps the tile's (m, l, acc) in shared memory and does the dots with
// f32 FMA on the CUDA cores. Tensor cores and pipelined copies are later
// work.
//
// Plain C interface (nvcc -shared, loaded with ctypes). The entry point
// launches on the given stream, allocates nothing, never synchronises,
// and returns cudaGetLastError() (or a negative code for arguments it
// refuses).

#include "attention_tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlockK = 64;   // keys per shared-memory panel

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
template <typename T, int D>
struct StridedPanel {
  static constexpr int kKeys = kBlockK;
  const T* k;   // slot 0 of kv head h in row b
  const T* v;
  size_t stride;   // Hkv * D
  int keys;        // kBlockK
  int limit;       // S

  template <int kThreads>
  __device__ void load(int j, float* ks, float* vs, int tid) const {
    for (int idx = tid; idx < kKeys * D; idx += kThreads) {
      const int c = idx / D, d = idx - (idx / D) * D;
      const int s = j * kKeys + c;
      float kx = 0.f, vx = 0.f;
      if (s < limit) {
        const size_t off = (size_t)s * stride + d;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      ks[c * (D + 1) + d] = kx;
      vs[idx] = vx;
    }
  }
};

// grid (B, Hkv, ceil(T / block_q)): kv head blockIdx.y of batch row
// blockIdx.x, query tile blockIdx.z
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_kernel(Args a) {
  const int b = blockIdx.x, h = blockIdx.y;
  const size_t stride = (size_t)a.tile.Hkv * D;
  const size_t base = (size_t)b * a.S * stride + (size_t)h * D;
  const StridedPanel<T, D> panel{static_cast<const T*>(a.k) + base,
                                 static_cast<const T*>(a.v) + base, stride,
                                 kBlockK, a.S};
  attend_tile<T, D, kThreads>(a.tile, panel, b, h, blockIdx.z,
                              a.starts[b], (a.S + kBlockK - 1) / kBlockK);
}

template <typename T, int D>
int launch(const Args& a, cudaStream_t stream) {
  const int rows = a.tile.block_q * (a.tile.H / a.tile.Hkv);
  const int smem = tile_smem_floats(rows, D, kBlockK) * (int)sizeof(float);
  const dim3 grid(a.B, a.tile.Hkv,
                  (a.tile.T + a.tile.block_q - 1) / a.tile.block_q);
  return launch_tile_kernel<flash_kernel<T, D>>(grid, kThreads, smem, a,
                                                stream);
}

template <typename T>
int dispatch(int D, const Args& a, cudaStream_t stream) {
  if (D == 64) return launch<T, 64>(a, stream);
  if (D == 128) return launch<T, 128>(a, stream);
  if (D == 256) return launch<T, 256>(a, stream);
  return kBadHeadDim;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, caches and out share it)
int flash_attention_with_cache(const void* q, const void* k, const void* v,
                               const int* starts, void* out, int dtype,
                               int B, int T, int H, int Hkv, int D, int S,
                               int block_q, float scale, void* stream) {
  if (B <= 0 || T <= 0 || Hkv <= 0 || H % Hkv || S <= 0 || block_q <= 0)
    return kBadShape;
  const Args a{{q, out, T, H, Hkv, block_q, scale, 0, 0.f}, k, v, starts,
               B, S};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(D, a, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(D, a, s);
  return kBadDtype;
}

const char* flash_attention_error_string(int code) {
  return error_string(code);
}

}  // extern "C"
