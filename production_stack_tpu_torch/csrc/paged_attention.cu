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
// Two optional branches, off at 0 as in Pallas (Gemma-2 runs both):
// - `window` W > 0 (sliding-window layers): a query at p attends keys in
//   (p - W, p]. A tile starts its block loop at jmin = (first query's
//   position - (W - 1)) / Bs (pallas_paged.py:113-119, :359-366), so the
//   blocks before the window are skipped, not read and masked; the -1e30
//   sentinel wipes a block wholly masked for some rows of a tile, as in
//   Pallas (attention_tile.cuh).
// - `softcap` c > 0: s = c * tanh(s / c) on the scaled raw score,
//   before the mask (pallas_paged.py:135-137, :387-388).
//
// What bounds them on an H100: decode reads every live KV byte once and
// does ~2 flops per byte per query row, so it is bound by device-memory
// bandwidth (3.35 TB/s); prefill at a 512-token chunk does ~T/2 times more
// work per byte and is bound by arithmetic. This first version is the
// simple, right one: one thread block per (row, kv head[, query tile])
// runs the tile of attention_tile.cuh over the row's [Bs, D] K and V
// panels, read through its block table. It reads each KV byte a tile needs
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

#include "attention_tile.cuh"

namespace {

constexpr int kDecodeThreads = 128;
constexpr int kPrefillThreads = 256;

struct Args {
  TileArgs tile;
  const void* k_pool;
  const void* v_pool;
  const int* tables;
  const int* starts;
  int B, Bs, MB, nb, N;
};

// Panel j of one (batch row, kv head): pool block tables[b, j], a
// contiguous [Bs, D] tile. The block index is clamped to [0, MB-1] and the
// block id to [0, N-1].
template <typename T, int D>
struct PagedPanel {
  static constexpr int kKeys = 0;   // Bs, a runtime value
  const T* k_pool;
  const T* v_pool;
  const int* table;   // row b of the block tables
  int h, Hkv, MB, N;
  int keys;           // Bs
  int limit;          // nb * Bs: the loop never reaches a block past nb

  template <int kThreads>
  __device__ void load(int j, float* ks, float* vs, int tid) const {
    const int jj = min(max(j, 0), MB - 1);
    const int blk = min(max(table[jj], 0), N - 1);
    const size_t off = ((size_t)blk * Hkv + h) * (size_t)keys * D;
    const T* kb = k_pool + off;
    const T* vb = v_pool + off;
    for (int idx = tid; idx < keys * D; idx += kThreads) {
      const int c = idx / D, d = idx - (idx / D) * D;
      ks[c * (D + 1) + d] = to_f32(kb[idx]);
      vs[idx] = to_f32(vb[idx]);
    }
  }
};

// grid (B, Hkv, ceil(T / block_q)): kv head blockIdx.y of batch row
// blockIdx.x, query tile blockIdx.z. A parked row has no panel to read.
template <typename T, int D, int kThreads>
__device__ __forceinline__ void paged_tile(const Args& a) {
  const int b = blockIdx.x, h = blockIdx.y;
  const int start = a.starts[b];
  const PagedPanel<T, D> panel{
      static_cast<const T*>(a.k_pool), static_cast<const T*>(a.v_pool),
      a.tables + (size_t)b * a.MB, h, a.tile.Hkv, a.MB, a.N, a.Bs,
      a.nb * a.Bs};
  attend_tile<T, D, kThreads>(a.tile, panel, b, h, blockIdx.z, start,
                              start >= a.MB * a.Bs ? 0 : a.nb);
}

// a decode window is one tile unless its T * G rows outgrow the tile
// (wide GQA at D = 256)
template <typename T, int D>
__global__ void __launch_bounds__(kDecodeThreads)
paged_decode_kernel(Args a) {
  paged_tile<T, D, kDecodeThreads>(a);
}

template <typename T, int D>
__global__ void __launch_bounds__(kPrefillThreads)
paged_prefill_kernel(Args a) {
  paged_tile<T, D, kPrefillThreads>(a);
}

template <typename T, int D>
int launch(bool decode, const Args& a, cudaStream_t stream) {
  const int rows = a.tile.block_q * (a.tile.H / a.tile.Hkv);
  const int smem = tile_smem_floats(rows, D, a.Bs) * (int)sizeof(float);
  const dim3 grid(a.B, a.tile.Hkv,
                  (a.tile.T + a.tile.block_q - 1) / a.tile.block_q);
  if (decode)
    return launch_tile_kernel<paged_decode_kernel<T, D>>(
        grid, kDecodeThreads, smem, a, stream);
  return launch_tile_kernel<paged_prefill_kernel<T, D>>(
      grid, kPrefillThreads, smem, a, stream);
}

template <typename T>
int dispatch(bool decode, int D, const Args& a, cudaStream_t stream) {
  if (D == 64) return launch<T, 64>(decode, a, stream);
  if (D == 128) return launch<T, 128>(decode, a, stream);
  if (D == 256) return launch<T, 256>(decode, a, stream);
  return kBadHeadDim;
}

int run(bool decode, const void* q, const void* k_pool, const void* v_pool,
        const int* tables, const int* starts, void* out, int dtype, int B,
        int T, int H, int Hkv, int D, int Bs, int MB, int nb, int N,
        int block_q, float scale, int window, float softcap,
        void* stream) {
  if (B <= 0 || T <= 0 || Hkv <= 0 || H % Hkv || Bs <= 0 || MB <= 0 ||
      nb <= 0 || nb > MB || N <= 0 || block_q <= 0 || window < 0 ||
      softcap < 0.f)
    return kBadShape;
  const Args a{{q, out, T, H, Hkv, block_q, scale, window, softcap},
               k_pool, v_pool, tables, starts, B, Bs, MB, nb, N};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(decode, D, a, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(decode, D, a, s);
  return kBadDtype;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, pools and out share it);
// window 0 and softcap 0 turn those branches off
int paged_decode_attention(const void* q, const void* k_pool,
                           const void* v_pool, const int* tables,
                           const int* starts, void* out, int dtype, int B,
                           int T, int H, int Hkv, int D, int Bs, int MB,
                           int nb, int N, int block_q, float scale,
                           int window, float softcap, void* stream) {
  return run(true, q, k_pool, v_pool, tables, starts, out, dtype, B, T, H,
             Hkv, D, Bs, MB, nb, N, block_q, scale, window, softcap,
             stream);
}

int paged_prefill_attention(const void* q, const void* k_pool,
                            const void* v_pool, const int* tables,
                            const int* starts, void* out, int dtype, int B,
                            int T, int H, int Hkv, int D, int Bs, int MB,
                            int nb, int N, int block_q, float scale,
                            int window, float softcap, void* stream) {
  return run(false, q, k_pool, v_pool, tables, starts, out, dtype, B, T, H,
             Hkv, D, Bs, MB, nb, N, block_q, scale, window, softcap,
             stream);
}

const char* paged_attention_error_string(int code) {
  return error_string(code);
}

}  // extern "C"
