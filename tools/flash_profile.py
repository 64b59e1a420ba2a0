#!/usr/bin/env python3
"""Where the bf16 flash kernel's time goes, on one NVIDIA GPU.

    python3 tools/flash_profile.py

Copies production_stack_tpu_torch/ into build/flash_profile/ (listed in
.gitignore), adds timers to the copy of csrc/flash_attention.cu (the
globaltimer at a block's start, when its Q has landed, after its first
panel, after its last panel and at its end; per consumer warpgroup the
clock64 cycles spent waiting for a K/V panel, waiting for its turn,
waiting for its scores, in the softmax and waiting for P.V), builds and
runs that copy at chip_smoke.flash_timing's two shapes, and prints per
shape: the blocks' mean times per phase, the gap between consecutive
blocks on an SM, the SMs' busy share of the kernel's span, and the
cycles a warpgroup spends per panel in each wait. The timers cost time:
read the breakdown as shares, and time the kernel with chip_smoke.py.
Exits 2 without CUDA; raises if the kernel no longer has the statements
the timers are attached to.
"""

import ctypes
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPY = os.path.join(REPO, "build", "flash_profile")

# (statement in csrc/flash_attention.cu, what replaces it in the copy)
PATCHES = [
    ('''namespace {

constexpr int kTileThreads = 256;''',
     '''__device__ unsigned long long g_prof[4096 * 24];

namespace {
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ unsigned smid() {
  unsigned r;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(r));
  return r;
}

constexpr int kTileThreads = 256;'''),
    ('''  const int n_panels = kmax >= 0 ? kmax / kKeys + 1 : 0;
''', '''  const int n_panels = kmax >= 0 ? kmax / kKeys + 1 : 0;
  unsigned long long* prof =
      g_prof + (size_t)(blockIdx.y * gridDim.x + blockIdx.x) * 24;
  if (threadIdx.x == 0) {
    prof[0] = blockIdx.y * gridDim.x + blockIdx.x;
    prof[1] = smid();
    prof[2] = n_panels;
    prof[3] = gtime();
  }
'''),
    ('''    named_barrier_sync(1 + wg, 128);
  }
''', '''    named_barrier_sync(1 + wg, 128);
  }
  if (ct == 0 && wg == 0) prof[4] = gtime();
  long long c_full = 0, c_turn = 0, c_w1 = 0, c_soft = 0, c_w0 = 0;
  long long c0;
#define TIC c0 = clock64();
#define TOC(x) x += clock64() - c0;
'''),
    ('''    wait_full(0, 0);
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
      wgmma_wait<0>();''', '''    TIC wait_full(0, 0); TOC(c_full)
    TIC take_turn(); TOC(c_turn)
    issue_scores(0);
    pass_turn();
    TIC wgmma_wait<0>(); TOC(c_w1)
    fence_regs(s);
    release(0, 0);
    TIC softmax(0);
    pack_p(); TOC(c_soft)
    if (ct == 0 && wg == 0) prof[5] = gtime();
    for (int i = 1; i < n_panels; ++i) {
      TIC wait_full(0, i);
      wait_full(1, i - 1); TOC(c_full)
      TIC take_turn(); TOC(c_turn)
      issue_scores(i);
      issue_pv(i - 1);
      pass_turn();
      TIC wgmma_wait<1>(); TOC(c_w1)
      fence_regs(s);
      release(0, i);
      TIC softmax(i); TOC(c_soft)
      TIC wgmma_wait<0>(); TOC(c_w0)'''),
    ('''    release(1, n_panels - 1);
  }
''', '''    release(1, n_panels - 1);
  }
  if (ct == 0) {
    if (wg == 0) prof[6] = gtime();
    prof[8 + wg * 8 + 0] = c_full;
    prof[8 + wg * 8 + 1] = c_turn;
    prof[8 + wg * 8 + 2] = c_w1;
    prof[8 + wg * 8 + 3] = c_soft;
    prof[8 + wg * 8 + 4] = c_w0;
  }
'''),
    ('''            __floats2bfloat162_rn(o[n][j] * inv, o[n][j + 1] * inv);
      }
  }
}
''', '''            __floats2bfloat162_rn(o[n][j] * inv, o[n][j + 1] * inv);
      }
  }
  if (ct == 0 && wg == 0) prof[7] = gtime();
}
'''),
    ('''const char* flash_attention_error_string(int code) {''',
     '''int flash_prof_read(void* dst, int bytes) {
  return (int)cudaMemcpyFromSymbol(dst, g_prof, bytes);
}

const char* flash_attention_error_string(int code) {'''),
]
PHASES = ["wait_panel", "wait_turn", "wait_scores", "softmax", "wait_pv"]


def instrumented_copy():
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(os.path.join(REPO, "production_stack_tpu_torch"),
                    os.path.join(COPY, "production_stack_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(COPY, "production_stack_tpu_torch", "csrc",
                        "flash_attention.cu")
    with open(path) as f:
        src = f.read()
    for old, new in PATCHES:
        if src.count(old) != 1:
            raise RuntimeError(f"csrc/flash_attention.cu changed: the timer "
                               f"site {old[:60]!r} is not there once")
        src = src.replace(old, new)
    with open(path, "w") as f:
        f.write(src)


def report(fa, np, torch, H, D):
    g = torch.Generator(device="cuda").manual_seed(103)
    B, T, Hkv, S = 4, 512, 8, 1024

    def rnd(*shape):
        return torch.randn(shape, generator=g,
                           device="cuda").to(torch.bfloat16)
    q, k, v = rnd(B, T, H, D), rnd(B, S, Hkv, D), rnd(B, S, Hkv, D)
    starts = torch.tensor([0, 128, 256, 512], dtype=torch.int32,
                          device="cuda")
    for _ in range(20):
        fa.flash_attention_with_cache(q, k, v, starts)
    torch.cuda.synchronize()
    lib = fa._lib()
    lib.flash_prof_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    buf = np.zeros(4096 * 24, np.uint64)
    if lib.flash_prof_read(buf.ctypes.data, buf.nbytes) != 0:
        raise RuntimeError("could not read the timers")
    blocks = B * Hkv * -(-T * (H // Hkv) // fa.flash_tile(D)["rows"])
    r = buf[:blocks * 24].reshape(blocks, 24).astype(np.int64)
    t0, n = r[:, 3].min(), r[:, 2]
    span = r[:, 7].max() - t0
    dur = r[:, 7] - r[:, 3]
    busy = np.bincount(r[:, 1], weights=dur)
    gaps = []
    for sm in np.unique(r[:, 1]):
        idx = np.where(r[:, 1] == sm)[0]
        idx = idx[np.argsort(r[idx, 3])]
        gaps += list(r[idx[1:], 3] - r[idx[:-1], 7])
    out = {"D": D, "blocks": int(blocks), "panels": int(n.sum()),
           "span_ns": int(span), "block_ns": float(dur.mean()),
           "q_landed_ns": float((r[:, 4] - r[:, 3]).mean()),
           "first_panel_ns": float((r[:, 5] - r[:, 4]).mean()),
           "later_panel_ns": float(((r[:, 6] - r[:, 5])
                                    / np.maximum(n - 1, 1)).mean()),
           "output_ns": float((r[:, 7] - r[:, 6]).mean()),
           "gap_between_blocks_ns": float(np.mean(gaps)) if gaps else 0.0,
           "sm_busy_share": float(busy[busy > 0].mean() / span)}
    for wg in (0, 1):
        c = r[:, 8 + wg * 8: 13 + wg * 8].sum(0) / n.sum()
        out[f"warpgroup{wg}_cycles_per_panel"] = dict(
            zip(PHASES, map(float, c)))
    return out


def main() -> int:
    import json
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("flash_profile: CUDA is not available", file=sys.stderr)
        return 2
    instrumented_copy()
    sys.path.insert(0, COPY)
    from production_stack_tpu_torch.ops import flash_attention as fa
    if not fa.__file__.startswith(COPY):
        raise RuntimeError(f"imported {fa.__file__}, not the copy")
    for H, D in ((32, 128), (16, 256)):
        print(json.dumps(report(fa, np, torch, H, D)), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.sm", "--format=csv,noheader"],
                         capture_output=True, text=True,
                         timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
