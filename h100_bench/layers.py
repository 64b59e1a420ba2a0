"""The arithmetic the metric readers share: model FLOP utilisation of
the runner's calls, the paged kernels' roofline share, the decode pace,
the padded token-steps and the device's idle share. A cell whose decode is host-paced reports the decode-side
ones under names of its own (metrics/*.<cell>.py) through the same
functions."""

from typing import Optional

from h100_bench import work
from h100_bench.measures import percentile, tpots_s


def mfu(ctx, kind: str) -> Optional[float]:
    """Model operations of the window's ``kind`` calls (prefill:
    the real tokens of each chunk, the head on its last; decode: every
    live row of every step, the head on each) over their summed device
    spans (CUDA events around each call) at the bf16 peak, in %."""
    if not ctx.calls:
        return None
    S = ctx.engine_cfg.max_model_len
    flops = secs = 0.0
    for c in ctx.calls:
        if c["kind"] != kind or c["device_s"] is None:
            continue
        if kind == "prefill":
            f = sum(work.span_flops(ctx.cfg, s, n, True)
                    for s, n in zip(c["starts"], c["lengths"]) if s < S)
        else:
            f = sum(work.token_flops(ctx.cfg, s, True)
                    for fw in c["forwards"] for s in fw["starts"] if s < S)
        flops += f
        secs += c["device_s"]
    if secs <= 0 or flops <= 0:
        return None
    return 100.0 * flops / (secs * work.PEAK_BF16_FLOPS)


def roofline(ctx, wrapper: str) -> Optional[float]:
    """The least time of every ``wrapper`` call whose kernel ran inside
    the profiled slice (work.paged_work over the bf16 rate and HBM
    bandwidth, whichever binds) over those kernels' device time, in %."""
    prof = ctx.profile or {}
    kernel = prof.get("attn_kernel_s") or {}
    bound = spent = 0.0
    for i, secs in kernel.items():
        c = ctx.attn[i]
        if c["name"] != wrapper:
            continue
        bound += work.bound_s(*work.paged_work(
            c["B"], c["T"], c["H"], c["D"], c["starts"], c["nb"], c["MB"],
            c["Bs"], c["Hkv"], c["itemsize"], c["window"],
            c["kv_itemsize"]))
        spent += secs
    if spent <= 0 or bound <= 0:
        return None
    return 100.0 * bound / spent


def tpot_p95_ms(ctx) -> Optional[float]:
    """95th percentile over the window's requests of (last token - first
    token) / (tokens - 1)."""
    v = tpots_s(ctx.run)
    return 1e3 * percentile(v, 95) if v else None


def pad_dead_share(ctx) -> Optional[float]:
    """(pad + dead) / (real + pad + dead) decode token-steps over the
    window, /debug/perf's totals after minus before, in %."""
    if not ctx.perf:
        return None
    d = {k: ctx.perf["after"]["decode"][k] - ctx.perf["before"]["decode"][k]
         for k in ("real", "pad", "dead")}
    total = d["real"] + d["pad"] + d["dead"]
    return 100.0 * (d["pad"] + d["dead"]) / total if total else None


def idle_share(ctx) -> Optional[float]:
    """The profiled slice's wall time with nothing running on the
    device, in %."""
    p = ctx.profile or {}
    if not p.get("window_s"):
        return None
    return 100.0 * (p["window_s"] - p["busy_s"]) / p["window_s"]
