"""Engine efficiency accounting (``production_stack_tpu/engine/
efficiency.py``): every decode window's token-steps classified as real
(emitted tokens the client keeps), pad (parked rows) or dead (finished
rows' tails, rows finished between dispatch and read), every prefill
dispatch's bucket padding, and a modelled HBM traffic figure that gives
the effective-bandwidth and MBU gauges of ``/load`` and ``/metrics``.

Windows run at a variable geometry (continuous batching across
windows, engine.py): each is recorded at the batch bucket it was
dispatched at, so pad counts only the parked rows inside that bucket,
and every ring entry carries the JAX entry's keys (batch, steps,
positions, kv_len, live_rows, real, pad, dead, window_s, bytes,
effective_bytes, at, at_unix).

The byte model is the JAX package's: one decode step streams the whole
weight set once plus, for every batch row, the KV prefix up to the
window's kv bucket; effective bytes are those scaled by the window's
live fraction, and MBU is effective bytes per wall-clock second over
``EngineConfig.hbm_peak_gbps``. On a CPU engine the absolute numbers
mean nothing, but the fractions (live / pad / dead) are exact.

The engine loop calls ``note_window`` once per window and
``note_prefill`` once per prefill bucket group: integer adds and one
bounded-ring append under a lock held only for them. ``perf_block`` (the
``/load`` ``perf`` block) takes only that lock, never the engine's. The
ring (``EngineConfig.perf_ring_entries`` windows) is served on ``GET
/debug/perf`` by ``recent_windows``.

The JAX package also rings its XLA compile events and attaches those
that overlap a request to its trace. An eager PyTorch engine compiles
no executable, so here the compile ring is always empty:
``recent_compiles`` and ``compile_events_between`` return nothing, as
``/load``'s compile counters read 0, and keep their shapes for the
readers of ``/debug/perf`` and the trace middleware.
"""

import collections
import threading
import time
from typing import Dict, List, Tuple

# KV-pool occupancy observed at allocation time (fraction of non-trash
# blocks held by live sequences)
OCCUPANCY_BUCKETS: Tuple[float, ...] = (
    0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0)


class EngineEffAccounting:
    """Plain-int efficiency totals and a bounded ring of windows.

    ``kv_position_bytes``: the bytes one cache position costs one
    attention read (2 x layers x kv-heads x head-dim x itemsize, plus
    the int8 pool's f32 scales); ``weight_bytes``: the whole parameter
    set; ``ring_entries``: the windows kept for the recent rates and
    ``/debug/perf``. Ring entries carry the wall clock (``at_unix``)
    beside the monotonic ``at``, so a reader in another process can line
    them up with trace spans."""

    def __init__(self, *, weight_bytes: int, kv_position_bytes: int,
                 hbm_peak_bytes_per_s: float, ring_entries: int = 256):
        self.weight_bytes = int(weight_bytes)
        self.kv_position_bytes = int(kv_position_bytes)
        self.hbm_peak_bytes_per_s = float(hbm_peak_bytes_per_s)
        self._started_at = time.monotonic()
        self.decode_real = 0
        self.decode_pad = 0
        self.decode_dead = 0
        self.decode_token_steps_total = 0
        self.decode_windows = 0
        self.decode_busy_s = 0.0
        self.prefill_real = 0
        self.prefill_pad = 0
        self.prefill_dispatches = 0
        self.bytes_total = 0
        self.bytes_effective = 0
        self._windows: "collections.deque[dict]" = collections.deque(
            maxlen=max(1, ring_entries))
        self._lock = threading.Lock()

    # -- step-loop writes ------------------------------------------------

    def note_window(self, *, steps: int, batch: int, live_rows: int,
                    kv_len: int, real: int, pad: int, dead: int,
                    window_s: float, positions: int = 1) -> None:
        """One decode window: ``batch * steps * positions`` token-step
        computations (``positions`` = spec + 1 per speculative
        macro-step), of which ``real`` emitted tokens the client keeps,
        ``pad`` ran on parked rows and ``dead`` on live rows past their
        stop or on rejected draft positions."""
        total = batch * steps * positions
        useful = real / total if total else 0.0
        win_bytes = steps * (self.weight_bytes
                             + batch * self.kv_position_bytes * kv_len)
        eff_bytes = int(win_bytes * useful)
        entry = {"at": time.monotonic(),
                 "at_unix": round(time.time(), 4),
                 "steps": steps, "positions": positions, "batch": batch,
                 "live_rows": live_rows, "kv_len": kv_len, "real": real,
                 "pad": pad, "dead": dead,
                 "window_s": round(window_s, 6), "bytes": win_bytes,
                 "effective_bytes": eff_bytes}
        with self._lock:
            self.decode_real += real
            self.decode_pad += pad
            self.decode_dead += dead
            self.decode_token_steps_total += total
            self.decode_windows += 1
            self.decode_busy_s += window_s
            self.bytes_total += win_bytes
            self.bytes_effective += eff_bytes
            self._windows.append(entry)

    def note_prefill(self, *, bucket: int, batch: int,
                     real_tokens: int) -> None:
        """One prefill bucket group: ``batch * bucket`` positions were
        computed, ``real_tokens`` of them prompt-chunk tokens."""
        with self._lock:
            self.prefill_real += real_tokens
            self.prefill_pad += max(0, batch * bucket - real_tokens)
            self.prefill_dispatches += 1

    # -- reads (off the hot path) ----------------------------------------

    def report(self) -> Dict[str, object]:
        """Cumulative totals (the scrape-time delta-sync source).
        ``compiles_total``, ``compile_s_total``, ``compile_in_flight``
        and ``compiles`` (per executable) are XLA's compile counters in
        the JAX package: an eager PyTorch engine compiles nothing, so
        they read 0 (empty) here and keep their keys for the readers of
        ``/load`` and ``/debug/perf``."""
        with self._lock:
            return {
                "decode": {"real": self.decode_real,
                           "pad": self.decode_pad,
                           "dead": self.decode_dead,
                           "token_steps_total":
                               self.decode_token_steps_total,
                           "windows": self.decode_windows,
                           "busy_s": round(self.decode_busy_s, 4)},
                "prefill": {"real": self.prefill_real,
                            "pad": self.prefill_pad,
                            "dispatches": self.prefill_dispatches},
                "bytes_total": self.bytes_total,
                "bytes_effective": self.bytes_effective,
                "compiles_total": 0,
                "compile_s_total": 0.0,
                "compile_in_flight": 0,
                "compiles": {},
                "weight_bytes": self.weight_bytes,
                "kv_position_bytes": self.kv_position_bytes,
                "hbm_peak_bytes_per_s": self.hbm_peak_bytes_per_s,
            }

    def rates(self, horizon_s: float = 10.0) -> Dict[str, float]:
        """Recent rates from the ring: effective and total bytes per
        wall-clock second over the last ``horizon_s`` (idle time counts
        against them), MBU against the configured peak, the live
        fraction and decode tokens per second. The divisor is clamped
        to what the ring can witness: the uptime, and on a full ring the
        age of its oldest entry."""
        now = time.monotonic()
        window = min(horizon_s, max(1e-9, now - self._started_at))
        eff = tot = real = pad = dead = 0
        with self._lock:
            if (self._windows
                    and len(self._windows) == self._windows.maxlen):
                window = min(window, max(1e-9,
                                         now - self._windows[0]["at"]))
            cutoff = now - window
            for e in self._windows:
                if e["at"] >= cutoff:
                    eff += e["effective_bytes"]
                    tot += e["bytes"]
                    real += e["real"]
                    pad += e["pad"]
                    dead += e["dead"]
        all_steps = real + pad + dead
        eff_rate = eff / window
        return {
            "horizon_s": round(window, 3),
            "effective_bytes_per_s": round(eff_rate, 1),
            "total_bytes_per_s": round(tot / window, 1),
            "mbu_perc": round(100.0 * eff_rate
                              / self.hbm_peak_bytes_per_s, 4)
            if self.hbm_peak_bytes_per_s > 0 else 0.0,
            "live_fraction": round(real / all_steps, 6)
            if all_steps else 0.0,
            "decode_tokens_per_s": round(real / window, 3),
        }

    def perf_block(self, horizon_s: float = 10.0) -> Dict[str, object]:
        """The ``/load`` ``perf`` block: totals and recent rates."""
        r = self.report()
        out = {
            "token_steps": r["decode"],
            "prefill_tokens": r["prefill"],
            "bytes_total": r["bytes_total"],
            "bytes_effective": r["bytes_effective"],
            "compiles_total": r["compiles_total"],
            "compile_s_total": r["compile_s_total"],
            "compile_in_flight": r["compile_in_flight"],
            "weight_bytes": r["weight_bytes"],
        }
        out.update(self.rates(horizon_s))
        return out

    def recent_windows(self, limit: int = 50) -> List[dict]:
        """The newest ``limit`` window entries (``/debug/perf``)."""
        with self._lock:
            return list(self._windows)[-max(1, limit):]

    def recent_compiles(self, limit: int = 50) -> List[dict]:
        """Compile events for ``/debug/perf``: none (module docstring)."""
        return []

    def compile_events_between(self, t0: float, t1: float
                               ) -> List[Tuple[float, float, str, int,
                                               int, int]]:
        """Compile events overlapping ``[t0, t1]`` for a request's trace:
        none (module docstring)."""
        return []
