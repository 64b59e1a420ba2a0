"""Engine efficiency accounting (``production_stack_tpu/engine/
efficiency.py``): every decode window's token-steps classified as real
(emitted tokens the client keeps), pad (parked rows) or dead (finished
rows' tails, rows finished between dispatch and read), every prefill
dispatch's bucket padding, and a modelled HBM traffic figure that gives
the effective-bandwidth and MBU gauges of ``/load`` and ``/metrics``.

The byte model is the JAX package's: one decode step streams the whole
weight set once plus, for every batch row, the KV prefix up to the
window's kv bucket; effective bytes are those scaled by the window's
live fraction, and MBU is effective bytes per wall-clock second over
``EngineConfig.hbm_peak_gbps``. On a CPU engine the absolute numbers
mean nothing, but the fractions (live / pad / dead) are exact.

The engine loop calls ``note_window`` once per window and
``note_prefill`` once per prefill bucket group: integer adds and one
bounded-ring append under a lock held only for them. ``perf_block`` (the
``/load`` ``perf`` block) takes only that lock, never the engine's.
"""

import collections
import threading
import time
from typing import Dict, Tuple

# KV-pool occupancy observed at allocation time (fraction of non-trash
# blocks held by live sequences)
OCCUPANCY_BUCKETS: Tuple[float, ...] = (
    0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0)

# decode windows the recent rates are taken over (the JAX default)
RING_ENTRIES = 256


class EngineEffAccounting:
    """Plain-int efficiency totals and a bounded ring of windows.

    ``kv_position_bytes``: the bytes one cache position costs one
    attention read (2 x layers x kv-heads x head-dim x itemsize, plus
    the int8 pool's f32 scales); ``weight_bytes``: the whole parameter
    set."""

    def __init__(self, *, weight_bytes: int, kv_position_bytes: int,
                 hbm_peak_bytes_per_s: float):
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
            maxlen=RING_ENTRIES)
        self._lock = threading.Lock()

    # -- step-loop writes ------------------------------------------------

    def note_window(self, *, steps: int, batch: int, kv_len: int,
                    real: int, pad: int, dead: int, window_s: float,
                    positions: int = 1) -> None:
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
        entry = {"at": time.monotonic(), "real": real, "pad": pad,
                 "dead": dead, "bytes": win_bytes,
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
        ``compiles_total``, ``compile_s_total`` and
        ``compile_in_flight`` are XLA's compile counters in the JAX
        package: an eager PyTorch engine compiles nothing, so they read
        0 here and keep their keys for the readers of ``/load``."""
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
