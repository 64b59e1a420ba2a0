"""The profiled slice of a traced run: device busy time, kernel time by
name and by the profiler range it was launched under, and the idle gaps.

``torch.profiler`` (CPU and CUDA activity) starts a lead-in before the
slice, because a trace that starts with the work drops its first device
events (the port's ``chip_smoke.py`` ``device_profile`` keeps the same
margin). The slice is bounded by two marker ranges: ``mark_start`` and
``mark_end``; ``mark_end`` waits for the device, so every kernel
launched before it has finished when the profiler stops. The
profiler's start and stop hold the engine's thread inside the window
(on an H100 with torch 2.11 its start takes 10-15 s), so the host's
times of a traced run are not an untraced run's, and no metric reads
them (PERF.md, §3).

``reduce`` reads the raw profiler events: a kernel shares its CUDA
correlation id with the runtime or driver call that launched it (or,
failing that, names the CPU op around the launch), and that launch lies
inside a ``record_function`` range of the same thread (serve.Probes'
labels) by time. Device time is clipped to the slice.
"""

import bisect
import threading
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

START, END = "bench.slice.start", "bench.slice.end"
RANGE_FAMILIES = ("bench.attn.", "bench.runner.")


class Slice:
    """The profiler, driven from the engine's own thread: the profiler
    records the CPU ops, and links the kernels, of the thread that
    starts it, and the engine loop's thread is the one that launches the
    work. ``attach`` wraps the engine's ``step``; the actions asked for
    (``start``, ``mark_start``, ``mark_end``, ``stop``) run in order, one
    before each step, so the slice holds whole steps and the profiler
    runs at least a step before and after it. ``took`` holds each
    action's host seconds."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self._todo: "list[str]" = []
        self._lock = threading.Lock()
        self.done = threading.Event()
        self.took: Dict[str, float] = {}

    def attach(self, engine) -> None:
        orig = engine.step

        def step(*a, **k):
            if self._todo:
                with self._lock:
                    action = self._todo.pop(0)
                t = time.perf_counter()
                getattr(self, "_" + action)()
                self.took[action] = time.perf_counter() - t
            return orig(*a, **k)
        engine.step = step
        self._detach = lambda: setattr(engine, "step", orig)

    def ask(self, action: str) -> None:
        with self._lock:
            self._todo.append(action)

    def _start(self) -> None:
        self.prof.start()

    def _mark_start(self) -> None:
        with torch.profiler.record_function(START):
            pass

    def _mark_end(self) -> None:
        with torch.profiler.record_function(END):
            pass
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    def _stop(self) -> None:
        self.prof.stop()
        self.done.set()

    def detach(self) -> None:
        self._detach()

    def reduce(self) -> Dict:
        return reduce_events(self.prof.profiler.kineto_results.events())


class _Intervals:
    """Non-overlapping ranges of one family on one thread, sorted."""

    def __init__(self, rows: List[Tuple[int, int, str]]):
        rows.sort()
        self.starts = [r[0] for r in rows]
        self.rows = rows

    def find(self, t: int):
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and self.rows[i][0] <= t <= self.rows[i][1]:
            return self.rows[i]
        return None


def _merge(iv: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def reduce_events(events) -> Dict:
    from torch.autograd import DeviceType
    marks: Dict[str, int] = {}
    ops: Dict[int, Tuple[int, int]] = {}       # op id -> (tid, start)
    launches: Dict[int, Tuple[int, int]] = {}  # CUDA correlation -> same
    ranges: Dict[Tuple[str, int], list] = defaultdict(list)
    device = []
    seen = defaultdict(int)
    for e in events:
        name = e.name()
        dtype = e.device_type()
        seen[(str(dtype), e.is_user_annotation())] += 1
        if dtype == DeviceType.CPU:
            start = e.start_ns()
            if name in (START, END):
                marks[name] = start
                continue
            where = (e.start_thread_id(), start)
            if name.startswith(("cuda", "cu")) and not e.is_user_annotation():
                # a CUDA runtime or driver call: where a kernel was
                # launched, by the CUDA correlation id they share
                launches[e.correlation_id()] = where
                continue
            ops[e.correlation_id()] = where
            if name.startswith("bench."):
                fam = next((f for f in RANGE_FAMILIES
                            if name.startswith(f)), None)
                if fam is not None:
                    ranges[(fam, where[0])].append(
                        (start, start + e.duration_ns(), name))
        elif (dtype == DeviceType.CUDA and not e.is_user_annotation()
              and not name.startswith("bench.")):
            start = e.start_ns()
            device.append((start, start + e.duration_ns(), name,
                           e.correlation_id(), e.linked_correlation_id()))
    device = [(s, end, name, launches.get(c) or ops.get(linked))
              for s, end, name, c, linked in device]
    if START not in marks or END not in marks or not device:
        return {"missing": {"marks": sorted(marks), "device": len(device),
                            "events": {str(k): v for k, v in seen.items()}}}
    a, b = marks[START], marks[END]
    fams = {k: _Intervals(v) for k, v in ranges.items()}

    def enclosing(fam: str, where):
        """The range of a family that holds a launch (thread, time)."""
        if where is None:
            return None
        iv = fams.get((fam, where[0]))
        return iv.find(where[1]) if iv is not None else None

    by_name: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    attn: Dict[int, float] = defaultdict(float)
    busy_iv = []
    for s, e, name, corr in device:
        cs, ce = max(s, a), min(e, b)
        if ce <= cs:
            continue
        dur = (ce - cs) / 1e9
        busy_iv.append((cs, ce))
        by_name[name][0] += dur
        by_name[name][1] += 1
        if "paged_decode" in name or "paged_prefill" in name:
            r = enclosing("bench.attn.", corr)
            if r is not None and r[0] >= a and r[1] <= b:
                attn[int(r[2].rsplit("#", 1)[1])] += (e - s) / 1e9
    merged = _merge(busy_iv)
    busy = sum(e - s for s, e in merged) / 1e9
    # idle gaps, named by the runner call the host was in at the gap's
    # start (if any)
    runner = [iv for (fam, _), iv in fams.items() if fam == "bench.runner."]
    gaps = []
    edges = [a] + [x for iv in merged for x in iv] + [b]
    for gs, ge in zip(edges[0::2], edges[1::2]):
        if ge <= gs:
            continue
        where = "host outside the runner's calls"
        for iv in runner:
            r = iv.find(gs)
            if r is not None:
                where = "host in " + r[2][len("bench."):]
                break
        gaps.append((where, (ge - gs) / 1e9))
    gaps.sort(key=lambda g: -g[1])
    ops_top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {"window_s": (b - a) / 1e9, "busy_s": busy,
            "by_name": {k: v for k, v in by_name.items()},
            "attn_kernel_s": dict(attn),
            "device_ops": [[k[:200], v[0]] for k, v in ops_top],
            "idle_gaps": [[w, s] for w, s in gaps[:10]]}
