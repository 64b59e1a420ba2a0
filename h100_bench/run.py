"""Run one cell of the benchmark once.

    python3 -m h100_bench.run --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1> [--control w8a16]

from the root of a checkout. A run builds the port's kernels (the first
run of a checkout compiles them into ``build/torch_kernels/``), draws
the cell's model on the card from the seed (weights.py), serves it with
the port's engine and OpenAI server, warms it with the cell's own
traffic, and measures for ``--seconds`` seconds while the load
generator (client.py, a process of its own) drives it. Then it checks
what was served against the reference (judge.py) and prints one JSON
line last on standard output:

    {"correct", "attempted", "failed", "metrics", "device",
     ["breakdown"], ["control"], "checks"}

``--trace 0`` reports the cell's end-to-end metrics; ``--trace 1`` runs
the probes (serve.Probes) and the profiler over a slice of the window
(trace.py: from 40 % of the window on, for a fifth of it and at most 4
s) and reports the per-layer metrics. ``--control <precision>`` also
puts the control (reference.py) through the same check of what was
served and reports its verdict under "control"; the benchmark's own
runs never pass it. Without a card, with fewer cards
than the cell asks for, or with JAX or the JAX package loaded once the
window has closed, the run exits non-zero and prints no result.
"""

import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import queue  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the profiled slice: where it starts in the window, its share of the
# window and its longest length; the profiler starts LEAD_S earlier
SLICE_AT, SLICE_SHARE, SLICE_MAX_S, LEAD_S = 0.4, 0.2, 4.0, 1.0
# how long set-up may wait for the window to open
OPEN_TIMEOUT_S = 900.0


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m h100_bench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("w8a16",), default=None,
                   help="also check the control put in the program's "
                   "place (it has to come out not correct)")
    args = p.parse_args(argv)
    if args.seconds <= 0:
        p.error("--seconds must be positive")
    return args


def cache_env(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout, and
    no Flax through a library that would load it."""
    build = root / "build" / "h100_bench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


class Context:
    """What a metric's reader reads (metrics/*.py): the run's window,
    its client records, and in a traced run the probes' calls, the
    profiled slice and /debug/perf before and after."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


class _Lines:
    """The client's standard output, a line at a time, off a thread."""

    def __init__(self, stream):
        self.q: "queue.Queue[Optional[str]]" = queue.Queue()
        self.t = threading.Thread(target=self._pump, args=(stream,),
                                  daemon=True)
        self.t.start()

    def _pump(self, stream):
        for line in stream:
            self.q.put(line.strip())
        self.q.put(None)

    def wait_for(self, word: str, deadline: float) -> Optional[float]:
        while True:
            try:
                line = self.q.get(timeout=max(0.0, deadline
                                              - time.monotonic()))
            except queue.Empty:
                return None
            if line is None:
                return None
            if line.startswith(word + " "):
                return float(line.split()[1])


class Client:
    """The load generator's process (client.py) running one plan."""

    def __init__(self, plan: Dict):
        self.tmp = tempfile.mkdtemp(prefix="h100_bench-")
        self.plan_path = os.path.join(self.tmp, "plan.json")
        self.out_path = os.path.join(self.tmp, "run.json")
        with open(self.plan_path, "w") as f:
            json.dump(plan, f)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "h100_bench.client", self.plan_path,
             self.out_path], cwd=str(ROOT), stdout=subprocess.PIPE,
            text=True, env=env)
        self.lines = _Lines(self.proc.stdout)

    def result(self, timeout: float) -> Dict:
        self.proc.wait(timeout=timeout)
        if self.proc.returncode != 0:
            raise RuntimeError(f"the load generator exited "
                               f"{self.proc.returncode}")
        with open(self.out_path) as f:
            return json.load(f)

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.proc.stdout.close()
        for p in (self.plan_path, self.out_path):
            if os.path.exists(p):
                os.remove(p)
        os.rmdir(self.tmp)


def _sleep_until(t: float) -> None:
    dt = t - time.monotonic()
    if dt > 0:
        time.sleep(dt)


def run_cell(bench, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             log=sys.stderr, keep: Optional[Dict] = None,
             control: Optional[str] = None) -> Dict:
    """One run of one cell; returns the result (its ``error`` key set
    where the run could not complete). ``keep``, where given, receives
    the run's plan, client records, served ids and checked sample;
    ``control`` is judge.check's."""
    import torch
    from h100_bench import judge, serve, traffic
    from h100_bench.imports import forbidden_loaded
    from h100_bench import measures
    from h100_bench.weights import dims

    t_start = T_PROCESS if t_start is None else t_start
    wl = bench.workload(workload)
    cfg = bench.config(wl["config"])
    cfg_path = str(bench.config_path(wl["config"]))
    cell = bench.cell(workload)
    mix = bench.traffic(wl["traffic"])
    dev = torch.device(device)
    card = power_limit() if dev.type == "cuda" else None
    if card:
        print(f"card: {card}", file=log)

    model = serve.build_model(cfg_path, cfg, seed, dev)
    server = serve.Server(serve.engine_config(cfg_path, cfg, cell, seed,
                                              device), model)
    del model
    probes = serve.Probes(server) if trace else None
    drain_s = float(cell.get("drain_s", 60.0))
    plan = traffic.plan(mix, cell, seed, dims(cfg)["V"], seconds, drain_s)
    plan.update(url=server.url, model=server.model_id, seconds=seconds,
                drain_s=drain_s,
                deadline=time.monotonic() + OPEN_TIMEOUT_S + seconds
                + drain_s)
    slice_ = None
    client = Client(plan)
    lines = client.lines
    perf = {}
    try:
        t_open = lines.wait_for("open", plan["deadline"])
        if t_open is None:
            raise RuntimeError("the window never opened")
        setup_s = t_open - t_start
        if trace:
            from h100_bench.trace import Slice
            perf["before"] = server.get("/debug/perf?limit=1")["totals"]
            probes.recording = True
            a = t_open + SLICE_AT * seconds
            slice_ = Slice()
            slice_.attach(server.engine.engine)
            _sleep_until(a - LEAD_S)
            slice_.ask("start")
            _sleep_until(a)
            slice_.ask("mark_start")
            _sleep_until(a + min(SLICE_MAX_S, SLICE_SHARE * seconds))
            slice_.ask("mark_end")
            slice_.ask("stop")
        lines.wait_for("close", t_open + seconds + 60.0)
        if trace:
            probes.recording = False
            slice_.done.wait(timeout=120.0)
            slice_.detach()
            print("profiler actions, host s: " + json.dumps(
                {k: round(v, 4) for k, v in slice_.took.items()}),
                file=log)
            perf["after"] = server.get("/debug/perf?limit=1")["totals"]
        run = client.result(timeout=drain_s + 120.0)
        if server.failure() is not None:
            raise RuntimeError(f"the engine failed: {server.failure()!r}")
        peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else 0)
        served = dict(server.tee.served)
        calls = attn = prof = None
        if trace:
            probes.finish()
            calls, attn = probes.calls, probes.attn
            prof = slice_.reduce() if slice_.done.is_set() else {
                "missing": "the profiler never stopped"}
            slice_ = None
            if "missing" in prof:
                print(f"profiled slice incomplete: {prof['missing']}",
                      file=log)
                prof = {}
        ecfg = server.engine.engine.cfg
    finally:
        client.close()
        server.stop()
        server = probes = None
    if dev.type == "cuda":
        print(f"device memory after the program stopped: "
              f"{torch.cuda.memory_allocated(dev) / 2 ** 30:.3f} GiB "
              f"allocated", file=log)
    bad = forbidden_loaded()
    if bad:
        return {"error": f"forbidden modules loaded: {bad}"}
    verdict = judge.check(run, plan, served, cfg, cell, seed, dev,
                          control=control)
    if keep is not None:
        keep.update(plan=plan, run=run, served=served,
                    sample=verdict["sample"])
    print(f"widest gap (not compared): {verdict['widest_gap']}", file=log)
    ctx = Context(cfg=cfg, cell=cell, workload=workload, seconds=seconds,
                  run=run, setup_s=setup_s, peak_bytes=peak, calls=calls,
                  attn=attn, profile=prof, perf=perf,
                  engine_cfg=ecfg, card=card)
    metrics = {}
    for m in bench.metrics(workload, trace):
        v = bench.read(m, ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    window = [r for r in run["records"] if r["in_window"]]
    ttft, tpot = measures.ttfts_s(run), measures.tpots_s(run)
    print("latency ms: " + json.dumps({
        f"{name}_p{p}": round(1e3 * measures.percentile(v, p), 3)
        for name, v in (("ttft", ttft), ("tpot", tpot))
        for p in (50, 80, 90, 95, 99)}) + f" over {len(ttft)} / "
        f"{len(tpot)} requests", file=log)
    late = run["lateness_s"]
    print(f"window: {len(window)} requests, generator late by at most "
          f"{max(late, default=0.0):.4f} s (p95 "
          f"{sorted(late)[int(0.95 * (len(late) - 1))] if late else 0.0:.4f}"
          f" s)", file=log)
    result = {"correct": verdict["correct"], "attempted": len(window),
              "failed": measures.failed(run), "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else
                         dev.type,
                         "kind": (torch.cuda.get_device_name(dev)
                                  if dev.type == "cuda" else "cpu"),
                         "count": 1, "memory_peak_bytes": peak}}
    if card:
        result["card"] = card
    if trace and prof:
        result["device"]["busy_s"] = prof["busy_s"]
        result["device"]["window_s"] = prof["window_s"]
        result["breakdown"] = {"device_ops": prof["device_ops"],
                               "idle_gaps": prof["idle_gaps"]}
    if control is not None:
        result["control"] = {k: verdict["control"][k] for k in
                             ("precision", "correct", "checks",
                              "widest_gap")}
    result["checks"] = verdict["checks"]
    return result


def main(argv=None) -> int:
    args = parse_args(argv)
    cache_env(ROOT)
    from h100_bench.spec import Bench
    try:
        bench = Bench(ROOT)
        wl = bench.workload(args.workload)
    except (OSError, KeyError, ValueError) as e:
        print(f"h100_bench: {e}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("h100_bench: no CUDA device", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < wl["chips"]:
        print(f"h100_bench: {wl['name']} needs {wl['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    try:
        result = run_cell(bench, args.workload, args.seed, args.seconds,
                          bool(args.trace), control=args.control)
    except ImportError as e:
        print(f"h100_bench: the program is missing: {e}", file=sys.stderr)
        return 5
    if "error" in result:
        print(f"h100_bench: {result['error']}", file=sys.stderr)
        return 4
    if "control" in result:
        ctl = result["control"]
        for name, c in ctl["checks"].items():
            print(f"control {ctl['precision']} check {name}: {c['value']} "
                  f"(limit {c['rule']} {c['limit']})", file=sys.stderr)
        print(f"control {ctl['precision']} correct: {ctl['correct']}",
              file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['rule']} "
              f"{c['limit']})", file=sys.stderr)
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
