"""What the port's loadgen modes start: the coordinator spawns the port's
worker (with no JAX_PLATFORMS), distload's capstone and multitenant
spawn the port's router, every ``run_*`` and launcher defaults its
engines to the card, the lazy imports inside the copies name the port,
and one closed loop through the port's CLI on fake engines:
``loadgen disagg`` with one producer (SIGKILLed mid-storm and
restarted) and one consumer.
"""

import ast
import asyncio
import inspect
import json
import os
import subprocess
import sys

import pytest

from production_stack_tpu_torch.loadgen import orchestrator as torch_orch
from production_stack_tpu_torch.loadgen.distributed import \
    coordinator as tcoord

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOADGEN = os.path.join(REPO, "production_stack_tpu_torch", "loadgen")

# the modules this package gained beside the loadgen core
MODULES = ["__main__", "kvshare", "kvmigrate", "disagg", "trace", "chaos",
           "overhead", "effwatch", "firedrill", "incident", "fleetdrill",
           "multirouter", "multitenant", "distributed.__init__",
           "distributed.shard", "distributed.tracefile",
           "distributed.worker", "distributed.coordinator",
           "distributed.distload"]


def _path(name):
    return os.path.join(LOADGEN, *name.split(".")) + ".py"


def _module(cmd):
    return cmd[cmd.index("-m") + 1]


def test_every_jax_loadgen_module_has_its_copy():
    jax = os.path.join(REPO, "production_stack_tpu", "loadgen")
    want = sorted(os.path.relpath(os.path.join(d, f), jax)
                  for d, _, fs in os.walk(jax) for f in fs
                  if f.endswith(".py"))
    got = sorted(os.path.relpath(os.path.join(d, f), LOADGEN)
                 for d, _, fs in os.walk(LOADGEN) for f in fs
                 if f.endswith(".py"))
    assert got == want
    for name in MODULES:
        assert os.path.exists(_path(name)), name


def _lazy_imports(tree):
    """Package imports made inside a function body: (line, module)."""
    out = []
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for node in ast.walk(fn):
            if isinstance(node, ast.ImportFrom) and node.module:
                out.append((node.lineno, node.module))
            elif isinstance(node, ast.Import):
                out += [(node.lineno, a.name) for a in node.names]
    return [(line, m) for line, m in out
            if m.split(".")[0].startswith("production_stack_tpu")]


def test_lazy_imports_name_the_port():
    found = {}
    for name in MODULES:
        with open(_path(name)) as f:
            text = f.read()
        for line, mod in _lazy_imports(ast.parse(text)):
            assert mod.split(".")[0] == "production_stack_tpu_torch", \
                (name, line, mod)
            found.setdefault(mod, []).append(f"{name}:{line}")
        assert "production_stack_tpu." not in text, name
        assert "JAX_PLATFORMS" not in text, name
    # the lazy imports of the JAX files have their counterparts here
    assert {"production_stack_tpu_torch.router.service_discovery",
            "production_stack_tpu_torch.loadgen.overhead",
            "production_stack_tpu_torch.kvcache.store",
            "production_stack_tpu_torch.loadgen.multirouter",
            "production_stack_tpu_torch.loadgen.kvshare"} <= set(found)


def _run_functions():
    import importlib
    for name in MODULES:
        mod = importlib.import_module(
            "production_stack_tpu_torch.loadgen." +
            name.replace(".__init__", ""))
        for attr, fn in vars(mod).items():
            if inspect.isfunction(fn) and fn.__module__ == mod.__name__ \
                    and "platform" in inspect.signature(fn).parameters:
                yield f"{name}.{attr}", fn


RUN_FUNCTIONS = dict(_run_functions())


def test_every_platform_default_is_the_card():
    defaults = {name: inspect.signature(fn).parameters["platform"].default
                for name, fn in RUN_FUNCTIONS.items()}
    for run in ("kvshare.run_kvshare", "kvmigrate.run_kvmigrate",
                "disagg.run_disagg", "trace.run_trace", "chaos.run_chaos",
                "overhead.run_overhead", "effwatch.run_effwatch",
                "firedrill.run_firedrill", "incident.run_incident",
                "fleetdrill.run_fleetdrill", "multirouter.run_multirouter",
                "multitenant.run_multitenant",
                "distributed.distload.run_distload"):
        assert defaults[run] == "cuda", run
    assert {d for d in defaults.values()
            if d is not inspect.Parameter.empty} == {"cuda"}, defaults


def test_effwatch_ab_record_names_the_card(monkeypatch):
    """run_effwatch_ab's record takes the platform it was given, the card
    when none was."""
    from production_stack_tpu.loadgen import effwatch as jeff
    from production_stack_tpu_torch.loadgen import effwatch as teff
    with open(os.path.join(REPO, "EFF_r15.json")) as f:
        side = json.load(f)

    async def run(**kw):
        rec = json.loads(json.dumps(side))
        rec["detail"]["window_adapt"] = kw["window_adapt"]
        return rec
    monkeypatch.setattr(teff, "run_effwatch", run)
    monkeypatch.setattr(jeff, "run_effwatch", run)
    got = asyncio.run(teff.run_effwatch_ab(engine="fake", rounds=2))
    want = asyncio.run(jeff.run_effwatch_ab(engine="fake", rounds=2))
    assert (got.pop("platform"), want.pop("platform")) == ("cuda", "cpu")
    assert got == want
    assert asyncio.run(teff.run_effwatch_ab(
        engine="fake", platform="cpu"))["platform"] == "cpu"


class _Spawned(Exception):
    pass


@pytest.fixture
def spawned(monkeypatch):
    """_spawn recording (name, argv) in the given modules' namespaces and
    stopping the caller at the first spawn."""
    calls = []

    def spawn(name, cmd, url, log_dir, env=None):
        calls.append(dict(name=name, cmd=cmd, env=env))
        raise _Spawned(name)

    def patch(*mods):
        for mod in mods:
            monkeypatch.setattr(mod, "_spawn", spawn)
        return calls
    return patch


def test_multitenant_spawns_the_port_router(spawned):
    from production_stack_tpu_torch.loadgen import multitenant
    calls = spawned(multitenant)
    with pytest.raises(_Spawned):
        multitenant._launch_pool_router(
            8123, pools_json="{}", config_path="c.json", log_dir="logs",
            max_inflight=4, tenant_rate=1.0, extra_args=[])
    (call,) = calls
    assert _module(call["cmd"]) == "production_stack_tpu_torch.router.app"
    assert not call["env"]


def test_distload_capstone_spawns_the_port_router(spawned, monkeypatch):
    from production_stack_tpu_torch.loadgen.distributed import distload
    calls = spawned(distload)

    def engine(kind, port, *, log_dir, platform="cuda", extra_args=None):
        return torch_orch.Proc(name=f"e{port}", popen=None,
                               url=f"http://127.0.0.1:{port}",
                               log_path="x")

    async def healthy(*a, **k):
        return None
    monkeypatch.setattr(distload, "launch_engine", engine)
    monkeypatch.setattr(distload, "wait_healthy", healthy)
    monkeypatch.setattr(distload, "_stop", lambda procs: None)
    with pytest.raises(_Spawned):
        asyncio.run(distload._run_capstone(
            trace_path="never-read.trace.jsonl", workers=2, speedup=4.0,
            routers=2, engines_per_pool=1, service_jitter=0.1,
            worker_timeout_s=10.0, startup_timeout_s=5.0, log_dir="logs",
            work_dir="wd", control_errors=[]))
    (call,) = calls
    assert _module(call["cmd"]) == "production_stack_tpu_torch.router.app"
    assert "--pools" in call["cmd"] and not call["env"]


def test_coordinator_runs_the_port_workers(tmp_path, monkeypatch):
    """Two port worker processes against a fake engine: the coordinator
    starts `production_stack_tpu_torch.loadgen.distributed.worker` with
    the caller's environment (no JAX_PLATFORMS) and merges their
    records."""
    from production_stack_tpu_torch.loadgen.spec import (ArrivalSpec,
                                                         SessionSpec,
                                                         WorkloadSpec)
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    popens = []
    real = subprocess.Popen

    def popen(cmd, **kw):
        popens.append((cmd, kw))
        return real(cmd, **kw)
    monkeypatch.setattr(tcoord.subprocess, "Popen", popen)
    eng = torch_orch.launch_engine("fake", torch_orch.free_port(),
                                   log_dir=str(tmp_path / "logs"))
    try:
        asyncio.run(torch_orch.wait_healthy(eng.url, 60.0))
        spec = WorkloadSpec(
            name="t", model="fake-model", seed=3,
            session=SessionSpec(rounds_min=1, rounds_max=2,
                                system_prompt_tokens=8,
                                question_tokens_mean=8.0,
                                question_tokens_max=12,
                                answer_tokens_mean=8.0,
                                answer_tokens_max=8),
            arrival=ArrivalSpec(users=2)).validate()
        asns = tcoord.synthetic_assignments(spec, eng.url, workers=2,
                                            total_sessions=6)
        res = tcoord.run_coordinated(asns, work_dir=str(tmp_path / "wd"),
                                     timeout_s=120.0)
    finally:
        torch_orch._stop([eng])
    workers = [(cmd, kw) for cmd, kw in popens if "-m" in cmd
               and _module(cmd).endswith("distributed.worker")]
    assert len(workers) == 2
    for cmd, kw in workers:
        assert _module(cmd) == \
            "production_stack_tpu_torch.loadgen.distributed.worker"
        assert "JAX_PLATFORMS" not in (kw.get("env") or os.environ)
        assert kw["cwd"] == REPO
    assert res.violations == []
    assert res.merged_summary["errors"] == 0
    assert len({r.session_id for r in res.records}) == 6


def test_disagg_cli_closed_loop_on_fake_engines(tmp_path):
    """The P/D split through the port's CLI: one producer, SIGKILLed at
    0.4 of the storm and restarted, one consumer; then the aggregated
    baseline. The storm outlasts the restart, so the restarted producer
    publishes again (the record reads the prefill pool's counters from
    it)."""
    out = tmp_path / "disagg.json"
    proc = subprocess.run(
        [sys.executable, "-m", "production_stack_tpu_torch.loadgen",
         "disagg", "--engine", "fake", "--platform", "cpu",
         "--prefill-engines", "1", "--decode-engines", "1",
         "--duration", "14", "--kill-downtime", "1",
         "--min-itl-improvement", "-1", "--output", str(out),
         "--log-dir", str(tmp_path / "logs")],
        cwd=REPO, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "disagg PASSED" in proc.stdout
    record = json.loads(out.read_text())
    assert record["platform"] == "cpu"
    split = record["detail"]["split_phase"]
    assert split["chaos"] == {"kills": 1, "restarts": 1}
    roles = {kv["pool"]: kv["role"] for kv in split["engine_kv"].values()}
    assert roles == {"prefill": "kv_producer", "decode": "kv_consumer"}
    assert sum(kv["hit_tokens"] for kv in split["engine_kv"].values()
               if kv["pool"] == "decode") > 0
    assert sum(kv["progress_published_chunks"]
               for kv in split["engine_kv"].values()
               if kv["pool"] == "prefill") > 0
    for phase in (split, record["detail"]["aggregated_baseline"]):
        for cls in ("chat", "rag"):
            assert phase[cls]["errors"] == 0 and phase[cls]["finished"] > 0
