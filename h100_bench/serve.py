"""The system under test: the port's engine behind its OpenAI server,
fed the benchmark's weights. The only module of the harness that
imports the program.

- ``build_model``: the port's ``Llama`` module filled from weights.py's
  draws, a layer at a time on the device.
- ``Server``: ``AsyncLLMEngine(cfg, params=model)`` served by
  ``engine/server.build_app`` on a free localhost port, from an event
  loop on a thread of its own.
- ``Tee``: files the token ids the engine produced for each prompt
  (``AsyncLLMEngine.stream``, which the server calls), so the check of
  what was served compares exact ids with what the client received.
- ``Probes`` (traced runs only): CUDA events and profiler ranges around
  the runner's ``prefill`` / ``decode``, and a profiler range around
  each paged attention call, whose shapes it keeps. Each wraps the name
  its callers resolve at call time.
"""

import asyncio
import contextlib
import gc
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from h100_bench import weights as W
from h100_bench.client import prompt_key


def engine_config(cfg_path: str, cfg: dict, cell: dict, seed: int,
                  device: str):
    from production_stack_tpu_torch.engine.config import EngineConfig
    dep = cfg.get("deployment", {})
    return EngineConfig(model=cfg_path, device=device, seed=seed,
                        quantization=dep.get("quantization"),
                        dtype=dep.get("dtype", "bfloat16"),
                        kv_dtype=dep.get("kv_dtype", "bfloat16"),
                        **cell["engine"])


@torch.no_grad()
def build_model(cfg_path: str, cfg: dict, seed: int, device):
    """The port's Llama module holding weights.py's draws."""
    from production_stack_tpu_torch.models.config import get_config
    from production_stack_tpu_torch.models.llama import Llama
    mcfg = get_config(cfg_path)
    model = Llama(mcfg, device=device)
    for name, layer, value in W.iter_draws(cfg, seed, device):
        leaf = getattr(model, name)
        (leaf if layer is None else leaf[layer]).copy_(value)
        del value
    return model


class Tee:
    """Token ids the engine produced, by prompt key."""

    def __init__(self, engine):
        self.served: Dict[str, List[int]] = {}
        orig = engine.stream

        async def stream(prompt_tokens, options, model=None, deadline=None):
            ids = self.served.setdefault(prompt_key(prompt_tokens), [])
            async with contextlib.aclosing(orig(
                    prompt_tokens, options, model=model,
                    deadline=deadline)) as it:
                async for out in it:
                    if out.new_token is not None:
                        ids.append(int(out.new_token))
                    yield out
        engine.stream = stream


class Server:
    """The engine and its server on a thread's event loop."""

    def __init__(self, ecfg, model):
        from aiohttp import web
        from production_stack_tpu_torch.engine.async_engine import \
            AsyncLLMEngine
        from production_stack_tpu_torch.engine.server import build_app
        self.engine = AsyncLLMEngine(ecfg, params=model)
        self.model_id = ecfg.model
        self.tee = Tee(self.engine)
        self.warmup_s = self.engine.engine.runner.warmup()
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       name="bench-server", daemon=True)
        self.thread.start()
        self.runner = web.AppRunner(build_app(self.engine),
                                    handle_signals=False)
        self._call(self.runner.setup())
        site = web.TCPSite(self.runner, "127.0.0.1", 0)
        self._call(site.start())
        port = site._server.sockets[0].getsockname()[1]
        self.url = f"http://127.0.0.1:{port}"

    def _call(self, coro, timeout: float = 120.0):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(
            timeout)

    def get(self, path: str) -> dict:
        """GET a JSON route of the server (from any thread but its
        loop's)."""
        import json
        import urllib.request
        with urllib.request.urlopen(self.url + path, timeout=60) as r:
            return json.loads(r.read())

    def failure(self) -> Optional[BaseException]:
        return self.engine.failure

    def stop(self) -> None:
        """Stop the server, the engine loop and the event loop, and free
        the program's device state: the runner's weights, pool and
        carried tensors are dropped by name, whatever else may still
        hold the engine."""
        try:
            self._call(self.runner.cleanup())
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self.thread.join(timeout=30)
            self.loop.close()
            eng = self.engine.engine
            for obj in (eng.runner, eng):
                for name, value in list(vars(obj).items()):
                    if isinstance(value, (torch.Tensor, torch.nn.Module)) \
                            or type(value).__name__ == "KVCache":
                        setattr(obj, name, None)
            self.engine = self.runner = self.loop = self.thread = None
            gc.collect()
            if torch.cuda.is_available():
                torch.cuda.empty_cache()


class Probes:
    """The traced run's instruments (module doc). ``recording`` gates
    what the runner wrappers keep: the window's calls."""

    def __init__(self, server: Server):
        from production_stack_tpu_torch.ops import paged_attention as pa
        self.recording = False
        self.calls: List[dict] = []
        self.attn: List[dict] = []
        self._current: Optional[dict] = None
        self._starts_seen: Dict[int, torch.Tensor] = {}
        self._undo = []
        runner = server.engine.engine.runner
        cuda = runner.device.type == "cuda"
        for kind in ("prefill", "decode"):
            self._wrap_runner(runner, kind, cuda)
        for name in ("paged_attention", "paged_decode_attention"):
            self._wrap_attention(pa, name)

    def _patch(self, obj, name, fn):
        orig = getattr(obj, name)
        setattr(obj, name, fn)
        self._undo.append((obj, name, orig))
        return orig

    def remove(self) -> None:
        for obj, name, orig in reversed(self._undo):
            setattr(obj, name, orig)
        self._undo.clear()

    def _wrap_runner(self, runner, kind, cuda):
        orig = getattr(runner, kind)
        label = f"bench.runner.{kind}"

        def wrapped(*a, **k):
            if not self.recording:
                with torch.profiler.record_function(label):
                    return orig(*a, **k)
            rec = {"kind": kind, "forwards": []}
            if kind == "prefill":
                rec["starts"] = np.asarray(a[1]).tolist()
                rec["lengths"] = np.asarray(a[2]).tolist()
            if cuda:
                rec["ev"] = (torch.cuda.Event(enable_timing=True),
                             torch.cuda.Event(enable_timing=True))
                rec["ev"][0].record()
            self._current = rec
            try:
                with torch.profiler.record_function(label):
                    return orig(*a, **k)
            finally:
                self._current = None
                if cuda:
                    rec["ev"][1].record()
                self.calls.append(rec)
        self._patch(runner, kind, wrapped)

    def _wrap_attention(self, pa, name):
        orig = getattr(pa, name)

        def wrapped(q, k_pool, v_pool, tables, starts, *a, **k):
            if not self.recording:
                return orig(q, k_pool, v_pool, tables, starts, *a, **k)
            # one copy of a forward's starts, shared by its layers: the
            # decode carry advances the tensor in place after the call
            key = id(starts)
            snap = self._starts_seen.get(key)
            if snap is None or snap[0] is not starts:
                snap = (starts, starts.clone())
                self._starts_seen = {key: snap}
                if self._current is not None:
                    self._current["forwards"].append(
                        {"T": q.shape[1], "starts": snap[1]})
            call = {"name": name, "index": len(self.attn),
                    "B": q.shape[0], "T": q.shape[1], "H": q.shape[2],
                    "D": q.shape[3], "nb": k["nb"],
                    "MB": tables.shape[1], "Bs": k_pool.shape[2],
                    "Hkv": k_pool.shape[1], "itemsize": q.element_size(),
                    "kv_itemsize": k_pool.element_size(),
                    "window": k.get("window", 0), "starts": snap[1]}
            self.attn.append(call)
            with torch.profiler.record_function(
                    f"bench.attn.{name}#{call['index']}"):
                return orig(q, k_pool, v_pool, tables, starts, *a, **k)
        self._patch(pa, name, wrapped)

    def finish(self) -> None:
        """After the window: device times of the calls and host copies
        of every kept starts."""
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        host: Dict[int, list] = {}

        def to_host(t):
            if id(t) not in host:
                host[id(t)] = t.cpu().tolist()
            return host[id(t)]
        for rec in self.calls:
            ev = rec.pop("ev", None)
            rec["device_s"] = (ev[0].elapsed_time(ev[1]) / 1e3
                               if ev is not None else None)
            for f in rec["forwards"]:
                f["starts"] = to_host(f["starts"])
        for call in self.attn:
            call["starts"] = to_host(call["starts"])
        self.remove()
