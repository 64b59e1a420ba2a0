"""The worker ranks of a parallel serving engine, and rank 0's runner
that drives them. The JAX package has no counterpart: one JAX
controller drives every chip of its mesh.

``ParallelRunner`` is what ``LLMEngine`` holds on a serving mesh of more
than one rank: ``dp x ep x tp`` (``MeshConfig``; the engine builds
``tp x ep`` from ``tensor_parallel_size * expert_parallel_size > 1``,
and takes a mesh with dp > 1 only as an argument, as JAX does). The
engine process
is rank 0 — scheduler, block manager, server and rank 0's shard — and
the runner starts the other ranks as worker processes (spawned), each
of which builds its ``ServingMesh`` (parallel/mesh.py) from one
TCPStore, holds its shard of the weights, the KV pool and the adapters
in a ``ModelRunner`` of its own, and runs, in order, the calls rank 0
runs. The forward's collectives keep the ranks in step.

The call channel is one pipe per worker. Every runner entry point the
engine, the server and the KV connector use (``CALLS``) goes through
``_call``: under one lock, rank 0 sends the call to every worker, then
runs it on its own shard and returns its own result. Arguments travel
pickled: numpy arrays as they are, tensors as host copies, each of
which a worker moves to its device. The tensors of a dispatch's
sampling parameters and guided table change only at composition
changes, so those of ``decode``, ``decode_spec`` and ``prefill`` are
sent once and then named by a handle (``_TensorCache``), and a worker
keeps the same device tensor for a handle, which its runner's
identity-keyed caches (the batch's adapter factors) rely on. A decode
window runs at the batch of the carry that ``set_decode_state``
uploaded, which the engine cuts to the window's batch bucket: the
relayed call carries that cut, so every rank runs each window at rank
0's bucket and the collectives match. Weights
handed to the engine are cut per rank on rank 0 and sent to each
worker once; random weights are drawn by every rank from the seed.

Failure: every group is built with ``timeout_s``. A worker whose call
raises reports the traceback on its pipe and exits, which breaks its
sockets; rank 0's collective then raises, and rank 0 raises a
``WorkerError`` naming the rank instead of hanging. A worker that died
is found at the next send (a broken pipe). ``close`` stops every worker
and joins it, killing one that does not stop; a runner that is
collected without ``close`` stops its workers the same way.

``map_ranks`` calls a module-level function with each rank's runner, on
every rank (reports: a rank's pool, its memory).
"""

import collections
import dataclasses
import datetime
import importlib
import itertools
import multiprocessing
import pickle
import signal
import threading
import time
import traceback
import weakref
from typing import Any, List, Optional

import torch
import torch.distributed as dist

from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.models.config import ModelConfig
from production_stack_tpu_torch.parallel import sharding
from production_stack_tpu_torch.parallel.mesh import (MeshConfig,
                                                      ServingMesh, Shard,
                                                      device_map)
from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)

# seconds any collective, the store and the start-up wait for a peer
DEFAULT_TIMEOUT_S = 300.0
# seconds close() waits for a worker to stop before killing it
JOIN_TIMEOUT_S = 30.0

# the runner entry points every rank runs
CALLS = ("set_block_tables", "set_decode_state", "set_penalty_state",
         "set_lora", "decode", "decode_spec", "prefill", "embed",
         "prompt_logprobs", "extract_chunk", "inject_chunk", "warmup")
# calls whose tensors (sampling parameters, the guided table) are
# reused across calls and sent once per tensor
_CACHED_CALLS = ("decode", "decode_spec", "prefill")


class WorkerError(RuntimeError):
    """A worker rank failed or died; the engine cannot go on."""


@dataclasses.dataclass(frozen=True)
class _Ref:
    handle: int


@dataclasses.dataclass(frozen=True)
class _Val:
    tensor: torch.Tensor     # a host copy


def _walk(obj, fn):
    """obj with fn applied to every tensor (or _Ref/_Val) inside the
    tuples, lists, dicts and dataclasses it is made of."""
    if isinstance(obj, (torch.Tensor, _Ref, _Val)):
        return fn(obj)
    if isinstance(obj, tuple):
        return tuple(_walk(x, fn) for x in obj)
    if isinstance(obj, list):
        return [_walk(x, fn) for x in obj]
    if isinstance(obj, dict):
        return {k: _walk(v, fn) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _walk(getattr(obj, f.name), fn)
            for f in dataclasses.fields(obj)})
    return obj


class _TensorCache:
    """Rank 0's record of the tensors sent by handle: the tensor kept
    (so its id is not reused) with its handle, the oldest dropped past
    `capacity`, and the drops named in the next message."""

    def __init__(self, capacity: int = 64):
        self.capacity = capacity
        self.sent: "collections.OrderedDict[int, tuple]" = \
            collections.OrderedDict()
        self.handles = itertools.count(1)

    def pack(self, args, cached: bool):
        new = {}

        def one(t):
            if not cached:
                return _Val(t.detach().cpu())
            hit = self.sent.get(id(t))
            if hit is not None and hit[0] is t:
                self.sent.move_to_end(id(t))
                return _Ref(hit[1])
            h = next(self.handles)
            self.sent[id(t)] = (t, h)
            new[h] = t.detach().cpu()
            return _Ref(h)

        packed = _walk(args, one)
        drop = []
        while len(self.sent) > self.capacity:
            drop.append(self.sent.popitem(last=False)[1][1])
        return packed, new, drop


# ------------------------------------------------------------------ worker

# a worker's last result of each call, kept for last_result()
_LAST: dict = {}


def last_result(name: str):
    """This rank's last result of call `name`, on the host (workers
    answer it through ParallelRunner.run_on_workers)."""
    return _walk(_LAST.get(name), lambda t: t.detach().cpu())


def memory() -> dict:
    """This rank's device memory: allocated now and at its peak, bytes
    (zeros on the CPU)."""
    if not torch.cuda.is_available():
        return {"allocated": 0, "peak": 0}
    return {"allocated": torch.cuda.memory_allocated(),
            "peak": torch.cuda.max_memory_allocated()}


def pool_report(runner) -> dict:
    """A rank's KV pool: its dp coordinates, blocks (owned, and held
    with the scratch block) and bytes (payload and scales)."""
    c = runner.cache
    return {"dp_rank": c.dp_rank, "owned_blocks": c.local_blocks,
            "held_blocks": c.k.shape[1], "pool_blocks": c.num_blocks,
            "bytes": sum(t.nbytes for t in (c.k, c.v, c.ks, c.vs)
                         if t is not None)}


def pool_tensors(runner) -> dict:
    """Copies of a rank's KV pool tensors (and an int8 pool's scales), on
    the host."""
    c = runner.cache
    return {name: getattr(c, name).to("cpu", copy=True)
            for name in ("k", "v", "ks", "vs")
            if getattr(c, name) is not None}


def _send(conn, obj) -> None:
    conn.send_bytes(pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL))


def _recv(conn):
    return pickle.loads(conn.recv_bytes())


def _worker_main(rank: int, mesh_cfg: MeshConfig, model_cfg: ModelConfig,
                 engine_cfg: EngineConfig, port: int, conn,
                 timeout_s: float) -> None:
    """A worker rank: build the mesh, the shard and its runner, then run
    rank 0's calls in order until the stop message or rank 0's end."""
    # a terminal's Ctrl-C reaches the whole process group: rank 0 stops
    # the workers (the stop message, or the pipe's end when it exits)
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    torch.set_num_threads(1)
    from production_stack_tpu_torch.engine.runner import ModelRunner
    timeout = datetime.timedelta(seconds=timeout_s)
    _send(conn, ("ok", None))     # started: rank 0 may build its groups
    try:
        store = dist.TCPStore("127.0.0.1", port, mesh_cfg.size, False,
                              timeout=timeout)
        mesh = ServingMesh(mesh_cfg, rank, store, engine_cfg.torch_device,
                           timeout_s)
        params, lora_stacked, lora_scaling = _recv(conn)
        if params is not None:
            params = params.to(mesh.device)
        lora_stacked = _walk(lora_stacked,
                             lambda v: v.tensor.to(mesh.device))
        runner = ModelRunner(model_cfg, engine_cfg, params=params,
                             lora_stacked=lora_stacked,
                             lora_scaling=lora_scaling, mesh=mesh)
        del params, lora_stacked
        mesh.barrier()
    except Exception:   # noqa: BLE001 — reported, then the rank ends
        _report(conn, rank)
        return
    handles = {}
    while True:
        try:
            msg = _recv(conn)
        except (EOFError, OSError):
            return      # rank 0 is gone
        if msg is None:
            return
        op, name, args, kwargs, new, drop = msg
        try:
            for h, t in new.items():
                handles[h] = t.to(mesh.device)
            args, kwargs = _walk((args, kwargs), lambda v: (
                handles[v.handle] if isinstance(v, _Ref)
                else v.tensor.to(mesh.device)))
            for h in drop:
                handles.pop(h, None)
            if op == "call":
                _LAST[name] = getattr(runner, name)(*args, **kwargs)
            elif op == "setattr":
                setattr(runner, name, args[0])
            else:   # "run" / "map": a module-level function, answered
                if op == "map":
                    args = (runner,) + tuple(args)
                _send(conn, ("ok", _target(name)(*args, **kwargs)))
        except Exception:   # noqa: BLE001 — reported, then the rank ends
            _report(conn, rank)
            return


def _target(name: str):
    """The module-level function "module:function"."""
    mod, fn = name.split(":")
    return getattr(importlib.import_module(mod), fn)


def _report(conn, rank: int) -> None:
    try:
        _send(conn, ("error", f"rank {rank}: {traceback.format_exc()}"))
    except OSError:
        pass


# ------------------------------------------------------------------ rank 0

def _stop(procs, conns) -> None:
    """Stop every worker: the stop message, a join, then terminate and
    kill what is left."""
    for conn in conns:
        try:
            _send(conn, None)
        except OSError:
            pass
    for p in procs:
        p.join(JOIN_TIMEOUT_S)
        if p.is_alive():
            p.terminate()
            p.join(5)
        if p.is_alive():
            p.kill()
            p.join(5)
    for conn in conns:
        conn.close()


class ParallelRunner:
    """Rank 0's runner of a dp x ep x tp engine: its own shard's
    ModelRunner (``local``; attributes read through to it) and the worker
    ranks it started, which run every call in ``CALLS`` beside it.
    mesh_cfg: the serving mesh (sp = pp = 1)."""

    def __init__(self, model_cfg: ModelConfig, engine_cfg: EngineConfig,
                 mesh_cfg: MeshConfig, params=None, lora_stacked=None,
                 lora_scaling: float = 1.0,
                 timeout_s: Optional[float] = None):
        from production_stack_tpu_torch.engine.runner import ModelRunner
        Shard.of(mesh_cfg, 0)       # refuses sp and pp
        dp, tp, ep = mesh_cfg.dp, mesh_cfg.tp, mesh_cfg.ep
        device = engine_cfg.torch_device
        sharding.check_mesh(model_cfg, tp, ep, dp, device,
                            engine_cfg.dp_gather_attention_ok)
        self.mesh_cfg = mesh_cfg
        self.timeout_s = timeout_s = timeout_s or DEFAULT_TIMEOUT_S
        world = mesh_cfg.size
        self._lock = threading.RLock()
        self._cache = _TensorCache()
        self._procs: List[multiprocessing.Process] = []
        self._conns: list = []
        self._closed = False
        # rank 0's last result of each call (last_results)
        self._last: dict = {}
        timeout = datetime.timedelta(seconds=timeout_s)
        self._store = dist.TCPStore("127.0.0.1", 0, world, True,
                                    timeout=timeout,
                                    wait_for_workers=False)
        ctx = multiprocessing.get_context("spawn")
        for r in range(1, world):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_worker_main, name=f"engine-rank{r}",
                            args=(r, self.mesh_cfg, model_cfg, engine_cfg,
                                  self._store.port, child, timeout_s),
                            daemon=True)
            p.start()
            child.close()
            self._procs.append(p)
            self._conns.append(parent)
        self._finalizer = weakref.finalize(self, _stop, self._procs,
                                           self._conns)
        try:
            self._wait_started()
            mesh = ServingMesh(self.mesh_cfg, 0, self._store, device,
                               timeout_s)
            self.local = ModelRunner(model_cfg, engine_cfg, params=params,
                                     lora_stacked=lora_stacked,
                                     lora_scaling=lora_scaling, mesh=mesh)
            lora_host = _walk(lora_stacked, lambda t: _Val(t.detach().cpu()))
            for r, conn in enumerate(self._conns, start=1):
                # given weights (quantized in place above where asked):
                # each worker gets its own slice, on the host
                part = None if params is None else sharding.shard_params(
                    params, Shard.of(self.mesh_cfg, r)).cpu()
                _send(conn, (part, lora_host, lora_scaling))
                del part
            del params
            mesh.barrier()
        except BaseException as e:
            err = self._worker_errors(wait_s=2.0)
            self.close()
            if err:
                raise WorkerError(err) from e
            raise
        logger.info("dp=%d tp=%d ep=%d serving world: backend %s, ranks %s",
                    dp, tp, ep, mesh.backend, device_map(device, world))

    def _wait_started(self) -> None:
        """Each worker's first message, or a WorkerError as soon as one
        exits before it (a spawn or import failure) or timeout_s ends."""
        deadline = time.monotonic() + self.timeout_s
        for r, (p, conn) in enumerate(zip(self._procs, self._conns),
                                      start=1):
            while not conn.poll(0.2):
                if not p.is_alive() or time.monotonic() > deadline:
                    raise WorkerError(
                        f"rank {r} did not start (exit code {p.exitcode})")
            _recv(conn)

    # ------------------------------------------------------------------

    def __getattr__(self, name: str):
        if name in CALLS:
            return lambda *a, **kw: self._call(name, a, kw)
        if name == "local":     # not built: the constructor failed
            raise AttributeError(name)
        return getattr(self.local, name)

    @property
    def eos_id(self) -> int:
        return self.local.eos_id

    @eos_id.setter
    def eos_id(self, value: int) -> None:
        with self._lock:
            self._send_all(("setattr", "eos_id", (value,), {}, {}, []))
            self.local.eos_id = value

    @property
    def workers(self) -> List[multiprocessing.Process]:
        return list(self._procs)

    def _send_all(self, msg) -> None:
        if self._closed:
            raise WorkerError("the serving world is closed")
        for r, (p, conn) in enumerate(zip(self._procs, self._conns),
                                      start=1):
            try:
                _send(conn, msg)
            except OSError as e:
                raise WorkerError(
                    f"rank {r} is gone (exit code {p.exitcode}): "
                    f"{self._worker_errors(wait_s=0.5) or e}") from e

    def _call(self, name: str, args: tuple, kwargs: dict):
        with self._lock:
            if name == "prompt_logprobs":
                # refused before any rank starts it, so no rank waits in
                # a collective the others never reach
                T = args[0].shape[1] if args else kwargs["tokens"].shape[1]
                if T > self.local.engine_cfg.max_model_len:
                    raise ValueError(
                        f"prompt length {T} exceeds max_model_len "
                        f"{self.local.engine_cfg.max_model_len}")
            (pargs, pkwargs), new, drop = self._cache.pack(
                (args, kwargs), cached=name in _CACHED_CALLS)
            self._send_all(("call", name, pargs, pkwargs, new, drop))
            try:
                out = getattr(self.local, name)(*args, **kwargs)
                self._last[name] = out
                return out
            except Exception as e:
                err = self._worker_errors(wait_s=2.0)
                if err:
                    raise WorkerError(err) from e
                raise

    def run_on_workers(self, target: str, *args, **kwargs) -> List[Any]:
        """Call the module-level function `target` ("module:function") on
        every worker, in order after the calls before it; their results
        by rank (1..world-1)."""
        with self._lock:
            self._send_all(("run", target, args, kwargs, {}, []))
            return self._answers(target)

    def _answers(self, target: str) -> List[Any]:
        out = []
        for r, conn in enumerate(self._conns, start=1):
            if not conn.poll(self.timeout_s):
                raise WorkerError(f"rank {r} did not answer {target} "
                                  f"within {self.timeout_s}s")
            status, value = _recv(conn)
            if status != "ok":
                raise WorkerError(value)
            out.append(value)
        return out

    def map_ranks(self, target: str, *args, **kwargs) -> List[Any]:
        """target(runner, *args) ("module:function") with each rank's
        runner, on every rank in order after the calls before it; the
        results by rank (0..world-1)."""
        with self._lock:
            self._send_all(("map", target, args, kwargs, {}, []))
            mine = _target(target)(self.local, *args, **kwargs)
            return [mine] + self._answers(target)

    def last_results(self, name: str) -> list:
        """Every rank's last result of call `name`, on the host, by rank
        (a tensor-parallel world samples the same tokens on every
        rank)."""
        return [_walk(self._last.get(name), lambda t: t.detach().cpu())] \
            + self.run_on_workers(f"{__name__}:last_result", name)

    def _worker_errors(self, wait_s: float) -> str:
        """The errors the workers reported, waiting up to wait_s for a
        report from each that has not sent one."""
        errs = []
        for r, (p, conn) in enumerate(zip(self._procs, self._conns),
                                      start=1):
            try:
                if conn.poll(wait_s):
                    status, value = _recv(conn)
                    if status == "error":
                        errs.append(value)
                elif not p.is_alive():
                    errs.append(f"rank {r} exited with code {p.exitcode}")
            except (EOFError, OSError):
                errs.append(f"rank {r} exited with code {p.exitcode}")
        return "\n".join(errs)

    def close(self) -> None:
        """Stop and join every worker (idempotent)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._finalizer()
