"""The training and pipeline halves of the JAX package's multichip dry
run (``__graft_entry__.dryrun_multichip``: the sharded step, lines
57-112; GPipe's loss, lines 283-299) over the port's training worlds.

    python -m production_stack_tpu_torch.parallel.dryrun --devices 8
    python -m production_stack_tpu_torch.parallel.dryrun --devices 8 \\
        --device cpu

``dryrun_multichip(n)`` factors n ranks as JAX does
(``MeshConfig.for_devices``: 8 -> dp 2 x sp 2 x tp 2), builds the tiny
model of the JAX dry run (vocab 256, hidden 128, 2 layers, max(8, 2 tp)
heads over max(4, tp) kv heads of 16, f32) with random weights from a
seed, and takes `steps` sharded steps (ring attention over sp) on a
batch of max(2, 2 dp) x max(32, 16 sp) tokens: the losses are finite,
equal a one-rank run's on the same weights within 1e-4, and fall. Then
pp = 2 ranks (1 for n = 1) run GPipe over 4 microbatches of an 8 x 32
batch: the loss within 1e-4 of the plain loss (JAX asserts 1e-3), every
gradient within JAX's tolerance of the plain one (atol 2e-4, rtol
2e-3). Any miss raises.

Ranks are processes (spawned, one TCPStore) on the card, rank r on
``cuda:(r % device_count)``, and threads over one in-memory store on
the CPU; the backend is the serving rule (parallel/mesh.py): NCCL where
every rank has a card, gloo where ranks share one and on the CPU.
"""

import argparse
import datetime
import json
import multiprocessing
import queue
import threading
import time
import traceback
from typing import Callable, List

import numpy as np
import torch
import torch.distributed as dist

from production_stack_tpu_torch.models import llama
from production_stack_tpu_torch.models.config import ModelConfig
from production_stack_tpu_torch.parallel import pipeline, train
from production_stack_tpu_torch.parallel.mesh import MeshConfig, TrainWorld
from production_stack_tpu_torch.utils import resolve_device

# seconds a rank's collectives and the whole world may take
TIMEOUT_S = 300.0
LOSS_TOL = 1e-4
GRAD_ATOL, GRAD_RTOL = 2e-4, 2e-3
PP_BATCH, PP_SEQ, PP_MICRO = 8, 32, 4


def tiny_config(tp: int) -> ModelConfig:
    """The JAX dry run's "dryrun-tiny" model at a world's tp."""
    return ModelConfig(
        name="dryrun-tiny", vocab_size=256, hidden_size=128,
        intermediate_size=256, num_layers=2, num_heads=max(8, 2 * tp),
        num_kv_heads=max(4, tp), head_dim=16, max_position_embeddings=256,
        dtype=torch.float32)


def random_model(cfg: ModelConfig, device, seed: int) -> llama.Llama:
    device = resolve_device(device)
    return llama.init_params(
        cfg, torch.Generator(device=device).manual_seed(seed), device=device)


def _rank_main(rank: int, mesh_cfg: MeshConfig, device: str, store, fn,
               args, results) -> None:
    try:
        world = TrainWorld(mesh_cfg, rank, store, torch.device(device),
                           TIMEOUT_S)
        results.put((rank, "ok", fn(world, *args)))
    except Exception:   # noqa: BLE001 — reported to the caller
        results.put((rank, "error", traceback.format_exc()))


def _process_main(rank, mesh_cfg, device, port, fn, args, results):
    torch.set_num_threads(1)
    store = dist.TCPStore("127.0.0.1", port, mesh_cfg.size, False,
                          timeout=datetime.timedelta(seconds=TIMEOUT_S))
    _rank_main(rank, mesh_cfg, device, store, fn, args, results)


def run_world(mesh_cfg: MeshConfig, device, fn: Callable, *args) -> List:
    """fn(world, *args) on every rank of a training world; the results
    in rank order. On the card every rank is a spawned process, on the
    CPU a thread over one in-memory store. A rank that raises makes this
    raise with its traceback."""
    device = resolve_device(device)
    if device.type == "cpu":
        got = _run_threads(mesh_cfg, fn, args)
    else:
        got = run_processes(mesh_cfg, str(device), fn, args)
    out, errors = [None] * mesh_cfg.size, []
    for rank, status, value in got:
        if status == "error":
            errors.append(f"rank {rank}: {value}")
        else:
            out[rank] = value
    if errors or any(v is None for v in out):
        raise RuntimeError("training world failed:\n" + "\n".join(errors))
    return out


def _run_threads(mesh_cfg: MeshConfig, fn: Callable, args) -> list:
    store, results = dist.HashStore(), queue.Queue()
    threads = [threading.Thread(
        target=_rank_main, args=(r, mesh_cfg, "cpu", store, fn, args,
                                 results)) for r in range(mesh_cfg.size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT_S)
    if any(t.is_alive() for t in threads):
        raise RuntimeError(f"a rank of {mesh_cfg} did not finish in "
                           f"{TIMEOUT_S} s")
    return [results.get_nowait() for _ in range(results.qsize())]


def run_processes(mesh_cfg: MeshConfig, device: str, fn: Callable,
                  args) -> list:
    """(rank, status, value) of every rank, each a spawned process over
    one TCPStore (fn a module-level function, args picklable); every
    process is stopped before this returns, the others at once when one
    reports an error (they would wait on it in a collective)."""
    n = mesh_cfg.size
    store = dist.TCPStore("127.0.0.1", 0, n, True,
                          timeout=datetime.timedelta(seconds=TIMEOUT_S),
                          wait_for_workers=False)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_process_main, name=f"train-rank{r}",
                         args=(r, mesh_cfg, device, store.port, fn, args,
                               results), daemon=True)
             for r in range(n)]
    got = []
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + TIMEOUT_S
        while len(got) < n:
            try:
                got.append(results.get(timeout=max(
                    1.0, deadline - time.monotonic())))
            except queue.Empty:
                raise RuntimeError(
                    f"{n - len(got)} ranks of {mesh_cfg} did not report "
                    f"in {TIMEOUT_S} s") from None
            if got[-1][1] == "error":
                break
    finally:
        wait_s = 10 if len(got) == n else 1
        for p in procs:
            p.join(wait_s)
            if p.is_alive():
                p.terminate()
                p.join(5)
            if p.is_alive():
                p.kill()
                p.join(5)
    return got


def _train_rank(world: TrainWorld, cfg: ModelConfig, tokens: np.ndarray,
                steps: int, seed: int) -> dict:
    """`steps` sharded steps on this rank: its losses and collectives."""
    state, step_fn = train.jit_train_step(
        world, cfg, random_model(cfg, world.device, seed),
        sequence_parallel=world.size("sp") > 1)
    tokens = torch.from_numpy(tokens)
    losses = []
    for _ in range(steps):
        state, loss = step_fn(state, tokens)
        losses.append(float(loss))
    return {"losses": losses, "calls": dict(world.calls),
            "world": world.describe()}


def _max_excess(got: torch.Tensor, want: torch.Tensor) -> float:
    """max(|got - want| - rtol |want|): within atol where <= GRAD_ATOL."""
    return float(((got - want).abs() - GRAD_RTOL * want.abs()).max())


def _pp_rank(world: TrainWorld, cfg: ModelConfig, tokens: np.ndarray,
             n_micro: int, seed: int) -> dict:
    """GPipe's loss and this stage's gradients against the plain loss
    and gradients of the whole model, on this rank."""
    full = random_model(cfg, world.device, seed)
    P, s = world.size("pp"), world.index("pp")
    stage = train.trainable(pipeline.stage_params(full, P, s))
    tokens = torch.from_numpy(tokens).to(world.device)
    loss = pipeline.pipeline_loss_fn(cfg, world, n_micro)(stage, tokens)
    names = [n for n, _ in stage.named_parameters()]
    grads = torch.autograd.grad(loss, list(stage.parameters()))
    train.trainable(full)
    plain = train.loss_fn(full, cfg, tokens)
    want = dict(zip(names, torch.autograd.grad(
        plain, [getattr(full, n) for n in names])))
    per = cfg.num_layers // P
    excess = {}
    for name, g in zip(names, grads):
        w = want[name]
        if name in llama.LAYER_KEYS:
            w = w[s * per:(s + 1) * per]
        excess[name] = _max_excess(g, w)
    return {"loss": float(loss.detach()), "plain": float(plain.detach()),
            "grad_excess": excess, "calls": dict(world.calls),
            "world": world.describe()}


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def dryrun_multichip(n_devices: int, device="cuda", steps: int = 3,
                     seed: int = 0) -> dict:
    """The dry run of the module doc on n_devices ranks; a report of
    what it measured (losses, their differences, the pipeline's errors,
    backends, rank -> device maps, collectives per step, seconds)."""
    device = resolve_device(device)
    mesh_cfg = MeshConfig.for_devices(n_devices)
    cfg = tiny_config(mesh_cfg.tp)
    batch, seqlen = max(2, 2 * mesh_cfg.dp), max(32, 16 * mesh_cfg.sp)
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (batch, seqlen)).astype(np.int64)
    t0 = time.monotonic()
    ranks = run_world(mesh_cfg, device, _train_rank, cfg, tokens, steps,
                      seed)
    train_s = time.monotonic() - t0
    state = train.init_train_state(random_model(cfg, device, seed))
    opt = train.make_optimizer()
    one_rank = []
    for _ in range(steps):
        state, loss = train.train_step(state, torch.from_numpy(tokens).to(
            device), cfg, opt)
        one_rank.append(float(loss))
    losses = ranks[0]["losses"]
    _check(all(r["losses"] == losses for r in ranks),
           f"the ranks' losses differ: {[r['losses'] for r in ranks]}")
    _check(bool(np.isfinite(losses).all()), f"non-finite loss {losses}")
    diff = max(abs(a - b) for a, b in zip(losses, one_rank))
    _check(diff < LOSS_TOL, f"sharded losses {losses} differ from one "
           f"rank's {one_rank} by {diff}")
    _check(losses[-1] < losses[0], f"loss did not fall: {losses}")

    pp = 2 if n_devices >= 2 else 1   # dryrun-tiny has 2 layers
    pp_tokens = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (PP_BATCH, PP_SEQ)).astype(np.int64)
    t0 = time.monotonic()
    stages = run_world(MeshConfig(pp=pp), device, _pp_rank, cfg, pp_tokens,
                       PP_MICRO, seed)
    pp_s = time.monotonic() - t0
    pp_diff = max(abs(r["loss"] - r["plain"]) for r in stages)
    _check(pp_diff < LOSS_TOL, f"pp={pp} pipeline loss diverges from plain: "
           f"{[(r['loss'], r['plain']) for r in stages]}")
    excess = max(max(r["grad_excess"].values()) for r in stages)
    _check(excess <= GRAD_ATOL, f"pp={pp} pipeline gradients diverge from "
           f"plain: {[r['grad_excess'] for r in stages]}")
    return {
        "mesh": {"dp": mesh_cfg.dp, "sp": mesh_cfg.sp, "tp": mesh_cfg.tp},
        "world": ranks[0]["world"], "losses": losses,
        "one_rank_losses": one_rank, "max_loss_diff": diff,
        "collectives_per_step": {k: v / steps
                                 for k, v in ranks[0]["calls"].items()},
        "train_s": train_s,
        "pp": {"pp": pp, "n_micro": PP_MICRO, "loss": stages[0]["loss"],
               "plain": stages[0]["plain"], "loss_diff": pp_diff,
               "grad_max_excess": excess, "world": stages[0]["world"],
               "collectives": stages[0]["calls"], "seconds": pp_s},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=8,
                    help="ranks of the training world (8: dp 2 x sp 2 x "
                         "tp 2)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (ranks as processes) or cpu (threads)")
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)
    print(json.dumps(dryrun_multichip(args.devices, args.device,
                                      args.steps)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
