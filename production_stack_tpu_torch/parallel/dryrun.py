"""The JAX package's multichip dry run
(``__graft_entry__.dryrun_multichip``) over the port's worlds: the
training and pipeline halves (the sharded step, lines 57-112; GPipe's
loss, lines 283-299) and the serving half (lines 114-281).

    python -m production_stack_tpu_torch.parallel.dryrun --devices 8
    python -m production_stack_tpu_torch.parallel.dryrun --devices 4 \\
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

``dryrun_serving(n)`` serves, at JAX's sizes (debug-tiny and debug-moe,
f32, max_model_len 128, chunks of 32, windows of 4; on the card at head
dim 64, the smallest the paged kernels take, from a config.json written
for the run), with greedy requests of 8 tokens:
- a dp x tp engine (tp = 2 where n >= 2, dp = n // tp, behind
  ``dp_gather_attention_ok``) on the 2 dp prompts of JAX's, against the
  single-rank engine, over an f32 and an int8 pool, and over a bf16
  pool against the tp-only engine;
- debug-moe at ep x tp (2 x 2 where n >= 4) on the first two prompts,
  against the single-rank engine (JAX computes both and compares
  neither; here they must agree);
- the feature pass over tp (n-gram speculation at 3, a guided row, the
  first prompt again as a prefix-cache hit, a shaped row) against the
  single-rank engine, with a hit rate above 0 on both;
- a disaggregated handoff over tp: a producer publishes a 64-token
  prompt's KV to a disk tier, a consumer hits it and gives the
  producer's tokens.
Any miss raises, as JAX asserts. Its engines spawn their worker ranks.

Training ranks are processes (spawned, one TCPStore) on the card, rank
r on ``cuda:(r % device_count)``, and threads over one in-memory store
on the CPU; the backend is the serving rule (parallel/mesh.py): NCCL
where every rank has a card, gloo where ranks share one and on the CPU.
"""

import argparse
import dataclasses
import datetime
import json
import multiprocessing
import os
import queue
import tempfile
import threading
import time
import traceback
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.scheduler import SamplingOptions
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


# ------------------------------------------------------------- serving

# the JAX dry run's serving geometry (__graft_entry__.py:127-131)
SERVE = dict(max_model_len=128, prefill_chunk=32, prefill_buckets=(32,),
             decode_window=4, dtype="float32", kv_dtype="float32")
GREEDY = dict(temperature=0.0, max_tokens=8, ignore_eos=True)
# the feature pass's repetitive prompts (n-gram drafts accept runs; longer
# than a block of 16, so the first run registers a block the second hits)
SPEC_PROMPTS = ([7, 8, 9] * 13 + [7], [5, 6] * 20)
HANDOFF_PROMPT = list(range(40, 104))    # two publishable chunks of 32
# head dim of the tiny models on the card: the paged kernels take 64,
# 128 and 256 (JAX's kernel is off at debug-tiny's 32 as well)
CARD_HEAD_DIM = 64
_HF_CONFIGS = {
    "debug-tiny": {"model_type": "llama", "intermediate_size": 384},
    "debug-moe": {"model_type": "mixtral", "intermediate_size": 256,
                  "num_local_experts": 4, "num_experts_per_tok": 2},
}


def tiny_model(name: str, device: torch.device, where: str) -> dict:
    """The engine's model and tokenizer for a tiny preset: the preset on
    the CPU; on the card a directory under `where` holding the preset's
    config.json at head dim CARD_HEAD_DIM, with the preset's byte
    tokenizer (named by the preset: a directory's tokenizer would be
    read from the directory)."""
    if device.type == "cpu":
        return {"model": name, "tokenizer": name}
    path = os.path.join(where, f"{name}-d{CARD_HEAD_DIM}")
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(dict(_HF_CONFIGS[name], vocab_size=512, hidden_size=128,
                       num_hidden_layers=2, num_attention_heads=4,
                       num_key_value_heads=2, head_dim=CARD_HEAD_DIM,
                       max_position_embeddings=512,
                       tie_word_embeddings=False), f)
    return {"model": path, "tokenizer": name}


def _drain(eng: LLMEngine, sids: List[str]) -> List[List[int]]:
    """Step until every sequence of sids finished; their tokens."""
    pending = set(sids)
    for _ in range(500):
        if not pending:
            return [eng.seqs[s].output_tokens for s in sids]
        pending -= {o.seq_id for o in eng.step() if o.finished}
    raise AssertionError("serving dryrun did not converge")


def _serve(cfg: EngineConfig, mesh, prompts, report=None):
    """Greedy tokens of `prompts` through a new engine on `mesh`
    (None: one rank), closed after; report(engine) fills a dict."""
    eng = LLMEngine(cfg, mesh=mesh)
    try:
        opts = SamplingOptions(**GREEDY)
        toks = _drain(eng, [eng.add_request(list(p), opts)
                            for p in prompts])
        if report is not None:
            report(eng)
        return toks
    finally:
        eng.close()


def _feature_pass(cfg: EngineConfig, mesh) -> dict:
    """JAX's feature pass (__graft_entry__._feature_pass) on one engine:
    speculating greedy rows, a guided row, the first prompt again (a
    prefix-cache hit), a shaped row; then the hit rate."""
    eng = LLMEngine(cfg, mesh=mesh)
    try:
        opts = SamplingOptions(**GREEDY)
        out = {"plain": _drain(eng, [eng.add_request(list(p), opts)
                                     for p in SPEC_PROMPTS])}
        out["guided"] = _drain(eng, [eng.add_request(
            eng.tokenizer.encode("pick"), SamplingOptions(
                temperature=0.0, max_tokens=12,
                guided_regex=r"(one|two|three)", ignore_eos=True))])
        out["again"] = _drain(eng, [eng.add_request(list(SPEC_PROMPTS[0]),
                                                    opts)])
        out["shaped"] = _drain(eng, [eng.add_request(
            list(SPEC_PROMPTS[1]), SamplingOptions(
                temperature=0.0, max_tokens=8, ignore_eos=True,
                presence_penalty=2.0, min_tokens=6))])
        out["hit_rate"] = eng.block_mgr.hit_rate
        return out
    finally:
        eng.close()


def _handoff(model: dict, device: str, mesh, tier: str) -> dict:
    """A producer on `mesh` publishes HANDOFF_PROMPT's KV to the disk
    tier `tier`; a consumer on `mesh` serves it from the tier."""
    def cfg(role):
        return EngineConfig(**model, device=device, max_num_seqs=2,
                            **SERVE, kv_transfer_config={
                                "kv_role": role, "chunk_size": 32,
                                "local_cpu_gb": 0, "local_disk_path": tier})
    opts = SamplingOptions(**GREEDY)
    out = {}
    for role in ("kv_producer", "kv_consumer"):
        eng = LLMEngine(cfg(role), mesh=mesh)
        try:
            out[role] = _drain(eng, [eng.add_request(list(HANDOFF_PROMPT),
                                                     opts)])[0]
            eng.connector.flush()
            out[role + "_hit_tokens"] = eng.connector.hit_tokens
        finally:
            eng.close()
    return out


def dryrun_serving(n_devices: int, device="cuda",
                   workdir: Optional[str] = None) -> dict:
    """The serving half of the dry run (the module doc) on n_devices
    ranks; a report of what it measured (tokens, the dp engine's pool
    per rank and collectives, hit rates and tokens, seconds per part).
    workdir: where the card's model configs and the disk tier go (None:
    a temporary directory). Any miss raises."""
    if workdir is None:
        with tempfile.TemporaryDirectory() as where:
            return dryrun_serving(n_devices, device, where)
    device = resolve_device(device)
    dev = str(device)
    tp = 2 if n_devices >= 2 else 1    # debug-tiny has 2 kv heads
    dp = max(1, n_devices // tp)
    ep = moe_tp = 2 if n_devices >= 4 else 1    # debug-moe: 4 experts
    prompts = [list(range(3 + i, 23 + i)) for i in range(2 * dp)]
    report = {"mesh": {"dp": dp, "tp": tp}, "seconds": {}}
    tiny = tiny_model("debug-tiny", device, workdir)
    moe = tiny_model("debug-moe", device, workdir)
    base = EngineConfig(**tiny, device=dev, max_num_seqs=2 * dp,
                        dp_gather_attention_ok=True, **SERVE)
    serve_mesh = MeshConfig(dp=dp, tp=tp)

    def dp_report(eng):
        if eng.mesh is None:
            return
        report["dp_engine"] = {
            "world": eng.runner.mesh.describe(),
            "pool": eng.runner.map_ranks(
                "production_stack_tpu_torch.parallel.workers:"
                "pool_report"),
            "block_manager_blocks": eng.block_mgr.num_blocks,
            "collectives": dict(eng.runner.mesh.calls)}
    for kv, cfg, other in (
            ("float32", base, None),
            ("int8", dataclasses.replace(base, kv_dtype="int8"), None),
            ("bfloat16", dataclasses.replace(
                base, dtype="bfloat16", kv_dtype="bfloat16"),
             MeshConfig(tp=tp))):
        t0 = time.monotonic()
        got = _serve(cfg, serve_mesh, prompts,
                     dp_report if kv == "float32" else None)
        want = _serve(cfg, other, prompts)
        _check(got == want, f"tp{tp}xdp{dp} {kv}-KV serving tokens "
               f"diverge from {other or 'single-device'}: {got} vs "
               f"{want}")
        report[kv] = {"tokens": got, "against": str(other or "one rank")}
        report["seconds"][kv] = time.monotonic() - t0

    t0 = time.monotonic()
    moe_cfg = EngineConfig(**moe, device=dev, max_num_seqs=2,
                           **SERVE)
    got = _serve(moe_cfg, MeshConfig(ep=ep, tp=moe_tp), prompts[:2])
    want = _serve(moe_cfg, None, prompts[:2])
    _check(got == want, f"ep{ep}xtp{moe_tp} MoE serving tokens "
           f"diverge from single-device: {got} vs {want}")
    report["moe"] = {"mesh": {"ep": ep, "tp": moe_tp}, "tokens": got}
    report["seconds"]["moe"] = time.monotonic() - t0

    t0 = time.monotonic()
    feat_mesh = MeshConfig(tp=tp)
    feat_cfg = EngineConfig(**tiny, device=dev, max_num_seqs=2,
                            speculative_ngram_tokens=3, kv_block_size=16,
                            enable_prefix_caching=True, **SERVE)
    sharded = _feature_pass(feat_cfg, feat_mesh)
    solo = _feature_pass(feat_cfg, None)
    for case in ("plain", "guided", "shaped", "again"):
        _check(sharded[case] == solo[case],
               f"tp{tp} {case} decode diverges: {sharded[case]} vs "
               f"{solo[case]}")
    _check(sharded["again"][0] == sharded["plain"][0],
           f"tp{tp} prefix-cache re-run diverges from the first run: "
           f"{sharded['again']} vs {sharded['plain']}")
    _check(sharded["hit_rate"] > 0 and solo["hit_rate"] > 0,
           f"prefix cache never hit (sharded {sharded['hit_rate']}, "
           f"solo {solo['hit_rate']})")
    report["features"] = {"tp": tp, **sharded,
                          "solo_hit_rate": solo["hit_rate"]}
    report["seconds"]["features"] = time.monotonic() - t0

    t0 = time.monotonic()
    tier = os.path.join(workdir, "tier")
    handoff = _handoff(tiny, dev, feat_mesh, tier)
    _check(handoff["kv_consumer_hit_tokens"] > 0,
           "consumer never hit the produced KV tier")
    _check(handoff["kv_consumer"] == handoff["kv_producer"],
           f"disagg handoff diverges: consumer "
           f"{handoff['kv_consumer']} vs producer "
           f"{handoff['kv_producer']}")
    report["handoff"] = handoff
    report["seconds"]["handoff"] = time.monotonic() - t0
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=8,
                    help="ranks of the worlds (8: training at dp 2 x sp "
                         "2 x tp 2, serving at dp 4 x tp 2)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (ranks as processes) or cpu (training "
                         "ranks as threads, serving ranks as processes)")
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)
    print(json.dumps({
        "training": dryrun_multichip(args.devices, args.device, args.steps),
        "serving": dryrun_serving(args.devices, args.device)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
