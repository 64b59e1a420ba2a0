"""disagg mode: disaggregated prefill/decode, measured end to end.

The closed loop for BASELINE config 5. The
orchestrator launches the SPLIT topology — a shared TPKV cache server, P
kv_producer prefill engines, D kv_consumer decode engines, and the real
router wired with ``--prefill-backends`` — then the AGGREGATED baseline
at **equal engine count** (P+D plain engines, no pools), and drives the
identical mixed workload at both:

- **chat class**: short prompts, long streamed decodes — the traffic
  whose inter-token latency (ITL) the split is supposed to protect;
- **rag class**: long unique prompts, short decodes — the head-of-line
  blocker. In the aggregated fleet its prefill paces on the same
  engines that are mid-decode (the fake's
  ``--prefill-decode-interference`` models the fused-step contention a
  real engine shows); in the split fleet prefill runs on the producer
  pool and the decode pool sees only the uncached chunk remainder.

Mid-run the rig SIGKILLs a prefill pod and restarts it (the chaos
extension to the split topology): the degradation contract says decode
recomputes — **zero client-visible errors** — while the router's
fallback counters tick.

``disagg_violations`` is the pass/fail contract the CLI enforces
(exit 1): any raw 5xx or transport error in either phase, chat ITL p99
not improving by ``min_itl_improvement`` split-vs-aggregated, a split
decode pool that never consumed tier KV, producers that never published
mid-prefill, or a scheduled prefill-kill that didn't happen. Run with
``--no-split`` both phases are aggregated and the ITL gate must fail —
the committed anti-vacuity check.

Engines: the fake (``--kv-role producer/consumer`` simulation over the
real TPKV tier protocol — measures the router orchestration + transfer
data path with deterministic pacing) or real engines
(``--kv-transfer-config`` roles; ITL then includes real model compute).
"""

import asyncio
import dataclasses
import json
import random
import time
from typing import Dict, List, Optional

import aiohttp

from production_stack_tpu_torch.loadgen.orchestrator import (Proc, _stop,
                                                       free_port,
                                                       launch_cache_server,
                                                       launch_engine,
                                                       launch_router,
                                                       wait_cache_ready,
                                                       wait_healthy)
from production_stack_tpu_torch.loadgen.report import percentile
from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)

# real engines run under orchestrator.ENGINE_ARGS (--max-model-len
# 1024, char-level debug-tiny tokenizer): storm prompts above this are
# clamped so the advertised real-engine recipe can't 400 out of the box
REAL_ENGINE_PROMPT_CHARS = 700


def clamp_storm_for_real_engine(storm_kwargs: Dict) -> Dict:
    """launch_engine pins real engines to --max-model-len 1024 and the
    server 400-rejects prompts at or over it; debug-tiny tokenizes per
    char, so the fake-mode rag default (2400 chars) would error every
    rag request out of the gate. 700 leaves decode + chat-history
    headroom inside the window (the slow-test shape). Mutates and
    returns ``storm_kwargs``."""
    for key in ("chat_prompt_chars", "rag_prompt_chars"):
        if storm_kwargs[key] > REAL_ENGINE_PROMPT_CHARS:
            logger.warning(
                "disagg: clamping %s %d -> %d to fit the real-engine "
                "--max-model-len window", key, storm_kwargs[key],
                REAL_ENGINE_PROMPT_CHARS)
            storm_kwargs[key] = REAL_ENGINE_PROMPT_CHARS
    return storm_kwargs

CHAT_PATH = "/v1/chat/completions"

# real-engine geometry (debug-tiny character-level tokenizer: chars ~
# tokens; the orchestrator's 1024-token max-model-len bounds prompts)
REAL_KV_CHUNK_TOKENS = 32


@dataclasses.dataclass
class _ClassStats:
    """Aggregated outcomes for one traffic class in one phase."""

    launched: int = 0
    finished: int = 0
    errors: int = 0
    raw_5xx: int = 0
    transport_errors: int = 0
    error_samples: List[str] = dataclasses.field(default_factory=list)
    ttft_s: List[float] = dataclasses.field(default_factory=list)
    itl_s: List[float] = dataclasses.field(default_factory=list)

    def note_error(self, sample: str) -> None:
        self.errors += 1
        if len(self.error_samples) < 8:
            self.error_samples.append(sample)

    def summary(self) -> Dict:
        def pct(vals, p):
            return round(percentile(vals, p) * 1e3, 2) if vals else None
        return {
            "launched": self.launched,
            "finished": self.finished,
            "errors": self.errors,
            "raw_5xx": self.raw_5xx,
            "transport_errors": self.transport_errors,
            "error_samples": self.error_samples or None,
            "ttft_ms": {"p50": pct(self.ttft_s, 50),
                        "p99": pct(self.ttft_s, 99)},
            "itl_ms": {"p50": pct(self.itl_s, 50),
                       "p90": pct(self.itl_s, 90),
                       "p99": pct(self.itl_s, 99)},
        }


def _words(rng: random.Random, n_chars: int) -> str:
    out, size = [], 0
    while size < n_chars:
        w = "w%04x" % rng.randrange(1 << 16)
        out.append(w)
        size += len(w) + 1
    return " ".join(out)[:n_chars]


async def _storm(router_url: str, model: str, *, duration_s: float,
                 chat_users: int, rag_users: int, chat_prompt_chars: int,
                 chat_tokens: int, rag_prompt_chars: int, rag_tokens: int,
                 seed: int, request_timeout_s: float = 120.0
                 ) -> Dict[str, _ClassStats]:
    """Closed-loop mixed storm: ``chat_users`` + ``rag_users``
    concurrent users looping for ``duration_s``. Prompts are unique per
    request (prefixed from the FIRST chars) so neither phase gets
    cross-request prefix reuse — the A/B isolates the split itself, not
    caching luck."""
    stats = {"chat": _ClassStats(), "rag": _ClassStats()}
    timeout = aiohttp.ClientTimeout(total=request_timeout_s)
    end_at = time.monotonic() + duration_s

    async def one_request(http, cls: str, rng: random.Random,
                          uid: str) -> None:
        st = stats[cls]
        if cls == "chat":
            prompt = f"chat {uid} " + _words(rng, chat_prompt_chars)
            max_tokens = chat_tokens
        else:
            prompt = f"rag {uid} " + _words(rng, rag_prompt_chars)
            max_tokens = rag_tokens
        body = json.dumps({
            "model": model, "stream": True, "max_tokens": max_tokens,
            "messages": [{"role": "user", "content": prompt}]}).encode()
        st.launched += 1
        t0 = time.monotonic()
        first_at = last_at = None
        chunks = 0
        try:
            async with http.post(
                    f"{router_url}{CHAT_PATH}", data=body,
                    headers={"Content-Type": "application/json"},
                    timeout=timeout) as resp:
                if resp.status != 200:
                    if resp.status >= 500:
                        st.raw_5xx += 1
                    st.note_error(f"HTTP {resp.status}: "
                                  f"{(await resp.text())[:120]}")
                    return
                async for raw_line in resp.content:
                    line = raw_line.strip()
                    if not line.startswith(b"data:"):
                        continue
                    if line[5:].strip() == b"[DONE]":
                        continue
                    now = time.monotonic()
                    if first_at is None:
                        first_at = now
                    last_at = now
                    chunks += 1
        except (aiohttp.ClientError, ConnectionError, OSError,
                asyncio.TimeoutError) as e:
            st.transport_errors += 1
            st.note_error(f"{type(e).__name__}: {e}")
            return
        if first_at is None:
            st.note_error("stream produced no data frames")
            return
        st.finished += 1
        st.ttft_s.append(first_at - t0)
        if chunks > 1:
            st.itl_s.append((last_at - first_at) / (chunks - 1))

    async def user(cls: str, i: int) -> None:
        rng = random.Random(seed * 104729 + (0 if cls == "chat"
                                             else 1 << 20) + i)
        k = 0
        async with aiohttp.ClientSession(
                connector=aiohttp.TCPConnector(limit=0)) as http:
            while time.monotonic() < end_at:
                await one_request(http, cls, rng, f"{i}-{k}")
                k += 1

    await asyncio.gather(
        *[user("chat", i) for i in range(chat_users)],
        *[user("rag", i) for i in range(rag_users)])
    return stats


async def _scrape_json(url: str) -> Dict:
    try:
        async with aiohttp.ClientSession() as http:
            async with http.get(
                    url, timeout=aiohttp.ClientTimeout(total=5)) as r:
                return await r.json()
    except (aiohttp.ClientError, ConnectionError, OSError,
            asyncio.TimeoutError, ValueError):
        return {}


async def _kill_prefill_pod(procs: List[Proc], engine: str,
                            engine_args: List[str], *, at_s: float,
                            downtime_s: float, platform: str,
                            log_dir: str, record: Dict,
                            startup_timeout_s: float) -> None:
    """SIGKILL the first prefill pod mid-run, restart it on the same
    port after ``downtime_s`` (the chaos extension: a dead prefill pod
    must cost recompute, never a client-visible error)."""
    await asyncio.sleep(at_s)
    victim = procs[0]
    port = int(victim.url.rsplit(":", 1)[1])
    # reap and respawn off the event loop: the storm's inter-chunk
    # timestamps are being sampled on this loop, and a blocking wait()
    # or subprocess spawn would land its stall in the measured split
    # phase's ITL (the aggregated baseline never pays it)
    victim.popen.kill()
    await asyncio.to_thread(victim.popen.wait)
    record["kills"] += 1
    logger.info("disagg chaos: SIGKILLed prefill pod %s", victim.url)
    await asyncio.sleep(downtime_s)

    # the registration runs in the worker thread: a cancel that lands
    # while the spawn is in flight must not drop the Proc handle, or
    # the phase's cleanup never sees (and never stops) the new engine
    def _respawn() -> None:
        procs[0] = launch_engine(engine, port, log_dir=log_dir,
                                 platform=platform,
                                 extra_args=engine_args)

    spawn = asyncio.ensure_future(asyncio.to_thread(_respawn))
    try:
        await asyncio.shield(spawn)
    except asyncio.CancelledError:
        await spawn                  # join the thread; procs[0] is set
        raise
    try:
        await wait_healthy(procs[0].url, startup_timeout_s)
        record["restarts"] += 1
        logger.info("disagg chaos: prefill pod %s restarted",
                    procs[0].url)
    except TimeoutError:
        logger.warning("disagg chaos: prefill pod did not come back")


async def _run_phase(*, split: bool, prefill_engines: int,
                     decode_engines: int, engine: str, model: str,
                     tokens_per_s: float, prefill_ms_per_char: float,
                     interference: float, kv_chunk_chars: int,
                     headstart_s: float, min_prompt_chars: int,
                     routing: str, storm_kwargs: Dict,
                     prefill_kill: bool, kill_downtime_s: float,
                     duration_s: float, platform: str, log_dir: str,
                     startup_timeout_s: float) -> Dict:
    procs: List[Proc] = []
    prefill_procs: List[Proc] = []
    kill_task: Optional[asyncio.Task] = None
    total = prefill_engines + decode_engines
    fake = engine == "fake"
    prefill_args: List[str] = []
    try:
        cache_url = None
        if split:
            cache = launch_cache_server(free_port(), log_dir=log_dir)
            procs.append(cache)
            await wait_cache_ready(cache.url)
            cache_url = cache.url

        def fake_args(role: Optional[str]) -> List[str]:
            args = ["--num-tokens", str(max(
                        storm_kwargs["chat_tokens"],
                        storm_kwargs["rag_tokens"])),
                    "--tokens-per-s", str(tokens_per_s),
                    "--prefill-ms-per-char", str(prefill_ms_per_char),
                    "--prefill-decode-interference", str(interference)]
            if role is not None:
                args += ["--kv-role", role,
                         "--kv-remote-url", cache_url,
                         "--kv-chunk-chars", str(kv_chunk_chars)]
            return args

        def real_args(role: Optional[str]) -> List[str]:
            if role is None:
                return []
            return ["--kv-transfer-config",
                    json.dumps({"kv_role": role,
                                "chunk_size": REAL_KV_CHUNK_TOKENS,
                                "remote_url": cache_url})]

        mk_args = fake_args if fake else real_args
        if split:
            prefill_args = mk_args("kv_producer")
            prefill_procs = [launch_engine(engine, free_port(),
                                           log_dir=log_dir,
                                           platform=platform,
                                           extra_args=prefill_args)
                             for _ in range(prefill_engines)]
            decode_procs = [launch_engine(engine, free_port(),
                                          log_dir=log_dir,
                                          platform=platform,
                                          extra_args=mk_args(
                                              "kv_consumer"))
                            for _ in range(decode_engines)]
        else:
            prefill_procs = []
            decode_procs = [launch_engine(engine, free_port(),
                                          log_dir=log_dir,
                                          platform=platform,
                                          extra_args=mk_args(None))
                            for _ in range(total)]
        procs.extend(prefill_procs)
        procs.extend(decode_procs)
        await asyncio.gather(*[wait_healthy(e.url, startup_timeout_s)
                               for e in prefill_procs + decode_procs])

        router_extra = ["--engine-stats-interval", "2"]
        if split:
            router_extra += [
                "--prefill-backends",
                ",".join(e.url for e in prefill_procs),
                "--prefill-models",
                ",".join([model] * prefill_engines),
                "--prefill-headstart", str(headstart_s),
                "--disagg-min-prompt-chars", str(min_prompt_chars),
                "--prefill-breaker-cooldown", "2",
            ]
        router = launch_router([e.url for e in decode_procs], model,
                               free_port(), routing=routing,
                               log_dir=log_dir, extra_args=router_extra)
        procs.append(router)
        await wait_healthy(router.url, 60.0,
                           require_endpoints=len(decode_procs))

        chaos_record = {"kills": 0, "restarts": 0}
        if split and prefill_kill:
            kill_task = asyncio.ensure_future(_kill_prefill_pod(
                prefill_procs, engine, prefill_args,
                at_s=duration_s * 0.4, downtime_s=kill_downtime_s,
                platform=platform, log_dir=log_dir,
                record=chaos_record,
                startup_timeout_s=startup_timeout_s))

        t0 = time.monotonic()
        stats = await _storm(router.url, model,
                             duration_s=duration_s, **storm_kwargs)
        elapsed = time.monotonic() - t0
        # settle chaos before scraping: a respawn still in flight would
        # be scraped half-started (and the finally re-joins on the
        # failure path, where this line never ran)
        if kill_task is not None:
            kill_task.cancel()
            await asyncio.gather(kill_task, return_exceptions=True)

        engine_kv = {}
        for p in prefill_procs + decode_procs:
            data = await _scrape_json(f"{p.url}/load")
            kv = data.get("kv_cache") or {}
            engine_kv[p.url] = {
                "pool": "prefill" if p in prefill_procs else "decode",
                "role": kv.get("role"),
                "hit_tokens": kv.get("hit_tokens", 0),
                "query_tokens": kv.get("query_tokens", 0),
                "published_chunks": kv.get("published_chunks", 0),
                "progress_published_chunks": kv.get(
                    "progress_published_chunks", 0),
            }
        router_health = await _scrape_json(f"{router.url}/health")
    finally:
        # a failing storm must not leak the kill task: left pending it
        # would wake after its downtime sleep and respawn an engine
        # nobody stops
        if kill_task is not None:
            kill_task.cancel()
            await asyncio.gather(kill_task, return_exceptions=True)
        # a chaos restart replaced an entry in prefill_procs; the stale
        # handle in procs is already dead, the fresh one must die too
        seen = {id(p) for p in procs}
        _stop(procs + [p for p in prefill_procs
                       if id(p) not in seen])

    return {
        "split": split,
        "duration_s": round(elapsed, 1),
        "chat": stats["chat"].summary(),
        "rag": stats["rag"].summary(),
        "engine_kv": engine_kv,
        "prefill_pool": router_health.get("prefill_pool"),
        "chaos": chaos_record if split else None,
    }


async def run_disagg(*, prefill_engines: int = 2,
                     decode_engines: int = 2,
                     engine: str = "fake",
                     chat_users: int = 8, rag_users: int = 4,
                     duration_s: float = 30.0,
                     chat_prompt_chars: int = 96,
                     chat_tokens: int = 24,
                     rag_prompt_chars: int = 2400,
                     rag_tokens: int = 4,
                     tokens_per_s: float = 40.0,
                     prefill_ms_per_char: float = 0.4,
                     interference: float = 1.5,
                     kv_chunk_chars: int = 64,
                     headstart_s: float = 3.0,
                     min_prompt_chars: int = 512,
                     routing: str = "least_loaded",
                     seed: int = 0,
                     no_split: bool = False,
                     prefill_kill: bool = True,
                     kill_downtime_s: float = 3.0,
                     platform: str = "cuda",
                     log_dir: str = "loadgen-logs",
                     startup_timeout_s: float = 420.0) -> Dict:
    """Run the split phase (or a second aggregated phase with
    ``no_split`` — the anti-vacuity mode) plus the aggregated
    equal-hardware baseline; return the DISAGG record."""
    model = "fake-model" if engine == "fake" else engine
    storm_kwargs = dict(chat_users=chat_users, rag_users=rag_users,
                        chat_prompt_chars=chat_prompt_chars,
                        chat_tokens=chat_tokens,
                        rag_prompt_chars=rag_prompt_chars,
                        rag_tokens=rag_tokens, seed=seed)
    if engine != "fake":
        clamp_storm_for_real_engine(storm_kwargs)
    phase_kwargs = dict(prefill_engines=prefill_engines,
                        decode_engines=decode_engines, engine=engine,
                        model=model, tokens_per_s=tokens_per_s,
                        prefill_ms_per_char=prefill_ms_per_char,
                        interference=interference,
                        kv_chunk_chars=kv_chunk_chars,
                        headstart_s=headstart_s,
                        min_prompt_chars=min_prompt_chars,
                        routing=routing, storm_kwargs=storm_kwargs,
                        prefill_kill=prefill_kill,
                        kill_downtime_s=kill_downtime_s,
                        duration_s=duration_s, platform=platform,
                        log_dir=log_dir,
                        startup_timeout_s=startup_timeout_s)
    logger.info("disagg: %s phase — %d prefill + %d decode %s engines, "
                "%d chat + %d rag users, %.0fs",
                "aggregated (--no-split)" if no_split else "split",
                prefill_engines, decode_engines, engine, chat_users,
                rag_users, duration_s)
    main = await _run_phase(split=not no_split, **phase_kwargs)
    logger.info("disagg: measuring the aggregated equal-hardware "
                "baseline (%d engines, no pools)...",
                prefill_engines + decode_engines)
    baseline = await _run_phase(split=False, **{
        **phase_kwargs, "prefill_kill": False})

    main_itl = main["chat"]["itl_ms"]["p99"]
    base_itl = baseline["chat"]["itl_ms"]["p99"]
    improvement = None
    if main_itl and base_itl:
        improvement = round(100.0 * (1.0 - main_itl / base_itl), 1)
    return {
        "metric": "disaggregated prefill/decode: chat ITL p99 under a "
                  "mixed long-prefill/short-decode storm, split "
                  "topology vs aggregated serving at equal engine "
                  "count (prefill-pod SIGKILL mid-run)",
        "value": improvement,
        "unit": "% chat ITL p99 improvement",
        "platform": platform,
        "detail": {
            "engine": engine,
            "prefill_engines": prefill_engines,
            "decode_engines": decode_engines,
            "chat_users": chat_users, "rag_users": rag_users,
            "duration_s": duration_s,
            "chat_prompt_chars": chat_prompt_chars,
            "chat_tokens": chat_tokens,
            "rag_prompt_chars": rag_prompt_chars,
            "rag_tokens": rag_tokens,
            "tokens_per_s": tokens_per_s if engine == "fake" else None,
            "prefill_ms_per_char": prefill_ms_per_char
            if engine == "fake" else None,
            "interference": interference if engine == "fake" else None,
            "kv_chunk": kv_chunk_chars if engine == "fake"
            else REAL_KV_CHUNK_TOKENS,
            "headstart_s": headstart_s,
            "min_prompt_chars": min_prompt_chars,
            "routing": routing, "seed": seed, "no_split": no_split,
            "prefill_kill": prefill_kill and not no_split,
            "split_phase": main,
            "aggregated_baseline": baseline,
            "chat_itl_p99_ms": {"split": main_itl,
                                "aggregated": base_itl,
                                "improvement_pct": improvement},
        },
    }


def disagg_violations(record: Dict,
                      min_itl_improvement: Optional[float] = 0.1
                      ) -> List[str]:
    """The disagg pass/fail contract (CLI exits 1 on any violation).

    ``min_itl_improvement=None`` skips the ITL gate (errors, KV-flow
    evidence, and the kill contract still apply) — for configurations
    whose ITL is noise-dominated, e.g. real debug-tiny engines on CPU,
    where the committed fake-engine A/B holds the latency claim and
    the real-engine run proves the data path."""
    d = record["detail"]
    main, base = d["split_phase"], d["aggregated_baseline"]
    out: List[str] = []
    for phase_name, phase in (("split", main), ("aggregated", base)):
        for cls in ("chat", "rag"):
            c = phase[cls]
            if c["raw_5xx"]:
                out.append(f"{phase_name}/{cls}: {c['raw_5xx']} raw 5xx "
                           f"(first: {(c['error_samples'] or ['?'])[0]})")
            if c["errors"] - c["raw_5xx"]:
                out.append(
                    f"{phase_name}/{cls}: "
                    f"{c['errors'] - c['raw_5xx']} non-5xx errors "
                    f"(first: {(c['error_samples'] or ['?'])[0]})")
            if not c["finished"]:
                out.append(f"{phase_name}/{cls}: nothing finished")
    itl = d["chat_itl_p99_ms"]
    if min_itl_improvement is None:
        pass
    elif itl["split"] is None or itl["aggregated"] is None:
        out.append("chat ITL comparison missing (no multi-chunk "
                   "streams measured on one side)")
    elif itl["split"] > itl["aggregated"] * (1.0 - min_itl_improvement):
        out.append(
            f"chat ITL p99 did not improve by "
            f"{min_itl_improvement:.0%}: split {itl['split']:.1f}ms vs "
            f"aggregated {itl['aggregated']:.1f}ms "
            f"({(itl['improvement_pct'] or 0):.1f}%)")
    if not d["no_split"]:
        decode_hits = sum(kv.get("hit_tokens", 0)
                          for kv in main["engine_kv"].values()
                          if kv["pool"] == "decode")
        if not decode_hits:
            out.append("split decode pool consumed zero tier KV — the "
                       "prefill handoff never happened")
        progress = sum(kv.get("progress_published_chunks", 0)
                       for kv in main["engine_kv"].values()
                       if kv["pool"] == "prefill")
        if not progress:
            out.append("prefill pool published zero chunks mid-prefill "
                       "— progressive publish is not overlapping")
        if d.get("prefill_kill") and \
                (main.get("chaos") or {}).get("kills", 0) < 1:
            # a scheduled kill that never fired would leave the
            # degradation contract unmeasured
            out.append("prefill-pod kill never fired — the degradation "
                       "contract went unmeasured")
    return out
