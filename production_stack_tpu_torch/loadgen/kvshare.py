"""kvshare mode: cross-replica KV sharing, measured end to end.

The closed loop for BASELINE config 3. The orchestrator
launches a shared TPKV cache server, N engine replicas wired to it as
their remote KV tier, and the real router with session affinity
DELIBERATELY broken: every round carries a ROTATED ``x-user-id``
(``kvshare-<session>-r<round>``), so the session policy's consistent
hash scatters consecutive rounds of one conversation across replicas —
deterministically per run, immune to the accidental lockstep
stickiness a global roundrobin falls into when concurrent sessions
advance in phase. Any prefix reuse must therefore flow through the
shared tier, not replica-local state. A
multi-round-QA storm (sessions of R rounds, each round replaying the
full history plus the engine's actual previous answers) measures:

- **cross-replica hit rate**: aggregate tier hit tokens / query tokens
  scraped from every engine's ``/load`` ``kv_cache`` block, with the
  foreign share (hits on chunks the serving replica never published —
  produced elsewhere) reported alongside, and every replica required to
  show foreign hits;
- **TTFT vs recompute**: the identical storm is re-run against a fleet
  launched WITHOUT the cache (same pacing, full prefill); follow-up
  rounds (>= 2 — round 1 is definitionally cold) must get faster.

``kvshare_violations`` is the pass/fail contract the CLI enforces
(exit 1): errors, hit rate <= ``min_hit_rate`` (60% default), no
TTFT improvement, or a replica that never consumed a foreign chunk.
Run with ``--no-cache`` the same contract naturally fails — the
committed acceptance check that the rig cannot pass vacuously.

Engines: the fake (``--kv-remote-url`` simulation — measures the
router + cache-server + tier protocol data path with deterministic
prefill pacing) or real engines (``--kv-transfer-config`` with a
remote tier; TTFT then includes real prefill compute skipped by
injected KV chunks).
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

CHAT_PATH = "/v1/chat/completions"

# real-engine geometry: debug-tiny's character-level tokenizer means
# chars ~ tokens, and the orchestrator's 1024-token max-model-len caps
# the final round's history
REAL_KV_CHUNK_TOKENS = 32


@dataclasses.dataclass
class _SessionResult:
    ttft_by_round: List[List[float]]      # [round][samples] seconds
    errors: int = 0
    error_samples: Optional[List[str]] = None


def _words(rng: random.Random, n_chars: int) -> str:
    out = []
    size = 0
    while size < n_chars:
        w = "w%04x" % rng.randrange(1 << 16)
        out.append(w)
        size += len(w) + 1
    return " ".join(out)[:n_chars]


async def _run_sessions(router_url: str, model: str, *, sessions: int,
                        rounds: int, system_chars: int, round_chars: int,
                        num_tokens: int, seed: int,
                        request_timeout_s: float = 60.0) -> _SessionResult:
    """Concurrent multi-round QA sessions through the router. Every
    round replays the full history INCLUDING the engine's actual
    previous replies (streamed deltas reassembled), so the prompts the
    engines see chain exactly like production multi-round traffic."""
    res = _SessionResult(ttft_by_round=[[] for _ in range(rounds)],
                         errors=0, error_samples=[])
    timeout = aiohttp.ClientTimeout(total=request_timeout_s)

    async def one_session(i: int) -> None:
        rng = random.Random(seed * 7919 + i)
        messages = [{"role": "system",
                     "content": f"session-{i} " + _words(rng,
                                                         system_chars)}]
        async with aiohttp.ClientSession(
                connector=aiohttp.TCPConnector(limit=0)) as http:
            for r in range(rounds):
                messages.append({"role": "user",
                                 "content": f"round-{r} " +
                                            _words(rng, round_chars)})
                body = json.dumps({"model": model, "messages": messages,
                                   "max_tokens": num_tokens,
                                   "stream": True}).encode()
                t0 = time.monotonic()
                first_at = None
                reply_parts: List[str] = []
                # the affinity break: the session key ROTATES every
                # round, so the session policy's consistent hash sends
                # consecutive rounds of one conversation to
                # (pseudo-randomly) different replicas — deterministic
                # per run, immune to the accidental lockstep stickiness
                # a global roundrobin can fall into when concurrent
                # sessions advance in phase
                headers = {"Content-Type": "application/json",
                           "x-user-id": f"kvshare-{i}-r{r}"}
                try:
                    async with http.post(
                            f"{router_url}{CHAT_PATH}", data=body,
                            headers=headers,
                            timeout=timeout) as resp:
                        if resp.status != 200:
                            res.errors += 1
                            if len(res.error_samples) < 8:
                                res.error_samples.append(
                                    f"HTTP {resp.status}: "
                                    f"{(await resp.text())[:120]}")
                            return
                        async for raw_line in resp.content:
                            line = raw_line.strip()
                            if not line.startswith(b"data:"):
                                continue
                            if first_at is None:
                                first_at = time.monotonic()
                            payload = line[5:].strip()
                            if payload == b"[DONE]":
                                continue
                            try:
                                delta = json.loads(payload)["choices"][0][
                                    "delta"]
                                reply_parts.append(
                                    delta.get("content") or "")
                            except (ValueError, KeyError, IndexError):
                                pass
                except (aiohttp.ClientError, ConnectionError, OSError,
                        asyncio.TimeoutError) as e:
                    res.errors += 1
                    if len(res.error_samples) < 8:
                        res.error_samples.append(
                            f"{type(e).__name__}: {e}")
                    return
                if first_at is None:
                    res.errors += 1
                    return
                res.ttft_by_round[r].append(first_at - t0)
                # the engine's EXACT reply rides into the next round's
                # history (stripped: streamed deltas carry a trailing
                # pad the non-streamed rendering does not)
                messages.append({"role": "assistant",
                                 "content": "".join(reply_parts).strip()})

    await asyncio.gather(*[one_session(i) for i in range(sessions)])
    return res


async def _scrape_kv(engine_urls: List[str]) -> Dict[str, Dict]:
    """Each engine's /load kv_cache block (empty dict when absent)."""
    out: Dict[str, Dict] = {}
    async with aiohttp.ClientSession() as http:
        for url in engine_urls:
            try:
                async with http.get(
                        f"{url}/load",
                        timeout=aiohttp.ClientTimeout(total=5)) as r:
                    data = await r.json()
                    out[url] = data.get("kv_cache") or {}
            except (aiohttp.ClientError, ConnectionError, OSError,
                    asyncio.TimeoutError, ValueError):
                out[url] = {}
    return out


async def _run_phase(*, cached: bool, engines: int, engine: str,
                     sessions: int, rounds: int, system_chars: int,
                     round_chars: int, num_tokens: int,
                     prefill_ms_per_char: float, kv_chunk_chars: int,
                     routing: str, seed: int, platform: str,
                     log_dir: str, startup_timeout_s: float,
                     kv_codec: Optional[str] = None) -> Dict:
    """``kv_codec`` (fake engines only) publishes deterministic
    pseudo-KV chunk bodies through the named REAL tier codec
    (kvcache/codec.py) instead of text bytes — the kvmigrate codec
    phase's lever for measuring tier-capacity ratios against the cache
    server's physical footprint."""
    procs: List[Proc] = []
    try:
        cache_url = None
        if cached:
            cache = launch_cache_server(free_port(), log_dir=log_dir)
            procs.append(cache)
            await wait_cache_ready(cache.url)
            cache_url = cache.url
        if engine == "fake":
            extra = ["--num-tokens", str(num_tokens),
                     "--tokens-per-s", "0",
                     "--prefill-ms-per-char", str(prefill_ms_per_char)]
            if cached:
                extra += ["--kv-remote-url", cache_url,
                          "--kv-chunk-chars", str(kv_chunk_chars)]
                if kv_codec:
                    extra += ["--kv-codec", kv_codec]
        else:
            extra = []
            if cached:
                extra = ["--kv-transfer-config",
                         json.dumps({"kv_role": "kv_both",
                                     "chunk_size": REAL_KV_CHUNK_TOKENS,
                                     "remote_url": cache_url})]
        engine_procs = [launch_engine(engine, free_port(),
                                      log_dir=log_dir, platform=platform,
                                      extra_args=extra)
                        for _ in range(engines)]
        procs.extend(engine_procs)
        await asyncio.gather(*[wait_healthy(e.url, startup_timeout_s)
                               for e in engine_procs])
        model = "fake-model" if engine == "fake" else engine
        router = launch_router([e.url for e in engine_procs], model,
                               free_port(), routing=routing,
                               log_dir=log_dir,
                               extra_args=["--engine-stats-interval", "2"])
        procs.append(router)
        await wait_healthy(router.url, 60.0, require_endpoints=engines)

        if engine != "fake":
            # real engines compile a new executable the first time a
            # round's prompt length crosses a prefill/kv bucket — a
            # 20 s compile inside a measured TTFT would swamp the
            # prefill savings in noise. Drive one full throwaway
            # session DIRECTLY at each engine (disjoint seed, so its
            # content never collides with measured sessions) to
            # compile every shape the storm will use.
            for idx, e in enumerate(engine_procs):
                warm = await _run_sessions(
                    e.url, model, sessions=1, rounds=rounds,
                    system_chars=system_chars, round_chars=round_chars,
                    num_tokens=num_tokens,
                    seed=seed + 100003 + idx,
                    request_timeout_s=300.0)
                if warm.errors:
                    logger.warning("kvshare warmup against %s: %d "
                                   "errors — TTFTs may include "
                                   "compiles", e.url, warm.errors)
        # counters are DELTA-scraped around the measured storm so
        # warmup traffic never dilutes the hit rate
        kv_before = await _scrape_kv([e.url for e in engine_procs])

        t0 = time.monotonic()
        res = await _run_sessions(router.url, model, sessions=sessions,
                                  rounds=rounds,
                                  system_chars=system_chars,
                                  round_chars=round_chars,
                                  num_tokens=num_tokens, seed=seed)
        elapsed = time.monotonic() - t0
        kv_after = await _scrape_kv([e.url for e in engine_procs])
        cache_stats = None
        if cached:
            # physical footprint on the shared tier (the denominator
            # of the codec capacity ratio): the cache server's STATS
            # op counts stored — i.e. ENCODED — bytes
            def _cache_stats():
                from production_stack_tpu_torch.kvcache.store import \
                    RemoteStore
                store = RemoteStore(cache_url, connect_timeout=2.0,
                                    io_timeout=5.0)
                try:
                    return store.stats()
                finally:
                    store.close()
            try:
                cache_stats = await asyncio.to_thread(_cache_stats)
            except (OSError, ConnectionError):
                cache_stats = None
        kv = {
            url: {key: stats.get(key, 0)
                  - kv_before.get(url, {}).get(key, 0)
                  for key in ("queries", "query_tokens", "hit_tokens",
                              "foreign_hit_tokens", "bytes_loaded",
                              "bytes_saved")}
            if stats else {}
            for url, stats in kv_after.items()
        }
    finally:
        _stop(procs)

    def stat(vals: List[float]) -> Optional[Dict]:
        if not vals:
            return None
        return {"mean": round(sum(vals) / len(vals) * 1e3, 1),
                "p50": round(percentile(vals, 50) * 1e3, 1),
                "p90": round(percentile(vals, 90) * 1e3, 1)}

    followup = [t for r in res.ttft_by_round[1:] for t in r]
    total_q = sum(e.get("query_tokens", 0) for e in kv.values())
    total_h = sum(e.get("hit_tokens", 0) for e in kv.values())
    total_f = sum(e.get("foreign_hit_tokens", 0) for e in kv.values())
    return {
        "cached": cached,
        "duration_s": round(elapsed, 1),
        "errors": res.errors,
        "error_samples": res.error_samples,
        "completed_rounds": sum(len(r) for r in res.ttft_by_round),
        "ttft_ms_by_round": [stat(r) for r in res.ttft_by_round],
        "ttft_followup": stat(followup),
        "hit_rate": round(total_h / total_q, 4) if total_q else 0.0,
        "foreign_share": round(total_f / total_h, 4) if total_h else 0.0,
        "query_tokens": total_q,
        "hit_tokens": total_h,
        "foreign_hit_tokens": total_f,
        "bytes_saved": sum(e.get("bytes_saved", 0) for e in kv.values()),
        "per_engine_kv": kv,
        "cache_server": cache_stats,
    }


async def run_kvshare(*, engines: int = 2,
                      engine: str = "fake",
                      sessions: int = 4,
                      rounds: int = 6,
                      system_chars: int = 384,
                      round_chars: int = 160,
                      num_tokens: int = 8,
                      prefill_ms_per_char: float = 0.5,
                      kv_chunk_chars: int = 64,
                      routing: str = "session",
                      seed: int = 0,
                      no_cache: bool = False,
                      platform: str = "cuda",
                      log_dir: str = "loadgen-logs",
                      startup_timeout_s: float = 420.0) -> Dict:
    """Run the cached phase (or the bare fleet with ``no_cache``) plus
    the recompute comparison baseline; return the KVSHARE record."""
    kwargs = dict(engines=engines, engine=engine, sessions=sessions,
                  rounds=rounds, system_chars=system_chars,
                  round_chars=round_chars, num_tokens=num_tokens,
                  prefill_ms_per_char=prefill_ms_per_char,
                  kv_chunk_chars=kv_chunk_chars, routing=routing,
                  seed=seed, platform=platform, log_dir=log_dir,
                  startup_timeout_s=startup_timeout_s)
    logger.info("kvshare: %d %s engines via %s routing (affinity "
                "broken), %d sessions x %d rounds%s", engines, engine,
                routing, sessions, rounds,
                " [NO CACHE]" if no_cache else "")
    main = await _run_phase(cached=not no_cache, **kwargs)
    baseline = None
    if not no_cache:
        logger.info("kvshare: measuring the recompute baseline "
                    "(same fleet, no KV tiers)...")
        baseline = await _run_phase(cached=False, **kwargs)

    main_ttft = (main.get("ttft_followup") or {}).get("mean")
    base_ttft = (baseline.get("ttft_followup") or {}).get("mean") \
        if baseline else None
    improvement = None
    if main_ttft and base_ttft:
        improvement = round(100.0 * (1.0 - main_ttft / base_ttft), 1)
    return {
        "metric": "cross-replica KV sharing: tier hit rate and "
                  "follow-up-round TTFT with session affinity broken "
                  "(multi-round QA, session key rotated every round; "
                  "shared TPKV cache server as the cross-replica "
                  "rendezvous)",
        "value": round(100.0 * main["hit_rate"], 1),
        "unit": "% hit rate",
        "platform": platform,
        "detail": {
            "engine": engine, "engines": engines, "routing": routing,
            "sessions": sessions, "rounds": rounds,
            "system_chars": system_chars, "round_chars": round_chars,
            "num_tokens": num_tokens,
            "prefill_ms_per_char": prefill_ms_per_char
            if engine == "fake" else None,
            "kv_chunk": kv_chunk_chars if engine == "fake"
            else REAL_KV_CHUNK_TOKENS,
            "no_cache": no_cache,
            "seed": seed,
            "cached": main,
            "recompute_baseline": baseline,
            "ttft_followup_mean_ms": {
                "cached": main_ttft, "recompute": base_ttft,
                "improvement_pct": improvement},
        },
    }


def kvshare_violations(record: Dict,
                       min_hit_rate: float = 0.6) -> List[str]:
    """The kvshare pass/fail contract (CLI exits 1 on any violation)."""
    d = record["detail"]
    main = d["cached"]
    out: List[str] = []
    if main["errors"]:
        out.append(f"{main['errors']} client-visible errors in the "
                   f"measured storm")
    base = d.get("recompute_baseline")
    if base and base["errors"]:
        out.append(f"{base['errors']} errors in the recompute baseline")
    expected = d["sessions"] * d["rounds"]
    if main["completed_rounds"] < expected:
        out.append(f"only {main['completed_rounds']}/{expected} rounds "
                   f"completed")
    if main["hit_rate"] <= min_hit_rate:
        out.append(f"cross-replica hit rate {main['hit_rate']:.1%} <= "
                   f"the {min_hit_rate:.0%} bar (affinity broken: reuse "
                   f"must flow through the shared tier)")
    if d["engines"] > 1 and not d["no_cache"]:
        cold = [url for url, kv in main["per_engine_kv"].items()
                if not kv.get("foreign_hit_tokens")]
        if cold:
            out.append(f"{len(cold)} replica(s) never consumed a "
                       f"foreign chunk ({', '.join(cold)}) — sharing is "
                       f"not cross-replica")
    ttft = d["ttft_followup_mean_ms"]
    if ttft["cached"] is None or ttft["recompute"] is None:
        out.append("TTFT comparison missing (no follow-up rounds "
                   "measured on one side)")
    elif ttft["cached"] >= ttft["recompute"]:
        out.append(f"follow-up TTFT did not improve: cached "
                   f"{ttft['cached']:.1f}ms >= recompute "
                   f"{ttft['recompute']:.1f}ms")
    return out
