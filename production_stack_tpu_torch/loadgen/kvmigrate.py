"""kvmigrate mode: the kvplane closed loop — migration storm + codecs.

Two experiments, one record (``KVMIGRATE_*.json``), one pass/fail
contract (``kvmigrate_violations`` -> CLI exit 1):

**Fragmentation storm.** Two fake engines behind
the real router (roundrobin — every replica keeps taking traffic), one
injected into the fragmented admission-failure regime via ``POST
/fault {"kv_pool": ...}`` (free capacity exists fleet-wide, but replica
A's pool cannot seat a request). A request storm runs twice:

- **migration ON**: the real kvplane planner process polls the census,
  sees A's ``alloc_failures_fragmented`` rising, and executes the
  migrate_out -> warm -> rehome hand-off. Gate: A's fragmented-failure
  RATE in the second half of the storm collapses to ~0 (the planner
  needs one failure delta to trigger, so the first half is allowed to
  hurt), while the fleet's aggregate block count stays constant —
  migration moves memory pressure, it must not mint capacity.
- **migration OFF** (anti-vacuity): the identical storm with no
  planner must KEEP failing — if the OFF phase passes the ON gate, the
  rig is measuring nothing and the record is rejected.

Failures are measured at the ENGINE (census counter deltas), not the
client: the router may retry a refused admission elsewhere, which is
good for users and useless for measuring pool health.

**Codec capacity.** The r11 kvshare storm re-run
twice with fake engines publishing deterministic pseudo-KV through the
REAL tier codecs (``--kv-codec raw`` vs ``int4``, kvcache/codec.py).
Gates: the int4 phase's logical-bytes / cache-server-physical-bytes
ratio >= 2.0 (>= 2x tier capacity at equal logical bytes), the raw
phase's ratio stays ~1 (sanity: the accounting is honest), hit TTFT
within tolerance of raw, and the kvshare hit-rate floor still holds.

Engines: fake only — the storm drives the injected census model
(engine-free tier-1), the codec phase drives REAL codec encode/decode
against a REAL cache server.
"""

import asyncio
import json
import time
from typing import Dict, List, Optional

import aiohttp

from production_stack_tpu_torch.loadgen import kvshare
from production_stack_tpu_torch.loadgen.orchestrator import (Proc, _stop,
                                                       free_port,
                                                       launch_engine,
                                                       launch_kvplane,
                                                       launch_router,
                                                       wait_healthy)
from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)

CHAT_PATH = "/v1/chat/completions"

# injected census: A is fragmented (free capacity exists — 4 blocks —
# but below the 16-block request demand), B holds the fleet's headroom
FRAGMENTED_POOL = {"num_blocks": 256, "free": 4, "active": 252,
                   "cached": 0, "blocks_per_request": 16,
                   "free_contiguity": 0.08}
HEALTHY_POOL = {"num_blocks": 256, "free": 224, "active": 32,
                "cached": 0, "blocks_per_request": 16,
                "free_contiguity": 0.9}


async def _post_json(http: aiohttp.ClientSession, url: str,
                     body: dict, timeout_s: float = 10.0) -> dict:
    async with http.post(url, json=body,
                         timeout=aiohttp.ClientTimeout(
                             total=timeout_s)) as resp:
        return await resp.json()


async def _census(http: aiohttp.ClientSession, url: str) -> Dict:
    async with http.get(f"{url}/load",
                        timeout=aiohttp.ClientTimeout(total=5)) as r:
        return (await r.json()).get("kv_pool") or {}


async def _storm(router_url: str, *, duration_s: float, workers: int,
                 model: str = "fake-model") -> Dict:
    """Closed-loop chat storm through the router; counts client-side
    outcomes (engine-side truth comes from the census deltas)."""
    stop_at = time.monotonic() + duration_s
    counts = {"requests": 0, "ok": 0, "rejected_503": 0, "errors": 0}

    async def worker(i: int) -> None:
        async with aiohttp.ClientSession(
                connector=aiohttp.TCPConnector(limit=0)) as http:
            r = 0
            while time.monotonic() < stop_at:
                r += 1
                body = {"model": model,
                        "messages": [{"role": "user",
                                      "content": f"storm-{i}-{r}"}],
                        "max_tokens": 4}
                counts["requests"] += 1
                try:
                    async with http.post(
                            f"{router_url}{CHAT_PATH}", json=body,
                            timeout=aiohttp.ClientTimeout(
                                total=10)) as resp:
                        await resp.read()
                        if resp.status == 200:
                            counts["ok"] += 1
                        elif resp.status == 503:
                            counts["rejected_503"] += 1
                        else:
                            counts["errors"] += 1
                except (aiohttp.ClientError, ConnectionError, OSError,
                        asyncio.TimeoutError):
                    counts["errors"] += 1
                await asyncio.sleep(0.02)

    await asyncio.gather(*[worker(i) for i in range(workers)])
    return counts


async def _run_storm_phase(*, migration: bool, duration_s: float,
                           workers: int, poll_interval_s: float,
                           log_dir: str, routing: str = "roundrobin",
                           startup_timeout_s: float = 60.0) -> Dict:
    """One storm phase: fragmented A + healthy B behind the router,
    with (ON) or without (OFF) the kvplane planner process."""
    procs: List[Proc] = []
    tag = "on" if migration else "off"
    try:
        extra = ["--num-tokens", "4", "--tokens-per-s", "0"]
        eng_a = launch_engine("fake", free_port(),
                              log_dir=f"{log_dir}/{tag}",
                              extra_args=extra)
        eng_b = launch_engine("fake", free_port(),
                              log_dir=f"{log_dir}/{tag}",
                              extra_args=extra)
        procs += [eng_a, eng_b]
        await asyncio.gather(wait_healthy(eng_a.url, startup_timeout_s),
                             wait_healthy(eng_b.url, startup_timeout_s))
        router = launch_router([eng_a.url, eng_b.url], "fake-model",
                               free_port(), routing=routing,
                               log_dir=f"{log_dir}/{tag}",
                               extra_args=["--engine-stats-interval",
                                           "1"])
        procs.append(router)
        await wait_healthy(router.url, 60.0, require_endpoints=2)

        async with aiohttp.ClientSession() as http:
            await _post_json(http, f"{eng_a.url}/fault",
                             {"kv_pool": dict(FRAGMENTED_POOL)})
            await _post_json(http, f"{eng_b.url}/fault",
                             {"kv_pool": dict(HEALTHY_POOL)})

            planner_status = None
            if migration:
                planner = launch_kvplane(
                    [eng_a.url, eng_b.url], free_port(),
                    log_dir=f"{log_dir}/{tag}", router_url=router.url,
                    extra_args=["--poll-interval",
                                str(poll_interval_s),
                                "--move-cooldown", "1.0"])
                procs.append(planner)
                await wait_healthy(planner.url, 30.0)

            census_before = {"a": await _census(http, eng_a.url),
                             "b": await _census(http, eng_b.url)}
            half = duration_s / 2.0
            first = await _storm(router.url, duration_s=half,
                                 workers=workers)
            census_mid = {"a": await _census(http, eng_a.url),
                          "b": await _census(http, eng_b.url)}
            second = await _storm(router.url, duration_s=half,
                                  workers=workers)
            census_after = {"a": await _census(http, eng_a.url),
                            "b": await _census(http, eng_b.url)}
            if migration:
                async with http.get(
                        f"{planner.url}/status",
                        timeout=aiohttp.ClientTimeout(total=5)) as r:
                    planner_status = await r.json()
    finally:
        _stop(procs)

    def frag(census: Dict) -> int:
        return sum(c.get("alloc_failures_fragmented", 0)
                   for c in census.values())

    def allocs(census: Dict) -> int:
        return sum(c.get("allocs", 0) for c in census.values())

    halves = []
    for before, after, storm in ((census_before, census_mid, first),
                                 (census_mid, census_after, second)):
        d_frag = frag(after) - frag(before)
        d_allocs = allocs(after) - allocs(before)
        halves.append({
            "alloc_attempts": d_allocs,
            "fragmented_failures": d_frag,
            "failure_rate": round(d_frag / d_allocs, 4)
            if d_allocs else 0.0,
            "client": storm,
        })
    return {
        "migration": migration,
        "halves": halves,
        "census_before": census_before,
        "census_after": census_after,
        "aggregate_blocks_before": sum(
            c.get("num_blocks", 0) for c in census_before.values()),
        "aggregate_blocks_after": sum(
            c.get("num_blocks", 0) for c in census_after.values()),
        "planner": {k: planner_status.get(k) for k in
                    ("moves", "moved_blocks", "warmed_chunks",
                     "decisions", "move_errors", "recent_moves")}
        if planner_status else None,
    }


async def run_kvmigrate(*, storm_duration_s: float = 8.0,
                        storm_workers: int = 4,
                        poll_interval_s: float = 0.3,
                        codec: str = "int4",
                        sessions: int = 4,
                        rounds: int = 6,
                        seed: int = 0,
                        platform: str = "cuda",
                        log_dir: str = "loadgen-logs/kvmigrate",
                        startup_timeout_s: float = 60.0) -> Dict:
    """Run storm ON, storm OFF, and the raw-vs-codec kvshare re-run;
    return the KVMIGRATE record."""
    logger.info("kvmigrate: fragmentation storm with migration ON "
                "(%.0fs, %d workers)...", storm_duration_s,
                storm_workers)
    storm_on = await _run_storm_phase(
        migration=True, duration_s=storm_duration_s,
        workers=storm_workers, poll_interval_s=poll_interval_s,
        log_dir=log_dir, startup_timeout_s=startup_timeout_s)
    logger.info("kvmigrate: anti-vacuity storm with migration OFF...")
    storm_off = await _run_storm_phase(
        migration=False, duration_s=storm_duration_s,
        workers=storm_workers, poll_interval_s=poll_interval_s,
        log_dir=log_dir, startup_timeout_s=startup_timeout_s)

    kv_chunk_chars = 64
    kv_bytes_per_char = 256  # fake_engine --kv-bytes-per-char default
    share_kwargs = dict(engines=2, engine="fake", sessions=sessions,
                        rounds=rounds, system_chars=384,
                        round_chars=160, num_tokens=8,
                        prefill_ms_per_char=0.5,
                        kv_chunk_chars=kv_chunk_chars,
                        routing="session", seed=seed,
                        platform=platform,
                        startup_timeout_s=startup_timeout_s)
    logger.info("kvmigrate: codec phase — raw tier baseline...")
    phase_raw = await kvshare._run_phase(
        cached=True, kv_codec="raw",
        log_dir=f"{log_dir}/codec-raw", **share_kwargs)
    logger.info("kvmigrate: codec phase — %s tier...", codec)
    phase_codec = await kvshare._run_phase(
        cached=True, kv_codec=codec,
        log_dir=f"{log_dir}/codec-{codec}", **share_kwargs)

    # capacity ratio = logical KV bytes resident / physical cache
    # bytes. Logical comes from the cache server's CHUNK COUNT times
    # the per-chunk logical size (each resident chunk stands in for
    # kv_chunk_chars * kv_bytes_per_char of bf16-equivalent KV) —
    # counting resident chunks, not publish traffic, so a digest both
    # replicas raced to publish is never double-counted.
    chunk_logical_bytes = kv_chunk_chars * kv_bytes_per_char

    def capacity_ratio(phase: Dict) -> Optional[float]:
        stats = phase.get("cache_server") or {}
        physical = stats.get("bytes")
        count = stats.get("count")
        if not physical or not count:
            return None
        return round(count * chunk_logical_bytes / physical, 3)

    on_half2 = storm_on["halves"][1]
    off_half2 = storm_off["halves"][1]
    record = {
        "metric": "kvplane migration storm: fragmented-admission "
                  "failure rate (second half, migration ON vs OFF) + "
                  "compressed-tier capacity ratio vs raw at equal "
                  "logical bytes",
        "value": round(100.0 * on_half2["failure_rate"], 2),
        "unit": "% fragmented-failure rate (migration ON, 2nd half)",
        "platform": platform,
        "detail": {
            "storm": {
                "duration_s": storm_duration_s,
                "workers": storm_workers,
                "poll_interval_s": poll_interval_s,
                "pools": {"fragmented": FRAGMENTED_POOL,
                          "healthy": HEALTHY_POOL},
                "on": storm_on,
                "off": storm_off,
            },
            "codec": {
                "name": codec,
                "sessions": sessions, "rounds": rounds, "seed": seed,
                "chunk_logical_bytes": chunk_logical_bytes,
                "raw": phase_raw,
                "compressed": phase_codec,
                "capacity_ratio": {
                    "raw": capacity_ratio(phase_raw),
                    codec: capacity_ratio(phase_codec)},
                # the gate compares MEDIANS: the per-round TTFT tail
                # is scheduling/transfer noise on a single host, and a
                # couple of outlier rounds should not fail a codec
                # whose typical hit is byte-for-byte as fast
                "ttft_followup_p50_ms": {
                    "raw": (phase_raw.get("ttft_followup")
                            or {}).get("p50"),
                    codec: (phase_codec.get("ttft_followup")
                            or {}).get("p50")},
                "ttft_followup_mean_ms": {
                    "raw": (phase_raw.get("ttft_followup")
                            or {}).get("mean"),
                    codec: (phase_codec.get("ttft_followup")
                            or {}).get("mean")},
            },
        },
    }
    logger.info(
        "kvmigrate: ON 2nd-half failure rate %.1f%% (OFF %.1f%%), "
        "capacity ratio raw %s vs %s %s",
        100 * on_half2["failure_rate"],
        100 * off_half2["failure_rate"],
        record["detail"]["codec"]["capacity_ratio"]["raw"],
        codec, record["detail"]["codec"]["capacity_ratio"][codec])
    return record


def kvmigrate_violations(record: Dict,
                         max_on_failure_rate: float = 0.02,
                         min_off_failure_rate: float = 0.2,
                         min_capacity_ratio: float = 2.0,
                         ttft_tolerance: float = 0.25,
                         min_hit_rate: float = 0.6) -> List[str]:
    """The kvmigrate pass/fail contract (CLI exits 1 on any
    violation)."""
    out: List[str] = []
    d = record["detail"]
    storm = d["storm"]
    on, off = storm["on"], storm["off"]

    on2 = on["halves"][1]
    if not on2["alloc_attempts"]:
        out.append("migration-ON second half saw no allocation "
                   "attempts — the storm never exercised the pool")
    elif on2["failure_rate"] > max_on_failure_rate:
        out.append(
            f"migration ON did not erase the fragmented regime: "
            f"second-half failure rate {on2['failure_rate']:.1%} > "
            f"{max_on_failure_rate:.0%} "
            f"({on2['fragmented_failures']}/{on2['alloc_attempts']})")
    planner = on.get("planner") or {}
    if not planner.get("moves"):
        out.append("planner executed no migrations in the ON phase — "
                   "any recovery did not come from kvplane")
    if planner.get("move_errors"):
        out.append(f"{planner['move_errors']} planner move errors in "
                   f"the ON phase")

    off2 = off["halves"][1]
    if off2["failure_rate"] < min_off_failure_rate:
        out.append(
            f"anti-vacuity breach: with migration OFF the second-half "
            f"failure rate was {off2['failure_rate']:.1%} < "
            f"{min_off_failure_rate:.0%} — the storm does not actually "
            f"depend on migration")

    for phase in (on, off):
        if phase["aggregate_blocks_before"] != \
                phase["aggregate_blocks_after"]:
            out.append(
                f"aggregate HBM changed during the "
                f"{'ON' if phase['migration'] else 'OFF'} storm: "
                f"{phase['aggregate_blocks_before']} -> "
                f"{phase['aggregate_blocks_after']} blocks — "
                f"migration must move capacity, not mint it")
        for half in phase["halves"]:
            if half["client"]["errors"]:
                out.append(f"{half['client']['errors']} non-503 client "
                           f"errors in a storm half")

    codec = d["codec"]
    name = codec["name"]
    for phase_name in ("raw", "compressed"):
        if codec[phase_name]["errors"]:
            out.append(f"{codec[phase_name]['errors']} errors in the "
                       f"codec {phase_name} phase")
    ratios = codec["capacity_ratio"]
    if ratios.get(name) is None:
        out.append("compressed-phase capacity ratio unmeasured (cache "
                   "server stats or bytes_saved missing)")
    elif ratios[name] < min_capacity_ratio:
        out.append(f"codec {name} capacity ratio "
                   f"{ratios[name]:.2f}x < {min_capacity_ratio:.1f}x")
    if ratios.get("raw") is not None and \
            not (0.85 <= ratios["raw"] <= 1.10):
        out.append(f"raw capacity ratio {ratios['raw']:.2f}x outside "
                   f"[0.85, 1.10] — the logical/physical accounting "
                   f"is off, the codec gate is not trustworthy")
    ttft = codec["ttft_followup_p50_ms"]
    if ttft.get("raw") is None or ttft.get(name) is None:
        out.append("codec TTFT comparison missing a side")
    elif ttft[name] > ttft["raw"] * (1.0 + ttft_tolerance):
        out.append(f"compressed-tier hit TTFT p50 {ttft[name]:.1f}ms "
                   f"exceeds raw {ttft['raw']:.1f}ms by more than "
                   f"{ttft_tolerance:.0%}")
    if codec["compressed"]["hit_rate"] <= min_hit_rate:
        out.append(f"codec-phase hit rate "
                   f"{codec['compressed']['hit_rate']:.1%} <= "
                   f"{min_hit_rate:.0%} — quantized chunks are not "
                   f"being consumed")
    return out
