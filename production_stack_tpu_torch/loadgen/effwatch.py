"""Effwatch: storm an engine and audit its efficiency accounting.

The closed loop for the engine-efficiency telemetry layer
(engine/efficiency.py): the roofline push is about to
make optimization decisions off the real/pad/dead token-step split, the
MBU gauge, and the compile counters — so those numbers must first be
proven to reconcile with ground truth an independent observer can
measure. The rig launches ONE engine (a real ``debug-tiny`` process or
a fake), drives a warmup storm (so every executable the steady shape
needs is compiled), scrapes the ``/load`` ``perf`` block immediately
around a steady measured storm, and gates on:

- **sum-to-1**: the real+pad+dead token-step deltas must equal the
  separately accumulated ``token_steps_total`` delta within
  ``--sum-tolerance`` (default 2%). For the real engine this is a
  *plumbing* check spanning every adder, the ``/load``
  serialization, and the scrape-delta math (the engine derives dead
  by subtraction, so it cannot catch a misclassification by itself —
  that is the reconciliation gate's job); the fake's ``--fake-skew``
  knob proves the gate can fail;
- **reconciliation**: accounted decode tokens/s (the ``real`` delta
  over the scrape window) must match CLIENT-measured completion
  tokens/s within ``--rate-tolerance`` (default 10%). The client
  counts what it actually received (the stream's ``include_usage``
  tail, content chunks as fallback), minus one token per request —
  the first output token comes from the prefill dispatch, which the
  decode accounting correctly excludes;
- **steady-window compile silence**: zero XLA compile events may land
  between the two scrapes — post-warmup steady serving that still
  compiles means the warmup story is broken;
- zero client-visible errors.

``--anti-vacuity`` deliberately mis-sizes the accounting window (the
"before" scrape is taken before the warmup storm instead of after it),
so the accounted-token delta covers warmup + steady while the client
only measured steady — the reconciliation gate MUST fail, proving the
gates can fail at all.

Committed records are ``EFF_*.json``; reproduction one-liners live in
docs/benchmarks.md "Engine efficiency: effwatch".
"""

import asyncio
import json
import time
from typing import Dict, List, Optional

import aiohttp

from production_stack_tpu_torch.loadgen.orchestrator import (_stop, free_port,
                                                       launch_engine,
                                                       wait_healthy)
from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)

CHAT_PATH = "/v1/chat/completions"


class _StormCounters:
    def __init__(self):
        self.requests = 0
        self.tokens = 0           # completion tokens the client received
        self.errors = 0
        self.samples: List[str] = []

    def sample(self, text: str) -> None:
        if len(self.samples) < 6:
            self.samples.append(text[:160])


async def _one_stream(session: aiohttp.ClientSession, url: str,
                      model: str, prompt: str, num_tokens: int,
                      c: _StormCounters) -> None:
    """One streaming chat request; counts completion tokens the client
    actually received (usage tail when the server sends one, content
    chunks otherwise — the fake has no usage tail)."""
    payload = {
        "model": model, "stream": True,
        "stream_options": {"include_usage": True},
        "messages": [{"role": "user", "content": prompt}],
        "max_tokens": num_tokens, "temperature": 0.0,
        "ignore_eos": True,
    }
    chunks = 0
    usage_tokens = None
    try:
        async with session.post(
                f"{url}{CHAT_PATH}", json=payload,
                timeout=aiohttp.ClientTimeout(total=120)) as resp:
            if resp.status != 200:
                c.errors += 1
                c.sample(f"HTTP {resp.status}: "
                         f"{(await resp.read())[:120]!r}")
                return
            async for raw in resp.content:
                line = raw.decode("utf-8", "replace").strip()
                if not line.startswith("data: "):
                    continue
                data = line[len("data: "):]
                if data == "[DONE]":
                    break
                try:
                    obj = json.loads(data)
                except ValueError:
                    continue
                usage = obj.get("usage")
                if usage and usage.get("completion_tokens") is not None:
                    usage_tokens = int(usage["completion_tokens"])
                for choice in obj.get("choices") or []:
                    if (choice.get("delta") or {}).get("content"):
                        chunks += 1
    except (aiohttp.ClientError, ConnectionError, OSError,
            asyncio.TimeoutError) as e:
        c.errors += 1
        c.sample(f"{type(e).__name__}: {e}")
        return
    c.requests += 1
    c.tokens += usage_tokens if usage_tokens is not None else chunks


async def _storm(url: str, model: str, *, users: int, duration_s: float,
                 num_tokens: int, tag: str,
                 stagger_s: float = 0.0,
                 mixed_tokens: Optional[List[int]] = None,
                 prompt_chars: int = 0) -> _StormCounters:
    """Closed-loop storm: ``users`` workers re-issuing streams until
    the window elapses; in-flight requests run to completion so every
    received token lies inside the surrounding scrape window.

    The churny shape for the window-adaptation A/B: ``stagger_s``
    offsets each worker's first request (staggered arrivals — batch
    composition keeps changing instead of settling once), and
    ``mixed_tokens`` cycles per-request ``max_tokens`` through the
    given list offset by worker id (mixed short/long outputs — rows
    finish at different steps, the finished-tail regime)."""
    c = _StormCounters()
    t_end = time.monotonic() + duration_s

    async def worker(wid: int):
        i = 0
        if stagger_s > 0:
            await asyncio.sleep(stagger_s * wid)
        async with aiohttp.ClientSession(
                connector=aiohttp.TCPConnector(limit=0)) as session:
            while time.monotonic() < t_end:
                toks = (mixed_tokens[(wid + i) % len(mixed_tokens)]
                        if mixed_tokens else num_tokens)
                i += 1
                prompt = f"{tag} worker {wid} round {i}"
                if prompt_chars and len(prompt) < prompt_chars:
                    # pad the prompt to a target length (longer live
                    # context -> the per-row KV read dominates the
                    # dispatch's fixed overhead; debug-tiny tokenizes
                    # per character)
                    prompt += " " + "ctx " * ((prompt_chars
                                               - len(prompt)) // 4 + 1)
                    prompt = prompt[:prompt_chars]
                await _one_stream(session, url, model, prompt,
                                  toks, c)

    await asyncio.gather(*(worker(w) for w in range(users)))
    return c


async def _scrape_perf(url: str) -> Dict:
    async with aiohttp.ClientSession() as session:
        async with session.get(
                f"{url}/load",
                timeout=aiohttp.ClientTimeout(total=10)) as r:
            r.raise_for_status()
            data = await r.json()
    return data.get("perf") or {}


async def _scrape_debug_perf(url: str) -> Optional[Dict]:
    """Best-effort /debug/perf grab for the committed record (the fake
    engine serves no /debug/perf — absence is not a failure)."""
    try:
        async with aiohttp.ClientSession() as session:
            async with session.get(
                    f"{url}/debug/perf?limit=12",
                    timeout=aiohttp.ClientTimeout(total=10)) as r:
                if r.status != 200:
                    return None
                return await r.json()
    except (aiohttp.ClientError, ConnectionError, OSError,
            asyncio.TimeoutError):
        return None


def _steps(perf: Dict) -> Dict:
    return perf.get("token_steps") or {}


def effwatch_violations(record: Dict,
                        sum_tolerance: float = 0.02,
                        rate_tolerance: float = 0.10) -> List[str]:
    """The accounting audit's pass/fail contract (CLI exits 1 on
    any)."""
    d = record["detail"]
    out = []
    if d["errors"]:
        out.append(f"{d['errors']} client-visible errors during the "
                   f"storm: {d.get('error_samples')}")
    delta = d["deltas"]
    total = delta["token_steps_total"]
    kinds = delta["real"] + delta["pad"] + delta["dead"]
    if total <= 0:
        out.append("no decode token-steps accounted in the measured "
                   "window (accounting dead or storm too short)")
    else:
        frac = kinds / total
        if abs(frac - 1.0) > sum_tolerance:
            out.append(
                f"token-step kinds do not sum to the independent "
                f"total: (real+pad+dead)/total = {frac:.4f} "
                f"(|1-x| > {sum_tolerance})")
    acct = d["accounted_decode_tokens"]
    client = d["client_decode_tokens"]
    if client <= 0:
        out.append("client measured zero decode tokens")
    else:
        ratio = acct / client
        if abs(ratio - 1.0) > rate_tolerance:
            out.append(
                f"accounted decode tokens diverge from client-measured"
                f": accounted {acct} vs client {client} "
                f"(ratio {ratio:.3f}, tolerance {rate_tolerance})")
    if delta["compiles_total"] != 0:
        out.append(
            f"{delta['compiles_total']} XLA compile events landed in "
            f"the post-warmup steady window (must be zero)")
    return out


async def run_effwatch(*, engine: str = "debug-tiny",
                       users: int = 6,
                       duration_s: float = 20.0,
                       warmup_s: float = 8.0,
                       num_tokens: int = 32,
                       sum_tolerance: float = 0.02,
                       rate_tolerance: float = 0.10,
                       anti_vacuity: bool = False,
                       window_adapt: bool = True,
                       stagger_s: float = 0.0,
                       mixed_tokens: Optional[List[int]] = None,
                       prompt_chars: int = 0,
                       engine_args: Optional[List[str]] = None,
                       fake_pad_fraction: float = 0.3,
                       fake_dead_fraction: float = 0.1,
                       fake_skew: float = 0.0,
                       fake_tokens_per_s: float = 200.0,
                       platform: str = "cuda",
                       log_dir: str = "loadgen-logs",
                       startup_timeout_s: float = 420.0) -> Dict:
    """Launch one engine, audit its efficiency accounting around a
    steady storm; return the EFF record (BENCH schema; headline =
    accounted steady decode tokens/s).

    ``window_adapt=False`` launches the real engine with
    ``--no-window-adapt`` (the r17 A/B control: full-geometry windows
    whatever the batch holds); ``stagger_s``/``mixed_tokens`` shape
    the churny storm; ``engine_args`` appends raw engine CLI flags
    (geometry overrides for the compile-budget tests)."""
    procs = []
    try:
        if engine == "fake":
            extra = ["--num-tokens", str(num_tokens),
                     "--tokens-per-s", str(fake_tokens_per_s)]
        else:
            extra = list(engine_args or [])
            if not window_adapt:
                extra.append("--no-window-adapt")
        proc = launch_engine(engine, free_port(), log_dir=log_dir,
                             platform=platform, extra_args=extra)
        procs.append(proc)
        await wait_healthy(proc.url, startup_timeout_s)
        model = "fake-model" if engine == "fake" else engine
        if engine == "fake":
            # synthetic pad/dead fractions (and optionally a sum skew)
            # so the engine-free smoke exercises non-trivial splits
            async with aiohttp.ClientSession() as session:
                await session.post(f"{proc.url}/fault", json={
                    "perf": {"pad_fraction": fake_pad_fraction,
                             "dead_fraction": fake_dead_fraction,
                             "skew": fake_skew}})

        before_warmup = await _scrape_perf(proc.url)
        t_before_warmup = time.monotonic()
        logger.info("effwatch warmup storm: %d users for %.0fs", users,
                    warmup_s)
        await _storm(proc.url, model, users=users, duration_s=warmup_s,
                     num_tokens=num_tokens, tag="warmup",
                     stagger_s=stagger_s, mixed_tokens=mixed_tokens,
                     prompt_chars=prompt_chars)

        if anti_vacuity:
            # deliberately mis-sized accounting window: the "before"
            # scrape predates the warmup storm, so the accounted delta
            # covers warmup + steady while the client only measures
            # steady — reconciliation MUST fail
            before, t_before = before_warmup, t_before_warmup
        else:
            before = await _scrape_perf(proc.url)
            t_before = time.monotonic()
        logger.info("effwatch steady storm: %d users for %.0fs", users,
                    duration_s)
        c = await _storm(proc.url, model, users=users,
                         duration_s=duration_s, num_tokens=num_tokens,
                         tag="steady", stagger_s=stagger_s,
                         mixed_tokens=mixed_tokens,
                         prompt_chars=prompt_chars)
        after = await _scrape_perf(proc.url)
        t_after = time.monotonic()
        debug_perf = await _scrape_debug_perf(proc.url)
    finally:
        _stop(procs)

    window_s = max(1e-9, t_after - t_before)
    b, a = _steps(before), _steps(after)
    deltas = {
        "real": a.get("real", 0) - b.get("real", 0),
        "pad": a.get("pad", 0) - b.get("pad", 0),
        "dead": a.get("dead", 0) - b.get("dead", 0),
        "token_steps_total": (a.get("token_steps_total", 0)
                              - b.get("token_steps_total", 0)),
        "windows": a.get("windows", 0) - b.get("windows", 0),
        "compiles_total": (after.get("compiles_total", 0)
                           - before.get("compiles_total", 0)),
    }
    # the client's decode-token ground truth: tokens received minus
    # one per request (the first token is prefill-sampled, so the
    # decode accounting rightly never saw it)
    client_decode = c.tokens - c.requests
    acct_rate = deltas["real"] / window_s
    record = {
        "metric": "engine efficiency accounting audit: accounted vs "
                  "client-measured decode tokens/s, token-step "
                  "fraction consistency, steady-window compile "
                  "silence" + (" (ANTI-VACUITY: mis-sized accounting "
                               "window, must fail)" if anti_vacuity
                               else ""),
        "value": round(acct_rate, 2),
        "unit": "accounted_decode_tokens_per_s",
        "platform": platform,
        "detail": {
            "engine": engine,
            "users": users,
            "duration_s": duration_s,
            "warmup_s": warmup_s,
            "num_tokens": num_tokens,
            "window_adapt": window_adapt,
            "stagger_s": stagger_s,
            "mixed_tokens": mixed_tokens,
            "prompt_chars": prompt_chars,
            "anti_vacuity": anti_vacuity,
            "window_s": round(window_s, 3),
            "requests": c.requests,
            "client_tokens": c.tokens,
            "client_decode_tokens": client_decode,
            "client_decode_tokens_per_s": round(
                client_decode / window_s, 2),
            "accounted_decode_tokens": deltas["real"],
            "accounted_decode_tokens_per_s": round(acct_rate, 2),
            "deltas": deltas,
            "fraction_sum": round(
                (deltas["real"] + deltas["pad"] + deltas["dead"])
                / deltas["token_steps_total"], 4)
            if deltas["token_steps_total"] else None,
            # live fraction over the WHOLE measured window (delta-
            # derived — the A/B gates on this, not on the ring's
            # recent-horizon figure)
            "live_fraction_window": round(
                deltas["real"] / max(1, deltas["real"] + deltas["pad"]
                                     + deltas["dead"]), 4),
            "live_fraction_steady": after.get("live_fraction"),
            "mbu_perc_steady": after.get("mbu_perc"),
            "effective_bytes_per_s_steady":
                after.get("effective_bytes_per_s"),
            "compiles_total_lifetime": after.get("compiles_total"),
            "compile_in_flight_at_end":
                after.get("compile_in_flight"),
            "errors": c.errors,
            "error_samples": c.samples,
            "sum_tolerance": sum_tolerance,
            "rate_tolerance": rate_tolerance,
            "perf_before": before,
            "perf_after": after,
            "debug_perf": debug_perf,
        },
    }
    return record


def effwatch_ab_violations(record: Dict,
                           live_floor: float = 0.80,
                           improve_floor: float = 0.20,
                           sum_tolerance: float = 0.02,
                           rate_tolerance: float = 0.10) -> List[str]:
    """The A/B acceptance contract (CLI exits 1 on any):

    - BOTH sides must individually pass every effwatch gate (sum-to-1,
      client reconciliation, steady-window compile silence, zero
      errors) — the anti-vacuity substrate holds under variable batch
      and window geometry, or the win is unaccountable;
    - the adapt side's whole-window live fraction must reach
      ``live_floor`` AND beat the control's (directional: adaptation
      off must actually cost live fraction, or the storm shape proves
      nothing);
    - accounted decode tokens/s must improve by ``improve_floor``
      relative to the control.
    """
    d = record["detail"]
    out = []
    for side in ("adapt", "control"):
        for v in effwatch_violations({"detail": d[side]},
                                     sum_tolerance=sum_tolerance,
                                     rate_tolerance=rate_tolerance):
            out.append(f"[{side}] {v}")
    live_a = d["adapt"].get("live_fraction_window") or 0.0
    live_c = d["control"].get("live_fraction_window") or 0.0
    if live_a < live_floor:
        out.append(f"adapt-side live fraction {live_a:.3f} below the "
                   f"{live_floor} floor")
    if live_a <= live_c:
        out.append(f"adapt-side live fraction {live_a:.3f} does not "
                   f"beat the control's {live_c:.3f} — the storm "
                   f"shape is not exercising the levers")
    rate_a = d["adapt"]["accounted_decode_tokens_per_s"]
    rate_c = d["control"]["accounted_decode_tokens_per_s"]
    if rate_c <= 0:
        out.append("control side accounted zero decode tokens/s")
    elif rate_a < rate_c * (1.0 + improve_floor):
        out.append(
            f"accounted decode tokens/s improved only "
            f"{100.0 * (rate_a / rate_c - 1.0):.1f}% "
            f"({rate_a} vs {rate_c}; floor {100 * improve_floor:.0f}%)")
    return out


def _aggregate_side(details: List[Dict]) -> Dict:
    """Fold one side's per-round details into an aggregate the A/B
    gates read: counters and token counts SUM across rounds, rates
    come from the summed tokens over the summed measured windows, so
    no single round's host noise owns the comparison."""
    deltas = {k: sum(d["deltas"][k] for d in details)
              for k in ("real", "pad", "dead", "token_steps_total",
                        "windows", "compiles_total")}
    window_s = sum(d["window_s"] for d in details)
    acct = sum(d["accounted_decode_tokens"] for d in details)
    client = sum(d["client_decode_tokens"] for d in details)
    kinds = deltas["real"] + deltas["pad"] + deltas["dead"]
    return {
        "rounds": len(details),
        "window_adapt": details[0]["window_adapt"],
        "errors": sum(d["errors"] for d in details),
        "error_samples": [s for d in details
                          for s in d["error_samples"]][:6],
        "requests": sum(d["requests"] for d in details),
        "deltas": deltas,
        "window_s": round(window_s, 3),
        "accounted_decode_tokens": acct,
        "client_decode_tokens": client,
        "accounted_decode_tokens_per_s": round(acct / window_s, 2),
        "client_decode_tokens_per_s": round(client / window_s, 2),
        "fraction_sum": round(kinds / deltas["token_steps_total"], 4)
        if deltas["token_steps_total"] else None,
        "live_fraction_window": round(deltas["real"] / max(1, kinds),
                                      4),
    }


async def run_effwatch_ab(*, live_floor: float = 0.80,
                          improve_floor: float = 0.20,
                          rounds: int = 1,
                          fake_control_pad_fraction: float = 0.40,
                          fake_control_dead_fraction: float = 0.10,
                          fake_control_tokens_per_s: float = 200.0,
                          **kw) -> Dict:
    """Same-storm A/B: window adaptation ON vs ``--no-window-adapt``
    (identical storm shape, fresh engine process per side per round).
    ``rounds`` > 1 repeats the pair in ABBA order (adapt-control /
    control-adapt alternating) and gates on per-side AGGREGATES —
    single-host run-to-run noise is comparable to the effect size, so
    the committed record sums tokens and measured seconds across
    rounds instead of trusting one pair. Returns an EFF record whose
    detail carries both aggregates, every per-round detail, and the
    comparison; headline value = accounted decode tokens/s
    improvement (%).

    Fake-engine mode is a PLUMBING smoke (delta math, per-side gates,
    comparison arithmetic): the control side runs with deliberately
    worse synthetic pad/dead fractions and pacing — the committed
    acceptance record comes from the real-engine A/B
    (benchmarks/run_effwatch.sh --ab)."""
    ctrl_kw = dict(kw)
    if ctrl_kw.get("engine") == "fake":
        ctrl_kw.update(
            fake_pad_fraction=fake_control_pad_fraction,
            fake_dead_fraction=fake_control_dead_fraction,
            fake_tokens_per_s=fake_control_tokens_per_s)
    per: Dict[bool, List[Dict]] = {True: [], False: []}
    for i in range(max(1, rounds)):
        order = (True, False) if i % 2 == 0 else (False, True)
        for adapt_side in order:
            logger.info("effwatch A/B round %d/%d: %s side", i + 1,
                        max(1, rounds),
                        "adapt" if adapt_side else "control")
            rec = await run_effwatch(
                window_adapt=adapt_side,
                **(kw if adapt_side else ctrl_kw))
            per[adapt_side].append(rec["detail"])
    adapt = _aggregate_side(per[True])
    control = _aggregate_side(per[False])
    rate_a = adapt["accounted_decode_tokens_per_s"]
    rate_c = control["accounted_decode_tokens_per_s"]
    improvement = (100.0 * (rate_a / rate_c - 1.0)
                   if rate_c > 0 else None)
    return {
        "metric": "continuous batching across fused decode windows: "
                  "same-storm A/B, window adaptation (live-row "
                  "compaction + adaptive window sizing + mid-window "
                  "admission) vs --no-window-adapt",
        "value": round(improvement, 2) if improvement is not None
        else None,
        "unit": "accounted_decode_tokens_per_s_improvement_perc",
        "platform": kw.get("platform", "cuda"),
        "detail": {
            "adapt": adapt,
            "control": control,
            "rounds": {"adapt": per[True], "control": per[False]},
            "accounted_decode_tokens_per_s_adapt": rate_a,
            "accounted_decode_tokens_per_s_control": rate_c,
            "improvement_perc": round(improvement, 2)
            if improvement is not None else None,
            "live_fraction_adapt": adapt["live_fraction_window"],
            "live_fraction_control": control["live_fraction_window"],
            "live_floor": live_floor,
            "improve_floor": improve_floor,
        },
    }
