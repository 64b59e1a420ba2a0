"""OpenAI-compatible HTTP server for the PyTorch engine (aiohttp)
(``production_stack_tpu/engine/server.py``). Left out, with what they
belong to: ``/debug/traces`` and ``/debug/perf``, the trace middleware
and API-key enforcement (not yet queued), and an embedding encoder
(``--embedding-model``).

Endpoints: ``/v1/completions`` and ``/v1/chat/completions`` (streamed
as SSE or not; ``n`` choices, several prompts per completion request,
logprobs with top alternatives, ``echo`` with prompt logprobs, logit
shaping, guided decoding), the pooling routes ``/v1/embeddings``,
``/v1/rerank``, ``/v2/rerank`` and ``/v1/score`` (the serving model's
mean-pooled hidden states, flagged ``embedding_source``
``causal-mean-pool``), ``/v1/models``, ``/health``, ``/load``,
``/metrics``, ``/version``, ``/tokenize`` and ``/detokenize``, and the
runtime adapter verbs ``/admin/lora/load`` and ``/admin/lora/evict``,
and the kvplane's ``/admin/kvplane/migrate_out`` and
``/admin/kvplane/warm``. Every reply carries the engine's ``x-engine-*`` load headers. Overload answers
as the JAX server does: 503 + Retry-After when bounded admission sheds a
request or the queue-delay cap drops it, 504 + ``x-deadline-expired``
when the client's ``x-request-deadline-ms`` elapses before admission.

Guided decoding takes vLLM's fields — ``guided_regex``,
``guided_choice``, ``guided_json`` — and ``response_format``
``json_schema``; the grammar is compiled in an executor before the
request reaches the engine, and a constraint the DFA cannot express
(``json_object`` among them) answers 400 naming its field; nothing is
silently ignored. A failed engine step answers 500 and turns /health to
503 (engine/async_engine.py).

Multi-LoRA, as the JAX server serves it: each adapter is a model id
(``--lora-adapters name=/path.npz,other=random:SEED``, or loaded at
runtime with ``POST /admin/lora/load {"name", "src"}``), listed on
``/v1/models`` with the base model as ``root`` / ``parent`` and on
``/load``'s ``models``. An unknown model answers 404, a failed load 503
+ Retry-After (a shed: the engine serves on), an unknown evict 404; the
pooling routes serve the base model only (400 for an adapter).
``--checkpoint DIR`` serves an HF checkpoint's weights.

KV tiering and disaggregated prefill: ``--kv-transfer-config JSON``
(kvcache/connector.KVTransferConfig's fields, e.g. ``{"kv_role":
"kv_producer", "local_disk_path": "/tmp/tier", "remote_url":
"tpukv://host:port"}``) makes the engine publish and consume KV chunks
through host, disk and remote tiers, byte-compatible with the JAX
engine's, so a port engine serves in the JAX router's
``--prefill-backends`` (producer) or decode (consumer) pool. ``/load``
then carries the ``kv_cache`` block and ``/metrics`` the
``tpu:kvcache_*`` series; ``--no-kvplane-defrag`` turns off the free
list's defrag after fragmented allocation failures.

    python -m production_stack_tpu_torch.engine.server --model llama-3-8b

runs on the card; ``--device cpu`` runs the plain PyTorch path.
"""

import argparse
import asyncio
import dataclasses
import json
import math
import time
from contextlib import aclosing
from typing import List, Optional

import numpy as np
from aiohttp import web
from pydantic import ValidationError

from production_stack_tpu_torch import protocol as proto
from production_stack_tpu_torch.engine import guided
from production_stack_tpu_torch.engine.async_engine import (AsyncLLMEngine,
                                                            EngineDeadError)
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import (AdmissionRejected,
                                                      DeadlineExceeded)
from production_stack_tpu_torch.engine.scheduler import SamplingOptions
from production_stack_tpu_torch.utils import init_logger
from production_stack_tpu_torch.version import __version__

logger = init_logger(__name__)

ENGINE_KEY = web.AppKey("engine", AsyncLLMEngine)

# relative per-request budget in milliseconds (the router sets it)
DEADLINE_HEADER = "x-request-deadline-ms"
# marks a 504 as "the client's deadline elapsed": the router relays it
# without a breaker signal or failover
DEADLINE_MARKER = "x-deadline-expired"
# OpenAI's bound on n, and on len(prompt) * n
MAX_CHOICES = 128


def _error(status: int, message: str,
           err_type: str = "invalid_request_error") -> web.Response:
    body = proto.ErrorResponse(
        error=proto.ErrorInfo(message=message, type=err_type, code=status))
    return web.json_response(body.model_dump(), status=status)


def _dead(e: EngineDeadError) -> web.Response:
    return _error(500, str(e), err_type="internal_error")


class _QueueDelayShed(Exception):
    """The scheduler shed this request for exceeding max_queue_delay_ms
    while it waited (finish_reason "queue_delay")."""


def _deadline_from(request: web.Request):
    """x-request-deadline-ms as an absolute monotonic deadline:
    (deadline or None, error response or None)."""
    raw = request.headers.get(DEADLINE_HEADER)
    if raw is None:
        return None, None
    try:
        ms = float(raw)
    except ValueError:
        return None, _error(400, f"{DEADLINE_HEADER} must be a number "
                                 f"of milliseconds (got {raw!r})")
    if not math.isfinite(ms):
        return None, _error(400, f"{DEADLINE_HEADER} must be finite")
    if ms <= 0:
        # already expired on arrival: 504 before any engine work
        return None, _deadline_error()
    return time.monotonic() + ms / 1e3, None


def _deadline_error() -> web.Response:
    resp = _error(504, "request deadline expired while waiting for "
                       "admission (x-request-deadline-ms elapsed before "
                       "the engine could start it)",
                  err_type="timeout_error")
    resp.headers[DEADLINE_MARKER] = "1"
    return resp


def _shed_error(engine: AsyncLLMEngine,
                message: Optional[str] = None) -> web.Response:
    """503 + Retry-After: the shed the router reads as shed-not-sick."""
    retry_s = max(1.0, engine.engine.estimated_queue_delay_s())
    resp = _error(503, message or "engine overloaded: request shed; "
                                  "retry after the indicated delay",
                  err_type="overloaded_error")
    resp.headers["Retry-After"] = str(int(math.ceil(retry_s)))
    return resp


def _load_headers(engine: AsyncLLMEngine) -> dict:
    """The load report every reply carries (lock-free)."""
    report = engine.engine.load_report()
    return {
        "x-engine-queue-depth": str(report["queue_depth"]),
        "x-engine-running": str(report["running"]),
        "x-engine-free-kv-blocks": str(report["free_kv_blocks"]),
        "x-engine-est-queue-delay-ms": str(report["est_queue_delay_ms"]),
    }


def _check_overload_finish(out) -> None:
    """A waiting-dropped sequence's terminal output (no token, no text)
    as the error the client contract promises."""
    if not out.finished or out.new_token is not None or out.text_delta:
        return
    if out.finish_reason == "deadline":
        raise DeadlineExceeded()
    if out.finish_reason == "queue_delay":
        raise _QueueDelayShed()


async def _guarded_payloads(merged, lead_payloads, chunk_for):
    """The streaming shape of both generation routes: the first engine
    output is pulled before the lead payloads (role or echo chunks) go
    out, so a shed or a deadline drop before it still answers a clean
    503/504; then every chunk_for(i, out) payload. A drop after the
    response started ends that choice with its finish_reason chunk."""
    try:
        head = await merged.__anext__()
    except StopAsyncIteration:
        head = None
    if head is not None:
        _check_overload_finish(head[1])
    for payload in lead_payloads:
        yield payload
    if head is not None:
        payload = chunk_for(*head)
        if payload is not None:
            yield payload
        async for i, out in merged:
            payload = chunk_for(i, out)
            if payload is not None:
                yield payload


_GUIDED_FIELDS = ("guided_regex", "guided_choice", "guided_json",
                  "response_format")


def _guided_pattern(req) -> Optional[str]:
    """vLLM-style guided decoding fields -> one regex, or None (JAX
    ``_guided_pattern``): guided_regex as it is, guided_choice as an
    alternation of its literals, guided_json and response_format
    json_schema as the schema's regex. A free-form json_object and an
    unknown response_format type raise ValueError."""
    if getattr(req, "guided_regex", None):
        return req.guided_regex
    if getattr(req, "guided_choice", None):
        return guided.choice_regex(req.guided_choice)
    if getattr(req, "guided_json", None) is not None:
        return guided.json_schema_regex(req.guided_json)
    rf = getattr(req, "response_format", None)
    if rf:
        kind = rf.get("type")
        if kind == "json_schema":
            spec = rf.get("json_schema") or {}
            schema = spec.get("schema", spec)   # OpenAI nests .schema
            return guided.json_schema_regex(schema)
        if kind == "json_object":
            raise ValueError(
                "response_format json_object (free-form JSON) is not "
                "supported: a DFA cannot express unbounded-depth JSON. "
                "Use response_format json_schema or guided_json with a "
                "schema.")
        if kind not in (None, "text"):
            raise ValueError(f"unsupported response_format type {kind!r}")
    return None


async def _guided_options(engine: AsyncLLMEngine, req, options):
    """(options with the request's guided pattern, None) or (None, a
    400 naming the field): the grammar is compiled here, in an
    executor, so a bad pattern is a 400 before any response starts and
    a first compile (a walk over the whole vocabulary) never blocks the
    event loop; the engine then finds it in the compile cache."""
    field = next((f for f in _GUIDED_FIELDS if getattr(req, f, None)),
                 "guided decoding")
    try:
        pattern = _guided_pattern(req)
        if pattern is not None:
            await asyncio.get_running_loop().run_in_executor(
                None, guided.compile_grammar, pattern, engine.tokenizer)
    except ValueError as e:
        return None, _error(400, f"invalid guided decoding constraint "
                                 f"({field}): {e}")
    return dataclasses.replace(options, guided_regex=pattern), None


def _logit_bias(req) -> Optional[dict]:
    """OpenAI logit_bias {token-id string: bias} -> {int: float}, at
    most OpenAI's 300 entries."""
    raw = getattr(req, "logit_bias", None)
    if not raw:
        return None
    if len(raw) > 300:
        raise ValueError(
            f"logit_bias supports at most 300 entries (got {len(raw)})")
    try:
        return {int(k): float(v) for k, v in raw.items()}
    except (TypeError, ValueError):
        raise ValueError("logit_bias keys must be token ids and values "
                         "numbers")


def _top_logprobs(req) -> int:
    """The alternatives per token a request asks for: chat's
    top_logprobs (which needs logprobs=true), or legacy completions'
    integer logprobs=N; at most 20, as OpenAI."""
    tl = getattr(req, "top_logprobs", None)
    if tl is not None and not 0 <= tl <= 20:
        raise ValueError(f"top_logprobs must be in [0, 20] (got {tl})")
    if tl and not getattr(req, "logprobs", None):
        raise ValueError("top_logprobs requires logprobs to be set to true")
    tl = tl or 0
    if not tl:
        lp = getattr(req, "logprobs", None)
        if isinstance(lp, int) and not isinstance(lp, bool) and lp > 0:
            tl = lp
    if tl > 20:
        raise ValueError(f"top_logprobs supports at most 20 (got {tl})")
    return int(tl)


def _sampling_options(req, max_tokens: Optional[int]) -> SamplingOptions:
    stop = req.stop if isinstance(req.stop, list) else (
        [req.stop] if req.stop else [])
    return SamplingOptions(
        temperature=req.temperature, top_p=req.top_p, top_k=req.top_k,
        max_tokens=max_tokens if max_tokens is not None else 128,
        stop=stop, stop_token_ids=req.stop_token_ids or [],
        ignore_eos=req.ignore_eos, seed=req.seed,
        presence_penalty=req.presence_penalty,
        frequency_penalty=req.frequency_penalty,
        repetition_penalty=req.repetition_penalty, min_p=req.min_p,
        min_tokens=req.min_tokens, priority=req.priority,
        logit_bias=_logit_bias(req), top_logprobs=_top_logprobs(req))


async def _check_request(engine: AsyncLLMEngine, req, max_tokens):
    """(SamplingOptions, None) or (None, error response)."""
    try:
        engine.engine.resolve_model(req.model or None)
    except ValueError as e:
        return None, _error(404, str(e))
    if not 1 <= req.n <= MAX_CHOICES:
        return None, _error(400, f"n must be between 1 and {MAX_CHOICES}")
    try:
        options = _sampling_options(req, max_tokens)
        engine.engine.check_options(options)
    except ValueError as e:
        return None, _error(400, str(e))
    return await _guided_options(engine, req, options)


def _too_long(engine: AsyncLLMEngine, n: int) -> Optional[web.Response]:
    limit = engine.engine.cfg.max_model_len
    if n >= limit:
        return _error(400, f"prompt has {n} tokens, which exceeds "
                           f"max_model_len {limit}")
    return None


def _choice_options(options: SamplingOptions, i: int) -> SamplingOptions:
    """A choice's options: a seeded request varies the seed by choice
    index, or n choices would draw the same noise."""
    if i == 0 or options.seed is None:
        return options
    return dataclasses.replace(options, seed=options.seed + i)


def _choice_jobs(prompts, options, n):
    """The OpenAI choice grid: (prompt p, sample j) is choice p * n + j.
    Returns [(index, prompt ids, options)]."""
    return [(p * n + j, pids, _choice_options(options, j))
            for p, pids in enumerate(prompts) for j in range(n)]


async def _gather_cancelling(coros):
    """gather() where one failure cancels the siblings, which free
    their engine slots before the error response goes out."""
    tasks = [asyncio.ensure_future(c) for c in coros]
    try:
        return await asyncio.gather(*tasks)
    except BaseException:
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        raise


def _merged_streams(engine, jobs, model, deadline=None):
    """Run the jobs [(choice index, prompt ids, options)] at once and
    yield (choice index, StepOutput) as they come. A stream's failure
    reaches the consumer; closing the generator cancels every stream
    and frees their slots."""
    async def gen():
        q: asyncio.Queue = asyncio.Queue()

        async def pump(idx, pids, opts):
            try:
                async with aclosing(engine.stream(
                        list(pids), opts, model=model,
                        deadline=deadline)) as it:
                    async for out in it:
                        await q.put((idx, out))
            except Exception as e:  # noqa: BLE001 — raised by the consumer
                await q.put((idx, e))
                return
            await q.put((idx, None))

        tasks = [asyncio.ensure_future(pump(*job)) for job in jobs]
        try:
            done = 0
            while done < len(jobs):
                i, out = await q.get()
                if out is None:
                    done += 1
                    continue
                if isinstance(out, Exception):
                    raise out
                yield i, out
        finally:
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
    return gen()


async def _sse_stream(request: web.Request, gen) -> web.StreamResponse:
    """Relay an SSE generator, preparing the response lazily: the 200
    and its headers go out with the first payload, so a shed, a
    deadline drop or an engine failure before it is a clean error
    response; after it they can only end the connection."""
    engine = request.app[ENGINE_KEY]
    resp: Optional[web.StreamResponse] = None

    async def ensure_prepared() -> web.StreamResponse:
        nonlocal resp
        if resp is None:
            resp = web.StreamResponse(status=200, headers={
                "Content-Type": "text/event-stream",
                "Cache-Control": "no-cache", "X-Accel-Buffering": "no",
                **_load_headers(engine)})
            await resp.prepare(request)
        return resp

    errors = {AdmissionRejected: lambda e: _shed_error(engine, str(e)),
              DeadlineExceeded: lambda e: _deadline_error(),
              _QueueDelayShed: lambda e: _shed_error(engine),
              EngineDeadError: _dead}
    try:
        async for payload in gen:
            await ensure_prepared()
            await resp.write(f"data: {payload}\n\n".encode())
        await ensure_prepared()
        await resp.write(b"data: [DONE]\n\n")
        await resp.write_eof()
    except (ConnectionResetError, ConnectionError):
        # the client went away; closing the generator aborts the request
        await gen.aclose()
        if resp is None:
            resp = web.Response(status=500)   # never reaches the client
    except tuple(errors) as e:
        await gen.aclose()
        if resp is None:
            return errors[type(e)](e)
        resp.force_close()
    return resp


# ---------------------------------------------------------------- logprobs

def _lp_skip(out) -> bool:
    """A token that stopped the sequence is excluded from the text, so
    it has no logprobs entry either (OpenAI alignment)."""
    return out.finished and out.finish_reason == "stop"


def _chat_lp_entry(tok, token_id: int, logprob, want_top: bool,
                   alts=None):
    """One chat-logprobs content entry; `alts` [(token_id, logprob)]
    are the device's top-K under the distribution the chosen logprob
    comes from."""
    text, raw = tok.id_to_token(token_id)
    lp = logprob if logprob is not None else 0.0
    entry = proto.ChatLogprobToken(token=text, logprob=lp, bytes=raw)
    if want_top:
        if alts:
            tops = []
            for tid, tlp in alts:
                ttext, traw = tok.id_to_token(int(tid))
                tops.append(proto.ChatLogprobTop(
                    token=ttext, logprob=float(tlp), bytes=traw))
            entry.top_logprobs = tops
        else:
            entry.top_logprobs = [proto.ChatLogprobTop(
                token=text, logprob=lp, bytes=raw)]
    return entry


def _completion_logprobs(tok, token_ids, logprobs, want_top: bool,
                         alts_list=None) -> proto.CompletionLogprobs:
    """The legacy completions logprobs block; alts_list (parallel to
    token_ids) holds each token's [(id, logprob)] alternatives."""
    texts = [tok.id_to_token(t)[0] for t in token_ids]
    lps = [lp if lp is not None else 0.0 for lp in logprobs]
    top = None
    if want_top:
        top = []
        for i, (text, lp) in enumerate(zip(texts, lps)):
            alts = alts_list[i] if alts_list else None
            if alts:
                top.append({tok.id_to_token(int(t))[0]: float(l)
                            for t, l in alts})
            else:
                top.append({text: lp})
    return proto.CompletionLogprobs(tokens=texts, token_logprobs=lps,
                                    top_logprobs=top)


async def _prompt_echo_blocks(engine, tok, prompts, req):
    """[(prompt text, CompletionLogprobs or None)] per prompt for
    echo=true: the prompt's text prefixes each of its choices; with
    logprobs asked, the teacher-forced prompt logprobs of every prompt
    in one batched call (runner.prompt_logprobs, off the event loop),
    position 0 reporting null as OpenAI does."""
    texts = [tok.decode(p) for p in prompts]
    if req.logprobs is None:
        return [(t, None) for t in texts]
    runner = engine.engine.runner
    T = max(len(p) for p in prompts)
    arr = np.zeros((len(prompts), T), np.int32)
    for r, p in enumerate(prompts):
        arr[r, :len(p)] = p

    def compute():
        out = runner.prompt_logprobs(arr).cpu().numpy()
        return [out[r, :len(p) - 1].tolist()
                for r, p in enumerate(prompts)]

    all_lps = await asyncio.get_running_loop().run_in_executor(None, compute)
    blocks = []
    for text, pids, lps in zip(texts, prompts, all_lps):
        pieces = [tok.id_to_token(t)[0] for t in pids]
        token_lps = [None] + [float(v) for v in lps]
        top = None
        if req.logprobs > 0:
            top = [None] + [{pc: lp} for pc, lp in
                            zip(pieces[1:], token_lps[1:])]
        blocks.append((text, proto.CompletionLogprobs(
            tokens=pieces, token_logprobs=token_lps, top_logprobs=top)))
    return blocks


def _merge_echo_lp(echo_lp, lp_block):
    """The prompt's logprobs block ahead of a completion's."""
    if echo_lp is None:
        return lp_block
    return proto.CompletionLogprobs(
        tokens=echo_lp.tokens + lp_block.tokens,
        token_logprobs=echo_lp.token_logprobs + lp_block.token_logprobs,
        top_logprobs=(echo_lp.top_logprobs + lp_block.top_logprobs
                      if echo_lp.top_logprobs is not None
                      and lp_block.top_logprobs is not None else None))


def _usage(prompt_tokens: int, completion_tokens: int) -> proto.UsageInfo:
    return proto.UsageInfo(prompt_tokens=prompt_tokens,
                           completion_tokens=completion_tokens,
                           total_tokens=prompt_tokens + completion_tokens)


async def _run_choices(engine, coros):
    """Non-streamed choices, or the error response that ends them."""
    try:
        return await _gather_cancelling(coros), None
    except AdmissionRejected as e:
        return None, _shed_error(engine, str(e))
    except DeadlineExceeded:
        return None, _deadline_error()
    except _QueueDelayShed:
        return None, _shed_error(engine)
    except EngineDeadError as e:
        return None, _dead(e)


# ---------------------------------------------------------------- handlers

async def chat_completions(request: web.Request) -> web.StreamResponse:
    engine = request.app[ENGINE_KEY]
    try:
        req = proto.ChatCompletionRequest(**await request.json())
    except (ValidationError, json.JSONDecodeError) as e:
        return _error(400, f"invalid request: {e}")
    options, bad = await _check_request(
        engine, req, req.max_completion_tokens or req.max_tokens)
    if bad is not None:
        return bad
    deadline, bad = _deadline_from(request)
    if bad is not None:
        return bad
    if engine.engine.admission_full():
        # refuse before the template and tokenizer work
        return _shed_error(engine)
    tok = engine.tokenizer
    prompt_ids = tok.encode(tok.apply_chat_template(
        [m.model_dump() for m in req.messages]))
    bad = _too_long(engine, len(prompt_ids))
    if bad is not None:
        return bad
    rid = proto._gen_id("chatcmpl")
    model = req.model or None
    want_top = bool(req.top_logprobs)

    if req.stream:
        include_usage = bool(req.stream_options
                             and req.stream_options.include_usage)
        # with include_usage every chunk carries "usage": null until the
        # final usage chunk; without it the field is left out
        exclude = None if include_usage else {"usage"}

        async def gen():
            num_tokens = 0

            def chunk_for(i, out):
                nonlocal num_tokens
                if out.new_token is not None:
                    num_tokens += 1
                lp_block = None
                if (req.logprobs and out.new_token is not None
                        and not _lp_skip(out)):
                    lp_block = proto.ChatLogprobs(content=[_chat_lp_entry(
                        tok, out.new_token, out.logprob, want_top,
                        out.top_alts)])
                # a token may have no text yet (partial UTF-8) and still
                # a logprob entry to deliver
                if out.text_delta or out.finished or lp_block:
                    return proto.ChatCompletionChunk(
                        id=rid, model=req.model,
                        choices=[proto.ChatCompletionChunkChoice(
                            index=i, delta=proto.DeltaMessage(
                                content=out.text_delta or None),
                            finish_reason=out.finish_reason
                            if out.finished else None,
                            logprobs=lp_block)]
                    ).model_dump_json(exclude=exclude)
                return None

            role_chunks = [proto.ChatCompletionChunk(
                id=rid, model=req.model,
                choices=[proto.ChatCompletionChunkChoice(
                    index=i, delta=proto.DeltaMessage(role="assistant",
                                                      content=""))]
            ).model_dump_json(exclude=exclude) for i in range(req.n)]
            async with aclosing(_merged_streams(
                    engine, _choice_jobs([prompt_ids], options, req.n),
                    model, deadline)) as it:
                async for payload in _guarded_payloads(it, role_chunks,
                                                       chunk_for):
                    yield payload
            if include_usage:
                yield proto.ChatCompletionChunk(
                    id=rid, model=req.model, choices=[],
                    usage=_usage(len(prompt_ids), num_tokens)
                ).model_dump_json()
        return await _sse_stream(request, gen())

    async def collect_one(i: int):
        parts, lp_entries, finish, tokens = [], [], None, 0
        async with aclosing(engine.stream(
                list(prompt_ids), _choice_options(options, i), model=model,
                deadline=deadline)) as it:
            async for out in it:
                _check_overload_finish(out)
                parts.append(out.text_delta)
                if out.new_token is not None:
                    tokens += 1
                    if req.logprobs and not _lp_skip(out):
                        lp_entries.append(_chat_lp_entry(
                            tok, out.new_token, out.logprob, want_top,
                            out.top_alts))
                if out.finished:
                    finish = out.finish_reason
        return proto.ChatCompletionChoice(
            index=i, message=proto.ChatChoiceMessage(content="".join(parts)),
            finish_reason=finish,
            logprobs=(proto.ChatLogprobs(content=lp_entries)
                      if req.logprobs else None)), tokens

    results, bad = await _run_choices(
        engine, [collect_one(i) for i in range(req.n)])
    if bad is not None:
        return bad
    resp = proto.ChatCompletionResponse(
        id=rid, model=req.model, choices=[c for c, _ in results],
        usage=_usage(len(prompt_ids), sum(t for _, t in results)))
    return web.json_response(resp.model_dump())


def _as_token_lists(tok, raw, what: str = "prompt") -> List[List[int]]:
    """OpenAI `prompt` (or the pooling routes' `input`): str | [str] |
    [int] | [[int]] -> token lists."""
    if isinstance(raw, str):
        return [tok.encode(raw)]
    if not isinstance(raw, list):
        raise ValueError(f"{what} must be str, [str], [int], or [[int]]")
    if raw and all(isinstance(x, int) and not isinstance(x, bool)
                   for x in raw):
        return [list(raw)]
    out: List[List[int]] = []
    for item in raw:
        if isinstance(item, str):
            out.append(tok.encode(item))
        elif isinstance(item, list) and all(
                isinstance(x, int) and not isinstance(x, bool)
                for x in item):
            out.append(list(item))
        else:
            raise ValueError(f"{what} must be str, [str], [int], or "
                             f"[[int]]")
    return out


async def completions(request: web.Request) -> web.StreamResponse:
    engine = request.app[ENGINE_KEY]
    try:
        req = proto.CompletionRequest(**await request.json())
    except (ValidationError, json.JSONDecodeError) as e:
        return _error(400, f"invalid request: {e}")
    options, bad = await _check_request(engine, req, req.max_tokens)
    if bad is not None:
        return bad
    deadline, bad = _deadline_from(request)
    if bad is not None:
        return bad
    if engine.engine.admission_full():
        return _shed_error(engine)
    tok = engine.tokenizer
    prompt = req.prompt
    # cap the choice grid before tokenizing a large batch on the loop
    if (isinstance(prompt, list) and prompt
            and isinstance(prompt[0], (str, list))
            and len(prompt) * req.n > MAX_CHOICES):
        return _error(400, f"len(prompt) * n must be <= {MAX_CHOICES}")
    try:
        prompts = _as_token_lists(tok, prompt)
    except ValueError as e:
        return _error(400, str(e))
    if not prompts or any(not p for p in prompts):
        return _error(400, "prompt must not be (or contain) empty input")
    for pids in prompts:
        bad = _too_long(engine, len(pids))
        if bad is not None:
            return bad
    rid = proto._gen_id("cmpl")
    model = req.model or None
    n_prompt = sum(len(p) for p in prompts)
    want_top = req.logprobs is not None and req.logprobs > 0
    # echo blocks come before any response starts: a failure is a clean
    # error response, not a cut stream
    echo_blocks = []
    if req.echo:
        echo_blocks = await _prompt_echo_blocks(engine, tok, prompts, req)

    if req.stream:
        include_usage = bool(req.stream_options
                             and req.stream_options.include_usage)
        exclude = None if include_usage else {"usage"}

        async def gen():
            num_tokens = 0

            def chunk_for(i, out):
                nonlocal num_tokens
                if out.new_token is not None:
                    num_tokens += 1
                lp_block = None
                if (req.logprobs is not None and out.new_token is not None
                        and not _lp_skip(out)):
                    lp_block = _completion_logprobs(
                        tok, [out.new_token], [out.logprob], want_top,
                        [out.top_alts])
                if out.text_delta or out.finished or lp_block:
                    return proto.CompletionChunk(
                        id=rid, model=req.model,
                        choices=[proto.CompletionChunkChoice(
                            index=i, text=out.text_delta,
                            finish_reason=out.finish_reason
                            if out.finished else None,
                            logprobs=lp_block)]
                    ).model_dump_json(exclude=exclude)
                return None

            echo_chunks = [proto.CompletionChunk(
                id=rid, model=req.model,
                choices=[proto.CompletionChunkChoice(
                    index=p * req.n + j, text=echo_text,
                    logprobs=echo_lp)]
            ).model_dump_json(exclude=exclude)
                for p, (echo_text, echo_lp) in enumerate(echo_blocks)
                for j in range(req.n)]
            async with aclosing(_merged_streams(
                    engine, _choice_jobs(prompts, options, req.n),
                    model, deadline)) as it:
                async for payload in _guarded_payloads(it, echo_chunks,
                                                       chunk_for):
                    yield payload
            if include_usage:
                yield proto.CompletionChunk(
                    id=rid, model=req.model, choices=[],
                    usage=_usage(n_prompt, num_tokens)).model_dump_json()
        return await _sse_stream(request, gen())

    async def collect_one(idx: int, pids, opts):
        parts, ids, lps, alts, tokens, finish = [], [], [], [], 0, None
        async with aclosing(engine.stream(list(pids), opts, model=model,
                                          deadline=deadline)) as it:
            async for out in it:
                _check_overload_finish(out)
                parts.append(out.text_delta)
                if out.new_token is not None:
                    tokens += 1
                    if not _lp_skip(out):
                        ids.append(out.new_token)
                        lps.append(out.logprob)
                        alts.append(out.top_alts)
                if out.finished:
                    finish = out.finish_reason
        lp_block = (_completion_logprobs(tok, ids, lps, want_top, alts)
                    if req.logprobs is not None else None)
        echo_text = ""
        if req.echo:
            echo_text, echo_lp = echo_blocks[idx // req.n]
            if lp_block is not None:
                lp_block = _merge_echo_lp(echo_lp, lp_block)
        return proto.CompletionChoice(
            index=idx, text=echo_text + "".join(parts),
            finish_reason=finish, logprobs=lp_block), tokens

    results, bad = await _run_choices(
        engine, [collect_one(*job)
                 for job in _choice_jobs(prompts, options, req.n)])
    if bad is not None:
        return bad
    resp = proto.CompletionResponse(
        id=rid, model=req.model, choices=[c for c, _ in results],
        usage=_usage(n_prompt, sum(t for _, t in results)))
    return web.json_response(resp.model_dump())


# ---------------------------------------------------------------- pooling

def _check_pool_model(engine: AsyncLLMEngine,
                      model) -> Optional[web.Response]:
    """The pooling routes serve the base model only: they pool the base
    model's hidden states, which no adapter colors. Unknown models 404,
    adapters 400, as the JAX server answers."""
    try:
        adapter_id = engine.engine.resolve_model(model or None)
    except ValueError as e:
        return _error(404, str(e))
    if adapter_id != 0:
        return _error(400, f"model {model!r} is a LoRA adapter; "
                           f"embeddings/rerank/score serve the base "
                           f"model only")
    return None


async def _pooled(engine: AsyncLLMEngine,
                  token_lists: List[List[int]]) -> np.ndarray:
    """The pooled vectors [n, H] of non-empty token lists within the
    embedding length cap, computed in an executor (the forward blocks
    until the card is done) beside the engine loop."""
    max_len = engine.engine.max_embed_len
    for toks in token_lists:
        if not toks:
            raise ValueError("empty input")
        if len(toks) > max_len:
            raise ValueError(f"input has {len(toks)} tokens, which "
                             f"exceeds the embedding length cap {max_len}")
    return await asyncio.get_running_loop().run_in_executor(
        None, engine.engine.embed_tokens, token_lists)


def _cosine(a: np.ndarray, b: np.ndarray) -> float:
    num = float(np.dot(a, b))
    den = float(np.linalg.norm(a) * np.linalg.norm(b)) or 1e-12
    return num / den


async def _pool_body(request: web.Request):
    """(engine, JSON body, None) or (.., .., the error response of an
    unknown model)."""
    engine = request.app[ENGINE_KEY]
    body = await request.json()
    return engine, body, _check_pool_model(engine, body.get("model"))


async def embeddings(request: web.Request) -> web.Response:
    """OpenAI /v1/embeddings: one vector per input, the mean of the
    serving model's final hidden states over the input's tokens
    (``embedding_source`` says so: an approximation of an embedding
    model whose quality nothing here validates)."""
    try:
        engine, body, bad = await _pool_body(request)
        if bad is not None:
            return bad
        tok = engine.engine.embedding_tokenizer
        token_lists = _as_token_lists(tok, body.get("input"), "input")
        if not token_lists:
            return _error(400, "missing 'input'")
        vecs = await _pooled(engine, token_lists)
    except (ValueError, TypeError, json.JSONDecodeError) as e:
        return _error(400, f"invalid request: {e}")
    n_tokens = sum(len(t) for t in token_lists)
    return web.json_response({
        "object": "list",
        "model": body.get("model") or engine.engine.cfg.model,
        "embedding_source": engine.engine.embedding_source,
        "data": [{"object": "embedding", "index": i,
                  "embedding": vec.tolist()}
                 for i, vec in enumerate(vecs)],
        "usage": {"prompt_tokens": n_tokens, "total_tokens": n_tokens},
    })


async def rerank(request: web.Request) -> web.Response:
    """/v1/rerank and /v2/rerank: the documents ordered by the cosine
    of their pooled vectors with the query's (top_n keeps the first)."""
    try:
        engine, body, bad = await _pool_body(request)
        if bad is not None:
            return bad
        query, docs = body.get("query"), body.get("documents")
        if not isinstance(query, str) or not isinstance(docs, list) \
                or not docs or not all(isinstance(d, str) for d in docs):
            return _error(400, "need 'query' (str) and 'documents' "
                               "(non-empty list of str)")
        token_lists = _as_token_lists(engine.engine.embedding_tokenizer,
                                      [query] + docs, "input")
        vecs = await _pooled(engine, token_lists)
    except (ValueError, TypeError, json.JSONDecodeError) as e:
        return _error(400, f"invalid request: {e}")
    q = vecs[0]
    scored = sorted(
        ({"index": i, "document": {"text": d},
          "relevance_score": _cosine(q, v)}
         for i, (d, v) in enumerate(zip(docs, vecs[1:]))),
        key=lambda r: r["relevance_score"], reverse=True)
    top_n = body.get("top_n")
    if isinstance(top_n, int) and top_n > 0:
        scored = scored[:top_n]
    return web.json_response({
        "id": proto._gen_id("rerank"),
        "model": body.get("model") or engine.engine.cfg.model,
        "results": scored,
        "usage": {"total_tokens": sum(len(t) for t in token_lists)},
    })


async def score(request: web.Request) -> web.Response:
    """/v1/score: the cosine of text_1's pooled vector with each
    text_2 entry's."""
    try:
        engine, body, bad = await _pool_body(request)
        if bad is not None:
            return bad
        t1, t2 = body.get("text_1"), body.get("text_2")
        texts = [t2] if isinstance(t2, str) else t2
        if not isinstance(t1, str) or not isinstance(texts, list) \
                or not texts or not all(isinstance(x, str) for x in texts):
            return _error(400, "need 'text_1' (str) and 'text_2' "
                               "(str or non-empty list of str)")
        token_lists = _as_token_lists(engine.engine.embedding_tokenizer,
                                      [t1] + texts, "input")
        vecs = await _pooled(engine, token_lists)
    except (ValueError, TypeError, json.JSONDecodeError) as e:
        return _error(400, f"invalid request: {e}")
    return web.json_response({
        "id": proto._gen_id("score"),
        "model": body.get("model") or engine.engine.cfg.model,
        "data": [{"index": i, "score": _cosine(vecs[0], v)}
                 for i, v in enumerate(vecs[1:])],
        "usage": {"total_tokens": sum(len(t) for t in token_lists)},
    })


# ------------------------------------------------------------------ misc

async def list_models(request: web.Request) -> web.Response:
    """The base model, then every adapter with the base as its root and
    parent."""
    engine = request.app[ENGINE_KEY]
    served = engine.engine.served_models
    base = served[0]
    cards = proto.ModelList(data=[
        proto.ModelCard(id=name, root=base if i else None,
                        parent=base if i else None)
        for i, name in enumerate(served)])
    return web.json_response(cards.model_dump())


async def health(request: web.Request) -> web.Response:
    engine = request.app[ENGINE_KEY]
    if engine.failure is not None:
        return web.json_response(
            {"status": "failed", "error": repr(engine.failure)},
            status=503)
    return web.json_response({"status": "ok"})


async def load(request: web.Request) -> web.Response:
    """The engine's load report (queue depth, running sequences, free
    KV blocks, estimated queue delay, advertised capacity, efficiency
    and pool census), lock-free: it answers while a step holds the
    engine lock."""
    engine = request.app[ENGINE_KEY]
    return web.json_response(engine.engine.load_report())


async def version(request: web.Request) -> web.Response:
    return web.json_response({"version": __version__})


async def metrics(request: web.Request) -> web.Response:
    engine = request.app[ENGINE_KEY]
    return web.Response(body=engine.engine.render_metrics(),
                        content_type="text/plain")


async def _admin_body(request: web.Request) -> dict:
    try:
        body = await request.json()
    except Exception:
        body = {}
    return body if isinstance(body, dict) else {}


async def admin_kvplane_migrate_out(request: web.Request) -> web.Response:
    """kvplane planner entry point: publish victim sequences' chunks to
    the tiers and preempt them (body: {"max_seqs": n, "target_blocks":
    n}); 409 with an "error" field where the engine has no producer
    role."""
    engine = request.app[ENGINE_KEY]
    body = await _admin_body(request)
    max_seqs = int(body.get("max_seqs", 2))
    target_blocks = int(body.get("target_blocks", 0))
    # takes the engine lock, then flushes the KV writer: off the loop
    result = await asyncio.to_thread(
        engine.engine.migrate_out, max_seqs=max_seqs,
        target_blocks=target_blocks)
    return web.json_response(result, status=409 if "error" in result
                             else 200)


async def admin_kvplane_warm(request: web.Request) -> web.Response:
    """kvplane planner destination side: pull the named chunk keys
    through the tiers so the fastest one holds them (body: {"keys":
    ["<hex>", ...]})."""
    engine = request.app[ENGINE_KEY]
    body = await _admin_body(request)
    keys = body.get("keys") or []
    if not isinstance(keys, list):
        return _error(400, "keys must be a list of hex strings")
    result = await asyncio.to_thread(engine.engine.warm_chunks, keys)
    return web.json_response(result)


async def admin_lora_load(request: web.Request) -> web.Response:
    """Load a LoRA adapter at runtime and serve it as its own model id.
    Body: {"name": "sql-adapter", "src": "random:7" | "/path.npz"}. A
    failed load (bad source, no memory for the restack) answers 503 +
    Retry-After: a shed, never a breaker signal, since the engine serves
    its other models on. A reload answers 200 with loaded false."""
    engine = request.app[ENGINE_KEY]
    body = await _admin_body(request)
    name = str(body.get("name") or "").strip()
    src = str(body.get("src") or "").strip()
    if not name or not src:
        return _error(400, "adapter load needs {'name': ..., 'src': "
                           "'random:SEED' or '/path/to/adapter.npz'}")
    try:
        # the restack holds the engine lock: off the event loop
        loaded = await asyncio.to_thread(
            engine.engine.load_adapter, name, src)
    except Exception as e:
        logger.warning("adapter load %s from %s failed: %s", name, src, e)
        resp = _error(503, f"adapter {name!r} failed to load: {e}; "
                           f"the engine is healthy and still serving "
                           f"its current models — retry later",
                      err_type="overloaded_error")
        resp.headers["Retry-After"] = "5"
        return resp
    return web.json_response({
        "loaded": loaded, "name": name,
        "models": list(engine.engine.served_models)})


async def admin_lora_evict(request: web.Request) -> web.Response:
    """Stop serving adapter ``name`` (body: {"name": ...}); an adapter
    that is not served answers 404. Its row is tombstoned, so in-flight
    requests on it finish."""
    engine = request.app[ENGINE_KEY]
    body = await _admin_body(request)
    name = str(body.get("name") or "").strip()
    if not name:
        return _error(400, "adapter evict needs {'name': ...}")
    try:
        await asyncio.to_thread(engine.engine.evict_adapter, name)
    except KeyError as e:
        return _error(404, str(e.args[0]) if e.args else
                      f"adapter {name!r} is not loaded",
                      err_type="not_found_error")
    return web.json_response({
        "evicted": name, "models": list(engine.engine.served_models)})


async def tokenize(request: web.Request) -> web.Response:
    engine = request.app[ENGINE_KEY]
    body = await request.json()
    ids = engine.tokenizer.encode(body.get("prompt", ""))
    return web.json_response({"tokens": ids, "count": len(ids)})


async def detokenize(request: web.Request) -> web.Response:
    engine = request.app[ENGINE_KEY]
    body = await request.json()
    return web.json_response(
        {"prompt": engine.tokenizer.decode(body.get("tokens", []))})


def build_app(engine: AsyncLLMEngine) -> web.Application:
    @web.middleware
    async def stamp_load_headers(request: web.Request, handler):
        # every reply carries the engine's load (SSE streams take theirs
        # when they are prepared, in _sse_stream)
        resp = await handler(request)
        if not resp.prepared:
            for k, v in _load_headers(engine).items():
                resp.headers[k] = v
        return resp

    app = web.Application(client_max_size=32 * 1024 * 1024,
                          middlewares=[stamp_load_headers])
    app[ENGINE_KEY] = engine
    app.router.add_post("/v1/chat/completions", chat_completions)
    app.router.add_post("/v1/completions", completions)
    app.router.add_get("/v1/models", list_models)
    app.router.add_get("/health", health)
    app.router.add_get("/load", load)
    app.router.add_get("/version", version)
    app.router.add_get("/metrics", metrics)
    app.router.add_post("/tokenize", tokenize)
    app.router.add_post("/detokenize", detokenize)
    app.router.add_post("/v1/embeddings", embeddings)
    app.router.add_post("/v1/rerank", rerank)
    app.router.add_post("/v2/rerank", rerank)
    app.router.add_post("/v1/score", score)
    app.router.add_post("/admin/kvplane/migrate_out",
                        admin_kvplane_migrate_out)
    app.router.add_post("/admin/kvplane/warm", admin_kvplane_warm)
    app.router.add_post("/admin/lora/load", admin_lora_load)
    app.router.add_post("/admin/lora/evict", admin_lora_evict)

    async def on_startup(app):
        # warmup (if any) ran before the loop started
        engine.start(asyncio.get_running_loop(), warmup=False)

    async def on_cleanup(app):
        engine.stop()
        # flush the queued KV-tier saves and close the tier sockets
        engine.engine.close()

    app.on_startup.append(on_startup)
    app.on_cleanup.append(on_cleanup)
    return app


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        "pstpu-torch-engine",
        description="OpenAI-compatible serving engine, PyTorch + CUDA")
    p.add_argument("--model", default="debug-tiny")
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--checkpoint", default=None,
                   help="HF checkpoint dir (*.safetensors or *.bin; random "
                        "weights if omitted); --model names the same dir "
                        "or a preset of the same widths")
    p.add_argument("--chat-template", default=None,
                   help="Jinja file overriding the tokenizer chat template")
    p.add_argument("--device", default="cuda",
                   help="cuda (the hand-written kernels) or cpu (their "
                        "plain PyTorch versions)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8100)
    p.add_argument("--max-model-len", type=int, default=2048)
    p.add_argument("--dtype", choices=["bfloat16", "float32"],
                   default="bfloat16")
    p.add_argument("--kv-cache-dtype", choices=["bfloat16", "float32",
                                                "int8"],
                   default="bfloat16",
                   help="KV cache precision; int8 stores per-(token, "
                        "head)-scaled int8 blocks, read by the paged "
                        "kernels' int8 branches (models/kv.py)")
    p.add_argument("--quantization", choices=["int8"], default=None,
                   help="weight-only int8: projections, embedding and LM "
                        "head stored int8 with per-channel scales; norms "
                        "stay in --dtype (models/quant.py)")
    p.add_argument("--moe-capacity-factor", type=float, default=None,
                   help="MoE prefill capacity factor (ops/moe.py): >= "
                        "num_experts/top_k disables token dropping at "
                        "dense-compute cost; default keeps the model "
                        "family value")
    p.add_argument("--max-num-seqs", type=int, default=8)
    p.add_argument("--max-waiting-seqs", type=int, default=None,
                   help="bounded admission: shed (503 + Retry-After) "
                        "once this many sequences wait beyond the free "
                        "slots (default unbounded)")
    p.add_argument("--max-queue-delay-ms", type=float, default=None,
                   help="shed (503) a request still waiting after this "
                        "long (default never)")
    p.add_argument("--prefill-chunk", type=int, default=512)
    p.add_argument("--decode-window", type=int, default=8,
                   help="tokens per decode window (one host sync each)")
    p.add_argument("--kv-len-buckets", default=None,
                   help="comma-separated attention-length buckets")
    p.add_argument("--kv-block-size", type=int, default=64)
    p.add_argument("--kv-pool-tokens", type=int, default=None)
    p.add_argument("--enable-prefix-caching", action="store_true")
    p.add_argument("--speculative-ngram-tokens", type=int, default=0,
                   help="n-gram (prompt-lookup) speculative decoding: "
                        "draft length per macro-step (0 = off); eligible "
                        "rows (greedy, unguided, unshaped, no "
                        "top_logprobs) speculate, the others single-step "
                        "in the same window")
    p.add_argument("--hbm-peak-gbps", type=float, default=3350.0,
                   help="device-memory peak the MBU gauge normalizes "
                        "against (GB/s; default an H100 SXM's)")
    p.add_argument("--lora-adapters", default=None,
                   help="comma-separated name=source pairs; source is an "
                        ".npz adapter checkpoint (models/lora.py) or "
                        "random:SEED. Each adapter is served as its own "
                        "model id")
    p.add_argument("--lora-rank", type=int, default=8)
    p.add_argument("--lora-alpha", type=float, default=16.0)
    p.add_argument("--lora-targets", default="q,v",
                   help="comma-separated projections to adapt "
                        "(q,k,v,o,gate,up,down)")
    p.add_argument("--kv-transfer-config", default=None,
                   help="JSON dict enabling KV tiering, e.g. "
                        '\'{"kv_role": "kv_both", "local_cpu_gb": 4, '
                        '"remote_url": "tpukv://cache:8100"}\' '
                        "(kvcache/connector.py)")
    p.add_argument("--no-kvplane-defrag", action="store_true",
                   help="disable the free-list defrag the engine runs "
                        "after fragmented allocation failures")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-warmup", action="store_true")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    engine = AsyncLLMEngine(EngineConfig(
        model=args.model, tokenizer=args.tokenizer,
        chat_template=args.chat_template, device=args.device,
        max_model_len=args.max_model_len, dtype=args.dtype,
        kv_dtype=args.kv_cache_dtype, quantization=args.quantization,
        moe_capacity_factor=args.moe_capacity_factor,
        max_num_seqs=args.max_num_seqs,
        max_waiting_seqs=args.max_waiting_seqs,
        max_queue_delay_ms=args.max_queue_delay_ms,
        prefill_chunk=args.prefill_chunk, decode_window=args.decode_window,
        kv_len_buckets=tuple(int(x) for x in args.kv_len_buckets.split(","))
        if args.kv_len_buckets else (),
        kv_block_size=args.kv_block_size, kv_pool_tokens=args.kv_pool_tokens,
        enable_prefix_caching=args.enable_prefix_caching,
        kv_transfer_config=json.loads(args.kv_transfer_config)
        if args.kv_transfer_config else None,
        kvplane_defrag=not args.no_kvplane_defrag,
        speculative_ngram_tokens=args.speculative_ngram_tokens,
        hbm_peak_gbps=args.hbm_peak_gbps, seed=args.seed,
        checkpoint=args.checkpoint,
        lora_adapters=dict(pair.split("=", 1)
                           for pair in args.lora_adapters.split(","))
        if args.lora_adapters else None,
        lora_rank=args.lora_rank, lora_alpha=args.lora_alpha,
        lora_targets=tuple(args.lora_targets.split(","))))
    if not args.no_warmup:
        engine.engine.runner.warmup()
    logger.info("engine serving %s on %s:%d (%s)", args.model, args.host,
                args.port, args.device)
    web.run_app(build_app(engine), host=args.host, port=args.port,
                handler_cancellation=True)


if __name__ == "__main__":
    main()
