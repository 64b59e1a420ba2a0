"""OpenAI-compatible HTTP server for the PyTorch engine (aiohttp)
(``production_stack_tpu/engine/server.py``, the main path only).

Endpoints: ``/health``, ``/v1/models``, ``/v1/completions`` and
``/v1/chat/completions``, streamed (SSE) or not. A request that sets a
field the port does not implement yet — guided decoding, penalties,
logit_bias, min_tokens, top or prompt logprobs, n > 1, several prompts
in one request, a LoRA model id — is answered 400 with the field's
name; nothing is silently ignored. A failed engine step answers 500 and
turns /health to 503 (engine/async_engine.py).

    python -m production_stack_tpu_torch.engine.server --model llama-3-8b

runs on the card; ``--device cpu`` runs the plain PyTorch path.
"""

import argparse
import asyncio
import json
from contextlib import aclosing
from typing import List, Optional

from aiohttp import web
from pydantic import ValidationError

from production_stack_tpu_torch import protocol as proto
from production_stack_tpu_torch.engine.async_engine import (AsyncLLMEngine,
                                                            EngineDeadError)
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import unsupported_options
from production_stack_tpu_torch.engine.scheduler import SamplingOptions
from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)

ENGINE_KEY = web.AppKey("engine", AsyncLLMEngine)


def _error(status: int, message: str,
           err_type: str = "invalid_request_error") -> web.Response:
    body = proto.ErrorResponse(
        error=proto.ErrorInfo(message=message, type=err_type, code=status))
    return web.json_response(body.model_dump(), status=status)


def _dead(e: EngineDeadError) -> web.Response:
    return _error(500, str(e), err_type="internal_error")


def _unsupported_fields(req) -> List[str]:
    """Request fields set to something the port does not implement."""
    bad = [name for name in ("guided_regex", "guided_choice", "guided_json")
           if getattr(req, name, None) is not None]
    rf = getattr(req, "response_format", None)
    if rf and rf.get("type") not in (None, "text"):
        bad.append("response_format")
    if req.n != 1:
        bad.append("n")
    tl = getattr(req, "top_logprobs", None)
    if tl:
        bad.append("top_logprobs")
    lp = getattr(req, "logprobs", None)
    if isinstance(lp, int) and not isinstance(lp, bool) and lp > 0:
        bad.append("logprobs")   # legacy completions: top-N alternatives
    if getattr(req, "echo", False) and lp is not None:
        bad.append("echo")       # prompt logprobs
    return bad


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
        logit_bias=req.logit_bias or None)


def _check_request(engine: AsyncLLMEngine, req, max_tokens):
    """(SamplingOptions, None) or (None, error response)."""
    try:
        engine.engine.resolve_model(req.model or None)
    except ValueError as e:
        return None, _error(400, f"model: {e}")
    options = _sampling_options(req, max_tokens)
    bad = _unsupported_fields(req) + unsupported_options(options)
    if bad:
        return None, _error(400, f"not implemented in the PyTorch port "
                                 f"yet: {', '.join(bad)}")
    if not 0.0 <= options.min_p <= 1.0:
        return None, _error(400, f"min_p must be in [0, 1] "
                                 f"(got {options.min_p})")
    return options, None


def _too_long(engine: AsyncLLMEngine, n: int) -> Optional[web.Response]:
    limit = engine.engine.cfg.max_model_len
    if n >= limit:
        return _error(400, f"prompt has {n} tokens, which exceeds "
                           f"max_model_len {limit}")
    return None


async def _sse_stream(request: web.Request, gen) -> web.StreamResponse:
    """Relay an SSE generator. The 200 goes out with the first payload,
    so a failure before it becomes a clean error response; one after it
    can only close the connection."""
    resp: Optional[web.StreamResponse] = None
    try:
        async for payload in gen:
            if resp is None:
                resp = web.StreamResponse(status=200, headers={
                    "Content-Type": "text/event-stream",
                    "Cache-Control": "no-cache"})
                await resp.prepare(request)
            await resp.write(f"data: {payload}\n\n".encode())
        if resp is None:
            resp = web.StreamResponse(status=200, headers={
                "Content-Type": "text/event-stream"})
            await resp.prepare(request)
        await resp.write(b"data: [DONE]\n\n")
        await resp.write_eof()
    except (ConnectionResetError, ConnectionError):
        await gen.aclose()
        if resp is None:
            resp = web.Response(status=500)   # never reaches the client
    except EngineDeadError as e:
        await gen.aclose()
        if resp is None:
            return _dead(e)
        resp.force_close()
    return resp


async def _collect(engine: AsyncLLMEngine, prompt_ids: List[int],
                   options: SamplingOptions, model: Optional[str]):
    """Run one request to its end: (text, token ids, logprobs,
    finish_reason). A stop token is excluded from text and logprobs."""
    parts, ids, lps, finish = [], [], [], None
    async with aclosing(engine.stream(list(prompt_ids), options,
                                      model=model)) as it:
        async for out in it:
            parts.append(out.text_delta)
            if out.new_token is not None and not (
                    out.finished and out.finish_reason == "stop"):
                ids.append(out.new_token)
                lps.append(out.logprob)
            if out.finished:
                finish = out.finish_reason
    return "".join(parts), ids, lps, finish


def _usage(prompt_tokens: int, completion_tokens: int) -> proto.UsageInfo:
    return proto.UsageInfo(prompt_tokens=prompt_tokens,
                           completion_tokens=completion_tokens,
                           total_tokens=prompt_tokens + completion_tokens)


async def chat_completions(request: web.Request) -> web.StreamResponse:
    engine = request.app[ENGINE_KEY]
    try:
        req = proto.ChatCompletionRequest(**await request.json())
    except (ValidationError, json.JSONDecodeError) as e:
        return _error(400, f"invalid request: {e}")
    options, bad = _check_request(
        engine, req, req.max_completion_tokens or req.max_tokens)
    if bad is not None:
        return bad
    tok = engine.tokenizer
    prompt_ids = tok.encode(tok.apply_chat_template(
        [m.model_dump() for m in req.messages]))
    bad = _too_long(engine, len(prompt_ids))
    if bad is not None:
        return bad
    rid = proto._gen_id("chatcmpl")
    model = req.model or None

    def lp_block(token_ids, logprobs):
        if not req.logprobs:
            return None
        entries = []
        for t, lp in zip(token_ids, logprobs):
            text, raw = tok.id_to_token(t)
            entries.append(proto.ChatLogprobToken(
                token=text, logprob=lp if lp is not None else 0.0,
                bytes=raw))
        return proto.ChatLogprobs(content=entries)

    if req.stream:
        include_usage = bool(req.stream_options
                             and req.stream_options.include_usage)
        exclude = None if include_usage else {"usage"}

        async def gen():
            yield proto.ChatCompletionChunk(
                id=rid, model=req.model,
                choices=[proto.ChatCompletionChunkChoice(
                    delta=proto.DeltaMessage(role="assistant",
                                             content=""))]
            ).model_dump_json(exclude=exclude)
            n = 0
            async with aclosing(engine.stream(prompt_ids, options,
                                              model=model)) as it:
                async for out in it:
                    n += out.new_token is not None
                    stop = out.finished and out.finish_reason == "stop"
                    lps = (lp_block([out.new_token], [out.logprob])
                           if out.new_token is not None and not stop
                           else None)
                    if out.text_delta or out.finished or lps:
                        yield proto.ChatCompletionChunk(
                            id=rid, model=req.model,
                            choices=[proto.ChatCompletionChunkChoice(
                                delta=proto.DeltaMessage(
                                    content=out.text_delta or None),
                                finish_reason=out.finish_reason
                                if out.finished else None,
                                logprobs=lps)]
                        ).model_dump_json(exclude=exclude)
            if include_usage:
                yield proto.ChatCompletionChunk(
                    id=rid, model=req.model, choices=[],
                    usage=_usage(len(prompt_ids), n)).model_dump_json()
        return await _sse_stream(request, gen())

    try:
        text, ids, lps, finish = await _collect(engine, prompt_ids,
                                                options, model)
    except EngineDeadError as e:
        return _dead(e)
    n = len(ids) + (finish == "stop")
    resp = proto.ChatCompletionResponse(
        id=rid, model=req.model,
        choices=[proto.ChatCompletionChoice(
            message=proto.ChatChoiceMessage(content=text),
            finish_reason=finish, logprobs=lp_block(ids, lps))],
        usage=_usage(len(prompt_ids), n))
    return web.json_response(resp.model_dump())


def _prompt_ids(tok, raw) -> List[int]:
    """One prompt: a string, a token-id list, or a one-element list of
    either. Several prompts per request are not implemented yet."""
    if isinstance(raw, list) and len(raw) == 1 and isinstance(
            raw[0], (str, list)):
        raw = raw[0]
    if isinstance(raw, str):
        return tok.encode(raw)
    if isinstance(raw, list) and raw and all(
            isinstance(x, int) and not isinstance(x, bool) for x in raw):
        return list(raw)
    raise ValueError("prompt: one string or one token-id list per request "
                     "(several prompts are not implemented in the PyTorch "
                     "port yet)")


async def completions(request: web.Request) -> web.StreamResponse:
    engine = request.app[ENGINE_KEY]
    try:
        req = proto.CompletionRequest(**await request.json())
    except (ValidationError, json.JSONDecodeError) as e:
        return _error(400, f"invalid request: {e}")
    options, bad = _check_request(engine, req, req.max_tokens)
    if bad is not None:
        return bad
    tok = engine.tokenizer
    try:
        prompt_ids = _prompt_ids(tok, req.prompt)
    except ValueError as e:
        return _error(400, str(e))
    bad = _too_long(engine, len(prompt_ids))
    if bad is not None:
        return bad
    rid = proto._gen_id("cmpl")
    model = req.model or None
    echo = tok.decode(prompt_ids) if req.echo else ""

    def lp_block(token_ids, logprobs):
        if req.logprobs is None:
            return None
        return proto.CompletionLogprobs(
            tokens=[tok.id_to_token(t)[0] for t in token_ids],
            token_logprobs=[lp if lp is not None else 0.0
                            for lp in logprobs])

    if req.stream:
        include_usage = bool(req.stream_options
                             and req.stream_options.include_usage)
        exclude = None if include_usage else {"usage"}

        async def gen():
            if echo:
                yield proto.CompletionChunk(
                    id=rid, model=req.model,
                    choices=[proto.CompletionChunkChoice(text=echo)]
                ).model_dump_json(exclude=exclude)
            n = 0
            async with aclosing(engine.stream(prompt_ids, options,
                                              model=model)) as it:
                async for out in it:
                    n += out.new_token is not None
                    stop = out.finished and out.finish_reason == "stop"
                    lps = (lp_block([out.new_token], [out.logprob])
                           if out.new_token is not None and not stop
                           else None)
                    if out.text_delta or out.finished or lps:
                        yield proto.CompletionChunk(
                            id=rid, model=req.model,
                            choices=[proto.CompletionChunkChoice(
                                text=out.text_delta,
                                finish_reason=out.finish_reason
                                if out.finished else None,
                                logprobs=lps)]
                        ).model_dump_json(exclude=exclude)
            if include_usage:
                yield proto.CompletionChunk(
                    id=rid, model=req.model, choices=[],
                    usage=_usage(len(prompt_ids), n)).model_dump_json()
        return await _sse_stream(request, gen())

    try:
        text, ids, lps, finish = await _collect(engine, prompt_ids,
                                                options, model)
    except EngineDeadError as e:
        return _dead(e)
    n = len(ids) + (finish == "stop")
    resp = proto.CompletionResponse(
        id=rid, model=req.model,
        choices=[proto.CompletionChoice(text=echo + text,
                                        finish_reason=finish,
                                        logprobs=lp_block(ids, lps))],
        usage=_usage(len(prompt_ids), n))
    return web.json_response(resp.model_dump())


async def list_models(request: web.Request) -> web.Response:
    engine = request.app[ENGINE_KEY]
    cards = proto.ModelList(data=[proto.ModelCard(id=name) for name in
                                  engine.engine.served_models])
    return web.json_response(cards.model_dump())


async def health(request: web.Request) -> web.Response:
    engine = request.app[ENGINE_KEY]
    if engine.failure is not None:
        return web.json_response(
            {"status": "failed", "error": repr(engine.failure)},
            status=503)
    return web.json_response({"status": "ok"})


def build_app(engine: AsyncLLMEngine) -> web.Application:
    app = web.Application(client_max_size=32 * 1024 * 1024)
    app[ENGINE_KEY] = engine
    app.router.add_post("/v1/chat/completions", chat_completions)
    app.router.add_post("/v1/completions", completions)
    app.router.add_get("/v1/models", list_models)
    app.router.add_get("/health", health)

    async def on_startup(app):
        # warmup (if any) ran before the loop started
        engine.start(asyncio.get_running_loop(), warmup=False)

    async def on_cleanup(app):
        engine.stop()

    app.on_startup.append(on_startup)
    app.on_cleanup.append(on_cleanup)
    return app


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        "pstpu-torch-engine",
        description="OpenAI-compatible serving engine, PyTorch + CUDA")
    p.add_argument("--model", default="debug-tiny")
    p.add_argument("--tokenizer", default=None)
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
    p.add_argument("--max-num-seqs", type=int, default=8)
    p.add_argument("--prefill-chunk", type=int, default=512)
    p.add_argument("--decode-window", type=int, default=8,
                   help="tokens per decode window (one host sync each)")
    p.add_argument("--kv-len-buckets", default=None,
                   help="comma-separated attention-length buckets")
    p.add_argument("--kv-block-size", type=int, default=64)
    p.add_argument("--kv-pool-tokens", type=int, default=None)
    p.add_argument("--enable-prefix-caching", action="store_true")
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
        max_num_seqs=args.max_num_seqs,
        prefill_chunk=args.prefill_chunk, decode_window=args.decode_window,
        kv_len_buckets=tuple(int(x) for x in args.kv_len_buckets.split(","))
        if args.kv_len_buckets else (),
        kv_block_size=args.kv_block_size, kv_pool_tokens=args.kv_pool_tokens,
        enable_prefix_caching=args.enable_prefix_caching, seed=args.seed))
    if not args.no_warmup:
        engine.engine.runner.warmup()
    logger.info("engine serving %s on %s:%d (%s)", args.model, args.host,
                args.port, args.device)
    web.run_app(build_app(engine), host=args.host, port=args.port,
                handler_cancellation=True)


if __name__ == "__main__":
    main()
