"""OpenAI-compatible API protocol models (pydantic v2).

A copy of ``production_stack_tpu/protocol.py`` (the port imports nothing
of the JAX package).

Shared by the engine server and the router. Extra fields are tolerated
everywhere (parity with the reference's extra-field-tolerant
OpenAIBaseModel, reference: src/vllm_router/protocols.py) so newer client
SDKs never break the stack.
"""

import time
import uuid
from typing import Any, Dict, List, Literal, Optional, Union

from pydantic import BaseModel, ConfigDict, Field


class OpenAIBase(BaseModel):
    model_config = ConfigDict(extra="allow")


def _gen_id(prefix: str) -> str:
    return f"{prefix}-{uuid.uuid4().hex[:24]}"


def _now() -> int:
    return int(time.time())


# ---------------------------------------------------------------- requests

class CompletionRequest(OpenAIBase):
    model: str
    prompt: Union[str, List[str], List[int], List[List[int]]] = ""
    max_tokens: Optional[int] = 16
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0                      # vLLM extension
    n: int = 1
    stream: bool = False
    stream_options: Optional["StreamOptions"] = None
    stop: Optional[Union[str, List[str]]] = None
    stop_token_ids: Optional[List[int]] = None  # vLLM extension
    ignore_eos: bool = False            # vLLM extension
    echo: bool = False
    logprobs: Optional[int] = None      # legacy: N requests logprobs
    seed: Optional[int] = None
    # vLLM guided-decoding extensions (engine/guided.py)
    guided_regex: Optional[str] = None
    guided_choice: Optional[List[str]] = None
    guided_json: Optional[Union[str, dict]] = None
    # OpenAI structured outputs: {"type": "json_schema", "json_schema":
    # {...}} maps onto guided_json; "json_object" is rejected (DFA)
    response_format: Optional[Dict[str, Any]] = None
    # OpenAI logit shaping + vLLM extensions (engine/sampler.py)
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    repetition_penalty: float = 1.0    # vLLM extension (HF semantics)
    min_p: float = 0.0                 # vLLM extension
    min_tokens: int = 0                # vLLM extension
    priority: int = 0                  # vLLM extension (lower = sooner)
    logit_bias: Optional[Dict[str, float]] = None
    user: Optional[str] = None


class ChatMessage(OpenAIBase):
    role: str
    content: Optional[Union[str, List[Dict[str, Any]]]] = ""


class StreamOptions(OpenAIBase):
    include_usage: bool = False


class ChatCompletionRequest(OpenAIBase):
    model: str
    messages: List[ChatMessage]
    max_tokens: Optional[int] = None
    max_completion_tokens: Optional[int] = None
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0
    n: int = 1
    stream: bool = False
    stream_options: Optional[StreamOptions] = None
    stop: Optional[Union[str, List[str]]] = None
    stop_token_ids: Optional[List[int]] = None
    ignore_eos: bool = False
    logprobs: Optional[bool] = False
    top_logprobs: Optional[int] = None
    seed: Optional[int] = None
    # vLLM guided-decoding extensions (engine/guided.py)
    guided_regex: Optional[str] = None
    guided_choice: Optional[List[str]] = None
    guided_json: Optional[Union[str, dict]] = None
    # OpenAI structured outputs: {"type": "json_schema", "json_schema":
    # {...}} maps onto guided_json; "json_object" is rejected (DFA)
    response_format: Optional[Dict[str, Any]] = None
    # OpenAI logit shaping + vLLM extensions (engine/sampler.py)
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    repetition_penalty: float = 1.0    # vLLM extension (HF semantics)
    min_p: float = 0.0                 # vLLM extension
    min_tokens: int = 0                # vLLM extension
    priority: int = 0                  # vLLM extension (lower = sooner)
    logit_bias: Optional[Dict[str, float]] = None
    user: Optional[str] = None


# ---------------------------------------------------------------- responses

class UsageInfo(OpenAIBase):
    prompt_tokens: int = 0
    completion_tokens: int = 0
    total_tokens: int = 0


class CompletionLogprobs(OpenAIBase):
    """Legacy completions logprobs block. logprobs=N returns the N
    highest-probability alternatives per position, computed on-device
    next to the chosen token's logprob. Both report the PRE-temperature,
    POST-shaping distribution: for requests without penalties/
    logit_bias/guided constraints that is the raw model distribution;
    shaped requests report the distribution they were actually decoded
    from (engine/runner.py). Paths without alternatives fall back to
    the chosen token's entry."""
    tokens: List[str] = Field(default_factory=list)
    token_logprobs: List[Optional[float]] = Field(default_factory=list)
    top_logprobs: Optional[List[Optional[Dict[str, float]]]] = None
    text_offset: Optional[List[int]] = None


class CompletionChoice(OpenAIBase):
    index: int = 0
    text: str = ""
    finish_reason: Optional[str] = None
    logprobs: Optional[CompletionLogprobs] = None


class CompletionResponse(OpenAIBase):
    id: str = Field(default_factory=lambda: _gen_id("cmpl"))
    object: Literal["text_completion"] = "text_completion"
    created: int = Field(default_factory=_now)
    model: str = ""
    choices: List[CompletionChoice] = Field(default_factory=list)
    usage: UsageInfo = Field(default_factory=UsageInfo)


class ChatChoiceMessage(OpenAIBase):
    role: str = "assistant"
    content: Optional[str] = None


class ChatLogprobTop(OpenAIBase):
    token: str = ""
    logprob: float = 0.0
    bytes: Optional[List[int]] = None


class ChatLogprobToken(OpenAIBase):
    token: str = ""
    logprob: float = 0.0
    bytes: Optional[List[int]] = None
    top_logprobs: List[ChatLogprobTop] = Field(default_factory=list)


class ChatLogprobs(OpenAIBase):
    content: Optional[List[ChatLogprobToken]] = None


class ChatCompletionChoice(OpenAIBase):
    index: int = 0
    message: ChatChoiceMessage = Field(default_factory=ChatChoiceMessage)
    finish_reason: Optional[str] = None
    logprobs: Optional[ChatLogprobs] = None


class ChatCompletionResponse(OpenAIBase):
    id: str = Field(default_factory=lambda: _gen_id("chatcmpl"))
    object: Literal["chat.completion"] = "chat.completion"
    created: int = Field(default_factory=_now)
    model: str = ""
    choices: List[ChatCompletionChoice] = Field(default_factory=list)
    usage: UsageInfo = Field(default_factory=UsageInfo)


class DeltaMessage(OpenAIBase):
    role: Optional[str] = None
    content: Optional[str] = None


class ChatCompletionChunkChoice(OpenAIBase):
    index: int = 0
    delta: DeltaMessage = Field(default_factory=DeltaMessage)
    finish_reason: Optional[str] = None
    logprobs: Optional[ChatLogprobs] = None


class ChatCompletionChunk(OpenAIBase):
    id: str = ""
    object: Literal["chat.completion.chunk"] = "chat.completion.chunk"
    created: int = Field(default_factory=_now)
    model: str = ""
    choices: List[ChatCompletionChunkChoice] = Field(default_factory=list)
    # present only on the final chunk when stream_options.include_usage
    usage: Optional[UsageInfo] = None


class CompletionChunkChoice(OpenAIBase):
    index: int = 0
    text: str = ""
    finish_reason: Optional[str] = None
    logprobs: Optional[CompletionLogprobs] = None


class CompletionChunk(OpenAIBase):
    id: str = ""
    object: Literal["text_completion"] = "text_completion"
    created: int = Field(default_factory=_now)
    model: str = ""
    choices: List[CompletionChunkChoice] = Field(default_factory=list)
    # present only on the final chunk when stream_options.include_usage
    usage: Optional[UsageInfo] = None


# ---------------------------------------------------------------- models API

class ModelCard(OpenAIBase):
    id: str
    object: Literal["model"] = "model"
    created: int = Field(default_factory=_now)
    owned_by: str = "production-stack-tpu"
    root: Optional[str] = None
    parent: Optional[str] = None


class ModelList(OpenAIBase):
    object: Literal["list"] = "list"
    data: List[ModelCard] = Field(default_factory=list)


class ErrorInfo(OpenAIBase):
    message: str
    type: str = "invalid_request_error"
    code: Optional[int] = None


class ErrorResponse(OpenAIBase):
    error: ErrorInfo
