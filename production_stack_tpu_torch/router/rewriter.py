"""Pluggable request-rewrite hook applied before routing/forwarding.

Capability parity with reference src/vllm_router/services/request_service/
rewriter.py:17-83 (abstract rewriter + noop + factory). Rewriters can
change the body (e.g. prompt decoration, model aliasing, parameter
clamping) — the proxy re-serializes when the body changes.
"""

import json
from abc import ABC, abstractmethod
from typing import Tuple


class RequestRewriter(ABC):
    @abstractmethod
    def rewrite(self, endpoint_path: str, body: dict,
                raw: bytes) -> Tuple[dict, bytes]:
        """Return (body, raw) — possibly modified."""


class NoopRequestRewriter(RequestRewriter):
    def rewrite(self, endpoint_path, body, raw):
        return body, raw


class ModelAliasRewriter(RequestRewriter):
    """Rewrites request 'model' through an alias map (router-level alias
    support independent of engine-reported names)."""

    def __init__(self, aliases: dict):
        self.aliases = dict(aliases)

    def rewrite(self, endpoint_path, body, raw):
        model = body.get("model")
        if model in self.aliases:
            body = dict(body)
            body["model"] = self.aliases[model]
            raw = json.dumps(body).encode()
        return body, raw


def make_rewriter(kind: str = "noop", **kwargs) -> RequestRewriter:
    if kind == "noop":
        return NoopRequestRewriter()
    if kind == "model_alias":
        return ModelAliasRewriter(kwargs.get("aliases", {}))
    raise ValueError(f"unknown rewriter {kind!r}")
