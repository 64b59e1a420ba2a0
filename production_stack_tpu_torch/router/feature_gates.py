"""Kubernetes-style feature gates for experimental router features.

Capability parity with reference src/vllm_router/experimental/
feature_gates.py:1-141 (stages ALPHA/BETA/GA, --feature-gates=Name=true
CLI + env var), without the reference's duplicated-initializer quirk.
"""

import enum
import os
from typing import Dict, Optional

from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)

ENV_VAR = "PSTPU_FEATURE_GATES"


class FeatureStage(enum.Enum):
    ALPHA = "alpha"       # off by default
    BETA = "beta"         # on by default
    GA = "ga"             # always on


KNOWN_FEATURES: Dict[str, FeatureStage] = {
    "SemanticCache": FeatureStage.ALPHA,
    "PIIDetection": FeatureStage.ALPHA,
    "KVAwareRouting": FeatureStage.BETA,
}


class FeatureGates:
    def __init__(self, spec: Optional[str] = None):
        self._enabled: Dict[str, bool] = {
            name: stage != FeatureStage.ALPHA
            for name, stage in KNOWN_FEATURES.items()}
        spec = spec if spec is not None else os.environ.get(ENV_VAR, "")
        for item in (spec or "").split(","):
            item = item.strip()
            if not item:
                continue
            if "=" not in item:
                raise ValueError(
                    f"feature gate {item!r} must be Name=true|false")
            name, value = item.split("=", 1)
            name = name.strip()
            if name not in KNOWN_FEATURES:
                raise ValueError(f"unknown feature gate {name!r}; known: "
                                 f"{sorted(KNOWN_FEATURES)}")
            if KNOWN_FEATURES[name] == FeatureStage.GA and \
                    value.lower() == "false":
                raise ValueError(f"GA feature {name} cannot be disabled")
            self._enabled[name] = value.strip().lower() == "true"
        for name, on in sorted(self._enabled.items()):
            if on:
                logger.info("feature gate %s enabled (%s)", name,
                            KNOWN_FEATURES[name].value)

    def enabled(self, name: str) -> bool:
        return self._enabled.get(name, False)

    def as_dict(self) -> Dict[str, bool]:
        return dict(self._enabled)
