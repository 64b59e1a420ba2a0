"""Engine membership: who can serve which model, kept fresh.

Two implementations behind one interface (capability parity with
reference src/vllm_router/service_discovery.py:36-239, re-designed):

- StaticServiceDiscovery: fixed URL/model lists from flags; optionally
  confirms each backend's model list by probing /v1/models.
- K8sServiceDiscovery: watches pod events through the Kubernetes REST
  API directly (aiohttp + the pod's serviceaccount token — no kubernetes
  client dependency). A pod becomes routable only when it is Ready AND
  answers /v1/models (same readiness gate as the reference :201-239).

All implementations are asyncio tasks on the app's event loop — no
threads, no locks; state mutations happen on the loop.
"""

import asyncio
import json
import os
import ssl
import time
from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import aiohttp

from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)


@dataclass
class EndpointInfo:
    url: str                      # e.g. http://10.0.0.3:8100
    model: str                    # served model name
    added_at: float = field(default_factory=time.time)
    pod_name: Optional[str] = None
    model_aliases: List[str] = field(default_factory=list)
    # named pool membership (disaggregated serving, router/disagg.py):
    # discovery-managed endpoints are the "decode" pool; the prefill
    # orchestrator's endpoints carry "prefill"
    pool: str = "decode"

    def serves(self, model: str) -> bool:
        return model == self.model or model in self.model_aliases


class ServiceDiscovery(ABC):
    @abstractmethod
    def get_endpoints(self) -> List[EndpointInfo]:
        ...

    def all_endpoints(self) -> List[EndpointInfo]:
        """The full configured membership, INCLUDING endpoints
        temporarily withheld from routing (e.g. probe-marked
        unroutable). State eviction keys off this so a transient
        outage doesn't wipe an endpoint's stats/breaker/drain state."""
        return self.get_endpoints()

    async def start(self) -> None:
        pass

    async def close(self) -> None:
        pass

    def healthy(self) -> bool:
        return True


def engine_auth_headers() -> Dict[str, str]:
    """Bearer header for engine pods when they enforce an API key.

    Reads ENGINE_API_KEY — the same secret the chart delivers to engine
    pods (reference parity: the stack's discovery queries pods with
    VLLM_API_KEY, src/vllm_router/service_discovery.py:145-147).
    """
    key = os.environ.get("ENGINE_API_KEY", "")
    return {"Authorization": f"Bearer {key}"} if key else {}


async def probe_model_name(session: aiohttp.ClientSession,
                           url: str) -> Optional[List[str]]:
    """GET <url>/v1/models -> list of model ids, or None if unreachable."""
    try:
        async with session.get(f"{url}/v1/models",
                               headers=engine_auth_headers(),
                               timeout=aiohttp.ClientTimeout(total=5)) as r:
            if r.status != 200:
                return None
            data = await r.json()
            return [card["id"] for card in data.get("data", [])]
    except (aiohttp.ClientError, asyncio.TimeoutError, json.JSONDecodeError,
            KeyError):
        return None


class StaticServiceDiscovery(ServiceDiscovery):
    """Fixed endpoint list, optionally liveness-checked.

    With ``probe=True``, each backend's ``/v1/models`` is re-probed on
    an interval: extra served models become routable aliases, and —
    since a static list has no other liveness signal — an endpoint
    failing ``probe_failure_threshold`` consecutive probes is marked
    unroutable (dropped from ``get_endpoints``) until a probe succeeds
    again. Probe outcomes are also fed to the router's
    ``HealthTracker`` (when wired) so the breaker, ``/metrics``, and
    discovery agree on who is healthy.
    """

    def __init__(self, urls: List[str], models: List[str],
                 aliases: Optional[Dict[str, str]] = None,
                 probe: bool = False, probe_interval: float = 30.0,
                 probe_failure_threshold: int = 3,
                 health_tracker=None):
        if len(urls) != len(models):
            raise ValueError(
                f"{len(urls)} backends but {len(models)} model names")
        alias_map: Dict[str, List[str]] = {}
        for alias, target in (aliases or {}).items():
            alias_map.setdefault(target, []).append(alias)
        self._endpoints = [
            EndpointInfo(url=u.rstrip("/"), model=m,
                         model_aliases=alias_map.get(m, []))
            for u, m in zip(urls, models)]
        self._probe = probe
        self._probe_interval = probe_interval
        self._probe_failure_threshold = probe_failure_threshold
        self._probe_failures: Dict[str, int] = {}
        self._unroutable: set = set()
        self._health = health_tracker
        self._probe_task: Optional[asyncio.Task] = None

    def get_endpoints(self) -> List[EndpointInfo]:
        if not self._unroutable:
            return list(self._endpoints)
        return [ep for ep in self._endpoints
                if ep.url not in self._unroutable]

    def all_endpoints(self) -> List[EndpointInfo]:
        return list(self._endpoints)

    async def start(self) -> None:
        if not self._probe:
            return
        # one immediate pass (routers usually start after engines), then
        # keep re-probing: an engine that is still warming up at router
        # start would otherwise never contribute its extra served models
        # (e.g. LoRA adapters) as routable aliases
        await self._probe_once()
        self._probe_task = asyncio.create_task(self._probe_loop(),
                                               name="static-probe")

    async def close(self) -> None:
        if self._probe_task:
            self._probe_task.cancel()
            self._probe_task = None

    async def _probe_loop(self) -> None:
        while True:
            await asyncio.sleep(self._probe_interval)
            try:
                await self._probe_once()
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("static backend probe failed")

    async def _probe_once(self) -> None:
        async with aiohttp.ClientSession() as session:
            for ep in self._endpoints:
                models = await probe_model_name(session, ep.url)
                if not models:
                    n = self._probe_failures.get(ep.url, 0) + 1
                    self._probe_failures[ep.url] = n
                    if n >= self._probe_failure_threshold and \
                            ep.url not in self._unroutable:
                        # stale aliases must not keep a dead endpoint
                        # routable forever
                        logger.warning(
                            "backend %s unroutable: %d consecutive "
                            "/v1/models probe failures", ep.url, n)
                        self._unroutable.add(ep.url)
                    if self._health is not None:
                        self._health.record_probe_result(ep.url, False)
                    continue
                if ep.url in self._unroutable:
                    logger.info("backend %s recovered (probe ok); "
                                "routable again", ep.url)
                    self._unroutable.discard(ep.url)
                self._probe_failures[ep.url] = 0
                if self._health is not None:
                    self._health.record_probe_result(ep.url, True)
                if ep.model not in models:
                    logger.warning(
                        "backend %s reports models %s, flag says %s",
                        ep.url, models, ep.model)
                extra = [m for m in models
                         if m != ep.model and m not in ep.model_aliases]
                if extra:
                    # adapters/aliases the engine serves beyond the flag
                    # (e.g. LoRA adapters as model ids) become routable
                    logger.info("backend %s also serves %s", ep.url, extra)
                    ep.model_aliases = ep.model_aliases + extra


class K8sServiceDiscovery(ServiceDiscovery):
    """Watch pods matching a label selector; track ready engine pods.

    Reconnects the watch on expiry/failure with the last resourceVersion
    (falling back to a fresh list on 410 Gone).
    """

    SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"

    def __init__(self, namespace: str, label_selector: str,
                 engine_port: int = 8100,
                 api_server: Optional[str] = None,
                 token_path: Optional[str] = None,
                 ca_path: Optional[str] = None):
        self.namespace = namespace
        self.label_selector = label_selector
        self.engine_port = engine_port
        host = os.environ.get("KUBERNETES_SERVICE_HOST", "kubernetes.default")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        self.api_server = api_server or f"https://{host}:{port}"
        self.token_path = token_path or f"{self.SA_DIR}/token"
        self.ca_path = ca_path or f"{self.SA_DIR}/ca.crt"
        self._endpoints: Dict[str, EndpointInfo] = {}   # pod name -> info
        self._task: Optional[asyncio.Task] = None
        self._session: Optional[aiohttp.ClientSession] = None
        self._last_event = 0.0

    # -- interface ------------------------------------------------------

    def get_endpoints(self) -> List[EndpointInfo]:
        return list(self._endpoints.values())

    def healthy(self) -> bool:
        return self._task is not None and not self._task.done()

    async def start(self) -> None:
        ssl_ctx: Optional[ssl.SSLContext] = None
        if os.path.exists(self.ca_path):
            ssl_ctx = ssl.create_default_context(cafile=self.ca_path)
        self._session = aiohttp.ClientSession(
            connector=aiohttp.TCPConnector(ssl=ssl_ctx))
        self._task = asyncio.create_task(self._watch_loop(),
                                         name="k8s-watch")

    async def close(self) -> None:
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        if self._session:
            await self._session.close()
            self._session = None

    # -- internals ------------------------------------------------------

    def _headers(self) -> Dict[str, str]:
        headers = {}
        if os.path.exists(self.token_path):
            with open(self.token_path) as f:
                headers["Authorization"] = f"Bearer {f.read().strip()}"
        return headers

    async def _watch_loop(self) -> None:
        resource_version = ""
        while True:
            try:
                resource_version = await self._list_pods()
                await self._watch(resource_version)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                logger.warning("k8s watch error (%s); retrying in 2s", e)
                await asyncio.sleep(2)

    async def _list_pods(self) -> str:
        url = (f"{self.api_server}/api/v1/namespaces/{self.namespace}/pods"
               f"?labelSelector={self.label_selector}")
        async with self._session.get(url, headers=self._headers()) as r:
            r.raise_for_status()
            data = await r.json()
        seen = set()
        for pod in data.get("items", []):
            name = await self._handle_pod(pod)
            if name:
                seen.add(name)
        for gone in set(self._endpoints) - seen:
            logger.info("engine pod %s gone", gone)
            del self._endpoints[gone]
        return data.get("metadata", {}).get("resourceVersion", "")

    async def _watch(self, resource_version: str) -> None:
        url = (f"{self.api_server}/api/v1/namespaces/{self.namespace}/pods"
               f"?watch=true&labelSelector={self.label_selector}"
               f"&resourceVersion={resource_version}"
               f"&timeoutSeconds=300")
        async with self._session.get(
                url, headers=self._headers(),
                timeout=aiohttp.ClientTimeout(total=None, sock_read=330)
        ) as resp:
            resp.raise_for_status()
            async for line in resp.content:
                if not line.strip():
                    continue
                event = json.loads(line)
                self._last_event = time.time()
                etype = event.get("type")
                pod = event.get("object", {})
                if etype in ("ADDED", "MODIFIED"):
                    await self._handle_pod(pod)
                elif etype == "DELETED":
                    name = pod.get("metadata", {}).get("name")
                    if name in self._endpoints:
                        logger.info("engine pod %s deleted", name)
                        del self._endpoints[name]

    @staticmethod
    def _pod_ready(pod: dict) -> bool:
        statuses = pod.get("status", {}).get("containerStatuses", [])
        return bool(statuses) and all(s.get("ready") for s in statuses)

    async def _handle_pod(self, pod: dict) -> Optional[str]:
        meta = pod.get("metadata", {})
        name = meta.get("name")
        ip = pod.get("status", {}).get("podIP")
        if not name:
            return None
        if not ip or not self._pod_ready(pod) or pod.get("metadata", {}).get(
                "deletionTimestamp"):
            if name in self._endpoints:
                logger.info("engine pod %s not ready; removing", name)
                del self._endpoints[name]
            return None
        url = f"http://{ip}:{self.engine_port}"
        existing = self._endpoints.get(name)
        if existing is not None:
            if existing.url == url:
                return name
            # same pod name, new IP (recreated pod, missed DELETED event):
            # fall through and re-probe at the new address
            logger.info("engine pod %s moved %s -> %s; re-probing", name,
                        existing.url, url)
            del self._endpoints[name]
        models = await probe_model_name(self._session, url)
        if not models:
            return None   # not answering yet; next MODIFIED event retries
        self._endpoints[name] = EndpointInfo(url=url, model=models[0],
                                             pod_name=name,
                                             model_aliases=models[1:])
        logger.info("engine pod %s at %s serving %s", name, url, models)
        return name
