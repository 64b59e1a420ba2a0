"""The port's router (production_stack_tpu_torch/router/) against the JAX
package's, both applications in process over the same fake engines
(tests/fake_engine.py), one router after the other: the backend each
request of a scripted sequence lands on under roundrobin, session,
least-loaded and prefix-aware routing; the regex PII analyzer's block and
redact replies; a semantic-cache hit on a repeated request (through the
native ``psvi_*`` index where ``native/`` builds); the failover retry
when one backend resets every connection; ``/v1/models`` and the
router's ``/metrics`` family names.
"""

import asyncio

import pytest
from aiohttp.test_utils import TestClient, TestServer

from production_stack_tpu.router import app as japp
from production_stack_tpu_torch.kvcache import _native
from production_stack_tpu_torch.router import app as tapp
from tests.fake_engine import FakeEngine


async def _fleet(fakes):
    servers = []
    for fake in fakes:
        server = TestServer(fake.build_app())
        await server.start_server()
        servers.append(server)
    return servers, [f"http://127.0.0.1:{s.port}" for s in servers]


def _each_router(fakes, scenario, *extra):
    """Run ``scenario(client, app)`` through the JAX router, then the
    port's, over the same fake engines (their request logs cleared
    before each); returns the two results."""
    async def body():
        servers, urls = await _fleet(fakes)
        results = []
        try:
            for mod in (japp, tapp):
                for f in fakes:
                    f.requests_seen.clear()
                args = mod.parse_args([
                    "--service-discovery", "static",
                    "--static-backends", ",".join(urls),
                    "--static-models", ",".join([f.model for f in fakes]),
                    *extra])
                async with TestClient(TestServer(mod.build_app(args))) \
                        as client:
                    results.append(await scenario(client, client.app))
        finally:
            for s in servers:
                await s.close()
        return results
    return asyncio.run(body())


def _chat(content="hi", **kw):
    return {"model": "m", "messages": [{"role": "user",
                                        "content": content}], **kw}


def _served_by(fakes, user):
    """Index of the fake that logged the request sent as ``user``."""
    hits = [i for i, f in enumerate(fakes)
            if any(seen[1] == user for seen in f.requests_seen)]
    assert len(hits) == 1, (user, hits)
    return hits[0]


def _script(policy):
    """(prompt, x-user-id) of each request. The session policy routes on
    the header (five users, three requests each); the others ignore it,
    so it tags each request."""
    if policy == "session":
        return [(f"q{i}", f"user-{i % 5}") for i in range(15)]
    if policy == "prefix":
        docs = ["alpha " * 80, "bravo " * 80, "charlie " * 80]
        return [(docs[i % 3] + f"question {i}", f"r{i}") for i in range(12)]
    if policy == "least_loaded":
        return [(f"q{i}", f"r{i}") for i in range(6)]
    return [(f"q{i}", f"r{i}") for i in range(7)]


@pytest.mark.parametrize("policy", ["roundrobin", "session",
                                    "least_loaded", "prefix"])
def test_routing_choices_equal_jax(policy):
    """The same scripted sequence lands on the same backends. Sequential
    except least_loaded, whose requests overlap (each engine takes 2 s to
    its first token; a request is sent once the one before it reached
    its engine), so the routers' in-flight counts decide, then the
    request rates (recomputed at every request)."""
    overlap = policy == "least_loaded"
    fakes = [FakeEngine(model="m", ttft_s=2.0 if overlap else 0.0)
             for _ in range(3)]
    script = _script(policy)

    async def scenario(client, app):
        choices, pending = [], []
        for prompt, user in script:
            req = client.post("/v1/chat/completions", json=_chat(prompt),
                              headers={"x-user-id": user})
            if overlap:
                pending.append(asyncio.ensure_future(req))
                while not any(seen[1] == user for f in fakes
                              for seen in f.requests_seen):
                    await asyncio.sleep(0.005)
                continue
            r = await req
            assert r.status == 200, await r.text()
            seen = [i for i, f in enumerate(fakes)
                    if f.requests_seen and f.requests_seen[-1][1] == user]
            choices.append(seen)
        for r in await asyncio.gather(*pending):
            assert r.status == 200, await r.text()
        if overlap:
            return [_served_by(fakes, user) for _, user in script]
        return choices

    want, got = _each_router(fakes, scenario, "--routing-logic", policy,
                             "--request-stats-snapshot-ttl", "0")
    assert got == want
    if policy == "least_loaded":
        # one request in flight on each engine, then two
        assert sorted(want[:3]) == [0, 1, 2], want
        assert sorted(want) == [0, 0, 1, 1, 2, 2], want
    elif policy == "roundrobin":
        assert [c for (c,) in want] == [0, 1, 2, 0, 1, 2, 0] or \
            sorted({c for (c,) in want}) == [0, 1, 2], want
    else:
        # sticky: a user (session) or a document (prefix) stays put
        key = {"session": lambda i: i % 5, "prefix": lambda i: i % 3}[policy]
        homes = {}
        for i, c in enumerate(want):
            assert homes.setdefault(key(i), c) == c, (i, want)


def test_pii_regex_block_and_redact_equal_jax():
    fakes = [FakeEngine(model="m")]
    texts = ["my ssn is 123-45-6789", "reach me at jane@corp.com",
             "hello there", "card 4111 1111 1111 1111 and ip 10.0.0.1"]

    async def scenario(client, app):
        out = []
        for action in ("block", "redact"):
            mw = app["state"]["pii_middleware"]
            mw.config.action = type(mw.config.action)(action)
            for text in texts:
                n = len(fakes[0].requests_seen)
                r = await client.post("/v1/chat/completions",
                                      json=_chat(text))
                body = await r.json()
                reached = len(fakes[0].requests_seen) > n
                out.append((action, r.status,
                            body if r.status != 200 else None,
                            fakes[0].last_chat_body if reached else None))
        m = await (await client.get("/metrics")).text()
        out.append(sorted(ln for ln in m.splitlines()
                          if ln.startswith("vllm:pii_")))
        return out

    want, got = _each_router(fakes, scenario,
                             "--feature-gates", "PIIDetection=true")
    assert got == want
    assert [r[1] for r in want[:4]] == [400, 400, 200, 400]
    assert "[REDACTED:ssn]" in want[4][3]


def test_semantic_cache_hit_equal_jax():
    fakes = [FakeEngine(model="m")]

    async def scenario(client, app):
        req = _chat("what is two plus two?")
        r1 = await client.post("/v1/chat/completions", json=req)
        first = await r1.json()
        cache = app["state"]["semantic_cache"]
        for _ in range(100):       # the store is fire-and-forget
            if len(cache):
                break
            await asyncio.sleep(0.05)
        r2 = await client.post("/v1/chat/completions", json=req)
        second = await r2.json()
        m = await (await client.get("/metrics")).text()
        return (r1.status, r2.status, second.get("cached"),
                second["choices"] == first["choices"],
                len(fakes[0].requests_seen), type(cache.index).__name__,
                # every series with its value, the latency's by name
                sorted(ln.split()[0] if "latency" in ln else ln
                       for ln in m.splitlines()
                       if ln.startswith("vllm:semantic_cache_")))

    want, got = _each_router(fakes, scenario,
                             "--feature-gates", "SemanticCache=true",
                             "--semantic-cache-threshold", "0.9")
    assert got == want
    assert want[:5] == (200, 200, True, True, 1)
    if _native.load() is not None:
        assert got[5] == "NativeVectorIndex"


def test_failover_retry_equal_jax():
    """One of two backends resets every connection: every request is
    retried on the other before a byte reaches the client."""
    good, bad = FakeEngine(model="m"), FakeEngine(model="m")
    bad.fault = {"mode": "reset", "count": -1, "scope": "inference"}
    fakes = [good, bad]

    async def scenario(client, app):
        statuses = []
        for i in range(6):
            r = await client.post("/v1/chat/completions", json=_chat(),
                                  headers={"x-user-id": f"r{i}"})
            statuses.append(r.status)
        tracker = app["state"]["health"]
        urls = sorted(tracker.retries)
        m = await (await client.get("/metrics")).text()
        return (statuses, len(good.requests_seen),
                [tracker.retries[u] >= 1 for u in urls],
                sorted(ln.split("{")[0] for ln in m.splitlines()
                       if ln.startswith("vllm:upstream_failures_total")))

    want, got = _each_router(fakes, scenario, "--breaker-threshold", "2",
                             "--breaker-cooldown", "30")
    assert got == want
    assert want[0] == [200] * 6 and want[1] == 6 and want[3]


def test_models_and_metric_families_equal_jax():
    fakes = [FakeEngine(model="m-a"), FakeEngine(model="m-b")]

    async def scenario(client, app):
        models = await (await client.get("/v1/models")).json()
        r = await client.post("/v1/chat/completions",
                              json=dict(_chat(), model="m-b"))
        assert r.status == 200
        health = await (await client.get("/health")).json()
        m = await (await client.get("/metrics")).text()
        families = sorted({ln.split()[2] for ln in m.splitlines()
                           if ln.startswith("# TYPE ")})
        return ([(c["id"], c["object"], c["owned_by"])
                 for c in models["data"]], models["object"],
                health["status"], health["endpoints"], families)

    want, got = _each_router(fakes, scenario)
    assert got == want
    assert [c[0] for c in want[0]] == ["m-a", "m-b"]
    assert "vllm:healthy_pods_total" in want[4]
