"""The port's KV tiering (production_stack_tpu_torch/kvcache/, the
runner's extract_chunk / inject_chunk, the engine's connector wiring,
the kvplane's defrag, migrate_out and warm) against the JAX package's on
the CPU.

- keys: chunk keys with and without an adapter salt equal JAX's;
- stores: host (native and Python), disk and tiered stores; the TPKV
  wire both ways (the port's client against the JAX cache server, the
  JAX client against the port's asyncio server and against the native
  server the port's entry point starts), the breaker and a torn put;
- runner: extract_chunk / inject_chunk against JAX's on the same pool
  (float32: equal bytes; int8: equal bf16 bytes out, equal int8 payload
  and scales in);
- engines within the port (the JAX package's own engine tests, on the
  port): prefix reuse through a host tier and through a remote server,
  progressive publish during prefill;
- engines across the packages on one shared disk tier (float32 weights
  drawn by JAX and carried across): a JAX producer's chunks serve a
  port consumer and the reverse, a whole-chunk prompt (a 1-token
  suffix) and an adapter-salted prompt, tokens equal to each package's
  recompute and to the other package's;
- surface and kvplane: /load's kv_cache block through
  signals.parse_load_report, the tier and kvplane metric families' names,
  types and labels, defrag against JAX's on one seeded alloc/free
  sequence, /admin/kvplane/* statuses and bodies against the JAX
  server's, a migrated victim re-admitted by injection;
- config: a connector turns rolling KV off, as in JAX.
"""

import asyncio
import contextlib
import dataclasses
import os
import socket
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer
from prometheus_client.parser import text_string_to_metric_families

from production_stack_tpu.engine import async_engine as jasync
from production_stack_tpu.engine import config as jec
from production_stack_tpu.engine import engine as jengine
from production_stack_tpu.engine import runner as jrunner
from production_stack_tpu.engine import server as jserver
from production_stack_tpu.engine.block_manager import \
    BlockManager as JBlockManager
from production_stack_tpu.engine.scheduler import \
    SamplingOptions as JSamplingOptions
from production_stack_tpu.kvcache import chunks as jchunks
from production_stack_tpu.kvcache.server import \
    CacheServer as JCacheServer
from production_stack_tpu.kvcache.store import RemoteStore as JRemoteStore
from production_stack_tpu.models import config as jconfig
from production_stack_tpu.models import kv as jkv
from production_stack_tpu.models import llama as jllama
from production_stack_tpu.models import lora as jlora
from production_stack_tpu.signals import parse_load_report
from production_stack_tpu_torch.engine import config as tec
from production_stack_tpu_torch.engine import engine as tengine
from production_stack_tpu_torch.engine import runner as trunner
from production_stack_tpu_torch.engine.async_engine import AsyncLLMEngine
from production_stack_tpu_torch.engine.block_manager import BlockManager
from production_stack_tpu_torch.engine.scheduler import SamplingOptions
from production_stack_tpu_torch.engine.server import build_app
from production_stack_tpu_torch.kvcache import chunks, protocol
from production_stack_tpu_torch.kvcache._native import load as load_native
from production_stack_tpu_torch.kvcache.connector import tensor_bytes
from production_stack_tpu_torch.kvcache.server import CacheServer
from production_stack_tpu_torch.kvcache.store import (DiskStore,
                                                      HostMemoryStore,
                                                      RemoteStore,
                                                      TieredStore)
from production_stack_tpu_torch.models import config as tconfig
from production_stack_tpu_torch.weights import cache_from_jax, params_from_jax

from tests.torch_geometry import FIXED

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK = 32
# float32 weights and pool on both sides (greedy ties cannot flip between
# two libraries' summation orders), 16-token blocks under 32-token chunks
ENG = dict(model="debug-tiny", dtype="float32", kv_dtype="float32",
           max_model_len=256, max_num_seqs=2, prefill_chunk=64,
           prefill_buckets=(16, 32, 64), kv_block_size=16,
           lora_rank=4, lora_alpha=8.0, lora_targets=("q", "v"))


def _prompt(seed: int, n: int = 100):
    return np.random.default_rng(seed).integers(0, 500, n).tolist()


def _run(engine, prompt, opts_cls, max_tokens=8, model=None):
    sid = engine.add_request(list(prompt), opts_cls(
        temperature=0.0, max_tokens=max_tokens, ignore_eos=True),
        model=model)
    while engine.has_work:
        engine.step()
    return list(engine.seqs[sid].output_tokens)


@contextlib.contextmanager
def cache_server(cls):
    """An asyncio cache server (`cls`: the port's or JAX's) on a free
    port, on a loop thread of its own."""
    loop = asyncio.new_event_loop()
    server = cls(host="127.0.0.1", port=0, capacity_bytes=1 << 22)
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    asyncio.run_coroutine_threadsafe(server.start(), loop).result(5)
    try:
        yield server
    finally:
        asyncio.run_coroutine_threadsafe(server.stop(), loop).result(5)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(5)
        assert not thread.is_alive()


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(jconfig.get_config("debug-tiny"),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(tconfig.get_config("debug-tiny"),
                               dtype=torch.float32)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(7))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module")
def adapter(tmp_path_factory, weights):
    """An .npz adapter written by the JAX package (rank 4 on q and v:
    it colors the KV, so its chunks are salted)."""
    path = str(tmp_path_factory.mktemp("lora") / "ad.npz")
    lcfg = jlora.LoRAConfig(rank=4, alpha=8.0, targets=("q", "v"))
    jlora.save_adapter_npz(jlora.random_adapter(
        weights[0], lcfg, jax.random.PRNGKey(3)), path)
    return {"ad": path}


def _port(weights, adapter, kv=None, **kw):
    return tengine.LLMEngine(tec.EngineConfig(
        **dict(ENG, **FIXED, **kw), device="cpu", lora_adapters=adapter,
        kv_transfer_config=kv), params=weights[3])


@pytest.fixture(scope="module")
def recompute(weights, adapter):
    """A port engine without tiers, on the same weights."""
    return _port(weights, adapter)


# ------------------------------------------------------------------- keys

@pytest.mark.parametrize("salt", ["", "lora:ad"])
def test_chunk_keys_equal_jax(salt):
    toks = _prompt(1, 150)
    ns = chunks.model_fingerprint(tconfig.get_config("debug-tiny"),
                                  "float32")
    assert ns == jchunks.model_fingerprint(jconfig.get_config("debug-tiny"),
                                           "float32")
    mine, ref = chunks.ChunkHasher(32, ns), jchunks.ChunkHasher(32, ns)
    assert mine.chunk_keys(toks, salt=salt) == \
        ref.chunk_keys(toks, salt=salt)
    head, state = mine.chain_keys(toks[:64], salt=salt)
    tail, _ = mine.chain_keys(toks, salt=salt, state=state)
    assert head + tail == ref.chunk_keys(toks, salt=salt)
    data = bytes(range(256)) * 3
    assert chunks.chain_digest_bytes(data, 100) == \
        jchunks.chain_digest_bytes(data, 100)


# ----------------------------------------------------------------- stores

@pytest.mark.parametrize("force_python", [True, False])
def test_host_store_roundtrip_and_lru(force_python):
    if not force_python and load_native() is None:
        pytest.skip("libpskv.so cannot be built here (no toolchain)")
    st = HostMemoryStore(1000, force_python=force_python)
    assert st.backend == ("python" if force_python else "native")
    assert st.get(b"k") is None
    assert st.put(b"k", b"v" * 100) and st.get(b"k") == b"v" * 100
    assert st.exists(b"k") and st.delete(b"k") and not st.exists(b"k")
    for i in range(3):
        assert st.put(b"k%d" % i, bytes([i]) * 400)
    assert st.get(b"k0") is None and st.get(b"k2") == b"\x02" * 400
    assert st.stats()["evictions"] >= 1
    assert not st.put(b"big", b"x" * 2000)


def test_disk_and_tiered_stores(tmp_path):
    disk = DiskStore(str(tmp_path / "d"), capacity_bytes=1000)
    assert disk.put(b"a", b"1" * 400) and disk.get(b"a") == b"1" * 400
    assert not [f for f in os.listdir(tmp_path / "d") if ".tmp" in f]
    for key in (b"b", b"c"):
        time.sleep(0.01)
        assert disk.put(key, b"2" * 400)
    assert disk.get(b"a") is None            # the oldest was evicted
    assert disk.stats()["count"] == 2 and disk.stats()["bytes"] == 800
    cpu = HostMemoryStore(1 << 20, force_python=True)
    tiered = TieredStore([cpu, disk])
    assert tiered.put(b"t", b"3" * 10) and cpu.get(b"t") == b"3" * 10
    cpu.delete(b"t")
    assert tiered.get_with_tier(b"t") == (b"3" * 10, "disk")
    assert cpu.get(b"t") == b"3" * 10        # promoted
    assert set(tiered.tier_stats()) == {"cpu", "disk"}


def _roundtrip(client):
    assert client.ping()
    assert client.get(b"k") is None
    assert client.put(b"k", b"\x00\x01" * 500)
    assert client.get(b"k") == b"\x00\x01" * 500
    assert client.exists(b"k") and client.delete(b"k")
    assert not client.exists(b"k")
    assert "bytes" in client.stats()
    client.close()


def test_remote_wire_both_ways_with_torn_put():
    """The port's client against the JAX cache server, the JAX client
    against the port's; a client dying mid-PUT on the port's server
    leaves no value."""
    with cache_server(JCacheServer) as jsrv:
        _roundtrip(RemoteStore(f"tpukv://127.0.0.1:{jsrv.port}"))
    with cache_server(CacheServer) as srv:
        url = f"tpukv://127.0.0.1:{srv.port}"
        _roundtrip(JRemoteStore(url))
        frame = protocol.encode_request(protocol.OP_PUT, b"torn", b"x" * 4096)
        with socket.create_connection(("127.0.0.1", srv.port), 5) as sock:
            sock.sendall(frame[:len(frame) // 2])
        client = JRemoteStore(url)
        for _ in range(20):
            if client.ping():
                break
            time.sleep(0.05)
        assert not client.exists(b"torn") and client.get(b"torn") is None
        client.close()


def test_remote_breaker_opens_and_recovers():
    dead = RemoteStore("tpukv://127.0.0.1:1", connect_timeout=0.2,
                       breaker_threshold=2, breaker_cooldown_s=0.2)
    assert dead.get(b"a") is None and not dead.breaker_open()
    assert dead.get(b"b") is None and dead.breaker_open()
    t0 = time.monotonic()
    assert dead.get(b"c") is None and not dead.put(b"k", b"v")
    assert time.monotonic() - t0 < 0.05      # short-circuited
    assert dead.stats()["breaker_trips"] == 1
    time.sleep(0.25)
    assert not dead.breaker_open()


def test_server_entry_point_serves_the_jax_client():
    """`python -m production_stack_tpu_torch.kvcache.server` (the native
    pskv-server where it builds, else the asyncio server) answers the
    JAX package's client."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "production_stack_tpu_torch.kvcache.server",
         "--host", "127.0.0.1", "--port", str(port), "--capacity-gb",
         "0.1"], cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        url = f"tpukv://127.0.0.1:{port}"
        # polled while the server starts: no breaker in the way
        probe = JRemoteStore(url, connect_timeout=0.5,
                             breaker_threshold=1000)
        for _ in range(100):
            if probe.ping():
                break
            time.sleep(0.1)
        probe.close()
        _roundtrip(JRemoteStore(url))
    finally:
        proc.terminate()
        proc.wait(timeout=10)


# ----------------------------------------------------------------- runner

@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_extract_and_inject_chunk_equal_jax(weights, kv_dtype):
    jcfg, tcfg, jparams, tparams = weights
    common = dict(ENG, kv_dtype=kv_dtype, max_num_seqs=3)
    del common["lora_rank"], common["lora_alpha"], common["lora_targets"]
    jr = jrunner.ModelRunner(jcfg, jec.EngineConfig(**common, **FIXED),
                             params=jparams)
    tr = trunner.ModelRunner(tcfg, tec.EngineConfig(**common, device="cpu"),
                             params=tparams)
    rng = np.random.default_rng(9)
    L, N, H, Bs, D = jr.cache.k.shape
    if kv_dtype == "int8":
        k8, v8 = (rng.integers(-127, 128, (L, N, H, Bs, D)).astype(np.int8)
                  for _ in range(2))
        ks, vs = (rng.uniform(0.001, 0.05, (L, N, H, Bs)).astype(np.float32)
                  for _ in range(2))
        jr.cache = jkv.KVCache(*(jnp.asarray(a) for a in (k8, v8, ks, vs)))
        tr.cache = cache_from_jax(k8, v8, device="cpu", ks=ks, vs=vs)[0]
    else:
        k, v = (rng.standard_normal((L, N, H, Bs, D)).astype(np.float32)
                for _ in range(2))
        jr.cache = jkv.KVCache(jnp.asarray(k), jnp.asarray(v))
        tr.cache = cache_from_jax(k, v, device="cpu")[0]
    MB = tr.engine_cfg.max_blocks_per_seq
    tables = (rng.permutation(3 * MB) + 1).reshape(3, MB).astype(np.int32)
    for r in (jr, tr):
        r.set_block_tables(tables)
    # a chunk boundary, one inside a block, and one whose last positions
    # run past the table (their block index clamps to MB - 1)
    for slot, start in ((1, 32), (2, 40), (0, MB * Bs - 20)):
        jk, jv = jr.extract_chunk(slot, start, CHUNK)
        tk, tv = tr.extract_chunk(slot, start, CHUNK)
        assert tk.shape == (L, CHUNK, H, D) and tk.is_contiguous()
        assert tensor_bytes(tk) == np.asarray(jk).tobytes()
        assert tensor_bytes(tv) == np.asarray(jv).tobytes()
    wire = np.asarray(jk).dtype
    ck, cv = (rng.standard_normal((L, CHUNK, H, D)).astype(wire)
              for _ in range(2))

    def host(a):
        t = torch.from_numpy(a.view(np.uint16) if a.dtype != np.float32
                             else a)
        return t.view(torch.bfloat16) if a.dtype != np.float32 else t
    blk, off = (np.asarray(a) for a in jr._slot_block_offsets(
        jr._dev_tables(), 1, 64, CHUNK))
    jr.inject_chunk(1, 64, ck, cv)
    tr.inject_chunk(1, 64, host(ck), host(cv))
    if kv_dtype == "float32":
        for name in ("k", "v"):
            np.testing.assert_array_equal(getattr(tr.cache, name).numpy(),
                                          np.asarray(getattr(jr.cache, name)))
        return
    # int8: the JAX recipe (kv.quantize_chunk) scattered at JAX's
    # addresses, exactly; JAX's jitted inject computes the scale as
    # amax x fl(1/127) (XLA's rewrite of the division), which rounds a
    # few ties one int8 step or one scale ulp the other way
    for name, src, sname in (("k", ck, "ks"), ("v", cv, "vs")):
        q, sc = (np.asarray(a) for a in jkv.quantize_chunk(jnp.asarray(src)))
        want_q = np.asarray(getattr(jr.cache, name)).copy()
        want_s = np.asarray(getattr(jr.cache, sname)).copy()
        want_q[:, blk, :, off, :] = q.transpose(1, 0, 2, 3)
        want_s[:, blk, :, off] = sc.transpose(1, 0, 2)
        got_q = getattr(tr.cache, name).numpy()
        got_s = getattr(tr.cache, sname).numpy()
        np.testing.assert_array_equal(got_q[:, blk, :, off, :],
                                      want_q[:, blk, :, off, :])
        np.testing.assert_array_equal(got_s, want_s)
        jit_q = np.asarray(getattr(jr.cache, name))
        jit_s = np.asarray(getattr(jr.cache, sname))
        assert np.abs(got_q.astype(int) - jit_q).max() <= 1
        assert (got_q != jit_q).mean() <= 1e-3
        ulp = np.abs(got_s.view(np.int32) - jit_s.view(np.int32))
        assert ulp.max() <= 1 and (ulp > 0).mean() <= 0.05


# --------------------------------------------------- engines in the port

def test_port_prefix_reuse_through_host_and_remote_tiers(weights, adapter,
                                                         recompute):
    """The JAX package's test_engine_prefix_reuse_local_cpu and
    test_engine_prefix_reuse_via_remote_server on the port: 3 full
    32-token chunks of a 100-token prompt (96 tokens) come back, all of
    them foreign on a second replica, and the tokens equal an engine
    that never cached."""
    prompt = _prompt(11)
    want = _run(recompute, prompt, SamplingOptions)
    local = _port(weights, adapter, {"local_cpu_gb": 0.25,
                                     "chunk_size": CHUNK})
    try:
        assert _run(local, prompt, SamplingOptions) == want
        local.connector.flush()
        assert local.connector.hit_tokens == 0
        assert _run(local, prompt, SamplingOptions) == want
        assert local.connector.hit_tokens == 96
        assert local.connector.foreign_hit_tokens == 0
    finally:
        local.close()
    with cache_server(CacheServer) as srv:
        kv = {"remote_url": f"tpukv://127.0.0.1:{srv.port}",
              "chunk_size": CHUNK}
        producer, consumer = (_port(weights, adapter, kv) for _ in range(2))
        try:
            assert _run(producer, prompt, SamplingOptions) == want
            producer.connector.flush()
            assert _run(consumer, prompt, SamplingOptions) == want
            assert consumer.connector.hit_tokens == 96
            assert consumer.connector.foreign_hit_tokens == 96
            assert producer.connector.foreign_hit_tokens == 0
        finally:
            producer.close()
            consumer.close()


def test_port_progressive_publish_during_prefill(tmp_path, weights,
                                                 adapter):
    """A producer publishes full prompt chunks while later chunks still
    prefill; on_finish publishes no chunk twice."""
    eng = _port(weights, adapter, {"kv_role": "kv_producer",
                                   "chunk_size": CHUNK,
                                   "local_disk_path": str(tmp_path)},
                prefill_chunk=32, prefill_buckets=(32,), max_num_seqs=1)
    try:
        sid = eng.add_request(list(range(1, 200)), SamplingOptions(
            temperature=0.0, max_tokens=4, ignore_eos=True))
        for _ in range(3):
            assert not any(o.finished for o in eng.step())
        assert eng.seqs[sid].status.value == "prefilling"
        eng.connector.flush()
        assert len(os.listdir(tmp_path)) >= 2
        assert eng.connector.progress_published_chunks >= 2
        while eng.has_work:
            eng.step()
        eng.connector.flush()
        # 199 prompt + 3 written outputs: 6 chunks, each published once
        assert eng.connector.published_chunks == 6
        assert len(os.listdir(tmp_path)) == 6
    finally:
        eng.close()


# ------------------------------------------------- across the packages

@pytest.fixture(scope="module")
def shared(tmp_path_factory, weights, adapter):
    """A JAX engine and a port engine (kv_both) on one disk tier."""
    tier = str(tmp_path_factory.mktemp("tier"))
    kv = {"chunk_size": CHUNK, "local_disk_path": tier}
    je = jengine.LLMEngine(jec.EngineConfig(
        **ENG, **FIXED, lora_adapters=adapter, kv_transfer_config=kv),
        params=weights[2])
    te = _port(weights, adapter, kv)
    yield je, te
    je.close()
    te.close()


def _hits(engine):
    c = engine.connector
    return c.hit_tokens, c.foreign_hit_tokens


def _serve_after(producer, consumer, prompt, p_opts, c_opts, model=None):
    """(producer's tokens, consumer's tokens, consumer's new hit and
    foreign-hit tokens) of `prompt` served by the producer, then, once
    its chunks are on the tier, by the consumer."""
    made = _run(producer, prompt, p_opts, model=model)
    producer.connector.flush()
    h0, f0 = _hits(consumer)
    got = _run(consumer, prompt, c_opts, model=model)
    h1, f1 = _hits(consumer)
    return made, got, h1 - h0, f1 - f0


def test_jax_producer_serves_a_port_consumer(shared, recompute):
    je, te = shared
    for prompt, hit in ((_prompt(21), 96), (_prompt(22, 64), 63)):
        made, got, h, f = _serve_after(je, te, prompt, JSamplingOptions,
                                       SamplingOptions)
        assert (h, f) == (hit, hit)
        assert got == made == _run(recompute, prompt, SamplingOptions)


def test_port_producer_serves_a_jax_consumer(shared):
    je, te = shared
    for prompt, hit in ((_prompt(23), 96), (_prompt(24, 64), 63)):
        made, got, h, f = _serve_after(te, je, prompt, SamplingOptions,
                                       JSamplingOptions)
        assert (h, f) == (hit, hit)
        assert got == made
        # the JAX engine's own recompute: the tier's chunks deleted
        for key in je.connector.hasher.chunk_keys(prompt):
            assert je.connector.store.delete(key)
        h0 = je.connector.hit_tokens
        assert _run(je, prompt, JSamplingOptions) == made
        assert je.connector.hit_tokens == h0


def test_adapter_salted_chunks_cross_the_packages(shared, recompute):
    """An adapter's chunks are keyed under its salt: the JAX engine's
    serve the port's requests for the adapter and never its base
    requests."""
    je, te = shared
    prompt = _prompt(25)
    made, got, h, f = _serve_after(je, te, prompt, JSamplingOptions,
                                   SamplingOptions, model="ad")
    assert (h, f) == (96, 96)
    assert got == made == _run(recompute, prompt, SamplingOptions,
                               model="ad")
    h0 = te.connector.hit_tokens
    base = _run(te, prompt, SamplingOptions)
    assert te.connector.hit_tokens == h0
    assert base == _run(recompute, prompt, SamplingOptions)


# ------------------------------------------------------ surface, kvplane

def test_load_block_and_metric_families_equal_jax(shared):
    """/load's kv_cache block reads through signals.parse_load_report
    (the router's and the autoscaler's parser) and has the JAX engine's
    keys; the tpu:kvcache_*, tpu:engine_kv_role and tpu:kvplane_*
    families have the JAX engine's names, types and labels."""
    je, te = shared
    _run(te, _prompt(26), SamplingOptions)
    report = te.load_report()
    load = parse_load_report(report)
    kv = report["kv_cache"]
    assert load.kv_role == "kv_both" and kv["role"] == "kv_both"
    assert load.kv_hit_tokens == kv["hit_tokens"] > 0
    assert load.kv_query_tokens == kv["query_tokens"]
    assert load.kv_foreign_hit_tokens == kv["foreign_hit_tokens"]
    assert load.kv_hit_rate == pytest.approx(kv["hit_rate"])
    assert set(kv) == set(je.load_report()["kv_cache"])
    assert kv["tiers"]["disk"]["count"] > 0

    def families(engine):
        out = {}
        for fam in text_string_to_metric_families(
                engine.render_metrics().decode()):
            if fam.name.startswith(("tpu:kvcache", "tpu:engine_kv_role",
                                    "tpu:kvplane")):
                out[fam.name] = (fam.type, sorted({
                    tuple(sorted(s.labels)) for s in fam.samples}))
        return out
    mine, ref = families(te), families(je)
    assert "tpu:engine_kv_role" in mine
    assert "tpu:kvcache_hit_tokens" in mine
    assert "tpu:kvplane_free_contiguity" in mine
    assert mine == ref


def test_defrag_equals_jax_on_a_seeded_alloc_free_sequence():
    rng = np.random.default_rng(12)
    mine, ref = BlockManager(64, 16), JBlockManager(64, 16)
    held = []
    for _ in range(60):
        if held and rng.random() < 0.45:
            blocks = held.pop(int(rng.integers(len(held))))
            mine.free(blocks)
            ref.free(blocks)
        else:
            n = int(rng.integers(1, 9))
            a, b = mine.alloc(n), ref.alloc(n)
            assert a == b
            if a:
                held.append(a)
        if rng.random() < 0.2:
            assert mine.defrag() == ref.defrag()
        assert mine.frag_report() == ref.frag_report()
    assert mine.frag_report()["defrag_runs"] > 0


def test_admin_kvplane_routes_answer_as_jax(tmp_path, weights):
    """/admin/kvplane/migrate_out and /warm: the JAX server's statuses
    and bodies, with a producer role (an idle migrate, a warm of keys
    of which one is on the tier, a malformed key list) and without
    tiers (409)."""
    common = dict(ENG, max_num_seqs=1)
    for name in ("lora_rank", "lora_alpha", "lora_targets"):
        del common[name]

    def engines(kv):
        return (jasync.AsyncLLMEngine(jec.EngineConfig(
                    **common, **FIXED, kv_transfer_config=kv),
                    params=weights[2]),
                AsyncLLMEngine(tec.EngineConfig(
                    **common, **FIXED, device="cpu",
                    kv_transfer_config=kv),
                    params=weights[3]))

    async def calls(client, key):
        out = []
        for path, body in (
                ("/admin/kvplane/migrate_out", {"max_seqs": 1}),
                ("/admin/kvplane/warm", {"keys": [key.hex(), "00" * 8]}),
                ("/admin/kvplane/warm", {"keys": "nope"}),
                ("/admin/kvplane/warm", {"keys": ["zz"]})):
            r = await client.post(path, json=body)
            out.append((r.status, await r.json()))
        return out

    async def both(pair, key):
        got = []
        for eng, app in zip(pair, (jserver.build_app(pair[0]),
                                   build_app(pair[1], api_key=""))):
            if key is not None:
                eng.engine.connector.store.put(key, b"chunk")
            async with TestClient(TestServer(app)) as client:
                got.append(await calls(client, key or b"\0"))
        return got

    want, got = asyncio.run(both(engines(
        {"kv_role": "kv_producer", "local_cpu_gb": 0.01,
         "chunk_size": CHUNK}), b"key-1"))
    assert got == want
    assert got[0] == (200, {"migrated": [], "freed_blocks": 0, "keys": []})
    assert got[1] == (200, {"warmed": 1, "missed": 1})
    want, got = asyncio.run(both(engines(None), None))
    assert got == want and got[0][0] == 409


def test_migrated_victim_readmits_by_injection(tmp_path, weights, adapter,
                                               shared):
    """migrate_out of a decoding sequence publishes its chunks and
    preempts it; it re-admits by injection (hit tokens grow by its 3
    chunks) and its tokens equal the JAX engine's; a second replica on
    the same tier warms the returned keys."""
    je, _ = shared
    prompt = _prompt(27)
    want = _run(je, prompt, JSamplingOptions, max_tokens=20)
    kv = {"kv_role": "kv_both", "chunk_size": CHUNK,
          "local_disk_path": str(tmp_path)}
    eng, dest = _port(weights, adapter, kv), _port(weights, adapter, kv)
    try:
        sid = eng.add_request(prompt, SamplingOptions(
            temperature=0.0, max_tokens=20, ignore_eos=True))
        while not eng.seqs[sid].output_tokens:
            eng.step()
        h0 = eng.connector.hit_tokens
        assert eng._inflight   # a window of the victim's
        out = eng.migrate_out(max_seqs=1)
        assert out["migrated"] == [sid] and out["freed_blocks"] > 0
        assert len(out["keys"]) == 3
        assert eng.seqs[sid].kv_prefetch is not None
        n = len(eng.seqs[sid].output_tokens)
        eng.step()
        # re-admitted, prefilled and one new window: the window
        # dispatched before the migration gave it no token
        assert len(eng.seqs[sid].output_tokens) == n + eng.cfg.decode_window
        while eng.has_work:
            eng.step()
        assert eng.connector.hit_tokens == h0 + 96
        assert eng.seqs[sid].output_tokens == want
        assert dest.warm_chunks(out["keys"]) == {"warmed": 3, "missed": 0}
        assert dest.warm_chunks(["xyz"]) == {"warmed": 0, "missed": 1}
        text = eng.render_metrics().decode()
        assert 'tpu:kvplane_migrations_total{model_name="debug-tiny"} 1.0' \
            in text
    finally:
        eng.close()
        dest.close()


# ----------------------------------------------------------------- config

def test_connector_turns_rolling_off_as_in_jax(tmp_path):
    kv = {"chunk_size": CHUNK, "local_disk_path": str(tmp_path)}
    common = dict(model="debug-sliding", max_model_len=256, max_num_seqs=1,
                  prefill_chunk=64, kv_block_size=16)
    for conn in (None, kv):
        je = jengine.LLMEngine(jec.EngineConfig(
            **common, **FIXED, kv_transfer_config=conn))
        te = tengine.LLMEngine(tec.EngineConfig(
            **common, **FIXED, device="cpu", kv_transfer_config=conn))
        assert (te._roll_window is None) == (je._roll_window is None) \
            == (conn is not None)
        for e in (je, te):
            e.close()
