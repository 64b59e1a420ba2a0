"""The port's KV tier codecs (production_stack_tpu_torch/kvcache/codec.py)
and pipelined prefetch walk (kvcache/pipeline.py) against the JAX
package's on the CPU.

The codecs must be byte-compatible: for raw, int8, int4 and fp8 over
bf16 and f32 chunk bodies (seeded draws with outlier rows and the edge
values where the two libraries' casts part: +-464, +-465, +-1000, +-inf,
NaN, subnormals), the port's encoded payload equals the JAX package's,
and each package decodes the other's payload to equal bytes. The JAX
codecs take bfloat16 and e4m3 from ml_dtypes; the port carries them
through numpy bit arithmetic and torch, so ml_dtypes is the reference
here for the casts themselves.
"""

import hashlib
import threading
import time

import ml_dtypes
import numpy as np
import pytest
import torch

from production_stack_tpu.kvcache import codec as jcodec
from production_stack_tpu.kvcache.store import \
    HostMemoryStore as JHostMemoryStore
from production_stack_tpu_torch.kvcache import codec
from production_stack_tpu_torch.kvcache.pipeline import PipelinedFetcher
from production_stack_tpu_torch.kvcache.store import (HostMemoryStore,
                                                      TieredStore)

# NaN and infinities among the values: their int8 / int4 casts warn in
# both packages alike
pytestmark = pytest.mark.filterwarnings("ignore:invalid value encountered")

HEAD_DIM = 64
NP_DTYPES = {"bfloat16": np.dtype(ml_dtypes.bfloat16),
             "float32": np.dtype(np.float32)}
# where torch's casts and ml_dtypes' part, and their neighbours
EDGES = np.array([464.0, -464.0, 465.0, -465.0, 1000.0, -1000.0, np.inf,
                  -np.inf, np.nan, -np.nan, 448.0, 447.9, 470.0, 3e38,
                  2.0 ** -9, -2.0 ** -9, 2.0 ** -10, 1.5 * 2.0 ** -8, 1e-40,
                  -1e-40, 0.0, -0.0], np.float32)


def _values(seed: int, rows: int = 48) -> np.ndarray:
    rng = np.random.default_rng(seed)
    arr = rng.standard_normal((rows, HEAD_DIM)).astype(np.float32)
    arr[::7] *= 40.0           # outlier rows: absmax scaling matters
    arr[3, :len(EDGES)] = EDGES
    arr[5] = 0.0               # an all-zero row: the scale floor
    return arr


def _body(seed: int, dtype: str, rows: int = 48) -> bytes:
    return _values(seed, rows).astype(NP_DTYPES[dtype]).tobytes()


def _connector_value(body: bytes) -> bytes:
    return body + hashlib.blake2b(body, digest_size=8).digest()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", ["raw", "int8", "int4", "fp8"])
def test_payload_bytes_equal_jax_both_ways(name, dtype, seed):
    body = _body(seed, dtype)
    mine = codec.make_codec(name, dtype=dtype, head_dim=HEAD_DIM)
    ref = jcodec.make_codec(name, np_dtype=NP_DTYPES[dtype],
                            head_dim=HEAD_DIM)
    got = codec.encode_payload(mine, body)
    want = jcodec.encode_payload(ref, body)
    assert got == want
    back = jcodec.decode_payload(ref, got, len(body))
    assert back is not None and len(back) == len(body)
    assert codec.decode_payload(mine, want, len(body)) == back


def test_fp8_casts_equal_ml_dtypes_at_the_edges():
    """fp8_encode writes ml_dtypes' e4m3fn bytes, NaN past +-464 and at
    +-inf where torch's own cast saturates to +-448 (0x7e/0xfe), and
    fp8_decode reads every one of the 256 codes as ml_dtypes does."""
    rng = np.random.default_rng(3)
    x = np.concatenate([EDGES, rng.standard_normal(4096).astype(
        np.float32) * 300, np.linspace(440, 490, 501, dtype=np.float32)])
    want = x.astype(ml_dtypes.float8_e4m3fn).view(np.uint8)
    got = np.frombuffer(codec.fp8_encode(x), np.uint8)
    np.testing.assert_array_equal(got, want)
    # the saturation that fp8_encode avoids
    sat = torch.tensor([465.0, float("inf"), -1000.0]).to(
        torch.float8_e4m3fn).view(torch.uint8).tolist()
    assert sat == [0x7E, 0x7E, 0xFE]
    assert np.frombuffer(codec.fp8_encode(np.array(
        [465.0, np.inf, -1000.0], np.float32)), np.uint8).tolist() == \
        [0x7F, 0x7F, 0xFF]
    codes = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(
        codec.fp8_decode(codes.tobytes()).view(np.uint32),
        codes.view(ml_dtypes.float8_e4m3fn).astype(np.float32).view(
            np.uint32))


def test_bf16_bits_equal_ml_dtypes():
    rng = np.random.default_rng(4)
    x = np.concatenate([EDGES, rng.standard_normal(1 << 16).astype(
        np.float32) * np.float32(10.0) ** rng.integers(-40, 38, 1 << 16)
        .astype(np.float32)]).astype(np.float32)
    x = np.concatenate([x, np.array([0x7F800001, 0xFFC00001, 0x7F7FFFFF],
                                    np.uint32).view(np.float32)])
    np.testing.assert_array_equal(
        codec.bf16_bits(x), x.astype(ml_dtypes.bfloat16).view(np.uint16))
    body = x.astype(ml_dtypes.bfloat16).tobytes()
    np.testing.assert_array_equal(
        codec.to_f32(body, "bfloat16").view(np.uint32),
        np.frombuffer(body, ml_dtypes.bfloat16).astype(np.float32).view(
            np.uint32))


@pytest.mark.parametrize("name", ["raw", "int8", "int4", "fp8"])
def test_torn_payload_reads_as_a_miss(name):
    c = codec.make_codec(name, dtype="bfloat16", head_dim=HEAD_DIM)
    body = _body(0, "bfloat16")
    payload = codec.encode_payload(c, body)
    assert codec.decode_payload(c, payload, len(body)) is not None
    for cut in (0, 1, codec.HEADER.size, len(payload) // 2,
                len(payload) - 1):
        assert codec.decode_payload(c, payload[:cut], len(body)) is None
    for pos in (0, 3, len(payload) // 2, len(payload) - 1):
        torn = bytearray(payload)
        torn[pos] ^= 0x40
        assert codec.decode_payload(c, bytes(torn), len(body)) is None
    assert codec.decode_payload(c, payload, len(body) + 2 * HEAD_DIM) \
        is None


def test_foreign_codec_payload_is_a_miss_in_both_packages():
    body = _body(1, "bfloat16")
    int8 = codec.make_codec("int8", dtype="bfloat16", head_dim=HEAD_DIM)
    raw = codec.make_codec("raw", dtype="bfloat16", head_dim=HEAD_DIM)
    jraw = jcodec.make_codec("raw", np_dtype=NP_DTYPES["bfloat16"],
                             head_dim=HEAD_DIM)
    payload = codec.encode_payload(int8, body)
    assert codec.decode_payload(raw, payload, len(body)) is None
    assert jcodec.decode_payload(jraw, payload, len(body)) is None
    with pytest.raises(ValueError, match="unknown KV codec"):
        codec.make_codec("zstd", dtype="bfloat16", head_dim=HEAD_DIM)


def test_codec_stores_hold_each_others_payloads():
    """A JAX CodecStore's stored payload is the port's, byte for byte,
    and the port's CodecStore serves it with a fresh connector digest;
    a torn payload is rejected, evicted and healed by a republish."""
    body = _body(2, "bfloat16", rows=64)
    value = _connector_value(body)
    jinner = JHostMemoryStore(1 << 20, force_python=True)
    jst = jcodec.CodecStore(jinner, jcodec.make_codec(
        "int4", np_dtype=NP_DTYPES["bfloat16"], head_dim=HEAD_DIM),
        chunk_body_bytes=len(body))
    inner = HostMemoryStore(1 << 20, force_python=True)
    st = codec.CodecStore(inner, codec.make_codec(
        "int4", dtype="bfloat16", head_dim=HEAD_DIM),
        chunk_body_bytes=len(body))
    assert jst.put(b"k", value) and st.put(b"k", value)
    assert inner.get(b"k") == jinner.get(b"k")
    got = st.get(b"k")
    assert got == jst.get(b"k")
    assert hashlib.blake2b(got[:-8], digest_size=8).digest() == got[-8:]
    assert not st.put(b"t", value[:-3])           # torn before encoding
    inner.put(b"k", inner.get(b"k")[:100])        # torn on the tier
    assert st.get(b"k") is None and st.rejects == 1
    assert not inner.exists(b"k")
    assert st.put(b"k", value) and st.get(b"k") == got
    s = st.codec_stats()
    assert s["codec"] == "int4" and 0 < s["bytes_out"] < s["bytes_in"]


def test_apply_tier_codecs_promotes_through_the_codec():
    """disk int8-wrapped, cpu raw: a disk hit promotes the DECODED
    connector value into cpu; codec_stats_of lists the disk tier."""
    body = _body(3, "float32", rows=16)
    cpu = HostMemoryStore(1 << 20, force_python=True)
    disk = HostMemoryStore(1 << 20, force_python=True)
    disk.tier_name = "disk"
    tiered = codec.apply_tier_codecs(
        TieredStore([cpu, disk]), {"disk": "int8"}, dtype=torch.float32,
        head_dim=HEAD_DIM, chunk_body_bytes=len(body))
    assert isinstance(tiered.tiers[1], codec.CodecStore)
    assert tiered.put(b"k", _connector_value(body))
    cpu.delete(b"k")
    val, tier = tiered.get_with_tier(b"k")
    assert tier == "disk" and cpu.get(b"k") == val
    assert len(disk.get(b"k")) < len(body)
    assert [s["tier"] for s in codec.codec_stats_of(tiered)] == ["disk"]
    with pytest.raises(ValueError, match="unknown tier"):
        codec.apply_tier_codecs(cpu, {"hbm": "int8"}, dtype="float32",
                                head_dim=HEAD_DIM, chunk_body_bytes=64)


# ------------------------------------------------- pipelined prefetch walk

def _keys(n):
    return [bytes([i]) * 8 for i in range(n)]


def test_fetch_walk_in_order_stops_at_first_miss_or_error():
    data = {k: b"v" + k for k in _keys(8)}
    del data[_keys(8)[5]]

    def get_fn(k):
        if k == _keys(8)[7]:
            raise OSError("sick tier")
        return data.get(k), "cpu"

    fetcher = PipelinedFetcher(workers=4)
    try:
        results, stats = fetcher.fetch_walk(_keys(8), get_fn, budget_s=5.0)
        errs, _ = fetcher.fetch_walk(_keys(8)[6:], get_fn, budget_s=5.0)
    finally:
        fetcher.close()
    assert [k for k, _, _ in results] == _keys(8)[:5]
    assert all(v == b"v" + k for k, v, _ in results)
    assert stats.pipelined_fetches > 0
    assert stats.deadline_hits == 0 and stats.chunk_deadline_hits == 0
    assert [k for k, _, _ in errs] == _keys(8)[6:7]


def test_fetch_walk_stall_is_cut_at_its_fair_share():
    """Chunk 0 of 8 stalls: it is abandoned after about budget / 8, not
    after the whole budget."""
    stall = threading.Event()

    def get_fn(k):
        if k == _keys(8)[0]:
            stall.wait(10.0)
            return None, None
        return b"v", "cpu"

    fetcher = PipelinedFetcher(workers=4)
    t0 = time.monotonic()
    try:
        results, stats = fetcher.fetch_walk(_keys(8), get_fn, budget_s=2.0)
    finally:
        elapsed = time.monotonic() - t0
        stall.set()
        fetcher.close()
    assert results == [] and stats.chunk_deadline_hits == 1
    assert elapsed < 1.0, elapsed
