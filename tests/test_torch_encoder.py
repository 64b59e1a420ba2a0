"""The PyTorch port's BERT encoder (models/encoder.py) and the engine's
``embedding_model`` against the JAX package and HuggingFace on the CPU:
``encode`` on debug-encoder with the JAX weights carried across (f32),
an HF ``BertModel`` directory (safetensors and .bin) against HF's mean
pooling, padding invariance, the engine's embedding source, length cap,
out-of-vocab refusal and startup errors as the JAX engine's, and
/v1/embeddings from one checkpoint directory through both servers.
"""

import asyncio
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers
from aiohttp.test_utils import TestClient, TestServer

from production_stack_tpu.engine import async_engine as jasync
from production_stack_tpu.engine import config as jec
from production_stack_tpu.engine import engine as jengine
from production_stack_tpu.engine import server as jserver
from production_stack_tpu.models import encoder as jenc
from production_stack_tpu_torch.engine import config as tec
from production_stack_tpu_torch.engine import engine as tengine
from production_stack_tpu_torch.engine import server as tserver
from production_stack_tpu_torch.engine.async_engine import AsyncLLMEngine
from production_stack_tpu_torch.models import encoder as tenc
from production_stack_tpu_torch.weights import encoder_params_from_jax

COMMON = dict(model="debug-tiny", max_model_len=128, max_num_seqs=2,
              prefill_chunk=32, prefill_buckets=(16, 32))


def _ragged(lens, vocab, seed):
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lens), max(lens)), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, vocab, size=n)
    return toks, np.asarray(lens, np.int32)


def _encode_port(params, cfg, toks, lens):
    return tenc.encode(params, cfg, torch.from_numpy(toks).long(),
                       torch.from_numpy(lens).long()).numpy()


def test_encode_equals_jax_debug_encoder():
    """debug-encoder with the JAX init carried across: pooled vectors
    and the valid rows of the hidden states within 1e-5 (f32)."""
    jcfg = jenc.get_encoder_config("debug-encoder")
    tcfg = tenc.get_encoder_config("debug-encoder")
    jparams = jenc.init_params(jcfg, jax.random.PRNGKey(3))
    tparams = encoder_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    toks, lens = _ragged([17, 9, 40, 1], jcfg.vocab_size, 0)
    want = np.asarray(jenc.encode(jparams, jcfg, jnp.asarray(toks),
                                  jnp.asarray(lens)))
    got = _encode_port(tparams, tcfg, toks, lens)
    assert got.dtype == np.float32 and got.shape == (4, 64)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    hj = np.asarray(jenc.encode_hidden(jparams, jcfg, jnp.asarray(toks),
                                       jnp.asarray(lens)))
    ht = tenc.encode_hidden(tparams, tcfg, torch.from_numpy(toks).long(),
                            torch.from_numpy(lens).long()).numpy()
    for i, n in enumerate(lens):
        np.testing.assert_allclose(ht[i, :n], hj[i, :n], atol=1e-5, rtol=0)


def _write_tokenizer(path, extra=0):
    """A BERT WordPiece tokenizer saved into `path` (vocab.txt and its
    config): the special tokens, letters, digits, punctuation, their
    ## continuations and a few words, plus `extra` filler entries."""
    chars = list("abcdefghijklmnopqrstuvwxyz0123456789.,!?")
    words = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + chars
             + ["##" + c for c in chars]
             + ["rivers", "run", "to", "the", "sea", "tea"]
             + [f"[unused{i}]" for i in range(extra)])
    vocab = os.path.join(path, "vocab.txt")
    os.makedirs(path, exist_ok=True)
    with open(vocab, "w") as f:
        f.write("\n".join(words) + "\n")
    transformers.BertTokenizer(vocab).save_pretrained(path)
    return len(words)


def _tiny_bert(vocab=256, seed=0):
    hf_cfg = transformers.BertConfig(
        vocab_size=vocab, hidden_size=64, intermediate_size=128,
        num_hidden_layers=3, num_attention_heads=4,
        max_position_embeddings=96, type_vocab_size=2,
        layer_norm_eps=1e-12, attn_implementation="eager")
    torch.manual_seed(seed)
    return transformers.BertModel(hf_cfg).eval().to(torch.float32)


@pytest.mark.parametrize("safe", [True, False], ids=["safetensors", "bin"])
def test_hf_bert_directory_equals_hf_mean_pooling(tmp_path, safe):
    """A random-init BertModel saved to a directory, read by the port's
    own reader (config.json, then *.safetensors or *.bin): its pooled
    vectors against HF's mean pooling within 1e-4 (tests/test_encoder.py's
    bound), and equal to the JAX package's read of the same directory
    within 1e-5."""
    hf = _tiny_bert()
    hf.save_pretrained(tmp_path, safe_serialization=safe)
    with open(tmp_path / "config.json") as f:
        raw = json.load(f)
    cfg = tenc.config_from_hf_json(raw, name="tiny-bert")
    assert (cfg.vocab_size, cfg.hidden_size, cfg.num_layers,
            cfg.num_heads, cfg.max_position_embeddings) == (256, 64, 3, 4,
                                                            96)
    params = tenc.load_checkpoint(cfg, str(tmp_path), device="cpu")
    toks, lens = _ragged([17, 9, 24], cfg.vocab_size, 0)
    mask = (np.arange(toks.shape[1])[None] < lens[:, None]).astype(np.int64)
    with torch.no_grad():
        h = hf(input_ids=torch.from_numpy(toks).long(),
               attention_mask=torch.from_numpy(mask)).last_hidden_state
        m = torch.from_numpy(mask)[:, :, None].float()
        want = ((h * m).sum(1) / m.sum(1)).numpy()
    got = _encode_port(params, cfg, toks, lens)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    jcfg = jenc.config_from_hf_json(raw, name="tiny-bert")
    jparams = jenc.load_checkpoint(jcfg, str(tmp_path))
    jgot = np.asarray(jenc.encode(jparams, jcfg, jnp.asarray(toks),
                                  jnp.asarray(lens)))
    np.testing.assert_allclose(got, jgot, atol=1e-5, rtol=0)


def test_padding_invariance():
    """Extra right-padding leaves a row's vector alone (padding keys out
    of every softmax, padding rows out of the mean), also beside a long
    row in one batch."""
    cfg = tenc.get_encoder_config("debug-encoder")
    params = tenc.init_params(cfg, torch.Generator().manual_seed(1),
                              device="cpu")
    row = np.random.default_rng(1).integers(0, cfg.vocab_size, size=12)
    short = row[None].astype(np.int32)
    padded = np.zeros((2, 128), np.int32)
    padded[0, :12] = row
    padded[1] = np.random.default_rng(2).integers(0, cfg.vocab_size, 128)
    a = _encode_port(params, cfg, short, np.array([12], np.int32))
    b = _encode_port(params, cfg, padded, np.array([12, 128], np.int32))
    np.testing.assert_allclose(a[0], b[0], atol=1e-5, rtol=1e-5)


def test_engine_embedding_surface_equals_jax():
    """EngineConfig(embedding_model="debug-encoder") in both packages:
    embedding_source encoder:debug-encoder, the encoder's position table
    as the length cap, vectors of the encoder's width, the same refusal
    of an id outside the encoder's vocabulary; without it
    causal-mean-pool and max_model_len."""
    je = jengine.LLMEngine(jec.EngineConfig(
        **COMMON, embedding_model="debug-encoder"))
    te = tengine.LLMEngine(tec.EngineConfig(
        **COMMON, device="cpu", embedding_model="debug-encoder"))
    got = {}
    for name, eng in (("jax", je), ("port", te)):
        vecs = eng.embed_tokens([[1, 2, 3], [4, 5, 6, 7, 8]])
        assert np.isfinite(vecs).all()
        np.testing.assert_array_equal(
            vecs, eng.embed_tokens([[1, 2, 3], [4, 5, 6, 7, 8]]))
        with pytest.raises(ValueError) as err:
            eng.embed_tokens([[1, 512]])
        got[name] = (eng.embedding_source, eng.max_embed_len, vecs.shape,
                     str(err.value), eng.embedding_tokenizer.vocab_size)
    assert got["port"] == got["jax"] == (
        "encoder:debug-encoder", 128, (2, 64),
        "token id 512 out of range for the embedding encoder vocab (512)",
        512)
    plain = tengine.LLMEngine(tec.EngineConfig(**COMMON, device="cpu"))
    assert plain.embedding_source == "causal-mean-pool"
    assert plain.max_embed_len == 128


def test_bad_encoder_preset_fails_at_startup():
    """An unknown preset raises at engine start in both packages."""
    for mod_ec, mod_eng, kw in ((jec, jengine, {}),
                                (tec, tengine, {"device": "cpu"})):
        cfg = mod_ec.EngineConfig(**COMMON, **kw, embedding_model="nope-42")
        with pytest.raises(ValueError, match="unknown encoder preset"):
            mod_eng.LLMEngine(cfg)


@pytest.mark.parametrize("case", ["no_files_small_vocab", "no_files",
                                  "tokenizer_past_vocab", "own_tokenizer"])
def test_checkpoint_tokenizer_at_startup(tmp_path, case):
    """An encoder directory's tokenizer, at engine start:
    - no tokenizer files, the byte fallback's 512 ids past the
      encoder's 256: both packages raise;
    - no tokenizer files, 600 ids: the JAX engine takes the byte
      fallback (its ids fit), the port raises (ROADMAP Queue C item 13:
      a tokenizer that is not the checkpoint's reads text meaninglessly);
    - the directory's tokenizer past the encoder's vocabulary: both
      raise;
    - its own tokenizer within the vocabulary: both serve it."""
    vocab = 256 if case in ("no_files_small_vocab",
                            "tokenizer_past_vocab") else 600
    _tiny_bert(vocab=vocab).save_pretrained(tmp_path)
    if case == "tokenizer_past_vocab":
        assert _write_tokenizer(tmp_path, extra=200) > vocab
    if case == "own_tokenizer":
        _write_tokenizer(tmp_path)
    raised = {}
    for name, mod_ec, mod_eng, kw in (("jax", jec, jengine, {}),
                                      ("port", tec, tengine,
                                       {"device": "cpu"})):
        cfg = mod_ec.EngineConfig(**COMMON, **kw,
                                  embedding_model=str(tmp_path))
        try:
            eng = mod_eng.LLMEngine(cfg)
        except ValueError as e:
            assert "no usable tokenizer" in str(e)
            raised[name] = True
        else:
            raised[name] = False
            assert eng.embedding_source == f"encoder:{tmp_path.name}"
    want = {"no_files_small_vocab": (True, True), "no_files": (False, True),
            "tokenizer_past_vocab": (True, True),
            "own_tokenizer": (False, False)}[case]
    assert (raised["jax"], raised["port"]) == want


def test_embeddings_route_from_one_directory_equals_jax(tmp_path):
    """/v1/embeddings from one HF directory (--embedding-model DIR)
    through the JAX and the port server: the same embedding_source
    (encoder:<dir name>), usage and vectors within 1e-5, string inputs
    tokenized by the directory's own WordPiece tokenizer."""
    d = tmp_path / "tiny-bert"
    _tiny_bert(vocab=600, seed=4).save_pretrained(d)
    _write_tokenizer(d)
    inputs = ["Rivers run to the sea.", "Tea.", "x" * 90]
    engines = (
        jasync.AsyncLLMEngine(jec.EngineConfig(**COMMON,
                                               embedding_model=str(d))),
        AsyncLLMEngine(tec.EngineConfig(**COMMON, device="cpu",
                                        embedding_model=str(d))))
    app_makers = (jserver.build_app, tserver.build_app)

    async def call(app):
        async with TestClient(TestServer(app)) as client:
            r = await client.post("/v1/embeddings", json={
                "model": "debug-tiny", "input": inputs})
            assert r.status == 200, await r.text()
            body = await r.json()
            r = await client.post("/v1/embeddings", json={
                "model": "debug-tiny", "input": "y" * 97})
            return body, r.status
    (jbody, jlong), (tbody, tlong) = [
        asyncio.run(call(build(e, api_key="")))
        for build, e in zip(app_makers, engines)]
    assert tbody["embedding_source"] == jbody["embedding_source"] == \
        "encoder:tiny-bert"
    assert tbody["usage"] == jbody["usage"]
    assert tbody["usage"]["prompt_tokens"] == 8 + 4 + 92   # [CLS] .. [SEP]
    assert tlong == jlong == 400      # past the 96-position table
    np.testing.assert_allclose(
        np.array([x["embedding"] for x in tbody["data"]]),
        np.array([x["embedding"] for x in jbody["data"]]), atol=1e-5,
        rtol=0)
    assert os.path.isdir(d)
