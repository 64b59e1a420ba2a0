"""The port's HF checkpoint loader against the JAX package's on the CPU:
params from random-init ``transformers`` models (Llama and Gemma-2,
the configurations of tests/test_model_numerics.py and
tests/test_gemma2.py) equal the JAX loader's bit for bit in float32,
and the port's logits equal HF's within JAX's tolerance there (1e-2);
Mixtral, Qwen2 (q/k/v biases), Qwen2-MoE (shared expert) and Mistral
with a sliding window, saved by ``transformers`` and read back through
the port's reader, equal the JAX loader's output on the same files (and
their logits JAX's to 1e-4, HF's to 1e-2); the port's own safetensors
reader and writer against the ``safetensors`` package (F32, F16, BF16,
two shards); the .bin fallback, the errors; an engine started on a
checkpoint directory (greedy tokens equal the JAX engine's on the same
directory, exactly).
"""

import os

# transformers imports TensorFlow where it finds it (~9 s here), which
# these tests do not use
os.environ.setdefault("USE_TF", "0")

import jax  # noqa: E402
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.engine import config as jec
from production_stack_tpu.engine import engine as jengine
from production_stack_tpu.engine.scheduler import (
    SamplingOptions as JSamplingOptions)
from production_stack_tpu.models import hf_loader as jloader
from production_stack_tpu.models import llama as jllama
from production_stack_tpu.models.config import ModelConfig as JModelConfig
from production_stack_tpu_torch.engine import config as tec
from production_stack_tpu_torch.engine import engine as tengine
from production_stack_tpu_torch.engine.scheduler import SamplingOptions
from production_stack_tpu_torch.models import config as tconfig
from production_stack_tpu_torch.models import hf_loader as tloader
from production_stack_tpu_torch.models import llama as tllama
from production_stack_tpu_torch.models.kv import make_slot_cache

from tests.torch_geometry import FIXED

transformers = pytest.importorskip("transformers")
st_torch = pytest.importorskip("safetensors.torch")


def _llama_hf():
    hf_cfg = transformers.LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, rms_norm_eps=1e-5, rope_theta=10000.0,
        tie_word_embeddings=False, attn_implementation="eager")
    torch.manual_seed(0)
    return hf_cfg, transformers.LlamaForCausalLM(hf_cfg).eval().float()


def _gemma2_hf():
    hf_cfg = transformers.Gemma2Config(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, max_position_embeddings=128, rms_norm_eps=1e-6,
        rope_theta=10000.0, sliding_window=16, query_pre_attn_scalar=24.0,
        attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
        hidden_activation="gelu_pytorch_tanh", tie_word_embeddings=True,
        attn_implementation="eager")
    torch.manual_seed(3)
    return hf_cfg, transformers.Gemma2ForCausalLM(hf_cfg).eval().float()


@pytest.fixture(scope="module", params=["llama", "gemma2"])
def hf(request):
    hf_cfg, model = {"llama": _llama_hf, "gemma2": _gemma2_hf}[
        request.param]()
    d = hf_cfg.to_dict()
    return (JModelConfig.from_hf_config(d, name="tiny", dtype=jnp.float32),
            tconfig.ModelConfig.from_hf_config(d, name="tiny",
                                               dtype=torch.float32),
            model)


def test_params_equal_the_jax_loaders(hf):
    """Every parameter equals the JAX loader's, bit for bit (float32),
    sandwich-norm renames and tied embeddings included."""
    jcfg, tcfg, model = hf
    sd = model.state_dict()
    jparams = jloader.params_from_state_dict(jcfg, sd)
    tparams = tloader.params_from_state_dict(tcfg, sd, device="cpu")
    names = dict(tparams.named_parameters())
    assert ("lm_head" in names) == (not tcfg.tie_word_embeddings)
    assert ("post_mlp_norm" in names) == tcfg.sandwich_norms
    for name, p in names.items():
        src = (jparams["layers"][name] if name in tllama.LAYER_KEYS
               else jparams[name])
        np.testing.assert_array_equal(p.numpy(), np.asarray(src))


def test_logits_match_hf(hf):
    """A 40-token prompt (past Gemma-2's 16-token window) through the
    port's forward over a paged pool: logits within 1e-2 of HF's, the
    tolerance the JAX package holds its loader to."""
    _, tcfg, model = hf
    params = tloader.params_from_state_dict(tcfg, model.state_dict(),
                                            device="cpu")
    toks = np.random.default_rng(4).integers(0, 256, size=(2, 40))
    with torch.no_grad():
        ref = model(torch.tensor(toks)).logits.numpy()
    cache, tables = make_slot_cache(
        tcfg.num_layers, 2, 48, tcfg.num_kv_heads, tcfg.head_dim_,
        dtype=torch.float32, block_size=16, device="cpu")
    logits, _ = tllama.forward(
        params, tcfg, torch.from_numpy(toks).to(torch.int32),
        torch.arange(40, dtype=torch.int32)[None].expand(2, -1), cache,
        block_tables=tables, kv_len=48)
    np.testing.assert_allclose(logits.numpy(), ref, atol=1e-2, rtol=0)


# ------------------------------------------------------------ safetensors

def _tensors(dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return {f"t{seed}.{i}": (torch.randn(shape, generator=g) * 3).to(dtype)
            for i, shape in enumerate([(7, 5), (3,), (2, 3, 4), (1, 1)])}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
def test_reader_matches_safetensors_on_two_shards(tmp_path, dtype):
    """Two shards written by the safetensors package read back equal,
    dtype and bits, through the port's reader — one file at a time and
    as a checkpoint directory."""
    shards = [_tensors(dtype, 0), _tensors(dtype, 1)]
    for i, tensors in enumerate(shards):
        st_torch.save_file(tensors, str(tmp_path / f"model-{i}.safetensors"),
                           metadata={"format": "pt"})
    merged = {}
    for i in range(2):
        path = str(tmp_path / f"model-{i}.safetensors")
        want, got = st_torch.load_file(path), tloader.read_safetensors(path)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype == dtype
            assert torch.equal(got[k], want[k])
        merged.update(want)
    sd = tloader.read_state_dict(str(tmp_path))
    assert sorted(sd) == sorted(merged)
    assert all(torch.equal(sd[k], merged[k]) for k in merged)


def test_writer_is_read_by_safetensors(tmp_path):
    """What the port writes (bf16, f16, f32, int8 and a scalar) the
    safetensors package reads back bit for bit, and so does the port."""
    tensors = {**_tensors(torch.bfloat16, 2), **_tensors(torch.float16, 3),
               **_tensors(torch.float32, 4),
               "i8": torch.arange(-5, 5, dtype=torch.int8),
               "scalar": torch.tensor(2.5)}
    path = str(tmp_path / "w.safetensors")
    tloader.save_safetensors(tensors, path)
    for got in (st_torch.load_file(path), tloader.read_safetensors(path)):
        assert sorted(got) == sorted(tensors)
        for k, t in tensors.items():
            assert got[k].dtype == t.dtype and torch.equal(got[k], t)


def test_bin_fallback_and_errors(tmp_path):
    """A directory of .bin files loads as the safetensors one does; an
    empty directory raises FileNotFoundError, a missing tensor KeyError,
    as in JAX."""
    hf_cfg, model = _llama_hf()
    tcfg = tconfig.ModelConfig.from_hf_config(hf_cfg.to_dict(),
                                              dtype=torch.float32)
    sd = model.state_dict()
    torch.save(sd, str(tmp_path / "pytorch_model.bin"))
    got = tloader.load_checkpoint(tcfg, str(tmp_path), device="cpu")
    want = tloader.params_from_state_dict(tcfg, sd, device="cpu")
    for (n, p), (_, q) in zip(got.named_parameters(),
                              want.named_parameters()):
        assert torch.equal(p, q), n
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        tloader.read_state_dict(str(empty))
    partial = {k: v for k, v in sd.items() if "layers.1.mlp.up" not in k}
    with pytest.raises(KeyError, match="missing weight"):
        tloader.params_from_state_dict(tcfg, partial, device="cpu")
    with pytest.raises(KeyError, match="missing weight"):
        jloader.params_from_state_dict(
            JModelConfig.from_hf_config(hf_cfg.to_dict(),
                                        dtype=jnp.float32), partial)


@pytest.mark.parametrize("preset", ["qwen2-7b", "debug-moe"])
def test_unported_families_refused_before_reading(tmp_path, preset):
    """Qwen2's q/k/v bias and MoE are no longer refused before reading:
    a missing directory raises FileNotFoundError from the reader, and a
    checkpoint of the family without its bias or expert tensors raises
    KeyError naming the first one missing, as the JAX loader does."""
    family = {"qwen2-7b": "qwen2", "debug-moe": "mixtral"}[preset]
    hf_cfg, model = FAMILIES[family]()
    tcfg = tconfig.ModelConfig.from_hf_config(hf_cfg.to_dict(),
                                              dtype=torch.float32)
    assert tcfg.attention_bias if family == "qwen2" else tcfg.num_experts
    with pytest.raises(FileNotFoundError):
        tloader.load_checkpoint(tcfg, str(tmp_path / "missing"),
                                device="cpu")
    gone = "q_proj.bias" if family == "qwen2" else "experts.1.w3"
    partial = {k: v for k, v in model.state_dict().items() if gone not in k}
    with pytest.raises(KeyError, match=gone):
        tloader.params_from_state_dict(tcfg, partial, device="cpu")
    with pytest.raises(KeyError, match=gone):
        jloader.params_from_state_dict(
            JModelConfig.from_hf_config(hf_cfg.to_dict(),
                                        dtype=jnp.float32), partial)


# ----------------------------------------------- MoE, bias, window families

def _mixtral_hf():
    hf_cfg = transformers.MixtralConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, rms_norm_eps=1e-5, rope_theta=10000.0,
        num_local_experts=4, num_experts_per_tok=2,
        tie_word_embeddings=False, attn_implementation="eager")
    torch.manual_seed(3)
    return hf_cfg, transformers.MixtralForCausalLM(hf_cfg).eval().float()


def _qwen2_hf():
    hf_cfg = transformers.Qwen2Config(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, rms_norm_eps=1e-6, rope_theta=10000.0,
        tie_word_embeddings=False, attn_implementation="eager")
    torch.manual_seed(5)
    return hf_cfg, _random_biases(
        transformers.Qwen2ForCausalLM(hf_cfg).eval().float())


def _qwen2_moe_hf():
    hf_cfg = transformers.Qwen2MoeConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        moe_intermediate_size=48, shared_expert_intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, rms_norm_eps=1e-5, rope_theta=10000.0,
        num_experts=4, num_experts_per_tok=2, norm_topk_prob=False,
        decoder_sparse_step=1, mlp_only_layers=[],
        tie_word_embeddings=False, attn_implementation="eager")
    torch.manual_seed(4)
    return hf_cfg, _random_biases(
        transformers.Qwen2MoeForCausalLM(hf_cfg).eval().float())


def _mistral_hf():
    hf_cfg = transformers.MistralConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, rms_norm_eps=1e-5, rope_theta=10000.0,
        sliding_window=16, tie_word_embeddings=False,
        attn_implementation="eager")
    torch.manual_seed(6)
    return hf_cfg, transformers.MistralForCausalLM(hf_cfg).eval().float()


def _random_biases(model):
    """HF initialises the q/k/v biases to zero: draw them, so the bias
    path moves the logits."""
    with torch.no_grad():
        for layer in model.model.layers:
            for proj in ("q_proj", "k_proj", "v_proj"):
                getattr(layer.self_attn, proj).bias.normal_(0.0, 0.1)
    return model


FAMILIES = {"mixtral": _mixtral_hf, "qwen2": _qwen2_hf,
            "qwen2_moe": _qwen2_moe_hf, "mistral": _mistral_hf}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_checkpoint_loads_as_the_jax_loader_reads_it(tmp_path,
                                                            family):
    """transformers writes the model (config.json + model.safetensors);
    the port's reader and the JAX loader (the safetensors package) read
    the same files: every parameter bit-equal in float32, the port's
    logits of a 40-token prompt (past Mistral's 16-token window) within
    1e-4 of the JAX forward's and 1e-2 of HF's."""
    hf_cfg, model = FAMILIES[family]()
    model.save_pretrained(str(tmp_path))
    d = hf_cfg.to_dict()
    jcfg = JModelConfig.from_hf_config(d, name=family, dtype=jnp.float32)
    tcfg = tconfig.ModelConfig.from_hf_config(d, name=family,
                                              dtype=torch.float32)
    if family == "mistral":
        assert tcfg.sliding_window == 16 and not tcfg.alternating_sliding
    jparams = jloader.load_checkpoint(jcfg, str(tmp_path))
    tparams = tloader.load_checkpoint(tcfg, str(tmp_path), device="cpu")
    for name, p in tparams.named_parameters():
        src = (jparams["layers"][name] if name in tllama.LAYER_KEYS
               else jparams[name])
        np.testing.assert_array_equal(p.numpy(), np.asarray(src))
    toks = np.random.default_rng(4).integers(0, 256, size=(2, 40))
    with torch.no_grad():
        ref = model(torch.tensor(toks)).logits.numpy()
    cache, tables = make_slot_cache(
        tcfg.num_layers, 2, 48, tcfg.num_kv_heads, tcfg.head_dim_,
        dtype=torch.float32, block_size=16, device="cpu")
    logits, _ = tllama.forward(
        tparams, tcfg, torch.from_numpy(toks).to(torch.int32),
        torch.arange(40, dtype=torch.int32)[None].expand(2, -1), cache,
        block_tables=tables, kv_len=48)
    want = np.asarray(jllama.forward_train(jparams, jcfg,
                                           jnp.asarray(toks)))
    np.testing.assert_allclose(logits.numpy(), want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(logits.numpy(), ref, atol=1e-2, rtol=0)


def test_checkpoint_engine_tokens_equal_jax(tmp_path):
    """An engine started with model = checkpoint = a directory written by
    transformers (config.json + model.safetensors): greedy tokens of a
    mixed batch equal the JAX engine's on the same directory, and the
    loaded weights equal the file's."""
    hf_cfg, model = _llama_hf()
    model.save_pretrained(str(tmp_path))
    assert os.path.exists(tmp_path / "model.safetensors")
    common = dict(model=str(tmp_path), checkpoint=str(tmp_path),
                  dtype="float32", kv_dtype="float32", max_model_len=64,
                  max_num_seqs=2, prefill_chunk=16, prefill_buckets=(16,),
                  decode_window=4, kv_block_size=8)
    te = tengine.LLMEngine(tec.EngineConfig(**common, device="cpu",
                                            **FIXED))
    je = jengine.LLMEngine(jec.EngineConfig(**common, **FIXED))
    assert torch.equal(te.runner.params.lm_head,
                       model.lm_head.weight.t().contiguous())
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 256, n).tolist() for n in (5, 21, 9)]

    def run(engine, opts_cls):
        ids = [engine.add_request(p, opts_cls(temperature=0.0,
                                              max_tokens=8,
                                              ignore_eos=True))
               for p in prompts]
        while engine.has_work:
            engine.step()
        return [engine.seqs[i].output_tokens for i in ids]

    got = run(te, SamplingOptions)
    assert got == run(je, JSamplingOptions)
    assert [len(t) for t in got] == [8, 8, 8]


# ------------------------------------------------------- int8, a layer a time

def _debug_moe_mixtral_dir(path):
    """transformers' Mixtral at debug-moe's widths (vocab 512, hidden
    128, 2 layers, 4 q over 2 kv heads, 4 experts of 256, top-2), saved
    in bf16 as safetensors shards of at most 200 KB with their index."""
    hf_cfg = transformers.MixtralConfig(
        vocab_size=512, hidden_size=128, intermediate_size=256,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=512, rms_norm_eps=1e-5, rope_theta=1e6,
        num_local_experts=4, num_experts_per_tok=2,
        tie_word_embeddings=False, torch_dtype="bfloat16")
    torch.manual_seed(8)
    model = transformers.MixtralForCausalLM(hf_cfg).to(torch.bfloat16)
    model.save_pretrained(str(path), max_shard_size="200KB")


def test_int8_checkpoint_load_bit_equal_load_then_quantize(tmp_path,
                                                           monkeypatch):
    """A Mixtral-named directory at debug-moe's widths in several bf16
    safetensors shards, loaded with quantization="int8": each tensor is
    read from its byte range (read_state_dict is never called) and each
    layer quantized as it lands; w8, scale and the bf16 leaves equal
    quantize_params of the whole bf16 read bit for bit; each rank's
    slice at tp = 2, ep = 2 and ep = 2 x tp = 2 equals shard_params of
    it; an int8 engine on the directory holds the same weights."""
    from production_stack_tpu_torch.models import quant as tquant
    from production_stack_tpu_torch.parallel import sharding
    from production_stack_tpu_torch.parallel.mesh import MeshConfig, Shard
    _debug_moe_mixtral_dir(tmp_path)
    assert len(list(tmp_path.glob("*.safetensors"))) >= 2
    cfg = tconfig.get_config(str(tmp_path))
    assert (cfg.dtype, cfg.num_experts, cfg.moe_naming) == (
        torch.bfloat16, 4, "mixtral")
    want = tquant.quantize_params(tloader.params_from_state_dict(
        cfg, tloader.read_state_dict(str(tmp_path)), device="cpu"))

    def same(got, ref):
        a, b = got.state_dict(), ref.state_dict()
        assert sorted(a) == sorted(b)
        for name in a:
            assert a[name].dtype == b[name].dtype, name
            assert torch.equal(a[name], b[name]), name

    def refused(path):
        raise AssertionError("the int8 load read the checkpoint whole")
    with monkeypatch.context() as m:
        m.setattr(tloader, "read_state_dict", refused)
        got = tloader.load_checkpoint(cfg, str(tmp_path), device="cpu",
                                      quantization="int8")
        same(got, want)
        assert tquant.is_quantized(got.gate) and got.gate.w8.shape == (
            2, 4, 128, 256)
        for mesh in (MeshConfig(tp=2), MeshConfig(ep=2),
                     MeshConfig(ep=2, tp=2)):
            for rank in range(mesh.size):
                shard = Shard.of(mesh, rank)
                same(tloader.load_checkpoint(cfg, str(tmp_path),
                                             device="cpu",
                                             quantization="int8",
                                             shard=shard),
                     sharding.shard_params(want, shard))
        eng = tengine.LLMEngine(tec.EngineConfig(
            model=str(tmp_path), checkpoint=str(tmp_path), device="cpu",
            dtype="bfloat16", quantization="int8", max_model_len=64,
            max_num_seqs=2, tokenizer="byte"))
        same(eng.runner.params, want)


def test_checkpoint_load_reads_a_tensor_at_a_time(tmp_path, monkeypatch):
    """Every safetensors directory is read a tensor at a time, in the
    model dtype too: the bf16 load of debug-moe's Mixtral shards equals
    the whole read bit for bit, each rank's slice at tp = 2, ep = 2 and
    ep = 2 x tp = 2 equals shard_params of it, and a bf16 engine on the
    directory holds it."""
    from production_stack_tpu_torch.parallel import sharding
    from production_stack_tpu_torch.parallel.mesh import MeshConfig, Shard
    _debug_moe_mixtral_dir(tmp_path)
    cfg = tconfig.get_config(str(tmp_path))
    want = tloader.params_from_state_dict(
        cfg, tloader.read_state_dict(str(tmp_path)), device="cpu")

    def same(got, ref):
        a, b = got.state_dict(), ref.state_dict()
        assert sorted(a) == sorted(b)
        for name in a:
            assert a[name].dtype == b[name].dtype == torch.bfloat16, name
            assert torch.equal(a[name], b[name]), name

    def refused(path):
        raise AssertionError("the load read the checkpoint whole")
    with monkeypatch.context() as m:
        m.setattr(tloader, "read_state_dict", refused)
        same(tloader.load_checkpoint(cfg, str(tmp_path), device="cpu"),
             want)
        for mesh in (MeshConfig(tp=2), MeshConfig(ep=2),
                     MeshConfig(ep=2, tp=2)):
            for rank in range(mesh.size):
                shard = Shard.of(mesh, rank)
                same(tloader.load_checkpoint(cfg, str(tmp_path),
                                             device="cpu", shard=shard),
                     sharding.shard_params(want, shard))
        eng = tengine.LLMEngine(tec.EngineConfig(
            model=str(tmp_path), checkpoint=str(tmp_path), device="cpu",
            dtype="bfloat16", max_model_len=64, max_num_seqs=2,
            tokenizer="byte"))
        same(eng.runner.params, want)
