"""The port's int8 model built a layer at a time (models/llama.py
``init_params(int8=True)``, ``put_leaf``; the runner's int8 build) on
the CPU, against the whole-model route it replaces: draw the model in
its dtype, then ``quant.quantize_params`` (JAX quantizes its whole
params with donated buffers, ``production_stack_tpu/engine/runner.py:
72-79``) and, for a rank, ``sharding.shard_params`` of that.

Tolerance: bit-equal, w8 and scale alike (the same rounded layers go
through the same reductions). The build must never allocate a stacked
leaf whole in the model dtype: every tensor it makes is recorded by a
dispatch mode.
"""

import dataclasses

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.models import llama, quant
from production_stack_tpu_torch.models.config import get_config
from production_stack_tpu_torch.parallel import sharding
from production_stack_tpu_torch.parallel.mesh import MeshConfig, Shard


def _cfg(preset, tie=None):
    kw = {} if tie is None else dict(tie_word_embeddings=tie)
    return dataclasses.replace(get_config(preset), dtype=torch.bfloat16,
                               **kw)


def _whole(cfg, seed=0):
    return quant.quantize_params(llama.init_params(
        cfg, torch.Generator().manual_seed(seed), device="cpu"))


def _assert_same(got, want):
    a, b = got.state_dict(), want.state_dict()
    assert sorted(a) == sorted(b)
    for name in a:
        assert a[name].dtype == b[name].dtype, name
        assert torch.equal(a[name], b[name]), name


@pytest.mark.parametrize("preset,tie", [("debug-tiny", False),
                                        ("debug-tiny", True),
                                        ("debug-gemma2", None),
                                        ("debug-moe", None)])
def test_int8_build_bit_equal_draw_then_quantize(preset, tie):
    """Every int8 leaf's w8 and scale and every leaf left in the model
    dtype equal quantize_params(init_params(...)) bit for bit (bf16
    weights, so the layer is rounded before it is quantized), tied
    embeddings, Gemma-2's sandwich norms and the MoE's expert stacks
    included; the int8 leaves are QuantizedWeight modules."""
    cfg = _cfg(preset, tie)
    built = llama.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu", int8=True)
    _assert_same(built, _whole(cfg))
    names = [n for n in llama.leaf_shapes(cfg) if quant.is_quantized_name(n)]
    assert names and all(isinstance(getattr(built, n), quant.QuantizedWeight)
                         for n in names)
    assert all(not quant.is_quantized_name(n)
               for n, _ in built.named_parameters())


@pytest.mark.parametrize("mesh", [dict(tp=2), dict(ep=2), dict(ep=2, tp=2)],
                         ids=["tp2", "ep2", "ep2tp2"])
def test_int8_rank_slices_bit_equal_shard_params(mesh):
    """debug-moe at tp = 2, ep = 2 and ep = 2 x tp = 2: each rank's int8
    build (every layer drawn and quantized whole, the rank's slice of w8
    and scale kept) equals shard_params of the whole quantized model,
    the row-parallel scales (o, down) whole on every rank."""
    cfg = _cfg("debug-moe")
    whole = _whole(cfg)
    mcfg = MeshConfig(**mesh)
    for rank in range(mcfg.size):
        shard = Shard.of(mcfg, rank)
        built = llama.init_params(cfg, torch.Generator().manual_seed(0),
                                  device="cpu", shard=shard, int8=True)
        _assert_same(built, sharding.shard_params(whole, shard))
        assert built.shard == shard


class _Allocations(TorchDispatchMode):
    """(dtype, shape) of every tensor an op makes."""

    def __init__(self):
        super().__init__()
        self.made = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.made.append((t.dtype, tuple(t.shape)))
        return out


def test_int8_build_never_allocates_a_whole_leaf_in_the_model_dtype():
    """Under a dispatch mode that records every tensor made: the int8
    build of debug-moe (the constructor and the draw) makes no tensor
    in the model dtype at a stacked leaf's full shape, and none larger
    than one layer's largest matrix stack or the embedding; the route it
    replaces (the bf16 model, then quantize_params) makes every one of
    those shapes."""
    cfg = _cfg("debug-moe")
    stacked = {shape for name, shape in llama.leaf_shapes(cfg).items()
               if name in llama.LAYER_KEYS and quant.is_quantized_name(name)}
    largest = max(max(int(torch.Size(s[1:]).numel()) for s in stacked),
                  cfg.vocab_size * cfg.hidden_size)

    def record(build):
        with _Allocations() as rec:
            build()
        return [s for dtype, s in rec.made if dtype == cfg.dtype]

    made = record(lambda: llama.init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu", int8=True))
    assert made
    assert not stacked & set(made)
    assert max(torch.Size(s).numel() for s in made) <= largest
    old = record(lambda: _whole(cfg))
    assert stacked <= set(old)


def test_int8_engine_builds_the_layer_at_a_time_weights():
    """An int8 engine of debug-moe without given weights holds, bit for
    bit, quantize_params of the seed's bf16 draw; given weights are
    quantized in place as before."""
    cfg = EngineConfig(model="debug-moe", device="cpu", dtype="bfloat16",
                       quantization="int8", max_model_len=64,
                       max_num_seqs=2, seed=5)
    eng = LLMEngine(cfg)
    _assert_same(eng.runner.params, _whole(_cfg("debug-moe"), seed=5))
    given = llama.init_params(_cfg("debug-moe"),
                              torch.Generator().manual_seed(5), device="cpu")
    eng2 = LLMEngine(cfg, params=given)
    _assert_same(eng2.runner.params, eng.runner.params)
