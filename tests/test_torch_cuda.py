"""The port's CUDA kernels against their plain PyTorch versions, on the
card. A CUDA kernel has no interpret mode, so these skip where there is
no NVIDIA GPU; on a machine with one:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerances as in chip_smoke.py: float32 2e-5 (softmax summed in another
order); bfloat16 3e-2 (bf16 outputs, and the plain version rounds the
probabilities to bf16 before the value product where the kernel keeps
them in float32).
"""

import pytest
import torch

from production_stack_tpu_torch.models.kv import write_chunk
from production_stack_tpu_torch.ops import paged_attention as pa

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _case(dev, T, G, D, dtype, lens=(70, 5, 300), seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    Bs, Hkv, B = 64, 2, len(lens) + 1
    MB = -(-(max(lens) + T + 1) // Bs) + 1
    N = B * MB + 2

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)
    k, v = rnd(N, Hkv, Bs, D), rnd(N, Hkv, Bs, D)
    tables = (torch.randperm(N - 1, generator=g, device=dev)[:B * MB]
              + 1).reshape(B, MB).to(torch.int32)
    # the last row is parked past the virtual capacity MB*Bs
    starts = torch.tensor(list(lens) + [MB * Bs + 1], dtype=torch.int32,
                          device=dev)
    pos = starts[:, None].long() + torch.arange(T, device=dev)
    write_chunk(k, rnd(B, T, Hkv, D), tables, pos)
    write_chunk(v, rnd(B, T, Hkv, D), tables, pos)
    nb = min(-(-(max(lens) + T) // Bs), MB)
    return rnd(B, T, Hkv * G, D), k, v, tables, starts, nb


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fn,T,G,D", [
    (pa.paged_decode_attention, 1, 4, 128),
    (pa.paged_decode_attention, 8, 8, 64),
    (pa.paged_attention, 9, 4, 128),
    (pa.paged_attention, 130, 8, 64),
])
def test_kernel_matches_plain_version(cuda, fn, T, G, D, dtype):
    q, k, v, tables, starts, nb = _case(cuda, T, G, D, dtype)
    name = fn.__name__
    before = pa.launch_counts[name]
    got = fn(q, k, v, tables, starts, nb=nb)
    torch.cuda.synchronize()
    assert pa.launch_counts[name] == before + 1
    want = pa.paged_attention_plain(q, k, v, tables, starts, nb, D ** -0.5)
    assert got.dtype == dtype and torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]


def test_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v, tables, starts, nb = _case(cuda, 1, 4, 128, torch.float32)
    with pytest.raises(ValueError, match="head dim"):
        pa.paged_decode_attention(q[..., :96].contiguous(),
                                  k[..., :96].contiguous(),
                                  v[..., :96].contiguous(), tables, starts,
                                  nb=nb)
    with pytest.raises(TypeError, match="int32"):
        pa.paged_attention(q, k, v, tables.long(), starts, nb=nb)
    with pytest.raises(ValueError, match="T <= 8"):
        pa.paged_decode_attention(q.repeat(1, 9, 1, 1), k, v, tables,
                                  starts, nb=nb)
