"""Operations and bytes: the yardstick of the roofline and MFU metrics.

``paged_work`` is a copy of the port's ``chip_smoke.py`` ``work()``
with the tensors replaced by their shapes and the starts by host ints;
``model_flops`` counts a token's model operations from the published
config. Peaks are NVIDIA's data sheet for one H100 SXM (dense, no
sparsity) at its full 700 W power limit.
"""

from typing import Iterable, Tuple

from h100_bench.weights import dims

PEAK_BF16_FLOPS = 989e12     # bf16 / fp16 tensor-core rate
PEAK_HBM_BYTES = 3.35e12     # HBM3 bandwidth


def paged_work(B: int, T: int, H: int, D: int, starts: Iterable[int],
               nb: int, MB: int, Bs: int, Hkv: int, itemsize: int,
               window: int = 0, kv_itemsize: int = 0) -> Tuple[int, int]:
    """(bytes, flops) a paged attention call needs on this data. Every
    row: starts once and its output written once. A live row (start <
    MB*Bs) also reads its q, the table entries of the blocks it attends
    (from its first query's window start to its last query's block,
    within nb) and the K/V of the keys it attends (from its first
    query's window start to its last query's position, within those
    blocks), not the rest of their blocks — an int8 pool (kv_itemsize
    1) also a 4-byte K and V scale per attended (key, head) — and does
    4*D flops per (query head, attended key) for QK and PV, counting
    only the keys inside each query's window. A parked row needs nothing
    more."""
    kv_itemsize = kv_itemsize or itemsize
    kv_row = D * kv_itemsize + (4 if kv_itemsize == 1 else 0)
    row_q = T * H * D * itemsize
    byts = B * (row_q + 4)
    flops = 0
    for s in starts:
        if s >= MB * Bs:
            continue
        jend = min((s + T - 1) // Bs, nb - 1)
        first = max(s - (window - 1), 0) if window else 0
        blocks = max(jend - first // Bs + 1, 0)
        attended = max(min(s + T, (jend + 1) * Bs) - first, 0)
        byts += row_q + 2 * attended * Hkv * kv_row + 4 * blocks
        for t in range(T):
            lo = max(s + t - window + 1, 0) if window else 0
            keys = max(min(s + t + 1, (jend + 1) * Bs) - lo, 0)
            flops += 4 * D * H * keys
    return byts, flops


def bound_s(byts: int, flops: int) -> float:
    """The least time the card could take: whichever of the bytes over
    HBM bandwidth and the operations over the bf16 rate binds."""
    return max(byts / PEAK_HBM_BYTES, flops / PEAK_BF16_FLOPS)


def layer_params(cfg: dict) -> int:
    """Weights one token multiplies through in one layer: q, k, v, o and
    the MLP."""
    m = dims(cfg)
    H, I = m["H"], m["I"]
    return H * m["NH"] * m["D"] * 2 + H * m["NKV"] * m["D"] * 2 + 3 * H * I


def token_flops(cfg: dict, position: int, with_head: bool) -> int:
    """Model operations of one token at ``position`` (0-based): 2 per
    weight it multiplies through, attention's 4*D per (query head,
    key attended) over the keys in its window, and the head where its
    logits are computed."""
    m = dims(cfg)
    keys = position + 1
    if m["window"]:
        keys = min(keys, m["window"])
    per_layer = 2 * layer_params(cfg) + 4 * m["D"] * m["NH"] * keys
    head = 2 * m["H"] * m["V"] if with_head else 0
    return m["L"] * per_layer + head


def span_flops(cfg: dict, start: int, length: int, with_head: bool) -> int:
    """token_flops summed over positions start .. start + length - 1,
    the head on the last one only (a prefill chunk) or on none."""
    m = dims(cfg)
    W = m["window"]
    keys = 0
    for p in range(start, start + length):
        keys += min(p + 1, W) if W else p + 1
    total = m["L"] * (2 * layer_params(cfg) * length
                      + 4 * m["D"] * m["NH"] * keys)
    return total + (2 * m["H"] * m["V"] if with_head else 0)
