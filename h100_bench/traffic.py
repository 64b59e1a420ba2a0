"""The one traffic generator: every mix is a data file under
``traffic/`` that this module reads.

The load is an open loop: independent users, whose requests are due on
a Poisson schedule at the cell's ``rate``, whatever the server does. A
mix file holds:
- ``prompt`` and ``output``: token counts drawn lognormal, each
  ``{"median", "sigma", "min", "max"}``;
- ``warm_s``: seconds of load before the window opens.

Against noise between seeds, every seed gets the same work in another
order: lengths sit at fixed quantiles of their distribution and gaps
between arrivals at fixed quantiles of the exponential, as many in the
window (and in the warm-up and the drain) for every seed, and the seed
shuffles them and draws the prompts' token ids. The arrival function
replaces the port's ``loadgen/arrival.py`` ``poisson_times`` by that
rule.
"""

import math
import random
from statistics import NormalDist
from typing import Dict, List

import numpy as np


def quantile_lengths(spec: Dict, n: int, rng: random.Random) -> List[int]:
    """n lengths at the quantiles (i + 0.5) / n of lognormal(median,
    sigma) cut to [min, max], in an order the rng draws."""
    nd = NormalDist()
    out = []
    for i in range(n):
        z = nd.inv_cdf((i + 0.5) / n)
        x = spec["median"] * math.exp(spec["sigma"] * z)
        out.append(int(min(max(round(x), spec["min"]), spec["max"])))
    rng.shuffle(out)
    return out


def arrival_offsets(rate: float, length: float,
                    rng: random.Random) -> List[float]:
    """The arrivals of a Poisson process at ``rate`` over ``length``
    seconds, made the same for every seed but for their order:
    round(rate * length) gaps at the quantiles (i + 0.5) / n of the
    exponential, shuffled by the rng and scaled to span the segment,
    each arrival at the middle of its gap."""
    if rate <= 0:
        raise ValueError(f"rate must be positive, got {rate}")
    n = max(1, round(rate * length))
    gaps = [-math.log(1.0 - (i + 0.5) / n) for i in range(n)]
    rng.shuffle(gaps)
    total, out, t = sum(gaps), [], 0.0
    for g in gaps:
        out.append(length * (t + g / 2) / total)
        t += g
    return out


def plan(traffic: Dict, cell: Dict, seed: int, vocab: int, seconds: float,
         drain_s: float) -> Dict:
    """The requests of one run. The schedule has three segments, the
    warm-up, the window and the drain after it, and each holds the same
    number of arrivals and the same set of lengths for every seed, in an
    order the seed draws. Returns {"warm_s", "requests": [{"prompt":
    ids, "max_tokens", "due"}]}; ``due`` is an offset from the start of
    the load."""
    rng = random.Random(seed)
    warm = float(traffic.get("warm_s", 0.0))
    rate, at = float(cell["rate"]), 0.0
    prompts, outputs, dues = [], [], []
    for length in (warm, seconds, drain_s):
        if length <= 0:
            continue
        offs = arrival_offsets(rate, length, rng)
        dues += [at + o for o in offs]
        prompts += quantile_lengths(traffic["prompt"], len(offs), rng)
        outputs += quantile_lengths(traffic["output"], len(offs), rng)
        at += length
    ids = np.random.Generator(np.random.PCG64(seed)).integers(
        0, vocab, size=sum(prompts), dtype=np.int64)
    requests, at = [], 0
    for p, o, due in zip(prompts, outputs, dues):
        requests.append({"prompt": ids[at:at + p].tolist(), "max_tokens": o,
                         "due": due})
        at += p
    return {"warm_s": warm, "requests": requests}
