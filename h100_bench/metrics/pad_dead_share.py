"""(pad + dead) / (real + pad + dead) decode token-steps over the window,
from /debug/perf's totals after minus before (engine/engine.py), in %."""

from h100_bench import layers


def read(ctx):
    return layers.pad_dead_share(ctx)
