"""Model FLOP utilisation of the runner's prefill calls in the window
(engine/runner.py), in % of the bf16 peak."""

from h100_bench.layers import mfu


def read(ctx):
    return mfu(ctx, "prefill")
