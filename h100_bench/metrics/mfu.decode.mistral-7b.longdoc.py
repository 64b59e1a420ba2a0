"""Model FLOP utilisation of the cell's decode windows, in % of the bf16
peak (layers.mfu).

The decode of mistral-7b.longdoc is host-paced (its traced runs read the device idle
over half the slice), so this is a per-layer metric of that cell, and
it moves its TTFT (PERF.md)."""

from h100_bench.layers import mfu


def read(ctx):
    return mfu(ctx, "decode")
