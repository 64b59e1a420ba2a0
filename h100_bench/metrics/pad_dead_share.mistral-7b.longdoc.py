"""Padded and dead decode token-steps of the cell's window, in %
(layers.pad_dead_share).

The decode of mistral-7b.longdoc is host-paced (its traced runs read the device idle
over half the slice), so this is a per-layer metric of that cell, and
it moves its TTFT (PERF.md)."""

from h100_bench import layers


def read(ctx):
    return layers.pad_dead_share(ctx)
