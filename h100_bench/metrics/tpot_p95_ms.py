"""95th percentile over the window's requests of (last token - first
token) / (output tokens - 1)."""

from h100_bench import layers


def read(ctx):
    return layers.tpot_p95_ms(ctx)
