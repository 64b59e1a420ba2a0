"""The paged decode kernel's share of its roofline over the cell's
profiled slice, in % (layers.roofline).

The decode of mistral-7b.longdoc is host-paced (its traced runs read the device idle
over half the slice), so this is a per-layer metric of that cell, and
it moves its TTFT (PERF.md)."""

from h100_bench.layers import roofline


def read(ctx):
    return roofline(ctx, "paged_decode_attention")
