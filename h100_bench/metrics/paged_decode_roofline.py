"""The paged decode kernel's share of its roofline over the profiled
slice (ops/paged_attention.py paged_decode_attention,
csrc/paged_attention.cu), in %."""

from h100_bench.layers import roofline


def read(ctx):
    return roofline(ctx, "paged_decode_attention")
