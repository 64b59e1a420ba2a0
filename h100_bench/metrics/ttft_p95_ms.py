"""95th percentile of the window requests' time to first token, from
when each was due."""

from h100_bench.measures import percentile, ttfts_s


def read(ctx):
    v = ttfts_s(ctx.run)
    return 1e3 * percentile(v, 95) if v else None
