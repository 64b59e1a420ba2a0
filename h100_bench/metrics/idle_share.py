"""Share of the profiled slice's wall time with no operation running on
the device, in %."""

from h100_bench import layers


def read(ctx):
    return layers.idle_share(ctx)
