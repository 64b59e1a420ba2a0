"""The fixed decode geometry: no batch buckets and no window dispatched
ahead. Tests whose JAX engine is pinned to it as the reference pin the
port's engine the same way, so both decode the same windows."""

FIXED = dict(window_adapt=False, pipeline_depth=1)
