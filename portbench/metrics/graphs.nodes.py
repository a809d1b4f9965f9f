"""Registry and graphs (``aot/registry.py``, ``graphs.py``, ``warm.py``): the
CUDA graph nodes of every program the pool warmed, summed over its rows."""
from portbench.metrics._layers import warm_sum


def read(ctx):
    return warm_sum(ctx, "nodes")
