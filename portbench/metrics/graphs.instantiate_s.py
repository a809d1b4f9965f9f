"""Registry and graphs: seconds to instantiate every program the pool
warmed, summed over its warm rows."""
from portbench.metrics._layers import warm_sum


def read(ctx):
    return warm_sum(ctx, "instantiate_s")
