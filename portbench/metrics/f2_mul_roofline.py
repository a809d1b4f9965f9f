"""Kernel f2_mul (``csrc/fp_kernels.cu``): its share of the roofline in the
profiled replay, the least time for the work at every launch size the
graph holds (bytes over HBM bandwidth against 32-bit multiplies over the
integer rate, ``portbench/ref/roofline.py``) over its device time."""
from portbench.metrics._layers import kernel_roofline_pct
from portbench.ref.roofline import bound_us


def count_us(n: int) -> float:
    """The least microseconds for n elements of f2_mul."""
    return bound_us("f2_mul", n)[0]


def read(ctx):
    return kernel_roofline_pct(ctx, "f2_mul", count_us)
