# Frozen copy of the roofline arithmetic of chip_smoke.py (HBM_BYTES_PER_S,
# INT32_MADD_PER_S, MULS_PER_PRODUCT, MULS_PER_REDUCTION, LIMB_BYTES, KERNELS,
# bound_us) at commit a7764c99fc009f548297e969c7f2027c1302fc87.  Do not edit:
# a kernel's roofline share must read the same work whatever implements it.
"""The least time an NVIDIA H100 (SXM, 700 W) could take for the hand-written
field kernels K1-K3 of ``lodestar_tpu_torch/ops/bls12_381/csrc/fp_kernels.cu``.
"""
from __future__ import annotations

from typing import Tuple

# H100 SXM rates: HBM bandwidth (NVIDIA data sheet) and 32-bit integer
# multiply-adds, 64 per SM per clock on compute capability 9.0 (CUDA C++
# Programming Guide, arithmetic throughput table) x 132 SMs x 1.98 GHz.
HBM_BYTES_PER_S = 3.35e12
INT32_MADD_PER_S = 64 * 132 * 1.98e9
# The least 32-bit multiplies known for the work, one issue slot each, low
# and high halves counted apart, on 12 words of 32 bits: a full product a*b
# takes 144 + 144; a reduction to x*2^-390 takes 12 digits m and 144 + 144
# for m*p (x*2^-384), then one 6-bit step (its digit, and 12 + 12 for the
# product by p).
MULS_PER_PRODUCT = 2 * 144
MULS_PER_REDUCTION = 12 + 2 * 144 + 1 + 2 * 12
# one field element: 30 limbs of int32
LIMB_BYTES = 30 * 4

KERNELS = {
    # name: (full products, reductions, inputs, outputs).  K2 at its least:
    # Karatsuba's three products, summed into the two coefficients before
    # one reduction each; K3: (a0+a1)(a0-a1) and a0 a1.
    "mont_mul": (1, 1, 2, 1),
    "f2_mul": (3, 2, 4, 2),
    "f2_sqr": (2, 2, 2, 2),
}


def bytes_moved(name: str, n: int) -> int:
    """Each input read once and each output written once, for n elements."""
    _, _, n_in, n_out = KERNELS[name]
    return (n_in + n_out) * n * LIMB_BYTES


def multiplies(name: str, n: int) -> int:
    """The least 32-bit multiplies for n elements."""
    products, reductions, _, _ = KERNELS[name]
    return (products * MULS_PER_PRODUCT + reductions * MULS_PER_REDUCTION) * n


def bound_us(name: str, n: int) -> Tuple[float, str]:
    """The least time the card could take for ``n`` elements of a kernel:
    bytes over HBM bandwidth against 32-bit multiplies over the integer
    rate.  Returns (us, "bytes" or "operations")."""
    t_bytes = bytes_moved(name, n) / HBM_BYTES_PER_S
    t_ops = multiplies(name, n) / INT32_MADD_PER_S
    return max(t_bytes, t_ops) * 1e6, "bytes" if t_bytes >= t_ops else "operations"
