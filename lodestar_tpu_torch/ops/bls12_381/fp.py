"""Fp arithmetic over limb tensors — the field layer of the port.

Counterpart of ``lodestar_tpu/ops/bls12_381/fp.py``.  Every value is an
int32 tensor ``(..., NLIMBS)`` of radix-2^13 limbs in Montgomery form,
canonical (each limb < 2^13, value < p).  Ops broadcast over leading axes.

Products go through kernel K1 (``fp_kernels.mont_mul``); additions and
subtractions through the add and subtract kernels (``fp_kernels.add_mod``/
``sub_mod``), one launch each.  The XLA
compile-time devices of the reference (CIOS scan, shift matrices, trace
cache, platform dispatch) have no counterpart here.
"""
from __future__ import annotations

import numpy as np
import torch

from lodestar_tpu_torch.crypto.bls.fields import P
from . import fp_kernels as fpk
from .limbs import NLIMBS, from_mont_int, int_to_limbs, limbs_to_int, to_mont_int


def zeros(shape=(), device=None) -> torch.Tensor:
    return torch.zeros((*shape, NLIMBS), dtype=torch.int32, device=device)


def one_mont(shape=(), device=None) -> torch.Tensor:
    """1 in Montgomery form, broadcast to ``shape`` (a read-only view)."""
    return fpk.limb_const("one_mont", torch.device(device or "cpu")).expand(*shape, NLIMBS)


add = fpk.add_mod  # a + b mod p on canonical limbs
sub = fpk.sub_mod  # a - b mod p on canonical limbs


def neg(a):
    """-a mod p."""
    return fpk.sub_mod(torch.zeros_like(a), a)


def dbl(a):
    """2a mod p."""
    return fpk.add_mod(a, a)


def mont_mul(a, b):
    """Montgomery product a*b*R^-1 mod p, canonical output (kernel K1)."""
    return fpk.mont_mul(a, b)


def mont_sqr(a):
    return fpk.mont_mul(a, a)


def to_mont(a):
    """Plain limbs (value < p) -> Montgomery form."""
    return fpk.mont_mul(a, fpk.limb_const("r2", a.device))


def from_mont(a):
    """Montgomery form -> plain canonical limbs."""
    return fpk.mont_mul(a, fpk.limb_const("one_plain", a.device))


def is_zero(a):
    """Canonical limbs -> bool (...,)."""
    return (a == 0).all(-1)


def eq(a, b):
    return (a == b).all(-1)


def select(cond, a, b):
    """where(cond, a, b) with cond shaped (...,) against (..., NLIMBS)."""
    return torch.where(cond.unsqueeze(-1), a, b)


def mont_pow_fixed(a, e: int):
    """a^e in Montgomery form for a host exponent e (4-bit fixed window).

    A table a^0..a^15, then per nibble MSB-first four squarings and one
    multiply by the table entry that the nibble, a Python int, names."""
    one = one_mont(a.shape[:-1], a.device)
    if e == 0:
        return one
    if e < 16:
        acc = one
        for bit in bin(e)[2:]:
            acc = mont_sqr(acc)
            if bit == "1":
                acc = mont_mul(acc, a)
        return acc
    table = [one, a, mont_sqr(a)]
    for _ in range(13):
        table.append(mont_mul(table[-1], a))
    ndigits = (e.bit_length() + 3) // 4
    digits = [(e >> (4 * (ndigits - 1 - i))) & 0xF for i in range(ndigits)]
    acc = table[digits[0]]
    for d in digits[1:]:
        for _ in range(4):
            acc = mont_sqr(acc)
        if d:
            acc = mont_mul(acc, table[d])
    return acc


def inv(a):
    """Multiplicative inverse via Fermat (a^(p-2)); inv(0) = 0."""
    return mont_pow_fixed(a, P - 2)


# host <-> device element helpers ---------------------------------------------


def encode_int(x: int) -> np.ndarray:
    """Host: python int mod p -> canonical Montgomery limbs (numpy uint32)."""
    return int_to_limbs(to_mont_int(x % P))


def decode(limbs) -> int:
    """Host: Montgomery limb array or tensor -> python int in [0, p)."""
    if isinstance(limbs, torch.Tensor):
        limbs = limbs.cpu().numpy()
    return from_mont_int(limbs_to_int(np.asarray(limbs)))
