"""Fp2/Fp6/Fp12 tower arithmetic over limb tensors (nested tuples).

Counterpart of ``lodestar_tpu/ops/bls12_381/tower.py``, same layout:
  Fp2  = (c0, c1)          u^2 = -1
  Fp6  = (a0, a1, a2)      v^3 = xi = 1 + u
  Fp12 = (b0, b1)          w^2 = v

Every Fp2 product is kernel K2 (``fp_kernels.f2_mul``) and every Fp2
square kernel K3 (``fp_kernels.f2_sqr``).  As in the reference, the
independent products of a tower level are stacked into ONE kernel call:
an ``f12_mul`` is one launch of 18 Fp2 products per batch element.

Additions and subtractions work on whole trees at once: the leaves are
stacked and go through one ``fp.add``/``fp.sub``, one kernel launch, so an
Fp12 addition is one launch, not twelve.  Results
are canonical residues, so they equal the reference's limb for limb
whatever the grouping.
"""
from __future__ import annotations

import functools
from typing import List

import numpy as np
import torch

from lodestar_tpu_torch.crypto.bls import fields as _orc
from . import fp, fp_kernels as fpk
from .limbs import int_to_limbs, to_mont_int

# ---------------------------------------------------------------------------
# trees of limb tensors
# ---------------------------------------------------------------------------


def tree_map(fn, *trees):
    if isinstance(trees[0], tuple):
        return tuple(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, tuple):
        return [leaf for t in tree for leaf in leaves(t)]
    return [tree]


def _rebuild(like, it):
    if isinstance(like, tuple):
        return tuple(_rebuild(t, it) for t in like)
    return next(it)


def stack(items):
    """N same-structured trees -> one tree with a new leading axis N."""
    flat = [leaves(t) for t in items]
    width = len(flat[0])
    cols = []
    for j in range(width):
        cols.append(torch.stack(torch.broadcast_tensors(*[f[j] for f in flat])))
    return _rebuild(items[0], iter(cols))


def unstack(tree, n: int):
    return [tree_map(lambda t, i=i: t[i], tree) for i in range(n)]


def _leafwise(op, a, b):
    """``op`` on every leaf pair of two same-structured trees, as one call
    over the stacked leaves."""
    la, lb = leaves(a), leaves(b)
    if len(la) == 1:
        return _rebuild(a, iter([op(la[0], lb[0])]))
    both = torch.broadcast_tensors(*la, *lb)
    out = op(torch.stack(both[: len(la)]), torch.stack(both[len(la):]))
    return _rebuild(a, iter(out.unbind(0)))


def t_add(a, b):
    """Leafwise a + b mod p over any tree (Fp2, Fp6, Fp12, tuples of them)."""
    return _leafwise(fp.add, a, b)


def t_sub(a, b):
    """Leafwise a - b mod p over any tree."""
    return _leafwise(fp.sub, a, b)


def t_neg(a):
    """Leafwise -a mod p over any tree."""
    return _leafwise(fp.sub, tree_map(torch.zeros_like, a), a)


def t_select(cond, a, b):
    return tree_map(lambda x, y: fp.select(cond, x, y), a, b)


# ---------------------------------------------------------------------------
# host encode/decode helpers (tests, constants)
# ---------------------------------------------------------------------------


def _const(x: int) -> torch.Tensor:
    """Python int mod p -> Montgomery limb constant (CPU int32)."""
    return torch.from_numpy(int_to_limbs(to_mont_int(x % _orc.P)).astype(np.int32))


def encode_fp2(a) -> tuple:
    return (_const(a[0]), _const(a[1]))


def encode_fp6(a) -> tuple:
    return tuple(encode_fp2(c) for c in a)


def encode_fp12(a) -> tuple:
    return tuple(encode_fp6(c) for c in a)


def decode_fp2(a):
    return (fp.decode(a[0]), fp.decode(a[1]))


def decode_fp6(a):
    return tuple(decode_fp2(c) for c in a)


def decode_fp12(a):
    return tuple(decode_fp6(c) for c in a)


def to_device(tree, device):
    return tree_map(lambda t: t.to(device), tree)


# ---------------------------------------------------------------------------
# Fp2
# ---------------------------------------------------------------------------


def f2_zeros(shape=(), device=None):
    return (fp.zeros(shape, device), fp.zeros(shape, device))


def f2_one(shape=(), device=None):
    return (fp.one_mont(shape, device), fp.zeros(shape, device))


f2_add = t_add
f2_sub = t_sub
f2_neg = t_neg


def f2_dbl(a):
    return t_add(a, a)


def f2_mul(a, b):
    """Karatsuba product: kernel K2."""
    return fpk.f2_mul(a, b)


def f2_sqr(a):
    """Square: kernel K3."""
    return fpk.f2_sqr(a)


def f2_conj(a):
    return (a[0], fp.neg(a[1]))


def f2_mul_fp(a, k):
    """Fp2 * Fp: one stacked K1 call."""
    t = fp.mont_mul(torch.stack(torch.broadcast_tensors(a[0], a[1])), k)
    return (t[0], t[1])


def f2_mul_by_xi(a):
    # xi = 1 + u
    return (fp.sub(a[0], a[1]), fp.add(a[0], a[1]))


def f2_inv(a):
    a01 = torch.stack(torch.broadcast_tensors(a[0], a[1]))
    t = fp.mont_mul(a01, a01)
    ninv = fp.inv(fp.add(t[0], t[1]))
    u = fp.mont_mul(a01, ninv)
    return (u[0], fp.neg(u[1]))


def f2_is_zero(a):
    return fp.is_zero(a[0]) & fp.is_zero(a[1])


def f2_eq(a, b):
    return fp.eq(a[0], b[0]) & fp.eq(a[1], b[1])


f2_select = t_select


# ---------------------------------------------------------------------------
# Fp6
# ---------------------------------------------------------------------------


def f6_zeros(shape=(), device=None):
    return (f2_zeros(shape, device), f2_zeros(shape, device), f2_zeros(shape, device))


def f6_one(shape=(), device=None):
    return (f2_one(shape, device), f2_zeros(shape, device), f2_zeros(shape, device))


f6_add = t_add
f6_sub = t_sub


f6_neg = t_neg


def f6_mul(a, b):
    """Toom-style: 6 independent Fp2 products in one stacked K2 call."""
    a0, a1, a2 = a
    b0, b1, b2 = b
    # pre-adds (a1+a2, a0+a1, a0+a2) and the same for b, in one call
    s = t_add((a1, a0, a0, b1, b0, b0), (a2, a1, a2, b2, b1, b2))
    # products: t0=a0b0, t1=a1b1, t2=a2b2, m12=(a1+a2)(b1+b2),
    #           m01=(a0+a1)(b0+b1), m02=(a0+a2)(b0+b2)
    prod = f2_mul(stack([a0, a1, a2, s[0], s[1], s[2]]),
                  stack([b0, b1, b2, s[3], s[4], s[5]]))
    t0, t1, t2, m12, m01, m02 = unstack(prod, 6)
    # y = (m12 - t1 - t2, m01 - t0 - t1, m02 - t0 - t2)
    y = t_sub(t_sub((m12, m01, m02), (t1, t0, t0)), (t2, t1, t2))
    xi_y0, xi_t2 = unstack(f2_mul_by_xi(stack([y[0], t2])), 2)
    # c0 = t0 + xi y0, c1 = y1 + xi t2, c2 = y2 + t1
    return t_add((t0, y[1], y[2]), (xi_y0, xi_t2, t1))


def f6_sqr(a):
    return f6_mul(a, a)


def f6_mul_by_v(a):
    return (f2_mul_by_xi(a[2]), a[0], a[1])


def f6_inv(a):
    a0, a1, a2 = a
    # layer 1: squares and cross products in one stacked K2 call
    prod = f2_mul(stack([a0, a2, a1, a1, a0, a0]), stack([a0, a2, a1, a2, a1, a2]))
    s0, s2, s1, a12, a01, a02 = unstack(prod, 6)
    xi_a12, xi_s2 = unstack(f2_mul_by_xi(stack([a12, s2])), 2)
    c0, c1, c2 = t_sub((s0, xi_s2, s1), (xi_a12, a01, a02))
    # layer 2: t = a0 c0 + xi (a1 c2 + a2 c1)
    q0, q1, q2 = unstack(f2_mul(stack([a0, a1, a2]), stack([c0, c2, c1])), 3)
    t = t_add(q0, f2_mul_by_xi(t_add(q1, q2)))
    tinv = f2_inv(t)
    r = f2_mul(stack([c0, c1, c2]), tinv)
    return tuple(unstack(r, 3))


def f6_is_zero(a):
    return f2_is_zero(a[0]) & f2_is_zero(a[1]) & f2_is_zero(a[2])




# ---------------------------------------------------------------------------
# Fp12
# ---------------------------------------------------------------------------


def f12_one(shape=(), device=None):
    return (f6_one(shape, device), f6_zeros(shape, device))


f12_add = t_add
f12_sub = t_sub


def f12_mul(a, b):
    """Karatsuba over Fp6: 3 independent f6 products, one stacked call."""
    a0, a1 = a
    b0, b1 = b
    s = t_add((a0, b0), (a1, b1))
    t0, t1, t01 = unstack(f6_mul(stack([a0, a1, s[0]]), stack([b0, b1, s[1]])), 3)
    c0 = f6_add(t0, f6_mul_by_v(t1))
    c1 = f6_sub(f6_sub(t01, t0), t1)
    return (c0, c1)


def f12_sqr(a):
    a0, a1 = a
    s = t_add((a0, a0), (a1, f6_mul_by_v(a1)))
    t, c0 = unstack(f6_mul(stack([a0, s[0]]), stack([a1, s[1]])), 2)
    c0 = f6_sub(f6_sub(c0, t), f6_mul_by_v(t))
    return (c0, f6_add(t, t))


def f12_conj(a):
    return (a[0], f6_neg(a[1]))


def f12_inv(a):
    a0, a1 = a
    s0, s1 = unstack(f6_mul(stack([a0, a1]), stack([a0, a1])), 2)
    tinv = f6_inv(f6_sub(s0, f6_mul_by_v(s1)))
    q0, q1 = unstack(f6_mul(stack([a0, a1]), tinv), 2)
    return (q0, f6_neg(q1))


def f12_is_one(a):
    c00 = a[0][0]
    one = fp.one_mont((), c00[0].device)
    eq_one = fp.eq(c00[0], one) & fp.is_zero(c00[1])
    return eq_one & f2_is_zero(a[0][1]) & f2_is_zero(a[0][2]) & f6_is_zero(a[1])


f12_select = t_select


# ---------------------------------------------------------------------------
# Frobenius (coefficients computed from the host oracle at import time)
# ---------------------------------------------------------------------------

GAMMA1 = [encode_fp2(g) for g in _orc.GAMMA1]


@functools.lru_cache(maxsize=None)
def _gamma1_stacked(device: torch.device):
    """The six coefficients stacked per Fp2 component: two (6, 30) tensors."""
    return tuple(torch.stack([g[i] for g in GAMMA1]).to(device) for i in range(2))


def _to_wcoeffs(a):
    (a0, a1, a2), (b0, b1, b2) = a
    return [a0, b0, a1, b1, a2, b2]


def _from_wcoeffs(c):
    return ((c[0], c[2], c[4]), (c[1], c[3], c[5]))


def f12_frobenius(a, power: int = 1):
    out = a
    for _ in range(power % 12):
        coeffs = stack(_to_wcoeffs(out))           # Fp2 with leading axis 6
        lead = coeffs[0].dim() - 2
        gammas = tuple(
            g.reshape(6, *([1] * lead), g.shape[-1])
            for g in _gamma1_stacked(coeffs[0].device)
        )
        out = _from_wcoeffs(unstack(f2_mul(f2_conj(coeffs), gammas), 6))
    return out
