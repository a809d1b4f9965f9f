"""The field kernels: wrappers, launch counters, plain versions.

Counterpart of ``lodestar_tpu/ops/bls12_381/pallas_fp.py`` for the three
products, and of ``fp.py::add``/``sub`` for the canonical add and
subtract.  Each wrapper keeps its reference's signature (broadcasting, any
leading axes, tuples for Fp2) and dispatches on where its tensors lie:

* a CUDA tensor goes to the hand-written kernel in ``csrc/fp_kernels.cu``
  (built and loaded by ``_build``), or the wrapper raises;
* a CPU tensor goes to the kernel's plain PyTorch version below.

There is no other route: no fallback from a failed launch, no switch.

    mont_mul(a, b)   -> K1 ``lodestar_fp_mont_mul``  a*b*R^-1 mod p
    f2_mul(a, b)     -> K2 ``lodestar_fp_f2_mul``    Karatsuba in Fp[u]/(u^2+1)
    f2_sqr(a)        -> K3 ``lodestar_fp_f2_sqr``    (a0+a1)(a0-a1), 2 a0 a1
    add_mod(a, b)    ->    ``lodestar_fp_add_mod``   a + b mod p
    sub_mod(a, b)    ->    ``lodestar_fp_sub_mod``   a - b mod p

``LAUNCHES`` counts kernel launches per wrapper; a wrapper adds one where
it launches its kernel and nowhere else.  ``LAUNCH_SIZES`` keeps, per
wrapper, the same launches as a histogram keyed by the number of elements
``n`` of the launch.

The plain versions follow ``fp.mont_mul_parallel``'s algorithm
(``lodestar_tpu/ops/bls12_381/fp.py``) in int64 torch ops: the sum
U + mu*p is past int32 (up to 2^31 + 8223 in the reference's form, up to
2^32 here, where U is not carried first).  ``add_mod_plain``/
``sub_mod_plain``, the canonical modular add and subtract, resolve
single-bit carries by packing the per-limb generate and propagate bits
into one integer, where one integer addition runs the whole carry chain
(``_propagate``); ``mont_mul_plain`` ends with the same chains.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import _build
from .limbs import LIMB_BITS, MASK, NLIMBS, NPRIME_LIMBS, ONE_MONT, P_LIMBS, R2_LIMBS

LAUNCHES: Dict[str, int] = {"mont_mul": 0, "f2_mul": 0, "f2_sqr": 0, "add_mod": 0, "sub_mod": 0}
LAUNCH_SIZES: Dict[str, Dict[int, int]] = {name: {} for name in LAUNCHES}

_TABLES = {
    "p": P_LIMBS,
    "nprime": NPRIME_LIMBS,
    "r2": R2_LIMBS,
    "one_mont": ONE_MONT,
    "one_plain": np.eye(1, NLIMBS, dtype=np.uint32)[0],
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
        LAUNCH_SIZES[name].clear()


@functools.lru_cache(maxsize=None)
def limb_const(name: str, device: torch.device, dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """A limb constant (``p``, ``nprime``, ``r2``, ``one_mont``,
    ``one_plain``) as a (30,) tensor on ``device``, made once per device."""
    return torch.from_numpy(_TABLES[name].astype(np.int64)).to(device=device, dtype=dtype)


@functools.lru_cache(maxsize=None)
def _bit_tables(n: int, dtype: torch.dtype, device: torch.device):
    shifts = torch.arange(n, dtype=dtype, device=device)
    return torch.ones(n, dtype=dtype, device=device) << shifts, shifts


# ---------------------------------------------------------------------------
# carry machinery and the plain canonical add/sub
# ---------------------------------------------------------------------------


def _propagate(code):
    """Single-bit carry chain over the last axis (width n <= 61).

    ``code`` is 2*g + p per limb: g = the limb generates a carry, p = it
    passes an incoming one on (never both).  Returns (carry into each limb,
    carry out of the top limb).  Packed into integers, (G|Pm) + G runs the
    whole chain in one addition, and as g and p are disjoint that sum is
    sum_i code_i 2^i; its bit i is p_i XOR carry_in_i and bit n the carry
    out.  int32 holds the sum for n <= 30, int64 up to n = 61."""
    n = code.shape[-1]
    dtype = torch.int32 if n <= 30 else torch.int64
    weights, shifts = _bit_tables(n, dtype, code.device)
    S = (code * weights).sum(-1, dtype=dtype)
    carry_in = ((S.unsqueeze(-1) >> shifts) & 1) ^ (code & 1)
    return carry_in, S >> n


def _resolve(t):
    """Exact canonical limbs for limbs <= 2^14 - 2 (single-bit carries);
    the carry out of the top limb is dropped.  A limb generates when it is
    >= 2^13 and passes a carry on when it equals 2^13 - 1, so
    2g + p = ((t + 1) >> 13) + (t >> 13)."""
    carry_in, _ = _propagate(((t + 1) >> LIMB_BITS) + (t >> LIMB_BITS))
    return (t + carry_in) & MASK


def _borrow_code(a, b):
    """2g + p for the borrow chain of a - b: g = a_i < b_i, p = a_i == b_i."""
    return (a <= b).to(torch.int32) + (a < b)


def _cond_sub_p(t):
    """Canonical t in [0, 2p) -> [0, p)."""
    p = limb_const("p", t.device, t.dtype)
    borrow_in, borrow_out = _propagate(_borrow_code(t, p))
    d = (t + (1 << LIMB_BITS) - p - borrow_in) & MASK
    return torch.where(borrow_out.unsqueeze(-1) != 0, t, d)


def add_mod_plain(a, b):
    """Plain version of ``add_mod``: a + b mod p on canonical limbs
    (broadcasting)."""
    return _cond_sub_p(_resolve(a + b))


def sub_mod_plain(a, b):
    """Plain version of ``sub_mod``: a - b mod p on canonical limbs
    (broadcasting)."""
    borrow_in, borrow_out = _propagate(_borrow_code(a, b))
    d = (a + (1 << LIMB_BITS) - b - borrow_in) & MASK
    # where a < b the limbs hold a - b + 2^390: adding p and dropping the
    # carry out of the top limb (exactly 2^390) leaves a - b + p
    dp = _resolve(d + limb_const("p", d.device, d.dtype))
    return torch.where(borrow_out.unsqueeze(-1) != 0, dp, d)


# ---------------------------------------------------------------------------
# plain versions (int64 internally)
# ---------------------------------------------------------------------------


def _conv(a, b, width: int = 2 * NLIMBS - 1):
    """Low ``width`` limbs of the limb convolution of a (..., 30) with b,
    which has a's shape or is one (30,) constant.

    The outer product sits in rows of 60 (zero-padded); re-read with a row
    stride of 59, row i appears shifted right by i, so a sum over rows is
    the convolution.  The sum comes out as int64."""
    lead = a.shape[:-1]
    rows = torch.zeros(*lead, NLIMBS, 2 * NLIMBS, dtype=a.dtype, device=a.device)
    torch.mul(a.unsqueeze(-1), b.unsqueeze(-2), out=rows[..., :NLIMBS])
    skewed = rows.as_strided(
        (*lead, NLIMBS, width), (*rows.stride()[:-2], 2 * NLIMBS - 1, 1)
    )
    return skewed.sum(-2, dtype=torch.int64)


def _carry_widen(x):
    """One carry pass that widens by one limb (no truncation)."""
    lo, hi = x & MASK, x >> LIMB_BITS
    lo[..., 1:] += hi[..., :-1]
    return torch.cat([lo, hi[..., -1:]], -1)


def _carry_trunc(x):
    """One carry pass at fixed width (drops the top carry)."""
    lo = x & MASK
    lo[..., 1:] += (x >> LIMB_BITS)[..., :-1]
    return lo


def mont_mul_plain(a, b):
    """Plain version of K1: a*b*R^-1 mod p, canonical, broadcasting.

    U = a*b, mu = (U mod R)*N' mod R, T = U + mu*p (= 0 mod R), T/R in
    [0, 2p), then one conditional subtract — fp.mont_mul_parallel's steps,
    with int64 limbs so that fewer carry passes are needed."""
    # U = a*b: 59 limbs < 30 * 8191^2 < 2^31 (the int32 products fit too)
    u = _conv(a, b)
    # mu = (U mod R) * N' mod R: dropping limbs >= 30 removes multiples of
    # R; limbs < 2^49, and four truncating passes bring them to <= 2^13, so
    # mu < 1.001 R and T/R < p^2/R + 1.001 p < 2p
    mu = _conv(u[..., :NLIMBS], limb_const("nprime", a.device, torch.int64), NLIMBS)
    for _ in range(4):
        mu = _carry_trunc(mu)
    # T = U + mu*p: limbs < 2^31 + 2^31; two passes -> <= 2^13 + 64
    t = _carry_widen(_carry_widen(u + _conv(mu, limb_const("p", a.device, torch.int64))))
    # T < 2^772: every limb from 60 up is zero in any non-negative limb form
    t = _resolve(t[..., : 2 * NLIMBS])
    return _cond_sub_p(t[..., NLIMBS : 2 * NLIMBS]).to(torch.int32)


def f2_mul_plain(a, b):
    """Plain version of K2 (same formula: three products, fused adds)."""
    a0, a1, b0, b1 = torch.broadcast_tensors(a[0], a[1], b[0], b[1])
    s = add_mod_plain(torch.stack([a0, b0]), torch.stack([a1, b1]))
    t = mont_mul_plain(torch.stack([a0, a1, s[0]]), torch.stack([b0, b1, s[1]]))
    d = sub_mod_plain(torch.stack([t[0], t[2]]), torch.stack([t[1], t[0]]))
    return d[0], sub_mod_plain(d[1], t[1])


def f2_sqr_plain(a):
    """Plain version of K3: (a0+a1)(a0-a1), 2 a0 a1."""
    a0, a1 = torch.broadcast_tensors(a[0], a[1])
    t = mont_mul_plain(
        torch.stack([add_mod_plain(a0, a1), a0]), torch.stack([sub_mod_plain(a0, a1), a1])
    )
    return t[0], add_mod_plain(t[1], t[1])


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _operands(*xs) -> Tuple[torch.Tensor, ...]:
    for x in xs:
        if x.dtype != torch.int32:
            raise TypeError(f"limb tensors must be torch.int32, got {x.dtype}")
        if x.shape[-1] != NLIMBS:
            raise ValueError(f"limb tensors need a last axis of {NLIMBS}, got {tuple(x.shape)}")
    if len({x.device for x in xs}) != 1:
        raise ValueError("limb tensors lie on different devices")
    return torch.broadcast_tensors(*xs)


def _launch(name: str, fn, n_out: int, *xs):
    """Launch one kernel on contiguous copies of ``xs``; returns the outputs."""
    lib = _build.library()
    dev = xs[0].device
    if dev.type != "cuda":
        raise ValueError(f"the {name} kernel runs on CUDA tensors, not {dev}")
    if dev.index is not None and dev.index != torch.cuda.current_device():
        raise ValueError(f"the {name} kernel launches on the current device, not {dev}")
    xs = [x.contiguous() for x in xs]
    outs = [torch.empty(xs[0].shape, dtype=torch.int32, device=dev) for _ in range(n_out)]
    n = xs[0].numel() // NLIMBS
    if n:
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, fn)(*[t.data_ptr() for t in (*xs, *outs)], n, stream)
        if rc != 0:
            raise RuntimeError(f"{name} kernel launch failed with cudaError {rc}")
        LAUNCHES[name] += 1
        LAUNCH_SIZES[name][n] = LAUNCH_SIZES[name].get(n, 0) + 1
    return outs


def mont_mul(a, b):
    """K1: Montgomery product a*b*R^-1 mod p, canonical in and out."""
    a, b = _operands(a, b)
    if a.device.type == "cpu":
        return mont_mul_plain(a, b)
    (out,) = _launch("mont_mul", "lodestar_fp_mont_mul", 1, a, b)
    return out


def f2_mul(a, b):
    """K2: Fp2 product of two (c0, c1) tuples -> (c0, c1)."""
    a0, a1, b0, b1 = _operands(a[0], a[1], b[0], b[1])
    if a0.device.type == "cpu":
        return f2_mul_plain((a0, a1), (b0, b1))
    c0, c1 = _launch("f2_mul", "lodestar_fp_f2_mul", 2, a0, a1, b0, b1)
    return c0, c1


def f2_sqr(a):
    """K3: Fp2 square of a (c0, c1) tuple -> (c0, c1)."""
    a0, a1 = _operands(a[0], a[1])
    if a0.device.type == "cpu":
        return f2_sqr_plain((a0, a1))
    c0, c1 = _launch("f2_sqr", "lodestar_fp_f2_sqr", 2, a0, a1)
    return c0, c1


def add_mod(a, b):
    """a + b mod p on canonical limbs (broadcasting): one launch."""
    a, b = _operands(a, b)
    if a.device.type == "cpu":
        return add_mod_plain(a, b)
    (out,) = _launch("add_mod", "lodestar_fp_add_mod", 1, a, b)
    return out


def sub_mod(a, b):
    """a - b mod p on canonical limbs (broadcasting): one launch."""
    a, b = _operands(a, b)
    if a.device.type == "cpu":
        return sub_mod_plain(a, b)
    (out,) = _launch("sub_mod", "lodestar_fp_sub_mod", 1, a, b)
    return out
