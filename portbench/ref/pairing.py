# Frozen copy of lodestar_tpu_torch/crypto/bls/pairing.py at commit
# a7764c99fc009f548297e969c7f2027c1302fc87, kept with the benchmark so that
# its reference and generator import nothing of the program under test.
# Do not edit: the yardstick must not move with the program.
"""BLS12-381 optimal ate pairing on Python ints — the port's host oracle.

The port's copy of the oracle pairing.  Strategy: obvious correctness over
speed.  G2 points are *untwisted* into E(Fp12) and the Miller loop runs
with affine line functions in Fp12; the final-exponentiation hard part
uses the x-adic chain (the pairing comes out cubed) that the device program (``ops/bls12_381/pairing.py``)
runs too, so host and device agree bit for bit.  It serves the host tier of
the pool (``chain/bls/device_pool.py``), ``verify_on_main_thread`` and the
expected verdicts of the chip script.

Multi-pairing (shared final exponentiation over a product of Miller loops)
mirrors blst's ``verifyMultipleSignatures`` random-linear-combination batching
used by the reference's BLS pool (chain/bls/maybeBatch.ts:17).
"""
from __future__ import annotations

from typing import Sequence, Tuple

from .curve import AffineG1, AffineG2
from .fields import (
    ABS_X,
    f12_cyclotomic_pow_x,
    F6_ONE,
    F6_ZERO,
    F12_ONE,
    Fp12T,
    f12_conj,
    f12_frobenius,
    f12_inv,
    f12_is_one,
    f12_mul,
    f12_sqr,
    f12_sub,
)

# Fp12 constants for the untwist map: w, w^-2, w^-3  (w^2 = v).
_W: Fp12T = (F6_ZERO, F6_ONE)
_W2 = f12_sqr(_W)
_W3 = f12_mul(_W2, _W)
_W2_INV = f12_inv(_W2)
_W3_INV = f12_inv(_W3)


Fp12Point = Tuple[Fp12T, Fp12T]  # affine point over Fp12 (never infinity here)


def _embed_fp(a: int) -> Fp12T:
    return (((a, 0), (0, 0), (0, 0)), F6_ZERO)


def _embed_fp2(a) -> Fp12T:
    return ((a, (0, 0), (0, 0)), F6_ZERO)


def untwist(q: AffineG2) -> Fp12Point:
    """E'(Fp2) -> E(Fp12): (x, y) -> (x * w^-2, y * w^-3)."""
    assert q is not None
    x, y = q
    return (f12_mul(_embed_fp2(x), _W2_INV), f12_mul(_embed_fp2(y), _W3_INV))


def embed_g1(p: AffineG1) -> Fp12Point:
    assert p is not None
    return (_embed_fp(p[0]), _embed_fp(p[1]))


def _line_and_step(r: Fp12Point, q: Fp12Point, at: Fp12Point, doubling: bool):
    """Evaluate the line through r,q (tangent if doubling) at ``at`` and return
    (line_value, r_next)."""
    xr, yr = r
    xq, yq = q
    xt, yt = at
    if doubling:
        # tangent slope m = 3 x^2 / 2 y
        xx = f12_sqr(xr)
        num = f12_mul(_embed_fp(3), xx)
        den = f12_inv(f12_mul(_embed_fp(2), yr))
        m = f12_mul(num, den)
        x2 = xr
    else:
        if xr == xq:
            # vertical line (r == -q): value = xt - xr; result is infinity but
            # this never happens in a subgroup Miller loop with ABS_X < r.
            return f12_sub(xt, xr), None
        m = f12_mul(f12_sub(yq, yr), f12_inv(f12_sub(xq, xr)))
        x2 = xq
    # new point
    xn = f12_sub(f12_sub(f12_sqr(m), xr), x2)
    yn = f12_sub(f12_mul(m, f12_sub(xr, xn)), yr)
    # line value at `at`: m*(xt - xr) - (yt - yr)
    line = f12_sub(f12_mul(m, f12_sub(xt, xr)), f12_sub(yt, yr))
    return line, (xn, yn)


def miller_loop(q: AffineG2, p: AffineG1) -> Fp12T:
    """f_{|x|,Q}(P), conjugated for the negative BLS parameter x."""
    if q is None or p is None:
        return F12_ONE
    q12 = untwist(q)
    p12 = embed_g1(p)
    r = q12
    f = F12_ONE
    for bit in bin(ABS_X)[3:]:  # MSB already consumed by r = q
        line, r = _line_and_step(r, r, p12, doubling=True)
        f = f12_mul(f12_sqr(f), line)
        if bit == "1":
            line, r = _line_and_step(r, q12, p12, doubling=False)
            f = f12_mul(f, line)
    # x < 0  =>  invert, realised as conjugation under the final exponentiation
    return f12_conj(f)


def _pow_neg_x(a: Fp12T) -> Fp12T:
    """a^x for the (negative) BLS parameter x, for cyclotomic-subgroup a.

    a^x = conj(a^|x|) since inversion is conjugation in the cyclotomic
    subgroup.
    """
    return f12_conj(f12_cyclotomic_pow_x(a))


def hard_part_x_chain(m: Fp12T) -> Fp12T:
    """m^(3*(p^4 - p^2 + 1)/r) via the x-adic chain (5 pow-by-x).

    Uses 3*(p^4-p^2+1)/r = (x-1)^2 (x+p)(x^2+p^2-1) + 3 — the standard
    BLS12 hard-part decomposition.  The spurious cube is harmless for
    pairing equality checks because gcd(3, r) = 1; the device program
    implements the identical chain so the two agree bit for bit.
    """
    # t1 = m^((x-1)^2):  m^(x-1) = conj(m^|x| * m)  (x < 0)
    t0 = f12_conj(f12_mul(f12_cyclotomic_pow_x(m), m))
    t1 = f12_conj(f12_mul(f12_cyclotomic_pow_x(t0), t0))
    # a = t1^(x+p)
    a = f12_mul(_pow_neg_x(t1), f12_frobenius(t1, 1))
    # t4 = a^(x^2+p^2-1) = (a^x)^x * a^(p^2) * conj(a)
    b = _pow_neg_x(a)
    t4 = f12_mul(f12_mul(_pow_neg_x(b), f12_frobenius(a, 2)), f12_conj(a))
    # * m^3
    return f12_mul(t4, f12_mul(f12_sqr(m), m))


def _easy_part(f: Fp12T) -> Fp12T:
    """f^((p^6 - 1)(p^2 + 1)) — shared by both hard-part variants."""
    f1 = f12_mul(f12_conj(f), f12_inv(f))          # f^(p^6 - 1)
    return f12_mul(f12_frobenius(f1, 2), f1)       # ^(p^2 + 1)


def final_exponentiation(f: Fp12T) -> Fp12T:
    # hard part (times 3, see hard_part_x_chain)
    return hard_part_x_chain(_easy_part(f))


def pairing(p: AffineG1, q: AffineG2) -> Fp12T:
    """e(P, Q)^3 for P in G1, Q in G2 (affine, None = infinity).

    NOTE: this returns the standard ate pairing CUBED — final_exponentiation
    uses the x-adic hard part 3*(p^4-p^2+1)/r (see hard_part_x_chain).  All
    is-one / equality / bilinearity checks are unaffected (gcd(3, r) = 1 so
    g -> g^3 is a bijection of the r-torsion GT), and the device program
    implements the identical chain, so the two agree bit for bit.
    """
    if p is None or q is None:
        return F12_ONE
    return final_exponentiation(miller_loop(q, p))


def multi_miller_loop(pairs: Sequence[Tuple[AffineG1, AffineG2]]) -> Fp12T:
    acc = F12_ONE
    for p, q in pairs:
        if p is None or q is None:
            continue
        acc = f12_mul(acc, miller_loop(q, p))
    return acc


def multi_pairing_is_one(pairs: Sequence[Tuple[AffineG1, AffineG2]]) -> bool:
    """prod_i e(P_i, Q_i) == 1, with a single shared final exponentiation."""
    return f12_is_one(final_exponentiation(multi_miller_loop(pairs)))
