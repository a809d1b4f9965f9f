# Frozen copy of lodestar_tpu_torch/crypto/bls/fields.py at commit
# a7764c99fc009f548297e969c7f2027c1302fc87, kept with the benchmark so that
# its reference and generator import nothing of the program under test.
# Do not edit: the yardstick must not move with the program.
"""BLS12-381 field tower arithmetic on Python ints — the port's host oracle.

The port's own copy of the integer-level field code: the curve constants
(P, R, ABS_X), Fp and Fp2 for the host curve code, hash-to-curve and
signing, the Fp6/Fp12 tower, Frobenius and cyclotomic helpers for the host
pairing (``pairing.py``), and the Frobenius coefficients GAMMA1 that the
device tower encodes.  The port keeps a copy so that it imports nothing of
the JAX package.

Representation (functional, tuple-based — mirrors the device layout):
  Fp   : python int in [0, P)
  Fp2  : (c0, c1)            meaning c0 + c1*u,  u^2 = -1
  Fp6  : (a0, a1, a2)        meaning a0 + a1*v + a2*v^2,  v^3 = xi = u + 1
  Fp12 : (b0, b1)            meaning b0 + b1*w,  w^2 = v
"""
from __future__ import annotations

from typing import Tuple

# ---------------------------------------------------------------------------
# Curve constants (standard, widely published BLS12-381 parameters)
# ---------------------------------------------------------------------------

P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001  # subgroup order
# BLS parameter x (negative): curve is parameterised by x = -0xd201000000010000
X = -0xD201000000010000
ABS_X = 0xD201000000010000
H_EFF_G1 = 0xD201000000010001  # 1 - x, effective G1 cofactor multiplier (RFC 9380)

Fp2T = Tuple[int, int]
Fp6T = Tuple[Fp2T, Fp2T, Fp2T]
Fp12T = Tuple[Fp6T, Fp6T]

# ---------------------------------------------------------------------------
# Fp
# ---------------------------------------------------------------------------


def fp_add(a: int, b: int) -> int:
    c = a + b
    return c - P if c >= P else c


def fp_sub(a: int, b: int) -> int:
    c = a - b
    return c + P if c < 0 else c


def fp_mul(a: int, b: int) -> int:
    return (a * b) % P


def fp_neg(a: int) -> int:
    return P - a if a else 0


def fp_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("Fp inverse of zero")
    return pow(a, P - 2, P)


def fp_sqrt(a: int) -> int | None:
    """Square root in Fp (P % 4 == 3 so a^((P+1)/4) works). None if no root."""
    c = pow(a, (P + 1) // 4, P)
    return c if c * c % P == a else None


# ---------------------------------------------------------------------------
# Fp2 = Fp[u] / (u^2 + 1)
# ---------------------------------------------------------------------------

F2_ZERO: Fp2T = (0, 0)
F2_ONE: Fp2T = (1, 0)


def f2_add(a: Fp2T, b: Fp2T) -> Fp2T:
    return (fp_add(a[0], b[0]), fp_add(a[1], b[1]))


def f2_sub(a: Fp2T, b: Fp2T) -> Fp2T:
    return (fp_sub(a[0], b[0]), fp_sub(a[1], b[1]))


def f2_neg(a: Fp2T) -> Fp2T:
    return (fp_neg(a[0]), fp_neg(a[1]))


def f2_mul(a: Fp2T, b: Fp2T) -> Fp2T:
    # (a0 + a1 u)(b0 + b1 u) = (a0 b0 - a1 b1) + (a0 b1 + a1 b0) u
    t0 = a[0] * b[0]
    t1 = a[1] * b[1]
    t2 = (a[0] + a[1]) * (b[0] + b[1])
    return ((t0 - t1) % P, (t2 - t0 - t1) % P)


def f2_sqr(a: Fp2T) -> Fp2T:
    # (a0 + a1 u)^2 = (a0+a1)(a0-a1) + 2 a0 a1 u
    t0 = (a[0] + a[1]) * (a[0] - a[1])
    t1 = 2 * a[0] * a[1]
    return (t0 % P, t1 % P)


def f2_conj(a: Fp2T) -> Fp2T:
    return (a[0], fp_neg(a[1]))


def f2_inv(a: Fp2T) -> Fp2T:
    # (a0 - a1 u) / (a0^2 + a1^2)
    norm = (a[0] * a[0] + a[1] * a[1]) % P
    ninv = fp_inv(norm)
    return (a[0] * ninv % P, (P - a[1]) * ninv % P if a[1] else 0)


def f2_mul_by_xi(a: Fp2T) -> Fp2T:
    # xi = 1 + u:  (a0 + a1 u)(1 + u) = (a0 - a1) + (a0 + a1) u
    return (fp_sub(a[0], a[1]), fp_add(a[0], a[1]))


def f2_pow(a: Fp2T, e: int) -> Fp2T:
    result = F2_ONE
    base = a
    while e:
        if e & 1:
            result = f2_mul(result, base)
        base = f2_sqr(base)
        e >>= 1
    return result


def f2_is_zero(a: Fp2T) -> bool:
    return a[0] == 0 and a[1] == 0


def f2_sqrt(a: Fp2T) -> Fp2T | None:
    """Square root in Fp2 (algorithm for p % 4 == 3: Adj-Rodriguez)."""
    if f2_is_zero(a):
        return F2_ZERO
    # Adj-Rodriguez for p % 4 == 3:
    #   a1 = a^((p-3)/4); x0 = a1*a; alpha = a1*x0 = a^((p-1)/2)
    #   alpha == -1  ->  x = u * x0;  else  x = (1+alpha)^((p-1)/2) * x0
    a1 = f2_pow(a, (P - 3) // 4)
    x0 = f2_mul(a1, a)
    alpha = f2_mul(a1, x0)
    if alpha == (P - 1, 0):
        x = (fp_neg(x0[1]), x0[0])  # u * x0
    else:
        b = f2_pow(f2_add(F2_ONE, alpha), (P - 1) // 2)
        x = f2_mul(b, x0)
    return x if f2_sqr(x) == a else None


def f2_sgn0(a: Fp2T) -> int:
    """RFC 9380 sgn0 for Fp2 (sign of the 'lowest' non-zero component)."""
    sign_0 = a[0] & 1
    zero_0 = 1 if a[0] == 0 else 0
    sign_1 = a[1] & 1
    return sign_0 | (zero_0 & sign_1)


# ---------------------------------------------------------------------------
# Fp6 = Fp2[v] / (v^3 - xi),  xi = u + 1
# ---------------------------------------------------------------------------

F6_ZERO: Fp6T = (F2_ZERO, F2_ZERO, F2_ZERO)
F6_ONE: Fp6T = (F2_ONE, F2_ZERO, F2_ZERO)


def f6_add(a: Fp6T, b: Fp6T) -> Fp6T:
    return (f2_add(a[0], b[0]), f2_add(a[1], b[1]), f2_add(a[2], b[2]))


def f6_sub(a: Fp6T, b: Fp6T) -> Fp6T:
    return (f2_sub(a[0], b[0]), f2_sub(a[1], b[1]), f2_sub(a[2], b[2]))


def f6_neg(a: Fp6T) -> Fp6T:
    return (f2_neg(a[0]), f2_neg(a[1]), f2_neg(a[2]))


def f6_mul(a: Fp6T, b: Fp6T) -> Fp6T:
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = f2_mul(a0, b0)
    t1 = f2_mul(a1, b1)
    t2 = f2_mul(a2, b2)
    # c0 = t0 + xi*((a1+a2)(b1+b2) - t1 - t2)
    c0 = f2_add(t0, f2_mul_by_xi(f2_sub(f2_sub(f2_mul(f2_add(a1, a2), f2_add(b1, b2)), t1), t2)))
    # c1 = (a0+a1)(b0+b1) - t0 - t1 + xi*t2
    c1 = f2_add(f2_sub(f2_sub(f2_mul(f2_add(a0, a1), f2_add(b0, b1)), t0), t1), f2_mul_by_xi(t2))
    # c2 = (a0+a2)(b0+b2) - t0 - t2 + t1
    c2 = f2_add(f2_sub(f2_sub(f2_mul(f2_add(a0, a2), f2_add(b0, b2)), t0), t2), t1)
    return (c0, c1, c2)


def f6_sqr(a: Fp6T) -> Fp6T:
    return f6_mul(a, a)


def f6_mul_by_v(a: Fp6T) -> Fp6T:
    # (a0 + a1 v + a2 v^2) * v = xi*a2 + a0 v + a1 v^2
    return (f2_mul_by_xi(a[2]), a[0], a[1])


def f6_inv(a: Fp6T) -> Fp6T:
    a0, a1, a2 = a
    c0 = f2_sub(f2_sqr(a0), f2_mul_by_xi(f2_mul(a1, a2)))
    c1 = f2_sub(f2_mul_by_xi(f2_sqr(a2)), f2_mul(a0, a1))
    c2 = f2_sub(f2_sqr(a1), f2_mul(a0, a2))
    t = f2_add(f2_mul(a0, c0), f2_mul_by_xi(f2_add(f2_mul(a1, c2), f2_mul(a2, c1))))
    tinv = f2_inv(t)
    return (f2_mul(c0, tinv), f2_mul(c1, tinv), f2_mul(c2, tinv))


def f6_is_zero(a: Fp6T) -> bool:
    return all(f2_is_zero(c) for c in a)


# ---------------------------------------------------------------------------
# Fp12 = Fp6[w] / (w^2 - v)
# ---------------------------------------------------------------------------

F12_ZERO: Fp12T = (F6_ZERO, F6_ZERO)
F12_ONE: Fp12T = (F6_ONE, F6_ZERO)


def f12_add(a: Fp12T, b: Fp12T) -> Fp12T:
    return (f6_add(a[0], b[0]), f6_add(a[1], b[1]))


def f12_sub(a: Fp12T, b: Fp12T) -> Fp12T:
    return (f6_sub(a[0], b[0]), f6_sub(a[1], b[1]))


def f12_mul(a: Fp12T, b: Fp12T) -> Fp12T:
    a0, a1 = a
    b0, b1 = b
    t0 = f6_mul(a0, b0)
    t1 = f6_mul(a1, b1)
    c0 = f6_add(t0, f6_mul_by_v(t1))
    c1 = f6_sub(f6_sub(f6_mul(f6_add(a0, a1), f6_add(b0, b1)), t0), t1)
    return (c0, c1)


def f12_sqr(a: Fp12T) -> Fp12T:
    a0, a1 = a
    # (a0 + a1 w)^2 = (a0^2 + v a1^2) + 2 a0 a1 w
    t = f6_mul(a0, a1)
    c0 = f6_mul(f6_add(a0, a1), f6_add(a0, f6_mul_by_v(a1)))
    c0 = f6_sub(f6_sub(c0, t), f6_mul_by_v(t))
    c1 = f6_add(t, t)
    return (c0, c1)


def f12_conj(a: Fp12T) -> Fp12T:
    """Conjugation = Frobenius^6 (negates the w component)."""
    return (a[0], f6_neg(a[1]))


def f12_inv(a: Fp12T) -> Fp12T:
    a0, a1 = a
    t = f6_sub(f6_sqr(a0), f6_mul_by_v(f6_sqr(a1)))
    tinv = f6_inv(t)
    return (f6_mul(a0, tinv), f6_neg(f6_mul(a1, tinv)))


def f12_is_one(a: Fp12T) -> bool:
    return a[0] == F6_ONE and f6_is_zero(a[1])


# ---------------------------------------------------------------------------
# Frobenius endomorphism on Fp12.
#
# Coefficients are *computed* at import time (not hard-coded) to avoid any
# transcription risk: gamma1[i] = xi^(i*(p-1)/6) for i in 0..5.
# frobenius(a)_as_Fp2_coeffs[i] = conj(coeff_i) * gamma1[i] in the w-basis.
# ---------------------------------------------------------------------------

_XI: Fp2T = (1, 1)
GAMMA1 = [f2_pow(_XI, i * (P - 1) // 6) for i in range(6)]


def _f12_to_wcoeffs(a: Fp12T) -> list[Fp2T]:
    """Fp12 as 6 Fp2 coefficients in the basis 1, w, w^2(=v), w^3, w^4, w^5."""
    (a0, a1, a2), (b0, b1, b2) = a
    # a0 + a1 v + a2 v^2 + w(b0 + b1 v + b2 v^2), v = w^2
    return [a0, b0, a1, b1, a2, b2]


def _f12_from_wcoeffs(c: list[Fp2T]) -> Fp12T:
    return ((c[0], c[2], c[4]), (c[1], c[3], c[5]))


def f12_frobenius(a: Fp12T, power: int = 1) -> Fp12T:
    out = a
    for _ in range(power % 12):
        coeffs = _f12_to_wcoeffs(out)
        coeffs = [f2_mul(f2_conj(c), GAMMA1[i]) for i, c in enumerate(coeffs)]
        out = _f12_from_wcoeffs(coeffs)
    return out


# ---------------------------------------------------------------------------
# Cyclotomic operations (for the final exponentiation hard part).
# After the easy part, f lies in the cyclotomic subgroup where
# f^(p^6+1... ) structure allows cheap inversion: f^-1 = conj(f).
# ---------------------------------------------------------------------------


def f12_cyclotomic_sqr(a: Fp12T) -> Fp12T:
    # Granger-Scott compressed squaring could go here; plain squaring is fine
    # for the oracle.
    return f12_sqr(a)


def f12_cyclotomic_pow_x(a: Fp12T) -> Fp12T:
    """a^|x| using square-and-multiply over the (sparse) BLS parameter.

    NOTE: exponent is |x|; callers account for the sign of x via conjugation.
    """
    result = F12_ONE
    base = a
    e = ABS_X
    while e:
        if e & 1:
            result = f12_mul(result, base)
        base = f12_cyclotomic_sqr(base)
        e >>= 1
    return result
