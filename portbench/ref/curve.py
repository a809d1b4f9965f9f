# Frozen copy of lodestar_tpu_torch/crypto/bls/curve.py at commit
# a7764c99fc009f548297e969c7f2027c1302fc87, kept with the benchmark so that
# its reference and generator import nothing of the program under test.
# Do not edit: the yardstick must not move with the program.
"""BLS12-381 G1/G2 group operations — pure-Python host oracle (port copy).

Points are represented in Jacobian coordinates as tuples ``(X, Y, Z)`` over
the base field (Fp for G1, Fp2 for G2); ``Z == 0`` is the point at infinity.
Affine points are ``(x, y)`` with an explicit ``None`` for infinity.

This supplies the role that blst's G1/G2 ops play in the reference client
(pubkey aggregation at packages/beacon-node/src/chain/bls/utils.ts:5 — done in
Jacobian coordinates per state-transition/src/cache/pubkeyCache.ts:76).
"""
from __future__ import annotations

from typing import Optional, Tuple

from .fields import (
    P,
    R,
    X,
    Fp2T,
    F2_ONE,
    F2_ZERO,
    f2_add,
    f2_conj,
    f2_inv,
    f2_is_zero,
    f2_mul,
    f2_neg,
    f2_pow,
    f2_sqr,
    f2_sqrt,
    f2_sub,
    fp_add,
    fp_inv,
    fp_mul,
    fp_neg,
    fp_sqrt,
    fp_sub,
)

# Curve: E/Fp:  y^2 = x^3 + 4          (G1)
#        E'/Fp2: y^2 = x^3 + 4(u+1)    (G2, M-twist)
B_G1 = 4
B_G2: Fp2T = (4, 4)

# Standard generators (widely published BLS12-381 constants).
G1_GEN = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)
G2_GEN = (
    (
        0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
    ),
    (
        0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
    ),
)

AffineG1 = Optional[Tuple[int, int]]
AffineG2 = Optional[Tuple[Fp2T, Fp2T]]
JacG1 = Tuple[int, int, int]
JacG2 = Tuple[Fp2T, Fp2T, Fp2T]

INF_G1: JacG1 = (1, 1, 0)
INF_G2: JacG2 = (F2_ONE, F2_ONE, F2_ZERO)


# ---------------------------------------------------------------------------
# Generic Jacobian arithmetic, parameterised by the field ops.  We instantiate
# twice (Fp and Fp2) with small closures; the oracle favours one well-tested
# code path over duplicated formulas.
# ---------------------------------------------------------------------------


class _CurveOps:
    def __init__(self, add, sub, mul, sqr, neg, inv, is_zero, zero, one, b):
        self.add, self.sub, self.mul, self.sqr = add, sub, mul, sqr
        self.neg, self.inv, self.is_zero = neg, inv, is_zero
        self.zero, self.one, self.b = zero, one, b

    # -- Jacobian formulas (standard EFD dbl-2009-l / add-2007-bl) --

    def is_inf(self, pt):
        return self.is_zero(pt[2])

    def double(self, pt):
        X1, Y1, Z1 = pt
        if self.is_zero(Z1) or self.is_zero(Y1):
            return (self.one, self.one, self.zero)
        A = self.sqr(X1)
        B = self.sqr(Y1)
        C = self.sqr(B)
        D = self.sub(self.sqr(self.add(X1, B)), self.add(A, C))
        D = self.add(D, D)
        E = self.add(self.add(A, A), A)
        F = self.sqr(E)
        X3 = self.sub(F, self.add(D, D))
        C8 = self.add(C, C)
        C8 = self.add(C8, C8)
        C8 = self.add(C8, C8)
        Y3 = self.sub(self.mul(E, self.sub(D, X3)), C8)
        Z3 = self.mul(self.add(Y1, Y1), Z1)
        return (X3, Y3, Z3)

    def add_pts(self, p1, p2):
        if self.is_inf(p1):
            return p2
        if self.is_inf(p2):
            return p1
        X1, Y1, Z1 = p1
        X2, Y2, Z2 = p2
        Z1Z1 = self.sqr(Z1)
        Z2Z2 = self.sqr(Z2)
        U1 = self.mul(X1, Z2Z2)
        U2 = self.mul(X2, Z1Z1)
        S1 = self.mul(self.mul(Y1, Z2), Z2Z2)
        S2 = self.mul(self.mul(Y2, Z1), Z1Z1)
        if U1 == U2:
            if S1 != S2:
                return (self.one, self.one, self.zero)
            return self.double(p1)
        H = self.sub(U2, U1)
        I = self.sqr(self.add(H, H))
        J = self.mul(H, I)
        rr = self.sub(S2, S1)
        rr = self.add(rr, rr)
        V = self.mul(U1, I)
        X3 = self.sub(self.sub(self.sqr(rr), J), self.add(V, V))
        S1J = self.mul(S1, J)
        Y3 = self.sub(self.mul(rr, self.sub(V, X3)), self.add(S1J, S1J))
        Z3 = self.mul(self.sub(self.sqr(self.add(Z1, Z2)), self.add(Z1Z1, Z2Z2)), H)
        return (X3, Y3, Z3)

    def neg_pt(self, pt):
        return (pt[0], self.neg(pt[1]), pt[2])

    def mul_scalar(self, pt, k: int):
        if k < 0:
            return self.mul_scalar(self.neg_pt(pt), -k)
        result = (self.one, self.one, self.zero)
        addend = pt
        while k:
            if k & 1:
                result = self.add_pts(result, addend)
            addend = self.double(addend)
            k >>= 1
        return result

    def to_affine(self, pt):
        if self.is_inf(pt):
            return None
        zinv = self.inv(pt[2])
        zinv2 = self.sqr(zinv)
        return (self.mul(pt[0], zinv2), self.mul(self.mul(pt[1], zinv), zinv2))

    def from_affine(self, aff):
        if aff is None:
            return (self.one, self.one, self.zero)
        return (aff[0], aff[1], self.one)

    def on_curve(self, aff) -> bool:
        if aff is None:
            return True
        x, y = aff
        return self.sqr(y) == self.add(self.mul(self.sqr(x), x), self.b)

    def eq(self, p1, p2) -> bool:
        inf1, inf2 = self.is_inf(p1), self.is_inf(p2)
        if inf1 or inf2:
            return inf1 == inf2
        # X1 Z2^2 == X2 Z1^2 and Y1 Z2^3 == Y2 Z1^3
        Z1Z1, Z2Z2 = self.sqr(p1[2]), self.sqr(p2[2])
        if self.mul(p1[0], Z2Z2) != self.mul(p2[0], Z1Z1):
            return False
        return self.mul(self.mul(p1[1], p2[2]), Z2Z2) == self.mul(self.mul(p2[1], p1[2]), Z1Z1)


def _fp_is_zero(a: int) -> bool:
    return a == 0


g1 = _CurveOps(fp_add, fp_sub, fp_mul, lambda a: a * a % P, fp_neg, fp_inv, _fp_is_zero, 0, 1, B_G1)
g2 = _CurveOps(f2_add, f2_sub, f2_mul, f2_sqr, f2_neg, f2_inv, f2_is_zero, F2_ZERO, F2_ONE, B_G2)

G1_GEN_JAC: JacG1 = g1.from_affine(G1_GEN)
G2_GEN_JAC: JacG2 = g2.from_affine(G2_GEN)


# ---------------------------------------------------------------------------
# psi endomorphism on E'(Fp2): untwist -> Frobenius -> twist.
# psi(x, y) = (c_x * conj(x), c_y * conj(y)) with constants computed at
# import time:  c_x = 1/xi^((p-1)/3),  c_y = 1/xi^((p-1)/2).
# On G2 psi acts as the Frobenius eigenvalue; used for fast cofactor clearing
# and (testably) satisfies psi(P) == [p mod r] P for P in G2.
# ---------------------------------------------------------------------------

_XI: Fp2T = (1, 1)
PSI_CX = f2_inv(f2_pow(_XI, (P - 1) // 3))
PSI_CY = f2_inv(f2_pow(_XI, (P - 1) // 2))


def psi(pt: JacG2) -> JacG2:
    aff = g2.to_affine(pt)
    if aff is None:
        return INF_G2
    x, y = aff
    return g2.from_affine((f2_mul(PSI_CX, f2_conj(x)), f2_mul(PSI_CY, f2_conj(y))))


def clear_cofactor_g2(pt: JacG2) -> JacG2:
    """Budroni-Pintore efficient cofactor clearing (RFC 9380 appendix G.3):

    h_eff * P = [x^2 - x - 1]P + [x - 1]psi(P) + psi^2([2]P)

    (coefficient choice validated numerically: the result of this combination
    on a random E'(Fp2) point lands in the r-torsion; the sign variants do not)
    """
    x_p = g2.mul_scalar(pt, X)                 # [x]P      (x negative)
    x2_p = g2.mul_scalar(x_p, X)               # [x^2]P
    part1 = g2.add_pts(g2.add_pts(x2_p, g2.neg_pt(x_p)), g2.neg_pt(pt))   # [x^2-x-1]P
    part2 = g2.mul_scalar(psi(pt), X - 1)      # [x-1]psi(P)
    part3 = psi(psi(g2.double(pt)))            # psi^2([2]P)
    return g2.add_pts(g2.add_pts(part1, part2), part3)


def g2_in_subgroup(pt: JacG2) -> bool:
    """Fast subgroup check: psi(P) == [x]P  iff  P in G2 (Bowe's criterion)."""
    if g2.is_inf(pt):
        return True
    if not g2.on_curve(g2.to_affine(pt)):
        return False
    return g2.eq(psi(pt), g2.mul_scalar(pt, X))


def g1_in_subgroup(pt: JacG1) -> bool:
    """G1 subgroup check via the GLV endomorphism sigma(x,y) = (beta*x, y):
    P in G1  iff  sigma^2(P) == [-x^2] ... we use the direct criterion
    [r]P == inf (the oracle favours obviousness)."""
    if g1.is_inf(pt):
        return True
    if not g1.on_curve(g1.to_affine(pt)):
        return False
    return g1.is_inf(g1.mul_scalar(pt, R))


# ---------------------------------------------------------------------------
# Serialization — ZCash-style compressed/uncompressed encodings used by the
# Ethereum consensus spec (48B G1 / 96B G2 compressed; flag bits in the top
# three bits of the first byte: compressed, infinity, lexicographically-larger-y).
# ---------------------------------------------------------------------------

_COMP = 0x80
_INF = 0x40
_SORT = 0x20
_HALF_P = (P - 1) // 2


def _fp_to_bytes(a: int) -> bytes:
    return a.to_bytes(48, "big")


def g1_to_bytes(aff: AffineG1, compressed: bool = True) -> bytes:
    if not compressed:
        if aff is None:
            out = bytearray(96)
            out[0] = _INF
            return bytes(out)
        return _fp_to_bytes(aff[0]) + _fp_to_bytes(aff[1])
    if aff is None:
        out = bytearray(48)
        out[0] = _COMP | _INF
        return bytes(out)
    x, y = aff
    flags = _COMP | (_SORT if y > _HALF_P else 0)
    out = bytearray(_fp_to_bytes(x))
    out[0] |= flags
    return bytes(out)


def g1_from_bytes(data: bytes) -> AffineG1:
    """Decode + validate (on curve; subgroup check is separate)."""
    if len(data) == 48:
        flags = data[0]
        if not flags & _COMP:
            raise ValueError("48-byte G1 encoding must have compression bit set")
        if flags & _INF:
            if any(data[1:]) or data[0] != (_COMP | _INF):
                raise ValueError("invalid G1 infinity encoding")
            return None
        x = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:], "big")
        if x >= P:
            raise ValueError("G1 x >= p")
        y = fp_sqrt((x * x % P * x + B_G1) % P)
        if y is None:
            raise ValueError("G1 x not on curve")
        y_big = y > _HALF_P
        if bool(flags & _SORT) != y_big:
            y = fp_neg(y)
        return (x, y)
    elif len(data) == 96:
        if data[0] & (_COMP | _SORT):
            raise ValueError("uncompressed G1 encoding has invalid flag bits")
        if data[0] & _INF:
            if data[0] != _INF or any(data[1:]):
                raise ValueError("invalid G1 infinity encoding")
            return None
        x = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:48], "big")
        y = int.from_bytes(data[48:], "big")
        if x >= P or y >= P:
            raise ValueError("G1 coordinate >= p")
        if not g1.on_curve((x, y)):
            raise ValueError("G1 point not on curve")
        return (x, y)
    raise ValueError(f"invalid G1 encoding length {len(data)}")


def g2_to_bytes(aff: AffineG2, compressed: bool = True) -> bytes:
    if not compressed:
        if aff is None:
            out = bytearray(192)
            out[0] = _INF
            return bytes(out)
        (x0, x1), (y0, y1) = aff
        return _fp_to_bytes(x1) + _fp_to_bytes(x0) + _fp_to_bytes(y1) + _fp_to_bytes(y0)
    if aff is None:
        out = bytearray(96)
        out[0] = _COMP | _INF
        return bytes(out)
    (x0, x1), (y0, y1) = aff
    y_big = (y1 > _HALF_P) or (y1 == 0 and y0 > _HALF_P)
    flags = _COMP | (_SORT if y_big else 0)
    out = bytearray(_fp_to_bytes(x1) + _fp_to_bytes(x0))
    out[0] |= flags
    return bytes(out)


def g2_from_bytes(data: bytes) -> AffineG2:
    if len(data) == 96:
        flags = data[0]
        if not flags & _COMP:
            raise ValueError("96-byte G2 encoding must have compression bit set")
        if flags & _INF:
            if any(data[1:]) or data[0] != (_COMP | _INF):
                raise ValueError("invalid G2 infinity encoding")
            return None
        x1 = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:48], "big")
        x0 = int.from_bytes(data[48:96], "big")
        if x0 >= P or x1 >= P:
            raise ValueError("G2 x coordinate >= p")
        x = (x0, x1)
        y = f2_sqrt(f2_add(f2_mul(f2_sqr(x), x), B_G2))
        if y is None:
            raise ValueError("G2 x not on curve")
        y_big = (y[1] > _HALF_P) or (y[1] == 0 and y[0] > _HALF_P)
        if bool(flags & _SORT) != y_big:
            y = f2_neg(y)
        return (x, y)
    elif len(data) == 192:
        if data[0] & (_COMP | _SORT):
            raise ValueError("uncompressed G2 encoding has invalid flag bits")
        if data[0] & _INF:
            if data[0] != _INF or any(data[1:]):
                raise ValueError("invalid G2 infinity encoding")
            return None
        x1 = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:48], "big")
        x0 = int.from_bytes(data[48:96], "big")
        y1 = int.from_bytes(data[96:144], "big")
        y0 = int.from_bytes(data[144:], "big")
        if max(x0, x1, y0, y1) >= P:
            raise ValueError("G2 coordinate >= p")
        aff = ((x0, x1), (y0, y1))
        if not g2.on_curve(aff):
            raise ValueError("G2 point not on curve")
        return aff
    raise ValueError(f"invalid G2 encoding length {len(data)}")
