# Frozen copy of lodestar_tpu_torch/crypto/bls/hash_to_curve.py at commit
# a7764c99fc009f548297e969c7f2027c1302fc87, kept with the benchmark so that
# its reference and generator import nothing of the program under test.
# Do not edit: the yardstick must not move with the program.
"""RFC 9380 hash-to-curve for BLS12-381 G2 (BLS12381G2_XMD:SHA-256_SSWU_RO_).

Ethereum consensus signs over G2 with the proof-of-possession ciphersuite DST
``BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_`` (the scheme the reference's
``@chainsafe/bls`` backends implement).

Pipeline: expand_message_xmd(SHA-256) -> hash_to_field(Fp2, count=2) ->
simplified SWU on the 3-isogenous curve E'' -> isogeny map to E' ->
clear_cofactor (psi-based Budroni-Pintore, equivalent to h_eff per RFC 9380
appendix G.3).

The port's copy of the oracle pipeline: pure Python over ``hashlib``, with
no native fast path.  The device engine takes the SSWU and isogeny tables
from here, and tests hold the copy equal to the JAX package's oracle.
"""
from __future__ import annotations

import hashlib
from typing import List, Tuple

from .curve import JacG2, clear_cofactor_g2, g2
from .fields import (
    P,
    Fp2T,
    F2_ONE,
    f2_add,
    f2_inv,
    f2_is_zero,
    f2_mul,
    f2_neg,
    f2_sgn0,
    f2_sqr,
    f2_sqrt,
    f2_sub,
)

CIPHERSUITE_DST = b"BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_"

# --- SSWU parameters for the 3-isogenous curve E'': y^2 = x^3 + A'x + B' ---
SSWU_A: Fp2T = (0, 240)
SSWU_B: Fp2T = (1012, 1012)
SSWU_Z: Fp2T = (P - 2, P - 1)  # -(2 + u)

# --- 3-isogeny map E'' -> E' coefficients (RFC 9380 appendix E.3) ---
_C1 = 0x5C759507E8E333EBB5B7A9A47D7ED8532C52D39FD3A042A88B58423C50AE15D5C2638E343D9C71C6238AAAAAAAA97D6
_C2 = 0x11560BF17BAA99BC32126FCED787C88F984F87ADF7AE0C7F9A208C6B4F20A4181472AAA9CB8D555526A9FFFFFFFFC71A
_C3 = 0x11560BF17BAA99BC32126FCED787C88F984F87ADF7AE0C7F9A208C6B4F20A4181472AAA9CB8D555526A9FFFFFFFFC71E
_C4 = 0x8AB05F8BDD54CDE190937E76BC3E447CC27C3D6FBD7063FCD104635A790520C0A395554E5C6AAAA9354FFFFFFFFE38D
_C5 = 0x171D6541FA38CCFAED6DEA691F5FB614CB14B4E7F4E810AA22D6108F142B85757098E38D0F671C7188E2AAAAAAAA5ED1

XNUM: List[Fp2T] = [
    (_C1, _C1),
    (0, _C2),
    (_C3, _C4),
    (_C5, 0),
]
XDEN: List[Fp2T] = [
    (0, P - 0x48),        # (p - 72) * u
    (0xC, P - 0xC),       # 12 + (p - 12) u
    F2_ONE,               # monic x^2
]
_C6 = 0x1530477C7AB4113B59A4C18B076D11930F7DA5D4A07F649BF54439D87D27E500FC8C25EBF8C92F6812CFC71C71C6D706
_C7 = 0x5C759507E8E333EBB5B7A9A47D7ED8532C52D39FD3A042A88B58423C50AE15D5C2638E343D9C71C6238AAAAAAAA97BE
_C8 = 0x11560BF17BAA99BC32126FCED787C88F984F87ADF7AE0C7F9A208C6B4F20A4181472AAA9CB8D555526A9FFFFFFFFC71C
_C9 = 0x8AB05F8BDD54CDE190937E76BC3E447CC27C3D6FBD7063FCD104635A790520C0A395554E5C6AAAA9354FFFFFFFFE38F
_C10 = 0x124C9AD43B6CF79BFBF7043DE3811AD0761B0F37A1E26286B0E977C69AA274524E79097A56DC4BD9E1B371C71C718B10

YNUM: List[Fp2T] = [
    (_C6, _C6),
    (0, _C7),
    (_C8, _C9),
    (_C10, 0),
]
YDEN: List[Fp2T] = [
    (P - 0x1B0, P - 0x1B0),   # (p - 432)(1 + u)
    (0, P - 0xD8),            # (p - 216) u
    (0x12, P - 0x12),
    F2_ONE,                   # monic x^3
]


# ---------------------------------------------------------------------------
# expand_message_xmd (SHA-256)
# ---------------------------------------------------------------------------


def expand_message_xmd(msg: bytes, dst: bytes, len_in_bytes: int) -> bytes:
    b_in_bytes = 32   # SHA-256 output
    r_in_bytes = 64   # SHA-256 block
    ell = (len_in_bytes + b_in_bytes - 1) // b_in_bytes
    if ell > 255 or len(dst) > 255:
        raise ValueError("expand_message_xmd: invalid length")
    dst_prime = dst + bytes([len(dst)])
    z_pad = bytes(r_in_bytes)
    l_i_b = len_in_bytes.to_bytes(2, "big")
    b0 = hashlib.sha256(z_pad + msg + l_i_b + b"\x00" + dst_prime).digest()
    b = [hashlib.sha256(b0 + b"\x01" + dst_prime).digest()]
    for i in range(2, ell + 1):
        tv = bytes(x ^ y for x, y in zip(b0, b[-1]))
        b.append(hashlib.sha256(tv + bytes([i]) + dst_prime).digest())
    return b"".join(b)[:len_in_bytes]


def hash_to_field_fp2(msg: bytes, count: int, dst: bytes = CIPHERSUITE_DST) -> List[Fp2T]:
    L = 64
    uniform = expand_message_xmd(msg, dst, count * 2 * L)
    out = []
    for i in range(count):
        e = []
        for j in range(2):
            off = L * (j + i * 2)
            e.append(int.from_bytes(uniform[off : off + L], "big") % P)
        out.append((e[0], e[1]))
    return out


# ---------------------------------------------------------------------------
# Simplified SWU on E'' and isogeny to E'
# ---------------------------------------------------------------------------


def map_to_curve_sswu(t: Fp2T) -> Tuple[Fp2T, Fp2T]:
    """Non-constant-time simplified SWU; returns a point on E''."""
    zt2 = f2_mul(SSWU_Z, f2_sqr(t))          # Z t^2
    tv1 = f2_add(f2_sqr(zt2), zt2)           # Z^2 t^4 + Z t^2
    if f2_is_zero(tv1):
        x1 = f2_mul(SSWU_B, f2_inv(f2_mul(SSWU_Z, SSWU_A)))
    else:
        x1 = f2_mul(
            f2_mul(f2_neg(SSWU_B), f2_inv(SSWU_A)),
            f2_add(F2_ONE, f2_inv(tv1)),
        )
    gx1 = f2_add(f2_mul(f2_add(f2_sqr(x1), SSWU_A), x1), SSWU_B)
    y = f2_sqrt(gx1)
    if y is not None:
        x = x1
    else:
        x2 = f2_mul(zt2, x1)
        gx2 = f2_add(f2_mul(f2_add(f2_sqr(x2), SSWU_A), x2), SSWU_B)
        x, y = x2, f2_sqrt(gx2)
    assert y is not None
    if f2_sgn0(t) != f2_sgn0(y):
        y = f2_neg(y)
    return (x, y)


def _horner(coeffs: List[Fp2T], x: Fp2T) -> Fp2T:
    acc = coeffs[-1]
    for c in reversed(coeffs[:-1]):
        acc = f2_add(f2_mul(acc, x), c)
    return acc


def iso_map_g2(x: Fp2T, y: Fp2T) -> Tuple[Fp2T, Fp2T]:
    """3-isogeny E'' -> E'."""
    x_num = _horner(XNUM, x)
    x_den = _horner(XDEN, x)
    y_num = _horner(YNUM, x)
    y_den = _horner(YDEN, x)
    xo = f2_mul(x_num, f2_inv(x_den))
    yo = f2_mul(f2_mul(y, y_num), f2_inv(y_den))
    return (xo, yo)


# ---------------------------------------------------------------------------
# Full hash_to_curve
# ---------------------------------------------------------------------------


def map_to_curve_g2(t: Fp2T) -> Tuple[Fp2T, Fp2T]:
    x, y = map_to_curve_sswu(t)
    return iso_map_g2(x, y)


def hash_to_g2(msg: bytes, dst: bytes = CIPHERSUITE_DST) -> JacG2:
    """hash_to_curve: returns a Jacobian point in the G2 subgroup."""
    u0, u1 = hash_to_field_fp2(msg, 2, dst)
    q0 = g2.from_affine(map_to_curve_g2(u0))
    q1 = g2.from_affine(map_to_curve_g2(u1))
    return clear_cofactor_g2(g2.add_pts(q0, q1))


def hash_to_g2_affine(msg: bytes, dst: bytes = CIPHERSUITE_DST):
    """Affine hash_to_curve (None never occurs for a real message)."""
    return g2.to_affine(hash_to_g2(msg, dst))
