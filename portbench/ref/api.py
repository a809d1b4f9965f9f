# Frozen copy of the verify functions of lodestar_tpu_torch/crypto/bls/api.py
# at commit a7764c99fc009f548297e969c7f2027c1302fc87 (``verify``,
# ``verify_multiple_signature_sets``), kept with the benchmark so that its
# reference imports nothing of the program under test.  One change: a set
# is a plain ``(pubkey, message, signature)`` tuple of affine points, the
# form the generator makes, in place of the port's dataclasses.  Do not
# edit: the yardstick must not move with the program.
"""Host BLS verification, the benchmark's plain reference.

Scheme: minimal-pubkey-size (pubkeys in G1, signatures in G2), POP
ciphersuite, the Ethereum consensus configuration."""
from __future__ import annotations

from typing import List, Sequence, Tuple

from . import curve, pairing
from .curve import AffineG1, AffineG2, G1_GEN_JAC, g1, g2, g2_in_subgroup
from .hash_to_curve import hash_to_g2_affine

_NEG_G1_GEN_AFF = g1.to_affine(g1.neg_pt(G1_GEN_JAC))

RefSet = Tuple[AffineG1, bytes, AffineG2]


def verify(pk: AffineG1, message: bytes, sig: AffineG2) -> bool:
    """CoreVerify: e(pk, H(m)) * e(-G1, sig) == 1."""
    if pk is None or sig is None:
        return False
    if not g2_in_subgroup(g2.from_affine(sig)):
        return False
    h = hash_to_g2_affine(message)
    return pairing.multi_pairing_is_one([(pk, h), (_NEG_G1_GEN_AFF, sig)])


def verify_multiple_signature_sets(sets: Sequence[RefSet], rand: Sequence[int]) -> bool:
    """Batch verification with random linear combination (blst's
    verifyMultipleSignatures):

    prod_i [ e(pk_i, r_i H(m_i)) * e(-G1, r_i sig_i) ] == 1
    realised as  prod_i e(r_i pk_i, H(m_i)) * e(-G1, sum_i r_i sig_i) == 1
    so the n+1 Miller loops share one final exponentiation.
    """
    if not sets:
        return False
    if len(rand) != len(sets):
        raise ValueError("rand coefficient count must match set count")
    pairs: List[Tuple[AffineG1, AffineG2]] = []
    sig_acc = curve.INF_G2
    for (pk, message, sig), r in zip(sets, rand):
        if pk is None or sig is None:
            return False
        if not g2_in_subgroup(g2.from_affine(sig)):
            return False
        h = hash_to_g2_affine(message)
        rpk = g1.to_affine(g1.mul_scalar(g1.from_affine(pk), r))
        pairs.append((rpk, h))
        sig_acc = g2.add_pts(sig_acc, g2.mul_scalar(g2.from_affine(sig), r))
    pairs.append((_NEG_G1_GEN_AFF, g2.to_affine(sig_acc)))
    return pairing.multi_pairing_is_one(pairs)
