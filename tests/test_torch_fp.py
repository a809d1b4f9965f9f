"""The PyTorch port's field layer against the JAX package, limb for limb.

Constants, ``fp`` ops and the plain version of kernel K1 are held against
the JAX package on the same seeded inputs; the Pallas kernel runs in
interpret mode, as in tests/test_pallas_fp.py.  All exact: the values are
canonical residues.
"""
import os
import re

import jax
import numpy as np
import pytest
import torch

from lodestar_tpu.crypto.bls import curve as jorc_curve
from lodestar_tpu.crypto.bls import fields as jorc_fields
from lodestar_tpu.crypto.bls import hash_to_curve as jorc_h2c
from lodestar_tpu.ops.bls12_381 import buckets as jbuckets
from lodestar_tpu.ops.bls12_381 import fp as jfp
from lodestar_tpu.ops.bls12_381 import h2c as jh2c
from lodestar_tpu.ops.bls12_381 import limbs as jlimbs
from lodestar_tpu.ops.bls12_381 import pairing as jpairing
from lodestar_tpu.ops.bls12_381 import pallas_fp
from lodestar_tpu.ops.bls12_381 import tower as jtower
from lodestar_tpu.ops.bls12_381 import verify as jverify
from lodestar_tpu_torch import convert
from lodestar_tpu_torch.crypto.bls import curve as orc_curve
from lodestar_tpu_torch.crypto.bls import fields as orc_fields
from lodestar_tpu_torch.crypto.bls import hash_to_curve as orc_h2c
from lodestar_tpu_torch.ops.bls12_381 import buckets, fp, fp_kernels as fpk, h2c, limbs
from lodestar_tpu_torch.ops.bls12_381 import pairing, tower, verify

torch.set_num_threads(1)

P = orc_fields.P
EDGES = [0, 1, 2, P - 1, P - 2, (P - 1) // 2]


def _rand_ints(seed, n):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(48), "big") % P for _ in range(n)]


def _plain_limbs(vals):
    return np.stack([jlimbs.int_to_limbs(v) for v in vals])


def _mont_limbs(vals):
    return np.stack([jfp.encode_int(v) for v in vals])


def _t(arr):
    return convert.limbs_from_jax(arr, "cpu")


def _np(t):
    return convert.limbs_to_numpy(t)


# ---------------------------------------------------------------------------
# constant tables
# ---------------------------------------------------------------------------

_LIMB_TABLES = ["P_LIMBS", "NPRIME_LIMBS", "R2_LIMBS", "ONE_MONT", "ZERO"]


@pytest.mark.parametrize("name", _LIMB_TABLES)
def test_limb_tables_equal_jax(name):
    assert np.array_equal(getattr(limbs, name), getattr(jlimbs, name))


@pytest.mark.parametrize("name", ["LIMB_BITS", "NLIMBS", "MASK", "N0INV", "NPRIME", "R2", "R1"])
def test_limb_scalars_equal_jax(name):
    assert getattr(limbs, name) == getattr(jlimbs, name)


def test_gamma1_equals_jax():
    for ours, theirs in zip(tower.GAMMA1, jtower._GAMMA1_CONST):
        assert np.array_equal(_np(ours[0]), np.asarray(theirs[0]))
        assert np.array_equal(_np(ours[1]), np.asarray(theirs[1]))


_H2C_CONSTS = [
    ("SSWU_A", "_SSWU_A"),
    ("SSWU_B", "_SSWU_B"),
    ("SSWU_Z", "_SSWU_Z"),
    ("NEG_B_DIV_A", "_NEG_B_DIV_A"),
    ("B_DIV_ZA", "_B_DIV_ZA"),
    ("XNUM", "_XNUM"),
    ("XDEN", "_XDEN"),
    ("YNUM", "_YNUM"),
    ("YDEN", "_YDEN"),
    ("PSI_CX_M", "_PSI_CX"),
    ("PSI_CY_M", "_PSI_CY"),
]


@pytest.mark.parametrize("ours,theirs", _H2C_CONSTS)
def test_h2c_constants_equal_jax(ours, theirs):
    a = tower.leaves(getattr(h2c, ours))
    b = [np.asarray(x) for x in jax.tree.leaves(getattr(jh2c, theirs))]
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert np.array_equal(_np(x), y)


def test_x_bits_equal_jax():
    assert np.array_equal(pairing._X_BITS, jpairing._X_BITS)


def test_neg_g1_equals_jax():
    assert np.array_equal(_np(verify.NEG_G1_X), np.asarray(jverify._NEG_G1_X))
    assert np.array_equal(_np(verify.NEG_G1_Y), np.asarray(jverify._NEG_G1_Y))


@pytest.mark.parametrize("name", ["P", "R", "X", "ABS_X", "H_EFF_G1", "GAMMA1"])
def test_oracle_field_constants_equal_jax(name):
    assert getattr(orc_fields, name) == getattr(jorc_fields, name)


@pytest.mark.parametrize("name", ["G1_GEN", "G2_GEN", "PSI_CX", "PSI_CY", "B_G1", "B_G2"])
def test_oracle_curve_constants_equal_jax(name):
    assert getattr(orc_curve, name) == getattr(jorc_curve, name)


@pytest.mark.parametrize(
    "name", ["SSWU_A", "SSWU_B", "SSWU_Z", "XNUM", "XDEN", "YNUM", "YDEN", "CIPHERSUITE_DST"]
)
def test_oracle_h2c_tables_equal_jax(name):
    assert getattr(orc_h2c, name) == getattr(jorc_h2c, name)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hash_to_field_equals_jax(seed):
    rng = np.random.default_rng(seed)
    msg = rng.bytes(int(rng.integers(0, 100)))
    assert orc_h2c.expand_message_xmd(msg, b"DST", 96) == jorc_h2c.expand_message_xmd(
        msg, b"DST", 96
    )
    assert orc_h2c.hash_to_field_fp2(msg, 2) == jorc_h2c.hash_to_field_fp2(msg, 2)


def test_bucket_tables_equal_jax():
    assert buckets.BUCKETS == jbuckets.BUCKETS
    assert buckets.POOL_BUCKETS == jbuckets.POOL_BUCKETS


@pytest.mark.parametrize("cap", [None, 4, 8, 600, 2048])
def test_bucket_functions_equal_jax(cap):
    for n in [1, 3, 4, 5, 100, 128, 129, 511, 512, 513, 600, 1000, 1025, 2048, 2049, 5000]:
        if cap is None or n <= cap:
            assert buckets.pool_bucket(n, cap) == jbuckets.pool_bucket(n, cap), n
        assert buckets.bucket_size(n) == jbuckets.bucket_size(n)
        assert buckets.align_down(n) == jbuckets.align_down(n)


def test_convert_round_trip_and_range():
    a = _plain_limbs(EDGES)
    t = convert.limbs_from_jax(a, "cpu")
    assert t.dtype == torch.int32 and np.array_equal(convert.limbs_to_numpy(t), a)
    mask = np.array([True, False])
    assert convert.limbs_from_jax(mask, "cpu").dtype == torch.bool
    assert np.array_equal(convert.limbs_to_numpy(convert.limbs_from_jax(mask, "cpu")), mask)
    with pytest.raises(ValueError):
        convert.limbs_from_jax(np.array([1 << 31], dtype=np.uint32), "cpu")
    reject = jverify.EncodedJob("reject", 2, 0, None)
    job = convert.encoded_job_from_jax(reject, "cpu")
    assert (job.kind, job.n, job.bucket, job.args) == ("reject", 2, 0, None)


def _kernel_source():
    return open(os.path.join(os.path.dirname(fpk.__file__), "csrc", "fp_kernels.cu")).read()


def _source_ints(src, pattern):
    body = re.search(pattern, src).group(1)
    return [int(x) for x in body.replace("\n", " ").split(",")]


def test_kernel_source_constants():
    """The CUDA source embeds p and -p^-1 as literals in 26-bit digits;
    they must be the limb tables', the accumulator bounds it states must
    hold, and its five kernels (K1-K3, add and subtract) must share the
    one cooperative design."""
    src = _kernel_source()
    # one design: every kernel launches TPI lanes per element, and no
    # 13-bit per-thread code is left
    assert src.count("<<<coop_blocks_for(n), COOP_THREADS, 0,") == 5
    assert src.count("__global__") == 5
    assert "kP[NL]" not in src and "N0INV" not in src and "THREADS = 64" not in src
    # 15 digits of 26 bits (R = 2^390 unchanged) in 16 slots
    assert int(re.search(r"TPI = (\d+);", src).group(1)) in _TPIS
    assert int(re.search(r"SLOTS = (\d+);", src).group(1)) == _SLOTS
    assert int(re.search(r"ND = (\d+);", src).group(1)) == _ND
    assert int(re.search(r"DBITS = (\d+);", src).group(1)) == _DBITS
    assert _ND * _DBITS == limbs.R_EXP and _DBITS == 2 * limbs.LIMB_BITS
    assert _source_ints(src, r"kP26\[SLOTS\] = \{([^}]*)\}") == _P26.tolist()
    assert int(re.search(r"PINV26 = (\d+)u;", src).group(1)) == int(_PINV26)
    assert int(re.search(r"P0_26 = (\d+)u;", src).group(1)) == P % (1 << _DBITS)
    # lazy accumulators: 15 steps of digit products, plus a carry.  K1: a_i
    # b_k and m p_k; K2: two products and m p_k; K3: a canonical digit times
    # an uncarried one (at most 2^27 - 2) and m p_k
    step = {"K1": 2 * _DMASK**2, "K2": 3 * _DMASK**2, "K3": _DMASK * (2 * _DMASK) + _DMASK**2}
    for kernel, width in (("K1", 57), ("K2", 58), ("K3", 58)):
        bound = 15 * step[kernel] + 2**32
        assert bound < 2**width and (bound >> _DBITS) < 2**32
        terms = 15 * step[kernel] // _DMASK**2
        assert f"{kernel}: {terms} x (2^26-1)^2 + 2^32 = {bound:,} < 2^{width}" in src
    assert bound == _K3_BOUND
    # both factors of a K3 product uncarried: the carry would not fit 32 bits
    assert (15 * ((2 * _DMASK) ** 2 + _DMASK**2) + 2**32) >> _DBITS >= 2**32


# ---------------------------------------------------------------------------
# a numpy model of the cooperative K1-K3 (csrc/fp_kernels.cu): the same
# digits, slots, reduction order and lane-level carry chains, for any TPI
# the source's constant may take
# ---------------------------------------------------------------------------

_TPIS = (1, 2, 4, 8, 16)
_SLOTS, _ND, _DBITS = 16, 15, 26
_DMASK = (1 << _DBITS) - 1
_U26, _M26 = np.uint64(_DBITS), np.uint64(_DMASK)
_P26 = np.array([(P >> (_DBITS * j)) & _DMASK for j in range(_ND)] + [0], dtype=np.uint64)
_PINV26 = np.uint64((-pow(P, -1, 1 << _DBITS)) % (1 << _DBITS))
# K3's accumulator bound, as the source states it
_K3_BOUND = 45 * _DMASK**2 + 2**32


def _to_digits(x):
    """(n, 30) 13-bit limbs -> (n, 16) slots: digit j = limb 2j + 2^13 limb
    2j+1, slot 15 zero."""
    x = x.astype(np.uint64)
    d = x[:, 0::2] | (x[:, 1::2] << np.uint64(limbs.LIMB_BITS))
    return np.concatenate([d, np.zeros((x.shape[0], 1), np.uint64)], 1)


def _to_limbs(d):
    out = np.empty((d.shape[0], limbs.NLIMBS), np.uint64)
    out[:, 0::2] = d[:, :_ND] & np.uint64(limbs.MASK)
    out[:, 1::2] = d[:, :_ND] >> np.uint64(limbs.LIMB_BITS)
    return out


def _lane_carry(out0, out1):
    """The ballot chain across lanes: (n, TPI) carry-outs for a carry in of
    0 and 1 -> (carry into each lane, carry out of the group)."""
    tpi = out0.shape[1]
    w = np.uint64(1) << np.arange(tpi, dtype=np.uint64)
    G = (out0 * w).sum(1)
    Pm = ((out1 & ~out0 & np.uint64(1)) * w).sum(1)
    S = Pm + (G << np.uint64(1))
    return ((S ^ Pm)[:, None] >> np.arange(tpi, dtype=np.uint64)) & np.uint64(1), (
        S >> np.uint64(tpi)
    ) & np.uint64(1)


def _add_digits(w, c):
    """Each lane's D digits (n, TPI, D) plus a carry in: canonical digits,
    carry out."""
    d = np.empty_like(w)
    for r in range(w.shape[2]):
        t = w[:, :, r] + c
        d[:, :, r], c = t & _M26, t >> _U26
    return d, c


def _sub_digits(x, y, b):
    d = np.empty_like(x)
    for r in range(x.shape[2]):
        yb = y[:, :, r] + b
        d[:, :, r], b = (x[:, :, r] - yb) & _M26, (x[:, :, r] < yb).astype(np.uint64)
    return d, b


def _sub_group(x, y):
    """x - y over (n, TPI, D) slots, borrows across lanes by the ballot
    chain; returns the digits and the borrow out of slot 15."""
    zero = np.zeros(x.shape[:2], np.uint64)
    _, b0 = _sub_digits(x, y, zero)
    _, b1 = _sub_digits(x, y, zero + np.uint64(1))
    borrow, out = _lane_carry(b0, b1)
    return _sub_digits(x, y, borrow)[0], out


def _resolve_group(w, tpi, carry_out=0):
    """(n, 16) digits of at most 2^27 - 2 -> canonical digits, the carries
    run across lanes by the ballot chain (the source's ``resolve``), and
    the carry out of slot 15 dropped: it must be ``carry_out`` (0 where the
    value is below 2^390)."""
    assert (w <= 2 * _DMASK).all()
    w = w.reshape(-1, tpi, _SLOTS // tpi)
    zero = np.zeros(w.shape[:2], np.uint64)
    _, o0 = _add_digits(w, zero)
    _, o1 = _add_digits(w, zero + np.uint64(1))
    carry, out = _lane_carry(o0, o1)
    assert np.array_equal(out, np.broadcast_to(np.uint64(carry_out), out.shape))
    return _add_digits(w, carry)[0].reshape(-1, _SLOTS)


def _redc_step(u, pk, i):
    u0 = u[:, i : i + 1]
    m = ((u0 & np.uint64(0xFFFFFFFF)) * _PINV26) & _M26
    u = u + m * pk
    carry = (u0 + m * _P26[0]) >> _U26
    assert not (u[:, i] & _M26).any()
    u[:, i] = 0
    u[:, i + 1] += carry[:, 0]
    return u


def _finish(u, tpi, width):
    """Lazy slots (logical digit k in slot k - 1) -> canonical digits mod p."""
    assert (u < 2 ** width).all()
    u = np.roll(u, 1, axis=1)  # ring_up: logical digit k to slot k
    assert not u[:, _ND].any()
    zero = np.zeros((u.shape[0], 1), np.uint64)
    v = (u & _M26) + np.concatenate([zero, u[:, :-1] >> _U26], 1)
    w = (v & _M26) + np.concatenate([zero, v[:, :-1] >> _U26], 1)
    assert (w <= _DMASK + 2 ** 7).all()
    return _resolve_mod_p(w, tpi)


def _resolve_mod_p(w, tpi):
    """(n, 16) digits of a value below 2p -> canonical digits mod p: the
    carries resolved, then one conditional subtract of p (the source's
    ``resolve_mod_p``)."""
    d = _resolve_group(w, tpi).reshape(-1, tpi, _SLOTS // tpi)
    diff, keep = _sub_group(d, _p_lanes(len(d), tpi))
    return np.where(keep[:, None, None] != 0, d, diff).reshape(-1, _SLOTS)


def _p_lanes(n, tpi):
    return np.broadcast_to(_P26.reshape(1, tpi, -1), (n, tpi, _SLOTS // tpi))


def model_mont_mul(a, b, tpi):
    x, y, pk = _to_digits(a), _to_digits(b), _P26[None]
    u = np.zeros_like(x)
    for i in range(_ND):
        u = u + x[:, i : i + 1] * y
        u = _redc_step(u, pk, i)
        y, pk = np.roll(y, 1, axis=1), np.roll(pk, 1, axis=1)  # ring_up
    return _to_limbs(_finish(u, tpi, 57))


def model_f2_mul(a, b, tpi):
    x0, x1, y0, y1 = (_to_digits(t) for t in (a[0], a[1], b[0], b[1]))
    p = _p_lanes(x0.shape[0], tpi)
    ny1, out = _sub_group(p, y1.reshape(p.shape))
    assert not out.any()
    ny1, pk = ny1.reshape(-1, _SLOTS), _P26[None]
    u, v = np.zeros_like(x0), np.zeros_like(x0)
    for i in range(_ND):
        u = u + x0[:, i : i + 1] * y0 + x1[:, i : i + 1] * ny1
        v = v + x0[:, i : i + 1] * y1 + x1[:, i : i + 1] * y0
        u, v = _redc_step(u, pk, i), _redc_step(v, pk, i)
        y0, y1, ny1, pk = (np.roll(t, 1, axis=1) for t in (y0, y1, ny1, pk))
    return _to_limbs(_finish(u, tpi, 58)), _to_limbs(_finish(v, tpi, 58))


def _f2_sqr_steps(x, y, x0, y1):
    """K3's loop: u = x y and v = x0 y1, each reduced once, with the
    broadcast factors x and x0 canonical and the rotated ones y and y1
    uncarried.  Asserts the source's K3 bound after every step."""
    pk = _P26[None]
    u, v = np.zeros_like(x), np.zeros_like(x)
    for i in range(_ND):
        u = u + x[:, i : i + 1] * y
        v = v + x0[:, i : i + 1] * y1
        u, v = _redc_step(u, pk, i), _redc_step(v, pk, i)
        assert (u < _K3_BOUND).all() and (v < _K3_BOUND).all()
        y, y1, pk = (np.roll(t, 1, axis=1) for t in (y, y1, pk))
    return u, v


def model_f2_sqr(a, tpi):
    x0, x1 = _to_digits(a[0]), _to_digits(a[1])
    s = _resolve_group(x0 + x1, tpi)  # a0 + a1 < 2p, canonical
    p = _p_lanes(x0.shape[0], tpi)
    ny1, out = _sub_group(p, x1.reshape(p.shape))
    assert not out.any()
    y0 = ny1.reshape(-1, _SLOTS) + x0  # a0 + (p - a1) < 2p, uncarried
    y1 = x1 << np.uint64(1)  # 2 a1 < 2p, uncarried
    assert (y0 <= 2 * _DMASK).all() and (y1 <= 2 * _DMASK).all()
    u, v = _f2_sqr_steps(s, y0, x0, y1)
    return _to_limbs(_finish(u, tpi, 58)), _to_limbs(_finish(v, tpi, 58))


def model_add_mod(a, b, tpi):
    """The source's add_mod_kernel: the digitwise sum, a + b < 2p, reduced
    as ``_finish`` reduces a product."""
    return _to_limbs(_resolve_mod_p(_to_digits(a) + _to_digits(b), tpi))


def model_sub_mod(a, b, tpi):
    """The source's sub_mod_kernel: one borrow chain; where it leaves slot
    15 (a < b), p added and resolved, the carry out of slot 15 dropped."""
    x = _to_digits(a).reshape(-1, tpi, _SLOTS // tpi)
    y = _to_digits(b).reshape(x.shape)
    d, borrow = _sub_group(x, y)
    # a < b: slot 15 holds 2^26 - 1, and the sum with p carries 2^416 out
    assert np.array_equal(d[:, -1, -1] == _DMASK, borrow != 0)
    r = _resolve_group((d + _p_lanes(len(d), tpi)).reshape(-1, _SLOTS), tpi, borrow)
    return _to_limbs(np.where(borrow[:, None] != 0, r, d.reshape(-1, _SLOTS)))


def _model_operands(seed, n=40):
    vals = [_rand_ints(seed + k, n) for k in range(4)]
    for i, x in enumerate(EDGES):
        for j, y in enumerate(EDGES):
            for k, v in enumerate((x, y, EDGES[(i + j) % 6], EDGES[(i + 2 * j) % 6])):
                vals[k].append(v)
    return [_plain_limbs(v) for v in vals]


@pytest.mark.parametrize("tpi", _TPIS)
def test_coop_model_mont_mul_equals_plain(tpi):
    a, b, _, _ = _model_operands(tpi)
    want = _np(fpk.mont_mul_plain(_t(a), _t(b)))
    assert np.array_equal(model_mont_mul(a, b, tpi), want)


@pytest.mark.parametrize("tpi", _TPIS)
def test_coop_model_f2_mul_equals_plain(tpi):
    a0, a1, b0, b1 = _model_operands(tpi + 10)
    w0, w1 = fpk.f2_mul_plain((_t(a0), _t(a1)), (_t(b0), _t(b1)))
    g0, g1 = model_f2_mul((a0, a1), (b0, b1), tpi)
    assert np.array_equal(g0, _np(w0)) and np.array_equal(g1, _np(w1))


@pytest.mark.parametrize("tpi", _TPIS)
def test_coop_model_f2_sqr_equals_plain(tpi):
    a0, a1, _, _ = _model_operands(tpi + 20)
    w0, w1 = fpk.f2_sqr_plain((_t(a0), _t(a1)))
    g0, g1 = model_f2_sqr((a0, a1), tpi)
    assert np.array_equal(g0, _np(w0)) and np.array_equal(g1, _np(w1))


@pytest.mark.parametrize("op", ["add_mod", "sub_mod"])
@pytest.mark.parametrize("tpi", _TPIS)
def test_coop_model_add_sub_equals_plain(op, tpi):
    a, b, _, _ = _model_operands(tpi + 30)
    a, b = np.concatenate([a, _plain_limbs(_SUM_IS_P[0])]), np.concatenate([b, _plain_limbs(_SUM_IS_P[1])])
    want = _np(getattr(fpk, f"{op}_plain")(_t(a), _t(b)))
    model = model_add_mod if op == "add_mod" else model_sub_mod
    assert np.array_equal(model(a, b, tpi), want)


def test_coop_model_f2_sqr_bound_holds_on_worst_digits():
    """K3's loop on the largest digits its factors can hold (all 2^26 - 1
    canonical, all 2^27 - 2 uncarried) and on p - 1, p - 2, (p - 1)/2."""
    top = np.zeros((1, _SLOTS), np.uint64)
    top[:, :_ND] = _DMASK
    edge = _to_digits(_plain_limbs([P - 1, P - 2, (P - 1) // 2]))
    x = np.concatenate([top, edge])
    u, v = _f2_sqr_steps(x, 2 * x, x, 2 * x)
    assert u.max() > _K3_BOUND // 2 and ((np.maximum(u, v) >> _U26) < 2**32).all()


def test_coop_model_digit_conversion_round_trip():
    x = _plain_limbs(_rand_ints(31, 16) + EDGES)
    d = _to_digits(x)
    assert (d[:, :_ND] <= _DMASK).all() and not d[:, _ND].any()
    assert [sum(int(v) << (_DBITS * j) for j, v in enumerate(r)) for r in d] == [
        jlimbs.limbs_to_int(r) for r in x
    ]
    assert np.array_equal(_to_limbs(d), x)


# ---------------------------------------------------------------------------
# fp ops against the JAX fp ops
# ---------------------------------------------------------------------------


def _pair_inputs(seed, n=24):
    xs = _rand_ints(seed, n) + EDGES
    ys = _rand_ints(seed + 100, n) + list(reversed(EDGES))
    return _mont_limbs(xs), _mont_limbs(ys)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("op", ["add", "sub", "mont_mul"])
def test_binary_op_equals_jax(op, seed):
    a, b = _pair_inputs(seed)
    want = np.asarray(getattr(jfp, op)(a, b))
    got = _np(getattr(fp, op)(_t(a), _t(b)))
    assert np.array_equal(got, want)


# pairs whose sum is exactly p (and p + 1, p - 1), as (a values, b values)
_SUM_IS_P = ([1, P // 2, (P + 1) // 2, P - 1, 2, P - 2], [P - 1, (P + 1) // 2, P // 2, 1, P - 1, 1])


def _add_sub_edges():
    """Plain limbs: every pairing of the edges (a < b, a == b, a > b, 0, 1,
    p - 1), and pairs whose sum is p, p + 1 or p - 1."""
    a = [x for x in EDGES for _ in EDGES] + _SUM_IS_P[0]
    b = [y for _ in EDGES for y in EDGES] + _SUM_IS_P[1]
    return a, b


@pytest.mark.parametrize("op", ["add", "sub"])
def test_add_sub_plain_edges_equal_jax_and_ints(op):
    a, b = _add_sub_edges()
    la, lb = _plain_limbs(a), _plain_limbs(b)
    got = _np(getattr(fpk, f"{op}_mod_plain")(_t(la), _t(lb)))
    assert np.array_equal(got, np.asarray(getattr(jfp, op)(la, lb)))
    ref = (lambda x, y: (x + y) % P) if op == "add" else (lambda x, y: (x - y) % P)
    assert [jlimbs.limbs_to_int(r) for r in got] == [ref(x, y) for x, y in zip(a, b)]
    # the wrapper takes CPU tensors to the plain version
    assert np.array_equal(_np(getattr(fpk, f"{op}_mod")(_t(la), _t(lb))), got)


@pytest.mark.parametrize("op", ["add", "sub"])
@pytest.mark.parametrize("const_first", [False, True])
def test_add_sub_broadcast_against_a_constant(op, const_first):
    """A (30,) constant (p - 1, then 0) against a (2, 7, 30) operand, either
    side, through the wrapper and the plain version."""
    x = _plain_limbs(_rand_ints(41, 12) + EDGES[:2]).reshape(2, 7, limbs.NLIMBS)
    for c in (P - 1, 0):
        k = jlimbs.int_to_limbs(c)
        args = (k, x) if const_first else (x, k)
        want = np.asarray(getattr(jfp, op)(*args))
        for fn in (getattr(fpk, f"{op}_mod"), getattr(fpk, f"{op}_mod_plain")):
            got = fn(*(_t(t) for t in args))
            assert got.shape == (2, 7, limbs.NLIMBS) and got.dtype == torch.int32
            assert np.array_equal(_np(got), want)


@pytest.mark.parametrize("op", ["add_mod", "sub_mod", "mont_mul"])
def test_binary_wrapper_launches_its_kernel_off_the_cpu(op, monkeypatch):
    """Off the CPU the wrapper hands broadcast operands of one shape to its
    own launcher and returns what the launch made (``meta`` tensors stand
    in for CUDA ones: no kernel runs)."""
    calls = []

    def launch(name, fn, n_out, *xs):
        calls.append((name, fn, n_out, [tuple(x.shape) for x in xs]))
        return [torch.empty(xs[0].shape, dtype=torch.int32, device=xs[0].device)]

    monkeypatch.setattr(fpk, "_launch", launch)
    a = torch.empty((4, 3, limbs.NLIMBS), dtype=torch.int32, device="meta")
    b = torch.empty((limbs.NLIMBS,), dtype=torch.int32, device="meta")
    out = getattr(fpk, op)(a, b)
    assert out.shape == (4, 3, limbs.NLIMBS)
    assert calls == [(op, f"lodestar_fp_{op}", 1, [(4, 3, limbs.NLIMBS)] * 2)]


@pytest.mark.parametrize("op", ["neg", "to_mont", "from_mont", "mont_sqr", "dbl"])
def test_unary_op_equals_jax(op):
    a, _ = _pair_inputs(7)
    if op == "to_mont":
        a = _plain_limbs(_rand_ints(8, 24) + EDGES)
    want = np.asarray(getattr(jfp, op)(a))
    got = _np(getattr(fp, op)(_t(a)))
    assert np.array_equal(got, want)


def test_inv_equals_jax():
    a, _ = _pair_inputs(9, n=6)
    want = np.asarray(jfp.inv(a))
    got = _np(fp.inv(_t(a)))
    assert np.array_equal(got, want)
    assert not got[6].any()  # row 6 is the edge value 0: inv(0) = 0


@pytest.mark.parametrize("e", [0, 1, 5, 15, 16, 0x1234567, P - 2])
def test_pow_fixed_matches_int_pow(e):
    vals = _rand_ints(11, 3) + [1, 2]
    got = fp.mont_pow_fixed(_t(_mont_limbs(vals)), e)
    assert [fp.decode(got[i]) for i in range(len(vals))] == [pow(v, e, P) for v in vals]


def test_select_eq_is_zero():
    a, b = _pair_inputs(12, n=4)
    ta, tb = _t(a), _t(b)
    cond = torch.tensor([True, False] * 5)
    assert np.array_equal(_np(fp.select(cond, ta, tb)), np.asarray(jfp.select(np.asarray(cond), a, b)))
    assert fp.eq(ta, ta).all() and not fp.eq(ta, tb).any()
    assert fp.is_zero(_t(_mont_limbs([0, 5]))).tolist() == [True, False]


@pytest.mark.parametrize("v", EDGES + [0x1234, P // 3])
def test_encode_decode_equal_jax(v):
    assert np.array_equal(fp.encode_int(v), jfp.encode_int(v))
    assert fp.decode(torch.from_numpy(fp.encode_int(v).astype(np.int32))) == v


# ---------------------------------------------------------------------------
# the plain version of K1 against the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------


def test_mont_mul_plain_equals_pallas_and_parallel():
    a = _plain_limbs(_rand_ints(21, 40))
    b = _plain_limbs(_rand_ints(22, 40))
    want = np.asarray(pallas_fp.mont_mul(a, b, interpret=True))
    assert np.array_equal(want, np.asarray(jfp.mont_mul_parallel(a, b)))
    assert np.array_equal(_np(fpk.mont_mul_plain(_t(a), _t(b))), want)


def test_mont_mul_plain_edge_values():
    a = _plain_limbs(EDGES * 6)
    b = _plain_limbs([y for y in EDGES for _ in EDGES])
    want = np.asarray(pallas_fp.mont_mul(a, b, interpret=True))
    assert np.array_equal(_np(fpk.mont_mul_plain(_t(a), _t(b))), want)


def test_mont_mul_plain_broadcast_and_leading_axes():
    a = _plain_limbs(_rand_ints(23, 12)).reshape(3, 4, limbs.NLIMBS)
    b = _plain_limbs(_rand_ints(24, 4)).reshape(1, 4, limbs.NLIMBS)
    want = np.asarray(pallas_fp.mont_mul(a, b, interpret=True))
    got = fpk.mont_mul_plain(_t(a), _t(b))
    assert got.shape == (3, 4, limbs.NLIMBS) and got.dtype == torch.int32
    assert np.array_equal(_np(got), want)
    # the wrapper takes CPU tensors to the plain version, with its shapes
    assert np.array_equal(_np(fpk.mont_mul(_t(a), _t(b))), want)
