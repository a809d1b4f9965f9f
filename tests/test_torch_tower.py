"""The PyTorch port's Fp2/Fp6/Fp12 tower against the JAX package.

The plain versions of kernels K2/K3 are held against the Pallas kernels in
interpret mode and the JAX tower; the wider tower ops against the JAX
package's pure-Python oracle (the JAX tower compiles them slowly on CPU).
Exact throughout.
"""
import numpy as np
import pytest
import torch

from lodestar_tpu.crypto.bls import fields as orc
from lodestar_tpu.ops.bls12_381 import fp as jfp
from lodestar_tpu.ops.bls12_381 import pallas_fp
from lodestar_tpu.ops.bls12_381 import tower as jtower
from lodestar_tpu_torch import convert
from lodestar_tpu_torch.ops.bls12_381 import fp_kernels as fpk, tower as tw

torch.set_num_threads(1)

P = orc.P
EDGES = [0, 1, 2, P - 1, P - 2, (P - 1) // 2]
B = 3


def _ints(rng, n):
    return [int.from_bytes(rng.bytes(48), "big") % P for _ in range(n)]


def _f2_batch(seed, n=16):
    """Two (n + 6, 30) Montgomery limb arrays: seeded values, then edges."""
    rng = np.random.default_rng(seed)
    return tuple(
        np.stack([jfp.encode_int(v) for v in _ints(rng, n) + EDGES[k:] + EDGES[:k]])
        for k in range(2)
    )


def _t(tree):
    return convert.tree_from_jax(tree, "cpu")


def _np(tree):
    return convert.tree_to_numpy(tree)


def _eq(got, want):
    got, want = tw.leaves(_np(got)), [np.asarray(w) for w in tw.leaves(want)]
    return len(got) == len(want) and all(np.array_equal(g, w) for g, w in zip(got, want))


# ---------------------------------------------------------------------------
# K2 / K3 plain versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [1, 2])
def test_f2_mul_plain_equals_pallas_and_tower(seed):
    a, b = _f2_batch(seed), _f2_batch(seed + 10)
    want = pallas_fp.f2_mul(a, b, interpret=True)
    assert _eq(_t(want), jtower.f2_mul(a, b))
    assert _eq(fpk.f2_mul_plain(_t(a), _t(b)), want)
    assert _eq(tw.f2_mul(_t(a), _t(b)), want)


@pytest.mark.parametrize("seed", [3, 4])
def test_f2_sqr_plain_equals_pallas_and_tower(seed):
    a = _f2_batch(seed)
    want = pallas_fp.f2_sqr(a, interpret=True)
    assert _eq(_t(want), jtower.f2_sqr(a))
    assert _eq(fpk.f2_sqr_plain(_t(a)), want)
    assert _eq(tw.f2_sqr(_t(a)), want)


def test_f2_plain_broadcast_and_leading_axes():
    a = tuple(x[:12].reshape(3, 4, 30) for x in _f2_batch(5))
    b = tuple(x[:4].reshape(1, 4, 30) for x in _f2_batch(6))
    want = pallas_fp.f2_mul(a, b, interpret=True)
    got = fpk.f2_mul_plain(_t(a), _t(b))
    assert got[0].shape == (3, 4, 30) and _eq(got, want)


# ---------------------------------------------------------------------------
# tower ops against the oracle
# ---------------------------------------------------------------------------


def _rand_f2(rng):
    return tuple(_ints(rng, 2))


def _rand_f6(rng):
    return tuple(_rand_f2(rng) for _ in range(3))


def _rand_f12(rng):
    return (_rand_f6(rng), _rand_f6(rng))


def _enc(elems, encode):
    """B oracle elements -> one port tree batched on axis 0."""
    trees = [_t(encode(e)) for e in elems]
    return tw.tree_map(lambda *xs: torch.stack(xs), *trees)


def _dec(tree, decode, n):
    return [decode(tw.tree_map(lambda t, i=i: t[i], tree)) for i in range(n)]


def _f12s(seed):
    rng = np.random.default_rng(seed)
    return [_rand_f12(rng) for _ in range(B)]


_F12_BINARY = [("f12_mul", orc.f12_mul), ("f12_add", orc.f12_add), ("f12_sub", orc.f12_sub)]


@pytest.mark.parametrize("name,ref", _F12_BINARY)
def test_f12_binary_equals_oracle(name, ref):
    xs, ys = _f12s(31), _f12s(32)
    got = getattr(tw, name)(_enc(xs, jtower.encode_fp12), _enc(ys, jtower.encode_fp12))
    assert _dec(got, tw.decode_fp12, B) == [ref(x, y) for x, y in zip(xs, ys)]


_F12_UNARY = [
    ("f12_sqr", orc.f12_sqr),
    ("f12_inv", orc.f12_inv),
    ("f12_conj", orc.f12_conj),
    ("frob1", lambda a: orc.f12_frobenius(a, 1)),
    ("frob2", lambda a: orc.f12_frobenius(a, 2)),
]


@pytest.mark.parametrize("name,ref", _F12_UNARY)
def test_f12_unary_equals_oracle(name, ref):
    xs = _f12s(33)
    fn = {
        "frob1": lambda a: tw.f12_frobenius(a, 1),
        "frob2": lambda a: tw.f12_frobenius(a, 2),
    }.get(name) or getattr(tw, name)
    got = fn(_enc(xs, jtower.encode_fp12))
    assert _dec(got, tw.decode_fp12, B) == [ref(x) for x in xs]


@pytest.mark.parametrize("name,ref", [("f6_mul", orc.f6_mul), ("f6_add", orc.f6_add)])
def test_f6_binary_equals_oracle(name, ref):
    rng = np.random.default_rng(34)
    xs = [_rand_f6(rng) for _ in range(B)]
    ys = [_rand_f6(rng) for _ in range(B)]
    got = getattr(tw, name)(_enc(xs, jtower.encode_fp6), _enc(ys, jtower.encode_fp6))
    assert _dec(got, tw.decode_fp6, B) == [ref(x, y) for x, y in zip(xs, ys)]


def test_f6_inv_and_mul_by_v_equal_oracle():
    rng = np.random.default_rng(35)
    xs = [_rand_f6(rng) for _ in range(B)]
    t = _enc(xs, jtower.encode_fp6)
    assert _dec(tw.f6_inv(t), tw.decode_fp6, B) == [orc.f6_inv(x) for x in xs]
    assert _dec(tw.f6_mul_by_v(t), tw.decode_fp6, B) == [orc.f6_mul_by_v(x) for x in xs]


_F2_UNARY = [
    ("f2_inv", orc.f2_inv),
    ("f2_neg", orc.f2_neg),
    ("f2_conj", orc.f2_conj),
    ("f2_mul_by_xi", orc.f2_mul_by_xi),
    ("f2_dbl", lambda a: orc.f2_add(a, a)),
]


@pytest.mark.parametrize("name,ref", _F2_UNARY)
def test_f2_unary_equals_oracle(name, ref):
    rng = np.random.default_rng(36)
    xs = [_rand_f2(rng) for _ in range(B)] + [(1, 0)]
    got = getattr(tw, name)(_enc(xs, jtower.encode_fp2))
    assert _dec(got, tw.decode_fp2, len(xs)) == [ref(x) for x in xs]


def test_f2_mul_fp_equals_oracle():
    rng = np.random.default_rng(37)
    xs = [_rand_f2(rng) for _ in range(B)]
    ks = _ints(rng, B)
    k = torch.from_numpy(np.stack([jfp.encode_int(v) for v in ks]).astype(np.int32))
    got = tw.f2_mul_fp(_enc(xs, jtower.encode_fp2), k)
    assert _dec(got, tw.decode_fp2, B) == [orc.f2_mul_scalar(x, v) for x, v in zip(xs, ks)]


def test_f12_is_one_and_select():
    xs = _f12s(38)
    xs[1] = orc.F12_ONE
    t = _enc(xs, jtower.encode_fp12)
    assert tw.f12_is_one(t).tolist() == [False, True, False]
    cond = torch.tensor([True, False, True])
    ones = tw.f12_one((B,))
    got = _dec(tw.f12_select(cond, ones, t), tw.decode_fp12, B)
    assert got == [orc.F12_ONE, xs[1], orc.F12_ONE]


def test_f12_mul_is_one_stacked_kernel_call(monkeypatch):
    """An f12_mul makes ONE K2 call of 18 Fp2 products per batch element."""
    calls = []
    real = fpk.f2_mul

    def spy(a, b):
        calls.append(torch.broadcast_shapes(a[0].shape, b[0].shape))
        return real(a, b)

    monkeypatch.setattr(fpk, "f2_mul", spy)
    xs, ys = _f12s(39), _f12s(40)
    tw.f12_mul(_enc(xs, jtower.encode_fp12), _enc(ys, jtower.encode_fp12))
    assert len(calls) == 1
    assert int(np.prod(calls[0][:-1])) == 18 * B


def test_f12_add_sub_are_one_wrapper_call_each(monkeypatch):
    """A ``t_add`` and a ``t_sub`` of two Fp12 operands each call the
    ``fp_kernels.add_mod``/``sub_mod`` wrapper once (one launch on the
    card), and G1's field table is bound to those wrappers."""
    from lodestar_tpu_torch.ops.bls12_381 import curve, fp

    assert fp.add is fpk.add_mod and fp.sub is fpk.sub_mod
    assert curve.F1.add is fpk.add_mod and curve.F1.sub is fpk.sub_mod
    assert curve.F2.add is tw.t_add and curve.F2.sub is tw.t_sub
    calls = []
    for name in ("add_mod_plain", "sub_mod_plain"):
        real = getattr(fpk, name)

        def spy(a, b, name=name, real=real):
            calls.append((name, tuple(a.shape)))
            return real(a, b)

        monkeypatch.setattr(fpk, name, spy)
    xs, ys = _f12s(41), _f12s(42)
    a, b = _enc(xs, jtower.encode_fp12), _enc(ys, jtower.encode_fp12)
    total = tw.t_add(a, b)
    assert calls == [("add_mod_plain", (12, B, 30))]
    diff = tw.t_sub(total, b)
    assert calls[1:] == [("sub_mod_plain", (12, B, 30))]
    assert _dec(diff, tw.decode_fp12, B) == xs
