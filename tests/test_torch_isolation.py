"""The PyTorch port stands alone and never falls back quietly.

* No module of ``lodestar_tpu_torch``, not ``chip_smoke.py`` and not
  ``chip_ab.py`` imports JAX or anything of the JAX package: checked
  statically per file, and by importing every module in a subprocess where
  those imports fail.
* An entry point called with ``device=None`` means the CUDA card; where
  none is available it raises instead of running on the CPU.
* A kernel wrapper given a tensor that is not on the CPU launches its
  kernel or raises: with no kernel library it raises and counts nothing.
"""
import ast
import importlib.util
import json
import os
import subprocess
import sys

import pytest
import torch

import lodestar_tpu_torch
from lodestar_tpu_torch import convert
from lodestar_tpu_torch.chain.bls.verifier import TorchBlsVerifier
from lodestar_tpu_torch.crypto.bls import api
from lodestar_tpu_torch.ops.bls12_381 import _build, curve as cv, fp_kernels as fpk
from lodestar_tpu_torch.ops.bls12_381 import h2c, verify as dv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(lodestar_tpu_torch.__file__)))
PKG = os.path.join(REPO, "lodestar_tpu_torch")
_FORBIDDEN = ("jax", "jaxlib", "lodestar_tpu")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py"), os.path.join(REPO, "chip_ab.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(os.path.relpath(p, REPO) for p in out)


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in _FORBIDDEN)


@pytest.mark.parametrize("path", _port_files())
def test_no_jax_imports_in_source(path):
    tree = ast.parse(open(os.path.join(REPO, path)).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


_BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if any(name == f or name.startswith(f + ".") for f in ("jax", "jaxlib", "lodestar_tpu")):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
for name in ("jax", "jaxlib", "lodestar_tpu"):
    sys.modules.pop(name, None)
import lodestar_tpu_torch
names = ["chip_smoke", "chip_ab"] + [m.name for m in pkgutil.walk_packages(
    lodestar_tpu_torch.__path__, "lodestar_tpu_torch.")]
for name in names:
    importlib.import_module(name)
loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "lodestar_tpu")]
assert not loaded, loaded
print(len(names))
"""


def test_every_module_imports_with_jax_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT],
        cwd=REPO,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 15


# ---------------------------------------------------------------------------
# device=None means the card
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def one_set():
    sk = api.SecretKey(0x1234567)
    msg = b"\x07" * 32
    return [api.SignatureSet(sk.to_public_key(), msg, sk.sign(msg))]


_ENTRY_POINTS = {
    "encode_job": lambda sets: dv.encode_job(sets),
    "verify_signature_sets_device": lambda sets: dv.verify_signature_sets_device(sets),
    "TorchBlsVerifier": lambda sets: TorchBlsVerifier(),
    "encode_g1_affine": lambda sets: cv.encode_g1_affine([sets[0].public_key.point]),
    "encode_g2_affine": lambda sets: cv.encode_g2_affine([sets[0].signature.point]),
    "scalars_to_bits": lambda sets: cv.scalars_to_bits([3]),
    "encode_field_draws": lambda sets: h2c.encode_field_draws([sets[0].message], 4),
    "limbs_from_jax": lambda sets: convert.limbs_from_jax([[1] * 30]),
}


@pytest.mark.parametrize("name", sorted(_ENTRY_POINTS))
def test_device_none_without_a_card_raises(one_set, name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _ENTRY_POINTS[name](one_set)


# ---------------------------------------------------------------------------
# kernel wrappers: the kernel or an exception, never the plain version
# ---------------------------------------------------------------------------


def _limbs(device, dtype=torch.int32, n=4, width=30):
    return torch.zeros(n, width, dtype=dtype, device=device)


_WRAPPERS = {
    "mont_mul": lambda d: fpk.mont_mul(_limbs(d), _limbs(d)),
    "f2_mul": lambda d: fpk.f2_mul((_limbs(d), _limbs(d)), (_limbs(d), _limbs(d))),
    "f2_sqr": lambda d: fpk.f2_sqr((_limbs(d), _limbs(d))),
}


def _no_toolkit():
    raise RuntimeError("nvcc not found")


@pytest.mark.parametrize("name", sorted(_WRAPPERS))
def test_non_cpu_tensor_without_library_raises(name, tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "_nvcc", _no_toolkit)
    before = dict(fpk.LAUNCHES)
    with pytest.raises(RuntimeError, match="nvcc"):
        _WRAPPERS[name](torch.device("meta"))
    assert fpk.LAUNCHES == before
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("name", sorted(_WRAPPERS))
def test_cpu_tensor_takes_plain_version_without_library(name, monkeypatch):
    def absent():
        raise AssertionError("a CPU tensor must not reach the kernel library")

    monkeypatch.setattr(_build, "library", absent)
    before = dict(fpk.LAUNCHES)
    out = _WRAPPERS[name](torch.device("cpu"))
    assert all(not t.any() for t in (out if isinstance(out, tuple) else (out,)))
    assert fpk.LAUNCHES == before


@pytest.mark.parametrize(
    "args,exc",
    [
        ((_limbs("cpu", torch.int64), _limbs("cpu")), TypeError),
        ((_limbs("cpu", width=29), _limbs("cpu", width=29)), ValueError),
        ((_limbs("cpu"), _limbs("meta")), ValueError),
    ],
)
def test_wrapper_checks_operands(args, exc):
    with pytest.raises(exc):
        fpk.mont_mul(*args)


# ---------------------------------------------------------------------------
# the chip scripts' bookkeeping: the kernels' bound and chip_ab.py's sides
# ---------------------------------------------------------------------------


def _script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_bound_counts_the_least_work():
    from lodestar_tpu_torch.crypto.bls.fields import P

    smoke = _script("chip_smoke")
    words = -(-P.bit_length() // 32)
    assert words == 12 and 390 - 32 * words == 6
    assert smoke.MULS_PER_PRODUCT == 2 * words * words
    assert smoke.MULS_PER_REDUCTION == words + 2 * words * words + 1 + 2 * words
    for name, (products, reductions, *_rest) in smoke.KERNELS.items():
        muls = products * smoke.MULS_PER_PRODUCT + reductions * smoke.MULS_PER_REDUCTION
        assert muls < products * smoke.MADDS_13BIT_YARDSTICK
        for n in (1, 512, 9234):
            us, by = smoke.bound_us(name, n)
            assert us <= smoke.yardstick_13bit_us(name, n)
            assert by == "bytes"


def test_chip_ab_sides_differ_only_in_the_kernel_source(tmp_path):
    ab = _script("chip_ab")
    ab_dir = tmp_path / "ab"
    assert ab.prepare(["a=tree", "b=tpi:4"], ab_dir=str(ab_dir)) == ["a", "b"]
    assert json.loads((ab_dir / "sides.json").read_text())["order"] == ["a", "b"]
    src = {s: (ab_dir / s / ab.KERNEL_SOURCE).read_text().splitlines() for s in "ab"}
    diff = [(x, y) for x, y in zip(src["a"], src["b"]) if x != y]
    assert len(src["a"]) == len(src["b"]) and len(diff) == 1
    assert "TPI = 8;" in diff[0][0] and "TPI = 4;" in diff[0][1]
    for side in "ab":
        assert (ab_dir / side / "chip_smoke.py").exists()
        assert not (ab_dir / side / "lodestar_tpu_torch" / "_build").exists()
    with pytest.raises(ValueError):
        ab.prepare(["c=tpi:x"], ab_dir=str(ab_dir))
    with pytest.raises(ValueError):
        ab.prepare(["tree"], ab_dir=str(ab_dir))


def test_chip_ab_reads_and_summarizes_chip_smoke_output():
    ab = _script("chip_ab")

    def output(us, busy, build):
        shapes = [{"n": n, "launches": 3, "device_us": us + n, "bound_us": 0.1}
                  for n in (1, 512)]
        lines = ["[build] ptxas info    : Compiling entry function "
                 "'_ZN4_GLOBAL__15mont_mul_kernelEPKiS1_Pil' for 'sm_90a'",
                 "[build] ptxas info    : Used 28 registers, used 0 barriers"] if build else []
        main = {"main_path": [{"median_s": 4.0, "profile": {
            "device_busy_s": busy, "hand_written": {"mont_mul": {"ms": 7.0}}}}],
            "launch_floor_us": 2.0, "card": "NVIDIA H100 80GB HBM3, 700.00 W"}
        return "\n".join(lines + [json.dumps(main),
                                  json.dumps({"kernels": [{"name": "mont_mul", "shapes": shapes}]}),
                                  '{"ok": true}'])

    runs = [("x", ab.read_run(output(3.0, 0.7, True))), ("y", ab.read_run(output(5.0, 0.8, True))),
            ("y", ab.read_run(output(5.5, 0.8, False))), ("x", ab.read_run(output(3.5, 0.7, False)))]
    summary = ab.summarize(["x", "y"], runs)
    assert summary["kernels"]["mont_mul"]["512"]["x"] == [515.0, 515.5]
    assert summary["kernels"]["mont_mul"]["1"]["y"] == [6.0, 6.5]
    assert summary["sides"]["x"]["registers"] == {"mont_mul": 28}
    assert summary["sides"]["y"]["card_busy_s"] == [0.8, 0.8]
    assert summary["card"] == ["NVIDIA H100 80GB HBM3, 700.00 W"]
    with pytest.raises(ValueError):
        ab.read_run("no result")
