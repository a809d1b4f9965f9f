"""Nothing the benchmark runs imports JAX or the JAX package, and its
generator and reference import nothing of the program either.  Top-level
module names are compared whole: ``lodestar_tpu_torch`` is not
``lodestar_tpu``."""
import ast
import json
import os
import shutil
import subprocess
import sys

from portbench import manifest, run

BENCH = os.path.join(manifest.ROOT, "portbench")
JAX_SIDE = {"jax", "jaxlib", "flax", "lodestar_tpu"}
PROGRAM = {"lodestar_tpu_torch", "torch"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def _sources(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in _sources(BENCH):
        assert not JAX_SIDE.intersection(_imports(path)), path


def test_the_generator_and_the_reference_import_nothing_of_the_program():
    pure = [os.path.join(BENCH, f) for f in ("gen.py", "check.py")] + list(_sources(os.path.join(BENCH, "ref")))
    for path in pure:
        assert not PROGRAM.intersection(_imports(path)), path


def _loaded_after(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=manifest.ROOT, capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_loading_the_harness_and_every_reader_loads_no_jax():
    tops = _loaded_after("from portbench import manifest, run, sweep, readings, spans\n"
                         "[manifest.load_cell(w['name']) for w in manifest.load_manifest()['workloads']]\n"
                         "from lodestar_tpu_torch.chain.bls import device_pool\n"
                         "from lodestar_tpu_torch.ops.bls12_381 import verify")
    assert "lodestar_tpu_torch" in tops and not JAX_SIDE.intersection(tops)
    worker = _loaded_after("import portbench.gen, portbench.check, portbench.ref.api")
    assert not (JAX_SIDE | PROGRAM).intersection(worker)


def test_the_run_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "lodestar_tpu_torch_probe", object())
    assert run.forbidden_modules() == sorted(JAX_SIDE.intersection({m.split(".")[0] for m in sys.modules}))
    monkeypatch.setitem(sys.modules, "lodestar_tpu", object())
    assert "lodestar_tpu" in run.forbidden_modules()


def _bench(cwd):
    return subprocess.run([sys.executable, "-m", "portbench", "--workload", "gossip-300k.slots",
                           "--seed", str(2**40 + 3), "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_without_a_card_it_fails_and_prints_no_result():
    done = _bench(manifest.ROOT)
    assert done.returncode != 0 and done.stdout.strip() == ""


def test_without_the_program_it_fails_and_prints_no_result(tmp_path):
    shutil.copy(os.path.join(manifest.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    done = _bench(str(tmp_path))
    assert done.returncode != 0 and done.stdout.strip() == ""
