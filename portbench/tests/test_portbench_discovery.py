"""Cells, configurations, mixes and metrics are found by name from files:
a throw-away one is added with no edit to any harness file."""
import json
import os
import re

from portbench import gen, manifest
from portbench.metrics._layers import TraceContext

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_a_throwaway_cell_is_found_from_files_alone(tmp_path):
    bench = tmp_path / "bench"
    for d in ("configs", "traffic", "metrics"):
        (bench / d).mkdir(parents=True)
    with open(os.path.join(manifest.ROOT, "portbench/configs/gossip-300k.json")) as f:
        config = json.load(f)
    config["validators"] = 1_000_000
    (bench / "configs" / "gossip-1m.json").write_text(json.dumps(config))
    with open(os.path.join(manifest.ROOT, "portbench/traffic/slots.json")) as f:
        mix = json.load(f)
    mix["scale"] = 0.25
    (bench / "traffic" / "quarter.json").write_text(json.dumps(mix))
    (bench / "metrics" / "toy.answer.py").write_text("def read(ctx):\n    return 42.0 + ctx.window_s\n")
    (bench / "metrics" / "toy.shared.py").write_text("def read(ctx):\n    return 2.0 * ctx.window_s\n")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({
        "paths": ["bench"],
        "configs": [{"name": "gossip-1m", "file": "bench/configs/gossip-1m.json"}],
        "workloads": [{"name": "gossip-1m.quarter", "config": "gossip-1m", "traffic": "quarter", "chips": 1}],
        "end_to_end": [{"name": "p95_latency_ms", "unit": "ms"}, {"name": "setup_s", "unit": "s"}],
        "per_layer": [{"name": "toy.answer", "unit": "1", "moves": "p95_latency_ms"},
                      {"name": "toy.shared.quarter", "unit": "1", "moves": "p95_latency_ms"}],
    }))
    cell = manifest.load_cell("gossip-1m.quarter", root=str(tmp_path))
    assert cell.config["validators"] == 1_000_000 and cell.traffic["scale"] == 0.25
    assert [m["name"] for m in cell.end_to_end] == ["p95_latency_ms", "setup_s"]
    assert cell.readers["toy.answer"](TraceContext(1.0)) == 43.0
    # a metric with no file of its own is read by its name without the tag
    assert cell.readers["toy.shared.quarter"](TraceContext(1.0)) == 2.0
    plan = gen.make_plan(cell.config, cell.traffic, 7, 12)
    assert gen.kind_counts(cell.config, 0.25)["attestation"] == 7812
    assert sum(1 for r in plan.requests if r.kind == "attestation" and not r.tail) == 7812


def test_the_manifest_keeps_the_contracts_shape():
    m = manifest.load_manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert m["command"][:3] == ["python3", "-m", "portbench"] and m["paths"] == ["portbench"]
    names = set()
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("portbench/") and os.path.exists(os.path.join(manifest.ROOT, c["file"]))
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200 and NAME.match(w["name"]) and NAME.match(w["traffic"])
    for metric in m["end_to_end"] + m["per_layer"]:
        assert NAME.match(metric["name"]) and UNIT.match(metric["unit"]) and metric["name"] not in names
        names.add(metric["name"])
        assert metric["better"] in ("lower", "higher")
    for metric in m["end_to_end"]:
        assert 0.01 <= metric["bound"] <= 0.25 and metric["source"] in ("host_clock", "device_trace")
    e2e = {x["name"] for x in m["end_to_end"]}
    for metric in m["per_layer"]:
        assert metric["moves"] in e2e and metric["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
    assert len(json.dumps(m)) < 64 * 1024
    for w in m["workloads"]:
        cell = manifest.load_cell(w["name"])
        reported = {x["name"] for x in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer
        assert all(x["moves"] in reported for x in cell.per_layer)
