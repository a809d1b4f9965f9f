"""Find a cell's files by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration, whose ``file``
the manifest gives, and a traffic mix, read from
``<bench>/traffic/<traffic>.json``.  Its metrics are the manifest's
end-to-end metrics that list the cell (or list no cells) and the per-layer
metrics that list it (or, listing none, move an end-to-end metric the cell
reports); each per-layer metric is read by ``<bench>/metrics/<name>.py``,
a module with a ``read(ctx)`` function, or, where that file does not
exist, by the reader of the name without its last ``.<tag>``: one reader
serves ``device.replay_ms.gossip`` and ``device.replay_ms.sync``, which
differ only in the cells they list and the metric they move.
``<bench>`` is the first of the manifest's ``paths``.  Adding a cell, a
configuration, a mix or a metric is adding files and entries: nothing
here names one.
"""
from __future__ import annotations

import importlib.util
import json
import os
import re
from dataclasses import dataclass, field
from typing import Callable, Dict, List

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _by_name(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_reader(path: str, name: str) -> Callable:
    """The ``read`` function of the metric module at ``path``."""
    module_name = "portbench_metric_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(module_name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load the reader of {name!r} from {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def reader_path(bench: str, name: str) -> str:
    """``metrics/<name>.py``, or the file of ``name`` without its last
    ``.<tag>`` where there is none of its own."""
    own = os.path.join(bench, "metrics", name + ".py")
    if os.path.exists(own) or "." not in name:
        return own
    return os.path.join(bench, "metrics", name.rsplit(".", 1)[0] + ".py")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    readers: Dict[str, Callable] = field(default_factory=dict)


def load_cell(name: str, root: str = ROOT) -> Cell:
    manifest = load_manifest(root)
    work = _by_name(manifest["workloads"], name, "workload")
    conf = _by_name(manifest["configs"], work["config"], "configuration")
    bench = os.path.join(root, manifest["paths"][0])
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(bench, "traffic", work["traffic"] + ".json")) as f:
        traffic = json.load(f)
    e2e = [m for m in manifest["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [
        m for m in manifest["per_layer"]
        if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)
    ]
    readers = {m["name"]: load_reader(reader_path(bench, m["name"]), m["name"]) for m in per_layer}
    return Cell(name, work["chips"], config, traffic, e2e, per_layer, readers)
