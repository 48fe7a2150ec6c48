"""Finds everything a cell needs by the names in ``BENCHMARK.json``.

A workload names a configuration (its file is the configuration's
``file``) and a traffic mix (``benchmark/traffic/<traffic>.json``); its
limits are ``benchmark/limits/<workload>.json``. A metric's reader is
``benchmark/metrics/<name>.py``, or, for a name with a suffix after a dot
(``ddim_s.clip``), the reader of the part before the first dot. The
configuration's ``family`` names the program's driver
(``benchmark/drivers/<family>.py``) and the plain reference
(``benchmark/reference/<family>.py``). Nothing here knows a cell or a
metric by name.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Callable, Dict, List, Optional

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
PKG = os.path.basename(PKG_DIR)
ROOT = os.path.dirname(PKG_DIR)


class ManifestError(ValueError):
    """A name in ``BENCHMARK.json`` that resolves to no entry or file."""


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, dict]
    end_to_end: List[dict]      # the end-to-end metrics this cell reports
    per_layer: List[dict]       # the per-layer metrics this cell reports
    root: str = ROOT


def load_manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _json(path: str, what: str) -> dict:
    if not os.path.isfile(path):
        raise ManifestError(f"{what}: no file {path}")
    with open(path) as fh:
        return json.load(fh)


def traffic_path(root: str, traffic: str) -> str:
    return os.path.join(root, PKG, "traffic", f"{traffic}.json")


def limits_path(root: str, workload: str) -> str:
    return os.path.join(root, PKG, "limits", f"{workload}.json")


def metric_path(root: str, name: str) -> str:
    """The reader of metric ``name``: its own file, else that of the part
    before the first dot."""
    own = os.path.join(root, PKG, "metrics", f"{name}.py")
    if os.path.isfile(own):
        return own
    return os.path.join(root, PKG, "metrics", f"{name.split('.')[0]}.py")


def reports(metric: dict, workload: str, reported_e2e: Optional[set] = None) -> bool:
    """Whether ``workload`` reports ``metric``: those its ``workloads`` list,
    else every cell (end to end) or every cell that reports what it moves."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    return reported_e2e is None or metric["moves"] in reported_e2e


def resolve(workload: str, root: str = ROOT) -> Cell:
    """The cell named ``workload``, with its files read."""
    m = load_manifest(root)
    entry = next((w for w in m["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise ManifestError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next((c for c in m["configs"] if c["name"] == entry["config"]), None)
    if conf is None:
        raise ManifestError(f"workload {workload!r}: no configuration {entry['config']!r}")
    e2e = [x for x in m["end_to_end"] if reports(x, workload)]
    names = {x["name"] for x in e2e}
    layer = [x for x in m["per_layer"] if reports(x, workload, names)]
    for x in e2e + layer:
        if not os.path.isfile(metric_path(root, x["name"])):
            raise ManifestError(f"metric {x['name']!r}: no reader {metric_path(root, x['name'])}")
    traffic = _json(traffic_path(root, entry["traffic"]), f"traffic {entry['traffic']!r}")
    if traffic.get("loop") != "closed":
        raise ManifestError(f"traffic {entry['traffic']!r}: only a closed loop of one client "
                            "is driven")
    return Cell(name=workload, chips=entry["chips"],
                config=_json(os.path.join(root, conf["file"]), f"configuration {conf['name']!r}"),
                traffic=traffic,
                limits=_json(limits_path(root, workload), f"limits of {workload!r}"),
                end_to_end=e2e, per_layer=layer, root=root)


def reader(name: str, root: str = ROOT) -> Callable:
    """The ``read(run)`` function of metric ``name``."""
    path = metric_path(root, name)
    spec = importlib.util.spec_from_file_location(f"{PKG}_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
