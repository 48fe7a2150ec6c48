"""BENCHMARK.json against the benchmark's contract, and the harness's
resolution of every name to its files."""

import json
import os
import re
import shutil

import pytest

from benchmark import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
            "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
M = manifest.load_manifest()
WORKLOADS = [w["name"] for w in M["workloads"]]


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_keys_names_and_units():
    raw = open(os.path.join(manifest.ROOT, "BENCHMARK.json"), "rb").read()
    assert len(raw) <= 64 * 1024
    assert set(M) == KEYS["top"]
    assert 1 <= len(M["command"]) <= 32 and all(line(w) for w in M["command"])
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    assert 1 <= len(M["paths"]) <= 16
    for p in M["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
    for kind, extra in (("config", set()), ("workload", set()), ("end_to_end", {"workloads"}),
                        ("per_layer", {"workloads"})):
        entries = M[kind + "s" if kind in ("config", "workload") else kind]
        names = [e["name"] for e in entries]
        assert len(names) == len(set(names)), f"duplicate {kind} names"
        for e in entries:
            assert KEYS[kind] <= set(e) <= KEYS[kind] | extra, (kind, e["name"])
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
                assert e["source"] in SOURCES
            for key in ("why", "layer", "source"):
                if key in e:
                    assert line(e[key]), (e["name"], key)
    all_metrics = [e["name"] for e in M["end_to_end"] + M["per_layer"]]
    assert len(all_metrics) == len(set(all_metrics))
    for c in M["configs"]:
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert any(c["file"].startswith(p.rstrip("/") + "/") for p in M["paths"])
    assert len({c["file"] for c in M["configs"]}) == len(M["configs"])
    for w in M["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in M["workloads"]) <= max(1, len(pairs) // 4)
    assert {w["config"] for w in M["workloads"]} == {c["name"] for c in M["configs"]}


def test_end_to_end_bounds():
    names = {e["name"]: e for e in M["end_to_end"]}
    assert "setup_s" in names and names["setup_s"]["bound"] <= 0.25
    for e in M["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25, e["name"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_workload_resolves_to_its_files(workload):
    cell = manifest.resolve(workload)
    assert cell.config["family"] and cell.traffic["batch"] >= 1
    for name in ("latent_err", "decode_err", "video_err"):
        limit = cell.limits[name]
        assert not limit.get("provisional"), f"{workload} {name}: limit not yet set"
        assert limit["lower"] < limit["limit"] < limit["upper"]
    assert os.path.isfile(os.path.join(manifest.PKG_DIR, "drivers",
                                       f"{cell.config['family']}.py"))
    assert os.path.isfile(os.path.join(manifest.PKG_DIR, "reference",
                                       f"{cell.config['family']}.py"))


@pytest.mark.parametrize("workload", WORKLOADS)
def test_each_cell_reports_what_it_must(workload):
    cell = manifest.resolve(workload)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e, (m["name"], m["moves"])


def test_per_layer_metric_moves_one_reported_metric():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    for m in M["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        for w in m.get("workloads", WORKLOADS):
            assert manifest.reports(e2e[m["moves"]], w), (m["name"], w)


@pytest.mark.parametrize("metric", [m["name"] for m in M["end_to_end"] + M["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(manifest.reader(metric))


def test_a_new_cell_needs_only_new_files(tmp_path):
    """A configuration, a traffic mix, a limits file and a per-layer metric
    added as new files and new entries resolve without an edit."""
    root = tmp_path / "checkout"
    shutil.copytree(manifest.PKG_DIR, root / manifest.PKG,
                    ignore=shutil.ignore_patterns("__pycache__", "_cache", "tests"))
    m = json.loads(json.dumps(M))
    pkg = root / manifest.PKG
    config = json.loads((pkg / "configs" / "dawn_128.json").read_text())
    (pkg / "configs" / "dummy_cfg.json").write_text(json.dumps(dict(config, name="dummy_cfg")))
    (pkg / "traffic" / "dummy.t8.json").write_text(json.dumps(
        {"batch": 2, "frames": 8, "loop": "closed", "trace_calls": 1}))
    (pkg / "limits" / "dummy.cell.json").write_text(json.dumps(
        {"latent_err": {"limit": 0.1}, "decode_err": {"limit": 0.1},
         "video_err": {"limit": 0.1}}))
    (pkg / "metrics" / "dummy_frames.py").write_text(
        "def read(run):\n    return float(sum(c['frames'] for c in run.calls))\n")
    m["configs"].append({"name": "dummy_cfg", "source": "https://example.org/dummy",
                         "file": f"{manifest.PKG}/configs/dummy_cfg.json", "reduced": [],
                         "why": "a test"})
    m["workloads"].append({"name": "dummy.cell", "config": "dummy_cfg", "traffic": "dummy.t8",
                           "chips": 1, "why": "a test"})
    m["per_layer"].append({"name": "dummy_frames", "unit": "frames", "better": "higher",
                           "source": "program_counter", "layer": "sampling entry",
                           "moves": "video_fps", "workloads": ["dummy.cell"]})
    m["end_to_end"][0]["workloads"].append("dummy.cell")
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    cell = manifest.resolve("dummy.cell", root=str(root))
    assert cell.traffic["frames"] == 8 and cell.config["name"] == "dummy_cfg"
    assert [x["name"] for x in cell.per_layer] == ["dummy_frames"]
    read = manifest.reader("dummy_frames", root=str(root))
    run = type("Run", (), {"calls": [{"frames": 16}, {"frames": 16}]})()
    assert read(run) == 32.0
    # a suffixed name falls back to the reader of its stem
    assert manifest.metric_path(str(root), "dummy_frames.clip").endswith("dummy_frames.py")


def test_unknown_names_are_refused():
    with pytest.raises(manifest.ManifestError):
        manifest.resolve("no.such.cell")
