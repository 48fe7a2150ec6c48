"""The plain reference against the port's plain CPU path, what a run may
import, and a run's refusals."""

import ast
import os
import shutil
import subprocess
import sys
import types

import pytest
import torch

from benchmark import manifest, run
from benchmark.drivers import dawn as driver
from benchmark.reference import dawn as reference

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "dawn_tpu"}


def _subprocess(code, cwd=manifest.ROOT, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True,
                          text=True, timeout=300, env=env)


def test_reference_matches_the_port_in_f32(tiny_cell):
    """Same weights, same inputs, the port's plain CPU path in f32: the two
    agree to float32 rounding."""
    config = dict(tiny_cell.config, precision=dict(tiny_cell.config["precision"],
                                                   unet="float32", conv_tf32=False))
    weights = reference.seeded_state_dict(config, 11, "cpu")
    inputs = reference.make_inputs(config, tiny_cell.traffic, 11, 0, "cpu")
    got = driver.call(driver.build(config, weights, "cpu"), config, inputs)
    ref = reference.FlowDiffusion(config)
    ref.load_state_dict(weights, strict=True)
    values = reference.judge(ref, inputs, got)
    assert values["latent_err"] < 1e-5 and values["video_err"] < 1e-4, values
    assert values["decode_err"] < 1e-4, values


def test_state_dict_names_and_shapes_match_the_port():
    from dawn_tpu_torch.models.dm.flow_diffusion import FlowDiffusion, FlowDiffusionConfig
    config = manifest.resolve("dawn256.b1.t200").config
    ours = reference.seeded_state_dict(config, 1, "cpu")
    port = FlowDiffusion(FlowDiffusionConfig(img_size=256), device="cpu").state_dict()
    assert {k: v.shape for k, v in port.items()} == {k: v.shape for k, v in ours.items()}


def test_inputs_and_weights_follow_the_seed(tiny_cell):
    big = 2 ** 31 + 11
    a = reference.make_inputs(tiny_cell.config, tiny_cell.traffic, big, 3, "cpu")
    b = reference.make_inputs(tiny_cell.config, tiny_cell.traffic, big, 3, "cpu")
    c = reference.make_inputs(tiny_cell.config, tiny_cell.traffic, big, 4, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert {k: a[k].shape for k in a} == {k: c[k].shape for k in c}
    assert not torch.equal(a["noise_seq"], c["noise_seq"])
    w1 = reference.seeded_state_dict(tiny_cell.config, big, "cpu")
    w2 = reference.seeded_state_dict(tiny_cell.config, big, "cpu")
    assert all(torch.equal(w1[k], w2[k]) for k in w1)


def test_no_module_of_jax_or_the_jax_package_is_imported():
    """Every module the harness, the drivers, the reference, the metric
    readers and the calibration import, compared by whole top-level name."""
    code = ("import sys, glob, os\n"
            "import benchmark.run, benchmark.calibrate, benchmark.trace\n"
            "import benchmark.drivers.dawn, benchmark.reference.dawn\n"
            "from benchmark import manifest\n"
            "for f in glob.glob(os.path.join(manifest.PKG_DIR, 'metrics', '*.py')):\n"
            "    manifest.reader(os.path.basename(f)[:-3])\n"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))\n")
    proc = _subprocess(code)
    assert proc.returncode == 0, proc.stderr
    names = set(proc.stdout.split())
    assert "dawn_tpu_torch" in names and not names & FORBIDDEN, names & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    proc = _subprocess("import sys, benchmark.reference.dawn, benchmark.calibrate\n"
                       "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))\n")
    assert proc.returncode == 0, proc.stderr
    names = set(proc.stdout.split())
    assert not names & (FORBIDDEN | {"dawn_tpu_torch"})
    for root, _, files in os.walk(os.path.join(manifest.PKG_DIR, "reference")):
        for f in files:
            if f.endswith(".py"):
                tree = ast.parse(open(os.path.join(root, f)).read())
                for node in ast.walk(tree):
                    mods = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                            [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
                    for m in mods:
                        assert m.split(".")[0] not in FORBIDDEN | {"dawn_tpu_torch"}, (f, m)


def test_forbidden_names_are_compared_whole(monkeypatch):
    assert run.forbidden_modules() == []          # dawn_tpu_torch is loaded here
    monkeypatch.setitem(sys.modules, "dawn_tpu.models", types.ModuleType("dawn_tpu.models"))
    assert run.forbidden_modules() == ["dawn_tpu"]


def test_a_module_a_reader_loads_withholds_the_result(tiny_cell, tmp_path, monkeypatch,
                                                       capsys):
    """A per-layer reader that imports a module named ``jax`` is loaded
    after the window has closed; the run then prints no result."""
    stub = tmp_path / "stubs" / "jax"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text("")
    metrics = tmp_path / "checkout" / manifest.PKG / "metrics"
    metrics.mkdir(parents=True)
    (metrics / "jax_probe.py").write_text("import jax  # noqa: F401\n\n\n"
                                          "def read(run):\n    return 1.0\n")
    monkeypatch.syspath_prepend(str(tmp_path / "stubs"))
    tiny_cell.root = str(tmp_path / "checkout")
    tiny_cell.end_to_end = [{"name": "jax_probe", "unit": "%"}]
    try:
        result, out, err = run.run_cell(tiny_cell, 2 ** 31 + 9, 0.05, False, "cpu")
        assert result["metrics"] == {"jax_probe": {"value": 1.0, "unit": "%"}}
        assert run.report(result, out, err) != 0
    finally:
        sys.modules.pop("jax", None)
    printed = capsys.readouterr()
    assert "{" not in printed.out and "jax" in printed.err.splitlines()[-1]


def _no_card_env():
    return dict(os.environ, CUDA_VISIBLE_DEVICES="")


def test_a_run_without_a_card_fails_and_prints_no_result():
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                           "dawn128.b1.t200", "--seed", str(2 ** 31 + 5), "--seconds", "1",
                           "--trace", "0"], cwd=manifest.ROOT, capture_output=True, text=True,
                          timeout=300, env=_no_card_env())
    assert proc.returncode != 0
    assert "{" not in proc.stdout and "no run on the CPU" in proc.stderr


def test_a_checkout_of_the_benchmark_alone_fails(tmp_path):
    shutil.copy(os.path.join(manifest.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(manifest.PKG_DIR, tmp_path / manifest.PKG,
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                           "dawn128.b4.t200", "--seed", "3", "--seconds", "1", "--trace", "1"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=300,
                          env=dict(_no_card_env(), PYTHONPATH=""))
    assert proc.returncode != 0 and "{" not in proc.stdout


@pytest.mark.card
def test_a_short_run_on_the_card(tiny_cell):
    """One run of the tiny cell through the card (needs a CUDA card)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    result, _, _ = run.run_cell(tiny_cell, 5, 0.1, False, "cuda")
    assert result["correct"] and result["device"]["platform"] == "gpu"
