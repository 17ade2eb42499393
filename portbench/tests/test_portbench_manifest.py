"""BENCHMARK.json against the shape the harness requires, discovery of
each cell's files by name, and the check that nothing the benchmark runs
imports JAX or the JAX package (top-level module names compared whole)."""

import ast
import json
import re
import subprocess
import sys

import pytest

from harness import bench, manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
FORBIDDEN = {"jax", "jaxlib", "flax", "metalpathtracer_tpu"}
# the modules that must not import the program: the yardstick
YARDSTICK = ("harness/reference.py", "harness/compare.py", "harness/scene.py",
             "harness/manifest.py", "harness/window.py", "harness/trace.py",
             "control.py")


@pytest.fixture(scope="module")
def spec():
    return json.loads((manifest.REPO / "BENCHMARK.json").read_text())


def test_top_level_keys_and_limits(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["command"] == ["python3", "portbench/run.py"]
    assert spec["paths"] == ["portbench"]
    assert 1 <= spec["run_seconds"] <= 51
    assert len((manifest.REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys(spec):
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    names += [w["name"] for w in spec["workloads"]] + [c["name"] for c in spec["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in spec["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in spec["end_to_end"])
    e2e = {m["name"] for m in spec["end_to_end"]}
    for m in spec["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e


def test_every_cell_finds_its_files(spec):
    configs = {c["name"] for c in spec["configs"]}
    used = set()
    for w in spec["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        cell = manifest.Cell(spec, w["name"])
        used.add(w["config"])
        assert cell.traffic["integrator"] in ("scan", "wavefront")
        assert set(cell.limits) == {"gap_mean", "off_share"}
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert callable(cell.reader(m["name"]))
    assert used == configs
    for c in spec["configs"]:
        assert c["file"].startswith("portbench/configs/")
        assert set(c) == {"name", "source", "file", "reduced", "why"}


def test_unknown_workload_is_refused(spec):
    with pytest.raises(KeyError):
        manifest.Cell(spec, "no.such_cell")


def test_layer_files_compile():
    layers = manifest.layers()
    assert {"hit", "step"} <= set(layers)
    assert all(layers.values())


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_no_module_of_the_benchmark_imports_jax():
    files = sorted(manifest.ROOT.rglob("*.py"))
    assert files
    for f in files:
        tops = {m.split(".")[0] for m in _imports(f)}
        assert not tops & FORBIDDEN, (f, tops & FORBIDDEN)


def test_the_yardstick_imports_nothing_of_the_program():
    for rel in YARDSTICK:
        tops = {m.split(".")[0] for m in _imports(manifest.ROOT / rel)}
        assert "metalpathtracer_torch" not in tops, rel


def test_top_level_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "metalpathtracer_tpu_like", sys)
    assert "metalpathtracer_tpu_like" not in bench.forbidden_modules()
    monkeypatch.setitem(sys.modules, "metalpathtracer_tpu.render", sys)
    assert bench.forbidden_modules() == ["metalpathtracer_tpu"]


def test_the_import_path_loads_no_jax():
    """A fresh interpreter imports the harness and the program as a run
    does (and builds a cell's scene on the CPU): no JAX module is loaded."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from harness import bench, manifest, program, scene\n"
        "cell = manifest.Cell(manifest.load_json(manifest.REPO / 'BENCHMARK.json'),"
        " 'reference.scan_720p')\n"
        "program.upload(scene.build(cell.config['scene'], cell.root), 'cpu')\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
    ) % (str(manifest.ROOT), str(manifest.REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(manifest.REPO))
    assert out.returncode == 0, out.stderr
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "metalpathtracer_torch" in tops
    assert not tops & FORBIDDEN


def test_run_refuses_without_a_card():
    """No card: a non-zero exit and no result line."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines without one")
    out = subprocess.run([sys.executable, str(manifest.ROOT / "run.py"), "--workload",
                          "reference.scan_720p", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300,
                         cwd=str(manifest.REPO))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
