"""`BENCHMARK.json` and the files it names, found by name.

A cell (`workloads` entry) names a configuration and a traffic mix. Its
files are the configuration's `file`, `traffic/<traffic>.json` and
`limits/<cell>.json` (the correctness limits); each per-layer metric the
cell reports is read by `metrics/<metric>.py`, and each layer's kernel
names are in `layers/<layer file>.json`. Adding a configuration, a mix, a
metric or a layer adds files and entries and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]  # the benchmark's folder
REPO = ROOT.parent  # where BENCHMARK.json and the program are


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


class Cell:
    """One workload of the manifest with its configuration, traffic and
    limits, and the metrics it reports."""

    def __init__(self, manifest: dict, name: str, root: Path = ROOT,
                 repo: Path = REPO):
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have: {', '.join(cells)})")
        self.root = root
        self.workload = cells[name]
        self.name = name
        self.chips = int(self.workload["chips"])
        configs = {c["name"]: c for c in manifest["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.config = load_json(repo / self.config_entry["file"])
        self.traffic = load_json(root / "traffic" / f"{self.workload['traffic']}.json")
        self.limits = load_json(root / "limits" / f"{name}.json")
        self.end_to_end = [m for m in manifest["end_to_end"] if self._reports(m)]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in manifest["per_layer"]
                          if self._reports(m) and m["moves"] in reported]

    def _reports(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def reader(self, metric: str):
        """The `read(ctx)` function of `metrics/<metric>.py`."""
        path = self.root / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read


def layers(root: Path = ROOT) -> dict:
    """{layer file stem: compiled kernel-name patterns} of `layers/*.json`."""
    return {p.stem: [re.compile(k) for k in load_json(p)["kernels"]]
            for p in sorted((root / "layers").glob("*.json"))}
