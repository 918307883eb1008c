"""Finds what a cell is made of by the names BENCHMARK.json gives: the
configuration file, the traffic mix `traffic/<name>.json`, the key stream
`streams/<name>.py` and each metric's reader `metrics/<name>.py`, all
under the benchmark's folder. Adding a cell, a mix, a stream or a metric
is adding files; nothing here lists them."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent


class Spec:
    """BENCHMARK.json and the benchmark folder it points into."""

    def __init__(self, bench_file: Path, root: Path = HERE):
        self.bench_file = Path(bench_file)
        self.repo = self.bench_file.resolve().parent
        self.root = Path(root)
        self.bench = json.loads(self.bench_file.read_text())
        self._mods: Dict[Path, ModuleType] = {}

    def workload(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload named {name!r} in {self.bench_file}")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                cfg = json.loads((self.repo / c["file"]).read_text())
                cfg["name"] = name
                return cfg
        raise KeyError(f"no configuration named {name!r} in {self.bench_file}")

    def traffic(self, name: str) -> dict:
        t = json.loads((self.root / "traffic" / f"{name}.json").read_text())
        t["name"] = name
        return t

    def _load(self, path: Path) -> ModuleType:
        if path not in self._mods:
            if not path.is_file():
                raise FileNotFoundError(f"no file {path}")
            mod_name = "portbench_" + path.parent.name + "_" + path.stem.replace(".", "_").replace("-", "_")
            spec = importlib.util.spec_from_file_location(mod_name, path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._mods[path] = mod
        return self._mods[path]

    def stream(self, name: str) -> ModuleType:
        return self._load(self.root / "streams" / f"{name}.py")

    def reader(self, metric: str) -> ModuleType:
        return self._load(self.root / "metrics" / f"{metric}.py")

    def metrics(self, workload: str, trace: bool) -> List[dict]:
        """The metrics a run of `workload` reports: its end-to-end metrics
        with tracing off, its per-layer metrics with tracing on. A metric
        without a `workloads` list is the cell's where it is end to end,
        and where the end-to-end metric it moves is."""
        e2e = [m for m in self.bench["end_to_end"] if workload in m.get("workloads", [workload])]
        if not trace:
            return e2e
        moved = {m["name"] for m in e2e}
        return [m for m in self.bench["per_layer"]
                if workload in m.get("workloads", ()) or ("workloads" not in m and m["moves"] in moved)]
