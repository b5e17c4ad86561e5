"""A cell of BENCHMARK.json and the files it names, found by name:
configs/<config>.json, traffic/<traffic>.json, layers/<config>.json and
metrics/<metric>.py under perfbench/."""

from __future__ import annotations

import copy
import importlib.util
import json
import os


class CellError(Exception):
    pass


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


class Cell:
    def __init__(self, root: str, bench: dict, workload: dict):
        self.root = root
        self.bench_dir = os.path.join(root, "perfbench")
        self.name = workload["name"]
        self.chips = int(workload["chips"])
        self.config_name = workload["config"]
        self.traffic_name = workload["traffic"]
        self.bench = bench
        self.config = _json(os.path.join(
            self.bench_dir, "configs", f"{self.config_name}.json"))
        self.traffic = _json(os.path.join(
            self.bench_dir, "traffic", f"{self.traffic_name}.json"))
        layers = os.path.join(self.bench_dir, "layers",
                              f"{self.config_name}.json")
        self.layers = _json(layers) if os.path.exists(layers) else None
        self.entry = self.config["entry"]

    def dry_run(self) -> "Cell":
        """This cell at the configuration's and the traffic's `dry_run`
        sizes, for a run on the CPU."""
        c = copy.copy(self)
        c.config = _merge(self.config, self.config.get("dry_run", {}))
        c.traffic = _merge(self.traffic, self.traffic.get("dry_run", {}))
        if self.layers is not None:
            # no device events on the CPU: nothing can be required of them
            c.layers = {**self.layers, "require": []}
        return c

    def _applies(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def metric_names(self, trace: bool) -> list:
        key = "per_layer" if trace else "end_to_end"
        return [m["name"] for m in self.bench[key] if self._applies(m)]

    def unit(self, name: str) -> str:
        for m in self.bench["end_to_end"] + self.bench["per_layer"]:
            if m["name"] == name:
                return m["unit"]
        raise CellError(f"no metric {name}")

    def readers(self) -> dict:
        """{per-layer metric name: its reader's `read(trace)`}."""
        out = {}
        for name in self.metric_names(True):
            path = os.path.join(self.bench_dir, "metrics", f"{name}.py")
            spec = importlib.util.spec_from_file_location(
                "perfbench_metric_" + name.replace(".", "_").replace(
                    "-", "_"), path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            out[name] = mod.read
        return out


def load(root: str, workload: str) -> Cell:
    path = os.path.join(root, "BENCHMARK.json")
    bench = _json(path)
    for w in bench["workloads"]:
        if w["name"] == workload:
            return Cell(root, bench, w)
    raise CellError(f"no workload {workload!r} in {path}")
