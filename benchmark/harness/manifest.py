"""BENCHMARK.json and the files it names, found by name.

- a configuration: the file its entry names (configs/<name>.json);
- a traffic mix: traffic/<traffic>.json;
- a per-layer metric: metrics/<name>.py, a module with `read(ctx)`
  returning the number, or None where the cell gives it nothing to read.

A later cell, configuration or metric is a new file and a new entry:
nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
METRIC_DIR = BENCH_DIR / "metrics"


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _named(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def workload(manifest: dict, name: str) -> dict:
    return _named(manifest["workloads"], name, "workload")


def config(manifest: dict, name: str, root: Path = ROOT) -> dict:
    """The configuration's file, with "dir", the directory it lies in
    (where the files it names are)."""
    entry = _named(manifest["configs"], name, "configuration")
    path = root / entry["file"]
    return {**json.loads(path.read_text()), "dir": str(path.parent)}


def traffic(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    return json.loads((bench_dir / "traffic" / f"{name}.json").read_text())


def _reports(metric: dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def cell_metrics(manifest: dict, cell: str):
    """(the cell's end-to-end metrics, its per-layer metrics): those whose
    `workloads` list it, or that have none (a per-layer metric without
    one: where the end-to-end metric it moves is reported)."""
    e2e = [m for m in manifest["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    names = {m["name"] for m in e2e}
    return e2e, [m for m in manifest["per_layer"]
                 if _reports(m, cell, names)]


def metric_reader(name: str, metric_dir: Path = METRIC_DIR):
    """metrics/<name>.py's read function."""
    path = metric_dir / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
