"""BENCHMARK.json against the benchmark's contract, and the harness's
finding of cells, configurations and metrics by name alone."""

from __future__ import annotations

import json
import re

import pytest

from bench_tiny import BENCH, ROOT, make_root, run

from harness import manifest as mf

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def manifest():
    return mf.load()


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_and_sizes(manifest):
    assert set(manifest) == KEYS
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= manifest["run_seconds"] <= 51
    assert isinstance(manifest["run_seconds"], int)
    assert 1 <= len(manifest["paths"]) <= 16
    for p in manifest["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    cmd = manifest["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    for w in cmd[1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in manifest["paths"])


def test_entries_have_just_their_keys(manifest):
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
    for m in manifest["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()


def test_names_and_units(manifest):
    named = (manifest["configs"] + manifest["workloads"]
             + manifest["end_to_end"] + manifest["per_layer"])
    for e in named:
        assert NAME.match(e["name"]), e["name"]
    for w in manifest["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for group in ("configs", "workloads"):
        names = [e["name"] for e in manifest[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in manifest["end_to_end"] + manifest["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_cell_reports_what_it_must(manifest):
    configs = {c["name"] for c in manifest["configs"]}
    assert configs == {w["config"] for w in manifest["workloads"]}
    assert any(m["name"] == "setup_s" for m in manifest["end_to_end"])
    four = sum(w["chips"] == 4 for w in manifest["workloads"])
    assert four <= max(1, len(manifest["workloads"]) // 4)
    for w in manifest["workloads"]:
        e2e, layer = mf.cell_metrics(manifest, w["name"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2 and layer
    for m in manifest["per_layer"]:
        assert m["moves"] in {e["name"] for e in manifest["end_to_end"]}
        cells = m.get("workloads") or [w["name"]
                                       for w in manifest["workloads"]]
        for cell in cells:
            e2e, _ = mf.cell_metrics(manifest, cell)
            assert m["moves"] in {e["name"] for e in e2e}, (m["name"], cell)


def test_a_new_cell_config_and_metric_are_files_and_entries(tmp_path):
    """A throwaway configuration, traffic mix and per-layer metric added
    as files and BENCHMARK.json entries alone run without a code edit."""
    root = make_root(tmp_path)
    bench = root / "benchmark"
    cfg = json.loads((bench / "configs" / "bundled.json").read_text())
    cfg["pixel_samples"] = 1
    (bench / "configs" / "bundled_1spp.json").write_text(json.dumps(cfg))
    tr = json.loads((bench / "traffic" / "ao.json").read_text())
    tr["tile"] = 24
    (bench / "traffic" / "ao24.json").write_text(json.dumps(tr))
    (bench / "metrics" / "frames_traced.py").write_text(
        "def read(ctx):\n    return ctx.trace['frames']\n")
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "bundled_1spp", "source": "a test",
                         "file": "benchmark/configs/bundled_1spp.json",
                         "reduced": ["pixel_samples"], "why": "a test"})
    m["workloads"].append({"name": "throwaway", "config": "bundled_1spp",
                           "traffic": "ao24", "chips": 1, "why": "a test"})
    m["per_layer"].append({"name": "frames_traced", "unit": "frames",
                           "better": "higher", "source": "device_trace",
                           "layer": "device", "moves": "frame_s",
                           "workloads": ["throwaway"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    got = run(root, "throwaway", trace=1)
    assert got["correct"]
    assert got["metrics"]["frames_traced"] == {"value": 1.0,
                                               "unit": "frames"}
    got = run(root, "throwaway", trace=0)
    assert got["correct"] and got["metrics"]["frame_s"]["value"] > 0
