"""What a run may load and where it refuses to run."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys

from bench_tiny import BENCH, ROOT, make_root

from harness.guard import BANNED, banned_loaded


def test_top_level_names_compare_whole():
    assert banned_loaded({"lucille_tpu_torch": 1, "lucille_tpu_torch.accel": 1,
                          "jaxtyping": 1, "numpy": 1}) == []
    assert banned_loaded({"lucille_tpu.accel.bvh": 1, "jaxlib.xla_client": 1,
                          "bench_large": 1, "tools_tpu": 1,
                          "examples_tpu.fur": 1, "jax": 1, "flax.linen": 1}
                         ) == sorted(BANNED)


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((BENCH / "reference").glob("*.py")):
        found = _imports(path) & (BANNED | {"lucille_tpu_torch", "harness"})
        assert not found, (path.name, found)


def test_the_benchmark_imports_no_jax():
    for path in sorted(BENCH.rglob("*.py")):
        assert not _imports(path) & BANNED, path


def _run(cwd, *extra, env=None):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "bundled-ao",
         "--seed", "1", "--seconds", "1", "--trace", "0", *extra], cwd=cwd,
        capture_output=True, text=True, timeout=300, env=env)


def test_no_card_no_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = _run(ROOT, env=env)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())
    assert "CUDA card" in out.stderr


def test_the_benchmark_alone_does_not_run(tmp_path):
    """A directory with BENCHMARK.json and benchmark/ but not the program
    exits non-zero without a result, whatever the card."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    probe = ("import sys; sys.argv[1:] = ['--workload', 'bundled-ao', "
             "'--seed', '1', '--seconds', '1']; import torch; "
             "torch.cuda.is_available = lambda: True; "
             "torch.cuda.device_count = lambda: 1; "
             "sys.path[:0] = ['benchmark', '.']; "
             "import runpy; runpy.run_path('benchmark/run.py', "
             "run_name='__main__')")
    out = subprocess.run([sys.executable, "-c", probe], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())
    assert "lucille_tpu_torch" in out.stderr
    assert json.loads((tmp_path / "BENCHMARK.json").read_text())


def test_a_banned_module_loaded_by_the_check_stops_the_result(
        tmp_path, monkeypatch, capsys):
    """A JAX module that a step after the window loads (here the check)
    leaves the run with no result and a non-zero exit."""
    import types

    import torch

    from harness import cell

    root = make_root(tmp_path)
    real_run, real_compare = cell.run_cell, cell.compare

    def compare_loading_jax(*a, **kw):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return real_compare(*a, **kw)

    monkeypatch.setattr(cell, "compare", compare_loading_jax)
    monkeypatch.setattr(cell, "run_cell", lambda args, t, r: real_run(
        args, t, r, device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for key in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR"):
        monkeypatch.setenv(key, "")
    rc = cell.main(["--workload", "bundled-ao", "--seed", "3000000017",
                    "--seconds", "1"], 0.0, root)
    out = capsys.readouterr()
    assert rc != 0
    assert not any(line.startswith("{") for line in out.out.splitlines())
    assert "jax" in out.err
