"""``BENCHMARK.json`` against the contract's form, every configuration,
mix, driver and metric found by name, and the benchmark's imports."""

import ast
import json
import os
import re

import pytest

from fdk_bench import run as R

ROOT = R.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["fdk_bench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len(bench["command"]) <= 32
    assert not any(w.startswith("/") or ".." in w for w in bench["command"])
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 << 10


def test_names_and_units(bench):
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])


def test_configs_found_by_name(bench):
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert c["file"] == f"fdk_bench/configs/{c['name']}.json"
        with open(R.find("config", c["name"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert key in cfg, key


def test_cells_mixes_drivers_metrics_found_by_name(bench):
    cells = {w["name"] for w in bench["workloads"]}
    for w in bench["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        mix = R.load_json(R.find("traffic", w["traffic"]))
        driver = R.load_module("driver", mix["driver"])
        assert callable(driver.run) and driver.TRACE_WINDOWS
        assert set(mix["limits"]) == {"rel_rmse"}
        assert mix["control"] in ("bfloat16", "float8_e4m3fn")
        e2e = R.cell_metrics(bench, w["name"], False)
        assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
        assert R.cell_metrics(bench, w["name"], True)
    for m in bench["end_to_end"] + bench["per_layer"]:
        reader = R.load_module("metric", m["name"])
        assert reader.UNIT == m["unit"] and callable(reader.read)
        assert set(m.get("workloads", cells)) <= cells
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        reports = set(e2e[m["moves"]].get("workloads", cells))
        assert set(m["workloads"]) <= reports


def test_every_file_by_name_loads():
    """Configurations, mixes and readers kept for cells not in
    ``BENCHMARK.json`` yet load as those in it do."""
    for n in os.listdir(os.path.join(R.HERE, "configs")):
        cfg = R.load_json(R.find("config", n[:-5]))
        assert cfg["name"] == n[:-5] and cfg["reduced"]
    for n in os.listdir(os.path.join(R.HERE, "traffic")):
        mix = R.load_json(R.find("traffic", n[:-5]))
        assert callable(R.load_module("driver", mix["driver"]).run)
        assert set(mix["limits"]) == {"rel_rmse"}
    for n in os.listdir(os.path.join(R.HERE, "metrics")):
        if n.endswith(".py") and n != "__init__.py":
            reader = R.load_module("metric", n[:-3])
            assert reader.UNIT and reader.read({"trace": {}}) is None


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_jax_and_a_reference_free_of_the_program():
    base = os.path.join(ROOT, "fdk_bench")
    seen = 0
    for d, _, files in os.walk(base):
        if os.path.relpath(d, base).split(os.sep)[0] == "tests":
            continue
        for n in files:
            if not n.endswith(".py"):
                continue
            path = os.path.join(d, n)
            tops = {m.split(".", 1)[0] for m in _imports(path)}
            assert not tops & {"jax", "jaxlib", "flax", "paris_tpu"}, path
            if os.path.relpath(d, base).startswith("reference"):
                assert "paris_tpu_torch" not in tops, path
            seen += 1
    assert seen > 20


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    import sys
    import types
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    monkeypatch.delitem(sys.modules, "paris_tpu", raising=False)
    base = set(R.forbidden_modules())
    monkeypatch.setitem(sys.modules, "paris_tpu_torch_x",
                        types.ModuleType("paris_tpu_torch_x"))
    assert set(R.forbidden_modules()) == base
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert "jax" in R.forbidden_modules()


def test_no_result_without_a_card_or_without_the_program(tmp_path):
    import shutil
    import subprocess
    import sys
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "fdk_bench"), tmp_path / "fdk_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run(
        [sys.executable, "-m", "fdk_bench.run", "--workload",
         "c5-block-fast", "--seed", "3", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=120)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
