"""The benchmark's data files: ``BENCHMARK.json`` and every configuration,
traffic mix, cell and metric file it names, held to the benchmark's
contract; and a cell added as files alone is found and run."""

import json
import re
import shutil
import time

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
DIR = harness.BENCH_DIR


def _line(s: str) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert all(_line(w) for w in BENCH["command"])


def test_configs():
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] not in names
        names.add(c["name"])
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        body = json.loads((harness.ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    assert names == {w["config"] for w in BENCH["workloads"]}


def test_cells():
    seen = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in seen
        seen.add((w["config"], w["traffic"]))
        assert (DIR / "traffic" / f"{w['traffic']}.json").is_file()
        spec = harness.load_spec(w["name"])
        assert spec.traffic["kind"] in ("render", "fit")
        assert spec.limits
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)


def _metrics():
    return BENCH["end_to_end"] + BENCH["per_layer"]


def test_metric_entries():
    names = [m["name"] for m in _metrics()]
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in names
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"])
    for m in _metrics():
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (DIR / "metrics" / f"{m['name']}.py").is_file()
        base = m["name"].split(".")[0]  # a metric split by cells shares its kernels
        if base.endswith("_roofline"):
            assert m["unit"] == "%"
            assert list((DIR / "metrics").glob(f"{base}.kernels*.json"))


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def test_every_cell_reports_what_its_metrics_move():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = [w["name"] for w in BENCH["workloads"]]
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells and _reports(e2e[m["moves"]], cell)
    for cell in cells:
        shown = [n for n, m in e2e.items() if _reports(m, cell)]
        assert "setup_s" in shown and len(shown) >= 2
        assert any(_reports(m, cell) for m in BENCH["per_layer"])


def test_layers_are_named_alike():
    by_layer = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def test_file_names_are_names():
    for path in DIR.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(harness.ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_.\-/]+$", rel), rel


def test_a_cell_added_as_files_runs(tmp_path):
    """A new configuration, traffic mix and cell, each a file, dropped into
    a copy of the benchmark: found and run by the unchanged harness."""
    root = tmp_path / "checkout"
    shutil.copytree(DIR, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    cfg = json.loads((DIR / "configs" / "grid-64.json").read_text())
    cfg.update(name="grid-9")
    cfg["scene"]["n"] = 9
    (root / "benchmark" / "configs" / "grid-9.json").write_text(json.dumps(cfg))
    traffic = json.loads((DIR / "traffic" / "viewer-walk-4k-d4.json").read_text())
    traffic.update(width=40, height=24, depth=1)
    (root / "benchmark" / "traffic" / "viewer-walk-40x24-d1.json").write_text(json.dumps(traffic))
    limits = json.loads((DIR / "workloads" / "grid1024-render-4k-d4.json").read_text())
    (root / "benchmark" / "workloads" / "grid9-render-tiny.json").write_text(json.dumps(limits))
    bench["configs"].append({"name": "grid-9", "source": cfg["source"],
                             "file": "benchmark/configs/grid-9.json", "reduced": ["scene"],
                             "why": "a test's"})
    bench["workloads"].append({"name": "grid9-render-tiny", "config": "grid-9",
                               "traffic": "viewer-walk-40x24-d1", "chips": 1, "why": "a test's"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "rays_per_s" in (m["name"], m.get("moves")) or m["name"] == "frame_p95_ms" \
                or m["name"] == "frame_p95_ms.hostpaced":
            m.setdefault("workloads", []).append("grid9-render-tiny")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = harness.load_spec("grid9-render-tiny", root=root, bench_dir=root / "benchmark")
    assert spec.config["scene"]["n"] == 9 and spec.traffic["width"] == 40
    pytest.importorskip("raytracer_tpu_torch")
    out = harness.run_cell(spec, 2**40 + 3, 0.3, False, "cpu", time.perf_counter())
    assert out["correct"] and out["attempted"] >= 1
    assert {m["name"] for m in spec.end_to_end} == set(out["metrics"])
