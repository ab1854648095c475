"""The harness finds everything by name, a new cell needs only new files
and a new entry, BENCHMARK.json keeps to the contract, and a run's last
line has exactly the contract's keys (checks last)."""

import json
import os
import re
import subprocess
import sys

import pytest

from portbench.conftest import HERE, ROOT, load_bench
from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


@pytest.mark.parametrize("cell", [w["name"] for w in load_bench()["workloads"]])
def test_cell_found_by_name(cell):
    spec = harness.find_cell(load_bench(), cell)
    assert spec["config"]["name"] == spec["cell"]["config"]
    assert {"width", "height", "display"} <= set(spec["traffic"])
    assert set(spec["check"]["limits"]) >= {"pixels_off", "gap_median",
                                            "light_rows"}
    for m in spec["per_layer"]:
        assert callable(harness.reader(spec["metrics_dir"], m["name"]))
    assert callable(spec["reference"].radiance)
    assert {m["name"] for m in spec["end_to_end"]} >= {"setup_s", "ms_per_spp"}


def test_new_cell_is_new_files_and_an_entry(mini, tmp_path):
    bench, root = mini
    with open(os.path.join(root, "portbench", "metrics",
                           "mini.rays_per_frame.py"), "w") as f:
        f.write("def read(rec):\n    return rec.get('rays')\n")
    bench["per_layer"].append(dict(
        name="mini.rays_per_frame", unit="rays", better="higher",
        source="program_counter", layer="integrator", moves="ms_per_spp",
        workloads=["mini.tiny"]))
    spec = harness.find_cell(bench, "mini.tiny", root)
    assert spec["config"]["scene"]["columns"] == 2
    assert spec["traffic"]["width"] == 48
    names = [m["name"] for m in spec["per_layer"]]
    assert "mini.rays_per_frame" in names
    assert harness.reader(spec["metrics_dir"], "mini.rays_per_frame")(
        dict(rays=7.0)) == 7.0
    # the real cells are untouched by it
    assert "mini.rays_per_frame" not in [
        m["name"] for m in harness.find_cell(
            load_bench(), "sponza_class.final_1080p")["per_layer"]]


def test_benchmark_json_keeps_to_the_contract():
    b = load_bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"] and 1 <= b["run_seconds"] <= 51
    assert b["command"] == ["python3", "portbench/run.py"]
    cfgs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and NAME.match(c["name"])
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in cfgs and w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        pairs.add((w["config"], w["traffic"]))
        assert os.path.exists(os.path.join(HERE, "traffic",
                                           w["traffic"] + ".json"))
        assert os.path.exists(os.path.join(HERE, "checks",
                                           w["name"] + ".json"))
    assert len(pairs) == len(b["workloads"])
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert set(e2e) == {"setup_s", "ms_per_spp"}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    assert len(b["per_layer"]) == 7
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert os.path.exists(os.path.join(HERE, "metrics", m["name"] + ".py"))
        for w in m["workloads"]:
            assert "workloads" not in e2e[m["moves"]] or \
                w in e2e[m["moves"]]["workloads"]


def test_no_card_no_result():
    """Without a CUDA device the command fails and prints no result."""
    p = subprocess.run([sys.executable, os.path.join(HERE, "run.py"),
                        "--workload", "sponza_class.final_1080p",
                        "--seed", "5000000000", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       cwd=ROOT, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_has_the_contracts_keys(mini, trace):
    bench, root = mini
    out = harness.run(bench, "mini.tiny", 4000000001, 0.3, bool(trace),
                      device="cpu", root=root)
    line = json.loads(json.dumps(out))
    assert set(line) == KEYS | ({"breakdown"} if trace else set())
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["attempted"] >= 1
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        line["device"])
    spec = harness.find_cell(bench, "mini.tiny", root)
    want = spec["per_layer"] if trace else spec["end_to_end"]
    assert set(line["metrics"]) <= {m["name"] for m in want}
    if not trace:
        assert set(line["metrics"]) == {m["name"] for m in want}
        assert "frame_ms_p90" in line["metrics"]
    else:
        assert "post.display_ms" in line["metrics"]
    for v in line["checks"].values():
        assert set(v) == {"value", "limit"}
