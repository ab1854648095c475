"""Fixtures of the benchmark's CPU tests: a miniature checkout whose one
cell is a small colonnade at 48 x 27, made of new files and a new
BENCHMARK.json entry alone (the way a later change adds a cell), and a
whole checkout with the test cell of testcell/ (a textured studio under
an HDR sky, with its own generator and reference) added to it."""

import hashlib
import json
import os
import shutil
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
TESTCELL = os.path.join(HERE, "testcell")
PYCACHE = shutil.ignore_patterns("__pycache__")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def load_bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def make_mini(root, display=True, columns=2, rows=2):
    """(BENCHMARK dict, root) of a checkout under `root` holding the
    metric readers and one cell "mini.tiny"."""
    pb = os.path.join(root, "portbench")
    for d in ("configs", "traffic", "checks"):
        os.makedirs(os.path.join(pb, d), exist_ok=True)
    for d in ("metrics", "reference"):
        shutil.copytree(os.path.join(HERE, d), os.path.join(pb, d),
                        dirs_exist_ok=True, ignore=PYCACHE)
    with open(os.path.join(HERE, "configs", "sponza_class.json")) as f:
        cfg = json.load(f)
    cfg["scene"].update(columns=columns, rows=rows, sphere_res=[8, 12])
    files = {
        "configs/mini.json": cfg,
        "traffic/tiny.json": dict(width=48, height=27, display=display),
        "checks/mini.tiny.json": json.load(open(os.path.join(
            HERE, "checks", "sponza_class.viewport_720p.json"))),
    }
    for name, body in files.items():
        with open(os.path.join(pb, name), "w") as f:
            json.dump(body, f)
    bench = load_bench()
    bench["configs"].append(dict(bench["configs"][0], name="mini",
                                 file="portbench/configs/mini.json"))
    bench["workloads"].append(dict(name="mini.tiny", config="mini",
                                   traffic="tiny", chips=1, why="test"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("mini.tiny")
    # the viewport's metrics, kept for a later cell, on the displaying mix
    bench["end_to_end"].append(dict(
        name="frame_ms_p90", unit="ms", better="lower", bound=0.25,
        source="host_clock", workloads=["mini.tiny"]))
    bench["per_layer"].append(dict(
        name="post.display_ms", unit="ms", better="lower",
        source="host_clock", layer="post stack", moves="frame_ms_p90",
        workloads=["mini.tiny"]))
    return bench, str(root)


def digests(root) -> dict:
    """{path under root: sha256} of every file under root."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def make_studio(root):
    """(BENCHMARK dict, root, digests of the checkout before the cell) of
    a copy of the benchmark under `root` to which the test cell
    "studio.studio_tiny" is added as new files (testcell/'s, each at its
    place under portbench/) and new entries. Raises if a file of the
    cell would replace one the checkout has."""
    pb = os.path.join(root, "portbench")
    shutil.copytree(HERE, pb, ignore=shutil.ignore_patterns(
        "__pycache__", "testcell"))
    before = digests(pb)
    for d, _, files in os.walk(TESTCELL):
        for f in files:
            if f.endswith(".pyc"):
                continue
            rel = os.path.relpath(os.path.join(d, f), TESTCELL)
            if rel in before:
                raise FileExistsError(rel)
            os.makedirs(os.path.dirname(os.path.join(pb, rel)), exist_ok=True)
            shutil.copy(os.path.join(d, f), os.path.join(pb, rel))
    bench = load_bench()
    bench["configs"].append(dict(
        name="studio", source="a test scene", reduced=[], why="test",
        file="portbench/configs/studio.json"))
    bench["workloads"].append(dict(name="studio.studio_tiny", config="studio",
                                   traffic="studio_tiny", chips=1,
                                   why="test"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("studio.studio_tiny")
    return bench, str(root), before


@pytest.fixture
def mini(tmp_path):
    return make_mini(tmp_path)


@pytest.fixture
def studio(tmp_path):
    return make_studio(tmp_path)
