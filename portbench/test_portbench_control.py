"""The control, the reference computed in bfloat16 in the program's place,
comes out as not correct under every cell's limits (here at a size a test
run holds: a small colonnade, 48 x 27, a few samples)."""

import pytest
import torch

from portbench import compare, harness
from portbench.conftest import load_bench
from portbench.control import control_numbers


@pytest.mark.parametrize("cell", [w["name"] for w in load_bench()["workloads"]])
def test_the_control_fails(cell, tmp_path):
    spec = harness.find_cell(load_bench(), cell)
    spec["config"]["scene"].update(columns=2, rows=2, sphere_res=[8, 12])
    spec["traffic"].update(width=48, height=27)
    spec["check"]["pixels"] = 256
    nums = control_numbers(spec, 9000000007, 3, torch.device("cpu"))
    table, correct = compare.judge(spec["check"], nums)
    assert not correct
    assert table["pixels_off"]["value"] > table["pixels_off"]["limit"]
