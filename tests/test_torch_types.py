"""platinum_tpu_torch scene types: settings parity, `.to(device)`, and no
JAX in the port's imports."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from platinum_tpu.render import types as jtypes
from platinum_tpu_torch.render import types as ttypes

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_render_settings_fields_and_defaults_match_jax():
    jf = [(f.name, f.default) for f in dataclasses.fields(jtypes.RenderSettings)]
    tf = [(f.name, f.default) for f in dataclasses.fields(ttypes.RenderSettings)]
    assert tf == jf
    s = ttypes.RenderSettings(width=7, height=3)
    assert s.num_pixels == 21
    assert hash(s) == hash(ttypes.RenderSettings(width=7, height=3))


@pytest.mark.parametrize("name", ["MAT_ANISOTROPIC", "MAT_EMISSIVE",
                                  "MAT_THIN", "MAT_USES_ALPHA",
                                  "FLAG_MULTISCATTER_GGX", "FLAG_GMON"])
def test_flag_bits_match_jax(name):
    assert getattr(ttypes, name) == getattr(jtypes, name)


def test_port_imports_no_jax():
    """Import every module of the port in a fresh interpreter: JAX must
    stay out of sys.modules."""
    code = (
        "import pkgutil, sys, importlib, platinum_tpu_torch\n"
        "for m in pkgutil.walk_packages(platinum_tpu_torch.__path__,"
        " 'platinum_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "print(sorted(k for k in sys.modules if k == 'jax'"
        " or k.startswith('jax.')))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "[]"


def test_struct_to_moves_every_leaf():
    cam = ttypes.CameraConstants(*(torch.zeros(3) for _ in range(4)),
                                 *(torch.zeros(()) for _ in range(4)))
    moved = cam.to("meta")
    for f in dataclasses.fields(moved):
        assert getattr(moved, f.name).device.type == "meta"
    assert np.array_equal(cam.position.numpy(), np.zeros(3))
