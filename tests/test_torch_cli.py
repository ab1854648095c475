"""The port's CLI (platinum_tpu_torch/app/cli.py) against the JAX
package's: `render cornell --spp 2 --size 16x16 --device cpu` writes a PNG
within a mean absolute difference of 1 (u8) of the JAX CLI's, with the
output space's ICC profile; `info` prints the JAX CLI's JSON; `render`
without `--device` runs on the card and raises where there is none; every
option that is not ported raises NotImplementedError naming its ROADMAP
queue-1 item; the options ported since (a `.ptscene` scene, the reference
app's `.json`, `--sampler z`, `--mesh`, `preview`) write the JAX CLI's
image."""

import json

import numpy as np
import pytest
import torch
from PIL import Image

from platinum_tpu.app import cli as jcli
from platinum_tpu_torch.app import cli
from platinum_tpu_torch.io.icc import profile_for

torch.set_num_threads(1)

RENDER = ["render", "cornell", "--spp", "2", "--size", "16x16"]


@pytest.mark.parametrize("tonemap", ["agx", "flim"])
def test_render_png_matches_the_jax_cli(tonemap, tmp_path, capsys):
    jpath, path = str(tmp_path / "jax.png"), str(tmp_path / "port.png")
    jcli.main(RENDER + ["--tonemap", tonemap, "-o", jpath])
    cli.main(RENDER + ["--tonemap", tonemap, "--device", "cpu", "-o", path])
    assert capsys.readouterr().out.split() == [jpath, path]
    a, b = Image.open(jpath), Image.open(path)
    assert b.size == (16, 16) and b.mode == a.mode == "RGB"
    diff = np.abs(np.asarray(a, np.int16) - np.asarray(b, np.int16))
    assert diff.mean() <= 1.0
    assert np.asarray(b).mean() > 0
    assert b.info["icc_profile"] == profile_for("sRGB")


def test_info_prints_the_jax_clis_json(capsys):
    jcli.main(["info", "cornell", "--assets"])
    ref = json.loads(capsys.readouterr().out)
    cli.main(["info", "cornell", "--assets"])
    assert json.loads(capsys.readouterr().out) == ref
    assert ref["triangles"] == 12


def test_render_defaults_to_the_card(tmp_path):
    args = cli.build_parser().parse_args(RENDER + ["-o", "x.png"])
    assert args.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(RENDER + ["-o", str(tmp_path / "x.png")])
        assert not (tmp_path / "x.png").exists()


@pytest.mark.parametrize("argv,item", [
    (["bake-luts"], 12),
])
def test_unported_options_raise_naming_their_item(argv, item, tmp_path):
    out = ["-o", str(tmp_path / "x.png")] if argv[0] != "bake-luts" else []
    if argv[0] == "render":
        out += ["--device", "cpu"]
    with pytest.raises(NotImplementedError,
                       match=rf"ROADMAP queue 1, item {item}\b"):
        cli.main(argv + out)


def _ported_case(case, tmp_path):
    """(argv) of a formerly refused option, its scene files written."""
    if case == "ptscene":
        from platinum_tpu.app.scenes import make_cornell_scene
        from platinum_tpu.io.sceneio import save_scene

        path = str(tmp_path / "cornell.ptscene")
        save_scene(make_cornell_scene()[0], path)
        return RENDER[:1] + [path] + RENDER[2:]
    if case == "refjson":
        from test_refscene import _write_fixture

        path, _ = _write_fixture(str(tmp_path))
        return ["render", path, "--spp", "2", "--size", "16x16", "--sampler",
                "pcg4d", "--bounces", "2"]
    if case == "sampler_z":
        return RENDER + ["--sampler", "z"]
    if case == "mesh":
        # one process: a one-rank mesh (tests/test_torch_parallel.py runs
        # two ranks under torch.distributed.run)
        return RENDER + ["--mesh", "sample=1,tile=1"]
    return ["preview", "colonnade-small", "--size", "24x16", "--pick", "12,8"]


@pytest.mark.parametrize("case", ["ptscene", "refjson", "sampler_z",
                                  "mesh", "preview"])
def test_formerly_unported_options_write_the_jax_clis_image(case, tmp_path,
                                                            capsys):
    """Each option that raised NotImplementedError before its module was
    ported now runs, and writes the JAX CLI's image (mean absolute
    difference <= 1 of 255); preview also prints the JAX CLI's pick."""
    argv = _ported_case(case, tmp_path)
    jpath, path = str(tmp_path / "jax.png"), str(tmp_path / "port.png")
    jcli.main(argv + ["-o", jpath])
    jout = capsys.readouterr().out.split()
    cli.main(argv + ["--device", "cpu", "-o", path])
    out = capsys.readouterr().out.split()
    assert out[:-1] == jout[:-1] and out[-1] == path
    a = np.asarray(Image.open(jpath), np.int16)
    b = np.asarray(Image.open(path), np.int16)
    assert a.shape == b.shape
    assert np.abs(a - b).mean() <= 1.0
    assert b.mean() > 0
