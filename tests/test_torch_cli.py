"""The port's CLI (platinum_tpu_torch/app/cli.py) against the JAX
package's: `render cornell --spp 2 --size 16x16 --device cpu` writes a PNG
within a mean absolute difference of 1 (u8) of the JAX CLI's, with the
output space's ICC profile; `info` prints the JAX CLI's JSON; `render`
without `--device` runs on the card and raises where there is none; every
option that is not ported raises NotImplementedError naming its ROADMAP
queue-1 item."""

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
    (["render", "scene.ptscene"], 10),
    (["render", "scene.json"], 10),
    (["render", "cornell", "--mesh", "sample=2"], 11),
    (["render", "cornell", "--sampler", "z"], 8),
    (["preview", "cornell"], 9),
    (["bake-luts"], 12),
])
def test_unported_options_raise_naming_their_item(argv, item, tmp_path):
    out = ["-o", str(tmp_path / "x.png")] if argv[0] != "bake-luts" else []
    if argv[0] == "render":
        out += ["--device", "cpu"]
    with pytest.raises(NotImplementedError,
                       match=rf"ROADMAP queue 1, item {item}\b"):
        cli.main(argv + out)
