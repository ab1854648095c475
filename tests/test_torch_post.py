"""The port's post stack (post/pipeline.py, post/tonemap.py) against the
JAX package's on the same image: postprocess_image with every tonemapper,
every AgX look and every flim preset, chromatic aberration, vignette, the
tone curve, contrast and saturation on, for every working space and output
space of core/colorspace.py's list, on a 24x40 image of HDR values from 0
to 1e3. Tolerance: atol 2e-5 on the display-encoded output in [0, 1] (the
ports of pow, log2 and exp2 differ from XLA's by ulps, which the flim
chain's exp2(-27.5 x) and the sRGB curve's slope near 0 amplify). The
option structs are the JAX package's, field for field."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from platinum_tpu.post import options as jopt
from platinum_tpu.post.pipeline import postprocess_image as jpost
from platinum_tpu_torch.core import colorspace as cs
from platinum_tpu_torch.post import options as opt
from platinum_tpu_torch.post.pipeline import postprocess_image, postprocess_jit

torch.set_num_threads(1)

ATOL = 2e-5
WORKING = ("BT709", "DisplayP3", "BT2020")
OUTPUT = ("sRGB", "DisplayP3", "BT2020")
TONEMAPS = ([("none", "none", "flim"), ("khronos_pbr", "none", "flim")]
            + [("agx", look, "flim") for look in sorted(opt.AGX_LOOKS)]
            + [("flim", "none", p) for p in sorted(opt.FLIM_PRESETS)])


def _image():
    rng = np.random.default_rng(7)
    img = (rng.random((24, 40, 3)) ** 6 * 1e3).astype(np.float32)
    img[0, :4] = 0.0
    img[1, :3] = np.eye(3, dtype=np.float32) * 1e3      # saturated primaries
    img[2, :3] = [[1e-4, 1e-4, 1e-4], [0.18, 0.18, 0.18], [1.0, 0.5, 0.25]]
    return img


def _options(module, tonemapper, look, preset):
    return module.PostProcessOptions(
        exposure=module.ExposureOptions(exposure=0.5),
        chromatic_aberration=module.ChromaticAberrationOptions(amount=60.0),
        contrast_saturation=module.ContrastSaturationOptions(
            contrast=25.0, saturation=-20.0),
        tone_curve=module.ToneCurveOptions(blacks=10.0, shadows=-15.0,
                                           highlights=20.0, whites=-10.0),
        vignette=module.VignetteOptions(amount=-1.5, midpoint=10.0),
        tonemap=module.TonemapOptions(
            tonemapper=tonemapper, agx_look=module.AGX_LOOKS[look],
            flim=module.FLIM_PRESETS[preset]))


def test_spaces_are_colorspace_lists():
    assert set(WORKING) | set(OUTPUT) == set(cs._BY_NAME)


@pytest.mark.parametrize("working", WORKING)
@pytest.mark.parametrize("output", OUTPUT)
@pytest.mark.parametrize("tonemapper,look,preset", TONEMAPS)
def test_postprocess_matches_jax(tonemapper, look, preset, working, output):
    img = _image()
    ref = np.asarray(jpost(jnp.asarray(img), _options(
        jopt, tonemapper, look, preset), working, output))
    got = postprocess_image(torch.from_numpy(img), _options(
        opt, tonemapper, look, preset), working, output).numpy()
    assert got.shape == ref.shape == (24, 40, 3)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_postprocess_jit_is_postprocess_image():
    assert postprocess_jit is postprocess_image


def _fields(x):
    if dataclasses.is_dataclass(x):
        return {f.name: _fields(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    return x


def test_options_are_the_jax_packages():
    assert _fields(opt.PostProcessOptions()) == _fields(
        jopt.PostProcessOptions())
    assert {k: _fields(v) for k, v in opt.FLIM_PRESETS.items()} == {
        k: _fields(v) for k, v in jopt.FLIM_PRESETS.items()}
    assert {k: _fields(v) for k, v in opt.AGX_LOOKS.items()} == {
        k: _fields(v) for k, v in jopt.AGX_LOOKS.items()}
