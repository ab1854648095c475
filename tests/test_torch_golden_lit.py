"""The port's CPU render of the blessed goldens, part 2: the furnace and
the alpha cutout (tests/test_torch_golden.py has part 1 and says which
goldens only the card holds).

furnace_rough_metal (96x96, 32 spp, 8 bounces: a rough metal sphere in a
white furnace) and cutout_shadows (128x128, 32 spp: a checker-cut quad's
stochastic alpha on path and shadow rays), each rendered as
tests/test_golden.py renders it and held to tests/goldens/<name>.exr at
its bar, RMSE <= 1e-3.
"""

import numpy as np
import pytest
import torch

import golden_configs as gc

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["furnace_rough_metal", "cutout_shadows"])
def test_port_renders_the_golden(name):
    img, _ = gc.render(name, "cpu")
    ref = gc.golden(name)
    assert img.shape == ref.shape
    assert np.isfinite(img).all() and img.mean() > 0
    err = gc.rmse(img, ref)
    assert err <= gc.RMSE_THRESHOLD, f"{name}: RMSE {err:.2e}"
