"""A whole run (the harness without its look for a card, on the CPU at a
small size) with the timed path broken underneath: `correct` comes out
false for each fault a render cell can have. A sound run comes out true."""

import numpy as np
import pytest
import torch

from portbench import harness

SEED = 64 * 70000000 + 0            # the window starts at sample 1


def _step_unchanged(orig):
    def f(flat, settings, accum, accum_count, *a, **k):
        return accum
    return f


def _half_left_out(orig):
    def f(flat, settings, sample_idx, *a, **k):
        out = orig(flat, settings, sample_idx, *a, **k)
        half = out.shape[0] // 2
        return torch.cat([out[:half], out[:half].mean(0).expand(
            out.shape[0] - half, 3)])
    return f


def _altered(orig):
    def f(flat, settings, sample_idx, *a, **k):
        out = orig(flat, settings, sample_idx, *a, **k)
        return out * torch.tensor([1.05, 1.0, 1.0])
    return f


@pytest.mark.parametrize("fault,target", [
    (None, None),
    (_step_unchanged, "render_step"),
    (_half_left_out, "render_sample"),
    (_altered, "render_sample"),
])
def test_fault_is_caught(mini, monkeypatch, fault, target):
    from platinum_tpu_torch.render import integrator

    bench, root = mini
    if fault is not None:
        monkeypatch.setattr(integrator, target,
                            fault(getattr(integrator, target)))
    out = harness.run(bench, "mini.tiny", SEED, 0.6, False, device="cpu",
                      root=root)
    assert out["correct"] is (fault is None), out["checks"]
    assert np.isfinite(out["metrics"]["ms_per_spp"]["value"])
