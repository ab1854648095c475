"""ops/gmon.py of the port against the JAX module, to atol 1e-6: B = 8
integer-valued buckets (so lumas tie), every n_full from 1 to 8, cap 0.5
and 1.0; and a case built so that breaking luma ties in another order
than jnp.argsort's stable one moves the result by far more than that."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from platinum_tpu.ops.gmon import gmon_combine as jgmon
from platinum_tpu_torch.ops.gmon import gmon_combine

torch.set_num_threads(1)

ATOL = 1e-6
B = 8


@pytest.mark.parametrize("cap", [0.5, 1.0])
@pytest.mark.parametrize("n_full", range(1, B + 1))
def test_gmon_matches_jax(n_full, cap):
    rng = np.random.default_rng(100 * n_full + int(cap * 10))
    buckets = rng.integers(0, 4, (B, 2048, 3)).astype(np.float32)
    buckets[:, :256] = buckets[:1, :256]          # every bucket equal
    buckets[:, 256:512] = 0.0                     # black pixels
    buckets[-1, 512:600] = 40.0                   # a firefly bucket
    ref = np.asarray(jgmon(jnp.asarray(buckets), n_full, cap))
    got = gmon_combine(torch.from_numpy(buckets), n_full, cap).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def _combine_with_ties_reversed(buckets, n_full, cap):
    """The same estimator with luma ties broken by descending bucket
    index: what an unstable sort may give."""
    luma = (buckets * np.float32([0.2126, 0.7152, 0.0722])).sum(-1)
    b = buckets.shape[0]
    valid = np.arange(b)[:, None] < n_full
    key = np.where(valid, luma, np.inf)
    out = np.zeros(buckets.shape[1:], np.float32)
    for p in range(buckets.shape[1]):
        order = np.lexsort((-np.arange(b), key[:, p]))
        sl = np.where(valid[:, 0], luma[:, p], 0.0)[order]
        n = np.float32(n_full)
        s = sl.sum()
        ws = (np.arange(1, b + 1) * sl * valid[order, 0]).sum()
        g = np.clip(2 * ws / max(n * s, 1e-20) - (n + 1) / n, 0, cap)
        c = int(np.floor(g * (n_full // 2)))
        out[p] = buckets[order[c:n_full - c], p].mean(0)
    return out


def test_tied_lumas_keep_the_stable_order():
    """Buckets (0.7152, 0, 0) and (0, 0.2126, 0) have bitwise equal f32
    lumas but different colours; the window cuts through the tie, so which
    of them enters decides the result."""
    r = np.float32([0.7152, 0.0, 0.0])
    g = np.float32([0.0, 0.2126, 0.0])
    dark, bright = np.float32([0.01] * 3), np.float32([5.0] * 3)
    pixels = [[dark, r, g, r, g, bright, bright, bright],
              [r, g, g, r, dark, dark, bright, bright],
              [g, r, dark, dark, dark, r, g, bright]]
    buckets = np.stack([np.stack(p) for p in pixels], axis=1)
    assert buckets.shape == (B, 3, 3)
    ref = np.asarray(jgmon(jnp.asarray(buckets), B, 1.0))
    got = gmon_combine(torch.from_numpy(buckets), B, 1.0).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    other = _combine_with_ties_reversed(buckets, B, 1.0)
    assert np.abs(other - ref).max() > 100 * ATOL
