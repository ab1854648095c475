"""The port's Z-sampler (ops/zsampler.py) against the JAX module, bit for
bit: the canonical index from `create`, the permuted index `_index` and
the draws of `next_1d` / `next_2d` for several dimensions, and `skip`, over
whole pixel grids with spp of 1 (no sample digits), odd and even
log2(spp), width != height, sizes that are not powers of two and sample
indices at and beyond spp (whose bits spill into the Morton digits), and
the default 4096 x 4096 x 4096 configuration, where the Morton index and
the sample bits pass 32 bits and wrap. Also: a compacted stream (the
integrator's `_take_lanes` on a permutation) draws JAX's numbers of the
permuted lanes, make_stream("z", ...) takes the image size and the budget,
and a sample index per lane (a sample batch) works as in JAX.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from platinum_tpu.ops import samplers as jsmp
from platinum_tpu.ops import zsampler as jz
from platinum_tpu_torch.ops import samplers as smp
from platinum_tpu_torch.ops import zsampler as z
from platinum_tpu_torch.render.integrator import _take_lanes

torch.set_num_threads(1)

# (width, height, spp, sample index)
GRIDS = [
    (16, 16, 1, 0),        # spp 1: log2_spp 0
    (16, 16, 1, 3),        # beyond spp
    (37, 21, 8, 5),        # odd log2_spp, w != h, not powers of two
    (37, 21, 8, 8),        # at spp
    (24, 40, 4, 2),        # even log2_spp
    (24, 40, 4, 13),       # beyond spp
    (5, 3, 2, 1),          # the smallest odd case
    (100, 60, 128, 127),   # odd log2_spp, 7 sample bits
    (64, 64, 4096, 4095),  # even log2_spp, 12 sample bits
    (4096, 4096, 4096, 77),  # the defaults: 36 bits, wrapped
]
DIMS = 7


def _bits(x):
    return np.asarray(x).astype(np.uint32)


def _fbits(x):
    return np.asarray(x).view(np.uint32)


def _grid(w, h, limit=4096):
    """All pixels of a w x h grid, or a seeded subset of `limit` of them."""
    if w * h <= limit:
        yy, xx = np.mgrid[0:h, 0:w]
        return xx.ravel().astype(np.uint32), yy.ravel().astype(np.uint32)
    rng = np.random.default_rng(w + h)
    return (rng.integers(0, w, limit).astype(np.uint32),
            rng.integers(0, h, limit).astype(np.uint32))


def _pair(px, py, s, w, h, spp):
    js = jz.ZStream.create(jnp.asarray(px), jnp.asarray(py), s, w, h, spp)
    ts = z.ZStream.create(torch.from_numpy(px.astype(np.int64)),
                          torch.from_numpy(py.astype(np.int64)), s, w, h, spp)
    return js, ts


@pytest.mark.parametrize("w,h,spp,s", GRIDS)
def test_zstream_is_jax_bitwise(w, h, spp, s):
    px, py = _grid(w, h)
    js, ts = _pair(px, py, s, w, h, spp)
    assert (ts.log2_res, ts.log2_spp, ts.base4_digits) == (
        js.log2_res, js.log2_spp, js.base4_digits)
    assert np.array_equal(ts.z.numpy().astype(np.uint32), _bits(js.z))
    assert int(ts.z.max()) <= 0xFFFFFFFF and int(ts.z.min()) >= 0
    for k in range(DIMS):
        assert np.array_equal(_bits(ts._index()), _bits(js._index()))
        if k % 2:
            js, ju = js.next_1d()
            ts, tu = ts.next_1d()
        else:
            js, ju = js.next_2d()
            ts, tu = ts.next_2d()
        assert tu.dtype == torch.float32 and tu.shape == ju.shape
        assert np.array_equal(_fbits(tu), _fbits(ju))
        assert ts.dim == int(js.dim)
    js, ts = js.skip(3), ts.skip(3)
    assert ts.dim == int(js.dim)
    js, ju = js.next_2d()
    ts, tu = ts.next_2d()
    assert np.array_equal(_fbits(tu), _fbits(ju))
    assert float(tu.max()) < 1.0 and float(tu.min()) >= 0.0


def test_zstream_draws_cover_the_unit_interval():
    """A 16x16 grid at 16 spp: each dimension's draws over all samples of
    a pixel are stratified, so the mean is near 1/2."""
    px, py = _grid(16, 16)
    means = []
    for s in range(16):
        _, ts = _pair(px, py, s, 16, 16, 16)
        _, u = ts.next_2d()
        means.append(u.mean(0).numpy())
    assert np.allclose(np.mean(means, 0), 0.5, atol=0.02)


def test_compacted_zstream_draws_jax_numbers():
    """`_take_lanes` keeps the per-lane canonical index and leaves the
    scalar dimension: the permuted stream draws what JAX's stream does
    on the same lanes."""
    px, py = _grid(32, 24)
    js, ts = _pair(px, py, 6, 32, 24, 8)
    js, _ = js.next_2d()
    ts, _ = ts.next_2d()
    n = len(px)
    perm = np.random.default_rng(2).permutation(n)[: n // 3]
    ts = _take_lanes(ts, torch.from_numpy(perm), n)
    assert ts.dim == 1 and ts.z.shape == (len(perm),)
    js = jz.ZStream(z=js.z[perm], dim=js.dim, log2_res=js.log2_res,
                    log2_spp=js.log2_spp, base4_digits=js.base4_digits)
    for _ in range(3):
        js, ju = js.next_1d()
        ts, tu = ts.next_1d()
        assert np.array_equal(_fbits(tu), _fbits(ju))


def test_make_stream_takes_the_image_size_and_budget():
    px, py = _grid(20, 12)
    lane_idx = np.repeat(np.arange(3), len(px) // 3).astype(np.int32)
    ref = jsmp.make_stream("z", jnp.asarray(px), jnp.asarray(py),
                           jnp.asarray(lane_idx), 20, 12, 6)
    got = smp.make_stream("z", torch.from_numpy(px.astype(np.int64)),
                          torch.from_numpy(py.astype(np.int64)),
                          torch.from_numpy(lane_idx), 20, 12, 6)
    assert isinstance(got, z.ZStream)
    assert (got.log2_res, got.log2_spp) == (5, 3)
    assert np.array_equal(got.z.numpy().astype(np.uint32), _bits(ref.z))
    _, ju = ref.next_2d()
    _, tu = got.next_2d()
    assert np.array_equal(_fbits(tu), _fbits(ju))
    # the defaults are JAX's
    d = smp.make_stream("zsampler", torch.from_numpy(px.astype(np.int64)),
                        torch.from_numpy(py.astype(np.int64)), 0)
    assert (d.log2_res, d.log2_spp, d.base4_digits) == (12, 12, 18)
