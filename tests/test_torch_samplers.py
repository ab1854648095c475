"""platinum_tpu_torch samplers vs the JAX package's: the uint32 hashes and
Halton offsets bit for bit, Halton draws within 1 ulp, warps to 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from platinum_tpu.ops import samplers as jsmp
from platinum_tpu_torch.ops import samplers as tsmp

torch.set_num_threads(1)
RNG = np.random.default_rng(1234)
N = 4096


def _u32(n):
    return RNG.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)


def test_pcg4d_bitwise():
    v = np.stack([_u32(N) for _ in range(4)], -1)
    ref = np.asarray(jsmp.pcg4d(jnp.asarray(v)))
    got = tsmp.pcg4d(torch.from_numpy(v.astype(np.int64))).numpy()
    assert np.array_equal(got.astype(np.uint32), ref)


def test_hash_u32_bitwise():
    v = _u32(N)
    ref = np.asarray(jsmp.hash_u32(jnp.asarray(v)))
    got = tsmp.hash_u32(torch.from_numpy(v.astype(np.int64))).numpy()
    assert np.array_equal(got.astype(np.uint32), ref)


def _pixels():
    px = RNG.integers(0, 512, N).astype(np.uint32)
    py = RNG.integers(0, 512, N).astype(np.uint32)
    return px, py


@pytest.mark.parametrize("sample_index", [0, 7, 1023])
def test_halton_offsets_bitwise_and_draws_within_one_ulp(sample_index):
    px, py = _pixels()
    js = jsmp.HaltonStream.create(jnp.asarray(px), jnp.asarray(py),
                                  sample_index)
    ts = tsmp.HaltonStream.create(torch.from_numpy(px.astype(np.int64)),
                                  torch.from_numpy(py.astype(np.int64)),
                                  sample_index)
    assert np.array_equal(ts.offset.numpy().astype(np.uint32),
                          np.asarray(js.offset))
    # camera (2+2), then two bounces of BSDF + NEE + RR draws
    for step in ("2d", "2d") + ("2d", "1d", "1d", "2d", "2d", "1d", "1d") * 2:
        if step == "1d":
            js, a = js.next_1d()
            ts, b = ts.next_1d()
        else:
            js, a = js.next_2d()
            ts, b = ts.next_2d()
        np.testing.assert_array_max_ulp(b.numpy(), np.asarray(a), maxulp=1)


def test_pcg4d_stream_bitwise():
    px, py = _pixels()
    js = jsmp.PCG4DStream.create(jnp.asarray(px), jnp.asarray(py), 5)
    ts = tsmp.PCG4DStream.create(torch.from_numpy(px.astype(np.int64)),
                                 torch.from_numpy(py.astype(np.int64)), 5)
    for _ in range(4):
        js, a = js.next_2d()
        ts, b = ts.next_2d()
        assert np.array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("warp", ["sample_disk", "sample_disk_polar",
                                  "sample_cosine_hemisphere",
                                  "sample_tri_uniform"])
def test_warps_match(warp):
    u = RNG.random((N, 2), dtype=np.float32)
    ref = np.asarray(getattr(jsmp, warp)(jnp.asarray(u)))
    got = getattr(tsmp, warp)(torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_z_sampler_raises_until_ported():
    """(The name is from when the port refused the Z-sampler.) Every name
    of it gives a ZStream whose draws are JAX's bit for bit, at
    make_stream's default size and budget."""
    px, py = _pixels()
    for kind in ("z", "zsampler", "sobol"):
        ref = jsmp.make_stream(kind, jnp.asarray(px), jnp.asarray(py), 5)
        got = tsmp.make_stream(kind, torch.from_numpy(px.astype(np.int64)),
                               torch.from_numpy(py.astype(np.int64)), 5)
        assert type(got).__name__ == "ZStream"
        for _ in range(3):
            ref, ju = ref.next_2d()
            got, tu = got.next_2d()
            assert np.array_equal(tu.numpy().view(np.uint32),
                                  np.asarray(ju).view(np.uint32))
