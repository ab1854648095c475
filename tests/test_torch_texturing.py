"""ops/texturing.py of the port against the JAX module on the same inputs,
to atol 1e-6: sample_atlas on a u8 and an f32 atlas, entries with
srgb = 0 and 1 and with w == 0, UVs in [-3, 3] (repeat wrap: the texel
index is jnp.mod's / torch.remainder's, the sign of the divisor);
sample_material_textures with slots=None and pruned slots, with and
without `idt`; sample_normal_map; sample_base_alpha."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from platinum_tpu.ops import texturing as jtex
from platinum_tpu_torch.ops import texturing as tex

torch.set_num_threads(1)

ATOL = 1e-6
N = 4096


def _inputs(dtype, seed=0):
    rng = np.random.default_rng(seed)
    ah, aw = 64, 128
    if dtype == "u8":
        atlas = rng.integers(0, 256, (ah, aw, 4), np.uint8)
    else:
        atlas = rng.uniform(0, 1, (ah, aw, 4)).astype(np.float32)
    # (x, y, w, h, srgb): sub-rectangles, one of them empty (w == 0)
    table = np.array([[0, 0, 32, 16, 1], [32, 0, 64, 48, 0],
                      [96, 8, 31, 56, 1], [5, 20, 0, 7, 1],
                      [0, 48, 17, 9, 0]], np.int32)
    uv = rng.uniform(-3, 3, (N, 2)).astype(np.float32)
    uv[:64] = np.round(uv[:64] * 4) / 4          # texel centres and edges
    tex_ids = rng.integers(-1, len(table), (N, 6)).astype(np.int32)
    return atlas, table, uv, tex_ids


def _close(got, ref, name=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, name
    assert got.dtype == ref.dtype, (name, got.dtype, ref.dtype)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("dtype", ["u8", "f32"])
def test_sample_atlas_matches_jax(dtype):
    atlas, table, uv, tex_ids = _inputs(dtype)
    entry = table[tex_ids[:, 0] % len(table)]
    ref = jtex.sample_atlas(jnp.asarray(atlas), jnp.asarray(entry),
                            jnp.asarray(uv))
    got = tex.sample_atlas(torch.from_numpy(atlas), torch.from_numpy(entry),
                           torch.from_numpy(uv))
    _close(got, ref)
    assert (got[entry[:, 2] == 0] == 0).all()


@pytest.mark.parametrize("dtype", ["u8", "f32"])
@pytest.mark.parametrize("slots", [None, frozenset({0, 1}),
                                   frozenset({2, 4, 5})])
@pytest.mark.parametrize("idt", [False, True])
def test_sample_material_textures_matches_jax(dtype, slots, idt):
    atlas, table, uv, tex_ids = _inputs(dtype, seed=1)
    m = np.array([[0.6, 0.3, 0.1], [0.05, 0.9, 0.05],
                  [0.02, 0.1, 0.88]], np.float32) if idt else None
    ref = jtex.sample_material_textures(
        jnp.asarray(atlas), jnp.asarray(table), jnp.asarray(tex_ids),
        jnp.asarray(uv), idt=None if m is None else jnp.asarray(m),
        slots=slots)
    got = tex.sample_material_textures(
        torch.from_numpy(atlas), torch.from_numpy(table),
        torch.from_numpy(tex_ids), torch.from_numpy(uv),
        idt=None if m is None else torch.from_numpy(m), slots=slots)
    for f in dataclasses.fields(got):
        _close(getattr(got, f.name), getattr(ref, f.name), f.name)


@pytest.mark.parametrize("dtype", ["u8", "f32"])
@pytest.mark.parametrize("fn", ["sample_normal_map", "sample_base_alpha"])
def test_normal_map_and_base_alpha_match_jax(dtype, fn):
    atlas, table, uv, tex_ids = _inputs(dtype, seed=2)
    ref = getattr(jtex, fn)(jnp.asarray(atlas), jnp.asarray(table),
                            jnp.asarray(tex_ids), jnp.asarray(uv))
    got = getattr(tex, fn)(torch.from_numpy(atlas), torch.from_numpy(table),
                           torch.from_numpy(tex_ids), torch.from_numpy(uv))
    if fn == "sample_normal_map":
        assert np.array_equal(got[0].numpy(), np.asarray(ref[0]))
        _close(got[1], ref[1])
    else:
        _close(got, ref)
