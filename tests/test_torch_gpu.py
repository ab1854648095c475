"""The CUDA wide-BVH kernel on the card: one-level (K1, K2) and two-level
(K3) modes against their plain PyTorch versions, the wrapper's input
checks, and the threefry draws on the card against the CPU. Every test
here needs a CUDA device and skips without one; this module imports no
JAX and nothing of the JAX package, so it also runs where only PyTorch is
installed (`python -m pytest tests/test_torch_gpu.py -m gpu`)."""

import numpy as np
import pytest
import torch

from platinum_tpu_torch.accel.bvh import build_bvh
from platinum_tpu_torch.accel.wide import build_wide_bvh
from platinum_tpu_torch.ops import packet_trace as pt
from platinum_tpu_torch.ops import threefry

pytestmark = pytest.mark.gpu
TMIN = 1e-3


@pytest.fixture
def soup_on_card():
    """A random triangle soup's wide BVH on the card (the recipe of
    tests/test_pallas_trace.py's `_random_soup`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(0)
    t = 800
    c = rng.uniform(-4, 4, (t, 3)).astype(np.float32)
    v0, v1, v2 = (c + rng.normal(0, 0.3, (t, 3)).astype(np.float32)
                  for _ in range(3))
    bvh = build_bvh(v0, v1, v2, max_leaf=4)
    o = bvh.tri_order
    geo = np.concatenate([v0[o], v1[o] - v0[o], v2[o] - v0[o],
                          np.zeros((t, 3), np.float32)], -1)
    wide = build_wide_bvh(bvh, geo, leaf_cap=16)
    dev = torch.device("cuda")
    return (torch.from_numpy(wide.nodes).reshape(-1, 16, 8).to(dev),
            torch.from_numpy(wide.tri_blocks).to(dev),
            torch.from_numpy(wide.meta).to(dev))


def _rays(n, tmax, dev):
    rng = np.random.default_rng(7)
    o = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([o.T, d.T, np.full((1, n), TMIN, np.float32),
                           np.full((1, n), tmax, np.float32)])
    return torch.from_numpy(rays).to(dev).contiguous()


@pytest.mark.parametrize("any_hit,tmax", [(False, np.inf), (True, 8.0)])
def test_kernel_matches_plain_version(soup_on_card, any_hit, tmax):
    nodes, blocks, meta = soup_on_card
    rays = _rays(4096, tmax, nodes.device)
    before = dict(pt.LAUNCHES)
    k = pt.trace_wide(rays, nodes, blocks, meta, any_hit)
    p = pt.trace_wide_plain(rays, nodes, blocks, meta, any_hit)
    torch.cuda.synchronize()
    mode = "any" if any_hit else "closest"
    assert pt.LAUNCHES[mode] == before[mode] + 1
    hk, hp = k[1] >= 0, p[1] >= 0
    assert (hk == hp).float().mean() > 0.995 and hp.sum() > 100
    if not any_hit:
        both = hk & hp
        tie = torch.isclose(k[0][both], p[0][both], rtol=1e-5, atol=1e-6)
        assert ((k[1][both] == p[1][both]) | tie).all()
        torch.testing.assert_close(k[0][both], p[0][both],
                                   rtol=1e-4, atol=1e-5)


def test_wrapper_refuses_bad_inputs(soup_on_card):
    nodes, blocks, meta = soup_on_card
    rays = _rays(256, np.inf, nodes.device)
    with pytest.raises(TypeError):
        pt.trace_wide(rays, nodes, blocks, meta.long(), False)
    with pytest.raises(ValueError, match="contiguous"):
        pt.trace_wide(rays[:, ::2], nodes, blocks, meta, False)
    with pytest.raises(ValueError, match="is on"):
        pt.trace_wide(rays, nodes.cpu(), blocks, meta, False)


@pytest.fixture
def instanced_on_card():
    """The 24-instance scene of tests/test_tlas.py, flattened two-level."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from instanced_scenes import instanced_scene
    from platinum_tpu_torch.render.flatten import flatten_scene
    from platinum_tpu_torch.render.types import RenderSettings

    scene, cam = instanced_scene("platinum_tpu_torch")
    flat = flatten_scene(scene, cam, RenderSettings(
        width=48, height=48, instancing="on", tracer="packet"),
        accel_min_tris=1, device="cuda")
    return (flat.wbvh_nodes.reshape(-1, 16, 8).contiguous(), flat.wbvh_tris,
            flat.wbvh_meta, flat.instances.feat)


@pytest.mark.parametrize("any_hit,tmax", [(False, np.inf), (True, 6.0)])
def test_instanced_kernel_matches_plain_version(instanced_on_card, any_hit,
                                                tmax):
    nodes, blocks, meta, feat = instanced_on_card
    rays = _rays(4096, tmax, nodes.device)
    before = dict(pt.LAUNCHES)
    k = pt.trace_wide(rays, nodes, blocks, meta, any_hit, inst_feat=feat)
    p = pt.trace_wide_inst_plain(rays, nodes, blocks, meta, any_hit, feat)
    torch.cuda.synchronize()
    mode = "inst_any" if any_hit else "inst_closest"
    assert pt.LAUNCHES[mode] == before[mode] + 1
    hk, hp = k[1] >= 0, p[1] >= 0
    assert (hk == hp).float().mean() > 0.995 and hp.sum() > 100
    if not any_hit:
        both = hk & hp
        same = k[1][both] == p[1][both]
        tie = torch.isclose(k[0][both], p[0][both], rtol=1e-5, atol=1e-6)
        assert (same | tie).all()
        assert (k[4][both][same] == p[4][both][same]).all()
        torch.testing.assert_close(k[0][both], p[0][both],
                                   rtol=1e-4, atol=1e-5)


def test_threefry_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    key = threefry.fold_in(threefry.fold_in(threefry.PRNGKey(0), 7), 2)
    for n in (1, 513, 262_144):
        gpu = threefry.uniform(key, n, "cuda").cpu()
        cpu = threefry.uniform(key, n, "cpu")
        assert torch.equal(gpu.view(torch.int32), cpu.view(torch.int32))
