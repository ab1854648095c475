"""The CUDA kernel sources themselves, run on the CPU thread by thread.

tools/torch_emulate_kernels.py compiles platinum_tpu_torch/csrc/*.cu with
g++ against a shim of the CUDA headers and runs every launch as a loop
over threads. What the plain PyTorch versions cannot show without a card
is held here: every mode of wide_trace.cu that computes K1's function
(streamed blocks, the octant order, two_phase, the pipelined walk with
and without the flat push, the paired launch) gives K1's / K2's results
bit for bit, on one tree level and on the instanced tree; K1, K2 and the
reduced tiers agree with their plain versions under the bars of
tests/test_torch_gpu.py; the warp-wide drains, over the fp32 blocks (K1,
K6 and K7 closest) and over the pre-split planes of the reduced tiers
(built by the split kernel, bit for bit their plain version), give the
hit set and t of the leaf-pair kernel's per-pair test on every (ray,
block) pair in every bit, and its ids outside exact-t ties; the any-hit
drain (K2 and K6 any hit) gives the flag and the per-ray counts of the
per-thread classic walk (`profile="fix64"`); the two-level drains (K3,
K7 and K9 over the instanced tree) their plain versions' results and
K3's; the paired launch (K8: each CTA on its half's unpaired drain,
outputs and counts those modes', resident and streamed at every tier)
and the pipelined drain (K9) the unpaired modes' results; the ablation
modes do what they must; the leaf-pair kernel of stream_mt.cu makes the
ray-stream tracer's t K1's to the bit, and its chunked schedule gives
the outputs of its own per-pair path in every bit; the redesigned level
prefix (K11) gives its plain version's tables on synthetic levels; the
five kernels of bf_stream.cu (with their block scans, warp ballots and
barriers, run as cooperating threads) give the plain versions' tables
and results in every bit and the breadth-first tracer K1's, also on
their corner cases (tests/torch_kernel_cases.py), writing nothing past
the count, and the MT kernel (K13) gives K15's results on its pairs; the
C entry of wide_trace.cu takes walk codes 0-2 alone; the shim's
`__syncwarp` is a barrier of the warp. Skips where there is no g++.
"""

import os
import re
import shutil
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_emulate_kernels as emu  # noqa: E402
import torch_kernel_cases as kc  # noqa: E402
from platinum_tpu_torch.ops import bfstream as bf  # noqa: E402
from platinum_tpu_torch.ops import packet_trace as pt  # noqa: E402
from platinum_tpu_torch.ops import raystream as rs  # noqa: E402

torch.set_num_threads(1)
HIGH_T_RTOL = 1e-6      # "high": the same exact bf16 products, a few ulps


@pytest.fixture(scope="module")
def emulation(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernel sources for the host")
    return emu.Emulation(str(tmp_path_factory.mktemp("emulated_kernels")))


@pytest.fixture(scope="module")
def soup():
    return emu.soup_tree(n_tris=1500, seed=4)


RC = emu.soup_rays(1536, 1)
RA = emu.soup_rays(1200, 2, tmax=8.0)


def _hold_to_plain(k, p, rtol=1e-4, atol=1e-5):
    hk, hp = k[1] >= 0, p[1] >= 0
    assert (hk == hp).float().mean() > 0.995 and hp.sum() > 100
    both = hk & hp
    same = k[1][both] == p[1][both]
    tie = torch.isclose(k[0][both], p[0][both], rtol=1e-5, atol=1e-6)
    assert (same | tie).all()
    torch.testing.assert_close(k[0][both][same], p[0][both][same],
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_emulated_k1_k2_match_plain_versions(emulation, soup, any_hit):
    nodes, blocks, meta, _ = soup
    rays = RA if any_hit else RC
    before = dict(pt.LAUNCHES)
    with emulation:
        k = emu.trace_wide(rays, nodes, blocks, meta, any_hit)
    assert pt.LAUNCHES == before       # the wrapper's count is the card's
    p = pt.trace_wide_plain(rays, nodes, blocks, meta, any_hit)
    if any_hit:
        assert (k[1] == p[1]).float().mean() > 0.995 and (p[1] > 0).sum() > 50
    else:
        _hold_to_plain(k, p)


@pytest.mark.parametrize("tier", ["high", "default", "two_phase"])
def test_emulated_tier_matches_its_plain_version(emulation, soup, tier):
    nodes, blocks, meta, _ = soup
    with emulation:
        k = emu.trace_wide(RC, nodes, blocks, meta, False, mt_precision=tier,
                           planes=pt.split_planes(blocks))
    p = pt.trace_wide_reference(RC, nodes, blocks, meta, False,
                                mt_precision=tier)
    if tier == "high":
        _hold_to_plain(k, p, rtol=HIGH_T_RTOL, atol=0.0)
    else:
        _hold_to_plain(k, p)


MODES = {"stream": dict(stream=True), "oct_order": dict(oct=True),
         "stream+oct_order": dict(stream=True, oct=True),
         "two_phase": dict(mt_precision="two_phase"),
         "pipe": dict(pipe=True), "flat_walk": dict(flat_walk=True)}


@pytest.mark.parametrize("name", sorted(MODES))
def test_emulated_mode_is_k1_and_k2_bit_for_bit(emulation, soup, name):
    """A mode that changes the walk changes no result: closest hit equal
    to K1 in every output's bits, any hit equal to K2 (any hit takes no
    octant order and no tier)."""
    nodes, blocks, meta, worder = soup
    kw = dict(MODES[name])
    if kw.pop("oct", False):
        kw["worder"] = worder
    if "mt_precision" in kw:
        kw["planes"] = pt.split_planes(blocks)
    with emulation:
        k1 = emu.trace_wide(RC, nodes, blocks, meta, False)
        k = emu.trace_wide(RC, nodes, blocks, meta, False, **kw)
        assert emu.same_bits(k, k1) and (k1[1] >= 0).sum() > 100
        for key in ("worder", "mt_precision", "planes"):
            kw.pop(key, None)
        k2 = emu.trace_wide(RA, nodes, blocks, meta, True)
        assert emu.same_bits(emu.trace_wide(RA, nodes, blocks, meta, True,
                                            **kw), k2)


def test_emulated_pipelined_walk_counts(emulation, soup):
    """A stale bound admits more pops; a backlog entry behind the running
    best is dropped untested, so no more blocks are tested than K1's
    walk tests; per ray the counts are those `profile="count"` reports.
    The pipelined drain fills the drain rows."""
    nodes, blocks, meta, _ = soup
    with emulation:
        c1 = emu.trace_wide(RC, nodes, blocks, meta, False, count=True)
        c9 = emu.trace_wide(RC, nodes, blocks, meta, False, count=True,
                            pipe=True)
        cf = emu.trace_wide(RC, nodes, blocks, meta, False, count=True,
                            flat_walk=True)
    assert int(c9[0].sum()) >= int(c1[0].sum()) > 0
    assert 0 < int(c9[1].sum()) <= int(c1[1].sum())
    assert torch.equal(c9, cf)        # the flat push changes no count
    assert not c9[2:5].any()          # no instance entry, refine or re-walk
    _drain_counts_bracket(c9)


def test_emulated_pipelined_walk_over_multi_block_leaves(emulation):
    """Leaves of several blocks fill the backlog faster; the pipelined
    walk stays K1 bit for bit, and the flat push refuses such a tree. The
    C entry takes walk codes 0-2 alone."""
    nodes, blocks, meta, _ = emu.soup_tree(n_tris=1500, seed=4,
                                           leaf_cap=31 * 8)
    assert not pt._single_block_leaves(meta)
    with emulation:
        k1 = emu.trace_wide(RC, nodes, blocks, meta, False)
        assert emu.same_bits(
            emu.trace_wide(RC, nodes, blocks, meta, False, pipe=True), k1)
        with pytest.raises(ValueError, match="exactly one MT block"):
            emu.trace_wide(RC, nodes, blocks, meta, False, flat_walk=True)
        for any_hit in (False, True):
            for walk in (3, 4, 5, 6):
                with pytest.raises(RuntimeError, match="invalid value"):
                    pt._launch(RC, nodes, blocks, meta, any_hit, None, False,
                               walk=walk)


def test_emulated_pipelined_walk_loses_no_block_of_an_overfull_node(
        emulation, soup):
    """A node whose leaves hold more blocks than the backlog has room for
    (no tree of accel.wide, which allows a node 64): one root whose 16
    leaves own 24 blocks each (overlapping ranges of the soup's blocks),
    384 against a backlog of 256. What does not fit is tested at once, so
    closest hit and occlusion stay K1's / K2's bit for bit, and the plain
    version's where it is not borderline; the pipelined drain tests what
    the backlog could not take as a warp, and its own counts show every
    block of the node tested."""
    _, blocks, _, _ = soup
    blocks = blocks[:15 * 7 + 24].contiguous()
    nodes = torch.zeros((1, 16, 8))
    nodes[0, :, 0:3], nodes[0, :, 3:6] = -100.0, 100.0
    meta = -(torch.arange(16, dtype=torch.int32) * 7 * 32 + 24) - 2
    nodes[0, :, 6] = meta.float()
    with emulation:
        k1 = emu.trace_wide(RC, nodes, blocks, meta, False)
        k2 = emu.trace_wide(RA, nodes, blocks, meta, True)
        assert (k1[1] >= 0).sum() > 100 and (k2[1] > 0).sum() > 50
        assert emu.same_bits(
            emu.trace_wide(RC, nodes, blocks, meta, False, pipe=True), k1)
        assert emu.same_bits(
            emu.trace_wide(RA, nodes, blocks, meta, True, pipe=True), k2)
        tests = emu.trace_wide(RC, nodes, blocks, meta, False, count=True,
                               pipe=True)[1]
    assert int(tests.max()) == 384     # every block of the node, none lost
    _hold_to_plain(k1, pt.trace_wide_plain(RC, nodes, blocks, meta, False))


@pytest.mark.parametrize("n_c,n_a", [(1536, 1200), (700, 1200), (1536, 100),
                                     (0, 1200), (1536, 0)])
@pytest.mark.parametrize("mode", [dict(), dict(mt_precision="high"),
                                  dict(mt_precision="two_phase"),
                                  dict(stream=True),
                                  dict(mt_precision="default"),
                                  dict(mt_precision="high", stream=True),
                                  dict(mt_precision="default", stream=True)],
                         ids=lambda m: "+".join(m) or "fp32")
def test_emulated_paired_launch_is_k1_and_k2(emulation, soup, n_c, n_a, mode):
    """K8 in every mode, resident and streamed: each CTA runs its half's
    unpaired drain, so the closest half is the unpaired closest-hit mode
    at the tier (and stream) and the any-hit half K2, in every output's
    bits; either wave longer, or empty. At fp32, resident and streamed, the counting
    tables of both halves are the unpaired K1 / K6 closest and K2 drains'
    row for row, drain rounds and distinct blocks included (the warps hold
    the same rays)."""
    nodes, blocks, meta, _ = soup
    rc, ra = RC[:, :n_c].contiguous(), RA[:, :n_a].contiguous()
    if "mt_precision" in mode:
        mode = dict(mode, planes=pt.split_planes(blocks))
    stream = mode.get("stream", False)
    with emulation:
        got = emu.trace_wide_paired(rc, ra, nodes, blocks, meta, **mode)
        ref_c = emu.trace_wide(rc, nodes, blocks, meta, False, **mode)
        ref_a = emu.trace_wide(ra, nodes, blocks, meta, True, stream=stream)
        if "mt_precision" not in mode:
            cc, ca = emu.trace_wide_paired(rc, ra, nodes, blocks, meta,
                                           count=True, **mode)
            c1 = emu.trace_wide(rc, nodes, blocks, meta, False, count=True,
                                stream=stream)
            c2 = emu.trace_wide(ra, nodes, blocks, meta, True, count=True,
                                stream=stream)
    closest, occ = got
    assert emu.same_bits(closest, ref_c) and torch.equal(occ, ref_a[1])
    if "mt_precision" not in mode:
        assert torch.equal(cc, c1) and torch.equal(ca, c2)
        if n_c and n_a:
            _drain_counts_bracket(c1)
            _drain_counts_bracket(c2)


def test_emulated_profile_modes_do_what_they_must(emulation, soup):
    nodes, blocks, meta, _ = soup
    with emulation:
        k1 = emu.trace_wide(RC, nodes, blocks, meta, False)
        k1c = emu.trace_wide(RC, nodes, blocks, meta, False, count=True)
        for any_hit, rays in ((False, RC), (True, RA)):
            for stream in (False, True):
                for prof in ("empty", "nomt"):
                    k = emu.trace_wide(rays, nodes, blocks, meta, any_hit,
                                       stream=stream, profile=prof)
                    p = pt.trace_wide_profile_plain(rays, nodes, blocks, meta,
                                                    any_hit, prof)
                    assert all(torch.equal(a, b) for a, b in zip(k, p))
        cnt = emu.trace_wide(RC, nodes, blocks, meta, False, profile="count")
        assert emu.same_bits((cnt[0], cnt[1], cnt[3]), (k1[0], k1[1], k1[3]))
        pops = cnt[2].int()       # the per-thread walk's pops, per ray
        nomt = emu.trace_wide(RC, nodes, blocks, meta, False, count=True,
                              profile="nomt")
        assert not nomt[1].any() and int(nomt[0].sum()) >= int(pops.sum())
        fix = emu.trace_wide(RC, nodes, blocks, meta, False, profile="fix64")
        short = pops <= 64
        assert short.all() and emu.same_bits(fix, k1)
        fixc = emu.trace_wide(RC, nodes, blocks, meta, False, count=True,
                              profile="fix64")
        with pytest.raises(RuntimeError, match="launch failed"):
            emu.trace_wide(RC, nodes, blocks, meta, False, count=True,
                           profile="count")     # no such instantiation
    # every walk here ends within 64 pops, so fix64 counts the per-thread
    # walk: count's pops, and K1's (warp-wide, queued) MT block tests; K1
    # pops no fewer nodes and fills the drain rows
    assert torch.equal(fixc[0], pops) and torch.equal(fixc[1:5], k1c[1:5])
    assert not fixc[5:].any() and (k1c[0] >= pops).all()


@pytest.fixture(scope="module")
def instanced_flat():
    from instanced_scenes import instanced_scene
    from platinum_tpu_torch.render.flatten import flatten_scene
    from platinum_tpu_torch.render.types import RenderSettings

    scene, cam = instanced_scene("platinum_tpu_torch")
    return flatten_scene(scene, cam, RenderSettings(
        width=16, height=16, instancing="on", tracer="packet"),
        accel_min_tris=1, device="cpu")


@pytest.fixture(scope="module")
def instanced(instanced_flat):
    flat = instanced_flat
    return (flat.wbvh_nodes.reshape(-1, 16, 8).contiguous(), flat.wbvh_tris,
            flat.wbvh_meta, flat.instances.feat)


def test_emulated_instanced_modes(emulation, instanced):
    """K3 against its plain version, and the streamed and pipelined walks
    over the two-level tree against K3 bit for bit, instance ids
    included."""
    nodes, blocks, meta, feat = instanced
    flat_ok = pt._single_block_leaves(meta)
    with emulation:
        k3 = emu.trace_wide(RC, nodes, blocks, meta, False, inst_feat=feat)
        a3 = emu.trace_wide(RA, nodes, blocks, meta, True, inst_feat=feat)
        for kw in (dict(stream=True), dict(pipe=True)) + (
                (dict(flat_walk=True),) if flat_ok else ()):
            k = emu.trace_wide(RC, nodes, blocks, meta, False, inst_feat=feat,
                               **kw)
            assert len(k) == 5 and emu.same_bits(k, k3), kw
            assert emu.same_bits(emu.trace_wide(RA, nodes, blocks, meta, True,
                                                inst_feat=feat, **kw), a3), kw
    p = pt.trace_wide_inst_plain(RC, nodes, blocks, meta, False, feat)
    _hold_to_plain(k3, p)
    same = (k3[1] >= 0) & (k3[1] == p[1])
    assert torch.equal(k3[4][same], p[4][same])


@pytest.fixture(scope="module")
def multi_block():
    """A soup whose leaves hold up to four blocks: one node's queue holds
    more than 16 blocks."""
    return emu.soup_tree(n_tris=3000, seed=5, leaf_cap=256)


def _drain_counts_bracket(counts):
    """The drain rows of a counting table: 0 < rounds <= distinct blocks
    <= MT block tests."""
    tests, rounds, distinct = (int(counts[r].sum()) for r in (1, 5, 6))
    assert 0 < rounds <= distinct <= tests


@pytest.mark.parametrize("tree", ["soup", "multi_block", "instanced"])
def test_emulated_warp_drain_over_pre_split_planes(emulation, soup,
                                                   multi_block, instanced,
                                                   tree):
    """The split kernel's planes are its plain version's in every bit, and
    the warp-wide "high" drain over them gives the per-thread code's
    results: on one-level trees, queues of more than 16 blocks included,
    those of the leaf-pair kernel run on every (ray, block) pair (hit set
    and t in every bit; id, u and v too except at exact-t ties between
    blocks, which the walk breaks by visiting order); on the instanced
    tree the plain version's, t to HIGH_T_RTOL and instance ids equal.
    The counting instantiation's drain rounds and distinct blocks bracket
    its tests."""
    nodes, blocks, meta, feat = (instanced if tree == "instanced" else
                                 {"soup": soup, "multi_block": multi_block}[
                                     tree][:3] + (None,))
    with emulation:
        planes = emu.split_planes(blocks)
        k4 = emu.trace_wide(RC, nodes, blocks, meta, False, inst_feat=feat,
                            mt_precision="high", planes=planes)
        counts = emu.trace_wide(RC, nodes, blocks, meta, False,
                                inst_feat=feat, mt_precision="high",
                                planes=planes, count=True)
        if feat is None:
            ref = kc.brute_closest(emu.stream_mt, RC, blocks, "high")
    assert torch.equal(planes.view(torch.int16),
                       pt.split_planes_plain(blocks).view(torch.int16))
    rows = meta.long().view(-1, 16)
    nb = torch.where(rows <= -2, (-rows - 2) & 31, 0).sum(1)
    assert int(nb.max()) > 16 or tree != "multi_block"
    _drain_counts_bracket(counts)
    hit = k4[1] >= 0
    assert hit.sum() > 100
    if feat is None:
        assert torch.equal(ref[1] >= 0, hit)
        assert emu.same_bits((k4[0][hit],), (ref[0][hit],))
        keep = hit & ~ref[4]
        assert keep.sum() > 100
        assert torch.equal(k4[1][keep], ref[1][keep])
        assert emu.same_bits((k4[2][keep], k4[3][keep]),
                             (ref[2][keep], ref[3][keep]))
    else:
        p = pt.trace_wide_inst_plain(RC, nodes, blocks, meta, False, feat,
                                     mt_precision="high")
        _hold_to_plain(k4, p, rtol=HIGH_T_RTOL, atol=0.0)
        same = hit & (k4[1] == p[1])
        assert torch.equal(k4[4][same], p[4][same])


def _ragged_wave(rays=RC):
    """1,013 rays (not a multiple of 32), every fifth one dead (tmax below
    tmin): dead lanes inside warps and a last warp past the wave."""
    rays = rays[:, :1013].clone()
    rays[7, ::5] = rays[6, ::5] - 1.0
    return rays


@pytest.mark.parametrize("tree", ["soup", "multi_block", "ragged",
                                  "instanced", "instanced_ragged"])
def test_emulated_fp32_drain_is_the_leaf_pair_oracle(emulation, soup,
                                                     multi_block, instanced,
                                                     tree):
    """K1 and K6 closest (stream=True), and on the instanced tree K3
    closest and its streamed mode, take the warp-wide drain over the fp32
    blocks. On one tree level, hit set and t in every bit those of the
    leaf-pair kernel's per-pair test on every (ray, block) pair
    (`kc.brute_closest`), id, u and v too outside exact-t ties between
    blocks; on the instanced scene (ten lanes forming each drained ray's
    object features) K3 is held to its plain version and its instance ids
    where the ids agree. K6 and K9 (`pipe=True`) give K1's / K3's every
    output, the instance id included, in every bit; on the soup, on a tree
    whose nodes queue more than 16 blocks and on ragged waves with dead
    lanes. The counting instantiation fills the drain rows (0 < rounds <=
    distinct blocks <= tests), the same with and without streamed blocks;
    on one level it tests the blocks of the per-thread classic walk
    (`profile="fix64"`'s count, where every walk ends within 64 pops; no
    fewer than the pipelined drain, which drops stale backlog entries), on
    the instanced tree it enters instances."""
    feat = None
    if tree.startswith("instanced"):
        nodes, blocks, meta, feat = instanced
    else:
        nodes, blocks, meta, _ = multi_block if tree == "multi_block" else soup
    rays = _ragged_wave() if tree.endswith("ragged") else RC
    with emulation:
        k1, k6, k9 = (emu.trace_wide(rays, nodes, blocks, meta, False,
                                     inst_feat=feat, **kw)
                      for kw in (dict(), dict(stream=True), dict(pipe=True)))
        c1, c6 = (emu.trace_wide(rays, nodes, blocks, meta, False,
                                 inst_feat=feat, count=True, stream=stream)
                  for stream in (False, True))
        if feat is None:
            c9, cf = (emu.trace_wide(rays, nodes, blocks, meta, False,
                                     count=True, **kw)
                      for kw in (dict(pipe=True), dict(profile="fix64")))
            ref = kc.brute_closest(emu.stream_mt, rays, blocks, "highest")
        else:
            whole = emu.trace_wide(RC, nodes, blocks, meta, False,
                                   inst_feat=feat)
    assert emu.same_bits(k6, k1) and emu.same_bits(k9, k1)
    hit = k1[1] >= 0
    enough = 100 if feat is None else 50    # the instanced scene is small
    assert hit.sum() > enough
    if tree.endswith("ragged"):
        dead = rays[7] < rays[6]
        assert not hit[dead].any() and (hit & ~dead).sum() > enough
        assert emu.same_bits((k1[0][dead],), (rays[7][dead],))
    assert torch.equal(c1, c6)
    _drain_counts_bracket(c1)
    if feat is not None:
        assert len(k1) == 5 and len(torch.unique(k1[4][hit])) > 1
        assert int(c1[2].sum()) > 0 and not c1[3:5].any()
        # the whole wave against the plain version; a ragged wave's live
        # rays get the whole wave's results
        p = pt.trace_wide_inst_plain(RC, nodes, blocks, meta, False, feat)
        _hold_to_plain(whole, p)
        same = (whole[1] >= 0) & (whole[1] == p[1])
        assert torch.equal(whole[4][same], p[4][same])
        live = rays[7] >= rays[6]
        assert emu.same_bits([x[:rays.shape[1]][live] for x in whole],
                             [x[live] for x in k1])
        return
    assert torch.equal(ref[1] >= 0, hit)
    assert emu.same_bits((k1[0][hit],), (ref[0][hit],))
    keep = hit & ~ref[4]
    assert keep.sum() > 100 and torch.equal(k1[1][keep], ref[1][keep])
    assert emu.same_bits((k1[2][keep], k1[3][keep]),
                         (ref[2][keep], ref[3][keep]))
    assert int(cf[0].max()) < 64
    assert torch.equal(c1[1], cf[1]) and (c1[0] >= cf[0]).all()
    assert int(c1[1].sum()) >= int(c9[1].sum()) > 0


@pytest.mark.parametrize("tree", ["soup", "multi_block", "ragged"])
def test_emulated_paired_any_half_is_k2s_drain(emulation, soup, multi_block,
                                               tree):
    """K8's any-hit half alone (an empty closest-hit wave, so n_split = 0)
    runs K2's any-hit drain: every output in every bit and the whole
    counting table, drain rows included, resident and streamed."""
    nodes, blocks, meta, _ = multi_block if tree == "multi_block" else soup
    rays = _ragged_wave(RA) if tree == "ragged" else RA
    empty = rays[:, :0].contiguous()
    with emulation:
        for stream in (False, True):
            got = emu.trace_wide(rays, nodes, blocks, meta, True,
                                 stream=stream)
            c = emu.trace_wide(rays, nodes, blocks, meta, True, count=True,
                               stream=stream)
            occ = emu.trace_wide_paired(empty, rays, nodes, blocks, meta,
                                        stream=stream)[1]
            c8 = emu.trace_wide_paired(empty, rays, nodes, blocks, meta,
                                       stream=stream, count=True)[1]
            assert emu.same_bits(got, (rays[7], occ, torch.zeros_like(
                rays[7]), torch.zeros_like(rays[7])))
            assert torch.equal(c, c8) and not c[2:5].any()
            _drain_counts_bracket(c)
            assert (occ > 0).sum() > 50 and (occ < 0).sum() > 50


@pytest.mark.parametrize("tree", ["soup", "multi_block", "ragged",
                                  "instanced", "instanced_ragged"])
def test_emulated_any_hit_drain_is_k2(emulation, soup, multi_block,
                                      instanced, tree):
    """fp32 any hit without the octant order takes the warp-wide any-hit
    drain, with resident blocks (K2, K3 any hit) and streamed ones (K6
    any hit), the two giving the same outputs and counts in every bit.
    On one tree level its outputs are those of the per-thread classic walk
    bit for bit, reached through `profile="fix64"` where every walk ends
    within 64 pops (on the soup, on a tree whose nodes queue more than 16
    blocks and on a ragged wave with dead lanes); with the constant tmax
    as its node cull it pops that walk's nodes and tests its blocks, ray
    by ray, and fills the drain rows. On the instanced tree (ten lanes
    forming each drained ray's object features) its flag is the plain
    version's and its outputs K9 any hit's (`pipe=True`) bit for bit,
    whole and ragged; it enters instances, fills the drain rows and, on
    every ray nothing occludes, pops K9's nodes and tests its blocks."""
    feat = None
    if tree.startswith("instanced"):
        nodes, blocks, meta, feat = instanced
    else:
        nodes, blocks, meta, _ = multi_block if tree == "multi_block" else soup
    rays = _ragged_wave(RA) if tree.endswith("ragged") else RA
    with emulation:
        k2, k6 = (emu.trace_wide(rays, nodes, blocks, meta, True,
                                 inst_feat=feat, stream=stream)
                  for stream in (False, True))
        c2, c6 = (emu.trace_wide(rays, nodes, blocks, meta, True,
                                 inst_feat=feat, count=True, stream=stream)
                  for stream in (False, True))
        walk = dict(pipe=True) if feat is not None else dict(profile="fix64")
        ref, cref = (emu.trace_wide(rays, nodes, blocks, meta, True,
                                    inst_feat=feat, count=count, **walk)
                     for count in (False, True))
    assert emu.same_bits(k2, ref) and emu.same_bits(k6, k2)
    assert torch.equal(c6, c2)
    occluded = k2[1] > 0
    enough = 50 if feat is None else 20     # the instanced scene is small
    assert occluded.sum() > enough and (~occluded).sum() > enough
    if tree.endswith("ragged"):
        assert not occluded[rays[7] < rays[6]].any()
    _drain_counts_bracket(c2)
    assert not c2[3:5].any()
    if feat is None:
        assert int(cref[0].max()) < 64     # fix64 walked every ray whole
        assert torch.equal(c2[:2], cref[:2]) and not c2[2].any()
        assert not cref[2:].any()
    else:
        plain = pt.trace_wide_inst_plain(rays, nodes, blocks, meta, True,
                                         feat)
        assert torch.equal(k2[1], plain[1])
        assert int(c2[2].sum()) > 0
        # a ray that nothing occludes walks the whole tree under tmax, in
        # any order: the pipelined walk's pops and block tests
        free = ~occluded
        assert torch.equal(c2[:2, free], cref[:2, free])


@pytest.fixture(scope="module")
def dense():
    """A soup of 20,000 triangles in the same cube: deeper walks, whose
    backlogs hold entries a found hit has made stale."""
    return emu.soup_tree(n_tris=20000, seed=6)


def _tree(tree, soup, multi_block, instanced, instanced_flat, dense=None):
    """(nodes, blocks, meta, inst_feat, worder) of a named tree: the soup,
    the soup whose leaves hold up to four blocks, the dense soup, or the
    instanced scene (inst_feat None on one level)."""
    if tree.startswith("instanced"):
        return (*instanced, instanced_flat.wbvh_order)
    nodes, blocks, meta, worder = {"multi_block": multi_block,
                                   "dense": dense}.get(tree, soup)
    return nodes, blocks, meta, None, worder


def _drain_rows(counts, inst):
    """A drain's counting table: no refine test or re-walk, the drain rows
    filled; on two levels it enters instances (once per drained lane,
    instance and round)."""
    assert not counts[3:5].any()
    _drain_counts_bracket(counts)
    assert (int(counts[2].sum()) > 0) == inst


@pytest.mark.parametrize("tree", ["soup", "multi_block", "ragged",
                                  "streamed", "instanced",
                                  "instanced_ragged", "instanced_streamed"])
def test_emulated_oct_order_drain_is_the_leaf_pair_oracle_and_k1(
        emulation, soup, multi_block, instanced, instanced_flat, tree):
    """K7, fp32 closest hit under the octant order, takes the fp32 drain
    (each lane's queue drained newest first), resident and streamed, on
    one tree level and two. On one level its hit set and t are the
    leaf-pair kernel's on every (ray, block) pair (`kc.brute_closest`) in
    every bit, its ids too outside exact-t ties; against K1 / K3 its t
    and hit set are equal in every bit, and every output, the instance id
    included, wherever the ids agree (elsewhere two blocks tie at t: the
    near-first order visits another first); on the soup, on a tree whose
    nodes queue more than 16 blocks, on the instanced scene and on ragged
    waves with dead lanes. The near-first order is not the slot order:
    its counts differ from K1's."""
    nodes, blocks, meta, feat, worder = _tree(tree, soup, multi_block,
                                              instanced, instanced_flat)
    rays = _ragged_wave() if tree.endswith("ragged") else RC
    kw = dict(inst_feat=feat, worder=worder, stream=tree.endswith("streamed"))
    with emulation:
        k7 = emu.trace_wide(rays, nodes, blocks, meta, False, **kw)
        c7 = emu.trace_wide(rays, nodes, blocks, meta, False, count=True, **kw)
        k1 = emu.trace_wide(rays, nodes, blocks, meta, False, inst_feat=feat)
        c1 = emu.trace_wide(rays, nodes, blocks, meta, False, count=True,
                            inst_feat=feat)
        if feat is None:
            ref = kc.brute_closest(emu.stream_mt, rays, blocks, "highest")
    _drain_rows(c7, feat is not None)
    hit = k7[1] >= 0
    assert hit.sum() > (50 if feat is not None else 100)
    if tree.endswith("ragged"):
        assert not hit[rays[7] < rays[6]].any()
    assert len(k7) == len(k1) and torch.equal(k1[1] >= 0, hit)
    assert emu.same_bits((k7[0],), (k1[0],))
    same = k7[1] == k1[1]
    assert same.float().mean() > 0.99
    assert emu.same_bits([x[same] for x in k7], [x[same] for x in k1])
    if feat is None:
        assert torch.equal(ref[1] >= 0, hit)
        assert emu.same_bits((k7[0][hit],), (ref[0][hit],))
        keep = hit & ~ref[4]
        assert keep.sum() > 100 and torch.equal(k7[1][keep], ref[1][keep])
        assert emu.same_bits((k7[2][keep], k7[3][keep]),
                             (ref[2][keep], ref[3][keep]))
    assert not torch.equal(c7[:2], c1[:2])     # another order than K1's


@pytest.mark.parametrize("tree", ["soup", "multi_block", "ragged",
                                  "instanced", "dense"])
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("walk", ["pipe", "flat_walk"])
def test_emulated_pipelined_drain_is_k1_and_k2(
        emulation, soup, multi_block, instanced, instanced_flat, dense, walk,
        any_hit, tree):
    """K9, closest and any hit, with and without the flat push, takes the
    pipelined drain: every lane keeps its ray's pipelined schedule and the
    warp tests up to kPipeDrain of each lane's backlog entries a round.
    Every output (t, id, u, v, instance, occlusion flag) is K1's / K2's
    (K3's and K3 any hit's on the instanced tree) in every bit, and the
    drain rows are filled; on the soup, on a tree whose leaves hold up to
    four blocks (which the flat push refuses), on a ragged wave with dead
    lanes, on the instanced scene and on a dense soup, where a hit makes
    backlog entries stale that still count as one of their lane's
    kPipeDrain."""
    nodes, blocks, meta, feat, _ = _tree(tree, soup, multi_block, instanced,
                                         instanced_flat, dense)
    rays = RA if any_hit else RC
    if tree == "ragged":
        rays = _ragged_wave(rays)
    kw = dict(inst_feat=feat, **{walk: True})
    with emulation:
        if walk == "flat_walk" and not pt._single_block_leaves(meta):
            with pytest.raises(ValueError, match="exactly one MT block"):
                emu.trace_wide(rays, nodes, blocks, meta, any_hit, **kw)
            assert tree == "multi_block"
            return
        k9 = emu.trace_wide(rays, nodes, blocks, meta, any_hit, **kw)
        c9 = emu.trace_wide(rays, nodes, blocks, meta, any_hit, count=True,
                            **kw)
        k1 = emu.trace_wide(rays, nodes, blocks, meta, any_hit,
                            inst_feat=feat)
    assert emu.same_bits(k9, k1) and len(k9) == len(k1)
    _drain_rows(c9, feat is not None)
    hit = k9[1] >= 0 if not any_hit else k9[1] > 0
    assert hit.sum() > (20 if feat is not None else 50)
    if tree == "ragged":
        assert not hit[rays[7] < rays[6]].any()


@pytest.mark.parametrize("tree", ["soup", "multi_block"])
def test_replayed_walk_is_emulated_k4(emulation, soup, multi_block, tree):
    """chip_smoke.py's `_replay_walk` (3j's certificate: K4's walk for one
    ray, one thread's way, on the host, each block tested by K15) gives
    the emulated K4 "high"'s t, id and barycentrics in every bit, hits
    and misses alike."""
    import chip_smoke

    nodes, blocks, meta, _ = {"soup": soup, "multi_block": multi_block}[tree]
    rays = RC[:, :256].contiguous()
    one = torch.zeros(1, dtype=torch.int32)
    with emulation:
        k4 = emu.trace_wide(rays, nodes, blocks, meta, False,
                            mt_precision="high",
                            planes=pt.split_planes(blocks))
        got = []
        for i in range(rays.shape[1]):
            ray = rays[:, i:i + 1].contiguous()

            def test_block(b, best, ray=ray):
                limit = torch.tensor([best], dtype=torch.float32)
                out = emu.stream_mt(ray, limit, one, one + b, blocks, False,
                                    "high")
                return [x.item() for x in out]

            got.append(chip_smoke._replay_walk(ray[:, 0].double().numpy(),
                                               nodes.numpy(), meta.numpy(),
                                               test_block))
    t, sid, u, v = (np.array(c) for c in zip(*got))
    assert (sid >= 0).sum() > 50
    assert np.array_equal(sid, k4[1].numpy())
    for a, b in ((t, k4[0]), (u, k4[2]), (v, k4[3])):
        assert np.array_equal(a.astype(np.float32).view(np.int32),
                              b.numpy().view(np.int32))


@pytest.mark.parametrize("tier", ["highest", "high", "default"])
def test_emulated_stream_mt_matches_plain_version(emulation, soup, tier):
    """K15 on every level's real pairs, closest and any hit."""
    nodes, blocks, meta, _ = soup
    wn = nodes.reshape(-1, 128)
    for any_hit, rays in ((False, RC), (True, RA)):
        calls = []

        def capture(*args):
            calls.append(args[:4])
            return rs.stream_mt_plain(*args)

        pair = rs.make_stream_tracer(wn, blocks, meta, mt_precision=tier,
                                     mt_fn=capture)
        pair[int(any_hit)](rays[0:3].T, rays[3:6].T, 1e-3, rays[7])
        assert sum(c[2].shape[0] for c in calls) > rays.shape[1]
        for wave, limit, pair_ray, pair_block in calls:
            with emulation:
                k = emu.stream_mt(wave, limit, pair_ray, pair_block, blocks,
                                  any_hit, tier)
            p = rs.stream_mt_plain(wave, limit, pair_ray, pair_block, blocks,
                                   any_hit, tier)
            hk, hp = k[1] >= 0, p[1] >= 0
            assert (hk == hp).float().mean() > 0.995
            if any_hit:
                continue
            both = hk & hp
            same = k[1][both] == p[1][both]
            tie = torch.isclose(k[0][both], p[0][both], rtol=1e-5, atol=1e-6)
            assert (same | tie).all()
            rtol, atol = ((HIGH_T_RTOL, 0.0) if tier == "high"
                          else (1e-4, 1e-5))
            torch.testing.assert_close(k[0][both][same], p[0][both][same],
                                       rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def level_pairs(soup):
    """The largest level's (ray, block) pairs of the ray-stream tracer on
    the soup, per mode: (wave, limit, pair cases)."""
    nodes, blocks, meta, _ = soup
    out = {}
    for any_hit, rays in ((False, RC), (True, RA)):
        calls = []

        def capture(*args):
            calls.append(args[:4])
            return rs.stream_mt_plain(*args)

        pair = rs.make_stream_tracer(nodes.reshape(-1, 128), blocks, meta,
                                     mt_fn=capture)
        pair[int(any_hit)](rays[0:3].T, rays[3:6].T, 1e-3, rays[7])
        wave, limit, pair_ray, pair_block = max(
            calls, key=lambda c: c[2].shape[0])
        out[any_hit] = (wave, limit, kc.pair_cases(
            pair_ray, pair_block, wave.shape[1], blocks.shape[0]))
    return out


@pytest.mark.parametrize("case", ["real", "cross_chunk", "single",
                                  "one_block", "padding", "tied"])
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("tier", ["highest", "high", "default"])
def test_emulated_chunked_stream_mt_is_its_single_pair_path(
        emulation, soup, level_pairs, tier, any_hit, case):
    """The chunked K15 (each block staged once per CTA, R pairs a thread,
    a last round's tasks split over up to 16 threads) gives the t, slot,
    u and v in every bit that the same kernel gives the same pairs when
    every chunk takes its per-pair path (`test_pair`, one thread a pair:
    each pair followed by a padding pair, so that every run holds one
    pair): on the soup's real pairs, runs longer than a chunk, runs of one
    pair, one block for every pair, padding and ids out of range, and the
    long runs against blocks whose every hit has an exact-t twin in the
    other half (the lower slot wins, also across the lanes of a split
    task). Chunks of runs shorter than 32 pairs on average ("single", some
    of "real") take the per-pair path on both sides."""
    _, blocks, _, _ = soup
    wave, limit, cases = level_pairs[any_hit]
    pair_ray, pair_block = cases["cross_chunk" if case == "tied" else case]
    if case == "tied":
        blocks = kc.tied_blocks(blocks)
    ray1, block1 = kc.one_pair_runs(pair_ray, pair_block, blocks.shape[0])
    assert not kc.chunks_staged(block1).any()
    staged = kc.chunks_staged(pair_block)
    if case in ("cross_chunk", "one_block", "tied"):
        assert staged[:-1].all()     # a last chunk may hold a few pairs
    elif case == "single":
        assert not staged.any()
    with emulation:
        k = emu.stream_mt(wave, limit, pair_ray, pair_block, blocks, any_hit,
                          tier)
        p = emu.stream_mt(wave, limit, ray1, block1, blocks, any_hit, tier)
    assert (p[1][1::2] == -1).all()
    assert emu.same_bits(k, [x[0::2] for x in p])
    assert (k[1] >= 0).sum() > (10 if case == "single" else 100)
    if case == "padding":
        dead = ((pair_block < 0) | (pair_block >= blocks.shape[0])
                | (pair_ray < 0) | (pair_ray >= wave.shape[1]))
        assert dead.sum() > 600 and (k[1][dead] == -1).all()


@pytest.mark.parametrize("case", kc.PREFIX_CASES)
def test_emulated_level_prefix_is_its_plain_version(emulation, case):
    """The redesigned K11 (a scan block with every item in registers,
    then a grid of fill warps) writes bf_prefix_plain's distinct nodes,
    offsets, regions, unit tables, every lane of the pair lists and the
    status row, in every bit: on a level of 5,000 units and 1,300
    distinct nodes (five passes of the scan, 264 fill blocks), the same
    with both capacities at half its need, an empty level, and regions of
    exactly 128 lanes."""
    lv = kc.prefix_level(case)
    got, ref = kc.prefix_buffers(lv), kc.prefix_buffers(lv)
    with emulation:
        k = bf.prefix_kernel(*kc.prefix_args(lv, got))
    p = bf.bf_prefix_plain(*kc.prefix_args(lv, ref))
    assert kc.same_prefix(k, got, p, ref, int(lv["level"][0])) == []
    stat = got[3].tolist()
    if case == "overflow":
        assert stat[bf.LOST] > 0 and stat[bf.NEED_NEXT] > stat[bf.NEXT]
    elif case == "empty":
        assert stat == [0, 37, 0, 0, 37, 0, 0, 0]
    else:
        assert stat[bf.LOST] == 0 and stat[bf.DISTINCT] > 250
    if case == "exact128":
        assert (got[0] != -1).all() and (got[1] != -1).all()
    elif case != "empty":
        assert (got[0] == -1).sum() > 1000 and (got[1] == -1).sum() > 1000


@pytest.mark.parametrize("tier", ["highest", "high"])
def test_emulated_stream_tracer_is_the_packet_tracer_bit_for_bit(
        emulation, soup, tier):
    """Both kernels include csrc/mt_block.cuh, so the breadth-first tracer
    gives the depth-first one's hit set, t, ids and barycentrics in every
    bit, at "highest" and at "high"; occlusion equals K2's at "highest"
    (the ray-stream tracer's any hit runs at the tier, K2 at fp32)."""
    nodes, blocks, meta, _ = soup
    with emulation:
        pair = rs.make_stream_tracer(nodes.reshape(-1, 128), blocks, meta,
                                     mt_precision=tier, mt_fn=emu.stream_mt)
        rec = pair[0](RC[0:3].T, RC[3:6].T, 1e-3, float("inf"))
        occ = pair[1](RA[0:3].T, RA[3:6].T, 1e-3, RA[7])
        k1 = emu.trace_wide(RC, nodes, blocks, meta, False, mt_precision=tier,
                            planes=pt.split_planes(blocks))
        k2 = emu.trace_wide(RA, nodes, blocks, meta, True)
    hit = k1[1] >= 0
    assert torch.equal(rec.hit, hit) and hit.sum() > 100
    assert emu.same_bits((rec.t[hit], rec.tri[hit], rec.bary[hit, 0],
                          rec.bary[hit, 1]),
                         (k1[0][hit], k1[1][hit], k1[2][hit], k1[3][hit]))
    if tier == "highest":
        assert torch.equal(occ, k2[1] > 0)


def _bf_levels(steps, soup, tier, any_hit, rays, **kw):
    nodes, blocks, meta, _ = soup
    pair = bf.make_bf_tracer(nodes.reshape(-1, 128), blocks, meta,
                             mt_precision=tier, seg_rays=1024, steps=steps,
                             **kw)
    return pair[int(any_hit)].with_levels(rays[0:3].T, rays[3:6].T, 1e-3,
                                          rays[7])


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("tier", ["highest", "high", "default"])
def test_emulated_bf_kernels_are_the_plain_versions(emulation, soup, tier,
                                                    any_hit):
    """Every level's status row, masks, counts, distinct nodes, offsets,
    regions, unit tables and pair lanes, the MT list and K13's results,
    and the traced result, in every bit."""
    rays = RA if any_hit else RC
    before = dict(bf.LAUNCHES)
    with emulation:
        res, segs = _bf_levels(emu.BF_STEPS, soup, tier, any_hit, rays)
    assert bf.LAUNCHES == before
    ref, refs = _bf_levels(None, soup, tier, any_hit, rays)
    assert len(segs) == len(refs) == 2
    for sk, sp in zip(segs, refs):
        assert torch.equal(sk["stat"], sp["stat"])
        for lvl, (a, b) in enumerate(zip(sk["levels"][:-1],
                                         sp["levels"][:-1])):
            n = int(sk["stat"][lvl, bf.NEXT])
            nd = int(sk["stat"][lvl + 1, bf.DISTINCT])
            for key in ("units", "pairs", "masks", "counts", "dn", "uoff"):
                assert torch.equal(a[key][:n], b[key][:n]), (lvl, key)
            assert torch.equal(a["base"][:nd * 16], b["base"][:nd * 16])
        a, b = sk["levels"][-1], sp["levels"][-1]
        k = int(sk["stat"][-1, bf.MT_CUR])
        assert k > 0
        assert torch.equal(a["mt_units"][:k], b["mt_units"][:k])
        assert torch.equal(a["mt_pairs"][:k * 128], b["mt_pairs"][:k * 128])
        assert emu.same_bits([x[:k * 128] for x in a["mt"]],
                             [x[:k * 128] for x in b["mt"]])
    if any_hit:
        assert torch.equal(res, ref) and res.sum() > 50
    else:
        assert emu.same_bits((res.t, res.tri, res.bary),
                             (ref.t, ref.tri, ref.bary))


@pytest.mark.parametrize("tier", ["highest", "high"])
def test_emulated_bf_tracer_is_the_packet_tracer_bit_for_bit(emulation, soup,
                                                             tier):
    """K13 includes csrc/mt_block.cuh as K1 does: the breadth-first
    tracer's hit set, t, ids and barycentrics are K1's in every bit; its
    any hit at "highest" is K2's."""
    nodes, blocks, meta, _ = soup
    with emulation:
        rec, _ = _bf_levels(emu.BF_STEPS, soup, tier, False, RC)
        occ, _ = _bf_levels(emu.BF_STEPS, soup, "highest", True, RA)
        k1 = emu.trace_wide(RC, nodes, blocks, meta, False, mt_precision=tier,
                            planes=pt.split_planes(blocks))
        k2 = emu.trace_wide(RA, nodes, blocks, meta, True)
    hit = k1[1] >= 0
    assert torch.equal(rec.hit, hit) and hit.sum() > 100
    assert emu.same_bits((rec.t[hit], rec.tri[hit], rec.bary[hit, 0],
                          rec.bary[hit, 1]),
                         (k1[0][hit], k1[1][hit], k1[2][hit], k1[3][hit]))
    assert torch.equal(occ, k2[1] > 0)


@pytest.fixture(scope="module")
def mt_lists(soup):
    """The soup's real MT lists (plain versions, first segment), per mode:
    (ray table, mt_pairs, mt_units, count, level records, status rows)."""
    out = {}
    for any_hit, rays in ((False, RC), (True, RA)):
        _, segs = _bf_levels(None, soup, "highest", any_hit, rays)
        seg = segs[0]
        rec = seg["levels"][-1]
        out[any_hit] = (seg["rays"], rec["mt_pairs"], rec["mt_units"],
                        int(seg["stat"][-1, bf.MT_CUR]), seg["levels"],
                        seg["stat"])
    return out


SENTINEL = -7


def _filled(kernel, n_lanes, *args):
    """bf_stream.cu's entry `bf_<kernel>_launch(*args, t, sid, u, v)`
    into outputs of n_lanes filled with SENTINEL, so that a lane the
    kernel does not write shows."""
    out = (torch.full((n_lanes,), float(SENTINEL)),
           torch.full((n_lanes,), SENTINEL, dtype=torch.int32),
           torch.full((n_lanes,), float(SENTINEL)),
           torch.full((n_lanes,), float(SENTINEL)))
    bf._launch(kernel, torch.device("cpu"), *args, *out)
    return out


def _mt_filled(pairs, units, count, rays, blocks, any_hit, tier):
    level = torch.zeros(8, dtype=torch.int32)
    level[bf.MT_CUR] = count
    cap = units.shape[0]
    return _filled("mt", cap * 128, pairs, units, level, cap, rays,
                   rays.shape[1], blocks, blocks.shape[0], int(any_hit),
                   pt.PRECISIONS[tier])


@pytest.mark.parametrize("case", kc.MT_CASES)
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("tier", ["highest", "high", "default"])
def test_emulated_bf_mt_is_its_plain_version_and_k15(emulation, soup,
                                                     mt_lists, tier, any_hit,
                                                     case):
    """The redesigned K13 (CTAs over ranges of tiles, a tile's live lanes
    R a thread, split over lanes where few, blocks staged a tile ahead)
    writes bf_mt_plain's t, slot id, u and v in every bit over every lane
    of the tiles below the count, and nothing past it, and K15's on the
    same (ray, block) pairs (both run mt_chunk.cuh's task test): on the
    soup's real MT list, a full tile, tiles of 1, 2 and 33 live lanes,
    a region of several tiles of one block, tiles of alternating blocks,
    dead lanes and block ids out of range, and blocks whose every hit has
    an exact-t twin in their other half (the lower slot wins across the
    lanes of a split task)."""
    _, blocks, _, _ = soup
    rays, mt_pairs, mt_units, n = mt_lists[any_hit][:4]
    pairs, units, count = kc.mt_cases(mt_pairs, mt_units, n, rays.shape[1],
                                      blocks.shape[0])[case]
    if case == "tied":
        blocks = kc.tied_blocks(blocks)
    args = (pairs, units, count, rays, blocks, any_hit, tier)
    with emulation:
        k = _mt_filled(*args)
        k15 = kc.k15_of_tiles(emu.stream_mt, *args)
    lanes = count * 128
    assert emu.same_bits([x[:lanes] for x in k], k15)
    assert (k[1][:lanes] != SENTINEL).all()
    assert (k[1][lanes:] == SENTINEL).all()
    level = torch.zeros(8, dtype=torch.int32)
    level[bf.MT_CUR] = count
    ref = bf.bf_mt_plain(pairs, units, level, rays, blocks, any_hit, tier)
    assert emu.same_bits([x[:lanes] for x in k], [x[:lanes] for x in ref])
    assert (k[1][:lanes] >= 0).sum() > 0


@pytest.mark.parametrize("case", ["closest", "any", "synthetic"])
def test_emulated_bf_bwd_is_its_plain_version(emulation, mt_lists, case):
    """The redesigned K14 (CTAs striding over the units, every selected
    child's (t, slot id) gathered at once, u and v for the winner alone,
    ranks from one prefix of packed warp counts) writes bf_bwd_plain's
    results in every bit on every level of the soup's closest and any-hit
    waves, deepest first, and on a synthetic level (every child selected,
    none, inner and MT children mixed, equal t under different slot ids),
    and nothing past the count."""
    if case == "synthetic":
        lv = kc.bwd_level()
        steps = [(lv["masks"], lv["level"], lv["dn"], lv["uoff"],
                  lv["base"], lv["child"], lv["mt"])]
    else:
        rays, mt_pairs, mt_units, _, levels, stat = mt_lists[case == "any"]
        mt = levels[-1]["mt"]
        steps, child = [], None
        for lvl in range(len(levels) - 2, -1, -1):
            rec = levels[lvl]
            args = (rec["masks"], stat[lvl], rec["dn"], rec["uoff"],
                    rec["base"])
            steps.append((*args, child, mt))
            child = bf.bf_bwd_plain(*args, child, mt)
    ties = 0
    for masks, level, dn, uoff, base, child, mt in steps:
        cap, n = masks.shape[0], int(level[bf.NEXT])
        args = (masks, level, cap, dn, uoff, base,
                *(mt if child is None else child), *mt)
        with emulation:
            k = _filled("bwd", cap * 128, *args)
        lanes = n * 128
        assert (k[1][lanes:] == SENTINEL).all()
        ref = bf.bf_bwd_plain(masks, level, dn, uoff, base, child, mt)
        assert emu.same_bits([x[:lanes] for x in k],
                             [x[:lanes] for x in ref])
        assert (k[1][:lanes] >= 0).sum() > 0
        ties += int((k[0][:lanes] == 1.0).sum())
    if case == "synthetic":
        assert (k[1][:4 * 128] >= 0).all()            # every child
        assert (k[1][4 * 128:8 * 128] == -1).all()    # none
        assert ties > 1000


@pytest.fixture(scope="module")
def real_levels(soup):
    """Every segment of the soup's closest and any-hit waves through the
    plain versions: (ray table, status rows, level records, MT capacity)
    per segment."""
    out = []
    for any_hit, rays in ((False, RC), (True, RA)):
        _, segs = _bf_levels(None, soup, "highest", any_hit, rays)
        out += [(seg["rays"], seg["stat"], seg["levels"],
                 seg["levels"][-1]["mt_units"].shape[0]) for seg in segs]
    return out


def _expand_filled(kernel, units, level, pairs, rays, nodes):
    """bf_stream.cu's entry `bf_<kernel>_launch` of K10 into masks and
    counts filled with SENTINEL."""
    cap = units.shape[0]
    masks = torch.full((cap, 128), SENTINEL, dtype=torch.int32)
    counts = torch.full((cap, 16), SENTINEL, dtype=torch.int32)
    bf._launch(kernel, torch.device("cpu"), units, level, cap, pairs, rays,
               rays.shape[1], nodes, nodes.shape[0], masks, counts)
    return masks, counts


@pytest.mark.parametrize("case", ["real", *kc.EXPAND_CASES])
def test_emulated_bf_expand_is_its_plain_version(emulation, soup,
                                                 real_levels, case):
    """The redesigned K10 (a block per unit, each lane's ray loaded with
    the node row, only the node's non-empty children tested) writes
    bf_expand_plain's masks and counts in every bit, and nothing past the
    count:
    on every level of the soup's closest and any-hit waves, a full level
    whose warps take several units each, a count far below the capacity,
    dead tiles and tiles of one live lane or of lanes 96-127 alone, ray
    and node ids out of range, zero direction components and empty-slot
    metas."""
    if case == "real":
        nodes = soup[0]
        steps = [(lv["units"], stat[lvl], lv["pairs"], rays, nodes)
                 for rays, stat, levels, _ in real_levels
                 for lvl, lv in enumerate(levels[:-1])]
    else:
        lv = kc.expand_level(case)
        steps = [(lv["units"], lv["level"], lv["pairs"], lv["rays"],
                  lv["nodes"])]
    hits = 0
    for step in steps:
        n = int(step[1][bf.NEXT])
        with emulation:
            k = _expand_filled("expand", *step)
        assert all((x[n:] == SENTINEL).all() for x in k)
        ref = bf.bf_expand_plain(*step)
        assert all(torch.equal(a[:n], b[:n]) for a, b in zip(k, ref))
        assert torch.equal(k[1][:n], torch.stack([
            ((k[0][:n] >> c) & 1).sum(1) for c in range(16)], 1).int())
        hits += int(k[1][:n].sum())
    assert hits > 500


def _emit_filled(kernel, pairs, masks, level, dn, uoff, base, next_lanes,
                 mt_lanes):
    """bf_stream.cu's entry `bf_<kernel>_launch` of K12 (or, for "plain",
    bf_emit_plain) into lists of next_lanes and mt_lanes entries filled
    with -2, as 3k's fresh buffers are."""
    out = (torch.full((next_lanes,), -2, dtype=torch.int32),
           torch.full((mt_lanes,), -2, dtype=torch.int32))
    args = (pairs, masks, level, dn, uoff, base, *out)
    if kernel == "plain":
        bf.bf_emit_plain(*args)
    else:
        bf._launch(kernel, torch.device("cpu"), pairs, masks, level,
                   pairs.shape[0], dn, uoff, base, *out)
    return out


@pytest.mark.parametrize("case", ["real", *kc.EMIT_CASES])
def test_emulated_bf_emit_is_its_plain_version(emulation, real_levels,
                                               case):
    """The redesigned K12 (a warp per unit on the CTAs the card holds,
    ranks from the warp's four ballots a child, the unit's offset and
    region rows in one load) writes bf_emit_plain's entries of both lists
    in every bit (every other entry left at -2): on every level of
    the soup's closest and any-hit waves, and on levels with every bit
    set, one child in lane 127 alone, regions in both lists, a region not
    taken between two taken, many units of one node and many units past
    the count."""
    if case == "real":
        steps = [(lv["pairs"], lv["masks"], stat[lvl], lv["dn"], lv["uoff"],
                  lv["base"], max(lv["cap_next"], 1) * 128, mt_cap * 128)
                 for _, stat, levels, mt_cap in real_levels
                 for lvl, lv in enumerate(levels[:-1])]
    else:
        lv = kc.emit_level(case)
        steps = [(lv["pairs"], lv["masks"], lv["level"], lv["dn"],
                  lv["uoff"], lv["base"], lv["next_lanes"], lv["mt_lanes"])]
    written = [0, 0]
    for step in steps:
        with emulation:
            k = _emit_filled("emit", *step)
        ref = _emit_filled("plain", *step)
        assert all(torch.equal(a, b) for a, b in zip(k, ref))
        written = [w + int((x != -2).sum()) for w, x in zip(written, k)]
    assert min(written) > 0 or case == "lane127"
    assert sum(written) > 0


def test_emulated_bf_tracer_retraces_an_overflow(emulation, soup,
                                                 monkeypatch):
    """With the capacities forced small the emulated kernels report the
    lost pairs and what each level needs, and the traces again give the
    unshrunk result."""
    ref, _ = _bf_levels(None, soup, "highest", False, RC)
    monkeypatch.setattr(bf, "PAIR_CAP_MULT", (1.0,) * 10)
    monkeypatch.setattr(bf, "CAP_SLACK_TILES", 0)
    with emulation:
        rec, segs = _bf_levels(emu.BF_STEPS, soup, "highest", False, RC)
    assert all(s["traces"] > 1 for s in segs)
    assert emu.same_bits((rec.t, rec.tri), (ref.t, ref.tri))


BROKEN = r"""
#include <cuda_runtime.h>
namespace {
__global__ void early_exit(int* out) {
  if (threadIdx.x < 16) return;     // these threads never reach the barrier
  __syncthreads();
  out[threadIdx.x] = 1;
}
__global__ void half_ballot(int* out) {
  if (threadIdx.x & 1) out[threadIdx.x] = __ballot_sync(0xffffffffu, 1);
}
__global__ void scan(int* out) {
  int x = threadIdx.x;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if ((int)(threadIdx.x & 31) >= o) x += y;
  }
  __syncthreads();
  out[threadIdx.x] = x + (int)__ballot_sync(0xffffffffu, threadIdx.x < 40);
}
}  // namespace
extern "C" int run(int which, int* out) {
  if (which == 0) early_exit<<<1, 64, 0, nullptr>>>(out);
  if (which == 1) half_ballot<<<1, 64, 0, nullptr>>>(out);
  if (which == 2) scan<<<2, 64, 0, nullptr>>>(out);
  return cudaGetLastError();
}
"""


def test_emulated_collectives_and_barrier_faults(emulation, tmp_path):
    """The cooperative scheduler computes warp shuffles and ballots for
    every lane, and a launch whose threads leave a barrier or a warp
    collective to part of the block reports an error, as the card would
    misbehave."""
    import ctypes

    emu._write_headers(str(tmp_path))
    lib = ctypes.CDLL(emu.compile_source("broken", BROKEN, str(tmp_path)))
    lib.run.argtypes = [ctypes.c_int, ctypes.c_void_p]
    out = torch.zeros(64, dtype=torch.int32)
    assert lib.run(0, out.data_ptr()) != 0
    assert lib.run(1, out.data_ptr()) != 0
    assert lib.run(2, out.data_ptr()) == 0
    lane = torch.arange(64) % 32
    ballot = torch.tensor([-1, 0xFF], dtype=torch.int64).repeat_interleave(32)
    expect = (torch.arange(64) - lane) * (lane + 1) + lane * (lane + 1) // 2
    assert torch.equal(out.long(), (expect + ballot).to(torch.int32).long())


SYNCWARP = r"""
#include <cuda_runtime.h>
namespace {
__global__ void exchange(int* out) {
  __shared__ int s[64];
  s[threadIdx.x] = threadIdx.x;
  __syncwarp();
  out[threadIdx.x] = s[threadIdx.x ^ 31];
}
__global__ void half_syncwarp(int* out) {
  if (threadIdx.x & 1) __syncwarp();
  out[threadIdx.x] = 1;
}
__global__ void mixed(int* out) {
  if (threadIdx.x & 1) __syncwarp();
  else out[threadIdx.x] = __ballot_sync(0xffffffffu, 1);
}
}  // namespace
extern "C" int run(int which, int* out) {
  if (which == 0) exchange<<<1, 64, 0, nullptr>>>(out);
  if (which == 1) half_syncwarp<<<1, 64, 0, nullptr>>>(out);
  if (which == 2) mixed<<<1, 64, 0, nullptr>>>(out);
  return cudaGetLastError();
}
"""


def test_emulated_syncwarp_is_a_warp_barrier(emulation, tmp_path):
    """`__syncwarp` releases a warp once all 32 lanes reach it (each lane
    then reads what another lane of its warp wrote before it), and a
    launch whose lanes leave it to part of the warp, or meet another
    collective there, reports an error."""
    import ctypes

    emu._write_headers(str(tmp_path))
    lib = ctypes.CDLL(emu.compile_source("syncwarp", SYNCWARP,
                                         str(tmp_path)))
    lib.run.argtypes = [ctypes.c_int, ctypes.c_void_p]
    out = torch.zeros(64, dtype=torch.int32)
    assert lib.run(0, out.data_ptr()) == 0
    lane = torch.arange(64)
    assert torch.equal(out.long(), lane - lane % 32 + (31 - lane % 32))
    assert lib.run(1, out.data_ptr()) != 0
    assert lib.run(2, out.data_ptr()) != 0


def test_host_source_rewrites_every_launch():
    """Every launch of every source is rewritten; and each function has
    one kernel: no source keeps a `*_per_*_launch` entry."""
    for name in emu.SOURCES:
        with open(os.path.join(pt.CSRC_DIR, name + ".cu")) as f:
            source = f.read()
        text = emu.host_source(source)
        assert "<<<" not in text and "asm volatile" not in text
        assert "emu_launch(" in text
        assert not re.search(r"\b\w+_per_\w+_launch\b", source)
    with pytest.raises(ValueError, match="no kernel launch"):
        emu.host_source("int main() { return 0; }")
