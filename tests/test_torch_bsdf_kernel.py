"""The BSDF kernel (csrc/bsdf_shade.cu) against the plain BSDF
(models/bsdf.py `sample_plain`, `evaluate_plain`).

On the CPU: `sample` and `evaluate` on CPU tensors are the plain functions
bit for bit; the feature mask gives each feature the BSDF reads its own
bit, the one the source reads; the wrapper refuses what the kernel does
not take; and the source itself, compiled for the host by
tools/torch_emulate_kernels.py, is held to the plain code. On the card
(marker `gpu`, skipped without a CUDA device): the kernel against the
plain functions run on the same CUDA tensors, every launch counted.

The cases are numpy-made lanes over rough and smooth materials, cosines
near MIN_COS and both hemispheres, under the feature sets of the
benchmark's cells (the colonnade's metallic scenes on the energy rows, the
helmet's smooth textured-roughness one on the LUTs), all of ALL_FEATURES
on the LUTs and on the rows, multiscatter and the mixture pdf each way.
This module imports no JAX."""

import dataclasses
import os
import re
import shutil
import sys
import tempfile

import numpy as np
import pytest
import torch

from platinum_tpu_torch.models import bsdf
from platinum_tpu_torch.ops import luts as luts_mod
from platinum_tpu_torch.ops import packet_trace as pt
from platinum_tpu_torch.utils import telemetry

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import torch_emulate_kernels as emu  # noqa: E402

FEATURE_SETS = {
    # sponza_class and bistro_class: metallic, the per-material rows
    "colonnade": frozenset({"area_lights", "metallic"}),
    # helmet_env: textured roughness, so the LUTs
    "helmet": frozenset({"env", "area_lights", "metallic", "smooth",
                         "tex_rough", "texslot0", "texslot1", "texslot4",
                         "texslot5"}),
    "all": bsdf.ALL_FEATURES,
    "all_rows": bsdf.ALL_FEATURES - {"tex_rough"},
}
SWITCHES = [(True, True), (True, False), (False, True), (False, False)]
READ = {"metallic", "transparent", "clearcoat", "smooth", "aniso", "thin",
        "tex_rough"}

# The kernel does the plain code's operations in its order, one rounding
# each (-fmad=false, IEEE division and square root), so it differs from the
# plain code by what sinf, cosf and sqrtf give on either side: an ulp or
# two (PyTorch's CPU sqrt is not correctly rounded; the host build's is).
# Both are held to the plain code run in float64 on the same inputs: the
# kernel's f, pdf and wi must lie within RTOL / ATOL of it on every lane.
# Where the function itself turns an ulp into more (near the
# visible-normal disk's rim, sqrt(1 - px^2); GGX near the smooth cutoff,
# D ~ 1 / alpha^2; a reflection leaving at grazing) no float32 code can:
# there the kernel may be SPREAD_K times as far from float64 as the plain
# float32 code is, on these inputs or on inputs moved by NUDGE (two ulps).
# At most ILL_SHARE of the lanes may need that where the plain float32
# code met RTOL / ATOL on these inputs. A branch that compares
# two values an ulp apart (rz < F, rw < p_coat, pdf <= 0) can go the
# other way on a lane at its threshold, and then all of that lane
# differs: flags may differ from the float32 plain code's on at most
# FLAG_SHARE of the lanes, and the lanes where any of the runs decides
# otherwise (the float64 ones included) are left out of the value check,
# at most UNSTABLE_SHARE of them.
RTOL, ATOL = 1e-5, 1e-6
NUDGE = 2.0 ** -22
NUDGES = 3
SPREAD_K = 4.0
ILL_SHARE = 2e-3
FLAG_SHARE = 1e-4
UNSTABLE_SHARE = 1e-3
_FLOAT_FIELDS = ("albedo", "emission", "roughness", "metallic",
                 "transmission", "ior", "anisotropy", "anisotropy_rotation",
                 "clearcoat", "clearcoat_roughness", "energy", "energy_avg",
                 "energy_avg_row")


def _case(n, seed, dev, features=bsdf.ALL_FEATURES):
    """(ctx, wo, wi, r4, rc): a ShadingContext whose fields are column
    views of (n, 16) packed rows, as make_shading_context makes them, of
    materials that give `features` (scene_features' rules: no smooth
    surface without "smooth", no metal without "metallic", ...), and
    directions with 10% of their cosines within 2e-4 of +-MIN_COS."""
    rng = np.random.default_rng(seed)
    row = np.zeros((n, 16), np.float32)
    row[:, 0:3] = rng.uniform(0, 1, (n, 3))
    row[:, 4:7] = rng.uniform(0, 2, (n, 3))
    rough = rng.uniform(0, 1, n)
    smooth = rng.random(n) < 0.2
    rough[smooth] = rng.uniform(0, 0.03, smooth.sum())
    rough[rng.random(n) < 0.02] = 0.0
    row[:, 7] = rough
    row[:, 8] = np.select([rng.random(n) < 0.3, rng.random(n) < 0.5],
                          [0.0, 1.0], rng.uniform(0, 1, n))
    row[:, 9] = np.select([rng.random(n) < 0.4, rng.random(n) < 0.5],
                          [0.0, 1.0], rng.uniform(0, 1, n))
    row[:, 10] = np.where(rng.random(n) < 0.15, rng.uniform(0.5, 1, n),
                          rng.uniform(1, 2.5, n))
    row[:, 11] = np.where(rng.random(n) < 0.5, 0.0, rng.uniform(-1, 1, n))
    row[:, 12] = rng.uniform(0, 1, n)
    row[:, 13] = np.where(rng.random(n) < 0.4, 0.0, rng.uniform(0, 1, n))
    coat_rough = rng.uniform(0, 1, n)
    smooth = rng.random(n) < 0.3
    coat_rough[smooth] = rng.uniform(0, 0.03, smooth.sum())
    row[:, 14] = coat_rough
    row[:, 15] = rng.integers(0, 8, n)       # anisotropic, emissive, thin
    if "smooth" not in features:
        row[:, 7] = np.maximum(row[:, 7], 0.04)
        row[:, 14] = np.maximum(row[:, 14], 0.04)
    for name, col in (("metallic", 8), ("transparent", 9), ("aniso", 11),
                      ("clearcoat", 13)):
        if name not in features:
            row[:, col] = 0.0
    if "thin" not in features:
        row[:, 15] = row[:, 15].astype(np.int64) & ~4
    m, k = 16, 32
    energy = rng.uniform(0.05, 1, (m, k, 6)).astype(np.float32)
    energy_avg = rng.uniform(0.05, 1, (m, 4)).astype(np.float32)
    idx = rng.integers(0, m, n)

    def dirs():
        d = rng.normal(0, 1, (n, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        near = np.nonzero(rng.random(n) < 0.1)[0]
        sign = np.where(rng.random(near.size) < 0.5, -1.0, 1.0)
        z = sign * (bsdf.MIN_COS + rng.uniform(-2e-4, 2e-4, near.size))
        z[::7] = sign[::7] * bsdf.MIN_COS      # on the gate itself
        s = np.sqrt((1 - z * z) / (d[near, 0] ** 2 + d[near, 1] ** 2))
        d[near, 0] *= s
        d[near, 1] *= s
        d[near, 2] = z
        return torch.from_numpy(d.astype(np.float32)).to(dev)

    row = torch.from_numpy(row).to(dev)
    energy_avg = torch.from_numpy(energy_avg).to(dev)
    idx = torch.from_numpy(idx).to(dev, torch.int32)
    ctx = bsdf.ShadingContext(
        albedo=row[:, 0:3], emission=row[:, 4:7], roughness=row[:, 7],
        metallic=row[:, 8], transmission=row[:, 9], ior=row[:, 10],
        anisotropy=row[:, 11], anisotropy_rotation=row[:, 12],
        clearcoat=row[:, 13], clearcoat_roughness=row[:, 14],
        flags=row[:, 15].to(torch.int32),
        energy=torch.from_numpy(energy).to(dev), energy_avg=energy_avg,
        mat_idx=idx, energy_avg_row=energy_avg[idx.long()])
    wo, wi = dirs(), dirs()
    r4 = torch.from_numpy(rng.random((n, 4)).astype(np.float32)).to(dev)
    rc = torch.from_numpy(rng.random((n, 2)).astype(np.float32)).to(dev)
    return ctx, wo, wi, r4, rc


def _nudged(inputs, k):
    """The float inputs, each element moved by NUDGE relative, up or down
    at random (seeded by k); k = 0 leaves them as they are."""
    if k == 0:
        return list(inputs)
    g = torch.Generator().manual_seed(k)
    return [t * (1.0 + NUDGE * (2.0 * torch.randint(
        0, 2, t.shape, generator=g).to(t.device, t.dtype) - 1.0))
        for t in inputs]


def _double(ctx, luts):
    ctx = dataclasses.replace(ctx, **{f: getattr(ctx, f).double()
                                      for f in _FLOAT_FIELDS})
    luts = luts_mod.Luts(**{f.name: getattr(luts, f.name).double()
                            for f in dataclasses.fields(luts)})
    return ctx, luts


def _gap(a, b):
    """|a - b| per lane and component, 0 where both are NaN, inf where
    one is."""
    d = (a - b).abs()
    d = torch.where(a.isnan() & b.isnan(), 0.0, d)
    return torch.where(a.isnan() != b.isnan(), float("inf"), d)


def _hold(got, plain, ctx, luts, inputs):
    """Hold a kernel result (BSDFSample or BSDFEval) to plain(ctx, luts,
    *inputs), on every lane, as the constants above say."""
    ctx64, luts64 = _double(ctx, luts)
    runs = []
    for k in range(NUDGES + 1):
        x = _nudged(inputs, k)
        runs.append((plain(ctx, luts, *x),
                     plain(ctx64, luts64, *[t.double() for t in x])))
    want, want64 = runs[0]
    n = want.pdf.shape[0]
    sampled = hasattr(want, "flags")
    if sampled:
        flags_off = got.flags != want.flags
        assert flags_off.sum() <= FLAG_SHARE * n, (
            f"flags differ on {int(flags_off.sum())} of {n} lanes")
        unstable = flags_off | (got.flags != want64.flags)
        for r32, r64 in runs:
            unstable |= r32.flags != r64.flags
    else:
        unstable = torch.zeros(n, dtype=torch.bool, device=want.pdf.device)
    assert unstable.sum() <= UNSTABLE_SHARE * n, (
        f"{int(unstable.sum())} of {n} lanes decided otherwise by a run")
    ill = torch.zeros_like(unstable)
    for name in (("wi", "f", "pdf") if sampled else ("f", "pdf")):
        b = getattr(want64, name).reshape(n, -1)
        spread = torch.zeros_like(b)
        for r32, r64 in runs:
            spread = torch.maximum(spread, _gap(
                getattr(r32, name).reshape(n, -1).double(),
                getattr(r64, name).reshape(n, -1)))
        err = _gap(getattr(got, name).reshape(n, -1).double(), b)
        tol = ATOL + RTOL * torch.nan_to_num(b.abs())
        strict = err <= tol
        bad = ~(strict | (err <= SPREAD_K * spread + tol))
        bad &= ~unstable[:, None]
        if bad.any():
            i = int(bad.any(-1).nonzero()[0, 0])
            raise AssertionError(
                f"{name}: {int(bad.any(-1).sum())} of {n} lanes off; lane "
                f"{i}: {getattr(got, name).reshape(n, -1)[i].tolist()} "
                f"against {b[i].tolist()} in float64, the float32 plain "
                f"code's spread {spread[i].tolist()}")
        # where the plain float32 code met the tolerance and the kernel
        # did not
        met = _gap(getattr(want, name).reshape(n, -1).double(), b) <= tol
        ill |= (~strict & met).any(-1) & ~unstable
    assert ill.sum() <= ILL_SHARE * n, (
        f"{int(ill.sum())} of {n} lanes held by the spread alone where the "
        f"plain float32 code needed none")


# ---------------------------------------------------------------------------
# On the CPU
# ---------------------------------------------------------------------------

def _bits_equal(a, b):
    return a.dtype == b.dtype and torch.equal(
        a.view(torch.int32) if a.dtype == torch.float32 else a,
        b.view(torch.int32) if b.dtype == torch.float32 else b)


@pytest.mark.parametrize("name", sorted(FEATURE_SETS))
def test_cpu_tensors_take_the_plain_code_bit_for_bit(name):
    feats = FEATURE_SETS[name]
    ctx, wo, wi, r4, rc = _case(2048, 5, "cpu", feats)
    luts = luts_mod.load_luts("cpu")
    before = dict(bsdf.LAUNCHES)
    telemetry.drain()
    telemetry.start()
    try:
        for ms, mix in SWITCHES:
            s = bsdf.sample(ctx, wo, r4, rc, luts, multiscatter=ms,
                            features=feats, mixture_pdf=mix)
            p = bsdf.sample_plain(ctx, wo, r4, rc, luts, multiscatter=ms,
                                  features=feats, mixture_pdf=mix)
            assert all(_bits_equal(getattr(s, k), getattr(p, k))
                       for k in ("wi", "f", "pdf", "flags"))
            e = bsdf.evaluate(ctx, wo, wi, luts, multiscatter=ms,
                              features=feats)
            q = bsdf.evaluate_plain(ctx, wo, wi, luts, multiscatter=ms,
                                    features=feats)
            assert _bits_equal(e.f, q.f) and _bits_equal(e.pdf, q.pdf)
        counters = telemetry.drain()["counters"]
    finally:
        telemetry.stop()
    assert bsdf.LAUNCHES == before
    # every lane seen, none shaded by the kernel
    assert counters.get("bsdf.lanes") == 2 * len(SWITCHES) * 2048
    assert "bsdf.kernel_lanes" not in counters


def test_feature_mask_gives_each_read_feature_its_own_bit():
    assert set(bsdf.FEATURE_BITS) == READ and READ <= bsdf.ALL_FEATURES
    bits = [bsdf.feature_mask({f}) for f in sorted(READ)]
    assert len(set(bits)) == len(bits)
    assert all(b > 0 and b & (b - 1) == 0 and b < bsdf.MODE_MULTISCATTER
               for b in bits)
    for f in READ:
        assert bsdf.mask_features(bsdf.feature_mask({f})) == {f}
    assert bsdf.mask_features(bsdf.feature_mask(bsdf.ALL_FEATURES)) == READ
    # the features the BSDF does not read have no bit
    assert bsdf.feature_mask(bsdf.ALL_FEATURES - READ) == 0
    switches = (bsdf.MODE_MULTISCATTER, bsdf.MODE_MIXTURE_PDF,
                bsdf.MODE_ROWS)
    assert len(set(switches)) == 3 and all(
        s & (s - 1) == 0 and s & bsdf.feature_mask(READ) == 0
        for s in switches)


def test_the_source_reads_the_same_bits():
    with open(os.path.join(pt.CSRC_DIR, "bsdf_shade.cu")) as f:
        text = f.read()
    consts = {k: int(v) for k, v in re.findall(r"\b(k\w+) = (\d+)\b", text)}
    names = {"metallic": "kMetallic", "transparent": "kTransparent",
             "clearcoat": "kClearcoat", "smooth": "kSmooth",
             "aniso": "kAniso", "thin": "kThin"}
    for feature, const in names.items():
        assert consts[const] == bsdf.FEATURE_BITS[feature]
    # tex_rough has no branch of its own: it turns the rows off
    assert "kTexRough" not in consts
    assert (consts["kMultiscatter"], consts["kMixturePdf"],
            consts["kRows"]) == (bsdf.MODE_MULTISCATTER,
                                 bsdf.MODE_MIXTURE_PDF, bsdf.MODE_ROWS)
    assert (consts["kReflected"], consts["kTransmitted"], consts["kDiffuse"],
            consts["kGlossy"], consts["kSpecular"], consts["kEmitted"]) == (
        bsdf.SAMPLE_REFLECTED, bsdf.SAMPLE_TRANSMITTED, bsdf.SAMPLE_DIFFUSE,
        bsdf.SAMPLE_GLOSSY, bsdf.SAMPLE_SPECULAR, bsdf.SAMPLE_EMITTED)


def test_rows_and_luts_choose_the_mode():
    ctx, *_ = _case(8, 1, "cpu")
    assert bsdf._mode(ctx, FEATURE_SETS["colonnade"], True, True) == (
        1 | bsdf.MODE_MULTISCATTER | bsdf.MODE_MIXTURE_PDF | bsdf.MODE_ROWS)
    # textured roughness reads the LUTs, as _use_rows says
    assert not bsdf._mode(ctx, FEATURE_SETS["helmet"], False) & (
        bsdf.MODE_ROWS | bsdf.MODE_MIXTURE_PDF | bsdf.MODE_MULTISCATTER)


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    ctx, wo, wi, r4, rc = _case(16, 2, "cpu")
    luts = luts_mod.load_luts("cpu")
    mode = bsdf._mode(ctx, FEATURE_SETS["colonnade"], True, True)
    with pytest.raises(TypeError, match="wo must be torch.float32"):
        bsdf._launch(0, ctx, wo.double(), r4, rc, luts, mode)
    with pytest.raises(ValueError, match="r4 must have shape"):
        bsdf._launch(0, ctx, wo, r4[:, :3], rc, luts, mode)
    with pytest.raises(ValueError, match="wo must be"):
        bsdf._launch(0, ctx, wo[None], r4, rc, luts, mode)
    with pytest.raises(TypeError, match="flags must be torch.int32"):
        bsdf._launch(0, dataclasses.replace(ctx, flags=ctx.flags.long()),
                     wo, r4, rc, luts, mode)
    with pytest.raises(TypeError, match="mat_idx must be torch.int32"):
        bsdf._launch(0, dataclasses.replace(ctx, mat_idx=ctx.mat_idx.long()),
                     wo, r4, rc, luts, mode)
    with pytest.raises(ValueError, match="needs the Luts"):
        bsdf._launch(1, ctx, wo, wi, None, None,
                     bsdf._mode(ctx, FEATURE_SETS["helmet"], True))


# ---------------------------------------------------------------------------
# The source on the host (tools/torch_emulate_kernels.py)
# ---------------------------------------------------------------------------

HOST_LANES = 16384


@pytest.fixture(scope="module")
def emulated():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernel source for the host")
    tmp = tempfile.mkdtemp(prefix="emulated_bsdf_")
    try:
        yield emu.Emulation(tmp, sources=("bsdf_shade",))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


_HOST_CASES = {}


def _host_case(name):
    if name not in _HOST_CASES:
        _HOST_CASES[name] = (_case(HOST_LANES, 11, "cpu", FEATURE_SETS[name]),
                             luts_mod.load_luts("cpu"))
    return _HOST_CASES[name]


@pytest.mark.parametrize("name", sorted(FEATURE_SETS))
@pytest.mark.parametrize("multiscatter,mixture_pdf", [(True, True),
                                                      (False, False)])
def test_emulated_sample_is_the_plain_sample(emulated, name, multiscatter,
                                             mixture_pdf):
    (ctx, wo, _, r4, rc), luts = _host_case(name)
    feats = FEATURE_SETS[name]
    with emulated:
        got = bsdf.BSDFSample(*bsdf._launch(
            0, ctx, wo, r4, rc, luts,
            bsdf._mode(ctx, feats, multiscatter, mixture_pdf)))
    _hold(got, lambda ctx, luts, wo, r4, rc: bsdf.sample_plain(
        ctx, wo, r4, rc, luts, multiscatter, feats, mixture_pdf), ctx, luts,
        [wo, r4, rc])


@pytest.mark.parametrize("name", sorted(FEATURE_SETS))
@pytest.mark.parametrize("multiscatter", [True, False])
def test_emulated_evaluate_is_the_plain_evaluate(emulated, name,
                                                 multiscatter):
    (ctx, wo, wi, _, _), luts = _host_case(name)
    feats = FEATURE_SETS[name]
    with emulated:
        got = bsdf.BSDFEval(*bsdf._launch(
            1, ctx, wo, wi, None, luts, bsdf._mode(ctx, feats, multiscatter)))
    _hold(got, lambda ctx, luts, wo, wi: bsdf.evaluate_plain(
        ctx, wo, wi, luts, multiscatter, feats), ctx, luts, [wo, wi])


def test_emulated_kernel_reads_fields_where_they_lie(emulated):
    """wo, wi, r4, rc as column views of wider rows (any lane and
    component stride) give the same bits as packed tensors."""
    ctx, wo, wi, r4, rc = _case(4096, 3, "cpu")
    wide = torch.cat([wo, r4, wi, rc], dim=1)
    feats = FEATURE_SETS["all_rows"]
    mode = bsdf._mode(ctx, feats, True, True)
    with emulated:
        a = bsdf._launch(0, ctx, wo, r4, rc, None, mode)
        b = bsdf._launch(0, ctx, wide[:, 0:3], wide[:, 3:7], wide[:, 10:12],
                         None, mode)
        c = bsdf._launch(1, ctx, wo, wi, None, None, mode)
        d = bsdf._launch(1, ctx, wide.T.contiguous().T[:, 0:3],
                         wide[:, 7:10], None, None, mode)
    assert all(_bits_equal(x, y) for x, y in zip(a + c, b + d))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

CARD_LANES = 65536


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(FEATURE_SETS))
@pytest.mark.parametrize("multiscatter,mixture_pdf", SWITCHES)
def test_kernel_sample_is_the_plain_sample(card, name, multiscatter,
                                           mixture_pdf):
    feats = FEATURE_SETS[name]
    ctx, wo, _, r4, rc = _case(CARD_LANES, 21, card, feats)
    luts = luts_mod.load_luts(card)
    before = bsdf.LAUNCHES["sample"]
    got = bsdf.sample(ctx, wo, r4, rc, luts, multiscatter, feats,
                      mixture_pdf)
    torch.cuda.synchronize()
    assert bsdf.LAUNCHES["sample"] == before + 1
    _hold(got, lambda ctx, luts, wo, r4, rc: bsdf.sample_plain(
        ctx, wo, r4, rc, luts, multiscatter, feats, mixture_pdf), ctx, luts,
        [wo, r4, rc])


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(FEATURE_SETS))
@pytest.mark.parametrize("multiscatter", [True, False])
def test_kernel_evaluate_is_the_plain_evaluate(card, name, multiscatter):
    feats = FEATURE_SETS[name]
    ctx, wo, wi, _, _ = _case(CARD_LANES, 22, card, feats)
    luts = luts_mod.load_luts(card)
    before = bsdf.LAUNCHES["evaluate"]
    got = bsdf.evaluate(ctx, wo, wi, luts, multiscatter, feats)
    torch.cuda.synchronize()
    assert bsdf.LAUNCHES["evaluate"] == before + 1
    _hold(got, lambda ctx, luts, wo, wi: bsdf.evaluate_plain(
        ctx, wo, wi, luts, multiscatter, feats), ctx, luts, [wo, wi])


@pytest.mark.gpu
def test_kernel_counts_its_lanes_and_refuses_a_foreign_device(card):
    ctx, wo, wi, r4, rc = _case(1000, 23, card)
    luts = luts_mod.load_luts(card)
    telemetry.drain()
    telemetry.start()
    try:
        bsdf.sample(ctx, wo, r4, rc, luts)
        bsdf.evaluate(ctx, wo, wi, luts)
        counters = telemetry.drain()["counters"]
    finally:
        telemetry.stop()
    assert counters["bsdf.kernel_lanes"] == counters["bsdf.lanes"] == 2000
    with pytest.raises(ValueError, match="r4 is on cpu"):
        bsdf.sample(ctx, wo, r4.cpu(), rc, luts)
    # an empty wave launches nothing
    ctx, wo, wi, r4, rc = _case(0, 24, card)
    before = dict(bsdf.LAUNCHES)
    s = bsdf.sample(ctx, wo, r4, rc, luts)
    assert s.wi.shape == (0, 3) and bsdf.LAUNCHES == before
