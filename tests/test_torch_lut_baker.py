"""The port's LUT baker (tools/lut_baker.py) against the JAX package's, on
the CPU.

Every `bake_*` at a tiny size and spp (size 8, 64 samples; the
multiscatter tables fed the committed bundle's E / E_avg and aniso
tables) against the JAX function's same call. Both draw the same PCG4D
streams in the same batches; what differs is float32 rounding inside a
sample (XLA fuses a jitted batch and contracts products and sums into
FMAs, eager torch rounds every op) and the order of each batch's float32
sum. Each texel is held to rtol RTOL / atol ATOL. A texel outside that bar
must be traced to its samples (`_trace`: the integrand of every sample,
captured on both sides): at most MAX_APART of its samples differ beyond
the bar, and they carry at least half the texel's gap. Such a sample is
a discrete decision that a 1-ulp difference flips (a `bad` mask,
sample_vmdf's frame switch at wh.z = 0.9999), or a sample whose pdf is
tiny, where f / pdf amplifies the rounding: E_ms at size 4, 8 samples,
texel (3, 0, 2) has one at pdf 9.6e-5 whose value is 16.942 in torch and
16.954 under XLA, 6e-4 of the texel. A drift spread over many samples
fails.
`bake_all` at a tiny size writes a bundle that ops/luts loads, held to
JAX's bake_all the same way; the bundle path and RESOURCE_DIR are
monkeypatched into tmp_path, so no test writes into the package.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from platinum_tpu.ops.samplers import PCG4DStream as JStream
from platinum_tpu.tools import lut_baker as jbaker
from platinum_tpu_torch.ops import luts
from platinum_tpu_torch.ops.samplers import PCG4DStream
from platinum_tpu_torch.tools import lut_baker as baker

torch.set_num_threads(1)
RTOL, ATOL = 1e-4, 1e-6
MAX_APART = 2
SIZE, SPP = 8, 64


def _host():
    return luts.get_host_luts()


BAKES = {
    "E": lambda m, **k: m.bake_E(size=SIZE, spp=SPP, **k),
    "E_avg": lambda m, **k: m.bake_E_avg(size=SIZE, spp=SPP, **k),
    "E_aniso": lambda m, **k: m.bake_E_aniso(size=SIZE, spp=SPP, **k),
    "E_avg_aniso": lambda m, **k: m.bake_E_avg_aniso(size=SIZE, spp=SPP,
                                                     **k),
    "E_ms": lambda m, **k: m.bake_E_ms(_host().E, _host().E_avg, size=SIZE,
                                       spp=SPP, **k),
    "E_ms_avg": lambda m, **k: m.bake_E_ms_avg(_host().E, _host().E_avg,
                                               size=SIZE, spp=SPP, **k),
    "E_trans_in": lambda m, **k: m.bake_E_trans(False, size=SIZE, spp=SPP,
                                                **k),
    "E_trans_out": lambda m, **k: m.bake_E_trans(True, size=SIZE, spp=SPP,
                                                 **k),
    "E_trans_in_avg": lambda m, **k: m.bake_E_trans_avg(False, size=SIZE,
                                                        spp=SPP, **k),
    "E_trans_out_avg": lambda m, **k: m.bake_E_trans_avg(True, size=SIZE,
                                                         spp=SPP, **k),
    "E_ms_aniso": lambda m, **k: m.bake_E_ms_aniso(
        _host().E_aniso, _host().E_avg_aniso, size=SIZE, asize=4, spp=SPP,
        **k),
    "E_ms_avg_aniso": lambda m, **k: m.bake_E_ms_avg_aniso(
        _host().E_aniso, _host().E_avg_aniso, size=SIZE, asize=4, spp=SPP,
        **k),
}


def _capture(monkeypatch, module, store):
    """Make `module`'s _mc also record every sample's integrand, (spp,
    n_texels), in `store` (one entry per bake, in call order): JAX's
    texel function jitted over all samples at once, the port's eager."""
    real = module._mc

    def _mc(texel_fn, shape, spp, *args, **kw):
        n = int(np.prod(shape))
        lin = np.arange(n, dtype=np.uint32)
        px = np.broadcast_to(lin & 0xFFFF, (spp, n))
        py = np.broadcast_to(lin >> 16, (spp, n))
        s = np.broadcast_to(np.arange(spp, dtype=np.uint32)[:, None],
                            (spp, n))
        if module is jbaker:
            run = jax.jit(lambda a, b, c: texel_fn(JStream.create(a, b, c)))
            vals = run(jnp.asarray(px), jnp.asarray(py), jnp.asarray(s))
        else:
            vals = texel_fn(PCG4DStream.create(*(
                torch.from_numpy(x.astype(np.int64)) for x in (px, py, s))))
        store.append(np.asarray(vals, np.float64))
        return real(texel_fn, shape, spp, *args, **kw)

    monkeypatch.setattr(module, "_mc", _mc)


def _trace(name, got, ref, pvals, jvals):
    """Hold every texel to RTOL / ATOL, or trace it to its samples (see
    the module docstring); returns the number of texels traced."""
    got, ref = got.reshape(-1), ref.reshape(-1)
    out = np.nonzero(~np.isclose(got, ref, rtol=RTOL, atol=ATOL))[0]
    for i in out:
        p, j = pvals[:, i], jvals[:, i]
        apart = ~np.isclose(p, j, rtol=RTOL, atol=ATOL)
        gap = abs(float(got[i]) - float(ref[i])) * len(p)
        assert 1 <= apart.sum() <= MAX_APART, (name, i, int(apart.sum()))
        assert np.abs(p - j)[apart].sum() >= 0.5 * gap, (name, i)
    return len(out)


def _hold(got, ref, name, pvals, jvals):
    assert got.dtype == ref.dtype == np.float32
    assert got.shape == ref.shape, name
    assert np.isfinite(got).all() and (got >= 0).all()
    _trace(name, got, ref, pvals, jvals)


@pytest.mark.parametrize("name", sorted(BAKES))
def test_bake_matches_jax(name, monkeypatch):
    jvals, pvals = [], []
    _capture(monkeypatch, jbaker, jvals)
    _capture(monkeypatch, baker, pvals)
    ref = np.asarray(BAKES[name](jbaker))
    got = BAKES[name](baker, device="cpu")
    _hold(got, ref, name, pvals[0], jvals[0])
    assert got.max() > 0.05, name


def test_bake_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default bakes there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        baker.bake_E(size=4, spp=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        baker.bake_all(spp_2d=4, spp_avg=4, spp_3d=4, verbose=False)


def test_batches_are_jaxs():
    """_mc's batch count and its refusal of an spp that is not a multiple
    of it (JAX: samples_per_call = max(64, 2^floor(log2(4e6 / n)))),
    and the float64 accumulation: one batch or several give the mean of
    the same samples."""
    calls = []

    def texel(stream):
        calls.append(tuple(stream.x.shape))
        _, u = stream.next_1d()
        return u

    one = baker._mc(texel, (4, 4), 64, torch.device("cpu"))
    assert calls == [(64, 16)]
    calls.clear()
    many = baker._mc(texel, (4, 4), 64, torch.device("cpu"),
                     samples_per_call=8)
    assert calls == [(8, 16)] * 8
    np.testing.assert_allclose(many, one, rtol=1e-6)
    with pytest.raises(ValueError, match="multiple"):
        baker._mc(texel, (4, 4), 12, torch.device("cpu"), samples_per_call=8)


def small_bakes(monkeypatch, module):
    """Every bake_* of `module` at size 4 (aniso bins 2), so bake_all runs
    in seconds on the CPU at the JAX defaults' spp rules."""
    for name in ("bake_E", "bake_E_avg", "bake_E_aniso", "bake_E_avg_aniso",
                 "bake_E_ms", "bake_E_ms_avg", "bake_E_trans",
                 "bake_E_trans_avg"):
        monkeypatch.setattr(module, name, functools.partial(
            getattr(module, name), size=4))
    for name in ("bake_E_ms_aniso", "bake_E_ms_avg_aniso"):
        monkeypatch.setattr(module, name, functools.partial(
            getattr(module, name), size=4, asize=2))


def bundle_paths(monkeypatch, module, root):
    """The bundle and RESOURCE_DIR of `module` under `root`."""
    monkeypatch.setattr(module, "LUT_BUNDLE", str(root / "ggx_luts.npz"))
    monkeypatch.setattr(module, "RESOURCE_DIR", str(root))
    return root / "ggx_luts.npz"


def test_bake_all_writes_a_bundle_ops_luts_loads(monkeypatch, tmp_path):
    vals = {}
    for module, sub in ((jbaker, "jax"), (baker, "port")):
        small_bakes(monkeypatch, module)
        bundle_paths(monkeypatch, module, tmp_path / sub)
        _capture(monkeypatch, module, vals.setdefault(sub, []))
    kw = dict(spp_2d=8, spp_avg=16, spp_3d=8, verbose=False,
              write_exr_slices=True)
    ref = jbaker.bake_all(**kw)
    got = baker.bake_all(**kw, device="cpu")
    assert list(got) == list(ref) == list(luts.LUT_NAMES)
    for k, name in enumerate(got):
        _hold(got[name], np.asarray(ref[name]), name, vals["port"][k],
              vals["jax"][k])
    path = tmp_path / "port" / "ggx_luts.npz"
    assert path.exists()
    # E, E_avg, three avg tables and the 4 z-slices of each 3-D table
    names = {sub: sorted(p.name for p in (tmp_path / sub / "lut").glob(
        "*.exr")) for sub in ("jax", "port")}
    assert names["port"] == names["jax"] and len(names["port"]) == 5 + 3 * 4
    monkeypatch.setenv("PLATINUM_TPU_LUTS", str(path))
    host = luts.get_host_luts()
    np.testing.assert_array_equal(host.E_ms_aniso, got["E_ms_aniso"])
    dev = luts.load_luts("cpu")
    assert dev.E.shape == (4, 4) and dev.E_F_coat.shape == (32, 32)
