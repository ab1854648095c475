"""Wide-BVH ray tracing on the GPU: the CUDA kernel, its plain version and
the host glue.

Port of platinum_tpu/ops/pallas_trace.py. `make_packet_tracer` keeps its
name and returns the same (trace_closest, trace_any) pair over the
accel.wide arrays. Rays are sorted by direction octant + origin Morton
code (`_ray_sort_key`), traced as flat (8, R) SoA rows and unsorted;
closest hits map kernel slot ids to triangle ids through `wslot`.

`trace_wide` is the wrapper of the hand-written CUDA kernel
(csrc/wide_trace.cu), which replaces the TPU kernels `_make_kernel` and
`_make_kernel_pipe` in every mode: closest hit and any hit over one tree
(K1, K2) and over the two-level instanced tree of accel/tlas.py (K3,
given `inst_feat`); the Moller-Trumbore precision tiers "high" /
"default" (K4) and "two_phase" (K5) of closest hit, which a warp tests
block by block from the blocks' pre-split bf16 planes (`split_planes`,
built once per tracer by the same source's split kernel); streamed leaf blocks
(K6, `stream`) and the near-first octant order (K7, `worder`); the
pipelined walk with its flat push (K9, `pipe`, `flat_walk`) and the
ablation modes (`profile`). Every mode but the ablation modes tests its
blocks warp-wide. `trace_wide_paired` launches a closest-hit and an
any-hit wave as one grid (K8), each CTA on the drain of its half's
unpaired mode. On CUDA tensors they launch the kernel
or raise; on CPU tensors they run the plain PyTorch version
(`trace_wide_plain`, `trace_wide_inst_plain`,
`trace_wide_two_phase_plain`, `trace_wide_profile_plain`): a brute force
over the same (B, 10, 256) coefficient blocks with the same accept tests
and the same split products, which the tests and chip_smoke.py hold the
kernel against. K6, K7 and K9 change the order of the walk, not what it
computes, so their plain versions are K1's/K3's. `trace_wide_counts` runs
the kernel's counting instantiation (node pops, MT block tests, instance
entries and refine tests per ray) for chip_smoke.py's bounds; it is not on
the render path. The TPU kernel's `pops`, `ordered`, `packets`, `drain`,
`FUSED_DRAIN` and `FEAT_SCRATCH` shape the schedule of its 128-ray
packets and change no result; a kernel with one thread per ray has no
packet to schedule, so they have no counterpart here. The kernel is built
with nvcc from the sources in this package at first use, into
platinum_tpu_torch/_build/, and rebuilt when a source's hash changes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor

import torch

from platinum_tpu_torch.ops.intersect import INF, HitRecord
from platinum_tpu_torch.utils import telemetry

DET_EPS = 1e-12
SORT_MIN_RAYS = 1024   # the JAX tracer sorts waves of >= 2 x 4 x 128 rays
SORT_MIN_NODES = 64    # ... over trees of more than 64 nodes
DEAD_KEY = 1 << 30     # sort key of inactive rays (to the back)

# This module keeps the plumbing of every source in csrc/, the shading
# kernels' too (models/bsdf.py, ops/hitdata.py import it from here): the
# nvcc flags, the build (`build_kernel`, `build_kernels`), the loaded
# libraries (`load_library`) and the per-lane argument words
# (`lane_field`). One place, so one source's build and its wrapper's
# marshalling cannot drift from another's.
PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
# the headers the sources share (every source's build hash covers them)
CSRC_SHARED = tuple(os.path.join(CSRC_DIR, h)
                    for h in ("mt_block.cuh", "mt_chunk.cuh"))
BUILD_DIR = os.path.join(PKG_DIR, "_build")
# --split-compile=0: the optimiser runs over the template instantiations
# on every CPU thread
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--split-compile=0"]
# flags a source adds to NVCC_FLAGS: the shading kernels (the BSDF, the
# hit fetch) round each product apart, as the plain PyTorch code they are
# held to does
SOURCE_FLAGS = {"bsdf_shade": ["-fmad=false"], "hit_fetch": ["-fmad=false"]}

# Moller-Trumbore precision tiers of the closest-hit modes, with the
# kernel's codes (pallas_trace.py `mt_dot`): "highest" fp32 (K1), "high"
# bf16x3 and "default" 1-pass bf16 (K4), "two_phase" bf16x3 broad phase +
# fp32 refine of each ray's top-2 candidate blocks (K5). Any hit is exact
# fp32 under every tier (pallas_trace.py:390).
PRECISIONS = {"highest": 0, "high": 1, "default": 2, "two_phase": 3}
TP_K = 1.25e-4        # two_phase error-bound factor (pallas_trace.py:438)
TP_ABS = 1e-6         # two_phase absolute widening (pallas_trace.py:180)

# Ablation modes of the classic walk, with the kernel's codes
# (pallas_trace.py:81-84, 352, 519, 740, 788). WRONG RESULTS by design,
# for timing only: "empty" loads, initialises and stores without walking
# (the launch floor); "nomt" walks with every block test skipped; "fix64"
# runs exactly 64 loop iterations whatever the stack holds; "count"
# returns the thread's iteration count in place of u (its t, id and v are
# the walk's own).
PROFILES = {"none": 0, "empty": 1, "nomt": 2, "fix64": 3, "count": 4}
PROFILE = "none"      # make_packet_tracer's default ablation mode
PAIR_ALIGN = 128      # the kernel's block size: K8's any-hit rays start at
                      # a multiple of it, so no warp holds both waves
COUNT_ROWS = 7        # rows of the counting instantiation's table


def launch_key(any_hit: bool, instanced: bool = False,
               mt_precision: str = "highest", oct_order: bool = False,
               stream: bool = False, pipe: bool = False,
               flat_walk: bool = False, profile: str = "none",
               paired: bool = False) -> str:
    """LAUNCHES key of one kernel mode: "closest" / "any" (K1, K2), an
    "inst_" prefix for the two-level tree (K3), a "stream+" prefix for
    streamed blocks (K6), a "+<tier>" suffix for closest hit below
    "highest" (K4, K5) and "+oct" for the octant order (K7; the packet
    tracer asks it for closest hit only); "paired" in place of closest /
    any for the paired launch (K8); a "pipe+" or "flat+" prefix for the
    pipelined walk (K9); an "@<mode>" suffix for an ablation mode."""
    key = "paired" if paired else (
        ("inst_" if instanced else "") + ("any" if any_hit else "closest"))
    if stream:
        key = "stream+" + key
    if flat_walk:
        key = "flat+" + key
    elif pipe:
        key = "pipe+" + key
    if (paired or not any_hit) and mt_precision != "highest":
        key += "+" + mt_precision
    if oct_order:
        key += "+oct"
    if profile != "none":
        key += "@" + profile
    return key


# Kernel launches per mode (`launch_key`), counted where the wrapper
# launches and nowhere else (chip_smoke.py reads them to show that a render
# went through the kernel)
LAUNCHES = {launch_key(a, i, p, o, s): 0
            for a in (False, True) for i in (False, True)
            for p in (PRECISIONS if not a else ("highest",))
            for o in (False, True)
            for s in (False, True) if not (s and p == "two_phase")}
LAUNCHES.update({launch_key(False, mt_precision=p, stream=s, paired=True): 0
                 for p in PRECISIONS for s in (False, True)
                 if not (s and p == "two_phase")})
LAUNCHES.update({launch_key(a, i, pipe=True, flat_walk=f): 0
                 for a in (False, True) for i in (False, True)
                 for f in (False, True)})
LAUNCHES.update({launch_key(a, stream=s, profile=m): 0
                 for a in (False, True) for m in PROFILES if m != "none"
                 for s in ((False, True) if m in ("empty", "nomt")
                           else (False,))})
LAUNCHES["split_planes"] = 0   # the pre-split planes of the reduced tiers

_libs = {}
_lib_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: building the CUDA kernels "
                           "needs the CUDA toolkit")
    return path


def build_kernel(name: str = "wide_trace") -> str:
    """Compile csrc/<name>.cu to a shared library named by the hash of the
    source and the headers it shares (reused when present) and return its
    path. Raises on failure."""
    source = os.path.join(CSRC_DIR, name + ".cu")
    flags = NVCC_FLAGS + SOURCE_FLAGS.get(name, [])
    digest = hashlib.sha256(" ".join(flags).encode())
    for path in (source, *CSRC_SHARED):
        with open(path, "rb") as f:
            digest.update(f.read())
    out = os.path.join(BUILD_DIR, f"{name}_{digest.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *flags, "-o", tmp, source],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu "
                               f"({proc.returncode}):\n{proc.stderr[-4000:]}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def build_kernels(names=("wide_trace", "stream_mt", "bf_stream",
                         "bsdf_shade", "hit_fetch")) -> dict:
    """Build several kernel sources at once, one nvcc each, all started
    together; {name: library path}. Raises if any build fails."""
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(build_kernel, names)))


def load_library(name: str, declare):
    """The ctypes library of csrc/<name>.cu, built at first use and kept;
    `declare(lib)` sets the argument types of its entry points once."""
    with _lib_lock:
        if name not in _libs:
            with telemetry.span("kernels.build"):
                lib = ctypes.CDLL(build_kernel(name))
            declare(lib)
            _libs[name] = lib
        return _libs[name]


def lane_field(name, t, n, k, dev, dtype=torch.float32):
    """(pointer, lane stride, component stride) of a (n,) or (n, k)
    per-lane field that a shading kernel reads where it lies; raises on
    what the kernel does not take."""
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, the lanes on {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    shape = (n,) if k == 1 else (n, k)
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")
    return [t.data_ptr(), t.stride(0), t.stride(1) if k > 1 else 0]


def _declare(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wide_trace_launch.restype = i
    lib.wide_trace_launch.argtypes = [p, i, i, p, p, p, p, p, p, i, i, i,
                                      i, i, p, p, p, p, p, p, p]
    lib.wide_trace_split_planes.restype = i
    lib.wide_trace_split_planes.argtypes = [p, i, p, p]
    lib.wide_trace_error_string.restype = ctypes.c_char_p
    lib.wide_trace_error_string.argtypes = [i]


def _library():
    return load_library("wide_trace", _declare)


def _check(name, x, dtype, shape, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, rays on {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape[1:]) != tuple(shape[1:]) or x.dim() != len(shape):
        raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def check_mode(mt_precision: str, stream: bool, pipe: bool = False,
               flat_walk: bool = False, profile: str = "none"):
    """Refuse what the JAX package refuses (pallas_trace.py:1196-1203): an
    unknown tier or ablation mode; two_phase over streamed blocks or on
    the pipelined walk (its refine re-reads the candidate blocks);
    streamed blocks on the pipelined walk. Beyond it: the pipelined walk
    has no reduced tier and no ablation mode (the JAX package runs fp32
    and ignores `profile` there without a word). Over streamed blocks the
    kernel has "empty" and "nomt" alone, for timing the queued walk;
    `make_packet_tracer` refuses every ablation mode there, as the JAX
    package does."""
    if mt_precision not in PRECISIONS:
        raise ValueError(f"unknown mt_precision {mt_precision!r}; one of "
                         f"{sorted(PRECISIONS)}")
    if profile not in PROFILES:
        raise ValueError(f"unknown profile {profile!r}; one of "
                         f"{sorted(PROFILES)}")
    if mt_precision == "two_phase" and stream:
        raise ValueError("mt_precision='two_phase' needs resident blocks: "
                         "it cannot trace a streamed structure "
                         "(flat.wbvh_stream); use stream='off' or another "
                         "tier")
    pipe = pipe or flat_walk
    if stream and pipe:
        raise ValueError("streamed leaf blocks run on the default walk "
                         "only: not with pipe / flat_walk")
    if profile in ("fix64", "count"):
        _check_profile(profile, None, None, stream)
    if pipe and mt_precision != "highest":
        raise ValueError(f"the pipelined walk (pipe / flat_walk) is fp32: "
                         f"it has no mt_precision={mt_precision!r}")
    if pipe and profile != "none":
        raise ValueError("the pipelined walk has no profile modes")


def _single_block_leaves(meta) -> bool:
    """Every leaf of the tree owns exactly one MT block (the answer costs
    a device sync)."""
    m = meta[meta <= -2]
    return bool((((-m - 2) & 31) == 1).all())


def split_planes_plain(blocks):
    """The pre-split planes of the (B, 10, 256) f32 coefficient blocks:
    (B, 2, 10, 256) bf16, h = bf16(c) and l = bf16(c - h), each rounded to
    nearest even (c - h is exact in fp32): the split of the TPU kernel's
    `mt_dot` (pallas_trace.py:194-197), done once for the scene."""
    h = blocks.to(torch.bfloat16)
    low = (blocks - h.to(torch.float32)).to(torch.bfloat16)
    return torch.stack([h, low], dim=1).contiguous()


def split_planes(blocks):
    """`split_planes_plain`'s table, from the kernel's split kernel on CUDA
    tensors (counted in LAUNCHES["split_planes"]); CPU tensors take the
    plain version. The reduced tiers' closest hit reads these planes in
    place of the fp32 blocks."""
    if blocks.device.type == "cpu":
        return split_planes_plain(blocks)
    if blocks.device.type != "cuda":
        raise ValueError(f"split_planes: unsupported device {blocks.device}")
    _check("blocks", blocks, torch.float32, (blocks.shape[0], 10, 256),
           blocks.device)
    planes = torch.empty((blocks.shape[0], 2, 10, 256), dtype=torch.bfloat16,
                         device=blocks.device)
    if blocks.shape[0] == 0:
        return planes
    lib = _library()
    with torch.cuda.device(blocks.device):
        rc = lib.wide_trace_split_planes(
            blocks.data_ptr(), blocks.shape[0], planes.data_ptr(),
            torch.cuda.current_stream(blocks.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("split_planes kernel launch failed: "
                           + lib.wide_trace_error_string(rc).decode())
    LAUNCHES["split_planes"] += 1
    return planes


def _check_tree(dev, nodes, blocks, meta, inst_feat=None, worder=None,
                planes=None, closest_tier="highest"):
    """Check the tensors of the tree a wave is traced over, for rays on
    `dev`: devices, dtypes, shapes, contiguity and alignment. `planes`, the
    blocks' pre-split planes, are what closest hit at a reduced tier
    (`closest_tier`) reads, and must then be given. `trace_wide` checks
    them with every wave, a packet tracer once."""
    _check("nodes", nodes, torch.float32, (nodes.shape[0], 16, 8), dev)
    _check("blocks", blocks, torch.float32, (blocks.shape[0], 10, 256), dev)
    _check("meta", meta, torch.int32, (nodes.shape[0] * 16,), dev)
    if meta.shape[0] != nodes.shape[0] * 16:
        raise ValueError("meta must hold 16 entries per node")
    if inst_feat is not None:
        _check("inst_feat", inst_feat, torch.float32,
               (inst_feat.shape[0], 10, 128), dev)
    if worder is not None:
        _check("worder", worder, torch.int32, (nodes.shape[0] * 16,), dev)
        if worder.shape[0] != nodes.shape[0] * 16:
            raise ValueError("worder must hold 16 words per node")
    if closest_tier == "highest":
        return
    if planes is None:
        raise ValueError(f"closest hit at mt_precision={closest_tier!r} "
                         f"reads the blocks' pre-split planes: pass "
                         f"planes=split_planes(blocks), which a tracer "
                         f"builds once")
    _check("planes", planes, torch.bfloat16, (blocks.shape[0], 2, 10, 256),
           dev)
    if planes.shape[0] != blocks.shape[0]:
        raise ValueError("planes must hold one block's planes per block")


def _launch(rays, nodes, blocks, meta, any_hit, inst_feat, count,
            worder=None, mt_precision="highest", stream=False, walk=0,
            profile="none", n_split=0, planes=None):
    """Check the rays, allocate the outputs and launch one wave of the
    kernel on the current stream. any_hit: False, True, or 2 for the
    paired launch (rays below `n_split` closest hit, the others any hit);
    walk: 0 classic or queued, 1 pipelined, 2 pipelined with the flat
    push; `planes`: the blocks' pre-split planes, which closest hit at a
    reduced tier reads.
    Returns (t, sid, u, v, inst, counts); inst is None outside the
    instanced closest-hit mode, counts None unless `count`. The caller
    has checked the mode (`check_mode`) and the tree's tensors
    (`_check_tree`); the C entry refuses a bad mode again."""
    dev = rays.device
    r = rays.shape[1]
    _check("rays", rays, torch.float32, (8, r), dev)
    if nodes.device != dev:
        raise ValueError(f"nodes is on {nodes.device}, rays on {dev}")
    if any_hit is True or mt_precision == "highest":
        planes = None           # no closest hit at a reduced tier
    t = torch.empty(r, dtype=torch.float32, device=dev)
    sid = torch.empty(r, dtype=torch.int32, device=dev)
    u = torch.empty(r, dtype=torch.float32, device=dev)
    v = torch.empty(r, dtype=torch.float32, device=dev)
    inst = (torch.empty(r, dtype=torch.int32, device=dev)
            if inst_feat is not None and any_hit is False else None)
    counts = (torch.empty((COUNT_ROWS, r), dtype=torch.int32, device=dev)
              if count else None)
    if r == 0:
        return t, sid, u, v, inst, counts
    lib = _library()
    with torch.cuda.device(dev):
        cuda_stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.wide_trace_launch(
            rays.data_ptr(), r, n_split, nodes.data_ptr(), blocks.data_ptr(),
            planes.data_ptr() if planes is not None else None,
            meta.data_ptr(),
            inst_feat.data_ptr() if inst_feat is not None else None,
            worder.data_ptr() if worder is not None else None,
            int(any_hit), PRECISIONS[mt_precision], int(bool(stream)), walk,
            PROFILES[profile],
            t.data_ptr(), sid.data_ptr(), u.data_ptr(), v.data_ptr(),
            inst.data_ptr() if inst is not None else None,
            counts.data_ptr() if counts is not None else None, cuda_stream)
    if rc != 0:
        raise RuntimeError("wide_trace kernel launch failed: "
                           + lib.wide_trace_error_string(rc).decode())
    return t, sid, u, v, inst, counts


def _walk_code(meta, pipe: bool, flat_walk: bool, checked: bool) -> int:
    """The kernel's walk code; the flat push needs single-block leaves
    (pallas_trace.py:841-844 states it, the JAX package does not check),
    which is looked up here unless the caller has `checked` the tree."""
    if flat_walk and not checked and not _single_block_leaves(meta):
        raise ValueError("flat_walk needs every leaf to own exactly one MT "
                         "block (wide_leaf_cap <= 64, the build default)")
    return 2 if flat_walk else int(bool(pipe))


def _check_profile(profile: str, inst_feat, worder, stream: bool = False):
    """The ablation modes exist on the one-level walk without the octant
    order, and not over streamed blocks where `stream` is set: never for
    "fix64" and "count" (`check_mode`), and for none in a packet tracer,
    as in the JAX package (the kernel times "empty" and "nomt" there)."""
    if profile == "none":
        return
    if inst_feat is not None or worder is not None:
        raise ValueError("the profile modes exist on the one-level walk "
                         "without the octant order")
    if stream:
        raise ValueError(f"profile={profile!r} exists on the classic walk "
                         f"only, not over streamed blocks")


def trace_wide(rays, nodes, blocks, meta, any_hit: bool, inst_feat=None,
               worder=None, mt_precision: str = "highest",
               stream: bool = False, pipe: bool = False,
               flat_walk: bool = False, profile: str = "none",
               checked: bool = False, planes=None):
    """Trace one wave over the wide BVH.

    rays: (8, R) f32 rows [ox, oy, oz, dx, dy, dz, tmin, tmax]; nodes:
    (N, 16, 8) f32; blocks: (B, 10, 256) f32; meta: (N*16,) i32;
    inst_feat: (I, 10, 128) f32 feature transforms of an instanced tree
    (accel.tlas), or None for a one-level tree. `worder` ((N*16,) i32,
    accel.wide.build_octant_orders) walks children near-first (K7);
    `mt_precision` is the closest-hit tier (PRECISIONS; any hit is exact
    fp32 under every tier); `stream` queues each node's leaf blocks,
    prefetching them into L2 for closest hit, before they are tested
    (K6; fp32 any hit without `worder` drains each node's leaf queues
    warp-wide with or without it, so streamed and resident any hit are
    one mode); `pipe` takes the
    pipelined walk and `flat_walk` its flat push (K9), which looks the
    tree's leaves up on every call (a device sync) unless the caller says
    it has `checked` that each owns one block, as `make_packet_tracer`
    does once; `profile` is an ablation mode of the one-level fp32 walk
    (PROFILES: wrong results by design); `planes` ((B, 2, 10, 256) bf16,
    `split_planes(blocks)`) are what closest hit reads at a reduced tier,
    required there on CUDA tensors (a tracer builds them once; the plain
    version forms the split itself).
    Returns (t, sid, u, v), each (R,): t = best t (tmax on a
    miss), sid = block*64 + slot of the hit (-1 on a miss; any-hit: 1 if
    occluded), barycentrics u, v; the instanced closest-hit mode adds
    inst, the instance of the hit. CPU tensors take the plain version;
    CUDA tensors the kernel."""
    # also for any hit, as JAX does
    check_mode(mt_precision, stream, pipe, flat_walk, profile)
    _check_profile(profile, inst_feat, worder)
    pipe = pipe or flat_walk
    if pipe and worder is not None:
        raise ValueError("the pipelined walk takes no octant order "
                         "(pallas_trace.py:1459)")
    walk = _walk_code(meta, pipe, flat_walk, checked)
    if rays.device.type == "cuda":
        _check_tree(rays.device, nodes, blocks, meta, inst_feat, worder,
                    planes, "highest" if any_hit else mt_precision)
    return _trace_wave(rays, nodes, blocks, meta, any_hit, inst_feat, worder,
                       mt_precision, stream, walk, profile, planes)


def _trace_wave(rays, nodes, blocks, meta, any_hit, inst_feat, worder,
                mt_precision, stream, walk, profile, planes):
    """`trace_wide` after its checks of the mode and, on CUDA tensors, of
    the tree (a packet tracer makes them once and traces every wave
    here): the plain version on CPU tensors, else the kernel, counted in
    LAUNCHES. `walk` is `_walk_code`'s."""
    prec = "highest" if any_hit else mt_precision
    if rays.device.type == "cpu":
        return _reference(rays, nodes, blocks, meta, any_hit, inst_feat,
                          prec, profile)
    if rays.device.type != "cuda":
        raise ValueError(f"trace_wide: unsupported device {rays.device}")
    t, sid, u, v, inst, _ = _launch(rays, nodes, blocks, meta, bool(any_hit),
                                    inst_feat, False, worder, prec, stream,
                                    walk, profile, planes=planes)
    if rays.shape[1]:       # an empty wave launches nothing
        LAUNCHES[launch_key(any_hit, inst_feat is not None, prec,
                            worder is not None, stream, walk > 0, walk == 2,
                            profile)] += 1
    if inst is not None:
        return t, sid, u, v, inst
    return t, sid, u, v


def trace_wide_reference(rays, nodes, blocks, meta, any_hit: bool,
                         inst_feat=None, worder=None,
                         mt_precision: str = "highest",
                         stream: bool = False, pipe: bool = False,
                         flat_walk: bool = False, profile: str = "none",
                         checked: bool = False, planes=None):
    """The plain PyTorch version of the kernel mode `trace_wide` would
    launch with these arguments, on any device, with its outputs:
    `trace_wide_profile_plain` for an ablation mode,
    `trace_wide_two_phase_plain` for two_phase closest hit, else
    `trace_wide_plain` / `trace_wide_inst_plain` at the closest-hit tier.
    The walk (`worder`, `stream`, `pipe`, `flat_walk`, `checked`) changes
    how the kernel visits blocks, not what it computes, so it selects
    nothing here; `planes` hold the split the plain versions form
    themselves."""
    check_mode(mt_precision, stream, pipe, flat_walk, profile)
    return _reference(rays, nodes, blocks, meta, any_hit, inst_feat,
                      "highest" if any_hit else mt_precision, profile)


def _reference(rays, nodes, blocks, meta, any_hit, inst_feat, prec, profile):
    """`trace_wide_reference` of a checked mode at the wave's tier `prec`."""
    if profile != "none":
        return trace_wide_profile_plain(rays, nodes, blocks, meta, any_hit,
                                        profile)
    if prec == "two_phase":
        return trace_wide_two_phase_plain(rays, nodes, blocks, meta,
                                          inst_feat)
    if inst_feat is not None:
        return trace_wide_inst_plain(rays, nodes, blocks, meta, any_hit,
                                     inst_feat, mt_precision=prec)
    return trace_wide_plain(rays, nodes, blocks, meta, any_hit,
                            mt_precision=prec)


def trace_wide_profile_plain(rays, nodes, blocks, meta, any_hit: bool,
                             profile: str):
    """What an ablation mode must return, as far as that is defined:
    "empty" and "nomt" test no triangle, so every ray misses; "count" is
    the full walk with u replaced by the iteration count, which a brute
    force does not have (0 here; on the card it is held to
    `trace_wide_counts`' pops per ray); "fix64" stops after 64 iterations
    and is timed only, its value is whatever the walk had found by then
    (the full walk's, here)."""
    if profile in ("empty", "nomt"):
        r = rays.shape[1]
        return (rays[7].clone(),
                torch.full((r,), -1, dtype=torch.int32, device=rays.device),
                torch.zeros(r, device=rays.device),
                torch.zeros(r, device=rays.device))
    t, sid, u, v = trace_wide_plain(rays, nodes, blocks, meta, any_hit)
    return (t, sid, torch.zeros_like(u), v) if profile == "count" else (
        t, sid, u, v)


def pair_rays(rays_c, rays_a):
    """One (8, n) ray table for the paired launch: the closest-hit wave,
    dead rays (tmax < tmin) up to a multiple of PAIR_ALIGN, then the
    any-hit wave. Returns (rays, n_split): the any-hit rays start at
    n_split."""
    nc = rays_c.shape[1]
    n_split = -(-nc // PAIR_ALIGN) * PAIR_ALIGN
    parts = [rays_c]
    if n_split > nc:
        pad = torch.zeros((8, n_split - nc), dtype=torch.float32,
                          device=rays_c.device)
        pad[7] = -1.0
        parts.append(pad)
    return torch.cat([*parts, rays_a], dim=1), n_split


def trace_wide_paired(rays_c, rays_a, nodes, blocks, meta,
                      mt_precision: str = "highest", stream: bool = False,
                      planes=None):
    """Trace a closest-hit wave and an independent any-hit wave in ONE
    kernel launch (K8, pallas_trace.py `trace_paired`): one grid covers
    both waves, and each 128-ray CTA runs the drain of the unpaired mode
    that computes its half (`trace_wide` closest hit at the tier and
    `stream`, and any hit, exact fp32), the closest-hit CTAs first. One
    tree level only. Either wave may be longer, or empty. Returns ((t,
    sid, u, v) of the closest wave, the any-hit wave's sid: 1 occluded,
    -1 not): bit for bit `trace_wide`'s results; `planes` as in
    `trace_wide`. CPU tensors take the two plain versions."""
    check_mode(mt_precision, stream)
    if rays_c.device.type == "cuda":
        _check_tree(rays_c.device, nodes, blocks, meta, planes=planes,
                    closest_tier=mt_precision)
    return _paired_wave(rays_c, rays_a, nodes, blocks, meta, mt_precision,
                        stream, planes)


def _paired_wave(rays_c, rays_a, nodes, blocks, meta, mt_precision, stream,
                 planes):
    """`trace_wide_paired` after its checks (a packet tracer's paired
    waves come here)."""
    if rays_c.device.type == "cpu":
        return (_reference(rays_c, nodes, blocks, meta, False, None,
                           mt_precision, "none"),
                _reference(rays_a, nodes, blocks, meta, True, None,
                           "highest", "none")[1])
    if rays_c.device.type != "cuda":
        raise ValueError(f"trace_wide_paired: unsupported device "
                         f"{rays_c.device}")
    nc = rays_c.shape[1]
    rays, n_split = pair_rays(rays_c, rays_a)
    t, sid, u, v, _, _ = _launch(rays, nodes, blocks, meta, 2, None, False,
                                 None, mt_precision, stream, n_split=n_split,
                                 planes=planes)
    if rays.shape[1]:
        LAUNCHES[launch_key(False, mt_precision=mt_precision, stream=stream,
                            paired=True)] += 1
    return (t[:nc], sid[:nc], u[:nc], v[:nc]), sid[n_split:]


def _count_sums(counts) -> dict:
    (pops, tests, xforms, refine, rewalks, rounds,
     distinct) = counts.long().sum(dim=1).tolist()
    return {"pops": pops, "mt_tests": tests, "inst_entries": xforms,
            "refine_tests": refine, "rewalks": rewalks,
            "drain_rounds": rounds, "distinct_blocks": distinct}


def trace_wide_counts(rays, nodes, blocks, meta, any_hit: bool,
                      inst_feat=None, worder=None,
                      mt_precision: str = "highest",
                      stream: bool = False, pipe: bool = False,
                      flat_walk: bool = False, profile: str = "none",
                      per_ray: bool = False, checked: bool = False,
                      planes=None):
    """The work one wave of `trace_wide` does, from the kernel's counting
    instantiation (CUDA tensors only; not counted in LAUNCHES): total node
    pops, (ray, block) MT tests (two_phase: broad-phase tests), instance
    entries (T F products: one per switch of instance along a ray's walk,
    but in the fp32 drain over the two-level tree, K3 and its any hit, one
    per drained lane, instance and drain round, which re-enters an
    instance the walk already entered), two_phase's fp32 block tests
    (refine and exact re-walk), its re-walked rays, and for the warp-wide
    modes (closest hit at a reduced tier, fp32 closest hit, fp32 any hit
    without the octant order and the pipelined walk, over one tree level
    or two) the drain rounds that tested a block and the distinct blocks
    tested in them, summed over the warps (so MT tests / distinct blocks
    is the lanes that tested one block in one round). With `per_ray`, the
    (7, R) i32 table instead of the sums, the last two rows on each warp's
    lane 0. Of the ablation modes "nomt" and "fix64" have a counting
    instantiation. `planes` as in `trace_wide`."""
    if rays.device.type != "cuda":
        raise ValueError("trace_wide_counts runs the CUDA kernel only")
    check_mode(mt_precision, stream, pipe, flat_walk, profile)
    prec = "highest" if any_hit else mt_precision
    _check_tree(rays.device, nodes, blocks, meta, inst_feat, worder, planes,
                prec)
    counts = _launch(rays, nodes, blocks, meta, bool(any_hit), inst_feat,
                     True, worder, prec, stream,
                     _walk_code(meta, pipe or flat_walk, flat_walk, checked),
                     profile, planes=planes)[5]
    return counts if per_ray else _count_sums(counts)


def split_paired_counts(counts, n_closest: int, n_split: int,
                        per_ray: bool = False):
    """The paired launch's (7, n) counting table split by wave: (closest
    wave, any-hit wave), as sums or, with `per_ray`, as the two (7, R)
    tables."""
    halves = (counts[:, :n_closest], counts[:, n_split:])
    return halves if per_ray else tuple(_count_sums(c) for c in halves)


def trace_wide_paired_counts(rays_c, rays_a, nodes, blocks, meta,
                             stream: bool = False, per_ray: bool = False):
    """`trace_wide_counts` of the paired launch at the fp32 tier, split by
    wave: (counts of the closest wave, counts of the any-hit wave), sums
    or, with `per_ray`, the (7, R) tables of `trace_wide_counts(per_ray=
    True)`. Each CTA runs its half's unpaired drain, so the two tables are
    those of K1 (K6 closest with `stream`) and K2 on the two waves, drain
    rows included."""
    if rays_c.device.type != "cuda":
        raise ValueError("trace_wide_paired_counts runs the CUDA kernel only")
    _check_tree(rays_c.device, nodes, blocks, meta)
    rays, n_split = pair_rays(rays_c, rays_a)
    counts = _launch(rays, nodes, blocks, meta, 2, None, True, None,
                     "highest", stream, n_split=n_split)[5]
    return split_paired_counts(counts, rays_c.shape[1], n_split, per_ray)


def ray_features(rays: torch.Tensor) -> torch.Tensor:
    """(8, R) rays -> (10, R) MT features [d, o x d, o, 1]."""
    ox, oy, oz, dx, dy, dz = rays[0], rays[1], rays[2], rays[3], rays[4], rays[5]
    return torch.stack([dx, dy, dz,
                        oy * dz - oz * dy,
                        oz * dx - ox * dz,
                        ox * dy - oy * dx,
                        ox, oy, oz, torch.ones_like(ox)])


def _no_tf32(device):
    """Every fp32 product of the plain versions is exact fp32: no TF32."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if (torch.backends.cuda.matmul.allow_tf32
                or torch.backends.cudnn.allow_tf32):
            raise RuntimeError("TF32 could not be disabled")


def _bf16(x):
    """x rounded to bf16 (to nearest even) and back to fp32."""
    return x.to(torch.bfloat16).to(torch.float32)


def mt_product(coef, feat, mt_precision: str = "highest"):
    """Coefficient rows (M, 10) times features (10, k) at an MT tier, as
    the TPU kernel's `mt_dot` forms it (pallas_trace.py:187-204):
    "highest" one fp32 product; "high" and "two_phase" split both sides
    into h = bf16(x), l = bf16(x - h) and add the three products
    d(ch, fh) + d(ch, fl) + d(cl, fh) in that order; "default" d(ch, fh)
    alone. Products of bf16 values are exact in fp32, so only the fp32
    sums round."""
    if mt_precision == "highest":
        return coef @ feat
    ch, fh = _bf16(coef), _bf16(feat)
    hh = ch @ fh
    if mt_precision == "default":
        return hh
    return (hh + ch @ _bf16(feat - fh)) + _bf16(coef - ch) @ fh


def _fold_blocks(coef, b_start, b_end, nb, feat, lo, hi, any_hit, st,
                 mt_precision="highest"):
    """Fold coefficient blocks [b_start, b_end) into the running state st
    (best, sid, bu, bv, occ, found) of k rays with features feat (10, k):
    the kernel's accept tests on the tier's product (`mt_product`) per
    chunk of nb blocks, closest hit replacing the best only on a strictly
    smaller t (ties to the lowest block*64 + slot). st["found"] marks the
    rays whose best changed in this call."""
    k = feat.shape[1]
    st["found"] = torch.zeros(k, dtype=torch.bool, device=feat.device)
    for b0 in range(b_start, b_end, nb):
        bcount = min(nb, b_end - b0)
        out = mt_product(coef[b0 * 256:(b0 + bcount) * 256], feat,
                         mt_precision).view(bcount, 4, 64, k)
        sign = torch.where(out[:, 0] >= 0.0, 1.0, -1.0)
        out = out * sign[:, None]
        ad, us, vs, ts = out[:, 0], out[:, 1], out[:, 2], out[:, 3]
        cull = hi if any_hit else st["best"]
        ok = ((ad > DET_EPS) & (us >= 0.0) & (vs >= 0.0)
              & (us + vs <= ad) & (ts > lo * ad) & (ts < cull * ad))
        if any_hit:
            st["occ"] |= ok.reshape(-1, k).any(dim=0)
            continue
        t = torch.where(ok, ts / torch.clamp(ad, min=1e-37), INF)
        tb, arg = torch.min(t.reshape(-1, k), dim=0)
        found = tb < st["best"]
        pick = arg[None]
        iad = 1.0 / torch.clamp(ad.reshape(-1, k).gather(0, pick)[0],
                                min=1e-37)
        st["bu"] = torch.where(
            found, us.reshape(-1, k).gather(0, pick)[0] * iad, st["bu"])
        st["bv"] = torch.where(
            found, vs.reshape(-1, k).gather(0, pick)[0] * iad, st["bv"])
        st["sid"] = torch.where(found, b0 * 64 + arg, st["sid"])
        st["best"] = torch.where(found, tb, st["best"])
        st["found"] |= found


def _plain_setup(rays, n_blocks, max_elems):
    """Outputs initialised to misses, the live rays (tmax > tmin), their
    features and the ray / block chunk sizes of the plain versions."""
    dev = rays.device
    _no_tf32(dev)
    r = rays.shape[1]
    if max_elems is None:
        max_elems = 1 << (26 if dev.type == "cuda" else 22)
    outs = (rays[7].clone(),
            torch.full((r,), -1, dtype=torch.int32, device=dev),
            torch.zeros(r, dtype=torch.float32, device=dev),
            torch.zeros(r, dtype=torch.float32, device=dev))
    live = torch.nonzero(rays[7] > rays[6]).squeeze(1)
    nr = max(1, min(live.numel(), max_elems // 256))
    nb = max(1, min(n_blocks, max_elems // (256 * nr)))
    return outs, live, nr, nb


def _plain_state(hi):
    k = hi.shape[0]
    dev = hi.device
    return {"best": hi.clone(),
            "sid": torch.full((k,), -1, dtype=torch.int64, device=dev),
            "bu": torch.zeros(k, device=dev), "bv": torch.zeros(k, device=dev),
            "occ": torch.zeros(k, dtype=torch.bool, device=dev)}


def _plain_store(outs, idx, st, any_hit):
    t_out, sid_out, u_out, v_out = outs
    if any_hit:
        sid_out[idx] = torch.where(st["occ"], 1, -1).to(torch.int32)
    else:
        t_out[idx] = st["best"]
        sid_out[idx] = st["sid"].to(torch.int32)
        u_out[idx] = st["bu"]
        v_out[idx] = st["bv"]


def trace_wide_plain(rays, nodes, blocks, meta, any_hit: bool,
                     max_elems: int | None = None,
                     mt_precision: str = "highest"):
    """Plain PyTorch version of `trace_wide` on a one-level tree (K1, K2,
    K4; also of the streamed and octant-ordered walks K6, K7, which
    compute the same function), with the same outputs.

    Brute force over every coefficient block, independent of the tree
    (`nodes` and `meta` are unused): the product of the blocks as
    (B*256, 10) with the features (10, R) at the closest-hit tier
    `mt_precision` ("highest", "high" or "default"; `mt_product`, no
    TF32), chunked over blocks and rays so that no temporary exceeds
    `max_elems` floats (2^26 = 256 MB on a GPU), then the kernel's accept
    tests. Closest hit: min t, ties to the lowest block*64 + slot. Any hit
    is exact fp32 under every tier. Only rays with tmax > tmin are
    traced."""
    n_blocks = blocks.shape[0]
    outs, live, nr, nb = _plain_setup(rays, n_blocks, max_elems)
    if live.numel() == 0 or n_blocks == 0:
        return outs
    prec = "highest" if any_hit else mt_precision
    feat = ray_features(rays[:, live])
    tmin, tmax = rays[6, live], rays[7, live]
    coef = blocks.transpose(1, 2).reshape(n_blocks * 256, 10)
    for r0 in range(0, live.numel(), nr):
        fr = feat[:, r0:r0 + nr]
        k = fr.shape[1]
        lo, hi = tmin[r0:r0 + k], tmax[r0:r0 + k]
        st = _plain_state(hi)
        _fold_blocks(coef, 0, n_blocks, nb, fr, lo, hi, any_hit, st, prec)
        _plain_store(outs, live[r0:r0 + k], st, any_hit)
    return outs


def instance_block_ranges(meta, n_inst: int):
    """(I, 2) int64 [first, end) library block range of each instance of
    an instanced tree, from its leaf metas (inst<<19 | block<<5 | n): the
    blocks of the instance's mesh, since every block of a mesh is a leaf
    block of its BLAS."""
    m = meta.long()
    val = -m[m <= -2] - 2
    inst = val >> 19
    b0 = (val >> 5) & 0x3FFF
    b1 = b0 + (val & 31)
    lo = torch.full((n_inst,), 1 << 30, dtype=torch.int64, device=m.device)
    hi = torch.zeros(n_inst, dtype=torch.int64, device=m.device)
    lo = lo.scatter_reduce(0, inst, b0, reduce="amin")
    hi = hi.scatter_reduce(0, inst, b1, reduce="amax")
    return torch.stack([torch.minimum(lo, hi), hi], dim=1)


def trace_wide_inst_plain(rays, nodes, blocks, meta, any_hit: bool,
                          inst_feat, max_elems: int | None = None,
                          mt_precision: str = "highest"):
    """Plain PyTorch version of `trace_wide` on an instanced tree (K3; K4,
    K6 and K7 on the two-level tree).

    Independent of the tree's nodes: for every instance, in order, the
    blocks of its mesh (`instance_block_ranges`) are brute-forced with the
    ray features transformed by its T (one fp32 (10, 10) x (10, R)
    product), the closest-hit tier's product and K1's accept tests.
    Closest hit keeps the minimum t, ties to the lowest (instance,
    block*64 + slot), and adds inst, the instance of the hit (0 on a
    miss)."""
    n_inst = inst_feat.shape[0]
    outs, live, nr, nb = _plain_setup(rays, blocks.shape[0], max_elems)
    inst_out = torch.zeros(rays.shape[1], dtype=torch.int32,
                           device=rays.device)
    if live.numel() == 0 or blocks.shape[0] == 0:
        return outs if any_hit else (*outs, inst_out)
    prec = "highest" if any_hit else mt_precision
    ranges = instance_block_ranges(meta, n_inst).tolist()
    tmat = inst_feat[:, :, 0:10]
    feat = ray_features(rays[:, live])
    tmin, tmax = rays[6, live], rays[7, live]
    coef = blocks.transpose(1, 2).reshape(blocks.shape[0] * 256, 10)
    for r0 in range(0, live.numel(), nr):
        fr = feat[:, r0:r0 + nr]
        k = fr.shape[1]
        lo, hi = tmin[r0:r0 + k], tmax[r0:r0 + k]
        st = _plain_state(hi)
        best_inst = torch.zeros(k, dtype=torch.int32, device=rays.device)
        for i, (b_lo, b_hi) in enumerate(ranges):
            if b_hi <= b_lo:
                continue
            _fold_blocks(coef, b_lo, b_hi, nb, tmat[i] @ fr, lo, hi,
                         any_hit, st, prec)
            if not any_hit:
                best_inst = torch.where(st["found"], i, best_inst)
        idx = live[r0:r0 + k]
        _plain_store(outs, idx, st, any_hit)
        if not any_hit:
            inst_out[idx] = best_inst
    return outs if any_hit else (*outs, inst_out)


def _broad_blocks(coef, b0, bcount, feat, lo):
    """Broad phase of two_phase on blocks [b0, b0 + bcount) for k rays
    (pallas_trace.py:416-461): the bf16x3 product, the 1-pass bf16
    magnitude product |c| |F|, error bounds e = TP_K * magnitude; per
    (block, ray) the least loose t and a sound lower bound of the t of any
    hit the block can hold ((ts - e_t) / (ad + e_det) over its loose
    triangles, -inf where not positive or the determinant's sign is
    unreliable); both inf where the block admits nothing."""
    k = feat.shape[1]
    c = coef[b0 * 256:(b0 + bcount) * 256]
    out = mt_product(c, feat, "high").view(bcount, 4, 64, k)
    mag = (_bf16(c).abs() @ _bf16(feat).abs()).view(bcount, 4, 64, k)
    sign = torch.where(out[:, 0] >= 0.0, 1.0, -1.0)
    out = out * sign[:, None]
    ad, us, vs, ts = out[:, 0], out[:, 1], out[:, 2], out[:, 3]
    e = TP_K * mag
    e_det, e_u, e_v, e_t = e[:, 0], e[:, 1], e[:, 2], e[:, 3]
    unrel = (ad <= e_det) & (mag[:, 0] > 0.0)
    solid = ad > e_det
    loose = unrel | (solid & (us >= -e_u) & (vs >= -e_v)
                     & (us + vs <= ad + e_u + e_v + e_det)
                     & (ts > lo * ad - lo * e_det - e_t - TP_ABS))
    tl_val = torch.where(unrel, 3e36, ts * (1.0 / torch.clamp(ad, min=1e-37)))
    num = ts - e_t
    lo_val = torch.where(unrel | (num < 0.0), -INF, num / (ad + e_det))
    return (torch.where(loose, tl_val, INF).amin(dim=1),
            torch.where(loose, lo_val, INF).amin(dim=1))


def _keep_two(cand, t_new, lo_new, tag_new):
    """Merge (n, k) block candidates (loose t, lower bound, tag), in
    visiting order, into the two of least t per ray; a tie keeps the
    earlier one, as the kernel's strict-< slots do. The lower bounds of
    the blocks not kept lower the ray's `evicted` bound."""
    t_keep, lo_keep, tag_keep, evicted = cand
    got = t_new < 3e37
    ts = torch.cat([t_keep, torch.where(got, t_new, 3e38)])
    los = torch.cat([lo_keep, torch.where(got, lo_new, INF)])
    tags = torch.cat([tag_keep, torch.where(got, tag_new, -1)])
    order = torch.argsort(ts, dim=0, stable=True)
    pick, rest = order[:2], order[2:]
    evicted = torch.minimum(evicted, los.gather(0, rest).amin(dim=0))
    return (ts.gather(0, pick), los.gather(0, pick), tags.gather(0, pick),
            evicted)


def trace_wide_two_phase_plain(rays, nodes, blocks, meta, inst_feat=None,
                               max_elems: int | None = None):
    """Plain PyTorch version of `trace_wide` at mt_precision="two_phase"
    (K5): closest hit over a one-level tree, or an instanced one given
    `inst_feat`, with K1's (K3's) outputs.

    The kernel's two phases in brute force, independent of the tree: the
    broad phase (`_broad_blocks`) runs over every block (every instance's
    blocks with its object features, in instance order) and keeps each
    ray's two blocks of least loose t, tagged inst << 14 | block as in the
    TPU kernel, and the least lower bound over the blocks not kept; the
    refine re-tests the distinct candidates in ascending tag order with
    the exact fp32 product and K1's accept tests against tmax, committing
    a strictly smaller t, from best = tmax; a ray whose not-kept blocks
    could still beat the refined best is traced again by the exact brute
    force (`trace_wide_plain` / `trace_wide_inst_plain`), as the kernel
    walks it again. The broad phase's cull bound only prunes the kernel's
    walk, so it has no counterpart here: the brute force sees every
    block."""
    n_blocks = blocks.shape[0]
    dev = rays.device
    outs, live, nr, nb = _plain_setup(rays, n_blocks, max_elems)
    inst_out = torch.zeros(rays.shape[1], dtype=torch.int32, device=dev)
    done = outs if inst_feat is None else (*outs, inst_out)
    if live.numel() == 0 or n_blocks == 0:
        return done
    if inst_feat is None:
        groups = [(0, 0, n_blocks, None)]
        tmat = None
    else:
        tmat = inst_feat[:, :, 0:10]
        ranges = instance_block_ranges(meta, inst_feat.shape[0]).tolist()
        groups = [(i, lo, hi, tmat[i]) for i, (lo, hi) in enumerate(ranges)
                  if hi > lo]
    feat = ray_features(rays[:, live])
    tmin, tmax = rays[6, live], rays[7, live]
    coef = blocks.transpose(1, 2).reshape(n_blocks * 256, 10)
    blk_rows = blocks.transpose(1, 2)                      # (B, 256, 10)
    n_ref = max(1, nr * 256 // 2560)   # refine gathers 2,560 floats a ray
    again = []
    for r0 in range(0, live.numel(), nr):
        fr = feat[:, r0:r0 + nr]
        k = fr.shape[1]
        lo, hi = tmin[r0:r0 + k], tmax[r0:r0 + k]
        cand = (torch.full((2, k), 3e38, device=dev),
                torch.full((2, k), INF, device=dev),
                torch.full((2, k), -1, dtype=torch.int64, device=dev),
                torch.full((k,), INF, device=dev))
        for inst, b_lo, b_hi, tm in groups:
            fg = fr if tm is None else tm @ fr
            for b0 in range(b_lo, b_hi, nb):
                bcount = min(nb, b_hi - b0)
                t_l, t_lo = _broad_blocks(coef, b0, bcount, fg, lo)
                tags = ((inst << 14) + torch.arange(
                    b0, b0 + bcount, device=dev))[:, None].expand(-1, k)
                cand = _keep_two(cand, t_l, t_lo, tags)
        c1, c2 = cand[2][0], cand[2][1]
        first = torch.where((c1 >= 0) & (c2 >= 0), torch.minimum(c1, c2),
                            torch.maximum(c1, c2))
        second = torch.where((c1 >= 0) & (c2 >= 0) & (c1 != c2),
                             torch.maximum(c1, c2), -1)
        st = _plain_state(hi)
        best_inst = torch.zeros(k, dtype=torch.int64, device=dev)
        for tag in (first, second):
            for s0 in range(0, k, n_ref):
                sel = s0 + torch.nonzero(tag[s0:s0 + n_ref] >= 0).squeeze(1)
                if sel.numel() == 0:
                    continue
                b = tag[sel] & 0x3FFF
                f = fr[:, sel]
                if tmat is not None:
                    f = torch.bmm(tmat[tag[sel] >> 14],
                                  f.T[:, :, None])[..., 0].T
                out = torch.bmm(blk_rows[b], f.T[:, :, None])[..., 0]
                out = out.T.reshape(4, 64, -1)
                sign = torch.where(out[0] >= 0.0, 1.0, -1.0)
                ad, us, vs, ts = out * sign
                ok = ((ad > DET_EPS) & (us >= 0.0) & (vs >= 0.0)
                      & (us + vs <= ad) & (ts > lo[sel] * ad)
                      & (ts < hi[sel] * ad))
                t = torch.where(ok, ts / torch.clamp(ad, min=1e-37), INF)
                tb, arg = torch.min(t, dim=0)
                found = tb < st["best"][sel]
                pick = arg[None]
                iad = 1.0 / torch.clamp(ad.gather(0, pick)[0], min=1e-37)
                f_sel = sel[found]
                st["best"][f_sel] = tb[found]
                st["sid"][f_sel] = (b * 64 + arg)[found]
                st["bu"][f_sel] = (us.gather(0, pick)[0] * iad)[found]
                st["bv"][f_sel] = (vs.gather(0, pick)[0] * iad)[found]
                best_inst[f_sel] = (tag[sel] >> 14)[found]
        idx = live[r0:r0 + k]
        _plain_store(outs, idx, st, False)
        inst_out[idx] = best_inst.to(torch.int32)
        again.append(idx[cand[3] < st["best"]])
    again = torch.cat(again)
    if again.numel():
        sub = rays[:, again]
        exact = (trace_wide_plain(sub, nodes, blocks, meta, False, max_elems)
                 if inst_feat is None else
                 trace_wide_inst_plain(sub, nodes, blocks, meta, False,
                                       inst_feat, max_elems))
        for dst, src in zip(done, exact):
            dst[again] = src
    return done


def _part1by2(x):
    """Spread 10 bits of x so there are two zero bits between each."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _ray_sort_key(o, d, lo, inv_extent):
    """Direction-octant (high bits) + 21-bit Morton code of the origin, in
    int32 (pallas_trace.py:1295-1314)."""
    q = torch.clamp((o - lo) * inv_extent, 0.0, 1.0)
    qi = (q * 127.0).to(torch.int32)
    morton = (_part1by2(qi[:, 0])
              | (_part1by2(qi[:, 1]) << 1)
              | (_part1by2(qi[:, 2]) << 2))
    octant = ((d[:, 0] < 0).to(torch.int32)
              + 2 * (d[:, 1] < 0).to(torch.int32)
              + 4 * (d[:, 2] < 0).to(torch.int32))
    return (octant << 21) | morton


def sort_frame(nodes):
    """(lo, 1/extent) of the scene for the Morton key, from the root
    node's valid child slots; nodes: (N, 16, 8)."""
    root = nodes[0]
    valid = root[:, 6:7] != -1.0
    lo = torch.where(valid, root[:, 0:3], 1e30).amin(dim=0)
    hi = torch.where(valid, root[:, 3:6], -1e30).amax(dim=0)
    return lo, 1.0 / torch.clamp(hi - lo, 1e-12, 1e30)


def make_packet_tracer(wnodes, wtris, wmeta, wslot=None,
                       sort: bool | None = None, trace_fn=trace_wide,
                       inst_feat=None, worder=None, stream: bool = False,
                       mt_precision: str = "highest",
                       pipe: bool = False, flat_walk: bool = False,
                       profile: str | None = None):
    """(trace_closest, trace_any) over the packed wide-BVH tensors.

    wnodes: (N, 128) f32 node rows; wtris: (B, 10, 256) f32 coefficient
    blocks; wmeta: (N*16,) i32 child meta; wslot: (B*64,) i32 slot ->
    triangle id (None if slot ids are triangle ids). `inst_feat` ((I, 10,
    128) feature transforms, accel.tlas) selects the two-level tree: hit
    records then carry the instance id. `sort` reorders each wave by
    octant + Morton key (default: trees of more than 64 nodes). As in the
    JAX package's make_packet_tracer: `worder` ((N*16,) i32 octant orders,
    accel.wide.build_octant_orders) walks closest-hit waves near-first
    (K7; any-hit waves keep the plain walk, and so does the pipelined
    walk, pallas_trace.py:1459); `stream` traces a streamed structure
    (K6); `mt_precision` is the MT tier of closest-hit waves (PRECISIONS:
    K1, K4, K5; any hit stays exact fp32); `pipe` takes the
    pipelined walk and `flat_walk`, which implies it, its flat push (K9);
    `profile` (default PROFILE) is an ablation mode (PROFILES). An unknown
    tier, two_phase over streamed blocks, and `pipe` or `profile` with
    `stream` raise, as they do in the JAX package; so do `pipe` with a
    reduced tier (the JAX package silently runs fp32) and `flat_walk` over
    a tree with a multi-block leaf (the JAX package does not check).
    Unlike the JAX package, two_phase is not refused on the accelerator
    (its refusal there rests on TPU measurements and a Mosaic reduce
    fault, pallas_trace.py:1383-1397). `trace_fn` traces one (8, R) wave
    with trace_wide's arguments: the kernel wrapper `trace_wide`, or
    `trace_wide_reference` to hold a render to the plain version. At a
    reduced tier the blocks' pre-split planes (`split_planes`) are built
    once, here, and passed with every wave (`trace_closest.planes`; None
    at "highest"; the plain versions ignore them).

    `trace_closest.paired(oc, dc, tminc, tmaxc, oa, da, tmina, tmaxa,
    active_c=None, active_a=None)` traces a closest-hit wave and an
    any-hit wave in one launch (K8) and returns (HitRecord, occluded);
    one tree level only. Both functions carry `capturable`, True when
    `trace_fn` is `trace_wide`: their waves then neither read the device
    on the host nor copy from it, so a CUDA graph may capture them."""
    pipe = bool(pipe) or flat_walk
    profile = PROFILE if profile is None else profile
    check_mode(mt_precision, stream, pipe, flat_walk, profile)
    n_nodes = wnodes.shape[0]
    nodes = wnodes.reshape(n_nodes, 16, 8).contiguous()
    blocks = wtris.contiguous()
    meta = wmeta.to(torch.int32).contiguous()
    slot_map = wslot.long() if wslot is not None else None
    # once, here: raises on a multi-block leaf under the flat push
    walk = _walk_code(meta, pipe, flat_walk, checked=False)
    _check_profile(profile, inst_feat, worder, stream)
    if worder is not None:
        worder = worder.to(torch.int32).contiguous()
        if worder.shape != (n_nodes * 16,):
            raise ValueError(f"worder must be ({n_nodes * 16},) octant "
                             f"orders, got {tuple(worder.shape)}")
        if pipe:
            worder = None   # pallas_trace.py:1459: no octant order there
    if inst_feat is not None:
        inst_feat = inst_feat.to(torch.float32).contiguous()
    else:
        # an instanced tree (leaf vals carry inst << 19) traced without
        # inst_feat would decode garbage block ids; plain block ids never
        # reach the block count (pallas_trace.py:1414-1424)
        lv = -meta[meta <= -2].long() - 2
        if lv.numel() and int((lv >> 5).max()) >= blocks.shape[0]:
            raise ValueError(
                "instanced wide-BVH (leaf vals carry instance tags) passed "
                "without inst_feat; pass the (I, 10, 128) feature "
                "transforms from accel.tlas / render.flatten")
    if sort is None:
        sort = n_nodes > SORT_MIN_NODES

    scene_lo, inv_extent = sort_frame(nodes)
    # the reduced tiers' closest hit reads the blocks' pre-split planes:
    # split once, here, for every wave this tracer traces
    planes = split_planes(blocks) if mt_precision != "highest" else None
    capturable = trace_fn is trace_wide
    if capturable:
        # the mode was checked above and the tree is checked here, once:
        # each wave checks its rays alone
        if nodes.device.type == "cuda":
            _check_tree(nodes.device, nodes, blocks, meta, inst_feat, worder,
                        planes, mt_precision)

        def trace_wave(rays, any_hit):
            return _trace_wave(rays, nodes, blocks, meta, any_hit, inst_feat,
                               None if any_hit else worder, mt_precision,
                               stream, walk, profile, planes)
    else:
        walk_opts = {}
        if pipe:
            walk_opts.update(pipe=True, flat_walk=flat_walk,
                             checked=flat_walk)
        if profile != "none":
            walk_opts.update(profile=profile)

        def trace_wave(rays, any_hit):
            return trace_fn(rays, nodes, blocks, meta, any_hit, inst_feat,
                            worder=None if any_hit else worder,
                            mt_precision=mt_precision, stream=stream,
                            planes=planes, **walk_opts)

    def _sorted_wave(o, d, tmin, tmax, active):
        """One wave as (8, R) rows in kernel order, and the permutation
        that sorted it (None if it was not sorted)."""
        r = o.shape[0]
        dev = o.device
        # a Python bound becomes a fill, not a copy from the host
        tmin, tmax = (
            torch.full((r,), x, dtype=torch.float32, device=dev)
            if not torch.is_tensor(x)
            else x.to(dtype=torch.float32, device=dev).expand(r)
            for x in (tmin, tmax))
        if active is not None:
            tmax = torch.where(active, tmax, tmin - 1.0)
        perm = None
        if sort and r >= SORT_MIN_RAYS:
            key = _ray_sort_key(o, d, scene_lo, inv_extent)
            if active is not None:
                key = torch.where(active, key, DEAD_KEY)
            perm = torch.argsort(key, stable=True)
            o, d, tmin, tmax = o[perm], d[perm], tmin[perm], tmax[perm]
        rays = torch.stack([o[:, 0], o[:, 1], o[:, 2],
                            d[:, 0], d[:, 1], d[:, 2], tmin, tmax])
        return rays, perm

    def _unsort(perm, cols):
        if perm is None:
            return cols
        inv = torch.empty_like(perm)
        inv[perm] = torch.arange(perm.shape[0], device=perm.device)
        return [c[inv] if c is not None else None for c in cols]

    def _record(t, sid, u, v, inst=None):
        if slot_map is not None:
            sid = torch.where(sid >= 0, slot_map[torch.clamp(sid, min=0).long()]
                              .to(torch.int32), -1)
        hit = sid >= 0
        return HitRecord(t=torch.where(hit, t, INF), tri=sid,
                         bary=torch.stack([u, v], dim=-1), hit=hit,
                         inst=(torch.where(hit, inst, 0)
                               if inst is not None else None))

    def _run(o, d, tmin, tmax, active, any_hit):
        rays, perm = _sorted_wave(o, d, tmin, tmax, active)
        out = trace_wave(rays, any_hit)
        t, sid, u, v, inst = _unsort(
            perm, [*out[:4], out[4] if len(out) > 4 else None])
        if any_hit:
            return sid >= 0
        return _record(t, sid, u, v, inst)

    def trace_closest(o, d, tmin, tmax, active=None) -> HitRecord:
        return _run(o, d, tmin, tmax, active, any_hit=False)

    def trace_any(o, d, tmin, tmax, active=None) -> torch.Tensor:
        return _run(o, d, tmin, tmax, active, any_hit=True)

    def trace_paired(oc, dc, tminc, tmaxc, oa, da, tmina, tmaxa,
                     active_c=None, active_a=None):
        """A closest-hit wave and an independent any-hit wave in one
        launch (K8). Each wave is sorted by its own key and unsorted on
        its own permutation. Returns (HitRecord of the closest wave,
        occlusion of the any-hit wave). As in the JAX package it honours
        `stream` and the tier, never `pipe` or the octant order."""
        if inst_feat is not None:
            raise ValueError("paired tracing: non-instanced only")
        if profile != "none":
            raise ValueError("paired tracing has no profile modes")
        rays_c, perm_c = _sorted_wave(oc, dc, tminc, tmaxc, active_c)
        rays_a, perm_a = _sorted_wave(oa, da, tmina, tmaxa, active_a)
        if capturable:
            (t, sid, u, v), occ = _paired_wave(
                rays_c, rays_a, nodes, blocks, meta, mt_precision, stream,
                planes)
        else:
            t, sid, u, v = trace_fn(rays_c, nodes, blocks, meta, False, None,
                                    mt_precision=mt_precision, stream=stream,
                                    planes=planes)
            occ = trace_fn(rays_a, nodes, blocks, meta, True, None,
                           mt_precision=mt_precision, stream=stream,
                           planes=planes)[1]
        rec = _record(*_unsort(perm_c, [t, sid, u, v]))
        return rec, _unsort(perm_a, [occ])[0] >= 0

    # the paired entry and the planes ride as attributes so that the
    # (closest, any) pair stays what callers unpack
    trace_closest.paired = trace_paired
    trace_closest.planes = planes
    trace_closest.capturable = trace_any.capturable = capturable
    return trace_closest, trace_any
