"""Drive the PyTorch/CUDA port (platinum_tpu_torch) once on one GPU.

    python3 chip_smoke.py

Phases, one printed block each (any failure exits non-zero):
  1. device: a CUDA device must be present; prints nvidia-smi's name and
     power limit
  2. build: compiles the three kernel sources (csrc/wide_trace.cu,
     csrc/stream_mt.cu, csrc/bf_stream.cu; one nvcc each, started
     together) and the native BVH construction library from the checkout
  3. K1/K2 vs plain: the kernel's closest-hit and any-hit modes against
     the plain PyTorch version on the full colonnade (271k triangles), on
     16,384 rays each of a camera wave, a bounce-like wave from surface
     points and a wave of shadow segments to light points; then each
     whole 262,144-ray wave, timed and counted (node pops, MT tests) for
     the kernel's least possible time. Every disagreeing ray must be
     certified borderline in float64 (`_borderline`, `_fp32_ambiguous`).
     K1 (like K3 closest and K6 closest) tests each leaf block with the
     whole warp over the fp32 blocks, K2 (like K3 and K6 any hit) on the
     warp-wide any-hit drain
  3b. K3 vs plain: the same for the two-level modes on the colonnade
     flattened with instancing="on" (K3's and K9's bounds count the
     instance entries of the per-thread pipelined walk, `pipe=True,
     per_thread=True`, on the same wave: the drains re-enter an instance
     per round); then K3 closest (the warp-wide drain, ten lanes forming
     each drained ray's object features) against the per-thread pipelined
     walk with the instance features on the whole camera, bounce and
     shadow waves (shadow traced as closest hit): every output, the
     instance id included, bit for bit, no exception; instance entries
     per drain round and lanes per distinct block on each; and K3 any hit
     (the any-hit drain, resident and with stream=True) against the same
     walk on the whole shadow wave: every output bit for bit, per ray that
     nothing occludes its pops and MT block tests, with its drain counts
  3c. the pre-split planes of the colonnade's blocks (the split kernel
     against its plain version in every bit, both timed), then K4
     ("high"), K5 ("two_phase") and K7 (octant order), K4 and K5 over
     those planes,
     vs plain on the colonnade's camera and bounce waves, as in 3: the
     16,384-ray subsets, then the whole waves timed and counted and held
     (K4 both; K5 and K7 the bounce wave: 3d holds them to K1 on both)
     (K4's certification adds the bf16 split error to the fp32 forward
     error, and K4's t must equal its plain version's to HIGH_T_RTOL,
     a few fp32 ulps, wherever the ids agree)
  3d. K5 and K7 against K1 on the whole waves (K5 also on the shadow
     wave, traced as closest hit): hit set and t bit for bit, ids equal
     outside exact-t ties; every exception printed and certified. Then
     K7 (the fp32 drain, each lane's queue newest first) against the
     per-thread queued walk under the same octant order (`per_thread=
     True`) on the whole camera, bounce and shadow waves as closest hit:
     every output bit for bit and per ray the same node pops and MT block
     tests, no exception
  3e. K4 against K1 on the whole waves with the bars of
     tests/test_pallas_trace.py:209-220, held on the camera wave (rays from
     free space, as in that test) and printed for the bounce wave; on both
     waves K4's t must differ from K1's on >= TIER_DIFF_MIN of the hits
     where the triangles agree (the tier is not fp32)
  3f. K6 (streamed blocks) on bistro_class_studio's tree (the colonnade at
     24x12, 1.08M triangles, flattened with stream="auto") vs plain on
     16,384-ray subsets of its own 960x540 waves (the plain version takes
     about a minute a whole wave), timed and counted on the whole
     518,400-ray waves, and bit for bit against K1/K2 on all three whole
     waves of the same tree (K1/K2 timed there too; no exception); K2 and
     K6 any hit, the warp-wide any-hit drain, against its per-thread
     reference, the classic any-hit walk (`per_thread=True`), on the whole
     shadow wave: every output on every ray, and per ray that walk's node
     pops and MT block tests, with their drain counts; K1 and K6 closest
     against the per-thread pipelined walk on the camera, bounce and shadow
     waves as closest hit, with no exception, and the drain's lanes per
     distinct block on each; K9 (pipe, flat_walk) against the per-thread
     pipelined walk on the three whole waves as 3h holds it; the
     instanced stream modes on the colonnade flattened with
     instancing="on", stream="on"
  4. the headline without compaction: Renderer(scene).start_render at
     512x512, 2 spp, 8 bounces, mis, halton, the packet tracer; both K1/K2
     modes must launch
  4b. the instanced main path (bench.py's sponza_instanced_512 cut to
     4 spp): Renderer(scene) on the default device, compact=True,
     instancing="on"; render() until done, readback(), EXR export; only
     the K3 modes may launch. Then update_instance_transform moves one
     column, one spp renders, and the refit tree's closest hits on a
     camera wave must match a fresh flatten of the moved scene
  4c. the headline with compaction (bench.py's sponza_class_512 cut to
     4 spp): compact=True, compact_plan="auto", instancing="off"; then
     the host syncs (torch's sync debug mode) and make_tracers calls of
     one spp through render_step_n without `tracers=` (a pair per
     sample) and through Renderer.render (the pair start_render built)
  4d. sponza_class_512_mt3_knob cut to 4 spp: 4c with mt_precision="high";
     only K4 ("closest+high"), K2 and the split kernel (once, at
     start_render) may launch; the image mean within 1% of 4c's
  4e. bistro_class_studio at its 4 spp: the 1.08M-triangle colonnade at
     960x540, 4 bounces, compact=True (static plan), instancing="off",
     stream="auto"; the tree must stream, and only the K6 modes may
     launch. Its edit-loop cadence waits for the preview ladder
  4f. the headline (4c's settings) at 2 spp with neither option (K1), with
     mt_precision="two_phase" (K5) and with oct_order=True (K7); each
     launches only its closest mode and K2, and each image mean is within
     MEAN_RTOL of the K1 render's
  5. K1/K2 kernel path against the plain path end to end: the colonnade
     at 64x64, 1 spp, default tracers vs the plain tracer pair
  5b. the same for the instanced colonnade at 96x96 x 1 spp (9,216 lanes,
     so the static plan compacts) with the plain K3 pair; and
     ops/threefry.uniform on the card bitwise equal to the CPU
  5c. the same per new mode at 64x64 x 1 spp: "high", "two_phase",
     oct_order, and stream="on" on the headline colonnade
  3g. K8, the paired launch (each 128-ray CTA on its half's unpaired
     drain): paired(camera wave, shadow wave) and paired(bounce wave,
     shadow wave) bit for bit K1 / K2 on the whole waves, and so is K8's
     per-thread reference (`per_thread=True`), then with either wave cut
     to 100,000 rays; each pair timed in turns against that reference and
     K1 and K2 launched one after the other; the counting tables of both
     halves row for row K1's and K2's (drain rows included); (bounce, shadow) at "high",
     "default" and "two_phase" against K4 / K5 and K2 the same way, timed;
     K2 (the any-hit drain) against its per-thread reference, the classic
     any-hit walk, on the whole shadow wave: every output on every ray and
     per ray the node pops and MT block tests; on the bistro tree with
     stream=True against K6; through the tracer's `trace_closest.paired`
     entry, which is the path that counts its launches
  3h. K9, the pipelined drain, with and without the flat push: closest
     and any hit against K1/K2 as 3d holds K5 and K7 (closest hit with no
     exception); against the per-thread pipelined walk it keeps lane by
     lane (`per_thread=True`) on the camera, bounce (closest hit) and
     shadow (any hit) waves: every output bit for bit, per ray the same
     node pops and MT block tests, with its drain counts; K1 against the
     per-thread pipelined walk on the three waves as closest hit, with the
     drain's rounds, distinct blocks and lanes per distinct block on each;
     and on the instanced colonnade against K3 and the per-thread walk,
     with counts and times; against the plain version on the 16,384-ray
     subsets; both timed and held to K1/K2 and to the per-thread walk on
     the bistro tree's whole waves too
  3i. the ablation modes, on the per-thread walk: "empty" and "nomt"
     miss everything, "nomt" pops no fewer nodes than K1 and tests no
     block, "count" is K1 with u = the per-thread walk's pops (fix64's
     count up to 64; no more than K1's warp-wide walk pops, K2's exactly),
     "fix64" is K1 on every ray whose walk ends within 64
     pops; launch floor / walk / MT split of each headline wave and the
     bistro bounce wave, on the classic and the queued walk; through
     make_packet_tracer(profile=...), the path that counts their launches
  3j. K15, the leaf-pair kernel: on every leaf level's real pairs of the
     camera, bounce and shadow waves, the chunked kernel (each block
     staged once per CTA, several pairs a thread) against its
     one-thread-per-pair reference (`per_pair=True`) in every output bit
     at "highest", "high" and "default", both timed there in device time
     (`_device_ms`: calls queued behind a sleep, so the host's launch
     overhead does not count); against its plain version; the whole
     ray-stream tracer against K1/K2 bit for bit on the whole waves; every
     level's pair and leaf-pair counts beside the JAX module's static caps;
     time per wave split into kernel and host glue. Then K4 "high" against
     the ray-stream tracer at "high" on the three whole waves (the shadow
     wave as closest hit): hit set, t, ids and barycentrics bit for bit,
     every exception borderline in float64 and K4's result on it, bit
     for bit, that of its walk replayed one thread at a time with K15's
     block tests (a reduced tier's t can fall in front of its own leaf's
     box, so the two walks' culls can differ); with the warp drain's
     distinct blocks per round and lanes per distinct block on each wave
  3k. K10-K14, the breadth-first pipeline (csrc/bf_stream.cu), on the
     headline's whole camera, bounce and shadow waves (262,144 rays, one
     segment each): the tracer (closest on camera and bounce, its own
     any-hit mode on shadow) bit for bit K1/K2; then every level's K10,
     K11 + K12 (on fresh buffers), K13 and, deepest first, K14 against
     their plain versions on the recorded inputs, every output in every
     bit (K11: its scan block and its fill grid, the tables, every lane of
     the pair lists and the status row); per level its tiles, nodes, live
     pairs and MT tiles against the
     capacities and the pairs lost; per wave the tracer's time, the host
     syncs torch's sync debug mode counts, the launches, each kernel's
     device time summed over the levels beside its plain version's and its
     bound, and one scatter_reduce "amin" of packed (t, slot) keys per
     level over K14's pre-gathered edges (routing and gathers untimed: no
     PyTorch call computes K14's function, so its library entry is null)
     and one index_put_ of the live lanes' ray ids at K12's pre-formed
     positions per level (K12's library entry, marked as part of its work:
     the routing is untimed); the redesigned K10 and K12 on every level,
     K13 at every tier and K14 on every level against the kernels they
     were before (`per_block=True`, `per_tile=True`, `per_unit=True`) in
     every bit, each timed beside them, and the MT tiles by live lanes
  4j. sponza_class_512's settings with tracer="bf" at 2 spp through the
     Renderer: the Renderer fills bf_depth, only K10-K14 (closest mode)
     and K2 may launch, the image K1's (RMSE 0 against 4f's render at the
     same 2 spp); launches per spp and per kernel
  3c also times K4 at mt_precision="default" on the bounce wave, with its
     bound (one bf16 product per block test), and launches it once
     through make_packet_tracer
  4g. sponza_class_512's settings with the ray-stream pair as `tracers=`,
     2 spp through integrator.render_step_n; only K15 may launch; image
     mean within MEAN_RTOL of 4f's K1 render at the same 2 spp
  4i. sponza_class_512's settings with the pipelined packet tracer
     (pipe=True, then flat_walk=True) as `tracers=`, 2 spp each through
     integrator.render_step_n; only the K9 modes may launch; image mean
     within MEAN_RTOL of 4f's K1 render at the same 2 spp, and the image
     within RMSE IMAGE_RMSE of it
  4h. sponza_class_512 at 4 spp with fuse_shadow, with spp_batch=2 and
     with chunk_shade=65536, against 4c: image mean to MEAN_RTOL, largest
     per-pixel difference printed, trace launches and all kernel launches
     per spp printed beside 4c's
  5d. kernel path against plain path at 64x64 x 1 spp for pipe, flat_walk
     and the ray-stream pair
  6. sponza_class_512 as bench.py runs it (bench.py:149-181, 231-242): the
     colonnade written by tools/foreign_glb.py and read back by io/gltf.py
     (camera physics and environment carried over), 4 spp through the
     Renderer; the loaded world triangles within TRI_RTOL of the direct
     build's, only K1/K2 launch, the image mean within MEAN_Z standard errors of the
     per-pixel difference from 4c's image (the file carries no tangents:
     the loader makes them with mikktspace, so a few paths fork); the
     .glb's size and the export and load seconds
  6b. metalrough_spheres (bench.py:254-264) through the foreign GLB at
     512x512, 6 bounces, 4 spp: only K1/K2 launch; on the camera wave's
     hits sample_material_textures and sample_normal_map on the card
     against the same calls on the CPU to TEX_ATOL
  6c. metalrough_spheres_gmon (bench.py:266-292): 8 GMoN buckets cut to
     16 spp; Renderer to DONE, readback; gmon_combine of the card's
     buckets against the CPU to GMON_ATOL, the window's buckets equal
  6d. studio_loop (bench.py:310-346): the colonnade at 960x540 through
     the Renderer with the preview ladder (4 frames at 1/4 the size, each
     render + readback timed: interact_ms_per_frame), then 2 spp; the post
     stack on the card against the CPU for agx, khronos_pbr and flim to
     POST_ATOL; export_png read back: the size, and the iCCP profile is
     io/icc.profile_for("sRGB")
  6e. the port's CLI in the process: `render <6b's .glb> --spp 4 --size
     512x512 --gmon 4 -o <png>` on the card writes a 512x512 PNG through
     K1 (the file alone has no light: the image is black and no shadow ray
     is traced)
  7. alpha cutout at full width: sponza_class_512's settings
     (bench.py:231-242) on the colonnade with tests/test_golden.py:88-94's
     checker texture, alpha and all, on its `column` material, cut to 4
     spp: only K1 launches (K2 never: shadow rays trace closest hits
     through the cutouts); K1's launches per spp and ms/spp printed; then
     its kernel path against the plain tracer pair at 64x64 x 1 spp, held
     per pixel as 5 holds the headline, the means printed (the column
     bases are coplanar with the floor, and the tracers break that exact
     tie apart), and every closest-hit call of the kernel path traced
     again by the plain pair: each disagreeing ray a tie or borderline
  7b. (the cutout_shadows golden is 9b's case now, held)
  7c. the Z-sampler: ZStream's index and draws on the card bitwise the
     CPU's over a 512x512 wave; the headline at 2 spp with sampler="z"
     (K1/K2 only), ms/spp printed
  7d. the colonnade saved through the port's Store.save_as (.ptscene) and
     opened again: every flattened tensor and the 512x512 x 1 spp image
     bit for bit the original's
  7e. the studio: StudioRenderer at 960x540 on the colonnade, ms per
     frame (only K3 closest launches: the studio flattens with
     instancing="auto", as the JAX studio does, and the colonnade's reused
     meshes go instanced); its ids and colours against the plain tracer pair; a
     pick; the CLI's `preview` of 7d's .ptscene with a pick, and a short
     `preview --interactive` session in the process (pick, orbit, zoom,
     select, frame, render 2, save, quit)
  8. partitioned baked: bistro_class_studio (bench.py:348-380) with
     stream="off", so it flattens into partitions of partition_tris =
     350,000 (their count printed), 2 spp through the Renderer: only
     K1/K2 launch (once per partition a wave; launches per spp and per
     partition printed), ms/spp beside 4e's streamed (K6) reading; on
     the camera wave and a bounce wave the sequential partitioned tracer
     against 4e's streamed single structure: ids equal on >= PART_AGREE,
     each other ray an exact-t tie or certified borderline in float64;
     shadow occlusion likewise; the image mean against the streamed
     structure's render of the same 2 samples within MEAN_RTOL and
     MEAN_Z standard errors
  8b. partitioned instanced: sponza_instanced_512 (bench.py:302-308) cut
     to 2 spp with stream="off" and partition_bytes lowered to
     INST_PART_BYTES (a test scaffold: the colonnade's instanced
     structure fits the default budget) so partition_instanced splits it;
     K3 runs per partition; one update_instance_transform on a column;
     then the renderer's partitioned tracer against the unpartitioned
     instanced structure of the moved scene on a bounce wave: ids
     (triangle and instance) equal on >= PART_AGREE
  8c. render_sample(pixel_ids=) and the tile / sample mesh on the card:
     two ranks on a gloo group share cuda:0 (spawned, a FileStore in a
     temporary directory); sponza_class_512 (512x512, 8 bounces, the auto
     plan, and again with compact=False) for 2 spp on a tile=2 mesh, then
     a sample=2 mesh: each rank's shard bitwise a single-process
     render_sample(pixel_ids=) of its pixels; the assembled image within
     GEOM_ATOL of the single-device render, except the tile mesh with
     compaction (lanes drop differently on a subset), whose mean holds by
     6's z-test; one more step on a one-rank NCCL group in this process
     (bitwise render_sample); the backend of each group and which
     collectives gloo takes on CUDA tensors printed
  8d. geometry sharding: two gloo ranks on cuda:0 with geom=2 on 8's
     partitioned bistro at 960x540: the geom-sharded tracer's hits and
     occlusion on 8's bounce and shadow waves bitwise 8's sequential
     tracer's (the rays whose ranks' bests nearly tie, traced again in
     rank order, counted); both ranks' 1-spp radiance bitwise equal (the
     same-wave check) and within GEOM_ATOL of 8's at the same sample
     index
  8e. the CLI on a mesh: `python -m torch.distributed.run --standalone
     --nproc-per-node 2 -m platinum_tpu_torch.app.cli render colonnade
     --size 512x512 --spp 2 --mesh tile=2 -o out.png`: exit 0, the
     stderr mesh line with its seconds, one file written (rank 0's)
  9. the binary-BVH tracer (ops/traverse.py, `tracer="bvh"`: torch ops,
     as the JAX module is pure jnp) on the colonnade's 512x512 camera wave
     (closest hit) and shadow wave (any hit): ms a wave, host syncs, CUDA
     kernels of the camera wave; held to K1/K2 on the whole waves (hit
     sets, ids, occlusion on >= AGREE; t to BVH_T_RTOL where ids agree)
     and to its own CPU run on the 16,384-ray subset
  9b. the round's closing check: every blessed golden of
     tests/test_golden.py (cornell, cornell_pcg4d, cornell_dof,
     furnace_rough_metal, spheres, spheres_foreign_glb, cutout_shadows,
     spheres_gmon), built by tests/golden_configs.py (no JAX) and rendered
     on the card at its own size, spp and sampler with accel_min_tris=32
     (the Renderer under GMoN), each held to RMSE <= 1e-3 against
     tests/goldens/<name>.exr; then cornell (accel_min_tris=1) and spheres
     with tracer="bvh", held to the same bar
  9c. the LUT baker (tools/lut_baker.py) on the card: every bake_* at size
     16, 64 samples, against the same bake on the CPU, each texel within
     rtol BAKE_RTOL / atol BAKE_ATOL or traced to at most BAKE_MAX_APART
     of its samples (a flipped decision or a tiny pdf, as
     tests/test_torch_lut_baker.py traces them); then `bake-luts --spp 1024 --exr` through the CLI in
     this process into a temporary directory: its seconds, the 101 EXR
     slices, the bundle loaded by ops/luts
  9d. bench.py's cornell_512 (bench.py:223-229, 64 -> 8 spp, the brute
     tracer) and helmet_env_1080p (bench.py:294-300, through the foreign
     GLB, 1920x1080, packet, compact_plan="auto", 16 -> 4 spp) through the
     Renderer: ms/spp, trace kernel launches per spp, CUDA kernels of one
     step; a 32x32 crop at the centre rendered with
     render_sample(pixel_ids=) on the card and on the CPU, held per pixel
     by phase 5's bars (and, where the Renderer did not compact, its
     image's crop too)
Each path's kernel launch counts are zeroed just before it and read just
after. The line before the last is the kernel table as JSON; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

T_RTOL, T_ATOL = 1e-4, 1e-5        # t bars (tests/test_pallas_trace.py)
TIE_RTOL, TIE_ATOL = 1e-5, 1e-6    # t within this = a tie: ids may differ
AGREE = 0.995                      # hit-set / occlusion agreement
PIX_RTOL, PIX_ATOL = 2e-3, 2e-3    # per-pixel bar (tests/test_torch_slice.py)
MEAN_RTOL = 1e-3
N_CMP = 16_384                     # rays per compared wave
N_WAVE = 512 * 512                 # rays per main-path wave
SEED = 20261016
MOVED_NODE = "col_6_4"             # the column the transform edit moves
MEAN_TIER_RTOL = 0.01              # 4d: image mean of "high" vs "highest"
# K4 against its plain version where the ids agree: both form the same
# exact bf16 products and differ at most in the order of fp32 sums, so t
# holds to a few ulps (2^-23 = 1.2e-7); the bf16x3-vs-fp32 gap is ~1e-5
# relative and moves t's bits on ~99.5% of hits (CPU plain versions, small
# colonnade), so an fp32 K4 fails TIER_DIFF_MIN
HIGH_T_RTOL = 1e-6
TIER_DIFF_MIN = 0.9
BISTRO = dict(columns=24, rows=12)  # bench.py's bistro_class_studio scene
COLONNADE = {}                      # bench.py's sponza_class_512 scene
# bf16 split products per MT dot term of each tier, and the bound on what
# the "high" split drops per term, relative to |c| |F| (l*l and the split
# residuals, <= 2^-16, taken with 4x headroom). "default" (1-pass bf16) is
# not held here: its t errors move hits across node boxes, so its walk
# and its brute-force plain version disagree by design on scene waves
# (tests/test_torch_gpu.py holds it on a random soup)
TIER_PASSES = {"highest": 0, "high": 3, "default": 1, "two_phase": 4}
SPLIT_REL = {"highest": 0.0, "high": 2.0 ** -14}
# least-time model (H100 SXM data sheet, 700 W): fp32 outside the tensor
# cores, dense bf16 on the tensor cores (the unit the reduced MT tiers
# exist for) and HBM3 bandwidth
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12
MT_FLOP = 64 * 4 * 10 * 2          # one (ray, block) test: 64 tris x 4 dots
SLAB_FLOP = 12                     # one child slab test: 6 sub + 6 mul
XFORM_FLOP = 10 * 10 * 2           # one instance entry: F_obj = T F
# The static capacities of the JAX ray-stream module, as multiples of the
# wave size R (platinum_tpu/ops/raystream.py:59-64): the port sizes every
# level's pair list exactly; 3j prints each level's counts beside them
PAIR_CAPS = (2.0, 2.0, 1.5, 1.5, 1.25, 1.25, 1.25, 1.25)
LEAF_CAP = 1.5
CAP_FLOOR = 16384


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def _card():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def phase_device():
    check(torch.cuda.is_available(), "no CUDA device (this script needs a GPU)")
    print(_card(), flush=True)
    try:
        import PIL
        pillow = f"Pillow {PIL.__version__} imports"
    except ImportError:
        pillow = "Pillow does not import (io/png.py needs none)"
    print(f"device: torch {torch.__version__}, cuda {torch.version.cuda}, "
          f"{torch.cuda.device_count()} visible; {pillow}", flush=True)
    return torch.device("cuda", 0)


def _instantiations(path):
    """Kernel instantiations in a built library, from cuobjdump's resource
    listing (one "Function" line each); None without cuobjdump."""
    tool = os.path.join(os.path.dirname(shutil.which("nvcc")
                                        or "/usr/local/cuda/bin/nvcc"),
                        "cuobjdump")
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "--dump-resource-usage", path],
                         capture_output=True, text=True).stdout
    return sum(1 for line in out.splitlines()
               if line.lstrip().startswith("Function "))


def phase_build():
    from platinum_tpu_torch.accel.native import native_available
    from platinum_tpu_torch.ops import packet_trace as pt

    t0 = time.perf_counter()
    paths = pt.build_kernels()
    t_kernels = time.perf_counter() - t0
    check(native_available(), "the native BVH builder did not build")
    counts = {k: _instantiations(v) for k, v in paths.items()}
    print(f"build: the kernel sources in {t_kernels:.2f} s (one nvcc each, "
          f"started together), instantiations {counts}; with the native "
          f"BVH library {time.perf_counter() - t0:.2f} s -> "
          f"{[os.path.relpath(v) for v in paths.values()]}", flush=True)


def _zero_launches():
    from platinum_tpu_torch.ops import bfstream as bf
    from platinum_tpu_torch.ops import packet_trace as pt
    from platinum_tpu_torch.ops import raystream as rs

    for table in (pt.LAUNCHES, rs.LAUNCHES, bf.LAUNCHES):
        for mode in table:
            table[mode] = 0


def _launches():
    """Launch counts of the three kernel sources; the leaf-pair kernel's
    modes carry a "stream_mt " prefix, the breadth-first kernels' a "bf "
    prefix."""
    from platinum_tpu_torch.ops import bfstream as bf
    from platinum_tpu_torch.ops import packet_trace as pt
    from platinum_tpu_torch.ops import raystream as rs

    return {**pt.LAUNCHES,
            **{f"stream_mt {k}": v for k, v in rs.LAUNCHES.items()},
            **{f"bf {k}": v for k, v in bf.LAUNCHES.items()}}


def _rays(o, d, tmin, tmax):
    r = o.shape[0]
    return torch.stack([o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
                        tmin.expand(r), tmax.expand(r)]).contiguous()


def _wave_points(baked, dev, width=512, height=512):
    """World-space wave sources from a numpy seed: camera rays of the
    width x height view, as many surface points with random directions,
    and segments from the same points to random points on the lights."""
    from platinum_tpu_torch.render.integrator import init_path_state
    from platinum_tpu_torch.render.types import RenderSettings

    n = width * height
    rng = np.random.default_rng(SEED)
    st = init_path_state(baked, RenderSettings(width=width, height=height,
                                               sampler="halton"), 0)

    def surface_points(table, count):
        rows = table[torch.from_numpy(rng.integers(0, table.shape[0], count))
                     .to(dev)]
        b = torch.from_numpy(rng.random((count, 2), np.float32)).to(dev)
        b = torch.where(b.sum(-1, keepdim=True) > 1.0, 1.0 - b, b)
        return rows[:, 0:3] + rows[:, 3:6] * b[:, 0:1] + rows[:, 6:9] * b[:, 1:2]

    p = surface_points(baked.geometry.tri_geo, n)
    d = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)).to(dev)
    d = d / d.norm(dim=-1, keepdim=True)
    seg = surface_points(baked.lights.packed, n) - p
    dist = seg.norm(dim=-1)
    sample = torch.from_numpy(rng.choice(n, N_CMP, replace=False)).to(dev)
    return dict(cam_o=st["o"], cam_d=st["d"], p=p, d=d, seg=seg / dist[:, None],
                dist=dist, sample=sample)


def _waves(pts, nodes, dev):
    """Camera, bounce-like and shadow (8, N_WAVE) waves in the order the
    packet tracer hands them to the kernel: camera rays in pixel order,
    the others octant + Morton sorted in this tree's frame."""
    from platinum_tpu_torch.ops.packet_trace import _ray_sort_key, sort_frame
    from platinum_tpu_torch.render.integrator import RAY_EPS

    eps = torch.tensor(RAY_EPS, device=dev)
    inf = torch.tensor(float("inf"), device=dev)
    p, d, seg, dist = pts["p"], pts["d"], pts["seg"], pts["dist"]
    lo, inv_extent = sort_frame(nodes)
    camera = _rays(pts["cam_o"], pts["cam_d"], eps, inf)
    order = torch.argsort(_ray_sort_key(p, d, lo, inv_extent), stable=True)
    bounce = _rays(p[order], d[order], eps, inf)
    order = torch.argsort(_ray_sort_key(p, seg, lo, inv_extent), stable=True)
    shadow = _rays(p[order], seg[order], eps, (dist - RAY_EPS)[order])
    return {"camera": camera, "bounce": bounce, "shadow": shadow}


def _borderline(ray, tri64, eps=5e-4, t_rel=1e-5):
    """True when, in float64, the ray grazes some triangle within eps of
    its valid region (a barycentric edge, an end of (tmin, tmax), or a
    near-zero determinant), so an fp32 accept/reject may go either way:
    tests/test_pallas_trace.py's `_assert_borderline` criterion, with the
    t end tightened from 5e-4 to 1e-5 relative (a shadow segment ends
    RAY_EPS short of its light, which the looser bar would count)."""
    o, d, tmin, tmax = ray[0:3], ray[3:6], ray[6], ray[7]
    v0, e1, e2 = tri64[:, 0:3], tri64[:, 3:6], tri64[:, 6:9]
    pv = np.cross(d[None, :], e2)
    det = (e1 * pv).sum(-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = np.where(det != 0.0, 1.0 / np.where(det == 0.0, 1.0, det), np.inf)
        sv = o[None, :] - v0
        u = (sv * pv).sum(-1) * inv
        qv = np.cross(sv, e1)
        v = (d[None, :] * qv).sum(-1) * inv
        t = (e2 * qv).sum(-1) * inv
        w = 1.0 - u - v
        near = ((u > -eps) & (v > -eps) & (w > -eps) & np.isfinite(t)
                & (t > tmin * (1 - t_rel)) & (t < tmax * (1 + t_rel)))
        t_border = np.abs(t - tmin)
        if np.isfinite(tmax):
            t_border = np.minimum(t_border, np.abs(t - tmax))
        border = ((np.minimum(np.minimum(np.abs(u), np.abs(v)), np.abs(w)) < eps)
                  | (t_border < t_rel * np.maximum(np.abs(t), 1.0))
                  | (np.abs(det) < 1e-6 * (np.abs(det).max() + 1e-30)))
    return bool((near & border).any())


U32 = 2.0 ** -24                   # fp32 unit roundoff
GAMMA10 = 10 * U32 / (1 - 10 * U32)  # bound of a 10-term fp32 dot's error


def _coef_slots(blocks, meta_slots):
    """(10, 4, S) float64 MT coefficients of every triangle slot of the
    (B, 10, 256) blocks (row k, output q of slot b*64 + s), and the
    (S,) mask of slots that hold a triangle."""
    nb = blocks.shape[0]
    c = blocks.double().reshape(nb, 10, 4, 64).permute(1, 2, 0, 3)
    return c.reshape(10, 4, nb * 64).cpu().numpy(), meta_slots >= 0


def _fp32_ambiguous(ray, objects, det_eps=1e-12, tier="highest"):
    """True when some triangle's accept test, or the order of two
    accepted triangles' t, is not decided by fp32 arithmetic: evaluated
    in float64 with a forward error bound for the kernel's own fp32 path
    (world features F = [d, o x d, o, 1], object features T F, then the
    10-term dots with the coefficients), some predicate lies within its
    bound of flipping. This certifies rays that `_borderline`'s fixed
    thresholds miss where the features are ill-conditioned: a ray that
    leaves a surface almost tangentially, far from the world origin, has
    object-space o x d terms made of cancelling world-space terms. At a
    reduced tier each dot also carries the bf16 split's error,
    SPLIT_REL[tier] |c| |F|, so the criterion holds the split operands to
    the same forward-error test.
    objects: [(T (10, 10), coefficients (10, 4, S), valid (S,)), ...]."""
    o, d, tmin, tmax = ray[0:3], ray[3:6], ray[6], ray[7]
    fw = np.concatenate([d, np.cross(o, d), o, [1.0]])
    ew = np.zeros(10)
    ew[3:6] = 2 * U32 * (np.abs(o[[1, 2, 0]] * d[[2, 0, 1]])
                         + np.abs(o[[2, 0, 1]] * d[[1, 2, 0]]))
    t_lo, t_hi = [], []
    for tm, coef, valid in objects:
        fo = tm @ fw
        eo = GAMMA10 * (np.abs(tm) @ np.abs(fw)) + np.abs(tm) @ ew
        c = coef[:, :, valid]
        q = np.einsum("kcn,k->cn", c, fo)
        e = ((GAMMA10 + SPLIT_REL[tier])
             * np.einsum("kcn,k->cn", np.abs(c), np.abs(fo))
             + np.einsum("kcn,k->cn", np.abs(c), eo))
        s = np.where(q[0] >= 0.0, 1.0, -1.0)
        ad, us, vs, ts = q[0] * s, q[1] * s, q[2] * s, q[3] * s
        e_ad, e_u, e_v, e_t = e
        e_sum = e_ad + e_u + e_v + U32 * (np.abs(ad) + np.abs(us) + np.abs(vs))
        e_lo = e_t + tmin * e_ad + U32 * np.abs(tmin * ad)
        fin = np.isfinite(tmax)
        e_hi = (e_t + tmax * e_ad + U32 * np.abs(tmax * ad)) if fin else 0.0
        hi_ok = (ts <= tmax * ad + e_hi) if fin else np.ones_like(ts, bool)
        hi_no = (ts >= tmax * ad - e_hi) if fin else np.zeros_like(ts, bool)
        can_accept = ((ad >= det_eps - e_ad) & (us >= -e_u) & (vs >= -e_v)
                      & (us + vs <= ad + e_sum) & (ts >= tmin * ad - e_lo)
                      & hi_ok)
        can_reject = ((ad <= det_eps + e_ad) | (us <= e_u) | (vs <= e_v)
                      | (us + vs >= ad - e_sum) | (ts <= tmin * ad + e_lo)
                      | hi_no)
        if (can_accept & can_reject).any():
            return True
        acc = can_accept & ~can_reject
        with np.errstate(divide="ignore", invalid="ignore"):
            t = ts[acc] / ad[acc]
            et = (e_t[acc] + np.abs(t) * e_ad[acc]) / ad[acc] + U32 * np.abs(t)
        t_lo.append(t - et)
        t_hi.append(t + et)
    if not t_lo:
        return False
    lo, hi = np.concatenate(t_lo), np.concatenate(t_hi)
    if lo.size < 2:
        return False
    # two accepted triangles whose t intervals overlap the nearest one's
    return int((lo <= hi.min()).sum()) > 1


def _borderline_instanced(ray, objects):
    """`_borderline` on an instanced tree: the ray is moved into each
    instance's object space (o' = B(o - t), d' = B d, t unchanged) and
    tested against that instance's mesh. objects: [(B, t, tri64), ...]."""
    for b, tr, tri64 in objects:
        obj = ray.copy()
        obj[0:3] = b @ (ray[0:3] - tr)
        obj[3:6] = b @ ray[3:6]
        if _borderline(obj, tri64):
            return True
    return False


def _compare(name, k, p, any_hit, rays, certify, t_tol=(T_RTOL, T_ATOL)):
    """Hold kernel outputs k to plain outputs p on the wave `rays`;
    returns max |t_k - t_p| over common hits (closest) or max
    |occluded_k - occluded_p| (any).

    A ray agrees when its hit status agrees and, hitting, its id does or
    its t ties; >= 99.5% must agree, every ray that does not must be
    certified borderline in float64 (`certify(ray)`: one fp32 summation
    order accepts a grazed triangle the other rejects), and t holds to
    t_tol (rtol, atol) wherever the ids agree. A fifth output (the
    instance) must be equal wherever the ids are."""
    hk, hp = k[1] >= 0, p[1] >= 0
    both = hk & hp
    same = k[1] == p[1]
    tie = torch.isclose(k[0], p[0], rtol=TIE_RTOL, atol=TIE_ATOL)
    bad = hk != hp
    if not any_hit:
        bad = bad | (both & ~same & ~tie)
    agree = 1.0 - bad.float().mean().item()
    check(agree >= AGREE, f"{name}: {agree:.4%} of rays agree < {AGREE:.1%}")
    host = rays.double().cpu().numpy()
    idx = torch.nonzero(bad).squeeze(1).cpu().numpy()
    uncertified = [int(i) for i in idx if not certify(host[:, i])]
    check(not uncertified, f"{name}: rays {uncertified[:8]} disagree "
                           f"without a borderline triangle")
    if any_hit:
        print(f"  {name}: occlusion agrees on {agree:.4%} "
              f"({int(hp.sum())} occluded, {int(bad.sum())} disagreeing, "
              f"all certified borderline)", flush=True)
        return float((hk != hp).any())
    common = both & same
    if len(k) > 4:
        check(bool((k[4][common] == p[4][common]).all()),
              f"{name}: instance ids differ where the triangle ids agree")
    tk, tp = k[0][common], p[0][common]
    t_ok = torch.isclose(tk, tp, rtol=t_tol[0], atol=t_tol[1])
    check(bool(t_ok.all()), f"{name}: t differs beyond rtol={t_tol[0]} "
                            f"atol={t_tol[1]} on {int((~t_ok).sum())} rays")
    err = float((tk - tp).abs().max()) if common.any() else 0.0
    print(f"  {name}: {agree:.4%} of rays agree, {int(both.sum())} common "
          f"hits, {int((both & ~same & tie).sum())} id differences in t "
          f"ties, {int(bad.sum())} disagreeing (all certified borderline), "
          f"max |dt| {err:.3e}", flush=True)
    return err


def _time_ms(fn, reps, warm=True):
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _device_ms(fn, reps):
    """Device ms of one call of `fn`: CUDA events around `reps` calls
    queued behind a sleep on the stream, so that the host's time to launch
    them (argument checks, allocation, ctypes: tens of microseconds a
    call, more than a small level's kernel) does not count. Fails where
    the queue ran dry before the last call was queued."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    sleep_s = 4.0 * reps * (time.perf_counter() - t0) + 2e-3
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(sleep_s * 2.0e9))       # cycles at <= 2 GHz
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    queued_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    check(queued_s <= sleep_s, f"queued {reps} calls in {queued_s:.4f} s: "
                               f"the sleep may not have covered them")
    return start.elapsed_time(stop) / reps


def _bound(counts, n_rays, in_bytes, out_bytes_per_ray, tier="highest"):
    """Least time of one wave on the card, in ms: the larger of the
    operations this run's rays needed over their peaks and the bytes of
    each input read once and each output written once over HBM's rate.
    Slab tests, instance entries, fp32 MT tests and two_phase's refine
    tests count at the fp32 peak; a reduced tier's MT tests count as its
    bf16 products (TIER_PASSES: three for "high", one for "default", four
    with the magnitude product for two_phase's broad phase) at the dense
    bf16 tensor-core peak."""
    fp32 = (counts["pops"] * 16 * SLAB_FLOP
            + counts["inst_entries"] * XFORM_FLOP
            + counts["refine_tests"] * MT_FLOP)
    bf16 = 0
    if tier == "highest":
        fp32 += counts["mt_tests"] * MT_FLOP
    else:
        bf16 = counts["mt_tests"] * MT_FLOP * TIER_PASSES[tier]
    nbytes = in_bytes + 32 * n_rays + out_bytes_per_ray * n_rays
    t_ops = fp32 / PEAK_FP32 + bf16 / PEAK_BF16
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", fp32 + bf16,
            nbytes)


JOBS = (("camera closest", "camera", False),
        ("bounce closest", "bounce", False),
        ("shadow any", "shadow", True))


def _synced_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _hold_tree(label, nodes, blocks, meta, waves, sample, certify,
               inst_feat=None, mode=None, jobs=JOBS, whole_plain=True,
               plain_rows=None, inst_need=None):
    """Hold one kernel mode (`mode`: trace_wide's worder / mt_precision /
    stream / pipe / flat_walk) on one tree to its plain version:
    16,384-ray subsets, then the whole waves, each timed and counted, and
    with `whole_plain` (True, or the names of the waves it holds for) held
    to the plain version there too. Without it the row's plain time is `plain_rows`' (the rows of a mode with the same
    plain version, measured on the same whole waves in this run) or, with
    no such rows, the plain version's time on the 16,384-ray subset
    (`plain_rays` then says so). With `inst_need` (trace_wide's keywords
    of a per-thread walk), the bound counts that walk's instance entries
    on the same wave: the fp32 and any-hit drains (K3) enter an instance
    once per drained lane, instance and round, more often than the
    function needs. "high" holds t to HIGH_T_RTOL. Returns
    ({"closest"/"any": row fields}, {wave: kernel outputs on the whole
    wave})."""
    from platinum_tpu_torch.ops import packet_trace as pt

    mode = mode or {}
    tier = mode.get("mt_precision", "highest")
    # what the mode reads: the fp32 blocks (fp32 tests, any hit, two_phase's
    # refine) and the pre-split planes (a reduced tier's closest hit); the
    # jobs of a reduced tier are closest hit
    fp32_blocks = tier in ("highest", "two_phase")
    in_bytes = sum(x.numel() * x.element_size()
                   for x in (nodes, blocks if fp32_blocks else None, meta,
                             inst_feat, mode.get("worder"),
                             mode.get("planes"))
                   if x is not None)
    t_tol = (HIGH_T_RTOL, 0.0) if tier == "high" else (T_RTOL, T_ATOL)
    errs = {"closest": 0.0, "any": 0.0}
    sub_ms = {}
    for name, wave, any_hit in jobs:
        sub = waves[wave][:, sample].contiguous()
        k = pt.trace_wide(sub, nodes, blocks, meta, any_hit, inst_feat,
                          **mode)
        p, pms = _synced_ms(lambda: pt.trace_wide_reference(
            sub, nodes, blocks, meta, any_hit, inst_feat, **mode))
        kind = "any" if any_hit else "closest"
        sub_ms[kind] = pms
        errs[kind] = max(errs[kind], _compare(f"{label} {name}", k, p,
                                              any_hit, sub, certify, t_tol))
    rows, outs = {}, {}
    for name, wave, any_hit in jobs:
        rays = waves[wave]
        out = {}

        def kernel():
            out["k"] = pt.trace_wide(rays, nodes, blocks, meta, any_hit,
                                     inst_feat, **mode)

        kms = _time_ms(kernel, 20)
        kind = "any" if any_hit else "closest"
        extra = {}
        if whole_plain is True or (whole_plain and wave in whole_plain):
            p, pms = _synced_ms(lambda: pt.trace_wide_reference(
                rays, nodes, blocks, meta, any_hit, inst_feat, **mode))
            errs[kind] = max(errs[kind], _compare(
                f"{label} {name} (whole wave)", out["k"], p, any_hit, rays,
                certify, t_tol))
            plain = f"plain {pms:.1f} ms"
        elif plain_rows is not None:
            pms = plain_rows[kind]["plain_ms"]
            plain = f"plain {pms:.1f} ms (the same plain version, from above)"
        else:
            pms = sub_ms[kind]
            extra = dict(plain_rays=N_CMP)
            plain = f"plain {pms:.1f} ms on the {N_CMP}-ray subset"
        counts = pt.trace_wide_counts(rays, nodes, blocks, meta, any_hit,
                                      inst_feat, **mode)
        need, entries = counts, f"{counts['inst_entries']} instance entries"
        if inst_need is not None:
            walk = pt.trace_wide_counts(rays, nodes, blocks, meta, any_hit,
                                        inst_feat, **inst_need)
            need = dict(counts, inst_entries=walk["inst_entries"])
            entries += (f" (the drain's; the bound counts the per-thread "
                        f"walk's {walk['inst_entries']})")
        out_bytes = 16 + (4 if inst_feat is not None and not any_hit else 0)
        bms, by, flops, nbytes = _bound(need, rays.shape[1], in_bytes,
                                        out_bytes,
                                        "highest" if any_hit else tier)
        outs[wave] = out["k"]
        drain = (f"{counts['drain_rounds']} warp drain rounds testing "
                 f"{counts['distinct_blocks']} distinct blocks, "
                 if counts["drain_rounds"] else "")
        print(f"  {label} time per {rays.shape[1]}-ray wave, {name}: kernel "
              f"{kms:.3f} ms, {plain}; "
              f"{counts['pops']} pops, {counts['mt_tests']} MT block tests, "
              f"{drain}{entries}, "
              f"{counts['refine_tests']} fp32 refine / re-walk tests, "
              f"{counts['rewalks']} rays walked again -> "
              f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB, bound "
              f"{bms:.4f} ms by {by}", flush=True)
        if wave != "camera":
            rows[kind] = dict(ms=kms, plain_ms=pms, bound_ms=bms, bound_by=by,
                              counts=counts, **extra)
    for kind in rows:
        rows[kind]["max_abs_err"] = errs[kind]
    return rows, outs


def _flat_mode(meta):
    """trace_wide's arguments for the flat push over a tree whose leaves
    are looked up once, here, and not again inside every timed launch."""
    from platinum_tpu_torch.ops import packet_trace as pt

    check(pt._single_block_leaves(meta), "a leaf owns more than one block")
    return dict(flat_walk=True, checked=True)


def _bitwise(name, k, ref, rays, certify, caveat=""):
    """Hold kernel outputs k to a reference mode's on one wave bit for
    bit: hit set (occlusion) and t equal on every ray, ids (and
    instances) equal except at exact-t ties, where the two walks may meet
    the tied blocks in another order. Every other ray is printed and must
    be certified by `certify`; with `certify` None there must be none."""
    if certify is None:
        certify, caveat = (lambda ray: False), " (none allowed)"
    hk, hr = k[1] >= 0, ref[1] >= 0
    both = hk & hr
    t_diff = both & (k[0].view(torch.int32) != ref[0].view(torch.int32))
    bad = (hk != hr) | t_diff
    tie = both & ~t_diff & (k[1] != ref[1])
    if len(k) > 4:
        tie = tie | (both & ~t_diff & (k[4] != ref[4]))
    host = rays.double().cpu().numpy()
    idx = torch.nonzero(bad).squeeze(1).cpu().tolist()
    for i in idx:
        print(f"    exception ray {i}: hit {bool(hk[i])}/{bool(hr[i])}, "
              f"t {float(k[0][i])!r}/{float(ref[0][i])!r}, id "
              f"{int(k[1][i])}/{int(ref[1][i])}, certified "
              f"{certify(host[:, i])}{caveat}", flush=True)
    uncertified = [i for i in idx if not certify(host[:, i])]
    check(not uncertified, f"{name}: rays {uncertified[:8]} differ from "
                           f"the reference without a borderline triangle")
    print(f"  {name}: hit set and t bit for bit on {rays.shape[1] - len(idx)}"
          f" of {rays.shape[1]} rays ({len(idx)} certified exceptions), "
          f"{int(tie.sum())} id differences at exact-t ties", flush=True)


def _jax_bars(name, k, ref, hold=True):
    """K4 against K1 with tests/test_pallas_trace.py:209-220's bars: hit
    sets agree on > 99.8%, the same triangle on > 99% of common hits, t
    to rtol 1e-3 / atol 3e-4 there. The bars were set for rays that start
    in free space; with `hold` False (rays that leave a surface, where the
    tier's error decides self-intersections near tmin) the numbers are
    printed and not held."""
    h1, h2 = ref[1] >= 0, k[1] >= 0
    agree = (h1 == h2).float().mean().item()
    common = h1 & h2
    same = common & (k[1] == ref[1])
    frac = same.sum().item() / max(1, common.sum().item())
    ok = torch.isclose(k[0][same], ref[0][same], rtol=1e-3, atol=3e-4)
    err = float((k[0][same] - ref[0][same]).abs().max())
    print(f"  {name}: hit sets agree on {agree:.4%}, same triangle on "
          f"{frac:.4%} of {int(common.sum())} common hits, "
          f"{int((~ok).sum())} of them beyond the t bar, max |dt| "
          f"{err:.3e}{'' if hold else ' (reported, not held)'}", flush=True)
    check(not hold or (agree > 0.998 and frac > 0.99 and bool(ok.all())),
          f"{name}: outside the bars of tests/test_pallas_trace.py")


def _tier_moves_t(name, k, ref):
    """A reduced tier is not fp32: where K4 and K1 hit the same triangle,
    K4's t must differ from K1's in its bits on >= TIER_DIFF_MIN of the
    rays."""
    same = (ref[1] >= 0) & (k[1] == ref[1])
    moved = (k[0][same].view(torch.int32)
             != ref[0][same].view(torch.int32)).float().mean().item()
    print(f"  {name}: t differs from K1's in its bits on {moved:.4%} of "
          f"{int(same.sum())} same-triangle hits", flush=True)
    check(moved >= TIER_DIFF_MIN, f"{name}: t equals K1's on too many hits; "
                                  f"the tier computes fp32")


def phase_k1k2(scene, cam, dev):
    from platinum_tpu_torch.render.flatten import flatten_scene
    from platinum_tpu_torch.render.types import RenderSettings

    t0 = time.perf_counter()
    flat = flatten_scene(scene, cam, RenderSettings(
        width=512, height=512, tracer="packet", instancing="off"), device=dev)
    print(f"K1/K2 vs plain: colonnade flattened in "
          f"{time.perf_counter() - t0:.2f} s: "
          f"{flat.geometry.indices.shape[0]} triangles, "
          f"{flat.wbvh_nodes.shape[0]} wide nodes, "
          f"{flat.wbvh_tris.shape[0]} MT blocks, "
          f"{int(flat.lights.count)} lights", flush=True)
    nodes = flat.wbvh_nodes.reshape(-1, 16, 8).contiguous()
    pts = _wave_points(flat, dev)
    waves = _waves(pts, nodes, dev)
    tri64 = flat.geometry.tri_geo[:, 0:9].double().cpu().numpy()
    coef, valid = _coef_slots(flat.wbvh_tris, flat.wbvh_slot.cpu().numpy())
    fp32 = [(np.eye(10), coef, valid)]
    rows, outs = _hold_tree(
        "K1/K2", nodes, flat.wbvh_tris, flat.wbvh_meta, waves, pts["sample"],
        lambda ray: _borderline(ray, tri64) or _fp32_ambiguous(ray, fp32))
    return dict(flat=flat, nodes=nodes, pts=pts, waves=waves, tri64=tri64,
                fp32=fp32, outs=outs), rows


def phase_k3(scene, cam, dev, pts):
    from platinum_tpu_torch.render.flatten import flatten_scene
    from platinum_tpu_torch.render.types import RenderSettings

    t0 = time.perf_counter()
    host = {}
    flat = flatten_scene(scene, cam, RenderSettings(
        width=512, height=512, tracer="packet", instancing="on"), device=dev,
        host_accel_out=host)
    ibvh = host["ibvh"]
    print(f"K3 vs plain: instanced colonnade flattened in "
          f"{time.perf_counter() - t0:.2f} s: {ibvh.n_instances} instances "
          f"of {len(host['mesh_wides'])} meshes, "
          f"{flat.geometry.indices.shape[0]} library triangles, "
          f"{flat.wbvh_nodes.shape[0]} wide nodes ({ibvh.n_tlas_nodes} TLAS), "
          f"{flat.wbvh_tris.shape[0]} MT blocks, "
          f"{int(flat.lights.count)} lights", flush=True)
    nodes = flat.wbvh_nodes.reshape(-1, 16, 8).contiguous()
    waves = _waves(pts, nodes, dev)
    certify = _instanced_certify(flat, host)
    per_thread = dict(pipe=True, per_thread=True)
    rows, outs = _hold_tree("K3", nodes, flat.wbvh_tris, flat.wbvh_meta,
                            waves, pts["sample"], certify,
                            inst_feat=flat.instances.feat,
                            inst_need=per_thread)
    print("K9, the pipelined drain, on the instanced colonnade (3h):",
          flush=True)
    for key, mode in (("pipe", dict(pipe=True)),
                      ("flat_walk", _flat_mode(flat.wbvh_meta))):
        _, pipe_outs = _hold_tree(
            f"K9 {key} instanced", nodes, flat.wbvh_tris, flat.wbvh_meta,
            waves, pts["sample"], certify, inst_feat=flat.instances.feat,
            mode=mode, whole_plain=False, plain_rows=rows,
            inst_need=dict(mode, per_thread=True))
        for _, wave, any_hit in JOBS:
            _bitwise(f"K9 {key} instanced against K3, {wave}",
                     pipe_outs[wave], outs[wave], waves[wave], certify)
            _against_its_walk(f"K9 {key} instanced {wave}", waves[wave],
                              nodes, flat.wbvh_tris, flat.wbvh_meta, any_hit,
                              flat.instances.feat, **mode)
    _drain_against_per_thread("instanced colonnade", nodes, flat.wbvh_tris,
                              flat.wbvh_meta, waves,
                              inst_feat=flat.instances.feat)
    print("K3 any hit against the per-thread walk on the instanced colonnade "
          "tree:", flush=True)
    _inst_any_against_pipe("instanced colonnade", nodes, flat.wbvh_tris,
                           flat.wbvh_meta, waves["shadow"],
                           flat.instances.feat)
    return rows


def _instanced_certify(flat, host):
    """`certify` for an instanced tree: `_borderline` in each instance's
    object space, or the fp32 forward-error test through each instance's
    T (host: flatten_scene's host_accel_out)."""
    from platinum_tpu_torch.ops import packet_trace as pt

    ibvh = host["ibvh"]
    lib64 = flat.geometry.tri_geo[:, 0:9].double().cpu().numpy()
    coef, valid = _coef_slots(flat.wbvh_tris, flat.wbvh_slot.cpu().numpy())
    tmats = flat.instances.feat[:, :, 0:10].double().cpu().numpy()
    ranges = pt.instance_block_ranges(flat.wbvh_meta,
                                      ibvh.n_instances).tolist()
    objects, fp32 = [], []
    for i, inst in enumerate(host["instances"]):
        mi = int(ibvh.inst_mesh[i])
        base = host["mesh_tri_base"][mi]
        n = inst.mesh.num_triangles
        m = np.asarray(inst.transform, np.float64)
        objects.append((np.linalg.inv(m[:3, :3]), m[:3, 3],
                        lib64[base:base + n]))
        sl = slice(ranges[i][0] * 64, ranges[i][1] * 64)
        fp32.append((tmats[i], coef[:, :, sl], valid[sl]))
    return (lambda ray: _borderline_instanced(ray, objects)
            or _fp32_ambiguous(ray, fp32))


def _split_planes_row(blocks):
    """The pre-split planes of the colonnade's blocks (3c): the split
    kernel's table against its plain version in every bit, each timed;
    bound by bytes (4 B read and 4 B written per coefficient)."""
    from platinum_tpu_torch.ops import packet_trace as pt

    planes = pt.split_planes(blocks)
    plain = pt.split_planes_plain(blocks)
    check(torch.equal(planes.view(torch.int16), plain.view(torch.int16)),
          "the split kernel's planes differ from their plain version")
    del plain
    kms = _time_ms(lambda: pt.split_planes(blocks), 20)
    pms = _time_ms(lambda: pt.split_planes_plain(blocks), 5)
    nbytes = blocks.numel() * 8
    bms = nbytes / PEAK_BYTES * 1e3
    print(f"  pre-split planes of {blocks.shape[0]} blocks "
          f"({nbytes / 2 / 1e6:.1f} MB): the kernel's table bit for bit its "
          f"plain version's; kernel {kms:.3f} ms, plain {pms:.3f} ms, bound "
          f"{bms:.4f} ms by bytes", flush=True)
    return planes, dict(ms=kms, plain_ms=pms, bound_ms=bms, bound_by="bytes",
                        max_abs_err=0.0)


def phase_variants(ctx):
    """3c-3e: K4, K5 and K7 on the colonnade's camera and bounce waves."""
    from platinum_tpu_torch.ops import packet_trace as pt

    flat, nodes, waves = ctx["flat"], ctx["nodes"], ctx["waves"]
    tri64, fp32 = ctx["tri64"], ctx["fp32"]
    blocks, meta = flat.wbvh_tris, flat.wbvh_meta
    closest = JOBS[:2]
    rows, outs = {}, {}
    print("K4, K5, K7 vs plain on the colonnade (3c):", flush=True)
    planes, planes_row = _split_planes_row(blocks)
    ctx["planes"] = planes
    # K5 and K7 are K1 bit for bit on both whole waves (3d), and K1 is held
    # to its plain version on both (3); their own plain versions (30 s and
    # 8 s a wave) run on the whole bounce wave, whose time enters the
    # kernel table, and on the camera wave's subset. K4 is not K1's
    # function and keeps both whole waves
    for key, mode, tier, whole in (
            ("K4", dict(mt_precision="high", planes=planes), "high", True),
            ("K5", dict(mt_precision="two_phase", planes=planes), "highest",
             ("bounce",)),
            ("K7", dict(worder=flat.wbvh_order), "highest", ("bounce",))):
        def certify(ray, tier=tier):
            return _borderline(ray, tri64) or _fp32_ambiguous(ray, fp32,
                                                              tier=tier)
        rows[key], outs[key] = _hold_tree(
            key, nodes, blocks, meta, waves, ctx["pts"]["sample"], certify,
            mode=mode, jobs=closest, whole_plain=whole)
    print("K5, K7 against K1 on the whole waves (3d):", flush=True)
    caveat = (" (two_phase keeps two candidate blocks; a third inside the "
              "bf16x3 bound of the winner is the tier's documented caveat, "
              "pallas_trace.py:174-177)")
    for key in ("K5", "K7"):
        for _, wave, _ in closest:
            _bitwise(f"{key} {wave}", outs[key][wave], ctx["outs"][wave],
                     waves[wave],
                     lambda ray: _borderline(ray, tri64)
                     or _fp32_ambiguous(ray, fp32),
                     caveat if key == "K5" else "")
    print("K7 against the per-thread queued walk under the octant order "
          "(3d):", flush=True)
    for wave in ("camera", "bounce", "shadow"):
        _against_its_walk(f"K7 {wave} (closest hit)", waves[wave], nodes,
                          blocks, meta, False, worder=flat.wbvh_order)
    # and K5 on the third wave, the shadow segments traced as closest hit
    shadow = waves["shadow"]
    _bitwise("K5 shadow (traced as closest hit)",
             pt.trace_wide(shadow, nodes, blocks, meta, False,
                           mt_precision="two_phase", planes=planes),
             pt.trace_wide(shadow, nodes, blocks, meta, False), shadow,
             lambda ray: _borderline(ray, tri64) or _fp32_ambiguous(ray, fp32),
             caveat)
    print("K4 against K1 on the whole waves (3e):", flush=True)
    for _, wave, _ in closest:
        _jax_bars(f"K4 {wave}", outs["K4"][wave], ctx["outs"][wave],
                  hold=wave == "camera")
        _tier_moves_t(f"K4 {wave}", outs["K4"][wave], ctx["outs"][wave])
    out = {k: rows[k]["closest"] for k in ("K4", "K5", "K7")}
    out["K4 default"] = _default_tier_row(ctx)
    out["planes"] = planes_row
    return out


def _default_tier_row(ctx):
    """K4 at mt_precision="default" on the bounce wave (3c): timed,
    counted and bounded (one bf16 product per block test); against its
    plain version on the 16,384-ray subset, printed and not held (the
    tier's t errors move hits across node boxes, so its walk and the brute
    force disagree by design; tests/test_torch_gpu.py holds it on a soup);
    its launch through make_packet_tracer(mt_precision="default")."""
    from platinum_tpu_torch.ops import packet_trace as pt
    from platinum_tpu_torch.render.integrator import RAY_EPS

    flat, nodes, b = ctx["flat"], ctx["nodes"], ctx["waves"]["bounce"]
    blocks, meta = flat.wbvh_tris, flat.wbvh_meta
    mode = dict(mt_precision="default", planes=ctx["planes"])
    kms = _time_ms(lambda: pt.trace_wide(b, nodes, blocks, meta, False,
                                         **mode), 20)
    counts = pt.trace_wide_counts(b, nodes, blocks, meta, False, **mode)
    # the tier reads the h plane alone (mt_block.cuh lane_dots_split)
    in_bytes = sum(x.numel() * x.element_size()
                   for x in (nodes, ctx["planes"][:, 0], meta))
    bms, by, flops, nbytes = _bound(counts, b.shape[1], in_bytes, 16,
                                    "default")
    sub = b[:, ctx["pts"]["sample"]].contiguous()
    k = pt.trace_wide(sub, nodes, blocks, meta, False, **mode)
    p, pms = _synced_ms(lambda: pt.trace_wide_reference(
        sub, nodes, blocks, meta, False, **mode))
    same = (k[1] >= 0) & (k[1] == p[1])
    err = float((k[0][same] - p[0][same]).abs().max())
    agree = ((k[1] >= 0) == (p[1] >= 0)).float().mean().item()
    tc, _ = pt.make_packet_tracer(flat.wbvh_nodes, blocks, meta,
                                  flat.wbvh_slot, mt_precision="default")
    _zero_launches()
    tc(b[0:3].T, b[3:6].T, RAY_EPS, float("inf"))
    launches = _launches()["closest+default"]
    print(f"  K4 default time per {b.shape[1]}-ray wave, bounce closest: "
          f"kernel {kms:.3f} ms, plain {pms:.1f} ms on the {N_CMP}-ray "
          f"subset (hit sets agree on {agree:.4%}, max |dt| {err:.3e} where "
          f"the ids agree, not held); {counts['pops']} pops, "
          f"{counts['mt_tests']} MT block tests in "
          f"{counts['drain_rounds']} warp drain rounds on "
          f"{counts['distinct_blocks']} distinct blocks -> "
          f"{flops / 1e9:.2f} GFLOP, "
          f"{nbytes / 1e6:.1f} MB, bound {bms:.4f} ms by {by}; "
          f"make_packet_tracer(mt_precision='default') launched it "
          f"{launches} time(s)", flush=True)
    return dict(ms=kms, plain_ms=pms, plain_rays=N_CMP, bound_ms=bms,
                bound_by=by, max_abs_err=err, launches=launches)


def _exact(name, got, ref):
    """Every output equal bit for bit."""
    for a, b in zip(got, ref, strict=True):
        check(torch.equal(a, b), f"{name}: an output differs in its bits")


def _paired_waves(label, nodes, blocks, meta, closest, shadow, ref_c, ref_a,
                  **mode):
    """One paired launch over two whole waves: bit for bit the unpaired
    modes' outputs `ref_c` / `ref_a`, as is K8's per-thread reference
    (`per_thread=True`); timed against that reference and those two modes
    launched one after the other, each variant twice, in turns
    (reference, paired, apart, then back). At the fp32 tier the counting tables of the two halves must be
    the unpaired drains' (K1 or K6 closest, K2) row for row, drain rows
    included. `mode`: the tier (with its `planes`) or `stream`. Returns
    {variant: ms (the mean of its two readings)} and, at fp32, the counts
    of the closest and the any-hit wave."""
    from platinum_tpu_torch.ops import packet_trace as pt

    res = {}
    stream = mode.get("stream", False)
    tier = mode.get("mt_precision", "highest")

    def paired(**kw):
        def run():
            res[tuple(kw.items())] = pt.trace_wide_paired(
                closest, shadow, nodes, blocks, meta, **mode, **kw)
        return run

    def apart():
        pt.trace_wide(closest, nodes, blocks, meta, False, **mode)
        pt.trace_wide(shadow, nodes, blocks, meta, True, stream=stream)

    variants = {"per-thread reference": paired(per_thread=True),
                "paired": paired(), "apart": apart}
    turns = list(variants) + list(reversed(variants))
    readings = {v: [] for v in variants}
    for v in turns:
        readings[v].append(_time_ms(variants[v], 20))
    ms = {v: sum(r) / len(r) for v, r in readings.items()}
    for kw, (got_c, occ) in res.items():
        _exact(f"{label} closest half {dict(kw)}", got_c, ref_c)
        check(torch.equal(occ, ref_a[1][:occ.shape[0]]),
              f"{label} {dict(kw)}: the any-hit half differs from the "
              f"unpaired kernel")
    times = ", ".join(f"{v} {r[0]:.3f} / {r[1]:.3f}"
                      for v, r in readings.items())
    print(f"  {label}{'' if tier == 'highest' else ' at ' + tier}: "
          f"{closest.shape[1]} + {shadow.shape[1]} rays bit for bit the "
          f"unpaired modes, and so is the per-thread reference; ms per "
          f"call, two readings each: {times}; paired {ms['paired']:.3f} ms "
          f"against the per-thread reference "
          f"{ms['per-thread reference']:.3f} and the two modes apart "
          f"{ms['apart']:.3f}", flush=True)
    if tier != "highest":
        return ms, None, None
    cc, ca = pt.trace_wide_paired_counts(closest, shadow, nodes, blocks,
                                         meta, stream=stream, per_ray=True)
    check(torch.equal(cc, pt.trace_wide_counts(
              closest, nodes, blocks, meta, False, stream=stream,
              per_ray=True))
          and torch.equal(ca, pt.trace_wide_counts(
              shadow, nodes, blocks, meta, True, stream=stream,
              per_ray=True)),
          f"{label}: the paired counting tables differ from the unpaired "
          f"drains'")
    cc, ca = (pt._count_sums(c) for c in (cc, ca))
    print(f"    counting tables, row for row the unpaired "
          f"drains': closest wave {cc['pops']} pops, {cc['mt_tests']} MT "
          f"block tests, {cc['drain_rounds']} drain rounds; any-hit wave "
          f"{ca['pops']} pops, {ca['mt_tests']} MT block tests, "
          f"{ca['drain_rounds']} drain rounds", flush=True)
    return ms, cc, ca


def phase_paired(ctx, k12):
    """3g: K8 on the headline tree."""
    from platinum_tpu_torch.ops import packet_trace as pt
    from platinum_tpu_torch.render.integrator import RAY_EPS

    flat, nodes, waves, outs = (ctx["flat"], ctx["nodes"], ctx["waves"],
                                ctx["outs"])
    blocks, meta = flat.wbvh_tris, flat.wbvh_meta
    tri64, fp32 = ctx["tri64"], ctx["fp32"]
    sample = ctx["pts"]["sample"]

    def certify(ray):
        return _borderline(ray, tri64) or _fp32_ambiguous(ray, fp32)

    print("K8, the paired launch (3g):", flush=True)
    sub_c = waves["bounce"][:, sample].contiguous()
    sub_a = waves["shadow"][:, sample].contiguous()
    kc, ka = pt.trace_wide_paired(sub_c, sub_a, nodes, blocks, meta)
    err = max(
        _compare("K8 bounce half vs plain", kc,
                 pt.trace_wide_reference(sub_c, nodes, blocks, meta, False),
                 False, sub_c, certify),
        _compare("K8 shadow half vs plain", (sub_a[7], ka),
                 pt.trace_wide_reference(sub_a, nodes, blocks, meta, True),
                 True, sub_a, certify))
    shadow = waves["shadow"]
    for wave in ("camera", "bounce"):
        ms, cc, ca = _paired_waves(
            f"paired({wave}, shadow)", nodes, blocks, meta, waves[wave],
            shadow, outs[wave], outs["shadow"])
    # each CTA runs K1's or K2's drain, so the halves do K1's and K2's
    # work: their counts on the bounce and shadow waves, drain rows too
    ref_c, ref_a = k12["closest"]["counts"], k12["any"]["counts"]
    check(cc == ref_c and ca == ref_a,
          f"the paired launch's counts {cc}, {ca} against K1's {ref_c} "
          f"and K2's {ref_a}")
    # K2's any-hit drain against its per-thread reference, the classic
    # walk, ray by ray
    _any_drain_against_per_thread("headline", nodes, blocks, meta, shadow,
                                  {"K2": outs["shadow"]})
    cut = shadow[:, :100_000].contiguous()
    _paired_waves("paired(bounce, shadow cut to 100,000)", nodes, blocks,
                  meta, waves["bounce"], cut, outs["bounce"], outs["shadow"])
    _paired_waves("paired(camera cut to 100,000, shadow)", nodes, blocks,
                  meta, waves["camera"][:, :100_000].contiguous(), shadow,
                  [x[:100_000] for x in outs["camera"]], outs["shadow"])
    # the closest half at the reduced tiers and two_phase: K4's and K5's
    # drains beside K2's
    for tier in ("high", "default", "two_phase"):
        mode = dict(mt_precision=tier, planes=ctx["planes"])
        _paired_waves("paired(bounce, shadow)", nodes, blocks, meta,
                      waves["bounce"], shadow,
                      pt.trace_wide(waves["bounce"], nodes, blocks, meta,
                                    False, **mode), outs["shadow"], **mode)
    # the path: the tracer's own entry, on the same two waves
    tc, ta = pt.make_packet_tracer(flat.wbvh_nodes, blocks, meta,
                                   flat.wbvh_slot)
    b, sh = waves["bounce"], shadow
    _zero_launches()
    rec, occ = tc.paired(b[0:3].T, b[3:6].T, RAY_EPS, float("inf"),
                         sh[0:3].T, sh[3:6].T, RAY_EPS, sh[7])
    launches = _launches()
    _only("trace_closest.paired", launches, ("paired",))
    ref = tc(b[0:3].T, b[3:6].T, RAY_EPS, float("inf"))
    check(torch.equal(rec.t, ref.t) and torch.equal(rec.tri, ref.tri)
          and torch.equal(occ, ta(sh[0:3].T, sh[3:6].T, RAY_EPS, sh[7])),
          "trace_closest.paired differs from trace_closest / trace_any")
    print(f"  trace_closest.paired(bounce, shadow): one launch "
          f"({launches['paired']}), equal to trace_closest and trace_any",
          flush=True)
    c, a = k12["closest"], k12["any"]
    return dict(ms=ms["paired"], plain_ms=c["plain_ms"] + a["plain_ms"],
                bound_ms=c["bound_ms"] + a["bound_ms"],
                bound_by=c["bound_by"], max_abs_err=err,
                launches=launches["paired"],
                reference_ms=ms["per-thread reference"])


def phase_pipe(ctx, k12):
    """3h: K9 on the headline tree, with and without the flat push."""
    flat, nodes, waves = ctx["flat"], ctx["nodes"], ctx["waves"]
    tri64, fp32 = ctx["tri64"], ctx["fp32"]

    def certify(ray):
        return _borderline(ray, tri64) or _fp32_ambiguous(ray, fp32)

    rows = {}
    print("K9, the pipelined drain (3h):", flush=True)
    for key, mode in (("K9 pipe", dict(pipe=True)),
                      ("K9 flat_walk", _flat_mode(flat.wbvh_meta))):
        rows[key], outs = _hold_tree(
            key, nodes, flat.wbvh_tris, flat.wbvh_meta, waves,
            ctx["pts"]["sample"], certify, mode=mode, whole_plain=False,
            plain_rows=k12)
        # closest hit: K1 and K9 (two drains of the same function) must
        # agree with no exception; K9 is its per-thread walk lane by lane
        for _, wave, any_hit in JOBS:
            _bitwise(f"{key} against K1/K2, {wave}", outs[wave],
                     ctx["outs"][wave], waves[wave],
                     certify if any_hit else None)
            _against_its_walk(f"{key} {wave}", waves[wave], nodes,
                              flat.wbvh_tris, flat.wbvh_meta, any_hit,
                              **mode)
        for kind in ("closest", "any"):
            got, ref = rows[key][kind]["counts"], k12[kind]["counts"]
            print(f"  {key} {kind} (bounce / shadow wave): "
                  f"{got['pops']} pops against K1/K2's {ref['pops']} "
                  f"({got['pops'] / ref['pops'] - 1:+.2%}), "
                  f"{got['mt_tests']} MT block tests against "
                  f"{ref['mt_tests']} "
                  f"({got['mt_tests'] / ref['mt_tests'] - 1:+.2%})",
                  flush=True)
    _drain_against_per_thread("headline", nodes, flat.wbvh_tris,
                              flat.wbvh_meta, waves)
    return rows


def _drain_counts(name, c):
    """Check and print the drain rows of one wave's counts: 0 < rounds <=
    distinct blocks <= MT block tests; lanes per distinct block (MT block
    tests / distinct blocks), distinct blocks a round and, on an instanced
    tree, instance entries a round."""
    check(0 < c["drain_rounds"] <= c["distinct_blocks"] <= c["mt_tests"],
          f"{name}: drain counts {c}")
    entries = (f", {c['inst_entries']} instance entries: "
               f"{c['inst_entries'] / c['drain_rounds']:.2f} a round"
               if c["inst_entries"] else "")
    print(f"  {name}: {c['pops']} pops, {c['mt_tests']} MT block tests in "
          f"{c['drain_rounds']} warp drain rounds, {c['distinct_blocks']} "
          f"distinct blocks: {c['mt_tests'] / c['distinct_blocks']:.2f} "
          f"lanes per distinct block, "
          f"{c['distinct_blocks'] / c['drain_rounds']:.2f} distinct blocks "
          f"a round{entries}", flush=True)


def _against_its_walk(name, rays, nodes, blocks, meta, any_hit,
                      inst_feat=None, **mode):
    """A drain that keeps a per-thread walk lane by lane (K7: the queued
    walk under the octant order; K9: the pipelined walk) against that
    walk (`per_thread=True`) on one whole wave: every output in every
    bit, no exception, and per ray the same node pops and MT block tests;
    the drain's counts, and on an instanced tree both walks' instance
    entries (the drain's once per drained lane, instance and round)."""
    from platinum_tpu_torch.ops import packet_trace as pt

    got = pt.trace_wide(rays, nodes, blocks, meta, any_hit, inst_feat,
                        **mode)
    ref = pt.trace_wide(rays, nodes, blocks, meta, any_hit, inst_feat,
                        per_thread=True, **mode)
    check(len(got) == len(ref) and all(
        torch.equal(a.view(torch.int32), b.view(torch.int32))
        for a, b in zip(got, ref)),
          f"{name}: an output differs in its bits from the per-thread walk")
    c, cref = (pt.trace_wide_counts(rays, nodes, blocks, meta, any_hit,
                                    inst_feat, per_ray=True, per_thread=r,
                                    **mode) for r in (False, True))
    differ = int((c[:2] != cref[:2]).any(0).sum())
    check(differ == 0, f"{name}: node pops or MT block tests differ from "
                       f"the per-thread walk's on {differ} rays")
    hits = int((got[1] > 0).sum() if any_hit else (got[1] >= 0).sum())
    print(f"  {name} against the per-thread walk: every output bit for bit "
          f"on all {rays.shape[1]} rays ({hits} "
          f"{'occluded' if any_hit else 'hits'}), node pops and MT block "
          f"tests the same on every ray"
          + (f"; instance entries {int(c[2].sum())} against the walk's "
             f"{int(cref[2].sum())}" if inst_feat is not None else ""),
          flush=True)
    _drain_counts(name, pt._count_sums(c))


def _drain_against_per_thread(label, nodes, blocks, meta, waves, stream=False,
                              inst_feat=None):
    """K1 (and with `stream` K6 closest), or with `inst_feat` K3, the
    warp-wide drain over the fp32 blocks, against the per-thread
    pipelined walk (`pipe=True, per_thread=True`, the walk K9's drain
    keeps) on the camera, bounce and shadow waves, all traced as
    closest hit: hit set and t bit for bit on every ray, no exception
    allowed; id differences (exact-t ties between blocks, which the walks
    may meet in another order) printed for K1 / K6, and for K3 none
    allowed: every output, the instance id included, bit for bit. Also
    each wave's drain counts (`_drain_counts`)."""
    from platinum_tpu_torch.ops import packet_trace as pt

    modes = ([("K3", {})] if inst_feat is not None else
             [("K1", {})] + ([("K6 closest", dict(stream=True))]
                             if stream else []))
    print(f"{modes[0][0]} against the per-thread walk on the {label} tree:",
          flush=True)
    for wave in ("camera", "bounce", "shadow"):
        rays = waves[wave]
        pipe = pt.trace_wide(rays, nodes, blocks, meta, False, inst_feat,
                             pipe=True, per_thread=True)
        for name, mode in modes:
            got = pt.trace_wide(rays, nodes, blocks, meta, False, inst_feat,
                                **mode)
            what = (f"{name} against the per-thread pipelined walk, "
                    f"{label} {wave} as closest hit")
            _bitwise(what, got, pipe, rays, None)
            if inst_feat is not None:
                _exact(what, got, pipe)
            _drain_counts(f"{name} {label} {wave}", pt.trace_wide_counts(
                rays, nodes, blocks, meta, False, inst_feat, **mode))


def _any_drain_against_per_thread(label, nodes, blocks, meta, rays, outs):
    """The warp-wide any-hit drain against its per-thread reference, the
    classic any-hit walk (`trace_wide(..., True, per_thread=True)`), on
    one whole shadow wave; `outs`: {name: (t, sid, u, v) of that mode on
    the wave}, K2 (resident) and K6 any hit (streamed) taking the drain
    alike. Every output on every ray (no exception: the flag, t tmax and
    u, v 0), and per ray the same node pops and MT block tests (both cull
    nodes by the constant tmax and visit a node's leaves in slot order);
    with each mode's drain counts."""
    from platinum_tpu_torch.ops import packet_trace as pt

    ref = pt.trace_wide(rays, nodes, blocks, meta, True, per_thread=True)
    cref = pt.trace_wide_counts(rays, nodes, blocks, meta, True,
                                per_ray=True, per_thread=True)
    for name, got in outs.items():
        what = f"{name} against the per-thread any-hit walk, {label} shadow"
        _exact(what, got, ref)
        stream = name.startswith("K6")
        c = pt.trace_wide_counts(rays, nodes, blocks, meta, True,
                                 stream=stream, per_ray=True)
        check(torch.equal(c[:2], cref[:2]),
              f"{what}: pops or MT block tests differ from the per-thread "
              f"walk's on {int((c[:2] != cref[:2]).any(0).sum())} rays")
        print(f"  {what}: every output bit for bit on all {rays.shape[1]} "
              f"rays ({int((ref[1] > 0).sum())} occluded), node pops and MT "
              f"block tests the per-thread walk's on every ray", flush=True)
        _drain_counts(f"{name} {label} shadow",
                      pt.trace_wide_counts(rays, nodes, blocks, meta, True,
                                           stream=stream))


def _inst_any_against_pipe(label, nodes, blocks, meta, rays, inst_feat):
    """K3 any hit, the any-hit drain with the ten-lane instance entry,
    resident and with stream=True (the same drain), against the
    per-thread pipelined walk (`pipe=True, per_thread=True`) on one whole
    shadow wave: every output bit for bit, no exception; per ray that
    nothing occludes that walk's node pops and MT block tests (a walk
    under the constant tmax visits the same nodes and blocks in any
    order); with its drain counts."""
    from platinum_tpu_torch.ops import packet_trace as pt

    pipe = pt.trace_wide(rays, nodes, blocks, meta, True, inst_feat,
                         pipe=True, per_thread=True)
    ref = pt.trace_wide_counts(rays, nodes, blocks, meta, True, inst_feat,
                               pipe=True, per_ray=True, per_thread=True)
    free = pipe[1] < 0
    for name, mode in (("K3 any hit", {}),
                       ("K3 any hit stream=True", dict(stream=True))):
        what = (f"{name} against the per-thread pipelined walk, {label} "
                f"shadow")
        _exact(what, pt.trace_wide(rays, nodes, blocks, meta, True,
                                   inst_feat, **mode), pipe)
        c = pt.trace_wide_counts(rays, nodes, blocks, meta, True, inst_feat,
                                 per_ray=True, **mode)
        check(torch.equal(c[:2, free], ref[:2, free]),
              f"{what}: pops or MT block tests of an unoccluded ray differ "
              f"from the walk's")
        print(f"  {what}: every output bit for bit on all {rays.shape[1]} "
              f"rays ({int((~free).sum())} occluded); its pops and MT block "
              f"tests on the {int(free.sum())} unoccluded rays; on the "
              f"occluded ones {int(c[0, ~free].sum())} pops and "
              f"{int(c[1, ~free].sum())} MT block tests against its "
              f"{int(ref[0, ~free].sum())} and {int(ref[1, ~free].sum())}",
              flush=True)
        _drain_counts(f"{name} {label} shadow", pt.trace_wide_counts(
            rays, nodes, blocks, meta, True, inst_feat, **mode))


PROFILE_MODES = ("empty", "nomt", "fix64", "count")


def _profile_times(label, nodes, blocks, meta, rays, any_hit):
    """Launch floor / walk / MT split of one wave: the times of "empty",
    "nomt" and the full walk, on the classic and the queued per-thread
    walk. "empty" and "nomt" are the per-thread walk's; the full closest
    hit is K1 / K6 on the warp-wide drain, and so is the full any hit (K2,
    K6), so their MT share is the drain's time less the per-thread
    walk's."""
    from platinum_tpu_torch.ops import packet_trace as pt

    for walk, stream in (("classic", False), ("queued", True)):
        ms = {prof: _time_ms(lambda prof=prof: pt.trace_wide(
            rays, nodes, blocks, meta, any_hit, stream=stream, profile=prof),
            20) for prof in ("empty", "nomt", "none")}
        full = ("K6 warp-wide" if stream else
                "K2 warp-wide" if any_hit else "K1 warp-wide")
        print(f"  {label}, {walk} walk: empty {ms['empty']:.3f} ms, nomt "
              f"{ms['nomt']:.3f} ms, full ({full}) {ms['none']:.3f} ms -> "
              f"launch floor {ms['empty']:.3f}, walk "
              f"{ms['nomt'] - ms['empty']:.3f}, MT "
              f"{ms['none'] - ms['nomt']:.3f} ms", flush=True)


def phase_profile(ctx, k12):
    """3i: the ablation modes on the headline tree."""
    from platinum_tpu_torch.ops import packet_trace as pt
    from platinum_tpu_torch.render.integrator import RAY_EPS

    flat, nodes, waves = ctx["flat"], ctx["nodes"], ctx["waves"]
    blocks, meta = flat.wbvh_tris, flat.wbvh_meta
    # what each mode reads beside its rays: "empty" nothing, "nomt" the
    # tree without the blocks, "fix64" and "count" all of K1's inputs
    walk_bytes = sum(x.numel() * 4 for x in (nodes, meta))
    in_bytes = {"empty": 0, "nomt": walk_bytes,
                "fix64": walk_bytes + blocks.numel() * 4,
                "count": walk_bytes + blocks.numel() * 4}
    print("the ablation modes (3i):", flush=True)
    rows = {}
    for name, wave, any_hit in JOBS:
        rays, k1 = waves[wave], ctx["outs"][wave]
        n = rays.shape[1]
        per_ray = pt.trace_wide_counts(rays, nodes, blocks, meta, any_hit,
                                       per_ray=True)
        pops = per_ray[0]
        for stream in (False, True):
            for prof in ("empty", "nomt"):
                k = pt.trace_wide(rays, nodes, blocks, meta, any_hit,
                                  stream=stream, profile=prof)
                p = pt.trace_wide_reference(rays, nodes, blocks, meta,
                                            any_hit, profile=prof)
                check(all(torch.equal(a, b) for a, b in zip(k, p)),
                      f"profile={prof} on the {wave} wave does not miss "
                      f"everything (stream={stream})")
        nomt = pt.trace_wide_counts(rays, nodes, blocks, meta, any_hit,
                                    profile="nomt")
        check(nomt["mt_tests"] == 0 and nomt["pops"] >= int(pops.sum()),
              f"profile=nomt on the {wave} wave: {nomt} against K1's "
              f"{int(pops.sum())} pops")
        count = pt.trace_wide(rays, nodes, blocks, meta, any_hit,
                              profile="count")
        check(torch.equal(count[0], k1[0]) and torch.equal(count[1], k1[1])
              and torch.equal(count[3], k1[3]),
              f"profile=count on the {wave} wave: t, id or v differ from K1")
        # count's u: the per-thread walk's pops, which fix64's counting
        # instantiation counts up to 64; K2's any-hit drain pops exactly
        # that walk's nodes, K1's warp-wide walk no fewer
        thread_pops = count[2].int()
        fix_pops = pt.trace_wide_counts(rays, nodes, blocks, meta, any_hit,
                                        profile="fix64", per_ray=True)[0]
        check(torch.equal(fix_pops, thread_pops.clamp(max=64))
              and (pops >= thread_pops).all()
              and (not any_hit or torch.equal(pops, thread_pops)),
              f"profile=count on the {wave} wave: u is not the per-thread "
              f"walk's pops")
        fix = pt.trace_wide(rays, nodes, blocks, meta, any_hit,
                            profile="fix64")
        short = thread_pops <= 64
        check(all(torch.equal(a[short], b[short]) for a, b in zip(fix, k1)),
              f"profile=fix64 on the {wave} wave differs from K1 on a ray "
              f"whose walk ends within 64 pops")
        print(f"  {name}: empty and nomt miss everything; nomt pops "
              f"{nomt['pops']} nodes (K1/K2 {int(pops.sum())}) and tests no "
              f"block; count's t, id, v are K1's and u the per-thread "
              f"walk's pops ({int(thread_pops.sum())}, max "
              f"{int(thread_pops.max())}); fix64 is K1 on the "
              f"{int(short.sum())} of {n} rays that end within 64 pops",
              flush=True)
        _profile_times(name, nodes, blocks, meta, rays, any_hit)
        if wave != "bounce":
            continue
        # rows of the kernel table: closest hit on the bounce wave
        kind = k12["closest"]
        sub = rays[:, ctx["pts"]["sample"]].contiguous()
        sub_short = short[ctx["pts"]["sample"]]
        plain = pt.trace_wide_reference(sub, nodes, blocks, meta, False)
        # fix64's own pops and block tests, from its counting
        # instantiation: no more pops than K1's capped at 64 a ray
        walked = pt.trace_wide_counts(rays, nodes, blocks, meta, False,
                                      profile="fix64")
        check(0 < walked["pops"] <= int(torch.clamp(thread_pops,
                                                    max=64).sum())
              and 0 < walked["mt_tests"] <= kind["counts"]["mt_tests"],
              f"profile=fix64 counts {walked} against K1's "
              f"{kind['counts']}")
        for prof in PROFILE_MODES:
            ms = _time_ms(lambda: pt.trace_wide(
                rays, nodes, blocks, meta, False, profile=prof), 20)
            k = pt.trace_wide(sub, nodes, blocks, meta, False, profile=prof)
            p, pms = _synced_ms(lambda: pt.trace_wide_reference(
                sub, nodes, blocks, meta, False, profile=prof))
            hit = (k[1] >= 0) & (plain[1] == k[1])
            if prof == "fix64":
                hit &= sub_short
            # count, fix64: |t - K1's plain t| on common hits; empty, nomt:
            # largest difference of the hit flags from the all-miss version
            err = (float((k[0][hit] - plain[0][hit]).abs().max())
                   if prof in ("fix64", "count") else
                   float((k[1] != p[1]).float().max()))
            counts = {"empty": dict(kind["counts"], pops=0, mt_tests=0),
                      "nomt": nomt, "fix64": walked,
                      "count": dict(kind["counts"],
                                    pops=int(thread_pops.sum()))}[prof]
            bms, by, flops, nbytes = _bound(counts, n, in_bytes[prof], 16)
            print(f"  profile={prof} on the bounce wave: {ms:.3f} ms; "
                  f"{counts['pops']} pops, {counts['mt_tests']} MT block "
                  f"tests -> {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB, "
                  f"bound {bms:.4f} ms by {by}", flush=True)
            rows[prof] = dict(ms=ms, plain_ms=pms, plain_rays=N_CMP,
                              bound_ms=bms, bound_by=by, max_abs_err=err)
    # the path: make_packet_tracer(profile=...) on the bounce and shadow
    # waves
    b, sh = waves["bounce"], waves["shadow"]
    for prof in PROFILE_MODES:
        tc, ta = pt.make_packet_tracer(flat.wbvh_nodes, blocks, meta,
                                       flat.wbvh_slot, profile=prof)
        _zero_launches()
        rec = tc(b[0:3].T, b[3:6].T, RAY_EPS, float("inf"))
        occ = ta(sh[0:3].T, sh[3:6].T, RAY_EPS, sh[7])
        launches = _launches()
        _only(f"make_packet_tracer(profile={prof!r})", launches,
              (f"closest@{prof}", f"any@{prof}"))
        if prof in ("empty", "nomt"):
            check(not rec.hit.any() and not occ.any(),
                  f"the profile={prof} tracer hit something")
        rows[prof]["launches"] = (launches[f"closest@{prof}"]
                                  + launches[f"any@{prof}"])
    return rows


def _replay_walk(ray, nodes_np, meta_np, test_block):
    """K4's walk for one ray as one thread takes it (wide_trace.cu
    `warp_walk` and `drain` for one lane): pop a node, slab-test its 16
    children against the best at the pop in the kernel's float32
    arithmetic, push the inner hits, queue the leaves with their entry
    distance and visit the queue in order, skipping an entry beyond the
    running best; `test_block(b, best)` is the per-thread block test
    against the running best, (t, id, u, v) with id -1 unless it lowers
    it. Returns the ray's (t, id, u, v)."""
    f32 = np.float32
    o, d = ray[0:3].astype(f32), ray[3:6].astype(f32)
    tmin, best = f32(ray[6]), f32(ray[7])
    tiny = np.where(d < 0, f32(-1e-20), f32(1e-20))
    inv = f32(1.0) / np.where(np.abs(d) < f32(1e-20), tiny, d)
    hit = (-1, f32(0.0), f32(0.0))
    stack = [0] if best > tmin else []
    while stack:
        n = stack.pop()
        cull, queue = best, []
        for c in range(16):
            mc = int(meta_np[n * 16 + c])
            if mc == -1:
                continue
            t0 = (nodes_np[n, c, 0:3] - o) * inv
            t1 = (nodes_np[n, c, 3:6] - o) * inv
            tnear, tfar = np.minimum(t0, t1).max(), np.maximum(t0, t1).min()
            if not (tnear <= tfar and tfar >= tmin and tnear <= cull):
                continue
            if mc >= 0:
                stack.append(mc)
            else:
                queue.append((-mc - 2, tnear))
        check(len(stack) < 256, "the replayed walk overflows the stack")
        for val, tnear in queue:
            if not tnear <= best:
                continue
            for b in range(val >> 5, (val >> 5) + (val & 31)):
                t, sid, u, v = test_block(b, best)
                if sid >= 0:
                    best, hit = f32(t), (sid, f32(u), f32(v))
    return (best,) + hit


def _hold_high_to_raystream(ctx):
    """3j: K4 "high" closest against the ray-stream tracer at "high" on
    the headline's three whole waves (the shadow wave traced as closest
    hit). Both form each triangle's t with mt_block.cuh's arithmetic, K4
    warp-wide over the pre-split planes, K15 one thread per (ray, block)
    pair, so hit set, t, ids and barycentrics agree in every bit except
    where the walks cull differently: at a reduced tier a triangle's t can
    fall in front of its own leaf's box, and the depth-first walk culls by
    its best at each pop, the breadth-first one by its per-ray best at
    each level. Every ray that differs must be borderline in float64, and
    K4's t, id and barycentrics on it must be those of a one-thread replay
    of K4's walk (`_replay_walk`) whose block tests are K15's, in every
    bit. Prints the warp drain's sharing counts per wave."""
    from platinum_tpu_torch.ops import packet_trace as pt
    from platinum_tpu_torch.ops import raystream as rs

    flat, waves, planes = ctx["flat"], ctx["waves"], ctx["planes"]
    nodes, blocks, meta = ctx["nodes"], flat.wbvh_tris, flat.wbvh_meta
    tri64, fp32 = ctx["tri64"], ctx["fp32"]
    nodes_np, meta_np = nodes.cpu().numpy(), meta.cpu().numpy()
    dev = nodes.device
    pair = rs.make_stream_tracer(flat.wbvh_nodes, blocks, meta,
                                 mt_precision="high")
    one = torch.zeros(1, dtype=torch.int32, device=dev)
    print("K4 'high' against the ray-stream tracer at 'high' (3j):",
          flush=True)

    def certify(r):
        if not (_borderline(r[:8], tri64)
                or _fp32_ambiguous(r[:8], fp32, tier="high")):
            return False
        ray = torch.tensor(r[:8], dtype=torch.float32, device=dev)[:, None]

        def test_block(b, best):
            limit = torch.tensor([best], dtype=torch.float32, device=dev)
            out = rs.stream_mt(ray, limit, one, one + b, blocks, False,
                               "high")
            return [x.item() for x in out]

        got = _replay_walk(r, nodes_np, meta_np, test_block)
        want = r[8:12].astype(np.float32)
        return (int(got[1]) == int(want[1])
                and np.array_equal(np.array(got, np.float32)[[0, 2, 3]]
                                   .view(np.int32),
                                   want[[0, 2, 3]].view(np.int32)))

    sharing = {}
    for _, wave, _ in JOBS:
        rays = waves[wave]
        k4 = pt.trace_wide(rays, nodes, blocks, meta, False,
                           mt_precision="high", planes=planes)
        res = pair[0](rays[0:3].T.contiguous(), rays[3:6].T.contiguous(),
                      rays[6], rays[7])
        ref = (res.t, res.tri, res.bary[:, 0], res.bary[:, 1])
        # the ray and K4's t, id, u and v: what certify reads
        rows = torch.cat([rays, k4[0][None], k4[1][None].float(),
                          k4[2][None], k4[3][None]])
        _bitwise(f"K4 high against the ray-stream tracer at high, {wave}",
                 k4, ref, rows, certify,
                 " (borderline, and K4 is its walk replayed one thread at "
                 "a time with K15's block tests, in every bit)")
        c = pt.trace_wide_counts(rays, nodes, blocks, meta, False,
                                 mt_precision="high", planes=planes)
        sharing[wave] = dict(
            lanes_per_block=c["mt_tests"] / max(1, c["distinct_blocks"]),
            blocks_per_round=c["distinct_blocks"] / max(1, c["drain_rounds"]),
            **c)
        print(f"  K4 high warp drain, {wave}: {c['mt_tests']} block tests "
              f"in {c['drain_rounds']} drain rounds on "
              f"{c['distinct_blocks']} distinct blocks: "
              f"{sharing[wave]['blocks_per_round']:.3f} distinct blocks per "
              f"round, {sharing[wave]['lanes_per_block']:.3f} lanes per "
              f"distinct block", flush=True)
    return sharing


def phase_raystream(ctx):
    """3j: K15 and the ray-stream tracer on the headline tree."""
    from platinum_tpu_torch.ops import raystream as rs

    flat, waves = ctx["flat"], ctx["waves"]
    blocks, meta = flat.wbvh_tris, flat.wbvh_meta
    tri64, fp32 = ctx["tri64"], ctx["fp32"]
    coef, valid = fp32[0][1], fp32[0][2]
    slot_tri = flat.wbvh_slot.cpu().numpy()

    def certify(ray):
        return _borderline(ray, tri64) or _fp32_ambiguous(ray, fp32)

    def certify_pair(ray9):
        """A (ray, block) pair, its block id in a ninth row: borderline
        against the block's own 64 triangles."""
        sl = slice(int(ray9[8]) * 64, int(ray9[8]) * 64 + 64)
        tris = slot_tri[sl]
        return (_borderline(ray9[:8], tri64[tris[tris >= 0]])
                or _fp32_ambiguous(ray9[:8], [(np.eye(10), coef[:, :, sl],
                                               valid[sl])]))

    print("K15, the leaf-pair kernel and the ray-stream tracer (3j):",
          flush=True)
    rows = {}
    for name, wave, any_hit in JOBS:
        rays = waves[wave]
        n = rays.shape[1]
        o, d = rays[0:3].T.contiguous(), rays[3:6].T.contiguous()
        levels = []

        def timed_mt(*args):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = rs.stream_mt(*args)
            stop.record()
            levels.append((args[:4], out, start, stop))
            return out

        pair = rs.make_stream_tracer(flat.wbvh_nodes, blocks, meta,
                                     mt_fn=timed_mt)
        trace = pair[1] if any_hit else pair[0]
        trace(o, d, rays[6], rays[7])              # first use: not timed
        levels.clear()
        (res, stats), wall_ms = _synced_ms(
            lambda: trace.with_levels(o, d, rays[6], rays[7]))
        kernel_ms = sum(a.elapsed_time(b) for _, _, a, b in levels)
        # the whole tracer against K1 / K2
        got = ((rays[7], torch.where(res, 1, -1)) if any_hit else
               (res.t, res.tri, res.bary[:, 0], res.bary[:, 1]))
        _bitwise(f"ray-stream tracer against K1/K2, {wave}", got,
                 ctx["outs"][wave], rays, certify)
        # every level's pairs: the chunked kernel against its
        # one-thread-per-pair reference at every tier, every output bit,
        # and both timed on the card (device time)
        dev_ms = {}
        for tier in rs.TIERS:
            for per_pair in (False, True):
                key = f"{tier}{' per pair' if per_pair else ''}"
                dev_ms[key] = 0.0
                for (w, limit, pr, pb), _, _, _ in levels:
                    args = (w, limit, pr, pb, blocks, any_hit, tier)
                    if not per_pair:
                        got = rs.stream_mt(*args)
                        ref = rs.stream_mt(*args, per_pair=True)
                        check(all(_bits(a, b) for a, b in zip(got, ref)),
                              f"3j {wave}, {pr.shape[0]} pairs: the chunked "
                              f"K15 differs from the per-pair kernel at "
                              f"{tier!r}")
                    dev_ms[key] += _device_ms(
                        lambda: rs.stream_mt(*args, per_pair=per_pair), 10)
        print(f"  K15 {name}, {len(levels)} leaf levels: the chunked kernel "
              f"is the per-pair kernel in every output bit at every tier; "
              f"device ms per wave "
              + ", ".join(f"{k} {v:.4f}" for k, v in dev_ms.items()),
              flush=True)
        # every level's pairs against the plain version
        err, plain_ms, n_pairs, flops, nbytes = 0.0, 0.0, 0, 0, 36 * n
        for lvl, ((w, limit, pr, pb), out, _, _) in enumerate(levels):
            p, pms = _synced_ms(lambda: rs.stream_mt_plain(
                w, limit, pr, pb, blocks, any_hit))
            plain_ms += pms
            idx = pr.long()
            pair_rays = torch.cat([w[0:7, idx], limit[idx][None],
                                   pb[None].float()])
            err = max(err, _compare(
                f"K15 {name}, leaf level {lvl} ({pr.shape[0]} pairs)", out, p,
                any_hit, pair_rays, certify_pair))
            n_pairs += pr.shape[0]
            flops += pr.shape[0] * MT_FLOP
            nbytes += pr.shape[0] * 24 + int(torch.unique(pb).numel()) * 10240
        for st in stats:
            lvl = st["level"]
            cap = (1.0 if lvl == 0 else
                   PAIR_CAPS[min(lvl - 1, len(PAIR_CAPS) - 1)])
            fits = (st["pairs"] <= max(cap * n, CAP_FLOOR)
                    and st["leaf_pairs"] <= max(LEAF_CAP * n, CAP_FLOOR))
            print(f"    {wave} level {lvl}: {st['pairs'] / n:.3f} R pairs "
                  f"(cap {cap} R), {st['leaf_pairs'] / n:.3f} R leaf pairs "
                  f"(cap {LEAF_CAP} R): "
                  f"{'fits' if fits else 'OVERFLOWS'} the JAX module's "
                  f"static caps", flush=True)
        t_ops, t_bytes = flops / PEAK_FP32, nbytes / PEAK_BYTES
        print(f"  ray-stream tracer per {n}-ray wave, {name}: "
              f"{wall_ms:.1f} ms in all, {kernel_ms:.3f} ms of it between "
              f"the events around {len(levels)} K15 calls (host launch "
              f"gaps included) over {n_pairs} pairs "
              f"({n_pairs / n:.2f} R), {wall_ms - kernel_ms:.1f} ms host "
              f"glue and torch ops; plain version {plain_ms:.1f} ms; "
              f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB, bound "
              f"{max(t_ops, t_bytes) * 1e3:.4f} ms", flush=True)
        if wave != "camera":
            rows["any" if any_hit else "closest"] = dict(
                ms=dev_ms["highest"], plain_ms=plain_ms,
                bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                max_abs_err=err)
    return rows


BF_ROWS = ("expand", "prefix", "emit", "mt", "bwd")


def _bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _bf_work(seg, any_hit, occluded=0):
    """{kernel: (bytes, fp32 operations)} of one traced segment's
    launches, summed over its levels, from this run's counts: each input
    the kernel reads once (the rows of the distinct nodes and blocks it
    touches, the ray table once per launch), each output written once;
    16 slab tests per live (ray, node) pair, one 64-triangle block test
    per live MT pair (an occluded any-hit pair: one group of four, the
    least its early exit can test)."""
    st = seg["stat"].tolist()
    rays_bytes = 32 * seg["take"]
    work = {k: [0, 0] for k in BF_ROWS}
    live = seg["take"]
    mt_live = 0
    for lvl in range(len(st) - 1):
        n, nxt = st[lvl][0], st[lvl + 1]
        nd, n_next = nxt[7], nxt[0]
        live_next, live_mt = nxt[5], nxt[6]
        mt_tiles = nxt[1] - st[lvl][1]
        work["expand"][0] += (n * (4 + 512 + 512 + 64) + nd * 512
                              + rays_bytes)
        work["expand"][1] += live * 16 * SLAB_FLOP
        work["prefix"][0] += (n * (4 + 64 + 4 + 64) + nd * (64 + 64) + 64
                              + n_next * 4 + mt_tiles * 4
                              + (n_next * 128 - live_next) * 4
                              + (mt_tiles * 128 - live_mt) * 4)
        work["emit"][0] += (n * (512 + 512 + 4 + 64) + nd * 64
                            + (live_next + live_mt) * 4)
        work["bwd"][0] += (n * (512 + 4 + 64) + nd * 64
                           + (live_next + live_mt) * 16 + n * 128 * 16)
        live = live_next
        mt_live += live_mt
    mtr = seg["levels"][-1]
    n_mt = st[-1][1]
    blocks_used = int(torch.unique(mtr["mt_units"][:n_mt]).numel())
    work["mt"][0] = (n_mt * (512 + 4) + blocks_used * 10240 + rays_bytes
                     + n_mt * 128 * 16)
    work["mt"][1] = ((mt_live - occluded) * MT_FLOP
                     + occluded * MT_FLOP // 16)
    return work


def _live_histogram(mt_pairs, n_tiles, n_rays):
    """Tiles of the MT list by live lanes: {range: tiles}."""
    r = mt_pairs[:n_tiles * 128].view(n_tiles, 128)
    live = ((r >= 0) & (r < n_rays)).sum(dim=1)
    edges = (0, 1, 2, 17, 33, 65, 97, 128, 129)
    return {(f"{lo}" if hi == lo + 1 else f"{lo}-{hi - 1}"):
            int(((live >= lo) & (live < hi)).sum())
            for lo, hi in zip(edges[:-1], edges[1:])}


def _bf_hold_wave(label, seg, nodes, meta, blocks, any_hit, reps=10):
    """Every kernel of one traced wave (one segment) against its plain
    version on the same inputs, on the card: integer outputs and K13's /
    K14's results in every bit (the plain versions sum in the kernels'
    order); K13 at every tier and K14 on every level against the kernels
    they were before their redesign (`per_tile=True`, `per_unit=True`),
    and K10 and K12 on every level against theirs (`per_block=True`), in
    every bit. Returns ({kernel: kernel ms summed over the wave's
    levels}, {kernel: plain ms}, {"bwd", "emit": yardstick ms}, {K10,
    K12, K13, K14 and their references, K13 at "high" and "default":
    ms}): each kernel timed over `reps` launches on its recorded inputs,
    K14's yardstick being one torch.scatter_reduce("amin") of packed (t,
    slot) int64 keys per level, K12's one index_put_ of the live lanes'
    ray ids at their pre-formed positions in both lists per level."""
    from platinum_tpu_torch.ops import bfstream as bf

    rays, levels = seg["rays"], seg["levels"]
    dev = rays.device
    stat = seg["stat"].to(dev)
    mtr = levels[-1]
    mt_cap = mtr["mt_units"].shape[0]
    ms = {k: 0.0 for k in BF_ROWS}
    plain_ms = {k: 0.0 for k in BF_ROWS}
    redesign = {k: 0.0 for k in ("K10", "K10 per_block", "K12",
                                 "K12 per_block", "K14", "K14 per_unit")}
    lib_ms = {"bwd": 0.0, "emit": 0.0}

    def fresh(cap_next):
        return [torch.full((max(cap_next, 1) * 128,), -2, dtype=torch.int32,
                           device=dev),
                torch.full((mt_cap * 128,), -2, dtype=torch.int32,
                           device=dev),
                torch.full((mt_cap,), -2, dtype=torch.int32, device=dev),
                torch.zeros(8, dtype=torch.int32, device=dev)]

    for lvl, lv in enumerate(levels[:-1]):
        n = int(seg["stat"][lvl, 0])
        args = (lv["units"], stat[lvl], lv["pairs"], rays, nodes)
        got = bf.bf_expand(*args)
        ms["expand"] += _device_ms(lambda: bf.bf_expand(*args), reps)
        ref, pms = _synced_ms(lambda: bf.bf_expand_plain(*args))
        plain_ms["expand"] += pms
        check(all(torch.equal(a[:n], b[:n]) for a, b in zip(got, ref)),
              f"{label} level {lvl}: K10 differs from its plain version")
        old = bf.bf_expand(*args, per_block=True)
        check(all(torch.equal(a[:n], b[:n]) for a, b in zip(got, old)),
              f"{label} level {lvl}: K10 differs from its per-block "
              f"reference")
        redesign["K10 per_block"] += _device_ms(
            lambda: bf.bf_expand(*args, per_block=True), reps)
        outs = []
        for prefix, emit, key in ((bf.bf_prefix, bf.bf_emit, "kernel"),
                                  (bf.bf_prefix_plain, bf.bf_emit_plain,
                                   "plain")):
            bufs = fresh(lv["cap_next"])
            pargs = (lv["units"], stat[lvl], lv["counts"], meta,
                     lv["cap_next"], mt_cap, *bufs)
            out, t_p = _synced_ms(lambda: prefix(*pargs))
            eargs = (lv["pairs"], lv["masks"], stat[lvl], out[0], out[2],
                     out[1], bufs[0], bufs[1])
            if key == "kernel":
                # the reference into copies of the lists as K11 left them
                rargs = (*eargs[:6], bufs[0].clone(), bufs[1].clone())
                bf.bf_emit(*rargs, per_block=True)
            _, t_e = _synced_ms(lambda: emit(*eargs))
            if key == "kernel":
                ms["prefix"] += _device_ms(lambda: prefix(*pargs), reps)
                ms["emit"] += _device_ms(lambda: emit(*eargs), reps)
                check(torch.equal(bufs[0], rargs[6])
                      and torch.equal(bufs[1], rargs[7]),
                      f"{label} level {lvl}: K12 differs from its "
                      f"per-block reference")
                redesign["K12 per_block"] += _device_ms(
                    lambda: bf.bf_emit(*rargs, per_block=True), reps)
                lib_ms["emit"] += _emit_yardstick(label, lvl, n, lv,
                                                  out, bufs, reps)
            else:
                plain_ms["prefix"] += t_p
                plain_ms["emit"] += t_e
            outs.append((out, bufs))
        (ko, kb), (po, pb) = outs
        nd, nn = int(kb[3][7]), int(kb[3][0])
        check(torch.equal(ko[0][:n], po[0][:n])
              and torch.equal(ko[1][:nd * 16], po[1][:nd * 16])
              and torch.equal(ko[2][:n], po[2][:n])
              and torch.equal(ko[3][:nn], po[3][:nn])
              and all(torch.equal(a, b) for a, b in zip(kb, pb))
              and torch.equal(kb[3], stat[lvl + 1]),
              f"{label} level {lvl}: K11 / K12 differ from their plain "
              f"versions")
    n_mt = int(seg["stat"][-1, 1])
    margs = (mtr["mt_pairs"], mtr["mt_units"], stat[-1], rays, blocks,
             any_hit)
    got = bf.bf_mt(*margs)
    ms["mt"] = _device_ms(lambda: bf.bf_mt(*margs), reps)
    ref, plain_ms["mt"] = _synced_ms(lambda: bf.bf_mt_plain(*margs))
    k = n_mt * 128
    check(all(_bits(a[:k], b[:k]) for a, b in zip(got, ref)),
          f"{label}: K13 differs from its plain version")
    redesign["K10"], redesign["K12"] = ms["expand"], ms["emit"]
    for tier in ("highest", "high", "default"):
        targs = (*margs, tier)
        new = bf.bf_mt(*targs)
        old = bf.bf_mt(*targs, per_tile=True)
        check(all(_bits(a[:k], b[:k]) for a, b in zip(new, old)),
              f"{label}: K13 at {tier!r} differs from its per-tile "
              f"reference")
        redesign[f"K13 {tier}"] = _device_ms(lambda: bf.bf_mt(*targs), reps)
        redesign[f"K13 {tier} per_tile"] = _device_ms(
            lambda: bf.bf_mt(*targs, per_tile=True), reps)
    res_k = res_p = None
    for lvl in range(len(levels) - 2, -1, -1):
        lv = levels[lvl]
        n = int(seg["stat"][lvl, 0])
        bargs = (lv["masks"], stat[lvl], lv["dn"], lv["uoff"], lv["base"])
        child = res_k
        res_k = bf.bf_bwd(*bargs, child, got)
        ms["bwd"] += _device_ms(lambda: bf.bf_bwd(*bargs, child, got),
                                reps)
        res_p, pms = _synced_ms(lambda: bf.bf_bwd_plain(*bargs, res_p, ref))
        plain_ms["bwd"] += pms
        check(all(_bits(a[:n * 128], b[:n * 128])
                  for a, b in zip(res_k, res_p)),
              f"{label} level {lvl}: K14 differs from its plain version")
        old = bf.bf_bwd(*bargs, child, got, per_unit=True)
        check(all(_bits(a[:n * 128], b[:n * 128])
                  for a, b in zip(res_k, old)),
              f"{label} level {lvl}: K14 differs from its per-unit "
              f"reference")
        redesign["K14"] = ms["bwd"]
        redesign["K14 per_unit"] += _device_ms(
            lambda: bf.bf_bwd(*bargs, child, got, per_unit=True), reps)
        # the yardstick: the same per-pair minimum as one scatter_reduce
        # of packed (t, slot) keys over the level's (pair, child) edges
        sel, pos, in_mt = bf._routes(lv["masks"], n, lv["dn"], lv["uoff"],
                                     lv["base"])
        src_t = torch.where(in_mt, got[0][torch.where(sel & in_mt, pos, 0)],
                            child[0][torch.where(sel & ~in_mt, pos, 0)]
                            if child is not None else got[0][0])
        src_s = torch.where(in_mt, got[1][torch.where(sel & in_mt, pos, 0)],
                            child[1][torch.where(sel & ~in_mt, pos, 0)]
                            if child is not None else got[1][0])
        keys = ((src_t.view(torch.int32).long() << 32)
                | (src_s.long() & 0xFFFFFFFF))[sel]
        lane = torch.arange(n * 128, device=dev).view(n, 1, 128).expand(
            -1, 16, -1)[sel]
        out = torch.full((n * 128,), torch.iinfo(torch.int64).max,
                         dtype=torch.int64, device=dev)
        lib_ms["bwd"] += _device_ms(
            lambda: out.scatter_reduce_(0, lane, keys, "amin"), reps)
        hit = res_k[1][:n * 128] >= 0
        check(torch.equal(out[hit] & 0xFFFFFFFF,
                          res_k[1][:n * 128][hit].long()),
              f"{label} level {lvl}: the yardstick's minimum is not K14's")
    return ms, plain_ms, lib_ms, redesign


def _emit_yardstick(label, lvl, n, lv, out, bufs, reps):
    """K12's partial yardstick on one level, device ms: one index_put_ of
    the live lanes' ray ids at the positions K12 routes them to, formed
    beforehand (untimed) and offset into one tensor for both lists; held
    to K12's entries."""
    from platinum_tpu_torch.ops import bfstream as bf

    sel, pos, in_mt = bf._routes(lv["masks"], n, out[0], out[2], out[1])
    nxt = bufs[0].shape[0]
    idx = torch.where(in_mt, pos + nxt, pos)[sel]
    vals = lv["pairs"][:n][:, None, :].expand(-1, 16, -1)[sel]
    dest = torch.full((nxt + bufs[1].shape[0],), -2, dtype=torch.int32,
                      device=idx.device)
    t = _device_ms(lambda: dest.index_put_((idx,), vals), reps)
    check(torch.equal(dest[idx], torch.cat([bufs[0], bufs[1]])[idx]),
          f"{label} level {lvl}: the index_put_ yardstick is not K12's")
    return t


def phase_bf(ctx):
    """3k: K10-K14 and the breadth-first tracer on the headline's whole
    camera, bounce and shadow waves."""
    import warnings

    from platinum_tpu_torch.ops import bfstream as bf

    flat, waves = ctx["flat"], ctx["waves"]
    blocks, meta = flat.wbvh_tris, flat.wbvh_meta
    nodes = ctx["nodes"]
    tri64, fp32 = ctx["tri64"], ctx["fp32"]

    def certify(ray):
        return _borderline(ray, tri64) or _fp32_ambiguous(ray, fp32)

    grids = bf.resident_grids(blocks.device)
    print(f"K10-K14, the breadth-first pipeline, and its tracer (3k); the "
          f"CTAs the card holds of K13, K14 and K12 (K12 launches at most "
          f"one per four units of a level's capacity): "
          f"{grids}", flush=True)
    tc, ta = bf.make_bf_tracer(flat.wbvh_nodes, blocks, meta)
    rows = {}
    for name, wave, any_hit in JOBS:
        rays = waves[wave]
        n = rays.shape[1]
        o, d = rays[0:3].T.contiguous(), rays[3:6].T.contiguous()
        trace = ta if any_hit else tc
        trace(o, d, rays[6], rays[7])                # first use: not timed
        _zero_launches()
        (res, segs), wall_ms = _synced_ms(
            lambda: trace.with_levels(o, d, rays[6], rays[7]))
        launches = {k: v for k, v in bf.LAUNCHES.items() if v}
        check(len(segs) == 1, f"{wave}: {len(segs)} segments, expected one")
        seg = segs[0]
        got = ((rays[7], torch.where(res, 1, -1)) if any_hit else
               (res.t, res.tri, res.bary[:, 0], res.bary[:, 1]))
        _bitwise(f"bf tracer against K1/K2, {wave}", got, ctx["outs"][wave],
                 rays, certify)
        st = seg["stat"].tolist()
        for lvl in range(len(st) - 1):
            nxt = st[lvl + 1]
            cap = seg["caps"][lvl]
            cap_next = seg["caps"][lvl + 1] if lvl + 2 < len(st) else 0
            print(f"    {wave} level {lvl}: {st[lvl][0]} tiles (cap {cap}) "
                  f"of {nxt[7]} nodes -> {nxt[0]} tiles with {nxt[5]} live "
                  f"pairs next (cap {cap_next}), {nxt[1] - st[lvl][1]} MT "
                  f"tiles with {nxt[6]} live pairs (cursor {nxt[1]} of "
                  f"{seg['mt_cap']}), {nxt[2]} pairs lost", flush=True)
        lost = sum(r[2] for r in st[1:])
        # the host syncs of one traced wave: torch's own count
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            trace(o, d, rays[6], rays[7])
        torch.cuda.set_sync_debug_mode("default")
        where = [f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
                 if "synchroniz" in str(w.message)]
        syncs = len(where)
        wave_ms = _time_ms(lambda: trace(o, d, rays[6], rays[7]), 5)
        occluded = int(res.sum()) if any_hit else 0
        ms, plain_ms, lib_ms, redesign = _bf_hold_wave(
            f"3k {wave}", seg, nodes, meta, blocks, any_hit)
        mtr = seg["levels"][-1]
        print(f"    {wave}: MT tiles by live lanes "
              f"{_live_histogram(mtr['mt_pairs'], st[-1][1], n)}; device "
              f"ms, the redesigned K10, K12, K13 (every tier) and K14 "
              f"beside the kernels before (per_block, per_tile, per_unit), "
              f"each held to them in every bit: " + ", ".join(f"{k} {v:.4f}"
                                         for k, v in redesign.items()),
              flush=True)
        work = _bf_work(seg, any_hit, occluded)
        print(f"  bf tracer per {n}-ray wave, {name}: {wave_ms:.3f} ms "
              f"({wall_ms:.1f} ms with the level records), traced "
              f"{seg['traces']} time(s), {lost} pairs lost, {syncs} host "
              f"sync(s) (torch's sync debug mode: {where}); launches "
              f"{launches}; "
              f"kernel ms " + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
              + f" (sum {sum(ms.values()):.3f}); plain ms "
              + ", ".join(f"{k} {v:.1f}" for k, v in plain_ms.items())
              + f"; amin over pre-gathered keys (routing and gathers "
              f"untimed) {lib_ms['bwd']:.3f} ms; index_put_ at pre-formed "
              f"positions (routing untimed) {lib_ms['emit']:.4f} ms",
              flush=True)
        check(seg["traces"] == 1 or lost == 0, f"{wave}: pairs lost")
        for k in BF_ROWS:
            nbytes, flops = work[k]
            t_ops, t_bytes = flops / PEAK_FP32, nbytes / PEAK_BYTES
            print(f"    {k}: {nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP "
                  f"-> bound {max(t_ops, t_bytes) * 1e3:.4f} ms by "
                  f"{'operations' if t_ops >= t_bytes else 'bytes'}",
                  flush=True)
            row = dict(ms=ms[k], plain_ms=plain_ms[k],
                       bound_ms=max(t_ops, t_bytes) * 1e3,
                       bound_by="operations" if t_ops >= t_bytes else "bytes",
                       max_abs_err=0.0, library_ms=None)
            if k in ("expand", "emit", "mt", "bwd"):
                # the kernel before the redesign on the same inputs
                row["reference_ms"] = redesign[{
                    "expand": "K10 per_block", "emit": "K12 per_block",
                    "mt": "K13 highest per_tile", "bwd": "K14 per_unit"}[k]]
            if k == "emit":
                # one index_put_ at positions formed beforehand: a part of
                # K12's work, not its function
                row["library_ms"] = lib_ms["emit"]
                row["library_part"] = ("index_put_ of the live lanes' ray "
                                       "ids at pre-formed positions; the "
                                       "routing untimed")
            if wave == "bounce" and k != "mt":
                rows[k] = row
            if k == "mt" and wave in ("bounce", "shadow"):
                rows["mt any" if any_hit else "mt closest"] = row
        if any_hit:
            # K13's any-hit mode is on no render path: its launches are the
            # tracer's own entry's on this wave
            rows["mt any"]["launches"] = launches["mt any"]
        # one read of the levels' status per trace, and no other
        check(syncs <= seg["traces"], f"{wave}: {syncs} host syncs in one "
                                      f"traced wave: {where}")
    return rows


def phase_stream(scene_small, cam_small, dev, pts_small):
    """3f: K6 on bistro_class_studio's tree, and the instanced stream
    modes on the colonnade."""
    from platinum_tpu_torch.app.scenes import make_colonnade_scene
    from platinum_tpu_torch.ops import packet_trace as pt
    from platinum_tpu_torch.render.flatten import flatten_scene
    from platinum_tpu_torch.render.types import RenderSettings

    scene, cam = make_colonnade_scene(**BISTRO)
    t0 = time.perf_counter()
    flat = flatten_scene(scene, cam, RenderSettings(
        width=960, height=540, tracer="packet", instancing="off",
        stream="auto"), device=dev)
    t_flat = time.perf_counter() - t0
    check(flat.wbvh_stream, "the bistro tree does not stream")
    print(f"K6 vs plain (3f): bistro colonnade flattened in {t_flat:.2f} s: "
          f"{flat.geometry.indices.shape[0]} triangles, "
          f"{flat.wbvh_nodes.shape[0]} wide nodes, "
          f"{flat.wbvh_tris.shape[0]} MT blocks "
          f"({flat.wbvh_tris.numel() * 4 / 1e6:.1f} MB), "
          f"{int(flat.lights.count)} lights, wbvh_stream {flat.wbvh_stream}",
          flush=True)
    nodes = flat.wbvh_nodes.reshape(-1, 16, 8).contiguous()
    blocks, meta = flat.wbvh_tris, flat.wbvh_meta
    pts = _wave_points(flat, dev, 960, 540)
    waves = _waves(pts, nodes, dev)
    tri64 = flat.geometry.tri_geo[:, 0:9].double().cpu().numpy()
    coef, valid = _coef_slots(blocks, flat.wbvh_slot.cpu().numpy())
    fp32 = [(np.eye(10), coef, valid)]

    def certify(ray):
        return _borderline(ray, tri64) or _fp32_ambiguous(ray, fp32)

    # the plain version takes ~60 s per whole bistro wave: every wave is
    # held to it on its 16,384-ray subset and, below, bit for bit to K1/K2
    # on the whole wave (K1/K2 keep their whole-wave plain hold on the
    # headline tree, phase 3)
    rows, outs = _hold_tree("K6", nodes, blocks, meta, waves, pts["sample"],
                            certify, mode=dict(stream=True),
                            whole_plain=False)
    refs, ref_ms = {}, {}
    for name, wave, any_hit in JOBS:
        def k1():
            refs[wave] = pt.trace_wide(waves[wave], nodes, blocks, meta,
                                       any_hit)

        ref_ms[wave] = _time_ms(k1, 20)
        print(f"  K1/K2 time per {waves[wave].shape[1]}-ray wave on the "
              f"bistro tree, {name}: {ref_ms[wave]:.3f} ms", flush=True)
        _bitwise(f"K6 against K1/K2, bistro {wave}", outs[wave], refs[wave],
                 waves[wave], None)
    _any_drain_against_per_thread("bistro", nodes, blocks, meta,
                                  waves["shadow"],
                                  {"K2": refs["shadow"],
                                   "K6 any hit": outs["shadow"]})
    print("K9 against K1/K2 on the bistro tree (3h):", flush=True)
    for key, mode in (("pipe", dict(pipe=True)),
                      ("flat_walk", _flat_mode(meta))):
        for name, wave, any_hit in JOBS:
            got = {}

            def k9():
                got["k"] = pt.trace_wide(waves[wave], nodes, blocks, meta,
                                         any_hit, **mode)

            kms = _time_ms(k9, 20)
            _bitwise(f"K9 {key} against K1/K2, bistro {wave}", got["k"],
                     refs[wave], waves[wave],
                     certify if any_hit else None)
            print(f"  K9 {key} time per {waves[wave].shape[1]}-ray wave on "
                  f"the bistro tree, {name}: {kms:.3f} ms (K1/K2 "
                  f"{ref_ms[wave]:.3f} ms)", flush=True)
            _against_its_walk(f"K9 {key} bistro {wave}", waves[wave], nodes,
                              blocks, meta, any_hit, **mode)
    _drain_against_per_thread("bistro", nodes, blocks, meta, waves,
                              stream=True)
    print("K8 with stream=True against K6 on the bistro tree (3g):",
          flush=True)
    _paired_waves("bistro paired(bounce, shadow), stream=True", nodes, blocks,
                  meta, waves["bounce"], waves["shadow"], outs["bounce"],
                  outs["shadow"], stream=True)
    print("launch floor / walk / MT on the bistro bounce wave (3i):",
          flush=True)
    _profile_times("bistro bounce closest", nodes, blocks, meta,
                   waves["bounce"], False)
    del coef, valid, fp32

    host = {}
    flat = flatten_scene(scene_small, cam_small, RenderSettings(
        width=512, height=512, tracer="packet", instancing="on",
        stream="on"), device=dev, host_accel_out=host)
    check(flat.wbvh_stream, "instancing='on', stream='on' does not stream")
    nodes = flat.wbvh_nodes.reshape(-1, 16, 8).contiguous()
    waves = _waves(pts_small, nodes, dev)
    inst_certify = _instanced_certify(flat, host)
    inst_rows, inst_outs = _hold_tree(
        "K6 instanced", nodes, flat.wbvh_tris, flat.wbvh_meta, waves,
        pts_small["sample"], inst_certify, inst_feat=flat.instances.feat,
        mode=dict(stream=True), inst_need=dict(pipe=True, per_thread=True))
    for _, wave, any_hit in JOBS:
        ref = pt.trace_wide(waves[wave], nodes, flat.wbvh_tris,
                            flat.wbvh_meta, any_hit, flat.instances.feat)
        _bitwise(f"K6 instanced against K3, {wave}", inst_outs[wave], ref,
                 waves[wave], inst_certify)
    return rows


def _render_path(label, scene, cam, settings, renderer_device=None):
    """Drive one main path through the Renderer API: start_render,
    render() until done (timed per step), readback, EXR export, and the
    rays per spp from render_sample's own count of the first sample (or
    batch). Launch counts are zeroed
    just before start_render and read just after the last step; the
    renderer returned carries those of start_render alone (the auto plan's
    probe) as `probe_launches`."""
    from platinum_tpu_torch.render import integrator
    from platinum_tpu_torch.render.flatten import analyze_features
    from platinum_tpu_torch.render.renderer import Renderer, RenderStatus

    renderer = (Renderer(scene) if renderer_device is None
                else Renderer(scene, device=renderer_device))
    _zero_launches()
    renderer.start_render(cam, settings)
    # what start_render itself launched: the auto plan's probe sample
    renderer.probe_launches = _launches()
    steps = []
    while not renderer.status & RenderStatus.DONE:
        t0 = time.perf_counter()
        renderer.render()
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
    launches = _launches()
    img = renderer.readback()
    s = renderer.settings
    check(img.shape == (s.height, s.width, 3), f"{label}: image {img.shape}")
    check(bool(np.isfinite(img).all()), f"{label}: non-finite values")
    check(float(img.mean()) > 0.0, f"{label}: image mean {img.mean()} <= 0")
    feats = analyze_features(renderer.flat)
    batch = max(1, s.spp_batch)        # a step renders `batch` samples
    # rays per spp: counted on the first batch, rendered once more
    rays_spp = float(integrator.render_sample(
        renderer.flat, s, 0, return_stats=True, features=feats)[1]) / batch
    ms_spp = float(np.mean(steps[1:])) * 1e3 / batch
    renderer.ms_per_spp = ms_spp
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "render.exr")
        renderer.export_exr(path)
        exr_bytes = os.path.getsize(path)
    check(exr_bytes > 0, f"{label}: empty EXR")
    plan = integrator._compaction_plan(s.num_pixels, s)
    ran = {k: v for k, v in launches.items() if v}
    print(f"{label}: {s.width}x{s.height} x {s.spp} spp x {s.max_bounces} "
          f"bounces: {ms_spp:.1f} ms/spp after the first step "
          f"({steps[0] * 1e3:.1f} ms), {rays_spp / ms_spp / 1e3:.2f} Mrays/s "
          f"({rays_spp:.0f} rays/spp, from the first sample), mean "
          f"{img.mean():.4f}, plan {plan}, "
          f"launches {ran}, EXR {exr_bytes} bytes", flush=True)
    return renderer, launches, float(img.mean())


def _only(label, launches, allowed):
    """Every mode in `allowed` launched on the path, and no other."""
    ran = {k for k, v in launches.items() if v}
    check(ran == set(allowed),
          f"{label} launched {sorted(ran)}, expected {sorted(allowed)}")


def phase_headline_plain(scene, cam, dev):
    from platinum_tpu_torch.render.types import RenderSettings

    settings = RenderSettings(width=512, height=512, spp=2, max_bounces=8,
                              kernel="mis", sampler="halton",
                              tracer="packet", instancing="off")
    _, launches, _ = _render_path("headline without compaction", scene,
                                  cam, settings, renderer_device=dev)
    check(launches["closest"] > 0 and launches["any"] > 0,
          f"the render did not launch both K1/K2 modes: {launches}")


def phase_instanced(scene, cam, dev):
    from platinum_tpu_torch.core.transform import Transform
    from platinum_tpu_torch.render.flatten import flatten_scene
    from platinum_tpu_torch.render.integrator import (init_path_state,
                                                      make_tracers)
    from platinum_tpu_torch.render.types import RenderSettings

    settings = RenderSettings(width=512, height=512, spp=4, max_bounces=8,
                              kernel="mis", sampler="halton",
                              tracer="packet", compact=True, instancing="on")
    renderer, launches, _ = _render_path("instanced main path", scene, cam,
                                         settings)
    check(launches["inst_closest"] > 0 and launches["inst_any"] > 0,
          f"the instanced render did not launch both K3 modes: {launches}")
    check(launches["closest"] == 0 and launches["any"] == 0,
          f"the instanced render launched K1/K2: {launches}")

    # a transform edit: refit in place, one more spp, then the refit tree
    # against a fresh flatten of the moved scene on a camera wave
    node = next(scene.node(i.node_id) for i in scene.get_instances()
                if scene.node(i.node_id).name == MOVED_NODE)
    old = node.transform
    moved = Transform(translation=np.asarray(old.translation) + [1.0, 0, 0.5],
                      rotation=old.rotation, scale=old.scale)
    t0 = time.perf_counter()
    renderer.update_instance_transform(node.id, moved)
    t_edit = time.perf_counter() - t0
    renderer.render()
    img = renderer.readback()
    check(bool(np.isfinite(img).all()) and img.mean() > 0,
          "render after the transform edit")
    fresh = flatten_scene(scene, cam, settings, device=renderer.device)
    st = init_path_state(renderer.flat, settings, 0)
    ref_c, _ = make_tracers(fresh, settings)
    got_c, _ = make_tracers(renderer.flat, settings)
    a = got_c(st["o"], st["d"], 1e-3, float("inf"))
    b = ref_c(st["o"], st["d"], 1e-3, float("inf"))
    same = (a.hit == b.hit) & (~b.hit | ((a.tri == b.tri) & (a.inst == b.inst)))
    agree = same.float().mean().item()
    print(f"  transform edit: refit in {t_edit * 1e3:.1f} ms; camera wave "
          f"against a fresh flatten: {agree:.4%} of rays agree", flush=True)
    check(agree >= AGREE, "refit tree differs from a fresh flatten")
    return launches


HEADLINE = dict(width=512, height=512, max_bounces=8, kernel="mis",
                sampler="halton", tracer="packet", compact=True,
                instancing="off", compact_plan="auto")


def _syncs_per_spp(renderer):
    """4c: host syncs (torch's sync debug mode) and make_tracers calls of
    one spp, before and after the tracer pair was built once per
    start_render: the sample through integrator.render_step_n without
    `tracers=` (a pair built for the sample, as Renderer.render did
    before), then through Renderer.render (the pair start_render built).
    The renderer's accumulator is restored."""
    import warnings

    from platinum_tpu_torch.render import integrator

    calls = []
    real = integrator.make_tracers

    def counted(flat, settings):
        calls.append(1)
        return real(flat, settings)

    def before():
        integrator.render_step_n(renderer.flat, renderer.settings,
                                 renderer._buckets[0], 0, 1,
                                 features=renderer._features)

    def after():
        # not the last step, whose end-of-render synchronise would count
        renderer._accumulated = renderer.settings.spp - 2
        renderer.render()

    saved = (list(renderer._buckets), renderer._accumulated)
    out = {}
    integrator.make_tracers = counted
    try:
        for label, step in (("before", before), ("after", after)):
            calls.clear()
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("warn")
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                step()
            torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            out[label] = dict(syncs=sum("synchroniz" in str(w.message)
                                        for w in caught),
                              make_tracers=len(calls))
    finally:
        integrator.make_tracers = real
        renderer._buckets, renderer._accumulated = saved
    print(f"  per spp, host syncs (torch's sync debug mode) and make_tracers "
          f"calls: before (a pair per sample) {out['before']['syncs']} syncs, "
          f"{out['before']['make_tracers']} make_tracers; after (the pair of "
          f"start_render) {out['after']['syncs']} syncs, "
          f"{out['after']['make_tracers']} make_tracers", flush=True)
    check(out["after"]["make_tracers"] == 0,
          "Renderer.render built a tracer pair")
    return out


def phase_headline_compact(scene, cam):
    from platinum_tpu_torch.render.types import RenderSettings

    settings = RenderSettings(spp=4, **HEADLINE)
    renderer, launches, mean = _render_path("headline with compaction",
                                            scene, cam, settings)
    check(isinstance(renderer.settings.compact_plan, tuple),
          f"compact_plan not resolved: {renderer.settings.compact_plan}")
    _only("the headline", launches, ("closest", "any"))
    _syncs_per_spp(renderer)
    return launches, mean, renderer


def phase_mt3_knob(scene, cam, head_mean):
    """4d: sponza_class_512_mt3_knob (bench.py:244-252) cut to 4 spp."""
    from platinum_tpu_torch.render.types import RenderSettings

    settings = RenderSettings(spp=4, mt_precision="high", **HEADLINE)
    _, launches, mean = _render_path("sponza_class_512_mt3_knob", scene, cam,
                                     settings)
    _only("the mt3 knob", launches, ("closest+high", "any", "split_planes"))
    check(launches["split_planes"] == 1,
          f"the mt3 knob split the blocks {launches['split_planes']} times")
    rel = abs(mean / head_mean - 1.0)
    print(f"  image mean {mean:.5f} against 4c's {head_mean:.5f} "
          f"(rel {rel:.2e})", flush=True)
    check(rel <= MEAN_TIER_RTOL, "the mt3 knob's mean is off the headline's")
    return launches


def phase_bistro():
    """4e: bistro_class_studio (bench.py:348-380) at its own 4 spp."""
    from platinum_tpu_torch.app.scenes import make_colonnade_scene
    from platinum_tpu_torch.render.types import RenderSettings

    scene, cam = make_colonnade_scene(**BISTRO)
    settings = RenderSettings(width=960, height=540, spp=4, max_bounces=4,
                              kernel="mis", sampler="halton",
                              tracer="packet", compact=True,
                              instancing="off", stream="auto")
    renderer, launches, _ = _render_path("bistro_class_studio", scene, cam,
                                         settings)
    flat = renderer.flat
    check(flat.wbvh_stream, "the bistro render did not stream its blocks")
    print(f"  {flat.geometry.indices.shape[0]} triangles, "
          f"{flat.wbvh_tris.shape[0]} MT blocks "
          f"({flat.wbvh_tris.numel() * 4 / 1e6:.1f} MB), wbvh_stream "
          f"{flat.wbvh_stream}; the edit-loop cadence "
          f"(interact_ms_per_frame) is measured on studio_loop's scene (6d)",
          flush=True)
    _only("the bistro", launches, ("stream+closest", "stream+any"))
    return launches, renderer


def phase_exact_options(scene, cam):
    """4f: the headline at 2 spp with neither option, with two_phase and
    with oct_order."""
    from platinum_tpu_torch.render.types import RenderSettings

    out = {}
    k1, _, base = _render_path("headline at 2 spp (K1)", scene, cam,
                               RenderSettings(spp=2, **HEADLINE))
    out["image"] = k1.readback()
    for label, opt, keys in (("two_phase", dict(mt_precision="two_phase"),
                              ("closest+two_phase", "split_planes")),
                             ("oct_order", dict(oct_order=True),
                              ("closest+oct",))):
        _, launches, mean = _render_path(
            f"headline at 2 spp with {label}", scene, cam,
            RenderSettings(spp=2, **opt, **HEADLINE))
        _only(f"the {label} headline", launches, (*keys, "any"))
        rel = abs(mean / base - 1.0)
        print(f"  image mean {mean:.5f} against K1's {base:.5f} "
              f"(rel {rel:.2e})", flush=True)
        check(rel <= MEAN_RTOL, f"the {label} render's mean is off K1's")
        out[label] = launches
    return out, base


def phase_raystream_render(scene, cam, base_mean):
    """4g: sponza_class_512's settings at 2 spp through
    integrator.render_step_n with the ray-stream pair as `tracers=`."""
    from platinum_tpu_torch.ops import raystream as rs
    from platinum_tpu_torch.render import autoplan, integrator
    from platinum_tpu_torch.render.flatten import (analyze_features,
                                                   flatten_scene)
    from platinum_tpu_torch.render.types import RenderSettings

    settings = RenderSettings(spp=2, **HEADLINE)
    flat = flatten_scene(scene, cam, settings)
    settings = autoplan.resolve_auto_plan(flat, settings)  # probes with K1/K2
    feats = analyze_features(flat)
    pair = rs.make_stream_tracer(flat.wbvh_nodes, flat.wbvh_tris,
                                 flat.wbvh_meta, flat.wbvh_slot)
    accum = torch.zeros((settings.num_pixels, 3), device=flat.wbvh_nodes.device)
    _zero_launches()
    img, ms = _synced_ms(lambda: integrator.render_step_n(
        flat, settings, accum, 0, 2, features=feats, tracers=pair))
    launches = _launches()
    _only("the ray-stream render", launches,
          ("stream_mt closest", "stream_mt any"))
    img = img.cpu().numpy()
    check(bool(np.isfinite(img).all()), "the ray-stream render is not finite")
    rel = abs(float(img.mean()) / base_mean - 1.0)
    ran = {k: v for k, v in launches.items() if v}
    print(f"headline through the ray-stream pair (4g): 512x512 x 2 spp in "
          f"{ms:.1f} ms ({ms / 2:.1f} ms/spp, the first use included), mean "
          f"{img.mean():.5f} against K1's {base_mean:.5f} at the same 2 spp "
          f"(rel {rel:.2e}), plan {settings.compact_plan}, launches {ran}",
          flush=True)
    check(rel <= MEAN_RTOL, "the ray-stream render's mean is off K1's")
    return launches


IMAGE_RMSE = 1e-3  # 4i, 4j against 4f's K1 render (ROADMAP's image bar)


def phase_bf_render(scene, cam, base_img):
    """4j: sponza_class_512's settings with tracer="bf" at 2 spp: closest
    waves through K10-K14, any-hit waves through K2; held to the packet
    render of 4f at the same 2 spp by RMSE."""
    from platinum_tpu_torch.ops import bfstream as bf
    from platinum_tpu_torch.render.types import RenderSettings

    settings = RenderSettings(spp=2, **dict(HEADLINE, tracer="bf"))
    renderer, launches, mean = _render_path(
        "headline with tracer='bf' (4j)", scene, cam, settings)
    depth = bf._tree_depth(renderer.flat.wbvh_meta.cpu().numpy())
    check(renderer.settings.bf_depth == depth,
          f"the Renderer set bf_depth={renderer.settings.bf_depth}, the "
          f"tree's depth is {depth}")
    allowed = ("bf expand", "bf prefix", "bf prefix fill", "bf emit",
               "bf bwd", "bf mt closest", "any")
    _only("the bf headline", launches, allowed)
    img = renderer.readback()
    rmse = float(np.sqrt(np.mean((img - base_img) ** 2)))
    spp = renderer.settings.spp
    per_spp = {k: (launches[k] - renderer.probe_launches[k]) / spp
               for k in allowed}
    print(f"  tracer='bf': RMSE {rmse:.3e} against 4f's K1 render at the "
          f"same 2 spp (largest per-pixel difference "
          f"{float(np.abs(img - base_img).max()):.3e}); trace launches per "
          f"spp {per_spp} (the auto plan's probe apart: "
          f"{ {k: renderer.probe_launches[k] for k in allowed} }); depth "
          f"{depth}, so {depth + 1} launches of K10, K11's scan and fill, "
          f"K12, K14 and one of K13 per closest wave; bf.LAUNCHES "
          f"{dict(bf.LAUNCHES)}",
          flush=True)
    check(rmse <= IMAGE_RMSE, f"the bf render is {rmse:.3e} RMSE off K1's")
    # K10-K14 compute K1's closest hits to the bit on these waves (3k)
    check(rmse == 0.0, f"the bf render is not K1's: RMSE {rmse:.3e}")
    return launches


def phase_pipe_render(scene, cam, base_mean, base_img):
    """4i: sponza_class_512's settings at 2 spp through
    integrator.render_step_n with the pipelined packet tracer as
    `tracers=`, without and with the flat push; each image held to 4f's
    K1 render by its mean and by RMSE. Returns {"pipe" / "flat_walk":
    launch counts}."""
    from platinum_tpu_torch.ops import packet_trace as pt
    from platinum_tpu_torch.render import autoplan, integrator
    from platinum_tpu_torch.render.flatten import (analyze_features,
                                                   flatten_scene)
    from platinum_tpu_torch.render.types import RenderSettings

    settings = RenderSettings(spp=2, **HEADLINE)
    flat = flatten_scene(scene, cam, settings)
    settings = autoplan.resolve_auto_plan(flat, settings)  # probes with K1/K2
    feats = analyze_features(flat)
    out = {}
    for key, opt in (("pipe", dict(pipe=True)),
                     ("flat_walk", dict(flat_walk=True))):
        pair = pt.make_packet_tracer(flat.wbvh_nodes, flat.wbvh_tris,
                                     flat.wbvh_meta, flat.wbvh_slot, **opt)
        accum = torch.zeros((settings.num_pixels, 3),
                            device=flat.wbvh_nodes.device)
        _zero_launches()
        img, ms = _synced_ms(lambda: integrator.render_step_n(
            flat, settings, accum, 0, 2, features=feats, tracers=pair))
        launches = _launches()
        prefix = "flat+" if key == "flat_walk" else "pipe+"
        _only(f"the {key} headline", launches,
              (prefix + "closest", prefix + "any"))
        img = img.cpu().numpy()
        check(bool(np.isfinite(img).all()), f"the {key} render is not finite")
        rel = abs(float(img.mean()) / base_mean - 1.0)
        img = img.reshape(base_img.shape)
        rmse = float(np.sqrt(np.mean((img - base_img) ** 2)))
        ran = {k: v for k, v in launches.items() if v}
        print(f"headline through the packet tracer with {key}=True (4i): "
              f"512x512 x 2 spp in {ms:.1f} ms ({ms / 2:.1f} ms/spp), mean "
              f"{img.mean():.5f} against K1's {base_mean:.5f} at the same 2 "
              f"spp (rel {rel:.2e}), RMSE {rmse:.3e} against 4f's K1 render "
              f"(largest per-pixel difference "
              f"{float(np.abs(img - base_img).max()):.3e}), plan "
              f"{settings.compact_plan}, launches {ran}", flush=True)
        check(rel <= MEAN_RTOL, f"the {key} render's mean is off K1's")
        check(rmse <= IMAGE_RMSE,
              f"the {key} render is {rmse:.3e} RMSE off K1's")
        out[key] = launches
    return out


def _kernel_launches(renderer):
    """All device kernel launches of one render_sample call per sample it
    renders, counted by torch.profiler (cudaLaunchKernel calls)."""
    from torch.profiler import ProfilerActivity, profile

    from platinum_tpu_torch.render import integrator

    s = renderer.settings
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        integrator.render_sample(renderer.flat, s, 0,
                                 features=renderer._features)
        torch.cuda.synchronize()
    count = sum(ev.count for ev in prof.key_averages()
                if ev.key == "cudaLaunchKernel")
    check(count > 0, "torch.profiler saw no kernel launch")
    return count / max(1, s.spp_batch)


def phase_wave_modes(scene, cam, head, head_launches):
    """4h: the headline at 4 spp with fuse_shadow, spp_batch=2 and
    chunk_shade=65536 against 4c (`head`, rendered above)."""
    from platinum_tpu_torch.render import integrator
    from platinum_tpu_torch.render.types import RenderSettings

    def per_spp(renderer, launches, key):
        """Trace launches of one mode per sample, the probe's apart."""
        return (launches[key] - renderer.probe_launches[key]) / spp

    img0 = head.readback()
    spp = head.settings.spp
    base_all = _kernel_launches(head)
    base = {k: per_spp(head, head_launches, k) for k in ("closest", "any")}
    print(f"wave-shaping modes against 4c (4h): 4c launches "
          f"{base['closest']:.1f} closest and {base['any']:.1f} any-hit "
          f"trace kernels and {base_all:.0f} kernels of all kinds per spp "
          f"(the auto plan's probe apart), plan "
          f"{head.settings.compact_plan}", flush=True)
    out = {}
    for label, opt in (("fuse_shadow", dict(fuse_shadow=True)),
                       ("spp_batch=2", dict(spp_batch=2)),
                       ("chunk_shade=65536", dict(chunk_shade=65536))):
        renderer, launches, mean = _render_path(
            f"headline with {label}", scene, cam,
            RenderSettings(spp=spp, **opt, **HEADLINE))
        _only(f"the {label} headline", launches, ("closest", "any"))
        img = renderer.readback()
        rel = abs(mean / float(img0.mean()) - 1.0)
        diff = float(np.abs(img - img0).max())
        same_plan = renderer.settings.compact_plan == head.settings.compact_plan
        bars = ""
        if label != "spp_batch=2":
            # the same rays and the same numbers, summed in another order
            check(same_plan, f"{label} resolved another plan than 4c")
            bars = (f", within the JAX tests' Cornell bars: 1e-6 "
                    f"{np.allclose(img, img0, rtol=1e-6, atol=1e-6)}, 2e-4 "
                    f"{np.allclose(img, img0, rtol=2e-4, atol=2e-4)}")
        all_spp = _kernel_launches(renderer)
        got = {k: per_spp(renderer, launches, k) for k in ("closest", "any")}
        print(f"  {label}: mean {mean:.5f} against 4c's {img0.mean():.5f} "
              f"(rel {rel:.2e}), largest per-pixel difference {diff:.3e}"
              f"{bars}; per spp {got['closest']:.1f} closest and "
              f"{got['any']:.1f} any-hit trace launches (4c "
              f"{base['closest']:.1f} and {base['any']:.1f}) and "
              f"{all_spp:.0f} kernel launches of all kinds (4c "
              f"{base_all:.0f}); plan {renderer.settings.compact_plan}",
              flush=True)
        check(rel <= MEAN_RTOL, f"the {label} render's mean is off 4c's")
        if label == "fuse_shadow":
            # K2 only from resolve_pending: once per plan segment
            plan = integrator._compaction_plan(renderer.settings.num_pixels,
                                               renderer.settings)
            check(got["any"] <= len(plan),
                  f"fuse_shadow launched K2 {got['any']} times per spp, "
                  f"more than once per plan segment ({len(plan)})")
            check(got["closest"] <= base["closest"],
                  "fuse_shadow launched more closest waves than 4c")
        out[label] = launches
    return out


def _end_to_end(label, flat, settings, pairs=None):
    """One sample through the default tracers (the kernel) against the
    same sample through the packet tracer over the plain versions
    (trace_wide_reference) in the same mode; or, given `pairs` = (kernel
    tracer pair, plain tracer pair), through those as `tracers=`. Returns
    the kernel render's launch counts."""
    from platinum_tpu_torch.ops import packet_trace as pt
    from platinum_tpu_torch.render.flatten import analyze_features
    from platinum_tpu_torch.render.integrator import render_sample

    feats = analyze_features(flat)
    kernel = None
    if pairs is not None:
        kernel, plain = pairs
    else:
        inst_feat = (flat.instances.feat if flat.instances is not None
                     else None)
        plain = pt.make_packet_tracer(
            flat.wbvh_nodes, flat.wbvh_tris, flat.wbvh_meta, flat.wbvh_slot,
            trace_fn=pt.trace_wide_reference, inst_feat=inst_feat,
            worder=flat.wbvh_order if settings.oct_order else None,
            stream=flat.wbvh_stream, mt_precision=settings.mt_precision)
    _zero_launches()
    img_k = render_sample(flat, settings, 0, tracers=kernel,
                          features=feats).cpu().numpy()
    launches = _launches()
    ran = {k: v for k, v in launches.items() if v}
    img_p = render_sample(flat, settings, 0, tracers=plain,
                          features=feats).cpu().numpy()
    close = np.isclose(img_k, img_p, rtol=PIX_RTOL, atol=PIX_ATOL).all(-1)
    rel = abs(img_k.mean() / img_p.mean() - 1.0)
    print(f"{label}: {close.mean():.4%} of pixels within rtol={PIX_RTOL} "
          f"atol={PIX_ATOL} ({int((~close).sum())} outside), mean "
          f"{img_k.mean():.5f} vs {img_p.mean():.5f} (rel {rel:.2e}), "
          f"kernel launches {ran}", flush=True)
    check(bool(np.isfinite(img_k).all()), f"{label}: kernel render not finite")
    check(close.mean() >= AGREE, f"{label}: renders differ per pixel")
    check(rel <= MEAN_RTOL, f"{label}: render means differ")
    return launches


def phase_end_to_end(scene, cam, dev):
    from platinum_tpu_torch.ops import threefry
    from platinum_tpu_torch.render.flatten import flatten_scene
    from platinum_tpu_torch.render.types import RenderSettings

    small = dict(width=64, height=64, spp=1, max_bounces=8, kernel="mis",
                 sampler="halton", tracer="packet", instancing="off")
    settings = RenderSettings(**small)
    flat = flatten_scene(scene, cam, settings, device=dev)
    _end_to_end("end to end K1/K2 64x64x1", flat, settings)
    settings = RenderSettings(width=96, height=96, spp=1, max_bounces=8,
                              kernel="mis", sampler="halton",
                              tracer="packet", compact=True, instancing="on")
    _end_to_end("end to end K3 96x96x1, compacted",
                flatten_scene(scene, cam, settings, device=dev), settings)
    key = threefry.fold_in(threefry.fold_in(threefry.PRNGKey(0), 3), 1)
    gpu = threefry.uniform(key, N_WAVE, dev).cpu()
    cpu = threefry.uniform(key, N_WAVE, "cpu")
    check(torch.equal(gpu.view(torch.int32), cpu.view(torch.int32)),
          "threefry draws on the card differ from the CPU")
    print(f"threefry: {N_WAVE} uniforms on the card bitwise equal to the CPU",
          flush=True)
    # 5c: each new mode's kernel path against its plain path
    for label, opt in (("K4 high", dict(mt_precision="high")),
                       ("K5 two_phase", dict(mt_precision="two_phase")),
                       ("K7 oct_order", dict(oct_order=True))):
        settings = RenderSettings(**small, **opt)
        _end_to_end(f"end to end {label} 64x64x1", flat, settings)
    settings = RenderSettings(**dict(small, stream="on"))
    _end_to_end("end to end K6 stream='on' 64x64x1",
                flatten_scene(scene, cam, settings, device=dev), settings)
    # 5d: the pipelined walk and the ray-stream pair, as `tracers=`
    from platinum_tpu_torch.ops import packet_trace as pt
    from platinum_tpu_torch.ops import raystream as rs

    settings = RenderSettings(**small)
    tree = (flat.wbvh_nodes, flat.wbvh_tris, flat.wbvh_meta, flat.wbvh_slot)
    out = {}
    for key, opt in (("pipe", dict(pipe=True)),
                     ("flat_walk", dict(flat_walk=True))):
        out[key] = _end_to_end(
            f"end to end K9 {key} 64x64x1", flat, settings,
            (pt.make_packet_tracer(*tree, **opt),
             pt.make_packet_tracer(*tree, trace_fn=pt.trace_wide_reference,
                                   **opt)))
        prefix = "flat+" if key == "flat_walk" else "pipe+"
        _only(f"the {key} render", out[key],
              (prefix + "closest", prefix + "any"))
    out["raystream"] = _end_to_end(
        "end to end K15 ray-stream pair 64x64x1", flat, settings,
        (rs.make_stream_tracer(*tree),
         rs.make_stream_tracer(*tree, mt_fn=rs.stream_mt_plain)))
    _only("the ray-stream render", out["raystream"],
          ("stream_mt closest", "stream_mt any"))
    return out

# ---------------------------------------------------------------------------
# 6-6e: the user's render path, from a glTF file to a tonemapped PNG
# ---------------------------------------------------------------------------

COLONNADE_TRIS = 271_010
TRI_RTOL = 1e-6     # 6: world triangle corners, loaded against built
MEAN_Z = 4.0        # 6: |mean difference| within this many standard errors
TEX_ATOL = 1e-6     # 6b: texture samples on the card against the CPU
GMON_ATOL = 1e-6    # 6c: gmon_combine on the card against the CPU
POST_ATOL = 1e-5    # 6d: the post stack on the card against the CPU
SPHERES = dict(width=512, height=512, max_bounces=6, kernel="mis",
               sampler="halton", tracer="packet", compact=True,
               compact_plan="auto")


def _via_foreign_glb(scene, cam, path):
    """bench.py's _via_foreign_glb (bench.py:149-181) on the port: write the
    scene with tools/foreign_glb.py, read it back with io/gltf.py, carry
    the camera's physics and the environment over. Returns (scene, camera
    node, export s, load s)."""
    import copy

    from platinum_tpu_torch.core.scene import Scene
    from platinum_tpu_torch.io.gltf import load_gltf
    from platinum_tpu_torch.tools.foreign_glb import export_glb_foreign

    t0 = time.perf_counter()
    export_glb_foreign(scene, path)
    t1 = time.perf_counter()
    loaded = Scene()
    load_gltf(loaded, path)
    t2 = time.perf_counter()
    node_id = loaded.get_cameras()[0][0]
    loaded.node(node_id).camera = copy.copy(scene.node(cam).camera)
    loaded.environment = copy.copy(scene.environment)
    tid = scene.environment.texture_id
    if tid is not None:
        loaded.environment.texture_id = loaded.add_asset(scene.asset(tid),
                                                         retained=True)
    print(f"  {os.path.basename(path)}: {os.path.getsize(path) / 1e6:.3f} MB, "
          f"exported in {t1 - t0:.2f} s, loaded in {t2 - t1:.2f} s",
          flush=True)
    return loaded, node_id


def _world_triangles(scene):
    tris = []
    for inst in scene.get_instances():
        m = np.asarray(inst.transform, np.float32)
        p = inst.mesh.positions @ m[:3, :3].T + m[:3, 3]
        tris.append(p[inst.mesh.indices.astype(np.int64)])
    return np.concatenate(tris)


def phase_glb_headline(tmp, scene, cam, head_img):
    """6: sponza_class_512 as bench.py runs it, through the foreign GLB."""
    from platinum_tpu_torch.render.types import RenderSettings

    loaded, lcam = _via_foreign_glb(scene, cam,
                                    os.path.join(tmp, "sponza.glb"))
    a, b = _world_triangles(scene), _world_triangles(loaded)
    check(a.shape == b.shape == (COLONNADE_TRIS, 3, 3),
          f"the loaded colonnade has {b.shape[0]} triangles, not {a.shape[0]}")
    # the file holds each instance's transform as translation, quaternion
    # and scale: the world positions come back within a few ulps
    tri_err = float(np.abs(a - b).max())
    check(np.allclose(a, b, rtol=TRI_RTOL, atol=TRI_RTOL),
          f"the loaded triangles differ from the build by {tri_err}")
    renderer, launches, mean = _render_path(
        "sponza_class_512 through the foreign GLB (6)", loaded, lcam,
        RenderSettings(spp=4, **HEADLINE))
    _only("the GLB headline", launches, ("closest", "any"))
    # the GLB carries no tangents: the loader makes them with mikktspace
    # where the direct build has the primitives' own, so paths that sample
    # around a tangent fork; the means agree within their noise
    diff = (renderer.readback() - head_img).mean(-1).reshape(-1)
    se = float(diff.std() / np.sqrt(diff.size))
    z = float(diff.mean()) / max(se, 1e-30)
    rel = mean / float(head_img.mean()) - 1.0
    forked = float((np.abs(renderer.readback() - head_img).max(-1)
                    > 1e-4).mean())
    print(f"  world triangles within {tri_err:.3g} of the direct build's "
          f"(bar rtol = atol = {TRI_RTOL}); image mean {mean:.5f} "
          f"against 4c's {head_img.mean():.5f} (rel {rel:.2e}, "
          f"{z:+.2f} standard errors of the per-pixel difference; "
          f"{forked:.2%} of pixels differ by > 1e-4)", flush=True)
    check(abs(z) <= MEAN_Z, "the GLB headline's mean is off 4c's")
    return renderer.ms_per_spp


def phase_glb_spheres(tmp):
    """6b: metalrough_spheres (bench.py:254-264) through the foreign GLB,
    cut to 4 spp; the texture lookups on the camera wave's hits on the
    card against the same calls on the CPU."""
    from platinum_tpu_torch.app.scenes import make_spheres_scene
    from platinum_tpu_torch.ops import texturing as tx
    from platinum_tpu_torch.ops.hitdata import interpolate_hit
    from platinum_tpu_torch.render.integrator import init_path_state
    from platinum_tpu_torch.render.types import RenderSettings

    path = os.path.join(tmp, "spheres.glb")
    loaded, cam = _via_foreign_glb(*make_spheres_scene(), path)
    renderer, launches, _ = _render_path(
        "metalrough_spheres through the foreign GLB (6b)", loaded, cam,
        RenderSettings(spp=4, **SPHERES))
    _only("metalrough_spheres", launches, ("closest", "any"))
    flat, s = renderer.flat, renderer.settings
    check(flat.atlas is not None, "the loaded spheres have no atlas")
    st = init_path_state(flat, s, 0)
    rec = renderer._tracers[0](st["o"], st["d"], 1e-3, float("inf"))
    hd = interpolate_hit(flat.geometry, rec, st["o"], st["d"],
                         instances=flat.instances)
    uv, rows = hd.uv[rec.hit], flat.materials.textures[hd.mat_idx[rec.hit]
                                                       .long()]
    args = (flat.atlas, flat.atlas_table, rows, uv)
    cpu = [a.cpu() for a in args]
    card = tx.sample_material_textures(*args)
    host = tx.sample_material_textures(*cpu)
    errs = {f: float((getattr(card, f).cpu().float()
                      - getattr(host, f).float()).abs().max())
            for f in card.__dataclass_fields__}
    has_nm, nm = tx.sample_normal_map(*args)
    has_nm_h, nm_h = tx.sample_normal_map(*cpu)
    errs["normal_map"] = float((nm.cpu() - nm_h).abs().max())
    check(torch.equal(has_nm.cpu(), has_nm_h), "normal-map slots differ")
    worst = max(errs.values())
    print(f"  camera wave: {int(rec.hit.sum())} hits, "
          f"{int(has_nm.sum())} normal-mapped; sample_material_textures and "
          f"sample_normal_map on the card against the CPU: largest "
          f"difference {worst:.3g} (bar {TEX_ATOL})", flush=True)
    check(int(has_nm.sum()) > 0, "no camera hit samples the normal map")
    check(worst <= TEX_ATOL, f"texture samples differ: {errs}")
    return path, renderer.ms_per_spp


def phase_gmon():
    """6c: metalrough_spheres_gmon (bench.py:266-292), 8 buckets, cut to
    16 spp (2 a bucket); gmon_combine on the card against the CPU."""
    from platinum_tpu_torch.app.scenes import make_spheres_scene
    from platinum_tpu_torch.ops.gmon import gmon_combine, gmon_window
    from platinum_tpu_torch.render.types import FLAG_GMON, RenderSettings

    settings = RenderSettings(spp=16, flags=1 | FLAG_GMON, gmon_buckets=8,
                              **SPHERES)
    renderer, launches, _ = _render_path(
        "metalrough_spheres_gmon (6c)", *make_spheres_scene(), settings)
    ran = {k for k, v in launches.items() if v}
    check(ran and ran <= {"closest", "any", "inst_closest", "inst_any"},
          f"the GMoN render launched {sorted(ran)}")
    buckets = torch.stack(renderer._buckets)
    cap = renderer.settings.gmon_cap or 1.0
    card = renderer._combined().cpu()
    host = gmon_combine(buckets.cpu(), 8, cap)
    err = float((card - host).abs().max())
    (oc, wc), (oh, wh) = (gmon_window(b, 8, cap)
                          for b in (buckets, buckets.cpu()))
    chosen_c = torch.sort(torch.where(wc, oc, -1), dim=0).values.cpu()
    chosen_h = torch.sort(torch.where(wh, oh, -1), dim=0).values
    same = bool(torch.equal(chosen_c, chosen_h))
    trimmed = float((wh.sum(0) < 8).float().mean())
    print(f"  gmon_combine of the card's 8 buckets against the CPU: largest "
          f"difference {err:.3g} (bar {GMON_ATOL}), chosen buckets equal "
          f"{same}; {trimmed:.2%} of pixels trimmed", flush=True)
    check(same, "the GMoN window chose other buckets on the card")
    check(err <= GMON_ATOL, "gmon_combine differs on the card")
    return renderer.ms_per_spp


def phase_studio_post(tmp):
    """6d: studio_loop (bench.py:310-346): the colonnade at 960x540,
    accumulated 2 spp, then the post stack on the card against the CPU for
    three tonemappers and the PNG export read back; the preview ladder's
    cadence (bench.py's _edit_loop_cadence) on the way."""
    from platinum_tpu_torch.app.scenes import make_colonnade_scene
    from platinum_tpu_torch.io import png
    from platinum_tpu_torch.io.icc import profile_for
    from platinum_tpu_torch.post.options import (PostProcessOptions,
                                                 TonemapOptions)
    from platinum_tpu_torch.post.pipeline import postprocess_image
    from platinum_tpu_torch.render.renderer import Renderer
    from platinum_tpu_torch.render.types import RenderSettings

    scene, cam = make_colonnade_scene()
    settings = RenderSettings(width=960, height=540, spp=8, max_bounces=6,
                              kernel="mis", sampler="halton",
                              tracer="packet", compact=True)
    r = Renderer(scene)
    _zero_launches()
    r.start_render(cam, settings, preview_scale=4, preview_spp=4)
    frames = []
    for _ in range(4):
        t0 = time.perf_counter()
        r.render()
        r.readback()
        frames.append((time.perf_counter() - t0) * 1e3)
    steps = []
    for _ in range(2):
        t0 = time.perf_counter()
        r.render()
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)
    launches = {k: v for k, v in _launches().items() if v}
    check(r.completed_spp == 2, f"{r.completed_spp} spp accumulated")
    img = r._combined().reshape(settings.height, settings.width, 3)
    errs = {}
    for tm in ("agx", "khronos_pbr", "flim"):
        opt = PostProcessOptions(tonemap=TonemapOptions(tonemapper=tm))
        t0 = time.perf_counter()
        card = postprocess_image(img, opt, settings.working_space,
                                 settings.output_space)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        host = postprocess_image(img.cpu(), opt, settings.working_space,
                                 settings.output_space)
        errs[tm] = (float((card.cpu() - host).abs().max()), ms)
    path = os.path.join(tmp, "studio.png")
    t0 = time.perf_counter()
    r.export_png(path)
    t_png = time.perf_counter() - t0
    with open(path, "rb") as f:
        data = f.read()
    back = png.decode_png(data)
    print(f"studio_loop (6d): {settings.width}x{settings.height}, preview "
          f"frames at 1/4 the size "
          f"{[round(t, 1) for t in frames]} ms (median "
          f"{sorted(frames)[len(frames) // 2]:.1f} ms: "
          f"interact_ms_per_frame), 2 spp at "
          f"{[round(t, 1) for t in steps]} ms; post on the card against "
          f"the CPU, largest difference (card ms): "
          f"{ {k: (f'{e:.3g}', round(m, 2)) for k, (e, m) in errs.items()} } "
          f"(bar {POST_ATOL}); export_png {t_png * 1e3:.1f} ms, "
          f"{len(data)} bytes; launches {launches}", flush=True)
    check(all(e <= POST_ATOL for e, _ in errs.values()),
          f"the post stack differs on the card: {errs}")
    check(back.shape == (settings.height, settings.width, 4),
          f"the PNG reads back as {back.shape}")
    check(png.icc_profile(data) == profile_for("sRGB"),
          "the PNG's iCCP profile is not profile_for('sRGB')")
    return float(np.mean(steps))


def phase_cli(tmp, glb):
    """6e: the README's quick start, through the port's CLI in-process."""
    from platinum_tpu_torch.app import cli
    from platinum_tpu_torch.io.png import read_png

    out = os.path.join(tmp, "cli.png")
    _zero_launches()
    t0 = time.perf_counter()
    cli.main(["render", glb, "--spp", "4", "--size", "512x512", "--gmon",
              "4", "-o", out])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: v for k, v in _launches().items() if v}
    img = read_png(out)
    # a .glb carries no environment, and the spheres scene's only light is
    # its environment: the CLI's image of the file alone is black
    print(f"cli (6e): render {os.path.basename(glb)} --spp 4 --size 512x512 "
          f"--gmon 4 (50 bounces, no compaction): {dt:.2f} s with the load, "
          f"{img.shape[1]}x{img.shape[0]} PNG, mean {img[..., :3].mean():.2f}"
          f" (no light in the file); launches {launches}", flush=True)
    check(img.shape == (512, 512, 4), f"the CLI's PNG is {img.shape}")
    # no light: no shadow ray, so K2 has nothing to trace
    check("closest" in launches and set(launches) <= {"closest", "any"},
          f"the CLI render launched {sorted(launches)}")
    return dt


# ---------------------------------------------------------------------------
# 7-7e: alpha cutout, the Z-sampler, the scene formats and the studio
# ---------------------------------------------------------------------------

STUDIO_ATOL = 1e-5  # 7e: studio colours, kernel against plain, same stencil
CHECKER = 32        # texels a side of the golden's checker


def _checker_texture():
    """tests/test_golden.py:88-94's checker: opaque white, every other 4x4
    square cut out (alpha 0)."""
    from platinum_tpu_torch.core.texture import Texture, TextureFormat

    rgba = np.full((CHECKER, CHECKER, 4), 255, np.uint8)
    yy, xx = np.mgrid[0:CHECKER, 0:CHECKER]
    rgba[(yy // 4 + xx // 4) % 2 == 0, 3] = 0
    return Texture(data=rgba, format=TextureFormat.SRGB_RGBA, name="checker",
                   has_alpha=True)


def _checker_columns():
    """The colonnade with the checker bound to the base colour of its
    `column` material: the columns become cutouts."""
    from platinum_tpu_torch.app.scenes import make_colonnade_scene
    from platinum_tpu_torch.core.material import Material, TextureSlot

    scene, cam = make_colonnade_scene()
    tex_id = scene.add_asset(_checker_texture(), retained=True)
    cols = [d for _, d, *_ in scene.all_assets()
            if isinstance(d, Material) and d.name == "column"]
    check(len(cols) == 1, f"{len(cols)} column materials")
    cols[0].textures[TextureSlot.BASE_COLOR] = tex_id
    return scene, cam


def phase_alpha(dev):
    """7: sponza_class_512's settings on the colonnade with cutout columns,
    cut to 4 spp; then its kernel path against the plain tracer pair at
    64x64 x 1 spp."""
    from platinum_tpu_torch.render.flatten import flatten_scene
    from platinum_tpu_torch.render.types import RenderSettings

    scene, cam = _checker_columns()
    settings = RenderSettings(spp=4, **HEADLINE)
    renderer, launches, mean = _render_path(
        "sponza_class_512 with cutout columns (7)", scene, cam, settings)
    check("alpha" in renderer._features, "the columns are not alpha-tested")
    _only("the alpha headline", launches, ("closest",))
    check(launches["any"] == 0, "K2 launched under alpha")
    k1_spp = (launches["closest"]
              - renderer.probe_launches["closest"]) / settings.spp
    print(f"  K1 launches per spp under alpha {k1_spp:.1f} (the auto plan's "
          f"probe {renderer.probe_launches['closest']} more), "
          f"{renderer.ms_per_spp:.1f} ms/spp", flush=True)
    small = RenderSettings(width=64, height=64, spp=1, max_bounces=8,
                           kernel="mis", sampler="halton", tracer="packet",
                           instancing="off")
    _alpha_end_to_end(flatten_scene(scene, cam, small, device=dev), small)
    return renderer.ms_per_spp, k1_spp


def _alpha_end_to_end(flat, settings):
    """7: one sample through the kernel pair against the plain pair, as 5
    holds it, with one change. The column bases are coplanar with the
    floor, and under alpha a ray that passes a cut-out column meets both
    at one t: the two tracers break that exact tie apart (the kernel by
    its walk, the plain version by block order), the cap's alpha draw or
    the floor's opacity follows, and the path forks. So the image means
    are printed beside MEAN_RTOL, not held; instead every closest-hit call
    of the kernel path is traced again by the plain pair on the same
    inputs, and each ray they disagree on must be an exact-t tie (ids
    apart) or certified borderline in float64, as 3 holds whole waves."""
    from platinum_tpu_torch.ops import packet_trace as pt
    from platinum_tpu_torch.render.flatten import analyze_features
    from platinum_tpu_torch.render.integrator import (make_tracers,
                                                      render_sample)

    feats = analyze_features(flat)
    kernel = make_tracers(flat, settings)
    plain = pt.make_packet_tracer(
        flat.wbvh_nodes, flat.wbvh_tris, flat.wbvh_meta, flat.wbvh_slot,
        trace_fn=pt.trace_wide_reference)
    _zero_launches()
    img_k = render_sample(flat, settings, 0, tracers=kernel,
                          features=feats).cpu().numpy()
    launches = {k: v for k, v in _launches().items() if v}
    _only("the alpha end to end", launches, ("closest",))
    img_p = render_sample(flat, settings, 0, tracers=plain,
                          features=feats).cpu().numpy()
    close = np.isclose(img_k, img_p, rtol=PIX_RTOL, atol=PIX_ATOL).all(-1)
    rel = abs(img_k.mean() / img_p.mean() - 1.0)

    g = flat.geometry
    pos = g.positions.double().cpu().numpy()
    idx = g.indices.cpu().numpy()
    v0 = pos[idx[:, 0]]
    tri64 = np.concatenate([v0, pos[idx[:, 1]] - v0, pos[idx[:, 2]] - v0], 1)
    stats = dict(calls=0, rays=0, ties=0, borderline=0, uncertified=[])

    def checked(o, d, tmin, tmax, active=None):
        rk = kernel[0](o, d, tmin, tmax, active=active)
        rp = plain[0](o, d, tmin, tmax, active=active)
        act = active if active is not None else torch.ones_like(rk.hit)
        hk, hp = rk.hit & act, rp.hit & act
        tie = torch.isclose(rk.t, rp.t, rtol=TIE_RTOL, atol=TIE_ATOL)
        apart = hk & hp & (rk.tri != rp.tri)
        stats["calls"] += 1
        stats["rays"] += int(act.sum())
        stats["ties"] += int((apart & tie).sum())
        bad = torch.nonzero((hk != hp) | (apart & ~tie)).squeeze(1)
        if len(bad):
            host = torch.stack([*o.T, *d.T, torch.full_like(o[:, 0], tmin),
                                torch.broadcast_to(torch.as_tensor(
                                    tmax, device=o.device), o[:, 0].shape)])
            host = host.double().cpu().numpy()
            for i in bad.cpu().numpy():
                if _borderline(host[:, i], tri64):
                    stats["borderline"] += 1
                else:
                    stats["uncertified"].append(int(i))
        return rk

    render_sample(flat, settings, 0, tracers=(checked, kernel[1]),
                  features=feats)
    print(f"end to end alpha K1 {settings.width}x{settings.height}x1: "
          f"{close.mean():.4%} of pixels within rtol={PIX_RTOL} "
          f"atol={PIX_ATOL} ({int((~close).sum())} outside), mean "
          f"{img_k.mean():.5f} vs {img_p.mean():.5f} (rel {rel:.2e}, "
          f"MEAN_RTOL {MEAN_RTOL} printed, not held), kernel launches "
          f"{launches}; the kernel path's {stats['calls']} closest-hit calls "
          f"({stats['rays']} rays) traced again by the plain pair: "
          f"{stats['ties']} exact-t ties with the ids apart, "
          f"{stats['borderline']} borderline, "
          f"{len(stats['uncertified'])} uncertified", flush=True)
    check(bool(np.isfinite(img_k).all()), "7: kernel render not finite")
    check(close.mean() >= AGREE, "7: renders differ per pixel")
    check(not stats["uncertified"],
          f"7: rays {stats['uncertified'][:8]} disagree without a tie or a "
          f"borderline triangle")


def phase_zsampler(scene, cam, dev):
    """7c: ZStream's draws on the card bitwise the CPU's over a 512x512
    wave; the headline at 2 spp with sampler="z"."""
    from platinum_tpu_torch.ops.zsampler import ZStream
    from platinum_tpu_torch.render.types import RenderSettings

    n = 512
    draws = []
    for where in (dev, "cpu"):
        pix = torch.arange(n * n, device=where)
        st = ZStream.create(pix % n, pix // n, 1, n, n, 2)
        out = [st.z]
        for _ in range(4):
            st, u = st.next_2d()
            out.append(u.view(torch.int32))
            st, u = st.next_1d()
            out.append(u.view(torch.int32))
        draws.append([o.cpu() for o in out])
    same = all(torch.equal(a, b) for a, b in zip(*draws))
    print(f"Z-sampler (7c): {n * n} lanes, the index and 8 dimensions on the "
          f"card bitwise the CPU's: {same}", flush=True)
    check(same, "ZStream draws on the card differ from the CPU")
    settings = RenderSettings(spp=2, **dict(HEADLINE, sampler="z"))
    renderer, launches, _ = _render_path("sponza_class_512 with sampler='z' "
                                         "(7c)", scene, cam, settings)
    _only("the Z-sampler headline", launches, ("closest", "any"))
    return renderer.ms_per_spp


def _flat_leaves(a, b, path="flat"):
    """(name, a leaf, b leaf) over two FlatScenes' tensors, recursively."""
    import dataclasses

    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(x):
            yield from _flat_leaves(x, y, f"{path}.{f.name}")
        elif isinstance(x, torch.Tensor):
            yield f"{path}.{f.name}", x, y
        else:
            check(x == y, f"{path}.{f.name}: {x!r} != {y!r}")


def phase_ptscene(tmp, scene, cam, dev):
    """7d: the colonnade saved by Store.save_as and opened again: the
    flattened arrays and a 1-spp image bit for bit the original's."""
    from platinum_tpu_torch.app.store import Store
    from platinum_tpu_torch.render.flatten import (analyze_features,
                                                   flatten_scene)
    from platinum_tpu_torch.render.integrator import render_sample
    from platinum_tpu_torch.render.types import RenderSettings

    path = os.path.join(tmp, "colonnade.ptscene")
    t0 = time.perf_counter()
    Store(scene).save_as(path)
    t_save = time.perf_counter() - t0
    store = Store()
    t0 = time.perf_counter()
    store.open(path)
    t_open = time.perf_counter() - t0
    loaded = store.scene
    check([c[0] for c in loaded.get_cameras()] == [cam],
          "the loaded scene's camera node")
    settings = RenderSettings(width=512, height=512, spp=1, max_bounces=8,
                              kernel="mis", sampler="halton",
                              tracer="packet", instancing="off")
    a = flatten_scene(scene, cam, settings, device=dev)
    b = flatten_scene(loaded, cam, settings, device=dev)
    n = 0
    for name, x, y in _flat_leaves(a, b):
        # bit for bit: some float tables carry integer bits (NaN patterns)
        check(x.dtype == y.dtype and x.shape == y.shape and torch.equal(
            x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8)),
            f"7d: {name} differs after the .ptscene round trip")
        n += 1
    _zero_launches()
    img = render_sample(a, settings, 0, features=analyze_features(a))
    launches = {k: v for k, v in _launches().items() if v}
    img_b = render_sample(b, settings, 0, features=analyze_features(b))
    same = torch.equal(img, img_b)
    sizes = sum(os.path.getsize(os.path.join(tmp, f)) for f in
                ("colonnade.ptscene", "colonnade_data.bin"))
    print(f".ptscene (7d): {sizes} bytes, save {t_save:.2f} s, open "
          f"{t_open:.2f} s; {n} flattened tensors bit for bit; the 512x512 "
          f"x 1 spp image bit for bit: {same}; launches {launches}",
          flush=True)
    check(same, "7d: the reloaded scene renders differently")
    _only("the .ptscene render", launches, ("closest", "any"))
    return path


def phase_studio(tmp, scene, cam, dev, ptscene):
    """7e: StudioRenderer at 960x540 on the colonnade (K1 only), its ids
    and colours against the plain tracer pair, a pick, the CLI's preview
    of the .ptscene and a short interactive session in the process."""
    import contextlib
    import io

    from platinum_tpu_torch.app import cli
    from platinum_tpu_torch.io.png import read_png
    from platinum_tpu_torch.ops import packet_trace as pt
    from platinum_tpu_torch.render.studio import StudioRenderer, _studio_pass

    studio = StudioRenderer(scene, width=960, height=540)
    m = scene.world_transform(cam)
    studio.camera_to(m[:3, 3], m[:3, 3] - m[:3, 2] * 10.0)
    t0 = time.perf_counter()
    studio.render()
    t_first = time.perf_counter() - t0
    ids0 = studio._ids
    vals, counts = torch.unique(ids0[ids0 >= 0], return_counts=True)
    sel = int(vals[torch.argmax(counts)])
    _zero_launches()
    frames = []
    for _ in range(5):
        t0 = time.perf_counter()
        studio.render(selected_node=sel)
        frames.append((time.perf_counter() - t0) * 1e3)
    launches = {k: v for k, v in _launches().items() if v}
    flat = studio._flat
    # the studio's settings keep instancing="auto", as the JAX studio's do:
    # the colonnade's reused meshes flatten instanced, and K3 traces them
    mode = "inst_closest" if flat.instances is not None else "closest"
    _only("the studio", launches, (mode,))
    plain = pt.make_packet_tracer(
        flat.wbvh_nodes, flat.wbvh_tris, flat.wbvh_meta, flat.wbvh_slot,
        trace_fn=pt.trace_wide_reference,
        inst_feat=flat.instances.feat if flat.instances is not None else None)
    col_k, ids_k = _studio_pass(flat, studio.settings, sel, studio._gizmos,
                                studio._tracers)
    col_p, ids_p = _studio_pass(flat, studio.settings, sel, studio._gizmos,
                                plain)
    differ = ids_k != ids_p
    stencil = differ.clone()
    for sh in ((0, 1), (0, -1), (1, 0), (-1, 0)):
        stencil |= torch.roll(differ, sh, dims=(0, 1))
    err = float((col_k - col_p).abs().amax(-1)[~stencil].max())
    agree = 1.0 - float(differ.float().mean())
    w, h = studio.settings.width, studio.settings.height
    # pick the middle pixel of the selected node's
    at = torch.nonzero((ids_k == sel).reshape(-1)).squeeze(1)
    y, x = divmod(int(at[len(at) // 2]), w)
    picked = studio.readback_object_id_at(x, y)
    print(f"studio (7e): {w}x{h}, the first frame {t_first * 1e3:.1f} ms "
          f"(flatten, tracer pair), then "
          f"{[round(f, 1) for f in frames]} ms (median "
          f"{sorted(frames)[2]:.1f} ms a frame), launches {launches}; ids "
          f"against the plain tracer pair: {agree:.4%} equal, colours off by "
          f"{err:.3g} outside their stencil (bar {STUDIO_ATOL}); "
          f"pick ({x},{y}) -> {picked}, selected {sel}", flush=True)
    check(agree >= AGREE, "7e: studio ids differ from the plain pair's")
    check(err <= STUDIO_ATOL, "7e: studio colours differ")
    check(picked == int(ids_k[y, x]) == sel,
          "7e: the pick is not the id AOV's")

    out = os.path.join(tmp, "preview.png")
    buf = io.StringIO()
    _zero_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(["preview", ptscene, "--size", f"{w}x{h}", "--pick",
                  f"{x},{y}", "-o", out])
    t_cli = time.perf_counter() - t0
    lines = buf.getvalue().split("\n")
    check(lines[0] == f"node at ({x},{y}): {sel}", f"7e: {lines[0]!r}")
    check(read_png(out).shape == (h, w, 4), "7e: the preview PNG")
    cli_launches = {k: v for k, v in _launches().items() if v}
    script = "\n".join([f"pick {x // 2} {y // 2}", "orbit 0.3 0.1",
                        "zoom 1", f"select {sel}", "frame", "render 2",
                        f"save {os.path.join(tmp, 'kept.png')}", "quit"])
    buf = io.StringIO()
    stdin = sys.stdin
    sys.stdin = io.StringIO(script + "\n")
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            cli.main(["preview", ptscene, "--interactive", "--size",
                      f"{w // 2}x{h // 2}", "-o",
                      os.path.join(tmp, "session.png")])
    finally:
        sys.stdin = stdin
    t_session = time.perf_counter() - t0
    said = buf.getvalue()
    print(f"  cli preview {os.path.basename(ptscene)} --size {w}x{h} "
          f"--pick: {lines[0]!r}, {t_cli:.2f} s with the load, launches "
          f"{cli_launches}; preview --interactive ({w // 2}x{h // 2}: pick, "
          f"orbit, zoom, select, frame, render 2, save, quit) "
          f"{t_session:.2f} s: "
          f"{said.count('frame ')} frames, "
          f"{[ln for ln in said.splitlines() if ln.startswith('rendered')]}",
          flush=True)
    for word in ("ready", "picked", "preview frame 4", "rendered 2 spp",
                 "saved", "bye"):
        check(word in said, f"7e: the session did not say {word!r}")
    check("error:" not in said, "7e: the session reported an error")
    return sorted(frames)[2], t_cli, t_session


PART_AGREE = 0.999     # 8, 8b: ids equal on at least this share of a wave
GEOM_ATOL = 1e-5       # 8c, 8d: image bar (tests/test_multichip.py:47)
# 8b: a test scaffold. The instanced colonnade's one structure (~1.9 MB)
# fits the default budget; at this budget partition_instanced splits it
INST_PART_BYTES = 1_600_000


def _t64(ray, tri):
    """(t, smallest barycentric) of the ray against one (9,) float64
    triangle (v0, e1, e2), Moller-Trumbore in float64; None where the
    determinant is 0."""
    o, d = ray[0:3], ray[3:6]
    v0, e1, e2 = tri[0:3], tri[3:6], tri[6:9]
    pv = np.cross(d, e2)
    det = float(e1 @ pv)
    if det == 0.0:
        return None
    sv = o - v0
    qv = np.cross(sv, e1)
    u, v = float(sv @ pv) / det, float(d @ qv) / det
    return float(e2 @ qv) / det, min(u, v, 1.0 - u - v)


def _exact_tie64(pair, eps=5e-4):
    """True when, in float64, the ray meets both triangles of `pair`
    ([(ray in the triangle's frame, (9,) triangle)] x 2) inside their
    edges (to eps) at t equal within TIE_RTOL / TIE_ATOL: an exact-t tie,
    which either tracer may break its own way."""
    hits = [_t64(ray, tri) for ray, tri in pair]
    if any(h is None or h[1] < -eps for h in hits):
        return False
    (ta, _), (tb, _) = hits
    return abs(ta - tb) <= TIE_ATOL + TIE_RTOL * abs(tb)


def _ids_against(label, got, ref, o, d, tmin, tmax, frame, certify):
    """`got`'s hits against `ref`'s on one wave: ids (the triangle, and
    the instance where there is one) equal on >= PART_AGREE of the rays,
    t bit for bit where they are (the same per-triangle arithmetic);
    every other ray certified in float64, as 7 holds its rays: an exact-t
    tie (both hit, t within TIE_RTOL / TIE_ATOL, and `_exact_tie64` on
    the two triangles) or borderline (`certify(ray)`).
    frame(ray, tri, inst) -> (the ray in that triangle's frame, (9,)
    float64 triangle)."""
    inst = got.inst is not None
    ids_eq = got.tri == ref.tri
    if inst:
        ids_eq = ids_eq & (got.inst == ref.inst)
    same = (got.hit == ref.hit) & (~ref.hit | ids_eq)
    close = (got.hit & ref.hit & ~ids_eq
             & torch.isclose(got.t, ref.t, rtol=TIE_RTOL, atol=TIE_ATOL))
    bad = torch.nonzero(~same).squeeze(1)
    ties = border = 0
    if len(bad):
        r = o.shape[0]
        host = torch.stack([*o.T, *d.T,
                            torch.full((r,), tmin, device=o.device),
                            torch.broadcast_to(torch.as_tensor(
                                tmax, device=o.device), (r,))])
        host = host.double().cpu().numpy()
        cols = [close, got.tri, ref.tri]
        if inst:
            cols += [got.inst, ref.inst]
        cols = [c[bad].cpu().numpy() for c in cols]
        for j, i in enumerate(bad.cpu().numpy()):
            ray = host[:, i]
            ia, ib = (cols[3][j], cols[4][j]) if inst else (None, None)
            if cols[0][j] and _exact_tie64([frame(ray, cols[1][j], ia),
                                            frame(ray, cols[2][j], ib)]):
                ties += 1
            elif certify(ray):
                border += 1
    share = same.float().mean().item()
    t_bits = bool(torch.equal(got.t[same & ref.hit], ref.t[same & ref.hit]))
    print(f"  {label}: ids equal on {share:.5%} of {o.shape[0]} rays, "
          f"t bit for bit where they are: {t_bits}; of the "
          f"{len(bad)} others {ties} exact-t ties certified in float64, "
          f"{border} borderline, {len(bad) - ties - border} uncertified",
          flush=True)
    check(share >= PART_AGREE, f"{label}: ids equal on {share:.5%}")
    check(t_bits, f"{label}: t differs where the ids agree")
    check(ties + border == len(bad), f"{label}: "
          f"{len(bad) - ties - border} rays disagree without a tie or a "
          f"borderline triangle")


def _tri64(flat):
    g = flat.geometry
    pos = g.positions.double().cpu().numpy()
    idx = g.indices.cpu().numpy()
    v0 = pos[idx[:, 0]]
    return np.concatenate([v0, pos[idx[:, 1]] - v0, pos[idx[:, 2]] - v0], 1)


def _mean_z(a, b):
    """(relative mean difference, z) of two images: the mean per-pixel
    difference in standard errors, as 6 holds its means."""
    diff = (a - b).mean(-1).reshape(-1)
    se = float(diff.std() / np.sqrt(diff.size))
    return (float(a.mean() / b.mean() - 1.0),
            float(diff.mean()) / max(se, 1e-30))


def phase_partitioned(dev, streamed):
    """8: bistro_class_studio with stream="off": the partitioned path,
    held to 4e's streamed single structure (`streamed`, 4e's renderer)."""
    from platinum_tpu_torch.app.scenes import make_colonnade_scene
    from platinum_tpu_torch.render import integrator
    from platinum_tpu_torch.render.integrator import RAY_EPS
    from platinum_tpu_torch.render.types import RenderSettings

    scene, cam = make_colonnade_scene(**BISTRO)
    settings = RenderSettings(width=960, height=540, spp=2, max_bounces=4,
                              kernel="mis", sampler="halton",
                              tracer="packet", compact=True,
                              instancing="off", stream="off")
    renderer, launches, mean = _render_path(
        "bistro_class_studio partitioned (8)", scene, cam, settings)
    flat = renderer.flat
    n_parts = len(flat.wbvh_parts or ())
    check(n_parts >= 2, f"the bistro flattened into {n_parts} partitions")
    _only("the partitioned bistro", launches, ("closest", "any"))
    per_spp = {k: launches[k] / settings.spp for k in ("closest", "any")}
    blocks = [int(p[1].shape[0]) for p in flat.wbvh_parts]
    print(f"  {n_parts} partitions of {blocks} MT blocks; K1 "
          f"{per_spp['closest']:.1f} + K2 {per_spp['any']:.1f} launches "
          f"per spp ({per_spp['closest'] / n_parts:.1f} + "
          f"{per_spp['any'] / n_parts:.1f} per partition); "
          f"{renderer.ms_per_spp:.1f} ms/spp against 4e's streamed (K6) "
          f"{streamed.ms_per_spp:.1f}", flush=True)

    pts = _wave_points(flat, dev, settings.width, settings.height)
    tri64 = _tri64(flat)

    def frame(ray, tri, _inst):
        return ray, tri64[tri]

    def certify(ray):
        return _borderline(ray, tri64)

    seq_c, seq_a = renderer._tracers
    str_c, str_a = streamed._tracers
    for label, o, d in (("camera wave", pts["cam_o"], pts["cam_d"]),
                        ("bounce wave", pts["p"], pts["d"])):
        _ids_against(f"8 {label}, partitioned against streamed",
                     seq_c(o, d, RAY_EPS, float("inf")),
                     str_c(o, d, RAY_EPS, float("inf")),
                     o, d, RAY_EPS, float("inf"), frame, certify)
    tmax = pts["dist"] - RAY_EPS
    occ_p = seq_a(pts["p"], pts["seg"], RAY_EPS, tmax)
    occ_s = str_a(pts["p"], pts["seg"], RAY_EPS, tmax)
    occ_agree = (occ_p == occ_s).float().mean().item()
    print(f"  8 shadow wave: occlusion equal on {occ_agree:.5%}", flush=True)
    check(occ_agree >= PART_AGREE, "8: occlusion differs from streamed")

    feats = renderer._features
    zero = torch.zeros((settings.num_pixels, 3), device=dev)
    img_s = integrator.render_step_n(
        streamed.flat, renderer.settings, zero, 0, settings.spp,
        features=feats, tracers=streamed._tracers).cpu().numpy()
    img_p = renderer.readback().reshape(-1, 3)
    rel, z = _mean_z(img_p, img_s)
    print(f"  image mean {img_p.mean():.6f} against the streamed structure's "
          f"{img_s.mean():.6f} at the same {settings.spp} spp (rel {rel:.2e}, "
          f"bar {MEAN_RTOL}; {z:+.2f} standard errors, bar {MEAN_Z}; largest "
          f"pixel difference {np.abs(img_p - img_s).max():.3g})", flush=True)
    check(abs(rel) <= MEAN_RTOL and abs(z) <= MEAN_Z,
          "8: the partitioned image's mean is off the streamed one's")
    return dict(renderer=renderer, pts=pts, launches=launches,
                n_parts=n_parts)


def phase_partitioned_instanced(dev):
    """8b: sponza_instanced_512 with its instanced structure split into
    partitions; a transform edit; ids against one structure."""
    import dataclasses

    from platinum_tpu_torch.app.scenes import make_colonnade_scene
    from platinum_tpu_torch.core.transform import Transform
    from platinum_tpu_torch.render.flatten import flatten_scene
    from platinum_tpu_torch.render.integrator import RAY_EPS, make_tracers
    from platinum_tpu_torch.render.types import RenderSettings

    scene, cam = make_colonnade_scene()
    settings = RenderSettings(width=512, height=512, spp=2, max_bounces=8,
                              kernel="mis", sampler="halton",
                              tracer="packet", compact=True, instancing="on",
                              stream="off", partition_bytes=INST_PART_BYTES)
    renderer, launches, _ = _render_path(
        "sponza_instanced_512 partitioned (8b)", scene, cam, settings)
    n_parts = len(renderer.flat.wbvh_parts or ())
    check(n_parts >= 2, f"8b: {n_parts} partitions")
    _only("the partitioned instanced colonnade", launches,
          ("inst_closest", "inst_any"))
    node = next(scene.node(i.node_id) for i in scene.get_instances()
                if scene.node(i.node_id).name == MOVED_NODE)
    old = node.transform
    t0 = time.perf_counter()
    renderer.update_instance_transform(node.id, Transform(
        translation=np.asarray(old.translation) + [1.0, 0, 0.5],
        rotation=old.rotation, scale=old.scale))
    t_edit = time.perf_counter() - t0
    renderer.render()
    img = renderer.readback()
    check(bool(np.isfinite(img).all()) and img.mean() > 0,
          "8b: render after the transform edit")
    one = dataclasses.replace(settings, stream="auto",
                              partition_bytes=RenderSettings.partition_bytes)
    host = {}
    fresh = flatten_scene(scene, cam, one, device=dev, host_accel_out=host)
    check(fresh.wbvh_parts is None, "8b: the reference is not one structure")
    print(f"  {n_parts} partitions (partition_bytes {INST_PART_BYTES}), K3 "
          f"{launches['inst_closest'] / settings.spp:.1f} + "
          f"{launches['inst_any'] / settings.spp:.1f} launches per spp, "
          f"{renderer.ms_per_spp:.1f} ms/spp; transform edit (one partition "
          f"refit) {t_edit * 1e3:.1f} ms", flush=True)
    lib64 = fresh.geometry.tri_geo[:, 0:9].double().cpu().numpy()
    to_object = []
    for inst in host["instances"]:
        m = np.asarray(inst.transform, np.float64)
        to_object.append((np.linalg.inv(m[:3, :3]), m[:3, 3]))

    def frame(ray, tri, inst):
        b, tr = to_object[inst]
        obj = ray.copy()
        obj[0:3] = b @ (ray[0:3] - tr)
        obj[3:6] = b @ ray[3:6]
        return obj, lib64[tri]

    pts = _wave_points(fresh, dev)
    o, d = pts["p"], pts["d"]
    _ids_against("8b bounce wave, partitioned after the edit against the "
                 "moved scene's one structure",
                 renderer._tracers[0](o, d, RAY_EPS, float("inf")),
                 make_tracers(fresh, one)[0](o, d, RAY_EPS, float("inf")),
                 o, d, RAY_EPS, float("inf"), frame,
                 _instanced_certify(fresh, host))
    return launches, renderer.ms_per_spp


def _spawn(fn, nprocs, tmp, *args):
    """Run fn(rank, nprocs, store, tmp, *args) in `nprocs` spawned ranks
    (a FileStore under `tmp`); each rank saves its results to
    tmp/rank{r}.pt; returns them in rank order. Raises if a rank fails."""
    import torch.multiprocessing as mp

    mp.start_processes(fn, args=(nprocs, os.path.join(tmp, "store"), tmp,
                                 *args),
                       nprocs=nprocs, start_method="spawn")
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(nprocs)]


def _gloo_takes_cuda(dev):
    """Which collectives the installed gloo runs on CUDA tensors (every
    rank calls this together; a refusal is local, before any traffic)."""
    import torch.distributed as dist

    took = {}
    n = dist.get_world_size()
    for name in ("all_reduce", "all_gather", "broadcast"):
        x = torch.ones(4, device=dev)
        try:
            if name == "all_reduce":
                dist.all_reduce(x)
            elif name == "all_gather":
                dist.all_gather([torch.empty_like(x) for _ in range(n)], x)
            else:
                dist.broadcast(x, 0)
            torch.cuda.synchronize(dev)
            took[name] = "takes CUDA tensors"
        except (RuntimeError, ValueError) as e:
            took[name] = f"refuses them: {str(e)[:100]}"
    return took


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _rank_mesh(rank, world, store, tmp, device, scene_kw, settings_c,
               settings_p):
    """8c, one rank: the colonnade flattened here, 2 spp on a tile=2 and
    a sample=2 mesh, with and without compaction."""
    import torch.distributed as dist

    from platinum_tpu_torch.app.scenes import make_colonnade_scene
    from platinum_tpu_torch.parallel.mesh import join, mesh_of
    from platinum_tpu_torch.parallel.shard import (gather_image,
                                                   make_sharded_step)
    from platinum_tpu_torch.render.flatten import (analyze_features,
                                                   flatten_scene)
    from platinum_tpu_torch.render.integrator import make_tracers

    dev = join(rank, world, store=dist.FileStore(store, world),
               device=device)
    out = dict(backend=dist.get_backend(), device=str(dev))
    scene, cam = make_colonnade_scene(**scene_kw)
    flat = flatten_scene(scene, cam, settings_c, device=dev)
    feats = analyze_features(flat)
    tracers = make_tracers(flat, settings_c)
    for axes in ({"tile": 2}, {"sample": 2}):
        mesh = mesh_of(axes)
        name = ",".join(f"{a}={n}" for a, n in axes.items())
        for key, s in (("compact", settings_c), ("plain", settings_p)):
            step = make_sharded_step(flat, s, mesh, features=feats,
                                     tracers=tracers)
            acc = torch.zeros((s.num_pixels // mesh.shape.get("tile", 1), 3),
                              device=dev)
            steps = -(-s.spp // mesh.shape.get("sample", 1))
            _sync(dev)
            t0 = time.perf_counter()
            for i in range(steps):
                acc = step(acc, i)
            _sync(dev)
            ms = (time.perf_counter() - t0) * 1e3 / s.spp
            out[name, key] = dict(shard=acc.cpu(), ms=ms,
                                  img=gather_image(acc, s, mesh).cpu())
    out["gloo"] = _gloo_takes_cuda(dev) if dev.type == "cuda" else {}
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    dist.destroy_process_group()


def phase_mesh(dev, tmp):
    """8c: pixel_ids and the tile / sample mesh on the card."""
    import dataclasses

    import torch.distributed as dist

    from platinum_tpu_torch.app.scenes import make_colonnade_scene
    from platinum_tpu_torch.parallel.mesh import join, mesh_of
    from platinum_tpu_torch.parallel.shard import (gather_image,
                                                   make_sharded_step)
    from platinum_tpu_torch.render import autoplan
    from platinum_tpu_torch.render.flatten import (analyze_features,
                                                   flatten_scene)
    from platinum_tpu_torch.render.integrator import (make_tracers,
                                                      render_sample)
    from platinum_tpu_torch.render.types import RenderSettings

    scene, cam = make_colonnade_scene(**COLONNADE)   # as each rank does
    settings = RenderSettings(spp=2, **HEADLINE)
    flat = flatten_scene(scene, cam, settings, device=dev)
    feats = analyze_features(flat)
    tracers = make_tracers(flat, settings)
    settings_c = autoplan.resolve_auto_plan(flat, settings, tracers=tracers)
    settings_p = dataclasses.replace(settings_c, compact=False,
                                     compact_plan=None)
    t0 = time.perf_counter()
    ranks = _spawn(_rank_mesh, 2, tmp, str(dev), COLONNADE, settings_c,
                   settings_p)
    t_ranks = time.perf_counter() - t0

    def sample(s, i, ids=None):
        return render_sample(flat, s, i, pixel_ids=ids, tracers=tracers,
                             features=feats)

    n = settings.num_pixels
    rows = []
    for key, s in (("compact", settings_c), ("plain", settings_p)):
        single = torch.zeros((n, 3), device=dev)
        for i in range(s.spp):
            single = (single * float(i) + sample(s, i)) / (i + 1.0)
        single = single.cpu()
        for name in ("tile=2", "sample=2"):
            for r, got in enumerate(ranks):
                if name == "tile=2":
                    ids = r * (n // 2) + torch.arange(n // 2, device=dev)
                    want = torch.zeros((n // 2, 3), device=dev)
                    for i in range(s.spp):
                        want = ((want * float(i) + sample(s, i, ids))
                                / (i + 1.0))
                else:
                    ids = torch.arange(n, device=dev)
                    both = (sample(s, 0, ids) + sample(s, 1, ids)) / 2.0
                    want = (torch.zeros_like(both) * 0.0 + both) / 1.0
                check(torch.equal(got[name, key]["shard"], want.cpu()),
                      f"8c {name} {key}: rank {r}'s shard is not "
                      f"render_sample(pixel_ids=) bit for bit")
            img = ranks[0][name, key]["img"].reshape(-1, 3)
            check(torch.equal(img, ranks[1][name, key]["img"].reshape(-1, 3)),
                  f"8c {name} {key}: the ranks assembled other images")
            err = float((img - single).abs().max())
            rel, z = _mean_z(img.numpy(), single.numpy())
            zheld = name == "tile=2" and key == "compact"
            ms = ranks[0][name, key]["ms"]
            rows.append(f"{name} {key}: {ms:.1f} ms/spp "
                        f"(two ranks time-share the card), max abs "
                        f"{err:.3g} from one device, mean rel {rel:.2e}, "
                        f"z {z:+.2f}" + (" (held by z)" if zheld else ""))
            if zheld:
                check(abs(z) <= MEAN_Z, f"8c {name} {key}: mean off, z {z}")
            else:
                check(err <= GEOM_ATOL, f"8c {name} {key}: max abs {err}")

    # one more step on a one-rank NCCL group: the collectives on the card
    with tempfile.TemporaryDirectory() as ntmp:
        join(0, 1, store=dist.FileStore(os.path.join(ntmp, "store"), 1),
             device=dev)
        try:
            backend = dist.get_backend()
            mesh = mesh_of({"sample": 1, "tile": 1})
            step = make_sharded_step(flat, settings_c, mesh, features=feats,
                                     tracers=tracers)
            acc = step(torch.zeros((n, 3), device=dev), 0)
            img = gather_image(acc, settings_c, mesh).reshape(-1, 3)
            want = (torch.zeros((n, 3), device=dev) * 0.0
                    + sample(settings_c, 0)) / 1.0
            nccl_ok = torch.equal(img, want)
        finally:
            dist.destroy_process_group()
    print("8c (sponza_class_512 at 2 spp on a mesh of two gloo ranks on "
          f"{ranks[0]['device']}, backends {[r['backend'] for r in ranks]}; "
          f"{t_ranks:.1f} s with the spawn): every shard bit for bit "
          "render_sample(pixel_ids=); " + "; ".join(rows), flush=True)
    print(f"  gloo on CUDA tensors (torch {torch.__version__}): "
          f"{ranks[0]['gloo']}; the one-rank {backend} group's step bit for "
          f"bit render_sample: {nccl_ok}", flush=True)
    check(backend == ("nccl" if dev.type == "cuda" else "gloo"),
          f"8c: the one-rank group ran {backend}")
    check(nccl_ok, "8c: the NCCL step is not render_sample bit for bit")
    check(all(r["backend"] == "gloo" for r in ranks),
          "8c: two ranks on one card must run gloo")


def _rank_geom(rank, world, store, tmp, device, settings):
    """8d, one rank: the bistro flattened here, geom=2."""
    import torch.distributed as dist

    from platinum_tpu_torch.app.scenes import make_colonnade_scene
    from platinum_tpu_torch.parallel.geometry import (make_geom_sharded_step,
                                                      make_geom_sharded_tracer)
    from platinum_tpu_torch.parallel.mesh import join, mesh_of
    from platinum_tpu_torch.render.flatten import (analyze_features,
                                                   flatten_scene)
    from platinum_tpu_torch.render.integrator import RAY_EPS

    dev = join(rank, world, store=dist.FileStore(store, world),
               device=device)
    scene, cam = make_colonnade_scene(**BISTRO)
    flat = flatten_scene(scene, cam, settings, device=dev)
    mesh = mesh_of({"geom": 2, "sample": 1, "tile": 1})
    w = {k: v.to(dev) for k, v in torch.load(
        os.path.join(tmp, "wave.pt")).items()}
    tc, ta = make_geom_sharded_tracer(flat.wbvh_parts, mesh)
    rec = tc(w["p"], w["d"], RAY_EPS, float("inf"))
    occ = ta(w["p"], w["seg"], RAY_EPS, w["dist"] - RAY_EPS)
    step = make_geom_sharded_step(flat, settings, mesh,
                                  features=analyze_features(flat))
    _sync(dev)
    t0 = time.perf_counter()
    acc = step(torch.zeros((settings.num_pixels, 3), device=dev), 0)
    _sync(dev)
    torch.save(dict(t=rec.t.cpu(), tri=rec.tri.cpu(), bary=rec.bary.cpu(),
                    hit=rec.hit.cpu(), occ=occ.cpu(), img=acc.cpu(),
                    ms=(time.perf_counter() - t0) * 1e3,
                    retraced=tc.retraced, parts=len(flat.wbvh_parts),
                    backend=dist.get_backend()),
               os.path.join(tmp, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _float_merge_apart(parts, pts, ref):
    """Rays on which geometry sharding's merge without the re-trace (each
    half of the partitions folded from the wave's tmax, the halves merged
    with a float `<`, as the JAX package merges) differs from the
    sequential tracer's `ref`, here in one process."""
    from platinum_tpu_torch.ops.intersect import fold_partition_tracers
    from platinum_tpu_torch.ops.packet_trace import make_packet_tracer
    from platinum_tpu_torch.render.integrator import RAY_EPS

    k = -(-len(parts) // 2)
    halves = [fold_partition_tracers(
        [make_packet_tracer(*q[:4])[0] for q in parts[g * k:(g + 1) * k]],
        [None] * k, pts["p"], pts["d"], RAY_EPS, float("inf"))
        for g in (0, 1)]
    closer = halves[1].hit & (halves[1].t < halves[0].t)
    tri = torch.where(closer, halves[1].tri, halves[0].tri)
    t = torch.where(closer, halves[1].t, halves[0].t)
    hit = halves[0].hit | closer
    return int(((hit != ref.hit) | (hit & ((tri != ref.tri)
                                           | (t != ref.t)))).sum())


def phase_geom(part, tmp):
    """8d: geometry sharding over two ranks on 8's partitioned bistro."""
    import dataclasses

    from platinum_tpu_torch.render.integrator import RAY_EPS, render_sample

    renderer, pts = part["renderer"], part["pts"]
    settings = dataclasses.replace(renderer.settings, spp=1)
    torch.save({k: pts[k].cpu() for k in ("p", "d", "seg", "dist")},
               os.path.join(tmp, "wave.pt"))
    t0 = time.perf_counter()
    ranks = _spawn(_rank_geom, 2, tmp, str(renderer.device), settings)
    t_ranks = time.perf_counter() - t0
    seq_c, seq_a = renderer._tracers
    ref = seq_c(pts["p"], pts["d"], RAY_EPS, float("inf"))
    occ = seq_a(pts["p"], pts["seg"], RAY_EPS, pts["dist"] - RAY_EPS).cpu()
    apart = _float_merge_apart(renderer.flat.wbvh_parts, pts, ref)
    img = render_sample(renderer.flat, settings, 0, tracers=renderer._tracers,
                        features=renderer._features).cpu()
    for r, got in enumerate(ranks):
        for k in ("t", "tri", "bary", "hit"):
            check(torch.equal(got[k], getattr(ref, k).cpu()),
                  f"8d: rank {r}'s {k} is not the sequential tracer's")
        check(torch.equal(got["occ"], occ),
              f"8d: rank {r}'s occlusion is not the sequential tracer's")
    same_wave = torch.equal(ranks[0]["img"], ranks[1]["img"])
    err = float((ranks[0]["img"] - img).abs().max())
    print(f"8d (geom=2 on two gloo ranks, {ranks[0]['parts']} partitions, "
          f"{-(-ranks[0]['parts'] // 2)} a rank; {t_ranks:.1f} s with the "
          f"spawn and each rank's flatten): hits and occlusion on the "
          f"{pts['p'].shape[0]}-ray bounce and shadow waves bit for bit the "
          f"sequential tracer's ({ranks[0]['retraced']} bounce rays whose "
          f"ranks' bests nearly tie traced again in rank order; the float "
          f"merge alone leaves {apart} rays apart from the sequential "
          f"tracer); the two ranks' radiance bit for bit equal: "
          f"{same_wave}; max abs {err:.3g} from 8's 1-spp image (bar "
          f"{GEOM_ATOL}); {ranks[0]['ms']:.1f} ms for the spp", flush=True)
    check(same_wave, "8d: the geom ranks traced different waves")
    check(err <= GEOM_ATOL, f"8d: image off 8's by {err}")


def phase_mesh_cli(tmp):
    """8e: `render --mesh tile=2` under torch.distributed.run."""
    out_dir = os.path.join(tmp, "cli8e")
    os.makedirs(out_dir)
    out = os.path.join(out_dir, "out.png")
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (repo, os.environ.get("PYTHONPATH")) if p))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", "platinum_tpu_torch.app.cli",
           "render", "colonnade", "--size", "512x512", "--spp", "2",
           "--mesh", "tile=2", "-o", out]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=out_dir, env=env, capture_output=True,
                          text=True, timeout=600)
    wall = time.perf_counter() - t0
    line = next((ln for ln in proc.stderr.splitlines()
                 if ln.startswith("rendered 2 spp on mesh")), None)
    print(f"8e: {' '.join(cmd[1:])}: exit {proc.returncode} in {wall:.1f} s; "
          f"stderr {line!r}; files {sorted(os.listdir(out_dir))}", flush=True)
    check(proc.returncode == 0, f"8e: exit {proc.returncode}:\n"
          f"{proc.stderr[-3000:]}")
    check(line is not None and "{'tile': 2} in " in line
          and line.endswith("s"), "8e: no mesh line with its seconds")
    check(sorted(os.listdir(out_dir)) == ["out.png"],
          "8e: not exactly one file written")
    check(proc.stdout.split() == [out], f"8e: stdout {proc.stdout!r}")
    return wall


# ---------------------------------------------------------------------------
# 9-9d: the last modules (the bvh tracer, the LUT baker) and the round's
# closing check (every blessed golden, the two bench configs never run)
# ---------------------------------------------------------------------------

BVH_T_RTOL = 1e-4   # 9: t of the bvh tracer against K1 where ids agree
BAKE_RTOL, BAKE_ATOL = 1e-4, 1e-6   # 9c: tests/test_torch_lut_baker.py's
BAKE_MAX_APART = 2                  # 9c: samples apart in a traced texel
CROP = 32                           # 9d: the CPU-held crop, pixels a side
BVH_GOLDENS = (("cornell", 1), ("spheres", 32))  # 9b: (golden, min tris)
BAKE_CLI_SPP = 1024                 # 9c: bake-luts --spp


def _golden_configs():
    """tests/golden_configs.py (imports no JAX) from the checkout."""
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import golden_configs

    return golden_configs


def _kernel_count(fn):
    """CUDA kernels `fn` launches, read from torch.profiler's device
    events (the trace kernels' own counters see only K1-K15)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA)
    return out, n


def _host_syncs(fn):
    """Host syncs of `fn` (torch's sync debug mode)."""
    import warnings

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return out, sum("synchroniz" in str(w.message) for w in caught)


def phase_bvh(scene, cam, dev):
    """9: the binary-BVH tracer (ops/traverse.py, torch ops: the JAX
    module is pure jnp, no Pallas) on the colonnade's 512x512 camera wave
    (closest hit) and shadow wave (any hit): its time a wave, the host
    syncs and CUDA kernels of a wave; held to K1/K2 on the whole waves
    (hit sets and occlusion agree on >= AGREE, ids on >= AGREE of the
    common hits, t to BVH_T_RTOL where ids agree: the two test triangles
    with different arithmetic) and to its own run on the CPU on the
    16,384-ray subset (hits, ids and occlusion on >= AGREE)."""
    from platinum_tpu_torch.ops import traverse
    from platinum_tpu_torch.render.flatten import flatten_scene
    from platinum_tpu_torch.render.integrator import RAY_EPS, make_tracers
    from platinum_tpu_torch.render.types import RenderSettings

    settings = RenderSettings(width=512, height=512, tracer="packet",
                              instancing="off")
    flat = flatten_scene(scene, cam, settings, device=dev)
    check(flat.bvh_nodes is not None, "9: no binary BVH")
    pts = _wave_points(flat, dev)
    bvh_c, bvh_a = traverse.make_bvh_tracer(flat, max_leaf=4)
    k1, k2 = make_tracers(flat, settings)
    n = pts["cam_o"].shape[0]
    cam_args = (pts["cam_o"], pts["cam_d"], RAY_EPS, float("inf"))
    sh_args = (pts["p"], pts["seg"], RAY_EPS, pts["dist"] - RAY_EPS)

    bvh_c(*cam_args)                                  # warm the allocator
    rec, ms_c = _synced_ms(lambda: bvh_c(*cam_args))
    occ, ms_a = _synced_ms(lambda: bvh_a(*sh_args))
    _, syncs_c = _host_syncs(lambda: bvh_c(*cam_args))
    _, syncs_a = _host_syncs(lambda: bvh_a(*sh_args))
    _, kernels_c = _kernel_count(lambda: bvh_c(*cam_args))
    ref = k1(*cam_args)
    ref_occ = k2(*sh_args)
    hit_agree = float((rec.hit == ref.hit).float().mean())
    both = rec.hit & ref.hit
    same = both & (rec.tri == ref.tri)
    id_agree = float(same.sum()) / max(int(both.sum()), 1)
    t_ok = torch.isclose(rec.t[same], ref.t[same], rtol=BVH_T_RTOL,
                         atol=T_ATOL)
    occ_agree = float((occ == ref_occ).float().mean())

    sub = pts["sample"]
    cpu_c, cpu_a = traverse.make_bvh_tracer(flat.to("cpu"), max_leaf=4)
    args = [a[sub].cpu() if torch.is_tensor(a) else a for a in cam_args]
    rec_cpu = cpu_c(*args)
    occ_cpu = cpu_a(*[a[sub].cpu() if torch.is_tensor(a) else a
                      for a in sh_args])
    cpu_agree = min(
        float((rec.hit[sub].cpu() == rec_cpu.hit).float().mean()),
        float((rec.tri[sub].cpu() == rec_cpu.tri).float().mean()),
        float((occ[sub].cpu() == occ_cpu).float().mean()))
    print(f"bvh tracer (9) on the colonnade's {n}-ray waves: camera "
          f"closest {ms_c:.1f} ms ({syncs_c} host syncs, {kernels_c} CUDA "
          f"kernels), shadow any hit {ms_a:.1f} ms ({syncs_a} host syncs); "
          f"against K1/K2: hit sets {hit_agree:.4%}, ids {id_agree:.4%} "
          f"of {int(both.sum())} common hits, t within rtol {BVH_T_RTOL} on "
          f"{float(t_ok.float().mean()):.4%} of those, occlusion "
          f"{occ_agree:.4%}; against its CPU run on {len(sub)} rays "
          f"{cpu_agree:.4%}", flush=True)
    check(hit_agree >= AGREE and id_agree >= AGREE and occ_agree >= AGREE,
          "9: the bvh tracer disagrees with K1/K2")
    check(bool(t_ok.all()), "9: bvh t apart from K1's where ids agree")
    check(cpu_agree >= AGREE, "9: the bvh tracer's card and CPU runs differ")
    return dict(ms_closest=ms_c, ms_any=ms_a, syncs=syncs_c,
                kernels=kernels_c)


def phase_goldens():
    """9b: every blessed golden of tests/test_golden.py, rendered on the
    card at its own size, spp, sampler and accel_min_tris=32 through
    tests/golden_configs.py (flatten + integrator.render, the Renderer
    under GMoN), each held to RMSE <= 1e-3 (test_golden.py's bar) against
    tests/goldens/<name>.exr; then cornell (accel_min_tris=1, so it has a
    binary BVH) and spheres with tracer="bvh", held to the same bar."""
    gc = _golden_configs()
    runs = [(name, None, 32) for name in gc.NAMES]
    runs += [(name, "bvh", min_tris) for name, min_tris in BVH_GOLDENS]
    out = {}
    for name, tracer, min_tris in runs:
        label = name + (f" tracer={tracer}" if tracer else "")
        _zero_launches()
        t0 = time.perf_counter()
        img, settings = gc.render(name, "cuda", tracer=tracer,
                                  accel_min_tris=min_tris)
        dt = time.perf_counter() - t0
        spp = settings.spp
        launches = {k: v for k, v in _launches().items() if v}
        ref = gc.golden(name)
        check(img.shape == ref.shape, f"9b {label}: image {img.shape}")
        check(bool(np.isfinite(img).all()), f"9b {label}: non-finite")
        err = gc.rmse(img, ref)
        out[label] = dict(rmse=err, s=dt, ms_spp=dt * 1e3 / spp)
        print(f"  golden {label}: {img.shape[1]}x{img.shape[0]} x {spp} spp "
              f"in {dt:.2f} s ({dt * 1e3 / spp:.1f} ms/spp, the flatten "
              f"included), RMSE {err:.3e} (bar {gc.RMSE_THRESHOLD}), mean "
              f"{img.mean():.5f} vs {ref.mean():.5f}, kernel launches "
              f"{launches}", flush=True)
        check(err <= gc.RMSE_THRESHOLD,
              f"9b {label}: RMSE {err:.3e} > {gc.RMSE_THRESHOLD}")
    return out


def _capture_mc(baker, store):
    """Wrap lut_baker._mc so that it also records every sample's integrand
    (spp, texels) in `store`; returns the original."""
    from platinum_tpu_torch.ops.samplers import PCG4DStream

    real = baker._mc

    def _mc(texel_fn, shape, spp, device, *args, **kw):
        n = int(np.prod(shape))
        lin = torch.arange(n, device=device)
        s = torch.arange(spp, device=device)[:, None].expand(spp, n)
        vals = texel_fn(PCG4DStream.create((lin & 0xFFFF).expand(spp, n),
                                           (lin >> 16).expand(spp, n), s))
        store.append(vals.double().cpu().numpy())
        return real(texel_fn, shape, spp, device, *args, **kw)

    baker._mc = _mc
    return real


def _hold_bake(name, got, ref, gvals, rvals):
    """9c: every texel of the card's table within BAKE_RTOL / BAKE_ATOL of
    the CPU's, or traced to its samples as tests/test_torch_lut_baker.py
    traces them: at most BAKE_MAX_APART samples differ beyond the bar and
    they carry half the gap (a discrete decision that a 1-ulp difference
    of the card's sin / cos / sqrt flips, or a tiny pdf); returns
    {texel: [(card, CPU) of each sample apart]}."""
    got, ref = got.reshape(-1), ref.reshape(-1)
    out = np.nonzero(~np.isclose(got, ref, rtol=BAKE_RTOL,
                                 atol=BAKE_ATOL))[0]
    traced = {}
    for i in out:
        g, r = gvals[:, i], rvals[:, i]
        apart = ~np.isclose(g, r, rtol=BAKE_RTOL, atol=BAKE_ATOL)
        gap = abs(float(got[i]) - float(ref[i])) * len(g)
        check(1 <= apart.sum() <= BAKE_MAX_APART
              and np.abs(g - r)[apart].sum() >= 0.5 * gap,
              f"9c {name} texel {i}: {int(apart.sum())} samples apart do "
              f"not explain its gap")
        traced[int(i)] = [(float(a), float(b))
                          for a, b in zip(g[apart], r[apart])]
    return traced


def phase_bake(tmp):
    """9c: the LUT baker (tools/lut_baker.py, torch ops: the JAX module is
    pure jnp) on the card. Every bake_* at size 16 (aniso bins 4), 64
    samples, on the card and on the CPU, each texel held (or traced);
    then `bake-luts --spp 1024 --exr` through the CLI in this process on
    the card, the bundle and the slices written into a temporary
    directory: its seconds, and the bundle loaded by ops/luts."""
    from platinum_tpu_torch.app import cli
    from platinum_tpu_torch.ops import luts
    from platinum_tpu_torch.tools import lut_baker as baker

    host = luts.get_host_luts()
    size, spp = 16, 64
    kw = dict(size=size, spp=spp)
    ms_iso, ms_aniso = (host.E, host.E_avg), (host.E_aniso, host.E_avg_aniso)
    bakes = {
        "E": lambda d: baker.bake_E(**kw, device=d),
        "E_avg": lambda d: baker.bake_E_avg(**kw, device=d),
        "E_ms": lambda d: baker.bake_E_ms(*ms_iso, **kw, device=d),
        "E_ms_avg": lambda d: baker.bake_E_ms_avg(*ms_iso, **kw, device=d),
        "E_trans_in": lambda d: baker.bake_E_trans(False, **kw, device=d),
        "E_trans_out": lambda d: baker.bake_E_trans(True, **kw, device=d),
        "E_trans_in_avg": lambda d: baker.bake_E_trans_avg(False, **kw,
                                                           device=d),
        "E_trans_out_avg": lambda d: baker.bake_E_trans_avg(True, **kw,
                                                            device=d),
        "E_aniso": lambda d: baker.bake_E_aniso(**kw, device=d),
        "E_avg_aniso": lambda d: baker.bake_E_avg_aniso(**kw, device=d),
        "E_ms_aniso": lambda d: baker.bake_E_ms_aniso(*ms_aniso, asize=4,
                                                      **kw, device=d),
        "E_ms_avg_aniso": lambda d: baker.bake_E_ms_avg_aniso(
            *ms_aniso, asize=4, **kw, device=d),
    }
    traced, secs = {}, {}
    for name, bake in bakes.items():
        vals = {}
        for d in ("cuda", "cpu"):
            vals[d] = []
            real = _capture_mc(baker, vals[d])
            try:
                t0 = time.perf_counter()
                table = bake(d)
                torch.cuda.synchronize()
                secs.setdefault(name, {})[d] = time.perf_counter() - t0
            finally:
                baker._mc = real
            vals[d].append(table)
        gvals, got = vals["cuda"]
        rvals, ref = vals["cpu"]
        check(got.shape == ref.shape and bool(np.isfinite(got).all()),
              f"9c {name}: table {got.shape}")
        traced[name] = _hold_bake(name, got, ref, gvals, rvals)
    print(f"LUT bake (9c) card against CPU, size {size}, {spp} spp: "
          f"every texel within rtol {BAKE_RTOL} / atol {BAKE_ATOL} or "
          f"traced; traced texels {traced}", flush=True)

    saved = baker.LUT_BUNDLE, baker.RESOURCE_DIR
    bundle = os.path.join(tmp, "ggx_luts.npz")
    baker.LUT_BUNDLE, baker.RESOURCE_DIR = bundle, tmp
    try:
        t0 = time.perf_counter()
        cli.main(["bake-luts", "--spp", str(BAKE_CLI_SPP), "--exr"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        baker.LUT_BUNDLE, baker.RESOURCE_DIR = saved
    os.environ["PLATINUM_TPU_LUTS"] = bundle
    try:
        baked = luts.get_host_luts()
    finally:
        del os.environ["PLATINUM_TPU_LUTS"]
    slices = len(os.listdir(os.path.join(tmp, "lut")))
    apart = {k: float(np.abs(getattr(baked, k) - getattr(host, k)).max())
             for k in luts.LUT_NAMES}
    print(f"  bake-luts --spp {BAKE_CLI_SPP} --exr on the card: {dt:.2f} s, "
          f"{os.path.getsize(bundle)} bytes, {slices} EXR slices; largest "
          f"|difference| from the committed bundle per table (printed, not "
          f"held: at this spp E_avg's estimate passes 1 near roughness 0, "
          f"and the multiscatter tables' 1 / max(1 - E_avg, 1e-5) term "
          f"blows up there, on the CPU and in the JAX package alike) "
          f"{apart}", flush=True)
    check(slices == 101, f"9c: {slices} EXR slices")
    check(all(np.isfinite(getattr(baked, k)).all() for k in luts.LUT_NAMES),
          "9c: the baked bundle is not finite")
    return dict(bake_s=dt, small_s=secs)


def _crop_ids(w, h):
    ys, xs = np.mgrid[h // 2 - CROP // 2:h // 2 + CROP // 2,
                      w // 2 - CROP // 2:w // 2 + CROP // 2]
    return (ys * w + xs).reshape(-1)


def _bench_config(label, scene, cam, settings):
    """9d: one bench config through the Renderer at its cut spp (ms/spp,
    trace kernel launches per spp, all CUDA kernels of one step), then
    render_sample(pixel_ids=) of a CROP x CROP block at the image centre
    on the card against the same on the CPU (its own flatten) for every
    sample, held per pixel by phase 5's bars; where the Renderer did not
    compact, its image's crop is held to the CPU's too."""
    from platinum_tpu_torch.render import integrator
    from platinum_tpu_torch.render.flatten import (analyze_features,
                                                   flatten_scene)
    from platinum_tpu_torch.render.integrator import render_sample

    renderer, launches, mean = _render_path(label, scene, cam, settings)
    s = renderer.settings
    trace_spp = {k: (v - renderer.probe_launches.get(k, 0)) / s.spp
                 for k, v in launches.items() if v}
    ids = _crop_ids(s.width, s.height)
    img = renderer.readback().reshape(-1, 3)[ids]
    renderer._accumulated = s.spp - 2      # one more step, counted
    _, kernels = _kernel_count(renderer.render)
    cpu = flatten_scene(scene, cam, s, device="cpu")
    feats = analyze_features(renderer.flat)
    check(feats == analyze_features(cpu), f"{label}: features differ")
    card = torch.as_tensor(ids, device=renderer.flat.camera.position.device)
    crop_k = sum(render_sample(renderer.flat, s, i, pixel_ids=card,
                               features=feats).cpu().numpy()
                 for i in range(s.spp)) / s.spp
    crop_c = sum(render_sample(cpu, s, i, pixel_ids=torch.as_tensor(ids),
                               features=feats).numpy()
                 for i in range(s.spp)) / s.spp
    close = np.isclose(crop_k, crop_c, rtol=PIX_RTOL, atol=PIX_ATOL).all(-1)
    rel = abs(crop_k.mean() / crop_c.mean() - 1.0)
    plan = len(integrator._compaction_plan(s.num_pixels, s)) > 1
    whole = np.isclose(img, crop_c, rtol=PIX_RTOL, atol=PIX_ATOL).all(-1)
    print(f"  {label} crop {CROP}x{CROP} x {s.spp} spp, card against CPU: "
          f"{close.mean():.4%} of pixels within rtol={PIX_RTOL} "
          f"atol={PIX_ATOL}, mean {crop_k.mean():.5f} vs {crop_c.mean():.5f} "
          f"(rel {rel:.2e}); the Renderer's image there {whole.mean():.4%} "
          f"({'compacted: printed' if plan else 'held'}); trace kernel "
          f"launches per spp {trace_spp}, CUDA kernels of one step "
          f"{kernels}", flush=True)
    check(close.mean() >= AGREE and rel <= MEAN_RTOL,
          f"{label}: the crop differs from the CPU's")
    check(plan or whole.mean() >= AGREE,
          f"{label}: the Renderer's image differs from the CPU crop")
    return dict(ms_spp=renderer.ms_per_spp, launches_spp=trace_spp,
                kernels_step=kernels, mean=mean)


def phase_bench_configs(tmp):
    """9d: bench.py's two configs never run on the card before:
    cornell_512 (bench.py:223-229: 512x512, 8 bounces, mis, halton, 12
    triangles under accel_min_tris=32: the brute tracer) cut from 64 to
    8 spp, and helmet_env_1080p (bench.py:294-300: the helmet through the
    foreign GLB, 1920x1080, 6 bounces, packet, compact_plan="auto") cut
    from 16 to 4 spp."""
    from platinum_tpu_torch.app.scenes import (make_cornell_scene,
                                               make_helmet_scene)
    from platinum_tpu_torch.render.types import RenderSettings

    out = {}
    scene, cam = make_cornell_scene()
    out["cornell_512"] = _bench_config(
        "cornell_512 (9d)", scene, cam, RenderSettings(
            width=512, height=512, spp=8, max_bounces=8, kernel="mis",
            sampler="halton"))
    scene, cam = _via_foreign_glb(*make_helmet_scene(),
                                  os.path.join(tmp, "helmet.glb"))
    out["helmet_env_1080p"] = _bench_config(
        "helmet_env_1080p (9d)", scene, cam, RenderSettings(
            width=1920, height=1080, spp=4, max_bounces=6, kernel="mis",
            sampler="halton", tracer="packet", compact=True,
            compact_plan="auto"))
    return out


def _design(name):
    """How the kernel row `name` of the kernel table walks and tests:
    which of wide_trace.cu's walks, or the breadth-first kernels' step."""
    if "(K1)" in name or "closest (K3)" in name:
        walk = "warp-wide fp32 drain"
    elif any(f"any-hit (K{k})" in name for k in (2, 3, 6)):
        walk = "warp-wide any-hit drain"
    elif "(K4)" in name or "(K5)" in name:
        walk = "warp-wide drain over the pre-split planes"
    elif "(K6)" in name:
        walk = "warp-wide fp32 drain, L2 prefetch at enqueue"
    elif "(K7)" in name:
        walk = "warp-wide fp32 drain, near-first queues newest first"
    elif "split_planes" in name:
        return "one thread per coefficient"
    elif "bf_expand" in name:
        return ("a block per unit, a thread per lane; the lane's ray loaded "
                "with the node row, before the barrier; only the node's "
                "non-empty children tested (a full node unrolled)")
    elif "bf_emit" in name:
        return ("CTAs the card holds, a warp per unit, four lanes a thread; "
                "ranks from the warp's four ballots of each child some lane "
                "has; the unit's offset and region rows in one load, the "
                "next unit's loads ahead")
    elif "bf_prefix" in name:
        return ("one scan block, every item in registers, then a grid of "
                "fill warps (two launches)")
    elif "bf_mt" in name:
        return ("CTAs the card holds, CTA c taking MT tiles c, c + grid, "
                "...; a tile's live lanes 2 rays a thread (4 at default), "
                "split over up to 16 lanes where few; rays and blocks "
                "staged ahead (cp.async)")
    elif "bf_bwd" in name:
        return ("CTAs the card holds striding over the units; a lane's "
                "(t, slot) gathers issued together, u, v for the winner "
                "alone")
    elif "bf_" in name:
        return "breadth-first level step"
    elif "stream_mt" in name:
        return ("512 block-sorted pairs a CTA, each run's block staged once "
                "in shared memory (cp.async, one round ahead), 2 pairs a "
                "thread (4 at default)")
    elif "(K9" in name:
        walk = ("warp-wide pipelined drain (per-lane backlog, up to "
                "kPipeDrain blocks a lane a round)")
    elif "(K8)" in name:
        return ("each 128-ray CTA on its half's unpaired drain (K1's / "
                "K6's fp32 drain, K4's, K5's; K2's any-hit drain), "
                "closest-hit CTAs first")
    else:                       # the ablation modes
        walk = "per-thread walk"
    return walk + (", ten-lane instance entry" if "(K3)" in name else "")


def main():
    t_start = time.perf_counter()
    laps = [t_start]

    def lap(phases):
        """Print the wall time since the last lap: where the script's
        time goes."""
        torch.cuda.synchronize()
        laps.append(time.perf_counter())
        print(f"[{phases}: {laps[-1] - laps[-2]:.1f} s, "
              f"{laps[-1] - t_start:.1f} s so far]", flush=True)

    dev = phase_device()
    phase_build()
    lap("1-2 build")
    from platinum_tpu_torch.app.scenes import make_colonnade_scene

    scene, cam = make_colonnade_scene()
    ctx, k12 = phase_k1k2(scene, cam, dev)
    lap("3 K1/K2")
    k3 = phase_k3(scene, cam, dev, ctx["pts"])
    lap("3b K3, 3h instanced")
    k457 = phase_variants(ctx)
    lap("3c-3e K4, K5, K7")
    k8 = phase_paired(ctx, k12)
    k9 = phase_pipe(ctx, k12)
    prof = phase_profile(ctx, k12)
    lap("3g-3i K8, K9, ablation")
    k15 = phase_raystream(ctx)
    _hold_high_to_raystream(ctx)
    lap("3j K15, K4 against it")
    kbf = phase_bf(ctx)
    lap("3k K10-K14")
    k6 = phase_stream(scene, cam, dev, ctx["pts"])
    lap("3f K6 and the bistro tree")
    del ctx
    phase_headline_plain(scene, cam, dev)
    inst_launches = phase_instanced(scene, cam, dev)
    scene, cam = make_colonnade_scene()   # the column moved above
    head_launches, head_mean, head = phase_headline_compact(scene, cam)
    head_img = head.readback()
    lap("4-4c renders")
    phase_wave_modes(scene, cam, head, head_launches)
    del head
    lap("4h wave modes")
    knob_launches = phase_mt3_knob(scene, cam, head_mean)
    bistro_launches, bistro = phase_bistro()
    exact_launches, base_mean = phase_exact_options(scene, cam)
    stream_launches = phase_raystream_render(scene, cam, base_mean)
    pipe_launches = phase_pipe_render(scene, cam, base_mean,
                                      exact_launches["image"])
    lap("4d-4g, 4i renders")
    bf_launches = phase_bf_render(scene, cam, exact_launches.pop("image"))
    lap("4j bf render")
    phase_end_to_end(scene, cam, dev)
    lap("5-5d end to end")
    with tempfile.TemporaryDirectory() as tmp:
        ms6 = {}
        t6 = time.perf_counter()
        ms6["6"] = phase_glb_headline(tmp, scene, cam, head_img)
        lap("6 GLB headline")
        glb, ms6["6b"] = phase_glb_spheres(tmp)
        lap("6b GLB spheres")
        ms6["6c"] = phase_gmon()
        lap("6c GMoN")
        ms6["6d"] = phase_studio_post(tmp)
        lap("6d studio post")
        ms6["6e (s, the load included)"] = phase_cli(tmp, glb)
        lap("6e CLI")
    print(f"phases 6-6e on {_card()}: {time.perf_counter() - t6:.1f} s; "
          f"ms/spp {ms6}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        t7 = time.perf_counter()
        ms7 = {}
        ms7["7"], k1_spp = phase_alpha(dev)
        lap("7 alpha")
        ms7["7c"] = phase_zsampler(scene, cam, dev)
        lap("7c Z-sampler")
        ptscene = phase_ptscene(tmp, scene, cam, dev)
        lap("7d .ptscene")
        studio = phase_studio(tmp, scene, cam, dev, ptscene)
        lap("7e studio")
    print(f"phases 7-7e on {_card()}: {time.perf_counter() - t7:.1f} s; "
          f"ms/spp {ms7}, K1 launches per spp under alpha {k1_spp:.1f}; "
          f"studio ms a frame {studio[0]:.1f}, cli preview {studio[1]:.2f} s, "
          f"session {studio[2]:.2f} s", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        t8 = time.perf_counter()
        part = phase_partitioned(dev, bistro)
        ms8 = {"8": part["renderer"].ms_per_spp,
               "4e streamed": bistro.ms_per_spp}
        del bistro
        lap("8 partitioned bistro")
        _, ms8["8b"] = phase_partitioned_instanced(dev)
        lap("8b partitioned instanced")
        os.makedirs(os.path.join(tmp, "8c"))
        phase_mesh(dev, os.path.join(tmp, "8c"))
        lap("8c tile / sample mesh")
        os.makedirs(os.path.join(tmp, "8d"))
        phase_geom(part, os.path.join(tmp, "8d"))
        del part
        lap("8d geometry sharding")
        cli8 = phase_mesh_cli(tmp)
        lap("8e CLI on a mesh")
    print(f"phases 8-8e on {_card()}: {time.perf_counter() - t8:.1f} s; "
          f"ms/spp {ms8}; the CLI on a mesh {cli8:.1f} s", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        t9 = time.perf_counter()
        bvh9 = phase_bvh(scene, cam, dev)
        lap("9 bvh tracer")
        gold9 = phase_goldens()
        lap("9b goldens")
        bake9 = phase_bake(tmp)
        lap("9c LUT bake")
        bench9 = phase_bench_configs(tmp)
        lap("9d cornell_512, helmet_env_1080p")
    print(f"phases 9-9d on {_card()}: {time.perf_counter() - t9:.1f} s; "
          f"bvh tracer {bvh9}; goldens {gold9}; bake-luts --spp "
          f"{BAKE_CLI_SPP} {bake9['bake_s']:.2f} s; bench configs {bench9}",
          flush=True)

    src = "platinum_tpu_torch/csrc/wide_trace.cu"
    pallas = "platinum_tpu/ops/pallas_trace.py"
    table = [("wide_trace closest (K1)", f"{pallas}:99",
              k12["closest"], head_launches["closest"]),
             ("wide_trace any-hit (K2)", f"{pallas}:399",
              k12["any"], head_launches["any"]),
             ("wide_trace instanced closest (K3)", f"{pallas}:358",
              k3["closest"], inst_launches["inst_closest"]),
             ("wide_trace instanced any-hit (K3)", f"{pallas}:358",
              k3["any"], inst_launches["inst_any"]),
             ("wide_trace closest mt_precision=high (K4)", f"{pallas}:187",
              k457["K4"], knob_launches["closest+high"]),
             ("wide_trace closest mt_precision=default (K4)",
              f"{pallas}:187", k457["K4 default"],
              k457["K4 default"]["launches"]),
             ("wide_trace closest mt_precision=two_phase (K5)",
              f"{pallas}:416", k457["K5"],
              exact_launches["two_phase"]["closest+two_phase"]),
             ("wide_trace split_planes (K4/K5 pre-split planes)",
              f"{pallas}:194", k457["planes"], knob_launches["split_planes"]),
             ("wide_trace streamed closest (K6)", f"{pallas}:559",
              k6["closest"], bistro_launches["stream+closest"]),
             ("wide_trace streamed any-hit (K6)", f"{pallas}:559",
              k6["any"], bistro_launches["stream+any"]),
             ("wide_trace closest oct_order (K7)", f"{pallas}:623",
              k457["K7"], exact_launches["oct_order"]["closest+oct"]),
             ("wide_trace paired closest + any-hit (K8)", f"{pallas}:1519",
              k8, k8["launches"]),
             ("wide_trace pipelined closest (K9 pipe)", f"{pallas}:803",
              k9["K9 pipe"]["closest"], pipe_launches["pipe"]["pipe+closest"]),
             ("wide_trace pipelined any-hit (K9 pipe)", f"{pallas}:803",
              k9["K9 pipe"]["any"], pipe_launches["pipe"]["pipe+any"]),
             ("wide_trace pipelined closest, flat push (K9 flat_walk)",
              f"{pallas}:1071", k9["K9 flat_walk"]["closest"],
              pipe_launches["flat_walk"]["flat+closest"]),
             ("wide_trace pipelined any-hit, flat push (K9 flat_walk)",
              f"{pallas}:1071", k9["K9 flat_walk"]["any"],
              pipe_launches["flat_walk"]["flat+any"])]
    table += [(f"wide_trace closest profile={mode}", f"{pallas}:{line}",
               prof[mode], prof[mode]["launches"])
              for mode, line in (("empty", 740), ("nomt", 352),
                                 ("fix64", 519), ("count", 788))]
    bfj = "platinum_tpu/ops/bfstream.py"
    bf_src = "platinum_tpu_torch/csrc/bf_stream.cu"
    table = [(name, src, replaces, row, launches)
             for name, replaces, row, launches in table]
    for key, name, line in (("expand", "bf_expand (K10)", 215),
                            ("prefix", "bf_prefix (K11)", 385),
                            ("emit", "bf_emit (K12)", 548),
                            ("mt closest", "bf_mt closest (K13)", 706),
                            ("mt any", "bf_mt any-hit (K13)", 706),
                            ("bwd", "bf_bwd (K14)", 850)):
        row = kbf[key]
        if key == "prefix":
            row["fill_launches"] = bf_launches["bf prefix fill"]
        table.append((name, bf_src, f"{bfj}:{line}", row,
                      row.get("launches", bf_launches[f"bf {key}"])))
    kernels = [dict(name=name, route="cuda", design=_design(name),
                    source=source, replaces=replaces, launches=launches,
                    max_abs_err=row["max_abs_err"], ms=row["ms"],
                    plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                    bound_by=row["bound_by"],
                    library_ms=row.get("library_ms"),
                    **{k: row[k] for k in ("plain_rays", "fill_launches",
                                           "reference_ms", "library_part")
                       if k in row})
               for name, source, replaces, row, launches in table]
    stream_src = "platinum_tpu_torch/csrc/stream_mt.cu"
    for kind, mode in (("closest", "closest"), ("any", "any-hit")):
        row = k15[kind]
        kernels.append(dict(
            name=f"stream_mt {mode} (K15)", route="cuda",
            design=_design("stream_mt"), source=stream_src,
            replaces="platinum_tpu/ops/raystream.py:214",
            launches=stream_launches[f"stream_mt {kind}"],
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=None))
    check(all(k["launches"] > 0 for k in kernels),
          "a kernel of the main paths was never launched")
    print(f"total wall time {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
