"""Device-side scene representation: frozen dataclasses of torch tensors.

Torch counterpart of platinum_tpu/render/types.py. Every scene struct is a
frozen dataclass whose leaves are tensors (or nested structs, or None);
`.to(device)` moves all of them. Static configuration (image size, flags,
sampler kind, bounce count) lives in RenderSettings, a plain hashable
dataclass with the same fields and defaults as the JAX package's.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

# Material flag bits (platinum_tpu/render/types.py:24-28)
MAT_ANISOTROPIC = 1
MAT_EMISSIVE = 2
MAT_THIN = 4
MAT_USES_ALPHA = 8

# Renderer flag bits (platinum_tpu/render/types.py:31-32)
FLAG_MULTISCATTER_GGX = 1
FLAG_GMON = 2


def resolve_device(device) -> torch.device:
    """torch.device(device); a CUDA device must be present (the entry
    points default to the card and never fall back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: platinum_tpu_torch runs on the GPU by default; "
            "pass device='cpu' to run on the CPU")
    return dev


def _move(x, device):
    if isinstance(x, (torch.Tensor, TensorStruct)):
        return x.to(device)
    if isinstance(x, tuple):
        # FlatScene.wbvh_parts: a tuple of per-partition tensor tuples
        return tuple(_move(v, device) for v in x)
    return x


class TensorStruct:
    """Mixin for frozen dataclasses of tensors: `.to(device)` moves every
    tensor leaf, nested structs and tuples of tensors included."""

    def to(self, device):
        return dataclasses.replace(self, **{
            f.name: _move(getattr(self, f.name), device)
            for f in dataclasses.fields(self)})


@dataclass(frozen=True)
class Geometry(TensorStruct):
    """World-space triangle soup (instances baked)."""

    positions: torch.Tensor   # (V, 3) f32
    normals: torch.Tensor     # (V, 3) f32
    tangents: torch.Tensor    # (V, 4) f32 (xyz + handedness)
    uvs: torch.Tensor         # (V, 2) f32
    indices: torch.Tensor     # (T, 3) i32
    tri_material: torch.Tensor  # (T,) i32
    tri_geo: torch.Tensor | None = None    # (T, 12): v0, e1, e2, mat, node, pad
    tri_shade: torch.Tensor | None = None  # (T, 24): n0,n1,n2, tan4, uv0,uv1,uv2


@dataclass(frozen=True)
class MaterialTable(TensorStruct):
    """SoA material table, colors already in the working colorspace."""

    base_color: torch.Tensor      # (M, 4)
    emission: torch.Tensor        # (M, 3)
    roughness: torch.Tensor       # (M,)
    metallic: torch.Tensor        # (M,)
    transmission: torch.Tensor    # (M,)
    ior: torch.Tensor             # (M,)
    anisotropy: torch.Tensor      # (M,)
    anisotropy_rotation: torch.Tensor  # (M,)
    clearcoat: torch.Tensor       # (M,)
    clearcoat_roughness: torch.Tensor  # (M,)
    flags: torch.Tensor           # (M,) i32
    textures: torch.Tensor        # (M, 6) i32 atlas entry, -1 = none
    # per-material energy rows over cos-theta (see the JAX MaterialTable)
    energy: torch.Tensor | None = None      # (M, K, 6)
    energy_avg: torch.Tensor | None = None  # (M, 4)
    packed: torch.Tensor | None = None      # (M, 16) one-row material record


@dataclass(frozen=True)
class LightTable(TensorStruct):
    """Emissive-triangle table with power CDF and alias pick."""

    tri: torch.Tensor         # (L,) i32
    emission: torch.Tensor    # (L, 3)
    area: torch.Tensor        # (L,)
    power: torch.Tensor       # (L,)
    cum_power: torch.Tensor   # (L,)
    total_power: torch.Tensor  # () f32
    count: torch.Tensor       # () i32
    alias_p: torch.Tensor | None = None     # (L,)
    alias_idx: torch.Tensor | None = None   # (L,) i32
    packed: torch.Tensor | None = None      # (L, 16) [v0 e1 e2 emission area p/total alias_p alias]


@dataclass(frozen=True)
class EnvironmentLight(TensorStruct):
    """Equirect env map + alias table."""

    pixels: torch.Tensor   # (H, W, 3) f32
    pdf: torch.Tensor      # (H*W,)
    p: torch.Tensor        # (H*W,)
    alias: torch.Tensor    # (H*W,) i32
    count: torch.Tensor    # () i32 — 0 or 1


@dataclass(frozen=True)
class CameraConstants(TensorStruct):
    """Ray-generation constants."""

    position: torch.Tensor        # (3,)
    top_left: torch.Tensor        # (3,)
    pixel_delta_u: torch.Tensor   # (3,)
    pixel_delta_v: torch.Tensor   # (3,)
    aperture_radius: torch.Tensor  # ()
    aperture_blades: torch.Tensor  # () f32
    roundness: torch.Tensor       # ()
    bokeh_power: torch.Tensor     # ()


@dataclass(frozen=True)
class InstanceTable(TensorStruct):
    """Per-instance data of the two-level (TLAS/BLAS) path (accel.tlas):
    geometry stays in object space, once per mesh, and shading transforms
    interpolated vectors per lane with these rows."""

    # (I, 24) f32 [A row-major 9 | normal matrix row-major 9 | node id |
    # pad 5], A the object -> world linear part
    rows: torch.Tensor
    # (I, S) f32 material-table row per (instance, material slot)
    slot_mat: torch.Tensor
    # (I, 10, 128) f32 MT feature transforms T in lanes 0..9 (kernel input)
    feat: torch.Tensor


@dataclass(frozen=True)
class FlatScene(TensorStruct):
    """The flattened scene: same fields as the JAX package's FlatScene.

    `wbvh_parts` holds a scene's partitioned structures (stream="off"
    over the budget; accel/partition.py) in place of the single wide BVH:
    a tuple with one tuple of tensors per partition, a baked partition a
    5-tuple (nodes, tris, meta, slot_global, worder) and an instanced one
    a 7-tuple that adds inst_feat and inst_map (partition-local ->
    global instance ids; accel/tlas.py partition_instanced)."""

    geometry: Geometry
    materials: MaterialTable
    lights: LightTable
    env: EnvironmentLight
    camera: CameraConstants
    idt: torch.Tensor  # (3, 3) sRGB -> working-space matrix
    bvh_bounds_lo: torch.Tensor | None = None
    bvh_bounds_hi: torch.Tensor | None = None
    bvh_skip: torch.Tensor | None = None
    bvh_tri_start: torch.Tensor | None = None
    bvh_tri_count: torch.Tensor | None = None
    bvh_nodes: torch.Tensor | None = None
    # 16-wide BVH (accel.wide layout): (N, 128) node rows, (B, 10, 256) MT
    # coefficient blocks, (N*16,) i32 child meta, (B*64,) i32 slot -> tri
    wbvh_nodes: torch.Tensor | None = None
    wbvh_tris: torch.Tensor | None = None
    wbvh_meta: torch.Tensor | None = None
    wbvh_slot: torch.Tensor | None = None
    wbvh_order: torch.Tensor | None = None
    wbvh_parts: tuple | None = None
    wbvh_stream: bool = False
    atlas: torch.Tensor | None = None
    atlas_table: torch.Tensor | None = None
    luts: object | None = None   # ops.luts.Luts
    instances: InstanceTable | None = None


@dataclass(frozen=True)
class RenderSettings:
    """Static render configuration. Fields and defaults equal the JAX
    package's RenderSettings (platinum_tpu/render/types.py:203-311), which
    documents each knob; options this package does not implement yet raise
    NotImplementedError where they are read.

    The packet kernel's options, as this package runs them on the card
    (csrc/wide_trace.cu) and, on CPU tensors, through its plain versions:
    `oct_order` walks closest-hit waves near-first by the scene's octant
    orders (K7; same results as the plain walk); `mt_precision` is the MT
    tier of closest-hit waves: "highest" fp32 (K1), "high" bf16x3 and
    "default" 1-pass bf16 (K4; borderline hits drift), "two_phase" bf16x3
    broad phase + fp32 refine (K5; the "highest" results); any-hit waves
    stay fp32 under every tier. An unknown tier raises ValueError where
    render/integrator.make_tracers reads it. `stream` decides at flatten
    time whether a scene over `partition_tris` (baked) or
    `partition_bytes` (instanced) traces as one structure with streamed
    leaf blocks (K6, FlatScene.wbvh_stream): "auto" and "on" stream
    ("on" always); "off" splits such a scene into partitions
    (FlatScene.wbvh_parts), traced one after the other with the best t
    carried (accel/partition.py). two_phase over a streamed structure
    raises, as in the JAX package."""

    width: int = 512
    height: int = 512
    spp: int = 128
    max_bounces: int = 50
    kernel: str = "mis"            # "simple" | "mis"
    sampler: str = "halton"        # "halton" | "pcg4d" | "z"
    flags: int = FLAG_MULTISCATTER_GGX
    gmon_buckets: int = 1
    gmon_cap: int = 0
    working_space: str = "BT709"
    output_space: str = "sRGB"
    tracer: str = "auto"           # "auto" | "brute" | "bvh" | "packet" | "bf"
    bf_depth: int = 0
    instancing: str = "auto"       # "auto" | "on" | "off"
    compact: bool = False
    compact_plan: tuple | str | None = None
    spp_batch: int = 1
    mixture_pdf: bool = True
    oct_order: bool = False
    chunk_shade: int = 0
    fuse_shadow: bool = False
    accel_max_leaf: int = 4
    wide_leaf_cap: int = 64
    partition_tris: int = 350_000
    partition_bytes: int = 88 << 20
    mt_precision: str = "highest"
    stream: str = "auto"
    tile_rays: int = 1 << 18

    @property
    def num_pixels(self) -> int:
        return self.width * self.height
