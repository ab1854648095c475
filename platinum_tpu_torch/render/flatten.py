"""Scene -> FlatScene compiler ("the flattener"), torch edition.

Port of platinum_tpu/render/flatten.py: the baked path (:321-585), the
two-level instanced path (`_flatten_instanced`, :587-780) and
`analyze_features` (:811). The host work is the same numpy code over this
package's copies of the scene graph (core/), the BVH builders, the 16-wide
packer and the TLAS assembler (accel/); the result is a FlatScene of
tensors on the card, or on the CPU when asked. Under stream="off" a scene
over the budget flattens into partitions (FlatScene.wbvh_parts): baked
ones by accel/partition.py's partition_bvh (JAX flatten.py:525-551),
instanced ones by accel/tlas.py's partition_instanced (:660-676, :757-804).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from platinum_tpu_torch.accel import get_builder
from platinum_tpu_torch.accel.partition import partition_bvh
from platinum_tpu_torch.accel.tlas import (build_instanced_bvh,
                                           partition_instanced)
from platinum_tpu_torch.accel.wide import build_octant_orders, build_wide_bvh
from platinum_tpu_torch.core import colorspace as cs
from platinum_tpu_torch.core.environment import build_alias_table
from platinum_tpu_torch.core.material import NUM_TEXTURE_SLOTS, Material, TextureSlot
from platinum_tpu_torch.core.scene import Scene
from platinum_tpu_torch.core.texture import Texture
from platinum_tpu_torch.ops import luts as luts_mod
from platinum_tpu_torch.render.types import (
    LIGHT_ROW_TEXTURED,
    MAT_ANISOTROPIC,
    MAT_EMISSIVE,
    MAT_THIN,
    MAT_USES_ALPHA,
    CameraConstants,
    EnvironmentLight,
    FlatScene,
    Geometry,
    InstanceTable,
    LightTable,
    MaterialTable,
    RenderSettings,
    resolve_device,
)
from platinum_tpu_torch.utils import telemetry

F = np.float32


_CANONICAL = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
              np.dtype(np.uint64): np.uint32}


def _t(x, device, dtype=None):
    """numpy array or scalar -> tensor on `device`. 64-bit types narrow to
    32 bits, as the JAX package's arrays do with x64 off."""
    a = np.asarray(x, dtype=dtype)
    a = a.astype(_CANONICAL.get(a.dtype, a.dtype), copy=False)
    return torch.from_numpy(np.array(a, order="C")).to(device)


def _camera_constants(scene: Scene, camera_node_id: int,
                      settings: RenderSettings, device):
    node = scene.node(camera_node_id)
    camera = node.camera
    if camera is None:
        raise ValueError(f"node {camera_node_id} has no camera")
    m = scene.world_transform(camera_node_id)

    cols = m[:3, :3]
    norms = np.linalg.norm(cols, axis=0)
    cols = cols / np.maximum(norms, 1e-12)
    u, v, w = cols[:, 0], cols[:, 1], cols[:, 2]
    pos = m[:3, 3]

    aspect = settings.width / settings.height
    vh = camera.focus_distance * camera.cropped_sensor_height(aspect) / camera.focal_length
    vw = vh * aspect

    vu = u * vw
    vv = -v * vh
    top_left = pos - camera.focus_distance * w - (vu + vv) * 0.5

    return CameraConstants(
        position=_t(pos, device, F),
        top_left=_t(top_left, device, F),
        pixel_delta_u=_t(vu / settings.width, device, F),
        pixel_delta_v=_t(vv / settings.height, device, F),
        aperture_radius=_t(camera.aperture_radius_world, device, F),
        aperture_blades=_t(camera.aperture_blades, device, F),
        roundness=_t(camera.roundness, device, F),
        bokeh_power=_t(camera.bokeh_power, device, F),
    )


def _pack_atlas(textures: list) -> tuple:
    """Shelf-pack texture images into one atlas (JAX `_pack_atlas`):
    (atlas, table) with table[k] = (x, y, w, h, srgb_flag); uint8 storage
    when every source is 8-bit, float32 otherwise. Span `renderer.atlas`,
    counter `flatten.atlas_bytes`."""
    if not textures:
        return None, None
    with telemetry.span("renderer.atlas"):
        atlas, table = _pack_atlas_images(textures)
    telemetry.count("flatten.atlas_bytes", atlas.nbytes)
    return atlas, table


def _pack_atlas_images(textures: list) -> tuple:
    """The shelf packing of `_pack_atlas`, for a non-empty list."""
    u8 = [t.as_u8_rgba() for t in textures]
    use_u8 = all(x is not None for x in u8)
    if use_u8:
        imgs = [x[0] for x in u8]
        flags = [1 if x[1] else 0 for x in u8]
    else:
        imgs = [t.as_float_rgba() for t in textures]
        flags = [0] * len(imgs)
    order = sorted(range(len(imgs)), key=lambda i: -imgs[i].shape[0])
    max_w = max(i.shape[1] for i in imgs)
    atlas_w = max(1 << int(np.ceil(np.log2(max(max_w, 1)))), 128)

    table = [None] * len(imgs)
    shelves = []  # [y, height, x_cursor]
    y_cursor = 0
    for idx in order:
        h, w = imgs[idx].shape[:2]
        for s in shelves:
            if s[1] >= h and s[2] + w <= atlas_w:
                table[idx] = (s[2], s[0], w, h)
                s[2] += w
                break
        else:
            shelves.append([y_cursor, h, w])
            table[idx] = (0, y_cursor, w, h)
            y_cursor += h
    atlas = np.zeros((max(y_cursor, 1), atlas_w, 4),
                     dtype=np.uint8 if use_u8 else F)
    for idx, (x, y, w, h) in enumerate(table):
        atlas[y: y + h, x: x + w] = imgs[idx]
    table5 = np.asarray(
        [(x, y, w, h, flags[i]) for i, (x, y, w, h) in enumerate(table)],
        dtype=np.int32)
    return atlas, table5


def _material_arrays(scene, mat_ids, idt, texture_entry, device):
    """Material SoA + per-material energy rows (JAX `_material_arrays`)."""
    n_mat = len(mat_ids)
    base_color = np.zeros((n_mat, 4), F)
    emission = np.zeros((n_mat, 3), F)
    rough = np.zeros(n_mat, F)
    metal = np.zeros(n_mat, F)
    transm = np.zeros(n_mat, F)
    ior = np.zeros(n_mat, F)
    aniso = np.zeros(n_mat, F)
    aniso_rot = np.zeros(n_mat, F)
    coat = np.zeros(n_mat, F)
    coat_rough = np.zeros(n_mat, F)
    flags = np.zeros(n_mat, np.int32)
    tex_table = np.full((n_mat, NUM_TEXTURE_SLOTS), -1, np.int32)

    for row, mid in enumerate(mat_ids):
        mat: Material = scene.resolve_material(mid)
        bc = np.asarray(mat.base_color, F)
        base_color[row, :3] = idt @ bc[:3]
        base_color[row, 3] = bc[3] if len(bc) > 3 else 1.0
        emission[row] = (idt @ np.asarray(mat.emission, F)) * F(mat.emission_strength)
        rough[row] = mat.roughness
        metal[row] = mat.metallic
        transm[row] = mat.transmission
        ior[row] = mat.ior
        aniso[row] = mat.anisotropy
        aniso_rot[row] = mat.anisotropy_rotation
        coat[row] = mat.clearcoat
        coat_rough[row] = mat.clearcoat_roughness

        fl = 0
        if mat.is_emissive():
            fl |= MAT_EMISSIVE
        if mat.anisotropy != 0.0:
            fl |= MAT_ANISOTROPIC
        if mat.thin_transmission:
            fl |= MAT_THIN
        uses_alpha = base_color[row, 3] < 1.0
        for slot, tid in mat.textures.items():
            entry = texture_entry(tid)
            tex_table[row, int(slot)] = entry
            if int(slot) == int(TextureSlot.BASE_COLOR) and entry >= 0:
                tex = scene.asset(tid)
                uses_alpha = uses_alpha or tex.has_alpha
        if uses_alpha:
            fl |= MAT_USES_ALPHA
        flags[row] = fl

    lm = luts_mod
    _l = lm.get_host_luts()
    K = 64
    cos_grid = (np.arange(K, dtype=np.float64) + 0.5) / K
    energy = np.zeros((n_mat, K, 6), F)
    energy_avg = np.zeros((n_mat, 4), F)
    for row in range(n_mat):
        rg, io = float(rough[row]), float(ior[row])
        iorp = (io - 1.0) / max(io, 1e-6)
        an = abs(float(aniso[row])) if (flags[row] & MAT_ANISOTROPIC) else 0.0
        if an > 0.0:
            energy[row, :, 0] = lm.sample3d_np(_l.E_aniso, cos_grid, rg, an)
        else:
            energy[row, :, 0] = lm.sample2d_np(_l.E, cos_grid, rg)
        if an > 0.0:
            energy[row, :, 1] = lm.sample4d_np(
                _l.E_ms_aniso, cos_grid, rg, iorp, an)
        else:
            energy[row, :, 1] = lm.sample3d_np(_l.E_ms, cos_grid, rg, iorp)
        energy[row, :, 2] = lm.sample3d_np(_l.E_trans_in, cos_grid, rg, iorp)
        energy[row, :, 3] = lm.sample3d_np(
            _l.E_trans_out, cos_grid, rg, 1.0 - (1.0 / max(io, 1e-6)))
        cr = float(coat_rough[row])
        energy[row, :, 4] = lm.sample2d_np(_l.F_coat_avg, cos_grid, cr)
        energy[row, :, 5] = lm.sample2d_np(_l.E_F_coat, cos_grid, cr)
        energy_avg[row, 0] = (lm.sample2d_np(_l.E_avg_aniso, an, rg)
                              if an > 0.0 else lm.sample1d_np(_l.E_avg, rg))
        energy_avg[row, 1] = (
            lm.sample3d_np(_l.E_ms_avg_aniso, iorp, rg, an)
            if an > 0.0 else lm.sample2d_np(_l.E_ms_avg, iorp, rg))

    mat_packed = np.zeros((n_mat, 16), F)
    mat_packed[:, 0:4] = base_color
    mat_packed[:, 4:7] = emission
    mat_packed[:, 7] = rough
    mat_packed[:, 8] = metal
    mat_packed[:, 9] = transm
    mat_packed[:, 10] = ior
    mat_packed[:, 11] = aniso
    mat_packed[:, 12] = aniso_rot
    mat_packed[:, 13] = coat
    mat_packed[:, 14] = coat_rough
    mat_packed[:, 15] = flags.astype(F)

    table = MaterialTable(
        base_color=_t(base_color, device),
        emission=_t(emission, device),
        roughness=_t(rough, device),
        metallic=_t(metal, device),
        transmission=_t(transm, device),
        ior=_t(ior, device),
        anisotropy=_t(aniso, device),
        anisotropy_rotation=_t(aniso_rot, device),
        clearcoat=_t(coat, device),
        clearcoat_roughness=_t(coat_rough, device),
        flags=_t(flags, device),
        textures=_t(tex_table, device),
        energy=_t(energy, device),
        energy_avg=_t(energy_avg, device),
        packed=_t(mat_packed, device),
    )
    return table, flags, emission, tex_table


def _emission_uvtex(tex_table, light_mats, tri_uvs):
    """(L, 7) [uv0 uv1 uv2 entry] of emissive triangles: each one's three
    uvs (tri_uvs (L, 3, 2)) and its material's emission-texture atlas
    entry; None when no light binds an emission texture."""
    entry = tex_table[light_mats, int(TextureSlot.EMISSION)]
    if not (entry >= 0).any():
        return None
    return np.concatenate([tri_uvs.reshape(-1, 6),
                           entry[:, None].astype(F)], -1).astype(F)


def _light_table(lv0, le1, le2, l_emission, device,
                 l_uvtex=None) -> LightTable:
    """Emissive-triangle table with power CDF + alias pick. The power,
    and with it the pick, is the emission factor's. With `l_uvtex`
    (`_emission_uvtex`) each row goes on with the triangle's uvs and its
    emission-texture entry (types.LIGHT_ROW_TEXTURED columns), which NEE
    reads to multiply the factor by the texel it lands on."""
    if len(lv0):
        area = 0.5 * np.linalg.norm(np.cross(le1, le2), axis=-1)
        le = l_emission
        power = le[:, 1] * area * np.pi
        cum = np.cumsum(power, dtype=np.float64).astype(F)
        _, lp, lalias = build_alias_table(power)
        n_l = len(lv0)
        lpacked = np.zeros((n_l, 16 if l_uvtex is None
                            else LIGHT_ROW_TEXTURED), F)
        lpacked[:, 0:3] = lv0
        lpacked[:, 3:6] = le1
        lpacked[:, 6:9] = le2
        lpacked[:, 9:12] = le
        lpacked[:, 12] = area
        lpacked[:, 13] = power / max(float(cum[-1]), 1e-20)
        lpacked[:, 14] = lp
        lpacked[:, 15] = lalias.astype(F)
        if l_uvtex is not None:
            lpacked[:, 16:23] = l_uvtex
        return LightTable(
            tri=_t(np.zeros(n_l, np.int32), device),
            emission=_t(le, device),
            area=_t(area.astype(F), device),
            power=_t(power.astype(F), device),
            cum_power=_t(cum, device),
            total_power=_t(cum[-1], device, F),
            count=_t(n_l, device, np.int32),
            alias_p=_t(lp, device),
            alias_idx=_t(lalias.astype(np.int32), device),
            packed=_t(lpacked, device),
        )
    z = np.zeros(1, F)
    return LightTable(
        tri=_t(np.zeros(1, np.int32), device),
        emission=_t(np.zeros((1, 3), F), device),
        area=_t(z, device),
        power=_t(z, device),
        cum_power=_t(z, device),
        total_power=_t(0, device, F),
        count=_t(0, device, np.int32),
        alias_p=_t(np.ones(1, F), device),
        alias_idx=_t(np.zeros(1, np.int32), device),
        packed=_t(np.zeros((1, 16), F), device),
    )


def _environment_light(scene, idt, device) -> EnvironmentLight:
    """The environment's pixels and alias table; a map's table is built
    inside the span `renderer.env_table` (attr `texels`)."""
    env = scene.environment
    mapped = env.has_texture and scene.asset(env.texture_id) is not None
    if mapped:
        tex: Texture = scene.asset(env.texture_id)
        px = tex.as_float_rgba()[..., :3]
    else:
        px = np.asarray(env.constant_color, F).reshape(1, 1, 3)
    px = (px @ idt.T * F(env.strength)).astype(F)
    has_env = bool(px.max() > 0.0)
    luma = np.maximum(px @ cs.luminance_weights(cs.BT709), 0.0).reshape(-1)
    with (telemetry.span("renderer.env_table", texels=luma.shape[0])
          if mapped else contextlib.nullcontext()):
        pdf, p, alias = build_alias_table(luma)
    return EnvironmentLight(
        pixels=_t(px, device),
        pdf=_t(pdf, device),
        p=_t(p, device),
        alias=_t(alias.astype(np.int32), device),
        count=_t(1 if has_env else 0, device, np.int32),
    )


def flatten_scene(
    scene: Scene,
    camera_node_id: int | None = None,
    settings: RenderSettings | None = None,
    build_accel: bool = True,
    accel_min_tris: int = 32,
    accel_max_leaf: int | None = None,
    host_accel_out: dict | None = None,
    *,
    device="cuda",
) -> FlatScene:
    """Compile `scene` to a FlatScene of tensors on `device` (the card by
    default; raises when there is none). The JAX package's parameters in
    its order: `build_accel=False` builds no BVH (and no instancing), a
    scene below `accel_min_tris` triangles gets none either, and
    `accel_max_leaf` (default settings.accel_max_leaf) is the BVH's
    leaf size. `host_accel_out`, when a dict, receives the host-side
    instanced structure ({"ibvh", "mesh_wides", "mesh_tri_base",
    "instances"}) so that the Renderer can refit an instance's transform
    without a rebuild.

    Leaf for leaf the same arrays as the JAX package's flatten_scene on the
    baked path, the texture atlas included."""
    device = resolve_device(device)
    settings = settings or RenderSettings()
    if accel_max_leaf is None:
        accel_max_leaf = settings.accel_max_leaf
    working = cs.get_colorspace(settings.working_space)
    idt = cs.transform(cs.BT709, working)

    if camera_node_id is None:
        cams = scene.get_cameras()
        if not cams:
            raise ValueError("scene has no camera")
        camera_node_id = cams[0][0]

    instances = scene.get_instances()

    mat_ids: list = []
    mat_index: dict = {}

    def material_row(mid) -> int:
        if mid not in mat_index:
            mat_index[mid] = len(mat_ids)
            mat_ids.append(mid)
        return mat_index[mid]

    tex_assets: list = []
    tex_index: dict = {}

    def texture_entry(tid) -> int:
        if tid is None or scene.asset(tid) is None:
            return -1
        if tid not in tex_index:
            tex_index[tid] = len(tex_assets)
            tex_assets.append(scene.asset(tid))
        return tex_index[tid]

    # Two-level instancing decision (JAX flatten.py:378-395)
    n_unique = len({id(i.mesh) for i in instances}) if instances else 0
    use_instancing = (
        build_accel and settings.tracer in ("packet", "auto")
        and (settings.instancing == "on"
             or (settings.instancing == "auto"
                 and len(instances) > n_unique)))
    if use_instancing:
        total_tris = sum(i.mesh.num_triangles for i in instances)
        use_instancing = total_tris >= accel_min_tris
    if use_instancing:
        dets = [abs(np.linalg.det(np.asarray(i.transform,
                                             np.float64)[:3, :3]))
                for i in instances]
        use_instancing = min(dets) > 1e-12
    if use_instancing:
        return _flatten_instanced(
            scene, camera_node_id, settings, instances, material_row,
            texture_entry, mat_ids, tex_assets, idt, accel_max_leaf, device,
            host_accel_out)

    # Geometry: bake instances into world space
    positions, normals, tangents, uvs, indices, tri_mats = [], [], [], [], [], []
    tri_nodes = []
    v_off = 0
    for inst in instances:
        mesh = inst.mesh
        m, nm = inst.transform, inst.normal_transform
        wp = mesh.positions @ m[:3, :3].T + m[:3, 3]
        wn = mesh.normals @ nm.T
        wn /= np.maximum(np.linalg.norm(wn, axis=-1, keepdims=True), 1e-12)
        wt3 = mesh.tangents[:, :3] @ m[:3, :3].T
        wt3 /= np.maximum(np.linalg.norm(wt3, axis=-1, keepdims=True), 1e-12)

        positions.append(wp.astype(F))
        normals.append(wn.astype(F))
        tangents.append(np.concatenate([wt3, mesh.tangents[:, 3:4]], -1).astype(F))
        uvs.append(mesh.uvs.astype(F))
        indices.append(mesh.indices.astype(np.int64) + v_off)

        slot_rows = np.array(
            [material_row(inst.material_ids[s] if s < len(inst.material_ids)
                          else None)
             for s in range(mesh.num_material_slots)],
            dtype=np.int32,
        )
        tri_mats.append(slot_rows[mesh.material_slots])
        tri_nodes.append(np.full(mesh.num_triangles, inst.node_id, np.int32))
        v_off += mesh.num_vertices

    if not positions:
        raise ValueError("scene has no visible mesh instances")

    positions = np.concatenate(positions)
    normals = np.concatenate(normals)
    tangents = np.concatenate(tangents)
    uvs = np.concatenate(uvs)
    indices = np.concatenate(indices).astype(np.int32)
    tri_mats = np.concatenate(tri_mats).astype(np.int32)
    tri_nodes = np.concatenate(tri_nodes).astype(np.int32)

    # Acceleration structure: BVH build + leaf-contiguous triangle order
    bvh_arrays = {}
    bvh_host = None
    if build_accel and len(indices) >= accel_min_tris:
        bvh = bvh_host = get_builder()(
            positions[indices[:, 0]],
            positions[indices[:, 1]],
            positions[indices[:, 2]],
            max_leaf=accel_max_leaf,
        )
        indices = indices[bvh.tri_order]
        tri_mats = tri_mats[bvh.tri_order]
        tri_nodes = tri_nodes[bvh.tri_order]
        bvh_arrays = dict(
            bvh_bounds_lo=_t(bvh.bounds_lo, device),
            bvh_bounds_hi=_t(bvh.bounds_hi, device),
            bvh_skip=_t(bvh.skip, device),
            bvh_tri_start=_t(bvh.tri_start, device),
            bvh_tri_count=_t(bvh.tri_count, device),
        )

    materials, flags, emission, tex_table = _material_arrays(
        scene, mat_ids, idt, texture_entry, device)

    emissive_rows = np.nonzero(flags & MAT_EMISSIVE)[0]
    light_tris = np.nonzero(np.isin(tri_mats, emissive_rows))[0].astype(np.int32)
    tri_l = indices[light_tris]
    lv0 = positions[tri_l[:, 0]]
    lights = _light_table(lv0, positions[tri_l[:, 1]] - lv0,
                          positions[tri_l[:, 2]] - lv0,
                          emission[tri_mats[light_tris]], device,
                          _emission_uvtex(tex_table, tri_mats[light_tris],
                                          uvs[tri_l]))
    env_light = _environment_light(scene, idt, device)

    atlas, atlas_table = _pack_atlas(tex_assets)

    tri = indices
    v0w = positions[tri[:, 0]]
    e1w = positions[tri[:, 1]] - v0w
    e2w = positions[tri[:, 2]] - v0w
    t_cnt = len(tri)
    tri_geo = np.zeros((t_cnt, 12), F)
    tri_geo[:, 0:3] = v0w
    tri_geo[:, 3:6] = e1w
    tri_geo[:, 6:9] = e2w
    tri_geo[:, 9] = tri_mats.astype(F)
    tri_geo[:, 10] = tri_nodes.astype(F)
    tri_shade = np.zeros((t_cnt, 24), F)
    tri_shade[:, 0:3] = normals[tri[:, 0]]
    tri_shade[:, 3:6] = normals[tri[:, 1]]
    tri_shade[:, 6:9] = normals[tri[:, 2]]
    tri_shade[:, 9:13] = tangents[tri[:, 0]]
    tri_shade[:, 13:15] = uvs[tri[:, 0]]
    tri_shade[:, 15:17] = uvs[tri[:, 1]]
    tri_shade[:, 17:19] = uvs[tri[:, 2]]

    if bvh_host is not None:
        bn = np.zeros((bvh_host.num_nodes, 12), F)
        bn[:, 0:3] = bvh_host.bounds_lo
        bn[:, 3:6] = bvh_host.bounds_hi
        bn[:, 6] = bvh_host.skip.astype(np.int32).view(np.float32)
        bn[:, 7] = bvh_host.tri_start.astype(np.int32).view(np.float32)
        bn[:, 8] = bvh_host.tri_count.astype(np.int32).view(np.float32)
        bvh_arrays["bvh_nodes"] = _t(bn, device)
        stream = settings.stream == "on" or (
            settings.stream == "auto"
            and len(tri_geo) > settings.partition_tris)
        if stream:
            bvh_arrays["wbvh_stream"] = True
        if not stream and len(tri_geo) > settings.partition_tris:
            # beyond the budget: resident partitions traced in turn
            # (accel/partition.py), each a one-level wide BVH whose slot
            # map carries global triangle ids
            parts = []
            for part in partition_bvh(bvh_host, settings.partition_tris):
                w = build_wide_bvh(
                    part.bvh,
                    tri_geo[part.tri_base:part.tri_base + part.tri_count],
                    leaf_cap=settings.wide_leaf_cap)
                slot_g = np.where(w.tri_of_slot >= 0,
                                  w.tri_of_slot + part.tri_base, -1)
                parts.append((_t(w.nodes, device), _t(w.tri_blocks, device),
                              _t(w.meta, device),
                              _t(slot_g.astype(np.int32), device),
                              _t(build_octant_orders(w.nodes), device)))
            bvh_arrays["wbvh_parts"] = tuple(parts)
        else:
            wide = build_wide_bvh(bvh_host, tri_geo,
                                  leaf_cap=settings.wide_leaf_cap)
            bvh_arrays["wbvh_nodes"] = _t(wide.nodes, device)
            bvh_arrays["wbvh_tris"] = _t(wide.tri_blocks, device)
            bvh_arrays["wbvh_meta"] = _t(wide.meta, device)
            bvh_arrays["wbvh_slot"] = _t(wide.tri_of_slot.astype(np.int32),
                                         device)
            bvh_arrays["wbvh_order"] = _t(build_octant_orders(wide.nodes),
                                          device)

    return FlatScene(
        geometry=Geometry(
            positions=_t(positions, device),
            normals=_t(normals, device),
            tangents=_t(tangents, device),
            uvs=_t(uvs, device),
            indices=_t(indices, device),
            tri_material=_t(tri_mats, device),
            tri_geo=_t(tri_geo, device),
            tri_shade=_t(tri_shade, device),
        ),
        materials=materials,
        lights=lights,
        env=env_light,
        camera=_camera_constants(scene, camera_node_id, settings, device),
        idt=_t(idt, device),
        atlas=_t(atlas, device) if atlas is not None else None,
        atlas_table=_t(atlas_table, device) if atlas_table is not None else None,
        luts=luts_mod.load_luts(device),
        **bvh_arrays,
    )


def _flatten_instanced(scene, camera_node_id, settings, instances,
                       material_row, texture_entry, mat_ids, tex_assets,
                       idt, accel_max_leaf, device, host_accel_out=None):
    """Two-level TLAS/BLAS flatten (JAX `_flatten_instanced`): geometry is
    an object-space library of the unique meshes (stored once), each
    instance adds world-space BLAS node rows and a feature-transform
    matrix (accel.tlas), and shading resolves per-(instance, slot)
    materials and world transforms per lane (ops.hitdata)."""
    mesh_index: dict = {}
    mesh_list: list = []
    for inst in instances:
        if id(inst.mesh) not in mesh_index:
            mesh_index[id(inst.mesh)] = len(mesh_list)
            mesh_list.append(inst.mesh)

    # mesh library: object space, BVH-ordered, one wide BVH per mesh
    positions, normals, tangents, uvs, indices = [], [], [], [], []
    tri_slots, mesh_tri_base, mesh_wides = [], [], []
    v_off = t_off = 0
    builder = get_builder()
    for mesh in mesh_list:
        p = mesh.positions
        idx = mesh.indices.astype(np.int64)
        bvh = builder(p[idx[:, 0]], p[idx[:, 1]], p[idx[:, 2]],
                      max_leaf=accel_max_leaf)
        idxm = idx[bvh.tri_order]
        positions.append(p.astype(F))
        normals.append(mesh.normals.astype(F))
        tangents.append(mesh.tangents.astype(F))
        uvs.append(mesh.uvs.astype(F))
        indices.append(idxm + v_off)
        tri_slots.append(mesh.material_slots[bvh.tri_order].astype(np.int32))
        mesh_tri_base.append(t_off)
        v0 = p[idxm[:, 0]]
        tg = np.concatenate([v0, p[idxm[:, 1]] - v0, p[idxm[:, 2]] - v0,
                             np.zeros((len(idxm), 3), F)], -1).astype(F)
        mesh_wides.append(build_wide_bvh(bvh, tg,
                                         leaf_cap=settings.wide_leaf_cap))
        v_off += mesh.num_vertices
        t_off += len(idxm)

    positions = np.concatenate(positions)
    normals = np.concatenate(normals)
    tangents = np.concatenate(tangents)
    uvs = np.concatenate(uvs)
    indices = np.concatenate(indices).astype(np.int32)
    tri_slots_l = np.concatenate(tri_slots)

    # per-instance tables
    n_inst = len(instances)
    max_slots = max(m.num_material_slots for m in mesh_list)
    inst_rows = np.zeros((n_inst, 24), F)
    slot_mat = np.zeros((n_inst, max_slots), F)
    inst_mesh_mat = []
    for i, inst in enumerate(instances):
        mi = mesh_index[id(inst.mesh)]
        m, nm = np.asarray(inst.transform, np.float64), inst.normal_transform
        inst_mesh_mat.append((mi, m))
        inst_rows[i, 0:9] = m[:3, :3].reshape(-1)
        inst_rows[i, 9:18] = np.asarray(nm, np.float64).reshape(-1)
        inst_rows[i, 18] = float(inst.node_id)
        for s in range(inst.mesh.num_material_slots):
            mid = (inst.material_ids[s]
                   if s < len(inst.material_ids) else None)
            slot_mat[i, s] = material_row(mid)

    # one resident structure, or, with stream="off" over the budget,
    # spatial instance groups traced in turn (accel/tlas.py
    # partition_instanced); the projected size of one structure decides
    projected = (sum(w.tri_blocks.nbytes for w in mesh_wides)
                 + sum(mesh_wides[mi].nodes.nbytes + 10 * 128 * 4
                       for mi, _ in inst_mesh_mat))
    inst_stream = settings.stream == "on" or (
        settings.stream == "auto" and projected > settings.partition_bytes)
    ibvh = ibvh_parts = None
    if projected > settings.partition_bytes and not inst_stream:
        ibvh_parts = partition_instanced(mesh_wides, mesh_tri_base,
                                         inst_mesh_mat,
                                         settings.partition_bytes)
    else:
        ibvh = build_instanced_bvh(mesh_wides, mesh_tri_base, inst_mesh_mat)
    if host_accel_out is not None:
        host_accel_out.update(ibvh=ibvh, ibvh_parts=ibvh_parts,
                              mesh_wides=mesh_wides,
                              mesh_tri_base=list(mesh_tri_base),
                              instances=list(instances))

    materials, flags, emission, tex_table = _material_arrays(
        scene, mat_ids, idt, texture_entry, device)

    # lights: world-space emissive triangles, per instance
    lv0, le1, le2, lem, lmat, luv = [], [], [], [], [], []
    for i, inst in enumerate(instances):
        mi = mesh_index[id(inst.mesh)]
        base = mesh_tri_base[mi]
        n_tri = mesh_list[mi].num_triangles
        slots = tri_slots_l[base:base + n_tri]
        rows = slot_mat[i, np.clip(slots, 0, max_slots - 1)].astype(np.int64)
        em = (flags[rows] & MAT_EMISSIVE) != 0
        if not em.any():
            continue
        tr = indices[base:base + n_tri][em]
        a = np.asarray(inst.transform, np.float64)
        wp = positions[tr.reshape(-1)] @ a[:3, :3].T + a[:3, 3]
        wp = wp.reshape(-1, 3, 3).astype(F)
        lv0.append(wp[:, 0])
        le1.append(wp[:, 1] - wp[:, 0])
        le2.append(wp[:, 2] - wp[:, 0])
        lem.append(emission[rows[em]])
        lmat.append(rows[em])
        luv.append(uvs[tr])
    if lv0:
        lights = _light_table(np.concatenate(lv0), np.concatenate(le1),
                              np.concatenate(le2), np.concatenate(lem),
                              device,
                              _emission_uvtex(tex_table, np.concatenate(lmat),
                                              np.concatenate(luv)))
    else:
        z = np.zeros((0, 3), F)
        lights = _light_table(z, z, z, z, device)

    env_light = _environment_light(scene, idt, device)
    atlas, atlas_table = _pack_atlas(tex_assets)

    # packed per-triangle library rows
    tri = indices
    v0o = positions[tri[:, 0]]
    t_cnt = len(tri)
    tri_geo = np.zeros((t_cnt, 12), F)
    tri_geo[:, 0:3] = v0o
    tri_geo[:, 3:6] = positions[tri[:, 1]] - v0o
    tri_geo[:, 6:9] = positions[tri[:, 2]] - v0o
    tri_geo[:, 9] = tri_slots_l.astype(F)   # SLOT id, resolved per instance
    tri_shade = np.zeros((t_cnt, 24), F)
    tri_shade[:, 0:3] = normals[tri[:, 0]]
    tri_shade[:, 3:6] = normals[tri[:, 1]]
    tri_shade[:, 6:9] = normals[tri[:, 2]]
    tri_shade[:, 9:13] = tangents[tri[:, 0]]
    tri_shade[:, 13:15] = uvs[tri[:, 0]]
    tri_shade[:, 15:17] = uvs[tri[:, 1]]
    tri_shade[:, 17:19] = uvs[tri[:, 2]]

    return FlatScene(
        geometry=Geometry(
            positions=_t(positions, device),
            normals=_t(normals, device),
            tangents=_t(tangents, device),
            uvs=_t(uvs, device),
            indices=_t(indices, device),
            tri_material=_t(tri_slots_l, device),
            tri_geo=_t(tri_geo, device),
            tri_shade=_t(tri_shade, device),
        ),
        materials=materials,
        lights=lights,
        env=env_light,
        camera=_camera_constants(scene, camera_node_id, settings, device),
        idt=_t(idt, device),
        atlas=_t(atlas, device) if atlas is not None else None,
        atlas_table=_t(atlas_table, device) if atlas_table is not None else None,
        luts=luts_mod.load_luts(device),
        **(dict(_instanced_accel_arrays(ibvh, device),
                wbvh_stream=inst_stream)
           if ibvh is not None
           else dict(wbvh_parts=tuple(
               _instanced_part_arrays(part, gids, device)
               for part, gids, _ in ibvh_parts))),
        instances=InstanceTable(
            rows=_t(inst_rows, device),
            slot_mat=_t(slot_mat, device),
            feat=_t(_global_inst_feat(ibvh, ibvh_parts, n_inst), device),
        ),
    )


def _instanced_accel_arrays(ibvh, device) -> dict:
    """FlatScene accel fields of one resident TLAS/BLAS structure."""
    return dict(
        wbvh_nodes=_t(ibvh.nodes, device),
        wbvh_tris=_t(ibvh.tri_blocks, device),
        wbvh_meta=_t(ibvh.meta, device),
        wbvh_slot=_t(ibvh.tri_of_slot.astype(np.int32), device),
        wbvh_order=_t(build_octant_orders(np.asarray(ibvh.nodes)), device),
    )


def _instanced_part_arrays(ibvh, global_ids, device) -> tuple:
    """One instanced partition's 7-tuple for
    accel/partition.make_partitioned_tracer: (nodes, tris, meta, slot,
    worder, inst_feat, local -> global instance map)."""
    return (_t(ibvh.nodes, device),
            _t(ibvh.tri_blocks, device),
            _t(ibvh.meta, device),
            _t(ibvh.tri_of_slot.astype(np.int32), device),
            _t(build_octant_orders(np.asarray(ibvh.nodes)), device),
            _t(ibvh.inst_feat, device),
            _t(np.asarray(global_ids).astype(np.int32), device))


def _global_inst_feat(ibvh, ibvh_parts, n_inst):
    """Globally indexed (I, 10, 128) feature transforms: the single
    structure's, or scattered from each partition's local rows."""
    if ibvh is not None:
        return ibvh.inst_feat
    feat = np.zeros((n_inst, 10, 128), F)
    for part, gids, _ in ibvh_parts:
        feat[gids] = part.inst_feat
    return feat


def analyze_features(flat: FlatScene) -> frozenset:
    """Static BSDF lobe/feature set of the scene (JAX analyze_features)."""
    from platinum_tpu_torch.models.bsdf import scene_features

    class _HostMats:
        pass

    host = _HostMats()
    for name in ("metallic", "transmission", "clearcoat", "clearcoat_roughness",
                 "anisotropy", "roughness", "flags", "textures"):
        setattr(host, name, getattr(flat.materials, name).cpu().numpy())
    feats = set(scene_features(host))
    if int(flat.env.count) > 0:
        feats.add("env")
    if int(flat.lights.count) > 0:
        feats.add("area_lights")
    if (host.flags & MAT_USES_ALPHA).any():
        feats.add("alpha")
    for k in range(host.textures.shape[1]):
        if (host.textures[:, k] >= 0).any():
            feats.add(f"texslot{k}")
    return frozenset(feats)
