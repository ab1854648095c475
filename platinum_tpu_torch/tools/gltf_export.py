"""Copy of platinum_tpu/tools/gltf_export.py, kept in step with it: platinum_tpu_torch
imports nothing of the JAX package.

Minimal glTF 2.0 (.glb) exporter.

Writes scenes as standard binary glTF consumable by any glTF tool and by
this framework's own loader (io/gltf.py) — used to generate real on-disk
.glb benchmark fixtures (BASELINE configs name glTF assets; the sandbox
ships none, so the bench exports its procedural stand-ins and loads them
back through the full import path). The reference has no exporter either
(gltf.cpp is import-only); this is a capability extension.

Supported: per-slot mesh primitives (POSITION/NORMAL/TEXCOORD_0 + u32
indices), pbrMetallicRoughness materials + KHR extensions
(emissive_strength, transmission, ior, clearcoat), node transforms
(column-major matrix entries), perspective cameras. Textures are encoded
by io/png.py (filter 0; the JAX package encodes with PIL, so the PNG
payloads, and the offsets after the first image, differ while the
decoded texels and every other byte are the same).
"""

from __future__ import annotations

import json
import struct

import numpy as np

from platinum_tpu_torch.core.scene import Scene
from platinum_tpu_torch.io.png import encode_png

F32 = 5126
U32 = 5125


class _Bin:
    def __init__(self):
        self.chunks: list[bytes] = []
        self.views: list[dict] = []
        self.offset = 0

    def add(self, data: np.ndarray, target: int | None = None) -> int:
        raw = np.ascontiguousarray(data).tobytes()
        pad = (-len(raw)) % 4
        self.chunks.append(raw + b"\x00" * pad)
        view = dict(buffer=0, byteOffset=self.offset, byteLength=len(raw))
        if target:
            view["target"] = target
        self.views.append(view)
        self.offset += len(raw) + pad
        return len(self.views) - 1


def export_glb(scene: Scene, path: str, camera_node_id: int | None = None):
    """Write `scene` (meshes, materials, node transforms, cameras) to a
    standalone .glb file."""
    binbuf = _Bin()
    accessors: list[dict] = []
    gltf_meshes: list[dict] = []
    gltf_mats: list[dict] = []
    gltf_cams: list[dict] = []
    nodes: list[dict] = []

    def accessor(data, ctype, type_str, target=None, minmax=False):
        view = binbuf.add(data, target)
        acc = dict(bufferView=view, componentType=ctype,
                   count=len(data), type=type_str)
        if minmax:
            acc["min"] = [float(x) for x in data.min(axis=0)]
            acc["max"] = [float(x) for x in data.max(axis=0)]
        accessors.append(acc)
        return len(accessors) - 1

    gltf_images: list[dict] = []
    gltf_textures: list[dict] = []
    tex_index: dict = {}

    def texture(tid, slot) -> int | None:
        """Embed the texture as a PNG image in the bin chunk; returns the
        glTF texture index. metallicRoughness converts back to glTF channel
        order (G=roughness, B=metallic; ours is R=rough, G=metal)."""
        from platinum_tpu_torch.core.material import TextureSlot

        tex = scene.asset(tid)
        if tex is None:
            return None
        key = (tid, int(slot))
        if key in tex_index:
            return tex_index[key]
        u8 = tex.as_u8_rgba()
        if u8 is not None:
            data = u8[0].copy()
        else:
            data = np.clip(tex.as_float_rgba() * 255.0 + 0.5,
                           0, 255).astype(np.uint8)
        if int(slot) == int(TextureSlot.ROUGHNESS_METALLIC):
            out = np.zeros_like(data)
            out[..., 1] = data[..., 0]   # G = roughness
            out[..., 2] = data[..., 1]   # B = metallic
            out[..., 3] = 255
            data = out
        view = binbuf.add(np.frombuffer(encode_png(data), np.uint8))
        gltf_images.append(dict(bufferView=view, mimeType="image/png",
                                name=tex.name))
        gltf_textures.append(dict(source=len(gltf_images) - 1))
        tex_index[key] = len(gltf_textures) - 1
        return tex_index[key]

    mat_index: dict = {}

    def material(mid) -> int:
        if mid in mat_index:
            return mat_index[mid]
        m = scene.resolve_material(mid)
        spec: dict = {
            "name": m.name,
            "pbrMetallicRoughness": {
                "baseColorFactor": [float(x) for x in m.base_color[:4]],
                "metallicFactor": float(m.metallic),
                "roughnessFactor": float(m.roughness),
            },
        }
        ext: dict = {}
        em = [float(x) for x in m.emission]
        peak = max(em) if em else 0.0
        if peak > 0:
            # emissiveFactor must be <= 1; the KHR extension carries scale
            factor = [x / peak for x in em] if peak > 1.0 else em
            strength = float(m.emission_strength) * (peak if peak > 1.0 else 1.0)
            spec["emissiveFactor"] = factor
            if strength != 1.0:
                ext["KHR_materials_emissive_strength"] = {
                    "emissiveStrength": strength}
        if m.transmission > 0:
            ext["KHR_materials_transmission"] = {
                "transmissionFactor": float(m.transmission)}
        if m.ior != 1.5:
            ext["KHR_materials_ior"] = {"ior": float(m.ior)}
        if m.clearcoat > 0:
            ext["KHR_materials_clearcoat"] = {
                "clearcoatFactor": float(m.clearcoat),
                "clearcoatRoughnessFactor": float(m.clearcoat_roughness)}
        from platinum_tpu_torch.core.material import TextureSlot

        for slot, tid in m.textures.items():
            ti = texture(tid, slot)
            if ti is None:
                continue
            ref = {"index": ti}
            s = int(slot)
            if s == int(TextureSlot.BASE_COLOR):
                spec["pbrMetallicRoughness"]["baseColorTexture"] = ref
            elif s == int(TextureSlot.ROUGHNESS_METALLIC):
                spec["pbrMetallicRoughness"]["metallicRoughnessTexture"] = ref
            elif s == int(TextureSlot.NORMAL):
                spec["normalTexture"] = ref
            elif s == int(TextureSlot.EMISSION):
                spec["emissiveTexture"] = ref
            elif s == int(TextureSlot.TRANSMISSION):
                ext.setdefault("KHR_materials_transmission", {})[
                    "transmissionTexture"] = ref
            elif s == int(TextureSlot.CLEARCOAT):
                ext.setdefault("KHR_materials_clearcoat", {})[
                    "clearcoatTexture"] = ref
        if ext:
            spec["extensions"] = ext
        gltf_mats.append(spec)
        mat_index[mid] = len(gltf_mats) - 1
        return mat_index[mid]

    mesh_index: dict = {}

    def mesh_entry(mesh_id, material_ids) -> int:
        key = (mesh_id, tuple(material_ids))
        if key in mesh_index:
            return mesh_index[key]
        mesh = scene.asset(mesh_id)
        pos = accessor(mesh.positions.astype(np.float32), F32, "VEC3",
                       target=34962, minmax=True)
        nrm = accessor(mesh.normals.astype(np.float32), F32, "VEC3",
                       target=34962)
        uv = accessor(mesh.uvs.astype(np.float32), F32, "VEC2", target=34962)
        prims = []
        slots = np.asarray(mesh.material_slots)
        for slot in sorted(set(int(s) for s in slots)):
            idx = mesh.indices[slots == slot].astype(np.uint32).reshape(-1)
            ind = accessor(idx, U32, "SCALAR", target=34963)
            prim = dict(attributes=dict(POSITION=pos, NORMAL=nrm,
                                        TEXCOORD_0=uv), indices=ind)
            mid = (material_ids[slot] if slot < len(material_ids) else None)
            if mid is not None:
                prim["material"] = material(mid)
            prims.append(prim)
        gltf_meshes.append(dict(name=mesh.name, primitives=prims))
        mesh_index[key] = len(gltf_meshes) - 1
        return mesh_index[key]

    # nodes: flattened instances with world matrices (column-major in glTF)
    for inst in scene.get_instances():
        node = scene.node(inst.node_id)
        m = np.asarray(inst.transform, np.float32)
        nodes.append(dict(
            name=node.name,
            matrix=[float(x) for x in m.T.reshape(-1)],
            mesh=mesh_entry(node.mesh_id, inst.material_ids),
        ))
    for node_id, cam, m in scene.get_cameras():
        node = scene.node(node_id)
        gltf_cams.append(dict(
            type="perspective",
            perspective=dict(yfov=float(cam.y_fov), znear=0.01),
            name=node.name,
        ))
        nodes.append(dict(
            name=node.name,
            matrix=[float(x) for x in np.asarray(m, np.float32).T.reshape(-1)],
            camera=len(gltf_cams) - 1,
        ))

    doc = {
        "asset": {"version": "2.0", "generator": "platinum-tpu"},
        "scene": 0,
        "scenes": [{"nodes": list(range(len(nodes)))}],
        "nodes": nodes,
        "meshes": gltf_meshes,
        "accessors": accessors,
        "bufferViews": binbuf.views,
        "buffers": [{"byteLength": binbuf.offset}],
    }
    if gltf_mats:
        doc["materials"] = gltf_mats
    if gltf_cams:
        doc["cameras"] = gltf_cams
    if gltf_images:
        doc["images"] = gltf_images
        doc["textures"] = gltf_textures
    used_ext = sorted({k for m in gltf_mats
                       for k in m.get("extensions", {})})
    if used_ext:
        doc["extensionsUsed"] = used_ext

    js = json.dumps(doc, separators=(",", ":")).encode()
    js += b" " * ((-len(js)) % 4)
    bin_chunk = b"".join(binbuf.chunks)
    total = 12 + 8 + len(js) + 8 + len(bin_chunk)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, total))
        f.write(struct.pack("<II", len(js), 0x4E4F534A))
        f.write(js)
        f.write(struct.pack("<II", len(bin_chunk), 0x004E4942))
        f.write(bin_chunk)
    return path
