"""Copy of platinum_tpu/tools/foreign_glb.py, kept in step with it: platinum_tpu_torch
imports nothing of the JAX package.

Foreign-layout glTF 2.0 (.glb) writer — a loader stress harness.

`tools/gltf_export.py` writes the layout OUR pipeline prefers (planar
accessors, u32 indices, shared attribute accessors with per-slot index
subsets, matrix nodes). Real third-party exporters (Blender, assimp,
three.js, Sketchfab) make very different choices, and `io/gltf.py` must
survive files it didn't write (reference ingests arbitrary foreign files,
the Metal reference's src/loaders/gltf.cpp:27-110). This writer
deliberately
produces that foreign shape from any Scene:

- per-primitive COMPACTED vertex ranges (each material slot becomes its own
  primitive with a remapped index buffer — multi-primitive meshes)
- INTERLEAVED vertex attributes: one bufferView with byteStride 36
  (pos 12 + normal 12 + uv 8 + 4 pad bytes — a non-power-of-two stride),
  accessors sharing the view via byteOffset
- index component width minimized per primitive (u8 / u16 / u32)
- small primitives written NON-INDEXED (attributes expanded, no `indices`)
- node transforms as TRS with quaternion rotations (not matrices)
- textures embedded as PNGs with glTF channel order (G=roughness,
  B=metallic), encoded by io/png.py (filter 0; the JAX package encodes
  with PIL, so the PNG payloads, and the offsets after them, differ while
  the decoded texels and every other byte are the same)

No code is shared with the primary exporter, so a bug in one cannot hide
the same bug in the other; tests cross-check both paths against the source
scene.
"""

from __future__ import annotations

import json
import struct

import numpy as np

from platinum_tpu_torch.core.scene import Scene
from platinum_tpu_torch.io.png import encode_png

_F32, _U8, _U16, _U32 = 5126, 5121, 5123, 5125
_ARRAY, _ELEMENT = 34962, 34963
NONINDEXED_MAX_TRIS = 1024


def _mat_to_quat(m: np.ndarray) -> list[float]:
    """Rotation 3x3 -> glTF (x, y, z, w) unit quaternion (Shepperd)."""
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w, x, y, z = 0.25 * s, (m[2, 1] - m[1, 2]) / s, \
            (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        w, x, y, z = (m[2, 1] - m[1, 2]) / s, 0.25 * s, \
            (m[0, 1] + m[1, 0]) / s, (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        w, x, y, z = (m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s, \
            0.25 * s, (m[1, 2] + m[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        w, x, y, z = (m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s, \
            (m[1, 2] + m[2, 1]) / s, 0.25 * s
    q = np.array([x, y, z, w], np.float64)
    q /= np.linalg.norm(q)
    return [float(v) for v in q]


def _decompose(m4: np.ndarray):
    """World matrix -> (translation, quaternion, scale) TRS triplet."""
    t = [float(v) for v in m4[:3, 3]]
    lin = m4[:3, :3].astype(np.float64)
    scale = np.linalg.norm(lin, axis=0)
    scale[scale == 0] = 1.0
    rot = lin / scale[None, :]
    if np.linalg.det(rot) < 0:
        scale[0] *= -1
        rot = lin / scale[None, :]
    return t, _mat_to_quat(rot), [float(v) for v in scale]


class _Writer:
    def __init__(self, scene: Scene):
        self.scene = scene
        self.blob = bytearray()
        self.views: list[dict] = []
        self.accessors: list[dict] = []
        self.meshes: list[dict] = []
        self.materials: list[dict] = []
        self.images: list[dict] = []
        self.textures: list[dict] = []
        self.cameras: list[dict] = []
        self.nodes: list[dict] = []
        self._mesh_idx: dict = {}
        self._mat_idx: dict = {}
        self._tex_idx: dict = {}

    # -- binary chunk ------------------------------------------------------

    def _view(self, raw: bytes, target=None, stride=None) -> int:
        while len(self.blob) % 4:
            self.blob.append(0)
        v = dict(buffer=0, byteOffset=len(self.blob), byteLength=len(raw))
        if target:
            v["target"] = target
        if stride:
            v["byteStride"] = stride
        self.blob.extend(raw)
        self.views.append(v)
        return len(self.views) - 1

    def _accessor(self, view, ctype, count, type_str, offset=0,
                  minmax=None) -> int:
        a = dict(bufferView=view, componentType=ctype, count=count,
                 type=type_str)
        if offset:
            a["byteOffset"] = offset
        if minmax is not None:
            a["min"] = [float(x) for x in minmax[0]]
            a["max"] = [float(x) for x in minmax[1]]
        self.accessors.append(a)
        return len(self.accessors) - 1

    # -- geometry ----------------------------------------------------------

    def _interleaved_attrs(self, pos, nrm, uv) -> dict:
        n = len(pos)
        inter = np.zeros((n, 9), np.float32)  # 36-byte stride, last 4 pad
        inter[:, 0:3] = pos
        inter[:, 3:6] = nrm
        inter[:, 6:8] = uv
        view = self._view(inter.tobytes(), target=_ARRAY, stride=36)
        return {
            "POSITION": self._accessor(view, _F32, n, "VEC3", 0,
                                       (pos.min(0), pos.max(0))),
            "NORMAL": self._accessor(view, _F32, n, "VEC3", 12),
            "TEXCOORD_0": self._accessor(view, _F32, n, "VEC2", 24),
        }

    def _primitive(self, mesh, tri_mask, material: int | None) -> dict:
        tris = mesh.indices[tri_mask].astype(np.int64)
        used, remap = np.unique(tris.reshape(-1), return_inverse=True)
        pos = mesh.positions[used].astype(np.float32)
        nrm = mesh.normals[used].astype(np.float32)
        uv = mesh.uvs[used].astype(np.float32)
        new_idx = remap.astype(np.uint32)

        if len(tris) <= NONINDEXED_MAX_TRIS:
            # expand to non-indexed soup (exporters strip indices for
            # small fans; exercises io/gltf.py's index-generation path)
            order = new_idx.reshape(-1)
            prim_attrs = self._interleaved_attrs(pos[order], nrm[order],
                                                 uv[order])
            prim = dict(attributes=prim_attrs)
        else:
            prim_attrs = self._interleaved_attrs(pos, nrm, uv)
            if len(used) < 0x100:
                ind, ctype = new_idx.astype(np.uint8), _U8
            elif len(used) < 0x10000:
                ind, ctype = new_idx.astype(np.uint16), _U16
            else:
                ind, ctype = new_idx, _U32
            view = self._view(ind.tobytes(), target=_ELEMENT)
            prim = dict(
                attributes=prim_attrs,
                indices=self._accessor(view, ctype, ind.size, "SCALAR"),
            )
        if material is not None:
            prim["material"] = material
        return prim

    def _mesh(self, mesh_id, material_ids) -> int:
        key = (mesh_id, tuple(material_ids))
        if key in self._mesh_idx:
            return self._mesh_idx[key]
        mesh = self.scene.asset(mesh_id)
        slots = np.asarray(mesh.material_slots)
        prims = []
        for slot in sorted(set(int(s) for s in slots)):
            mid = material_ids[slot] if slot < len(material_ids) else None
            prims.append(self._primitive(
                mesh, slots == slot,
                None if mid is None else self._material(mid)))
        self.meshes.append(dict(name=mesh.name, primitives=prims))
        self._mesh_idx[key] = len(self.meshes) - 1
        return self._mesh_idx[key]

    # -- materials / textures ---------------------------------------------

    def _texture(self, tid, gltf_channels: str) -> int | None:
        tex = self.scene.asset(tid)
        if tex is None:
            return None
        key = (tid, gltf_channels)
        if key in self._tex_idx:
            return self._tex_idx[key]
        u8 = tex.as_u8_rgba()
        if u8 is not None:
            data = u8[0].copy()
        else:
            data = np.clip(tex.as_float_rgba() * 255.0 + 0.5,
                           0, 255).astype(np.uint8)
        if gltf_channels == "mr":  # glTF order: G=roughness, B=metallic
            out = np.zeros_like(data)
            out[..., 1] = data[..., 0]
            out[..., 2] = data[..., 1]
            out[..., 3] = 255
            data = out
        view = self._view(encode_png(data))
        self.images.append(dict(bufferView=view, mimeType="image/png",
                                name=tex.name))
        self.textures.append(dict(source=len(self.images) - 1))
        self._tex_idx[key] = len(self.textures) - 1
        return self._tex_idx[key]

    def _material(self, mid) -> int:
        if mid in self._mat_idx:
            return self._mat_idx[mid]
        from platinum_tpu_torch.core.material import TextureSlot

        m = self.scene.resolve_material(mid)
        pbr = {
            "baseColorFactor": [float(x) for x in m.base_color[:4]],
            "metallicFactor": float(m.metallic),
            "roughnessFactor": float(m.roughness),
        }
        spec: dict = {"name": m.name, "pbrMetallicRoughness": pbr}
        ext: dict = {}
        em = [float(x) for x in m.emission]
        peak = max(em) if em else 0.0
        if peak > 0:
            factor = [x / peak for x in em] if peak > 1.0 else em
            strength = float(m.emission_strength) * (
                peak if peak > 1.0 else 1.0)
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
        if getattr(m, "anisotropy", 0.0):
            ext["KHR_materials_anisotropy"] = {
                "anisotropyStrength": float(m.anisotropy),
                "anisotropyRotation": float(m.anisotropy_rotation)}
        if m.transmission > 0 and not m.thin_transmission:
            ext["KHR_materials_volume"] = {"thicknessFactor": 0.1}
        slot_map = {
            TextureSlot.BASE_COLOR: ("rgba", "baseColorTexture", pbr),
            TextureSlot.ROUGHNESS_METALLIC:
                ("mr", "metallicRoughnessTexture", pbr),
            TextureSlot.NORMAL: ("rgba", "normalTexture", spec),
            TextureSlot.EMISSION: ("rgba", "emissiveTexture", spec),
        }
        for slot, tid in m.textures.items():
            if slot not in slot_map:
                continue
            ch, field, container = slot_map[slot]
            ti = self._texture(tid, ch)
            if ti is not None:
                container[field] = {"index": ti}
        if ext:
            spec["extensions"] = ext
        self.materials.append(spec)
        self._mat_idx[mid] = len(self.materials) - 1
        return self._mat_idx[mid]

    # -- document ----------------------------------------------------------

    def write(self, path: str) -> str:
        scene = self.scene
        for inst in scene.get_instances():
            node = scene.node(inst.node_id)
            t, q, s = _decompose(np.asarray(inst.transform, np.float32))
            self.nodes.append(dict(
                name=node.name, translation=t, rotation=q, scale=s,
                mesh=self._mesh(node.mesh_id, inst.material_ids)))
        for node_id, cam, m in scene.get_cameras():
            node = scene.node(node_id)
            self.cameras.append(dict(
                type="perspective", name=node.name,
                perspective=dict(yfov=float(cam.y_fov), znear=0.01)))
            t, q, s = _decompose(np.asarray(m, np.float32))
            self.nodes.append(dict(name=node.name, translation=t,
                                   rotation=q, scale=s,
                                   camera=len(self.cameras) - 1))

        doc = {
            "asset": {"version": "2.0",
                      "generator": "platinum-tpu-foreign-writer"},
            "scene": 0,
            "scenes": [{"nodes": list(range(len(self.nodes)))}],
            "nodes": self.nodes,
            "meshes": self.meshes,
            "accessors": self.accessors,
            "bufferViews": self.views,
            "buffers": [{"byteLength": len(self.blob)}],
        }
        if self.materials:
            doc["materials"] = self.materials
        if self.cameras:
            doc["cameras"] = self.cameras
        if self.images:
            doc["images"] = self.images
            doc["textures"] = self.textures
        used_ext = sorted({k for m in self.materials
                           for k in m.get("extensions", {})})
        if used_ext:
            doc["extensionsUsed"] = used_ext

        js = json.dumps(doc, separators=(",", ":")).encode()
        js += b" " * ((-len(js)) % 4)
        raw = bytes(self.blob)
        raw += b"\x00" * ((-len(raw)) % 4)
        total = 12 + 8 + len(js) + 8 + len(raw)
        with open(path, "wb") as f:
            f.write(struct.pack("<III", 0x46546C67, 2, total))
            f.write(struct.pack("<II", len(js), 0x4E4F534A))
            f.write(js)
            f.write(struct.pack("<II", len(raw), 0x004E4942))
            f.write(raw)
        return path


def export_glb_foreign(scene: Scene, path: str) -> str:
    """Write `scene` to `path` in the deliberately-foreign layout described
    in the module docstring."""
    return _Writer(scene).write(path)
