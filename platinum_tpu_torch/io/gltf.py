"""Copy of platinum_tpu/io/gltf.py, kept in step with it: platinum_tpu_torch
imports nothing of the JAX package.

glTF 2.0 importer (pure Python + numpy).

Capability parity with the Metal reference's src/loaders/gltf.{hpp,cpp}
(fastgltf-based): .gltf and .glb containers, external buffers and data
URIs, meshes with per-primitive material slots (primitives concatenated
into one Mesh like gltf.cpp:115-248), index generation for non-indexed
primitives, tangent generation when absent, perspective cameras, full node
hierarchy with TRS or decomposed matrices, and the material extension set
the reference enables (gltf.cpp:39-44):

  KHR_materials_emissive_strength, KHR_materials_transmission,
  KHR_materials_ior, KHR_materials_anisotropy, KHR_materials_clearcoat,
  KHR_materials_volume (presence ⇒ thick transmission; absence ⇒ thin).

Textures are decoded by io/png.py (replacing stb_image; the JAX package
decodes with PIL): PNGs by its own codec, any other image through Pillow,
which raises naming the image where Pillow is missing. They are converted
to the canonical formats of core/texture.py (replacing the reference's
GPU convertTexture kernel, texture_converter.metal:10-29).
"""

from __future__ import annotations

import base64
import io as _io
import json
import os
import struct

import numpy as np

from platinum_tpu_torch.core.camera import Camera
from platinum_tpu_torch.core.material import Material, TextureSlot
from platinum_tpu_torch.core.mesh import Mesh
from platinum_tpu_torch.core.scene import Scene
from platinum_tpu_torch.core.texture import Texture, TextureFormat
from platinum_tpu_torch.core.transform import Transform
from platinum_tpu_torch.io.png import decode_image

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNTS = {
    "SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
    "MAT2": 4, "MAT3": 9, "MAT4": 16,
}


class GltfError(RuntimeError):
    pass


def _matrix_to_trs(m: np.ndarray):
    """Decompose a glTF column-major 4x4 into translation/rotation(euler)/
    scale (reference decomposes node matrices too, gltf.cpp:47)."""
    t = m[:3, 3].copy()
    lin = m[:3, :3]
    scale = np.linalg.norm(lin, axis=0)
    scale[scale == 0] = 1.0
    rot = lin / scale[None, :]
    if np.linalg.det(rot) < 0:
        scale[0] *= -1
        rot = lin / scale[None, :]
    # Euler for composition T·Ry·Rx·Rz (matching Transform.matrix):
    # R = Ry(y)·Rx(x)·Rz(z)
    sx = -rot[1, 2]
    x = np.arcsin(np.clip(sx, -1, 1))
    if abs(sx) < 0.9999:
        y = np.arctan2(rot[0, 2], rot[2, 2])
        z = np.arctan2(rot[1, 0], rot[1, 1])
    else:
        y = np.arctan2(-rot[2, 0], rot[0, 0])
        z = 0.0
    return t, np.array([x, y, z], np.float32), scale.astype(np.float32)


def _quat_to_euler(q):
    """glTF (x, y, z, w) quaternion → Euler angles for R = Ry·Rx·Rz."""
    x, y, z, w = q
    m = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])
    full = np.eye(4, dtype=np.float32)
    full[:3, :3] = m
    _, euler, _ = _matrix_to_trs(full)
    return euler


class GltfLoader:
    def __init__(self, path: str):
        self.path = path
        self.base_dir = os.path.dirname(os.path.abspath(path))
        self._glb_bin = None
        with open(path, "rb") as fh:
            head = fh.read(4)
            fh.seek(0)
            if head == b"glTF":
                self.doc = self._parse_glb(fh.read())
            else:
                self.doc = json.load(_io.TextIOWrapper(fh, encoding="utf-8"))
        self._buffers: dict = {}
        self._texture_assets: dict = {}  # (image_idx, format) → asset id

    def _parse_glb(self, blob: bytes) -> dict:
        magic, version, _length = struct.unpack_from("<III", blob, 0)
        if magic != 0x46546C67:
            raise GltfError("bad GLB magic")
        off = 12
        doc = None
        while off < len(blob):
            clen, ctype = struct.unpack_from("<II", blob, off)
            off += 8
            data = blob[off : off + clen]
            off += clen
            if ctype == 0x4E4F534A:  # JSON
                doc = json.loads(data.decode("utf-8"))
            elif ctype == 0x004E4942:  # BIN
                self._glb_bin = data
        if doc is None:
            raise GltfError("GLB missing JSON chunk")
        return doc

    # ------------------------------------------------------------------
    # Buffers / accessors
    # ------------------------------------------------------------------

    def _buffer(self, idx: int) -> bytes:
        if idx not in self._buffers:
            spec = self.doc["buffers"][idx]
            uri = spec.get("uri")
            if uri is None:
                data = self._glb_bin
            elif uri.startswith("data:"):
                data = base64.b64decode(uri.split(",", 1)[1])
            else:
                from urllib.parse import unquote

                with open(os.path.join(self.base_dir, unquote(uri)), "rb") as fh:
                    data = fh.read()
            self._buffers[idx] = data
        return self._buffers[idx]

    def _buffer_view(self, idx: int) -> tuple:
        bv = self.doc["bufferViews"][idx]
        data = self._buffer(bv["buffer"])
        off = bv.get("byteOffset", 0)
        return data[off : off + bv["byteLength"]], bv.get("byteStride")

    def accessor(self, idx: int) -> np.ndarray:
        """Decode an accessor to float32/uint32 numpy (normalized ints are
        scaled to [0,1] / [-1,1])."""
        acc = self.doc["accessors"][idx]
        count = acc["count"]
        n_comp = _TYPE_COUNTS[acc["type"]]
        dtype = _COMPONENT_DTYPES[acc["componentType"]]
        item = np.dtype(dtype).itemsize * n_comp

        if "bufferView" in acc:
            raw, stride = self._buffer_view(acc["bufferView"])
            off = acc.get("byteOffset", 0)
            if stride and stride != item:
                rows = np.frombuffer(raw, np.uint8)
                idxs = off + np.arange(count)[:, None] * stride + np.arange(item)[None, :]
                out = rows[idxs].tobytes()
                arr = np.frombuffer(out, dtype).reshape(count, n_comp)
            else:
                arr = np.frombuffer(
                    raw, dtype, count * n_comp, off
                ).reshape(count, n_comp)
        else:
            arr = np.zeros((count, n_comp), dtype)

        if "sparse" in acc:
            sp = acc["sparse"]
            n = sp["count"]
            iv = sp["indices"]
            raw_i, _ = self._buffer_view(iv["bufferView"])
            itype = _COMPONENT_DTYPES[iv["componentType"]]
            sp_idx = np.frombuffer(raw_i, itype, n, iv.get("byteOffset", 0))
            rv = sp["values"]
            raw_v, _ = self._buffer_view(rv["bufferView"])
            sp_val = np.frombuffer(
                raw_v, dtype, n * n_comp, rv.get("byteOffset", 0)
            ).reshape(n, n_comp)
            arr = arr.copy()
            arr[sp_idx] = sp_val

        if acc["componentType"] == 5126:
            out = arr.astype(np.float32)
        elif acc.get("normalized"):
            info = np.iinfo(dtype)
            if info.min < 0:
                out = np.maximum(arr.astype(np.float32) / info.max, -1.0)
            else:
                out = arr.astype(np.float32) / info.max
        elif dtype in (np.uint8, np.uint16, np.uint32):
            out = arr.astype(np.uint32)
        else:
            out = arr.astype(np.int32)
        return out if n_comp > 1 else out[:, 0]

    # ------------------------------------------------------------------
    # Images / textures
    # ------------------------------------------------------------------

    def _image_bytes(self, image_idx: int) -> bytes:
        img = self.doc["images"][image_idx]
        if "bufferView" in img:
            raw, _ = self._buffer_view(img["bufferView"])
            return bytes(raw)
        uri = img["uri"]
        if uri.startswith("data:"):
            return base64.b64decode(uri.split(",", 1)[1])
        from urllib.parse import unquote

        with open(os.path.join(self.base_dir, unquote(uri)), "rb") as fh:
            return fh.read()

    def _load_texture(self, scene: Scene, tex_info, fmt: TextureFormat):
        """Decode + convert a glTF texture reference → scene Texture asset.
        Channel remaps mirror the reference's convertTexture formats."""
        if tex_info is None:
            return None
        tex_idx = tex_info["index"] if isinstance(tex_info, dict) else tex_info
        tex = self.doc["textures"][tex_idx]
        image_idx = tex.get("source")
        if image_idx is None:
            return None
        key = (image_idx, fmt)
        if key in self._texture_assets:
            return self._texture_assets[key]

        name = self.doc["images"][image_idx].get("name", f"image_{image_idx}")
        arr = decode_image(self._image_bytes(image_idx), name)

        if fmt == TextureFormat.ROUGH_METAL:
            # glTF metallicRoughness: G = roughness, B = metallic
            data = np.stack([arr[:, :, 1], arr[:, :, 2]], axis=-1)
        elif fmt == TextureFormat.MONO:
            data = arr[:, :, 0]
        else:
            data = arr

        texture = Texture(data=data, format=fmt, name=name)
        asset_id = scene.add_asset(texture)
        self._texture_assets[key] = asset_id
        return asset_id

    # ------------------------------------------------------------------
    # Materials
    # ------------------------------------------------------------------

    def _load_material(self, scene: Scene, idx: int) -> int:
        spec = self.doc["materials"][idx]
        pbr = spec.get("pbrMetallicRoughness", {})
        ext = spec.get("extensions", {})

        base = pbr.get("baseColorFactor", [1, 1, 1, 1])
        emissive = spec.get("emissiveFactor", [0, 0, 0])
        strength = ext.get("KHR_materials_emissive_strength", {}).get(
            "emissiveStrength", 1.0
        )
        transmission = ext.get("KHR_materials_transmission", {}).get(
            "transmissionFactor", 0.0
        )
        ior = ext.get("KHR_materials_ior", {}).get("ior", 1.5)
        aniso_ext = ext.get("KHR_materials_anisotropy", {})
        coat_ext = ext.get("KHR_materials_clearcoat", {})
        has_volume = "KHR_materials_volume" in ext

        mat = Material(
            name=spec.get("name", f"material_{idx}"),
            base_color=tuple(base),
            emission=tuple(emissive),
            emission_strength=float(strength),
            roughness=float(pbr.get("roughnessFactor", 1.0)),
            metallic=float(pbr.get("metallicFactor", 1.0)),
            transmission=float(transmission),
            ior=float(ior),
            anisotropy=float(aniso_ext.get("anisotropyStrength", 0.0)),
            anisotropy_rotation=float(aniso_ext.get("anisotropyRotation", 0.0)),
            clearcoat=float(coat_ext.get("clearcoatFactor", 0.0)),
            clearcoat_roughness=float(coat_ext.get("clearcoatRoughnessFactor", 0.0)),
            thin_transmission=transmission > 0.0 and not has_volume,
        )

        tex_specs = [
            (TextureSlot.BASE_COLOR, pbr.get("baseColorTexture"), TextureFormat.SRGB_RGBA),
            (TextureSlot.ROUGHNESS_METALLIC, pbr.get("metallicRoughnessTexture"), TextureFormat.ROUGH_METAL),
            (TextureSlot.EMISSION, spec.get("emissiveTexture"), TextureFormat.SRGB_RGBA),
            (TextureSlot.NORMAL, spec.get("normalTexture"), TextureFormat.LINEAR_RGBA),
            (TextureSlot.TRANSMISSION,
             ext.get("KHR_materials_transmission", {}).get("transmissionTexture"),
             TextureFormat.MONO),
            (TextureSlot.CLEARCOAT, coat_ext.get("clearcoatTexture"), TextureFormat.MONO),
        ]
        for slot, info, fmt in tex_specs:
            tid = self._load_texture(scene, info, fmt)
            if tid is not None:
                mat.textures[slot] = tid
                scene.retain_asset(tid)

        return scene.add_asset(mat)

    # ------------------------------------------------------------------
    # Meshes
    # ------------------------------------------------------------------

    def _load_mesh(self, scene: Scene, idx: int) -> tuple:
        """Concatenate the mesh's primitives into one Mesh; returns
        (asset_id, [material asset id per slot])."""
        spec = self.doc["meshes"][idx]
        positions, normals, tangents, uvs, indices, slots = [], [], [], [], [], []
        slot_materials = []
        v_off = 0
        any_normals = any_tangents = any_uvs = False

        prims = [p for p in spec.get("primitives", []) if p.get("mode", 4) == 4]
        for prim in prims:
            attrs = prim["attributes"]
            pos = self.accessor(attrs["POSITION"]).reshape(-1, 3)
            n_v = len(pos)
            nrm = (self.accessor(attrs["NORMAL"]).reshape(-1, 3)
                   if "NORMAL" in attrs else None)
            tan = (self.accessor(attrs["TANGENT"]).reshape(-1, 4)
                   if "TANGENT" in attrs else None)
            uv = (self.accessor(attrs["TEXCOORD_0"]).reshape(-1, 2)
                  if "TEXCOORD_0" in attrs else None)
            if "indices" in prim:
                ind = np.asarray(self.accessor(prim["indices"]), np.uint32).reshape(-1, 3)
            else:
                ind = np.arange(n_v, dtype=np.uint32).reshape(-1, 3)

            positions.append(pos)
            normals.append(nrm if nrm is not None else np.zeros((n_v, 3), np.float32))
            any_normals |= nrm is not None
            tangents.append(tan if tan is not None else np.zeros((n_v, 4), np.float32))
            any_tangents |= tan is not None
            uvs.append(uv if uv is not None else np.zeros((n_v, 2), np.float32))
            any_uvs |= uv is not None

            indices.append(ind.astype(np.int64) + v_off)
            slot = len(slot_materials)
            slot_materials.append(prim.get("material"))
            slots.append(np.full(len(ind), slot, np.uint32))
            v_off += n_v

        if not positions:
            return None, []

        mesh = Mesh(
            positions=np.concatenate(positions),
            indices=np.concatenate(indices).astype(np.uint32),
            normals=np.concatenate(normals) if any_normals else None,
            tangents=np.concatenate(tangents) if any_tangents else None,
            uvs=np.concatenate(uvs) if any_uvs else None,
            material_slots=np.concatenate(slots),
            name=spec.get("name", f"mesh_{idx}"),
        )
        return scene.add_asset(mesh), slot_materials

    # ------------------------------------------------------------------
    # Scene graph
    # ------------------------------------------------------------------

    def load(self, scene: Scene, parent: int | None = None) -> list:
        """Import into `scene` under `parent` (default root). Returns the
        created top-level node ids."""
        doc = self.doc
        mat_assets = {}

        def material_asset(i):
            if i is None:
                return None
            if i not in mat_assets:
                mat_assets[i] = self._load_material(scene, i)
            return mat_assets[i]

        mesh_assets = {}

        def mesh_asset(i):
            if i not in mesh_assets:
                mesh_assets[i] = self._load_mesh(scene, i)
            return mesh_assets[i]

        def load_node(node_idx: int, parent_id: int) -> int:
            spec = doc["nodes"][node_idx]
            node = scene.create_node(spec.get("name", f"node_{node_idx}"), parent_id)

            if "matrix" in spec:
                m = np.asarray(spec["matrix"], np.float32).reshape(4, 4).T
                t, r, s = _matrix_to_trs(m)
                node.transform = Transform(t, r, s)
            else:
                t = np.asarray(spec.get("translation", [0, 0, 0]), np.float32)
                s = np.asarray(spec.get("scale", [1, 1, 1]), np.float32)
                q = spec.get("rotation", [0, 0, 0, 1])
                node.transform = Transform(t, _quat_to_euler(q), s)

            if "mesh" in spec:
                mesh_id, slot_mats = mesh_asset(spec["mesh"])
                if mesh_id is not None:
                    scene.set_mesh(node.id, mesh_id)
                    for slot, mat_idx in enumerate(slot_mats):
                        aid = material_asset(mat_idx)
                        if aid is not None:
                            scene.set_material(node.id, slot, aid)

            if "camera" in spec:
                cam = doc["cameras"][spec["camera"]]
                if cam.get("type") == "perspective":
                    p = cam.get("perspective", {})
                    node.camera = Camera.with_fov(p.get("yfov", 0.8))

            for child in spec.get("children", []):
                load_node(child, node.id)
            return node.id

        parent = scene.ROOT if parent is None else parent
        scene_spec = doc.get("scenes", [{}])[doc.get("scene", 0)]
        return [load_node(i, parent) for i in scene_spec.get("nodes", [])]


def load_gltf(scene: Scene, path: str, parent: int | None = None) -> list:
    """Import a .gltf/.glb file into the scene; returns top-level node ids."""
    return GltfLoader(path).load(scene, parent)
