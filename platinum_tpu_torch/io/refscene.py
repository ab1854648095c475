"""Copy of platinum_tpu/io/refscene.py, kept in step with it: platinum_tpu_torch
imports nothing of the JAX package.

Read-side importer for the reference app's native scene format.

The reference (teofum/platinum) saves scenes as a JSON file plus a
`<stem>_data.bin` sidecar holding raw GPU buffer bytes
(scene.cpp:536-627 write, :30-84 + :779-902 read). This module parses
that exact layout into a :class:`platinum_tpu_torch.core.scene.Scene`, so a
scene saved by the reference app loads directly into this framework
(VERDICT r4 missing #4 / next #9). platinum_tpu's own `.ptscene` format
(io/sceneio.py) remains the native round-trip format.

Layout facts derived from the reference source (cited per item):

* Top-level JSON: ``{"root": <node>, "assets": {"nextId", "assets": [...]},
  "envmap"?: {"texture": id, "aliasTable": [off, len]}}``
  (scene.cpp:602-624).
* Asset entry: ``{"id", "retain", "rc", "type": "texture"|"material"|
  "mesh", "data": {...}}`` (scene.cpp:682-717).
* Texture data: ``{"name", "alpha", "size": [w, h], "format": MTLPixelFormat
  int, "data": [offset, length]}``; raw texel rows, bytesPerRow =
  bytesPerPixel * width (scene.cpp:719-735, 790-817). Formats used by the
  app: RGBA32Float=125, RGBA8Unorm_sRGB=71, RGBA8Unorm=70, RG8Unorm=30,
  R8Unorm=10 (scene.cpp:8-19, loaders/texture.cpp:30-48).
* Material data: full parameter set + ``textures: [[slot, textureId],...]``
  (scene.cpp:757-787; slot order material.hpp:16-23 matches
  core.material.TextureSlot).
* Mesh data: ``{"indexCount", "vertexCount", "positions", "vertexData",
  "indices", "materials"}`` each ``[offset, length]`` into the sidecar
  (scene.cpp:763-777). Buffers are Metal simd layouts: positions are
  simd float3 (16 B stride); vertexData is ``{float3 normal; float4
  tangent; float2 texCoords}`` = 48 B stride with simd padding
  (mesh.hpp:17-21); indices u32; materials = per-TRIANGLE u32 slot index.
* Node: ``{"id", "name", "visible", "transform": {t, r, s, tgt, track},
  "children": [...], "mesh"?: {"id", "materials": [id|"default", ...]},
  "camera"?: {"f", "aperture", "sensor"}}`` (scene.cpp:629-679,
  json.hpp:30-38; euler rotation radians, transform.hpp:19-80).
* Envmap: texture asset id + the serialized alias-table buffer. The alias
  table is rebuilt here from the texture with core.environment's Vose
  builder instead of trusting foreign binary (semantically equivalent;
  environment.cpp:27-86 builds it the same way from per-pixel luma).
"""

from __future__ import annotations

import json
import os

import numpy as np

from platinum_tpu_torch.core.camera import Camera
from platinum_tpu_torch.core.material import Material, TextureSlot
from platinum_tpu_torch.core.mesh import Mesh
from platinum_tpu_torch.core.scene import Scene
from platinum_tpu_torch.core.texture import Texture, TextureFormat
from platinum_tpu_torch.core.transform import Transform

# MTLPixelFormat raw enum value -> (bytes/pixel, channels, our format)
_PIXEL_FORMATS = {
    125: (16, 4, TextureFormat.HDR),          # RGBA32Float
    71: (4, 4, TextureFormat.SRGB_RGBA),      # RGBA8Unorm_sRGB
    70: (4, 4, TextureFormat.LINEAR_RGBA),    # RGBA8Unorm
    30: (2, 2, TextureFormat.ROUGH_METAL),    # RG8Unorm
    10: (1, 1, TextureFormat.MONO),           # R8Unorm
}


def is_reference_scene(path: str) -> bool:
    """Heuristic: a reference-format file has top-level "root" + "assets"
    with the assets/nextId shape (vs .ptscene's own schema)."""
    try:
        with open(path) as f:
            doc = json.load(f)
        return (isinstance(doc.get("assets"), dict)
                and "nextId" in doc["assets"]
                and "root" in doc)
    except Exception:
        return False


def _read(blob: bytes, rec, dtype, count) -> np.ndarray:
    off, length = int(rec[0]), int(rec[1])
    arr = np.frombuffer(blob[off:off + length], dtype=dtype)
    if count is not None and len(arr) < count:
        raise ValueError(f"sidecar truncated: need {count}, got {len(arr)}")
    return arr


def _texture_from(data: dict, blob: bytes) -> Texture:
    w, h = int(data["size"][0]), int(data["size"][1])
    fmt = int(data["format"])
    if fmt not in _PIXEL_FORMATS:
        raise ValueError(f"unsupported MTLPixelFormat {fmt}")
    bpp, channels, our_fmt = _PIXEL_FORMATS[fmt]
    raw = _read(blob, data["data"], np.uint8, w * h * bpp)[: w * h * bpp]
    if our_fmt == TextureFormat.HDR:
        px = raw.view(np.float32).reshape(h, w, 4)
    else:
        px = raw.reshape(h, w, channels)
    return Texture(data=np.ascontiguousarray(px), format=our_fmt,
                   name=str(data.get("name", "texture")),
                   has_alpha=bool(data.get("alpha", False)))


def _material_from(data: dict) -> Material:
    bc = data["baseColor"]
    em = data["emission"]
    return Material(
        name=str(data.get("name", "material")),
        base_color=(float(bc[0]), float(bc[1]), float(bc[2]),
                    float(bc[3]) if len(bc) > 3 else 1.0),
        emission=(float(em[0]), float(em[1]), float(em[2])),
        emission_strength=float(data["emissionStrength"]),
        roughness=float(data["roughness"]),
        metallic=float(data["metallic"]),
        transmission=float(data["transmission"]),
        ior=float(data["ior"]),
        anisotropy=float(data["aniso"]),
        anisotropy_rotation=float(data["anisoRotation"]),
        clearcoat=float(data["clearcoat"]),
        clearcoat_roughness=float(data["clearcoatRoughness"]),
        thin_transmission=bool(data["thinTransmission"]),
        # slots filled by the caller once texture ids are remapped
        textures={},
    )


def _mesh_from(data: dict, blob: bytes) -> Mesh:
    vc = int(data["vertexCount"])
    ic = int(data["indexCount"])
    tc = ic // 3

    pos_rec = data["positions"]
    pos_stride = int(pos_rec[1]) // max(vc, 1)
    raw = _read(blob, pos_rec, np.float32, None)
    if pos_stride == 16:          # simd float3: 4 floats, w is padding
        positions = raw.reshape(vc, 4)[:, :3]
    elif pos_stride == 12:
        positions = raw.reshape(vc, 3)
    else:
        raise ValueError(f"unexpected positions stride {pos_stride}")

    vd_rec = data["vertexData"]
    vd_stride = int(vd_rec[1]) // max(vc, 1)
    raw = _read(blob, vd_rec, np.float32, None)
    if vd_stride == 48:           # simd: normal f3(16B), tangent f4, uv f2+pad
        vd = raw.reshape(vc, 12)
        normals = vd[:, 0:3]
        tangents = vd[:, 4:8]
        uvs = vd[:, 8:10]
    elif vd_stride == 40:         # tightly packed variant
        vd = raw.reshape(vc, 10)
        normals = vd[:, 0:3]
        tangents = vd[:, 4:8]
        uvs = vd[:, 8:10]
    else:
        raise ValueError(f"unexpected vertexData stride {vd_stride}")

    indices = _read(blob, data["indices"], np.uint32, ic)[:ic].reshape(tc, 3)
    slots = _read(blob, data["materials"], np.uint32, tc)[:tc]
    return Mesh(positions=np.ascontiguousarray(positions),
                indices=np.ascontiguousarray(indices),
                normals=np.ascontiguousarray(normals),
                tangents=np.ascontiguousarray(tangents),
                uvs=np.ascontiguousarray(uvs),
                material_slots=np.ascontiguousarray(slots))


def load_reference_scene(scene: Scene, path: str) -> None:
    """Load a reference-app scene file (JSON + `<stem>_data.bin`) into
    `scene`. Node hierarchy lands under the scene root; asset ids are
    remapped to this scene's id space."""
    with open(path) as f:
        doc = json.load(f)
    stem = os.path.splitext(os.path.basename(path))[0]
    bin_path = os.path.join(os.path.dirname(path) or ".",
                            f"{stem}_data.bin")
    with open(bin_path, "rb") as f:
        blob = f.read()

    # --- assets (two passes: textures/meshes first, then materials so
    # their texture-slot references can be remapped) -------------------
    idmap: dict[int, int] = {}
    materials_pending = []
    for entry in doc["assets"]["assets"]:
        rid = int(entry["id"])
        data = entry["data"]
        kind = entry["type"]
        if kind == "texture":
            ours = scene.add_asset(_texture_from(data, blob),
                                   name=data.get("name"),
                                   retained=bool(entry.get("retain", False)))
            idmap[rid] = ours
        elif kind == "mesh":
            ours = scene.add_asset(_mesh_from(data, blob),
                                   retained=bool(entry.get("retain", False)))
            idmap[rid] = ours
        elif kind == "material":
            materials_pending.append((rid, entry, data))
        else:
            raise ValueError(f"unknown asset type {kind!r}")
    for rid, entry, data in materials_pending:
        mat = _material_from(data)
        for slot, tex_rid in data.get("textures", []):
            tex = idmap.get(int(tex_rid))
            if tex is not None:
                mat.textures[TextureSlot(int(slot))] = tex
        idmap[rid] = scene.add_asset(
            mat, name=mat.name, retained=bool(entry.get("retain", False)))

    # --- node hierarchy ------------------------------------------------
    def build(node_json: dict, parent: int | None):
        if parent is None:
            nid = Scene.ROOT
            node = scene.node(nid)
            # the file root's name/transform apply to our root
            node.name = str(node_json.get("name", node.name))
        else:
            node = scene.create_node(str(node_json.get("name", "node")),
                                     parent=parent)
            nid = node.id
        node.visible = bool(node_json.get("visible", True))
        t = node_json["transform"]
        node.transform = Transform(
            translation=np.asarray(t["t"], np.float32),
            rotation=np.asarray(t["r"], np.float32),
            scale=np.asarray(t["s"], np.float32),
            target=np.asarray(t["tgt"], np.float32),
            track=bool(t["track"]),
        )
        if "mesh" in node_json:
            m = node_json["mesh"]
            scene.set_mesh(nid, idmap[int(m["id"])])
            for i, mid in enumerate(m.get("materials", [])):
                if mid != "default":
                    scene.set_material(nid, i, idmap[int(mid)])
        if "camera" in node_json:
            c = node_json["camera"]
            node.camera = Camera.with_focal_length(
                float(c["f"]),
                sensor_size=(float(c["sensor"][0]), float(c["sensor"][1])),
                aperture=float(c["aperture"]),
            )
        for child in node_json.get("children", []):
            build(child, nid)

    build(doc["root"], None)

    # --- environment ---------------------------------------------------
    env = doc.get("envmap")
    if env is not None:
        tid = idmap.get(int(env["texture"]))
        if tid is not None:
            tex = scene.asset(tid)
            scene.retain_asset(tid)
            scene.environment.set_texture(
                tid, tex.as_float_rgba()[:, :, :3])
