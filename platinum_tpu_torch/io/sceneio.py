"""Copy of platinum_tpu/io/sceneio.py, kept in step with it: platinum_tpu_torch
imports nothing of the JAX package.

Scene persistence: JSON structure + binary sidecar.

Capability parity with the reference's save/load (scene.cpp:536-627 write,
:30-84/:779-902 read): the scene graph, refcounted assets and environment are
serialized to a renderer-agnostic JSON file (.ptscene) with bulk data (mesh
buffers, texture bytes) in a sidecar `<name>_data.bin`, referenced by
offset/length/dtype/shape records. Round-trips preserve node hierarchy,
transforms, cameras, material parameters + texture slots, asset retain flags
and the environment (its alias table is rebuilt on load).
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

FORMAT_VERSION = 1


class _BlobWriter:
    def __init__(self):
        self.chunks = []
        self.offset = 0

    def add(self, arr: np.ndarray) -> dict:
        arr = np.ascontiguousarray(arr)
        rec = {
            "offset": self.offset,
            "length": arr.nbytes,
            "dtype": str(arr.dtype),
            "shape": list(arr.shape),
        }
        self.chunks.append(arr.tobytes())
        self.offset += arr.nbytes
        return rec


def _read_blob(blob: bytes, rec: dict) -> np.ndarray:
    arr = np.frombuffer(
        blob, np.dtype(rec["dtype"]), count=int(np.prod(rec["shape"])) or 0,
        offset=rec["offset"],
    )
    return arr.reshape(rec["shape"]).copy()


def _transform_json(t: Transform) -> dict:
    return {
        "translation": t.translation.tolist(),
        "rotation": t.rotation.tolist(),
        "scale": t.scale.tolist(),
        "target": t.target.tolist(),
        "track": bool(t.track),
    }


def _transform_from(d: dict) -> Transform:
    return Transform(
        d["translation"], d["rotation"], d["scale"], d["target"], d["track"]
    )


def _camera_json(c: Camera) -> dict:
    return {
        "sensor_size": list(c.sensor_size),
        "focal_length": c.focal_length,
        "aperture": c.aperture,
        "aperture_blades": c.aperture_blades,
        "roundness": c.roundness,
        "bokeh_power": c.bokeh_power,
        "focus_distance": c.focus_distance,
    }


def _camera_from(d: dict) -> Camera:
    return Camera(
        sensor_size=tuple(d["sensor_size"]),
        focal_length=d["focal_length"],
        aperture=d["aperture"],
        aperture_blades=d["aperture_blades"],
        roundness=d["roundness"],
        bokeh_power=d["bokeh_power"],
        focus_distance=d["focus_distance"],
    )


def _material_json(m: Material) -> dict:
    return {
        "name": m.name,
        "base_color": list(m.base_color),
        "emission": list(m.emission),
        "emission_strength": m.emission_strength,
        "roughness": m.roughness,
        "metallic": m.metallic,
        "transmission": m.transmission,
        "ior": m.ior,
        "anisotropy": m.anisotropy,
        "anisotropy_rotation": m.anisotropy_rotation,
        "clearcoat": m.clearcoat,
        "clearcoat_roughness": m.clearcoat_roughness,
        "thin_transmission": m.thin_transmission,
        "textures": {str(int(k)): v for k, v in m.textures.items()},
    }


def _material_from(d: dict) -> Material:
    return Material(
        name=d["name"],
        base_color=tuple(d["base_color"]),
        emission=tuple(d["emission"]),
        emission_strength=d["emission_strength"],
        roughness=d["roughness"],
        metallic=d["metallic"],
        transmission=d["transmission"],
        ior=d["ior"],
        anisotropy=d["anisotropy"],
        anisotropy_rotation=d["anisotropy_rotation"],
        clearcoat=d["clearcoat"],
        clearcoat_roughness=d["clearcoat_roughness"],
        thin_transmission=d["thin_transmission"],
        textures={TextureSlot(int(k)): v for k, v in d["textures"].items()},
    )


def save_scene(scene: Scene, path: str):
    blob = _BlobWriter()
    assets_json = []
    for aid, data, name, refcount, retained in scene.all_assets():
        rec = {"id": aid, "name": name, "retained": retained}
        if isinstance(data, Mesh):
            rec["type"] = "mesh"
            rec["buffers"] = {
                "positions": blob.add(data.positions),
                "normals": blob.add(data.normals),
                "tangents": blob.add(data.tangents),
                "uvs": blob.add(data.uvs),
                "indices": blob.add(data.indices),
                "material_slots": blob.add(data.material_slots),
            }
        elif isinstance(data, Material):
            rec["type"] = "material"
            rec["material"] = _material_json(data)
        elif isinstance(data, Texture):
            rec["type"] = "texture"
            rec["format"] = data.format.value
            rec["has_alpha"] = data.has_alpha
            rec["data"] = blob.add(data.data)
        else:
            continue
        assets_json.append(rec)

    nodes_json = []
    for nid in sorted(scene._nodes):
        node = scene.node(nid)
        nodes_json.append({
            "id": node.id,
            "name": node.name,
            "parent": node.parent,
            "children": list(node.children),
            "transform": _transform_json(node.transform),
            "visible": node.visible,
            "mesh": node.mesh_id,
            "materials": list(node.material_ids),
            "camera": _camera_json(node.camera) if node.camera else None,
        })

    doc = {
        "version": FORMAT_VERSION,
        "nodes": nodes_json,
        "assets": assets_json,
        "environment": {
            "texture": scene.environment.texture_id,
            "constant_color": list(scene.environment.constant_color),
            "strength": scene.environment.strength,
        },
        "default_material": _material_json(scene.default_material),
    }

    bin_path = os.path.splitext(path)[0] + "_data.bin"
    doc["binary"] = os.path.basename(bin_path)
    with open(bin_path, "wb") as fh:
        for chunk in blob.chunks:
            fh.write(chunk)
    with open(path, "w") as fh:
        json.dump(doc, fh)


def load_scene(path: str) -> Scene:
    with open(path) as fh:
        doc = json.load(fh)
    if doc.get("version") != FORMAT_VERSION:
        raise ValueError(f"unsupported scene version {doc.get('version')}")
    bin_path = os.path.join(os.path.dirname(os.path.abspath(path)), doc["binary"])
    with open(bin_path, "rb") as fh:
        blob = fh.read()

    scene = Scene()
    scene.default_material = _material_from(doc["default_material"])

    # Assets first (ids preserved)
    id_remap = {}
    for rec in doc["assets"]:
        if rec["type"] == "mesh":
            b = rec["buffers"]
            data = Mesh(
                positions=_read_blob(blob, b["positions"]),
                indices=_read_blob(blob, b["indices"]),
                normals=_read_blob(blob, b["normals"]),
                tangents=_read_blob(blob, b["tangents"]),
                uvs=_read_blob(blob, b["uvs"]),
                material_slots=_read_blob(blob, b["material_slots"]),
                name=rec["name"],
            )
        elif rec["type"] == "material":
            data = _material_from(rec["material"])
        elif rec["type"] == "texture":
            data = Texture(
                data=_read_blob(blob, rec["data"]),
                format=TextureFormat(rec["format"]),
                name=rec["name"],
                has_alpha=rec["has_alpha"],
            )
        else:
            continue
        new_id = scene.add_asset(data, rec["name"], retained=rec["retained"])
        id_remap[rec["id"]] = new_id

    # Fix texture references inside materials
    for _aid, mat in scene.assets_of_type(Material):
        mat.textures = {
            slot: id_remap[tid] for slot, tid in mat.textures.items()
            if tid in id_remap
        }
        for tid in mat.textures.values():
            scene.retain_asset(tid)

    # Nodes (two passes: create in stored order, then attach data)
    node_remap = {0: scene.ROOT}
    by_id = {n["id"]: n for n in doc["nodes"]}

    def create(nid):
        if nid in node_remap:
            return node_remap[nid]
        rec = by_id[nid]
        parent = create(rec["parent"]) if rec["parent"] is not None else scene.ROOT
        node = scene.create_node(rec["name"], parent)
        node_remap[nid] = node.id
        return node.id

    for rec in doc["nodes"]:
        if rec["id"] == 0:
            continue
        create(rec["id"])

    for rec in doc["nodes"]:
        node = scene.node(node_remap[rec["id"]])
        node.transform = _transform_from(rec["transform"])
        node.visible = rec["visible"]
        if rec["camera"]:
            node.camera = _camera_from(rec["camera"])
        if rec["mesh"] is not None and rec["mesh"] in id_remap:
            scene.set_mesh(node.id, id_remap[rec["mesh"]])
            for slot, mid in enumerate(rec["materials"]):
                if mid is not None and mid in id_remap:
                    scene.set_material(node.id, slot, id_remap[mid])

    env = doc["environment"]
    scene.environment.constant_color = tuple(env["constant_color"])
    scene.environment.strength = env["strength"]
    if env["texture"] is not None and env["texture"] in id_remap:
        tex = scene.asset(id_remap[env["texture"]])
        scene.environment.set_texture(
            id_remap[env["texture"]], tex.as_float_rgba()[..., :3]
        )
    return scene
