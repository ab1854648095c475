"""Frozen scene generators: plain numpy arrays, no package of the program.

`colonnade` is a copy of `make_colonnade_scene` in
platinum_tpu_torch/app/scenes.py (with the plane, cube and UV-sphere
functions of platinum_tpu_torch/core/primitives.py), frozen here so that a
later change to the program's copy cannot move the yardstick. It returns
the scene as arrays: the benchmark builds the program's Scene from them
(harness.py) and the plain reference reads the same arrays
(reference/pathtracer.py).

A configuration file names its generator (`"scene": {"generator": name,
**parameters}`). `make` looks the name up in GENERATORS first; any other
name is the file generators/<name>.py, loaded by path, whose
`make(**parameters)` returns the arrays. Such a file is frozen like
`colonnade` and imports only numpy and this module's primitives.

The arrays of a scene:
- "meshes": {name: {"positions", "normals", "tangents", "uvs", "indices"}};
- "materials": {name: keyword dict of the program's Material}; its
  optional "textures" is {slot: texture name}, the slot a TextureSlot
  name in lower case ("base_color", "roughness_metallic", "transmission",
  "clearcoat", "emission", "normal"), and every other key goes to
  Material as it is (clearcoat, anisotropy, transmission, ...);
- "instances": (name, mesh, material, translation, rotation, scale) in
  creation order;
- "camera": position, target, focal_length, sensor_size, focus_distance;
- "textures" (optional): {name: {"data": ndarray (H, W[, C]), uint8 or
  float32, "format": a TextureFormat value: "srgb_rgba", "linear_rgba",
  "mono", "rough_metal" or "hdr"}};
- "environment" (optional): {"constant_color": [r, g, b], "strength": s,
  "texture": a texture name or None (an equirectangular map)}.
An absent optional key leaves the program's default: no texture, and the
Scene's own environment (black).
"""

from __future__ import annotations

import importlib.util
import os

import numpy as np

GENERATORS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "generators")

F = np.float32


def plane(side: float = 1.0) -> dict:
    h = side * 0.5
    positions = np.array([[-h, 0, -h], [h, 0, -h], [-h, 0, h], [h, 0, h]],
                         dtype=F)
    return dict(positions=positions,
                normals=np.tile([0, 1, 0], (4, 1)).astype(F),
                tangents=np.tile([1, 0, 0, 1], (4, 1)).astype(F),
                uvs=((positions[:, [0, 2]] + h) / (2 * h)).astype(F),
                indices=np.array([[0, 2, 1], [1, 2, 3]], dtype=np.uint32))


def cube(side: float = 1.0) -> dict:
    h = side * 0.5
    face_uv = np.array([[1, -1], [1, 1], [-1, -1], [-1, 1]], dtype=F)
    pos, nrm, tan, uv, idx = [], [], [], [], []
    for i, fn in enumerate([(0, 0, 1), (1, 0, 0), (0, 0, -1), (-1, 0, 0),
                            (0, 1, 0), (0, -1, 0)]):
        fn = np.asarray(fn, dtype=F)
        up = (np.array([1, 0, 0], F) if abs(fn[1]) == 1.0
              else np.array([0, 1, 0], F))
        right = np.cross(up, fn)
        for fp in face_uv:
            pos.append((fn + up * fp[0] + right * fp[1]) * h)
            nrm.append(fn)
            tan.append([*right, 1.0])
            uv.append(fp)
        b = 4 * i
        idx += [[b + 0, b + 2, b + 1], [b + 1, b + 2, b + 3]]
    return dict(positions=np.array(pos, F), normals=np.array(nrm, F),
                tangents=np.array(tan, F), uvs=np.array(uv, F),
                indices=np.array(idx, np.uint32))


def sphere(radius: float = 1.0, lat: int = 24, lng: int = 32) -> dict:
    i = np.arange(lat + 1)
    j = np.arange(lng + 1)
    phi = 0.5 * np.pi - i * (np.pi / lat)
    theta = j * (2.0 * np.pi / lng)
    cp, sp = np.cos(phi), np.sin(phi)
    ct, st = np.cos(theta), np.sin(theta)
    d = np.stack([cp[:, None] * ct[None, :],
                  np.broadcast_to(sp[:, None], (lat + 1, lng + 1)),
                  cp[:, None] * st[None, :]], axis=-1).astype(F)
    tangents = np.stack(
        [np.broadcast_to(-st[None, :], (lat + 1, lng + 1)),
         np.zeros((lat + 1, lng + 1), F),
         np.broadcast_to(ct[None, :], (lat + 1, lng + 1)),
         np.ones((lat + 1, lng + 1), F)], axis=-1).reshape(-1, 4).astype(F)
    uvs = np.stack(np.meshgrid(j / lng, i / lat, indexing="xy"),
                   axis=-1).reshape(-1, 2).astype(F)
    ii, jj = np.meshgrid(np.arange(1, lat + 1), np.arange(1, lng + 1),
                         indexing="ij")
    v0 = (ii - 1) * (lng + 1) + (jj - 1)
    v1 = (ii - 1) * (lng + 1) + jj
    v2 = ii * (lng + 1) + (jj - 1)
    v3 = ii * (lng + 1) + jj
    tris = np.stack([np.stack([v0, v1, v2], -1), np.stack([v1, v3, v2], -1)],
                    axis=2).reshape(-1, 3).astype(np.uint32)
    return dict(positions=(d * radius).reshape(-1, 3),
                normals=d.reshape(-1, 3), tangents=tangents, uvs=uvs,
                indices=tris)


def colonnade(columns: int = 12, rows: int = 6, sphere_res=(36, 52)) -> dict:
    """The Sponza-class colonnade hall: floor, side walls, ceiling, a grid
    of sphere-capped columns, boxes scattered by a fixed draw (seed 42, as
    in the original) and emissive ceiling panels. Returns {"meshes",
    "materials", "instances", "camera"}: meshes by name, materials as
    keyword dicts of the program's Material, instances as (name, mesh,
    material, translation, rotation, scale) in creation order."""
    rng = np.random.default_rng(42)
    hall_w, hall_d = columns * 4.0, rows * 4.0
    meshes = dict(plane=plane(1.0), cube=cube(1.0),
                  sphere=sphere(1.0, lat=sphere_res[0], lng=sphere_res[1]))
    materials = dict(
        floor=dict(base_color=(0.6, 0.55, 0.5, 1), roughness=0.4),
        wall=dict(base_color=(0.75, 0.7, 0.65, 1)),
        column=dict(base_color=(0.8, 0.78, 0.72, 1), roughness=0.6),
        brass=dict(base_color=(0.9, 0.7, 0.3, 1), metallic=1.0,
                   roughness=0.3),
        panel=dict(base_color=(0, 0, 0, 1), emission=(1, 0.95, 0.85),
                   emission_strength=40.0),
    )
    inst = []

    def instance(name, mesh, mat, t, s, r=(0, 0, 0)):
        inst.append((name, mesh, mat, tuple(float(x) for x in t),
                     tuple(float(x) for x in r), tuple(float(x) for x in s)))

    instance("floor", "plane", "floor", (0, 0, 0), (hall_w, 1, hall_d))
    instance("wall_l", "cube", "wall", (-hall_w / 2, 4, 0), (0.5, 8, hall_d))
    instance("wall_r", "cube", "wall", (hall_w / 2, 4, 0), (0.5, 8, hall_d))
    instance("ceiling", "cube", "wall", (0, 8.5, 0), (hall_w, 0.5, hall_d))
    for i in range(columns):
        for j in range(rows):
            x = (i - columns / 2 + 0.5) * 4.0
            z = (j - rows / 2 + 0.5) * 4.0
            instance(f"col_{i}_{j}", "cube", "column", (x, 2.0, z),
                     (0.6, 4.0, 0.6))
            mat = "brass" if (i + j) % 3 == 0 else "column"
            instance(f"cap_{i}_{j}", "sphere", mat, (x, 4.6, z),
                     (0.8, 0.8, 0.8))
            if rng.uniform() < 0.4:
                instance(f"box_{i}_{j}", "cube", "column",
                         (x + rng.uniform(-1, 1), 0.4, z + rng.uniform(-1, 1)),
                         (0.8, 0.8, 0.8), (0, rng.uniform(0, 3.14), 0))
    for i in range(0, columns, 2):
        for j in range(0, rows, 2):
            x = (i - columns / 2 + 1.0) * 4.0
            z = (j - rows / 2 + 1.0) * 4.0
            instance(f"panel_{i}_{j}", "cube", "panel", (x, 8.0, z),
                     (1.5, 0.1, 1.5))
    cam_pos = np.array([0.0, 3.0, hall_d / 2 - 2.0])
    target = np.array([0.0, 3.0, -hall_d / 2])
    camera = dict(position=tuple(cam_pos), target=tuple(target),
                  focal_length=35.0, sensor_size=(36.0, 24.0),
                  focus_distance=float(np.linalg.norm(cam_pos - target)))
    return dict(meshes=meshes, materials=materials, instances=inst,
                camera=camera)


GENERATORS = {"colonnade": colonnade}


def load_file(path: str, prefix: str):
    """The module in the Python file `path`, loaded by path under a name
    made from `prefix` and the file's stem."""
    stem = os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(
        prefix + stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make(config: dict, generators_dir: str = GENERATORS_DIR) -> dict:
    """The scene arrays of a configuration file's "scene" entry:
    {"generator": name, **parameters}, the name from GENERATORS or the
    file generators_dir/<name>.py."""
    spec = dict(config["scene"])
    name = spec.pop("generator")
    if name in GENERATORS:
        return GENERATORS[name](**spec)
    path = os.path.join(generators_dir, name + ".py")
    return load_file(path, "portbench_generator_").make(**spec)
