"""Copy of platinum_tpu/app/scenes.py, kept in step with it: platinum_tpu_torch
imports nothing of the JAX package.

Built-in demo/benchmark scenes.

The Cornell setup mirrors the reference's Add→Cornell Box action
(scene_explorer.cpp:50-73): slot 0 white, slot 1 left wall red, slot 2 right
wall green, slot 3 emissive white (strength 50), plus a camera placed to view
the open front of the box.
"""

from __future__ import annotations

import numpy as np

from platinum_tpu_torch.core import primitives
from platinum_tpu_torch.core.camera import Camera
from platinum_tpu_torch.core.material import Material
from platinum_tpu_torch.core.scene import Scene
from platinum_tpu_torch.core.transform import Transform


def make_cornell_scene(
    camera_distance: float = 18.0, aperture: float = 0.0
) -> tuple:
    """Returns (scene, camera_node_id)."""
    scene = Scene()
    box_id = scene.add_asset(primitives.cornell_box())
    node = scene.create_node("cornell_box")
    scene.set_mesh(node.id, box_id)

    mats = [
        Material(name="cornell_base", base_color=(1, 1, 1, 1)),
        Material(name="cornell_wall_l", base_color=(0.704, 0.016, 0.020, 1)),
        Material(name="cornell_wall_r", base_color=(0.009, 0.591, 0.006, 1)),
        Material(
            name="cornell_light",
            base_color=(0, 0, 0, 1),
            emission=(1, 1, 1),
            emission_strength=50.0,
        ),
    ]
    for slot, mat in enumerate(mats):
        scene.set_material(node.id, slot, scene.add_asset(mat))

    cam_node = scene.create_node("camera")
    cam_node.camera = Camera.with_focal_length(50.0, aperture=aperture)
    cam_node.camera.focus_distance = camera_distance
    cam_node.transform = Transform(
        translation=[0.0, 5.0, camera_distance], target=[0.0, 5.0, 0.0], track=True
    )
    return scene, cam_node.id


def make_furnace_scene(albedo: float = 1.0, roughness: float = 1.0,
                       metallic: float = 0.0, env_value: float = 0.5,
                       transmission: float = 0.0, ior: float = 1.5,
                       clearcoat: float = 0.0, clearcoat_roughness: float = 0.0,
                       anisotropy: float = 0.0, anisotropy_rotation: float = 0.0,
                       thin: bool = False) -> tuple:
    """White-furnace test scene: a sphere in a constant environment. With
    albedo 1 and energy-preserving BSDFs, every pixel must equal env_value."""
    scene = Scene()
    sph_id = scene.add_asset(primitives.sphere(1.0, lat=32, lng=48))
    node = scene.create_node("sphere")
    scene.set_mesh(node.id, sph_id)
    mat = Material(
        name="furnace",
        base_color=(albedo, albedo, albedo, 1.0),
        roughness=roughness,
        metallic=metallic,
        transmission=transmission,
        ior=ior,
        clearcoat=clearcoat,
        clearcoat_roughness=clearcoat_roughness,
        anisotropy=anisotropy,
        anisotropy_rotation=anisotropy_rotation,
        thin_transmission=thin,
    )
    scene.set_material(node.id, 0, scene.add_asset(mat))
    scene.environment.constant_color = (env_value, env_value, env_value)

    cam_node = scene.create_node("camera")
    cam_node.camera = Camera.with_focal_length(50.0)
    cam_node.camera.focus_distance = 5.0
    cam_node.transform = Transform(
        translation=[0.0, 0.0, 5.0], target=[0.0, 0.0, 0.0], track=True
    )
    return scene, cam_node.id


def make_colonnade_scene(columns: int = 12, rows: int = 6,
                         sphere_res: tuple = (36, 52)) -> tuple:
    """Sponza-class architectural stress scene (~300k triangles): a colonnade
    hall with a floor, side walls, a grid of sphere-capped columns, scattered
    boxes and several emissive ceiling panels. Stands in for the Sponza
    benchmark config (BASELINE.md #4) since no external assets ship with this
    repository; geometry/light counts are matched (deep BVH, many lights).
    """
    import numpy as np

    scene = Scene()
    rng = np.random.default_rng(42)

    hall_w = columns * 4.0
    hall_d = rows * 4.0

    floor_id = scene.add_asset(primitives.plane(1.0), retained=True)
    cube_id = scene.add_asset(primitives.cube(1.0), retained=True)
    sphere_id = scene.add_asset(
        primitives.sphere(1.0, lat=sphere_res[0], lng=sphere_res[1]),
        retained=True,
    )

    mat_floor = scene.add_asset(Material(name="floor", base_color=(0.6, 0.55, 0.5, 1), roughness=0.4))
    mat_wall = scene.add_asset(Material(name="wall", base_color=(0.75, 0.7, 0.65, 1)))
    mat_col = scene.add_asset(Material(name="column", base_color=(0.8, 0.78, 0.72, 1), roughness=0.6))
    mat_metal = scene.add_asset(Material(name="brass", base_color=(0.9, 0.7, 0.3, 1), metallic=1.0, roughness=0.3))
    mat_light = scene.add_asset(Material(
        name="panel", base_color=(0, 0, 0, 1), emission=(1, 0.95, 0.85),
        emission_strength=40.0,
    ))

    def instance(name, mesh_id, mat_id, t, s, r=(0, 0, 0)):
        node = scene.create_node(name)
        scene.set_mesh(node.id, mesh_id)
        scene.set_material(node.id, 0, mat_id)
        node.transform = Transform(translation=t, rotation=r, scale=s)
        return node

    instance("floor", floor_id, mat_floor, (0, 0, 0), (hall_w, 1, hall_d))
    instance("wall_l", cube_id, mat_wall, (-hall_w / 2, 4, 0), (0.5, 8, hall_d))
    instance("wall_r", cube_id, mat_wall, (hall_w / 2, 4, 0), (0.5, 8, hall_d))
    instance("ceiling", cube_id, mat_wall, (0, 8.5, 0), (hall_w, 0.5, hall_d))

    for i in range(columns):
        for j in range(rows):
            x = (i - columns / 2 + 0.5) * 4.0
            z = (j - rows / 2 + 0.5) * 4.0
            instance(f"col_{i}_{j}", cube_id, mat_col, (x, 2.0, z), (0.6, 4.0, 0.6))
            mat = mat_metal if (i + j) % 3 == 0 else mat_col
            instance(f"cap_{i}_{j}", sphere_id, mat, (x, 4.6, z), (0.8, 0.8, 0.8))
            if rng.uniform() < 0.4:
                instance(
                    f"box_{i}_{j}", cube_id, mat_col,
                    (x + rng.uniform(-1, 1), 0.4, z + rng.uniform(-1, 1)),
                    (0.8, 0.8, 0.8), (0, rng.uniform(0, 3.14), 0),
                )

    # Emissive ceiling panels (many lights)
    for i in range(0, columns, 2):
        for j in range(0, rows, 2):
            x = (i - columns / 2 + 1.0) * 4.0
            z = (j - rows / 2 + 1.0) * 4.0
            instance(f"panel_{i}_{j}", cube_id, mat_light, (x, 8.0, z), (1.5, 0.1, 1.5))

    cam_node = scene.create_node("camera")
    cam_node.camera = Camera.with_focal_length(35.0)
    cam_pos = np.array([0.0, 3.0, hall_d / 2 - 2.0])
    target = np.array([0.0, 3.0, -hall_d / 2])
    cam_node.camera.focus_distance = float(np.linalg.norm(cam_pos - target))
    cam_node.transform = Transform(translation=cam_pos, target=target, track=True)
    return scene, cam_node.id


def make_spheres_scene(grid: int = 7) -> tuple:
    """MetalRoughSpheres-class benchmark scene (BASELINE.md #2): a grid of
    spheres sweeping roughness x metallic over the full GGX BSDF, with a
    procedural tangent-space normal map on the ground plane to exercise the
    normal-mapping path (the glTF sample asset itself does not ship with
    this repository; geometry/material coverage is matched).
    """
    from platinum_tpu_torch.core.material import TextureSlot
    from platinum_tpu_torch.core.texture import Texture, TextureFormat

    scene = Scene()
    sph_id = scene.add_asset(
        primitives.sphere(1.0, lat=28, lng=40), retained=True)
    plane_id = scene.add_asset(primitives.plane(1.0))

    # bumpy procedural normal map
    k = 128
    yy, xx = np.mgrid[0:k, 0:k].astype(np.float32) / k
    nx = 0.35 * np.sin(xx * 40.0)
    ny = 0.35 * np.cos(yy * 40.0)
    nz = np.sqrt(np.maximum(1.0 - nx * nx - ny * ny, 0.0))
    nm = np.stack([nx, ny, nz], -1) * 0.5 + 0.5
    nm4 = np.concatenate([nm, np.ones((k, k, 1), np.float32)], -1)
    nm_id = scene.add_asset(Texture(data=(nm4 * 255).astype(np.uint8),
                                    format=TextureFormat.LINEAR_RGBA,
                                    name="bump"))

    ground = scene.create_node("ground")
    scene.set_mesh(ground.id, plane_id)
    span = grid * 2.6
    ground.transform = Transform(translation=[0, -1.2, 0],
                                 scale=[span, 1.0, span])
    gmat = Material(name="ground", base_color=(0.5, 0.5, 0.55, 1),
                    roughness=0.35,
                    textures={TextureSlot.NORMAL: nm_id})
    scene.set_material(ground.id, 0, scene.add_asset(gmat))

    for i in range(grid):
        for j in range(grid):
            node = scene.create_node(f"s_{i}_{j}")
            scene.set_mesh(node.id, sph_id)
            x = (i - grid / 2 + 0.5) * 2.6
            z = (j - grid / 2 + 0.5) * 2.6
            node.transform = Transform(translation=[x, 0.0, z])
            mat = Material(
                name=f"m_{i}_{j}",
                base_color=(0.9, 0.35, 0.2, 1.0),
                roughness=i / max(grid - 1, 1),
                metallic=j / max(grid - 1, 1),
            )
            scene.set_material(node.id, 0, scene.add_asset(mat))

    scene.environment.constant_color = (0.8, 0.85, 0.95)

    cam_node = scene.create_node("camera")
    cam_node.camera = Camera.with_focal_length(40.0)
    pos = np.array([0.0, grid * 1.6, grid * 2.2])
    target = np.array([0.0, -0.5, 0.0])
    cam_node.camera.focus_distance = float(np.linalg.norm(pos - target))
    cam_node.transform = Transform(translation=pos, target=target, track=True)
    return scene, cam_node.id


def make_helmet_scene() -> tuple:
    """DamagedHelmet-class benchmark scene (BASELINE.md #3): a dense curved
    hero object (clearcoated metal dome over a brushed base) under an HDR
    environment with a small very bright sun — stresses environment-map
    importance sampling + MIS at 1080p. Stand-in for the glTF sample asset
    (no external assets ship with this repository)."""
    scene = Scene()

    dome_id = scene.add_asset(primitives.sphere(1.0, lat=96, lng=144))
    base_id = scene.add_asset(primitives.cube(1.0))

    dome = scene.create_node("dome")
    scene.set_mesh(dome.id, dome_id)
    dome.transform = Transform(translation=[0, 0.4, 0],
                               scale=[1.2, 1.0, 1.2])
    scene.set_material(dome.id, 0, scene.add_asset(Material(
        name="helmet", base_color=(0.35, 0.33, 0.3, 1), metallic=1.0,
        roughness=0.35, clearcoat=1.0, clearcoat_roughness=0.12,
    )))

    base = scene.create_node("base")
    scene.set_mesh(base.id, base_id)
    base.transform = Transform(translation=[0, -0.75, 0],
                               scale=[3.5, 0.3, 3.5])
    scene.set_material(base.id, 0, scene.add_asset(Material(
        name="base", base_color=(0.2, 0.2, 0.22, 1), roughness=0.25,
        metallic=0.8, anisotropy=0.8,
    )))

    # HDR-style environment: sky gradient + ground + small 500x sun
    h, w = 128, 256
    yy = (np.arange(h, dtype=np.float32) + 0.5) / h        # 0 top .. 1 bottom
    xx = (np.arange(w, dtype=np.float32) + 0.5) / w
    sky = np.zeros((h, w, 3), np.float32)
    sky[:] = np.stack([
        np.interp(yy, [0, 0.5, 1], [0.15, 0.5, 0.08]),
        np.interp(yy, [0, 0.5, 1], [0.25, 0.6, 0.07]),
        np.interp(yy, [0, 0.5, 1], [0.6, 0.8, 0.06]),
    ], -1)[:, None, :]
    cy, cx = int(0.25 * h), int(0.7 * w)
    sky[cy - 2:cy + 2, cx - 2:cx + 2] = (500.0, 480.0, 450.0)
    from platinum_tpu_torch.core.texture import Texture, TextureFormat
    sky_id = scene.add_asset(
        Texture(data=sky, format=TextureFormat.HDR, name="sky"), retained=True)
    scene.environment.set_texture(sky_id, sky)
    scene.environment.strength = 1.0

    cam_node = scene.create_node("camera")
    cam_node.camera = Camera.with_focal_length(60.0)
    pos = np.array([2.6, 1.4, 2.6])
    target = np.array([0.0, 0.2, 0.0])
    cam_node.camera.focus_distance = float(np.linalg.norm(pos - target))
    cam_node.transform = Transform(translation=pos, target=target, track=True)
    return scene, cam_node.id
