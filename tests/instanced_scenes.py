"""The instanced test scene of tests/test_tlas.py, built by either package.

`instanced_scene("platinum_tpu")` builds it from the JAX package's scene
graph, `instanced_scene("platinum_tpu_torch")` from the port's copy, with
the same arguments, so a test can flatten each with its own package and
compare. Imports neither package at module level (and never JAX), so the
GPU tests can use it where JAX is not installed.
"""

import importlib

import numpy as np


def instanced_scene(pkg: str, n_inst: int = 24, emissive: bool = True,
                    seed: int = 0):
    """(scene, camera node id): n_inst instances of a sphere, a cube and a
    plane under random transforms, diffuse, metal and emissive materials
    in turn, a constant environment (tests/test_tlas.py:26-53)."""
    prim = importlib.import_module(f"{pkg}.core.primitives")
    Camera = importlib.import_module(f"{pkg}.core.camera").Camera
    Material = importlib.import_module(f"{pkg}.core.material").Material
    Scene = importlib.import_module(f"{pkg}.core.scene").Scene
    Transform = importlib.import_module(f"{pkg}.core.transform").Transform

    rng = np.random.default_rng(seed)
    scene = Scene()
    meshes = [scene.add_asset(prim.sphere(0.5, 12, 8)),
              scene.add_asset(prim.cube(0.8)),
              scene.add_asset(prim.plane(1.5))]
    mats = [scene.add_asset(Material(name="diff",
                                     base_color=(0.8, 0.4, 0.3, 1),
                                     roughness=0.9)),
            scene.add_asset(Material(name="metal",
                                     base_color=(0.9, 0.9, 0.7, 1),
                                     roughness=0.3, metallic=1.0))]
    if emissive:
        mats.append(scene.add_asset(Material(
            name="emit", base_color=(0, 0, 0, 1), emission=(1, 1, 1),
            emission_strength=8.0)))
    for k in range(n_inst):
        n = scene.create_node(f"i{k}")
        scene.set_mesh(n.id, meshes[k % len(meshes)])
        n.transform = Transform(translation=rng.uniform(-4, 4, 3),
                                rotation=rng.uniform(0, 6.28, 3),
                                scale=[rng.uniform(0.5, 2.0)] * 3)
        scene.set_material(n.id, 0, mats[k % len(mats)])
    scene.environment.constant_color = (0.4, 0.45, 0.5)
    cam = scene.create_node("cam")
    cam.camera = Camera.with_focal_length(35.0)
    cam.camera.focus_distance = 10.0
    cam.transform = Transform(translation=[0, 2, 10], target=[0, 0, 0],
                              track=True)
    return scene, cam.id
