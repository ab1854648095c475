"""Alpha-cutout test scenes, built by either package.

`cutout_scene(pkg)` is the `cutout_shadows` golden scene of
tests/test_golden.py:70-117 (a checker-cut quad shadowing a Lambert floor
under a bright panel); `checker_columns(pkg)` is the small colonnade with
that checker texture, alpha and all, on its `column` material. `pkg` is
"platinum_tpu" or "platinum_tpu_torch", so a test can build the same scene
with each package's own scene graph. Imports neither package at module
level (and never JAX).
"""

import importlib

import numpy as np

CHECKER = 32          # texels a side, cut in 4x4 squares


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def checker_texture(pkg):
    """The golden's checker: opaque white with every other 4x4 square cut
    out (alpha 0)."""
    tex = _mod(pkg, "core.texture")
    rgba = np.full((CHECKER, CHECKER, 4), 255, np.uint8)
    yy, xx = np.mgrid[0:CHECKER, 0:CHECKER]
    rgba[(yy // 4 + xx // 4) % 2 == 0, 3] = 0
    return tex.Texture(data=rgba, format=tex.TextureFormat.SRGB_RGBA,
                       name="checker", has_alpha=True)


def cutout_scene(pkg):
    """(scene, camera node id) of test_golden.py's cutout_scene."""
    prim = _mod(pkg, "core.primitives")
    Camera = _mod(pkg, "core.camera").Camera
    mat_mod = _mod(pkg, "core.material")
    Material, TextureSlot = mat_mod.Material, mat_mod.TextureSlot
    Scene = _mod(pkg, "core.scene").Scene
    Transform = _mod(pkg, "core.transform").Transform

    scene = Scene()
    floor_id = scene.add_asset(prim.plane(8.0))
    fl = scene.create_node("floor")
    scene.set_mesh(fl.id, floor_id)
    scene.set_material(fl.id, 0, scene.add_asset(Material(
        name="floor", base_color=(0.7, 0.7, 0.7, 1), roughness=1.0)))

    tex_id = scene.add_asset(checker_texture(pkg), retained=True)
    mat = Material(name="cutout", base_color=(0.9, 0.3, 0.2, 1))
    mat.textures[TextureSlot.BASE_COLOR] = tex_id
    quad_id = scene.add_asset(prim.plane(3.0))
    q = scene.create_node("cutout")
    scene.set_mesh(q.id, quad_id)
    scene.set_material(q.id, 0, scene.add_asset(mat))
    q.transform = Transform(translation=[0, 1.5, 0])

    panel_id = scene.add_asset(prim.cube(1.0))
    p = scene.create_node("panel")
    scene.set_mesh(p.id, panel_id)
    scene.set_material(p.id, 0, scene.add_asset(Material(
        name="light", base_color=(0, 0, 0, 1), emission=(1, 1, 1),
        emission_strength=25.0)))
    p.transform = Transform(translation=[0, 3.5, 0], scale=[1.0, 0.05, 1.0])

    cam = scene.create_node("cam")
    cam.camera = Camera.with_focal_length(35.0)
    cam.camera.focus_distance = 6.0
    cam.transform = Transform(translation=[3.5, 4.0, 3.5],
                              target=[0, 0.8, 0], track=True)
    return scene, cam.id


def checker_columns(pkg, **colonnade):
    """(scene, camera node id): the colonnade (default: the small one of
    tests/test_torch_slice.py) with the checker texture bound to the base
    colour of its `column` material, which makes the columns cutouts."""
    scenes = _mod(pkg, "app.scenes")
    mat_mod = _mod(pkg, "core.material")
    kw = colonnade or dict(sphere_res=(12, 16))
    scene, cam = scenes.make_colonnade_scene(**kw)
    tex_id = scene.add_asset(checker_texture(pkg), retained=True)
    cols = [data for _, data, name, *_ in scene.all_assets()
            if isinstance(data, mat_mod.Material) and data.name == "column"]
    assert len(cols) == 1
    cols[0].textures[mat_mod.TextureSlot.BASE_COLOR] = tex_id
    return scene, cam
