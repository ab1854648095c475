"""The blessed golden configurations of tests/test_golden.py, without JAX.

`config(name)` builds tests/test_golden.py:38-185's scene and
RenderSettings for one golden with the port's scene graph; `render(name,
device)` renders it with the port as tests/test_golden.py:188-202
renders it with JAX (flatten with accel_min_tris=32 and
integrator.render, or, under GMoN, the Renderer to DONE and its
readback); `golden(name)` reads tests/goldens/<name>.exr. The bar is test_golden.py's RMSE_THRESHOLD,
1e-3. Imports neither package at module level, and never JAX, so
chip_smoke.py can hold the port's card renders to the goldens.
"""

import copy
import importlib
import os
import tempfile

import numpy as np

GOLD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "goldens")
RMSE_THRESHOLD = 1e-3
NAMES = ("cornell", "cornell_pcg4d", "furnace_rough_metal", "spheres",
         "spheres_foreign_glb", "cutout_shadows", "spheres_gmon",
         "cornell_dof")


def _mod(name):
    return importlib.import_module(f"platinum_tpu_torch.{name}")


def _foreign_spheres():
    """The spheres scene through a foreign-layout .glb and the import
    path, camera physics and environment carried over."""
    scenes = _mod("app.scenes")
    scene, cam = scenes.make_spheres_scene(grid=4)
    loaded = _mod("core.scene").Scene()
    with tempfile.TemporaryDirectory(prefix="ptpu-golden-") as tmp:
        path = os.path.join(tmp, "golden_spheres.glb")
        _mod("tools.foreign_glb").export_glb_foreign(scene, path)
        _mod("io.gltf").load_gltf(loaded, path)
    node_id = loaded.get_cameras()[0][0]
    loaded.node(node_id).camera = copy.copy(scene.node(cam).camera)
    loaded.environment = copy.copy(scene.environment)
    return loaded, node_id


def _cutout_scene():
    """Alpha-masked checker quad shadowing a Lambert floor under a bright
    panel (test_golden.py:70-117)."""
    prim = _mod("core.primitives")
    Camera = _mod("core.camera").Camera
    mat_mod = _mod("core.material")
    Material, TextureSlot = mat_mod.Material, mat_mod.TextureSlot
    tex_mod = _mod("core.texture")
    Transform = _mod("core.transform").Transform

    scene = _mod("core.scene").Scene()
    floor_id = scene.add_asset(prim.plane(8.0))
    fl = scene.create_node("floor")
    scene.set_mesh(fl.id, floor_id)
    scene.set_material(fl.id, 0, scene.add_asset(Material(
        name="floor", base_color=(0.7, 0.7, 0.7, 1), roughness=1.0)))

    k = 32
    rgba = np.full((k, k, 4), 255, np.uint8)
    yy, xx = np.mgrid[0:k, 0:k]
    rgba[(yy // 4 + xx // 4) % 2 == 0, 3] = 0   # checker cutout
    tex_id = scene.add_asset(tex_mod.Texture(
        data=rgba, format=tex_mod.TextureFormat.SRGB_RGBA, name="checker",
        has_alpha=True), retained=True)
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
    p.transform = Transform(translation=[0, 3.5, 0],
                            scale=[1.0, 0.05, 1.0])

    cam = scene.create_node("cam")
    cam.camera = Camera.with_focal_length(35.0)
    cam.camera.focus_distance = 6.0
    cam.transform = Transform(translation=[3.5, 4.0, 3.5],
                              target=[0, 0.8, 0], track=True)
    return scene, cam.id


def _gmon_spheres():
    """Spheres + a tiny ultra-bright firefly cube (test_golden.py:119-143)."""
    prim = _mod("core.primitives")
    Material = _mod("core.material").Material
    Transform = _mod("core.transform").Transform

    scene, cam = _mod("app.scenes").make_spheres_scene(grid=4)
    fid = scene.add_asset(prim.cube(1.0))
    f = scene.create_node("firefly")
    scene.set_mesh(f.id, fid)
    scene.set_material(f.id, 0, scene.add_asset(Material(
        name="firefly", base_color=(0, 0, 0, 1),
        emission=(1.0, 0.8, 0.5), emission_strength=2.0e4)))
    f.transform = Transform(translation=[0.0, 2.5, 0.0],
                            scale=[0.008, 0.008, 0.008])
    return scene, cam


def _dof_cornell():
    """Cornell through a wide-open 5-blade aperture
    (test_golden.py:145-158)."""
    scene, cam = _mod("app.scenes").make_cornell_scene()
    c = scene.node(cam).camera
    c.aperture = 1.4
    c.aperture_blades = 5
    c.roundness = 0.2
    c.bokeh_power = 0.5
    return scene, cam


def config(name):
    """((scene, camera node id), RenderSettings) of the golden `name`, as
    test_golden.py:164-184 builds it."""
    scenes = _mod("app.scenes")
    types = _mod("render.types")
    S = types.RenderSettings
    mis = dict(width=128, height=128, kernel="mis", sampler="halton")
    if name == "cornell_dof":
        return _dof_cornell(), S(spp=32, max_bounces=4, **mis)
    if name == "spheres_gmon":
        return _gmon_spheres(), S(spp=32, max_bounces=4, tracer="packet",
                                     flags=types.FLAG_GMON, gmon_buckets=8,
                                     **mis)
    if name == "cutout_shadows":
        return _cutout_scene(), S(spp=32, max_bounces=4, **mis)
    if name == "cornell":
        return scenes.make_cornell_scene(), S(spp=32, max_bounces=6,
                                              tracer="auto", **mis)
    if name == "cornell_pcg4d":
        return scenes.make_cornell_scene(), S(
            spp=32, max_bounces=6, tracer="auto",
            **dict(mis, sampler="pcg4d"))
    if name == "furnace_rough_metal":
        return scenes.make_furnace_scene(
            albedo=0.8, roughness=0.4, metallic=1.0), S(
            spp=32, max_bounces=8, **dict(mis, width=96, height=96))
    if name == "spheres":
        return scenes.make_spheres_scene(grid=4), S(
            spp=16, max_bounces=4, tracer="packet", **mis)
    if name == "spheres_foreign_glb":
        return _foreign_spheres(), S(spp=16, max_bounces=4,
                                        tracer="packet", **mis)
    raise KeyError(name)


def render(name, device, tracer=None, accel_min_tris=32):
    """(the port's (H, W, 3) numpy render, RenderSettings) of the golden
    `name` on `device`, rendered as test_golden.py renders it with JAX;
    `tracer` overrides the configuration's tracer (and `accel_min_tris`
    the flatten's)."""
    import dataclasses

    from platinum_tpu_torch.render.flatten import (analyze_features,
                                                   flatten_scene)
    from platinum_tpu_torch.render.integrator import render as render_flat
    from platinum_tpu_torch.render.renderer import Renderer, RenderStatus
    from platinum_tpu_torch.render.types import FLAG_GMON

    (scene, cam), settings = config(name)
    if tracer is not None:
        settings = dataclasses.replace(settings, tracer=tracer)
    if settings.flags & FLAG_GMON:
        # GMoN bucketing lives in the Renderer: the full pipeline
        r = Renderer(scene, device=device)
        r.start_render(cam, settings=settings)
        while not (r.status & RenderStatus.DONE):
            r.render()
        return np.asarray(r.readback()), settings
    flat = flatten_scene(scene, cam, settings, accel_min_tris=accel_min_tris,
                         device=device)
    img = render_flat(flat, settings, features=analyze_features(flat))
    return img.cpu().numpy(), settings


def golden(name):
    """tests/goldens/<name>.exr's RGB."""
    from platinum_tpu_torch.io.exr import read_exr

    return read_exr(os.path.join(GOLD_DIR, f"{name}.exr"))[..., :3]


def rmse(a, b):
    return float(np.sqrt(np.mean((np.asarray(a, np.float64) - b) ** 2)))
