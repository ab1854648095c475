"""A configuration brings its scene and its reference as new files: the
test cell of testcell/ (a generator with textures and an environment, and
its own reference) runs through the harness with no existing file
changed; port_scene builds textured, environment-lit arrays as the
program's API does; the accepted scenes and the default reference do not
move; a scene with no emissive triangle runs."""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from portbench import compare, harness, scenes
from portbench.conftest import HERE, digests, load_bench
from portbench.control import control_numbers
from portbench.reference import pathtracer

SEED = 4000000001

# sha256 of scenes.make's arrays for each accepted configuration (_digest)
FROZEN = {
    "sponza_class":
        "3102c7bae0102d47380ee0ac13270c2140dadad489989d87820057d1aeda40aa",
    "bistro_class":
        "0668fea0e1e87ace3c0c6e7ad697975923a1359564d5aa2fcb6f84f4a3be27d2",
}


def _digest(arrays) -> str:
    h = hashlib.sha256()

    def walk(x):
        if isinstance(x, dict):
            for k in sorted(x):
                h.update(repr(k).encode())
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            h.update(b"[%d" % len(x))
            for v in x:
                walk(v)
        elif isinstance(x, np.ndarray):
            h.update(f"{x.dtype}{x.shape}".encode())
            h.update(np.ascontiguousarray(x).tobytes())
        else:
            h.update(repr(float(x) if isinstance(x, (float, np.floating))
                          else x).encode())
    walk(arrays)
    return h.hexdigest()


def test_a_cell_of_new_files_runs_and_changes_no_file(studio):
    bench, root, before = studio
    out = harness.run(bench, "studio.studio_tiny", SEED, 0.3, False,
                      device="cpu", root=root)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] >= 1 and set(out["metrics"]) == {"setup_s",
                                                              "ms_per_spp"}
    after = digests(os.path.join(root, "portbench"))
    assert {k: after.get(k) for k in before} == before
    for rel in ("generators/studio.py", "reference/direct_light.py",
                "configs/studio.json"):
        assert rel in after and rel not in before


def test_the_control_fails_the_test_cell(studio):
    bench, root, _ = studio
    spec = harness.find_cell(bench, "studio.studio_tiny", root)
    nums = control_numbers(spec, SEED, 3, torch.device("cpu"))
    table, correct = compare.judge(spec["check"], nums)
    assert not correct and table["pixels_off"]["value"] > 0.12


def _rich_arrays():
    """The test cell's scene with every texture format and the lobes'
    material keys."""
    a = scenes.load_file(os.path.join(HERE, "testcell", "generators",
                                      "studio.py"), "test_").make()
    g = np.random.default_rng(5)
    a["textures"].update(
        albedo=dict(data=g.integers(0, 256, (8, 8, 4), np.uint8),
                    format="srgb_rgba"),
        rm=dict(data=g.integers(0, 256, (8, 4, 2), np.uint8),
                format="rough_metal"),
        coat=dict(data=g.integers(0, 256, (4, 8), np.uint8), format="mono"),
        glow=dict(data=g.integers(0, 256, (4, 4, 3), np.uint8),
                  format="srgb_rgba"))
    a["materials"].update(
        box=dict(base_color=(0.7, 0.3, 0.2, 1), roughness=0.6, clearcoat=1.0,
                 clearcoat_roughness=0.12,
                 textures=dict(base_color="albedo", roughness_metallic="rm",
                               clearcoat="coat")),
        ball=dict(base_color=(0.9, 0.8, 0.5, 1), metallic=0.8,
                  roughness=0.25, anisotropy=0.8, anisotropy_rotation=0.3,
                  textures=dict(emission="glow"), emission=(1, 1, 1),
                  emission_strength=2.0),
        glass=dict(transmission=1.0, ior=1.45, roughness=0.1,
                   thin_transmission=True))
    a["instances"].append(("pane", "plane", "glass", (0.0, 1.0, -1.0),
                           (1.5, 0.0, 0.0), (1.0, 1.0, 1.0)))
    a["environment"] = dict(constant_color=[0.1, 0.2, 0.3], strength=2.5,
                            texture="sky")
    return a


def _by_api(a):
    """The same scene built directly with the program's API, as
    app/scenes.py's make_helmet_scene builds its own."""
    from platinum_tpu_torch.core.camera import Camera
    from platinum_tpu_torch.core.material import Material, TextureSlot
    from platinum_tpu_torch.core.mesh import Mesh
    from platinum_tpu_torch.core.scene import Scene
    from platinum_tpu_torch.core.texture import Texture, TextureFormat
    from platinum_tpu_torch.core.transform import Transform

    scene = Scene()
    mesh = {k: scene.add_asset(Mesh(m["positions"], m["indices"],
                                    m["normals"], m["tangents"], m["uvs"],
                                    name=k), retained=True)
            for k, m in a["meshes"].items()}
    t = a["textures"]
    fmt = {"linear_rgba": TextureFormat.LINEAR_RGBA, "hdr": TextureFormat.HDR,
           "srgb_rgba": TextureFormat.SRGB_RGBA,
           "rough_metal": TextureFormat.ROUGH_METAL,
           "mono": TextureFormat.MONO}
    tex = {k: scene.add_asset(Texture(data=t[k]["data"],
                                      format=fmt[t[k]["format"]], name=k),
                              retained=True) for k in t}
    m = a["materials"]
    mats = dict(
        floor=Material(name="floor", base_color=(1, 1, 1, 1), roughness=0.5,
                       textures={TextureSlot.BASE_COLOR: tex["tiles"],
                                 TextureSlot.NORMAL: tex["bumps"]}),
        box=Material(name="box", base_color=(0.7, 0.3, 0.2, 1),
                     roughness=0.6, clearcoat=1.0, clearcoat_roughness=0.12,
                     textures={TextureSlot.BASE_COLOR: tex["albedo"],
                               TextureSlot.ROUGHNESS_METALLIC: tex["rm"],
                               TextureSlot.CLEARCOAT: tex["coat"]}),
        ball=Material(name="ball", base_color=(0.9, 0.8, 0.5, 1),
                      metallic=0.8, roughness=0.25, anisotropy=0.8,
                      anisotropy_rotation=0.3, emission=(1, 1, 1),
                      emission_strength=2.0,
                      textures={TextureSlot.EMISSION: tex["glow"]}),
        panel=Material(name="panel", **m["panel"]),
        glass=Material(name="glass", transmission=1.0, ior=1.45,
                       roughness=0.1, thin_transmission=True))
    mat = {k: scene.add_asset(mats[k]) for k in m}
    for name, mk, mt, tr, r, s in a["instances"]:
        node = scene.create_node(name)
        scene.set_mesh(node.id, mesh[mk])
        scene.set_material(node.id, 0, mat[mt])
        node.transform = Transform(translation=tr, rotation=r, scale=s)
    c = a["camera"]
    cam = scene.create_node("camera")
    cam.camera = Camera.with_focal_length(c["focal_length"],
                                          sensor_size=tuple(c["sensor_size"]))
    cam.camera.focus_distance = c["focus_distance"]
    cam.transform = Transform(translation=c["position"], target=c["target"],
                              track=True)
    sky = t["sky"]["data"]
    scene.environment.set_texture(tex["sky"], sky)
    scene.environment.strength = 2.5
    scene.environment.constant_color = (0.1, 0.2, 0.3)
    return scene, cam.id


def _same(x, y, path="flat"):
    if torch.is_tensor(x):
        assert torch.is_tensor(y) and x.dtype == y.dtype, path
        assert torch.equal(x, y), path
    elif isinstance(x, (tuple, list)):
        assert len(x) == len(y), path
        for i, (a, b) in enumerate(zip(x, y)):
            _same(a, b, f"{path}[{i}]")
    elif hasattr(x, "__dataclass_fields__"):
        for k in x.__dataclass_fields__:
            _same(getattr(x, k), getattr(y, k), f"{path}.{k}")
    elif isinstance(x, np.ndarray):
        np.testing.assert_array_equal(x, y, err_msg=path)
    else:
        assert x == y, path


def test_port_scene_is_the_programs_api():
    from platinum_tpu_torch.render.flatten import flatten_scene
    from platinum_tpu_torch.render.types import RenderSettings

    a = _rich_arrays()
    settings = RenderSettings(width=16, height=12, spp=1)
    flats = [flatten_scene(*build, settings, device="cpu")
             for build in (harness.port_scene(a), _by_api(a))]
    assert flats[0].atlas is not None and int(flats[0].env.count) == 1
    assert int((flats[0].materials.textures >= 0).sum()) == 6
    _same(*flats)


@pytest.mark.parametrize("name", sorted(FROZEN))
def test_the_accepted_scenes_do_not_move(name):
    cfg = harness.find_cell(load_bench(), name + ".final_1080p")["config"]
    assert _digest(scenes.make(cfg)) == FROZEN[name]


def test_the_default_reference_by_name_is_pathtracer():
    spec = harness.find_cell(load_bench(), "sponza_class.final_1080p")
    assert "reference" not in spec["config"]
    arrays = scenes.colonnade(columns=2, rows=2, sphere_res=(8, 12))
    scene = pathtracer.compile_scene(arrays, 48, 27)
    program_rows = pathtracer.light_table(
        scene, scene["light_tris"][::-1].copy())[0][:, :9]
    pixels, samples = np.arange(0, 48 * 27, 7), [0, 5, 6]
    rad, gap = spec["reference"].radiance(arrays, 48, 27, 8, pixels, samples,
                                          program_rows, "cpu", torch.float32)
    order, gap0 = pathtracer.match_lights(scene, program_rows)
    rows, total = pathtracer.light_table(scene, order)
    tables = pathtracer.device_tables(scene, rows, total, "cpu",
                                      torch.float32)
    rad0 = pathtracer.render_pixels(tables, pixels, samples, 8)
    assert torch.equal(rad, rad0) and gap == gap0 == 0.0
    assert float(rad.mean()) > 0.01


def test_a_scene_with_no_emitter_runs(studio):
    bench, root, _ = studio
    path = os.path.join(root, "portbench", "configs", "studio.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg["scene"]["panel"] = False              # lit by the sky alone
    with open(path, "w") as f:
        json.dump(cfg, f)
    out = harness.run(bench, "studio.studio_tiny", SEED, 0.3, False,
                      device="cpu", root=root)
    assert out["checks"]["light_rows"]["value"] == 0.0
    assert out["correct"] is True, out["checks"]


@pytest.mark.parametrize("light_rows", [None, np.zeros((0, 9), np.float32)])
def test_the_default_reference_takes_no_emitter(light_rows):
    arrays = scenes.colonnade(columns=2, rows=2, sphere_res=(8, 12))
    arrays["materials"]["panel"]["emission_strength"] = 0.0
    rad, gap = pathtracer.radiance(arrays, 24, 16, 8, np.arange(24 * 16),
                                   [0, 3], light_rows, "cpu")
    assert gap == 0.0 and rad.shape == (24 * 16, 2, 3)
    assert float(rad.abs().max()) == 0.0


def test_the_default_reference_refuses_textures_and_an_environment():
    a = _rich_arrays()
    with pytest.raises(ValueError):
        pathtracer.compile_scene(a, 16, 12)
    a = scenes.colonnade(columns=2, rows=2, sphere_res=(8, 12))
    a["environment"] = dict(constant_color=[0.5, 0.5, 0.5], strength=1.0,
                            texture=None)
    with pytest.raises(ValueError):
        pathtracer.compile_scene(a, 16, 12)
    a["environment"]["strength"] = 0.0          # a black sky lights nothing
    pathtracer.compile_scene(a, 16, 12)
