"""A small lit studio, the scene of the benchmark's test cell made of new
files alone: a floor with a base-colour texture and a normal map, a box,
a metal ball, an emissive panel (`panel=False` leaves it out) and an HDR
sky with a bright spot as the environment. Frozen; numpy and
portbench.scenes' primitives only."""

import numpy as np

from portbench.scenes import cube, plane, sphere

F = np.float32


def make(panel: bool = True, texel=(153, 102, 51), tilt=(0.3, -0.2)) -> dict:
    """The scene arrays (portbench/scenes.py lists the keys). The floor's
    textures are uniform: every texel of "tiles" is `texel` / 255 (linear)
    and every texel of "bumps" the tangent-space normal tilted by `tilt`."""
    tiles = np.ones((4, 4, 4), F)
    tiles[..., :3] = np.asarray(texel, F) / F(255.0)
    nx, ny = tilt
    n = np.array([nx, ny, np.sqrt(1.0 - nx * nx - ny * ny)], F)
    bumps = np.ones((4, 4, 4), F)
    bumps[..., :3] = n * F(0.5) + F(0.5)
    h, w = 8, 16
    yy = (np.arange(h, dtype=F) + 0.5) / h
    sky = np.zeros((h, w, 3), F)
    sky[:] = np.stack([np.interp(yy, [0, 0.5, 1], [0.2, 0.6, 0.1]),
                       np.interp(yy, [0, 0.5, 1], [0.3, 0.7, 0.1]),
                       np.interp(yy, [0, 0.5, 1], [0.7, 0.9, 0.1])],
                      -1).astype(F)[:, None, :]
    sky[2, 11] = (40.0, 38.0, 35.0)
    materials = dict(
        floor=dict(base_color=(1, 1, 1, 1), roughness=0.5,
                   textures=dict(base_color="tiles", normal="bumps")),
        box=dict(base_color=(0.7, 0.3, 0.2, 1), roughness=0.6),
        ball=dict(base_color=(0.9, 0.8, 0.5, 1), metallic=1.0,
                  roughness=0.35),
        panel=dict(base_color=(0, 0, 0, 1), emission=(1, 0.9, 0.8),
                   emission_strength=30.0),
    )
    inst = [("floor", "plane", "floor", (0.0, 0.0, 0.0), (0.0, 0.0, 0.0),
             (6.0, 1.0, 6.0)),
            ("box", "cube", "box", (-0.8, 0.5, 0.0), (0.0, 0.5, 0.0),
             (1.0, 1.0, 1.0)),
            ("ball", "sphere", "ball", (0.9, 0.6, 0.3), (0.0, 0.0, 0.0),
             (0.6, 0.6, 0.6))]
    if panel:
        inst.append(("panel", "cube", "panel", (0.0, 3.0, 0.0),
                     (0.0, 0.0, 0.0), (1.5, 0.1, 1.5)))
    pos, target = np.array([0.0, 1.6, 4.5]), np.array([0.0, 0.5, 0.0])
    return dict(
        meshes=dict(plane=plane(1.0), cube=cube(1.0),
                    sphere=sphere(1.0, lat=8, lng=12)),
        materials=materials, instances=inst,
        camera=dict(position=tuple(pos), target=tuple(target),
                    focal_length=35.0, sensor_size=(36.0, 24.0),
                    focus_distance=float(np.linalg.norm(pos - target))),
        textures=dict(tiles=dict(data=tiles, format="linear_rgba"),
                      bumps=dict(data=bumps, format="linear_rgba"),
                      sky=dict(data=sky, format="hdr")),
        environment=dict(constant_color=[0.0, 0.0, 0.0], strength=1.5,
                         texture="sky"))
