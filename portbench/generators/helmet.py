"""A DamagedHelmet-class asset under an HDR sky: one closed helmet-like
shell (a dome with a visor recess on its front, a neck ring and a closed
base) of one metal-rough material with four u8 maps in their glTF slots,
lit by a 2:1 equirectangular sky with a sun disc. Frozen; numpy and
portbench.scenes' primitives only (it needs none of them: the shell is
built here).

The shell is a surface of revolution, a grid of `columns` around and
rows down its profile, with a triangle fan at the top and at the base;
the visor is set back by a quarter of the radius, so that its face and
the brow and cheeks round it see each other, as on the asset.
As many grid quads round the visor's rim as the count needs are split
into four triangles about a centre vertex, which makes the triangle
count any even number, `triangles` exactly. Its uvs are laid out as the asset's
unwrap is: in charts (blocks of `chart` grid cells, each its own patch
of [0, 1]^2 with a gutter round it), so vertices on a chart's border are
repeated with the other chart's uvs, as a glTF exporter repeats them.
Normals are the surface's own, tangents follow u (around the shell) with
the handedness that makes the bitangent follow v.

The maps are drawn from a fixed seed here, each a sum of bilinearly
interpolated value noise, smooth over a few texels:
- "albedo" (srgb_rgba): painted metal, greys with coloured patches;
- "metal_rough" (rough_metal, 2 channels): roughness 0.05-0.95 and metal
  0 or 1 in patches, the glTF image's G and B channels as the program's
  glTF loader keeps them;
- "normal" (linear_rgba): unit tangent-space normals within 30 degrees
  of +z;
- "emissive" (srgb_rgba): black but for a few percent of the texels (the
  visor's and vents' lights).
The sky ("hdr", float32, `sky` = (height, width)) is a gradient from the
zenith to the horizon over a dim ground, with a sun disc 0.53 degrees
across that holds about half of the map's power (luminance over solid
angle). `tex`, `sky` and `triangles` are cut only by the CPU tests.
"""

import numpy as np

F = np.float32
SEED = 20240517
SUN_DIR = (0.55, 0.62, 0.56)       # towards the sun, from the camera's side
SUN_SHARE = 0.5
SUN_DEG = 0.53
VISOR_DEPTH = 0.25                 # the visor's inset, a share of the radius


def _profile(t):
    """(r, y) of the shell's profile, t in [0, 1] from the top pole to the
    centre of the base: a dome to 115 degrees, a neck tucked in with a
    raised ring on it, then the base closing to the axis."""
    t = np.asarray(t, np.float64)
    th = np.radians(115.0) * np.minimum(t, 0.62) / 0.62
    r_d, y_d = np.sin(th), np.cos(th)
    s = np.clip((t - 0.62) / 0.16, 0.0, 1.0)
    h = s * s * (3.0 - 2.0 * s)
    r_n = (1.0 - h) * r_d + h * 0.64
    y_n = (1.0 - s) * y_d + s * -0.56
    ring = 0.045 * np.exp(-((t - 0.70) / 0.018) ** 2)
    b = np.clip((t - 0.78) / 0.22, 0.0, 1.0)
    r = np.where(t <= 0.78, r_n + ring, 0.64 * (1.0 - b))
    r = np.where(t >= 1.0, 0.0, r)      # the base's pole on the axis
    y = np.where(t <= 0.78, y_n, -0.56 - 0.05 * b * b)
    return r, y


def _smoothstep(a, b, x):
    s = np.clip((x - a) / (b - a), 0.0, 1.0)
    return s * s * (3.0 - 2.0 * s)


def _surface(t, phi):
    """World position (..., 3) of the shell at profile t and angle phi
    (phi = pi / 2 faces +z, the front)."""
    r, y = _profile(t)
    dphi = np.angle(np.exp(1j * (phi - np.pi / 2)))
    recess = (VISOR_DEPTH * _smoothstep(0.20, 0.26, t)
              * (1 - _smoothstep(0.48, 0.54, t))
              * (1 - _smoothstep(0.8, 1.0, np.abs(dphi))))
    r = r * (1.0 - recess)
    return np.stack([0.95 * r * np.cos(phi), y, 1.1 * r * np.sin(phi)], -1)


def _normal_tangent(t, phi):
    """Unit outward normal and unit tangent (along phi) of the surface,
    by central differences; the poles take the axis."""
    h = 1e-5
    dt = (_surface(np.minimum(t + h, 1.0), phi)
          - _surface(np.maximum(t - h, 0.0), phi))
    dp = _surface(t, phi + h) - _surface(t, phi - h)
    n = np.cross(dp, dt)
    ln = np.linalg.norm(n, axis=-1, keepdims=True)
    top, bot = t <= 0.0, t >= 1.0
    n = np.where(ln > 1e-12, n / np.maximum(ln, 1e-30), 0.0)
    n[top] = (0.0, 1.0, 0.0)
    n[bot] = (0.0, -1.0, 0.0)
    tg = np.stack([-np.sin(phi), np.zeros_like(phi), np.cos(phi)], -1)
    tg = tg * np.array([0.95, 0.0, 1.1])
    tg = tg / np.linalg.norm(tg, axis=-1, keepdims=True)
    # the handedness that makes cross(n, tangent) * w follow +v (down)
    w = np.where(np.sum(np.cross(n, tg) * dt, -1) >= 0.0, 1.0, -1.0)
    return n, tg, w


def shell(triangles: int = 15452, columns: int = 128, chart=(2, 4)):
    """The helmet shell's mesh arrays with exactly `triangles` (even)."""
    if triangles % 2:
        raise ValueError("the shell's triangle count is even")
    rows = triangles // (2 * columns) + 1    # rows of cells, fans included
    splits = (triangles - 2 * columns * (rows - 1)) // 2
    ca, cb = chart
    if columns % ca:
        raise ValueError("chart width must divide the columns")
    n_cx, n_cy = columns // ca, -(-rows // cb)
    gx = int(np.ceil(np.sqrt(n_cx * n_cy)))
    gy = -(-(n_cx * n_cy) // gx)
    gutter = 0.15

    t_ring = np.linspace(0.0, 1.0, rows + 1)
    # quads split about a centre vertex: around the visor's rim, spread
    quad_cells = [(i, j) for i in range(1, rows - 1) for j in range(columns)]
    rim = sorted(quad_cells, key=lambda c: (
        abs(t_ring[c[0]] - 0.27), abs(np.angle(np.exp(1j * (
            2 * np.pi * c[1] / columns - np.pi / 2))))))
    split = set(rim[:splits])

    verts, index = [], {}

    def chart_uv(i, j, ci, cj):
        """uv of grid point (ring i, column j) inside chart (ci, cj)."""
        k = ci * n_cx + cj
        x0, y0 = (k % gx) / gx, (k // gx) / gy
        lu = (j - cj * ca) / ca
        lv = (i - ci * cb) / min(cb, rows - ci * cb)
        m = gutter * 0.5
        return (x0 + (m + lu * (1 - gutter)) / gx,
                y0 + (m + lv * (1 - gutter)) / gy)

    def vertex(i, j, ci, cj):
        key = (ci, cj, i, j)
        if key not in index:
            index[key] = len(verts)
            verts.append((t_ring[min(max(i, 0), rows)] if float(i).is_integer()
                          else np.interp(i, np.arange(rows + 1), t_ring),
                          2 * np.pi * (j % columns) / columns,
                          chart_uv(i, j, ci, cj)))
        return index[key]

    tris = []
    for i in range(rows):
        for j in range(columns):
            ci, cj = i // cb, j // ca
            if i == 0:                    # top fan: the pole at the cell's middle
                tris.append((vertex(0, j + 0.5, ci, cj),
                             vertex(1, j, ci, cj), vertex(1, j + 1, ci, cj)))
            elif i == rows - 1:           # base fan
                tris.append((vertex(i, j, ci, cj),
                             vertex(i + 1, j + 0.5, ci, cj),
                             vertex(i, j + 1, ci, cj)))
            else:
                a, b = vertex(i, j, ci, cj), vertex(i, j + 1, ci, cj)
                c, d = vertex(i + 1, j, ci, cj), vertex(i + 1, j + 1, ci, cj)
                if (i, j) in split:
                    m = vertex(i + 0.5, j + 0.5, ci, cj)
                    tris += [(m, a, c), (m, c, d), (m, d, b), (m, b, a)]
                else:
                    tris += [(a, c, b), (b, c, d)]
    t = np.array([v[0] for v in verts])
    phi = np.array([v[1] for v in verts])
    uv = np.array([v[2] for v in verts], np.float64)
    pos = _surface(t, phi)
    nrm, tg, w = _normal_tangent(t, phi)
    idx = np.array(tris, np.int64)
    # outward winding: the geometric normal along the surface's
    g = np.cross(pos[idx[:, 1]] - pos[idx[:, 0]], pos[idx[:, 2]] - pos[idx[:, 0]])
    flip = np.sum(g * (nrm[idx[:, 0]] + nrm[idx[:, 1]] + nrm[idx[:, 2]]),
                  -1) < 0
    idx[flip] = idx[flip][:, [0, 2, 1]]
    return dict(positions=pos.astype(F), normals=nrm.astype(F),
                tangents=np.concatenate([tg, w[:, None]], -1).astype(F),
                uvs=uv.astype(F), indices=idx.astype(np.uint32))


def _noise(rng, side, cell):
    """(side, side) value noise in [0, 1], bilinear between lattice
    points `cell` texels apart."""
    n = side // cell + 2
    lat = rng.random((n, n))
    x = (np.arange(side) + 0.5) / cell
    i0 = np.floor(x).astype(np.int64)
    f = x - i0
    rows = lat[i0] * (1 - f)[:, None] + lat[i0 + 1] * f[:, None]
    return rows[:, i0] * (1 - f)[None, :] + rows[:, i0 + 1] * f[None, :]


def _octaves(rng, side, cells, weights):
    out = sum(w * _noise(rng, side, max(1, min(c, side))) for c, w in
              zip(cells, weights))
    return out / sum(weights)


def _u8(x):
    return np.clip(np.rint(x * 255.0), 0, 255).astype(np.uint8)


def maps(tex: int = 2048) -> dict:
    """The four u8 maps at tex x tex."""
    rng = np.random.default_rng(SEED)
    s = tex / 2048.0
    cells = [max(2, int(c * s)) for c in (256, 64, 16, 4)]
    paint = _octaves(rng, tex, cells, (4, 2, 1, 0.5))
    patch = _smoothstep(0.47, 0.53, _octaves(rng, tex, cells[:2], (3, 1)))
    tint = np.stack([0.62, 0.48, 0.30])
    grey = 0.25 + 0.5 * paint
    rgb = grey[..., None] * ((1 - patch)[..., None] + patch[..., None] * tint)
    albedo = np.concatenate([_u8(rgb), np.full((tex, tex, 1), 255, np.uint8)],
                            -1)
    rough = 0.05 + 0.9 * _octaves(rng, tex, cells, (1, 2, 2, 1))
    metal = _smoothstep(0.45, 0.55, _octaves(rng, tex, cells[:3], (3, 2, 1)))
    metal_rough = np.stack([_u8(rough), _u8(metal)], -1)
    ang = np.radians(30.0) * _octaves(rng, tex, cells[1:], (1, 2, 2)) ** 1.5
    az = 2 * np.pi * _octaves(rng, tex, cells[1:], (2, 1, 1))
    nrm = np.stack([np.sin(ang) * np.cos(az), np.sin(ang) * np.sin(az),
                    np.cos(ang)], -1)
    normal = np.concatenate([_u8(nrm * 0.5 + 0.5),
                             np.full((tex, tex, 1), 255, np.uint8)], -1)
    glow = _octaves(rng, tex, cells[1:], (2, 1, 1))
    lit = _smoothstep(np.quantile(glow, 0.965), np.quantile(glow, 0.975), glow)
    hue = np.where(_noise(rng, tex, cells[0])[..., None] < 0.5,
                   np.array([1.0, 0.55, 0.2]), np.array([0.35, 0.8, 1.0]))
    emissive = np.concatenate([_u8(lit[..., None] * hue),
                               np.full((tex, tex, 1), 255, np.uint8)], -1)
    return dict(albedo=dict(data=albedo, format="srgb_rgba"),
                metal_rough=dict(data=metal_rough, format="rough_metal"),
                normal=dict(data=normal, format="linear_rgba"),
                emissive=dict(data=emissive, format="srgb_rgba"))


def sky(height: int = 1024, width: int = 2048) -> np.ndarray:
    """(height, width, 3) float32 radiance: zenith to horizon, a dim
    ground, and a sun disc SUN_DEG across holding SUN_SHARE of the power
    (BT.709 luminance over solid angle)."""
    theta = (np.arange(height) + 0.5) / height * np.pi
    phi = (np.arange(width) + 0.5) / width * 2 * np.pi
    up = np.cos(theta)
    a = np.clip(up, 0.0, 1.0) ** 0.5
    zen, hor = np.array([0.22, 0.38, 0.85]), np.array([0.85, 0.88, 0.92])
    ground = np.array([0.09, 0.08, 0.07])
    row = np.where((up > 0)[:, None], hor * (1 - a)[:, None] + zen * a[:, None],
                   ground * (0.6 + 0.4 * np.exp(up * 8.0))[:, None])
    px = np.broadcast_to(row[:, None, :], (height, width, 3)).copy()
    st, ct = np.sin(theta)[:, None], np.cos(theta)[:, None]
    d = np.stack([-np.cos(phi)[None, :] * st, np.broadcast_to(ct, (height, width)),
                  -np.sin(phi)[None, :] * st], -1)
    sun = np.asarray(SUN_DIR, np.float64)
    sun /= np.linalg.norm(sun)
    disc = np.sum(d * sun, -1) >= np.cos(np.radians(SUN_DEG) / 2)
    if not disc.any():                    # a small map: the nearest texel
        disc.flat[np.argmax(np.sum(d * sun, -1))] = True
    luma = np.array([0.2126, 0.7152, 0.0722])
    solid = np.broadcast_to(st, (height, width))
    sky_power = np.sum((px @ luma) * solid * ~disc)
    sun_rgb = np.array([1.0, 0.93, 0.82])
    k = SUN_SHARE / (1 - SUN_SHARE) * sky_power / (
        np.sum(solid[disc]) * (sun_rgb @ luma))
    px[disc] = sun_rgb * k
    return px.astype(F)


def make(tex: int = 2048, sky_size=(1024, 2048), triangles: int = 15452,
         columns: int = 128, chart=(2, 4)) -> dict:
    """The scene arrays (portbench/scenes.py lists the keys)."""
    mesh = shell(triangles, columns, tuple(chart))
    textures = maps(tex)
    textures["sky"] = dict(data=sky(*sky_size), format="hdr")
    materials = dict(helmet=dict(
        base_color=(1.0, 1.0, 1.0, 1.0), metallic=1.0, roughness=1.0,
        emission=(1.0, 1.0, 1.0), emission_strength=1.0,
        textures=dict(base_color="albedo", roughness_metallic="metal_rough",
                      normal="normal", emission="emissive")))
    target = np.array([0.0, 0.2, 0.0])
    view = np.array([np.sin(np.radians(28)) * np.cos(np.radians(12)),
                     np.sin(np.radians(12)),
                     np.cos(np.radians(28)) * np.cos(np.radians(12))])
    pos = target + 5.3 * view
    return dict(
        meshes=dict(helmet=mesh), materials=materials,
        instances=[("helmet", "helmet", "helmet", (0.0, 0.0, 0.0),
                    (0.0, 0.0, 0.0), (1.0, 1.0, 1.0))],
        camera=dict(position=tuple(float(x) for x in pos),
                    target=tuple(float(x) for x in target),
                    focal_length=50.0, sensor_size=(36.0, 24.0),
                    focus_distance=float(np.linalg.norm(pos - target))),
        textures=textures,
        environment=dict(constant_color=[0.0, 0.0, 0.0], strength=1.0,
                         texture="sky"))
