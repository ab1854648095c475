"""A Bistro-Exterior-class street under an HDR sky: a Paris street canyon
of stone façades with window and balcony relief, a cobbled roadway, a
café terrace of tables and chairs, two rows of trees and a line of
planters whose canopies are alpha-cut leaf cards, and strings of small
emissive bulbs hung across the street, lit by a 2:1 equirectangular sky
with a sun about 35 degrees up. Frozen; numpy and portbench.scenes'
primitives only (the shapes are built here; `sky` is a copy of
generators/helmet.py's with this scene's sun).

The street runs along -z from the camera, `bays` façade bays of BAY
metres on each side at x = +-HALF_WIDTH. Every mesh is in world space
(each instance's transform is the identity) and holds a few thousand
triangles: a façade bay (every floor of it), a chunk of a canopy, a
stretch of cobbles, a table set, a string of bulbs. Faces are flat;
normals and tangents (along u, handedness +1) are each face's own.

- Façades: piers, spandrels and lintels (the "facade" map, planar uvs),
  recessed windows with frames, muntins and louvred shutters, stone sills
  and lintels, on the upper floors balconies with a slab and a railing
  of turned balusters; shop fronts on the ground floor; a cornice.
- Roadway: cobbles of `cobble` metres, each a box's top and four sides,
  their heights jittered, in offset rows; raised sidewalks with curbs,
  and a ground plane round it all.
- Café: round tables on pedestals with chairs of bent legs and slatted
  seats and backs, on the right sidewalk.
- Trees: lathed trunks with tapered branches; a canopy of `cards` leaf
  cards in an ellipsoidal shell, each card a quad a leaf wide whose uvs
  cover one leaf of a 4 x 4 leaf atlas, its normal outward within a
  cone; planters with bushes of cards.
- Lights: `strings` catenaries across the street, `bulbs` bulbs each
  (a hexagonal bipyramid, 12 emissive triangles) on a thin wire.

Textures: two `tex` x `tex` srgb_rgba leaf atlases ("leaves_a",
"leaves_b"), 4 x 4 leaf silhouettes, alpha 0 outside the leaves and
softened over about a texel and a half at their edges, about half the
texels opaque; one opaque srgb_rgba façade albedo ("facade", plaster
and stone courses). The sky ("hdr", float32, `sky_size` = (height,
width)) is a gradient from the zenith to the horizon over a dim ground,
with a sun disc 0.53 degrees across that holds half of the map's power.
`bays`, `cards`, `tex`, `sky_size` and the other counts are cut, and
`leaf` widened, only by the tests.
"""

import numpy as np

F = np.float32
SEED = 20240611
BAY = 3.0                        # metres a façade bay
FLOOR = 3.4                      # metres a storey
FLOORS = 5
HALF_WIDTH = 6.0                 # façade to the street's axis
SIDEWALK = 2.5
SUN_ELEVATION = 35.0             # degrees
SUN_AZIMUTH = 15.0               # degrees from -z (down the street) to +x
SUN_SHARE = 0.5
SUN_DEG = 0.53
CHUNK = 4000                     # triangles a canopy or cobble mesh
TREE_PITCH = 8.0                 # metres between trees, planters, tables
PLANTER_PITCH = 5.7              # and strings of bulbs along the street
TABLE_PITCH = 2.0
STRING_PITCH = 3.9
LEAF = 0.13                      # metres a tree's leaf card, and a bush's
BUSH_LEAF = 0.14
EYE = (1.2, 1.7, -1.0)           # the camera, and the point it looks at,
LOOK_AT = (-0.8, 7.5, -40.0)     # from the street's front end


def _sun_dir():
    el, az = np.radians(SUN_ELEVATION), np.radians(SUN_AZIMUTH)
    return (np.sin(az) * np.cos(el), np.sin(el), -np.cos(az) * np.cos(el))


# ---------------------------------------------------------------------------
# Mesh assembly
# ---------------------------------------------------------------------------

class _Parts:
    """Triangles gathered by material, each part one face-flat piece:
    positions (n, 3), per-vertex normals, tangents (n, 4), uvs, indices."""

    def __init__(self):
        self.items = []

    def add(self, mat, pos, nrm, tan, uv, idx):
        self.items.append((mat, np.asarray(pos, np.float64),
                           np.asarray(nrm, np.float64),
                           np.asarray(tan, np.float64),
                           np.asarray(uv, np.float64),
                           np.asarray(idx, np.int64)))

    def meshes(self):
        """{material: mesh arrays} with every part of a material joined."""
        out = {}
        for mat in dict.fromkeys(m for m, *_ in self.items):
            parts = [p for p in self.items if p[0] == mat]
            base = np.cumsum([0] + [len(p[1]) for p in parts])[:-1]
            out[mat] = dict(
                positions=np.concatenate([p[1] for p in parts]).astype(F),
                normals=np.concatenate([p[2] for p in parts]).astype(F),
                tangents=np.concatenate([p[3] for p in parts]).astype(F),
                uvs=np.concatenate([p[4] for p in parts]).astype(F),
                indices=np.concatenate([p[5] + b for p, b in
                                        zip(parts, base)]).astype(np.uint32))
        return out


def _unit(v):
    return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-12)


def _planar_uv(pos, nrm, scale=0.25):
    """World-planar uvs: the face's two axes other than its normal's
    largest, `scale` repeats a metre."""
    a = np.abs(nrm).argmax(-1)
    u = np.where(a == 0, pos[:, 2], pos[:, 0])
    v = np.where(a == 1, pos[:, 2], pos[:, 1])
    return np.stack([u, -v], -1) * scale


_BOX_FACES = np.array([(0, 0, 1), (1, 0, 0), (0, 0, -1), (-1, 0, 0),
                       (0, 1, 0), (0, -1, 0)], np.float64)


def _box_template(faces):
    """Unit-cube corners (4 a face), normals and tangents of `faces`."""
    pos, nrm, tan = [], [], []
    for fn in _BOX_FACES[list(faces)]:
        up = (np.array([1.0, 0, 0]) if abs(fn[1]) == 1.0
              else np.array([0.0, 1.0, 0]))
        right = np.cross(up, fn)
        for a, b in ((1, -1), (1, 1), (-1, -1), (-1, 1)):
            pos.append((fn + up * a + right * b) * 0.5)
            nrm.append(fn)
            tan.append(right)
    return np.array(pos), np.array(nrm), np.array(tan)


def boxes(parts, mat, lo, hi, yaw=None, faces=range(6), uv_scale=0.25):
    """Axis-aligned boxes [lo, hi] (n, 3), each turned by `yaw` (n,)
    radians about its centre's vertical; `faces` picks the cube's faces
    (+z, +x, -z, -x, +y, -y)."""
    lo, hi = np.atleast_2d(lo).astype(np.float64), np.atleast_2d(hi)
    n = len(lo)
    tp, tn, tt = _box_template(faces)
    k = len(tp)
    size, mid = hi - lo, (hi + lo) * 0.5
    local = tp[None] * size[:, None, :]
    if yaw is None:
        yaw = np.zeros(n)
    c, s = np.cos(yaw)[:, None], np.sin(yaw)[:, None]

    def turn(v):
        return np.stack([c * v[..., 0] + s * v[..., 2], v[..., 1] + 0 * c,
                         -s * v[..., 0] + c * v[..., 2]], -1)

    pos = (turn(local) + mid[:, None, :]).reshape(-1, 3)
    nrm = turn(np.broadcast_to(tn, (n, k, 3))).reshape(-1, 3)
    tan = turn(np.broadcast_to(tt, (n, k, 3))).reshape(-1, 3)
    quad = np.array([[0, 2, 1], [1, 2, 3]])
    idx = (np.arange(len(faces) * n)[:, None, None] * 4 + quad).reshape(-1, 3)
    parts.add(mat, pos, nrm, np.concatenate([tan, np.ones((len(tan), 1))], -1),
              _planar_uv(pos, nrm, uv_scale), idx)


def lathe(parts, mat, base, axis, profile, sides):
    """Surfaces of revolution: for each of n instances, a ring of `sides`
    around `axis` (n, 3) from `base` (n, 3), radius profile (n, rings)
    at heights (n, rings) along the axis; flat faces, uvs around and
    along."""
    base, axis = np.atleast_2d(base), _unit(np.atleast_2d(axis))
    radius, height = profile
    n, rings = radius.shape
    ref = np.where(np.abs(axis[:, 1:2]) > 0.9, [[1.0, 0, 0]], [[0, 1.0, 0]])
    e1 = _unit(np.cross(axis, ref))
    e2 = np.cross(axis, e1)
    th = np.linspace(0.0, 2 * np.pi, sides + 1)
    ring = (np.cos(th)[None, :, None] * e1[:, None, :]
            + np.sin(th)[None, :, None] * e2[:, None, :])       # (n, s+1, 3)
    pts = (base[:, None, None, :] + axis[:, None, None, :]
           * height[:, :, None, None]
           + radius[:, :, None, None] * ring[:, None, :, :])      # (n, r, s+1, 3)
    a = pts[:, :-1, :-1]
    b = pts[:, :-1, 1:]
    c = pts[:, 1:, :-1]
    d = pts[:, 1:, 1:]
    quads = np.stack([a, b, c, d], 3).reshape(-1, 4, 3)
    g = _unit(np.cross(quads[:, 1] - quads[:, 0], quads[:, 2] - quads[:, 0]))
    out = np.sum(g * (quads[:, 0] - np.repeat(
        base, (rings - 1) * sides, 0)), -1) < 0
    g[out] = -g[out]
    tan = _unit(quads[:, 1] - quads[:, 0])
    uu = np.broadcast_to(th[None, None, :-1] / (2 * np.pi),
                         (n, rings - 1, sides)).reshape(-1)
    vv = np.broadcast_to(np.arange(rings - 1)[None, :, None] / rings,
                         (n, rings - 1, sides)).reshape(-1)
    du, dv = 1.0 / sides, 1.0 / rings
    uv = np.stack([np.stack([uu, vv], -1), np.stack([uu + du, vv], -1),
                   np.stack([uu, vv + dv], -1),
                   np.stack([uu + du, vv + dv], -1)], 1)
    pos = quads.reshape(-1, 3)
    nrm = np.repeat(g, 4, 0)
    tn = np.concatenate([np.repeat(tan, 4, 0), np.ones((len(pos), 1))], -1)
    # faces wound with their normal
    q = np.arange(len(quads))[:, None, None] * 4
    idx = (q + np.array([[0, 1, 2], [1, 3, 2]])).reshape(-1, 3)
    flip = np.repeat(out, 2)
    idx[flip] = idx[flip][:, [0, 2, 1]]
    parts.add(mat, pos, nrm, tn, uv.reshape(-1, 2), idx)


def leaf_cards(parts, mat, centre, normal, spin, size, cell, grid=4, inset=0.02):
    """Leaf cards: one quad each, centred at `centre` (n, 3), facing
    `normal`, turned by `spin` about it, `size` (n,) wide, its uvs the
    leaf atlas cell `cell` (n, 2) of a grid x grid atlas."""
    nrm = _unit(normal)
    ref = np.where(np.abs(nrm[:, 1:2]) > 0.9, [[1.0, 0, 0]], [[0, 1.0, 0]])
    a = _unit(np.cross(ref, nrm))
    b = np.cross(nrm, a)
    c, s = np.cos(spin)[:, None], np.sin(spin)[:, None]
    t, bt = c * a + s * b, -s * a + c * b
    h = 0.5 * size[:, None]
    corners = np.stack([centre - t * h - bt * h, centre + t * h - bt * h,
                        centre - t * h + bt * h, centre + t * h + bt * h], 1)
    u0 = (cell[:, 0] + inset) / grid
    v0 = (cell[:, 1] + inset) / grid
    u1 = (cell[:, 0] + 1 - inset) / grid
    v1 = (cell[:, 1] + 1 - inset) / grid
    # v grows down the image, b grows up the card
    uv = np.stack([np.stack([u0, v1], -1), np.stack([u1, v1], -1),
                   np.stack([u0, v0], -1), np.stack([u1, v0], -1)], 1)
    n = len(centre)
    q = np.arange(n)[:, None, None] * 4
    idx = (q + np.array([[0, 1, 2], [1, 3, 2]])).reshape(-1, 3)
    parts.add(mat, corners.reshape(-1, 3), np.repeat(nrm, 4, 0),
              np.concatenate([np.repeat(t, 4, 0), np.ones((4 * n, 1))], -1),
              uv.reshape(-1, 2), idx)


def bulbs(parts, mat, centre, radius):
    """Hexagonal bipyramids (12 triangles each) at `centre` (n, 3)."""
    n = len(centre)
    th = np.arange(6) * np.pi / 3
    ring = np.stack([np.cos(th), np.zeros(6), np.sin(th)], -1)
    verts = np.concatenate([ring, [[0, 1.3, 0], [0, -1.3, 0]]])
    faces = [(6, (j + 1) % 6, j) for j in range(6)] + \
        [(7, j, (j + 1) % 6) for j in range(6)]
    pos = (centre[:, None, :] + radius * verts[None]).reshape(-1, 3)
    nrm = np.broadcast_to(_unit(verts), (n, 8, 3)).reshape(-1, 3)
    tan = np.broadcast_to(np.array([1.0, 0, 0, 1]), (n * 8, 4))
    uv = np.broadcast_to((verts[:, [0, 2]] + 1) * 0.5, (n, 8, 2)).reshape(-1, 2)
    idx = (np.arange(n)[:, None, None] * 8 + np.array(faces)).reshape(-1, 3)
    parts.add(mat, pos, nrm, tan, uv, idx)


# ---------------------------------------------------------------------------
# The street's pieces
# ---------------------------------------------------------------------------

def facade_bay(parts, side, z0, balusters):
    """One bay of one side's façade, every floor, at z0 .. z0 - BAY (side
    +1 the right, -1 the left; the wall's face at x = side * HALF_WIDTH)."""
    x = side * HALF_WIDTH
    back = x + side * 0.6                       # the wall's thickness
    zc = z0 - BAY / 2
    win_w = 1.3
    for f in range(FLOORS):
        y0 = f * FLOOR
        wy0, wy1 = (y0 + 0.3, y0 + 2.9) if f == 0 else (y0 + 0.9, y0 + 3.0)
        ww = 2.2 if f == 0 else win_w
        # piers, spandrel, lintel (the plaster map)
        lo = np.array([[min(x, back), y0, z0 - BAY], [min(x, back), y0, zc + ww / 2],
                       [min(x, back), y0, zc - ww / 2], [min(x, back), wy1, zc - ww / 2]])
        hi = np.array([[max(x, back), y0 + FLOOR, zc - ww / 2],
                       [max(x, back), y0 + FLOOR, z0],
                       [max(x, back), wy0, zc + ww / 2],
                       [max(x, back), y0 + FLOOR, zc + ww / 2]])
        boxes(parts, "facade", lo, hi)
        # the window recess: glass at 0.25 m in, frame, muntins
        gx = x + side * 0.25
        boxes(parts, "glass", [[min(gx, gx + side * 0.02), wy0, zc - ww / 2]],
              [[max(gx, gx + side * 0.02), wy1, zc + ww / 2]],
              faces=(1,) if side < 0 else (3,))
        t = 0.06
        fl = np.array([[wy0, zc - ww / 2], [wy0, zc + ww / 2 - t],
                       [wy0, zc - ww / 2], [wy1 - t, zc - ww / 2],
                       [wy0, zc - t / 2], [(wy0 + wy1) / 2 - t / 2, zc - ww / 2]])
        fh = np.array([[wy1, zc - ww / 2 + t], [wy1, zc + ww / 2],
                       [wy0 + t, zc + ww / 2], [wy1, zc + ww / 2],
                       [wy1, zc + t / 2], [(wy0 + wy1) / 2 + t / 2, zc + ww / 2]])
        fx0, fx1 = sorted((gx - side * 0.08, gx))
        boxes(parts, "frame",
              np.column_stack([np.full(6, fx0), fl]),
              np.column_stack([np.full(6, fx1), fh]))
        # stone sill and lintel
        sx0, sx1 = sorted((x - side * 0.12, x + side * 0.05))
        boxes(parts, "stone", [[sx0, wy0 - 0.12, zc - ww / 2 - 0.15],
                               [sx0, wy1, zc - ww / 2 - 0.15]],
              [[sx1, wy0, zc + ww / 2 + 0.15],
               [sx1, wy1 + 0.2, zc + ww / 2 + 0.15]])
        if f == 0:
            continue
        # louvred shutters, open against the wall either side
        slats = 12
        sy = np.linspace(wy0 + 0.1, wy1 - 0.2, slats)
        for zs in (zc + ww / 2 + 0.05, zc - ww / 2 - 0.05 - ww / 2):
            ox0, ox1 = sorted((x - side * 0.03, x - side * 0.07))
            lo = np.column_stack([np.full(slats, ox0), sy,
                                  np.full(slats, zs)])
            hi = np.column_stack([np.full(slats, ox1), sy + 0.16,
                                  np.full(slats, zs + ww / 2)])
            boxes(parts, "shutter", lo, hi)
            boxes(parts, "shutter", [[ox0, wy0, zs], [ox0, wy0, zs + ww / 2 - 0.05]],
                  [[ox1, wy1, zs + 0.05], [ox1, wy1, zs + ww / 2]])
        # the balcony: slab and a railing of turned balusters
        depth = 0.8
        bx0, bx1 = sorted((x, x - side * depth))
        boxes(parts, "stone", [[bx0, y0 + 0.75, zc - 1.2]],
                              [[bx1, y0 + 0.9, zc + 1.2]])
        bz = np.linspace(zc - 1.1, zc + 1.1, balusters)
        bxs = x - side * (depth - 0.06)
        base = np.column_stack([np.full(balusters, bxs),
                                np.full(balusters, y0 + 0.9), bz])
        prof_h = np.array([0.0, 0.05, 0.18, 0.3, 0.45, 0.62, 0.8, 0.9])
        prof_r = np.array([0.035, 0.03, 0.045, 0.025, 0.02, 0.03, 0.022, 0.03])
        lathe(parts, "iron", base, np.tile([0.0, 1.0, 0.0], (balusters, 1)),
              (np.tile(prof_r, (balusters, 1)),
               np.tile(prof_h, (balusters, 1))), 6)
        rx0, rx1 = sorted((bxs - 0.04, bxs + 0.04))
        boxes(parts, "iron", [[rx0, y0 + 1.8, zc - 1.2]],
                             [[rx1, y0 + 1.86, zc + 1.2]])
    # the cornice: three stepped courses along the top
    top = FLOORS * FLOOR
    for k, (dx, h) in enumerate(((0.15, 0.25), (0.3, 0.2), (0.45, 0.15))):
        cx0, cx1 = sorted((x, x - side * dx))
        boxes(parts, "stone", [[cx0, top + 0.2 * k, z0 - BAY]],
                              [[cx1, top + 0.2 * k + h, z0]])


def table_set(parts, rng, centre):
    """A round café table on a pedestal and three chairs round it."""
    cx, cz = centre
    lathe(parts, "tabletop", [[cx, 0.72, cz]], [[0.0, 1.0, 0.0]],
          (np.array([[0.001, 0.35, 0.36, 0.35, 0.001]]),
           np.array([[0.0, 0.0, 0.02, 0.04, 0.04]])), 24)
    lathe(parts, "iron", [[cx, 0.15, cz]], [[0.0, 1.0, 0.0]],
          (np.array([[0.04, 0.03, 0.03, 0.05]]),
           np.array([[0.0, 0.1, 0.5, 0.57]])), 10)
    lathe(parts, "iron", [[cx, 0.15, cz]], [[0.0, 1.0, 0.0]],
          (np.array([[0.001, 0.25, 0.25, 0.001]]),
           np.array([[0.0, 0.0, 0.03, 0.03]])), 16)
    for k in range(3):
        a = 2 * np.pi * k / 3 + rng.uniform(-0.3, 0.3)
        px, pz = cx + 0.62 * np.cos(a), cz + 0.62 * np.sin(a)
        # four splayed legs: two lathed tubes each
        for lx, lz in ((0.18, 0.18), (0.18, -0.18), (-0.18, 0.18),
                       (-0.18, -0.18)):
            c, s = np.cos(a), np.sin(a)
            fx, fz = px + c * lx - s * lz, pz + s * lx + c * lz
            out = np.array([[c * lx - s * lz, 0.0, s * lx + c * lz]])
            lathe(parts, "iron", [[fx, 0.0, fz]],
                  _unit(np.array([[0, 1.0, 0]]) - out),
                  (np.full((1, 4), 0.012), np.array([[0.0, 0.15, 0.3, 0.46]])),
                  6)
        # the seat's slats and the back's
        slat_z = np.linspace(-0.18, 0.18, 8)
        lo = np.column_stack([np.full(8, -0.2), np.full(8, 0.45), slat_z - 0.02])
        hi = np.column_stack([np.full(8, 0.2), np.full(8, 0.47), slat_z + 0.02])
        _turned_boxes(parts, "wicker", lo, hi, a, (px, pz))
        back_y = np.linspace(0.55, 0.9, 6)
        lo = np.column_stack([np.full(6, 0.2), back_y, np.full(6, -0.2)])
        hi = np.column_stack([np.full(6, 0.23), back_y + 0.04, np.full(6, 0.2)])
        _turned_boxes(parts, "wicker", lo, hi, a, (px, pz))


def _turned_boxes(parts, mat, lo, hi, a, at):
    """Boxes given about a chair's own origin, turned by a and moved to
    `at` (x, z)."""
    mid = (lo + hi) * 0.5
    c, s = np.cos(a), np.sin(a)
    wx = at[0] + c * mid[:, 0] - s * mid[:, 2]
    wz = at[1] + s * mid[:, 0] + c * mid[:, 2]
    ctr = np.column_stack([wx, mid[:, 1], wz])
    half = (hi - lo) * 0.5
    boxes(parts, mat, ctr - half, ctr + half, yaw=np.full(len(lo), -a))


def tree(parts, rng, base, crown, radii, n_cards, leaf_mat, card_size):
    """A trunk with five branches and a canopy of leaf cards in the shell
    of the ellipsoid `radii` about `crown`."""
    bx, by, bz = base
    lathe(parts, "bark", [base], [[0.0, 1.0, 0.0]],
          (np.array([np.linspace(0.22, 0.13, 12)]),
           np.array([np.linspace(0.0, crown[1] - by - 0.5, 12)])), 14)
    tip = np.array([bx, crown[1] - 0.5, bz])
    dirs = _unit(np.column_stack([rng.normal(size=5), np.full(5, 1.2),
                                  rng.normal(size=5)]))
    lens = rng.uniform(1.6, 2.6, 5)
    lathe(parts, "bark", np.repeat(tip[None], 5, 0), dirs,
          (np.outer(np.ones(5), np.linspace(0.1, 0.03, 7)),
           np.outer(lens, np.linspace(0.0, 1.0, 7))), 8)
    u = rng.normal(size=(n_cards, 3))
    u = _unit(u)
    r = rng.uniform(0.55, 1.0, n_cards) ** 0.5
    centre = np.asarray(crown) + u * np.asarray(radii) * r[:, None]
    normal = _unit(u / np.asarray(radii) + 0.6 * rng.normal(size=(n_cards, 3)))
    spin = rng.uniform(0, 2 * np.pi, n_cards)
    size = card_size * rng.uniform(0.8, 1.2, n_cards)
    cell = rng.integers(0, 4, (n_cards, 2))
    leaf_cards(parts, leaf_mat, centre, normal, spin, size, cell)


# ---------------------------------------------------------------------------
# Textures
# ---------------------------------------------------------------------------

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


def _u8(x):
    return np.clip(np.rint(x * 255.0), 0, 255).astype(np.uint8)


def leaf_atlas(rng, tex, hue):
    """(tex, tex, 4) u8: 4 x 4 cells, a leaf silhouette in each (a pointed
    blade with lobes, turned a little), alpha 0 outside, softened over
    about a texel and a half; the blade's green varies with its veins."""
    cell = tex // 4
    y, x = np.mgrid[0:cell, 0:cell]
    px = (x + 0.5) / cell * 2 - 1
    py = (y + 0.5) / cell * 2 - 1
    img = np.zeros((tex, tex, 4), np.float64)
    for i in range(4):
        for j in range(4):
            a = rng.uniform(-0.4, 0.4)
            c, s = np.cos(a), np.sin(a)
            qx, qy = c * px - s * py, s * px + c * py
            lobes = rng.integers(3, 6)
            t = np.clip((qy + 0.95) / 1.85, 0.0, 1.0)          # base to tip
            width = 0.8 * np.sin(np.pi * t) ** 0.7 * (
                1 + 0.18 * np.cos(lobes * np.pi * t))
            d = (np.abs(qx) - width) * cell / 2                 # texels out
            d = np.where((qy < -0.95) | (qy > 0.9), np.maximum(
                d, (np.abs(qy) - 0.92) * cell / 2), d)
            alpha = np.clip(0.5 - d / 1.5, 0.0, 1.0)
            vein = np.exp(-(qx / 0.03) ** 2) + 0.5 * np.exp(
                -((np.abs(qx) - 0.5 * (qy + 1) * 0.3) / 0.02) ** 2)
            g = hue * (0.75 + 0.25 * rng.uniform()) * (1 + 0.25 * vein[..., None])
            sl = (slice(j * cell, (j + 1) * cell), slice(i * cell, (i + 1) * cell))
            img[sl[0], sl[1], :3] = g
            img[sl[0], sl[1], 3] = alpha
    shade = 0.85 + 0.3 * _noise(rng, tex, max(2, tex // 64))
    img[..., :3] = np.clip(img[..., :3] * shade[..., None], 0, 1)
    return _u8(img)


def facade_map(rng, tex):
    """(tex, tex, 4) u8 opaque: warm plaster with stone courses every
    eighth of the map and a little grime."""
    base = 0.62 + 0.1 * _noise(rng, tex, max(2, tex // 32)) \
        + 0.05 * _noise(rng, tex, max(2, tex // 256))
    v = (np.arange(tex) + 0.5) / tex * 8
    course = np.abs(v - np.rint(v)) < 0.02
    grime = np.linspace(0.85, 1.0, tex)[:, None]
    lum = np.where(course[:, None], base * 0.7, base) * grime
    rgb = lum[..., None] * np.array([1.0, 0.93, 0.82])
    return np.concatenate([_u8(rgb), np.full((tex, tex, 1), 255, np.uint8)],
                          -1)


def sky(height: int = 1024, width: int = 2048) -> np.ndarray:
    """(height, width, 3) float32 radiance: zenith to horizon, a dim
    ground, and a sun disc SUN_DEG across holding SUN_SHARE of the power
    (BT.709 luminance over solid angle); generators/helmet.py's sky with
    this scene's sun."""
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
    sun = np.asarray(_sun_dir(), np.float64)
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


# ---------------------------------------------------------------------------
# The scene
# ---------------------------------------------------------------------------

MATERIALS = dict(
    facade=dict(base_color=(1.0, 1.0, 1.0, 1.0), roughness=0.85,
                textures=dict(base_color="facade")),
    stone=dict(base_color=(0.78, 0.74, 0.66, 1.0), roughness=0.7),
    frame=dict(base_color=(0.82, 0.82, 0.78, 1.0), roughness=0.5),
    glass=dict(base_color=(0.05, 0.06, 0.07, 1.0), roughness=0.08),
    shutter=dict(base_color=(0.22, 0.36, 0.3, 1.0), roughness=0.6),
    iron=dict(base_color=(0.12, 0.12, 0.12, 1.0), metallic=1.0,
              roughness=0.45),
    cobble=dict(base_color=(0.42, 0.4, 0.37, 1.0), roughness=0.8),
    sidewalk=dict(base_color=(0.56, 0.54, 0.5, 1.0), roughness=0.9),
    bark=dict(base_color=(0.3, 0.24, 0.18, 1.0), roughness=0.9),
    leaves_a=dict(base_color=(1.0, 1.0, 1.0, 1.0), roughness=0.55,
                  textures=dict(base_color="leaves_a")),
    leaves_b=dict(base_color=(1.0, 1.0, 1.0, 1.0), roughness=0.55,
                  textures=dict(base_color="leaves_b")),
    tabletop=dict(base_color=(0.86, 0.85, 0.8, 1.0), roughness=0.3),
    wicker=dict(base_color=(0.55, 0.36, 0.2, 1.0), roughness=0.7),
    planter=dict(base_color=(0.55, 0.32, 0.22, 1.0), roughness=0.8),
    wire=dict(base_color=(0.03, 0.03, 0.03, 1.0), roughness=0.6),
    bulb=dict(base_color=(0.0, 0.0, 0.0, 1.0), emission=(1.0, 0.78, 0.5),
              emission_strength=30.0),
)


def _mesh_slices(m, limit):
    """A joined mesh as pieces of at most `limit` triangles, each with the
    vertices it uses."""
    idx = m["indices"].astype(np.int64)
    out = []
    step = max(2, limit - limit % 2)
    for a in range(0, len(idx), step):
        sub = idx[a:a + step]
        used, inv = np.unique(sub, return_inverse=True)
        out.append(dict(positions=m["positions"][used],
                        normals=m["normals"][used],
                        tangents=m["tangents"][used], uvs=m["uvs"][used],
                        indices=inv.reshape(-1, 3).astype(np.uint32)))
    return out


def make(bays: int = 40, cards: int = 21500, bush_cards: int = 3500,
         trees_per_side: int = 15, planters: int = 20, tables: int = 36,
         strings: int = 30, bulbs_per_string: int = 50,
         cobble: float = 0.16, balusters: int = 28, leaf: float = LEAF,
         tex: int = 2048, sky_size=(1024, 2048)) -> dict:
    """The scene arrays (portbench/scenes.py lists the keys)."""
    rng = np.random.default_rng(SEED)
    length = bays * BAY
    z_front = 6.0                              # behind the camera
    groups = []                                # (name, parts)

    def group(name):
        p = _Parts()
        groups.append((name, p))
        return p

    for side in (-1, 1):
        for b in range(bays):
            facade_bay(group(f"bay_{side}_{b}"), side,
                       z_front - b * BAY, balusters)

    # the roadway's cobbles, domed, their heights jittered; sidewalks
    road = HALF_WIDTH - SIDEWALK
    nx = int(round(2 * road / cobble))
    nz = int(round((length + z_front) / cobble))
    gx, gz = np.meshgrid((np.arange(nx) + 0.5) * cobble - road,
                         z_front - (np.arange(nz) + 0.5) * cobble)
    gz = gz + (np.arange(nx)[None, :] % 2) * cobble * 0.5
    c = np.column_stack([gx.ravel(), gz.ravel()])
    h = 0.06 + 0.02 * rng.random(len(c))
    g = 0.45 * cobble
    road_p = group("cobbles")
    boxes(road_p, "cobble", np.column_stack([c[:, 0] - g, np.zeros(len(c)),
                                             c[:, 1] - g]),
          np.column_stack([c[:, 0] + g, h, c[:, 1] + g]),
          faces=(0, 1, 2, 3, 4))
    walk = group("sidewalks")
    for side in (-1, 1):
        x0, x1 = sorted((side * road, side * HALF_WIDTH))
        boxes(walk, "sidewalk", [[x0, 0.0, z_front - length]],
              [[x1, 0.15, z_front]], faces=(1, 3, 4))
    boxes(walk, "cobble", [[-200.0, -0.02, -400.0]], [[200.0, 0.0, 200.0]],
          faces=(4,))

    # trees along both curbs, planters between those on the right
    zt = z_front - 4.0 - np.arange(trees_per_side) * TREE_PITCH
    k = 0
    for side in (-1, 1):
        for i, z in enumerate(zt):
            x = side * (road + 0.8)
            crown = (side * 3.2 + rng.uniform(-0.3, 0.3),
                     7.2 + rng.uniform(-0.4, 0.4), z + rng.uniform(-0.4, 0.4))
            tree(group(f"tree_{k}"), rng, (x, 0.15, z), crown,
                 (2.6, 2.4, 3.4), cards, "leaves_a" if k % 2 else "leaves_b",
                 leaf)
            k += 1
    zp = z_front - 8.0 - np.arange(planters) * PLANTER_PITCH
    for i, z in enumerate(zp):
        x = HALF_WIDTH - 0.6
        p = group(f"planter_{i}")
        boxes(p, "planter", [[x - 0.35, 0.15, z - 0.8]],
              [[x + 0.35, 0.75, z + 0.8]])
        u = _unit(rng.normal(size=(bush_cards, 3)) * [1.0, 0.7, 1.0])
        u[:, 1] = np.abs(u[:, 1])
        r = rng.uniform(0.5, 1.0, bush_cards) ** 0.5
        ctr = np.array([x, 0.8, z]) + u * np.array([0.45, 0.8, 0.95]) * r[:, None]
        leaf_cards(p, "leaves_b" if i % 2 else "leaves_a", ctr,
              _unit(u + 0.5 * rng.normal(size=u.shape)),
              rng.uniform(0, 2 * np.pi, bush_cards),
              BUSH_LEAF * rng.uniform(0.8, 1.2, bush_cards),
              rng.integers(0, 4, (bush_cards, 2)))

    # the café terrace on the right sidewalk and the roadway's edge
    for i in range(tables):
        z = z_front - 2.5 - i * TABLE_PITCH
        x = road + (0.9 if i % 2 else -0.6)
        table_set(group(f"table_{i}"), rng, (x, z))

    # strings of bulbs across the street, zig-zagging, with a sag
    for i in range(strings):
        z0 = z_front - 2.0 - i * STRING_PITCH
        z1 = z0 - 0.5 * STRING_PITCH
        t = np.linspace(0.0, 1.0, bulbs_per_string + 2)[1:-1]
        xs = -HALF_WIDTH + 0.3 + t * (2 * HALF_WIDTH - 0.6)
        ys = 6.2 - 1.2 * 4 * t * (1 - t)
        zs = z0 + (z1 - z0) * t
        pts = np.column_stack([xs, ys, zs])
        p = group(f"string_{i}")
        bulbs(p, "bulb", pts - [0.0, 0.06, 0.0], 0.035)
        a, b = pts[:-1], pts[1:]
        axis = b - a
        lathe(p, "wire", a, axis, (np.full((len(a), 2), 0.006),
                                   np.column_stack([np.zeros(len(a)),
                                                    np.linalg.norm(axis, axis=-1)])),
              3)

    meshes, instances = {}, []
    zero, one = (0.0, 0.0, 0.0), (1.0, 1.0, 1.0)
    for name, p in groups:
        for mat, m in p.meshes().items():
            limit = CHUNK if mat in ("cobble", "leaves_a", "leaves_b") else 1 << 30
            for j, piece in enumerate(_mesh_slices(m, limit)):
                key = f"{name}.{mat}.{j}"
                meshes[key] = piece
                instances.append((key, key, mat, zero, zero, one))

    textures = dict(
        leaves_a=dict(data=leaf_atlas(rng, tex, np.array([0.2, 0.42, 0.1])),
                      format="srgb_rgba"),
        leaves_b=dict(data=leaf_atlas(rng, tex, np.array([0.3, 0.45, 0.12])),
                      format="srgb_rgba"),
        facade=dict(data=facade_map(rng, tex), format="srgb_rgba"),
        sky=dict(data=sky(*sky_size), format="hdr"))
    pos = np.array(EYE) + [0.0, 0.0, z_front]
    target = np.array(LOOK_AT) + [0.0, 0.0, z_front]
    return dict(
        meshes=meshes, materials={k: dict(v) for k, v in MATERIALS.items()},
        instances=instances,
        camera=dict(position=tuple(float(x) for x in pos),
                    target=tuple(float(x) for x in target),
                    focal_length=35.0, sensor_size=(36.0, 24.0),
                    focus_distance=float(np.linalg.norm(pos - target))),
        textures=textures,
        environment=dict(constant_color=[0.0, 0.0, 0.0], strength=1.0,
                         texture="sky"))
