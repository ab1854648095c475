"""Studio preview renderer: the editor viewport, in torch.

Port of platinum_tpu/render/studio.py (the reference's renderer_studio):
a single-bounce headlight-shaded preview with an object-id AOV for
click-to-select picking (readbackObjectIdAt), Laplacian edge outlines with
the selection highlighted (edge_pass.metal), a procedural ground grid with
axis colours and a distance fade (grid.metal), camera gizmos, and an
orbit / pan / zoom camera (studio_camera.cpp). Primary rays are traced
against the same flattened scene the path tracer uses, through
render/integrator.make_tracers: the packet kernel's closest-hit mode (K1,
or K3 on an instanced scene) where the scene has a wide BVH, the brute
tracer where it has none.

`torch.round` rounds half to even and `torch.roll` wraps as `jnp.round`
and `jnp.roll` do, so the grid lines and the outlines fall on the JAX
package's pixels; the ids equal the JAX pass's bit for bit wherever the
two tracers agree on the hit.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from platinum_tpu_torch.core.camera import Camera
from platinum_tpu_torch.core.transform import Transform
from platinum_tpu_torch.models.camera_rays import spawn_camera_rays
from platinum_tpu_torch.ops import lookup
from platinum_tpu_torch.ops.frame import norm
from platinum_tpu_torch.ops.hitdata import interpolate_hit
from platinum_tpu_torch.render.flatten import flatten_scene
from platinum_tpu_torch.render.integrator import make_tracers
from platinum_tpu_torch.render.types import (FlatScene, RenderSettings,
                                             resolve_device)

# Theme colors (parity with the viewport section of theme.hpp)
GRID_COLOR = np.array([0.42, 0.42, 0.42], np.float32)
AXIS_X_COLOR = np.array([0.85, 0.3, 0.3], np.float32)
AXIS_Z_COLOR = np.array([0.3, 0.45, 0.85], np.float32)
BACKGROUND = np.array([0.16, 0.16, 0.18], np.float32)
SELECTION = np.array([1.0, 0.55, 0.1], np.float32)
OUTLINE = np.array([0.05, 0.05, 0.05], np.float32)
GIZMO_COLOR = np.array([0.9, 0.9, 0.92], np.float32)


def _rgb(c, dev):
    return torch.from_numpy(c).to(dev)


def camera_gizmo_segments(scene, exclude_node: int = -1) -> np.ndarray:
    """(S, 6) world-space line segments [a.xyz, b.xyz] drawing a wireframe
    frustum for every camera node (parity with the studio camera pass,
    renderer_studio.cpp:219-262: 8 lines per camera)."""
    segs = []
    for node_id, cam, m in scene.get_cameras():
        if node_id == exclude_node or cam is None:
            continue
        pos = m[:3, 3]
        u, v, w = m[:3, 0], m[:3, 1], m[:3, 2]
        depth = 0.8
        f = max(float(cam.focal_length), 1e-3)
        hw = depth * cam.sensor_size[0] / (2.0 * f)
        hh = depth * cam.sensor_size[1] / (2.0 * f)
        c = pos - w * depth
        corners = [c + u * sx * hw + v * sy * hh
                   for sx, sy in ((-1, -1), (1, -1), (1, 1), (-1, 1))]
        for k in range(4):
            segs.append(np.concatenate([pos, corners[k]]))
            segs.append(np.concatenate([corners[k], corners[(k + 1) % 4]]))
    if not segs:
        return np.zeros((0, 6), np.float32)
    return np.asarray(segs, np.float32)


def _draw_segments(color, o, d, scene_t, segs):
    """Analytic 3D line rasterisation: a pixel takes the gizmo colour when
    its view ray passes within an angular tolerance of a segment and the
    segment point is not occluded by geometry."""
    if segs.shape[0] == 0:
        return color
    a = segs[:, 0:3][None]          # (1, S, 3)
    b = segs[:, 3:6][None]
    ab = b - a
    o_ = o[:, None, :]
    d_ = d[:, None, :]
    ao = a - o_
    # closest points between the ray (o + t d) and the segment (a + s ab)
    dd = torch.sum(d_ * d_, -1)
    de = torch.sum(d_ * ab, -1)
    ee = torch.sum(ab * ab, -1)
    doo = torch.sum(d_ * ao, -1)
    eo = torch.sum(ab * ao, -1)
    den = dd * ee - de * de
    ok = torch.abs(den) > 1e-12
    safe = torch.where(ok, den, 1.0)
    s_par = torch.clamp(torch.where(ok, (de * doo - dd * eo) / safe, 0.0),
                        0.0, 1.0)
    p = a + ab * s_par[..., None]
    t_ray = torch.clamp(torch.sum((p - o_) * d_, -1), min=1e-4)
    q = o_ + d_ * t_ray[..., None]
    dist = norm(p - q)
    tol = t_ray * 3e-3  # ~screen-constant line width
    vis = (dist < tol) & (t_ray < scene_t[:, None] - 1e-3)
    return torch.where(vis.any(dim=1)[:, None],
                       _rgb(GIZMO_COLOR, color.device), color)


def _studio_pass(flat: FlatScene, settings: RenderSettings,
                 selected_node: int, gizmo_segs: torch.Tensor,
                 tracers=None):
    """(color (H, W, 3), object id (H, W) int32) of one studio frame.
    `tracers` is the scene's (trace_closest, trace_any) pair, built here
    when not given."""
    w, h = settings.width, settings.height
    n = w * h
    dev = flat.camera.position.device
    pix = torch.arange(n, device=dev)
    px = pix % w
    py = pix // w
    center = torch.full((n, 2), 0.5, device=dev)
    o, d = spawn_camera_rays(flat.camera, px, py, center, center)

    trace_closest, _ = tracers or make_tracers(flat, settings)
    rec = trace_closest(o, d, 1e-3, float("inf"))
    hd = interpolate_hit(flat.geometry, rec, o, d, instances=flat.instances)
    if flat.instances is not None:
        # instanced path: the node id lives in the instance table
        node_id = lookup.rows(flat.instances.rows,
                              torch.where(rec.hit, rec.inst, 0))[..., 18]
    else:
        node_id = lookup.rows(flat.geometry.tri_geo,
                              torch.where(rec.hit, rec.tri, 0))[..., 10]
    node_id = torch.where(rec.hit, node_id.to(torch.int32), -1)

    # headlight shade: albedo * (0.25 + 0.75 |n.d|), like the studio pass
    albedo = lookup.rows(flat.materials.packed, hd.mat_idx)[..., 0:3]
    ndotl = torch.abs(torch.sum(hd.normal * -d, dim=-1))
    shaded = albedo * (0.25 + 0.75 * ndotl)[:, None]

    # infinite ground grid where rays miss geometry (grid.metal)
    denom = d[:, 1]
    t_plane = -o[:, 1] / torch.where(torch.abs(denom) < 1e-6, 1e-6, denom)
    gp = o + d * t_plane[:, None]
    hits_plane = ((~rec.hit) & (t_plane > 0.0) & (torch.abs(gp[:, 0]) < 200)
                  & (torch.abs(gp[:, 2]) < 200))
    fx = torch.abs(gp[:, 0] - torch.round(gp[:, 0]))
    fz = torch.abs(gp[:, 2] - torch.round(gp[:, 2]))
    fw = torch.clamp(t_plane * 2e-3, min=8e-3)  # crude screen-space AA width
    line = (fx < fw) | (fz < fw)
    on_x_axis = torch.abs(gp[:, 2]) < fw * 2
    on_z_axis = torch.abs(gp[:, 0]) < fw * 2
    fade = torch.clamp(1.0 - t_plane / 120.0, 0.0, 1.0)
    grid_rgb = torch.where(
        on_x_axis[:, None], _rgb(AXIS_X_COLOR, dev),
        torch.where(on_z_axis[:, None], _rgb(AXIS_Z_COLOR, dev),
                    _rgb(GRID_COLOR, dev)))
    bg = torch.broadcast_to(_rgb(BACKGROUND, dev), (n, 3))
    grid_col = torch.where(
        (hits_plane & (line | on_x_axis | on_z_axis))[:, None],
        bg + (grid_rgb - bg) * fade[:, None], bg)

    color = torch.where(rec.hit[:, None], shaded, grid_col)
    # camera gizmos (wireframe frusta), depth-tested against the scene
    scene_t = torch.where(rec.hit, rec.t, 1e30)
    color = _draw_segments(color, o, d, scene_t, gizmo_segs)
    color = color.reshape(h, w, 3)
    ids = node_id.reshape(h, w)

    # edge outlines: 3x3 Laplacian over object ids (edge_pass.metal)
    shifts = ((0, 1), (0, -1), (1, 0), (-1, 0))
    edge = sum((torch.roll(ids, s, dims=(0, 1)) != ids).to(torch.float32)
               for s in shifts) > 0
    neighbors_selected = sum(
        (torch.roll(ids, s, dims=(0, 1)) == selected_node).to(torch.int32)
        for s in shifts) > 0
    # -1 = nothing selected (matches miss ids)
    is_sel_edge = (edge & (neighbors_selected | (ids == selected_node))
                   & (selected_node >= 0))
    color = torch.where(edge[..., None], _rgb(OUTLINE, dev), color)
    color = torch.where(is_sel_edge[..., None], _rgb(SELECTION, dev), color)
    return color, ids


class StudioRenderer:
    """Editor viewport: shaded preview, object picking, selection outlines.
    `device` is where the scene is flattened and traced (default: the
    current CUDA device; raises when there is none, and runs on the CPU
    only when asked with device="cpu")."""

    def __init__(self, scene, width: int = 960, height: int = 540, *,
                 device="cuda"):
        self.scene = scene
        self.device = resolve_device(device)
        self.settings = RenderSettings(width=width, height=height, spp=1,
                                       max_bounces=1, sampler="pcg4d")
        self.camera = StudioCamera()
        self._flat = None
        self._tracers = None
        self._ids = None

    def invalidate(self):
        """Call after scene edits; re-flattens on next render."""
        self._flat = None

    def handle_resize_viewport(self, width: int, height: int):
        self.settings = replace(self.settings, width=width, height=height)
        self.invalidate()

    def render(self, selected_node: int = -1) -> np.ndarray:
        if self._flat is None:
            cam_node = self.camera.attach(self.scene)
            self._flat = flatten_scene(self.scene, cam_node, self.settings,
                                       device=self.device)
            self._tracers = make_tracers(self._flat, self.settings)
            self._gizmos = torch.from_numpy(camera_gizmo_segments(
                self.scene, exclude_node=cam_node)).to(self.device)
        color, self._ids = _studio_pass(self._flat, self.settings,
                                        int(selected_node), self._gizmos,
                                        self._tracers)
        return color.cpu().numpy()

    def readback_object_id_at(self, x: int, y: int) -> int:
        """Click-to-select picking (parity with readbackObjectIdAt)."""
        if self._ids is None:
            self.render()
        return int(self._ids[y, x])

    # Input forwarding (parity with the studio input handlers)
    def handle_orbit(self, dx: float, dy: float):
        self.camera.orbit(dx, dy)
        self.invalidate()

    def handle_pan(self, dx: float, dy: float):
        self.camera.pan(dx, dy)
        self.invalidate()

    def handle_zoom(self, amount: float):
        self.camera.zoom(amount)
        self.invalidate()

    def camera_to(self, position, target):
        self.camera.move_to(position, target)
        self.invalidate()


@dataclass
class StudioCamera:
    """Orbit/pan/zoom camera with pole clamping
    (parity with studio_camera.cpp:15-59)."""

    target: np.ndarray = None
    distance: float = 20.0
    azimuth: float = 0.6
    elevation: float = 0.5

    def __post_init__(self):
        if self.target is None:
            self.target = np.zeros(3, np.float32)
        self.target = np.asarray(self.target, np.float32)

    @property
    def position(self) -> np.ndarray:
        ce = np.cos(self.elevation)
        return self.target + self.distance * np.array([
            ce * np.sin(self.azimuth), np.sin(self.elevation),
            ce * np.cos(self.azimuth),
        ], np.float32)

    def orbit(self, dx: float, dy: float):
        self.azimuth -= dx * 0.01
        self.elevation = float(np.clip(self.elevation + dy * 0.01,
                                       -np.pi / 2 + 1e-3, np.pi / 2 - 1e-3))

    def pan(self, dx: float, dy: float):
        fwd = (self.target - self.position)
        fwd /= np.linalg.norm(fwd)
        right = np.cross(np.array([0, 1, 0], np.float32), fwd)
        right /= np.linalg.norm(right)
        up = np.cross(fwd, right)
        scale = self.distance * 0.002
        self.target = self.target + (right * dx + up * dy) * scale

    def zoom(self, amount: float):
        self.distance = float(np.clip(self.distance * (0.9 ** amount), 0.05,
                                      1e5))

    def move_to(self, position, target):
        position = np.asarray(position, np.float32)
        self.target = np.asarray(target, np.float32)
        delta = position - self.target
        self.distance = float(np.linalg.norm(delta))
        self.elevation = float(np.arcsin(np.clip(delta[1] / self.distance,
                                                 -1, 1)))
        self.azimuth = float(np.arctan2(delta[0], delta[2]))

    def attach(self, scene) -> int:
        """Create/update the studio camera node in the scene; returns its
        id."""
        for nid in list(scene._nodes):
            if scene.node(nid).name == "__studio_camera__":
                node = scene.node(nid)
                break
        else:
            node = scene.create_node("__studio_camera__")
            node.camera = Camera.with_focal_length(35.0)
        node.camera.focus_distance = self.distance
        node.transform = Transform(
            translation=self.position, target=self.target, track=True
        )
        return node.id
