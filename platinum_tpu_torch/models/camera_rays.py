"""Camera ray generation with thin-lens DoF and polygonal-aperture bokeh.

Port of platinum_tpu/models/camera_rays.py: pixel jitter on the film plane
at the focus distance, lens sampling on a polar disk with the bokeh power
remap, and an N-bladed polygonal aperture blended toward a circle by
`roundness`.
"""

from __future__ import annotations

import numpy as np
import torch

from platinum_tpu_torch.ops.frame import normalize, rdiv
from platinum_tpu_torch.render.types import CameraConstants


def spawn_camera_rays(cam: CameraConstants, pixel_x: torch.Tensor,
                      pixel_y: torch.Tensor, pixel_sample: torch.Tensor,
                      lens_sample: torch.Tensor):
    """Returns (origins (R,3), directions (R,3))."""
    shape = tuple(pixel_x.shape)
    origin = torch.broadcast_to(cam.position, shape + (3,))

    r = torch.sqrt(lens_sample[..., 0])
    theta = 2.0 * np.pi * lens_sample[..., 1]
    r = torch.pow(torch.clamp(r, min=1e-20), torch.exp2(cam.bokeh_power))

    # polygonal aperture: radius of an n-gon at this angle, blended to 1
    n = cam.aperture_blades
    half_wedge = rdiv(np.pi, n)
    r_polygon = torch.cos(half_wedge) / torch.cos(
        torch.remainder(theta + 1.5 * np.pi, rdiv(2.0 * np.pi, n))
        - half_wedge)
    r = r * torch.where(cam.roundness < 1.0,
                        r_polygon * (1.0 - cam.roundness) + cam.roundness,
                        1.0)

    lens_xy = torch.stack([r * torch.cos(theta), r * torch.sin(theta)], -1)
    lens_xy = lens_xy * cam.aperture_radius
    du = normalize(cam.pixel_delta_u)
    dv = normalize(cam.pixel_delta_v)
    lens_offset = lens_xy[..., 0:1] * du + lens_xy[..., 1:2] * dv
    origin = origin + torch.where(cam.aperture_radius > 0.0, lens_offset, 0.0)

    fx = pixel_x.to(torch.float32) + pixel_sample[..., 0]
    fy = pixel_y.to(torch.float32) + pixel_sample[..., 1]
    film = (cam.top_left
            + fx[..., None] * cam.pixel_delta_u
            + fy[..., None] * cam.pixel_delta_v)
    return origin, normalize(film - origin)
