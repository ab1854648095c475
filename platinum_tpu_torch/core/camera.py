"""Copy of platinum_tpu/core/camera.py, kept in step with it: platinum_tpu_torch
imports nothing of the JAX package.

Physical camera model (host-side).

Capability parity with the Metal reference's src/core/camera.hpp:10-51: sensor size
in mm, lens focal length in mm, aperture as an f-number, aperture blade
count/roundness and a bokeh profile power, and focus distance in world units.
fov↔focal conversions and aspect-crop of the sensor. The derived per-render
ray-generation constants live in `platinum_tpu_torch.render.flatten`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Camera:
    sensor_size: tuple = (36.0, 24.0)  # mm
    focal_length: float = 50.0         # mm
    aperture: float = 0.0              # f-number; 0 disables DoF
    aperture_blades: int = 7
    roundness: float = 1.0             # 1 = perfect circle
    bokeh_power: float = 0.0           # radial density exponent (log2 scale)
    focus_distance: float = 1.0        # world units

    @staticmethod
    def with_focal_length(f: float, sensor_size=(36.0, 24.0), aperture: float = 0.0) -> "Camera":
        return Camera(sensor_size=sensor_size, focal_length=f, aperture=aperture)

    @staticmethod
    def with_fov(y_fov: float, sensor_size=(36.0, 24.0), aperture: float = 0.0) -> "Camera":
        focal = sensor_size[1] / (2.0 * np.tan(y_fov * 0.5))
        return Camera(sensor_size=sensor_size, focal_length=float(focal), aperture=aperture)

    @property
    def y_fov(self) -> float:
        return float(2.0 * np.arctan(self.sensor_size[1] / (2.0 * self.focal_length)))

    def cropped_sensor_height(self, aspect: float) -> float:
        """Sensor height after cropping to the render aspect ratio: wider
        renders crop the sensor vertically, taller ones use full height."""
        sensor_aspect = self.sensor_size[0] / self.sensor_size[1]
        return self.sensor_size[0] / max(sensor_aspect, aspect)

    @property
    def aperture_radius_world(self) -> float:
        """Lens radius in world units (focal mm → meters, diameter = f/N)."""
        if self.aperture <= 0.0:
            return 0.0
        return (self.focal_length / 2000.0) / self.aperture
