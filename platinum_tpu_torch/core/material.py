"""Copy of platinum_tpu/core/material.py, kept in step with it: platinum_tpu_torch
imports nothing of the JAX package.

PBR material (host-side).

Capability parity with the Metal reference's src/core/material.hpp:15-49: principled
GGX material with base color, emission (+strength), roughness, metallic,
transmission, IOR, anisotropy (+rotation), clearcoat (+roughness), a
thin-transmission flag, and 6 texture slots. The flattener derives GPU flags
(uses-alpha, emissive, anisotropic, thin) exactly like the reference's
MaterialGPU construction (renderer_pt.cpp:545-651).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np


class TextureSlot(enum.IntEnum):
    BASE_COLOR = 0
    ROUGHNESS_METALLIC = 1  # R = roughness, G = metallic
    TRANSMISSION = 2
    CLEARCOAT = 3
    EMISSION = 4
    NORMAL = 5


NUM_TEXTURE_SLOTS = len(TextureSlot)


@dataclass
class Material:
    name: str = "material"
    base_color: tuple = (0.8, 0.8, 0.8, 1.0)  # RGBA; A = opacity
    emission: tuple = (0.0, 0.0, 0.0)
    emission_strength: float = 1.0
    roughness: float = 1.0
    metallic: float = 0.0
    transmission: float = 0.0
    ior: float = 1.5
    anisotropy: float = 0.0
    anisotropy_rotation: float = 0.0
    clearcoat: float = 0.0
    clearcoat_roughness: float = 0.0
    thin_transmission: bool = False
    # texture slot → texture asset id
    textures: dict = field(default_factory=dict)

    def is_emissive(self) -> bool:
        has_tex = TextureSlot.EMISSION in self.textures
        return (has_tex or max(self.emission) > 0.0) and self.emission_strength > 0.0

    def texture(self, slot: TextureSlot):
        return self.textures.get(TextureSlot(slot))
