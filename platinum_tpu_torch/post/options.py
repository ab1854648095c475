"""Copy of platinum_tpu/post/options.py, kept in step with it: platinum_tpu_torch
imports nothing of the JAX package.

Post-processing option structs (host dataclasses).

Parity with the Metal reference's src/core/postprocessing.hpp:29-227: the
exact knobs and defaults of the reference's post stack, including the AgX
looks (none/golden/punchy) and the flim presets (flim/silver).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class AgxLook:
    offset: tuple = (0.0, 0.0, 0.0)
    slope: tuple = (1.0, 1.0, 1.0)
    power: tuple = (1.0, 1.0, 1.0)
    saturation: float = 1.0


AGX_LOOK_NONE = AgxLook()
AGX_LOOK_GOLDEN = AgxLook(slope=(1.0, 0.9, 0.5), power=(0.8, 0.8, 0.8), saturation=0.8)
AGX_LOOK_PUNCHY = AgxLook(power=(1.35, 1.35, 1.35), saturation=1.4)
AGX_LOOKS = {"none": AGX_LOOK_NONE, "golden": AGX_LOOK_GOLDEN, "punchy": AGX_LOOK_PUNCHY}


@dataclass(frozen=True)
class KhronosPbrOptions:
    compression_start: float = 0.8
    desaturation: float = 0.15


@dataclass(frozen=True)
class FlimOptions:
    pre_exposure: float = 4.3
    pre_formation_filter: tuple = (1.0, 1.0, 1.0)
    pre_formation_filter_strength: float = 0.0
    extended_gamut_scale: tuple = (1.05, 1.12, 1.045)
    extended_gamut_rotation: tuple = (0.5, 2.0, 0.1)
    extended_gamut_mul: tuple = (1.0, 1.0, 1.0)
    sigmoid_log2_min: float = -10.0
    sigmoid_log2_max: float = 22.0
    sigmoid_toe: tuple = (0.440, 0.280)
    sigmoid_shoulder: tuple = (0.591, 0.779)
    negative_exposure: float = 6.0
    negative_density: float = 5.0
    print_backlight: tuple = (1.0, 1.0, 1.0)
    print_exposure: float = 6.0
    print_density: float = 27.5
    black_point: float = 0.0
    auto_black_point: bool = True
    post_formation_filter: tuple = (1.0, 1.0, 1.0)
    post_formation_filter_strength: float = 0.0
    midtone_saturation: float = 1.02


FLIM_PRESET_FLIM = FlimOptions()
FLIM_PRESET_SILVER = FlimOptions(
    pre_exposure=3.9,
    pre_formation_filter=(0.0, 0.5, 1.0),
    pre_formation_filter_strength=0.05,
    extended_gamut_mul=(1.0, 1.0, 1.06),
    negative_exposure=4.7,
    negative_density=7.0,
    print_backlight=(0.9992, 0.99, 1.0),
    print_exposure=4.7,
    print_density=30.0,
    black_point=0.5,
    auto_black_point=False,
    post_formation_filter=(1.0, 1.0, 0.0),
    post_formation_filter_strength=0.04,
    midtone_saturation=1.0,
)
FLIM_PRESETS = {"flim": FLIM_PRESET_FLIM, "silver": FLIM_PRESET_SILVER}


@dataclass(frozen=True)
class ExposureOptions:
    exposure: float = 0.0  # EV


@dataclass(frozen=True)
class ContrastSaturationOptions:
    contrast: float = 0.0    # percent
    saturation: float = 0.0  # percent


@dataclass(frozen=True)
class ToneCurveOptions:
    blacks: float = 0.0
    shadows: float = 0.0
    highlights: float = 0.0
    whites: float = 0.0


@dataclass(frozen=True)
class VignetteOptions:
    amount: float = 0.0   # EV at full vignette
    midpoint: float = 0.0
    feather: float = 50.0
    power: float = 20.0
    roundness: float = 100.0


@dataclass(frozen=True)
class ChromaticAberrationOptions:
    amount: float = 0.0
    green_shift: float = 70.0


@dataclass(frozen=True)
class LiftGammaGain:
    shadow_color: tuple = (0.5, 0.5, 0.5)
    midtone_color: tuple = (0.5, 0.5, 0.5)
    highlight_color: tuple = (0.5, 0.5, 0.5)
    shadow_offset: float = 0.0
    midtone_offset: float = 0.0
    highlight_offset: float = 0.0


@dataclass(frozen=True)
class TonemapOptions:
    tonemapper: str = "agx"  # "none" | "agx" | "khronos_pbr" | "flim"
    agx_look: AgxLook = AGX_LOOK_NONE
    khronos: KhronosPbrOptions = KhronosPbrOptions()
    flim: FlimOptions = FLIM_PRESET_FLIM
    lift_gamma_gain: LiftGammaGain = LiftGammaGain()


@dataclass(frozen=True)
class PostProcessOptions:
    """The whole stack, in the reference's pass order
    (renderer_pt.cpp:184-196)."""

    exposure: ExposureOptions = ExposureOptions()
    chromatic_aberration: ChromaticAberrationOptions = ChromaticAberrationOptions()
    contrast_saturation: ContrastSaturationOptions = ContrastSaturationOptions()
    tone_curve: ToneCurveOptions = ToneCurveOptions()
    vignette: VignetteOptions = VignetteOptions()
    tonemap: TonemapOptions = TonemapOptions()
