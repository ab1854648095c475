"""platinum-tpu on PyTorch and CUDA: the port of the JAX package to an
NVIDIA Hopper GPU.

The JAX package (`platinum_tpu`) stays the reference; this package mirrors
its paths so each module's counterpart sits at the same place:

    render/    torch scene types, the flattener, the wavefront integrator
               and the Renderer API
    ops/       samplers, LUTs, lookups, frames, hit interpolation and the
               ray tracers (the wide-BVH CUDA kernel lives in csrc/)
    models/    camera rays, Fresnel, GGX, the principled BSDF and lights
    convert.py the JAX package's FlatScene (as numpy) -> this package's

The JAX-free host code of `platinum_tpu` (core/, io/, accel builders,
app/scenes.py, tools/foreign_glb.py, utils/matrices.py) is imported, not
copied. Nothing in this package imports JAX.
"""

__version__ = "0.1.0"
