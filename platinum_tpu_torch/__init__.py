"""platinum-tpu on PyTorch and CUDA: the port of the JAX package to an
NVIDIA Hopper GPU.

The JAX package (`platinum_tpu`) stays the reference; this package mirrors
its paths so each module's counterpart sits at the same place:

    render/    torch scene types, the flattener, the wavefront integrator,
               compaction plans (autoplan) and the Renderer API
    ops/       samplers, threefry, LUTs, lookups, frames, hit
               interpolation and the ray tracers (the wide-BVH CUDA kernel
               lives in csrc/)
    models/    camera rays, Fresnel, GGX, the principled BSDF and lights
    convert.py the JAX package's FlatScene (as numpy) -> this package's

Copies of the JAX package's host modules, numpy only, kept in step with
their originals: core/ (scene graph), accel/ (BVH builders, wide packer,
TLAS assembler), io/exr.py, app/scenes.py, utils/matrices.py and the LUT
bundles in resources/. Nothing in this package imports JAX or anything
of `platinum_tpu`.
"""

__version__ = "0.1.0"
