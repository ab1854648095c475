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
    post/      the post stack and tonemappers (options copied)
    io/png.py  a PNG codec of its own (no Pillow on the render path)
    app/cli.py the command line: render a scene or a glTF file to a PNG
    convert.py the JAX package's FlatScene (as numpy) -> this package's

Copies of the JAX package's host modules, numpy only, kept in step with
their originals: core/ (scene graph), accel/ (BVH builders, wide packer,
TLAS assembler), io/{exr,gltf,icc}.py, tools/foreign_glb.py,
post/options.py, app/scenes.py, utils/{matrices,telemetry}.py and the LUT
bundles in resources/ (tests/test_torch_guard.py keeps the record).
Nothing in this package imports JAX or anything of `platinum_tpu`.
"""

__version__ = "0.1.0"
