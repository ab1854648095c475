"""Command-line interface of the port.

Port of the `render` and `info` commands of platinum_tpu/app/cli.py:

  render     render a scene (.gltf/.glb or a builtin) to PNG/EXR
  info       inspect a scene

Usage: python -m platinum_tpu_torch.app.cli render scene.glb --spp 64 \\
           --gmon 4 --tonemap agx -o out.png

It renders on the card (`--device cuda`, the default) and raises where
there is none; `--device cpu` runs on the CPU. What is not ported raises
NotImplementedError naming its ROADMAP queue-1 item: `.ptscene` / `.json`
scenes (item 10), `--mesh` (item 11), `--sampler z` (item 8), and the
`preview` (item 9) and `bake-luts` (item 12) commands.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _unported(what: str, item: int, modules: str):
    return NotImplementedError(
        f"{what} is not ported to platinum_tpu_torch yet (ROADMAP queue 1, "
        f"item {item}: {modules})")


def _load_scene(path: str):
    from platinum_tpu_torch.app import scenes as builtin

    if path == "cornell":
        return builtin.make_cornell_scene()
    if path == "furnace":
        return builtin.make_furnace_scene()
    if path == "colonnade":
        return builtin.make_colonnade_scene()
    if path == "colonnade-small":
        return builtin.make_colonnade_scene(columns=4, rows=2,
                                            sphere_res=(10, 14))
    if path == "spheres":
        return builtin.make_spheres_scene()
    if path.endswith((".gltf", ".glb")):
        from platinum_tpu_torch.core.scene import Scene
        from platinum_tpu_torch.io.gltf import load_gltf

        scene = Scene()
        load_gltf(scene, path)
        cams = scene.get_cameras()
        return scene, (cams[0][0] if cams else None)
    if path.endswith((".ptscene", ".json")):
        raise _unported(f"loading {path}", 10, "io/{sceneio,refscene,hdr}.py")
    raise SystemExit(f"unknown scene: {path}")


def _ensure_camera(scene, cam_id, args):
    """Add a default orbiting camera if the scene has none."""
    if cam_id is not None:
        return cam_id
    import numpy as np

    from platinum_tpu_torch.core.camera import Camera
    from platinum_tpu_torch.core.transform import Transform

    lo = hi = None
    for inst in scene.get_instances():
        mesh = inst.mesh
        wp = mesh.positions @ inst.transform[:3, :3].T + inst.transform[:3, 3]
        lo = wp.min(axis=0) if lo is None else np.minimum(lo, wp.min(axis=0))
        hi = wp.max(axis=0) if hi is None else np.maximum(hi, wp.max(axis=0))
    center = (lo + hi) / 2
    radius = float(np.linalg.norm(hi - lo)) / 2 + 1e-3
    dist = radius * 2.6
    pos = center + np.array([0.4, 0.3, 1.0]) * dist

    node = scene.create_node("auto_camera")
    node.camera = Camera.with_focal_length(50.0)
    node.camera.focus_distance = float(np.linalg.norm(pos - center))
    node.transform = Transform(translation=pos, target=center, track=True)
    return node.id


def cmd_render(args):
    from platinum_tpu_torch.post.options import (AGX_LOOKS, FLIM_PRESETS,
                                                 ExposureOptions,
                                                 PostProcessOptions,
                                                 TonemapOptions)
    from platinum_tpu_torch.render.renderer import Renderer, RenderStatus
    from platinum_tpu_torch.render.types import (FLAG_GMON,
                                                 FLAG_MULTISCATTER_GGX,
                                                 RenderSettings)

    if args.mesh:
        raise _unported("--mesh (multi-device rendering)", 11,
                        "parallel/{mesh,shard,geometry,multihost}.py")
    if args.sampler == "z":
        raise _unported("--sampler z", 8, "ops/zsampler.py")
    scene, cam_id = _load_scene(args.scene)
    cam_id = _ensure_camera(scene, cam_id if args.camera < 0 else args.camera,
                            args)

    w, h = (int(v) for v in args.size.split("x"))
    flags = 0
    if not args.no_multiscatter:
        flags |= FLAG_MULTISCATTER_GGX
    if args.gmon > 1:
        flags |= FLAG_GMON
    settings = RenderSettings(
        width=w, height=h, spp=args.spp, max_bounces=args.bounces,
        kernel=args.kernel, sampler=args.sampler, flags=flags,
        gmon_buckets=max(1, args.gmon), gmon_cap=args.gmon_cap,
        working_space=args.working_space, output_space=args.output_space,
        tracer=args.tracer, compact=args.compact,
        compact_plan=args.compact_plan, instancing=args.instancing,
        **({"partition_tris": args.partition_tris}
           if args.partition_tris else {}),
        stream=args.stream, mt_precision=args.mt_precision,
    )
    post = PostProcessOptions(
        exposure=ExposureOptions(exposure=args.exposure),
        tonemap=TonemapOptions(
            tonemapper=args.tonemap,
            agx_look=AGX_LOOKS[args.agx_look],
            flim=FLIM_PRESETS[args.flim_preset],
        ),
    )

    renderer = Renderer(scene, post, device=args.device)
    renderer.start_render(cam_id, settings,
                          preview_scale=max(0, args.preview_scale),
                          preview_spp=4)
    t0 = time.perf_counter()
    last = t0
    watch_every = max(0, args.watch)
    next_watch = watch_every
    while not (renderer.status & RenderStatus.DONE):
        renderer.render()
        now = time.perf_counter()
        # progressive preview: rewrite the output as it refines
        if watch_every and renderer.completed_spp >= next_watch:
            if args.output.endswith(".exr"):
                renderer.export_exr(args.output)
            else:
                renderer.export_png(args.output)
            print(f"  watch: {renderer.completed_spp} spp -> {args.output}",
                  file=sys.stderr)
            next_watch += watch_every
        if args.progress and now - last > 2.0:
            print(f"  {renderer.render_progress*100:5.1f}%  "
                  f"{now - t0:6.1f}s", file=sys.stderr)
            last = now
    print(f"rendered {settings.spp} spp in {renderer.render_time:.2f}s",
          file=sys.stderr)

    out = args.output
    if out.endswith(".exr"):
        renderer.export_exr(out)
    else:
        renderer.export_png(out)
    print(out)


def cmd_info(args):
    scene, cam_id = _load_scene(args.scene)
    insts = scene.get_instances()
    tris = sum(i.mesh.num_triangles for i in insts)
    out = {
        "nodes": scene.node_count,
        "instances": len(insts),
        "triangles": tris,
        "cameras": len(scene.get_cameras()),
        "materials": len(scene.assets_of_type(type(scene.default_material))),
    }
    if args.assets:
        # every asset with type, refcount, retained flag and a
        # type-specific size summary
        rows = []
        for aid, data, name, refs, retained in scene.all_assets():
            row = {"id": aid, "type": type(data).__name__,
                   "name": name, "refs": refs, "retained": retained}
            if hasattr(data, "num_triangles"):
                row["triangles"] = int(data.num_triangles)
            elif hasattr(data, "width"):
                row["size"] = f"{data.width}x{data.height}"
                row["format"] = getattr(getattr(data, "format", None),
                                        "name", None)
            rows.append(row)
        out["assets"] = sorted(rows, key=lambda r: r["id"])
    print(json.dumps(out, indent=2))


def cmd_preview(args):
    raise _unported("the preview command", 9, "render/studio.py")


def cmd_bake_luts(args):
    raise _unported("the bake-luts command", 12, "tools/lut_baker.py")


def build_parser():
    p = argparse.ArgumentParser(prog="platinum-tpu-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render", help="render a scene to PNG/EXR")
    r.add_argument("scene", help=".gltf/.glb path or 'cornell'")
    r.add_argument("-o", "--output", default="render.png")
    r.add_argument("--device", default="cuda",
                   help="torch device to render on (default cuda; cpu for "
                        "tests)")
    r.add_argument("--size", default="512x512")
    r.add_argument("--spp", type=int, default=128)
    r.add_argument("--bounces", type=int, default=50)
    r.add_argument("--camera", type=int, default=-1, help="camera node id")
    r.add_argument("--kernel", choices=["simple", "mis"], default="mis")
    r.add_argument("--sampler", choices=["halton", "pcg4d", "z"],
                   default="halton")
    r.add_argument("--tracer",
                   choices=["auto", "brute", "bvh", "packet", "bf"],
                   default="auto")
    r.add_argument("--compact", action="store_true",
                   help="wavefront population-control compaction")
    r.add_argument("--compact-plan", choices=["auto"], default=None,
                   dest="compact_plan",
                   help="with --compact: probe the scene's per-bounce "
                        "live fractions on the device and fit the "
                        "compaction schedule to them (render/autoplan.py)")
    r.add_argument("--watch", metavar="N", type=int, default=0,
                   help="progressive preview: rewrite the output every N spp")
    r.add_argument("--preview-scale", metavar="K", type=int, default=0,
                   dest="preview_scale",
                   help="preview ladder: first frames render at (W/K, H/K) "
                        "and upscale while full-resolution accumulation "
                        "converges underneath (final image identical)")
    r.add_argument("--mesh", metavar="AXES", default=None,
                   help="multi-device render over a named mesh (not "
                        "ported yet)")
    r.add_argument("--instancing", choices=["auto", "on", "off"],
                   default="auto",
                   help="two-level TLAS/BLAS instancing (auto: on when "
                        "meshes are reused)")
    r.add_argument("--partition-tris", type=int, default=None,
                   help="per-partition triangle budget (default 350k)")
    r.add_argument("--stream", choices=["off", "auto", "on"], default="auto",
                   help="streamed leaf blocks: scenes over the resident "
                        "budget trace as one structure (K6)")
    r.add_argument("--mt-precision",
                   choices=["highest", "two_phase", "high", "default"],
                   default="highest", dest="mt_precision",
                   help="closest-hit MT tier: highest = fp32; two_phase = "
                        "bf16x3 broad phase + fp32 refine (exact winners); "
                        "high = bf16x3; default = 1-pass bf16 (testing)")
    r.add_argument("--no-multiscatter", action="store_true")
    r.add_argument("--gmon", type=int, default=0, help="GMoN bucket count")
    r.add_argument("--gmon-cap", type=float, default=1.0)
    r.add_argument("--working-space", default="BT709",
                   choices=["BT709", "DisplayP3", "BT2020"])
    r.add_argument("--output-space", default="sRGB",
                   choices=["sRGB", "DisplayP3", "BT2020"])
    r.add_argument("--tonemap", default="agx",
                   choices=["none", "agx", "khronos_pbr", "flim"])
    r.add_argument("--agx-look", default="none",
                   choices=["none", "golden", "punchy"])
    r.add_argument("--flim-preset", default="flim", choices=["flim", "silver"])
    r.add_argument("--exposure", type=float, default=0.0)
    r.add_argument("--progress", action="store_true")
    r.set_defaults(func=cmd_render)

    pv = sub.add_parser("preview", help="studio viewport preview frame "
                                        "(not ported yet)")
    pv.add_argument("scene")
    pv.add_argument("-o", "--output", default="preview.png")
    pv.add_argument("--size", default="960x540")
    pv.add_argument("--select", type=int, default=-1)
    pv.add_argument("--pick", default=None, help="x,y pixel to pick")
    pv.add_argument("--interactive", action="store_true")
    pv.set_defaults(func=cmd_preview)

    b = sub.add_parser("bake-luts", help="regenerate GGX energy LUTs (not "
                                         "ported yet)")
    b.add_argument("--spp", type=int, default=8192)
    b.add_argument("--exr", action="store_true")
    b.set_defaults(func=cmd_bake_luts)

    i = sub.add_parser("info", help="inspect a scene")
    i.add_argument("scene")
    i.add_argument("--assets", action="store_true",
                   help="list every asset (type, name, refcount, retained, "
                        "size)")
    i.set_defaults(func=cmd_info)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    main()
