"""Command-line interface of the port.

Port of platinum_tpu/app/cli.py's commands:

  render     render a scene (.gltf/.glb/.ptscene/.json or a builtin) to
             PNG/EXR
  preview    a studio viewport frame (optionally a pick at a pixel), or
             with --interactive the stdin-driven editor session
  bake-luts  regenerate the GGX energy LUT bundle (MultiscatterLutGenerator)
  info       inspect a scene

Usage: python -m platinum_tpu_torch.app.cli render scene.glb --spp 64 \\
           --gmon 4 --tonemap agx -o out.png
       python -m platinum_tpu_torch.app.cli preview scene.ptscene \\
           --pick 480,270 -o view.png

`render` and `preview` run on the card (`--device cuda`, the default) and
raise where there is none; `--device cpu` runs on the CPU. `.ptscene` and
`.json` scenes load through io/sceneio.py, or through io/refscene.py when
the file is the reference app's format.

`render --mesh sample=2,tile=2[,geom=2]` renders on a mesh of ranks
(parallel/): start one process per rank with torchrun, e.g.
`python -m torch.distributed.run --standalone --nproc-per-node 2 -m
platinum_tpu_torch.app.cli render colonnade --mesh tile=2 -o out.png`;
the world size must equal the product of the axes. Rank 0 writes the
file.

`bake-luts [--spp N] [--exr] [--device cpu]` bakes the GGX energy LUT
bundle (tools/lut_baker.py) into the port's resources, on the card
unless given the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


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
        from platinum_tpu_torch.io.refscene import (is_reference_scene,
                                                    load_reference_scene)

        if is_reference_scene(path):
            # a scene saved by the reference app (scene.cpp:536-627 JSON +
            # _data.bin sidecar) loads directly
            from platinum_tpu_torch.core.scene import Scene

            scene = Scene()
            load_reference_scene(scene, path)
        else:
            from platinum_tpu_torch.io.sceneio import load_scene

            scene = load_scene(path)
        cams = scene.get_cameras()
        return scene, (cams[0][0] if cams else None)
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

    if args.mesh:
        return _render_on_mesh(args, scene, cam_id, settings, post)

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


def _mesh_axes(spec: str) -> dict:
    axes = {}
    for part in spec.split(","):
        name, _, size = part.partition("=")
        name = name.strip()
        if not name or not size.strip().isdigit() or int(size) < 1:
            raise SystemExit(f"--mesh: bad axis spec {part!r} "
                             f"(expected name=N, e.g. sample=2,tile=4)")
        if name in axes:
            raise SystemExit(f"--mesh: duplicate axis {name!r}")
        axes[name] = int(size)
    return axes


def _render_on_mesh(args, scene, cam_id, settings, post):
    """Multi-device render (JAX `_render_on_mesh`): `--mesh
    sample=2,tile=4[,geom=N]` lays the ranks of the process group
    (parallel/multihost.py `initialize`, from torchrun's environment) out
    as a named mesh and renders through parallel/shard.py, or with a
    "geom" axis parallel/geometry.py, which spreads the scene's partitions
    over the ranks. Every rank flattens the scene; rank 0 writes the
    image."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from platinum_tpu_torch.parallel import multihost
    from platinum_tpu_torch.parallel.mesh import mesh_of, rank_device
    from platinum_tpu_torch.render.flatten import (analyze_features,
                                                   flatten_scene)
    from platinum_tpu_torch.render.types import FLAG_GMON

    axes = _mesh_axes(args.mesh)
    geom = "geom" in axes
    if geom:
        # the 3-axis step names geom, sample and tile; absent ray axes
        # have size 1
        axes.setdefault("sample", 1)
        axes.setdefault("tile", 1)
    n_need = int(np.prod(list(axes.values())))
    multihost.initialize(device=args.device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n_need:
        raise SystemExit(f"--mesh needs {n_need} devices, found {world}")
    device = rank_device(args.device, int(os.environ.get("LOCAL_RANK", "0")))
    mesh = mesh_of(axes)
    if geom and settings.stream != "off":
        # streaming replaces partitioning (one structure, no wbvh_parts),
        # and geometry sharding spreads resident partitions
        settings = dataclasses.replace(settings, stream="off")
        if multihost.is_coordinator():
            print("note: --mesh geom=N implies --stream off "
                  "(geometry sharding distributes resident partitions)",
                  file=sys.stderr)
    flat = flatten_scene(scene, cam_id, settings, device=device)
    if settings.compact_plan == "auto":
        from platinum_tpu_torch.render.autoplan import resolve_auto_plan

        settings = resolve_auto_plan(flat, settings)
    feats = analyze_features(flat)
    gmon = bool(settings.flags & FLAG_GMON)
    t0 = time.perf_counter()
    if geom:
        from platinum_tpu_torch.parallel.geometry import render_geom_sharded

        if flat.wbvh_parts is None:
            raise SystemExit(
                "--mesh geom=N needs a partitioned scene (the whole BVH "
                "fits one device; lower --partition-tris or drop the geom "
                "axis)")
        if gmon:
            raise SystemExit("--gmon is not supported with a geom mesh "
                             "axis yet; drop one of the two")
        img = render_geom_sharded(flat, settings, mesh, features=feats)
    elif gmon:
        from platinum_tpu_torch.parallel.shard import render_sharded_gmon

        img = render_sharded_gmon(flat, settings, mesh,
                                  cap=settings.gmon_cap, features=feats)
    else:
        from platinum_tpu_torch.parallel.shard import render_sharded

        img = render_sharded(flat, settings, mesh, features=feats)
    if img.is_cuda:
        torch.cuda.synchronize(img.device)
    dt = time.perf_counter() - t0
    coordinator = multihost.is_coordinator()
    if dist.is_initialized():
        dist.destroy_process_group()
    if not coordinator:
        return
    print(f"rendered {settings.spp} spp on mesh {mesh.shape} "
          f"in {dt:.2f}s", file=sys.stderr)
    out = args.output
    if out.endswith(".exr"):
        from platinum_tpu_torch.io.exr import write_exr

        write_exr(out, img.cpu().numpy())
    else:
        from platinum_tpu_torch.io.png import write_png
        from platinum_tpu_torch.post.pipeline import postprocess_jit

        write_png(out, postprocess_jit(img, post, settings.working_space,
                                       settings.output_space).cpu().numpy(),
                  output_space=settings.output_space)
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
    """Studio viewport preview: shaded frame + optional pick at a pixel."""
    if args.interactive:
        return cmd_preview_interactive(args)
    from platinum_tpu_torch.io.png import write_png
    from platinum_tpu_torch.render.studio import StudioRenderer

    scene, cam_id = _load_scene(args.scene)
    w, h = (int(v) for v in args.size.split("x"))
    studio = StudioRenderer(scene, width=w, height=h, device=args.device)
    if cam_id is not None:
        m = scene.world_transform(cam_id)
        studio.camera_to(m[:3, 3], m[:3, 3] - m[:3, 2] * 10.0)
    img = studio.render(selected_node=args.select)
    if args.pick:
        x, y = (int(v) for v in args.pick.split(","))
        print(f"node at ({x},{y}): {studio.readback_object_id_at(x, y)}")
    write_png(args.output, img)
    print(args.output)


def cmd_preview_interactive(args):
    """Interactive editor session (the capability of the reference's main
    loop, frontend.cpp:183-285, and the Store's deferred actions): stdin
    commands drive the studio camera, picking and selection between
    frames, and `render` runs a progressive path-traced render from the
    current view, restarted on any edit. Commands:

      orbit DX DY | pan DX DY | zoom D     camera controls
      pick X Y                             object id under a pixel
      select ID                            queue selection (outlined; applied
                                           between frames)
      remove ID [recursive|to_parent|to_root]  queue node removal
      move ID X Y Z                        set a node's translation
      mat ID [slot=N] key=value ...        edit the node's material
                                           (roughness/metallic/ior/...;
                                           base_color/emission take r,g,b)
      env PATH [S] | env color R,G,B [S]   set the environment map / constant
                                           colour with strength S
      cam key=value ...                    edit the render camera
                                           (focal_length/aperture/
                                           focus_distance/...), applied at
                                           render
      add KIND [NAME]                      add a primitive under the selection
                                           (plane|cube|sphere|cornell)
      import PATH                          glTF import under the selection
      savescene PATH                       write the scene as .ptscene
      frame                                write a studio frame
      spp N                                set progressive sample budget
      render [N]                           progressive render (N spp),
                                           writing the image as it converges
      save PATH                            write the current image
      quit                                 exit

    Scene edits (select/remove/import) go through the Store's deferred-
    action queue (app/store.py, reference store.cpp:56-67): they latch on
    the store and apply between frames, never mid-frame.
    """
    import numpy as np

    from platinum_tpu_torch.app.store import NodeAction, Store
    from platinum_tpu_torch.core import primitives
    from platinum_tpu_torch.core.camera import Camera
    from platinum_tpu_torch.core.material import Material
    from platinum_tpu_torch.core.scene import RemoveMode
    from platinum_tpu_torch.io.png import write_png
    from platinum_tpu_torch.render.renderer import Renderer, RenderStatus
    from platinum_tpu_torch.render.studio import StudioRenderer
    from platinum_tpu_torch.render.types import RenderSettings

    scene, cam_id = _load_scene(args.scene)
    cam_id = _ensure_camera(scene, cam_id, args)
    w, h = (int(v) for v in args.size.split("x"))
    store = Store(scene)
    studio = StudioRenderer(scene, width=w, height=h, device=args.device)
    m = scene.world_transform(cam_id)
    studio.camera_to(m[:3, 3], m[:3, 3] - m[:3, 2] * 10.0)
    spp = 16
    last = None
    cam_overrides: dict = {}
    env_owned_tid = None  # texture asset imported by this session's `env`

    def emit(img):
        nonlocal last
        last = img
        write_png(args.output, img)
        print(f"frame {args.output}", flush=True)

    def step_frame(scene_dirty: bool = False):
        """Apply deferred store actions, then render one studio frame."""
        action, _ = store.update()
        if action == NodeAction.REMOVE or scene_dirty:
            studio.invalidate()
        sel = store.selected_node if store.selected_node is not None else -1
        emit(studio.render(selected_node=sel))

    step_frame()
    print("ready", flush=True)
    for line in sys.stdin:
        parts = line.split()
        if not parts:
            continue
        cmd, rest = parts[0], parts[1:]
        try:
            if cmd == "quit":
                break
            elif cmd == "orbit":
                studio.handle_orbit(float(rest[0]), float(rest[1]))
                step_frame()
            elif cmd == "pan":
                studio.handle_pan(float(rest[0]), float(rest[1]))
                step_frame()
            elif cmd == "zoom":
                studio.handle_zoom(float(rest[0]))
                step_frame()
            elif cmd == "pick":
                nid = studio.readback_object_id_at(int(rest[0]), int(rest[1]))
                print(f"picked {nid}", flush=True)
            elif cmd == "select":
                store.select_node(int(rest[0]))
                step_frame()
            elif cmd == "remove":
                mode = {"recursive": RemoveMode.RECURSIVE,
                        "to_parent": RemoveMode.MOVE_TO_PARENT,
                        "to_root": RemoveMode.MOVE_TO_ROOT}[
                    rest[1] if len(rest) > 1 else "recursive"]
                store.remove_node(int(rest[0]), mode)
                step_frame()
                print(f"removed {rest[0]}", flush=True)
            elif cmd == "move":
                node = scene.node(int(rest[0]))
                node.transform.translation = np.asarray(
                    [float(v) for v in rest[1:4]], np.float32)
                studio.invalidate()
                step_frame()
                print(f"moved {rest[0]}", flush=True)
            elif cmd == "mat":
                node = scene.node(int(rest[0]))
                kv = dict(p.split("=", 1) for p in rest[1:])
                slot = int(kv.pop("slot", 0))
                mid = node.material_ids[slot]
                if mid is None:
                    # default-material slot: materialise one so the edit
                    # has something to land on
                    mid = scene.add_asset(Material(name=f"mat_{rest[0]}"))
                    scene.set_material(node.id, slot, mid)
                mat = scene.asset(mid)
                for key, val in kv.items():
                    cur = getattr(mat, key)  # AttributeError for bad names
                    if isinstance(cur, tuple):
                        vals = tuple(float(v) for v in val.split(","))
                        setattr(mat, key, vals + cur[len(vals):])
                    elif isinstance(cur, bool):
                        setattr(mat, key, val.lower() in ("1", "true", "on"))
                    else:
                        setattr(mat, key, type(cur)(val))
                studio.invalidate()
                step_frame()
                print(f"mat {mid} " + " ".join(sorted(kv)), flush=True)
            elif cmd == "env":
                env = scene.environment
                if rest[0] == "color":
                    rgb = tuple(float(v) for v in rest[1].split(","))
                    if len(rgb) != 3:
                        raise ValueError(
                            f"env color takes exactly R,G,B "
                            f"(got {len(rgb)} components)")
                    env.set_texture(None)
                    env.constant_color = rgb
                    new_tid = None
                    strength = rest[2:3]
                else:
                    # hdr inferred from the extension: .exr/.hdr load as
                    # linear float, LDR images decode sRGB -> linear
                    new_tid = store.import_texture(rest[0])
                    scene.retain_asset(new_tid)
                    env.set_texture(
                        new_tid, scene.asset(new_tid).as_float_rgba())
                    strength = rest[1:2]
                # release the previously imported map so replaced env
                # textures don't accumulate in the scene / saved .ptscene
                if env_owned_tid is not None and env_owned_tid != new_tid:
                    scene.release_asset(env_owned_tid)
                env_owned_tid = new_tid
                if strength:
                    env.strength = float(strength[0])
                print(f"env {rest[0]}", flush=True)
            elif cmd == "cam":
                # scalar numeric fields only (sensor_size is a tuple); the
                # values take the field's own type, applied all or nothing
                probe = Camera()
                pending = {}
                for p in rest:
                    k, v = p.split("=", 1)
                    cur = getattr(probe, k, None)
                    if not isinstance(cur, (int, float)):
                        raise KeyError(
                            f"unknown or non-scalar camera attribute {k!r}")
                    pending[k] = type(cur)(float(v))
                cam_overrides.update(pending)
                print("cam " + " ".join(sorted(cam_overrides)), flush=True)
            elif cmd == "add":
                kind = rest[0]
                mesh = {"plane": primitives.plane, "cube": primitives.cube,
                        "sphere": primitives.sphere,
                        "cornell": primitives.cornell_box}[kind]()
                name = rest[1] if len(rest) > 1 else kind
                nid = store.create_primitive(name, mesh)
                step_frame(scene_dirty=True)
                print(f"added {kind} {nid}", flush=True)
            elif cmd == "import":
                roots = store.import_gltf(rest[0])
                step_frame(scene_dirty=True)
                print(f"imported {rest[0]} nodes {roots}", flush=True)
            elif cmd == "savescene":
                store.save_as(rest[0])
                print(f"scene saved {rest[0]}", flush=True)
            elif cmd == "frame":
                step_frame()
            elif cmd == "spp":
                spp = int(rest[0])
                print(f"spp {spp}", flush=True)
            elif cmd == "save":
                if last is not None:
                    write_png(rest[0], last)
                print(f"saved {rest[0]}", flush=True)
            elif cmd == "render":
                n = int(rest[0]) if rest else spp
                cam_node = studio.camera.attach(scene)
                for k, v in cam_overrides.items():
                    setattr(scene.node(cam_node).camera, k, v)
                renderer = Renderer(scene, device=args.device)
                # the preview ladder: the first frames render at 1/4 the
                # size and are upscaled while the full-resolution
                # accumulation converges underneath
                renderer.start_render(cam_node, RenderSettings(
                    width=w, height=h, spp=n, max_bounces=8,
                    sampler="pcg4d", compact_plan="auto"),
                    preview_scale=4, preview_spp=4)
                while renderer._pv is not None and \
                        renderer._pv["done"] < renderer._pv["spp"]:
                    t0 = time.perf_counter()
                    renderer.render()
                    emit(renderer.readback())
                    print(f"preview frame {renderer._pv['done']} "
                          f"{(time.perf_counter() - t0) * 1e3:.0f} ms",
                          flush=True)
                step = max(1, n // 4)
                while not (renderer.status & RenderStatus.DONE):
                    for _ in range(step):
                        renderer.render()
                        if renderer.status & RenderStatus.DONE:
                            break
                    emit(renderer.readback())
                    print(f"progress {renderer.render_progress:.2f}",
                          flush=True)
                print(f"rendered {n} spp in {renderer.render_time:.2f}s",
                      flush=True)
            else:
                print(f"unknown command: {cmd}", flush=True)
        except (ValueError, IndexError, KeyError, OSError,
                AttributeError, TypeError) as e:
            print(f"error: {e}", flush=True)
    print("bye", flush=True)


def cmd_bake_luts(args):
    from platinum_tpu_torch.tools.lut_baker import bake_all

    bake_all(spp_2d=args.spp, spp_avg=args.spp * 2, spp_3d=args.spp // 2,
             write_exr_slices=args.exr, device=args.device)


def build_parser():
    p = argparse.ArgumentParser(prog="platinum-tpu-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render", help="render a scene to PNG/EXR")
    r.add_argument("scene", help=".gltf/.glb/.ptscene path or 'cornell'")
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
                   help="multi-device render over a named mesh of ranks "
                        "(start them with torchrun), e.g. "
                        "'sample=2,tile=4' or 'sample=2,tile=2,geom=2' "
                        "(geom spreads the scene's partitions over ranks)")
    r.add_argument("--instancing", choices=["auto", "on", "off"],
                   default="auto",
                   help="two-level TLAS/BLAS instancing (auto: on when "
                        "meshes are reused)")
    r.add_argument("--partition-tris", type=int, default=None,
                   help="per-partition triangle budget (default 350k; "
                        "lower it to force partitioning, e.g. for --mesh "
                        "geom=N)")
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

    pv = sub.add_parser("preview", help="studio viewport preview frame")
    pv.add_argument("scene")
    pv.add_argument("-o", "--output", default="preview.png")
    pv.add_argument("--device", default="cuda",
                    help="torch device to trace on (default cuda; cpu for "
                         "tests)")
    pv.add_argument("--size", default="960x540")
    pv.add_argument("--select", type=int, default=-1)
    pv.add_argument("--pick", default=None, help="x,y pixel to pick")
    pv.add_argument("--interactive", action="store_true",
                    help="stdin-driven editor session (orbit/pan/zoom/"
                         "pick/select/render)")
    pv.set_defaults(func=cmd_preview)

    b = sub.add_parser("bake-luts", help="regenerate GGX energy LUTs")
    b.add_argument("--spp", type=int, default=8192)
    b.add_argument("--exr", action="store_true", help="also write EXR slices")
    b.add_argument("--device", default="cuda",
                   help="torch device to bake on (default cuda; cpu for "
                        "the CPU)")
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
