"""Batch/dataset CLI: one colour image × many depth-model subdirectories.

Capability parity with the reference's ``render_many.py``: each subdirectory of
``depth_maps_path`` holds a depth map named like the colour image; every model gets
its own animated video, periodic PNG frame dumps, and afterwards mosaic /
concatenated / ground-truth-paired comparison videos are produced
(``render_many.py:150-382``).

Redesign: the reference renders models strictly sequentially through one
GL context (``ContextSwitcher``, ``render_many.py:270-292``). Here each model is a
*scene* in a batched pipeline — meshes are re-skinned from a shared grid
(``Mesh.from_copy_with_new_depth`` fast path), scenes shard over the device mesh
when more than one device is available, and frames stream to per-model async video
writers on the host. A per-scene manifest makes interrupted runs resumable (the
reference restarts from scratch; SURVEY.md §5).

Usage::

    python -m depthrenderer_tpu.batch <colour image> <depth-maps dir> \
        -fps 60 -mesh-density 8 -displacement-factor 4.0 -output-path output
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

import numpy as np

from . import animation as anim_mod
from . import io as dio
from . import runtime, transforms
from .render import render_clip
from .scene import Camera, Mesh, Texture
from .tasks import RecurringTask
from .utils import log
from .writers import AsyncImageWriter, AsyncVideoWriter
from . import postprocess


def build_parser(prog="python -m depthrenderer_tpu.batch"):
    p = argparse.ArgumentParser(
        prog=prog,
        description="Render one colour image against many depth-model outputs and "
        "produce per-model and comparison videos.",
    )
    p.add_argument("image_path", type=Path, help="The path to the colour image.")
    p.add_argument("depth_maps_path", type=Path,
                   help="Folder of per-model subfolders, each containing a depth map "
                        "with the same file name as the colour image.")
    for names, kwargs in [
        (("-fps", "--fps"), dict(type=float, default=60.0)),
        (("-mesh-density", "--mesh-density"),
         dict(type=int, default=8, dest="mesh_density")),
        (("-displacement-factor", "--displacement-factor"),
         dict(type=float, default=4.0, dest="displacement_factor")),
        (("-output-path", "--output-path"),
         dict(type=Path, default=Path("output"), dest="output_path")),
    ]:
        p.add_argument(*names, **kwargs)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--frames", type=int, default=None,
                   help="Frames per model (default: one animation loop).")
    p.add_argument("--fov-y", type=float, default=18.0, dest="fov_y")
    p.add_argument("--codec", choices=("MJPG", "DIB "), default="MJPG")
    p.add_argument("--frame-batch", type=int, default=8, dest="frame_batch")
    p.add_argument("--binning-quantile", type=float, default=0.995,
                   dest="binning_quantile",
                   help="Candidate-window sizing quantile (1.0 = lossless).")
    p.add_argument("--edge-cull", type=float, default=None, dest="edge_cull")
    p.add_argument("--png-every-seconds", type=float, default=1.0,
                   dest="png_every_seconds",
                   help="PNG dump interval in seconds (reference: 1/s).")
    p.add_argument("--resume", action="store_true",
                   help="Skip models already recorded in the output manifest.")
    p.add_argument("--no-post", action="store_true",
                   help="Skip mosaic/concat/paired post-processing.")
    p.add_argument("--container", choices=("avi", "mp4"), default="avi",
                   help="Video container: avi (native, no dependencies) or mp4 "
                        "(H.264 via ffmpeg, falls back to avi with a notice).")
    p.add_argument("--sharded", action="store_true",
                   help="Shard the models (scenes) over all available devices via "
                        "shard_map instead of rendering them sequentially.")
    p.add_argument("--readback", choices=("auto", "rgba", "yuv420"),
                   default="auto",
                   help="--sharded frame readback format. yuv420 packs "
                        "frames to planar YUV 4:2:0 on the device (1.5 B/px "
                        "device->host instead of 4) and the MJPEG encoder "
                        "takes the planes directly; PNG snapshot frames "
                        "still read back as full RGBA. auto = yuv420 for "
                        "MJPG video at even frame sizes, rgba otherwise.")
    return p


def discover_models(depth_maps_path, image_filename):
    """Sorted model subdirectories containing the expected depth map."""
    models = []
    for entry in sorted(os.listdir(depth_maps_path)):
        full = os.path.join(depth_maps_path, entry)
        if os.path.isdir(full):
            depth = os.path.join(full, image_filename)
            if os.path.exists(depth):
                models.append((entry, depth))
            else:
                log(f"Skipping model '{entry}': no depth map {depth}")
    return models


def main(argv=None):
    args = build_parser().parse_args(argv)
    runtime.enable_compile_cache()
    log(f"Device: {runtime.describe_device()}; rasteriser: "
        f"{runtime.raster_impl()}.")

    image_filename = Path(args.image_path).name
    image_name = Path(args.image_path).stem
    models = discover_models(args.depth_maps_path, image_filename)
    if not models:
        raise SystemExit(f"No model subdirectories with '{image_filename}' found "
                         f"under {args.depth_maps_path}.")

    video_output_path = os.path.join(args.output_path, "single_videos", image_name)
    os.makedirs(video_output_path, exist_ok=True)
    manifest_path = os.path.join(args.output_path, f"{image_name}.manifest.json")
    manifest = {}
    if args.resume and os.path.exists(manifest_path):
        manifest = json.load(open(manifest_path))

    colour = dio.load_colour(args.image_path)
    height, width = colour.shape[:2]
    out_w = args.width or width
    out_h = args.height or height

    texture = Texture(colour)
    camera = Camera(window_size=(width, height), fov_y=args.fov_y)
    camera_position = np.asarray(transforms.translation(dz=-10.0))

    # The reference's batch-mode camera path (render_many.py:318-330).
    rotation_angle = 2.5
    loops_per_second = 0.5 / rotation_angle
    sway = anim_mod.Compose([
        anim_mod.RotateAxisBounce(np.deg2rad(rotation_angle), axis=transforms.Axis.Y,
                                  offset=0.5, speed=-loops_per_second),
        anim_mod.RotateAxisBounce(np.deg2rad(rotation_angle / 5.0),
                                  axis=transforms.Axis.X, offset=0.5,
                                  speed=-loops_per_second),
        anim_mod.Translate(distance=0.30, speed=loops_per_second),
        anim_mod.Translate(distance=0.15, axis=transforms.Axis.Y, offset=0.25,
                           speed=loops_per_second),
    ])

    num_frames = args.frames
    if num_frames is None:
        num_frames = int(args.fps / loops_per_second)  # one loop, as the reference

    times = anim_mod.frame_times(num_frames, args.fps)
    views = camera_position[None] @ np.asarray(sway.batch(times))

    png_every = max(1, int(round(args.png_every_seconds * args.fps)))

    image_writer = AsyncImageWriter()
    base_mesh = None
    video_sources = []
    model_names = []

    if args.sharded:
        video_sources, model_names = _render_sharded(
            args, models, colour, texture, camera, views, num_frames, png_every,
            out_w, out_h, video_output_path, image_writer, manifest,
            manifest_path,
        )
        image_writer.cleanup()
        _postprocess(args, video_sources, model_names, image_name, out_w, out_h)
        log("Batch rendering complete.")
        return 0

    for model_name, depth_path in models:
        model_names.append(model_name)
        video_path = os.path.join(video_output_path,
                                  f"{model_name}.{args.container}")
        video_sources.append(video_path)

        if args.resume and manifest.get(model_name, {}).get("frames") == num_frames \
                and os.path.exists(video_path):
            log(f"[{model_name}] already complete, skipping (resume).")
            continue

        depth = dio.resize(dio.load_depth(depth_path), colour.shape)
        if base_mesh is None:
            base_mesh = Mesh.from_texture(texture, depth, density=args.mesh_density)
            mesh = base_mesh
        else:
            # Fast path: re-skin the shared grid with the new depth
            # (reference: Mesh.from_copy_with_new_depth, render.py:547-565).
            mesh = Mesh.from_copy_with_new_depth(base_mesh, depth)
        mesh.vertices[:, 2] = mesh.vertices[:, 2] * args.displacement_factor

        video_writer = AsyncVideoWriter(video_path, size=(out_w, out_h),
                                        fps=args.fps, codec=args.codec)
        frames_dir = os.path.join(args.output_path, "frames", model_name)
        os.makedirs(frames_dir, exist_ok=True)
        png_task = RecurringTask(
            lambda frame, idx, d=frames_dir: image_writer.write(
                frame, os.path.join(d, f"{idx:06d}.png")),
            frequency=png_every,
        )

        def on_frames(start, frames):
            for k in range(frames.shape[0]):
                video_writer.write(frames[k])
                png_task(frames[k], start + k)

        log(f"[{model_name}] rendering {num_frames} frames at {out_w}x{out_h}...")
        t0 = time.time()
        render_clip(mesh, camera.projection, views, out_w, out_h,
                    frame_batch=args.frame_batch, on_frames=on_frames,
                    binning_quantile=args.binning_quantile,
                    edge_cull_threshold=args.edge_cull)
        video_writer.cleanup()
        dt = time.time() - t0
        log(f"[{model_name}] {num_frames} frames in {dt:.2f}s "
            f"({num_frames / dt:.1f} frames/s).")

        manifest[model_name] = {"frames": num_frames, "video": video_path}
        with open(manifest_path, "w") as f:
            json.dump(manifest, f, indent=2)

    image_writer.cleanup()

    _postprocess(args, video_sources, model_names, image_name, out_w, out_h)

    log("Batch rendering complete.")
    return 0


def _postprocess(args, video_sources, model_names, image_name, out_w, out_h):
    if args.no_post:
        return
    # Both containers decode natively (video.read_video_frames dispatches
    # AVI/MP4); ffmpeg, when present, is still preferred for H.264 output.
    backend = "auto"
    postprocess.create_mosaic_video(video_sources,
                                    os.path.join(args.output_path, "mosaic"),
                                    image_name, (out_h, out_w), fps=args.fps,
                                    backend=backend)
    postprocess.create_concat_video(video_sources,
                                    os.path.join(args.output_path, "concat"),
                                    image_name, backend=backend)
    if "ground_truth" in model_names:
        postprocess.create_paired_videos(video_sources,
                                         os.path.join(args.output_path, "paired"),
                                         image_name, model_names, backend=backend)
    else:
        log("No 'ground_truth' model; skipping paired videos.")


def _render_sharded(args, models, colour, texture, camera, views, num_frames,
                    png_every, out_w, out_h, video_output_path,
                    image_writer, manifest, manifest_path):
    """Scene-parallel batch rendering: all models sharded over the device mesh.

    Replaces the reference's sequential per-model loop: each device renders its
    shard of scenes for a chunk of views; the host streams frames to the
    per-model writers. View chunking bounds device memory regardless of scene
    count or resolution.
    """
    from .parallel import make_render_mesh, render_scenes_sharded, shard_scenes

    n = 2 ** args.mesh_density + 1
    impl = runtime.raster_impl()
    # Device-side YUV 4:2:0 readback needs MJPG and an even frame size.
    yuv_ok = args.codec == "MJPG" and out_w % 2 == 0 and out_h % 2 == 0
    if args.readback == "yuv420" and not yuv_ok:
        raise SystemExit(
            f"--readback yuv420 needs the MJPG codec and an even frame size "
            f"(got codec {args.codec!r}, {out_w}x{out_h}); use --readback "
            f"rgba.")
    yuv = args.readback == "yuv420" or (args.readback == "auto" and yuv_ok)
    device_mesh = make_render_mesh()
    log(f"Sharding {len(models)} scenes over {device_mesh.devices.size} "
        f"device(s) (impl={impl}, readback={'yuv420' if yuv else 'rgba'}).")

    base_mesh = None
    vgrids, model_names, video_sources, writers, png_tasks = [], [], [], [], []

    for model_name, depth_path in models:
        model_names.append(model_name)
        video_path = os.path.join(video_output_path,
                                  f"{model_name}.{args.container}")
        video_sources.append(video_path)

        depth = dio.resize(dio.load_depth(depth_path), colour.shape)
        if base_mesh is None:
            base_mesh = Mesh.from_texture(texture, depth, density=args.mesh_density)
            mesh = base_mesh
        else:
            mesh = Mesh.from_copy_with_new_depth(base_mesh, depth)
        mesh.vertices[:, 2] = mesh.vertices[:, 2] * args.displacement_factor
        vgrids.append(mesh.vertices.reshape(n, n, 3))

        writers.append(AsyncVideoWriter(video_path, size=(out_w, out_h),
                                        fps=args.fps, codec=args.codec))
        frames_dir = os.path.join(args.output_path, "frames", model_name)
        os.makedirs(frames_dir, exist_ok=True)
        png_tasks.append(RecurringTask(
            # ``frame`` may be a zero-arg callable (the YUV420 readback path
            # passes a lazy device slice so only the due frames pull RGBA).
            lambda frame, idx, d=frames_dir: image_writer.write(
                frame() if callable(frame) else frame,
                os.path.join(d, f"{idx:06d}.png")),
            frequency=png_every,
        ))

    S = len(models)
    from .ops.raster_grid import measured_config

    proj0 = np.asarray(camera.projection, np.float32)
    sample_mvps = np.stack([
        proj0 @ np.asarray(views[k], np.float32)
        for k in np.linspace(0, len(views) - 1, min(3, len(views))).astype(int)
    ])
    # Measure candidate windows across EVERY scene and take the max span:
    # models with stronger depth relief than scene 0 would otherwise exceed the
    # shared windows and silently drop triangles (the sequential path sizes per
    # scene).
    per_scene = [
        measured_config(sample_mvps, vg, out_w, out_h,
                        quantile=args.binning_quantile,
                        edge_cull_threshold=args.edge_cull)
        for vg in vgrids
    ]
    import dataclasses as _dc

    config = _dc.replace(
        per_scene[0],
        window_rows=max(c.window_rows for c in per_scene),
        window_cols=max(c.window_cols for c in per_scene),
    )
    from .ops.raster_grid import binning_overflow_tiles

    uvgrid0 = base_mesh.texture_coordinates.reshape(n, n, 2)
    overflow = max(
        int(np.asarray(binning_overflow_tiles(
            sample_mvps, vg, uvgrid0, out_w, out_h, config)).max())
        for vg in vgrids
    )
    if overflow:
        log(f"WARNING: {overflow} tile(s) exceed the shared candidate window at "
            f"the sampled views (binning_quantile={args.binning_quantile}); "
            f"triangles near strong depth edges may be dropped there. Re-run "
            f"with --binning-quantile 1.0 for lossless binning.")
    uvgrid = base_mesh.texture_coordinates.reshape(n, n, 2)
    tex = np.asarray(colour, np.float32)
    # Scene data goes to the devices once, each scene shard to its own device.
    vgrids, uvgrids, textures = shard_scenes(device_mesh, (
        np.stack(vgrids), np.broadcast_to(uvgrid, (S,) + uvgrid.shape),
        np.broadcast_to(tex, (S,) + tex.shape)))

    proj = np.asarray(camera.projection, np.float32)
    mvps_all = (proj[None] @ np.asarray(views, np.float32)).astype(np.float32)

    t0 = time.time()
    chunk = max(1, args.frame_batch)

    def consume(start, stop, dev_frames, dev_yuv):
        if yuv:
            packed = np.asarray(dev_yuv)  # (S, Tc, H*W*3/2)
            cq = out_h * out_w // 4
            for s in range(S):
                for k in range(stop - start):
                    p = packed[s, k]
                    writers[s].write_yuv420(
                        p[:out_h * out_w].reshape(out_h, out_w),
                        p[out_h * out_w:out_h * out_w + cq].reshape(
                            out_h // 2, out_w // 2),
                        p[out_h * out_w + cq:].reshape(
                            out_h // 2, out_w // 2))
                    png_tasks[s](
                        lambda s=s, k=k: np.asarray(dev_frames[s, k]),
                        start + k)
            return
        frames = np.asarray(dev_frames)  # (S, Tc, H, W, 4)
        for s in range(S):
            for k in range(stop - start):
                writers[s].write(frames[s, k])
                png_tasks[s](frames[s, k], start + k)

    # One-chunk pipeline: dispatch chunk i+1 BEFORE reading back chunk i, so
    # the readback and writer encode of a chunk overlap the device render of
    # the next — the headless analogue of the reference's double-PBO async
    # readback (render.py:636-652,775-797).
    pending = None
    for start in range(0, num_frames, chunk):
        stop = min(start + chunk, num_frames)
        mvps = np.broadcast_to(mvps_all[start:stop], (S, stop - start, 4, 4)).copy()
        dev_frames = render_scenes_sharded(
            device_mesh, mvps, vgrids, uvgrids, textures, out_w, out_h, config,
            frame_batch=stop - start, impl=impl,
        )  # async dispatch
        dev_yuv = dio.rgba_to_yuv420(dev_frames) if yuv else None
        if pending is not None:
            consume(*pending)
        pending = (start, stop, dev_frames, dev_yuv)
    if pending is not None:
        consume(*pending)

    for s, model_name in enumerate(model_names):
        writers[s].cleanup()
        manifest[model_name] = {"frames": num_frames, "video": video_sources[s]}
    with open(manifest_path, "w") as f:
        json.dump(manifest, f, indent=2)
    dt = time.time() - t0
    total = S * num_frames
    log(f"Rendered {total} frames ({S} scenes x {num_frames}) in {dt:.2f}s "
        f"({total / dt:.1f} frames/s aggregate).")
    return video_sources, model_names


if __name__ == "__main__":
    import sys

    sys.exit(main())
