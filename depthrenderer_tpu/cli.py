"""Single-scene CLI: colour + depth pair → animated novel-view video + sample frame.

Surface parity with the reference CLI (``DepthRenderer/__main__.py:38-176``)::

    python -m depthrenderer_tpu <colour> <depth> -fps 60 -mesh-density 8 \
        -displacement-factor 4.0 -output-path frames

Same defaults (fps=60, density=8, displacement=4.0, output 'frames'; fov_y=18,
camera at dz=-10, 5-second composed sway animation, 3 loops, sample frame at frame
10, ``<image name>.avi`` video). The frame loop is replaced by the batched
device pipeline: animation → (T, 4, 4) MVPs → chunked device rendering
overlapped with host-side encoding.

Deliberate deviations (documented in SURVEY.md §7): output resolution is the image
size (not half the host screen — there is no screen), and there is no 3-frame
"window settling" delay (``__main__.py:137-139``) because nothing needs to settle.
"""

from __future__ import annotations

import argparse
import os
import time
from pathlib import Path

import numpy as np

from . import animation as anim_mod
from . import io as dio
from . import runtime, transforms
from .render import render_clip
from .scene import Camera, Mesh, Texture
from .utils import log
from .writers import AsyncImageWriter, AsyncVideoWriter

SAMPLE_FRAME_INDEX = 10  # reference: DelayedTask(OneTimeTask(write), delay=10)


def build_parser(prog="python -m depthrenderer_tpu"):
    p = argparse.ArgumentParser(
        prog=prog,
        description="Render a colour/depth image pair as an animated novel-view "
        "video using the tiled grid rasteriser.",
    )
    p.add_argument("image_path", type=Path, help="The path to the colour image.")
    p.add_argument("depth_path", type=Path,
                   help="The path to the depth map corresponding to the colour image.")
    # Single-dash long options preserve the reference's plac-style surface;
    # double-dash aliases are also accepted.
    for names, kwargs in [
        (("-fps", "--fps"), dict(type=float, default=60.0,
                                 help="Target frames per second (default 60).")),
        (("-mesh-density", "--mesh-density"),
         dict(type=int, default=8, dest="mesh_density",
              help="Grid subdivision; +1 roughly quadruples vertex count (default 8).")),
        (("-displacement-factor", "--displacement-factor"),
         dict(type=float, default=4.0, dest="displacement_factor",
              help="Multiplier on normalised depth (default 4.0).")),
        (("-output-path", "--output-path"),
         dict(type=Path, default=Path("frames"), dest="output_path",
              help="Directory for output frames/video (default 'frames').")),
    ]:
        p.add_argument(*names, **kwargs)
    p.add_argument("--width", type=int, default=None,
                   help="Output width (default: colour image width).")
    p.add_argument("--height", type=int, default=None,
                   help="Output height (default: colour image height).")
    p.add_argument("--frames", type=int, default=None,
                   help="Total frames (default: 3 animation loops = 3*5*fps).")
    p.add_argument("--loops", type=float, default=3.0,
                   help="Animation loops when --frames is unset (default 3).")
    p.add_argument("--fov-y", type=float, default=18.0, dest="fov_y",
                   help="Vertical field of view in degrees (default 18).")
    p.add_argument("--mode", choices=("texture", "debug_z"), default="texture",
                   help="Shading mode (debug_z = the reference's debug shader).")
    p.add_argument("--codec", choices=("MJPG", "DIB "), default="MJPG",
                   help="AVI codec: MJPG (compact) or 'DIB ' (uncompressed).")
    p.add_argument("--container", choices=("avi", "mp4"), default="avi",
                   help="Video container: avi (native) or mp4 (H.264 via "
                        "ffmpeg; falls back to avi with a notice).")
    p.add_argument("--frame-batch", type=int, default=8, dest="frame_batch",
                   help="Frames rendered per device dispatch (default 8).")
    p.add_argument("--binning-quantile", type=float, default=0.995,
                   dest="binning_quantile",
                   help="Candidate-window sizing quantile: 1.0 = lossless "
                        "binning (slower), lower = faster with possible speckles "
                        "at depth edges (default 0.995).")
    p.add_argument("--edge-cull", type=float, default=None, dest="edge_cull",
                   help="Cull triangles whose model-z spread exceeds this "
                        "(depth-discontinuity edge culling).")
    p.add_argument("--no-video", action="store_true",
                   help="Skip video output (write only the sample frame).")
    p.add_argument("--png-every", type=int, default=None, dest="png_every",
                   help="Also dump every Nth frame as PNG.")
    p.add_argument("--overlay-noise", type=int, nargs="+", default=None,
                   dest="overlay_noise", metavar="SCALE",
                   help="Overlay Perlin noise on the depth map at the given "
                        "scales (the reference's depth-augmentation path, e.g. "
                        "--overlay-noise 32 16 8).")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    runtime.enable_compile_cache()
    log(f"Device: {runtime.describe_device()}; rasteriser: "
        f"{runtime.raster_impl()}.")

    log(f"Loading colour image {args.image_path} ...")
    colour = dio.load_colour(args.image_path)
    depth = dio.load_depth(args.depth_path)
    depth = dio.resize(depth, colour.shape)

    if args.overlay_noise:
        from .utils import overlay_noise

        # Reference: depth = overlay_noise(overlay_noise(...), ...) (__main__.py:88).
        d = depth[..., None]
        for scale in args.overlay_noise:
            d = overlay_noise(d, scale=scale, seed=0)
        depth = d[..., 0]

    texture = Texture(colour)
    mesh = Mesh.from_texture(texture, depth_map=depth, density=args.mesh_density,
                             debug=True)
    mesh.vertices[:, 2] *= args.displacement_factor

    height, width = colour.shape[:2]
    out_w = args.width or width
    out_h = args.height or height

    camera = Camera(window_size=(width, height), fov_y=args.fov_y)
    camera_position = np.asarray(transforms.translation(dz=-10.0))

    log(f"Model:\n{mesh.transform}")
    log(f"View (camera position):\n{camera_position}")
    log(f"Projection:\n{camera.projection}")

    os.makedirs(args.output_path, exist_ok=True)

    animation_length_secs = 5.0
    sway = anim_mod.default_sway(animation_length_secs)
    num_frames = args.frames
    if num_frames is None:
        num_frames = int(args.loops * animation_length_secs * args.fps)

    times = anim_mod.frame_times(num_frames, args.fps)
    anim_batch = np.asarray(sway.batch(times))  # (T, 4, 4)
    views = camera_position[None] @ anim_batch  # camera.view = position @ anim


    image_writer = AsyncImageWriter(num_workers=1)
    video_writer = None
    if not args.no_video:
        video_writer = AsyncVideoWriter(
            os.path.join(args.output_path,
                         f"{Path(args.image_path).name}.{args.container}"),
            size=(out_w, out_h), fps=args.fps, codec=args.codec,
        )

    sample_path = os.path.join(args.output_path, "sample_frame.png")
    wrote_sample = False

    def on_frames(start, frames):
        nonlocal wrote_sample
        for k in range(frames.shape[0]):
            idx = start + k
            if video_writer is not None:
                video_writer.write(frames[k])
            if not wrote_sample and idx >= min(SAMPLE_FRAME_INDEX, num_frames - 1):
                image_writer.write(frames[k], sample_path)
                wrote_sample = True
            if args.png_every and idx % args.png_every == 0:
                image_writer.write(
                    frames[k], os.path.join(args.output_path, f"{idx:06d}.png")
                )

    log(f"Rendering {num_frames} frames at {out_w}x{out_h} "
        f"(mesh density {args.mesh_density}, {mesh.num_triangles:,d} triangles)...")
    t0 = time.time()
    render_clip(mesh, camera.projection, views, out_w, out_h,
                mode=args.mode, frame_batch=args.frame_batch, on_frames=on_frames,
                binning_quantile=args.binning_quantile,
                edge_cull_threshold=args.edge_cull)
    if video_writer is not None:
        video_writer.cleanup()
    image_writer.cleanup()
    dt = time.time() - t0
    log(f"Rendered and wrote {num_frames} frames in {dt:.2f}s "
        f"({num_frames / dt:.1f} frames/s).")
    texture.cleanup()
    mesh.cleanup()
    log(f"Output written to {args.output_path}.")
    return 0
