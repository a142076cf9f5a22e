"""Seeded synthetic scenes: colour + depth pairs made inside the repository.

Every input the tests, the benchmark and ``chip_smoke.py`` render comes from
here, generated from a ``seed`` at any size, so nothing depends on a file
outside the checkout. A scene is what ``io.load_colour`` / ``io.load_depth``
return for a real pair: an ``(H, W, 4)`` RGBA uint8 colour image and an
``(H, W)`` uint8 depth map (255 = nearest, the reference's convention,
``utils.py:169-186``). The depth map holds the cases a depth renderer has to
get right:

* smooth regions (Perlin relief, ``utils.perlin``) on a slanted background;
* a steep slanted plane along the bottom, which folds over itself under the
  sway camera path;
* foreground slabs and a dome standing in front of the background, whose
  borders are real depth discontinuities.

The colour image carries texture detail at several frequencies (fine grid
lines, checkers, stripes, rings), so bilinear sampling and winner-selection
errors show in the rendered pixels.

``write_batch_tree`` lays out the batch CLI's input: one colour image and a
``depth_maps/<model>/<image>.png`` tree of three depth variants that differ
the way depth estimators do — smooth, edge-heavy and noisy.

Usage: ``python -m depthrenderer_tpu.scenes OUT_DIR [--seed S] [--width W]
[--height H] [--batch]``
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from .io import save_image
from .utils import perlin

VARIANTS = ("smooth", "edges", "noisy")


def make_scene(seed: int, width: int, height: int):
    """One seeded scene -> ``(colour (H, W, 4) uint8, depth (H, W) uint8)``."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float64)
    u, v = xx / width, yy / height

    # Background: a gently slanted plane with smooth relief.
    relief = perlin(width, height, scale=4, seed=int(rng.integers(1 << 31)))
    depth = 50.0 + 30.0 * v + 15.0 * u + 25.0 * relief
    # Steep slanted floor along the bottom: folds under sway.
    floor = v > 0.78
    depth = np.where(floor, depth + 400.0 * (v - 0.78), depth)
    label = np.where(floor, 1, 0)

    # Foreground slabs: constant or tilted faces with sharp borders.
    for k in range(4):
        w = rng.uniform(0.10, 0.22) * width
        h = rng.uniform(0.12, 0.30) * height
        x0 = rng.uniform(0.05, 0.95) * width - w / 2
        y0 = rng.uniform(0.08, 0.70) * height
        inside = (xx >= x0) & (xx < x0 + w) & (yy >= y0) & (yy < y0 + h)
        tilt = rng.uniform(-60.0, 60.0) * (xx - x0) / w if k % 2 else 0.0
        depth = np.where(inside, rng.uniform(140.0, 200.0) + tilt, depth)
        label = np.where(inside, 2 + k, label)

    # A dome: smooth inside, a discontinuity at its rim.
    cx, cy = rng.uniform(0.3, 0.7) * width, rng.uniform(0.3, 0.6) * height
    rad = 0.12 * min(width, height)
    d2 = ((xx - cx) ** 2 + (yy - cy) ** 2) / rad**2
    dome = d2 < 1.0
    depth = np.where(dome, 170.0 + 70.0 * np.sqrt(np.clip(1.0 - d2, 0.0, 1.0)),
                     depth)
    label = np.where(dome, 6, label)
    depth = np.clip(np.round(depth), 0, 255).astype(np.uint8)

    # Colour: hue from a smooth field, detail that differs per region.
    hue = perlin(width, height, scale=3, seed=int(rng.integers(1 << 31)))
    base = np.stack([0.5 + 0.5 * np.sin(2 * np.pi * (hue + o))
                     for o in (0.0, 1 / 3, 2 / 3)], axis=-1)
    period = max(4, min(width, height) // 60)
    checker = ((xx // period + yy // period) % 2)[..., None]
    stripes = (np.sin(2 * np.pi * (xx + 0.5 * yy) / (1.5 * period)) > 0)[
        ..., None]
    rings = (np.sin(np.sqrt(d2) * 12 * np.pi) > 0)[..., None]
    grid_lines = ((xx % (4 * period) < 1) | (yy % (4 * period) < 1))[..., None]
    lab = label[..., None]
    colour = base * np.where(lab == 0, 0.55 + 0.45 * checker,
                             np.where(lab == 1, 0.6 + 0.4 * stripes,
                                      np.where(lab == 6, 0.5 + 0.5 * rings,
                                               0.65 + 0.35 * checker)))
    colour = np.where(grid_lines, 1.0 - colour, colour)
    rgb = np.clip(np.round(255.0 * colour), 0, 255).astype(np.uint8)
    alpha = np.full((height, width, 1), 255, np.uint8)
    return np.concatenate([rgb, alpha], axis=-1), depth


def depth_variants(depth, seed: int):
    """Three depth maps of one scene, as three depth estimators might give
    them: ``smooth`` (blurred, edges softened), ``edges`` (quantised into
    hard steps, more discontinuities) and ``noisy`` (per-pixel noise)."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)
    d = depth.astype(np.float64)
    sigma = max(1.0, min(depth.shape) / 120.0)
    noise = rng.normal(0.0, 6.0, depth.shape)
    out = {
        "smooth": gaussian_filter(d, sigma),
        "edges": np.round(d / 24.0) * 24.0,
        "noisy": d + noise,
    }
    return {k: np.clip(np.round(v), 0, 255).astype(np.uint8)
            for k, v in out.items()}


def write_pair(out_dir, seed: int, width: int, height: int,
               name: str = "scene"):
    """Write one scene as ``<name>_colour.png`` + ``<name>_depth.png``.
    Returns the two paths."""
    os.makedirs(out_dir, exist_ok=True)
    colour, depth = make_scene(seed, width, height)
    paths = (os.path.join(out_dir, f"{name}_colour.png"),
             os.path.join(out_dir, f"{name}_depth.png"))
    save_image(colour, paths[0])
    save_image(depth, paths[1])
    return paths


def write_batch_tree(out_dir, seed: int, width: int, height: int,
                     name: str = "scene"):
    """Write the batch CLI's input: ``<name>.png`` and
    ``depth_maps/<variant>/<name>.png`` for each of :data:`VARIANTS`.
    Returns ``(colour_path, depth_maps_dir)``."""
    colour, depth = make_scene(seed, width, height)
    os.makedirs(out_dir, exist_ok=True)
    colour_path = os.path.join(out_dir, f"{name}.png")
    save_image(colour, colour_path)
    maps = os.path.join(out_dir, "depth_maps")
    for variant, d in depth_variants(depth, seed).items():
        os.makedirs(os.path.join(maps, variant), exist_ok=True)
        save_image(d, os.path.join(maps, variant, f"{name}.png"))
    return colour_path, maps


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m depthrenderer_tpu.scenes",
                                 description="Write a seeded colour/depth "
                                 "scene (or a batch depth-map tree) as PNGs.")
    ap.add_argument("out_dir")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--batch", action="store_true",
                    help="Write the batch CLI's depth_maps/<variant>/ tree.")
    args = ap.parse_args(argv)
    if args.batch:
        paths = write_batch_tree(args.out_dir, args.seed, args.width,
                                 args.height)
    else:
        paths = write_pair(args.out_dir, args.seed, args.width, args.height)
    for p in paths:
        print(p)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
