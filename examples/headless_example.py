"""Minimal standalone headless rendering example.

The analogue of the reference's ``headless_render_example.py`` (which had to spawn
an Xvfb virtual display and a moderngl FBO to render without a screen): here the
whole framework is headless by construction, so the example is simply the smallest
end-to-end render — synthetic colour + depth, one frontal frame, PNG out.

Run:  python examples/headless_example.py  (works on CPU or GPU)
"""

import os
import sys

import numpy as np

# Allow running straight from a source checkout.
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import depthrenderer_tpu as dr
from depthrenderer_tpu import transforms
from depthrenderer_tpu.ops.common import suggest_config
from depthrenderer_tpu.ops.raster_grid import render_frame_grid

# Synthetic scene: colour gradient + a depth "bump" in the middle.
H, W = 240, 320
yy, xx = np.mgrid[0:H, 0:W]
colour = np.stack(
    [
        (xx * 255 // (W - 1)).astype(np.uint8),
        (yy * 255 // (H - 1)).astype(np.uint8),
        np.full((H, W), 96, np.uint8),
        np.full((H, W), 255, np.uint8),
    ],
    axis=-1,
)
r2 = ((xx - W / 2) / (W / 4)) ** 2 + ((yy - H / 2) / (H / 4)) ** 2
depth = (255 * np.clip(1.0 - r2, 0, 1)).astype(np.uint8)

mesh = dr.Mesh.from_texture(dr.Texture(colour), depth, density=6)
mesh.vertices[:, 2] *= 4.0

camera = dr.Camera(window_size=(W, H), fov_y=18)
view = np.asarray(transforms.translation(dz=-10.0))
spin = np.asarray(transforms.rotation(np.deg2rad(8.0), axis=dr.Axis.Y))
mvp = camera.projection @ view @ spin

n = 2**6 + 1
frame = render_frame_grid(
    mvp,
    mesh.vertices.reshape(n, n, 3),
    mesh.texture_coordinates.reshape(n, n, 2),
    colour.astype(np.float32),
    W, H,
    suggest_config(n, W, H),
)

dr.io.save_image(np.asarray(frame), "headless_output.png")
print("Saved render to 'headless_output.png'.")
