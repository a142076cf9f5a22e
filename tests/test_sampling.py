"""The quad-packed bilinear sampler vs the numpy f64 oracle.

`common.sample_texture_bilinear` packs all four filter taps into one (N, 4) u32
table row (one gather per pixel instead of four) and quantises texels to
8 bits before filtering, matching the reference's GL_RGBA8 uploads
(DepthRenderer/render.py:359-361). These tests pin:
  * exact agreement with the oracle for uint8-derived textures (the only kind
    the reference pipeline produces),
  * the <= 0.5/255-per-tap quantisation bound for arbitrary float textures,
  * clamp-to-edge semantics at and beyond every border.
"""

import numpy as np

from depthrenderer_tpu.ops import common
from depthrenderer_tpu.ops.raster_reference import _bilinear


def _uv_grid(n, lo=-0.3, hi=1.3, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.uniform(lo, hi, size=(n, n)).astype(np.float32)
    v = rng.uniform(lo, hi, size=(n, n)).astype(np.float32)
    return u, v


def test_matches_oracle_on_u8_texture():
    rng = np.random.default_rng(1)
    tex = rng.integers(0, 256, size=(19, 31, 4)).astype(np.float32)
    u, v = _uv_grid(64)
    got = np.asarray(common.sample_texture_bilinear(tex, u, v))
    want = _bilinear(tex, u, v)
    np.testing.assert_allclose(got, want, atol=2e-3)


def test_float_texture_quantisation_bound():
    rng = np.random.default_rng(2)
    tex = rng.uniform(0.0, 255.0, size=(13, 17, 4)).astype(np.float32)
    u, v = _uv_grid(64, seed=3)
    got = np.asarray(common.sample_texture_bilinear(tex, u, v))
    want = _bilinear(tex, u, v)
    # Each of the 4 taps is quantised to 8 bits before blending: |err| <= 0.5
    # per tap, and convex blending cannot exceed the worst tap error.
    assert np.abs(got - want).max() <= 0.5 + 1e-3


def test_clamp_to_edge():
    # A texture whose border texels differ strongly from the interior, sampled
    # far outside [0, 1]: the result must equal the border texel exactly.
    tex = np.full((8, 8, 4), 100.0, np.float32)
    tex[0, :] = 200.0   # v=1 samples row 0 (top-down convention)
    tex[-1, :] = 10.0
    tex[:, 0, :] = 30.0
    tex[:, -1, :] = 250.0
    tex[0, 0] = 77.0

    def sample(u, v):
        out = np.asarray(common.sample_texture_bilinear(
            tex, np.float32(u), np.float32(v)))
        return out

    np.testing.assert_allclose(sample(-2.0, 0.5), tex[4, 0], atol=1e-4)
    np.testing.assert_allclose(sample(3.0, 0.5), tex[4, -1], atol=1e-4)
    np.testing.assert_allclose(sample(0.5, 3.0), tex[0, 4], atol=1e-4)
    np.testing.assert_allclose(sample(0.5, -2.0), tex[-1, 4], atol=1e-4)
    np.testing.assert_allclose(sample(-1.0, 5.0), tex[0, 0], atol=1e-4)


def test_matches_oracle_at_texel_centres():
    rng = np.random.default_rng(4)
    tex = rng.integers(0, 256, size=(6, 9, 4)).astype(np.float32)
    ht, wt = tex.shape[:2]
    ys, xs = np.mgrid[0:ht, 0:wt]
    u = ((xs + 0.5) / wt).astype(np.float32)
    v = (1.0 - (ys + 0.5) / ht).astype(np.float32)
    got = np.asarray(common.sample_texture_bilinear(tex, u, v))
    np.testing.assert_allclose(got, tex, atol=1e-4)


def test_non_rgba_fallback_matches_oracle():
    rng = np.random.default_rng(5)
    tex = rng.integers(0, 256, size=(11, 7, 3)).astype(np.float32)
    u, v = _uv_grid(32, seed=6)
    got = np.asarray(common.sample_texture_bilinear(tex, u, v))
    want = _bilinear(tex, u, v)
    np.testing.assert_allclose(got, want, atol=2e-3)
