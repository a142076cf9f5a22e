"""The seeded scene source: deterministic, loader-shaped, with real depth edges."""

import numpy as np
import pytest

from depthrenderer_tpu import io as dio
from depthrenderer_tpu import scenes


@pytest.mark.parametrize("size", [(64, 48), (640, 480), (333, 97)])
def test_scene_is_loader_shaped(size):
    w, h = size
    colour, depth = scenes.make_scene(0, w, h)
    assert colour.shape == (h, w, 4) and colour.dtype == np.uint8
    assert depth.shape == (h, w) and depth.dtype == np.uint8
    assert (colour[..., 3] == 255).all()


def test_scene_is_deterministic_per_seed():
    a = scenes.make_scene(3, 160, 120)
    b = scenes.make_scene(3, 160, 120)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_seeds_differ():
    a_col, a_dep = scenes.make_scene(0, 160, 120)
    b_col, b_dep = scenes.make_scene(1, 160, 120)
    assert (a_dep != b_dep).mean() > 0.2
    assert (a_col != b_col).any(axis=-1).mean() > 0.2


def test_scene_has_discontinuities_and_smooth_regions():
    _, depth = scenes.make_scene(0, 640, 480)
    d = depth.astype(int)
    jumps = np.maximum(np.abs(np.diff(d, axis=0))[:, :-1],
                       np.abs(np.diff(d, axis=1))[:-1, :])
    assert (jumps >= 20).mean() > 0.002   # slab and dome borders
    assert (jumps <= 1).mean() > 0.8      # smooth relief and planes
    assert d.max() - d.min() > 100


def test_scene_texture_has_detail():
    colour, _ = scenes.make_scene(0, 320, 240)
    c = colour[..., :3].astype(int)
    assert (np.abs(np.diff(c, axis=1)).max(-1) > 32).mean() > 0.02


def test_write_pair_round_trips(tmp_path):
    colour_path, depth_path = scenes.write_pair(tmp_path, 5, 96, 64)
    colour, depth = scenes.make_scene(5, 96, 64)
    np.testing.assert_array_equal(dio.load_image(colour_path), colour)
    np.testing.assert_array_equal(dio.load_image(depth_path), depth)


def test_batch_tree_layout(tmp_path):
    colour_path, maps = scenes.write_batch_tree(tmp_path, 2, 96, 64)
    assert dio.load_colour(colour_path).shape == (64, 96, 4)
    variants = {v: dio.load_image(f"{maps}/{v}/scene.png")
                for v in scenes.VARIANTS}
    assert sorted(variants) == sorted(["smooth", "edges", "noisy"])
    d = {k: v.astype(int) for k, v in variants.items()}
    # Noise makes steps everywhere; quantising leaves the fewest levels.
    steps = {k: (np.abs(np.diff(v, axis=1)) > 10).mean() for k, v in d.items()}
    assert steps["smooth"] < steps["noisy"]
    assert len(np.unique(d["edges"])) < len(np.unique(d["smooth"]))


def test_scenes_cli(tmp_path, capsys):
    assert scenes.main([str(tmp_path), "--width", "40", "--height", "30",
                        "--batch"]) == 0
    assert (tmp_path / "depth_maps" / "noisy" / "scene.png").exists()
