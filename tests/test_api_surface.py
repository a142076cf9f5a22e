"""API-surface parity checks: package exports, CLI argument surfaces, edge cases."""

import numpy as np

import depthrenderer_tpu as dr


def test_package_exports():
    assert dr.Camera and dr.Mesh and dr.Texture and dr.Axis
    assert dr.MeshRenderer and dr.render_clip
    assert dr.writers.AsyncImageWriter and dr.video.AviFile
    assert dr.postprocess.create_mosaic_video and dr.evaluate.masked_psnr
    assert dr.profiling.StageTimer


def test_cli_parser_reference_surface():
    # The reference's plac-style single-dash options must parse
    # (python -m DepthRenderer <colour> <depth> -fps 60 -mesh-density 8
    #  -displacement-factor 4.0 -output-path frames).
    from depthrenderer_tpu.cli import build_parser

    args = build_parser().parse_args(
        ["c.png", "d.png", "-fps", "30", "-mesh-density", "7",
         "-displacement-factor", "2.5", "-output-path", "out"]
    )
    assert args.fps == 30 and args.mesh_density == 7
    assert args.displacement_factor == 2.5 and str(args.output_path) == "out"
    # Defaults match the reference (__main__.py:70).
    d = build_parser().parse_args(["c.png", "d.png"])
    assert d.fps == 60 and d.mesh_density == 8
    assert d.displacement_factor == 4.0 and str(d.output_path) == "frames"


def test_batch_parser_reference_surface():
    from depthrenderer_tpu.batch import build_parser

    args = build_parser().parse_args(
        ["c.png", "depths", "-fps", "24", "-mesh-density", "6",
         "-output-path", "o"]
    )
    assert args.fps == 24 and args.mesh_density == 6
    d = build_parser().parse_args(["c.png", "depths"])
    assert str(d.output_path) == "output"  # reference render_many default


def test_quality_flag_surface():
    # The CLI and batch parsers keep the reference surface and carry no
    # rasteriser-tier flags: the rasteriser is runtime.raster_impl()'s choice.
    import pytest

    from depthrenderer_tpu.batch import build_parser as batch_parser
    from depthrenderer_tpu.cli import build_parser as cli_parser

    for parser, pos in ((cli_parser(), ["c.png", "d.png"]),
                        (batch_parser(), ["c.png", "depths"])):
        args = parser.parse_args(pos + ["-fps", "30", "-mesh-density", "9",
                                        "-displacement-factor", "2.0"])
        assert (args.fps, args.mesh_density, args.displacement_factor) == \
            (30, 9, 2.0)
        for flag in ("--impl", "--quality", "--patch", "--colfix"):
            assert not any(flag in a.option_strings for a in parser._actions)
            with pytest.raises(SystemExit):
                parser.parse_args(pos + [flag])


def test_mesh_from_texture_without_depth(checker_texture):
    # No depth map -> flat quad grid at z = 1 (reference render.py:513-514).
    mesh = dr.Mesh.from_texture(dr.Texture(checker_texture), density=2)
    np.testing.assert_allclose(mesh.vertices[:, 2], 1.0)


def test_texture_rgb_gains_alpha(checker_texture):
    tex = dr.Texture(checker_texture[..., :3])
    assert tex.image.shape[2] == 4
    assert (tex.image[..., 3] == 255).all()
    copy = tex.copy()
    copy.image[0, 0, 0] = 7
    assert tex.image[0, 0, 0] != 7 or checker_texture[0, 0, 0] == 7
