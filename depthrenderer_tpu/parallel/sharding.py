"""Device-mesh sharding for the render farm.

Rendering novel views is embarrassingly parallel over frames and scenes, so the
design is pure data parallelism over a 1-D device mesh: scene data is replicated (or
sharded, for the many-scene farm), the frame/scene axis is sharded, and XLA moves
nothing between devices except the optional reduction for batch statistics. The
cards of one host are joined all to all, so the mesh follows the algorithm alone.
This replaces
the reference's sequential ``ContextSwitcher`` loop (``render_many.py:270-292``) and
its thread-pool writers with: device-parallel rendering + host-side writer farm.

Everything here works identically on several GPUs and on the fake
``--xla_force_host_platform_device_count`` CPU mesh used in tests (SURVEY.md §4).
Each shard renders with the rasteriser :func:`runtime.raster_impl` picks, unless
the caller names one.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..ops.common import RasterConfig
from ..render import frames_renderer
from ..runtime import raster_impl


def make_render_mesh(devices=None, axis_name: str = "batch") -> Mesh:
    """A 1-D device mesh over all (or the given) devices."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devices, axis_names=(axis_name,))


def _pad_to_multiple(x, mult, axis=0):
    n = x.shape[axis]
    pad = (-n) % mult
    if pad == 0:
        return x, n
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return jnp.pad(x, widths, mode="edge"), n


def render_frames_sharded(mesh: Mesh, mvps, vertex_grid, uv_grid, texture_f32,
                          width: int, height: int,
                          config: RasterConfig = RasterConfig(),
                          mode: str = "texture", frame_batch: int = 4,
                          with_stats: bool = False, impl: str = "auto"):
    """Render a clip with its frame axis sharded over the device mesh.

    Scene data (vertex grid, UVs, texture) is replicated; each device renders its
    contiguous shard of frames. Optionally returns global batch statistics (mean
    luminance per device-shard reduced with ``pmean`` across devices) as a cheap
    batch-QA signal.

    :param mvps: (T, 4, 4) per-frame model-view-projection matrices.
    :return: (T, height, width, 4) uint8 frames (sharded over the mesh), and stats
        if requested.
    """
    (axis,) = mesh.axis_names
    num = mesh.devices.size
    mvps = jnp.asarray(mvps, jnp.float32)
    mvps_padded, true_t = _pad_to_multiple(mvps, num, axis=0)

    vertex_grid = jnp.asarray(vertex_grid, jnp.float32)
    uv_grid = jnp.asarray(uv_grid, jnp.float32)
    texture_f32 = jnp.asarray(texture_f32, jnp.float32)

    render_frames = frames_renderer(raster_impl() if impl == "auto" else impl)

    def shard_fn(mvps_local, vgrid, uvgrid, tex):
        frames = render_frames(
            mvps_local, vgrid, uvgrid, tex, width, height, config, mode,
            frame_batch=frame_batch,
        )
        if with_stats:
            luma = jnp.mean(
                frames[..., :3].astype(jnp.float32) @ jnp.array([0.299, 0.587, 0.114])
            )
            global_luma = jax.lax.pmean(luma, axis_name=axis)
            return frames, global_luma[None]
        return frames

    out_spec = (P(axis), P(axis)) if with_stats else P(axis)
    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(axis), P(), P(), P()),
        out_specs=out_spec,
        # pallas_call does not annotate varying-mesh-axes metadata on its
        # outputs; the per-shard computation is embarrassingly parallel.
        check_vma=False,
    )
    result = jax.jit(fn)(mvps_padded, vertex_grid, uv_grid, texture_f32)
    if with_stats:
        frames, luma = result
        return frames[:true_t], {"mean_luma": jnp.mean(luma)}
    return result[:true_t]


def shard_scenes(mesh: Mesh, arrays):
    """Pad scene-major arrays to a multiple of the mesh size and place them,
    each scene shard on its own device (``NamedSharding`` over the scene
    axis). Returns the placed arrays; :func:`render_scenes_sharded` takes them
    as they are, so scene data crosses to the devices once per farm."""
    (axis,) = mesh.axis_names
    num = mesh.devices.size
    sharding = NamedSharding(mesh, P(axis))
    return tuple(
        jax.device_put(_pad_to_multiple(jnp.asarray(a, jnp.float32), num)[0],
                       sharding)
        for a in arrays)


def render_scenes_sharded(mesh: Mesh, mvps, vertex_grids, uv_grids, textures_f32,
                          width: int, height: int,
                          config: RasterConfig = RasterConfig(),
                          mode: str = "texture", frame_batch: int = 4,
                          impl: str = "auto"):
    """Render many scenes, sharding the *scene* axis over the device mesh.

    Replaces ``render_many.py``'s sequential per-model loop: every device owns
    a contiguous shard of scenes and renders all views of each.

    :param mvps: (S, T, 4, 4) — per-scene, per-view MVPs.
    :param vertex_grids: (S, n, n, 3); :param uv_grids: (S, n, n, 2);
    :param textures_f32: (S, Ht, Wt, 4) — each may come from
        :func:`shard_scenes` (then already padded and placed).
    :return: (S, T, height, width, 4) uint8 frames, scene axis sharded.
    """
    (axis,) = mesh.axis_names
    num = mesh.devices.size
    true_s = mvps.shape[0]
    render_frames = frames_renderer(raster_impl() if impl == "auto" else impl)

    if num == 1:
        # Single-device mesh: shard_map partitions nothing, so compose each
        # scene's own jitted pipeline on the host (async dispatch pipelines
        # the scenes) instead of one lax.map over scenes inside a jit.
        mvps = jnp.asarray(mvps, jnp.float32)
        return jnp.stack([
            render_frames(mvps[s], vertex_grids[s], uv_grids[s],
                          textures_f32[s], width, height, config, mode,
                          frame_batch=max(frame_batch, 1))
            for s in range(true_s)])

    mvps, vertex_grids, uv_grids, textures_f32 = shard_scenes(
        mesh, (mvps, vertex_grids, uv_grids, textures_f32))

    def shard_fn(mvps_local, vgrids, uvgrids, texs):
        def one_scene(args):
            mvps_s, vg, uv, tex = args
            return render_frames(
                mvps_s, vg, uv, tex, width, height, config, mode,
                frame_batch=frame_batch,
            )

        return jax.lax.map(one_scene, (mvps_local, vgrids, uvgrids, texs))

    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis)),
        out_specs=P(axis),
        check_vma=False,  # see render_frames_sharded
    )
    frames = jax.jit(fn)(mvps, vertex_grids, uv_grids, textures_f32)
    # Slice only when scenes were padded: slicing re-lays the array out.
    return frames if frames.shape[0] == true_s else frames[:true_s]
