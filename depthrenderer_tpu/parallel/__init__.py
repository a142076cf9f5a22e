"""Multi-device batch rendering via ``jax.sharding`` + ``shard_map``.

The reference's batch mode iterates scenes sequentially in one process
(``render_many.py``'s ``ContextSwitcher``); here the scene × view farm shards over a
device mesh instead (SURVEY.md §2 "Parallelism & communication").
"""

from .sharding import (  # noqa: F401
    make_render_mesh,
    render_frames_sharded,
    render_scenes_sharded,
    shard_scenes,
)
