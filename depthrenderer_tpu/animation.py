"""Camera-path animation as pure functions of time, batchable with ``vmap``.

Capability parity with the reference's animation system
(``DepthRenderer/animation.py:1-119``), re-designed for batching: instead of stateful
per-frame ``update(delta)`` mutation, every animation is fundamentally a pure function
``transform_at(t) -> (4, 4)``. The whole camera path of a clip is produced in one shot
as a ``(T, 4, 4)`` batch via :meth:`Animation.batch` (``jax.vmap`` over frame times),
which is what the batched renderer consumes.

The reference's stateful API (``update``/``transform``/``reset`` —
``animation.py:6-27``) is kept as a thin wrapper over the pure function so existing
call patterns keep working.

Timing semantics: the reference calls ``anim.update(delta)`` *before* reading
``anim.transform`` each frame (``__main__.py:143-148``), so the k-th rendered frame
(k = 0, 1, ...) sees ``elapsed = (k+1)·delta``. :func:`frame_times` replicates that.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .transforms import Axis, identity, matmul, rotation, translation


def frame_times(num_frames: int, fps: float):
    """Elapsed times seen by each frame's animation update (see module docstring)."""
    return (jnp.arange(num_frames, dtype=jnp.float32) + 1.0) / jnp.float32(fps)


class Animation:
    """Base animation: identity transform at all times (reference: ``animation.py:6-27``)."""

    def __init__(self):
        self.elapsed = 0.0

    # -- pure interface -------------------------------------------------------------

    def transform_at(self, t):
        """The (4, 4) transform at elapsed time ``t`` (a traced or concrete scalar)."""
        del t
        return identity()

    def batch(self, times):
        """Vectorised transforms for a vector of frame times -> ``(T, 4, 4)``."""
        return jax.vmap(self.transform_at)(jnp.asarray(times, jnp.float32))

    # -- stateful parity API ----------------------------------------------------------

    def update(self, delta):
        self.elapsed += delta

    def reset(self):
        self.elapsed = 0.0

    @property
    def transform(self):
        return np.asarray(self.transform_at(jnp.float32(self.elapsed)))

    def apply(self, other):
        """Right-multiply ``other`` by this animation's transform (``animation.py:18-19``)."""
        return other @ self.transform


class RotateAxisBounce(Animation):
    """Sinusoidal rotation bounce about one axis (reference: ``animation.py:30-43``).

    ``angle(t) = sin(2π·(speed·t + offset)) · angle``.
    """

    def __init__(self, angle=np.pi / 2, axis=Axis.Y, speed=1.0, offset=0.0):
        super().__init__()
        self.angle = float(angle)
        self.axis = axis
        self.speed = float(speed)
        self.offset = float(offset)

    def transform_at(self, t):
        a = jnp.sin(2.0 * jnp.pi * (self.speed * t + self.offset)) * self.angle
        return rotation(a, axis=self.axis)


class RotateXYBounce(Animation):
    """Coupled two-axis rotation bounce (reference: ``animation.py:46-61``).

    ``R_y(sin(φ(t))·angle) @ R_x(cos(φ(t))·angle)`` with ``φ(t) = 2π(speed·t + offset)``.
    """

    def __init__(self, angle=np.pi / 2, speed=1.0, offset=0.0):
        super().__init__()
        self.angle = float(angle)
        self.speed = float(speed)
        self.offset = float(offset)

    def transform_at(self, t):
        phase = 2.0 * jnp.pi * (self.speed * t + self.offset)
        y_angle = jnp.sin(phase) * self.angle
        x_angle = jnp.cos(phase) * self.angle
        return matmul(rotation(y_angle, axis=Axis.Y), rotation(x_angle, axis=Axis.X))


class Translate(Animation):
    """Sinusoidal translation along one axis (reference: ``animation.py:64-89``).

    ``d(t) = sin(2π·speed·t + 2π·offset) · distance``.
    """

    def __init__(self, distance=1.0, axis=Axis.X, speed=1.0, offset=0.0):
        super().__init__()
        self.distance = float(distance)
        self.axis = axis
        self.speed = float(speed)
        self.offset = float(offset)

    def transform_at(self, t):
        d = jnp.sin(self.speed * t * 2.0 * jnp.pi + self.offset * 2.0 * jnp.pi) * self.distance
        zero = jnp.zeros((), jnp.float32)
        dx = d if self.axis == Axis.X else zero
        dy = d if self.axis == Axis.Y else zero
        dz = d if self.axis == Axis.Z else zero
        return translation(dx, dy, dz)


class Compose(Animation):
    """Matrix product of child animations, in list order (reference: ``animation.py:92-119``)."""

    def __init__(self, animations):
        super().__init__()
        self.animations = list(animations)

    def transform_at(self, t):
        out = identity()
        for animation in self.animations:
            out = matmul(out, animation.transform_at(t))
        return out

    # Stateful parity: Compose forwards update/reset to children (animation.py:98-106).
    def update(self, delta):
        super().update(delta)
        for animation in self.animations:
            animation.update(delta)

    def reset(self):
        super().reset()
        for animation in self.animations:
            animation.reset()


def default_sway(animation_length_secs: float = 5.0):
    """The reference CLI's composed sway animation (``__main__.py:119-127``)."""
    speed = 1.0 / animation_length_secs
    return Compose(
        [
            RotateAxisBounce(np.deg2rad(2.5), axis=Axis.Y, offset=0.5, speed=-speed),
            RotateAxisBounce(np.deg2rad(0.5), axis=Axis.X, offset=0.5, speed=-speed),
            Translate(distance=0.30, speed=speed),
            Translate(distance=0.15, axis=Axis.Y, offset=0.25, speed=speed),
        ]
    )
