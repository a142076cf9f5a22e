"""4x4 homogeneous transform builders as pure, vmappable JAX functions.

Capability parity with the reference's transform math
(``DepthRenderer/utils.py:20-123``), re-designed as pure ``jnp`` functions so they can
be traced under ``jit``/``vmap`` and batched over animation frame times.

Two semantics notes carried over from the reference (required for pixel parity):

* :func:`perspective` replicates the reference's *nonstandard* projection
  (``utils.py:30-36`` and ``render.py:85-92``): the vertical field of view in
  **degrees** is used directly as the focal scale — it is *not* ``cot(fov/2)``.
* Matrices act on column vectors (``M @ [x, y, z, 1]^T``), matching the reference's
  row-major numpy matrices uploaded to GL with ``transpose=GL_TRUE``
  (``render.py:812``).
"""

from __future__ import annotations

import enum
from functools import partial

import jax
import jax.numpy as jnp


def matmul(a, b):
    """Matrix multiply at full float32 precision.

    JAX's default matmul precision may run float32 products in bfloat16 or TF32
    (on GPUs, in the tensor cores), which is far too coarse for
    transform composition and vertex projection (sub-pixel accuracy is a correctness
    requirement here). Every matmul inside this library goes through this helper (or
    passes ``precision`` explicitly) rather than mutating the user's global config.
    """
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


class Axis(enum.Enum):
    """The axes of a 3-D coordinate system (reference: ``utils.py:39-45``)."""

    X = 0
    Y = 1
    Z = 2


def perspective(fov_y, aspect_ratio, near=0.01, far=1000.0, dtype=jnp.float32):
    """Perspective projection matrix, reference semantics (``utils.py:20-36``).

    ``fov_y`` (degrees) is used directly as the focal scale. All arguments may be
    traced scalars, so this is jit/vmap friendly.
    """
    fov_y = jnp.asarray(fov_y, dtype)
    aspect_ratio = jnp.asarray(aspect_ratio, dtype)
    near = jnp.asarray(near, dtype)
    far = jnp.asarray(far, dtype)
    z = jnp.zeros((), dtype)
    one = jnp.ones((), dtype)

    return jnp.stack(
        [
            jnp.stack([fov_y / aspect_ratio, z, z, z]),
            jnp.stack([z, fov_y, z, z]),
            jnp.stack([z, z, (far + near) / (near - far), (2.0 * near * far) / (near - far)]),
            jnp.stack([z, z, -one, z]),
        ]
    )


@partial(jax.jit, static_argnames=("axis", "degrees"))
def rotation(angle, axis: Axis = Axis.X, degrees: bool = False):
    """Rotation about a coordinate axis (reference: ``utils.py:48-81``).

    ``angle`` may be a traced scalar; ``axis``/``degrees`` are static.
    """
    angle = jnp.asarray(angle, jnp.float32)
    if degrees:
        angle = jnp.deg2rad(angle)

    c = jnp.cos(angle)
    s = jnp.sin(angle)
    z = jnp.zeros((), jnp.float32)
    one = jnp.ones((), jnp.float32)

    if axis == Axis.X:
        rows = [
            [one, z, z, z],
            [z, c, -s, z],
            [z, s, c, z],
            [z, z, z, one],
        ]
    elif axis == Axis.Y:
        rows = [
            [c, z, s, z],
            [z, one, z, z],
            [-s, z, c, z],
            [z, z, z, one],
        ]
    elif axis == Axis.Z:
        rows = [
            [c, -s, z, z],
            [s, c, z, z],
            [z, z, one, z],
            [z, z, z, one],
        ]
    else:
        raise ValueError(f"Invalid axis {axis!r}; expected an {Axis}.")

    return jnp.stack([jnp.stack(r) for r in rows])


def translation(dx=0.0, dy=0.0, dz=0.0, dtype=jnp.float32):
    """Translation matrix (reference: ``utils.py:84-100``)."""
    dx = jnp.asarray(dx, dtype)
    dy = jnp.asarray(dy, dtype)
    dz = jnp.asarray(dz, dtype)
    z = jnp.zeros((), dtype)
    one = jnp.ones((), dtype)

    return jnp.stack(
        [
            jnp.stack([one, z, z, dx]),
            jnp.stack([z, one, z, dy]),
            jnp.stack([z, z, one, dz]),
            jnp.stack([z, z, z, one]),
        ]
    )


def scale(sx=1.0, sy=None, sz=None, dtype=jnp.float32):
    """Scale matrix (reference: ``utils.py:103-123``).

    If either ``sy`` or ``sz`` is ``None``, ``sx`` is used for all three axes.
    """
    if sy is None or sz is None:
        sy = sx
        sz = sx

    sx = jnp.asarray(sx, dtype)
    sy = jnp.asarray(sy, dtype)
    sz = jnp.asarray(sz, dtype)
    z = jnp.zeros((), dtype)
    one = jnp.ones((), dtype)

    return jnp.stack(
        [
            jnp.stack([sx, z, z, z]),
            jnp.stack([z, sy, z, z]),
            jnp.stack([z, z, sz, z]),
            jnp.stack([z, z, z, one]),
        ]
    )


def identity(dtype=jnp.float32):
    """4x4 identity."""
    return jnp.eye(4, dtype=dtype)
