"""Closed-form batched 3x3 linear algebra.

XLA's generic ``linalg.inv``/``det`` lower to a batched LU decomposition,
which would be wasteful at 3x3.
The reference hand-unrolls the same formulas in numba
(``source code/fcVM.py:436-453``); here they are written once, batched over
arbitrary leading dimensions, and fused by XLA into the surrounding element
math.
"""

from __future__ import annotations

import jax.numpy as jnp


def det3(a: jnp.ndarray) -> jnp.ndarray:
    """Determinant of (..., 3, 3), cofactor expansion (``fcVM.py:436-441``)."""
    return (
        a[..., 0, 0] * a[..., 1, 1] * a[..., 2, 2]
        - a[..., 0, 0] * a[..., 1, 2] * a[..., 2, 1]
        + a[..., 0, 2] * a[..., 1, 0] * a[..., 2, 1]
        - a[..., 0, 2] * a[..., 1, 1] * a[..., 2, 0]
        + a[..., 0, 1] * a[..., 1, 2] * a[..., 2, 0]
        - a[..., 0, 1] * a[..., 1, 0] * a[..., 2, 2]
    )


def inv3(a: jnp.ndarray, det=None):
    """Inverse of (..., 3, 3) via the adjugate (``fcVM.py:445-453``).

    Returns (inverse, determinant).
    """
    if det is None:
        det = det3(a)
    c00 = a[..., 1, 1] * a[..., 2, 2] - a[..., 2, 1] * a[..., 1, 2]
    c01 = a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2]
    c02 = a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1]
    c10 = a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2]
    c11 = a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0]
    c12 = a[..., 1, 0] * a[..., 0, 2] - a[..., 0, 0] * a[..., 1, 2]
    c20 = a[..., 1, 0] * a[..., 2, 1] - a[..., 2, 0] * a[..., 1, 1]
    c21 = a[..., 2, 0] * a[..., 0, 1] - a[..., 0, 0] * a[..., 2, 1]
    c22 = a[..., 0, 0] * a[..., 1, 1] - a[..., 1, 0] * a[..., 0, 1]
    row0 = jnp.stack([c00, c01, c02], axis=-1)
    row1 = jnp.stack([c10, c11, c12], axis=-1)
    row2 = jnp.stack([c20, c21, c22], axis=-1)
    inv = jnp.stack([row0, row1, row2], axis=-2) / det[..., None, None]
    return inv, det


def inv3_spd(a: jnp.ndarray) -> jnp.ndarray:
    """Inverse of symmetric (..., 3, 3) blocks (preconditioner path)."""
    inv, _ = inv3(a)
    return inv
