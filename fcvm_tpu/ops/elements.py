"""Tet10 / tri6 / line3 element kernels, batched for the accelerator.

The reference implements these as scalar numba loops with hand-unrolled 3x3
inverses (``source code/fcVM.py:351-613``).  Here every function is a pure
JAX op over one element (or one Gauss point) designed to be ``vmap``-ed over
the whole mesh, so XLA sees a single large batched einsum instead of a Python
loop.  Voigt ordering follows the reference throughout:
``[xx, yy, zz, xy, zx, yz]`` (see ``fcVM.py:464-478`` for the B-matrix and
``fcVM.py:2385-2390`` for the stress component order).
"""

from __future__ import annotations

import jax
import numpy as np
import jax.numpy as jnp

from fcvm_tpu.ops.quadrature import GP10, GP6, GP2
from fcvm_tpu.utils.linalg3 import inv3


def tet10_shape_np(xi: float, et: float, ze: float) -> np.ndarray:
    """Shape functions of the 10-node tet (reference ``fcVM.py:364-380``)."""
    a = 1.0 - xi - et - ze
    return np.array(
        [
            (2.0 * a - 1.0) * a,
            xi * (2.0 * xi - 1.0),
            et * (2.0 * et - 1.0),
            ze * (2.0 * ze - 1.0),
            4.0 * xi * a,
            4.0 * xi * et,
            4.0 * et * a,
            4.0 * ze * a,
            4.0 * xi * ze,
            4.0 * et * ze,
        ]
    )


def tet10_dshape_local_np(xi: float, et: float, ze: float) -> np.ndarray:
    """Local derivatives (3, 10) of the tet10 shape functions.

    Matches the hand-written tables in the reference
    (``fcVM.py:390-424``; source: CalculiX, G. Dhondt).
    """
    d = np.zeros((3, 10))
    a = 1.0 - 4.0 * (1.0 - xi - et - ze)
    d[0, 0] = a
    d[0, 1] = 4.0 * xi - 1.0
    d[0, 4] = 4.0 * (1.0 - 2.0 * xi - et - ze)
    d[0, 5] = 4.0 * et
    d[0, 6] = -4.0 * et
    d[0, 7] = -4.0 * ze
    d[0, 8] = 4.0 * ze

    d[1, 0] = a
    d[1, 2] = 4.0 * et - 1.0
    d[1, 4] = -4.0 * xi
    d[1, 5] = 4.0 * xi
    d[1, 6] = 4.0 * (1.0 - xi - 2.0 * et - ze)
    d[1, 7] = -4.0 * ze
    d[1, 9] = 4.0 * ze

    d[2, 0] = a
    d[2, 3] = 4.0 * ze - 1.0
    d[2, 4] = -4.0 * xi
    d[2, 6] = -4.0 * et
    d[2, 7] = 4.0 * (1.0 - xi - et - 2.0 * ze)
    d[2, 8] = 4.0 * xi
    d[2, 9] = 4.0 * et
    return d


# Compile-time constant tables at the 4 tet10 Gauss points.
SHP10_AT_GP = np.stack([tet10_shape_np(*gp[:3]) for gp in GP10])  # (4, 10)
DSHP10_AT_GP = np.stack([tet10_dshape_local_np(*gp[:3]) for gp in GP10])  # (4, 3, 10)
W10 = GP10[:, 3].copy()  # (4,)


def tet10_geometry(coords_el: jnp.ndarray, dshp_local: jnp.ndarray):
    """Jacobian determinant and global shape derivatives at one Gauss point.

    Args:
      coords_el: (10, 3) nodal coordinates of one element.
      dshp_local: (3, 10) local shape-function derivatives at the point.

    Returns:
      (detJ, dshpg) with ``dshpg`` of shape (3, 10):
      ``dshpg[i, j] = dN_j/dx_i`` (reference ``fcVM.py:426-460``).
    """
    # xs[i, j] = sum_k coords_el[k, i] * dshp_local[j, k]  (dx_i/dxi_j)
    # HIGHEST precision (see tet10_element_geometry): geometry must be
    # bit-consistent across the assembly and stress/residual paths
    from fcvm_tpu.ops.assembly import formation_precision

    hp = formation_precision()
    xs = jnp.einsum("ki,jk->ij", coords_el, dshp_local, precision=hp)
    xsi, det = inv3(xs)
    # dshpg[i, j] = sum_k xsi[k, i] * dshp_local[k, j]
    dshpg = jnp.einsum("ki,kj->ij", xsi, dshp_local, precision=hp)
    return det, dshpg


def bmat_from_dshpg(dshpg: jnp.ndarray) -> jnp.ndarray:
    """Strain-displacement matrix B (6, 30) from global derivatives (3, 10).

    Row order [xx, yy, zz, xy, zx, yz] with engineering shear strains,
    matching the reference layout (``fcVM.py:464-478``).
    """
    d0, d1, d2 = dshpg[0], dshpg[1], dshpg[2]
    z = jnp.zeros_like(d0)
    rows = jnp.stack(
        [
            jnp.stack([d0, z, z], axis=-1),  # eps_xx
            jnp.stack([z, d1, z], axis=-1),  # eps_yy
            jnp.stack([z, z, d2], axis=-1),  # eps_zz
            jnp.stack([d1, d0, z], axis=-1),  # gam_xy
            jnp.stack([d2, z, d0], axis=-1),  # gam_zx
            jnp.stack([z, d2, d1], axis=-1),  # gam_yz
        ]
    )  # (6, 10, 3)
    return rows.reshape(6, 30)


def tet10_element_geometry(coords_el: jnp.ndarray):
    """detJ, dshpg and B at all 4 Gauss points of one element.

    Returns:
      det: (4,), dshpg: (4, 3, 10), bmat: (4, 6, 30).
    """
    dshp = jnp.asarray(DSHP10_AT_GP, dtype=coords_el.dtype)
    # HIGHEST precision: the stress/residual path computes this geometry
    # under a default_matmul_precision("highest") context while the
    # assembly path (vmapped/chunked differently) would run it at the
    # device's reduced-precision f32 default — giving TWO different B matrices
    # for the same element and an operator-vs-internal-force inconsistency that
    # floors (and on the Embankment soil replay, diverges) the f32 Newton loop
    # at ~1e-2. Pinning HIGHEST here keeps every caller bit-consistent; the
    # cost is per-assembly/per-residual, not per-CG-iteration.
    from fcvm_tpu.ops.assembly import formation_precision

    hp = formation_precision()
    xs = jnp.einsum("ki,gjk->gij", coords_el, dshp, precision=hp)
    xsi, det = inv3(xs)
    dshpg = jnp.einsum("gki,gkj->gij", xsi, dshp, precision=hp)

    d0, d1, d2 = dshpg[:, 0], dshpg[:, 1], dshpg[:, 2]  # each (4, 10)
    z = jnp.zeros_like(d0)
    rows = jnp.stack(
        [
            jnp.stack([d0, z, z], axis=-1),
            jnp.stack([z, d1, z], axis=-1),
            jnp.stack([z, z, d2], axis=-1),
            jnp.stack([d1, d0, z], axis=-1),
            jnp.stack([d2, z, d0], axis=-1),
            jnp.stack([z, d2, d1], axis=-1),
        ],
        axis=1,
    )  # (4, 6, 10, 3)
    bmat = rows.reshape(4, 6, 30)
    return det, dshpg, bmat


def tri6_shape_np(xi: float, et: float) -> np.ndarray:
    """6-node triangle shape functions (reference ``fcVM.py:491-496``)."""
    return np.array(
        [
            (1.0 - xi - et) * (1.0 - 2.0 * xi - 2.0 * et),
            xi * (2.0 * xi - 1.0),
            et * (2.0 * et - 1.0),
            4.0 * xi * (1.0 - xi - et),
            4.0 * xi * et,
            4.0 * et * (1.0 - xi - et),
        ]
    )


def tri6_dshape_np(xi: float, et: float) -> np.ndarray:
    """(2, 6) local derivatives of the tri6 shape functions
    (reference ``fcVM.py:498-512``)."""
    return np.array(
        [
            [
                -3.0 + 4.0 * et + 4.0 * xi,
                -1.0 + 4.0 * xi,
                0.0,
                -4.0 * (-1.0 + et + 2.0 * xi),
                4.0 * et,
                -4.0 * et,
            ],
            [
                -3.0 + 4.0 * et + 4.0 * xi,
                0.0,
                -1.0 + 4.0 * et,
                -4.0 * xi,
                4.0 * xi,
                -4.0 * (-1.0 + 2.0 * et + xi),
            ],
        ]
    )


SHP6_AT_GP = np.stack([tri6_shape_np(*gp[:2]) for gp in GP6])  # (6, 6)
DSHP6_AT_GP = np.stack([tri6_dshape_np(*gp[:2]) for gp in GP6])  # (6, 2, 6)
W6 = GP6[:, 2].copy()


def tri6_surface_frame(coords_face: jnp.ndarray):
    """Area Jacobians and unit normals of a tri6 face at all 6 Gauss points.

    Args:
      coords_face: (6, 3) face node coordinates.

    Returns:
      xsj: (6,) area Jacobian magnitude; normal: (6, 3) unit normals
      (the reference's ``xp``, ``fcVM.py:514-527``).
    """
    dshp = jnp.asarray(DSHP6_AT_GP, dtype=coords_face.dtype)  # (6, 2, 6)
    # xs[g, a, :] = d(x, y, z)/d(xi_a) = dshp[g, a, :] @ coords_face
    xs = jnp.einsum("gak,ki->gai", dshp, coords_face,
                    precision=jax.lax.Precision.HIGHEST)  # (6, 2, 3)
    xp = jnp.cross(xs[:, 0], xs[:, 1])  # (6, 3) normal * |J|
    xsj = jnp.linalg.norm(xp, axis=-1)
    normal = xp / xsj[:, None]
    return xsj, normal


def line3_shape_np(xi: float) -> np.ndarray:
    """3-node line shape functions (reference ``fcVM.py:544-552``)."""
    return np.array(
        [-0.5 * (1.0 - xi) * xi, 0.5 * (1.0 + xi) * xi, (1.0 + xi) * (1.0 - xi)]
    )


def line3_dshape_np(xi: float) -> np.ndarray:
    return np.array([xi - 0.5, xi + 0.5, -2.0 * xi])


SHP2_AT_GP = np.stack([line3_shape_np(gp[0]) for gp in GP2])  # (2, 3)
DSHP2_AT_GP = np.stack([line3_dshape_np(gp[0]) for gp in GP2])  # (2, 3)
W2 = GP2[:, 1].copy()


def line3_jacobian(coords_edge: jnp.ndarray):
    """Arc-length Jacobian of a 3-node edge at both Gauss points.

    Args:
      coords_edge: (3, 3) edge node coordinates (3 nodes x xyz).

    Returns:
      xsj: (2,) (reference ``fcVM.py:554-563``).
    """
    dshp = jnp.asarray(DSHP2_AT_GP, dtype=coords_edge.dtype)  # (2, 3)
    dx = jnp.einsum("gk,ki->gi", dshp, coords_edge,
                    precision=jax.lax.Precision.HIGHEST)  # (2, 3)
    return jnp.linalg.norm(dx, axis=-1)
