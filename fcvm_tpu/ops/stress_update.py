"""Stress update and internal force: the per-iteration hot kernel.

Batched device form of the reference's ``update_stress_load``
(``source code/fcVM.py:2196-2464``): per Gauss point, recompute the
B-matrix on (optionally deformed) coordinates, form the strain increment
``deps = B du``, convect the old stress through the incremental deformation
gradient (``sig_c = (1/det F) F sigma F^T``, ``fcVM.py:2383-2429``), take the
elastic trial stress, radially return it to the von Mises surface, and
accumulate the internal force ``qin += B^T sigma w |J|``.

The whole mesh is processed as one ``vmap`` over elements inside a single
``jit``; there is no Python loop and no host round trip.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from fcvm_tpu.ops import elements as el
from fcvm_tpu.ops import material as mat
from fcvm_tpu.ops.assembly import scatter_node_rows, voigt_to_tensor
from fcvm_tpu.utils.linalg3 import det3


def _tensor_to_voigt(s: jnp.ndarray) -> jnp.ndarray:
    """(..., 3, 3) symmetric tensor -> (..., 6) Voigt [xx,yy,zz,xy,zx,yz]."""
    return jnp.stack(
        [
            s[..., 0, 0],
            s[..., 1, 1],
            s[..., 2, 2],
            s[..., 0, 1],
            s[..., 0, 2],
            s[..., 1, 2],
        ],
        axis=-1,
    )


def _element_stress_update(
    coords_el, u_el, du_el, sig_old_el, sig_yield_el, dmat, h, g, large_disp
):
    """One element: returns (sig_new (4,6), sig_test (4,6), pgp (4,), elv (30,))."""
    # Full f32 matmul precision is REQUIRED here: at an accelerator's
    # reduced-precision default for f32 dots (bf16 passes, or TF32 on a
    # GPU) the internal force B^T sigma carries O(1e-3) relative error,
    # which is a floor on the Newton residual ||r||/||q|| — an error
    # plateau that restarts cannot break (CPU f32, whose f32 matmuls are
    # exact, converges the imperfect-column example to 1e-5 in <= 5
    # iterations).  Residual ACCURACY sets the achievable convergence; the
    # CG operator's precision only affects the rate, so assembly/matvec
    # keep their own setting (ops/assembly.resolve_matvec_precision).  The
    # context is trace-time and also covers the tet10_element_geometry
    # matmuls below.
    with jax.default_matmul_precision("highest"):
        return _element_stress_update_hp(
            coords_el, u_el, du_el, sig_old_el, sig_yield_el, dmat, h, g,
            large_disp,
        )


def _element_stress_update_hp(
    coords_el, u_el, du_el, sig_old_el, sig_yield_el, dmat, h, g, large_disp
):
    coords_eff = coords_el + u_el if large_disp else coords_el
    det, dshpg, bmat = el.tet10_element_geometry(coords_eff)  # (4,), (4,3,10), (4,6,30)
    w = jnp.asarray(el.W10, dtype=coords_el.dtype)
    scale = w * jnp.abs(det)  # (4,)

    du_flat = du_el.reshape(30)
    deps = jnp.einsum("gkn,n->gk", bmat, du_flat)  # (4, 6)

    if large_disp:
        # Incremental deformation gradient F = I + d(du)/dx on the
        # start-of-step deformed configuration (fcVM.py:2396-2414).
        grad_du = jnp.einsum("ia,gbi->gab", du_el, dshpg)  # (4, 3, 3)
        f = jnp.eye(3, dtype=coords_el.dtype)[None] + grad_du
        det_f = det3(f)
        s_old = voigt_to_tensor(sig_old_el)  # (4, 3, 3)
        s_conv = jnp.einsum("gij,gjl,gkl->gik", f, s_old, f) / det_f[:, None, None]
        sig_c = _tensor_to_voigt(s_conv)
    else:
        sig_c = sig_old_el

    sig_test = sig_c + jnp.einsum("kl,gl->gk", dmat, deps)  # (4, 6)
    sig_new, pgp = mat.radial_return(sig_test, sig_yield_el, h, g)

    # Internal force: elv = sum_g B_g^T sigma_g w_g |J_g|  (fcVM.py:2448-2462)
    elv = jnp.einsum("gkn,gk,g->n", bmat, sig_new, scale)
    return sig_new, sig_test, pgp, elv


@partial(jax.jit, static_argnames=("large_disp",))
def update_stress_load(
    coords: jnp.ndarray,
    elnodes: jnp.ndarray,
    dmat: jnp.ndarray,
    sig_yield: jnp.ndarray,
    disp: jnp.ndarray,
    du: jnp.ndarray,
    sig_old: jnp.ndarray,
    e,
    nu,
    et_e,
    large_disp: bool,
    plan=None,
):
    """Full-mesh stress update + internal force.

    Args:
      coords: (nn, 3) original nodal coordinates.
      elnodes: (ne, 10) 0-based connectivity.
      dmat: (6, 6) elastic matrix.
      sig_yield: (ne, 4) current yield stresses.
      disp: (ndof,) total displacement at the start of the Riks step.
      du: (ndof,) accumulated displacement increment of the current step.
      sig_old: (ne, 4, 6) stresses at the start of the step.
      large_disp: geometric nonlinearity flag (static).

    Returns:
      (sig_new, sig_test, pgp, qin): updated stresses (ne, 4, 6), trial
      stresses (ne, 4, 6), plastic flags (ne, 4), internal force (ndof,).
    """
    g = mat.shear_modulus(e, nu)
    h = mat.hardening_modulus(e, et_e)
    ndof = disp.shape[0]

    coords_el = coords[elnodes]  # (ne, 10, 3)
    u_el = disp.reshape(-1, 3)[elnodes]
    du_el = du.reshape(-1, 3)[elnodes]

    def one_element(c, u, d, s, sy, dmat_e, h_e, g_e):
        return _element_stress_update(c, u, d, s, sy, dmat_e, h_e, g_e, large_disp)

    # per-element materials: dmat (ne, 6, 6), h/g (ne,); else broadcast.
    # Chunked past the threshold so per-gauss-point intermediates never
    # materialize whole-mesh (see assembly._maybe_chunked).
    from fcvm_tpu.ops.assembly import _maybe_chunked

    mat_axes = (0, 0, 0) if dmat.ndim == 3 else (None, None, None)
    sig_new, sig_test, pgp, elv = _maybe_chunked(
        one_element, elnodes,
        (coords_el, u_el, du_el, sig_old, sig_yield, dmat, h, g),
        (0, 0, 0, 0, 0) + mat_axes,
    )

    # node-row scatter: 3x fewer indices than per-dof (see make_matvec)
    if plan is not None:
        qin3 = scatter_node_rows(elv.reshape(-1, 3), plan)
    else:
        qin3 = jax.ops.segment_sum(
            elv.reshape(-1, 3), elnodes.reshape(-1), num_segments=ndof // 3
        )
    return sig_new, sig_test, pgp, qin3.reshape(-1)


@partial(jax.jit, static_argnames=("large_disp",))
def internal_force_from_stress(
    coords: jnp.ndarray,
    elnodes: jnp.ndarray,
    sig_gp: jnp.ndarray,
    disp: jnp.ndarray,
    large_disp: bool,
):
    """``qin = sum_e B^T sigma w |J|`` for a *given* stress field.

    Used for the reaction force of the target-LF interception state, whose
    stress is a linear interpolation rather than a radial-return result
    (``fcVM.py:1486-1510``) — the reference never re-evaluates the reaction
    there (documented divergence; its ``rfl`` history skips that step).
    """
    ndof = disp.shape[0]
    # refinement mode holds disp in f64 (runtime.driver); the reaction
    # record stays in the storage dtype (trace-time guard — same-dtype
    # inputs leave the jaxpr unchanged)
    if disp.dtype != coords.dtype:
        disp = disp.astype(coords.dtype)
    coords_el = coords[elnodes]
    if large_disp:
        coords_el = coords_el + disp.reshape(-1, 3)[elnodes]
    # full precision for the same reason as _element_stress_update: this
    # feeds the reaction-force record, not an iterative correction
    with jax.default_matmul_precision("highest"):
        det, _, bmat = jax.vmap(el.tet10_element_geometry)(coords_el)
        w = jnp.asarray(el.W10, dtype=coords.dtype)
        scale = w[None, :] * jnp.abs(det)  # (ne, 4)
        elv = jnp.einsum("egkn,egk,eg->en", bmat, sig_gp, scale)
    qin3 = jax.ops.segment_sum(
        elv.reshape(-1, 3), elnodes.reshape(-1), num_segments=ndof // 3
    )
    return qin3.reshape(-1)
