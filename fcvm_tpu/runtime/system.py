"""Jitted whole-system composites shared by the driver, buckling and bench.

Each function here is one ``jit`` boundary: assemble-elastic, solve,
residual/stress-update, tangent refresh.  They take only arrays / pytrees
(no Python objects) so the compiled executables are reused across load steps
and Newton iterations without retracing.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from fcvm_tpu.ops import assembly as asm
from fcvm_tpu.ops import solver as slv
from fcvm_tpu.ops.precond import apply_precond, build_two_level, refresh_blocks
from fcvm_tpu.ops.stress_update import update_stress_load


class LoadTables(NamedTuple):
    """Device-side load tables (see :class:`fcvm_tpu.models.spec.Loads`)."""

    pressure_faces: jnp.ndarray
    pressures: jnp.ndarray
    traction_faces: jnp.ndarray
    tractions: jnp.ndarray
    edges: jnp.ndarray
    edge_tractions: jnp.ndarray
    vertices: jnp.ndarray
    vertex_forces: jnp.ndarray
    gravity: jnp.ndarray

    @staticmethod
    def from_spec(loads, dtype) -> "LoadTables":
        return LoadTables(
            jnp.asarray(loads.pressure_faces, dtype=jnp.int32),
            jnp.asarray(loads.pressures, dtype=dtype),
            jnp.asarray(loads.traction_faces, dtype=jnp.int32),
            jnp.asarray(loads.tractions, dtype=dtype),
            jnp.asarray(loads.edges, dtype=jnp.int32),
            jnp.asarray(loads.edge_tractions, dtype=dtype),
            jnp.asarray(loads.vertices, dtype=jnp.int32),
            jnp.asarray(loads.vertex_forces, dtype=dtype),
            jnp.asarray(loads.gravity, dtype=dtype),
        )


def external_loads(coords, disp, elnodes, loads: LoadTables, density, follower: bool):
    """Global load vector + Gauss-point coordinates + volume + load sums.

    ``follower=False``: everything on the original geometry (elastic
    assembly, ``fcVM.py:647-767``).  ``follower=True``: pressure follows the
    stretched surface and gravity integrates on deformed coordinates, while
    uniform face/edge loads stay on the original geometry — the exact GNL
    tangent behaviour of the reference (``fcVM.py:858-938, 962-1009``).

    ``disp`` may be longer than ``3 * nn`` (dof-vector padding for
    gather/scatter alignment); the returned load vector matches its length.
    """
    ndof = disp.shape[0]
    nn = coords.shape[0]
    coords_def = coords + disp.reshape(-1, 3)[:nn] if follower else coords
    glv, gp_coords, volume = asm.gravity_load_and_gp_coords(
        coords_def, elnodes, density, loads.gravity, ndof
    )
    glv = glv + asm.pressure_face_loads(coords_def, loads.pressure_faces, loads.pressures, ndof)
    glv = glv + asm.uniform_face_loads(coords, loads.traction_faces, loads.tractions, ndof)
    glv = glv + asm.edge_loads(coords, loads.edges, loads.edge_tractions, ndof)
    glv = glv + asm.vertex_loads(loads.vertices, loads.vertex_forces, ndof, coords.dtype)
    loadsums = jnp.sum(glv.reshape(-1, 3), axis=0)
    return glv, gp_coords, volume, loadsums


@jax.jit
def assemble_elastic(
    coords, elnodes, dmat, loads: LoadTables, density, fixmask, u_fix, plan=None
):
    """Elastic blocks + preconditioner + loads + elastic RHS.

    The matrix-free equivalent of ``calcGSM`` (``fcVM.py:620-816``): instead of
    COO triplets we keep (ne, 30, 30) blocks and the 3x3 nodal Jacobi inverses.
    """
    esm = asm.elastic_stiffness_blocks(coords, elnodes, dmat)
    pinv = asm.block_jacobi_inverse_blocks(esm, elnodes, fixmask)
    zero = jnp.zeros_like(u_fix)
    glv, gp_coords, volume, loadsums = external_loads(
        coords, zero, elnodes, loads, density, follower=False
    )
    eldofs = asm.element_dof_ids(elnodes)
    rhs = asm.dirichlet_rhs(esm, eldofs, fixmask, u_fix, glv, plan)
    return esm, pinv, glv, rhs, gp_coords, volume, loadsums


class SolveSpace(NamedTuple):
    """Morton-ordered solve space: the node/element numbering CG runs in.

    The two-level preconditioner aggregates *index-contiguous* node ranges,
    so its effectiveness depends on contiguous ranges being spatially
    compact.  Rather than renumbering the user's mesh (which would change
    Gauss-point ordering and the result-parity with the reference), the
    linear solves permute into a Morton (Z-order) node numbering with
    elements sorted to match: one (nn, 3) row gather in and out per solve,
    amortized over the whole CG iteration.  At 499k dofs: 385 -> 87 CG
    iterations for the elastic solve; the element sort keeps the
    per-iteration gathers local (a random 3-wide-row permutation gather
    *per iteration* would cost what the per-solve boundary gathers cost
    once).

    Fields:
      nperm: (nn_pad,) original padded-node id at each Morton slot.
      npos: (nn_pad,) Morton slot of each original padded node.
      eperm: (ne,) solver element order (ascending min Morton slot).
      elnodes_m: (ne, 10) Morton node ids, ``eperm``-sorted.
      fixmask_m: (ndof_pad,) fixmask in Morton numbering.
      plan_m: gather-only scatter plan for the Morton numbering.
      coords_m: (nn, 3) coordinates in Morton numbering.
    """

    nperm: jnp.ndarray
    npos: jnp.ndarray
    eperm: jnp.ndarray
    elnodes_m: jnp.ndarray
    fixmask_m: jnp.ndarray
    plan_m: asm.ScatterPlan
    coords_m: jnp.ndarray

    def to_m(self, v):
        return v.reshape(-1, 3)[self.nperm].reshape(-1)

    def from_m(self, v):
        return v.reshape(-1, 3)[self.npos].reshape(-1)


def build_solve_space(coords_np, elnodes_np, fixmask, ndof_pad: int) -> SolveSpace:
    """Build the Morton solve space (one host argsort per analysis)."""
    from fcvm_tpu.utils.ordering import morton_perm

    nn = len(coords_np)
    nn_pad = ndof_pad // 3
    perm = np.concatenate([morton_perm(np.asarray(coords_np)),
                           np.arange(nn, nn_pad)])
    npos_np = np.empty(nn_pad, dtype=np.int64)
    npos_np[perm] = np.arange(nn_pad)
    elnodes_m_np = npos_np[np.asarray(elnodes_np)]
    eperm_np = np.argsort(elnodes_m_np.min(axis=1), kind="stable")
    elnodes_m_np = elnodes_m_np[eperm_np]
    dtype = fixmask.dtype
    fixmask_m = jnp.asarray(
        np.asarray(fixmask).reshape(nn_pad, 3)[perm].reshape(-1), dtype=dtype
    )
    plan_m = asm.build_scatter_plan(elnodes_m_np, nn_pad)
    coords_m = jnp.asarray(np.asarray(coords_np)[perm[:nn]], dtype=dtype)
    return SolveSpace(
        jnp.asarray(perm, dtype=jnp.int32),
        jnp.asarray(npos_np, dtype=jnp.int32),
        jnp.asarray(eperm_np, dtype=jnp.int32),
        jnp.asarray(elnodes_m_np, dtype=jnp.int32),
        fixmask_m,
        plan_m,
        coords_m,
    )


def _hp_precision(hp: bool):
    """Matvec einsum precision override for the HP-escalation tier (None =
    size-resolved default, ``ops.assembly.resolve_matvec_precision``)."""
    return jax.lax.Precision.HIGHEST if hp else None


@partial(jax.jit, static_argnames=("maxiter", "hp"))
def solve_displacement(
    esm, elnodes, fixmask, pc, b, rtol, maxiter: int, x0=None, plan=None,
    space: SolveSpace | None = None, defl=None, hp: bool = False,
):
    """PCG solve of ``K_hat x = b`` (replaces ``factor(f)``).

    ``pc`` is either (nn, 3, 3) block-Jacobi inverses or a
    :class:`fcvm_tpu.ops.precond.TwoLevelPrecond`.  Seeding ``x0`` with the
    prescribed-displacement vector makes the fixed dofs exact from iteration
    zero (the preconditioner is identity there, so search directions never
    touch them).  ``plan`` (a :class:`fcvm_tpu.ops.assembly.ScatterPlan`)
    switches the operator's scatter-add to the gather-only fast path.

    With ``space`` the whole Krylov loop runs in the Morton solve space —
    ``pc`` must then have been built on the Morton-permuted operator
    (:func:`build_precond`); ``esm`` stays in user element order and is
    permuted on entry (one (ne, 900) gather per solve).

    ``defl`` (a :class:`fcvm_tpu.ops.deflation.DeflationSpace`, in solve
    space) adds the Ritz-recycling correction to the preconditioner —
    measured 58 -> 30 CG iterations at 499k dof with the two-pass harvest.

    ``hp=True`` pins the operator einsum at HIGHEST precision (the driver's
    escalation tier for f32 stagnation above ``matvec_hp_max_dof``).
    """
    from fcvm_tpu.ops.deflation import deflated

    prec = _hp_precision(hp)
    if space is not None:
        esm_m = esm[space.eperm]
        eldofs = asm.element_dof_ids(space.elnodes_m)
        matvec = asm.make_bc_matvec(esm_m, eldofs, space.fixmask_m,
                                    space.plan_m, precision=prec)
        precond = deflated(lambda r: apply_precond(pc, r), defl)
        res = slv.pcg(
            matvec, space.to_m(b), precond=precond,
            x0=None if x0 is None else space.to_m(x0),
            rtol=rtol, maxiter=maxiter,
        )
        return res._replace(x=space.from_m(res.x))
    eldofs = asm.element_dof_ids(elnodes)
    matvec = asm.make_bc_matvec(esm, eldofs, fixmask, plan, precision=prec)
    precond = deflated(lambda r: apply_precond(pc, r), defl)
    return slv.pcg(matvec, b, precond=precond, x0=x0, rtol=rtol, maxiter=maxiter)


@partial(jax.jit, static_argnames=("maxiter", "nstore", "hp"))
def solve_displacement_harvest(
    esm, elnodes, fixmask, pc, b, rtol, maxiter: int, x0=None, plan=None,
    space: SolveSpace | None = None, defl=None, nstore: int = 64,
    hp: bool = False,
):
    """:func:`solve_displacement` recording Lanczos byproducts for recycling.

    Returns ``(CGResult, HarvestData)``; the harvest arrays (and any
    ``defl``) live in the solve space when ``space`` is given.
    """
    from fcvm_tpu.ops.deflation import deflated

    prec = _hp_precision(hp)
    if space is not None:
        esm_m = esm[space.eperm]
        eldofs = asm.element_dof_ids(space.elnodes_m)
        matvec = asm.make_bc_matvec(esm_m, eldofs, space.fixmask_m,
                                    space.plan_m, precision=prec)
        precond = deflated(lambda r: apply_precond(pc, r), defl)
        res, h = slv.pcg_harvest(
            matvec, space.to_m(b), precond=precond,
            x0=None if x0 is None else space.to_m(x0),
            rtol=rtol, maxiter=maxiter, nstore=nstore,
        )
        return res._replace(x=space.from_m(res.x)), h
    eldofs = asm.element_dof_ids(elnodes)
    matvec = asm.make_bc_matvec(esm, eldofs, fixmask, plan, precision=prec)
    precond = deflated(lambda r: apply_precond(pc, r), defl)
    return slv.pcg_harvest(
        matvec, b, precond=precond, x0=x0, rtol=rtol, maxiter=maxiter,
        nstore=nstore,
    )


@jax.jit
def build_deflation(esm, elnodes, fixmask, zs, coef, plan=None,
                    space: SolveSpace | None = None):
    """Fused per-step deflation-space build, in the solve space.

    One device program per mesh (coef is zero-padded to a fixed shape by
    ``ritz_coefficients``): basis combination, block Galerkin and the PSD
    pseudo-inverse all run in a single dispatch, with no per-piece host
    round-trips."""
    from fcvm_tpu.ops.deflation import build_space

    if space is not None:
        esm_m = esm[space.eperm]
        eldofs = asm.element_dof_ids(space.elnodes_m)
        return build_space(esm_m, eldofs, space.fixmask_m, space.plan_m,
                           zs, coef)
    eldofs = asm.element_dof_ids(elnodes)
    return build_space(esm, eldofs, fixmask, plan, zs, coef)


@jax.jit
def deflation_x0(b, defl, space: SolveSpace | None = None):
    """Deflation-as-initial-guess: ``x0 = W (W^T K W)^+ W^T b``.

    The zero-overhead alternative to the per-iteration correction in
    :func:`fcvm_tpu.ops.deflation.deflated` — the Ritz space is projected
    out of the initial residual only, so CG pays nothing per iteration but
    the slow modes can re-enter through rounding.  ``defl`` lives in the
    solve space; ``b`` and the returned ``x0`` are in user dof order."""
    bm = space.to_m(b) if space is not None else b
    with jax.default_matmul_precision("highest"):
        x0 = defl.w @ (defl.kw_inv @ (defl.w.T @ bm))
    return space.from_m(x0) if space is not None else x0


@jax.jit
def regalerkin_deflation(esm, elnodes, fixmask, w, plan=None,
                         space: SolveSpace | None = None):
    """Re-Galerkin an existing basis on a refreshed operator (one fused
    dispatch: block matvec + PSD pseudo-inverse)."""
    from fcvm_tpu.ops.deflation import (
        DeflationSpace, block_khat_matvec, pinv_psd,
    )

    # HIGHEST: Galerkin builds of subspace corrections (ops.deflation rule)
    with jax.default_matmul_precision("highest"):
        if space is not None:
            esm_m = esm[space.eperm]
            eldofs = asm.element_dof_ids(space.elnodes_m)
            kw = w.T @ block_khat_matvec(esm_m, eldofs, space.fixmask_m,
                                         space.plan_m, w)
        else:
            eldofs = asm.element_dof_ids(elnodes)
            kw = w.T @ block_khat_matvec(esm, eldofs, fixmask, plan, w)
    return DeflationSpace(w, pinv_psd(kw))


def build_precond(esm, elnodes, coords, fixmask, cluster_size: int,
                  space: SolveSpace | None = None, n_modes: int | None = None):
    """Two-level preconditioner build (device Galerkin assembly + dense
    inverse; see :func:`fcvm_tpu.ops.precond.build_two_level`).  With
    ``space`` the preconditioner is built on the Morton-permuted operator
    (compact index-contiguous clusters)."""
    from fcvm_tpu.config import get_config

    if n_modes is None:
        n_modes = get_config().coarse_modes
    if space is not None:
        return build_two_level(
            esm[space.eperm], space.elnodes_m, space.coords_m,
            space.fixmask_m, cluster_size=cluster_size, n_modes=n_modes,
        )
    return build_two_level(
        esm, elnodes, coords, fixmask, cluster_size=cluster_size,
        n_modes=n_modes,
    )


@partial(jax.jit, static_argnames=("large_disp",))
def residual(
    coords,
    elnodes,
    dmat,
    sig_yield,
    disp_new,
    du,
    sig_old,
    e,
    nu,
    et_e,
    glv,
    fixmask,
    lbd1,
    qnorm,
    large_disp: bool,
    plan=None,
    relax=1.0,
):
    """Stress update + out-of-balance residual (``fcVM.py:1323-1342``).

    The returned ``r`` is pre-scaled by the relaxation factor
    (``fcVM.py:1398-1400`` applies it at the solve RHS) so the NR loop
    does not pay a separate eager device op per iteration; ``error``
    is computed from the raw residual as the reference does."""
    sig_new, sig_test, pgp, qin = update_stress_load(
        coords, elnodes, dmat, sig_yield, disp_new, du, sig_old, e, nu, et_e,
        large_disp, plan,
    )
    r = fixmask * (lbd1 * glv - qin)
    error = jnp.linalg.norm(r) / qnorm
    return sig_new, sig_test, pgp, qin, relax * r, error


@partial(jax.jit, static_argnames=("large_disp",))
def residual_refined(
    coords,
    elnodes,
    dmat,
    sig_yield,
    disp_new,
    du,
    sig_old,
    e,
    nu,
    et_e,
    glv,
    fixmask,
    lbd1,
    qnorm,
    large_disp: bool,
    plan=None,
    relax=1.0,
):
    """:func:`residual` with f64 evaluation over f32-stored state.

    The mixed-precision refinement tier (``config.residual_refinement``;
    SURVEY.md's accelerator equivalent of the reference's unconditional
    CHOLMOD-f64 pipeline, ``fcVM.py:1111-1135``): every input is upcast to
    f64 *inside the jit* (no eager casts, no separate f64 state copies) and
    the stress update + out-of-balance force are evaluated exactly.  The
    f32 floor is evaluation noise — many-term cancellation in
    ``B^T sigma`` amplified on slender/ill-scaled meshes — so computing
    the residual of the f32-represented state in f64 removes it; the
    remaining limit is the smoothness of the (exact) function itself.

    Returns the Gauss state cast back to the caller's storage dtype (state
    stays f32 across steps), the CG right-hand side in the storage dtype
    (the correction solve keeps the f32 operator — that is the point of
    the tier), and the error as an f64 scalar.  Requires x64 enabled
    (the driver enables it at activation).
    """
    f64 = jnp.float64
    out_dt = glv.dtype

    def c(x):
        return jnp.asarray(x).astype(f64)

    sig_new, sig_test, pgp, qin = update_stress_load(
        c(coords), elnodes, c(dmat), c(sig_yield), c(disp_new), c(du),
        c(sig_old), c(e), c(nu), c(et_e), large_disp, plan,
    )
    r = c(fixmask) * (c(lbd1) * c(glv) - qin)
    error = jnp.linalg.norm(r) / c(qnorm)
    return (
        sig_new.astype(out_dt),
        sig_test.astype(out_dt),
        pgp,
        qin.astype(out_dt),
        (c(relax) * r).astype(out_dt),
        error,
    )


@partial(jax.jit, static_argnames=("maxiter", "solve_predictor", "hp"))
def tangent_refresh(
    coords,
    elnodes,
    dmat,
    sig_old,
    pgp,
    disp_new,
    du,
    loads: LoadTables,
    density,
    fixmask,
    u_fix,
    g,
    h,
    rtol,
    maxiter: int,
    pc=None,
    plan=None,
    space: SolveSpace | None = None,
    ue0=None,
    w=None,
    solve_predictor: bool = True,
    hp: bool = False,
):
    """GNL tangent reassembly + follower loads + tangent predictor solve.

    The matrix-free equivalent of ``calcTSM`` + re-factorization + ``ue =
    K_t^-1 f`` (``fcVM.py:1351-1396``).  Returns ``(esm_t, pc_t, glv_t, out,
    iters)`` where ``out`` is the tangent predictor solution (or, with
    ``solve_predictor=False``, the assembled predictor RHS so the caller can
    run a harvesting solve on it) and ``iters`` its CG count.  The two-level
    coarse correction is kept from the elastic operator; only the nodal blocks
    are rebuilt.  ``esm_t`` is returned in user element order; with ``space``
    the refresh and solve run in the Morton solve space (``pc`` must live there
    too).

    Successive tangent operators and their load-like RHS differ by one
    Newton update, so the predictor is seeded with the PREVIOUS predictor
    solution ``ue0`` (the ``rtol * ||b||`` stopping criterion makes a warm
    start pay off directly).  ``w`` (a load-rhs-harvested Ritz basis in
    solve space — a RESIDUAL-harvested one does nothing for load rhs,
    measured in tools/deflate_step_probe.py) is re-Galerkined against the
    fresh tangent inside the jit (one block matvec) and deflates the
    predictor solve.
    """
    from fcvm_tpu.ops.deflation import (
        DeflationSpace, block_khat_matvec, deflated, pinv_psd,
    )

    # Residual-refinement mode holds disp_new/du in f64 (runtime.driver);
    # the tangent OPERATOR stays in the storage dtype by design, so cast
    # at the boundary.  Trace-time guard: for same-dtype inputs the jaxpr
    # is unchanged (no convert op), preserving existing compiled programs.
    if disp_new.dtype != coords.dtype:
        disp_new = disp_new.astype(coords.dtype)
    if du.dtype != coords.dtype:
        du = du.astype(coords.dtype)

    coords_def = coords + disp_new.reshape(-1, 3)[: coords.shape[0]]
    esm_t = asm.tangent_stiffness_blocks(
        coords_def, elnodes, dmat, sig_old, pgp, g, h
    )
    glv_t, _, _, _ = external_loads(
        coords, disp_new, elnodes, loads, density, follower=True
    )
    prec = _hp_precision(hp)
    if space is not None:
        esm_m = esm_t[space.eperm]
        pc_t = refresh_blocks(pc, esm_m, space.elnodes_m, space.fixmask_m)
        eldofs = asm.element_dof_ids(space.elnodes_m)
        fix_m, plan_m = space.fixmask_m, space.plan_m
        rhs = asm.dirichlet_rhs(
            esm_m, eldofs, fix_m, space.to_m(u_fix), space.to_m(glv_t),
            plan_m,
        )
        matvec = asm.make_bc_matvec(esm_m, eldofs, fix_m, plan_m,
                                    precision=prec)
    else:
        esm_m = esm_t
        pc_t = refresh_blocks(pc, esm_t, elnodes, fixmask)
        eldofs = asm.element_dof_ids(elnodes)
        fix_m, plan_m = fixmask, plan
        rhs = asm.dirichlet_rhs(esm_t, eldofs, fix_m, u_fix, glv_t, plan_m)
        matvec = asm.make_bc_matvec(esm_t, eldofs, fix_m, plan_m,
                                    precision=prec)
    if not solve_predictor:
        # Known cost, accepted: the returned user-order RHS is immediately
        # re-permuted to solve space by the caller's solve_harvest (two
        # ~120 ms (nn, 3) row gathers at 166k nodes).  This branch fires
        # only when the driver (re)builds a LOAD-deflation space — a
        # handful of times per run — so a space-order return convention
        # (and the backend-signature change it needs) isn't worth it.
        out = space.from_m(rhs) if space is not None else rhs
        return esm_t, pc_t, glv_t, out, jnp.array(0, jnp.int32)
    defl = None
    if w is not None:
        # HIGHEST: Galerkin build of the load-deflation correction
        with jax.default_matmul_precision("highest"):
            kw = w.T @ block_khat_matvec(esm_m, eldofs, fix_m, plan_m, w)
        defl = DeflationSpace(w, pinv_psd(kw))
    precond = deflated(lambda r: apply_precond(pc_t, r), defl)
    x0 = None
    if ue0 is not None:
        x0 = space.to_m(ue0) if space is not None else ue0
    res = slv.pcg(matvec, rhs, precond=precond, x0=x0, rtol=rtol,
                  maxiter=maxiter)
    ue = space.from_m(res.x) if space is not None else res.x
    return esm_t, pc_t, glv_t, ue, res.iters


class NewtonIterOut(NamedTuple):
    """Everything one fused Newton iteration returns to the host loop.

    Scalars (``lbd1``, ``error``, ``cg_iters``, ``any_pgp``) are fetched in
    ONE bundled device_get per iteration; the array state stays on device
    and becomes the next iteration's input.  ``any_pgp`` is the
    reference's re-factorization trigger (``fcVM.py:1351``) evaluated on
    the NEW plastic flags — the host uses it to decide the next
    iteration's refresh without any separate probe dispatch.  ``a`` and
    ``defl`` are only non-None on a ``refresh=True`` call (the refreshed
    control vector and the re-Galerkined deflation space).
    """

    defl: object
    a: object
    du: jnp.ndarray
    lbd1: jnp.ndarray
    sig_new: jnp.ndarray
    sig_test: jnp.ndarray
    pgp: jnp.ndarray
    qin: jnp.ndarray
    r: jnp.ndarray
    error: jnp.ndarray
    cg_iters: jnp.ndarray
    any_pgp: jnp.ndarray


@partial(jax.jit, static_argnames=("large_disp", "maxiter", "crisfield",
                                   "hp", "refresh"))
def newton_iteration(
    coords,
    elnodes,
    dmat,
    sig_yield,
    disp_new,
    du,
    sig_old,
    e,
    nu,
    et_e,
    glv,
    fixmask,
    lbd0,
    lbd1,
    qnorm,
    a,
    ue,
    r,
    esm,
    pc,
    rtol,
    maxiter: int,
    large_disp: bool,
    refresh: bool,
    plan=None,
    space: SolveSpace | None = None,
    defl=None,
    relax=1.0,
    crisfield: bool = False,
    hp: bool = False,
) -> NewtonIterOut:
    """Correction solve + Riks update + stress-update/residual as ONE
    device program — the fused Newton iteration (SURVEY.md build-plan
    step 6 at iteration granularity; reference loop ``fcVM.py:1304-1557``).

    The host loop keeps only governance (restarts, floor watch, deflation
    policy) and fetches four scalars once per iteration; the unfused path
    pays ~6 dispatches and 3 blocking fetches per iteration.

    GNL refresh iterations run as TWO pipelined dispatches: the existing
    :func:`tangent_refresh` program (reassembly + follower loads + warm
    predictor solve) followed by this one with ``refresh=True``, which
    computes the control vector ``a = ue |du|/|ue|`` (``fcVM.py:1392-1394``)
    and re-Galerkins a held deflation space against the fresh ``esm``
    in-jit — no host sync between the two dispatches.  (A single fused
    program containing the tangent assembly + BOTH PCG loops exceeded the
    first accelerator's compile service at 499k dof, and a traced
    ``lax.cond`` refresh broke multi-process gloo with a collective-size
    mismatch — hence two static variants of a smaller program.  Whether
    one program compiles and pays on the H100 is an open measurement.)
    """
    # refinement mode never routes here (driver guard); keep the dtype
    # guards anyway so a stray f64 du cannot silently retrace the operator
    if disp_new.dtype != coords.dtype:
        disp_new = disp_new.astype(coords.dtype)
    if du.dtype != coords.dtype:
        du = du.astype(coords.dtype)

    from fcvm_tpu.ops.deflation import (
        DeflationSpace, block_khat_matvec, deflated, pinv_psd,
    )

    prec = _hp_precision(hp)
    if space is not None:
        eldofs = asm.element_dof_ids(space.elnodes_m)
        fix_m, plan_m = space.fixmask_m, space.plan_m
        esm_m = esm[space.eperm]
    else:
        eldofs = asm.element_dof_ids(elnodes)
        fix_m, plan_m = fixmask, plan
        esm_m = esm

    defl_out = None
    a_out = None
    if refresh and large_disp:
        # control vector from the (pipelined-in) fresh tangent predictor
        nu_t = jnp.linalg.norm(ue)
        a = ue * (jnp.linalg.norm(du)
                  / jnp.where(nu_t == 0.0, 1.0, nu_t))
        a_out = a
        if defl is not None:
            # re-Galerkin the held residual space on the fresh operator
            # (one block matvec; a stale Galerkin stays SPD but deflates
            # the wrong scales)
            with jax.default_matmul_precision("highest"):
                kw = defl.w.T @ block_khat_matvec(
                    esm_m, eldofs, fix_m, plan_m, defl.w
                )
            defl = DeflationSpace(defl.w, pinv_psd(kw))
            defl_out = defl

    # correction solve (fcVM.py:1400-1406 equivalent)
    matvec_c = asm.make_bc_matvec(esm_m, eldofs, fix_m, plan_m,
                                  precision=prec)
    precond_c = deflated(lambda r_: apply_precond(pc, r_), defl)
    b_m = space.to_m(r) if space is not None else r
    res_c = slv.pcg(matvec_c, b_m, precond=precond_c, rtol=rtol,
                    maxiter=maxiter)
    due = space.from_m(res_c.x) if space is not None else res_c.x

    riks_fn = riks_update_crisfield if crisfield else riks_update
    du, lbd1, _ = riks_fn(a, ue, due, du, lbd0, lbd1)

    sig_new, sig_test, pgp, qin, r_new, error = residual(
        coords, elnodes, dmat, sig_yield, disp_new, du, sig_old, e, nu,
        et_e, glv, fixmask, lbd1, qnorm, large_disp, plan, relax=relax,
    )
    return NewtonIterOut(
        defl_out, a_out, du, lbd1, sig_new, sig_test, pgp, qin,
        r_new, error, res_c.iters, jnp.any(pgp),
    )


@jax.jit
def riks_update(a, ue, due, du, lbd0, lbd1):
    """Arc-length load correction + increment scale-back
    (``fcVM.py:1414-1434``).

    Returns (du, lbd1, dl).
    """
    aue = jnp.vdot(a, ue)
    dl = -jnp.vdot(a, due) / jnp.where(aue == 0.0, 1.0, aue)
    lbd1 = lbd1 + dl
    aa = jnp.linalg.norm(a)
    du = du + due + dl * ue
    uu = jnp.linalg.norm(du)
    # ``uu = 0`` (zero increment, e.g. a fully-converged restart state)
    # must not poison the while_loop with NaN: no scale-back then.  The
    # reference divides unguarded (fcVM.py:1431-1434) — a crash hazard, not
    # a result-affecting quirk, so it is fixed here.
    sf = jnp.where(uu > 0.0, jnp.minimum(aa / jnp.where(uu == 0.0, 1.0, uu), 1.0), 1.0)
    lbd1 = lbd0 + sf * (lbd1 - lbd0)
    du = du * sf
    return du, lbd1, dl


@jax.jit
def any_flag(mask):
    """Jitted reduction for the driver host loop.

    Eager (non-jitted) multi-op array code dispatches once per op; the
    GNL Newton loop asks "any Gauss point plastic?" every iteration
    (``fcVM.py:1351``), so the reduction is a cached jit, not an eager op.
    """
    return jnp.any(mask)


@jax.jit
def scaled_control_vector(ue, du):
    """``a = ue * |du| / |ue|`` (``fcVM.py:1392-1394``) as ONE dispatch.

    Runs once per GNL tangent refresh in the driver host loop — eager it
    would be three dispatches (two norms + a multiply).  ``|ue| = 0`` guarded
    like :func:`riks_update` (crash-hazard class, not result-affecting).
    """
    nu = jnp.linalg.norm(ue)
    return ue * (jnp.linalg.norm(du) / jnp.where(nu == 0.0, 1.0, nu))


@jax.jit
def masked_sum(mask, v):
    """Jitted ``sum(mask * v)`` (displacement-control reaction level,
    ``fcVM.py:1522-1523``) — once per converged step in the host loop."""
    return jnp.sum(mask * v)


@jax.jit
def record_step_stats(disp_new, csr, peeq, pressure, svm, triax, ecr):
    """Converged-step history scalars in ONE device program + ONE fetch.

    The reference reads its full per-GP fields in-process to record the
    critical Gauss point (``fcVM.py:1539-1557``) — free on CPU.  A naive
    port would fetch six full ``(ne, 4)`` fields from the device every
    converged step (~11 MB at 499k dof); this computes the same records on
    device and the driver fetches nine scalars in one round trip.  All inputs
    are in USER Gauss order so the argmax tie-breaking (first max, like
    ``np.argmax``) matches the reference exactly.

    Returns (un_max, maxloc, csr@loc, pressure@loc, svm@loc, triax@loc,
    ecr@loc, peeq@loc, peeq_max).
    """
    un = jnp.sqrt((disp_new.reshape(-1, 3) ** 2).sum(axis=1).max())
    csr_f = csr.reshape(-1)
    maxloc = jnp.argmax(csr_f)
    return (
        un,
        maxloc,
        csr_f[maxloc],
        pressure.reshape(-1)[maxloc],
        svm.reshape(-1)[maxloc],
        triax.reshape(-1)[maxloc],
        ecr.reshape(-1)[maxloc],
        peeq.reshape(-1)[maxloc],
        peeq.max(),
    )


@jax.jit
def commit_step(disp_new, du, factor):
    """Converged-step commit in one dispatch: total displacement update +
    the adaptively scaled next increment (``fcVM.py:1515-1537``; the
    scale-up/scale-down branches are mutually exclusive, so the host
    resolves them to a single ``factor``).  Two eager device ops per
    converged step would be two dispatches — this is one."""
    return disp_new + du, du * factor


@jax.jit
def riks_update_crisfield(a, ue, due, du, lbd0, lbd1):
    """Spherical (Crisfield) arc-length update — beyond-reference capability.

    The reference's linearized correction + norm scale-back
    (:func:`riks_update`, ``fcVM.py:1414-1434``) cannot traverse a
    *snapback* fold: the scale-back never lets ``|du|`` grow within a
    step, so modified NR cycles at constant residual when the equilibrium
    path folds back in the controlled displacement (measured on the
    arch + soft-ram specimen of ``tests/test_buckling_gnl.py``).  This
    variant instead solves the spherical constraint
    ``|du + due + dl*ue|^2 = |a|^2`` exactly for the load correction
    (quadratic roots; the one keeping the increment aligned with the
    control vector ``a`` preserves path continuity, Crisfield 1981),
    falling back to the stationary point when the sphere is unreachable.
    Select with ``config.arc_length = "crisfield"`` / ``FCVM_ARC``.

    Returns (du, lbd1, dl) like :func:`riks_update`.
    """
    p = du + due
    a2 = jnp.vdot(ue, ue)
    safe_a2 = jnp.where(a2 == 0.0, 1.0, a2)
    b = 2.0 * jnp.vdot(p, ue)
    c = jnp.vdot(p, p) - jnp.vdot(a, a)
    disc = b * b - 4.0 * a2 * c
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    dl_hi = (-b + sq) / (2.0 * safe_a2)
    dl_lo = (-b - sq) / (2.0 * safe_a2)
    keep_hi = jnp.vdot(a, p + dl_hi * ue) >= jnp.vdot(a, p + dl_lo * ue)
    dl = jnp.where(keep_hi, dl_hi, dl_lo)
    dl = jnp.where(disc >= 0.0, dl, -b / (2.0 * safe_a2))
    du = p + dl * ue
    return du, lbd1 + dl, dl
