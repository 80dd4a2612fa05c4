"""Linear (elastic) buckling: K v = lambda (-G) v, matrix-free on device.

The reference assembles full elastic (``stms``) and geometric (``stmg``)
matrices and calls ARPACK shift-invert
(``eigsh(K, k=2, M=-G, sigma=0.1, mode='buckling')``,
``source code/fcVM.py:1199-1214``).  Shift-invert needs a sparse
factorization, which the matrix-free design avoids, so we solve the
equivalent problem: the buckling factors are
``lambda_i = 1 / theta_i`` for the largest eigenvalues ``theta`` of
``K_hat^{-1} (-G_hat)``, found by block subspace iteration with
Rayleigh-Ritz on the (K, -G) pencil.  Every operator application is the
matrix-free gather/block-matmul/scatter product; the inner ``K^{-1}`` is the
same PCG used by the nonlinear driver.

Boundary conditions (documented divergence): the reference multiplies fixed
diagonal entries of the full ``stms`` by 100 as a penalty
(``fcVM.py:1051-1062``); we eliminate fixed dofs exactly by default
(identity rows in K_hat, zero rows in G_hat), which is the limit the penalty
approximates — committed corpus factors differ by ~3e-4 because of this.
``config.buckling_bc = "penalty"`` (env ``FCVM_BUCKLING_BC=penalty``)
opts into an exact reproduction of the reference's penalized full pencil
for committed-corpus parity at print precision.  Eigenvectors are
normalized in the (-G) metric, matching ARPACK's M-normalization, with the
max-magnitude entry made positive for determinism.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

from fcvm_tpu.config import get_config
from fcvm_tpu.ops import assembly as asm
from fcvm_tpu.ops import material as mat
from fcvm_tpu.ops import solver as slv

# Per-sweep host-loop helpers as cached jits: eager array ops dispatch once
# per op, and the subspace iteration runs up to 60 sweeps.
#
# The QR and Gram projections MUST run at full f32 matmul precision: at a
# reduced-precision f32 default (bf16 passes, or TF32 on a GPU) the
# projected Q^T K Q picks up enough error to go indefinite, and the host
# generalized eigh then fails with "leading minor of B is not positive
# definite" (seen on the Euler column at f32; same trap as the coarse
# inverse).  These are (m, ndof) x (ndof, m) ops once per sweep — the
# precision cost is negligible next to the column solves.


# Pencil-residual acceptance bound for pencil_subspace's a-posteriori
# validation (see the check before the (-G)-normalization).  Healthy f32
# solves sit at <= ~1e-3 relative; the silent wrong-factor failure mode
# sits at O(1).
_PENCIL_RESIDUAL_TOL = 0.03

# Re-assembly failover bound: when the f64-iteration retry ALSO fails the
# pencil-residual validation, the operands themselves are the problem —
# on the corpus "Bar buckling" pencil (cond ~1e10) the f32-ASSEMBLED K's
# ~1e-7 relative error swamps the small buckling eigenvalues entirely
# (measured: even the exact-splu tier on f32 operands returns factors
# 6.03/6.31 vs committed 0.4347 with 0.44-0.55 pencil residuals).  Final
# tier: re-assemble everything in float64 and solve with the exact host
# splu K^{-1} — the reference's own pipeline (``fcVM.py:1111-1135,
# 1263-1278``).  Host factorization is only feasible at small/medium
# meshes.
_DIRECT_FAILOVER_MAX_DOF = 200_000


class EigensolveBreakdownError(RuntimeError):
    """The subspace iteration lost the pencil to arithmetic breakdown.

    Raised when the Rayleigh-Ritz projections come back non-finite (a
    diverged f32 inner solve poisons the block) or the projected
    B = Q^T K Q stays indefinite through the ridge ladder.  Callers with
    an f32 operand set should retry the eigensolve in float64
    (:func:`linear_buckling` does this automatically)."""


def _qr_q_impl(z):
    with jax.default_matmul_precision("highest"):
        return jnp.linalg.qr(z)[0]


def _proj_impl(q, w):
    with jax.default_matmul_precision("highest"):
        return q.T @ w


_qr_q = jax.jit(_qr_q_impl)
_proj = jax.jit(_proj_impl)
_mix = jax.jit(lambda q, c: q @ c)


def _recycling_params(cfg, ndof, itemsize):
    """Deep-harvest sizing for the eigensolve's Ritz recycling.

    The harvest must go much deeper than the nonlinear driver's (a 64-slot
    prefix of a 1000+-iteration solve holds too weak a low band — measured
    net loss); the (nstore, ndof) buffer is capped at ~1 GiB on big meshes,
    a cap sized for a 16 GB device (the right cap on the H100 is an open
    measurement).
    """
    nstore = max(
        cfg.deflation_nstore,
        min(cfg.buckling_deflation_nstore, int(2**30 // (ndof * itemsize))),
    )
    return nstore, min(cfg.buckling_deflation_k, max(nstore // 4, 8))


def make_recycled_k_inverse(kinv, harvest, build_space, k_defl, min_iters,
                            enabled):
    """Deep-harvest recycling policy, operator-parametrized (shared by the
    local and sharded eigensolve tiers — same shape as ``pencil_subspace``).

    ``kinv(w, defl, x0_basis, x0_scale)`` solves the columns (jitted; the
    Ritz warm start ``x0 = x0_basis * x0_scale`` is formed IN-JIT so the
    outer sweep loop dispatches no eager device ops), ``harvest(b)`` is a
    ``pcg_harvest`` of one column, ``build_space(zs, coef)`` the fused
    DeflationSpace build. ONE harvest (first column, first call) deflates every
    subsequent solve: the operator never changes, so no re-Galerkin is needed.
    """
    from fcvm_tpu.ops import deflation as defl_ops

    state = {"defl": None, "tried": not enabled}

    def k_inverse(w, x0_basis=None, x0_scale=None):
        if not state["tried"]:
            state["tried"] = True
            res0, h = harvest(w[:, 0])
            it0 = int(res0.iters)
            if it0 >= min_iters:
                coef = defl_ops.ritz_coefficients(
                    *jax.device_get((h.alphas, h.betas, h.rzs)), it0, k_defl
                )
                if coef is not None:
                    state["defl"] = build_space(h.zs, jnp.asarray(coef))
            if w.shape[1] > 1:
                rest = kinv(
                    w[:, 1:], state["defl"],
                    None if x0_basis is None else x0_basis[:, 1:],
                    None if x0_scale is None else x0_scale[1:],
                )
                return jnp.concatenate([res0.x[:, None], rest], axis=1)
            return res0.x[:, None]
        return kinv(w, state["defl"], x0_basis, x0_scale)

    return k_inverse


def _multi_matvec_penalty(eldofs, ndof):
    """Jitted full (uneliminated) block operator plus a diagonal addition:
    ``(blocks, dvec, (ndof, m)) -> K_full u + dvec * u``.

    The reference-parity penalty mode (``config.buckling_bc = "penalty"``)
    assembles the pencil WITHOUT Dirichlet elimination and stiffens the
    fixed K diagonals x100 instead (``fcVM.py:1051-1062``); ``dvec`` carries
    the 99x extra diagonal plus identity on structurally empty rows
    (dof-alignment padding)."""

    @jax.jit
    def mv(blocks, dvec, u):
        ue = u[eldofs]  # (ne, 30, m)
        fe = jnp.einsum("eij,ejm->eim", blocks, ue)
        y = jax.ops.segment_sum(
            fe.reshape(-1, u.shape[1]), eldofs.reshape(-1), num_segments=ndof
        )
        return y + dvec[:, None] * u

    return mv


@jax.jit
def _assembled_diagonal(esm, eldofs, ndof_arr):
    """(ndof,) assembled diagonal of the element blocks (no BC handling)."""
    d = jnp.einsum("eii->ei", esm)
    return jax.ops.segment_sum(
        d.reshape(-1), eldofs.reshape(-1), num_segments=ndof_arr.shape[0]
    )


@jax.jit
def _penalty_block_jacobi(esm, elnodes, dvec):
    """Inverse 3x3 nodal blocks of the PENALIZED full stiffness (no
    elimination): assembled nodal diagonal blocks + ``dvec`` on the
    diagonal.  Preconditioner for the penalty-mode inner CG."""
    from fcvm_tpu.utils.linalg3 import inv3_spd

    ne = esm.shape[0]
    nn = dvec.shape[0] // 3
    blocks5 = esm.reshape(ne, 10, 3, 10, 3)
    idx = jnp.arange(10)
    diag = blocks5[:, idx, :, idx, :]  # (10, ne, 3, 3)
    node_ids = elnodes.T.reshape(-1)
    nodal = jax.ops.segment_sum(
        diag.reshape(-1, 3, 3), node_ids, num_segments=nn
    )
    d3 = dvec.reshape(nn, 3)
    eye = jnp.eye(3, dtype=esm.dtype)
    nodal = nodal + eye[None] * d3[:, :, None]
    return inv3_spd(nodal)


def _assemble_penalty_csc(esm, eldofs, dvec, ndof):
    """Full (uneliminated) scipy CSC of the penalized stiffness: all element
    entries plus ``dvec`` on the diagonal.  Host direct tier of the
    penalty-BC buckling mode (reference analogue: ``fcVM.py:1207-1211``)."""
    import scipy.sparse as sp

    esm = np.asarray(esm)
    eldofs = np.asarray(eldofs)
    rows = np.repeat(eldofs, 30, axis=1).reshape(-1)
    cols = np.tile(eldofs, (1, 30)).reshape(-1)
    k = sp.coo_matrix((esm.reshape(-1), (rows, cols)), shape=(ndof, ndof))
    dvec = np.asarray(dvec)
    idx = np.arange(ndof)
    return (k + sp.coo_matrix((dvec, (idx, idx)), shape=(ndof, ndof))).tocsc()


def _penalty_operators(esm, nsm, eldofs, elnodes, fixmask, ndof, dtype, cfg,
                       rtol, maxiter, stall):
    """(kmv, minus_g, k_inverse) for the reference-parity penalty-BC pencil.

    Reproduces ``fcVM.py:1051-1062``: the FULL stiffness/geometric matrices
    (no Dirichlet elimination) with fixed K diagonals multiplied x100 and G
    unpenalized.  The committed corpus factors (e.g. Bar buckling
    [0.43472, 0.43473], ``output files/Bar buckling.out:5``) carry this
    penalty's ~3e-4 bias relative to exact elimination; this mode exists to
    match them at print precision (``config.buckling_bc = "penalty"``).
    Deflation recycling is skipped — the mode targets small parity meshes.
    """
    mvp = _multi_matvec_penalty(eldofs, ndof)
    diag = _assembled_diagonal(esm, eldofs, jnp.zeros(ndof, dtype=dtype))
    fixind = 1.0 - fixmask
    empty = (diag == 0).astype(dtype)  # dof-alignment padding rows
    dvec_k = 99.0 * diag * fixind + empty
    zero_d = jnp.zeros_like(dvec_k)
    nsm_neg = -nsm
    kmv = lambda u: mvp(esm, dvec_k, u)
    minus_g = lambda u: mvp(nsm_neg, zero_d, u)

    if cfg.solver == "scipy":
        from scipy.sparse.linalg import splu

        lu = splu(_assemble_penalty_csc(esm, eldofs, dvec_k, ndof))

        def k_inverse(w, x0_basis=None, x0_scale=None):
            # one device->host transfer for the whole block, then host
            # column slicing (a per-column np.asarray(w[:, i]) is a
            # separate device fetch each)
            wn = np.asarray(w)
            cols = [lu.solve(wn[:, i]) for i in range(wn.shape[1])]
            return jnp.asarray(np.stack(cols, axis=1), dtype=dtype)

    else:
        pinv = _penalty_block_jacobi(esm, elnodes, dvec_k)

        def _kinv(esm_a, pinv_a, dvec_a, w, x0_basis, x0_scale):
            def kv(u):
                ue = u[eldofs]
                fe = jnp.einsum("eij,ej->ei", esm_a, ue)
                y = jax.ops.segment_sum(
                    fe.reshape(-1), eldofs.reshape(-1), num_segments=ndof
                )
                return y + dvec_a * u

            prec = lambda r: asm.apply_block_precond(pinv_a, r)

            def solve_col(b, x0c):
                return slv.pcg(
                    kv, b, precond=prec, x0=x0c, rtol=rtol,
                    maxiter=maxiter, stall=stall,
                ).x

            if x0_basis is None:
                return jax.vmap(
                    lambda b: solve_col(b, None), in_axes=1, out_axes=1
                )(w)
            x0 = x0_basis * x0_scale[None, :]
            return jax.vmap(solve_col, in_axes=(1, 1), out_axes=1)(w, x0)

        _kinv_jit = jax.jit(_kinv)

        def k_inverse(w, x0_basis=None, x0_scale=None):
            xs = (None if x0_scale is None
                  else jnp.asarray(x0_scale, dtype=dtype))
            return _kinv_jit(esm, pinv, dvec_k, w, x0_basis, xs)

    return kmv, minus_g, k_inverse


def _multi_matvec(eldofs, fixmask, identity_on_fixed, negate=False,
                  plan=None):
    """Jitted ``(blocks, (ndof, m)) -> (ndof, m)`` block operator with
    Dirichlet projection — node-row gather + ScatterPlan reduction (the
    same shape as the sharded tier's ``multi_mv`` and
    ``ops.deflation.block_khat_matvec``: dof-granular indices would be 3x
    the node-row count).

    ``blocks`` is a jit ARGUMENT, not a closure: a closure would embed the
    600 MB element-block array of a 499k-dof mesh in the program as a
    constant, and the jitted whole-operator form costs one device dispatch
    instead of ~6 eager ops per application.  The einsum runs at HIGHEST
    precision: these operators feed the Rayleigh-Ritz projections and the
    pencil-residual validation, the same subspace-correction class as the
    deflation and coarse corrections."""
    nn = fixmask.shape[0] // 3
    elnodes = eldofs[:, ::3] // 3

    @jax.jit
    def mv(blocks, u):
        ne = blocks.shape[0]
        m = u.shape[1]
        up = fixmask[:, None] * u
        u3k = up.reshape(nn, 3, m)[elnodes]  # (ne, 10, 3, m) row gather
        fe = jnp.einsum(
            "eabj,ejm->eabm", blocks.reshape(ne, 10, 3, 30),
            u3k.reshape(ne, 30, m),
            precision=jax.lax.Precision.HIGHEST,
        )
        if plan is not None:
            out = asm.scatter_node_rows(fe.reshape(ne * 10, 3, m), plan)
        else:
            out = jax.ops.segment_sum(
                fe.reshape(ne * 10, 3, m), elnodes.reshape(-1),
                num_segments=nn,
            )
        y = fixmask[:, None] * out.reshape(nn * 3, m)
        if identity_on_fixed:
            y = y + (1.0 - fixmask)[:, None] * u
        return -y if negate else y

    return mv


def buckling_from_arrays(
    coords,
    elnodes,
    dmat,
    sig_gp,
    fixmask,
    k: int = 2,
    rtol: float = 1.0e-8,
    maxiter: int = 2000,
    n_sub: int = 0,
    outer_tol: float = 1.0e-9,
    max_outer: int = 60,
    plan=None,
    space=None,
    _dtype_override=None,
    _solver_override=None,
    allow_reassembly: bool = True,
):
    """Lowest ``k`` buckling factors + mode shapes.

    Args:
      sig_gp: (ne, 4, 6) the pre-stress field (elastic stresses under the
        full reference load, cf. ``fcVM.py:1195-1207``).
      space: optional :class:`fcvm_tpu.runtime.system.SolveSpace`; the whole
        eigensolve then runs in the Morton node numbering (compact
        preconditioner clusters), with mode shapes mapped back on return.
      allow_reassembly: whether the final retry tier (f64 re-assembly +
        host-direct splu) runs HERE.  The driver/backend path wants it
        (its ``sig_gp`` is collapse state this function cannot recompute);
        :func:`linear_buckling` passes False because it can do strictly
        better — rerun the whole pipeline, including the elastic
        pre-stress solve, in f64 (see below).
      _dtype_override: internal — the f64 breakdown retry (see below).

    f32 robustness — a three-tier retry ladder, each tier triggered by
    :class:`EigensolveBreakdownError` (non-finite projections, an
    indefinite Rayleigh-Ritz block, or the a-posteriori pencil-residual
    validation):

    1. f32 iteration on f32-assembled operands (the production tier);
    2. f64 iteration arithmetic on the SAME f32-assembled operands —
       restores positive-definiteness of the Rayleigh-Ritz projection
       when the projected small-eigenvalue block sits below the f32
       noise floor (seen on the Euler-column case on an accelerator);
    3. full f64 re-assembly + exact host splu ``K^{-1}`` (the
       reference's own pipeline, ``fcVM.py:1111-1135, 1263-1278``) —
       for extreme-slenderness pencils where the f32-built operands
       themselves destroy the small buckling eigenvalues (measured on
       the corpus "Bar buckling", cond ~1e10: even exact solves on f32
       operands return factors 6.03/6.31 vs committed 0.4347).  Note the
       pre-stress ``sig_gp`` is NOT recomputed here — factors come back
       at the accuracy of the caller's stress field.

    This covers the production driver's buckling/imperfection path
    (`runtime/backend.py:buckling`) as well as :func:`linear_buckling`
    (which replaces tier 3 with a full-pipeline f64 rerun).  The sharded
    backend tries its SPMD :func:`pencil_subspace` first and falls back
    HERE on an f32 breakdown (the eigensolve runs once per analysis, so
    robustness beats SPMD for the retry; ``parallel/system.py:buckling``).

    Returns:
      (eigenvalues (k,), eigenvectors (ndof, k)) as numpy arrays, sorted by
      ascending buckling factor.
    """
    import scipy.linalg

    cfg = get_config()
    m = n_sub if n_sub > 0 else max(cfg.n_eig_vectors, 2 * k, k + 4)
    ndof = fixmask.shape[0]
    dtype = _dtype_override if _dtype_override is not None else coords.dtype
    # the breakdown-retry ladder may override the solver tier (f32 PCG ->
    # f64-iteration PCG -> f64 re-assembly + host-direct splu); cfg stays
    # untouched.  Re-assembly is possible while the operands are still
    # f32-built and the mesh is host-factorizable.
    solver = _solver_override or cfg.solver
    f32_built = np.dtype(jnp.asarray(coords).dtype) == np.float32
    can_reassemble = (
        allow_reassembly
        and f32_built
        and fixmask.shape[0] <= _DIRECT_FAILOVER_MAX_DOF
    )
    # allow_reassembly=False promises the CALLER catches the breakdown and
    # reruns its whole pipeline in f64 — keep raising as long as the
    # operands say we are still inside the original f32 pipeline.
    caller_escalates = (not allow_reassembly) and f32_built
    # originals for the breakdown retry (the space branch rebinds these)
    elnodes_in, fixmask_in, plan_in = elnodes, fixmask, plan
    # The eigensolve wants "as accurate as the arithmetic allows" (rtol
    # 1e-10 is below the f32 residual floor), so the inner solves use the
    # PCG stagnation exit instead of a floored tolerance: each solve runs
    # to its own floor and stops ~STALL iterations later.  A fixed 50-eps
    # rtol floor was tried first and measured 8% eigenvalue error on the
    # Euler-column f32 example (the true f32 floor gives ~1%); without
    # either, every f32 inner solve burns maxiter.
    stall = 100

    penalty = cfg.buckling_bc == "penalty"
    if penalty:
        # Reference-parity penalty BC runs in the natural dof ordering on
        # the full (uneliminated) pencil; the Morton solve space and the
        # scatter plan are elimination-path machinery.
        space = None
        plan = None

    esm = asm.elastic_stiffness_blocks(coords, elnodes, dmat)
    nsm = asm.geometric_stiffness_blocks(coords, elnodes, sig_gp)
    coords_work = coords
    if space is not None:
        esm = esm[space.eperm]
        nsm = nsm[space.eperm]
        elnodes = space.elnodes_m
        fixmask = space.fixmask_m
        plan = space.plan_m
        coords_work = space.coords_m.astype(dtype)
    eldofs = asm.element_dof_ids(elnodes)
    if esm.dtype != dtype:
        # breakdown retry: f32-assembled operands, f64 iteration arithmetic
        esm = esm.astype(dtype)
        nsm = nsm.astype(dtype)
        fixmask = fixmask.astype(dtype)
        coords_work = coords_work.astype(dtype)

    if penalty:
        kmv, minus_g, k_inverse = _penalty_operators(
            esm, nsm, eldofs, elnodes, fixmask, ndof, dtype, cfg,
            rtol, maxiter, stall,
        )
        try:
            lam, vecs = pencil_subspace(
                kmv, minus_g, k_inverse, ndof, dtype, k, m, outer_tol,
                max_outer, fixmask=None,
                # the penalty parity mode has no direct-tier retry wiring
                # of its own: f64 is its last tier unless the caller
                # escalates the whole pipeline
                last_tier=not (dtype == jnp.float32 or caller_escalates),
            )
        except EigensolveBreakdownError:
            if dtype != jnp.float32:
                raise
            import warnings

            warnings.warn(
                "f32 penalty-BC buckling eigensolve broke down; retrying "
                "the iteration in float64 on the f32-assembled operands"
            )
            if cfg.dtype is None:
                cfg.dtype = "float32"
            x64_prev = jax.config.read("jax_enable_x64")
            jax.config.update("jax_enable_x64", True)
            try:
                return buckling_from_arrays(
                    coords, elnodes_in, dmat, sig_gp, fixmask_in, k=k,
                    rtol=rtol, maxiter=maxiter, n_sub=n_sub,
                    outer_tol=outer_tol, max_outer=max_outer, plan=plan_in,
                    space=None, _dtype_override=jnp.float64,
                    allow_reassembly=allow_reassembly,
                )
            finally:
                if not x64_prev:
                    jax.config.update("jax_enable_x64", False)
        return lam, vecs

    _kmv = _multi_matvec(eldofs, fixmask, identity_on_fixed=True, plan=plan)
    _mg = _multi_matvec(eldofs, fixmask, identity_on_fixed=False, negate=True,
                        plan=plan)
    kmv = lambda u: _kmv(esm, u)
    minus_g = lambda u: _mg(nsm, u)

    from fcvm_tpu.ops.precond import apply_precond, build_two_level

    if solver != "scipy" and cfg.precond == "two_level":
        pc = build_two_level(
            esm, elnodes, coords_work, fixmask,
            cluster_size=cfg.resolve_cluster_size(coords.shape[0]),
            n_modes=cfg.coarse_modes,
        )
    elif solver != "scipy":
        pc = asm.block_jacobi_inverse_blocks(esm, elnodes, fixmask)
    else:
        pc = None  # direct tier: no iterative preconditioner needed
    if solver == "scipy":
        # Host direct tier (the reference's Cholesky analogue,
        # ``fcVM.py:1263-1278``): exact K^{-1} makes the subspace iteration
        # robust on ill-conditioned (slender) structures where PCG would
        # need a very deep iteration to reach eigensolve accuracy.
        direct = slv.ScipyDirectSolver(esm, eldofs, fixmask, ndof)

        def k_inverse(w, x0_basis=None, x0_scale=None):
            # exact solve: the Ritz warm start has nothing to seed.
            # One device->host transfer for the block, then host slicing
            # (per-column fetches are a device round-trip each).
            wn = np.asarray(w)
            cols = [direct.solve(wn[:, i]) for i in range(wn.shape[1])]
            return jnp.stack(cols, axis=1).astype(dtype)

    else:
        # Ritz-deflation recycling (ops.deflation): the subspace iteration
        # re-solves the SAME K_hat for m columns x up to max_outer sweeps at
        # a much tighter rtol than the nonlinear driver, and its rhs
        # converge toward the lowest pencil modes — exactly the slow band a
        # Lanczos harvest of the first column captures.  One harvest (first
        # column, first sweep) deflates every subsequent solve; the operator
        # never changes, so no re-Galerkin is needed.  The harvest must go
        # much DEEPER than the nonlinear driver's (a 64-slot prefix of a
        # 1000+-iteration solve is a net loss — measured): 512 slots / k=64
        # measured 1.9x end-to-end on a 20:1 clamped-free column (CPU f64,
        # rtol 1e-10), identical eigenvalues.
        from fcvm_tpu.ops import deflation as defl_ops

        nstore, k_defl = _recycling_params(cfg, ndof, jnp.dtype(dtype).itemsize)

        # esm/pc enter every jit as ARGUMENTS (never closures: the element
        # blocks and the dense coarse inverse are each ~600 MB at 499k dof,
        # which a closure would embed in the program as constants)
        def _kinv(esm_a, pc_a, w, defl, x0_basis, x0_scale):
            kv = asm.make_bc_matvec(esm_a, eldofs, fixmask, plan)
            prec = defl_ops.deflated(lambda r: apply_precond(pc_a, r), defl)

            def solve_col(b, x0c):
                return slv.pcg(
                    kv, b, precond=prec, x0=x0c, rtol=rtol,
                    maxiter=maxiter, stall=stall,
                ).x

            if x0_basis is None:
                return jax.vmap(
                    lambda b: solve_col(b, None), in_axes=1, out_axes=1
                )(w)
            x0 = x0_basis * x0_scale[None, :]
            return jax.vmap(solve_col, in_axes=(1, 1), out_axes=1)(w, x0)

        _kinv_jit = jax.jit(_kinv)

        def _harvest(esm_a, pc_a, b):
            kv = asm.make_bc_matvec(esm_a, eldofs, fixmask, plan)
            return slv.pcg_harvest(
                kv, b, precond=lambda r: apply_precond(pc_a, r), rtol=rtol,
                maxiter=maxiter, nstore=nstore, stall=stall,
            )

        _harvest_jit = jax.jit(_harvest)

        k_inverse = make_recycled_k_inverse(
            lambda w, defl, xb, xs: _kinv_jit(esm, pc, w, defl, xb, xs),
            lambda b: _harvest_jit(esm, pc, b),
            # fused build, one device dispatch (jit: eager multi-op code
            # dispatches once per op)
            lambda zs, coef: jax.jit(defl_ops.build_space)(
                esm, eldofs, fixmask, plan, zs, coef
            ),
            k_defl, cfg.deflation_min_iters, cfg.deflation,
        )

    try:
        lam, vecs = pencil_subspace(
            kmv, minus_g, k_inverse, ndof, dtype, k, m, outer_tol, max_outer,
            fixmask=fixmask,
            last_tier=not (
                dtype == jnp.float32 or can_reassemble or caller_escalates
            ),
        )
    except EigensolveBreakdownError as err:
        import warnings

        if dtype == jnp.float32:
            warnings.warn(
                f"f32 buckling eigensolve broke down ({err}); retrying the "
                "iteration in float64 on the f32-assembled operands"
            )
            if cfg.dtype is None:
                # pin the implicit f32 so enabling x64 below cannot flip a
                # later dtype-unspecified analysis in this process to f64
                cfg.dtype = "float32"
            x64_prev = jax.config.read("jax_enable_x64")
            jax.config.update("jax_enable_x64", True)
            try:
                # the retry returns numpy arrays, so all f64 device work is
                # complete before the flag is restored below
                return buckling_from_arrays(
                    coords, elnodes_in, dmat, sig_gp, fixmask_in, k=k,
                    rtol=rtol, maxiter=maxiter, n_sub=n_sub,
                    outer_tol=outer_tol, max_outer=max_outer, plan=plan_in,
                    space=space, _dtype_override=jnp.float64,
                    _solver_override=_solver_override,
                    allow_reassembly=allow_reassembly,
                )
            finally:
                if not x64_prev:
                    # restore so later dtype-unspecified conversions in the
                    # same process (e.g. the continuing collapse driver)
                    # stay 32-bit
                    jax.config.update("jax_enable_x64", False)
        elif can_reassemble:
            # f64 iteration arithmetic on f32-built operands still fails:
            # the OPERANDS are the accuracy limit (extreme slenderness —
            # corpus "Bar buckling", cond ~1e10; see
            # _DIRECT_FAILOVER_MAX_DOF).  Final tier: re-assemble the
            # pencil in float64 and solve with the exact host splu K^{-1}
            # — the reference's own pipeline.
            warnings.warn(
                f"f64 iterative buckling eigensolve still invalid ({err}); "
                "re-assembling the pencil in float64 on the host-direct "
                "tier (exact splu K^-1)"
            )
            return buckling_from_arrays(
                jnp.asarray(coords, jnp.float64), elnodes_in,
                jnp.asarray(dmat, jnp.float64),
                jnp.asarray(sig_gp, jnp.float64),
                fixmask_in, k=k, rtol=rtol,
                maxiter=maxiter, n_sub=n_sub, outer_tol=outer_tol,
                max_outer=max_outer, plan=plan_in, space=space,
                _dtype_override=jnp.float64, _solver_override="scipy",
            )
        else:
            raise
    if space is not None:
        vecs = vecs.reshape(-1, 3, k)[np.asarray(space.npos)].reshape(-1, k)
    return lam, vecs


def pencil_subspace(
    kmv, minus_g, k_inverse, ndof, dtype, k, m, outer_tol=1.0e-9,
    max_outer=60, fixmask=None, last_tier=False,
):
    """Block subspace iteration with Rayleigh-Ritz on the (K, -G) pencil.

    Operator-parametrized so it drives the single-device multi-matvecs and
    the sharded (shard_map + psum) ones identically; all small dense math
    (QR, projected eigensolve) is host-side.
    """
    import scipy.linalg

    # NOTE: outer_tol is deliberately NOT floored by dtype.  The criterion
    # is a Cauchy test on theta; for slowly-contracting spectra (slender
    # columns, clustered modes) the per-sweep change can sit below 50 eps
    # while the eigenvalue error is still percent-level (measured: flooring
    # it cost 8% on the Euler-column f32 example).  At f32 the loop then
    # runs all max_outer sweeps — cheap, because the Ritz warm start makes
    # converged columns re-solve in a handful of iterations.
    key = jax.random.PRNGKey(0)
    v = jax.random.normal(key, (ndof, m), dtype=dtype)
    if fixmask is not None:
        v = fixmask[:, None] * v

    theta_old = None
    theta_full = None
    for _ in range(max_outer):
        # Ritz warm start: after Rayleigh-Ritz, K^-1 (-G) v_i ~ theta_i v_i
        # (theta are the pencil Ritz values from the previous sweep), so
        # theta_i * v_i seeds each column solve almost exactly once the
        # subspace converges — later sweeps' inner solves collapse to a
        # few iterations (measured 1.7x alone, ~3.1x with the deflation).
        # Passed as (basis, scale) so the product is formed inside the
        # solver jit, not as an eager per-sweep device op.
        if theta_full is None:
            z = k_inverse(minus_g(v))
        else:
            z = k_inverse(minus_g(v), x0_basis=v,
                          x0_scale=jnp.asarray(theta_full, dtype=dtype))
        # Euclidean orthonormalization keeps the Rayleigh-Ritz projection
        # well conditioned once columns align with the dominant eigenspace.
        # f32: on-device tall-skinny QR — the host version round-trips an
        # (ndof, m) block every sweep.  f64 stays on host (the tier is for
        # small, ill-conditioned pencils; a device f64 QR is an open H100
        # A/B).
        if dtype == jnp.float32:
            q = _qr_q(z)
        else:
            q = jnp.asarray(np.linalg.qr(np.asarray(z))[0], dtype=dtype)
        # one device_get for both (m, m) projections; the operator applies
        # are single jitted dispatches (blocks passed as args)
        a_small, b_small = jax.device_get(
            (_proj(q, minus_g(q)), _proj(q, kmv(q)))
        )
        a_small = np.asarray(a_small)
        b_small = np.asarray(b_small)
        if not (np.isfinite(a_small).all() and np.isfinite(b_small).all()):
            raise EigensolveBreakdownError(
                "non-finite Rayleigh-Ritz projection (a diverged inner "
                f"solve poisoned the subspace block) at dtype {dtype}"
            )
        b_small = 0.5 * (b_small + b_small.T)
        a_small = 0.5 * (a_small + a_small.T)
        # Residual f32 rounding (the big K q matvec stays at production
        # precision) can still leave B = Q^T K Q marginally indefinite;
        # escalate a relative ridge rather than crash — the ridge only
        # biases the Ritz values by O(ridge/diag), far below the f32
        # eigenvalue noise floor that made it necessary.
        scale = max(float(np.mean(np.abs(np.diag(b_small)))), 1e-300)
        for ridge in (0.0, 1e-6, 1e-4, 1e-2):
            try:
                theta, c = scipy.linalg.eigh(
                    a_small, b_small + (ridge * scale) * np.eye(len(b_small))
                )
                break
            except np.linalg.LinAlgError as err:
                if ridge == 1e-2:
                    raise EigensolveBreakdownError(
                        "projected Q^T K Q stayed indefinite through the "
                        f"ridge ladder at dtype {dtype}: {err}"
                    ) from err
        order = np.argsort(theta)[::-1]
        theta = theta[order]
        c = c[:, order]
        v = _mix(q, jnp.asarray(c, dtype=dtype))
        theta_full = theta
        if theta_old is not None:
            denom = np.maximum(np.abs(theta[:k]), 1e-300)
            if np.max(np.abs(theta[:k] - theta_old[:k]) / denom) < outer_tol:
                break
        theta_old = theta

    lam = 1.0 / theta[:k]
    vecs = np.array(v[:, :k])
    # A-posteriori pencil-residual validation: ||K v - lam (-G) v|| /
    # ||K v|| per retained pair.  The Cauchy test on theta only proves the
    # SUBSPACE stopped moving — when f32 inner solves stall at their
    # arithmetic floor, the iteration can converge (finitely!) onto a
    # non-eigenpair.  Measured on the slender imperfect-column case: the
    # f32 tier's inner solves used to DIVERGE (caught by the non-finite
    # check above); after the preconditioner precision fixes they
    # fail gracefully instead, and the sweep settled on factors 51.9/69.3
    # vs the true 2.23/2.24 with O(1) residuals.  A converged pair sits
    # orders of magnitude lower (see _PENCIL_RESIDUAL_TOL).
    kv_chk = np.asarray(kmv(jnp.asarray(vecs, dtype=dtype)))
    gv_chk = np.asarray(minus_g(jnp.asarray(vecs, dtype=dtype)))
    num = np.linalg.norm(kv_chk - gv_chk * lam[None, :], axis=0)
    den = np.maximum(np.linalg.norm(kv_chk, axis=0), 1e-300)
    rel_res = num / den
    if os.environ.get("FCVM_DEBUG_PENCIL_RESIDUAL"):
        print(f"pencil residuals ({np.dtype(dtype).name}): {rel_res}",
              flush=True)
    if np.max(rel_res) > _PENCIL_RESIDUAL_TOL:
        msg = (f"pencil residual validation failed at dtype {dtype}: "
               f"max ||Kv - lam(-G)v||/||Kv|| = {np.max(rel_res):.2e} "
               f"(factors {lam}) — the subspace converged onto a "
               "non-eigenpair (inner solves at their arithmetic floor)")
        if not last_tier:
            raise EigensolveBreakdownError(msg)
        import warnings

        warnings.warn(msg)  # no further tier to retry in
    # (-G)-metric normalization (matches ARPACK M-normalization);
    # reuses the validation pass's (-G) V product.
    gv = gv_chk
    for i in range(k):
        s = float(vecs[:, i] @ gv[:, i])
        if s > 0:
            vecs[:, i] /= np.sqrt(s)
        imax = int(np.argmax(np.abs(vecs[:, i])))
        if vecs[imax, i] < 0:
            vecs[:, i] = -vecs[:, i]
    return np.asarray(lam), vecs


def linear_buckling(model, params, k: int = 2):
    """Buckling factors/modes of a :class:`fcvm_tpu.models.spec.Model`.

    Runs the reference's pre-stress pipeline: elastic solve under the full
    load, elastic stress recovery, then the pencil eigensolve.

    f32 robustness: on slender ill-conditioned pencils the f32 inner
    solves can diverge past the stagnation exit and poison the subspace
    block (seen on the Euler-column example on an accelerator).  When the
    eigensolve breaks down at f32 (including the f64-iteration retry on
    f32 operands inside :func:`buckling_from_arrays`), the whole
    pipeline is retried once in float64 — crucially INCLUDING the
    elastic pre-stress solve: on the corpus "Bar buckling" pencil
    (cond ~1e10) the f32 PCG displacement error is percent-level in the
    energy norm, and re-assembling K alone left ~1% factor error with
    the near-degenerate pair split 3% (the committed
    pair [0.43472, 0.43473] agrees to 3e-4 only with an exact f64
    pre-stress).  For host-factorizable meshes the retry also escalates
    the solver to the exact host-direct tier (the reference's own
    pipeline, ``fcVM.py:1111-1135, 1263-1278``); above that bound it
    stays on f64 PCG (native f64 on the H100).  The process dtype is
    pinned first so enabling x64 for the retry cannot flip a later f32
    analysis to f64.
    """
    import warnings

    cfg = get_config()
    try:
        return _linear_buckling_impl(model, params, k)
    except EigensolveBreakdownError as err:
        if cfg.resolve_dtype() != jnp.float32:
            raise
        direct = (
            cfg.solver != "scipy"
            and model.mesh.ndof <= _DIRECT_FAILOVER_MAX_DOF
        )
        warnings.warn(
            f"f32 buckling eigensolve broke down ({err}); "
            "retrying the pipeline in float64"
            + (" on the host-direct solver tier" if direct else "")
        )
        prev_dtype = cfg.dtype if cfg.dtype is not None else "float32"
        prev_solver = cfg.solver
        x64_prev = jax.config.read("jax_enable_x64")
        jax.config.update("jax_enable_x64", True)
        cfg.dtype = "float64"
        if direct:
            cfg.solver = "scipy"
        try:
            # returns numpy arrays: all f64 device work completes in here
            lam, vecs = _linear_buckling_impl(model, params, k)
        finally:
            cfg.dtype = prev_dtype
            cfg.solver = prev_solver
            if not x64_prev:
                jax.config.update("jax_enable_x64", False)
        return lam, vecs


def _linear_buckling_impl(model, params, k: int = 2):
    from fcvm_tpu.ops.stress_update import update_stress_load
    from fcvm_tpu.runtime import system as sysm
    from fcvm_tpu.utils.indexing import pad_ndof, pad_vector

    cfg = get_config()
    from fcvm_tpu.config import enable_compilation_cache

    enable_compilation_cache()
    model.mesh.validate()  # fail fast, not deep inside a jit
    dtype = cfg.resolve_dtype()
    mesh = model.mesh
    coords = jnp.asarray(mesh.coords, dtype=dtype)
    elnodes = jnp.asarray(mesh.elnodes, dtype=jnp.int32)
    e = jnp.asarray(model.material.e, dtype=dtype)
    nu = jnp.asarray(model.material.nu, dtype=dtype)
    dmat = mat.hooke_dmat(e, nu)
    fixmask_np, u_fix_np, _ = model.bcs.masks(mesh.ndof)
    ndof_pad = pad_ndof(mesh.ndof)
    fixmask = jnp.asarray(pad_vector(fixmask_np, ndof_pad), dtype=dtype)
    u_fix = jnp.asarray(pad_vector(u_fix_np, ndof_pad), dtype=dtype)
    loads = sysm.LoadTables.from_spec(model.loads, dtype)
    density = jnp.asarray(model.material.density, dtype=dtype)

    esm, pinv, glv, rhs, _, _, _ = sysm.assemble_elastic(
        coords, elnodes, dmat, loads, density, fixmask, u_fix
    )
    plan = asm.build_scatter_plan(mesh.elnodes, ndof_pad // 3)
    space = sysm.build_solve_space(mesh.coords, mesh.elnodes, fixmask, ndof_pad)
    if cfg.solver == "scipy":
        pc = None  # direct tier below; no iterative preconditioner needed
    elif cfg.precond == "two_level":
        pc = sysm.build_precond(
            esm, elnodes, coords, fixmask,
            cfg.resolve_cluster_size(mesh.n_nodes), space=space,
        )
    else:
        pc = pinv[space.nperm]
    maxiter = cfg.resolve_cg_maxiter(mesh.ndof)
    if cfg.solver == "scipy":
        from fcvm_tpu.ops import solver as slv_mod

        direct = slv_mod.ScipyDirectSolver(
            esm, asm.element_dof_ids(elnodes), fixmask, ndof_pad
        )
        ue = jnp.asarray(direct.solve(rhs), dtype=dtype)
    else:
        ue = sysm.solve_displacement(
            esm, elnodes, fixmask, pc, rhs, cfg.cg_rtol, maxiter, plan=plan,
            space=space,
        ).x

    ne = mesh.n_elements
    zeros_gp6 = jnp.zeros((ne, 4, 6), dtype=dtype)
    huge_yield = jnp.full((ne, 4), 1.0e30, dtype=dtype)
    sig_el, _, _, _ = update_stress_load(
        coords, elnodes, dmat, huge_yield, jnp.zeros(ndof_pad, dtype=dtype),
        ue, zeros_gp6, e, nu, jnp.asarray(0.0, dtype=dtype), False,
    )
    lam, vecs = buckling_from_arrays(
        coords, elnodes, dmat, sig_el, fixmask,
        k=k, rtol=min(cfg.cg_rtol, 1.0e-10), maxiter=maxiter, plan=plan,
        space=space,
        # tier 3 (f64 re-assembly) would keep THIS frame's f32 pre-stress;
        # linear_buckling's own failover reruns the whole pipeline in f64
        # instead, which is strictly more accurate
        allow_reassembly=False,
    )
    return lam, vecs[: mesh.ndof]
