"""System backends: the compute engine behind the collapse driver.

The driver (:mod:`fcvm_tpu.runtime.driver`) owns only host control flow —
load stepping, restarts, adaptive scaling, history.  Every array operation
goes through a *backend* object with one of two implementations:

* :class:`LocalSystem` — single-device, wrapping the jitted composites of
  :mod:`fcvm_tpu.runtime.system` (Morton solve space, ScatterPlan).
* :class:`fcvm_tpu.parallel.system.ShardedSystem` — the same operations
  SPMD over a ``jax.sharding.Mesh`` element partition (``shard_map`` +
  one ``psum`` per operator application).

The split is what makes multi-chip a production path rather than a demo:
`solve_collapse` runs the *identical* Riks/restart logic over either
backend (cf. the reference's single solver loop, ``fcVM.py:1304-1557``).

Backend data contract:

* Node-space vectors (disp, du, loads, residuals) are in **user dof order**
  (padded to the 384 alignment), whichever backend.
* Gauss-state arrays (stress, PEEQ, CSR, yield) are in **backend order**:
  user element order for :class:`LocalSystem`, Morton element order (padded
  to the shard multiple) for the sharded backend.  ``gauss_to_user`` /
  ``user_to_gauss`` convert; the driver converts exactly at history
  recording, checkpointing and results boundaries.
"""

from __future__ import annotations

import jax.numpy as jnp

from fcvm_tpu.ops import assembly as asm
from fcvm_tpu.ops import material as mat
from fcvm_tpu.ops.stress_update import internal_force_from_stress, update_stress_load
from fcvm_tpu.runtime import system as sysm
from fcvm_tpu.utils.indexing import pad_ndof, pad_vector


class LocalSystem:
    """Single-device backend over the jitted composites of ``runtime.system``."""

    supports_scipy = True
    supports_deflation = True
    # The AOT prewarm compiles the LOCAL build executables (unpadded
    # element counts, non-shard_map kernels); ShardedSystem overrides this
    # to False — prewarming programs its build never calls would only
    # compete with the real first sharded build for the compiler.
    prewarm_matches_build = True

    def __init__(self, model, cfg, dtype):
        self.cfg = cfg
        self.dtype = dtype
        mesh = model.mesh
        self.mesh = mesh
        self.ne = mesh.n_elements
        self.ndof = mesh.ndof
        self.ndof_pad = pad_ndof(mesh.ndof)
        from fcvm_tpu.runtime.prewarm import start_precond_prewarm

        if (
            cfg.precond == "two_level"
            and getattr(cfg, "prewarm", True)
            and self.prewarm_matches_build
        ):
            # compile the preconditioner-build executables in the
            # background (AOT, no device memory) so the cold compiles
            # overlap the setup and the first assembly instead of
            # serializing inside the first build_precond call
            self.prewarm_thread = start_precond_prewarm(
                mesh.n_nodes, mesh.n_elements, self.ndof_pad,
                cfg.resolve_cluster_size(mesh.n_nodes), cfg.coarse_modes,
                dtype,
            )

        if model.materials_by_element is not None:
            mbe = model.materials_by_element
            self.e = jnp.asarray(mbe[:, 0], dtype=dtype)
            self.nu = jnp.asarray(mbe[:, 1], dtype=dtype)
            self.density = jnp.asarray(mbe[:, 2], dtype=dtype)
        else:
            self.e = jnp.asarray(model.material.e, dtype=dtype)
            self.nu = jnp.asarray(model.material.nu, dtype=dtype)
            self.density = jnp.asarray(model.material.density, dtype=dtype)
        self.dmat = mat.hooke_dmat(self.e, self.nu)
        self.g = mat.shear_modulus(self.e, self.nu)
        # per-gauss-point broadcast shapes for the damage update
        self.e_gp = self.e[:, None] if self.e.ndim == 1 else self.e
        self.nu_gp = self.nu[:, None] if self.nu.ndim == 1 else self.nu

        self.elnodes = jnp.asarray(mesh.elnodes, dtype=jnp.int32)
        fixmask_np, u_fix_np, movdof_np = model.bcs.masks(mesh.ndof)
        self.fixmask = jnp.asarray(pad_vector(fixmask_np, self.ndof_pad), dtype=dtype)
        self.u_fix = jnp.asarray(pad_vector(u_fix_np, self.ndof_pad), dtype=dtype)
        self.movdof = jnp.asarray(pad_vector(movdof_np, self.ndof_pad), dtype=dtype)
        self.has_movdof = bool(movdof_np.max() > 0.5)
        self.loads = sysm.LoadTables.from_spec(model.loads, dtype)
        self.plan = asm.build_scatter_plan(mesh.elnodes, self.ndof_pad // 3)
        self.space = sysm.build_solve_space(
            mesh.coords, mesh.elnodes, self.fixmask, self.ndof_pad
        )
        self.rtol = cfg.cg_rtol
        self.maxiter = cfg.resolve_cg_maxiter(mesh.ndof)

    # -- Gauss-state helpers -------------------------------------------------

    def gauss_zeros(self, trailing=()):
        return jnp.zeros((self.ne, 4) + tuple(trailing), dtype=self.dtype)

    def gauss_full(self, value):
        return jnp.full((self.ne, 4), value, dtype=self.dtype)

    def gauss_false(self):
        return jnp.zeros((self.ne, 4), dtype=bool)

    def gauss_to_user(self, a):
        return a

    def user_to_gauss(self, a):
        return jnp.asarray(a, dtype=a.dtype if hasattr(a, "dtype") else None)

    # -- composites ----------------------------------------------------------

    def assemble(self, coords):
        return sysm.assemble_elastic(
            jnp.asarray(coords, dtype=self.dtype), self.elnodes, self.dmat,
            self.loads, self.density, self.fixmask, self.u_fix, self.plan,
        )

    def make_pc(self, esm, pinv, coords_dev):
        if self.cfg.precond == "two_level":
            return sysm.build_precond(
                esm, self.elnodes, coords_dev, self.fixmask,
                self.cfg.resolve_cluster_size(self.mesh.n_nodes),
                space=self.space,
            )
        # block-Jacobi tier: permute the nodal blocks into the solve space
        return pinv[self.space.nperm]

    def solve(self, esm, pc, b, x0=None, defl=None, hp=False):
        return sysm.solve_displacement(
            esm, self.elnodes, self.fixmask, pc, b, self.rtol, self.maxiter,
            x0=x0, plan=self.plan, space=self.space, defl=defl, hp=hp,
        )

    # -- Ritz-deflation recycling (fcvm_tpu.ops.deflation) -------------------

    def solve_harvest(self, esm, pc, b, x0=None, defl=None, nstore=64,
                      hp=False):
        return sysm.solve_displacement_harvest(
            esm, self.elnodes, self.fixmask, pc, b, self.rtol, self.maxiter,
            x0=x0, plan=self.plan, space=self.space, defl=defl, nstore=nstore,
            hp=hp,
        )

    def build_deflation(self, esm, zs, coef):
        """Z,coef -> DeflationSpace, one fused device dispatch."""
        return sysm.build_deflation(esm, self.elnodes, self.fixmask, zs,
                                    jnp.asarray(coef), plan=self.plan,
                                    space=self.space)

    def make_deflation(self, esm, w):
        """Re-Galerkin an existing basis on a (refreshed) operator."""
        return sysm.regalerkin_deflation(esm, self.elnodes, self.fixmask, w,
                                         plan=self.plan, space=self.space)

    def deflation_basis(self, zs, coef):
        """Harvest data -> solve-space (ndof, k) Ritz basis only (no
        Galerkin): for spaces re-Galerkined later against other operators,
        e.g. the tangent-predictor's load space."""
        from fcvm_tpu.ops.deflation import build_w

        return build_w(zs, jnp.asarray(coef), self.space.fixmask_m)

    def residual(self, coords, sig_yield, disp_new, du, sig_old, glv,
                 lbd1, qnorm, et_e, large_disp, relax=1.0):
        return sysm.residual(
            coords, self.elnodes, self.dmat, sig_yield, disp_new, du, sig_old,
            self.e, self.nu, et_e, glv, self.fixmask,
            jnp.asarray(lbd1, dtype=self.dtype),
            jnp.asarray(qnorm, dtype=self.dtype), large_disp, self.plan,
            relax=jnp.asarray(relax, dtype=self.dtype),
        )

    def residual_refined(self, coords, sig_yield, disp_new, du, sig_old,
                         glv, lbd1, qnorm, et_e, large_disp, relax=1.0):
        """f64-evaluated residual over f32 state (the mixed-precision
        refinement tier, :func:`fcvm_tpu.runtime.system.residual_refined`;
        the driver enables x64 before the first call)."""
        f64 = jnp.float64
        return sysm.residual_refined(
            coords, self.elnodes, self.dmat, sig_yield, disp_new, du,
            sig_old, self.e, self.nu, et_e, glv, self.fixmask,
            jnp.asarray(lbd1, f64), jnp.asarray(qnorm, f64), large_disp,
            self.plan, relax=jnp.asarray(relax, f64),
        )

    def tangent_refresh(self, coords, sig_old, pgp, disp_new, du, pc, et_e,
                        ue0=None, w=None, solve_predictor=True, hp=False):
        h = mat.hardening_modulus(self.e, jnp.asarray(et_e, self.dtype))
        return sysm.tangent_refresh(
            coords, self.elnodes, self.dmat, sig_old, pgp, disp_new, du,
            self.loads, self.density, self.fixmask, self.u_fix, self.g, h,
            self.rtol, self.maxiter, pc=pc, plan=self.plan, space=self.space,
            ue0=ue0, w=w, solve_predictor=solve_predictor, hp=hp,
        )

    # -- fused Newton iteration (one dispatch per NR iteration) --------------

    supports_fused_newton = True

    def newton_iteration(self, coords, sig_yield, disp_new, du, sig_old,
                         glv, lbd0, lbd1, qnorm, a, ue, r, et_e, esm, pc,
                         refresh, large_disp, defl=None,
                         relax=1.0, crisfield=False, hp=False):
        """One fused NR iteration (see
        :func:`fcvm_tpu.runtime.system.newton_iteration`).  ``refresh`` is
        the host-decided static tangent-refresh flag (``iterat == 1 or
        any(pgp)``, from the previous iteration's fetched ``any_pgp``);
        on a refresh iteration the caller has already dispatched
        :meth:`tangent_refresh` and passes its (still in-flight) outputs
        as ``esm``/``pc``/``glv``/``ue``."""
        return sysm.newton_iteration(
            coords, self.elnodes, self.dmat, sig_yield, disp_new, du,
            sig_old, self.e, self.nu, jnp.asarray(et_e, self.dtype), glv,
            self.fixmask,
            jnp.asarray(lbd0, self.dtype), jnp.asarray(lbd1, self.dtype),
            jnp.asarray(qnorm, self.dtype), a, ue, r, esm, pc,
            self.rtol, self.maxiter, large_disp, bool(refresh),
            plan=self.plan, space=self.space, defl=defl,
            relax=jnp.asarray(relax, self.dtype),
            crisfield=crisfield, hp=hp,
        )

    def stress_update(self, coords, sig_yield, disp, du, sig_old, et_e,
                      large_disp):
        return update_stress_load(
            coords, self.elnodes, self.dmat, sig_yield, disp, du, sig_old,
            self.e, self.nu, et_e, large_disp, self.plan,
        )

    def internal_force(self, coords, sig_gp, disp, large_disp):
        return internal_force_from_stress(
            coords, self.elnodes, sig_gp, disp, large_disp
        )

    def buckling(self, coords, sig_el_gp, k=2):
        """Lowest-k buckling factors + mode shapes (user dof order).

        ``sig_el_gp`` is the elastic pre-stress field in backend Gauss
        order (user order here)."""
        from fcvm_tpu.runtime.buckling import buckling_from_arrays

        return buckling_from_arrays(
            coords, self.elnodes, self.dmat, sig_el_gp, self.fixmask,
            k=k, rtol=min(self.rtol, 1.0e-10), maxiter=self.maxiter,
            plan=self.plan, space=self.space,
        )

    def update_peeq_csr(self, sig_test, sig_new, sig_yield, peeq, csr, et_e,
                        ultimate_strain):
        return mat.update_peeq_csr(
            sig_test, sig_new, sig_yield, peeq, csr, self.e_gp, self.nu_gp,
            et_e, ultimate_strain,
        )

    def record_stats(self, disp_new, csr, peeq, pressure, svm, triax, ecr):
        """Converged-step history scalars on device (see
        :func:`fcvm_tpu.runtime.system.record_step_stats`); Gauss fields
        are already in user order on this backend."""
        return sysm.record_step_stats(
            disp_new, csr, peeq, pressure, svm, triax, ecr
        )

    # scipy direct tier (LocalSystem only)
    def scipy_direct(self, esm):
        from fcvm_tpu.ops.solver import ScipyDirectSolver

        return ScipyDirectSolver(
            esm, asm.element_dof_ids(self.elnodes), self.fixmask, self.ndof_pad
        )

    def scipy_rhs(self, esm, glv):
        return asm.dirichlet_rhs(
            esm, asm.element_dof_ids(self.elnodes), self.fixmask, self.u_fix, glv
        )


def make_backend(model, cfg, dtype):
    """Backend factory: sharded when ``cfg.n_devices > 1`` (or
    ``cfg.force_sharded``, which runs the SPMD path on a 1-device mesh —
    single-real-chip validation of the shard_map kernels), local otherwise.
    """
    if (getattr(cfg, "n_devices", 0) and cfg.n_devices > 1) or getattr(
        cfg, "force_sharded", False
    ):
        from fcvm_tpu.parallel.system import ShardedSystem

        return ShardedSystem(model, cfg, dtype)
    return LocalSystem(model, cfg, dtype)
