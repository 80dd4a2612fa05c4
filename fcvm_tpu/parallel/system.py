"""ShardedSystem: the full collapse-solver backend over a device mesh.

This is the multi-chip *production* path: `solve_collapse` runs its entire
Riks loop — elastic/tangent assembly, two-level-preconditioned CG, GNL
stress updates, restarts, displacement control — over an element partition
on a ``jax.sharding.Mesh``, not just a demo step.

Design:

* **Elements are the sharded axis**, in Morton (solve-space) order so each
  shard owns a spatially compact subdomain and the preconditioner clusters
  stay local.  All per-element state — stiffness blocks, connectivity,
  Gauss stress/damage — is partitioned ``P('e')`` and padded to the shard
  multiple with zero-weight ghost elements.
* **Node vectors are replicated.**  Every operator application is: local
  row gather from the replicated vector -> per-element block matmul ->
  local per-shard ScatterPlan reduce (pure gathers; see
  ``ops.assembly.build_sharded_scatter_plans``) -> one ``psum`` over the
  element axis.  That one
  (ndof,)-sized collective per matvec/internal-force is the entire
  communication volume of a Newton iteration; it rides ICI on real
  hardware.
* The CG loop runs in the **Morton node numbering** exactly like the
  single-device solver (``runtime/system.SolveSpace``): the two-level
  coarse correction applies replicated (its cost is O(ndof), tiny), while
  its Galerkin build accumulates per shard and ``psum``s the (ncl^2, 36)
  pair-block table.
* Small-table load integration (pressure/traction faces, edges, vertices)
  and the dense coarse factorization replicate on every device — identical
  results, no communication, negligible cost next to the element work.

Correctness contract: a sharded run reproduces the single-device driver's
load-displacement history to roundoff in f64 (``tests/test_sharded_driver``),
which is the multi-chip criterion SURVEY.md sets for the rebuild.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from fcvm_tpu.ops import assembly as asm
from fcvm_tpu.ops import elements as el
from fcvm_tpu.ops import material as mat
from fcvm_tpu.ops import solver as slv
from fcvm_tpu.ops.deflation import DeflationSpace, deflated, pinv_psd
from fcvm_tpu.ops.precond import (
    TwoLevelPrecond,
    _coarse_accumulate,
    _qmat_bc_jit,
    apply_precond,
    invert_coarse_with_ladder,
)
from fcvm_tpu.ops.stress_update import _element_stress_update
from fcvm_tpu.runtime.backend import LocalSystem
from fcvm_tpu.utils.linalg3 import inv3_spd


@jax.jit
def _sharded_record_stats(disp_new, csr, peeq, pressure, svm, triax, ecr,
                          epos):
    """User-order permute (drops the shard padding) + the shared
    converged-step scalar reduction — see
    :func:`fcvm_tpu.runtime.system.record_step_stats`."""
    from fcvm_tpu.runtime import system as sysm

    def u(a):
        return a[epos]

    return sysm.record_step_stats(
        disp_new, u(csr), u(peeq), u(pressure), u(svm), u(triax), u(ecr)
    )


def _nodal_diag_blocks(esm, elnodes, nn):
    """(nn, 3, 3) nodal diagonal blocks of the local element stiffnesses."""
    ne = esm.shape[0]
    blocks5 = esm.reshape(ne, 10, 3, 10, 3)
    idx = jnp.arange(10)
    diag = blocks5[:, idx, :, idx, :]  # (10, ne, 3, 3)
    node_ids = elnodes.T.reshape(-1)
    return jax.ops.segment_sum(diag.reshape(-1, 3, 3), node_ids, num_segments=nn)


class ShardedSystem(LocalSystem):
    """Element-partition SPMD backend with the LocalSystem interface."""

    supports_scipy = False
    # the local-path AOT prewarm compiles executables this backend's
    # shard_map build never calls (see runtime/backend.py)
    prewarm_matches_build = False
    # Ritz recycling runs sharded too: the harvest stores replicated
    # preconditioned residuals (the CG vectors are replicated by design),
    # the block Galerkin K @ W goes through the same one-psum shard_map
    # matvec with k trailing columns, and the (k, k) correction math is
    # replicated — so a deflated sharded iteration still pays exactly one
    # (ndof,)-sized collective.
    supports_deflation = True

    def __init__(self, model, cfg, dtype):
        super().__init__(model, cfg, dtype)
        # n=1 is a valid degenerate mesh (cfg.force_sharded): the SPMD
        # kernels run, as the device compiles them, on a single card
        n = max(1, int(cfg.n_devices))
        devs = jax.devices()
        if len(devs) < n:
            raise RuntimeError(
                f"requested {n} devices, found {len(devs)} "
                f"({jax.default_backend()} backend)"
            )
        self.dmesh = Mesh(np.array(devs[:n]), ("e",))
        self.n_shards = n
        self._sh_e = NamedSharding(self.dmesh, P("e"))
        self._sh_r = NamedSharding(self.dmesh, P())

        # Morton-ordered, shard-padded element tables.  eperm: user element
        # at each Morton slot; epos: Morton slot of each user element.
        eperm = np.asarray(self.space.eperm)
        ne = self.ne
        ne_pad = ((ne + n - 1) // n) * n
        self.ne_pad = ne_pad
        self._eperm = eperm
        epos = np.empty(ne, dtype=np.int64)
        epos[eperm] = np.arange(ne)
        self._epos = epos

        def pad_el(a, fill_row):
            if ne_pad == ne:
                return a
            pad = np.tile(fill_row, (ne_pad - ne,) + (1,) * (a.ndim - 1))
            return np.concatenate([a, pad], axis=0)

        eln_user = np.asarray(model.mesh.elnodes)[eperm]
        eln_m = np.asarray(self.space.elnodes_m)
        weights = np.zeros(ne_pad, dtype=np.float64)
        weights[:ne] = 1.0
        eln_user_pad = pad_el(eln_user, eln_user[:1])
        self.eln_s = jax.device_put(
            jnp.asarray(eln_user_pad, dtype=jnp.int32), self._sh_e
        )
        eln_m_pad = pad_el(eln_m, eln_m[:1])
        self.eln_m_s = jax.device_put(
            jnp.asarray(eln_m_pad, dtype=jnp.int32), self._sh_e
        )
        # Per-shard ScatterPlans for the Morton node reductions: the hot
        # CG matvec reduce as pure gathers instead of segment_sum (the
        # same plan as the local backend, ops/assembly.ScatterPlan).  At
        # n=1 this degenerates to exactly the local backend's plan shape.  The
        # pad elements duplicate element 0's connectivity with zero weights —
        # same rows segment_sum summed, so behavior is identical.
        _, incs_m, invp_m = asm.build_sharded_scatter_plans(
            np.split(np.asarray(eln_m_pad), n), self.ndof_pad // 3
        )
        self._plan_m = (
            tuple(jax.device_put(a, self._sh_e) for a in incs_m),
            jax.device_put(invp_m, self._sh_e),
        )
        # Second plan set in USER node order for the stress-update /
        # internal-force qin reductions (once per NR iteration; measured
        # ~10 ms at 499k dof as segment_sum — the last scatter-add on the
        # sharded Newton hot path).
        _, incs_u, invp_u = asm.build_sharded_scatter_plans(
            np.split(np.asarray(eln_user_pad), n), self.ndof_pad // 3
        )
        self._plan_u = (
            tuple(jax.device_put(a, self._sh_e) for a in incs_u),
            jax.device_put(invp_u, self._sh_e),
        )
        self.weights = jax.device_put(
            jnp.asarray(weights, dtype=dtype), self._sh_e
        )

        # per-element material tables follow the element partition
        def shard_mat(a):
            if a.ndim == 0:
                return a
            a_np = np.asarray(a)[eperm]
            return jax.device_put(
                jnp.asarray(pad_el(a_np, a_np[:1]), dtype=dtype), self._sh_e
            )

        self.dmat_s = shard_mat(self.dmat) if self.dmat.ndim == 3 else self.dmat
        self.e_s = shard_mat(self.e)
        self.nu_s = shard_mat(self.nu)
        self.g_s = shard_mat(self.g)
        self.density_s = shard_mat(self.density)
        self.e_gp = self.e_s[:, None] if self.e_s.ndim == 1 else self.e_s
        self.nu_gp = self.nu_s[:, None] if self.nu_s.ndim == 1 else self.nu_s

        self.nn_pad = self.ndof_pad // 3
        self.fixmask_m = self.space.fixmask_m
        # same size-resolved matvec einsum precision as the local backend
        # (ops/assembly.resolve_matvec_precision), so the two backends see
        # the SAME operator on hardware at small scale
        self.mv_prec = asm.resolve_matvec_precision(self.ndof_pad)
        self._build_jits()

    # -- Gauss-state helpers (backend order = Morton + shard padding) --------

    def gauss_zeros(self, trailing=()):
        return jax.device_put(
            jnp.zeros((self.ne_pad, 4) + tuple(trailing), dtype=self.dtype),
            self._sh_e,
        )

    def gauss_full(self, value):
        return jax.device_put(
            jnp.full((self.ne_pad, 4), value, dtype=self.dtype), self._sh_e
        )

    def gauss_false(self):
        return jax.device_put(
            jnp.zeros((self.ne_pad, 4), dtype=bool), self._sh_e
        )

    def record_stats(self, disp_new, csr, peeq, pressure, svm, triax, ecr):
        """Converged-step history scalars on device: permute the sharded
        Gauss fields to USER element order inside the jit (argmax
        tie-breaking must match the reference's ``np.argmax`` over user
        order, ``fcVM.py:1539-1557``) and reduce to nine scalars — the
        driver fetches them in one round trip instead of six full-field
        transfers."""
        if not hasattr(self, "_epos_dev"):
            self._epos_dev = jnp.asarray(self._epos, jnp.int32)
        return _sharded_record_stats(
            self._r(disp_new), self._e(csr), self._e(peeq),
            self._e(pressure), self._e(svm), self._e(triax), self._e(ecr),
            self._epos_dev,
        )

    def gauss_to_user(self, a):
        if jax.process_count() > 1:
            # Shards on other hosts are not addressable; gather the global
            # element axis to every process before the host-side reorder.
            from jax.experimental import multihost_utils

            a = multihost_utils.process_allgather(a, tiled=True)
        return np.asarray(a)[self._epos]

    def user_to_gauss(self, a):
        a_np = np.asarray(a)[self._eperm]
        if self.ne_pad > self.ne:
            pad = np.repeat(a_np[:1], self.ne_pad - self.ne, axis=0)
            a_np = np.concatenate([a_np, pad], axis=0)
        return jax.device_put(jnp.asarray(a_np), self._sh_e)

    # -- shard_map building blocks -------------------------------------------

    def _smap(self, f, in_specs, out_specs):
        return jax.shard_map(
            f, mesh=self.dmesh, in_specs=in_specs, out_specs=out_specs
        )

    def _kv_m(self, esm, eln_m, plan, u_m, prec=None):
        """Raw ``K @ v`` in the Morton node numbering (one psum).

        ``eln_m`` / ``plan`` (the sharded Morton connectivity + per-shard
        ScatterPlan leaves) are threaded as arguments, never closures:
        under an outer ``jax.jit`` a closed-over partitioned array must be
        fetched as a host constant, which is impossible when its shards
        live on other processes (multi-host).

        ``prec`` overrides the size-resolved einsum precision (the HP
        escalation tier; trace-time static).
        """
        nn = self.nn_pad
        mv_prec = self.mv_prec if prec is None else prec

        def local(esm_l, eln_l, plan_l, u_r):
            ne_l = eln_l.shape[0]
            incs_l, invp_l = plan_l
            u3 = u_r.reshape(nn, 3)[eln_l]
            fe = jnp.einsum(
                "eij,ej->ei", esm_l, u3.reshape(ne_l, 30),
                precision=mv_prec,
            )
            y = asm.scatter_node_rows_padded(
                fe.reshape(-1, 3), [a[0] for a in incs_l], invp_l[0]
            )
            return jax.lax.psum(y, "e")

        y3 = self._smap(local, (P("e"), P("e"), P("e"), P()), P())(
            esm, eln_m, plan, u_m
        )
        return y3.reshape(-1)

    def _khat_m(self, esm, eln_m, plan, u_m, prec=None):
        fm = self.fixmask_m
        return (fm * self._kv_m(esm, eln_m, plan, fm * u_m, prec=prec)
                + (1.0 - fm) * u_m)

    def _khat_block_m(self, esm, eln_m, plan, w):
        """``K_hat @ W`` for a replicated (ndof_m, k) block in ONE pass.

        The sharded counterpart of ``ops.deflation.block_khat_matvec``:
        gather cost is per-index and independent of row width, so the k
        columns ride the same element gather/psum as a single matvec."""
        nn = self.nn_pad
        fm = self.fixmask_m
        wp = fm[:, None] * w

        def local(esm_l, eln_l, plan_l, w_r):
            ne_l = eln_l.shape[0]
            k = w_r.shape[1]
            incs_l, invp_l = plan_l
            u3k = w_r.reshape(nn, 3, k)[eln_l]  # (ne_l, 10, 3, k)
            # HIGHEST (not mv_prec): K @ W feeds the deflation Galerkin
            # matrix, whose inverse must cancel the deflated modes below
            # CG tolerance — same rule as ops.deflation.block_khat_matvec
            fe = jnp.einsum(
                "eij,ejk->eik", esm_l, u3k.reshape(ne_l, 30, k),
                precision=jax.lax.Precision.HIGHEST,
            )
            y = asm.scatter_node_rows_padded(
                fe.reshape(-1, 3, k), [a[0] for a in incs_l], invp_l[0]
            )
            return jax.lax.psum(y, "e")

        y3 = self._smap(local, (P("e"), P("e"), P("e"), P()), P())(
            esm, eln_m, plan, wp
        )
        kw = fm[:, None] * y3.reshape(-1, w.shape[1])
        return kw + (1.0 - fm)[:, None] * w

    def _pinv_m(self, esm, eln_m):
        """Replicated (nn, 3, 3) block-Jacobi inverses in Morton node order."""
        nn = self.nn_pad

        def local(esm_l, eln_l):
            return jax.lax.psum(_nodal_diag_blocks(esm_l, eln_l, nn), "e")

        nodal = self._smap(local, (P("e"), P("e")), P())(esm, eln_m)
        m3 = self.fixmask_m.reshape(nn, 3)
        mask_ij = m3[:, :, None] * m3[:, None, :]
        eye = jnp.eye(3, dtype=esm.dtype)
        nodal = nodal * mask_ij + (1.0 - m3)[:, :, None] * eye[None]
        return inv3_spd(nodal)

    # -- jitted composites ----------------------------------------------------

    def _build_jits(self):
        space = self.space
        nn_pad = self.nn_pad
        dtype = self.dtype
        loads = self.loads
        ndof_pad = self.ndof_pad

        def gp_gravity_local(coords_eff, eln_l, plan_l, weights_l, density_l,
                             grav):
            """Per-shard gravity load + gp coords + volume (user node ids)."""
            coords_el = coords_eff[eln_l]
            dshp = jnp.asarray(el.DSHP10_AT_GP, dtype=dtype)
            shp = jnp.asarray(el.SHP10_AT_GP, dtype=dtype)
            w = jnp.asarray(el.W10, dtype=dtype)
            from fcvm_tpu.utils.linalg3 import det3

            # HIGHEST: load-vector geometry, matching the local backend
            # (ops/assembly.gravity_load_and_gp_coords)
            hp = jax.lax.Precision.HIGHEST
            xs = jnp.einsum("eki,gjk->egij", coords_el, dshp, precision=hp)
            det = det3(xs) * weights_l[:, None]
            scale = w[None, :] * jnp.abs(det)
            rho = (
                density_l[:, None, None]
                if jnp.ndim(density_l) == 1
                else density_l
            )
            gamma = jnp.einsum("eg,gj,c->ejc", scale, shp, grav,
                               precision=hp) * rho
            incs_l, invp_l = plan_l
            glv3 = asm.scatter_node_rows_padded(
                gamma.reshape(-1, 3), [a[0] for a in incs_l], invp_l[0]
            )
            gp_coords = jnp.einsum("gj,eji->egi", shp, coords_el)
            volume = jnp.sum(det * w[None, :])
            return (
                jax.lax.psum(glv3, "e").reshape(-1),
                gp_coords,
                jax.lax.psum(volume, "e"),
            )

        def assemble_fn(coords, eln_s, eln_m, plan_m, plan_u, weights, dmat_s,
                        density_s, fixmask, u_fix):
            def local(coords_r, eln_l, w_l, dmat_l):
                dm = dmat_l if dmat_l.ndim == 3 else dmat_l
                esm = asm.elastic_stiffness_blocks(coords_r, eln_l, dm)
                return esm * w_l[:, None, None]

            dspec = P("e") if self.dmat.ndim == 3 else P()
            esm = self._smap(
                local, (P(), P("e"), P("e"), dspec), P("e")
            )(coords, eln_s, weights, dmat_s)
            pinv = self._pinv_m(esm, eln_m)

            dsp = P("e") if self.density.ndim == 1 else P()
            glv_g, gp_coords, volume = self._smap(
                partial(gp_gravity_local, grav=loads.gravity),
                (P(), P("e"), P("e"), P("e"), dsp),
                (P(), P("e"), P()),
            )(coords, eln_s, plan_u, weights, density_s)

            # small-table loads: replicated (identical on every device)
            glv = glv_g
            glv = glv + asm.pressure_face_loads(
                coords, loads.pressure_faces, loads.pressures, ndof_pad
            )
            glv = glv + asm.uniform_face_loads(
                coords, loads.traction_faces, loads.tractions, ndof_pad
            )
            glv = glv + asm.edge_loads(
                coords, loads.edges, loads.edge_tractions, ndof_pad
            )
            glv = glv + asm.vertex_loads(
                loads.vertices, loads.vertex_forces, ndof_pad, dtype
            )
            loadsums = jnp.sum(glv.reshape(-1, 3), axis=0)

            # Dirichlet RHS in Morton space, mapped back to user order
            u_fix_m = space.to_m(u_fix)
            modf_m = -self.fixmask_m * self._kv_m(esm, eln_m, plan_m, u_fix_m)
            rhs_m = self.fixmask_m * space.to_m(glv) + modf_m + u_fix_m
            rhs = space.from_m(rhs_m)
            return esm, pinv, glv, rhs, gp_coords, volume, loadsums

        self._assemble_jit = jax.jit(assemble_fn)

        def _hp_prec(hp):
            return jax.lax.Precision.HIGHEST if hp else None

        def solve_fn(esm, eln_m, plan_m, pc, b, x0, defl, hp=False):
            # x0/defl may be None: jit caches per pytree structure, so each
            # (x0?, defl?) combination compiles its own executable once.
            matvec = lambda u: self._khat_m(esm, eln_m, plan_m, u,
                                            prec=_hp_prec(hp))
            precond = deflated(lambda r: apply_precond(pc, r), defl)
            res = slv.pcg(
                matvec, space.to_m(b), precond=precond,
                x0=None if x0 is None else space.to_m(x0),
                rtol=self.rtol, maxiter=self.maxiter,
            )
            return res._replace(x=space.from_m(res.x))

        self._solve_jit = jax.jit(solve_fn, static_argnames=("hp",))

        def solve_np_fn(esm, eln_m, plan_m, pc, b, x0, defl, hp=False):
            """Node-partitioned CG (``config.node_partition``): the WHOLE
            PCG loop runs inside one shard_map on Morton row slices of the
            node vectors.  Per iteration: one all_gather of the search
            direction (matvec input) + one psum_scatter of the element
            contributions back to owned rows — the same total bytes as the
            replicated design's single full psum — while the block-Jacobi
            apply, the coarse restriction/prolongation, the deflation
            correction and all vector algebra divide by n instead of
            replicating (the Amdahl term of the replicated design, which
            grows with the device count).  The dense
            coarse solve and the (ncl, nm)/(k,) reductions stay replicated
            (~50 KB psums).  Dot products are psum-reduced local dots
            (``slv.pcg(dot=...)``)."""
            np_prec = self.mv_prec if not hp else jax.lax.Precision.HIGHEST
            nn = self.nn_pad
            fm3 = self.fixmask_m.reshape(nn, 3)
            two_level = isinstance(pc, TwoLevelPrecond)
            if two_level:
                nm = pc.qmat.shape[2]
                ncl = pc.coarse_inv.shape[0] // nm
                cs = pc.qmat.shape[0] // ncl
                cid = jnp.arange(nn, dtype=jnp.int32) // cs
            b3 = space.to_m(b).reshape(nn, 3)

            args = [esm, eln_m, plan_m, fm3, b3]
            specs = [P("e"), P("e"), P("e"), P("e"), P("e")]
            args += [pc.pinv if two_level else pc]
            specs += [P("e")]
            if two_level:
                # rows past nn_pad are zero-masked padding (qmat_bc_jit);
                # slicing them off aligns the row partition with the vectors
                args += [pc.qmat[:nn], cid, pc.coarse_inv]
                specs += [P("e"), P("e"), P()]
            if defl is not None:
                args += [defl.w.reshape(nn, 3, -1), defl.kw_inv]
                specs += [P("e"), P()]
            if x0 is not None:
                args += [space.to_m(x0).reshape(nn, 3)]
                specs += [P("e")]

            def local(*a):
                it = iter(a)
                esm_l, eln_l, plan_l, fm_l, b_l = (next(it) for _ in range(5))
                incs_l, invp_l = plan_l
                pinv_l = next(it)
                if two_level:
                    qmat_l, cid_l, cinv = (next(it) for _ in range(3))
                if defl is not None:
                    w_l, kwi = next(it), next(it)
                x0_l = next(it) if x0 is not None else None

                def pdot(u, v):
                    return jax.lax.psum(jnp.vdot(u, v), "e")

                def mv(u_flat):
                    u3 = fm_l * u_flat.reshape(-1, 3)
                    u3g = jax.lax.all_gather(u3, "e", axis=0, tiled=True)
                    ne_l = eln_l.shape[0]
                    fe = jnp.einsum(
                        "eij,ej->ei", esm_l, u3g[eln_l].reshape(ne_l, 30),
                        precision=np_prec,
                    )
                    y = asm.scatter_node_rows_padded(
                        fe.reshape(-1, 3), [x[0] for x in incs_l], invp_l[0]
                    )
                    y_own = jax.lax.psum_scatter(
                        y, "e", scatter_dimension=0, tiled=True
                    )
                    y_own = fm_l * y_own + (1.0 - fm_l) * u_flat.reshape(-1, 3)
                    return y_own.reshape(-1)

                def prec(r_flat):
                    # HIGHEST on the subspace corrections (coarse +
                    # deflation), matching TwoLevelPrecond.apply and
                    # ops.deflation.deflated: their job is to cancel
                    # modes below CG tolerance, which reduced precision
                    # re-injects
                    hp = jax.lax.Precision.HIGHEST
                    r3 = r_flat.reshape(-1, 3)
                    z3 = jnp.einsum("nab,nb->na", pinv_l, r3)
                    if two_level:
                        rm = fm_l * r3
                        rc = jax.lax.psum(
                            jax.ops.segment_sum(
                                jnp.einsum("nak,na->nk", qmat_l, rm,
                                           precision=hp),
                                cid_l, num_segments=ncl,
                            ),
                            "e",
                        )  # (ncl, nm) replicated (~50 KB)
                        with jax.default_matmul_precision("highest"):
                            zc = cinv @ rc.T.reshape(-1)  # mode-major
                        zc_cl = zc.reshape(nm, ncl).T
                        z3 = z3 + jnp.einsum(
                            "nak,nk->na", qmat_l, zc_cl[cid_l], precision=hp
                        ) * fm_l
                    z = z3.reshape(-1)
                    if defl is not None:
                        wr = jax.lax.psum(
                            jnp.einsum("nak,na->k", w_l, r3, precision=hp), "e"
                        )
                        with jax.default_matmul_precision("highest"):
                            z = z + (
                                w_l.reshape(-1, w_l.shape[2]) @ (kwi @ wr)
                            )
                    return z

                res = slv.pcg(
                    mv, b_l.reshape(-1), precond=prec,
                    x0=None if x0_l is None else x0_l.reshape(-1),
                    rtol=self.rtol, maxiter=self.maxiter, dot=pdot,
                )
                return res.x.reshape(-1, 3), res.iters, res.relres

            x3, iters, relres = self._smap(
                local, tuple(specs), (P("e"), P(), P())
            )(*args)
            return slv.CGResult(
                space.from_m(x3.reshape(-1)), iters, relres
            )

        self._solve_np_jit = jax.jit(solve_np_fn, static_argnames=("hp",))

        def solve_harvest_fn(esm, eln_m, plan_m, pc, b, x0, defl, nstore,
                             hp=False):
            matvec = lambda u: self._khat_m(esm, eln_m, plan_m, u,
                                            prec=_hp_prec(hp))
            precond = deflated(lambda r: apply_precond(pc, r), defl)
            res, h = slv.pcg_harvest(
                matvec, space.to_m(b), precond=precond,
                x0=None if x0 is None else space.to_m(x0),
                rtol=self.rtol, maxiter=self.maxiter, nstore=nstore,
            )
            return res._replace(x=space.from_m(res.x)), h

        self._solve_harvest_jit = jax.jit(
            solve_harvest_fn, static_argnames=("nstore", "hp")
        )

        def build_deflation_fn(esm, eln_m, plan_m, zs, coef):
            # HIGHEST: subspace-correction builds (see ops.deflation)
            with jax.default_matmul_precision("highest"):
                w = self.fixmask_m[:, None] * jnp.einsum(
                    "mn,mk->nk", zs, coef.astype(zs.dtype)
                )
                kw = w.T @ self._khat_block_m(esm, eln_m, plan_m, w)
            return DeflationSpace(w, pinv_psd(kw))

        self._build_deflation_jit = jax.jit(build_deflation_fn)

        def regalerkin_fn(esm, eln_m, plan_m, w):
            with jax.default_matmul_precision("highest"):
                kw = w.T @ self._khat_block_m(esm, eln_m, plan_m, w)
            return DeflationSpace(w, pinv_psd(kw))

        self._regalerkin_jit = jax.jit(regalerkin_fn)

        def stress_update_fn(coords, eln_s, plan_u, weights, sig_yield, disp,
                             du, sig_old, dmat_s, g_s, h_s, et_e, large_disp):
            def local(coords_r, eln_l, plan_l, w_l, sy_l, disp_r, du_r,
                      sig_old_l, dmat_l, g_l, h_l):
                coords_el = coords_r[eln_l]
                u_el = disp_r.reshape(-1, 3)[eln_l]
                du_el = du_r.reshape(-1, 3)[eln_l]
                mat_axes = (0, 0, 0) if dmat_l.ndim == 3 else (None, None, None)
                sig_new, sig_test, pgp, elv = jax.vmap(
                    lambda c, u, d, s, sy, dm, hh, gg: _element_stress_update(
                        c, u, d, s, sy, dm, hh, gg, large_disp
                    ),
                    in_axes=(0, 0, 0, 0, 0) + mat_axes,
                )(coords_el, u_el, du_el, sig_old_l, sy_l, dmat_l, h_l, g_l)
                elv = elv * w_l[:, None]
                incs_l, invp_l = plan_l
                qin3 = asm.scatter_node_rows_padded(
                    elv.reshape(-1, 3), [a[0] for a in incs_l], invp_l[0]
                )
                return sig_new, sig_test, pgp, jax.lax.psum(qin3, "e")

            mspec = P("e") if self.dmat.ndim == 3 else P()
            sig_new, sig_test, pgp, qin3 = self._smap(
                local,
                (P(), P("e"), P("e"), P("e"), P("e"), P(), P(), P("e"),
                 mspec, mspec, mspec),
                (P("e"), P("e"), P("e"), P()),
            )(coords, eln_s, plan_u, weights, sig_yield, disp, du, sig_old,
              dmat_s, g_s, h_s)
            return sig_new, sig_test, pgp, qin3.reshape(-1)

        self._stress_update_jit = jax.jit(
            stress_update_fn, static_argnames=("large_disp",)
        )

        def residual_fn(coords, eln_s, plan_u, weights, sig_yield, disp_new,
                        du, sig_old, glv, lbd1, qnorm, dmat_s, g_s, h_s, et_e,
                        large_disp, relax=1.0):
            sig_new, sig_test, pgp, qin = stress_update_fn(
                coords, eln_s, plan_u, weights, sig_yield, disp_new, du,
                sig_old, dmat_s, g_s, h_s, et_e, large_disp,
            )
            r = self.fixmask * (lbd1 * glv - qin)
            error = jnp.linalg.norm(r) / qnorm
            # r pre-scaled by relax — see runtime/system.residual
            return sig_new, sig_test, pgp, qin, relax * r, error

        self._residual_jit = jax.jit(residual_fn, static_argnames=("large_disp",))

        def residual_refined_fn(coords, eln_s, plan_u, weights, sig_yield,
                                disp_new, du, sig_old, glv, lbd1, qnorm,
                                dmat_s, g_s, h_s, et_e, large_disp,
                                relax=1.0):
            # f64 residual evaluation over f32-stored state (the
            # mixed-precision refinement tier; see
            # runtime.system.residual_refined for the rationale).  All
            # upcasts happen in-jit; the shard_map stress update is
            # dtype-generic, so the same SPMD program runs in f64 with
            # an f64 psum for the internal-force reduce.
            f64 = jnp.float64
            out_dt = glv.dtype

            def c(x):
                return jnp.asarray(x).astype(f64)

            sig_new, sig_test, pgp, qin = stress_update_fn(
                c(coords), eln_s, plan_u, c(weights), c(sig_yield),
                c(disp_new), c(du), c(sig_old), c(dmat_s), c(g_s), c(h_s),
                c(et_e), large_disp,
            )
            r = c(self.fixmask) * (c(lbd1) * c(glv) - qin)
            error = jnp.linalg.norm(r) / c(qnorm)
            return (sig_new.astype(out_dt), sig_test.astype(out_dt), pgp,
                    qin.astype(out_dt), (c(relax) * r).astype(out_dt),
                    error)

        self._residual_refined_jit = jax.jit(
            residual_refined_fn, static_argnames=("large_disp",)
        )

        def tangent_fn(coords, eln_s, eln_m, plan_m, plan_u, weights, sig_old,
                       pgp, disp_new, du, pc, dmat_s, g_s, h_s, density_s,
                       u_fix, ue0=None, w=None, solve_predictor=True,
                       hp=False):
            # refinement mode holds disp_new/du in f64; the tangent
            # operator stays in the storage dtype (trace-time guard, same
            # as runtime.system.tangent_refresh)
            if disp_new.dtype != coords.dtype:
                disp_new = disp_new.astype(coords.dtype)
            if du.dtype != coords.dtype:
                du = du.astype(coords.dtype)
            coords_def = coords + disp_new.reshape(-1, 3)[: coords.shape[0]]

            def local(coords_r, eln_l, w_l, sig_l, pgp_l, dmat_l, g_l, h_l):
                esm_t = asm.tangent_stiffness_blocks(
                    coords_r, eln_l, dmat_l, sig_l, pgp_l, g_l, h_l
                )
                return esm_t * w_l[:, None, None]

            mspec = P("e") if self.dmat.ndim == 3 else P()
            esm_t = self._smap(
                local,
                (P(), P("e"), P("e"), P("e"), P("e"), mspec, mspec, mspec),
                P("e"),
            )(coords_def, eln_s, weights, sig_old, pgp, dmat_s, g_s, h_s)

            # follower loads: gravity on deformed coordinates (element
            # partition), pressure on the stretched surface + original-
            # geometry uniform/edge/vertex loads replicated
            # (fcVM.py:858-938, 962-1009)
            dsp = P("e") if self.density.ndim == 1 else P()
            glv3, _, _ = self._smap(
                partial(gp_gravity_local, grav=loads.gravity),
                (P(), P("e"), P("e"), P("e"), dsp),
                (P(), P("e"), P()),
            )(coords_def, eln_s, plan_u, weights, density_s)
            glv_t = glv3
            glv_t = glv_t + asm.pressure_face_loads(
                coords_def, loads.pressure_faces, loads.pressures, ndof_pad
            )
            glv_t = glv_t + asm.uniform_face_loads(
                coords, loads.traction_faces, loads.tractions, ndof_pad
            )
            glv_t = glv_t + asm.edge_loads(
                coords, loads.edges, loads.edge_tractions, ndof_pad
            )
            glv_t = glv_t + asm.vertex_loads(
                loads.vertices, loads.vertex_forces, ndof_pad, dtype
            )

            pinv_t = self._pinv_m(esm_t, eln_m)
            if isinstance(pc, TwoLevelPrecond):
                if pc.smooth_inv is not None:
                    pc_t = pc
                else:
                    pc_t = pc._replace(pinv=pinv_t)
            else:
                pc_t = pinv_t

            u_fix_m = space.to_m(u_fix)
            modf_m = -self.fixmask_m * self._kv_m(esm_t, eln_m, plan_m, u_fix_m)
            rhs_m = self.fixmask_m * space.to_m(glv_t) + modf_m + u_fix_m
            if not solve_predictor:
                # return the assembled predictor rhs so the driver can run
                # a load-space harvesting solve on it (same contract as
                # runtime.system.tangent_refresh)
                return (esm_t, pc_t, glv_t, space.from_m(rhs_m),
                        jnp.array(0, jnp.int32))
            defl = None
            if w is not None:
                # re-Galerkin the load-harvested basis on the fresh tangent
                with jax.default_matmul_precision("highest"):
                    kw = w.T @ self._khat_block_m(esm_t, eln_m, plan_m, w)
                defl = DeflationSpace(w, pinv_psd(kw))
            matvec = lambda u: self._khat_m(esm_t, eln_m, plan_m, u,
                                            prec=_hp_prec(hp))
            precond = deflated(lambda r: apply_precond(pc_t, r), defl)
            res = slv.pcg(
                matvec, rhs_m, precond=precond,
                x0=None if ue0 is None else space.to_m(ue0),
                rtol=self.rtol, maxiter=self.maxiter,
            )
            return esm_t, pc_t, glv_t, space.from_m(res.x), res.iters

        self._tangent_jit = jax.jit(
            tangent_fn, static_argnames=("solve_predictor", "hp")
        )

        def newton_fn(coords, eln_s, eln_m, plan_m, plan_u, weights,
                      sig_yield, disp_new, du, sig_old, glv, lbd0, lbd1,
                      qnorm, a, ue, r, esm, pc, dmat_s, g_s, h_s,
                      et_e, defl, relax,
                      large_disp, refresh=False, crisfield=False, hp=False,
                      np_solve=False):
            """Correction solve + Riks + residual as ONE SPMD program (see
            :func:`fcvm_tpu.runtime.system.newton_iteration` for the
            design rationale incl. why ``refresh`` is a STATIC variant:
            the all-in-one fused program exceeded the first accelerator's
            compile service, and a traced ``lax.cond`` around the shard_map
            refresh broke multi-process gloo with a collective-size
            mismatch).  Refresh iterations pipeline ``tangent_fn`` in
            front of this without a host sync; ``refresh=True`` computes
            the control vector and re-Galerkins a held deflation space
            against the fresh sharded operator.  The correction solve is
            the replicated one-psum CG, or the node-partitioned
            all_gather/psum_scatter loop when ``np_solve``
            (``config.node_partition``)."""
            if disp_new.dtype != coords.dtype:
                disp_new = disp_new.astype(coords.dtype)
            if du.dtype != coords.dtype:
                du = du.astype(coords.dtype)

            defl_out = None
            a_out = None
            if refresh and large_disp:
                nu_t = jnp.linalg.norm(ue)
                a = ue * (jnp.linalg.norm(du)
                          / jnp.where(nu_t == 0.0, 1.0, nu_t))
                a_out = a
                if defl is not None:
                    with jax.default_matmul_precision("highest"):
                        kw = defl.w.T @ self._khat_block_m(
                            esm, eln_m, plan_m, defl.w
                        )
                    defl = DeflationSpace(defl.w, pinv_psd(kw))
                    defl_out = defl

            if np_solve:
                res_c = solve_np_fn(esm, eln_m, plan_m, pc, r, None, defl,
                                    hp=hp)
            else:
                res_c = solve_fn(esm, eln_m, plan_m, pc, r, None, defl,
                                 hp=hp)
            due = res_c.x

            from fcvm_tpu.runtime import system as sysm

            riks_fn = (sysm.riks_update_crisfield if crisfield
                       else sysm.riks_update)
            du, lbd1, _ = riks_fn(a, ue, due, du, lbd0, lbd1)

            sig_new, sig_test, pgp, qin, r_new, error = residual_fn(
                coords, eln_s, plan_u, weights, sig_yield, disp_new, du,
                sig_old, glv, lbd1, qnorm, dmat_s, g_s, h_s, et_e,
                large_disp, relax,
            )
            return sysm.NewtonIterOut(
                defl_out, a_out, du, lbd1, sig_new, sig_test,
                pgp, qin, r_new, error, res_c.iters, jnp.any(pgp),
            )

        self._newton_jit = jax.jit(
            newton_fn,
            static_argnames=("large_disp", "refresh", "crisfield", "hp",
                             "np_solve"),
        )

        def internal_force_fn(coords, eln_s, plan_u, weights, sig_gp, disp,
                              large_disp):
            if disp.dtype != coords.dtype:  # refinement-mode f64 disp
                disp = disp.astype(coords.dtype)
            def local(coords_r, eln_l, plan_l, w_l, sig_l, disp_r):
                coords_el = coords_r[eln_l]
                if large_disp:
                    coords_el = coords_el + disp_r.reshape(-1, 3)[eln_l]
                det, _, bmat = jax.vmap(el.tet10_element_geometry)(coords_el)
                w = jnp.asarray(el.W10, dtype=dtype)
                scale = w[None, :] * jnp.abs(det) * w_l[:, None]
                # HIGHEST: the local route pins the internal-force einsums
                # at full f32 precision (ops/stress_update.py); a
                # reduced-precision residual against a HIGHEST operator is the
                # exact inconsistency that diverged the Embankment f32 replay
                elv = jnp.einsum(
                    "egkn,egk,eg->en", bmat, sig_l, scale,
                    precision=jax.lax.Precision.HIGHEST,
                )
                incs_l, invp_l = plan_l
                qin3 = asm.scatter_node_rows_padded(
                    elv.reshape(-1, 3), [a[0] for a in incs_l], invp_l[0]
                )
                return jax.lax.psum(qin3, "e")

            qin3 = self._smap(
                local, (P(), P("e"), P("e"), P("e"), P("e"), P()), P()
            )(coords, eln_s, plan_u, weights, sig_gp, disp)
            return qin3.reshape(-1)

        self._internal_force_jit = jax.jit(
            internal_force_fn, static_argnames=("large_disp",)
        )

    # -- argument-sharding canonicalization ----------------------------------
    #
    # jax's tracing cache keys on every argument's sharding METADATA.  Node
    # vectors and Gauss state alternate producers across the Newton loop —
    # sharded-jit outputs carry ``{Auto: ('e',)}`` axes, while host-created
    # arrays and local-jit outputs (commit_step, restart arithmetic) carry
    # ``{}`` — and every new combination RETRACED the 50+ MB shard_map
    # programs (5-30 s of host time at each step boundary; found with
    # jax_explain_cache_misses: this, not per-launch overhead, was the
    # sharded backend's per-step handicap).  device_put to the
    # canonical NamedSharding is metadata-only for equivalent layouts and
    # makes every call present one stable cache key.

    def _r(self, x):
        """Canonical replicated sharding (no-op transfer if equivalent)."""
        if x is None or not hasattr(x, "sharding"):
            return x
        return jax.device_put(x, self._sh_r)

    def _e(self, x):
        """Canonical element-partition sharding."""
        if x is None or not hasattr(x, "sharding"):
            return x
        return jax.device_put(x, self._sh_e)

    def _canon_pc(self, pc):
        if isinstance(pc, TwoLevelPrecond):
            return TwoLevelPrecond(*(self._r(v) for v in pc))
        return self._r(pc)

    def _canon_defl(self, defl):
        if defl is None:
            return None
        return DeflationSpace(self._r(defl.w), self._r(defl.kw_inv))

    # -- LocalSystem interface -------------------------------------------------

    def assemble(self, coords):
        coords_dev = jax.device_put(
            jnp.asarray(np.asarray(coords), dtype=self.dtype), self._sh_r
        )
        return self._assemble_jit(
            coords_dev, self.eln_s, self.eln_m_s, self._plan_m, self._plan_u,
            self.weights, self.dmat_s, self.density_s, self.fixmask,
            self.u_fix,
        )

    def make_pc(self, esm, pinv, coords_dev):
        if self.cfg.precond != "two_level":
            return pinv  # already Morton node order
        cluster_size = self.cfg.resolve_cluster_size(self.mesh.n_nodes)
        space = self.space
        coords_m = space.coords_m.astype(self.dtype)
        qmat_bc = _qmat_bc_jit(
            coords_m, self.fixmask_m, cluster_size, self.cfg.coarse_modes
        )

        @partial(jax.jit, static_argnames=("cs",))
        def acc(esm_s, eln_m, qbc, cs):
            def local(esm_l, eln_l, qbc_r):
                ncl = qbc_r.shape[0] // cs
                nm = qbc_r.shape[2]
                kc0 = jax.lax.pcast(
                    jnp.zeros((ncl * ncl, nm * nm), esm_l.dtype), ("e",),
                    to="varying",
                )
                return jax.lax.psum(
                    _coarse_accumulate(esm_l, eln_l, qbc_r, cs, kc0), "e"
                )

            return self._smap(local, (P("e"), P("e"), P()), P())(
                esm_s, eln_m, qbc
            )

        kc = acc(esm, self.eln_m_s, qmat_bc, cluster_size)
        coarse_inv = invert_coarse_with_ladder(kc, esm.dtype, label="sharded ")
        return TwoLevelPrecond(pinv, qmat_bc, coarse_inv, self.fixmask_m, None)

    def _np_solve_ok(self, pc):
        return (
            getattr(self.cfg, "node_partition", False)
            and self.nn_pad % self.n_shards == 0
            and not (
                isinstance(pc, TwoLevelPrecond) and pc.smooth_inv is not None
            )
        )

    def solve(self, esm, pc, b, x0=None, defl=None, hp=False):
        esm, pc, b, x0, defl = (self._e(esm), self._canon_pc(pc),
                                self._r(b), self._r(x0),
                                self._canon_defl(defl))
        if self._np_solve_ok(pc):
            return self._solve_np_jit(esm, self.eln_m_s, self._plan_m, pc, b,
                                      x0, defl, hp=hp)
        return self._solve_jit(esm, self.eln_m_s, self._plan_m, pc, b, x0,
                               defl, hp=hp)

    # -- Ritz-deflation recycling (sharded; see ops.deflation) ---------------

    def solve_harvest(self, esm, pc, b, x0=None, defl=None, nstore=64,
                      hp=False):
        return self._solve_harvest_jit(
            self._e(esm), self.eln_m_s, self._plan_m, self._canon_pc(pc),
            self._r(b), self._r(x0), self._canon_defl(defl), nstore=nstore,
            hp=hp,
        )

    def build_deflation(self, esm, zs, coef):
        return self._build_deflation_jit(
            self._e(esm), self.eln_m_s, self._plan_m, self._r(zs),
            jnp.asarray(coef),
        )

    def make_deflation(self, esm, w):
        return self._regalerkin_jit(self._e(esm), self.eln_m_s, self._plan_m,
                                    self._r(w))

    def residual(self, coords, sig_yield, disp_new, du, sig_old, glv,
                 lbd1, qnorm, et_e, large_disp, relax=1.0):
        h = mat.hardening_modulus(self.e_s, jnp.asarray(et_e, self.dtype))
        return self._residual_jit(
            self._r(coords), self.eln_s, self._plan_u, self.weights,
            self._e(sig_yield),
            self._r(disp_new), self._r(du), self._e(sig_old), self._r(glv),
            jnp.asarray(lbd1, self.dtype), jnp.asarray(qnorm, self.dtype),
            self.dmat_s, self.g_s, h, jnp.asarray(et_e, self.dtype),
            large_disp, jnp.asarray(relax, self.dtype),
        )

    def residual_refined(self, coords, sig_yield, disp_new, du, sig_old,
                         glv, lbd1, qnorm, et_e, large_disp, relax=1.0):
        """f64-evaluated residual over f32 state (refinement tier; driver
        enables x64 before the first call)."""
        h = mat.hardening_modulus(self.e_s, jnp.asarray(et_e, self.dtype))
        f64 = jnp.float64
        return self._residual_refined_jit(
            self._r(coords), self.eln_s, self._plan_u, self.weights,
            self._e(sig_yield),
            self._r(disp_new), self._r(du), self._e(sig_old), self._r(glv),
            jnp.asarray(lbd1, f64), jnp.asarray(qnorm, f64),
            self.dmat_s, self.g_s, h, jnp.asarray(et_e, self.dtype),
            large_disp, jnp.asarray(relax, f64),
        )

    def tangent_refresh(self, coords, sig_old, pgp, disp_new, du, pc, et_e,
                        ue0=None, w=None, solve_predictor=True, hp=False):
        h = mat.hardening_modulus(self.e_s, jnp.asarray(et_e, self.dtype))
        return self._tangent_jit(
            self._r(coords), self.eln_s, self.eln_m_s, self._plan_m,
            self._plan_u, self.weights, self._e(sig_old), self._e(pgp),
            self._r(disp_new), self._r(du), self._canon_pc(pc),
            self.dmat_s, self.g_s, h, self.density_s, self.u_fix,
            self._r(ue0), self._r(w), solve_predictor=solve_predictor, hp=hp,
        )

    # -- fused Newton iteration (one dispatch per NR iteration, SPMD) --------

    def newton_iteration(self, coords, sig_yield, disp_new, du, sig_old,
                         glv, lbd0, lbd1, qnorm, a, ue, r, et_e, esm, pc,
                         refresh, large_disp, defl=None,
                         relax=1.0, crisfield=False, hp=False):
        h = mat.hardening_modulus(self.e_s, jnp.asarray(et_e, self.dtype))
        return self._newton_jit(
            self._r(coords), self.eln_s, self.eln_m_s, self._plan_m,
            self._plan_u, self.weights, self._e(sig_yield),
            self._r(disp_new), self._r(du), self._e(sig_old), self._r(glv),
            jnp.asarray(lbd0, self.dtype), jnp.asarray(lbd1, self.dtype),
            jnp.asarray(qnorm, self.dtype), self._r(a), self._r(ue),
            self._r(r), self._e(esm), self._canon_pc(pc),
            self.dmat_s, self.g_s, h,
            jnp.asarray(et_e, self.dtype),
            self._canon_defl(defl), jnp.asarray(relax, self.dtype),
            large_disp=large_disp, refresh=bool(refresh),
            crisfield=crisfield, hp=hp,
            np_solve=self._np_solve_ok(pc),
        )

    def stress_update(self, coords, sig_yield, disp, du, sig_old, et_e,
                      large_disp):
        h = mat.hardening_modulus(self.e_s, jnp.asarray(et_e, self.dtype))
        return self._stress_update_jit(
            self._r(coords), self.eln_s, self._plan_u, self.weights,
            self._e(sig_yield), self._r(disp),
            self._r(du), self._e(sig_old), self.dmat_s, self.g_s, h,
            jnp.asarray(et_e, self.dtype), large_disp,
        )

    def internal_force(self, coords, sig_gp, disp, large_disp):
        return self._internal_force_jit(
            self._r(coords), self.eln_s, self._plan_u, self.weights,
            self._e(sig_gp), self._r(disp), large_disp
        )

    def buckling(self, coords, sig_el_gp, k=2):
        """Sharded (K, -G) pencil eigensolve: element blocks, multi-vector
        operators and the inner CG run SPMD over the element partition;
        the m x m Rayleigh-Ritz math stays on host (reference analogue:
        ``fcVM.py:1199-1214``)."""
        from fcvm_tpu.runtime.buckling import (
            EigensolveBreakdownError, buckling_from_arrays, pencil_subspace,
        )

        cfg = self.cfg
        if cfg.buckling_bc == "penalty":
            # Reference-parity penalty BC runs on the full uneliminated
            # pencil in natural dof order — elimination-path machinery
            # (Morton space, scatter plan, the SPMD operators below) does
            # not apply.  Route to the local tier, which implements it;
            # silently solving the eliminated pencil would ignore the
            # user's explicit FCVM_BUCKLING_BC=penalty opt-in.
            return buckling_from_arrays(
                jnp.asarray(np.asarray(coords), dtype=self.dtype),
                self.elnodes, self.dmat,
                jnp.asarray(self.gauss_to_user(sig_el_gp)), self.fixmask,
                k=k, rtol=min(self.rtol, 1.0e-10), maxiter=self.maxiter,
                plan=self.plan, space=self.space,
            )
        space = self.space
        dtype = self.dtype
        nn_pad = self.nn_pad
        ndof_pad = self.ndof_pad
        coords_dev = jax.device_put(
            jnp.asarray(np.asarray(coords), dtype=dtype), self._sh_r
        )

        # element blocks, Morton order, sharded
        def esm_local(coords_r, eln_l, w_l, dmat_l):
            return asm.elastic_stiffness_blocks(
                coords_r, eln_l, dmat_l
            ) * w_l[:, None, None]

        def nsm_local(coords_r, eln_l, w_l, sig_l):
            return asm.geometric_stiffness_blocks(
                coords_r, eln_l, sig_l
            ) * w_l[:, None, None]

        dspec = P("e") if self.dmat.ndim == 3 else P()
        esm = self._smap(esm_local, (P(), P("e"), P("e"), dspec), P("e"))(
            coords_dev, self.eln_s, self.weights, self.dmat_s
        )
        nsm = self._smap(nsm_local, (P(), P("e"), P("e"), P("e")), P("e"))(
            coords_dev, self.eln_s, self.weights, sig_el_gp
        )

        fm = self.fixmask_m

        def multi_mv(identity_on_fixed, negate=False):
            # blocks and the sharded connectivity are jit ARGUMENTS (not
            # closures — a closure embeds the blocks as program constants,
            # and on multi-host they are non-addressable shards)
            def mv(blocks, eln_m, plan_m, u):
                def local(blocks_l, eln_l, plan_l, u_r):
                    up = (fm[:, None] * u_r).reshape(nn_pad, 3, -1)[eln_l]
                    ne_l = eln_l.shape[0]
                    incs_l, invp_l = plan_l
                    fe = jnp.einsum(
                        "eij,ejm->eim", blocks_l,
                        up.reshape(ne_l, 30, up.shape[-1]),
                        precision=self.mv_prec,
                    )
                    y = asm.scatter_node_rows_padded(
                        fe.reshape(-1, 3, fe.shape[-1]),
                        [x[0] for x in incs_l], invp_l[0],
                    )
                    return jax.lax.psum(y, "e")

                y3 = self._smap(local, (P("e"), P("e"), P("e"), P()), P())(
                    blocks, eln_m, plan_m, u
                )
                y = fm[:, None] * y3.reshape(ndof_pad, -1)
                if identity_on_fixed:
                    y = y + (1.0 - fm)[:, None] * u
                return -y if negate else y

            return jax.jit(mv)

        _kmv = multi_mv(True)
        _mg = multi_mv(False, negate=True)
        kmv = lambda u: _kmv(esm, self.eln_m_s, self._plan_m, u)
        minus_g = lambda u: _mg(nsm, self.eln_m_s, self._plan_m, u)

        pinv = self._pinv_m(esm, self.eln_m_s)
        pc = self.make_pc(esm, pinv, coords_dev)
        rtol = min(self.rtol, 1.0e-10)
        # stagnation exit instead of a floored rtol — see
        # runtime/buckling.buckling_from_arrays
        stall = 100

        # Deep Ritz-harvest recycling, sharded: the policy helper is shared
        # with the local tier (runtime/buckling.make_recycled_k_inverse);
        # the Lanczos buffers and (k, k) correction math are replicated,
        # the Galerkin block matvec rides the one-psum shard_map operator
        # (self.build_deflation, the driver's own space builder).
        from fcvm_tpu.ops import deflation as defl_ops
        from fcvm_tpu.runtime.buckling import (
            _recycling_params, make_recycled_k_inverse,
        )

        nstore, k_defl = _recycling_params(
            cfg, ndof_pad, jnp.dtype(dtype).itemsize
        )

        # esm/eln/pc as jit ARGUMENTS, not closures (see the local tier)
        def _kinv(esm_a, eln_m, plan_m, pc_a, w, defl, x0_basis, x0_scale):
            prec = defl_ops.deflated(lambda r: apply_precond(pc_a, r), defl)

            def solve_col(b, x0c):
                return slv.pcg(
                    lambda u: self._khat_m(esm_a, eln_m, plan_m, u),
                    b, precond=prec, x0=x0c, rtol=rtol, maxiter=self.maxiter,
                    stall=stall,
                ).x

            if x0_basis is None:
                return jax.vmap(
                    lambda b: solve_col(b, None), in_axes=1, out_axes=1
                )(w)
            x0 = x0_basis * x0_scale[None, :]
            return jax.vmap(solve_col, in_axes=(1, 1), out_axes=1)(w, x0)

        _kinv_jit = jax.jit(_kinv)

        def _harvest(esm_a, eln_m, plan_m, pc_a, b):
            return slv.pcg_harvest(
                lambda u: self._khat_m(esm_a, eln_m, plan_m, u), b,
                precond=lambda r: apply_precond(pc_a, r),
                rtol=rtol, maxiter=self.maxiter, nstore=nstore, stall=stall,
            )

        _harvest_jit = jax.jit(_harvest)

        k_inverse = make_recycled_k_inverse(
            lambda w, defl, xb, xs: _kinv_jit(
                esm, self.eln_m_s, self._plan_m, pc, w, defl, xb, xs
            ),
            lambda b: _harvest_jit(esm, self.eln_m_s, self._plan_m, pc, b),
            lambda zs, coef: self.build_deflation(esm, zs, coef),
            k_defl, cfg.deflation_min_iters, cfg.deflation,
        )

        m = max(cfg.n_eig_vectors, 2 * k, k + 4)
        try:
            # warn-only at f64 (the pencil-residual validation's last-tier
            # semantics); raise at f32 so the ladder below can escalate
            lam, vecs = pencil_subspace(
                kmv, minus_g, k_inverse, ndof_pad, dtype, k, m, fixmask=fm,
                last_tier=dtype != jnp.float32,
            )
        except EigensolveBreakdownError:
            # The buckling solve runs once per analysis, so robustness
            # beats SPMD here: route the breakdown to the local tier's
            # full retry ladder (f64 iteration -> f64 re-assembly +
            # host-direct splu, runtime/buckling.buckling_from_arrays)
            # on the user-order arrays every process already holds.
            import warnings

            warnings.warn(
                "sharded f32 buckling eigensolve broke down; escalating "
                "through the local retry ladder (f64 iteration / "
                "re-assembly) — the collapse analysis itself stays sharded"
            )
            lam, vecs = buckling_from_arrays(
                jnp.asarray(np.asarray(coords), dtype=dtype), self.elnodes,
                self.dmat, jnp.asarray(self.gauss_to_user(sig_el_gp)),
                self.fixmask, k=k, rtol=rtol, maxiter=self.maxiter,
                plan=self.plan, space=self.space,
            )
            return lam, vecs
        vecs = vecs.reshape(-1, 3, k)[np.asarray(space.npos)].reshape(-1, k)
        return lam, vecs
