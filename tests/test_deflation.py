"""Ritz-deflation recycling (fcvm_tpu.ops.deflation).

The motivation is measured in tools/deflate_step_probe.py (499k dof:
in-step solves 56 -> 40 CG iterations, rebuilt per step because the Ritz
space is rhs-specific).  These tests validate the machinery in f64
on CPU: harvested Ritz data produces a correction that (a) leaves solutions
unchanged to solver tolerance, (b) never increases iteration counts, and
(c) integrates with the collapse driver without perturbing physics.
"""

import numpy as np
import pytest

import fcvm_tpu
from fcvm_tpu import config as cfgmod
from fcvm_tpu.models import meshgen
from fcvm_tpu.models.inp import ControlParams
from fcvm_tpu.ops import assembly as asm
from fcvm_tpu.ops import deflation as defl_ops
from fcvm_tpu.runtime.backend import LocalSystem
from fcvm_tpu.runtime.driver import solve_collapse

import jax.numpy as jnp

E, NU, SY0 = 210000.0, 0.3, 240.0
L, SIGMA = 10.0, 100.0


def uniaxial_model(n=3):
    mesh = meshgen.box_tet10(n, n, n, L, L, L)
    bcs = fcvm_tpu.BoundaryConditions.from_node_sets(
        [
            (mesh.select_nodes(lambda x, y, z: x < 1e-9), (0.0, None, None)),
            (mesh.select_nodes(lambda x, y, z: y < 1e-9), (None, 0.0, None)),
            (mesh.select_nodes(lambda x, y, z: z < 1e-9), (None, None, 0.0)),
        ]
    )
    faces = mesh.faces_on(lambda x, y, z: x > L - 1e-9)
    loads = fcvm_tpu.Loads(
        traction_faces=faces, tractions=np.tile([SIGMA, 0, 0], (len(faces), 1))
    )
    return mesh, fcvm_tpu.Model(mesh, fcvm_tpu.Material(E, NU), bcs, loads)


@pytest.fixture
def backend_setup():
    mesh, model = uniaxial_model(3)
    cfg = cfgmod.get_config()
    be = LocalSystem(model, cfg, jnp.float64)
    esm, pinv, glv, rhs, gpc, vol, ls = be.assemble(mesh.coords)
    pc = be.make_pc(esm, pinv, jnp.asarray(mesh.coords, jnp.float64))
    return be, esm, pc, rhs


def _build_space(be, esm, pc, rhs, k=12, nstore=48):
    res1, h1 = be.solve_harvest(esm, pc, rhs, nstore=nstore)
    coef = defl_ops.ritz_coefficients(
        h1.alphas, h1.betas, h1.rzs, int(res1.iters), k
    )
    assert coef is not None
    return res1, be.build_deflation(esm, h1.zs, coef)


def test_deflated_solve_same_solution_fewer_iters(backend_setup):
    be, esm, pc, rhs = backend_setup
    res1, defl = _build_space(be, esm, pc, rhs)
    res2 = be.solve(esm, pc, rhs, defl=defl)
    # same linear system, both converged to rtol -> solutions agree
    ref = np.asarray(res1.x)
    err = np.max(np.abs(np.asarray(res2.x) - ref)) / max(np.max(np.abs(ref)), 1e-30)
    assert err < 1e-5
    assert float(res2.relres) <= be.rtol
    # spectrally-exact coarse directions can only help
    assert int(res2.iters) < int(res1.iters)


def test_deflation_correction_is_free_dof_only(backend_setup):
    be, esm, pc, rhs = backend_setup
    _, defl = _build_space(be, esm, pc, rhs)
    # basis vanishes on fixed dofs (masked at build): the correction cannot
    # perturb prescribed displacements
    w = np.asarray(defl.w)
    fix = np.asarray(be.space.fixmask_m)
    assert np.all(w[fix < 0.5] == 0.0)


def test_galerkin_matches_explicit(backend_setup):
    be, esm, pc, rhs = backend_setup
    _, defl = _build_space(be, esm, pc, rhs, k=6)
    # W^T K_hat W column-by-column through the scalar matvec
    esm_m = esm[be.space.eperm]
    eldofs = asm.element_dof_ids(be.space.elnodes_m)
    kv = asm.make_bc_matvec(esm_m, eldofs, be.space.fixmask_m, be.space.plan_m)
    w = defl.w
    cols = jnp.stack([kv(w[:, j]) for j in range(w.shape[1])], axis=1)
    kw_ref = np.asarray(w.T @ cols)
    kw = np.asarray(
        defl_ops.galerkin(esm_m, eldofs, be.space.fixmask_m, be.space.plan_m, w)
    )
    assert np.allclose(kw, kw_ref, rtol=1e-10, atol=1e-8)


def test_ritz_coefficients_rejects_degenerate():
    z = np.zeros(8)
    assert defl_ops.ritz_coefficients(z, z, z, iters=2, k=4) is None
    # negative alpha (lost positive-definiteness) -> refuse
    a = np.full(8, -1.0)
    assert defl_ops.ritz_coefficients(a, np.ones(8), np.ones(8), 6, 4) is None


def test_pinv_psd_keeps_f64_and_matches_numpy(monkeypatch):
    """f64 Galerkin matrices stay f64 through the eigh on every backend
    (no downcast off the CPU) and the PSD pseudo-inverse equals numpy's on
    a rank-deficient matrix."""
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    rng = np.random.default_rng(3)
    b = rng.normal(size=(12, 7))
    kw = b @ b.T  # PSD, rank 7 (exactly singular directions)
    out = defl_ops.pinv_psd(jnp.asarray(kw, jnp.float64))
    assert out.dtype == jnp.float64
    ref = np.linalg.pinv(kw, rcond=1e-10, hermitian=True)
    np.testing.assert_allclose(np.asarray(out), ref,
                               atol=1e-12 * np.abs(ref).max())


def test_driver_deflation_preserves_physics():
    """Recycling forced on (min_iters lowered below this tiny mesh's solve
    counts) must not perturb the converged physics, and the space must be
    RETAINED across load steps (one harvest amortized over the run — the
    per-step-rebuild policy measured perf-neutral at 499k dof)."""
    mesh, model = uniaxial_model(2)
    params = ControlParams(nstep=8, sig_yield=SY0, et_e=0.1,
                           error_max=1e-8, target_lf=2.8)
    cfg = cfgmod.get_config()
    old_min = cfg.deflation_min_iters
    cfg.deflation_min_iters = 5
    logs = []
    try:
        res_on = solve_collapse(model, params, progress=logs.append)
    finally:
        cfg.deflation_min_iters = old_min
    n_harvest = sum("deflation space: k=" in l for l in logs)
    n_steps = sum(l.startswith("Step:") for l in logs)
    assert 1 <= n_harvest < n_steps
    cfg.deflation = False
    try:
        res_off = solve_collapse(model, params)
    finally:
        cfg.deflation = True
    lbd_on = np.asarray(res_on.history.lbd)
    lbd_off = np.asarray(res_off.history.lbd)
    assert lbd_on.shape == lbd_off.shape
    np.testing.assert_allclose(lbd_on, lbd_off, atol=5e-7)
    np.testing.assert_allclose(
        res_on.disp_total, res_off.disp_total, atol=1e-9
    )


def test_driver_deflation_gate_skips_small_solves():
    """At the default min_iters gate, a tiny mesh never builds a space —
    the deflated/undeflated paths are then bit-identical."""
    mesh, model = uniaxial_model(2)
    params = ControlParams(nstep=4, sig_yield=SY0, et_e=0.1,
                           error_max=1e-9, target_lf=2.6)
    logs = []
    res_on = solve_collapse(model, params, progress=logs.append)
    assert not any("deflation space" in l for l in logs)
    cfg = cfgmod.get_config()
    cfg.deflation = False
    try:
        res_off = solve_collapse(model, params)
    finally:
        cfg.deflation = True
    # the gated-off harvest solve runs the same CG recurrence as plain pcg
    # (only the stored byproducts differ); XLA fusion differences keep this
    # from being exactly bitwise, but it is roundoff-level
    np.testing.assert_allclose(
        np.asarray(res_on.history.lbd), np.asarray(res_off.history.lbd),
        atol=1e-12,
    )


def test_driver_load_deflation_switch_preserves_physics():
    """The predictor load-space recycling (GNL tangent path) is separately
    switchable: with ``load_deflation`` off the predictor runs on its warm
    start alone (the equal-iteration policy of
    tools/gnl_refresh_probe.py) and the converged physics is unchanged."""
    mesh, model = uniaxial_model(2)
    params = ControlParams(nstep=6, sig_yield=SY0, et_e=0.1,
                           error_max=1e-8, target_lf=2.8,
                           gnl="GNLY", max_imp=0.0)
    cfg = cfgmod.get_config()
    old_min = cfg.deflation_min_iters
    cfg.deflation_min_iters = 5
    logs_on, logs_off = [], []
    try:
        res_on = solve_collapse(model, params, progress=logs_on.append)
        cfg.load_deflation = False
        res_off = solve_collapse(model, params, progress=logs_off.append)
    finally:
        cfg.deflation_min_iters = old_min
        cfg.load_deflation = True
    assert any("load-deflation space" in l for l in logs_on)
    assert not any("load-deflation space" in l for l in logs_off)
    np.testing.assert_allclose(
        np.asarray(res_on.history.lbd), np.asarray(res_off.history.lbd),
        atol=5e-7,
    )
    np.testing.assert_allclose(
        res_on.disp_total, res_off.disp_total, atol=1e-8
    )
