"""Fused Newton iteration + HP-matvec escalation + dispatch telemetry.

The steady-state NR iteration runs as ONE device program
(``runtime/system.newton_iteration``, ``parallel/system.newton_fn`` —
SURVEY.md build-plan step 6, reference loop ``fcVM.py:1304-1557``), with
host governance at iteration granularity; the driver counts its device-program
launches; and a stagnating f32 attempt above ``matvec_hp_max_dof`` escalates
the CG matvec to full precision instead of paying the restart ladder
(``fcVM.py:1457-1484`` never restarts on roundoff).

The fused path must reproduce the unfused path's load-displacement
history bit-for-bit in f64 — same solves, same Riks updates, same
residuals, only the dispatch granularity changes.
"""

import numpy as np
import pytest

import fcvm_tpu
from fcvm_tpu.config import get_config
from fcvm_tpu.models import meshgen
from fcvm_tpu.models.inp import ControlParams

E, NU, L = 210000.0, 0.3, 10.0


def _tension_model(n=2):
    mesh = meshgen.box_tet10(n, n, n, L, L, L)
    bcs = fcvm_tpu.BoundaryConditions.from_node_sets([
        (mesh.select_nodes(lambda x, y, z: x < 1e-9), (0.0, None, None)),
        (mesh.select_nodes(lambda x, y, z: y < 1e-9), (None, 0.0, None)),
        (mesh.select_nodes(lambda x, y, z: z < 1e-9), (None, None, 0.0)),
    ])
    faces = mesh.faces_on(lambda x, y, z: x > L - 1e-9)
    loads = fcvm_tpu.Loads(
        traction_faces=faces,
        tractions=np.tile([100.0, 0, 0], (len(faces), 1)),
    )
    return fcvm_tpu.Model(mesh, fcvm_tpu.Material(E, NU), bcs, loads)


_GNL_PARAMS = ControlParams(
    sig_yield=60.0, nstep=3, error_max=1e-8, et_e=0.1, target_lf=99.0,
    gnl="GNLY", max_imp=0.0,
)


@pytest.fixture
def cfg():
    c = get_config()
    saved = (c.fused_newton, c.n_devices, c.node_partition, c.dtype)
    yield c
    (c.fused_newton, c.n_devices, c.node_partition, c.dtype) = saved


def _run(model, params=_GNL_PARAMS, **kw):
    return fcvm_tpu.solve_collapse(model, params, **kw)


def test_fused_matches_unfused_gnl_plastic(cfg):
    """GNL plastic collapse: fused and unfused paths walk the identical
    equilibrium path (same solves, Riks updates, residuals)."""
    model = _tension_model()
    res_f = _run(model)
    cfg.fused_newton = False
    res_u = _run(model)
    assert res_f.cg_stats["fused_iterations"] > 0
    assert res_u.cg_stats["fused_iterations"] == 0
    np.testing.assert_allclose(
        res_f.history.lbd, res_u.history.lbd, rtol=0, atol=1e-12
    )
    np.testing.assert_allclose(
        res_f.history.un, res_u.history.un, rtol=1e-12, atol=1e-15
    )
    np.testing.assert_allclose(res_f.peeq_gp, res_u.peeq_gp, atol=1e-14)
    # the point of the fusion: fewer driver-issued device programs
    assert res_f.cg_stats["dispatches"] < res_u.cg_stats["dispatches"]


def test_fused_matches_unfused_geometric_linear(cfg):
    """Modified-NR (GNL off): the fused program has no refresh branch."""
    model = _tension_model()
    params = ControlParams(
        sig_yield=60.0, nstep=4, error_max=1e-9, et_e=0.1, target_lf=99.0,
    )
    res_f = _run(model, params)
    cfg.fused_newton = False
    res_u = _run(model, params)
    assert res_f.cg_stats["fused_iterations"] > 0
    np.testing.assert_allclose(
        res_f.history.lbd, res_u.history.lbd, rtol=0, atol=1e-12
    )


def test_fused_sharded_matches_local(cfg):
    """The SPMD fused iteration (element partition, static refresh variant
    after the shard_map tangent refresh) reproduces the local fused history on
    the
    8-virtual-device mesh — both collective layouts."""
    model = _tension_model()
    res_l = _run(model)
    cfg.n_devices = 8
    res_s = _run(model)
    cfg.node_partition = True
    res_np = _run(model)
    assert res_s.cg_stats["fused_iterations"] > 0
    assert res_np.cg_stats["fused_iterations"] > 0
    np.testing.assert_allclose(
        res_l.history.lbd, res_s.history.lbd, rtol=0, atol=1e-12
    )
    np.testing.assert_allclose(
        res_l.history.lbd, res_np.history.lbd, rtol=0, atol=1e-10
    )


def test_fused_displacement_control(cfg):
    """movdof (displacement-control) runs through the fused path too and
    records the same reaction-force load levels."""
    mesh = meshgen.box_tet10(2, 2, 2, L, L, L)
    bcs = fcvm_tpu.BoundaryConditions.from_node_sets([
        (mesh.select_nodes(lambda x, y, z: x < 1e-9), (0.0, None, None)),
        (mesh.select_nodes(lambda x, y, z: y < 1e-9), (None, 0.0, None)),
        (mesh.select_nodes(lambda x, y, z: z < 1e-9), (None, None, 0.0)),
        (mesh.select_nodes(lambda x, y, z: x > L - 1e-9), (0.02, None, None)),
    ])
    model = fcvm_tpu.Model(mesh, fcvm_tpu.Material(E, NU), bcs,
                           fcvm_tpu.Loads())
    params = ControlParams(
        sig_yield=240.0, nstep=3, error_max=1e-9, et_e=0.1, target_lf=99.0,
    )
    res_f = _run(model, params)
    cfg.fused_newton = False
    res_u = _run(model, params)
    np.testing.assert_allclose(
        res_f.history.load, res_u.history.load, rtol=1e-10, atol=1e-12
    )


def test_scipy_tier_never_fuses(cfg):
    cfg_solver = get_config().solver
    get_config().solver = "scipy"
    try:
        res = _run(_tension_model())
    finally:
        get_config().solver = cfg_solver
    assert res.cg_stats["fused_iterations"] == 0
    assert np.all(np.diff(res.history.lbd) > 0)


# ---------------------------------------------------------------------------
# dispatch telemetry
# ---------------------------------------------------------------------------


def test_dispatch_telemetry_counts_and_logs(cfg):
    model = _tension_model()
    lines = []
    res = _run(model, progress=lines.append)
    assert res.cg_stats["dispatches"] > 0
    # fused runs need strictly fewer launches than one per op: at most a
    # few per Newton iteration plus per-step recording
    n_iters = res.cg_stats["newton_iterations"]
    assert res.cg_stats["dispatches"] < 12 * max(n_iters, 1)
    assert any("device dispatches:" in ln for ln in lines)


# ---------------------------------------------------------------------------
# HP-matvec escalation
# ---------------------------------------------------------------------------


def test_hp_solve_matches_default_precision():
    """hp=True threads a HIGHEST-precision operator through the same PCG;
    on CPU (exact f32/f64 matmuls) the result is identical."""
    import jax.numpy as jnp

    from fcvm_tpu.runtime.backend import LocalSystem

    model = _tension_model()
    cfg = get_config()
    be = LocalSystem(model, cfg, jnp.float64)
    esm, pinv, glv, rhs, *_ = be.assemble(model.mesh.coords)
    pc = be.make_pc(esm, pinv, jnp.asarray(model.mesh.coords))
    x0 = be.solve(esm, pc, rhs, hp=False)
    x1 = be.solve(esm, pc, rhs, hp=True)
    np.testing.assert_allclose(
        np.asarray(x0.x), np.asarray(x1.x), rtol=1e-10, atol=1e-12
    )


def test_hp_escalation_fires_instead_of_restart(cfg, monkeypatch):
    """Wire test: when the floor watch reports a roundoff-class stagnation
    on a mesh above matvec_hp_max_dof (forced to 0 here) in the f32 tier,
    the driver escalates the matvec ONCE (sticky), resets the iteration
    budget, and completes — no PrecisionFloorError, no f64 rerun."""
    from fcvm_tpu.runtime import driver as drv

    cfg.dtype = "float32"
    monkeypatch.setattr(cfg, "matvec_hp_max_dof", 0)

    fire = {"done": False}
    orig_observe = drv._FloorWatch.observe

    def fake_observe(self, error):
        # report one escalation-class stagnation from INSIDE the NR loop
        # (>= 2 errors since the last reset; the step-start observe, whose
        # return the driver discards, sees an empty window)
        if not fire["done"] and len(self.errs) >= 2:
            fire["done"] = True
            return "escalate"
        return orig_observe(self, error)

    monkeypatch.setattr(drv._FloorWatch, "observe", fake_observe)
    model = _tension_model()
    params = ControlParams(
        sig_yield=60.0, nstep=2, error_max=1e-5, et_e=0.1, target_lf=99.0,
        gnl="GNLY", max_imp=0.0,
    )
    lines = []
    res = fcvm_tpu.solve_collapse(model, params, progress=lines.append)
    assert res.cg_stats["hp_matvec_activations"] == 1
    assert res.cg_stats["hp_from_step"] is not None
    assert res.cg_stats["refinement_activations"] == 0
    assert any("CG-CORRECTION FLOOR" in ln for ln in lines)
    assert len(res.history.lbd) == 3  # both steps completed
    assert np.all(np.diff(res.history.lbd) > 0)


def test_hp_unavailable_below_threshold(cfg, monkeypatch):
    """Below matvec_hp_max_dof the matvec is ALREADY full-precision
    (resolve_matvec_precision auto tier) — escalation must not fire; the
    normal refinement/failover tiers keep the job."""
    from fcvm_tpu.runtime import driver as drv

    cfg.dtype = "float32"
    model = _tension_model()
    params = ControlParams(
        sig_yield=60.0, nstep=2, error_max=1e-5, et_e=0.1, target_lf=99.0,
        gnl="GNLY", max_imp=0.0,
    )
    res = fcvm_tpu.solve_collapse(model, params)
    assert res.cg_stats["hp_matvec_activations"] == 0


# ---------------------------------------------------------------------------
# continuation-action hygiene + monitor contract
# ---------------------------------------------------------------------------


def test_continuation_unknown_action_raises(cfg):
    model = _tension_model()
    with pytest.raises(ValueError, match="unrecognized continuation"):
        _run(model, continuation=lambda h, s: "bogus")


def test_continuation_all_string_tuple_is_sequence(cfg):
    """("add", "rev") must behave as the sequence [add, rev] (previously it
    matched no branch and silently stopped the loop)."""
    model = _tension_model()
    calls = {"n": 0}

    def cont(h, s):
        calls["n"] += 1
        return ("add", "rev") if calls["n"] == 1 else "stop"

    res = _run(model, continuation=cont)
    assert calls["n"] == 2  # the loop resumed once
    lbd = np.asarray(res.history.lbd)
    assert len(lbd) > 4  # more steps than the initial nstep=3
    assert np.any(np.diff(lbd) < 0)  # and the load reversed


def test_monitor_sees_current_step_history(cfg):
    """The monitor fires AFTER the current step's history scalars are
    appended."""
    model = _tension_model()
    seen = []

    def monitor(disp_nodes, history):
        seen.append((len(history.un), len(history.lbd),
                     float(np.max(np.abs(disp_nodes)))))

    res = _run(model, monitor=monitor)
    assert len(seen) == len(res.history.lbd) - 1
    for k, (n_un, n_lbd, dmax) in enumerate(seen):
        assert n_un == n_lbd == k + 2  # includes the just-converged step
