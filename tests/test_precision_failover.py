"""Automatic precision governance of the collapse driver.

The reference never needs one — its whole pipeline is f64 numpy + CHOLMOD
(``fcVM.py:1111-1135``; every kernel allocates ``np.float64``).  The
rebuild's production tier is f32, whose Newton residual has an
arithmetic floor; when ``error_max`` sits below it the driver must not
thrash the restart ladder against roundoff (reference restart logic:
``fcVM.py:1457-1484``).  Two responses, by how far the floor overshoots:

* clamp: accept steps at ~2x the measured floor when that stays within a
  decade of ``error_max`` (noise-aware stepping);
* escalate: rerun the whole analysis in the f64 tier (the pattern of the
  buckling eigensolve's f64 failover, ``runtime/buckling.py``).
"""

import warnings

import jax
import numpy as np
import pytest

import fcvm_tpu
from fcvm_tpu.config import get_config
from fcvm_tpu.models import meshgen
from fcvm_tpu.runtime.driver import (
    _FLOOR_ESCALATE_CAP,
    PrecisionFloorError,
    _FloorWatch,
)

E, NU, L = 210000.0, 0.3, 10.0


# ---------------------------------------------------------------------------
# _FloorWatch unit tests (the trigger logic, CPU-only, no solves)
# ---------------------------------------------------------------------------


def _feed(watch, errs):
    acts = [watch.observe(e) for e in errs]
    return acts[-1]


def test_floorwatch_converging_sequence_is_silent():
    w = _FloorWatch(error_max=1e-10, enabled=True)
    # geometric contraction never looks stagnant
    assert _feed(w, [10.0 * 0.5**i for i in range(20)]) is None
    assert all(w.observe(e) is None for e in (1e-6, 5e-7, 2e-7, 1e-7))


def test_floorwatch_clamps_near_floor():
    # floor ~1e-7, error_max 5e-8: 2*floor within a decade -> clamp
    # (attempt >= 1: clamp/escalate only fire after a restart re-probe)
    w = _FloorWatch(error_max=5e-8, enabled=True)
    w.reset(attempt=1)
    act = _feed(w, [1e-3, 1e-5, 3e-7, 1.2e-7, 1.1e-7, 1.0e-7, 1.05e-7,
                    1.02e-7, 1.04e-7])
    assert act is not None and act != "escalate"
    kind, clamp = act
    assert kind == "clamp"
    np.testing.assert_allclose(clamp, 2.0e-7, rtol=0.2)


def test_floorwatch_escalates_far_above_error_max():
    # floor ~1e-7, error_max 1e-12: clamping would be 5 decades off -> f64
    w = _FloorWatch(error_max=1e-12, enabled=True)
    w.reset(attempt=1)
    act = _feed(w, [1e-3, 1e-5, 3e-7, 1.2e-7, 1.1e-7, 1.0e-7, 1.05e-7,
                    1.02e-7, 1.04e-7])
    assert act == "escalate"


def test_floorwatch_first_attempt_never_fires():
    """Attempt 0 stagnation goes to the restart ladder (the step-shrink is
    the free second opinion); the same sequence clamps on attempt 1."""
    seq = [1e-3, 1e-5, 3e-7, 1.2e-7, 1.1e-7, 1.0e-7, 1.05e-7, 1.02e-7,
           1.04e-7]
    w = _FloorWatch(error_max=5e-8, enabled=True)
    assert all(w.observe(e) is None for e in seq)
    w.reset(attempt=1)
    assert _feed(w, seq)[0] == "clamp"


def test_floorwatch_rising_tail_is_divergence_not_floor():
    """The Embankment f32 hardware misfire: slow CLIMBS inside the decade
    window must not be clamp-accepted — a floor bounces, divergence climbs
    (driver.py _FLOOR_RISE). Real sequences from the run log."""
    # step 3: [2.43, 1.75, 1.57, 1.55, 1.62, 1.72]e-2, error_max 1e-2
    w = _FloorWatch(error_max=1e-2, enabled=True)
    w.reset(attempt=1)
    assert _feed(w, [2.43e-2, 1.75e-2, 1.57e-2, 1.55e-2, 1.62e-2,
                     1.72e-2]) is None
    # ... and continuing to climb (with a small dip) still never clamps
    assert all(w.observe(e) is None for e in (1.70e-2, 1.78e-2, 1.9e-2))
    # step 4: strictly climbing from the start
    w.reset(attempt=1)
    assert _feed(w, [3.97e-2, 4.18e-2, 4.48e-2, 4.84e-2, 5.23e-2]) is None
    # contrast: a genuine flat floor at the same level DOES clamp
    w.reset(attempt=1)
    act = _feed(w, [2.43e-2, 1.60e-2, 1.57e-2, 1.55e-2, 1.58e-2, 1.56e-2])
    assert act is not None and act[0] == "clamp"


def test_floorwatch_physical_stagnation_is_left_to_restarts():
    # stagnation ABOVE the escalate cap is limit-load physics, not roundoff
    level = 10.0 * _FLOOR_ESCALATE_CAP
    w = _FloorWatch(error_max=1e-6, enabled=True)
    assert _feed(w, [level * f for f in (3.0, 1.5, 1.1, 1.0, 0.98, 1.02, 1.0)]) is None


def test_floorwatch_disabled_and_mrr_predicate():
    w = _FloorWatch(error_max=1e-12, enabled=False)
    assert _feed(w, [1e-7] * 10) is None
    assert not w.escalate_at_mrr()

    w = _FloorWatch(error_max=1e-12, enabled=True)
    for e in (1e-4, 1e-6, 2e-7, 1.5e-7):
        w.observe(e)
    assert w.escalate_at_mrr()  # near-converged roundoff-class abandon

    w = _FloorWatch(error_max=1e-2, enabled=True)
    for e in (5.0, 1.0, 0.4, 0.5):  # genuine divergence at collapse
        w.observe(e)
    assert not w.escalate_at_mrr()


# ---------------------------------------------------------------------------
# Driver integration (tiny mesh, CPU; conftest pins x64 so f32 is explicit)
# ---------------------------------------------------------------------------


@pytest.fixture()
def f32_tier():
    cfg = get_config()
    old = cfg.dtype
    cfg.dtype = "float32"
    yield cfg
    cfg.dtype = old


def _tension_model():
    mesh = meshgen.box_tet10(2, 2, 2, L, L, L)
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


def test_noise_floor_stepping_completes_f32(f32_tier):
    """error_max just under the f32 floor (~1.3e-7 on this model): the run
    must complete all steps without MRR abandonment.  With the attempt
    gating, each floored step gets at most ONE restart re-probe (whose
    halved increment drops the floor below error_max here, so the ladder
    resolves it legitimately); the old behavior was >4 restarts and a dead
    run when the floor watch was disabled."""
    model = _tension_model()
    params = fcvm_tpu.ControlParams(
        sig_yield=240.0, nstep=6, error_max=5e-8, et_e=0.1,
        target_lf=99.0, iterat_max=30,
    )
    lines = []
    res = fcvm_tpu.solve_collapse(model, params, progress=lines.append)
    lbd = np.asarray(res.history.lbd)
    assert len(lbd) == 7  # all 6 steps completed, no MRR
    assert np.all(np.diff(lbd) > 0)
    # at most one re-probe restart per step, never a thrash to MAXIMUM
    assert not any("MAXIMUM RESTARTS" in l for l in lines)
    restarts = sum("RESTART" in l for l in lines)
    assert restarts <= 6


def test_noise_clamped_stepping_completes_f32(f32_tier):
    """error_max below even the restart-shrunk floor: the SECOND attempt of
    the first floored step clamps (gating), and once the run is proven
    floor-limited later steps clamp on their first attempt (run_floored
    memory) — completing without one restart per plateau step."""
    model = _tension_model()
    params = fcvm_tpu.ControlParams(
        sig_yield=240.0, nstep=6, error_max=3e-8, et_e=0.1,
        target_lf=99.0, iterat_max=30,
    )
    lines = []
    res = fcvm_tpu.solve_collapse(model, params, progress=lines.append)
    lbd = np.asarray(res.history.lbd)
    assert res.cg_stats["floor_clamps"] >= 3
    assert len(lbd) == 7  # all 6 steps completed despite the floor
    # the first clamp needed a restart re-probe; subsequent floored steps
    # clamp without one
    restarts = sum("RESTART" in l for l in lines)
    assert 1 <= restarts <= 2


def test_refinement_converges_below_f32_floor(f32_tier):
    """error_max a decade+ below the f32 floor (~1.3e-7 on this model):
    the refinement tier fires (f64 residual evaluation, f32 operator) and
    the run converges to the TRUE tolerance in-place — no f64 rerun, no
    clamps.  This is the first escalation tier (SURVEY.md mixed-precision
    iterative refinement; the reference's pipeline is unconditionally f64,
    fcVM.py:1111-1135)."""
    cfg = f32_tier
    model = _tension_model()
    params = fcvm_tpu.ControlParams(
        sig_yield=240.0, nstep=6, error_max=1e-9, et_e=0.1,
        target_lf=99.0, iterat_max=25,
    )
    lines = []
    x64_before = jax.config.read("jax_enable_x64")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        res = fcvm_tpu.solve_collapse(model, params, progress=lines.append)
    # refinement, not the rerun tier
    assert not any("residual floor" in str(w.message) for w in rec)
    assert not any(l.startswith("PRECISION FAILOVER") for l in lines)
    assert any("f64 residual refinement" in l for l in lines)
    assert res.cg_stats["refinement_activations"] >= 1
    # A refined attempt may still sit a small factor above error_max (the
    # f32 CG corrections bound what the exact residuals can buy; observed
    # 1.5e-9 vs the requested 1e-9 on the restart-shrunk step-0 state,
    # sensitive to last-ulp rounding of the committed f32 state — e.g. the
    # fused-vs-unfused iteration programs) — the clamp tier then accepts
    # within its band.  What matters: at most one clamp, never the 2.8x
    # f64 rerun.
    assert res.cg_stats["floor_clamps"] <= 1
    assert len(res.history.lbd) == 7  # all 6 steps, genuinely converged
    assert jax.config.read("jax_enable_x64") == x64_before
    # every step ended at a GENUINE error within the clamp band (<= 5x
    # error_max) — two decades below the ~1.3e-7 f32 evaluation floor,
    # impossible without the f64 residual path.
    # (The histories can't be compared to the f64 run elementwise: the
    # attempt-gated first restart legitimately shrinks the refined run's
    # step sizes.)
    import re

    step_last_err = []
    for line in lines:
        if line.startswith("Step:"):
            step_last_err.append(None)
        m = re.search(r"Error: ([0-9.e+-]+)", line)
        if m and step_last_err:
            step_last_err[-1] = float(m.group(1))
    assert len(step_last_err) == 6
    assert all(e is not None and e <= 5.0 * params.error_max
               for e in step_last_err)
    # all steps are elastic (yield at LF 2.4): the converged path must be
    # the linear elastic one to solver-tolerance class
    lbd_last = res.history.lbd[-1]
    np.testing.assert_allclose(
        res.disp_total, lbd_last * res.disp_el, rtol=2e-5, atol=1e-12
    )


def test_refinement_restores_x64_off():
    """A production-style process (x64 OFF) that activates refinement gets
    the flag back afterwards so later f32 analyses keep their traces."""
    cfg = get_config()
    old_dtype = cfg.dtype
    cfg.dtype = "float32"
    jax.config.update("jax_enable_x64", False)
    try:
        model = _tension_model()
        params = fcvm_tpu.ControlParams(
            sig_yield=240.0, nstep=3, error_max=1e-9, et_e=0.1,
            target_lf=99.0, iterat_max=25,
        )
        res = fcvm_tpu.solve_collapse(model, params)
        assert res.cg_stats["refinement_activations"] >= 1
        assert len(res.history.lbd) == 4
        assert not jax.config.read("jax_enable_x64")
    finally:
        jax.config.update("jax_enable_x64", True)  # conftest default
        cfg.dtype = old_dtype


def test_escalation_reruns_in_f64(f32_tier):
    """error_max far below the f32 floor with the refinement tier disabled:
    the run escalates, reruns f64, converges to the requested tolerance,
    and restores the dtype flags (the final failover tier)."""
    cfg = f32_tier
    model = _tension_model()
    params = fcvm_tpu.ControlParams(
        sig_yield=240.0, nstep=6, error_max=1e-12, et_e=0.1,
        target_lf=99.0, iterat_max=25,
    )
    lines = []
    old_refine = cfg.residual_refinement
    cfg.residual_refinement = False
    try:
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            res = fcvm_tpu.solve_collapse(model, params, progress=lines.append)
    finally:
        cfg.residual_refinement = old_refine
    assert any("residual floor" in str(w.message) for w in rec)
    assert any(l.startswith("PRECISION FAILOVER") for l in lines)
    # flags restored so later analyses in this process stay f32
    assert cfg.dtype == "float32"
    assert jax.config.read("jax_enable_x64")
    # the f64 rerun really converged to 1e-12 (impossible at f32): the
    # result matches an explicitly-f64 run exactly
    cfg.dtype = "float64"
    ref = fcvm_tpu.solve_collapse(model, params)
    cfg.dtype = "float32"
    np.testing.assert_allclose(res.history.lbd, ref.history.lbd, rtol=1e-12)
    np.testing.assert_allclose(res.disp_total, ref.disp_total, rtol=1e-10)
    assert res.cg_stats["floor_clamps"] == 0  # the f64 rerun needs none


def test_failover_disabled_raises(f32_tier):
    """FCVM_PRECISION_FAILOVER=0: the floor error propagates to the caller
    instead of silently rerunning."""
    cfg = f32_tier
    model = _tension_model()
    params = fcvm_tpu.ControlParams(
        sig_yield=240.0, nstep=6, error_max=1e-12, et_e=0.1,
        target_lf=99.0, iterat_max=25,
    )
    old = cfg.precision_failover
    cfg.precision_failover = False
    try:
        # watch disabled entirely: the reference restart ladder runs and the
        # step is abandoned (MAXIMUM RESTARTS), reference behavior
        res = fcvm_tpu.solve_collapse(model, params)
        assert list(res.history.lbd) == [0.0]
    finally:
        cfg.precision_failover = old


def test_f64_tier_never_watches():
    cfg = get_config()
    model = _tension_model()
    params = fcvm_tpu.ControlParams(
        sig_yield=240.0, nstep=4, error_max=1e-11, et_e=0.1, target_lf=99.0,
    )
    res = fcvm_tpu.solve_collapse(model, params)  # conftest x64 default
    assert res.cg_stats["floor_clamps"] == 0
    assert len(res.history.lbd) == 5
