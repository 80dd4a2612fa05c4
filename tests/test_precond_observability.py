"""The coarse-build degradation paths must be LOUD:
a zero-coarse fallback silently costs 4-7x CG iterations, so it has to show
up in the driver log and cg_stats, not just as a one-shot Python warning."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest

import fcvm_tpu
from fcvm_tpu.models import meshgen
from fcvm_tpu.ops import precond


def _model(n=2):
    l = 10.0
    mesh = meshgen.box_tet10(n, n, n, l, l, l)
    bcs = fcvm_tpu.BoundaryConditions.from_node_sets(
        [
            (mesh.select_nodes(lambda x, y, z: x < 1e-9), (0.0, None, None)),
            (mesh.select_nodes(lambda x, y, z: y < 1e-9), (None, 0.0, None)),
            (mesh.select_nodes(lambda x, y, z: z < 1e-9), (None, None, 0.0)),
        ]
    )
    faces = mesh.faces_on(lambda x, y, z: x > l - 1e-9)
    loads = fcvm_tpu.Loads(
        traction_faces=faces, tractions=np.tile([100.0, 0, 0], (len(faces), 1))
    )
    return fcvm_tpu.Model(mesh, fcvm_tpu.Material(210000.0, 0.3), bcs, loads)


def _nan_like_coarse(kc, ridge):
    import math

    ncl = math.isqrt(kc.shape[0])
    nm = math.isqrt(kc.shape[1])
    return jnp.full((nm * ncl, nm * ncl), jnp.nan, dtype=kc.dtype)


def test_forced_zero_coarse_fallback_is_loud(monkeypatch):
    """Every ridge 'fails' -> the run must warn, log, count — and still
    converge on the fine-level smoother alone."""
    monkeypatch.setattr(precond, "coarse_invert", _nan_like_coarse)
    model = _model()
    params = fcvm_tpu.ControlParams(
        sig_yield=240.0, nstep=3, error_max=1e-8, et_e=0.1, target_lf=1.0
    )
    logs = []
    with pytest.warns(UserWarning, match="fine-level smoother only"):
        res = fcvm_tpu.solve_collapse(model, params, progress=logs.append)
    assert res.cg_stats["coarse_zero_fallbacks"] >= 1
    assert any("fine-level smoother ONLY" in line for line in logs)
    # physics still correct (block-Jacobi alone converges on this mesh)
    lf = res.history.lbd[-1]
    end = model.mesh.select_nodes(lambda x, y, z: x > 10.0 - 1e-9)
    ux = res.disp_total.reshape(-1, 3)[end, 0]
    np.testing.assert_allclose(ux, lf * 100.0 * 10.0 / 210000.0, rtol=1e-6)


def test_ridge_escalation_is_counted(monkeypatch):
    """First-rung failures escalate the ladder and are counted + logged."""
    real = precond.coarse_invert

    def flaky(kc, ridge):
        if float(ridge) < 1e-3:  # fail the first rung only
            return _nan_like_coarse(kc, ridge)
        return real(kc, ridge)

    monkeypatch.setattr(precond, "coarse_invert", flaky)
    model = _model()
    params = fcvm_tpu.ControlParams(
        sig_yield=240.0, nstep=2, error_max=1e-8, et_e=0.1, target_lf=1.0
    )
    logs = []
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # escalation is NOT a warning
        res = fcvm_tpu.solve_collapse(model, params, progress=logs.append)
    assert res.cg_stats["coarse_ridge_escalations"] >= 1
    assert res.cg_stats["coarse_zero_fallbacks"] == 0
    assert any("ridge escalation" in line for line in logs)
