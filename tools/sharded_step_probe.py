"""Where does the sharded backend's 2x per-step overhead live?

The bench's sharded row runs the production driver on the SAME 499k mesh
and convergence path with the local backend and with the sharded backend
on a ONE-device mesh; the sharded one was about 2x slower per step on the
first accelerator.  This probe times each backend phase the driver
actually calls, one backend at a time:

  assemble            (cold + steady)
  make_pc             (first + repeat)
  solve(rhs)          (elastic CG solve, same rtol/maxiter)
  residual            (stress update + out-of-balance, steady over 5)
  tangent_refresh     (GNL tangent + follower loads + predictor solve)
  update_peeq_csr     (damage update)
  gauss_to_user       (result-order conversion, per-step history cost)

Run: python tools/sharded_step_probe.py   (FCVM_BENCH_NX, default 27)
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.chdir(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from fcvm_tpu.config import enable_compilation_cache, get_config

enable_compilation_cache()

import jax
import jax.numpy as jnp

import bench
import fcvm_tpu


def log(*a):
    print(*a, flush=True)


def probe_backend(name, backend_ctor, model, params):
    from fcvm_tpu.ops import material as mat

    cfg = get_config()
    dtype = jnp.float32
    t_init0 = time.perf_counter()
    backend = backend_ctor(model, cfg, dtype)
    log(f"[{name}] init: {time.perf_counter() - t_init0:.2f}s")
    coords_np = model.mesh.coords
    coords = jnp.asarray(coords_np, dtype)
    et_e = jnp.asarray(params.et_e, dtype)

    def timed(label, fn, reps=3):
        outs = None
        t_cold0 = time.perf_counter()
        outs = jax.block_until_ready(fn(0))
        t_cold = time.perf_counter() - t_cold0
        ts = []
        for k in range(1, reps + 1):
            t0 = time.perf_counter()
            outs = jax.block_until_ready(fn(k))
            ts.append(time.perf_counter() - t0)
        log(f"[{name}] {label}: cold {t_cold:.3f}s steady {min(ts)*1e3:.1f}ms")
        return outs

    out = timed("assemble", lambda k: backend.assemble(coords_np))
    esm, pinv, glv, rhs, gpc, vol, ls = out

    pc_holder = {}

    def mk(k):
        pc_holder["pc"] = backend.make_pc(esm, pinv, coords * (1.0 + 1e-9 * k))
        return pc_holder["pc"]

    timed("make_pc", mk, reps=2)
    pc = pc_holder["pc"]

    timed("solve(rhs)", lambda k: backend.solve(
        esm, pc, rhs * (1.0 + 1e-7 * k)).x)

    ndof_pad = backend.ndof_pad
    sig_yield = backend.gauss_full(params.sig_yield)
    zeros6 = backend.gauss_zeros((6,))
    disp = jnp.zeros(ndof_pad, dtype)
    res0 = backend.solve(esm, pc, rhs)
    ue = res0.x
    qnorm = float(jnp.linalg.norm(glv))

    timed("residual", lambda k: backend.residual(
        coords, sig_yield, disp, (0.3 + 1e-7 * k) * ue, zeros6, glv,
        0.3, qnorm, params.et_e, True)[4], reps=5)

    sig_new, sig_test, pgp, qin, r, err = backend.residual(
        coords, sig_yield, disp, 0.3 * ue, zeros6, glv, 0.3, qnorm,
        params.et_e, True)

    timed("tangent_refresh", lambda k: backend.tangent_refresh(
        coords, sig_new, pgp, disp * 0.0, (0.3 + 1e-7 * k) * ue, pc, et_e,
        ue0=ue)[3], reps=3)

    timed("update_peeq_csr", lambda k: backend.update_peeq_csr(
        sig_test, sig_new, sig_yield * (1.0 + 1e-9 * k),
        backend.gauss_zeros(), backend.gauss_zeros(), et_e, 0.25)[1],
        reps=3)

    timed("gauss_to_user(sig)", lambda k: jnp.asarray(
        backend.gauss_to_user(sig_new * (1.0 + 1e-9 * k))), reps=3)


def main():
    nx = int(os.environ.get("FCVM_BENCH_NX", "27"))
    _, model = bench.build(nx)
    params = fcvm_tpu.ControlParams(
        sig_yield=25.0, nstep=3, error_max=1e-5, et_e=0.1,
        target_lf=99.0, gnl="GNLY", max_imp=0.0,
    )
    log(f"mesh: nn={model.mesh.n_nodes} ndof={model.mesh.ndof}")

    from fcvm_tpu.runtime.backend import LocalSystem

    probe_backend("local", LocalSystem, model, params)

    from fcvm_tpu.parallel.system import ShardedSystem

    cfg = get_config()
    old = cfg.force_sharded
    cfg.force_sharded = True
    try:
        probe_backend("sharded", ShardedSystem, model, params)
    finally:
        cfg.force_sharded = old


if __name__ == "__main__":
    main()
