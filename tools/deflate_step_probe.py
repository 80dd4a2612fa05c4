"""Does Ritz deflation help the IN-STEP (plastic-residual-rhs) solves?

The elastic-rhs probes (tools/deflate_probe*.py) measured 58 -> 30 CG
iterations at 499k dof.  The bench regression (2564 -> 2659 ms/step with
deflation on) says the in-step solves — same elastic operator, residual
rhs — may not benefit.  This probe measures, on the bench mesh/operator:

  1. elastic-rhs solve: iters/time, undeflated vs deflated
  2. plastic-residual-rhs solve: iters/time, undeflated vs deflated
  3. converged relres levels of each (the Newton-health question)

Run on the GPU from the repo root: python tools/deflate_step_probe.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from fcvm_tpu.config import enable_compilation_cache, get_config

enable_compilation_cache()


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    import jax
    import jax.numpy as jnp

    from fcvm_tpu.ops import assembly as asm_ops
    from fcvm_tpu.ops import deflation as defl_ops
    from fcvm_tpu.ops import material as mat
    from fcvm_tpu.ops.stress_update import update_stress_load
    from fcvm_tpu.runtime import system as sysm
    from fcvm_tpu.utils.indexing import pad_ndof, pad_vector

    import bench

    dtype = jnp.float32
    nx = int(os.environ.get("FCVM_BENCH_NX", "27"))
    mesh, model = bench.build(nx)
    log(f"mesh: nn={mesh.n_nodes} ne={mesh.n_elements} ndof={mesh.ndof}")
    coords = jnp.asarray(mesh.coords, dtype)
    eln = jnp.asarray(mesh.elnodes)
    e = jnp.asarray(bench.E, dtype)
    nu = jnp.asarray(bench.NU, dtype)
    dmat = mat.hooke_dmat(e, nu)
    fixmask_np, u_fix_np, _ = model.bcs.masks(mesh.ndof)
    nd_pad = pad_ndof(mesh.ndof)
    fixmask = jnp.asarray(pad_vector(fixmask_np, nd_pad), dtype)
    u_fix = jnp.asarray(pad_vector(u_fix_np, nd_pad), dtype)
    lt = sysm.LoadTables.from_spec(model.loads, dtype)
    plan = asm_ops.build_scatter_plan(mesh.elnodes, nd_pad // 3)
    space = sysm.build_solve_space(mesh.coords, mesh.elnodes, fixmask, nd_pad)

    esm, pinv, glv, rhs, gpc, vol, ls = jax.block_until_ready(
        sysm.assemble_elastic(coords, eln, dmat, lt, jnp.asarray(0.0, dtype),
                              fixmask, u_fix, plan)
    )
    cfg = get_config()
    pc = jax.block_until_ready(
        sysm.build_precond(esm, eln, coords, fixmask,
                           cfg.resolve_cluster_size(mesh.n_nodes), space=space)
    )

    RTOL = 1e-5
    MAXITER = 5000

    def solve(b, defl=None, x0=None):
        return sysm.solve_displacement(
            esm, eln, fixmask, pc, b, RTOL, MAXITER, x0=x0, plan=plan,
            space=space, defl=defl,
        )

    def timed(fn, *a, **k):
        r = jax.block_until_ready(fn(*a, **k))
        t0 = time.perf_counter()
        r = jax.block_until_ready(fn(*a, **k))
        return r, time.perf_counter() - t0

    # --- deflation space, two-pass harvest (same as driver) ---------------
    k, nstore = cfg.deflation_k, cfg.deflation_nstore
    res1, h1 = sysm.solve_displacement_harvest(
        esm, eln, fixmask, pc, rhs, RTOL, MAXITER, plan=plan, space=space,
        nstore=nstore,
    )
    coef1 = defl_ops.ritz_coefficients(h1.alphas, h1.betas, h1.rzs,
                                       int(res1.iters), k)
    defl1 = sysm.build_deflation(esm, eln, fixmask, h1.zs,
                                 jnp.asarray(coef1), plan=plan, space=space)
    w1 = defl1.w
    res2, h2 = sysm.solve_displacement_harvest(
        esm, eln, fixmask, pc, rhs, RTOL, MAXITER, plan=plan, space=space,
        defl=defl1, nstore=nstore,
    )
    coef2 = defl_ops.ritz_coefficients(h2.alphas, h2.betas, h2.rzs,
                                       int(res2.iters), k)
    w2 = defl_ops.build_w(h2.zs, jnp.asarray(coef2), space.fixmask_m)
    w = jnp.concatenate([w1, w2], axis=1)
    defl = sysm.regalerkin_deflation(esm, eln, fixmask, w, plan=plan,
                                     space=space)
    log(f"harvests: {int(res1.iters)} + {int(res2.iters)} iters, "
        f"k={w.shape[1]}")

    # --- 1. elastic-rhs solves --------------------------------------------
    r0, t0s = timed(solve, rhs)
    rD, tDs = timed(solve, rhs, defl=defl)
    log(f"elastic rhs  undeflated: {int(r0.iters):4d} iters {t0s*1e3:7.1f} ms "
        f"relres {float(r0.relres):.2e}")
    log(f"elastic rhs  deflated  : {int(rD.iters):4d} iters {tDs*1e3:7.1f} ms "
        f"relres {float(rD.relres):.2e}")

    # --- 2. plastic-residual rhs ------------------------------------------
    ue = r0.x
    ne = mesh.n_elements
    sig_yield = jnp.full((ne, 4), bench.SY, dtype)
    zeros6 = jnp.zeros((ne, 4, 6), dtype)
    et = jnp.asarray(bench.ET_E, dtype)
    qnorm = jnp.asarray(float(jnp.linalg.norm(glv)), dtype)
    lbd0 = 2.45
    disp = lbd0 * ue
    sig0, _, _, _ = update_stress_load(
        coords, eln, dmat, 1e9 * sig_yield, jnp.zeros(nd_pad, dtype),
        disp, zeros6, e, nu, et, False, plan,
    )
    dl = 0.05
    du = dl * ue
    _, _, _, _, r, err = sysm.residual(
        coords, eln, dmat, sig_yield, disp, du, sig0, e, nu, et,
        glv, fixmask, jnp.asarray(lbd0 + dl, dtype), qnorm, False, plan,
    )
    r = jax.block_until_ready(r)
    log(f"plastic residual: err={float(err):.3e}")

    p0, tp0 = timed(solve, r)
    pD, tpD = timed(solve, r, defl=defl)
    log(f"plastic rhs  undeflated: {int(p0.iters):4d} iters {tp0*1e3:7.1f} ms "
        f"relres {float(p0.relres):.2e}")
    log(f"plastic rhs  deflated  : {int(pD.iters):4d} iters {tpD*1e3:7.1f} ms "
        f"relres {float(pD.relres):.2e}")

    # second/third NR-style residuals (smaller, more localized rhs)
    du2 = du + 0.1 * p0.x
    _, _, _, _, r2, err2 = sysm.residual(
        coords, eln, dmat, sig_yield, disp, du2, sig0, e, nu, et,
        glv, fixmask, jnp.asarray(lbd0 + dl, dtype), qnorm, False, plan,
    )
    r2 = jax.block_until_ready(r2)
    q0, tq0 = timed(solve, r2)
    qD, tqD = timed(solve, r2, defl=defl)
    log(f"NR-2 rhs     undeflated: {int(q0.iters):4d} iters {tq0*1e3:7.1f} ms "
        f"relres {float(q0.relres):.2e}")
    log(f"NR-2 rhs     deflated  : {int(qD.iters):4d} iters {tqD*1e3:7.1f} ms "
        f"relres {float(qD.relres):.2e}")

    # --- per-iteration overhead of the correction -------------------------
    dt_el = (tDs / max(int(rD.iters), 1)) - (t0s / max(int(r0.iters), 1))
    log(f"per-iteration delta (elastic): {dt_el*1e3:+.2f} ms")


if __name__ == "__main__" and os.environ.get("PROBE", "") == "":
    main()


def probe_plastic_harvest():
    """Harvest from a plastic-residual solve; does it deflate later ones?"""
    import jax
    import jax.numpy as jnp

    from fcvm_tpu.ops import assembly as asm_ops
    from fcvm_tpu.ops import deflation as defl_ops
    from fcvm_tpu.ops import material as mat
    from fcvm_tpu.ops.stress_update import update_stress_load
    from fcvm_tpu.runtime import system as sysm
    from fcvm_tpu.utils.indexing import pad_ndof, pad_vector

    import bench

    dtype = jnp.float32
    nx = int(os.environ.get("FCVM_BENCH_NX", "27"))
    mesh, model = bench.build(nx)
    coords = jnp.asarray(mesh.coords, dtype)
    eln = jnp.asarray(mesh.elnodes)
    e = jnp.asarray(bench.E, dtype)
    nu = jnp.asarray(bench.NU, dtype)
    dmat = mat.hooke_dmat(e, nu)
    fixmask_np, u_fix_np, _ = model.bcs.masks(mesh.ndof)
    nd_pad = pad_ndof(mesh.ndof)
    fixmask = jnp.asarray(pad_vector(fixmask_np, nd_pad), dtype)
    u_fix = jnp.asarray(pad_vector(u_fix_np, nd_pad), dtype)
    lt = sysm.LoadTables.from_spec(model.loads, dtype)
    plan = asm_ops.build_scatter_plan(mesh.elnodes, nd_pad // 3)
    space = sysm.build_solve_space(mesh.coords, mesh.elnodes, fixmask, nd_pad)
    esm, pinv, glv, rhs, gpc, vol, ls = jax.block_until_ready(
        sysm.assemble_elastic(coords, eln, dmat, lt, jnp.asarray(0.0, dtype),
                              fixmask, u_fix, plan)
    )
    cfg = get_config()
    pc = jax.block_until_ready(
        sysm.build_precond(esm, eln, coords, fixmask,
                           cfg.resolve_cluster_size(mesh.n_nodes), space=space)
    )
    RTOL, MAXITER = 1e-5, 5000

    def solve(b, defl=None):
        return sysm.solve_displacement(esm, eln, fixmask, pc, b, RTOL,
                                       MAXITER, plan=plan, space=space,
                                       defl=defl)

    def harvest(b, defl=None, ret_h=False):
        res, h = sysm.solve_displacement_harvest(
            esm, eln, fixmask, pc, b, RTOL, MAXITER, plan=plan, space=space,
            defl=defl, nstore=cfg.deflation_nstore,
        )
        coef = defl_ops.ritz_coefficients(h.alphas, h.betas, h.rzs,
                                          int(res.iters), cfg.deflation_k)
        w = None if coef is None else defl_ops.build_w(
            h.zs, jnp.asarray(coef), space.fixmask_m)
        if ret_h:
            return res, w, h
        return res, w

    def mkdefl(w):
        return sysm.regalerkin_deflation(esm, eln, fixmask, w, plan=plan,
                                         space=space)

    ue = solve(rhs).x
    ne = mesh.n_elements
    sig_yield = jnp.full((ne, 4), bench.SY, dtype)
    zeros6 = jnp.zeros((ne, 4, 6), dtype)
    et = jnp.asarray(bench.ET_E, dtype)
    qnorm = jnp.asarray(float(jnp.linalg.norm(glv)), dtype)
    lbd0 = 2.45
    disp = lbd0 * ue
    sig0, _, _, _ = update_stress_load(
        coords, eln, dmat, 1e9 * sig_yield, jnp.zeros(nd_pad, dtype),
        disp, zeros6, e, nu, et, False, plan,
    )
    dl = 0.05
    du = dl * ue
    _, _, _, _, r, _ = sysm.residual(
        coords, eln, dmat, sig_yield, disp, du, sig0, e, nu, et,
        glv, fixmask, jnp.asarray(lbd0 + dl, dtype), qnorm, False, plan,
    )
    res_p1, w1, h_p1 = harvest(r, ret_h=True)
    log(f"plastic harvest 1: {int(res_p1.iters)} iters")
    d1 = mkdefl(w1)
    res_p2, w2 = harvest(r, defl=d1)
    log(f"plastic harvest 2 (deflated): {int(res_p2.iters)} iters")
    d2 = mkdefl(jnp.concatenate([w1, w2], axis=1)) if w2 is not None else d1

    du2 = du + 0.1 * res_p1.x
    _, _, _, _, r2, _ = sysm.residual(
        coords, eln, dmat, sig_yield, disp, du2, sig0, e, nu, et,
        glv, fixmask, jnp.asarray(lbd0 + dl, dtype), qnorm, False, plan,
    )
    a = solve(r2)
    b2 = solve(r2, defl=d1)
    c = solve(r2, defl=d2)
    log(f"NR-2 rhs: undeflated {int(a.iters)}, plastic-harvest k=32 "
        f"{int(b2.iters)}, k=64 {int(c.iters)} iters")

    # --- variants: initial-guess projection (no per-iteration overhead),
    # and a cheaper k=16 space -------------------------------------------
    import time as _t

    def timed(fn, *args, **kw):
        rr = jax.block_until_ready(fn(*args, **kw))
        t0 = _t.perf_counter()
        rr = jax.block_until_ready(fn(*args, **kw))
        return rr, _t.perf_counter() - t0

    def solve_x0proj(b, d):
        x0 = sysm.deflation_x0(b, d, space=space)
        return sysm.solve_displacement(
            esm, eln, fixmask, pc, b, RTOL, MAXITER, x0=x0, plan=plan,
            space=space,
        )

    ra, ta = timed(solve, r2)
    rb, tb = timed(solve, r2, defl=d1)
    rp, tp2 = timed(solve_x0proj, r2, d1)
    coef16 = defl_ops.ritz_coefficients(h_p1.alphas, h_p1.betas, h_p1.rzs,
                                        int(res_p1.iters), 16)
    d16 = sysm.build_deflation(esm, eln, fixmask, h_p1.zs,
                               jnp.asarray(coef16), plan=plan, space=space)
    r16, t16 = timed(solve, r2, defl=d16)
    log(f"NR-2 timed: undeflated {int(ra.iters)} it {ta*1e3:.0f} ms | "
        f"defl k=32 {int(rb.iters)} it {tb*1e3:.0f} ms | "
        f"x0-proj {int(rp.iters)} it {tp2*1e3:.0f} ms | "
        f"defl k=16 {int(r16.iters)} it {t16*1e3:.0f} ms")


if __name__ == "__main__" and os.environ.get("PROBE") == "plastic":
    probe_plastic_harvest()
