"""Measure the GNL tangent-predictor levers at 499k dof on device.

In the collapse regime every NR iteration runs tangent_refresh (reassembly
+ predictor solve) plus a correction solve.  This probe isolates the
predictor-solve cost under three policies:

  a) cold:   x0 = 0, undeflated
  b) warm:   x0 = previous predictor        (successive tangents differ by
             one Newton update; the rtol*||b|| criterion pays directly)
  c) warm+W: warm start + load-rhs-harvested Ritz basis re-Galerkined
             against the fresh tangent in-jit (the production policy)

Run: PROBE=gnl timeout 900 python tools/gnl_refresh_probe.py
"""

import os
import sys
import time

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fcvm_tpu.config import enable_compilation_cache, get_config

enable_compilation_cache()


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    from bench import E, ET_E, NU, SY, build

    import numpy as np

    from fcvm_tpu.ops import assembly as asm_ops
    from fcvm_tpu.ops import material as mat
    from fcvm_tpu.ops import deflation as defl_ops
    from fcvm_tpu.ops.stress_update import update_stress_load
    from fcvm_tpu.runtime import system as sysm
    from fcvm_tpu.utils.indexing import pad_ndof, pad_vector

    nx = int(os.environ.get("FCVM_BENCH_NX", "27"))
    dtype = jnp.float32
    mesh, model = build(nx)
    log(f"mesh: ndof={mesh.ndof}")
    coords = jnp.asarray(mesh.coords, dtype)
    eln = jnp.asarray(mesh.elnodes)
    e = jnp.asarray(E, dtype)
    nu = jnp.asarray(NU, dtype)
    dmat = mat.hooke_dmat(e, nu)
    g = e / (2.0 * (1.0 + nu))
    et = jnp.asarray(ET_E, dtype)
    h = mat.hardening_modulus(e, et)
    fixmask_np, u_fix_np, _ = model.bcs.masks(mesh.ndof)
    nd_pad = pad_ndof(mesh.ndof)
    fixmask = jnp.asarray(pad_vector(fixmask_np, nd_pad), dtype)
    u_fix = jnp.asarray(pad_vector(u_fix_np, nd_pad), dtype)
    lt = sysm.LoadTables.from_spec(model.loads, dtype)
    plan = asm_ops.build_scatter_plan(mesh.elnodes, nd_pad // 3)
    space = sysm.build_solve_space(mesh.coords, mesh.elnodes, fixmask, nd_pad)
    cfg = get_config()

    esm, pinv, glv, rhs, gpc, vol, ls = sysm.assemble_elastic(
        coords, eln, dmat, lt, jnp.asarray(0.0, dtype), fixmask, u_fix, plan
    )
    pc = sysm.build_precond(esm, eln, coords, fixmask,
                            cfg.resolve_cluster_size(mesh.n_nodes),
                            space=space)
    RTOL, MAXITER = 1.0e-5, 5000
    ue = sysm.solve_displacement(esm, eln, fixmask, pc, rhs, RTOL, MAXITER,
                                 plan=plan, space=space).x

    # drive past yield, GNL state
    ne = mesh.n_elements
    sig_yield = jnp.full((ne, 4), SY, dtype)
    zeros6 = jnp.zeros((ne, 4, 6), dtype)
    lbd0 = 2.45
    disp = lbd0 * ue
    sig0, _, pgp, _ = update_stress_load(
        coords, eln, dmat, sig_yield, jnp.zeros(nd_pad, dtype), disp, zeros6,
        e, nu, et, True, plan,
    )
    du = 0.05 * ue

    def refresh(disp_new, du_, pc_, ue0=None, w=None, solve_predictor=True):
        return sysm.tangent_refresh(
            coords, eln, dmat, sig0, pgp, disp_new, du_, lt,
            jnp.asarray(0.0, dtype), fixmask, u_fix, g, h, RTOL, MAXITER,
            pc=pc_, plan=plan, space=space, ue0=ue0, w=w,
            solve_predictor=solve_predictor,
        )

    def timed(fn):
        r = jax.block_until_ready(fn())  # compile
        t0 = time.perf_counter()
        r = jax.block_until_ready(fn())
        return r, time.perf_counter() - t0

    # two successive NR states (disp grows a bit between refreshes)
    d1 = disp
    d2 = disp + 0.3 * du

    # (a) cold refresh at state 2
    (_, _, _, ue_a, it_a), t_a = timed(lambda: refresh(d2, du, pc))

    # predictor at state 1 to produce the warm seed + harvest
    esm1, pc1, glv1, rhs1, it0 = refresh(d1, du, pc, solve_predictor=False)
    res1, h1 = sysm.solve_displacement_harvest(
        esm1, eln, fixmask, pc1, rhs1, RTOL, MAXITER, plan=plan, space=space,
        nstore=cfg.deflation_nstore,
    )
    ue1 = res1.x
    coef = defl_ops.ritz_coefficients(
        *jax.device_get((h1.alphas, h1.betas, h1.rzs)), int(res1.iters),
        cfg.deflation_k,
    )
    w = defl_ops.build_w(h1.zs, jnp.asarray(coef), space.fixmask_m)
    log(f"state-1 predictor harvest: {int(res1.iters)} iters")

    # (b) warm refresh at state 2
    (_, _, _, ue_b, it_b), t_b = timed(lambda: refresh(d2, du, pc, ue0=ue1))
    # (c) warm + load-deflation
    (_, _, _, ue_c, it_c), t_c = timed(
        lambda: refresh(d2, du, pc, ue0=ue1, w=w)
    )
    # (d) deflation only (cold x0)
    (_, _, _, ue_d, it_d), t_d = timed(lambda: refresh(d2, du, pc, w=w))

    log(f"tangent refresh at 499k (assembly+precond+predictor):")
    log(f"  cold:    {int(it_a)} iters, {t_a*1e3:.0f} ms")
    log(f"  warm:    {int(it_b)} iters, {t_b*1e3:.0f} ms")
    log(f"  warm+W:  {int(it_c)} iters, {t_c*1e3:.0f} ms")
    log(f"  W only:  {int(it_d)} iters, {t_d*1e3:.0f} ms")
    ref = np.asarray(jax.device_get(ue_a))
    for name, u in (("warm", ue_b), ("warm+W", ue_c), ("W", ue_d)):
        err = float(np.max(np.abs(np.asarray(u) - ref))
                    / max(float(np.max(np.abs(ref))), 1e-30))
        log(f"  {name} vs cold solution: rel {err:.2e}")


if __name__ == "__main__" and os.environ.get("PROBE") == "gnl":
    main()
