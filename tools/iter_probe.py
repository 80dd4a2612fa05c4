"""Honest per-stage breakdown of the production CG iteration on device.

Rebuilds the bench mesh/operator (nx from FCVM_BENCH_NX, default 27 ->
499k dof) exactly as bench.py does, then times each stage of the Morton-space
CG iteration with the chained-``fori_loop`` + host-fetch discipline (each
stage's output feeds the next application, so XLA can neither hoist nor
elide the work).

Stages:
  1. input row gather            u3 = u.reshape(nn,3)[elnodes_m]
  2. gather + block einsum       fe = einsum(esm4, u3)
  3. full matvec                 bc-masked gather/einsum/ScatterPlan reduce
  4. block-Jacobi apply
  5. two-level precond apply     (BJ + coarse projection + dense matvec)
  6. coarse dense matvec alone   coarse_inv @ v
  7. full PCG loop               solve_displacement at fixed maxiter
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

from fcvm_tpu.config import enable_compilation_cache, get_config

enable_compilation_cache()

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
os.chdir(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ".")
import bench  # reuse the bench mesh builder

from fcvm_tpu.ops import assembly as asm_ops
from fcvm_tpu.ops import material as mat
from fcvm_tpu.runtime import system as sysm
from fcvm_tpu.utils.indexing import pad_ndof, pad_vector


def log(*a):
    print(*a, flush=True)


def timeit_chain(step, state, iters, fetch, reps=4, consts=()):
    """``state = step(state, *consts)`` chained on device.

    ``consts`` (big operand arrays) are passed as jit ARGUMENTS — a closure
    would embed >100 MB arrays in the program as constants.
    """

    @jax.jit
    def run(state, *consts):
        state = jax.lax.fori_loop(0, iters, lambda i, s: step(s, *consts), state)
        return fetch(state), state

    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        scalar, state = run(state, *consts)
        float(scalar)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts[1:])) / iters


def main():
    nx = int(os.environ.get("FCVM_BENCH_NX", "27"))
    dtype = jnp.float32
    mesh, model = bench.build(nx)
    log(f"mesh: nn={mesh.n_nodes} ne={mesh.n_elements} ndof={mesh.ndof}")
    coords = jnp.asarray(mesh.coords, dtype)
    eln = jnp.asarray(mesh.elnodes)
    dmat = mat.hooke_dmat(jnp.asarray(bench.E, dtype), jnp.asarray(bench.NU, dtype))
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
    log(f"coarse dim: {pc.coarse_inv.shape[0]}")

    # Morton-space operator pieces, exactly as solve_displacement builds them
    esm_m = esm[space.eperm]
    eldofs = asm_ops.element_dof_ids(space.elnodes_m)
    elnodes_m = space.elnodes_m
    nn = nd_pad // 3
    esm4 = esm_m.reshape(-1, 10, 3, 30)
    ne = esm4.shape[0]

    u0 = space.to_m(rhs)

    # 1. input gather
    def g_step(u):
        u3 = u.reshape(nn, 3)[elnodes_m]
        return u * 0.999999 + 1e-12 * u3.sum()

    t = timeit_chain(g_step, u0, 64, lambda u: u[0])
    log(f"1. input gather:            {t*1e3:6.2f} ms")

    # 2. gather + einsum
    def ge_step(u, esm4):
        u3 = u.reshape(nn, 3)[elnodes_m]
        fe = jnp.einsum("eabj,ej->eab", esm4, u3.reshape(ne, 30))
        return u * 0.999999 + 1e-12 * fe.sum()

    t = timeit_chain(ge_step, u0, 64, lambda u: u[0], consts=(esm4,))
    log(f"2. gather + einsum:         {t*1e3:6.2f} ms")

    # 3. full bc matvec
    def mv_step(u, esm_m):
        mv = asm_ops.make_bc_matvec(
            esm_m, eldofs, space.fixmask_m, space.plan_m
        )
        return u * 0.999999 + 1e-9 * mv(u)

    t = timeit_chain(mv_step, u0, 64, lambda u: u[0], consts=(esm_m,))
    log(f"3. full matvec:             {t*1e3:6.2f} ms")

    # 4. block-Jacobi apply
    def bj_step(r):
        return r * 0.999999 + 1e-9 * asm_ops.apply_block_precond(pc.pinv, r)

    t = timeit_chain(bj_step, u0, 64, lambda r: r[0])
    log(f"4. block-Jacobi apply:      {t*1e3:6.2f} ms")

    # 5. two-level apply (coarse_inv is ~600 MB -> pass as jit arg)
    def tl_step(r, coarse_inv):
        z = pc._replace(coarse_inv=coarse_inv).apply(r)
        return r * 0.999999 + 1e-9 * z

    t = timeit_chain(tl_step, u0, 64, lambda r: r[0], consts=(pc.coarse_inv,))
    log(f"5. two-level apply:         {t*1e3:6.2f} ms")

    # 6. coarse dense matvec alone
    ncd = pc.coarse_inv.shape[0]
    v0 = jnp.ones((ncd,), dtype)

    def cd_step(v, coarse_inv):
        return v * 0.999999 + 1e-9 * (coarse_inv @ v)

    t = timeit_chain(cd_step, v0, 64, lambda v: v[0], consts=(pc.coarse_inv,))
    log(f"6. coarse dense matvec:     {t*1e3:6.2f} ms (dim {ncd})")

    # 7. full PCG at fixed iteration count (rtol=0 -> runs to maxiter)
    for maxiter in (50, 100):
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            res = sysm.solve_displacement(
                esm, eln, fixmask, pc, rhs, 0.0, maxiter, plan=plan, space=space
            )
            float(res.relres)
            ts.append(time.perf_counter() - t0)
        t = float(np.median(ts[1:]))
        log(f"7. pcg maxiter={maxiter}: {t*1e3:8.1f} ms total "
            f"({t/maxiter*1e3:6.2f} ms/iter incl. boundary)")
    # boundary cost estimate: difference between the two runs
    log("done")


if __name__ == "__main__":
    main()
