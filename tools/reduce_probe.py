"""Why does the ScatterPlan node reduce cost ~9.8 ms (7 ns/idx) when an
equivalent-count connectivity gather costs 2.9 ms (2.5 ns/idx)?

Experiments on the real 499k-dof bench connectivity (Morton solve space):

  r1. scatter_node_rows(fe, plan) as shipped (baseline)
  r2. per-bucket cost split (which degree bucket dominates)
  r3. flat 1D inc gather + reshape + sum (same indices, 1D index vector)
  r4. stream sort-gather fe_ext[srt] alone (the plan's indices are srt
      reordered into per-node windows — is it the *positions* or the
      *layout* that's slow?)
  r5. sorted stream + per-bucket windowed start-index dynamic_slice sums
  r6. node-major value stream: einsum writes (10, ne, 3) so slot-major
      stream positions srt_t = a*ne + e have long runs of consecutive
      elements per node-slot
  r7. plain segment_sum baseline (the thing ScatterPlan replaced)

Chained fori_loop + host fetch throughout (the state flows through every
measured op, so nothing can be hoisted out of the loop).
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.chdir(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

from fcvm_tpu.config import enable_compilation_cache

enable_compilation_cache()

import bench
from fcvm_tpu.ops import assembly as asm_ops
from fcvm_tpu.runtime import system as sysm
from fcvm_tpu.utils.indexing import pad_ndof, pad_vector


def log(*a):
    print(*a, flush=True)


def timeit_chain(step, state, iters, fetch, reps=4, consts=()):
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
    fixmask_np, _, _ = model.bcs.masks(mesh.ndof)
    nd_pad = pad_ndof(mesh.ndof)
    fixmask = jnp.asarray(pad_vector(fixmask_np, nd_pad), dtype)
    space = sysm.build_solve_space(mesh.coords, mesh.elnodes, fixmask, nd_pad)
    plan = space.plan_m
    eln_m = np.asarray(space.elnodes_m)
    ne = eln_m.shape[0]
    nn = nd_pad // 3
    nrows = ne * 10
    log(f"ne={ne} nn={nn} nrows={nrows}")
    log("plan buckets (count x cap): "
        + ", ".join(f"{n}x{inc.shape[1]}" for n, inc in zip(plan.node_counts, plan.inc)))
    total_idx = sum(int(i.shape[0] * i.shape[1]) for i in plan.inc)
    log(f"total inc indices: {total_idx} (+invperm {nn})")

    rng = np.random.default_rng(0)
    fe = jnp.asarray(rng.normal(size=(nrows, 3)).astype(np.float32))

    # r1: shipped plan
    def r1(fe):
        out = asm_ops.scatter_node_rows(fe, plan)
        return fe * 0.999999 + 1e-12 * out.sum()

    t = timeit_chain(r1, fe, 64, lambda f: f[0, 0])
    log(f"r1 shipped plan:            {t*1e3:6.2f} ms ({t/total_idx*1e9:.2f} ns/idx)")

    # r2: per-bucket gather+sum cost
    for bi, inc in enumerate(plan.inc):
        nidx = int(inc.shape[0] * inc.shape[1])

        def rb(fe, inc=inc):
            rows_ext = jnp.concatenate([fe, jnp.zeros((1, 3), fe.dtype)])
            s = rows_ext[inc].sum(axis=1)
            return fe * 0.999999 + 1e-12 * s.sum()

        t = timeit_chain(rb, fe, 32, lambda f: f[0, 0])
        log(f"r2 bucket {bi} ({inc.shape[0]}x{inc.shape[1]}): {t*1e3:6.2f} ms "
            f"({t/max(nidx,1)*1e9:.2f} ns/idx)")

    # r3: flat 1D inc gather + reshape + sum
    def r3(fe):
        rows_ext = jnp.concatenate([fe, jnp.zeros((1, 3), fe.dtype)])
        outs = []
        for inc in plan.inc:
            flat = inc.reshape(-1)
            g = rows_ext[flat].reshape(inc.shape[0], inc.shape[1], 3)
            outs.append(g.sum(axis=1))
        nz = plan.invperm.shape[0] - sum(o.shape[0] for o in outs)
        outs.append(jnp.zeros((nz, 3), fe.dtype))
        out = jnp.concatenate(outs)[plan.invperm]
        return fe * 0.999999 + 1e-12 * out.sum()

    t = timeit_chain(r3, fe, 64, lambda f: f[0, 0])
    log(f"r3 flat-1D inc:             {t*1e3:6.2f} ms")

    # r4: stream sort-gather alone
    flat = eln_m.reshape(-1)
    srt = np.argsort(flat, kind="stable").astype(np.int32)
    srt_j = jnp.asarray(srt)

    def r4(fe):
        s = fe[srt_j]
        return fe * 0.999999 + 1e-12 * s.sum()

    t = timeit_chain(r4, fe, 64, lambda f: f[0, 0])
    log(f"r4 sort-gather (1.18M):     {t*1e3:6.2f} ms ({t/nrows*1e9:.2f} ns/idx)")

    # r5: sorted stream + windowed per-bucket sums
    cnt = np.bincount(flat, minlength=nn)
    ofs = np.zeros(nn + 1, np.int64)
    np.cumsum(cnt, out=ofs[1:])
    # reuse plan bucket boundaries
    caps = [int(i.shape[1]) for i in plan.inc]
    node_groups = []
    lo = 0
    for cap in caps:
        nodes = np.where((cnt > lo) & (cnt <= cap))[0]
        lo = cap
        node_groups.append(nodes)
    starts = [jnp.asarray(ofs[nids].astype(np.int32)) for nids in node_groups]
    counts = [jnp.asarray(cnt[nids].astype(np.int32)) for nids in node_groups]

    def r5(fe):
        s = fe[srt_j]  # sorted stream, padded below
        sp = jnp.concatenate([s, jnp.zeros((max(caps), 3), fe.dtype)])
        outs = []
        for cap, st, ct in zip(caps, starts, counts):
            win = jax.vmap(
                lambda s0: jax.lax.dynamic_slice(sp, (s0, 0), (cap, 3))
            )(st)  # (nb, cap, 3)
            k = jnp.arange(cap)[None, :, None]
            win = jnp.where(k < ct[:, None, None], win, 0.0)
            outs.append(win.sum(axis=1))
        nz = plan.invperm.shape[0] - sum(o.shape[0] for o in outs)
        outs.append(jnp.zeros((nz, 3), fe.dtype))
        out = jnp.concatenate(outs)[plan.invperm]
        return fe * 0.999999 + 1e-12 * out.sum()

    t = timeit_chain(r5, fe, 64, lambda f: f[0, 0])
    log(f"r5 sorted+windows:          {t*1e3:6.2f} ms")

    # r6: slot-major stream order — per-node runs of consecutive elements
    srt_t = np.argsort(
        flat.reshape(ne, 10).T.reshape(-1), kind="stable"
    ).astype(np.int32)
    srt_t_j = jnp.asarray(srt_t)
    fe_t = jnp.asarray(rng.normal(size=(10 * ne, 3)).astype(np.float32))

    def r6(fe_t):
        s = fe_t[srt_t_j]
        return fe_t * 0.999999 + 1e-12 * s.sum()

    t = timeit_chain(r6, fe_t, 64, lambda f: f[0, 0])
    log(f"r6 slot-major sort-gather:  {t*1e3:6.2f} ms ({t/nrows*1e9:.2f} ns/idx)")

    # r7: segment_sum baseline
    seg = jnp.asarray(flat.astype(np.int32))

    def r7(fe):
        out = jax.ops.segment_sum(fe, seg, num_segments=nn)
        return fe * 0.999999 + 1e-12 * out.sum()

    t = timeit_chain(r7, fe, 32, lambda f: f[0, 0])
    log(f"r7 segment_sum:             {t*1e3:6.2f} ms")

    log("done")


if __name__ == "__main__":
    main()
