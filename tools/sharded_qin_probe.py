"""Sharded stress-update qin reduce: per-shard ScatterPlan vs segment_sum.

The sharded backend's Newton residual rebuilds the internal force once per
NR iteration: vmapped element stress update -> node reduce of the (ne, 30)
element force rows in USER node order.  The reduce was `segment_sum`;
this probe measures it against the per-shard ScatterPlan head-to-head on
one device, plus the full residual for context.

Measurement discipline: ITERS dependent applications chained inside one
jit, result fetched to host.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

import fcvm_tpu
from fcvm_tpu.config import get_config, enable_compilation_cache
from fcvm_tpu.ops import assembly as asm

from sharded_mv_probe import build, NX

NX = int(os.environ.get("FCVM_PROBE_NX", NX))
ITERS = 50


def chain_time(fn, args, u0, label):
    @jax.jit
    def run(u, *a):
        def body(_, uu):
            y = fn(*a, uu)
            return y / jnp.maximum(jnp.linalg.norm(y), 1e-30)

        return jax.lax.fori_loop(0, ITERS, body, u)

    out = run(u0, *args)
    float(jnp.sum(out))  # compile + claim
    best = np.inf
    for rep in range(3):
        u = u0 * (1.0 + 1e-6 * (rep + 1))
        t0 = time.perf_counter()
        out = run(u, *args)
        float(jnp.sum(out))
        best = min(best, (time.perf_counter() - t0) / ITERS)
    print(f"{label}: {best * 1e3:.2f} ms/application")
    return best


def main():
    enable_compilation_cache()
    cfg = get_config()
    mesh, model = build(NX)
    print(f"mesh: nn={mesh.n_nodes} ne={mesh.n_elements} ndof={mesh.ndof}")
    dtype = jnp.float32

    old = cfg.force_sharded
    cfg.force_sharded = True
    try:
        from fcvm_tpu.parallel.system import ShardedSystem

        sh = ShardedSystem(model, cfg, dtype)
    finally:
        cfg.force_sharded = old

    from jax.sharding import PartitionSpec as P

    nn_pad = sh.nn_pad
    rng = np.random.default_rng(0)

    # (a) reduce via per-shard plan (the shipped path); chained over a node
    # vector u: elv rows are re-gathered from u so the chain is dependent
    def reduce_plan():
        def fn(eln_l, plan_l, u_r):
            ne_l = eln_l.shape[0]
            elv = u_r.reshape(nn_pad, 3)[eln_l].reshape(ne_l, 30)
            incs_l, invp_l = plan_l
            qin3 = asm.scatter_node_rows_padded(
                elv.reshape(-1, 3), [a[0] for a in incs_l], invp_l[0]
            )
            return jax.lax.psum(qin3, "e").reshape(-1)

        return sh._smap(fn, (P("e"), P("e"), P()), P())

    def reduce_seg():
        def fn(eln_l, u_r):
            ne_l = eln_l.shape[0]
            elv = u_r.reshape(nn_pad, 3)[eln_l].reshape(ne_l, 30)
            qin3 = jax.ops.segment_sum(
                elv.reshape(-1, 3), eln_l.reshape(-1), num_segments=nn_pad
            )
            return jax.lax.psum(qin3, "e").reshape(-1)

        return sh._smap(fn, (P("e"), P()), P())

    u0 = jnp.asarray(rng.standard_normal(sh.ndof_pad), dtype)
    plan_fn = reduce_plan()
    seg_fn = reduce_seg()
    t_plan = chain_time(
        lambda eln, plan, u: plan_fn(eln, plan, u),
        (sh.eln_s, sh._plan_u), u0, "gather+reduce (plan)     ",
    )
    t_seg = chain_time(
        lambda eln, u: seg_fn(eln, u),
        (sh.eln_s,), u0, "gather+reduce (segment_sum)",
    )
    print(f"segment_sum/plan ratio: {t_seg / t_plan:.2f}x")

    # full residual for context (chained on du)
    sig_yield = sh.gauss_full(240.0)
    sig_old = sh.gauss_zeros((6,))
    glv = jnp.zeros(sh.ndof_pad, dtype)

    def resid_fn(du):
        _, _, _, qin, r, _ = sh.residual(
            mesh.coords.astype(np.float32), sig_yield, du, du, sig_old, glv,
            1.0, 1.0, 0.0, True,
        )
        return qin

    u = u0 * 1e-8
    t0 = time.perf_counter()
    for _ in range(3):
        u = resid_fn(u)
        u = u / jnp.maximum(jnp.linalg.norm(u), 1e-30) * 1e-8
    float(jnp.sum(u))
    t_first = time.perf_counter() - t0
    best = np.inf
    for rep in range(3):
        uu = u0 * (1e-8 + 1e-12 * rep)
        t0 = time.perf_counter()
        for _ in range(5):
            uu = resid_fn(uu)
            uu = uu / jnp.maximum(jnp.linalg.norm(uu), 1e-30) * 1e-8
        float(jnp.sum(uu))
        best = min(best, (time.perf_counter() - t0) / 5)
    print(f"full sharded residual (GNL): {best * 1e3:.2f} ms "
          f"(first-3 incl. compile {t_first:.1f} s)")


if __name__ == "__main__":
    main()
