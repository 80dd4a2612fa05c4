"""Sharded-vs-local K_hat matvec cost on one device (chained, honest).

Measures the per-application cost of the sharded backend's `_khat_m`
(shard_map on a 1-device mesh) against the local `make_bc_matvec`, both at
the bench mesh size: ITERS dependent applications chained inside one
`lax.fori_loop` per jit call, result fetched to host.

Motivation: the sharded reduce was `segment_sum` while the local path uses
a ScatterPlan; the per-shard plan (ops.assembly.build_sharded_scatter_plans)
should close that gap.
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
from fcvm_tpu.models import meshgen
from fcvm_tpu.ops import assembly as asm

NX = 27  # bench headline mesh: 499k dof
ITERS = 50


def build(nx):
    l = 10.0
    mesh = meshgen.box_tet10(nx, nx, nx, l, l, l)
    bcs = fcvm_tpu.BoundaryConditions.from_node_sets(
        [(mesh.select_nodes(lambda x, y, z: x < 1e-9), (0.0, 0.0, 0.0))]
    )
    faces = mesh.faces_on(lambda x, y, z: x > l - 1e-9)
    loads = fcvm_tpu.Loads(
        traction_faces=faces, tractions=np.tile([100.0, 0, 0], (len(faces), 1))
    )
    return mesh, fcvm_tpu.Model(
        mesh, fcvm_tpu.Material(210000.0, 0.3), bcs, loads, name="mvprobe"
    )


def chain_time(fn, args, u0, label):
    """fn(args..., u) -> u, applied ITERS times inside one jit."""

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

    # local tier.  The element blocks MUST be jit arguments, not closures
    # (a closure embeds >=100 MB of program constants), so the
    # matvec is constructed INSIDE the jitted chain from the esm argument.
    from fcvm_tpu.runtime.backend import LocalSystem

    loc = LocalSystem(model, cfg, dtype)
    esm_l, pinv, glv, rhs, _, _, _ = loc.assemble(mesh.coords)
    space = loc.space
    esm_m = esm_l[space.eperm]
    eldofs = asm.element_dof_ids(space.elnodes_m)
    u0 = jnp.asarray(
        np.random.default_rng(0).standard_normal(loc.ndof_pad), dtype
    )
    t_loc = chain_time(
        lambda esm, u: asm.make_bc_matvec(
            esm, eldofs, space.fixmask_m, space.plan_m
        )(u),
        (esm_m,), u0, "local  K_hat (plan)",
    )
    del esm_l, esm_m

    # sharded tier, 1-device mesh
    old = cfg.force_sharded
    cfg.force_sharded = True
    try:
        from fcvm_tpu.parallel.system import ShardedSystem

        sh = ShardedSystem(model, cfg, dtype)
    finally:
        cfg.force_sharded = old
    esm_s, *_ = sh.assemble(mesh.coords)
    t_sh = chain_time(
        lambda esm, eln, plan, u: sh._khat_m(esm, eln, plan, u),
        (esm_s, sh.eln_m_s, sh._plan_m), u0, "sharded K_hat (plan)",
    )
    print(f"sharded/local ratio: {t_sh / t_loc:.2f}x")


if __name__ == "__main__":
    main()
