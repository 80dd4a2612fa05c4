"""Background AOT prewarm of the preconditioner-build executables.

The first two-level preconditioner build in a fresh process pays for
compiling (or loading from the persistent compile cache) its executables
before any of them runs; the dense coarse inverse is the largest of them.
That is host work, not device compute, so it can overlap the host-side
model setup and the first assembly instead of serializing after them.
``jax.jit(...).lower(avals).compile()`` populates the same executable
cache the normal call path uses and needs NO device memory — every shape
below is mirrored from the build inputs without allocating them.

The driver calls :func:`start_precond_prewarm` as soon as the solve space
exists (before the first device dispatch).  How much it saves on the H100
is an open measurement.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

import jax
import jax.numpy as jnp


def _aval(shape, dtype):
    return jax.ShapeDtypeStruct(tuple(shape), jnp.dtype(dtype))


def precond_prewarm_entries(n_nodes, ne, ndof_pad, cluster_size, n_modes,
                            dtype, large_dim_threshold: int = 9216):
    """The (jit_fn, avals) list of the two-level build, in call order.

    Shapes mirror :func:`fcvm_tpu.ops.precond.build_two_level` on the
    Morton solve-space views exactly (tests assert this against a real
    build): esm (ne, 30, 30), elnodes (ne, 10) int32, fixmask (ndof_pad,),
    coords (n_nodes, 3); the cluster-mode basis pads nodes to a multiple
    of ``cluster_size``.
    """
    from fcvm_tpu.ops import precond as pre

    dtype = jnp.dtype(dtype)
    nn_pad = ndof_pad // 3
    ncl = -(-nn_pad // cluster_size)
    nn_cl = ncl * cluster_size
    n6 = n_modes * ncl

    esm = _aval((ne, 30, 30), dtype)
    eln = _aval((ne, 10), jnp.int32)
    fixmask = _aval((ndof_pad,), dtype)
    coords = _aval((n_nodes, 3), dtype)
    qmat = _aval((nn_cl, 3, n_modes), dtype)
    kc = _aval((ncl * ncl, n_modes * n_modes), dtype)
    ridge = _aval((), dtype)

    entries = [
        ("block_jacobi", pre._block_jacobi_jit, (esm, eln, fixmask)),
        ("qmat_bc", pre._qmat_bc_jit, (coords, fixmask, cluster_size,
                                       n_modes)),
        ("coarse_accumulate", pre._coarse_accumulate_jit,
         (esm, eln, qmat, cluster_size)),
    ]
    if n6 <= large_dim_threshold:
        entries.append(
            ("coarse_densify_invert", pre._coarse_densify_invert, (kc, ridge))
        )
        return entries
    entries.append(
        ("coarse_densify_scale", pre._coarse_densify_scale, (kc, ridge))
    )
    f32 = jnp.dtype(jnp.float32)

    def recurse(n, dt):
        # mirrors pre._blocked_spd_inverse's shape recursion; the Schur
        # complement S is always f32 (cast inside _schur_complement), the
        # A block keeps the caller's dtype
        if n <= large_dim_threshold:
            entries.append(
                (f"fused_spd_inv32({n})", pre._fused_spd_inv32,
                 (_aval((n, n), dt),))
            )
            return
        h = (n + 1) // 2
        recurse(h, dt)
        a_inv = _aval((h, h), f32)
        b = _aval((h, n - h), dt)
        c = _aval((n - h, n - h), dt)
        entries.append(("schur_complement", pre._schur_complement,
                        (a_inv, b, c)))
        recurse(n - h, f32)
        s_inv = _aval((n - h, n - h), f32)
        entries.append(("schur_assemble", pre._schur_assemble,
                        (a_inv, b, s_inv)))

    recurse(n6, dtype)
    # the refinement runs on the full-size scaled matrix; its x input is
    # the f32 assembled inverse
    entries.append(("newton_schulz", pre._newton_schulz_refine,
                    (_aval((n6, n6), f32), _aval((n6, n6), dtype))))
    return entries


def _dedupe(entries):
    seen = set()
    out = []
    for name, fn, avals in entries:
        key = (id(fn), tuple(
            (a.shape, str(a.dtype)) if hasattr(a, "shape") else a
            for a in avals
        ))
        if key not in seen:
            seen.add(key)
            out.append((name, fn, avals))
    return out


def start_precond_prewarm(
    n_nodes: int,
    ne: int,
    ndof_pad: int,
    cluster_size: int,
    n_modes: int,
    dtype,
    log: Optional[Callable[[str], None]] = None,
) -> threading.Thread:
    """AOT-compile the two-level-build executables on a daemon thread.

    Launch as early as possible (shapes need only the mesh sizes + config)
    so the cold compiles overlap host setup and the first assembly.
    Compilation is C++ work that releases the GIL;
    a concurrent main-thread compile of the same signature is safe (JAX
    dedupes at the executable cache).  Failures are swallowed per entry —
    prewarm is an optimization, never a correctness dependency.
    """
    entries = _dedupe(precond_prewarm_entries(
        n_nodes, ne, ndof_pad, cluster_size, n_modes, dtype,
    ))

    def run():
        t0 = time.perf_counter()
        done = 0
        for name, fn, avals in entries:
            try:
                fn.lower(*avals).compile()
                done += 1
            except Exception as err:  # pragma: no cover - defensive
                if log is not None:
                    log(f"prewarm {name} failed: {type(err).__name__}: {err}")
        if log is not None:
            log(f"precond prewarm: {done}/{len(entries)} executables in "
                f"{time.perf_counter() - t0:.2f}s")

    thread = threading.Thread(target=run, name="fcvm-prewarm", daemon=True)
    thread.start()
    return thread
