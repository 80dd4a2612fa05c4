"""The background AOT prewarm must mirror the real build's jit signatures.

A prewarm entry whose aval (shape / dtype / static args) differs from what
``build_two_level`` actually calls compiles a *useless* executable and the
first build pays the compile anyway — so these tests assert
signature identity against a real build, including the blocked-Schur
recursion shapes (exercised with a small ``large_dim_threshold``).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np

from fcvm_tpu.config import get_config
from fcvm_tpu.models import meshgen
from fcvm_tpu.models.spec import BoundaryConditions, Loads
from fcvm_tpu.ops import material as mat
from fcvm_tpu.ops import precond as pre
from fcvm_tpu.runtime import system as sysm
from fcvm_tpu.runtime.prewarm import (
    precond_prewarm_entries,
    start_precond_prewarm,
)
from fcvm_tpu.utils.indexing import pad_ndof, pad_vector

E, NU, L = 210000.0, 0.3, 10.0


def _system(n=3, dtype=jnp.float64):
    mesh = meshgen.box_tet10(n, n, n, L, L, L)
    fixed = mesh.select_nodes(lambda x, y, z: x < 1e-9)
    bcs = BoundaryConditions.from_node_sets([(fixed, (0.0, 0.0, 0.0))])
    faces = mesh.faces_on(lambda x, y, z: x > L - 1e-9)
    loads = Loads(
        traction_faces=faces, tractions=np.tile([100.0, 0, 0], (len(faces), 1))
    )
    coords = jnp.asarray(mesh.coords, dtype)
    eln = jnp.asarray(mesh.elnodes, jnp.int32)
    dmat = mat.hooke_dmat(jnp.asarray(E, dtype), jnp.asarray(NU, dtype))
    fixmask_np, u_fix_np, _ = bcs.masks(mesh.ndof)
    nd_pad = pad_ndof(mesh.ndof)
    fixmask = jnp.asarray(pad_vector(fixmask_np, nd_pad), dtype)
    u_fix = jnp.asarray(pad_vector(u_fix_np, nd_pad), dtype)
    lt = sysm.LoadTables.from_spec(loads, dtype)
    esm = sysm.assemble_elastic(
        coords, eln, dmat, lt, jnp.asarray(0.0, dtype), fixmask, u_fix
    )[0]
    space = sysm.build_solve_space(mesh.coords, mesh.elnodes, fixmask, nd_pad)
    return mesh, esm, space, nd_pad, dtype


def _sig(x):
    return (tuple(x.shape), jnp.dtype(x.dtype))


def test_prewarm_entries_match_real_build_inputs():
    mesh, esm, space, nd_pad, dtype = _system()
    cfg = get_config()
    cs = cfg.resolve_cluster_size(mesh.n_nodes)
    nm = cfg.coarse_modes

    entries = {
        name: avals
        for name, fn, avals in precond_prewarm_entries(
            mesh.n_nodes, mesh.n_elements, nd_pad, cs, nm, dtype
        )
    }

    # real build stage inputs, exactly as build_two_level produces them
    esm_m = esm[space.eperm]
    assert [_sig(a) for a in entries["block_jacobi"]] == [
        _sig(esm_m), _sig(space.elnodes_m), _sig(space.fixmask_m)
    ]
    coords_aval, fixmask_aval, cs_got, nm_got = entries["qmat_bc"]
    assert _sig(coords_aval) == _sig(space.coords_m)
    assert _sig(fixmask_aval) == _sig(space.fixmask_m)
    assert (cs_got, nm_got) == (cs, nm)

    qmat = pre._qmat_bc_jit(space.coords_m, space.fixmask_m, cs, nm)
    esm_aval, eln_aval, qmat_aval, cs_got = entries["coarse_accumulate"]
    assert _sig(qmat_aval) == _sig(qmat)
    assert cs_got == cs

    kc = pre._coarse_accumulate_jit(esm_m, space.elnodes_m, qmat, cs)
    # small mesh -> n6 <= 9216 -> the fused single-jit invert path
    kc_aval, ridge_aval = entries["coarse_densify_invert"]
    assert _sig(kc_aval) == _sig(kc)
    ridge_real = jnp.asarray(3.0e-4, kc.dtype)
    assert _sig(ridge_aval) == _sig(ridge_real)
    assert not ridge_real.weak_type


def test_prewarm_mirrors_blocked_schur_recursion(monkeypatch):
    """With a small fused limit the recursion shapes must match the calls
    _blocked_spd_inverse actually makes (recorded via wrappers)."""
    mesh, esm, space, nd_pad, dtype = _system()
    cfg = get_config()
    cs = cfg.resolve_cluster_size(mesh.n_nodes)
    nm = cfg.coarse_modes
    qmat = pre._qmat_bc_jit(space.coords_m, space.fixmask_m, cs, nm)
    kc = pre._coarse_accumulate_jit(esm[space.eperm], space.elnodes_m, qmat, cs)
    n6 = nm * (qmat.shape[0] // cs)
    limit = max(64, n6 // 3)  # force two recursion levels
    assert n6 > limit

    calls = []
    real_fused = pre._fused_spd_inv32
    real_sc = pre._schur_complement
    real_sa = pre._schur_assemble
    real_ns = pre._newton_schulz_refine

    def rec(name, real):
        def wrapper(*args):
            calls.append((name, tuple(_sig(a) for a in args)))
            return real(*args)
        return wrapper

    monkeypatch.setattr(pre, "_fused_spd_inv32", rec("fused", real_fused))
    monkeypatch.setattr(pre, "_schur_complement", rec("schur_c", real_sc))
    monkeypatch.setattr(pre, "_schur_assemble", rec("schur_a", real_sa))
    monkeypatch.setattr(pre, "_newton_schulz_refine", rec("ns", real_ns))

    pre.coarse_invert(kc, jnp.asarray(3.0e-4, kc.dtype),
                      large_dim_threshold=limit)

    predicted = []
    for name, fn, avals in precond_prewarm_entries(
        mesh.n_nodes, mesh.n_elements, nd_pad, cs, nm, dtype,
        large_dim_threshold=limit,
    ):
        if name.startswith("fused"):
            predicted.append(("fused", tuple(_sig(a) for a in avals)))
        elif name == "schur_complement":
            predicted.append(("schur_c", tuple(_sig(a) for a in avals)))
        elif name == "schur_assemble":
            predicted.append(("schur_a", tuple(_sig(a) for a in avals)))
        elif name == "newton_schulz":
            predicted.append(("ns", tuple(_sig(a) for a in avals)))
    assert predicted == calls


def test_start_precond_prewarm_compiles_and_build_still_works():
    mesh, esm, space, nd_pad, dtype = _system()
    cfg = get_config()
    cs = cfg.resolve_cluster_size(mesh.n_nodes)
    errors = []
    thread = start_precond_prewarm(
        mesh.n_nodes, mesh.n_elements, nd_pad, cs, cfg.coarse_modes, dtype,
        log=errors.append,
    )
    assert isinstance(thread, threading.Thread)
    thread.join(timeout=300)
    assert not thread.is_alive()
    # every entry compiled (the log line reports n/n)
    assert errors and errors[-1].startswith("precond prewarm: ")
    n_done, n_total = errors[-1].split(": ")[1].split(" ")[0].split("/")
    assert n_done == n_total
    assert len(errors) == 1  # no per-entry failure lines
    # the real build runs fine afterwards and is usable
    pc = sysm.build_precond(
        esm, space.elnodes_m, space.coords_m, space.fixmask_m, cs, space=space
    )
    z = pc.apply(jnp.ones(space.fixmask_m.shape[0], dtype))
    assert bool(jnp.all(jnp.isfinite(z)))
