"""Batched stiffness/tangent blocks, load integration, Dirichlet handling.

Matrix-free replacement for the reference's COO triplet assembly
(``source code/fcVM.py:620-1079``).  Instead of building a scipy CSC matrix
for a host Cholesky factorization, we keep the per-element 30x30 blocks in
device memory and expose ``K @ v`` as gather -> batched block matmul ->
node reduce (a gather-only :class:`ScatterPlan`, or XLA ``segment_sum``).

Dirichlet boundary conditions reproduce the reference's elimination scheme
(``fcVM.py:771-796``): the operator acts as identity on fixed dofs and the
right-hand side carries ``modf = -(K u_fix)_free + u_fix`` so prescribed
displacements enter the elastic predictor exactly as in the reference.
(Divergence, documented: the reference accumulates one ``1.0`` diagonal entry
per adjacent element for a fixed dof, scaling both the diagonal and the RHS
by the element count; the solution is identical.)
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from fcvm_tpu.ops import elements as el
from fcvm_tpu.ops import material as mat
from fcvm_tpu.utils.linalg3 import det3, inv3_spd


def formation_precision():
    """Einsum precision for element-block formation and geometry.

    Default HIGHEST: at a reduced-precision f32 default (bf16 passes, or
    TF32 on a GPU) the formed blocks disagree with the full-precision
    stress-route internal force at ~1e-2 on badly-scaled meshes (the
    Embankment soil replay diverged).
    ``config.formation_precision = "default"`` restores the fast path for
    A/B measurement.  Resolved at trace time.
    """
    from fcvm_tpu.config import get_config

    mode = getattr(get_config(), "formation_precision", "highest")
    return None if mode == "default" else jax.lax.Precision.HIGHEST


def element_dof_ids(elnodes: jnp.ndarray) -> jnp.ndarray:
    """(ne, 30) global dof indices from 0-based connectivity (ne, 10)."""
    return (3 * elnodes[:, :, None] + jnp.arange(3)[None, None, :]).reshape(
        elnodes.shape[0], 30
    )


# ---------------------------------------------------------------------------
# Element stiffness blocks
# ---------------------------------------------------------------------------


def _single_elastic_esm(coords_el, dmat):
    det, _, bmat = el.tet10_element_geometry(coords_el)
    w = jnp.asarray(el.W10, dtype=coords_el.dtype)
    scale = w * jnp.abs(det)  # (4,)
    # esm = sum_g B_g^T D B_g * w_g |J_g|  -- batched matmuls.
    # HIGHEST precision: at a reduced-precision f32 default the formed
    # blocks carry enough relative error on badly-scaled meshes that K@du
    # disagrees with the (full-precision) stress-route internal force at
    # ~1e-2 — on the Embankment soil replay the f32 step-0 residual was
    # 1.46e-2 against 9.8e-7 with exact f32 matmuls, and modified-NR
    # diverged.  Formation runs once per tangent refresh, so the cost is
    # per-step, not per-CG-iteration.
    hp = formation_precision()
    db = jnp.einsum("kl,gln->gkn", dmat, bmat, precision=hp)
    return jnp.einsum("gkm,gkn,g->mn", bmat, db, scale, precision=hp)


# Above this element count, per-element block builders switch to chunked
# lax.map so the (ne, 4, 6, 30) B-matrix intermediates never materialize
# for the whole mesh at once (the fused whole-mesh vmap ran out of a 16 GB
# device at 1.98M dofs / ~470k elements, while the block output itself is
# only 1.7 GB).  The right threshold for the H100's 80 GB is an open
# measurement.
ASSEMBLY_CHUNK_THRESHOLD = 262_144
ASSEMBLY_CHUNK = 65_536


def _maybe_chunked(single_fn, elnodes, operands, el_axes):
    """vmap ``single_fn`` over elements, chunking via lax.map past the
    threshold.  ``operands``: tuple of arrays; ``el_axes``: 0 for
    per-element leading axes, None for broadcast."""
    ne = elnodes.shape[0]
    if ne <= ASSEMBLY_CHUNK_THRESHOLD:
        return jax.vmap(single_fn, in_axes=el_axes)(*operands)
    batched = tuple(op for op, ax in zip(operands, el_axes) if ax == 0)
    consts = tuple(op for op, ax in zip(operands, el_axes) if ax is None)

    def f(batch_ops):
        it_b = iter(batch_ops)
        it_c = iter(consts)
        args = tuple(
            next(it_b) if ax == 0 else next(it_c) for ax in el_axes
        )
        return single_fn(*args)

    return jax.lax.map(f, batched, batch_size=ASSEMBLY_CHUNK)


@partial(jax.jit, static_argnames=())
def elastic_stiffness_blocks(coords: jnp.ndarray, elnodes: jnp.ndarray, dmat: jnp.ndarray):
    """(ne, 30, 30) elastic element stiffness blocks (``fcVM.py:739-756``).

    ``dmat`` may be (6, 6) (single material, the reference's effective
    behavior) or (ne, 6, 6) (true per-element materials — the reference
    extracts the table but its kernels use element 0, ``fcVM.py:736``)."""
    coords_el = coords[elnodes]  # (ne, 10, 3)
    axes = (0, 0) if dmat.ndim == 3 else (0, None)
    return _maybe_chunked(_single_elastic_esm, elnodes, (coords_el, dmat), axes)


def _single_tangent_esm(coords_el, dmat, sig_el, pgp_el, g3fac):
    """Material tangent block with plastic rank-one correction.

    Reference ``fcVM.py:971-1000``: for plastic Gauss points the tangent is
    ``D - fac * s s^T`` with ``fac = 3G / (1 + H/3G) / svm^2`` computed from
    the stress at the start of the Riks step.
    """
    det, _, bmat = el.tet10_element_geometry(coords_el)
    w = jnp.asarray(el.W10, dtype=coords_el.dtype)
    scale = w * jnp.abs(det)  # (4,)
    dev, _, svm = mat.von_mises(sig_el)  # sig_el (4, 6)
    svm = jnp.where(svm == 0.0, 1.0, svm)
    fac = jnp.where(pgp_el, g3fac / svm**2, 0.0)  # (4,)
    # D_g = D - fac_g * s_g s_g^T
    dmat_g = dmat[None] - fac[:, None, None] * dev[:, :, None] * dev[:, None, :]
    # HIGHEST precision: see _single_elastic_esm (the Embankment trap)
    hp = formation_precision()
    db = jnp.einsum("gkl,gln->gkn", dmat_g, bmat, precision=hp)
    return jnp.einsum("gkm,gkn,g->mn", bmat, db, scale, precision=hp)


@jax.jit
def tangent_stiffness_blocks(
    coords_def: jnp.ndarray,
    elnodes: jnp.ndarray,
    dmat: jnp.ndarray,
    sig_gp: jnp.ndarray,
    pgp: jnp.ndarray,
    g: jnp.ndarray,
    h: jnp.ndarray,
):
    """(ne, 30, 30) consistent-ish tangent blocks on deformed coordinates.

    Args:
      coords_def: (nn, 3) current (deformed) nodal coordinates.
      sig_gp: (ne, 4, 6) stresses at the start of the step (``sig_old``).
      pgp: (ne, 4) plastic Gauss-point flags.
    """
    g3fac = 3.0 * g / (1.0 + h / (3.0 * g))
    coords_el = coords_def[elnodes]
    d_ax = 0 if dmat.ndim == 3 else None
    f_ax = 0 if jnp.ndim(g3fac) == 1 else None
    return _maybe_chunked(
        _single_tangent_esm, elnodes,
        (coords_el, dmat, sig_gp, pgp, g3fac), (0, d_ax, 0, 0, f_ax),
    )


def _single_geometric_nsm(coords_el, sig_el):
    """Initial-stress (geometric) stiffness block (``fcVM.py:1002-1006``).

    ``nsm[(j,b),(l,c)] = sum_g w_g |J_g| (dshpg_g^T sigma_g dshpg_g)[j,l] I[b,c]``.
    """
    det, dshpg, _ = el.tet10_element_geometry(coords_el)
    w = jnp.asarray(el.W10, dtype=coords_el.dtype)
    scale = w * jnp.abs(det)
    s = voigt_to_tensor(sig_el)  # (4, 3, 3)
    # HIGHEST precision: see _single_elastic_esm (the Embankment trap)
    m = jnp.einsum(
        "gij,gik,gkl,g->jl", dshpg, s, dshpg, scale,
        precision=formation_precision(),
    )  # (10, 10)
    eye3 = jnp.eye(3, dtype=coords_el.dtype)
    return jnp.einsum("jl,bc->jblc", m, eye3).reshape(30, 30)


@jax.jit
def geometric_stiffness_blocks(coords: jnp.ndarray, elnodes: jnp.ndarray, sig_gp: jnp.ndarray):
    coords_el = coords[elnodes]
    return _maybe_chunked(
        _single_geometric_nsm, elnodes, (coords_el, sig_gp), (0, 0)
    )


def voigt_to_tensor(sig: jnp.ndarray) -> jnp.ndarray:
    """(..., 6) Voigt [xx,yy,zz,xy,zx,yz] -> (..., 3, 3) symmetric tensor."""
    sxx, syy, szz = sig[..., 0], sig[..., 1], sig[..., 2]
    sxy, szx, syz = sig[..., 3], sig[..., 4], sig[..., 5]
    row0 = jnp.stack([sxx, sxy, szx], axis=-1)
    row1 = jnp.stack([sxy, syy, syz], axis=-1)
    row2 = jnp.stack([szx, syz, szz], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


# ---------------------------------------------------------------------------
# Load vector
# ---------------------------------------------------------------------------


def gravity_load_and_gp_coords(coords_eff, elnodes, density, grav, ndof):
    """Gravity nodal loads + Gauss point coordinates + mesh volume.

    Reference integrates ``grav * rho * N_i w |J|`` per element
    (``fcVM.py:757-767``).  ``coords_eff`` may be deformed coordinates for the
    GNL tangent path, reproducing the reference behaviour flagged by its own
    TODO at ``fcVM.py:966-968``.
    """
    coords_el = coords_eff[elnodes]  # (ne, 10, 3)
    dshp = jnp.asarray(el.DSHP10_AT_GP, dtype=coords_eff.dtype)
    shp = jnp.asarray(el.SHP10_AT_GP, dtype=coords_eff.dtype)  # (4, 10)
    w = jnp.asarray(el.W10, dtype=coords_eff.dtype)
    # HIGHEST precision: the load vector sets the residual normalization —
    # reduced-precision geometry here would perturb the applied loads
    # themselves by ~1e-3 at f32 (a model error, not a solver error).
    # One-time cost.
    hp = jax.lax.Precision.HIGHEST
    xs = jnp.einsum("eki,gjk->egij", coords_el, dshp, precision=hp)
    det = det3(xs)  # (ne, 4)
    scale = w[None, :] * jnp.abs(det)  # (ne, 4)
    grav = jnp.asarray(grav, dtype=coords_eff.dtype)
    # gamma[e, j, c] = grav[c] * rho_e * sum_g shp[g, j] * scale[e, g]
    rho = density[:, None, None] if jnp.ndim(density) == 1 else density
    gamma = jnp.einsum("eg,gj,c->ejc", scale, shp, grav, precision=hp) * rho
    glv = jax.ops.segment_sum(
        gamma.reshape(-1, 3), elnodes.reshape(-1), num_segments=ndof // 3
    ).reshape(-1)
    gp_coords = jnp.einsum("gj,eji->egi", shp, coords_el)  # (ne, 4, 3)
    volume = jnp.sum(det * w[None, :])
    return glv, gp_coords, volume


def pressure_face_loads(coords_eff, faces, pressures, ndof):
    """Nodal loads from pressure on tri6 faces (``fcVM.py:649-672``).

    Pressure acts along the outward face normal; in the GNL tangent path the
    reference evaluates it on the stretched surface (follower load,
    ``fcVM.py:858-883``), hence ``coords_eff``.

    Args:
      faces: (nf, 6) 0-based node ids; pressures: (nf,).
    """
    if faces.shape[0] == 0:
        return jnp.zeros(ndof, dtype=coords_eff.dtype)
    xlf = coords_eff[faces]  # (nf, 6, 3)
    xsj, normal = jax.vmap(el.tri6_surface_frame)(xlf)  # (nf, 6g), (nf, 6g, 3)
    shp = jnp.asarray(el.SHP6_AT_GP, dtype=coords_eff.dtype)  # (6g, 6n)
    w = jnp.asarray(el.W6, dtype=coords_eff.dtype)
    # load[f, n, c] = sum_g shp[g, n] * p_f * normal[f, g, c] * |xsj| * w_g
    load = jnp.einsum(
        "gn,f,fgc,fg,g->fnc", shp, pressures, normal, jnp.abs(xsj), w,
        precision=jax.lax.Precision.HIGHEST,  # load vector: see gravity note
    )
    dofs = (3 * faces[:, :, None] + jnp.arange(3)[None, None, :]).reshape(-1)
    return jax.ops.segment_sum(load.reshape(-1), dofs, num_segments=ndof)


def uniform_face_loads(coords, faces, tractions, ndof):
    """Nodal loads from uniform tractions on tri6 faces (``fcVM.py:683-705``).

    Always integrated on the original surface, even in the GNL path
    (``fcVM.py:894-916``).

    Args:
      faces: (nf, 6); tractions: (nf, 3) force per unit area.
    """
    if faces.shape[0] == 0:
        return jnp.zeros(ndof, dtype=coords.dtype)
    xlf = coords[faces]
    xsj, _ = jax.vmap(el.tri6_surface_frame)(xlf)
    shp = jnp.asarray(el.SHP6_AT_GP, dtype=coords.dtype)
    w = jnp.asarray(el.W6, dtype=coords.dtype)
    load = jnp.einsum(
        "gn,fc,fg,g->fnc", shp, tractions, jnp.abs(xsj), w,
        precision=jax.lax.Precision.HIGHEST,  # load vector: see gravity note
    )
    dofs = (3 * faces[:, :, None] + jnp.arange(3)[None, None, :]).reshape(-1)
    return jax.ops.segment_sum(load.reshape(-1), dofs, num_segments=ndof)


def edge_loads(coords, edges, tractions, ndof):
    """Nodal loads from line tractions on 3-node edges (``fcVM.py:707-727``).

    Args:
      edges: (nedg, 3); tractions: (nedg, 3) force per unit length.
    """
    if edges.shape[0] == 0:
        return jnp.zeros(ndof, dtype=coords.dtype)
    xle = coords[edges]  # (nedg, 3, 3)
    xsj = jax.vmap(el.line3_jacobian)(xle)  # (nedg, 2)
    shp = jnp.asarray(el.SHP2_AT_GP, dtype=coords.dtype)  # (2, 3)
    w = jnp.asarray(el.W2, dtype=coords.dtype)
    load = jnp.einsum(
        "gn,ec,eg,g->enc", shp, tractions, jnp.abs(xsj), w,
        precision=jax.lax.Precision.HIGHEST,  # load vector: see gravity note
    )
    dofs = (3 * edges[:, :, None] + jnp.arange(3)[None, None, :]).reshape(-1)
    return jax.ops.segment_sum(load.reshape(-1), dofs, num_segments=ndof)


def vertex_loads(vertices, forces, ndof, dtype):
    """Point loads at nodes (``fcVM.py:674-681``).

    Args:
      vertices: (nv,) node ids; forces: (nv, 3).
    """
    if vertices.shape[0] == 0:
        return jnp.zeros(ndof, dtype=dtype)
    dofs = (3 * vertices[:, None] + jnp.arange(3)[None, :]).reshape(-1)
    return jax.ops.segment_sum(
        forces.astype(dtype).reshape(-1), dofs, num_segments=ndof
    )


# ---------------------------------------------------------------------------
# Dirichlet elimination + matrix-free operator
# ---------------------------------------------------------------------------


class ScatterPlan(NamedTuple):
    """Degree-bucketed incidence tables: node scatter-add as pure gathers.

    The plan was written for an accelerator whose scatter-add ran several
    times slower than a gather of the same index count; whether it beats
    ``segment_sum`` on the H100 is an open measurement.  The plan inverts the
    (element, slot) -> node map at build time: for each node, the positions of
    its incident rows in the flat ``(ne*10, 3)`` value stream, padded to a
    per-bucket fixed degree.  Applying it is a fixed gather + small-axis sum +
    permutation gather — no scatter at all.

    Buckets group nodes by incidence degree so padding stays <15% (tet10
    midside nodes have ~4-6 incident elements, corners up to ~24+).
    """

    node_counts: tuple  # static per-bucket lengths are implied by shapes
    inc: tuple  # per bucket: (nb, Db) int32 positions into the value stream
    invperm: jnp.ndarray  # (nn,) int32; out = concat(bucket sums, zeros)[invperm]


def build_scatter_plan(elnodes, nn: int) -> ScatterPlan:
    """Host-side plan build from (ne, 10) connectivity (numpy, one-time)."""
    import numpy as np

    eln_np = np.asarray(elnodes)
    flat = eln_np.reshape(-1)
    nrows = flat.shape[0]
    cnt = np.bincount(flat, minlength=nn)
    srt = np.argsort(flat, kind="stable")
    ofs = np.zeros(nn + 1, np.int64)
    np.cumsum(cnt, out=ofs[1:])

    dmax = max(int(cnt.max()), 1)
    caps, c = [], 4
    while c < dmax:
        caps.append(c)
        c = c * 3 // 2 if c >= 8 else c + 2
    caps.append(dmax)

    node_groups, incs = [], []
    lo = 0
    for cap in caps:
        nodes = np.where((cnt > lo) & (cnt <= cap))[0]
        lo = cap
        if len(nodes) == 0:
            continue
        k = np.arange(cap)
        idx = ofs[nodes][:, None] + k[None, :]
        valid = k[None, :] < cnt[nodes][:, None]
        inc = np.where(valid, srt[np.minimum(idx, nrows - 1)], nrows)
        node_groups.append(nodes)
        incs.append(jnp.asarray(inc.astype(np.int32)))
    zero_nodes = np.where(cnt == 0)[0]
    node_order = np.concatenate(node_groups + [zero_nodes]) if node_groups else zero_nodes
    invperm = np.empty(nn, np.int64)
    invperm[node_order] = np.arange(nn)
    return ScatterPlan(
        tuple(len(n) for n in node_groups),
        tuple(incs),
        jnp.asarray(invperm.astype(np.int32)),
    )


def scatter_node_rows(rows3: jnp.ndarray, plan: ScatterPlan) -> jnp.ndarray:
    """Sum (nrows, ...) value rows into (nn, ...) node rows via the plan.

    Trailing shape is arbitrary — (3,) for the operator matvec, (3, k) for
    the deflation block matvec (gather cost is per-index, so wide rows ride
    along nearly free; see ``fcvm_tpu.ops.deflation``)."""
    rest = rows3.shape[1:]
    rows_ext = jnp.concatenate([rows3, jnp.zeros((1,) + rest, rows3.dtype)])
    outs = [rows_ext[inc].sum(axis=1) for inc in plan.inc]
    nz = plan.invperm.shape[0] - sum(o.shape[0] for o in outs)
    outs.append(jnp.zeros((nz,) + rest, rows3.dtype))
    return jnp.concatenate(outs)[plan.invperm]


def build_sharded_scatter_plans(eln_shards, nn: int):
    """Per-shard ScatterPlans with one UNIFIED static structure.

    ``eln_shards`` is a list of (ne_s, 10) connectivity slices (all the
    same ne_s — the sharded backend pads the element axis).  shard_map
    needs every shard to run the same program, so the per-shard plans
    must share bucket caps and per-bucket node counts; buckets are padded
    to the max count across shards with rows of all-``nrows`` indices
    (they gather the appended zero row and sum to zero, and no invperm
    entry references them).  Nodes a shard never touches map to the
    single trailing zero row.

    Returns ``(node_counts, incs, invperms)``:
      node_counts: static tuple of padded per-bucket lengths (same for
        every shard);
      incs: list over buckets of (n_shards, nb, Db) int32 stacks;
      invperms: (n_shards, nn) int32 stack.
    Apply with :func:`scatter_node_rows_padded` inside the shard body.
    """
    import numpy as np

    n_shards = len(eln_shards)
    nrows = int(np.asarray(eln_shards[0]).size)
    cnts = [np.bincount(np.asarray(e).reshape(-1), minlength=nn)
            for e in eln_shards]
    dmax = max(1, max(int(c.max()) for c in cnts))
    caps, c = [], 4
    while c < dmax:
        caps.append(c)
        c = c * 3 // 2 if c >= 8 else c + 2
    caps.append(dmax)

    # per shard, per cap: the node sets
    groups = []  # [shard][cap] -> node ids
    for cnt in cnts:
        lo, g = 0, []
        for cap in caps:
            g.append(np.where((cnt > lo) & (cnt <= cap))[0])
            lo = cap
        groups.append(g)
    nb = [max(len(groups[s][b]) for s in range(n_shards))
          for b in range(len(caps))]

    incs, invperms, counts = [], [], []
    for b, cap in enumerate(caps):
        if nb[b] == 0:
            continue
        counts.append(nb[b])
        stack = np.full((n_shards, nb[b], cap), nrows, dtype=np.int64)
        incs.append(stack)
    for s, cnt in enumerate(cnts):
        flat = np.asarray(eln_shards[s]).reshape(-1)
        srt = np.argsort(flat, kind="stable")
        ofs = np.zeros(nn + 1, np.int64)
        np.cumsum(cnt, out=ofs[1:])
        invperm = np.full(nn, -1, np.int64)
        pos = 0
        bi = 0
        for b, cap in enumerate(caps):
            if nb[b] == 0:
                continue
            nodes = groups[s][b]
            if len(nodes):
                k = np.arange(cap)
                idx = ofs[nodes][:, None] + k[None, :]
                valid = k[None, :] < cnt[nodes][:, None]
                inc = np.where(valid, srt[np.minimum(idx, nrows - 1)], nrows)
                incs[bi][s, : len(nodes)] = inc
                invperm[nodes] = pos + np.arange(len(nodes))
            pos += nb[b]
            bi += 1
        invperm[invperm < 0] = pos  # untouched nodes -> the zero row
        invperms.append(invperm)

    return (
        tuple(counts),
        [jnp.asarray(a.astype(np.int32)) for a in incs],
        jnp.asarray(np.stack(invperms).astype(np.int32)),
    )


def scatter_node_rows_padded(rows, incs, invperm):
    """Per-shard body of the sharded plan: sum local value rows into the
    full (nn, ...) node vector (zeros where the shard has no incidence).

    ``incs``/``invperm`` are one shard's slices of
    :func:`build_sharded_scatter_plans` output (leading shard axis already
    consumed by shard_map — squeeze it before calling)."""
    rest = rows.shape[1:]
    rows_ext = jnp.concatenate([rows, jnp.zeros((1,) + rest, rows.dtype)])
    outs = [rows_ext[inc].sum(axis=1) for inc in incs]
    outs.append(jnp.zeros((1,) + rest, rows.dtype))
    return jnp.concatenate(outs)[invperm]


def resolve_matvec_precision(ndof: int):
    """The einsum precision for a ``K @ v`` operator of this size.

    An accelerator's default f32 einsum may run in reduced precision (bf16
    passes, or TF32 on a GPU: ~1e-3-class relative noise).  For the CG
    correction solves that noise bounds the achievable Newton residual: on
    the Embankment corpus replay (81k dof, ``error_max`` 1e-2) a
    reduced-precision operator left modified-NR *diverging* geometrically
    (~×1.08/iter) where CPU f32 — exact f32 matmuls — converges every step
    without a restart.  Full f32 precision fixes small meshes; above
    ``matvec_hp_max_dof`` the device default stays, a cost trade made on
    the first accelerator, and the f64 tier (via the automatic precision
    failover) covers the rare hard case.  What the default does on the
    H100 is recorded in PERF.md.

    ``config.matvec_precision``: "auto" (HIGHEST below
    ``matvec_hp_max_dof``, default above), "highest", "default".
    Resolved from static shapes at trace time.
    """
    from fcvm_tpu.config import get_config

    cfg = get_config()
    mode = getattr(cfg, "matvec_precision", "auto")
    if mode == "highest":
        return jax.lax.Precision.HIGHEST
    if mode == "auto" and ndof <= getattr(cfg, "matvec_hp_max_dof", 200_000):
        return jax.lax.Precision.HIGHEST
    return None


def make_matvec(
    esm: jnp.ndarray,
    eldofs: jnp.ndarray,
    ndof: int,
    plan: Optional[ScatterPlan] = None,
    precision=None,
):
    """Raw ``K @ v`` from element blocks: gather -> block matmul -> scatter.

    Node-row granularity: gather/scatter cost scales with the *index*
    count, so moving 3-vectors per node instead of scalars per dof cuts the
    index count 3x.  Requires ``ndof`` divisible by 3 (guaranteed by the
    384-alignment padding).

    With a :class:`ScatterPlan` the scatter-add becomes pure gathers.

    ``precision`` defaults to :func:`resolve_matvec_precision` — full f32
    einsum precision on small meshes, where a reduced-precision default's
    noise otherwise floors (or diverges) the Newton loop.
    """
    ne = esm.shape[0]
    elnodes = eldofs[:, ::3] // 3  # (ne, 10) node ids
    nn = ndof // 3
    if precision is None:
        precision = resolve_matvec_precision(ndof)

    if plan is not None:
        esm4 = esm.reshape(ne, 10, 3, 30)

        def kv(u):
            u3 = u.reshape(nn, 3)[elnodes]  # (ne, 10, 3) row gather
            # (ne, 10, 3) output: reshape to rows is free (major dims only)
            fe = jnp.einsum(
                "eabj,ej->eab", esm4, u3.reshape(ne, 30), precision=precision
            )
            return scatter_node_rows(fe.reshape(-1, 3), plan).reshape(-1)

        return kv

    def kv(u):
        u3 = u.reshape(nn, 3)[elnodes]  # (ne, 10, 3) row gather
        fe = jnp.einsum("eij,ej->ei", esm, u3.reshape(ne, 30), precision=precision)
        out3 = jax.ops.segment_sum(
            fe.reshape(-1, 3), elnodes.reshape(-1), num_segments=nn
        )
        return out3.reshape(-1)

    return kv


def make_bc_matvec(
    esm: jnp.ndarray,
    eldofs: jnp.ndarray,
    fixmask: jnp.ndarray,
    plan: Optional[ScatterPlan] = None,
    precision=None,
):
    """``K_hat @ v`` with eliminated Dirichlet dofs.

    ``K_hat u = P K P u + (I - P) u`` with ``P = diag(fixmask)``; identical
    solution space to the reference's row/column elimination
    (``fcVM.py:771-796``).

    ``precision`` overrides :func:`resolve_matvec_precision` — the driver's
    HP-escalation tier passes ``HIGHEST`` when an f32 Newton attempt above
    ``matvec_hp_max_dof`` stagnates on reduced-precision CG-correction
    noise.
    """
    ndof = fixmask.shape[0]
    kv = make_matvec(esm, eldofs, ndof, plan, precision=precision)

    def khat(u):
        return fixmask * kv(fixmask * u) + (1.0 - fixmask) * u

    return khat


def dirichlet_rhs(esm, eldofs, fixmask, u_fix, glv, plan=None):
    """Full elastic RHS ``f = P glv - (P K u_fix) + u_fix``.

    Matches the reference ``f = fixdof * glv + modf`` (``fcVM.py:1128``) up to
    the adjacent-element-count diagonal scaling noted in the module docstring.
    """
    ndof = fixmask.shape[0]
    kv = make_matvec(esm, eldofs, ndof, plan)
    modf_free = -fixmask * kv(u_fix)
    return fixmask * glv + modf_free + u_fix


def block_jacobi_inverse_blocks(esm, elnodes, fixmask):
    """Inverse 3x3 nodal diagonal blocks of ``K_hat`` for PCG.

    Fixed dofs get identity rows/columns so the preconditioner is consistent
    with :func:`make_bc_matvec`.  Returns (nn, 3, 3).
    """
    ne = esm.shape[0]
    nn = fixmask.shape[0] // 3
    blocks5 = esm.reshape(ne, 10, 3, 10, 3)
    idx = jnp.arange(10)
    # diag[e, n] = esm[e, 3n:3n+3, 3n:3n+3]; advanced indexing puts the
    # shared node axis first -> (10, ne, 3, 3)
    diag = blocks5[:, idx, :, idx, :]
    node_ids = elnodes.T.reshape(-1)  # (10 * ne,) matching diag layout
    nodal = jax.ops.segment_sum(diag.reshape(-1, 3, 3), node_ids, num_segments=nn)
    m3 = fixmask.reshape(nn, 3)
    mask_ij = m3[:, :, None] * m3[:, None, :]
    eye = jnp.eye(3, dtype=esm.dtype)
    nodal = nodal * mask_ij + (1.0 - m3)[:, :, None] * eye[None]
    return inv3_spd(nodal)


def apply_block_precond(pinv, r):
    """Apply nodal block-Jacobi inverse blocks (nn, 3, 3) to r (ndof,)."""
    r3 = r.reshape(-1, 3)
    return jnp.einsum("nab,nb->na", pinv, r3).reshape(-1)
