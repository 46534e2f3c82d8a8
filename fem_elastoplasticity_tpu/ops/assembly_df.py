"""Double-float (two-f32) residual assembly — the fast-path accuracy core.

The fast path runs every hot op in f32, but the
reference's Newton stopping criteria (1e-12 inner / 1e-10 accept,
`tsx-tunnel/pythonFEM.py:1801-1804`) and the <=1e-10 displacement-accuracy
bar are unreachable in plain f32: at convergence the internal force is a
~1e-13-relative cancellation of O(1) element contributions.  This module
evaluates exactly that residual pipeline — strain gather, constitutive
stress, B^T(w s) nodal accumulation — in double-float arithmetic
(`ops/df32.py`): every value is an unevaluated f32 pair `hi + lo` with
~48-bit effective mantissa, and every reduction is a chain of error-free
`df_add` transforms, so cancellation is captured instead of rounded away.

Key design point: the nodal accumulation cannot use `segment_sum` (there is
no compensated segmented reduction); instead a **padded gather map** is
precomputed on the host — for each DOF, the fixed list of per-element force
slots that touch it — and the reduction is an unrolled `df_add` chain over
that static axis (scatter-free as well).

Geometry (B blocks, quadrature weights) is computed once on the host in
f64 and split exactly into hi/lo pairs, so the residual's backward error is
~1e-14 relative end-to-end.  The f32 `hi` geometry doubles as the plain
`Geometry` used by the (inexact-Newton) f32 tangent/criterion path.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .assembly import LANE_PAD, Geometry, compute_geometry
from .df32 import DF, df_add, df_barrier, df_const, df_mul
from .elements import ReferenceElement


class GeometryDF(NamedTuple):
    """f64-accurate geometry as (f32 Geometry, lo-corrections, gather map).

    hi:    plain f32 `Geometry` (the exactly-rounded heads) — reused by the
           f32 tangent assembly and criterion matvecs.
    B_lo:  (3, 2*n_p, n_int) f32 tails of the f64 B blocks.
    w_lo:  (n_int,) f32 tails of the f64 quadrature weights.
    gmap:  (2*n_n, K) int32 — for each DOF, flat indices into the
           (2*n_p, n_e) per-element force array of all slots accumulating
           into it; padded with the index of an appended zero slot.
    """

    hi: Geometry
    B_lo: jnp.ndarray
    w_lo: jnp.ndarray
    gmap: jnp.ndarray


def split_f64_np(x) -> tuple:
    """Host-side exact f64 -> (hi, lo) f32 split (numpy arrays)."""
    x64 = np.asarray(x, np.float64)
    hi = x64.astype(np.float32)
    lo = (x64 - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def dof_gather_map(
    edofs_t: np.ndarray, n_real: int, n_dofs: int
) -> np.ndarray:
    """Padded per-DOF gather lists over the (2*n_p, n_e) force-slot array.

    Only the first `n_real` (non-padding) elements contribute — padding
    elements carry exactly-zero B and weight, so skipping them loses
    nothing and keeps the pad rows pointing at the zero slot.
    """
    np2, n_e = edofs_t.shape
    ks, es = np.meshgrid(
        np.arange(np2), np.arange(n_real), indexing="ij"
    )
    pos = (ks * n_e + es).reshape(-1)
    dofs = np.asarray(edofs_t)[:, :n_real].reshape(-1)
    order = np.argsort(dofs, kind="stable")
    dofs_s, pos_s = dofs[order], pos[order]
    counts = np.bincount(dofs_s, minlength=n_dofs)
    k_max = int(counts.max())
    gmap = np.full((n_dofs, k_max), np2 * n_e, dtype=np.int32)  # zero slot
    starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
    within = np.arange(dofs_s.size) - starts[dofs_s]
    gmap[dofs_s, within] = pos_s
    return gmap


def geometry_df(
    coords: np.ndarray,
    elems: np.ndarray,
    ref: ReferenceElement,
    pad_to: Optional[int] = None,
) -> GeometryDF:
    """Host-side setup: f64 geometry on CPU, split into df32 pairs.

    Runs `compute_geometry` once on the CPU backend in float64 (the mesh is
    static), then splits B and weight exactly: hi = f32(x), lo = f32(x - hi).
    pad_to: optional integration-point padding target (multi-chip: pad so
    each shard holds an equal lane-aligned block of whole elements).
    """
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        g64 = compute_geometry(
            jnp.asarray(np.asarray(coords, np.float64)),
            jnp.asarray(elems),
            ref,
            pad_to=pad_to if pad_to is not None else LANE_PAD,
        )
        B64 = np.asarray(g64.B, np.float64)
        w64 = np.asarray(g64.weight, np.float64)
    B_hi = B64.astype(np.float32)
    B_lo = (B64 - B_hi.astype(np.float64)).astype(np.float32)
    w_hi = w64.astype(np.float32)
    w_lo = (w64 - w_hi.astype(np.float64)).astype(np.float32)
    edofs = np.asarray(g64.edofs, np.int32)
    hi = Geometry(
        B=jnp.asarray(B_hi),
        weight=jnp.asarray(w_hi),
        edofs=jnp.asarray(edofs),
        edofs_t=jnp.asarray(edofs.T),
        n_nodes=g64.n_nodes,
        n_q=g64.n_q,
        n_real=g64.n_real,
    )
    gmap = dof_gather_map(edofs.T, g64.n_real, 2 * g64.n_nodes)
    return GeometryDF(
        hi=hi,
        B_lo=jnp.asarray(B_lo),
        w_lo=jnp.asarray(w_lo),
        gmap=jnp.asarray(gmap),
    )


def _dof_values_df(g: GeometryDF, u: DF):
    hi = g.hi
    ue = DF(u.hi[hi.edofs_t], u.lo[hi.edofs_t])  # (2*n_p, n_e)
    if hi.n_q == 1:
        return ue
    shape = (hi.n_p2, hi.n_elems, hi.n_q)
    bcast = lambda x: jnp.broadcast_to(x[:, :, None], shape).reshape(
        hi.n_p2, -1
    )
    return DF(bcast(ue.hi), bcast(ue.lo))


def strains_df(g: GeometryDF, u: DF) -> DF:
    """Total strain (3, n_int) in double-float: e = B u, compensated.

    Parity: `ops.assembly.strains` / reference `E = B @ U`
    (`tsx-tunnel/pythonFEM.py:1771`), at ~1e-14 relative accuracy.
    """
    ue = _dof_values_df(g, u)
    rows = []
    for a in range(3):
        acc = None
        for p in range(g.hi.n_p2):
            term = df_mul(
                DF(g.hi.B[a, p], g.B_lo[a, p]), DF(ue.hi[p], ue.lo[p])
            )
            acc = term if acc is None else df_add(acc, term)
        rows.append(acc)
    return df_barrier(
        DF(
            jnp.stack([r.hi for r in rows], axis=0),
            jnp.stack([r.lo for r in rows], axis=0),
        )
    )


def internal_force_df(g: GeometryDF, s3: DF, axis_name=None) -> DF:
    """F = B^T (weight * s) in double-float, gather-accumulated — (2*n_n,).

    The per-slot products are exact df32 multiplies; the quadrature and
    nodal reductions are `df_add` chains over static axes (the padded
    gather map), so the ~1e-13-relative cancellation at Newton convergence
    survives.  Parity: `ops.assembly.internal_force`
    (`tsx-tunnel/pythonFEM.py:1778`).

    axis_name: element-shard mesh axis (shard_map) — per-shard partials
    are combined with the exact compensated all-reduce
    (`ops.df32.df_allreduce`), never a plain psum of hi/lo.
    """
    hi = g.hi
    w = DF(hi.weight, g.w_lo)
    fk = []
    for k in range(hi.n_p2):
        acc = None
        for a in range(3):
            ws = df_mul(w, DF(s3.hi[a], s3.lo[a]))
            term = df_mul(DF(hi.B[a, k], g.B_lo[a, k]), ws)
            acc = term if acc is None else df_add(acc, term)
        fk.append(acc)
    fk_hi = jnp.stack([f.hi for f in fk], axis=0)  # (2*n_p, n_int)
    fk_lo = jnp.stack([f.lo for f in fk], axis=0)
    if hi.n_q > 1:
        fk_hi = fk_hi.reshape(hi.n_p2, hi.n_elems, hi.n_q)
        fk_lo = fk_lo.reshape(hi.n_p2, hi.n_elems, hi.n_q)
        acc = DF(fk_hi[..., 0], fk_lo[..., 0])
        for q in range(1, hi.n_q):
            acc = df_add(acc, DF(fk_hi[..., q], fk_lo[..., q]))
        fk_hi, fk_lo = acc.hi, acc.lo
    zero = jnp.zeros((1,), fk_hi.dtype)
    flat_hi = jnp.concatenate([fk_hi.reshape(-1), zero])
    flat_lo = jnp.concatenate([fk_lo.reshape(-1), zero])
    gm = g.gmap
    acc = DF(flat_hi[gm[:, 0]], flat_lo[gm[:, 0]])
    for k in range(1, gm.shape[1]):
        acc = df_add(acc, DF(flat_hi[gm[:, k]], flat_lo[gm[:, k]]))
    out = df_barrier(acc)
    if axis_name is not None:
        from .df32 import df_allreduce

        out = df_allreduce(out, axis_name)
    return out


def elastic_apply_df(g: GeometryDF, u: DF, shear: float, bulk: float) -> DF:
    """K_elast u in double-float (setup-time iterative refinement helper)."""
    return internal_force_df(g, elastic_stress_df(strains_df(g, u), shear, bulk))


def refine_elastic_solve_with(
    g: GeometryDF,
    solve_fn,
    u0: DF,
    f_ext: DF,
    shear: float,
    bulk: float,
    iters: int = 4,
    apply_fn=None,
) -> DF:
    """df32-accurate elastic solve: K u = f_ext with a generic inner solver.

    Iterative refinement with the double-float residual: each pass calls
    `solve_fn(r_hi_full) -> du_full` (an approximate f32 K^{-1} on the free
    subspace, zero on constrained DOFs — a Cholesky back-substitution or a
    PCG solve) and multiplies the residual by the inner solver's relative
    accuracy, so a handful of passes reach the ~1e-14 df32 floor.

    `apply_fn(u: DF) -> DF`: override for the df32 elastic application
    K_el u.  Default = the matrix-free `elastic_apply_df` (gather/scatter
    path); callers with assembled G/S residual operators pass
    `elastic_apply_slot_df` instead.
    """
    if apply_fn is None:
        apply_fn = lambda u: DF(*elastic_apply_df(g, u, shear, bulk))
    u = u0
    for _ in range(iters):
        ku = apply_fn(u)
        r = df_add(f_ext, DF(-ku.hi, -ku.lo))
        du = solve_fn(r.hi)
        u = df_add(u, DF(du, jnp.zeros_like(du)))
    return u


def elastic_stress_df(e: DF, shear: float, bulk: float) -> DF:
    """df32 plane-strain elastic stress from (3, n_int) strains.

    s = D_el e with D_el = [[dd, oo, 0], [oo, dd, 0], [0, 0, shear]],
    dd = 4G/3 + K, oo = -2G/3 + K — the same constants the host
    assembly uses (`ops.spmv.build_ell_elastic`).  All products/sums in
    compensated df arithmetic so the pair stays f64-grade.
    """
    from ..ops.df32 import df_const, df_mul

    dd = df_const(4.0 * shear / 3.0 + bulk)
    oo = df_const(-2.0 * shear / 3.0 + bulk)
    sh = df_const(shear)
    e0 = DF(e.hi[0], e.lo[0])
    e1 = DF(e.hi[1], e.lo[1])
    e2 = DF(e.hi[2], e.lo[2])
    s0 = df_add(df_mul(e0, dd), df_mul(e1, oo))
    s1 = df_add(df_mul(e0, oo), df_mul(e1, dd))
    s2 = df_mul(e2, sh)
    return DF(
        jnp.stack([s0.hi, s1.hi, s2.hi]), jnp.stack([s0.lo, s1.lo, s2.lo])
    )


def elastic_apply_slot_df(gs_ops, u: DF, shear: float, bulk: float) -> DF:
    """Assembled df32 elastic application K_el u = S(D_el (G u)).

    gs_ops: (G_arrays, G_meta, S_arrays, S_meta) from
    `ops.spmv.build_residual_slot_df` — the same fixed-sparsity
    strain/force operators the Newton residual runs on; replaces the
    serialized matrix-free gather path in the elastic predictor."""
    from ..ops import spmv as _spmv

    Ga, Gm, Sa, Sm = gs_ops
    eh, el = _spmv.sp_matvec_df(Ga, Gm, u.hi, u.lo)
    n_int = eh.shape[0] // 3
    s = elastic_stress_df(
        DF(eh.reshape(3, n_int), el.reshape(3, n_int)), shear, bulk
    )
    fh, fl = _spmv.sp_matvec_df(Sa, Sm, s.hi.reshape(-1), s.lo.reshape(-1))
    return DF(fh, fl)


def elastic_apply_gs32(gs_ops, v: jnp.ndarray, shear: float, bulk: float):
    """f32 elastic application K_el v = S(D_el (G v)) on the G/S heads.

    The inner-CG OPERATOR counterpart of `elastic_apply_slot_df`: plain
    f32 on the hi value streams — inner-solve operator accuracy is
    irrelevant (iterative refinement measures the df32 residual), but
    the matrix-free `tangent_matvec` it replaces ran at 0.0116 GDOF/s
    (serialized XLA gather) and made every predictor PCG iteration ~20
    ms at the 228k-DOF level (measured 2026-08-21 — the 'predictor is
    40% of the wall' mystery)."""
    from ..ops import spmv as _spmv

    Ga, Gm, Sa, Sm = gs_ops
    G32 = {k: Ga[k] for k in Ga if not k.startswith("vals")}
    G32["vals"] = Ga["vals_hi"]
    S32 = {k: Sa[k] for k in Sa if not k.startswith("vals")}
    S32["vals"] = Sa["vals_hi"]
    e = _spmv.sp_matvec(G32, Gm, jnp.asarray(v, jnp.float32))
    n_int = e.shape[0] // 3
    e = e.reshape(3, n_int)
    dd = 4.0 * shear / 3.0 + bulk
    oo = -2.0 * shear / 3.0 + bulk
    s = jnp.stack(
        [dd * e[0] + oo * e[1], oo * e[0] + dd * e[1], shear * e[2]]
    )
    return _spmv.sp_matvec(S32, Sm, s.reshape(-1))


def refine_elastic_solve_df(
    g: GeometryDF,
    cho,
    free_idx: jnp.ndarray,
    u0: DF,
    f_ext: DF,
    shear: float,
    bulk: float,
    iters: int = 4,
) -> DF:
    """df32-accurate elastic solve: K u = f_ext on free DOFs, u = u0 elsewhere.

    f32 Cholesky + iterative refinement with the double-float residual.
    Each pass gains ~cond*eps32 (~1e-4 on these benchmarks), so 4 passes
    reach the ~1e-14 df32 floor — giving the load stepper a predictor whose
    first Newton step converges in one iteration, matching the reference's
    f64 trajectory (`tsx-tunnel/pythonFEM.py:1748`).
    """
    import jax

    zeros = jnp.zeros_like(u0.hi)

    def solve_fn(r_hi):
        du_free = jax.scipy.linalg.cho_solve(cho, r_hi[free_idx])
        return zeros.at[free_idx].set(du_free)

    return refine_elastic_solve_with(g, solve_fn, u0, f_ext, shear, bulk, iters)
