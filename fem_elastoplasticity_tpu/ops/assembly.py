"""Element-batched assembly kernels (the hot path) — lane-major layout.

Redesign of the reference's scipy-sparse assembly
(`Elasticity2D/pythonFEM.py:368-477`).  Instead of a global sparse
strain-displacement matrix and sparse GEMMs, we keep per-integration-point
dense tensors in **structure-of-arrays, lane-major** layout — the minor
(lane) dimension is always the integration-point axis, padded to a multiple
of 128, so every elementwise op streams contiguous memory at full vector
width:

    B       (3, 2*n_p, n_int)   strain-displacement blocks
    weight  (n_int,)            |det J| * w_q
    edofs_t (2*n_p, n_e)        global DOF indices (2*node + component)

(An (n_int, 4)-major layout would put the tiny Voigt axis in the minor
dimension and stride every access.)  All contractions over the tiny Voigt /
local-node axes are unrolled broadcasts (vector FMAs over lanes); the only
irregular ops are one gather (DOF values) and one `segment_sum` scatter
(nodal accumulation) per operator application.

Integration points are ordered element-major, quadrature-minor, matching
the reference's (..., n_int) arrays index-for-index (padding appended at
the end is inert: zero B, zero weight).

All functions are jittable and differentiable.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .elements import ReferenceElement, SurfaceElement

LANE_PAD = 128  # pad element count so n_int is a multiple of 128


class Geometry(NamedTuple):
    """Precomputed per-element quadrature geometry (pytree of arrays).

    B:        (3, 2*n_p, n_int) lane-major strain-displacement blocks
    weight:   (n_int,) quadrature weights including |det J| (0 on padding)
    edofs:    (n_e, 2*n_p) int32 global DOF indices
    edofs_t:  (2*n_p, n_e) transposed copy (gather/scatter layout)
    n_nodes:  static int — number of mesh nodes
    n_q:      static int — quadrature points per element
    n_real:   static int — real (non-padding) element count
    """

    B: jnp.ndarray
    weight: jnp.ndarray
    edofs: jnp.ndarray
    edofs_t: jnp.ndarray
    n_nodes: int
    n_q: int
    n_real: int

    @property
    def n_elems(self) -> int:  # including padding
        return self.edofs.shape[0]

    @property
    def n_int(self) -> int:
        return self.B.shape[2]

    @property
    def n_p2(self) -> int:
        return self.B.shape[1]


def element_dofs(elems: jnp.ndarray) -> jnp.ndarray:
    """(n_e, n_p) node indices -> (n_e, 2*n_p) interleaved DOF indices.

    DOF numbering 2*node+comp matches the reference's column-major flatten
    of (2, n_n) arrays (`tsx-tunnel/pythonFEM.py:1741-1748`).
    """
    e = jnp.asarray(elems)
    return jnp.stack([2 * e, 2 * e + 1], axis=-1).reshape(e.shape[0], -1)


def compute_geometry(
    coords: jnp.ndarray,
    elems: jnp.ndarray,
    ref: ReferenceElement,
    pad_to: int = LANE_PAD,
) -> Geometry:
    """Jacobians, physical gradients, B blocks and weights for all elements.

    Math parity with `get_elastic_stiffness_matrix`
    (`Elasticity2D/pythonFEM.py:385-446`): J = dN^T x_e, dphi = J^{-1} dN,
    weight = |det J| * w_q.  Elements are zero-padded to a lane multiple.
    """
    dtype = jnp.asarray(coords).dtype
    elems = jnp.asarray(elems)
    n_e = elems.shape[0]
    xe = jnp.asarray(coords)[elems]  # (n_e, n_p, 2)
    dN = jnp.asarray(ref.dN, dtype)  # (n_q, n_p, 2)
    n_q, n_p, _ = dN.shape

    # Jacobian J[e,q,i,j] = sum_p dN[q,p,i] * xe[e,p,j]
    J = jnp.einsum("qpi,epj->eqij", dN, xe)
    det = J[..., 0, 0] * J[..., 1, 1] - J[..., 0, 1] * J[..., 1, 0]
    inv = (
        jnp.stack(
            [
                jnp.stack([J[..., 1, 1], -J[..., 0, 1]], axis=-1),
                jnp.stack([-J[..., 1, 0], J[..., 0, 0]], axis=-1),
            ],
            axis=-2,
        )
        / det[..., None, None]
    )
    # physical gradients dphi[e,q,p,i]
    dphi = jnp.einsum("eqij,qpj->eqpi", inv, dN)
    weight = jnp.abs(det) * jnp.asarray(ref.w, dtype)[None, :]  # (n_e, n_q)

    # lane-major B: (3, 2*n_p, n_e*n_q), interleaved DOFs (x0,y0,x1,y1,...)
    dx = dphi[..., 0].transpose(2, 0, 1).reshape(n_p, -1)  # (n_p, n_int)
    dy = dphi[..., 1].transpose(2, 0, 1).reshape(n_p, -1)
    zero = jnp.zeros_like(dx)
    row0 = jnp.stack([dx, zero], axis=1).reshape(2 * n_p, -1)
    row1 = jnp.stack([zero, dy], axis=1).reshape(2 * n_p, -1)
    row2 = jnp.stack([dy, dx], axis=1).reshape(2 * n_p, -1)
    B = jnp.stack([row0, row1, row2], axis=0)  # (3, 2*n_p, n_int)
    w = weight.reshape(-1)

    # pad element count so n_int is a lane multiple, with inert slots
    n_e_total = n_e
    while (n_e_total * n_q) % pad_to != 0:
        n_e_total += 1
    pad_e = n_e_total - n_e
    if pad_e:
        B = jnp.pad(B, ((0, 0), (0, 0), (0, pad_e * n_q)))
        w = jnp.pad(w, (0, pad_e * n_q))
        elems = jnp.pad(elems, ((0, pad_e), (0, 0)))

    edofs = element_dofs(elems)
    return Geometry(
        B=B,
        weight=w,
        edofs=edofs,
        edofs_t=edofs.T,
        n_nodes=int(coords.shape[0]),
        n_q=int(n_q),
        n_real=int(n_e),
    )


# ---------------------------------------------------------------------------
# strain / stress / force / stiffness contractions (lane-major)
# ---------------------------------------------------------------------------
def dof_values(geom: Geometry, u: jnp.ndarray) -> jnp.ndarray:
    """u (2*n_n,) -> per-integration-point DOF values (2*n_p, n_int)."""
    ue = u[geom.edofs_t]  # (2*n_p, n_e)
    if geom.n_q == 1:
        return ue
    return jnp.broadcast_to(
        ue[:, :, None], (geom.n_p2, geom.n_elems, geom.n_q)
    ).reshape(geom.n_p2, -1)


def strains(geom: Geometry, u: jnp.ndarray) -> jnp.ndarray:
    """Total strain at integration points: (3, n_int), [e11, e22, 2e12].

    Matches the reference's `E = B @ U` reshaped (3, n_int)
    (`tsx-tunnel/pythonFEM.py:1771`).
    """
    ui = dof_values(geom, u)
    return (geom.B * ui[None, :, :]).sum(axis=1)


def apply_tangent(d: jnp.ndarray, e: jnp.ndarray) -> jnp.ndarray:
    """s = D e per integration point: d (3, 3, n), e (3, n) -> (3, n)."""
    return (d * e[None, :, :]).sum(axis=1)


def internal_force(
    geom: Geometry, s3: jnp.ndarray, axis_name: Optional[str] = None
) -> jnp.ndarray:
    """F = B^T (weight * s) scattered to (2*n_n,).

    Args:
      s3: (3, n_int) stress (first three Voigt components).
      axis_name: if set, `geom` holds this device's element shard and the
        scattered nodal partials are `psum`-reduced over the named mesh
        axis (SPMD assembly: element-local work + one collective).
    Parity: `tsx-tunnel/pythonFEM.py:1778`.
    """
    ws = geom.weight[None, :] * s3  # (3, n_int)
    fk = (geom.B * ws[:, None, :]).sum(axis=0)  # (2*n_p, n_int)
    if geom.n_q > 1:
        fk = fk.reshape(geom.n_p2, geom.n_elems, geom.n_q).sum(axis=-1)
    f = jax.ops.segment_sum(
        fk.reshape(-1), geom.edofs_t.reshape(-1), num_segments=2 * geom.n_nodes
    )
    if axis_name is not None:
        f = jax.lax.psum(f, axis_name)
    return f


def tangent_matvec(
    geom: Geometry, d: jnp.ndarray, v: jnp.ndarray, axis_name: Optional[str] = None
) -> jnp.ndarray:
    """Matrix-free K v: gather -> strain -> D -> B^T -> scatter.

    d: (3, 3, n_int) material tangent.  The CG workhorse — no sparse matrix
    is ever materialized (SURVEY.md §2.4: replaces scipy spsolve/CSR).
    """
    e = strains(geom, v)
    s = apply_tangent(d, e)
    return internal_force(geom, s, axis_name=axis_name)


def element_stiffness(geom: Geometry, d: jnp.ndarray) -> jnp.ndarray:
    """Per-element stiffness K_e = sum_q w_q B^T D B: (2*n_p, 2*n_p, n_e).

    Args: d (3, 3, n_int) material tangent at integration points.
    """
    wd = geom.weight[None, None, :] * d  # (3, 3, n)
    # T[b, k, n] = sum_a B[a, k, n] * wd[a, b, n]
    T = (geom.B[:, None, :, :] * wd[:, :, None, :]).sum(axis=0)
    # K[i, j, n] = sum_b T[b, i, n] * B[b, j, n]
    ke = (T[:, :, None, :] * geom.B[:, None, :, :]).sum(axis=0)
    if geom.n_q > 1:
        ke = ke.reshape(geom.n_p2, geom.n_p2, geom.n_elems, geom.n_q).sum(-1)
    return ke


def node_block_diagonal(
    geom: Geometry, d: jnp.ndarray, axis_name: Optional[str] = None
) -> jnp.ndarray:
    """2x2 nodal diagonal blocks of K for block-Jacobi preconditioning.

    Computed without materializing full element matrices (scales to
    million-element meshes).  Returns (n_n, 2, 2).
    """
    n_p = geom.n_p2 // 2
    wd = geom.weight[None, None, :] * d
    T = (geom.B[:, None, :, :] * wd[:, :, None, :]).sum(axis=0)  # (3, 2n_p, n)
    T4 = T.reshape(3, n_p, 2, -1)
    B4 = geom.B.reshape(3, n_p, 2, -1)
    # diag[p, i, j, n] = sum_b T[b, 2p+i, n] * B[b, 2p+j, n]
    diag = (T4[:, :, :, None, :] * B4[:, :, None, :, :]).sum(axis=0)
    if geom.n_q > 1:
        diag = diag.reshape(n_p, 2, 2, geom.n_elems, geom.n_q).sum(-1)
    nodes = geom.edofs_t[::2, :] // 2  # (n_p, n_e)
    out = jax.ops.segment_sum(
        diag.transpose(0, 3, 1, 2).reshape(-1, 2, 2),
        nodes.reshape(-1),
        num_segments=geom.n_nodes,
    )
    if axis_name is not None:
        out = jax.lax.psum(out, axis_name)
    return out


# ---------------------------------------------------------------------------
# dense assembly on the free-DOF subspace (reference-parity direct solves)
# ---------------------------------------------------------------------------
def free_dof_map(free_mask: np.ndarray) -> Tuple[np.ndarray, int]:
    """free_mask (n_n, 2) bool -> (map (2*n_n,) int32, n_free).

    Maps each global DOF to its position among free DOFs, or to n_free
    (a trash slot) if constrained.  Free-DOF order equals the reference's
    column-major (2, n_n) masking order (`tsx-tunnel/pythonFEM.py:1741-1744`).
    """
    flat = np.asarray(free_mask).reshape(-1)
    n_free = int(flat.sum())
    m = np.full(flat.shape, n_free, dtype=np.int32)
    m[flat] = np.arange(n_free, dtype=np.int32)
    return m, n_free


def assemble_dense_free(
    ke: jnp.ndarray, geom: Geometry, fmap: jnp.ndarray, n_free: int
) -> jnp.ndarray:
    """Scatter element matrices into the dense free-DOF stiffness.

    ke: (2*n_p, 2*n_p, n_e) from `element_stiffness`.  Returns
    (n_free, n_free); constrained rows/cols fall into a trash row/col that
    is sliced away — equivalent to the reference's `K[Q x Q^T]` masking
    (`tsx-tunnel/pythonFEM.py:1741-1744`) without the n^2 boolean outer
    product.
    """
    fd = fmap[geom.edofs_t]  # (2*n_p, n_e)
    K = jnp.zeros((n_free + 1, n_free + 1), ke.dtype)
    K = K.at[fd[:, None, :], fd[None, :, :]].add(ke)
    return K[:n_free, :n_free]


def assemble_dense_free_mxu(
    ke: jnp.ndarray, geom: Geometry, fmap: jnp.ndarray, n_free: int
) -> jnp.ndarray:
    """Dense free-DOF stiffness via one-hot matmuls (no scatter).

    K = S (blockdiag K_e) S^T with S the one-hot slot->free-DOF matrix,
    evaluated as a batched element matmul plus one large matmul: the
    scatter's duplicate-index accumulation becomes dense GEMMs.  Memory O(n_free * n_e * 2n_p) — intended for the
    small/medium parity meshes (use CG beyond).
    """
    fd = fmap[geom.edofs]  # (n_e, 2*n_p)
    S = jax.nn.one_hot(fd, n_free + 1, dtype=ke.dtype)  # (n_e, 2n_p, n_free+1)
    M = jnp.einsum(
        "ijn,njf->nif", ke, S, preferred_element_type=ke.dtype
    )  # (n_e, 2n_p, n_free+1)
    K = jnp.einsum(
        "nif,nig->fg", S, M, preferred_element_type=ke.dtype
    )
    return K[:n_free, :n_free]


# ---------------------------------------------------------------------------
# load vectors
# ---------------------------------------------------------------------------
def volume_force_vector(
    geom: Geometry, ref: ReferenceElement, f: jnp.ndarray
) -> jnp.ndarray:
    """Volume load vector: scatter of N^T (w * f) — (2*n_n,).

    Parity: `get_vector_volume` (`Elasticity2D/pythonFEM.py:246-292`).
    Args: f (2,) constant body force, or (2, n_int) field.
    """
    dtype = geom.B.dtype
    N = jnp.asarray(ref.N, dtype)  # (n_q, n_p)
    f = jnp.asarray(f, dtype)
    if f.ndim == 1:
        f = jnp.broadcast_to(f[:, None], (2, geom.n_int))
    wf = geom.weight[None, :] * f  # (2, n_int)
    n_p = geom.n_p2 // 2
    # per-node value: N[q,p] * wf[c, e*q]
    Nt = jnp.broadcast_to(
        N.T[:, None, :], (n_p, geom.n_elems, geom.n_q)
    ).reshape(n_p, -1)
    vals = Nt[:, None, :] * wf[None, :, :]  # (n_p, 2, n_int)
    vals = vals.reshape(n_p * 2, geom.n_elems, geom.n_q).sum(-1)  # (2n_p, n_e)
    return jax.ops.segment_sum(
        vals.reshape(-1), geom.edofs_t.reshape(-1), num_segments=2 * geom.n_nodes
    )


def traction_force_vector(
    coords: jnp.ndarray,
    edges: jnp.ndarray,
    surf: SurfaceElement,
    t: jnp.ndarray,
    n_nodes: int,
) -> jnp.ndarray:
    """Traction load vector over boundary edges — (2*n_n,).

    Parity: `get_vector_traction` (`Elasticity2D/pythonFEM.py:295-364`),
    including its x-projected line measure |j11| (valid for the
    axis-aligned Neumann faces of the reference benchmarks).
    """
    dtype = jnp.asarray(coords).dtype
    xe = jnp.asarray(coords)[jnp.asarray(edges)]  # (n_s, n_p_s, 2)
    N = jnp.asarray(surf.N, dtype)  # (n_q, n_p_s)
    dN = jnp.asarray(surf.dN, dtype)  # (n_q, n_p_s)
    j11 = jnp.einsum("qp,sp->sq", dN, xe[..., 0])
    w = jnp.abs(j11) * jnp.asarray(surf.w, dtype)[None, :]
    t = jnp.broadcast_to(jnp.asarray(t, dtype), (edges.shape[0], surf.n_q, 2))
    vals = jnp.einsum("qp,sq,sqc->spc", N, w, t)
    dofs = element_dofs(edges)  # (n_s, 2*n_p_s)
    return jax.ops.segment_sum(
        vals.reshape(-1), dofs.reshape(-1), num_segments=2 * n_nodes
    )


def pressure_traction_vector(
    coords: jnp.ndarray,
    edges: jnp.ndarray,
    surf: SurfaceElement,
    p,
    n_nodes: int,
) -> jnp.ndarray:
    """Normal pressure load on (possibly curved) boundary edges — (2*n_n,).

    Computes t = -p * n_out per quadrature point with the true arc-length
    measure sqrt(j11^2 + j12^2) and the outward normal (t_y, -t_x)/|t| of
    the owner-oriented edge (CCW elements keep the domain on the left).
    This completes what the reference lacks: its `get_vector_traction`
    (`Elasticity2D/pythonFEM.py:295-364`) only supports the x-projected
    measure of axis-aligned edges, and the tsx variant's surface-load hooks
    are commented out entirely (`tsx-tunnel/pythonFEM.py:1705-1708`).
    Use `mesh.boundary.boundary_edges` to extract `edges` (P1/P2/P4).
    """
    dtype = jnp.asarray(coords).dtype
    xe = jnp.asarray(coords)[jnp.asarray(edges)]  # (n_s, n_p_s, 2)
    N = jnp.asarray(surf.N, dtype)  # (n_q, n_p_s)
    dN = jnp.asarray(surf.dN, dtype)  # (n_q, n_p_s)
    tx = jnp.einsum("qp,sp->sq", dN, xe[..., 0])
    ty = jnp.einsum("qp,sp->sq", dN, xe[..., 1])
    arc = jnp.sqrt(tx * tx + ty * ty)
    w = arc * jnp.asarray(surf.w, dtype)[None, :]
    # traction on the domain from pressure p: -p * outward normal
    t = jnp.stack([-p * ty / arc, p * tx / arc], axis=-1)  # (n_s, n_q, 2)
    vals = jnp.einsum("qp,sq,sqc->spc", N, w, t)
    dofs = element_dofs(edges)
    return jax.ops.segment_sum(
        vals.reshape(-1), dofs.reshape(-1), num_segments=2 * n_nodes
    )


# ---------------------------------------------------------------------------
# integration-point -> node projection
# ---------------------------------------------------------------------------
def project_to_nodes(geom: Geometry, q_int: jnp.ndarray) -> jnp.ndarray:
    """Volume-weighted projection of a qp field to nodes: (n_n,).

    Parity: `transform` (`tsx-tunnel/pythonFEM.py:1160-1216`): nodal value
    = sum_e sum_q w*q / sum w over elements touching the node (the
    reference spreads each point's value to all element nodes with unit
    weighting; reproduced here).  q_int: (n_int,).
    """
    n_p = geom.n_p2 // 2
    wq = (geom.weight * q_int).reshape(geom.n_elems, geom.n_q).sum(-1)  # (n_e,)
    wsum = geom.weight.reshape(geom.n_elems, geom.n_q).sum(-1)
    nodes = geom.edofs_t[::2, :] // 2  # (n_p, n_e)
    num = jax.ops.segment_sum(
        jnp.broadcast_to(wq[None, :], (n_p, geom.n_elems)).reshape(-1),
        nodes.reshape(-1),
        num_segments=geom.n_nodes,
    )
    den = jax.ops.segment_sum(
        jnp.broadcast_to(wsum[None, :], (n_p, geom.n_elems)).reshape(-1),
        nodes.reshape(-1),
        num_segments=geom.n_nodes,
    )
    return num / den


# ---------------------------------------------------------------------------
# low-rank plastic tangent correction (assembled-elastic + correction CG)
# ---------------------------------------------------------------------------
def plastic_slots(ind_p: jnp.ndarray, p_max: int):
    """Static-size compaction of the plastic integration-point set.

    The Drucker-Prager consistent tangent equals the elastic tangent
    exactly at non-plastic points (`models/materials.py` return map), so
    K_tangent = K_elastic + a correction supported on the plastic points
    only — a sub-percent fraction of the mesh in the tsx/footing problems
    (379 of 56.8k at level 3).  This lets the CG operator run on the
    assembled elastic matvec (`ops/spmv.py`) plus a tiny gather/scatter
    correction instead of the full-mesh matrix-free path.

    The compaction is scatter-free AND sort-free: a prefix sum over the
    mask plus `searchsorted` for the slot positions (slot s holds the
    index of the (s+1)-th plastic point, ascending).  The earlier
    `lax.top_k` implementation had identical semantics (ties prefer the
    lower index) but costs ~O(n_int * p_max); cumsum+searchsorted is
    O(n_int + p_max * log n_int) batched gathers.  Returns
    (idx (p_max,) i32, valid (p_max,) bool).  If more than p_max points
    are plastic, the overflow is dropped: the CG operator then applies an
    inexact (still symmetric) tangent — Newton's residual is exact, so
    this costs iterations, never accuracy.
    """
    cnt = jnp.cumsum(ind_p.astype(jnp.int32))
    idx = jnp.searchsorted(
        cnt, jnp.arange(1, p_max + 1, dtype=cnt.dtype), side="left"
    )
    valid = jnp.arange(p_max) < cnt[-1]
    # padding slots point at 0 (inert: gather callers zero their weights)
    idx = jnp.where(valid, idx, 0)
    return idx.astype(jnp.int32), valid


def plastic_correction_gather(
    geom: Geometry, delta: jnp.ndarray, idx: jnp.ndarray, valid: jnp.ndarray
):
    """Gather (B, w*delta, dofs) at the static plastic slot set.

    delta: (3, 3, n_int) tangent deviation from elastic (d - d_elastic).
    Returns (Bp (3, 2n_p, P), wdelta (3, 3, P), edp (2n_p, P)).  Invalid
    (padding) slots get zero wdelta, making them inert regardless of
    where their idx points.
    """
    Bp = geom.B[:, :, idx]
    w = jnp.where(valid, geom.weight[idx], jnp.zeros((), geom.weight.dtype))
    wdelta = delta[:, :, idx] * w
    e = idx // geom.n_q
    edp = geom.edofs_t[:, e]
    return Bp, wdelta, edp


def plastic_correction_apply(
    Bp: jnp.ndarray,
    wdelta: jnp.ndarray,
    edp: jnp.ndarray,
    n_dofs: int,
    v: jnp.ndarray,
) -> jnp.ndarray:
    """(K_tangent - K_elastic) v over the gathered plastic slots.

    Same B^T (w*delta) B v contraction as `tangent_matvec` restricted to
    the slot set: gather v at the slots' element DOFs, strain, apply the
    tangent deviation, scatter B^T back.

    This runs once per CG iteration, so both ends move (x, y) node PAIRS
    (edofs are interleaved 2*node+comp, `element_dofs`): half the indices
    of the flat-DOF form for the same bytes.  Per-segment contribution order is
    unchanged (k-major, slot-minor), so results are bit-identical.
    """
    n2p, P = edp.shape
    en = edp[0::2] >> 1                           # (n_p, P) node ids
    ue = v.reshape(-1, 2)[en]                     # (n_p, P, 2)
    ue = ue.transpose(0, 2, 1).reshape(n2p, P)    # interleaved (2n_p, P)
    e3 = (Bp * ue[None, :, :]).sum(axis=1)        # (3, P)
    s3 = (wdelta * e3[None, :, :]).sum(axis=1)    # (3, P)
    fk = (Bp * s3[:, None, :]).sum(axis=0)        # (2n_p, P)
    fk2 = fk.reshape(n2p // 2, 2, P).transpose(0, 2, 1).reshape(-1, 2)
    out2 = jax.ops.segment_sum(
        fk2, en.reshape(-1), num_segments=n_dofs // 2
    )
    return out2.reshape(-1)
