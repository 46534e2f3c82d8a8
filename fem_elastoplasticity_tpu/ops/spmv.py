"""Assembled sparse operators: RCM locality + ELL / slot layouts.

The matrix-free `ops.assembly.tangent_matvec` re-derives the element
stiffness and gathers/scatters element DOFs on every application.  The
operators here are assembled ONCE on the host instead and applied as a
gather + multiply + reduce over a fixed layout:

  1. nodes are renumbered with reverse Cuthill-McKee (host, scipy), so
     every matrix row's columns lie within the RCM bandwidth and the
     gathered input stays cache-local;
  2. the elastic stiffness is assembled on the host (numpy/scipy —
     replaces the reference's per-call scipy assembly,
     `Elasticity2D/pythonFEM.py:368-477`) and stored in one of two
     padded layouts: windowed ELL (`build_ell`: deg slots per row, the
     columns of each 8x128-row group addressed inside one window of the
     input vector) or compacted slots (`build_slot`: one (source row,
     lane) slot shared by the 128 rows of an output block, optionally
     chunk-compacted per superblock — `SlotMeta`);
  3. every format is applied in plain `jnp` (gather the input at the
     stored flat column, multiply, reduce over the slot axis), which
     XLA fuses into one pass over the value stream.

The Drucker-Prager tangent is recovered as K_elastic + a low-rank plastic
correction (the return map leaves non-plastic points exactly elastic),
or by refreshing a copy of the value stream through the static
scatter table `element_corr_dest` (see `solve/newton.py`).

All jitted entry points take arrays as arguments (`utils/jitsafe.py`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .df32 import cross_sum, materialize, two_prod, two_sum
from .elements import ReferenceElement

# 128-row output blocks that share one input window in the ELL layout
_WINDOW_BLOCKS = 8


# ---------------------------------------------------------------------------
# host-side: locality ordering + elastic CSR assembly
# ---------------------------------------------------------------------------
def rcm_node_order(elems: np.ndarray, n_nodes: int) -> np.ndarray:
    """Reverse Cuthill-McKee node ordering from element connectivity.

    Returns `order` with order[k] = old node id placed at new position k.
    Bandwidth O(sqrt(n)) on planar meshes — the window size J of the ELL
    kernel is bandwidth/128, so locality here directly bounds kernel cost.
    """
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    elems = np.asarray(elems)
    n_p = elems.shape[1]
    rows, cols = [], []
    for a in range(n_p):
        for b in range(a + 1, n_p):
            rows.append(elems[:, a])
            cols.append(elems[:, b])
    i = np.concatenate(rows + cols)
    j = np.concatenate(cols + rows)
    adj = sp.coo_matrix(
        (np.ones(i.shape[0], np.int8), (i, j)), shape=(n_nodes, n_nodes)
    ).tocsr()
    return np.asarray(reverse_cuthill_mckee(adj, symmetric_mode=True))


def permute_mesh(coords: np.ndarray, elems: np.ndarray, order: np.ndarray):
    """Apply a node order: returns (coords', elems', new_of_old)."""
    n_n = coords.shape[0]
    new_of_old = np.empty(n_n, np.int64)
    new_of_old[order] = np.arange(n_n)
    return coords[order], new_of_old[np.asarray(elems)], new_of_old


def host_element_stiffness(
    coords: np.ndarray,
    elems: np.ndarray,
    ref: ReferenceElement,
    d33: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Numpy K_e = sum_q w_q B^T D B — setup-time oracle-grade assembly.

    Same math as `ops.assembly.compute_geometry`+`element_stiffness`
    (`Elasticity2D/pythonFEM.py:385-470` parity) but pure numpy so it
    never touches the accelerator.  d33: (3, 3) constant material tangent
    (elastic).  Returns (ke (n_e, 2n_p, 2n_p) f64, edofs (n_e, 2n_p)).
    """
    coords = np.asarray(coords, np.float64)
    elems = np.asarray(elems)
    xe = coords[elems]                       # (n_e, n_p, 2)
    dN = np.asarray(ref.dN, np.float64)      # (n_q, n_p, 2)
    n_q, n_p, _ = dN.shape
    n_e = elems.shape[0]
    J = np.einsum("qpi,epj->eqij", dN, xe)
    det = J[..., 0, 0] * J[..., 1, 1] - J[..., 0, 1] * J[..., 1, 0]
    inv = np.empty_like(J)
    inv[..., 0, 0] = J[..., 1, 1]
    inv[..., 0, 1] = -J[..., 0, 1]
    inv[..., 1, 0] = -J[..., 1, 0]
    inv[..., 1, 1] = J[..., 0, 0]
    inv /= det[..., None, None]
    dphi = np.einsum("eqij,qpj->eqpi", inv, dN)   # (n_e, n_q, n_p, 2)
    w = np.abs(det) * np.asarray(ref.w, np.float64)[None, :]

    B = np.zeros((n_e, n_q, 3, 2 * n_p))
    B[:, :, 0, 0::2] = dphi[..., 0]
    B[:, :, 1, 1::2] = dphi[..., 1]
    B[:, :, 2, 0::2] = dphi[..., 1]
    B[:, :, 2, 1::2] = dphi[..., 0]
    DB = np.einsum("ab,eqbj->eqaj", np.asarray(d33, np.float64), B)
    ke = np.einsum("eqai,eqaj,eq->eij", B, DB, w)
    edofs = np.stack([2 * elems, 2 * elems + 1], axis=-1).reshape(n_e, -1)
    return ke, edofs


def assemble_csr(ke: np.ndarray, edofs: np.ndarray, n2: int):
    """Scatter element matrices into a scipy CSR (setup-time only)."""
    import scipy.sparse as sp

    n_e, n2p, _ = ke.shape
    rows = np.repeat(edofs, n2p, axis=1).reshape(-1)
    cols = np.tile(edofs, (1, n2p)).reshape(-1)
    K = sp.coo_matrix((ke.reshape(-1), (rows, cols)), shape=(n2, n2)).tocsr()
    K.sum_duplicates()
    return K


def apply_bc_csr(K, free_flat: np.ndarray):
    """Zero constrained rows/cols, unit diagonal (reference masking
    semantics without the Q Q^T outer product, T:1741-1744).

    Scales `K.data` in place rather than multiplying by diagonal
    matrices: scipy's sparse matmul PRUNES zero-valued results, and the
    full element-connectivity pattern must survive — structured meshes
    carry exact zeros in the ELASTIC stiffness (axis-aligned xy cross
    terms) at positions the PLASTIC tangent needs (the static-structure
    value refresh scatters into them, `element_corr_dest`).
    """
    free = np.asarray(free_flat).reshape(-1)
    Kf = K.tocsr().copy()
    Kf.sum_duplicates()
    rows = np.repeat(np.arange(Kf.shape[0]), np.diff(Kf.indptr))
    Kf.data = Kf.data * (free[rows] & free[Kf.indices])
    # unit diagonal at constrained DOFs, written in place (scipy 1.17
    # binary ops like `+ diags(...)` ALSO prune zero entries) — every
    # diagonal is structurally present: each DOF belongs to an element
    con = np.nonzero(~free)[0]
    kd = csr_lookup(Kf, con, con)
    assert (kd >= 0).all(), "missing diagonal entries in the FEM pattern"
    Kf.data[kd] = 1.0
    return Kf


# ---------------------------------------------------------------------------
# ELL build
# ---------------------------------------------------------------------------
class EllMeta(NamedTuple):
    """Static metadata of a windowed-ELL operator (hashable, jit-static)."""

    n2: int        # output (row) count
    n_in: int      # input (column) count — equals n2 for square operators
    deg: int       # ELL slots per row
    J: int         # window rows per group
    n_groups: int
    vrows: int     # input-vector rows incl. J guard rows
    n_overflow: int  # COO entries outside the window cap (XLA side path)


def build_ell(K_csr, dtype=np.float32, max_overflow_frac=0.005):
    """CSR -> windowed-ELL arrays for `ell_matvec`.

    Works for rectangular operators too (e.g. multigrid prolongation /
    restriction): rows index the output, columns the input vector.

    The window size J is chosen as the smallest cap leaving at most
    `max_overflow_frac` of the entries outside their group's window;
    those spill into a COO side list applied with plain XLA gather /
    scatter (serialized, but tiny), so a handful of long-range rows
    cannot inflate every group's kernel cost.

    Returns (arrays dict, EllMeta).  arrays:
      w0     (n_groups,) i32          window base row per group (SMEM)
      li     (n_groups, deg*_WINDOW_BLOCKS, 128) i32 window-local column index
      vals   (n_groups, deg*_WINDOW_BLOCKS, 128) f32 matrix values (0 on padding)
      ov_r/ov_c/ov_v                  overflow COO (present if any)
    """
    n2, n_in = K_csr.shape
    deg_arr = np.diff(K_csr.indptr)
    deg_full = int(max(deg_arr.max(), 1))
    # row-degree cap: ELL pads EVERY row to the slot count, so a handful
    # of high-valence rows can inflate the arrays severalfold (measured:
    # the tsx S operator at level 4 carried deg=142 for a 99.9th-
    # percentile degree of ~30).  Spill the excess entries of outlier
    # rows into the overflow side path (exact: slot-df or XLA COO).
    deg = deg_full
    cands = sorted(
        {int(np.quantile(deg_arr, q)) for q in (0.9, 0.99, 0.999)}
        | {deg_full}
    )
    for cand in cands:
        cand = max(cand, 1)
        n_spill = int(np.maximum(deg_arr - cand, 0).sum())
        if n_spill <= 0.5 * max_overflow_frac * max(K_csr.nnz, 1):
            deg = cand
            break
    n2r = -(-max((n2 + 127) // 128, 1) // _WINDOW_BLOCKS) * _WINDOW_BLOCKS
    n2_pad = n2r * 128
    in_rows = max((n_in + 127) // 128, 1)

    ell_vals = np.zeros((deg, n2_pad), dtype)
    ell_cols = np.full((deg, n2_pad), -1, np.int64)  # -1 = padding slot
    idx = np.arange(K_csr.nnz)
    rowid = np.repeat(np.arange(n2), deg_arr)
    slot = idx - K_csr.indptr[rowid]
    keep_e = slot < deg
    sp_rows = rowid[~keep_e]
    sp_cols = K_csr.indices[~keep_e].astype(np.int64)
    sp_vals = K_csr.data[~keep_e].astype(dtype)
    ell_vals[slot[keep_e], rowid[keep_e]] = K_csr.data[keep_e].astype(dtype)
    ell_cols[slot[keep_e], rowid[keep_e]] = K_csr.indices[keep_e]

    n_groups = n2r // _WINDOW_BLOCKS
    cols3 = ell_cols.reshape(deg, n_groups, _WINDOW_BLOCKS * 128)
    colr = np.where(cols3 >= 0, cols3 // 128, -1)
    valid = cols3 >= 0
    n_valid = int(valid.sum())
    # robust window center per group: median source row of real entries
    med = np.full(n_groups, 0.0)
    any_valid = valid.any(axis=(0, 2))
    masked = np.where(valid, colr, np.nan).transpose(1, 0, 2).reshape(
        n_groups, -1
    )
    with np.errstate(all="ignore"):
        med_all = np.nanmedian(masked, axis=1)
    med[any_valid] = med_all[any_valid]

    for J in (4, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256):
        w0 = np.clip(
            np.round(med).astype(np.int64) - J // 2, 0, max(in_rows - 1, 0)
        )
        within = valid & (colr >= w0[None, :, None]) & (
            colr < (w0 + J)[None, :, None]
        )
        n_ov = n_valid - int(within.sum())
        if n_ov <= max_overflow_frac * max(n_valid, 1) or J >= in_rows:
            break

    w0 = w0.astype(np.int32)
    keep = within
    li64 = cols3 - (w0[None, :, None].astype(np.int64) * 128)
    li = np.where(keep, li64, 0).astype(np.int32)
    vals3 = np.where(keep, ell_vals.reshape(deg, n_groups, _WINDOW_BLOCKS * 128), 0)

    # overflow COO: window outliers + the degree-cap spill
    ov = valid & ~keep
    if n_ov:
        d_ix, g_ix, p_ix = np.nonzero(ov)
        ov_rows = (g_ix * (_WINDOW_BLOCKS * 128) + p_ix).astype(np.int64)
        ov_cols = cols3[d_ix, g_ix, p_ix]
        ov_vals = ell_vals.reshape(deg, n_groups, _WINDOW_BLOCKS * 128)[
            d_ix, g_ix, p_ix
        ]
    else:
        ov_rows = np.zeros(0, np.int64)
        ov_cols = np.zeros(0, np.int64)
        ov_vals = np.zeros(0, dtype)
    if sp_rows.size:
        ov_rows = np.concatenate([ov_rows, sp_rows.astype(np.int64)])
        ov_cols = np.concatenate([ov_cols, sp_cols])
        ov_vals = np.concatenate([ov_vals, sp_vals])
        n_ov = int(ov_rows.size)

    li = np.ascontiguousarray(
        li.reshape(deg, n_groups, _WINDOW_BLOCKS, 128).transpose(1, 0, 2, 3)
    ).reshape(n_groups, deg * _WINDOW_BLOCKS, 128)
    vals = np.ascontiguousarray(
        vals3.reshape(deg, n_groups, _WINDOW_BLOCKS, 128).transpose(1, 0, 2, 3)
    ).reshape(n_groups, deg * _WINDOW_BLOCKS, 128)

    meta = EllMeta(
        n2=n2, n_in=n_in, deg=deg, J=int(J), n_groups=n_groups,
        vrows=in_rows + int(J), n_overflow=int(n_ov),
    )
    arrays = dict(
        w0=jnp.asarray(w0), li=jnp.asarray(li), vals=jnp.asarray(vals)
    )
    if n_ov:
        arrays["ov_r"] = jnp.asarray(ov_rows.astype(np.int32))
        arrays["ov_c"] = jnp.asarray(ov_cols.astype(np.int32))
        arrays["ov_v"] = jnp.asarray(ov_vals, jnp.float32)
    return arrays, meta


def build_ell_elastic(
    coords: np.ndarray,
    elems: np.ndarray,
    ref: ReferenceElement,
    shear: float,
    bulk: float,
    free: Optional[np.ndarray] = None,
    dtype=np.float32,
    fmt: str = "ell",
):
    """Elastic-stiffness assembled sparse operator in one call (host setup).

    `free`: (n_n, 2) bool mask — constrained rows/cols are zeroed with
    unit diagonal so the operator is SPD on the whole space.
    `fmt`: "ell" (windowed-ELL) or "slot" (compacted-slot; 2.6x faster
    at 910k DOFs — see `build_slot`).
    Returns (arrays, meta, K_csr) — the CSR is kept for diag extraction.
    """
    dd = 4.0 * shear / 3.0 + bulk
    oo = -2.0 * shear / 3.0 + bulk
    d33 = np.array([[dd, oo, 0.0], [oo, dd, 0.0], [0.0, 0.0, shear]])
    ke, edofs = host_element_stiffness(coords, elems, ref, d33)
    n2 = 2 * coords.shape[0]
    K = assemble_csr(ke, edofs, n2)
    if free is not None:
        K = apply_bc_csr(K, np.asarray(free).reshape(-1))
    arrays, meta = build_sparse(K, dtype, fmt=fmt)
    return arrays, meta, K


def build_sparse(K_csr, dtype=np.float32, fmt: str = "ell"):
    """CSR -> (arrays, meta) in the requested layout.

    "rslot" = ragged compacted-slot (chunk-compacted value stream; falls
    back to the dense slot layout when chunking saves <15% — see
    SlotMeta).  Consumers dispatch on the meta, so the formats mix
    freely within one hierarchy.
    """
    if fmt == "rslot":
        return build_slot(K_csr, dtype, ragged=True, u=_RAGGED_U)
    if fmt == "slot":
        return build_slot(K_csr, dtype)
    assert fmt == "ell", fmt
    return build_ell(K_csr, dtype)


def sp_matvec(arrays: dict, meta, v: jnp.ndarray) -> jnp.ndarray:
    """Format-generic K v: dispatches on the static meta type."""
    if isinstance(meta, ShardedMeta):
        return _sharded_matvec(arrays, meta, v)
    if isinstance(meta, SlotMeta):
        return slot_matvec(arrays, meta, v)
    return ell_matvec(arrays, meta, v)


def diag_blocks_csr(K_csr, n_n: int) -> np.ndarray:
    """(n_n, 2, 2) nodal diagonal blocks from CSR (host, for smoothers)."""
    out = np.zeros((n_n, 2, 2))
    K = K_csr.tocsr()
    for di in range(2):
        for dj in range(2):
            out[:, di, dj] = K[di::2, dj::2].diagonal()
    return out


# ---------------------------------------------------------------------------
# the windowed-ELL matvec (plain XLA: one gather + multiply + slot reduce)
# ---------------------------------------------------------------------------
def _pad_flat(v: jnp.ndarray, n: int) -> jnp.ndarray:
    """Flat f32 vector zero-padded (or cut) to length n."""
    v = jnp.asarray(v, jnp.float32).reshape(-1)
    if v.shape[0] >= n:
        return v[:n]
    return jnp.pad(v, (0, n - v.shape[0]))


def _ell_cols(arrays: dict) -> jnp.ndarray:
    """Flat input index of every ELL slot: window base row * 128 + local."""
    return arrays["w0"][:, None, None] * 128 + arrays["li"]


def _ell_groups(x: jnp.ndarray, meta: EllMeta) -> jnp.ndarray:
    """(n_groups, deg*B, 128) slot tensor -> (n_groups, deg, B*128)."""
    return x.reshape(meta.n_groups, meta.deg, _WINDOW_BLOCKS * 128)


def ell_matvec(arrays: dict, meta: EllMeta, v: jnp.ndarray) -> jnp.ndarray:
    """K v on the windowed-ELL layout.  v: flat (n_in,) f32."""
    vf = _pad_flat(v, meta.vrows * 128)
    prod = arrays["vals"] * vf[_ell_cols(arrays)]
    out = _ell_groups(prod, meta).sum(axis=1).reshape(-1)
    if meta.n_overflow:
        # long-range entries outside the window cap: COO side path
        v32 = jnp.asarray(v, jnp.float32)
        out = out.at[arrays["ov_r"]].add(arrays["ov_v"] * v32[arrays["ov_c"]])
    return out[: meta.n2]


# ---------------------------------------------------------------------------
# compacted-slot format: level-independent work per row
# ---------------------------------------------------------------------------
class SlotMeta(NamedTuple):
    """Static metadata of a compacted-slot operator (hashable, jit-static).

    The compacted-slot format assigns every matrix entry to a (source
    row, dup) slot shared by the 128 rows of its output block: the slot
    count S is a *local* property of the mesh (~31 per block for P1,
    level-independent from L4 to L5), unlike the windowed-ELL window,
    which grows with the RCM bandwidth ~ sqrt(n).  The 8 blocks of a
    superblock share one slot index.
    """

    n2: int      # output rows
    n_in: int    # input length
    n_sb: int    # superblocks (8 x 128 output rows each)
    s_pad: int   # padded slots per block
    vrows: int   # input-vector rows
    # ragged chunking (0 = dense layout): the dense layout pads EVERY
    # superblock to the global max slot count — under the multigrid
    # hierarchy's parent ordering the fine tsx level carries s_pad=100
    # for a mean slot count of ~31, so a dense application streams ~3x
    # padding.  The ragged layout stores each superblock's slots
    # chunk-compacted (u slots per chunk); chunk partials are folded
    # into their superblocks by a segment sum, so work and memory
    # traffic scale with sum(ceil(nsl/u)) instead of n_sb * s_pad.
    n_ch: int = 0  # total chunks (ragged); 0 = dense slot layout
    u: int = 0     # slots per chunk (ragged)


def _slot_pack(K_csr):
    """Shared CSR -> slot-layout packing (indices only, value-agnostic).

    Returns (meta, nsl, srow (n_sb*8, s_pad), cidx (n_sb*8, s_pad, 128),
    fill=(blk2, s, lane2), perm) where `K_csr.data[perm]` is the value
    stream aligned with the fill indices.
    """
    n2, n_in = K_csr.shape
    deg_arr = np.diff(K_csr.indptr)
    rows = np.repeat(np.arange(n2, dtype=np.int64), deg_arr)
    cols = K_csr.indices.astype(np.int64)

    blk = rows >> 7
    lane = rows & 127
    r = cols >> 7
    c = cols & 127
    # size from n2, NOT from the last nonzero row: trailing empty rows
    # (common in overflow side matrices) must still produce output —
    # empty superblocks cost nothing (nsl = 0 skips the slot loop)
    n_blocks = max((n2 + 127) // 128, 1)
    n_sb = (n_blocks + 7) // 8
    vrows = max((n_in + 127) // 128, 1)

    # dup layer k: running count of entries per (blk, r, lane)
    o = np.lexsort((c, lane, r, blk))
    blk, lane, r, c = blk[o], lane[o], r[o], c[o]
    key_brl = (blk * vrows + r) * 128 + lane
    new = np.ones(key_brl.shape[0], bool)
    new[1:] = key_brl[1:] != key_brl[:-1]
    run_start = np.maximum.accumulate(np.where(new, np.arange(new.size), 0))
    k = np.arange(new.size) - run_start

    # slot id: rank of (r, k) within each block, ordered by (r, k)
    o2 = np.lexsort((k, r, blk))
    blk2, lane2, r2, c2, k2 = blk[o2], lane[o2], r[o2], c[o2], k[o2]
    # radix for exact (blk, r, k) key packing (k can exceed the typical
    # P1 bound of ~64 for high-order elements: a P4 row reaches ~100+
    # entries inside one 128-column tile under locality ordering)
    k_radix = int(k2.max(initial=0)) + 1
    key_brk = (blk2 * vrows + r2) * k_radix + k2
    new2 = np.ones(key_brk.shape[0], bool)
    new2[1:] = key_brk[1:] != key_brk[:-1]
    # slot index = number of distinct (r,k) seen so far within the block
    blk_change = np.ones(key_brk.shape[0], bool)
    blk_change[1:] = blk2[1:] != blk2[:-1]
    slot_cum = np.cumsum(new2)
    blk_base = np.maximum.accumulate(
        np.where(blk_change, slot_cum - 1, 0)
    )
    s = slot_cum - 1 - blk_base

    S_b = np.zeros(n_sb * 8, np.int64)
    if s.size:
        np.maximum.at(S_b, blk2, s + 1)
    s_pad = int(max(S_b.max(initial=1), 1))
    nsl = S_b.reshape(n_sb, 8).max(axis=1).astype(np.int32)

    srow = np.zeros((n_sb * 8, s_pad), np.int32)
    cidx = np.zeros((n_sb * 8, s_pad, 128), np.int32)
    srow[blk2, s] = r2.astype(np.int32)
    cidx[blk2, s, lane2] = c2.astype(np.int32)

    meta = SlotMeta(n2=n2, n_in=n_in, n_sb=n_sb, s_pad=s_pad, vrows=vrows)
    return meta, nsl, srow, cidx, (blk2, s, lane2), o[o2]


def slot_csr_positions(K_csr, meta: "SlotMeta") -> np.ndarray:
    """Flat destination of every CSR nonzero inside the slot `vals` tensor.

    Re-runs the (deterministic) `_slot_pack` on the SAME matrix the
    operator was built from and converts each entry's (block, slot, lane)
    cell to its flat index in the packed value array — the dense tiled
    layout (n_sb, s_pad, 8, 128) or the ragged chunk layout
    (n_ch, u, 8, 128), matching `meta`.  Returns (nnz,) int64, aligned
    with `K_csr.data`.

    This is the host half of the static-structure tangent refresh
    (`solve/newton.py` corr_dest): because the assembled operator's
    sparsity is FIXED across Newton iterations (SURVEY §7 "same fixed
    sparsity every iteration"), per-integration-point tangent corrections
    can be scatter-added into a copy of the value stream once per Newton
    iteration — every CG matvec then runs the plain slot kernel with no
    per-iteration gather/segment-sum correction operator.
    """
    meta2, nsl, srow, cidx, (blk2, s, lane2), perm = _slot_pack(K_csr)
    assert (meta2.n2, meta2.n_in, meta2.n_sb, meta2.s_pad) == (
        meta.n2, meta.n_in, meta.n_sb, meta.s_pad,
    ), (meta2, meta)
    sb = blk2 >> 3
    p = blk2 & 7
    if meta.n_ch:
        # ragged chunk layout (_ragged_pack): chunk = base[sb] + s // u,
        # cell (chunk, s % u, p, lane)
        u = meta.u
        nch_b = np.maximum((nsl.astype(np.int64) + u - 1) // u, 1)
        base = np.cumsum(nch_b) - nch_b
        ch = base[sb] + s // u
        flat = ((ch * u + s % u) * 8 + p) * 128 + lane2
    else:
        flat = ((sb * meta.s_pad + s) * 8 + p) * 128 + lane2
    pos = np.empty(K_csr.nnz, np.int64)
    pos[perm] = flat
    return pos


def csr_lookup(K_csr, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """Vectorized CSR entry lookup: index k with (row, col), else -1."""
    n2 = K_csr.shape[1]
    deg = np.diff(K_csr.indptr)
    all_keys = (
        np.repeat(np.arange(K_csr.shape[0], dtype=np.int64), deg) * n2
        + K_csr.indices.astype(np.int64)
    )
    q = rows.astype(np.int64) * n2 + cols.astype(np.int64)
    k = np.searchsorted(all_keys, q)
    k = np.minimum(k, max(all_keys.size - 1, 0))
    hit = all_keys[k] == q if all_keys.size else np.zeros(q.shape, bool)
    return np.where(hit, k, -1)


def element_corr_dest(
    K_csr, meta: "SlotMeta", elems: np.ndarray, free_flat: np.ndarray
) -> np.ndarray:
    """(n_e, 2n_p, 2n_p) i32 scatter destinations for per-element tangent
    correction blocks into the slot value stream of the assembled
    (BC-masked) operator built from `K_csr`.

    Entries whose row or column DOF is constrained get -1 (dropped by the
    runtime scatter, mode='drop'): the assembled operator zeroes those
    rows/cols (`apply_bc_csr`) and CG masks them, so omitting the
    correction there is exact.  Local DOF order is the interleaved
    [2v0, 2v0+1, 2v1, ...] convention of `Geometry.edofs` /
    `plastic_correction_gather`.
    """
    pos = slot_csr_positions(K_csr, meta)
    edofs = np.stack([2 * elems, 2 * elems + 1], axis=-1).reshape(
        elems.shape[0], -1
    )
    n2p = edofs.shape[1]
    rows = np.repeat(edofs, n2p, axis=1).reshape(-1)
    cols = np.tile(edofs, (1, n2p)).reshape(-1)
    free = np.asarray(free_flat).reshape(-1)
    k = csr_lookup(K_csr, rows, cols)
    ok = (k >= 0) & free[rows] & free[cols]
    dest = np.where(ok, pos[np.maximum(k, 0)], -1)
    assert dest.max(initial=-1) < np.iinfo(np.int32).max
    return dest.reshape(elems.shape[0], n2p, n2p).astype(np.int32)


def _slot_tile(x, n_sb, s_pad):
    """(n_sb*8, s_pad, 128) -> (n_sb, s_pad, 8, 128) contiguous."""
    return jnp.asarray(
        np.ascontiguousarray(
            x.reshape(n_sb, 8, s_pad, 128).transpose(0, 2, 1, 3)
        )
    )


def _ragged_pack(meta, nsl, srow, cidx, vals_named, u):
    """Dense slot tensors -> chunk-compacted ragged arrays (or None).

    nsl: (n_sb,) per-superblock slot bound.  srow: (n_sb*8, s_pad).
    cidx: (n_sb*8, s_pad, 128).  vals_named: {key: (n_sb*8, s_pad, 128)}
    value tensors.  Returns (arrays, meta) with meta.n_ch/u set, or None
    when chunking would save <15% of the dense slot volume (uniform
    operators: the dense layout is already tight and needs no chunk
    fold).
    """
    n_sb, s_pad = meta.n_sb, meta.s_pad
    u = int(min(u, s_pad))
    nch_b = np.maximum((nsl.astype(np.int64) + u - 1) // u, 1)
    n_ch = int(nch_b.sum())
    if n_ch * u > 0.85 * n_sb * s_pad:
        return None
    n_cmax = (s_pad + u - 1) // u
    sp_u = n_cmax * u
    sb_of = np.repeat(np.arange(n_sb, dtype=np.int32), nch_b)
    base = np.cumsum(nch_b) - nch_b
    lc = np.arange(n_ch, dtype=np.int64) - np.repeat(base, nch_b)

    srow_p = np.zeros((n_sb, 8, sp_u), np.int32)
    srow_p[:, :, :s_pad] = srow.reshape(n_sb, 8, s_pad)
    srow_r = srow_p.reshape(n_sb, 8, n_cmax, u).transpose(0, 2, 1, 3)[
        sb_of, lc
    ]

    def tile_chunks(x, dt):
        # numpy-only variant of _slot_tile + chunk gather (no device
        # round-trip: these tensors reach GBs at refinement level 5)
        xp = np.zeros((n_sb, sp_u, 8, 128), dt)
        xp[:, :s_pad] = x.reshape(n_sb, 8, s_pad, 128).transpose(0, 2, 1, 3)
        return jnp.asarray(
            np.ascontiguousarray(
                xp.reshape(n_sb, n_cmax, u, 8, 128)[sb_of, lc]
            )
        )

    arrays = dict(
        sbmap=jnp.asarray(sb_of),
        srow=jnp.asarray(np.ascontiguousarray(srow_r)),
        cidx=tile_chunks(cidx, np.int32),
    )
    for k, v in vals_named.items():
        arrays[k] = tile_chunks(v, v.dtype)
    return arrays, meta._replace(n_ch=n_ch, u=u)


def build_slot(K_csr, dtype=np.float32, ragged=False, u=16):
    """CSR -> compacted-slot arrays for `slot_matvec`.

    Returns (arrays, meta).  Dense layout (ragged=False, or ragged
    chunking would save <15%):
      nsl  (n_sb,)              i32  slot bound per superblock (SMEM)
      srow (n_sb, 8, s_pad)     i32  source vector row per (block, slot)
      cidx (n_sb, s_pad, 8,128) i32  lane index within the source row
      vals (n_sb, s_pad, 8,128) f32  matrix values (0 on padding)
    Ragged layout (meta.n_ch > 0; see SlotMeta): sbmap (n_ch,) i32 plus
    srow (n_ch, 8, u) / cidx / vals (n_ch, u, 8, 128) chunk-compacted.
    """
    meta, nsl, srow, cidx, (blk2, s, lane2), perm = _slot_pack(K_csr)
    vals = np.zeros((meta.n_sb * 8, meta.s_pad, 128), dtype)
    vals[blk2, s, lane2] = K_csr.data[perm].astype(dtype)
    if ragged:
        rg = _ragged_pack(meta, nsl, srow, cidx, dict(vals=vals), u)
        if rg is not None:
            return rg
    arrays = dict(
        nsl=jnp.asarray(nsl),
        srow=jnp.asarray(srow.reshape(meta.n_sb, 8, meta.s_pad)),
        cidx=_slot_tile(cidx, meta.n_sb, meta.s_pad),
        vals=_slot_tile(vals, meta.n_sb, meta.s_pad),
    )
    return arrays, meta


def build_slot_df(K_csr, ragged=False, u=16):
    """CSR (f64 values) -> slot arrays for `slot_matvec_df`.

    Like `build_slot` but the f64 values are split exactly into two-f32
    (hi, lo) pairs, for the double-float kernel that preserves ~1e-14
    relative accuracy (the Newton residual path).  ragged: see
    `build_slot` / SlotMeta.
    """
    meta, nsl, srow, cidx, (blk2, s, lane2), perm = _slot_pack(K_csr)
    d64 = K_csr.data[perm].astype(np.float64)
    d_hi = d64.astype(np.float32)
    d_lo = (d64 - d_hi.astype(np.float64)).astype(np.float32)
    vh = np.zeros((meta.n_sb * 8, meta.s_pad, 128), np.float32)
    vl = np.zeros_like(vh)
    vh[blk2, s, lane2] = d_hi
    vl[blk2, s, lane2] = d_lo
    if ragged:
        rg = _ragged_pack(
            meta, nsl, srow, cidx, dict(vals_hi=vh, vals_lo=vl), u
        )
        if rg is not None:
            return rg
    arrays = dict(
        nsl=jnp.asarray(nsl),
        srow=jnp.asarray(srow.reshape(meta.n_sb, 8, meta.s_pad)),
        cidx=_slot_tile(cidx, meta.n_sb, meta.s_pad),
        vals_hi=_slot_tile(vh, meta.n_sb, meta.s_pad),
        vals_lo=_slot_tile(vl, meta.n_sb, meta.s_pad),
    )
    return arrays, meta


class EllDfMeta(NamedTuple):
    """Static metadata of a double-float windowed-ELL operator.

    `ov` is the SlotMeta of the exact overflow side operator (entries
    outside the window cap run through `slot_matvec_df`, preserving the
    compensated accumulation — a plain XLA scatter-add side path would
    break the ~1e-14 accuracy of rows containing overflow entries).
    """

    ell: EllMeta
    ov: Optional[SlotMeta]


def build_ell_df(K_csr, max_overflow_frac=0.005):
    """CSR (f64 values) -> windowed-ELL arrays for `ell_matvec_df`.

    The dense-in-rows ELL layout stores deg*n2_pad value pairs — for the
    low-degree residual operators (G: 2n_p entries/row) this is ~an order
    of magnitude smaller than the compacted-slot layout, whose padded
    size is n_sb * max-block-slots (outlier blocks inflate every block).
    Window selection is structure-only, so the hi and lo value streams
    share one `build_ell` layout.
    """
    import scipy.sparse as sp

    d64 = K_csr.data.astype(np.float64)
    d_hi = d64.astype(np.float32)
    d_lo = (d64 - d_hi.astype(np.float64)).astype(np.float32)
    Kh = sp.csr_matrix(
        (d_hi.astype(np.float64), K_csr.indices, K_csr.indptr),
        shape=K_csr.shape,
    )
    Kl = sp.csr_matrix(
        (d_lo.astype(np.float64), K_csr.indices, K_csr.indptr),
        shape=K_csr.shape,
    )
    ah, meta = build_ell(Kh, np.float32, max_overflow_frac)
    al, meta_l = build_ell(Kl, np.float32, max_overflow_frac)
    assert meta_l == meta  # same structure -> same layout
    arrays = dict(
        w0=ah["w0"], li=ah["li"],
        vals_hi=ah["vals"], vals_lo=al["vals"],
    )
    ov = None
    if meta.n_overflow:
        # exact df32 side path: slot-df operator over the overflow COO.
        # Rows are COMPACTED to the occupied set first: the slot layout
        # pads n_sb * s_pad slots across ALL output blocks, so building
        # it over the full row space pays ~100x memory for the ~1% of
        # rows that actually hold overflow entries (~100 MB for the G
        # operator at refinement level 4 — ROADMAP r2 #1).  The compact
        # result is df-added back into the kernel output by row index;
        # two_sum with an exact zero is the identity, so untouched rows
        # are bit-identical to the uncompacted operator.
        ov_r = np.asarray(ah["ov_r"], np.int64)
        ov_c = np.asarray(ah["ov_c"], np.int64)
        ov_v = np.asarray(ah["ov_v"], np.float64) + np.asarray(
            al["ov_v"], np.float64
        )
        rows_nz = np.unique(ov_r)
        Kov = sp.coo_matrix(
            (ov_v, (np.searchsorted(rows_nz, ov_r), ov_c)),
            shape=(rows_nz.size, K_csr.shape[1]),
        ).tocsr()
        Kov.sum_duplicates()
        ov_arrays, ov_meta = build_slot_df(Kov)
        for k, v in ov_arrays.items():
            arrays["ovdf_" + k] = v
        arrays["ovdf_rows"] = jnp.asarray(rows_nz.astype(np.int32))
        ov = ov_meta
    return arrays, EllDfMeta(ell=meta, ov=ov)


def ell_matvec_df(arrays: dict, meta: EllDfMeta, v_hi, v_lo):
    """A v in double-float on the windowed-ELL layout.

    Returns (out_hi, out_lo) flat (n2,), ~1e-14-relative (validated in
    tests/test_spmv.py).  Window-overflow entries run through the exact
    slot-df side operator and are df-added to the main result.
    """
    em = meta.ell
    n = em.vrows * 128
    col = _ell_cols(arrays)
    p, e = _df_terms(
        arrays["vals_hi"], arrays["vals_lo"],
        _pad_flat(v_hi, n)[col], _pad_flat(v_lo, n)[col],
    )
    oh, ol = _df_sum(_ell_groups(p, em), _ell_groups(e, em), 1)
    oh = oh.reshape(-1)[: em.n2]
    ol = ol.reshape(-1)[: em.n2]
    if meta.ov is not None:
        from .df32 import DF, df_add, df_barrier

        ov_arrays = {
            k[len("ovdf_"):]: v
            for k, v in arrays.items()
            if k.startswith("ovdf_")
        }
        rows = ov_arrays.pop("rows")  # compacted row index (build_ell_df)
        ovh, ovl = slot_matvec_df(ov_arrays, meta.ov, v_hi, v_lo)
        sub = df_barrier(
            df_add(DF(oh[rows], ol[rows]), DF(ovh, ovl))
        )
        return oh.at[rows].set(sub.hi), ol.at[rows].set(sub.lo)
    return oh, ol


class SplitColsDfMeta(NamedTuple):
    """Column-split double-float operator: A v = sum_k A_k v[k-th slice].

    Used for operators whose columns live in widely separated index
    regions (the S force operator's columns are component-major
    integration points at offsets 0 / n_int / 2*n_int): one windowed-ELL
    layout can never cover all regions (measured 59% overflow at level
    4), but each per-region part windows tightly.  Partial results are
    combined with the compensated `df_add`.
    """

    metas: tuple  # per-part EllDfMeta/SlotMeta (equal column slices)
    n_in: int


def sp_matvec_df(arrays: dict, meta, v_hi, v_lo, pin=None):
    """Format-generic double-float A v: dispatches on the meta type.

    pin: the df32 pipeline's runtime zeros (`ops.df32.df_pin`).  The
    result is pinned with them, so that no compiler rewrite reaches
    across this stage boundary into the compensated products and sums;
    None skips the pin.
    """
    from .df32 import DF, df_pin

    out = df_pin(DF(*_sp_matvec_df(arrays, meta, v_hi, v_lo)), pin)
    return out.hi, out.lo


def _sp_matvec_df(arrays: dict, meta, v_hi, v_lo):
    if isinstance(meta, ShardedMeta):
        return _sharded_matvec_df(arrays, meta, v_hi, v_lo)
    if isinstance(meta, SplitColsDfMeta):
        from .df32 import DF, df_add, df_barrier

        w = meta.n_in // len(meta.metas)
        acc = None
        for k, m in enumerate(meta.metas):
            pre = f"p{k}_"
            sub = {
                kk[len(pre):]: vv
                for kk, vv in arrays.items()
                if kk.startswith(pre)
            }
            oh, ol = _sp_matvec_df(
                sub, m, v_hi[k * w:(k + 1) * w], v_lo[k * w:(k + 1) * w]
            )
            acc = (
                DF(oh, ol) if acc is None else df_add(acc, DF(oh, ol))
            )
        out = df_barrier(acc)
        return out.hi, out.lo
    if isinstance(meta, EllDfMeta):
        return ell_matvec_df(arrays, meta, v_hi, v_lo)
    assert isinstance(meta, SlotMeta), meta
    return slot_matvec_df(arrays, meta, v_hi, v_lo)


def build_residual_slot_df(
    gdf, fmt: str = "slot", max_overflow_frac: float = 0.005
):
    """Assembled strain/force operators for the df32 Newton residual.

    The matrix-free df32 residual (`ops.assembly_df`) is bound by XLA's
    serialized gather lowering (~8 ns/element: 12.6 ms per strain+force
    pass at level 3).  Both halves are CONSTANT sparse operators of the
    mesh (the state dependence is entirely in the return map between
    them), so they are assembled once on the host in f64 and applied with
    the double-float kernels (`sp_matvec_df`, ~1e-14 relative):

      e_flat = G u      G: (3*n_int, 2*n_n), G[a*n_int+q, dof(e_q,p)] = B[a,p,q]
      F      = S s_flat S: (2*n_n, 3*n_int), S[dof, a*n_int+q] = w_q B[a,p,q]

    Row/col layout is comp-major, matching the (3, n_int) lane layout
    reshape.  gdf: an `ops.assembly_df.GeometryDF` (padding slots have
    zero B/w and are simply absent).  Element ordering should be
    node-locality-sorted for small slot counts (models/tsx_tunnel.py).
    fmt: "slot" (compacted-slot; fastest at small/mid mesh sizes),
    "rslot" (ragged slot: chunk-compacted stream — the dense slot
    layout's global padding AND the outlier-block inflation both
    disappear, so it stays compact at large levels too) or "ell"
    (windowed-ELL df; the pre-rslot large-level answer).
    Returns (G_arrays, G_meta, S_arrays, S_meta).
    """
    import scipy.sparse as sp

    hi = gdf.hi
    B64 = np.asarray(hi.B, np.float64) + np.asarray(gdf.B_lo, np.float64)
    w64 = np.asarray(hi.weight, np.float64) + np.asarray(
        gdf.w_lo, np.float64
    )
    edofs = np.asarray(hi.edofs, np.int64)          # (n_e, 2n_p)
    n_int, n_p2, n_q = hi.n_int, hi.n_p2, hi.n_q
    n2 = 2 * hi.n_nodes
    qp = np.arange(n_int, dtype=np.int64)
    dof_pq = edofs[qp // n_q]                        # (n_int, 2n_p)

    a_ix = np.repeat(np.arange(3, dtype=np.int64), n_p2 * n_int)
    p_ix = np.tile(np.repeat(np.arange(n_p2, dtype=np.int64), n_int), 3)
    q_ix = np.tile(qp, 3 * n_p2)
    vals = B64.reshape(-1)
    nz = vals != 0.0
    a_ix, p_ix, q_ix, vals = a_ix[nz], p_ix[nz], q_ix[nz], vals[nz]
    rows_e = a_ix * n_int + q_ix
    cols_u = dof_pq[q_ix, p_ix]

    G = sp.coo_matrix(
        (vals, (rows_e, cols_u)), shape=(3 * n_int, n2)
    ).tocsr()
    G.sum_duplicates()
    if fmt == "ell":
        # S's columns are component-major integration points (offsets 0 /
        # n_int / 2*n_int): split per component so each part's columns
        # cluster and window tightly (SplitColsDfMeta note)
        Ga, Gm = build_ell_df(G, max_overflow_frac)
        Sa: dict = {}
        parts = []
        for a3 in range(3):
            m = a_ix == a3
            Sc = sp.coo_matrix(
                (vals[m] * w64[q_ix[m]], (cols_u[m], q_ix[m])),
                shape=(n2, n_int),
            ).tocsr()
            Sc.sum_duplicates()
            aa, mm = build_ell_df(Sc, max_overflow_frac)
            for kk, vv in aa.items():
                Sa[f"p{a3}_{kk}"] = vv
            parts.append(mm)
        return Ga, Gm, Sa, SplitColsDfMeta(
            metas=tuple(parts), n_in=3 * n_int
        )
    S = sp.coo_matrix(
        (vals * w64[q_ix], (cols_u, rows_e)), shape=(n2, 3 * n_int)
    ).tocsr()
    S.sum_duplicates()
    ragged = fmt == "rslot"
    Ga, Gm = build_slot_df(G, ragged=ragged)
    Sa, Sm = build_slot_df(S, ragged=ragged)
    return Ga, Gm, Sa, Sm


_RAGGED_U = 16      # ragged-slot chunk size (build_sparse fmt="rslot")


# ---------------------------------------------------------------------------
# slot-format application (plain XLA: one gather + multiply + slot reduce)
# ---------------------------------------------------------------------------
#
# Every slot holds, for the 8 x 128 output rows of its (super)block, one
# source row `srow` of the input vector and a lane `cidx` inside it: the
# flat input index is srow * 128 + cidx.  The product stream is reduced
# over the slot axis; ragged layouts reduce each u-slot chunk and fold the
# chunk partials into their superblocks with a segment sum.  XLA compiles
# the gather to ordinary loads (the input vector stays cache-resident),
# fuses it with the multiply and the reduction, and runs the blocks in any
# order — no partial is carried from one block to the next.


def _slot_cols(arrays: dict) -> jnp.ndarray:
    """(n, S, 8, 128) flat input index of every slot entry."""
    srow = jnp.swapaxes(arrays["srow"], 1, 2)[..., None]
    return srow * 128 + arrays["cidx"].astype(jnp.int32)


def _slot_blocks(arrays: dict, meta: SlotMeta, vf: jnp.ndarray):
    """K v as (n_sb*8, 128) output blocks; vf: flat input, >= vrows*128."""
    vals = arrays["vals"].astype(jnp.float32)  # bf16 smoother streams
    part = (vals * vf[_slot_cols(arrays)]).sum(axis=1)
    if meta.n_ch:
        part = jax.ops.segment_sum(
            part, arrays["sbmap"], num_segments=meta.n_sb,
            indices_are_sorted=True,
        )
    return part.reshape(meta.n_sb * 8, 128)


def _df_terms(ah, al, gh, gl):
    """Double-float products (ah+al)*(gh+gl) as unnormalised (p, e) pairs:
    exact head product, cross terms folded into the error (|al*gl| is
    below the df32 floor)."""
    p, e = two_prod(ah, gh)
    return p, e + cross_sum(ah, gl, al, gh)


def _df_sum(p, e, axis: int):
    """Compensated sum of the double-float terms p + e along `axis`.

    One variadic XLA reduce whose combiner is the double-float add.  XLA
    may combine in any order (GPU reductions run as trees); every combine
    keeps the rounding error of its head sum, so the result holds the
    df32 accuracy whatever the order."""

    def combine(a, b):
        s, err = two_sum(a[0], b[0])
        t = a[1] + b[1] + err
        hi = s + t
        return hi, t - (hi - s)

    zero = jnp.zeros((), jnp.float32)
    return jax.lax.reduce((p, e), (zero, zero), combine, (axis,))


def _df_fold_chunks(hi, lo, sbmap, meta: SlotMeta):
    """Ragged chunk partials -> superblock sums, compensated: each chunk
    takes its own cell (superblock, rank within the superblock) and the
    cells reduce with `_df_sum`."""
    n_cmax = -(-meta.s_pad // meta.u)
    rank = jnp.arange(meta.n_ch, dtype=sbmap.dtype) - jnp.searchsorted(
        sbmap, sbmap, side="left"
    ).astype(sbmap.dtype)
    cells = jnp.zeros((meta.n_sb, n_cmax, 8, 128), jnp.float32)
    return _df_sum(
        cells.at[sbmap, rank].set(hi), cells.at[sbmap, rank].set(lo), 1
    )


def slot_matvec_df(arrays: dict, meta: SlotMeta, v_hi, v_lo):
    """A v in double-float on the slot layout.

    v_hi/v_lo: flat (n_in,) f32 two-float pair.  Returns (out_hi, out_lo)
    flat (n2,) — ~1e-14-relative accurate (validated vs host f64 in
    tests/test_spmv.py).
    """
    n = meta.vrows * 128
    col = _slot_cols(arrays)
    p, e = _df_terms(
        arrays["vals_hi"], arrays["vals_lo"],
        _pad_flat(v_hi, n)[col], _pad_flat(v_lo, n)[col],
    )
    hi, lo = _df_sum(p, e, 1)
    if meta.n_ch:
        hi, lo = _df_fold_chunks(hi, lo, arrays["sbmap"], meta)
    return hi.reshape(-1)[: meta.n2], lo.reshape(-1)[: meta.n2]


def slot_matvec(arrays: dict, meta: SlotMeta, v: jnp.ndarray) -> jnp.ndarray:
    """K v on the slot layout.  v: flat (n_in,) f32."""
    vf = _pad_flat(v, meta.vrows * 128)
    return _slot_blocks(arrays, meta, vf).reshape(-1)[: meta.n2]


def _sweep_update(acc, z2, r2, aux: dict, update: bool):
    """Smoother epilogue on (rows, 128) blocks: masked residual, then the
    damped 2x2 nodal block inverse (`build_sweep_aux`) applied with the
    partner component of each DOF (lane i ^ 1).

    The accumulator is stored first: left to fusion, XLA recomputes the
    whole gather-reduce for the partner component (measured at L5 on the
    H100: 0.333 -> 0.227 ms per sweep with it stored)."""
    acc = materialize(acc)
    res = (r2 - acc) * aux["mask"]
    if not update:
        return res
    res_sw = res.reshape(res.shape[0], 64, 2)[:, :, ::-1].reshape(res.shape)
    return z2 + (aux["msf"] * res + aux["mpr"] * res_sw) * aux["mask"]


def build_sweep_aux(inv: np.ndarray, free_flat: np.ndarray, meta: SlotMeta):
    """Host build of the smoother-sweep per-level constants.

    inv: (n_n, 2, 2) damped block-Jacobi inverse (omega included);
    free_flat: (2*n_n,) bool.  Returns dict(mask, msf, mpr) padded to the
    (n_sb*8, 128) output blocks: for DOF i = 2k+c, msf[i] = inv[k, c, c]
    (own-component coefficient) and mpr[i] = inv[k, c, 1-c] (partner-
    component coefficient).
    """
    n = free_flat.shape[0]
    rows = meta.n_sb * 8
    inv = np.asarray(inv, np.float32)
    msf = np.zeros((rows * 128,), np.float32)
    mpr = np.zeros((rows * 128,), np.float32)
    mask = np.zeros((rows * 128,), np.float32)
    k = np.arange(n) // 2
    cc = np.arange(n) % 2
    msf[:n] = inv[k, cc, cc]
    mpr[:n] = inv[k, cc, 1 - cc]
    mask[:n] = np.asarray(free_flat, np.float32)
    return dict(
        mask=jnp.asarray(mask.reshape(rows, 128)),
        msf=jnp.asarray(msf.reshape(rows, 128)),
        mpr=jnp.asarray(mpr.reshape(rows, 128)),
    )


def slot_sweep(
    arrays: dict,
    meta: SlotMeta,
    aux: dict,
    z: jnp.ndarray,
    r2: jnp.ndarray,
    update: bool = True,
) -> jnp.ndarray:
    """One block-Jacobi smoother sweep / masked residual on a SQUARE slot
    operator: z + mask * inv * mask * (r - K z), with the 2x2 nodal
    inverse applied component-wise (`aux` from `build_sweep_aux`).

    z: flat (n2,) current iterate.  r2: (n_sb*8, 128) padded residual
    blocks (`pad_rhs`).  update=False returns mask*(r - K z) flat.

    Numerics note vs the einsum form of the sweep: the odd-component
    update computes d*r1 + c*r0 instead of the einsum's c*r0 + d*r1 —
    same values, one reordered addition, so results can differ by 1 ulp
    (the V-cycle is a preconditioner; CG trajectories remain within
    solver tolerance).

    ShardedMeta (under shard_map): `aux` and `r2` are the device-local
    row slices, z the full replicated iterate; the local rows are
    updated and all_gathered back into the full vector (bit-identical
    per row to the single-device sweep).
    """
    if isinstance(meta, ShardedMeta):
        m = meta.local
        assert isinstance(m, SlotMeta) and m.n_ch == 0
        acc = _slot_blocks(arrays, m, _pad_flat(z, m.vrows * 128))
        zb = None
        if update:
            # this device's own z row blocks for the update term
            idx = jax.lax.axis_index(meta.axis)
            rows_tot = m.n_sb * meta.n_shards * 8
            zb = jax.lax.dynamic_slice_in_dim(
                _pad_flat(z, rows_tot * 128).reshape(rows_tot, 128),
                idx * m.n_sb * 8, m.n_sb * 8, axis=0,
            )
        out = _sweep_update(acc, zb, r2, aux, update)
        return _gather_rows(out.reshape(-1), meta)

    assert meta.n2 == meta.n_in, "smoother sweep needs a square operator"
    rows = meta.n_sb * 8
    z2 = _pad_flat(z, rows * 128).reshape(rows, 128)
    return slot_sweep_b(arrays, meta, aux, z2, r2, update).reshape(-1)[
        : meta.n2
    ]


def slot_sweep_b(
    arrays: dict,
    meta: SlotMeta,
    aux: dict,
    z2: jnp.ndarray,
    r2: jnp.ndarray,
    update: bool = True,
) -> jnp.ndarray:
    """`slot_sweep` in padded-block layout end to end (non-sharded only).

    z2: (n_sb*8, 128) current iterate blocks, r2: same-shape residual
    blocks (`pad_rhs`).  Returns the updated iterate (or masked residual,
    update=False) as (n_sb*8, 128) blocks — no flat round-trip.  The
    V-cycle keeps z/r in this layout through all sweeps of a level
    (`solve.multigrid.make_vcycle_ell`), so no per-sweep pad/truncate
    copies of the full vector are made.

    Invariant: entries of z2 beyond meta.n2 are zero (the masked updates
    preserve this; `pad_rhs` establishes it).
    """
    assert not isinstance(meta, ShardedMeta), "padded IO is single-device"
    assert meta.n2 == meta.n_in, "smoother sweep needs a square operator"
    rows = meta.n_sb * 8
    assert rows >= meta.vrows, (rows, meta.vrows)
    assert z2.shape == (rows, 128), z2.shape
    acc = _slot_blocks(arrays, meta, z2.reshape(-1))
    return _sweep_update(acc, z2, r2, aux, update)


def pad_rhs(r: jnp.ndarray, meta) -> jnp.ndarray:
    """Flat (n2,) -> (n_sb*8, 128) blocks for `slot_sweep`'s r input.

    ShardedMeta: returns this device's local row-block slice.
    """
    if isinstance(meta, ShardedMeta):
        m = meta.local
        rows_tot = m.n_sb * meta.n_shards * 8
        full = _pad_flat(r, rows_tot * 128).reshape(rows_tot, 128)
        idx = jax.lax.axis_index(meta.axis)
        return jax.lax.dynamic_slice_in_dim(
            full, idx * m.n_sb * 8, m.n_sb * 8, axis=0
        )
    rows = meta.n_sb * 8
    return _pad_flat(r, rows * 128).reshape(rows, 128)


def pack_slot_bf16(arrays: dict, meta: SlotMeta) -> dict:
    """Narrow copy of a dense slot operator for the smoother sweeps.

    The V-cycle smoother only preconditions, so its operator stream can
    be stored narrower: bf16 values (upcast to f32 in the gather) and
    u8 lane indices — 3 bytes per slot entry instead of 8.  CG's operator
    A stays on the f32 arrays: an inexact-Newton tangent at cg_tol 1e-5
    needs more than bf16's ~3e-3 relative operator accuracy.  The result
    is an ordinary slot operator: `slot_matvec` / `slot_sweep` /
    `slot_sweep_b` apply it.
    """
    assert not meta.n_ch, "bf16 smoother streams use the dense slot layout"
    return dict(
        srow=arrays["srow"],
        cidx=arrays["cidx"].astype(jnp.uint8),
        vals=arrays["vals"].astype(jnp.bfloat16),
    )


# ---------------------------------------------------------------------------
# multi-chip SPMD: output-row partitioning over a device mesh (shard_map)
# ---------------------------------------------------------------------------
#
# Scaling design for the assembled operators (SURVEY.md §2.4; the
# reference has no parallelism at all — `tsx-tunnel/pythonFEM.py` is a
# single NumPy process).  An assembled operator maps a REPLICATED input
# vector to output rows; both the slot and windowed-ELL layouts block
# output rows (128-row blocks grouped into superblocks / window groups)
# and pack each block independently of every other block.
# Row-partitioning on block boundaries therefore gives every device a
# contiguous slice of the UNCHANGED arrays: each device computes its rows
# with the same per-row arithmetic as the single-device operator, and the
# full output vector is reassembled with one `all_gather` (pure
# concatenation — exact, unlike a psum, so df32 pairs survive with their
# compensation intact).
#
# Collectives per operator application: ONE all_gather of n2/n_dev * f32
# (x2 for df pairs).  No halo exchange is needed — the input vector is
# replicated, and rows are whole per device.

OP_AXIS = "oprows"


class ShardedMeta(NamedTuple):
    """Row-sharded operator meta: `local` is each device's own meta.

    Hashable/static like the metas it wraps.  `n2` is the FULL output row
    count (the gathered result is trimmed to it); the padding superblocks
    added to make the row blocks divide evenly hold zero values and are
    inert.  Dispatch happens inside `sp_matvec` / `sp_matvec_df` /
    `slot_sweep` / `pad_rhs`: call sites (solve/newton.py,
    solve/multigrid.py) are unchanged — under `shard_map` they receive the
    local array slices and a ShardedMeta, outside they never see one.
    """

    local: NamedTuple  # SlotMeta or EllMeta with per-shard n_sb/n_groups
    n2: int            # full (unsharded) output rows
    n_shards: int
    axis: str = OP_AXIS


def shard_rows(arrays: dict, meta, n_shards: int, axis: str = OP_AXIS):
    """Pad an operator's row blocks to split evenly over `n_shards`.

    Returns (arrays', ShardedMeta, specs) where `specs` maps each array
    key to a `jax.sharding.PartitionSpec` — leading-axis sharding for the
    row-blocked tensors, replicated for global side arrays (ELL overflow
    COO, applied identically on every device after the gather).
    """
    from jax.sharding import PartitionSpec as P

    def _pad0(v, n):
        if n == 0:
            return v
        z = jnp.zeros((n,) + tuple(v.shape[1:]), v.dtype)
        return jnp.concatenate([jnp.asarray(v), z], axis=0)

    out, specs = {}, {}
    if isinstance(meta, SlotMeta):
        assert meta.n_ch == 0, "ragged-slot sharding: use shard_rows_rslot"
        sbl = -(-meta.n_sb // n_shards)
        pad = sbl * n_shards - meta.n_sb
        for k, v in arrays.items():
            out[k] = _pad0(v, pad)
            specs[k] = P(axis)
        local = meta._replace(n_sb=sbl, n2=sbl * 8 * 128)
        return out, ShardedMeta(local, meta.n2, n_shards, axis), specs
    assert isinstance(meta, EllMeta), meta
    ngl = -(-meta.n_groups // n_shards)
    pad = ngl * n_shards - meta.n_groups
    for k in ("w0", "li", "vals"):
        out[k] = _pad0(arrays[k], pad)
        specs[k] = P(axis)
    for k in ("ov_r", "ov_c", "ov_v"):
        if k in arrays:
            out[k] = arrays[k]
            specs[k] = P()
    # local operator: no trim (n2 = all local rows), overflow applied by
    # the caller on the gathered full vector
    local = meta._replace(
        n_groups=ngl, n2=ngl * _WINDOW_BLOCKS * 128, n_overflow=0
    )
    return out, ShardedMeta(local, meta.n2, n_shards, axis), specs


def _gather_rows(y_local: jnp.ndarray, meta: ShardedMeta) -> jnp.ndarray:
    """Concatenate per-device row blocks -> full (n2,) vector (exact)."""
    y = jax.lax.all_gather(y_local, meta.axis, tiled=True)
    return y[: meta.n2]


def _sharded_matvec(arrays: dict, meta: ShardedMeta, v: jnp.ndarray):
    m = meta.local
    if isinstance(m, SlotMeta):
        y = slot_matvec(arrays, m, v)
    else:
        y = ell_matvec(
            {k: arrays[k] for k in ("w0", "li", "vals")}, m, v
        )
    y = _gather_rows(y, meta)
    if "ov_r" in arrays:
        # replicated COO side path on the gathered vector — identical on
        # every device, so the result stays replicated
        v32 = jnp.asarray(v, jnp.float32)
        y = y.at[arrays["ov_r"]].add(arrays["ov_v"] * v32[arrays["ov_c"]])
    return y


def _sharded_matvec_df(arrays: dict, meta: ShardedMeta, v_hi, v_lo):
    m = meta.local
    assert isinstance(m, SlotMeta), (
        "sharded df residual operators use the slot format"
    )
    oh, ol = slot_matvec_df(arrays, m, v_hi, v_lo)
    return _gather_rows(oh, meta), _gather_rows(ol, meta)
