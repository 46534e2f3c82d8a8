"""Geometric multigrid V-cycle preconditioner (matrix-free, jittable).

Block-Jacobi CG iteration counts grow ~h^-1 under uniform refinement
(measured 184 -> 1000+ over three red refinements).  The
red-refinement hierarchy (`mesh/refine.py`) gives geometric multigrid for
free: every fine node is either a coarse node (same index) or an edge
midpoint of two coarse parents, so

  * prolongation  P v = [v ; (v[a] + v[b]) / 2]   (gather + average)
  * restriction   R r = P^T r                      (segment-sum of halves)

Levels hold their own lane-major geometry; smoothing is damped block-Jacobi
(symmetric, so the V-cycle is SPD and valid as a CG preconditioner), and
the coarsest level is solved directly with a dense Cholesky factored once.

Everything is jittable with all arrays passed as arguments
(`utils/jitsafe.py`).
"""
from __future__ import annotations

from typing import List, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..mesh.midpoints import _edge_scan
from ..ops import assembly as asm
from ..ops.elements import ElementTables


class MGLevelArrays(NamedTuple):
    """Per-level arrays (pytree; passed through jit boundaries)."""

    coords: object
    elems: object
    free: object  # (n_n, 2) bool
    parents: object  # (n_new, 2) coarse parents of this level's new nodes
    # (coarsest level: parents is a (0, 2) placeholder)


def build_hierarchy(
    coords0: np.ndarray,
    elems0: np.ndarray,
    levels: int,
    free_fn,
) -> List[MGLevelArrays]:
    """Coarse-to-fine hierarchy by red refinement.

    Args:
      free_fn: coords -> (n_n, 2) bool free mask (applied per level).

    Returns list of MGLevelArrays, index 0 = coarsest.
    """
    out = [
        MGLevelArrays(
            coords=jnp.asarray(coords0),
            elems=jnp.asarray(elems0.astype(np.int32)),
            free=jnp.asarray(free_fn(coords0)),
            parents=jnp.zeros((0, 2), jnp.int32),
        )
    ]
    coords, elems = coords0, elems0
    for _ in range(levels):
        # identical edge scan as insert_midpoints_p2: new node n_c+k is the
        # midpoint of unique edge k (owner orientation)
        v = elems
        directed = np.stack(
            [v[:, [1, 2]], v[:, [2, 0]], v[:, [0, 1]]], axis=1
        ).reshape(-1, 2)
        first_pos, edge_id, _ = _edge_scan(directed)
        owners = directed[first_pos]
        mids = 0.5 * (coords[owners[:, 0]] + coords[owners[:, 1]])
        coords_f = np.concatenate([coords, mids], axis=0)
        n_c = coords.shape[0]
        mid_nodes = (n_c + edge_id).reshape(-1, 3)
        m23, m31, m12 = mid_nodes[:, 0], mid_nodes[:, 1], mid_nodes[:, 2]
        v0, v1, v2 = v[:, 0], v[:, 1], v[:, 2]
        children = np.stack(
            [
                np.stack([v0, m12, m31], axis=1),
                np.stack([v1, m23, m12], axis=1),
                np.stack([v2, m31, m23], axis=1),
                np.stack([m12, m23, m31], axis=1),
            ],
            axis=1,
        ).reshape(-1, 3)
        out.append(
            MGLevelArrays(
                coords=jnp.asarray(coords_f),
                elems=jnp.asarray(children.astype(np.int32)),
                free=jnp.asarray(free_fn(coords_f)),
                parents=jnp.asarray(owners.astype(np.int32)),
            )
        )
        coords, elems = coords_f, children
    return out


def prolong(v_c: jnp.ndarray, parents: jnp.ndarray, n_f: int) -> jnp.ndarray:
    """Coarse DOF vector (2*n_c,) -> fine (2*n_f,)."""
    n_c = v_c.shape[0] // 2
    v2 = v_c.reshape(n_c, 2)
    mid = 0.5 * (v2[parents[:, 0]] + v2[parents[:, 1]])
    return jnp.concatenate([v2, mid], axis=0).reshape(-1)


def restrict(r_f: jnp.ndarray, parents: jnp.ndarray, n_c: int) -> jnp.ndarray:
    """P^T: fine residual (2*n_f,) -> coarse (2*n_c,)."""
    r2 = r_f.reshape(-1, 2)
    own = r2[:n_c]
    halves = 0.5 * r2[n_c:]
    scat = jax.ops.segment_sum(
        jnp.concatenate([halves, halves], axis=0),
        jnp.concatenate([parents[:, 0], parents[:, 1]]),
        num_segments=n_c,
    )
    return (own + scat).reshape(-1)


class MGLevel(NamedTuple):
    """Built per-level state (geometry + smoother) — pytree."""

    geom: asm.Geometry
    d: object  # (3, 3, n_int) material tangent at this level
    free_flat: object  # (2*n_n,) bool
    inv_blocks: object  # (n_n, 2, 2) damped-Jacobi inverse blocks
    parents: object


def build_mg_levels(hier: List[MGLevelArrays], tab: ElementTables, d_fn, omega=0.7):
    """Per-level geometry, tangent and smoother blocks (jittable).

    d_fn: (geom) -> (3, 3, n_int) material tangent for that level.
    """
    levels = []
    for lv in hier:
        geom = asm.compute_geometry(lv.coords, lv.elems, tab)
        d = d_fn(geom)
        blocks = asm.node_block_diagonal(geom, d)
        free2 = lv.free
        mask = free2[:, :, None] & free2[:, None, :]
        b = jnp.where(mask, blocks, 0.0)
        eye = jnp.eye(2, dtype=blocks.dtype)
        b = b + eye * (~free2).astype(blocks.dtype)[:, :, None]
        a_, b_, c_, dd = b[:, 0, 0], b[:, 0, 1], b[:, 1, 0], b[:, 1, 1]
        det = a_ * dd - b_ * c_
        inv = (
            jnp.stack(
                [jnp.stack([dd, -b_], -1), jnp.stack([-c_, a_], -1)], -2
            )
            / det[:, None, None]
        ) * omega
        levels.append(
            MGLevel(
                geom=geom,
                d=d,
                free_flat=free2.reshape(-1),
                inv_blocks=inv,
                parents=lv.parents,
            )
        )
    return levels


def mg_level_arrays(levels: List[MGLevel]):
    """MGLevel list -> (list-of-array-dicts, list-of-static-int-tuples).

    The array dicts are a jit-safe pytree (pass through `args`);
    `mg_levels_from_arrays` reconstructs the MGLevel list inside the
    traced function with the static ints from the enclosing scope.  Use
    this to HOIST `build_mg_levels` out of jitted programs: per-level
    geometry and smoother blocks are then computed once at setup instead
    of inside every dispatch (compile-time and per-chunk-runtime win).
    """
    arrays = [
        dict(
            B=l.geom.B, weight=l.geom.weight, edofs=l.geom.edofs,
            edofs_t=l.geom.edofs_t, d=l.d, free_flat=l.free_flat,
            inv_blocks=l.inv_blocks, parents=l.parents,
        )
        for l in levels
    ]
    static = [(l.geom.n_nodes, l.geom.n_q, l.geom.n_real) for l in levels]
    return arrays, static


def mg_levels_from_arrays(arrays, static) -> List[MGLevel]:
    """Inverse of `mg_level_arrays` (inside a traced function)."""
    return [
        MGLevel(
            geom=asm.Geometry(
                B=a["B"], weight=a["weight"], edofs=a["edofs"],
                edofs_t=a["edofs_t"], n_nodes=s[0], n_q=s[1], n_real=s[2],
            ),
            d=a["d"], free_flat=a["free_flat"],
            inv_blocks=a["inv_blocks"], parents=a["parents"],
        )
        for a, s in zip(arrays, static)
    ]


# ---------------------------------------------------------------------------
# windowed-ELL multigrid (assembled operators; see ops/spmv.py)
# ---------------------------------------------------------------------------
def build_hierarchy_ell(
    coords0: np.ndarray,
    elems0: np.ndarray,
    levels: int,
    free_fn,
    shear: float,
    bulk: float,
    ref,
    omega: float = 0.7,
    fmt: str = "ell",
    pack_bf16="auto",
    order_mode: str = "fine_rcm",
    collect_levels: bool = False,
):
    """Host-side ELL multigrid build: red refinement + locality ordering.

    Replaces the in-jit `build_mg_levels` path for large meshes: every
    level's elastic operator, transfer operators and smoother blocks are
    assembled ONCE on the host (numpy/scipy) and stored in windowed-ELL
    form so the V-cycle never executes an XLA gather/scatter (the ~8
    ns/element serialization documented in ops/spmv.py).

    Node ordering (`order_mode`):
      * "fine_rcm" (default): RCM on the FINEST mesh; each coarser
        level is ordered by its nodes' positions in the next-finer
        ordering (coarse nodes are a prefix of the finer level's node
        set under red refinement).  The fine level carries ~85-95% of
        the V-cycle cost, and RCM packs its slot operator tightly
        (measured s_pad 48 vs 100 under parent ordering at the 228k-DOF
        tsx level — the compacted-slot kernels stream s_pad per
        superblock, so layout skew is paid on every sweep).  RCM via
        scipy is O(nnz) — ~seconds at 910k nodes.
      * "parent": RCM on the coarsest mesh, finer levels ordered by
        their parents' coarse positions (the pre-round-2-late scheme;
        kept for A/B comparisons).

    Returns (arrays, metas, perms, coarse):
      arrays[l]: dict(op=..., inv=(n_n,2,2) f32, free=(2n_n,) bool,
                      P=..., R=... for l >= 1) — jit-argument pytrees
      metas[l]:  dict(op=EllMeta, P=EllMeta, R=EllMeta) — static
      perms[l]:  new_of_old node map of level l
      coarse:    dict(cho0=(n_free0, n_free0) host Cholesky factor,
                      inv0=(n_free0, n_free0) explicit f32 inverse,
                      free_idx0=(n_free0,) indices) for the direct solve
                      (inv0 @ r is one matmul; triangular solves are
                      row-serial)
    """
    import scipy.linalg as sla
    import scipy.sparse as sp

    from ..ops import spmv

    chain = []
    coords, elems = np.asarray(coords0, np.float64), np.asarray(elems0)
    chain.append((coords, elems, None))
    for _ in range(levels):
        v = elems
        directed = np.stack(
            [v[:, [1, 2]], v[:, [2, 0]], v[:, [0, 1]]], axis=1
        ).reshape(-1, 2)
        first_pos, edge_id, _ = _edge_scan(directed)
        owners = directed[first_pos]
        mids = 0.5 * (coords[owners[:, 0]] + coords[owners[:, 1]])
        coords_f = np.concatenate([coords, mids], axis=0)
        n_c = coords.shape[0]
        mid_nodes = (n_c + edge_id).reshape(-1, 3)
        m23, m31, m12 = mid_nodes[:, 0], mid_nodes[:, 1], mid_nodes[:, 2]
        v0, v1, v2 = v[:, 0], v[:, 1], v[:, 2]
        children = np.stack(
            [
                np.stack([v0, m12, m31], axis=1),
                np.stack([v1, m23, m12], axis=1),
                np.stack([v2, m31, m23], axis=1),
                np.stack([m12, m23, m31], axis=1),
            ],
            axis=1,
        ).reshape(-1, 3)
        chain.append((coords_f, children.astype(np.int64), owners))
        coords, elems = coords_f, children

    fine_orders = None
    if order_mode == "fine_rcm":
        # fine RCM, then induce coarser orderings by restriction: level
        # l's nodes are ids 0..n_l-1 inside level l+1, so ordering them
        # by their position in level l+1's ordering inherits the fine
        # locality all the way down
        fine_orders = [None] * len(chain)
        c_top, e_top, _ = chain[-1]
        noo_next = None
        for l in reversed(range(len(chain))):
            n_l = chain[l][0].shape[0]
            if l == len(chain) - 1:
                order_l = spmv.rcm_node_order(e_top, n_l)
            else:
                order_l = np.argsort(noo_next[:n_l], kind="stable")
            noo_next = np.empty(n_l, np.int64)
            noo_next[order_l] = np.arange(n_l)
            fine_orders[l] = order_l
    else:
        assert order_mode == "parent", order_mode

    arrays, metas, perms = [], [], []
    prev_new_of_old = None
    prev_n = None
    coarse = {}
    for l, (c, e, par) in enumerate(chain):
        n_n = c.shape[0]
        if fine_orders is not None:
            order = fine_orders[l]
        elif l == 0:
            order = spmv.rcm_node_order(e, n_n)
        else:
            # order by parent position in the coarse level's ordering
            key = np.empty(n_n, np.int64)
            key[:prev_n] = prev_new_of_old * 2  # own nodes (even keys)
            pa = prev_new_of_old[par[:, 0]]
            pb = prev_new_of_old[par[:, 1]]
            key[prev_n:] = pa + pb  # midpoints between their parents
            order = np.argsort(key, kind="stable")
        c2, e2, new_of_old = spmv.permute_mesh(c, e, order)
        free2 = np.asarray(free_fn(c2))
        opa, opm, K = spmv.build_ell_elastic(
            c2, e2, ref, shear, bulk, free=free2, dtype=np.float32, fmt=fmt
        )
        blocks = spmv.diag_blocks_csr(K, n_n)
        a_, b_, cc_, d_ = (
            blocks[:, 0, 0], blocks[:, 0, 1], blocks[:, 1, 0], blocks[:, 1, 1]
        )
        det = a_ * d_ - b_ * cc_
        inv = (
            np.stack(
                [np.stack([d_, -b_], -1), np.stack([-cc_, a_], -1)], -2
            )
            / det[:, None, None]
        ) * omega
        entry = dict(
            op=opa,
            inv=jnp.asarray(inv, jnp.float32),
            free=jnp.asarray(free2.reshape(-1)),
        )
        if fmt in ("slot", "rslot"):
            # fused-sweep constants (ops/spmv.py slot_sweep): lane-aligned
            # block-inverse coefficients + f32 free mask in kernel blocks
            entry.update(
                spmv.build_sweep_aux(inv, free2.reshape(-1), opm)
            )
            # bf16-value / u8-index operator stream for the smoother and
            # masked-residual sweeps (the f32 `op` stays for CG's
            # operator A and the criterion).  bf16 smoothing costs
            # ~14-23% MORE CG iterations (measured), so it pays only
            # where the sweep's byte traffic dominates: "auto" packs
            # levels with n2 >= 500k rows.  That threshold was set on
            # other hardware and is open for re-measurement (ROADMAP).
            # The narrow stream uses the dense slot layout only.
            pack = (
                opm.n2 >= 500_000 if pack_bf16 == "auto" else bool(pack_bf16)
            ) and not opm.n_ch
            if pack:
                entry["opk"] = spmv.pack_slot_bf16(opa, opm)
        meta = dict(op=opm)
        if l == 0:
            flat0 = free2.reshape(-1)
            idx0 = np.nonzero(flat0)[0]
            K0 = K[idx0][:, idx0].toarray()
            c0, _ = sla.cho_factor(K0, lower=False)
            # explicit inverse for the coarse solve: one (n0, n0) matmul
            # instead of two row-serial triangular solves; the V-cycle is
            # a preconditioner, so f32 inverse accuracy is irrelevant to
            # the CG trajectory
            inv0 = sla.cho_solve((c0, False), np.eye(K0.shape[0]))
            coarse = dict(
                cho0=jnp.asarray(c0, jnp.float32),
                inv0=jnp.asarray(inv0, jnp.float32),
                free_idx0=jnp.asarray(idx0.astype(np.int32)),
            )
        else:
            o = order
            isc = o < prev_n
            safe = np.maximum(o - prev_n, 0)
            pa2 = np.where(isc, prev_new_of_old[np.minimum(o, prev_n - 1)],
                           prev_new_of_old[par[safe, 0]])
            pb2 = np.where(isc, pa2, prev_new_of_old[par[safe, 1]])
            rows = np.arange(n_n)
            rP, cP, vP = [], [], []
            for d in range(2):
                rP.append(2 * rows + d)
                cP.append(2 * pa2 + d)
                vP.append(np.full(n_n, 0.5))
                rP.append(2 * rows + d)
                cP.append(2 * pb2 + d)
                vP.append(np.full(n_n, 0.5))
            P = sp.coo_matrix(
                (np.concatenate(vP), (np.concatenate(rP), np.concatenate(cP))),
                shape=(2 * n_n, 2 * prev_n),
            ).tocsr()
            P.sum_duplicates()
            entry["P"], meta["P"] = spmv.build_sparse(P, np.float32, fmt=fmt)
            R = P.T.tocsr()
            R.sum_duplicates()
            entry["R"], meta["R"] = spmv.build_sparse(R, np.float32, fmt=fmt)
        arrays.append(entry)
        metas.append(meta)
        perms.append(new_of_old)
        if collect_levels:
            # per-level host data for the TANGENT-refresh hierarchy
            # (build_tangent_hierarchy): permuted mesh, BC'd CSR, free
            # mask, and the scipy prolongation (Galerkin RAP chain).
            # Element order per level is the refinement-chain order
            # (children of chain parent e sit at rows 4e..4e+3).
            coarse.setdefault("levels", []).append(
                dict(
                    coords=c2, elems=e2, K=K, free=free2,
                    P=(P if l > 0 else None),
                )
            )
        prev_new_of_old, prev_n = new_of_old, n_n
    # fine-level coordinates in hierarchy (locality) order — consumers
    # that permute a problem onto this ordering match nodes against it
    # (e.g. the p-multigrid P2/P4 lattice match, models/tsx_tunnel.py)
    coarse["fine_coords"] = c2
    # fine-level BC-masked CSR (host-only): the static-structure tangent
    # refresh builds its scatter-destination table from the exact matrix
    # the fine slot operator was packed from (ops/spmv.py
    # element_corr_dest; consumed by models/tsx_tunnel.py corr_mode)
    coarse["fine_K"] = K
    coarse["fine_free"] = free2
    return arrays, metas, perms, coarse


def build_tangent_hierarchy(metas, coarse, ref):
    """Host extras for the per-Newton-iteration TANGENT hierarchy refresh.

    For problems whose plastic zone spans most of the domain (the strip
    footing at its nu=0.48 limit load: ~75% of points plastic), the
    ELASTIC hierarchy preconditions the elastoplastic tangent poorly
    (measured rejection, FootingConfig.solver doc) and block-Jacobi CG
    iteration counts grow ~h^-1 past the iteration cap at level >= 4.
    This enables a TRUE tangent V-cycle, refreshed once per Newton
    iteration (`tangent_vcycle`):

      * the FINE level's slot value stream is rebuilt from the current
        consistent tangent by the fixed-sparsity scatter
        (`ops.spmv.element_corr_dest` — the corr_full machinery);
      * every COARSE level is the GALERKIN (RAP) restriction of the fine
        tangent: for nested P1 spaces K_c = P^T K_f P is exactly the
        coarse discretization of the fine coefficient field, its pattern
        equals the built coarse operator's, and the fine->coarse VALUE
        map is a STATIC sparse operator — assembled here once per level
        transition (<= 4 coarse contributions per fine entry through the
        0.5/1.0 prolongation weights) and applied at runtime as one slot
        matvec on the value stream (`Mhat`);
      * smoother block-inverse constants come from static diagonal-cell
        position tables; the coarsest tangent is densified from its
        value stream for a per-iteration f32 explicit-inverse solve.

    Requires `build_hierarchy_ell(..., collect_levels=True)`, the dense
    slot format, and a P1 hierarchy.  Returns (tmg_arrays, tmg_static):
    a pytree of device arrays for the solver's jit args + static shape
    info.  The elastic chain reproduces the built hierarchy EXACTLY by
    construction: base_c := vals_c_elastic - Mhat @ vals_f_elastic is
    folded into the static offset, so a zero tangent delta yields the
    measured-validated elastic V-cycle bit-for-bit.  The reference has
    no analog — its footing driver reassembles the dense tangent on the
    host each iteration (`Plasticity2D_DP/pythonFEM.py:1047-1050`).
    """
    import scipy.sparse as sp

    from ..ops import assembly as asm
    from ..ops import spmv
    from ..ops.elements import tables

    levels = coarse["levels"]
    top = len(levels) - 1
    tab = tables(ref)

    # fine geometry + scatter-destination table (corr_full machinery)
    fine = levels[top]
    g = asm.compute_geometry(
        jnp.asarray(fine["coords"], jnp.float32),
        jnp.asarray(np.asarray(fine["elems"]).astype(np.int32)), tab,
    )
    assert g.n_q == 1, "tangent hierarchy requires P1 (n_q == 1)"
    m_top = metas[top]["op"]
    dest = spmv.element_corr_dest(
        fine["K"], m_top, np.asarray(fine["elems"]), fine["free"]
    )
    n_pad_e = g.n_int // g.n_q
    if dest.shape[0] < n_pad_e:
        dest = np.concatenate(
            [
                dest,
                np.full(
                    (n_pad_e - dest.shape[0],) + dest.shape[1:],
                    -1, dest.dtype,
                ),
            ],
            axis=0,
        )

    # per-level slot-cell positions of every CSR entry + value sizes
    pos, vsize = [], []
    for l in range(top + 1):
        m = metas[l]["op"]
        assert isinstance(m, spmv.SlotMeta) and m.n_ch == 0, (
            "tangent hierarchy needs the dense slot format"
        )
        pos.append(spmv.slot_csr_positions(levels[l]["K"], m))
        vsize.append(m.n_sb * m.s_pad * 8 * 128)

    def _prow2(P):
        """Prolongation rows padded to 2 (coarse-dof, weight) entries."""
        P = P.tocsr()
        P.sum_duplicates()
        deg = np.diff(P.indptr)
        assert deg.max() <= 2
        n = P.shape[0]
        pidx = np.zeros((n, 2), np.int64)
        pw = np.zeros((n, 2), np.float64)
        r = np.repeat(np.arange(n), deg)
        k = np.arange(P.nnz) - np.repeat(P.indptr[:-1], deg)
        pidx[r, k] = P.indices
        pw[r, k] = P.data
        return pidx, pw

    arrs = dict(
        B=g.B, w=g.weight, edofs=g.edofs, edofs_t=g.edofs_t,
        dest=jnp.asarray(dest),
        mhat=[], base=[], diag_pos=[],
    )
    mhat_metas = []
    for l in range(top, 0, -1):
        K_f, K_c = levels[l]["K"], levels[l - 1]["K"]
        free_c = np.asarray(levels[l - 1]["free"]).reshape(-1)
        pidx, pw = _prow2(levels[l]["P"])
        nnz_f = K_f.nnz
        rows_f = np.repeat(
            np.arange(K_f.shape[0], dtype=np.int64), np.diff(K_f.indptr)
        )
        cols_f = K_f.indices.astype(np.int64)
        t = np.arange(nnz_f, dtype=np.int64)
        rM, cM, vM = [], [], []
        for a3 in range(2):
            for b3 in range(2):
                ci = pidx[rows_f, a3]
                cj = pidx[cols_f, b3]
                wgt = pw[rows_f, a3] * pw[cols_f, b3]
                keep = (wgt != 0.0) & free_c[ci] & free_c[cj]
                kc = spmv.csr_lookup(K_c, ci[keep], cj[keep])
                assert (kc >= 0).all(), "RAP pattern not in coarse pattern"
                rM.append(pos[l - 1][kc])
                cM.append(pos[l][t[keep]])
                vM.append(wgt[keep])
        Mhat = sp.coo_matrix(
            (
                np.concatenate(vM),
                (np.concatenate(rM), np.concatenate(cM)),
            ),
            shape=(vsize[l - 1], vsize[l]),
        ).tocsr()
        Mhat.sum_duplicates()
        # static elastic offset: vals_c_el - Mhat @ vals_f_el.  Equals
        # the BC unit diagonals (+ any non-variational boundary terms);
        # folding the exact numpy difference in makes the elastic chain
        # reproduce the built hierarchy exactly.
        vf_el = np.zeros(vsize[l], np.float64)
        vf_el[pos[l]] = levels[l]["K"].data
        vc_el = np.zeros(vsize[l - 1], np.float64)
        vc_el[pos[l - 1]] = levels[l - 1]["K"].data
        base = (vc_el - Mhat @ vf_el).astype(np.float32)
        Ma, Mm = spmv.build_sparse(Mhat, np.float32, fmt="slot")
        arrs["mhat"].append(Ma)
        arrs["base"].append(jnp.asarray(base))
        mhat_metas.append(Mm)
    arrs["mhat"] = arrs["mhat"][::-1]  # index l-1: level l -> l-1 map
    arrs["base"] = arrs["base"][::-1]
    mhat_metas = mhat_metas[::-1]

    # diagonal 2x2 block cell positions per level (smoother constants)
    for l in range(top + 1):
        n_n = levels[l]["coords"].shape[0]
        k = np.arange(n_n, dtype=np.int64)
        dp = np.empty((n_n, 2, 2), np.int64)
        for a3 in range(2):
            for b3 in range(2):
                kk = spmv.csr_lookup(levels[l]["K"], 2 * k + a3, 2 * k + b3)
                assert (kk >= 0).all()
                dp[:, a3, b3] = pos[l][kk]
        arrs["diag_pos"].append(jnp.asarray(dp.astype(np.int32)))

    # coarsest-level dense free-free scatter table
    K0 = levels[0]["K"]
    free0 = np.asarray(levels[0]["free"])
    fmap0_np, n_free0 = asm.free_dof_map(free0)
    r0 = np.repeat(np.arange(K0.shape[0], dtype=np.int64), np.diff(K0.indptr))
    c0 = K0.indices.astype(np.int64)
    ff0 = free0.reshape(-1)[r0] & free0.reshape(-1)[c0]
    arrs["d0_idx"] = jnp.asarray(
        (fmap0_np[r0[ff0]] * n_free0 + fmap0_np[c0[ff0]]).astype(np.int32)
    )
    arrs["pos0_ff"] = jnp.asarray(pos[0][ff0].astype(np.int32))
    arrs["free_idx0"] = jnp.asarray(
        np.nonzero(free0.reshape(-1))[0].astype(np.int32)
    )
    static = dict(
        geom=(g.n_nodes, g.n_q, g.n_real),
        n_free0=int(n_free0),
        mhat_metas=tuple(mhat_metas),
    )
    return arrs, static


def tangent_vcycle(
    metas,
    hier_arrays,
    tmg_arrays,
    tmg_static,
    d_fine: jnp.ndarray,
    shear: float,
    bulk: float,
    nu=2,
    omega: float = 0.7,
):
    """Runtime (traced) tangent refresh: -> (A_op, preconditioner).

    Rebuilds the fine slot value stream from the consistent tangent
    `d_fine` (3, 3, n_int_fine) via the static scatter table, restricts
    it down the hierarchy with the Galerkin value-map slot matvecs
    (`build_tangent_hierarchy` Mhat chain), refreshes the fused-sweep
    block-inverse constants from the static diagonal-cell tables, and
    densifies the coarsest tangent for an f32 explicit-inverse solve.
    Runs once per Newton iteration (`solve/newton.py tangent_mg`).

    Row-sharded hierarchies (metas wrap `ops.spmv.ShardedMeta`, under
    shard_map): the refresh itself is row-sharded.  Two
    modes, detected from the Mhat metas:

      * sharded Mhat chain (`tmg_static["mhat_metas"]` wrap ShardedMeta
        — models/footing.py build_df32(shard_devices=...)): the fine
        scatter lands directly on each device's LOCAL hierarchy vals
        slice (global dest cells shifted by the shard offset, out-of-
        slice entries dropped — the newton corr_shard_axis idiom), so
        no replicated fine elastic copy exists; each coarse stream is
        produced by the row-sharded Mhat slot matvec (work split over
        devices, one transient all_gather per level — the same gather
        every sharded operator application performs).  Local kernel
        inputs are bit-identical to the single-device refresh on their
        rows, so the trajectory matches exactly.
      * legacy replicated refresh (unsharded Mhat metas + a replicated
        `vals_fine_el` copy in `tmg_arrays`): full per-level streams
        computed identically on every device, then sliced.
    """
    from ..models.materials import elastic_tangent_lanes
    from ..ops import assembly as asm
    from ..ops import spmv

    f32 = jnp.float32
    top = len(metas) - 1
    sharded = isinstance(metas[top]["op"], spmv.ShardedMeta)
    n_nodes, n_q, n_real = tmg_static["geom"]
    g = asm.Geometry(
        B=tmg_arrays["B"], weight=tmg_arrays["w"],
        edofs=tmg_arrays["edofs"], edofs_t=tmg_arrays["edofs_t"],
        n_nodes=n_nodes, n_q=n_q, n_real=n_real,
    )
    d_el = elastic_tangent_lanes(shear, bulk, g.n_int, f32)
    ke = jnp.transpose(asm.element_stiffness(g, d_fine - d_el), (2, 0, 1))
    mhat_metas = tmg_static["mhat_metas"]
    mhat_sharded = top >= 1 and isinstance(mhat_metas[0], spmv.ShardedMeta)
    vals = [None] * (top + 1)
    didx = tmg_arrays["dest"].reshape(-1)
    if mhat_sharded:
        # row-sharded refresh (docstring): scatter straight into this
        # device's local hierarchy slice.  Global dest cells shift by
        # the shard offset; dropped (-1) entries AND earlier-shard cells
        # route to a POSITIVE out-of-bounds index (negatives would wrap)
        # and later-shard cells fall off the end — both dropped.
        m_sh = metas[top]["op"]
        vloc = hier_arrays[top]["op"]["vals"].reshape(-1)
        off = jax.lax.axis_index(m_sh.axis) * vloc.size
        didx_l = jnp.where(didx >= 0, didx - off, -1)
        didx_l = jnp.where(didx_l >= 0, didx_l, vloc.size)
        v_loc = vloc.at[didx_l].add(
            ke.reshape(-1).astype(vloc.dtype), mode="drop"
        )
        # one transient gather per level — full fine stream exists only
        # while the next Mhat matvec consumes it
        n_in_top = mhat_metas[top - 1].local.n_in
        vals[top] = jax.lax.all_gather(
            v_loc, m_sh.axis, tiled=True
        )[:n_in_top]
        for l in range(top, 0, -1):
            # row-sharded slot matvec: local rows + gather (sp_matvec)
            vals[l - 1] = (
                spmv.sp_matvec(
                    tmg_arrays["mhat"][l - 1], mhat_metas[l - 1], vals[l]
                )
                + tmg_arrays["base"][l - 1]
            )
    else:
        vals_f = (
            tmg_arrays["vals_fine_el"].reshape(-1)
            if sharded
            else hier_arrays[top]["op"]["vals"].reshape(-1)
        )
        # -1 (dropped) entries routed to a POSITIVE out-of-bounds index:
        # jnp indexing wraps negatives before the scatter (newton corr
        # note)
        didx = jnp.where(didx >= 0, didx, vals_f.size)
        vals[top] = vals_f.at[didx].add(
            ke.reshape(-1).astype(vals_f.dtype), mode="drop"
        )
        for l in range(top, 0, -1):
            vals[l - 1] = (
                spmv.sp_matvec(
                    tmg_arrays["mhat"][l - 1],
                    tmg_static["mhat_metas"][l - 1],
                    vals[l],
                )
                + tmg_arrays["base"][l - 1]
            )
    arrays_t = []
    for l in range(top + 1):
        m = metas[l]["op"]
        ml = m.local if sharded else m
        arr = hier_arrays[l]
        assert "opk" not in arr, (
            "bf16-packed smoother streams cannot be tangent-refreshed"
        )
        blocks = vals[l][tmg_arrays["diag_pos"][l].reshape(-1)].reshape(
            -1, 2, 2
        )
        free2 = arr["free"].reshape(-1, 2)
        bmask = free2[:, :, None] & free2[:, None, :]
        b = jnp.where(bmask, blocks, 0.0)
        b = b + jnp.eye(2, dtype=f32) * (~free2).astype(f32)[:, :, None]
        a_, b_, c_, dd_ = b[:, 0, 0], b[:, 0, 1], b[:, 1, 0], b[:, 1, 1]
        det = a_ * dd_ - b_ * c_
        i00 = dd_ / det * omega
        i01 = -b_ / det * omega
        i10 = -c_ / det * omega
        i11 = a_ / det * omega
        rows = ml.n_sb * (m.n_shards if sharded else 1) * 8
        n = 2 * free2.shape[0]
        msf = (
            jnp.zeros((rows * 128,), f32)
            .at[:n].set(jnp.stack([i00, i11], 1).reshape(-1))
            .reshape(rows, 128)
        )
        mpr = (
            jnp.zeros((rows * 128,), f32)
            .at[:n].set(jnp.stack([i01, i10], 1).reshape(-1))
            .reshape(rows, 128)
        )
        at = dict(arr)
        at["op"] = dict(arr["op"])
        if sharded:
            # slice this device's contiguous superblock range out of the
            # replicated refreshed stream / smoother-constant rows
            idx = jax.lax.axis_index(m.axis)
            cell = ml.s_pad * 8 * 128
            full_pad = ml.n_sb * m.n_shards * cell
            vl = vals[l]
            if full_pad > vl.size:
                vl = jnp.concatenate(
                    [vl, jnp.zeros((full_pad - vl.size,), f32)]
                )
            vloc = jax.lax.dynamic_slice_in_dim(
                vl, idx * ml.n_sb * cell, ml.n_sb * cell
            )
            at["op"]["vals"] = vloc.reshape(arr["op"]["vals"].shape)
            at["msf"] = jax.lax.dynamic_slice_in_dim(
                msf, idx * ml.n_sb * 8, ml.n_sb * 8, axis=0
            )
            at["mpr"] = jax.lax.dynamic_slice_in_dim(
                mpr, idx * ml.n_sb * 8, ml.n_sb * 8, axis=0
            )
        else:
            at["op"]["vals"] = vals[l].reshape(arr["op"]["vals"].shape)
            at["msf"], at["mpr"] = msf, mpr
        # the unfused first pre-sweep (z=0) applies arr["inv"] directly
        at["inv"] = jnp.stack(
            [jnp.stack([i00, i01], -1), jnp.stack([i10, i11], -1)], -2
        )
        arrays_t.append(at)
    # coarsest direct solve on the FULL tangent (f32 explicit inverse:
    # one factorization per Newton iteration; per-V-cycle triangular
    # back-substitution would be row-serial)
    n_free0 = tmg_static["n_free0"]
    K0 = (
        jnp.zeros((n_free0 * n_free0,), f32)
        .at[tmg_arrays["d0_idx"]]
        .set(vals[0][tmg_arrays["pos0_ff"]])
        .reshape(n_free0, n_free0)
    )
    dsc = jax.lax.rsqrt(jnp.diagonal(K0))
    Ks = K0 * dsc[:, None] * dsc[None, :]
    Ki = jax.scipy.linalg.cho_solve(
        jax.scipy.linalg.cho_factor(Ks), jnp.eye(n_free0, dtype=f32)
    )
    Ki = Ki * dsc[:, None] * dsc[None, :]
    idx0 = tmg_arrays["free_idx0"]
    coarse_solve = lambda r: jnp.zeros_like(r).at[idx0].set(Ki @ r[idx0])
    vc = make_vcycle_ell(metas, coarse_solve, nu=nu)
    A_op = lambda v: spmv.sp_matvec(
        arrays_t[top]["op"], metas[top]["op"], v
    )
    return A_op, lambda r: vc(arrays_t, r)


def shard_hierarchy_ell(arrays, metas, n_shards: int, axis=None):
    """Row-partition an ELL/slot hierarchy over `n_shards` devices.

    Every level's operator, transfer operators and fused-sweep aux rows
    are padded to split evenly and annotated for leading-axis sharding;
    the tiny per-level block-inverse/free-mask arrays (and the coarse
    direct solve) stay replicated.  Returns (arrays', metas', specs) —
    metas' wrap each operator meta in `ops.spmv.ShardedMeta`, so
    `make_vcycle_ell` works unchanged under `shard_map` (the dispatch
    lives in ops/spmv.py); `specs` mirrors arrays' with PartitionSpecs
    for the shard_map in_specs tree.

    Scaling rationale (SURVEY.md §2.4): the V-cycle is the dominant
    per-CG-iteration cost at scale and its operator arrays are the
    dominant memory (3.1 GB at the 908k-element level 5) — row sharding
    divides both by the device count, at the price of one all_gather per
    operator application.
    """
    from jax.sharding import PartitionSpec as P

    from ..ops import spmv

    if axis is None:
        axis = spmv.OP_AXIS
    out_a, out_m, out_s = [], [], []
    for arr, meta in zip(arrays, metas):
        a2, m2 = dict(arr), dict(meta)
        s2 = {k: jax.tree.map(lambda _: P(), v) for k, v in arr.items()}
        for key in [k for k in ("op", "P", "R") if k in m2]:
            pa, pm, ps = spmv.shard_rows(arr[key], meta[key], n_shards, axis)
            a2[key], m2[key], s2[key] = pa, pm, ps
        if "opk" in arr:
            # the bf16 smoother stream shares the operator's slot layout
            a2["opk"], _, s2["opk"] = spmv.shard_rows(
                arr["opk"], meta["op"], n_shards, axis
            )
        if "msf" in arr:
            # fused-sweep aux: pad to the op's padded row blocks, shard
            sbl = m2["op"].local.n_sb
            rows_tot = sbl * n_shards * 8
            for k in ("mask", "msf", "mpr"):
                v = arr[k]
                padn = rows_tot - v.shape[0]
                if padn:
                    v = jnp.concatenate(
                        [v, jnp.zeros((padn, 128), v.dtype)], axis=0
                    )
                a2[k] = v
                s2[k] = P(axis)
        out_a.append(a2)
        out_m.append(m2)
        out_s.append(s2)
    return out_a, out_m, out_s


def make_vcycle_ell(metas, coarse_solve, nu=2, cycle="v"):
    """ELL V-cycle: returns pre(arrays, r) with `arrays` a jit argument.

    nu: smoothing sweeps — an int (symmetric) or a (pre, post) tuple.
    The first pre-sweep from z=0 is a free block-inverse application (no
    matvec), so V(1,2) drops one full smoother sweep per level per cycle
    relative to V(2,2) while keeping two real post-sweeps.

    cycle: "v" | "w" — a W-cycle revisits each sub-level twice (the
    second visit smooths the updated coarse residual), strengthening
    the coarse-grid correction for ~the cost of the coarse-level
    sweeps only (fine-level work, which dominates the wall at scale,
    is unchanged).

    Same cycle structure as `make_vcycle` but every operator application
    is an assembled-sparse matvec (`ops.spmv.sp_matvec` — windowed-ELL or
    compacted-slot, per the hierarchy's build fmt).  Single-device and
    row-sharded hierarchies run the same flat-vector cycle body, so the
    sharded preconditioner is bit-identical to the single-device one.

    The nu smoothing sweeps are statically unrolled (a dynamic loop
    would serialize the small per-level programs behind its carry); the
    sweep body is one compact matvec + elementwise ops (unlike
    `make_vcycle`'s matrix-free body, which keeps the shared-body
    fori_loop).
    """
    from ..ops import spmv

    top = len(metas) - 1

    def _fused(arr, meta):
        # slot-format hierarchies carry the fused-sweep constants
        # (build_hierarchy_ell); ELL-format ones fall back to the
        # unfused sweep chain.  Row-sharded metas fuse iff their local
        # format does (ops/spmv.py ShardedMeta).
        m = meta["op"]
        if isinstance(m, spmv.ShardedMeta):
            m = m.local
        return "msf" in arr and isinstance(m, spmv.SlotMeta)

    nu_pre, nu_post = (nu, nu) if isinstance(nu, int) else nu

    def _smoother(arr):
        # the bf16 smoother stream when the level carries one
        return arr.get("opk", arr["op"])

    def smooth(arr, meta, z, r, r2, z_is_zero=False, sweeps=None):
        for k in range(sweeps if sweeps is not None else nu_post):
            if z_is_zero and k == 0:
                # first pre-smoothing sweep from z=0: res = r exactly, so
                # the operator application is a wasted full matvec
                dz = jnp.einsum(
                    "nij,nj->ni", arr["inv"], r.reshape(-1, 2)
                ).reshape(-1)
                z = jnp.where(arr["free"], dz, 0.0)
            elif r2 is not None:
                # slot sweep: matvec + residual mask + 2x2 block inverse +
                # update (ops/spmv.py slot_sweep), on the bf16 smoother
                # stream when the hierarchy carries one
                z = spmv.slot_sweep(_smoother(arr), meta["op"], arr, z, r2)
            else:
                res = r - spmv.sp_matvec(arr["op"], meta["op"], z)
                res = jnp.where(arr["free"], res, 0.0)
                dz = jnp.einsum(
                    "nij,nj->ni", arr["inv"], res.reshape(-1, 2)
                ).reshape(-1)
                z = z + jnp.where(arr["free"], dz, 0.0)
        return z

    def _coarse_correct(arrays, li, r_c):
        # one (V) or two (W) visits to the sub-level below li
        z_c = vcycle(arrays, li - 1, r_c)
        if cycle == "w" and li - 1 > 0:
            arr_c, meta_c = arrays[li - 1], metas[li - 1]
            res_c = r_c - spmv.sp_matvec(arr_c["op"], meta_c["op"], z_c)
            res_c = jnp.where(arr_c["free"], res_c, 0.0)
            z_c = z_c + vcycle(arrays, li - 1, res_c)
        return z_c

    def vcycle(arrays, li, r):
        arr, meta = arrays[li], metas[li]
        r = jnp.where(arr["free"], r, 0.0)
        if li == 0:
            return jnp.where(arr["free"], coarse_solve(r), 0.0)
        r2 = spmv.pad_rhs(r, meta["op"]) if _fused(arr, meta) else None
        z = smooth(
            arr, meta, jnp.zeros_like(r), r, r2, z_is_zero=True,
            sweeps=nu_pre,
        )
        if r2 is not None:
            res = spmv.slot_sweep(
                _smoother(arr), meta["op"], arr, z, r2, update=False
            )
        else:
            res = r - spmv.sp_matvec(arr["op"], meta["op"], z)
            res = jnp.where(arr["free"], res, 0.0)
        r_c = spmv.sp_matvec(arr["R"], meta["R"], res)
        z_c = _coarse_correct(arrays, li, r_c)
        z = z + jnp.where(
            arr["free"], spmv.sp_matvec(arr["P"], meta["P"], z_c), 0.0
        )
        return smooth(arr, meta, z, r, r2)

    return lambda arrays, r: vcycle(arrays, top, r)


def make_vcycle(levels: List[MGLevel], coarse_solve, nu=2):
    """V-cycle preconditioner application r -> z (approximate K^{-1} r).

    Args:
      levels: coarse-to-fine MGLevel list.
      coarse_solve: (r_free_masked (2*n_c,)) -> z at the coarsest level.
      nu: pre/post smoothing sweeps (damped block-Jacobi) — an int
          (symmetric) or a (pre, post) tuple, as in `make_vcycle_ell`.
    """
    nu_pre, nu_post = (nu, nu) if isinstance(nu, int) else nu

    def smooth(lev: MGLevel, z, r, z_is_zero=False):
        sweeps = nu_pre if z_is_zero else nu_post
        # fori_loop shares one copy of the sweep body across nu sweeps —
        # the V-cycle instantiates smooth at two call sites per level
        # (see solve_cg's code-size note)
        def sweep(_, z):
            res = r - asm.tangent_matvec(lev.geom, lev.d, z)
            res = jnp.where(lev.free_flat, res, 0.0)
            dz = jnp.einsum(
                "nij,nj->ni", lev.inv_blocks, res.reshape(-1, 2)
            ).reshape(-1)
            return z + jnp.where(lev.free_flat, dz, 0.0)

        lo = 0
        if z_is_zero:
            # first sweep from z=0: res = r exactly — skip the matvec
            dz = jnp.einsum(
                "nij,nj->ni", lev.inv_blocks, r.reshape(-1, 2)
            ).reshape(-1)
            z = jnp.where(lev.free_flat, dz, 0.0)
            lo = 1
        return jax.lax.fori_loop(lo, sweeps, sweep, z)

    def vcycle(li: int, r):
        lev = levels[li]
        r = jnp.where(lev.free_flat, r, 0.0)
        if li == 0:
            return jnp.where(lev.free_flat, coarse_solve(r), 0.0)
        z = smooth(lev, jnp.zeros_like(r), r, z_is_zero=True)
        res = r - asm.tangent_matvec(lev.geom, lev.d, z)
        res = jnp.where(lev.free_flat, res, 0.0)
        n_c = levels[li - 1].geom.n_nodes
        r_c = restrict(res, lev.parents, n_c)
        z_c = vcycle(li - 1, r_c)
        z = z + jnp.where(
            lev.free_flat, prolong(z_c, lev.parents, lev.geom.n_nodes), 0.0
        )
        return smooth(lev, z, r)

    return lambda r: vcycle(len(levels) - 1, r)
