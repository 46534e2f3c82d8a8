"""Assembled sparse operator tests (ops/spmv.py).

Every layout (windowed ELL, dense and ragged slot, their double-float
forms, the bf16 smoother stream) is applied in plain XLA; correctness is
checked against scipy CSR and the matrix-free `tangent_matvec`.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from fem_elastoplasticity_tpu.models.materials import (
    elastic_tangent_lanes,
    lame_moduli,
)
from fem_elastoplasticity_tpu.models.tsx_tunnel import tsx_mesh
from fem_elastoplasticity_tpu.ops import assembly as asm
from fem_elastoplasticity_tpu.ops import spmv
from fem_elastoplasticity_tpu.ops.elements import ElementType, volume_element


@pytest.fixture(scope="module")
def tsx_rcm():
    mesh = tsx_mesh(ElementType.P1, refine_levels=1)
    coords = np.asarray(mesh.coords)
    elems = np.asarray(mesh.elems)
    order = spmv.rcm_node_order(elems, coords.shape[0])
    coords2, elems2, new_of_old = spmv.permute_mesh(coords, elems, order)
    free2 = np.asarray(mesh.free)[order]
    return coords2, elems2, free2, new_of_old


def test_rcm_reduces_bandwidth(tsx_rcm):
    coords2, elems2, _, _ = tsx_rcm
    bw = int((elems2.max(axis=1) - elems2.min(axis=1)).max())
    n_n = coords2.shape[0]
    assert bw < n_n // 4  # locality: far below the unordered worst case


def test_host_assembly_matches_device(tsx_rcm):
    coords2, elems2, free2, _ = tsx_rcm
    ref = volume_element(ElementType.P1)
    shear, bulk = lame_moduli(60000.0, 0.2)
    _, _, K = spmv.build_ell_elastic(
        coords2, elems2, ref, shear, bulk, free=None
    )
    # device path
    geom = asm.compute_geometry(
        jnp.asarray(coords2), jnp.asarray(elems2), ref
    )
    d = elastic_tangent_lanes(shear, bulk, geom.n_int, jnp.float64)
    rng = np.random.default_rng(0)
    v = rng.standard_normal(K.shape[0])
    ref_out = np.asarray(asm.tangent_matvec(geom, d, jnp.asarray(v)))
    np.testing.assert_allclose(K @ v, ref_out, rtol=1e-10, atol=1e-10)


def test_ell_matvec_matches_scipy(tsx_rcm):
    coords2, elems2, free2, _ = tsx_rcm
    ref = volume_element(ElementType.P1)
    shear, bulk = lame_moduli(60000.0, 0.2)
    arrays, meta, K = spmv.build_ell_elastic(
        coords2, elems2, ref, shear, bulk, free=free2
    )
    rng = np.random.default_rng(1)
    v = rng.standard_normal(meta.n2).astype(np.float32)
    got = np.asarray(ell_apply(arrays, meta, v))
    exp = K @ v.astype(np.float64)
    scale = np.abs(exp).max()
    np.testing.assert_allclose(got, exp, atol=2e-6 * scale)


def ell_apply(arrays, meta, v):
    fn = jax.jit(
        lambda a, vv: spmv.ell_matvec(a, meta, vv)
    )
    return fn(arrays, jnp.asarray(v))


def test_ell_bc_rows_identity(tsx_rcm):
    """Constrained DOFs behave as unit diagonal after apply_bc_csr."""
    coords2, elems2, free2, _ = tsx_rcm
    ref = volume_element(ElementType.P1)
    shear, bulk = lame_moduli(60000.0, 0.2)
    arrays, meta, K = spmv.build_ell_elastic(
        coords2, elems2, ref, shear, bulk, free=free2
    )
    flat = free2.reshape(-1)
    v = np.zeros(meta.n2, np.float32)
    cidx = np.nonzero(~flat)[0][:5]
    v[cidx] = 1.0
    out = np.asarray(ell_apply(arrays, meta, v))
    np.testing.assert_allclose(out[cidx], 1.0, rtol=1e-6)
    # free rows see no contribution from constrained columns
    free_idx = np.nonzero(flat)[0]
    np.testing.assert_allclose(out[free_idx], 0.0, atol=1e-7)


def test_diag_blocks(tsx_rcm):
    coords2, elems2, free2, _ = tsx_rcm
    ref = volume_element(ElementType.P1)
    shear, bulk = lame_moduli(60000.0, 0.2)
    _, _, K = spmv.build_ell_elastic(
        coords2, elems2, ref, shear, bulk, free=free2
    )
    n_n = coords2.shape[0]
    blocks = spmv.diag_blocks_csr(K, n_n)
    Kd = K.toarray()
    k = 17
    np.testing.assert_allclose(
        blocks[k], Kd[2 * k : 2 * k + 2, 2 * k : 2 * k + 2]
    )


# ---------------------------------------------------------------------------
# ELL multigrid hierarchy (solve/multigrid.py build_hierarchy_ell)
# ---------------------------------------------------------------------------
from fem_elastoplasticity_tpu.models.config import TsxTunnelConfig
from fem_elastoplasticity_tpu.models.tsx_tunnel import _DATA
from fem_elastoplasticity_tpu.solve import multigrid as mg
from fem_elastoplasticity_tpu.solve.cg import solve_cg


def _free_fn(coords):
    free = np.ones((coords.shape[0], 2), dtype=bool)
    free[np.abs(coords[:, 0]) > 49.99, 0] = False
    free[np.abs(coords[:, 1]) > 49.99, 1] = False
    return free


@pytest.fixture(scope="module")
def ell_hier():
    cfg = TsxTunnelConfig()
    shear, bulk = lame_moduli(cfg.young, cfg.poisson)
    raw = np.load(_DATA)
    ref = volume_element(ElementType.P1)
    return (
        mg.build_hierarchy_ell(
            raw["coords"].astype(np.float64), raw["elems"], 1, _free_fn,
            shear, bulk, ref,
        ),
        (shear, bulk),
    )


def test_ell_transfer_windows_small(ell_hier):
    (arrays, metas, perms, coarse), _ = ell_hier
    # derived ordering + overflow cap must keep windows bounded
    assert metas[1]["P"].J <= 16
    assert metas[1]["R"].J <= 48
    assert metas[1]["op"].J <= 32
    # overflow stays a tiny fraction of the operator
    nnz_op = int(np.count_nonzero(np.asarray(arrays[1]["op"]["vals"])))
    assert metas[1]["op"].n_overflow <= max(1, nnz_op // 100)


def test_ell_vcycle_preconditions_cg(ell_hier):
    (arrays, metas, perms, coarse), (shear, bulk) = ell_hier
    meta = metas[-1]["op"]
    arr = arrays[-1]

    def coarse_solve(r):
        idx0 = coarse["free_idx0"]
        return jnp.zeros_like(r).at[idx0].set(
            jax.scipy.linalg.cho_solve(
                (coarse["cho0"], False), r[idx0]
            )
        )

    pre = mg.make_vcycle_ell(metas, coarse_solve, nu=2)
    rng = np.random.default_rng(3)
    free = np.asarray(arr["free"])
    b = rng.standard_normal(meta.n2).astype(np.float32) * free

    res = solve_cg(
        lambda v: spmv.ell_matvec(arr["op"], meta, v),
        jnp.asarray(b),
        jnp.asarray(free),
        precond=lambda r: pre(arrays, r),
        tol=1e-5,
        maxiter=40,
        structure="while",
    )
    assert bool(res.converged)
    assert int(res.iters) <= 25  # mesh-independent-ish count
    # verify against scipy on the same matrix
    mesh_ok = np.asarray(
        spmv.ell_matvec(arr["op"], meta, res.x)
    )
    np.testing.assert_allclose(
        mesh_ok * free, b * free,
        atol=2e-4 * np.abs(b).max(),
    )


# ---------------------------------------------------------------------------
# compacted-slot format (build_slot / slot_matvec)
# ---------------------------------------------------------------------------
def test_slot_matvec_matches_scipy(tsx_rcm):
    coords2, elems2, free2, _ = tsx_rcm
    ref = volume_element(ElementType.P1)
    shear, bulk = lame_moduli(60000.0, 0.2)
    _, _, K = spmv.build_ell_elastic(
        coords2, elems2, ref, shear, bulk, free=free2
    )
    arrays, meta = spmv.build_slot(K)
    rng = np.random.default_rng(5)
    v = rng.standard_normal(meta.n2).astype(np.float32)
    got = np.asarray(
        jax.jit(lambda a, vv: spmv.slot_matvec(a, meta, vv))(
            arrays, jnp.asarray(v)
        )
    )
    exp = K @ v.astype(np.float64)
    scale = np.abs(exp).max()
    np.testing.assert_allclose(got, exp, atol=2e-6 * scale)


def test_slot_csr_positions_roundtrip(tsx_rcm):
    """Scattering K.data through the position map rebuilds `vals` exactly
    (dense and ragged layouts) — the invariant the static-structure
    tangent refresh (element_corr_dest / newton corr_dest) rests on."""
    coords2, elems2, free2, _ = tsx_rcm
    ref = volume_element(ElementType.P1)
    shear, bulk = lame_moduli(60000.0, 0.2)
    _, _, K = spmv.build_ell_elastic(
        coords2, elems2, ref, shear, bulk, free=free2
    )
    for ragged, u in [(False, 16), (True, 4)]:
        arrays, meta = spmv.build_slot(K, ragged=ragged, u=u)
        if ragged and not meta.n_ch:
            continue  # chunking fell back to dense for this matrix
        pos = spmv.slot_csr_positions(K, meta)
        assert np.unique(pos).size == pos.size  # one cell per entry
        rebuilt = np.zeros(np.asarray(arrays["vals"]).size, np.float32)
        rebuilt[pos] = K.data.astype(np.float32)
        np.testing.assert_array_equal(
            rebuilt, np.asarray(arrays["vals"]).reshape(-1)
        )


def test_element_corr_dest_scatter_matches_apply(tsx_rcm):
    """The scatter-refreshed operator equals elastic matvec + the
    gather/segment-sum plastic correction (same math, f32 rounding)."""
    coords2, elems2, free2, _ = tsx_rcm
    ref = volume_element(ElementType.P1)
    shear, bulk = lame_moduli(60000.0, 0.2)
    arrays, meta, K = spmv.build_ell_elastic(
        coords2, elems2, ref, shear, bulk, free=free2, fmt="slot"
    )
    dest = spmv.element_corr_dest(K, meta, elems2, free2)
    geom = asm.compute_geometry(
        jnp.asarray(coords2, jnp.float32), jnp.asarray(elems2),
        __import__(
            "fem_elastoplasticity_tpu.ops.elements", fromlist=["tables"]
        ).tables(ref),
    )
    n_dofs = 2 * coords2.shape[0]
    rng = np.random.default_rng(3)
    # synthetic plastic set: 37 scattered points with random symmetric
    # tangent deviations
    cap = 64
    n_int = geom.n_int
    ind = np.zeros(n_int, bool)
    ind[rng.choice(geom.n_q * geom.n_real, 37, replace=False)] = True
    delta_r = rng.standard_normal((3, 3, n_int)).astype(np.float32)
    delta = delta_r + delta_r.transpose(1, 0, 2)
    idx_p, valid_p = asm.plastic_slots(jnp.asarray(ind), cap)
    Bp, wdelta, edp = asm.plastic_correction_gather(
        geom, jnp.asarray(delta), idx_p, valid_p
    )
    v = rng.standard_normal(n_dofs).astype(np.float32)
    v = v * np.asarray(free2).reshape(-1)  # CG directions are masked
    expected = np.asarray(
        spmv.sp_matvec(arrays, meta, jnp.asarray(v))
        + asm.plastic_correction_apply(Bp, wdelta, edp, n_dofs, jnp.asarray(v))
    )
    e_p = idx_p // geom.n_q
    corr = jnp.einsum("aip,abp,bjp->pij", Bp, wdelta, Bp)
    vals_t = (
        arrays["vals"].reshape(-1)
        .at[jnp.asarray(dest)[e_p].reshape(-1)]
        .add(corr.reshape(-1), mode="drop")
        .reshape(arrays["vals"].shape)
    )
    got = np.asarray(
        spmv.sp_matvec({**arrays, "vals": vals_t}, meta, jnp.asarray(v))
    )
    free_rows = np.asarray(free2).reshape(-1)
    scale = np.abs(expected).max()
    np.testing.assert_allclose(
        got[free_rows], expected[free_rows], atol=5e-5 * scale
    )


def test_slot_matvec_rectangular():
    """P/R-shaped (rectangular) operators work in slot format too."""
    import scipy.sparse as sp

    rng = np.random.default_rng(7)
    for shape in [(700, 350), (130, 900), (128, 128)]:
        M = sp.random(*shape, density=0.02, random_state=11, format="csr")
        M.sum_duplicates()
        arrays, meta = spmv.build_slot(M)
        v = rng.standard_normal(shape[1]).astype(np.float32)
        got = np.asarray(
            jax.jit(lambda a, vv: spmv.slot_matvec(a, meta, vv))(
                arrays, jnp.asarray(v)
            )
        )
        exp = M @ v.astype(np.float64)
        scale = max(np.abs(exp).max(), 1e-30)
        np.testing.assert_allclose(got, exp, atol=2e-6 * scale)


def test_slot_hierarchy_vcycle_preconditions_cg():
    """A slot-format hierarchy drives the same V-cycle via sp_matvec."""
    cfg = TsxTunnelConfig()
    shear, bulk = lame_moduli(cfg.young, cfg.poisson)
    raw = np.load(_DATA)
    ref = volume_element(ElementType.P1)
    arrays, metas, perms, coarse = mg.build_hierarchy_ell(
        raw["coords"].astype(np.float64), raw["elems"], 1, _free_fn,
        shear, bulk, ref, fmt="slot",
    )
    assert isinstance(metas[-1]["op"], spmv.SlotMeta)
    meta = metas[-1]["op"]
    arr = arrays[-1]

    def coarse_solve(r):
        idx0 = coarse["free_idx0"]
        return jnp.zeros_like(r).at[idx0].set(
            jax.scipy.linalg.cho_solve((coarse["cho0"], False), r[idx0])
        )

    pre = mg.make_vcycle_ell(metas, coarse_solve, nu=2)
    rng = np.random.default_rng(3)
    free = np.asarray(arr["free"])
    b = rng.standard_normal(meta.n2).astype(np.float32) * free
    res = solve_cg(
        lambda v: spmv.sp_matvec(arr["op"], meta, v),
        jnp.asarray(b),
        jnp.asarray(free),
        precond=lambda r: pre(arrays, r),
        tol=1e-5,
        maxiter=40,
        structure="while",
    )
    assert bool(res.converged)
    assert int(res.iters) <= 25
    got = np.asarray(spmv.sp_matvec(arr["op"], meta, res.x))
    np.testing.assert_allclose(
        got * free, b * free, atol=2e-4 * np.abs(b).max()
    )


# ---------------------------------------------------------------------------
# double-float slot operator (build_slot_df / slot_matvec_df)
# ---------------------------------------------------------------------------
def _df_split(x64):
    hi = x64.astype(np.float32)
    lo = (x64 - hi.astype(np.float64)).astype(np.float32)
    return jnp.asarray(hi), jnp.asarray(lo)


def test_slot_matvec_df_f64_grade(tsx_rcm):
    """(A_hi+A_lo)(v_hi+v_lo) reaches ~1e-14 relative vs host f64."""
    coords2, elems2, free2, _ = tsx_rcm
    ref = volume_element(ElementType.P1)
    shear, bulk = lame_moduli(60000.0, 0.2)
    _, _, K = spmv.build_ell_elastic(
        coords2, elems2, ref, shear, bulk, free=free2
    )
    arrays, meta = spmv.build_slot_df(K)
    rng = np.random.default_rng(9)
    v64 = rng.standard_normal(meta.n2)
    vh, vl = _df_split(v64)
    oh, ol = jax.jit(
        lambda a, h, l: spmv.slot_matvec_df(a, meta, h, l)
    )(arrays, vh, vl)
    got = np.asarray(oh, np.float64) + np.asarray(ol, np.float64)
    exp = K @ v64
    scale = np.abs(exp).max()
    # far beyond f32 (which floors at ~2e-6 * scale)
    np.testing.assert_allclose(got, exp, atol=5e-13 * scale)


def test_residual_slot_df_matches_matrix_free(tsx_rcm):
    """Assembled G/S slot operators == matrix-free df32 strain/force."""
    from fem_elastoplasticity_tpu.ops import assembly_df as adf
    from fem_elastoplasticity_tpu.ops.df32 import DF

    coords2, elems2, free2, _ = tsx_rcm
    ref = volume_element(ElementType.P1)
    gdf = adf.geometry_df(coords2, elems2, ref)
    Ga, Gm, Sa, Sm = spmv.build_residual_slot_df(gdf)
    n_int = gdf.hi.n_int
    n2 = 2 * gdf.hi.n_nodes
    assert Gm.n2 == 3 * n_int and Gm.n_in == n2
    assert Sm.n2 == n2 and Sm.n_in == 3 * n_int

    rng = np.random.default_rng(11)
    u64 = rng.standard_normal(n2) * 1e-3
    uh, ul = _df_split(u64)

    # host f64 oracle: e = B u per integration point
    B64 = np.asarray(gdf.hi.B, np.float64) + np.asarray(
        gdf.B_lo, np.float64
    )
    w64 = np.asarray(gdf.hi.weight, np.float64) + np.asarray(
        gdf.w_lo, np.float64
    )
    edofs = np.asarray(gdf.hi.edofs, np.int64)
    n_q = gdf.hi.n_q
    ue = u64[edofs[np.arange(n_int) // n_q]]  # (n_int, 2n_p)
    e_exp = np.einsum("apq,qp->aq", B64, ue)  # (3, n_int)

    eh, el = jax.jit(
        lambda a, h, l: spmv.slot_matvec_df(a, Gm, h, l)
    )(Ga, uh, ul)
    e_got = (
        np.asarray(eh, np.float64) + np.asarray(el, np.float64)
    ).reshape(3, n_int)
    scale_e = np.abs(e_exp).max()
    np.testing.assert_allclose(e_got, e_exp, atol=5e-13 * scale_e)

    # matrix-free df32 strain path agrees too
    e_mf = adf.strains_df(gdf, DF(uh, ul))
    e_mf64 = np.asarray(e_mf.hi, np.float64) + np.asarray(
        e_mf.lo, np.float64
    )
    np.testing.assert_allclose(e_got, e_mf64, atol=5e-13 * scale_e)

    # internal force: F = sum_q w_q B^T s
    s64 = rng.standard_normal((3, n_int))
    sh, sl = _df_split(s64)
    f_exp = np.zeros(n2)
    wB = B64 * w64[None, None, :]
    contrib = np.einsum("apq,aq->qp", wB, s64)  # (n_int, 2n_p)
    np.add.at(
        f_exp, edofs[np.arange(n_int) // n_q].reshape(-1),
        contrib.reshape(-1),
    )

    fh, fl = jax.jit(
        lambda a, h, l: spmv.slot_matvec_df(a, Sm, h, l)
    )(Sa, sh.reshape(-1), sl.reshape(-1))
    f_got = np.asarray(fh, np.float64) + np.asarray(fl, np.float64)
    scale_f = np.abs(f_exp).max()
    np.testing.assert_allclose(f_got, f_exp, atol=5e-13 * scale_f)

    f_mf = adf.internal_force_df(gdf, DF(sh, sl))
    f_mf64 = np.asarray(f_mf.hi, np.float64) + np.asarray(
        f_mf.lo, np.float64
    )
    np.testing.assert_allclose(f_got, f_mf64, atol=5e-13 * scale_f)


def test_slot_matvec_high_dup_rows():
    """Rows with >64 entries inside one 128-column tile (P4-like row
    degree under locality ordering) pack and apply correctly — the dup
    radix is data-derived, not capped."""
    import scipy.sparse as sp

    rng = np.random.default_rng(13)
    n = 256
    rows, cols = [], []
    for i in range(n):
        # every row reads 100 consecutive columns from its own tile
        base = (i // 128) * 128
        rows.extend([i] * 100)
        cols.extend((base + (i + j) % 128) for j in range(100))
    M = sp.coo_matrix(
        (rng.standard_normal(len(rows)), (rows, cols)), shape=(n, n)
    ).tocsr()
    M.sum_duplicates()
    arrays, meta = spmv.build_slot(M)
    v = rng.standard_normal(n).astype(np.float32)
    got = np.asarray(spmv.slot_matvec(arrays, meta, jnp.asarray(v)))
    exp = M @ v.astype(np.float64)
    np.testing.assert_allclose(got, exp, atol=2e-6 * np.abs(exp).max())


def test_ell_matvec_df_f64_grade(tsx_rcm):
    """Windowed-ELL double-float matvec reaches ~1e-14 vs host f64,
    including the exact (row-compacted) slot-df overflow side path."""
    coords2, elems2, free2, _ = tsx_rcm
    ref = volume_element(ElementType.P1)
    shear, bulk = lame_moduli(60000.0, 0.2)
    _, _, K = spmv.build_ell_elastic(
        coords2, elems2, ref, shear, bulk, free=free2
    )
    # inject long-range entries far outside any window: on the RCM-ordered
    # level-1 mesh the windows otherwise absorb everything (a tight
    # max_overflow_frac alone does NOT produce overflow here — verified)
    import scipy.sparse as sp

    rng0 = np.random.default_rng(3)
    n = K.shape[0]
    r = rng0.integers(0, n, 40)
    c = (r + n // 2) % n
    K = (
        K + sp.coo_matrix((rng0.standard_normal(40), (r, c)), shape=K.shape)
    ).tocsr()
    arrays, meta = spmv.build_ell_df(K, max_overflow_frac=0.0001)
    assert meta.ov is not None  # the overflow side path must be exercised
    assert meta.ov.n2 < meta.ell.n2  # and row-compacted
    rng = np.random.default_rng(17)
    v64 = rng.standard_normal(meta.ell.n_in)
    vh, vl = _df_split(v64)
    oh, ol = jax.jit(
        lambda a, h, l: spmv.ell_matvec_df(a, meta, h, l)
    )(arrays, vh, vl)
    got = np.asarray(oh, np.float64) + np.asarray(ol, np.float64)
    exp = K @ v64
    scale = np.abs(exp).max()
    np.testing.assert_allclose(got, exp, atol=5e-13 * scale)


def test_residual_ell_df_matches_slot(tsx_rcm):
    """fmt='ell' residual operators agree with fmt='slot' to the df floor."""
    from fem_elastoplasticity_tpu.ops import assembly_df as adf

    coords2, elems2, free2, _ = tsx_rcm
    ref = volume_element(ElementType.P1)
    gdf = adf.geometry_df(coords2, elems2, ref)
    Ga, Gm, Sa, Sm = spmv.build_residual_slot_df(gdf, fmt="slot")
    Ge, Gme, Se, Sme = spmv.build_residual_slot_df(gdf, fmt="ell")
    rng = np.random.default_rng(19)
    u64 = rng.standard_normal(2 * gdf.hi.n_nodes) * 1e-3
    uh, ul = _df_split(u64)
    a_h, a_l = spmv.sp_matvec_df(Ga, Gm, uh, ul)
    b_h, b_l = spmv.sp_matvec_df(Ge, Gme, uh, ul)
    a = np.asarray(a_h, np.float64) + np.asarray(a_l, np.float64)
    b = np.asarray(b_h, np.float64) + np.asarray(b_l, np.float64)
    scale = max(np.abs(a).max(), 1e-30)
    np.testing.assert_allclose(b, a, atol=1e-12 * scale)

    s64 = rng.standard_normal(3 * gdf.hi.n_int)
    sh, sl = _df_split(s64)
    a_h, a_l = spmv.sp_matvec_df(Sa, Sm, sh, sl)
    b_h, b_l = spmv.sp_matvec_df(Se, Sme, sh, sl)
    a = np.asarray(a_h, np.float64) + np.asarray(a_l, np.float64)
    b = np.asarray(b_h, np.float64) + np.asarray(b_l, np.float64)
    scale = max(np.abs(a).max(), 1e-30)
    np.testing.assert_allclose(b, a, atol=1e-12 * scale)


def test_slot_matvec_trailing_empty_rows():
    """Operators whose trailing rows are all-zero (e.g. ELL overflow side
    matrices) must still return full-length outputs — n_sb is sized from
    n2, not from the last nonzero row."""
    import scipy.sparse as sp

    n = 2000  # trailing ~1500 rows empty
    M = sp.coo_matrix(
        (np.ones(3), ([0, 5, 400], [1, 2, 3])), shape=(n, n)
    ).tocsr()
    arrays, meta = spmv.build_slot(M)
    v = np.arange(n, dtype=np.float32)
    got = np.asarray(spmv.slot_matvec(arrays, meta, jnp.asarray(v)))
    assert got.shape == (n,)
    np.testing.assert_allclose(got, M @ v.astype(np.float64), atol=1e-6)

    arrays_df, meta_df = spmv.build_slot_df(M)
    oh, ol = spmv.slot_matvec_df(
        arrays_df, meta_df, jnp.asarray(v), jnp.zeros_like(jnp.asarray(v))
    )
    assert oh.shape == (n,)


def test_slot_sweep_matches_unfused():
    """Smoother sweep == matvec + mask + 2x2 block einsum + update.

    The sweep reorders one addition in the odd component (msf*res
    + mpr*res_pair vs the einsum's row dot), so agreement is to f32
    roundoff, not bitwise.
    """
    import scipy.sparse as sp

    rng = np.random.default_rng(3)
    n_n = 300
    n = 2 * n_n
    A = sp.random(n, n, density=0.02, random_state=7)
    K = (A + A.T + 10 * sp.eye(n)).tocsr()
    free = rng.random(n) > 0.15
    Kb = spmv.apply_bc_csr(K.copy(), free)
    arrays, meta = spmv.build_slot(Kb)
    blocks = spmv.diag_blocks_csr(Kb, n_n)
    a_, b_, c_, d_ = (
        blocks[:, 0, 0], blocks[:, 0, 1], blocks[:, 1, 0], blocks[:, 1, 1]
    )
    det = a_ * d_ - b_ * c_
    inv = (
        np.stack([np.stack([d_, -b_], -1), np.stack([-c_, a_], -1)], -2)
        / det[:, None, None]
    ) * 0.7
    aux = spmv.build_sweep_aux(inv, free, meta)
    invj = jnp.asarray(inv, jnp.float32)
    freej = jnp.asarray(free)

    z = jnp.asarray(rng.standard_normal(n), jnp.float32)
    r = jnp.where(
        freej, jnp.asarray(rng.standard_normal(n), jnp.float32), 0.0
    )

    res = r - spmv.slot_matvec(arrays, meta, z)
    res = jnp.where(freej, res, 0.0)
    dz = jnp.einsum("nij,nj->ni", invj, res.reshape(-1, 2)).reshape(-1)
    z_ref = z + jnp.where(freej, dz, 0.0)

    r2 = spmv.pad_rhs(r, meta)
    z_fused = spmv.slot_sweep(arrays, meta, aux, z, r2)
    np.testing.assert_allclose(
        np.asarray(z_fused), np.asarray(z_ref),
        atol=1e-6 * float(jnp.abs(z_ref).max()),
    )
    # update=False returns the masked residual bit-for-bit
    res_fused = spmv.slot_sweep(arrays, meta, aux, z, r2, update=False)
    np.testing.assert_array_equal(np.asarray(res_fused), np.asarray(res))


def test_packed_slot_matches_bf16_rounded():
    """The bf16-value / u8-index smoother stream == the f32 slot operator
    run on bf16-rounded values — bitwise: the values are upcast in the
    gather, so the f32 arithmetic and its order are identical; only the
    operator STREAM is stored narrower (ops/spmv.py pack_slot_bf16)."""
    import scipy.sparse as sp

    rng = np.random.default_rng(11)
    n_n = 350
    n = 2 * n_n
    A = sp.random(n, n, density=0.02, random_state=5)
    K = (A + A.T + 10 * sp.eye(n)).tocsr()
    free = rng.random(n) > 0.15
    Kb = spmv.apply_bc_csr(K.copy(), free)
    arrays, meta = spmv.build_slot(Kb)
    pk = spmv.pack_slot_bf16(arrays, meta)
    assert pk["vals"].dtype == jnp.bfloat16 and pk["cidx"].dtype == jnp.uint8

    # reference arrays: values rounded to bf16 (the packing's only loss)
    u = np.asarray(arrays["vals"], np.float32).view(np.uint32)
    u = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    arrays_bf = dict(arrays, vals=jnp.asarray(u.view(np.float32)))

    v = jnp.asarray(rng.standard_normal(n), jnp.float32)
    np.testing.assert_array_equal(
        np.asarray(spmv.slot_matvec(pk, meta, v)),
        np.asarray(spmv.slot_matvec(arrays_bf, meta, v)),
    )
    # bf16 rounding itself is small: packed matvec ~3e-3-relative of f32
    y32 = np.asarray(spmv.slot_matvec(arrays, meta, v))
    ypk = np.asarray(spmv.slot_matvec(pk, meta, v))
    assert np.abs(ypk - y32).max() <= 4e-3 * np.abs(y32).max()

    inv = rng.standard_normal((n_n, 2, 2)).astype(np.float32)
    aux = spmv.build_sweep_aux(inv, free, meta)
    z = jnp.asarray(rng.standard_normal(n), jnp.float32)
    r2 = spmv.pad_rhs(jnp.asarray(rng.standard_normal(n), jnp.float32), meta)
    for update in (True, False):
        np.testing.assert_array_equal(
            np.asarray(spmv.slot_sweep(pk, meta, aux, z, r2, update)),
            np.asarray(spmv.slot_sweep(arrays_bf, meta, aux, z, r2, update)),
        )


def test_packed_hierarchy_vcycle_preconditions_cg():
    """The bf16-packed V-cycle still preconditions CG to convergence and
    the solution matches the f32-hierarchy solve to solver tolerance
    (iteration counts may differ by ~1: measured 7 -> 8 at nu=2)."""
    from fem_elastoplasticity_tpu.solve import multigrid as mgm
    from fem_elastoplasticity_tpu.solve.cg import solve_cg

    raw = np.load("fem_elastoplasticity_tpu/data/tsx_tunnel_mesh.npz")

    def free_of(cc):
        fr = np.ones((cc.shape[0], 2), dtype=bool)
        fr[np.abs(cc[:, 0]) > 49.99, 0] = False
        fr[np.abs(cc[:, 1]) > 49.99, 1] = False
        return fr

    from fem_elastoplasticity_tpu.ops.elements import (
        ElementType, volume_element,
    )

    ref = volume_element(ElementType.P1)
    sols = {}
    for packed in (True, False):
        arrays, metas, perms, coarse = mgm.build_hierarchy_ell(
            raw["coords"].astype(np.float64), raw["elems"], 1, free_of,
            3.0e3, 5.0e3, ref, fmt="slot", pack_bf16=packed,
        )
        assert ("opk" in arrays[-1]) == packed
        top = len(metas) - 1
        idx0 = jnp.asarray(coarse["free_idx0"])
        inv0 = coarse["inv0"]
        coarse_fn = lambda r: jnp.zeros_like(r).at[idx0].set(inv0 @ r[idx0])
        vc = mgm.make_vcycle_ell(metas, coarse_fn, nu=2)
        A = lambda v: spmv.sp_matvec(arrays[top]["op"], metas[top]["op"], v)
        rng = np.random.default_rng(0)
        n = metas[top]["op"].n2
        b = jnp.asarray(rng.standard_normal(n), jnp.float32)
        free = arrays[top]["free"]
        res = solve_cg(
            A, b, free, precond=lambda r: vc(arrays, r), tol=1e-6,
            maxiter=100,
        )
        assert bool(res.converged), (packed, int(res.iters))
        sols[packed] = np.asarray(res.x)
    scale = np.abs(sols[False]).max()
    assert np.abs(sols[True] - sols[False]).max() <= 1e-4 * scale


def test_packed_hierarchy_shards_bit_identically():
    """A hierarchy carrying the bf16 smoother stream row-shards with it:
    the V-cycle under shard_map on 4 devices equals the single-device
    V-cycle bitwise (the stream shares the operator's slot layout)."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from fem_elastoplasticity_tpu.ops.elements import volume_element
    from fem_elastoplasticity_tpu.parallel.sharding import make_device_mesh

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    raw = np.load(_DATA)
    arrays, metas, _, coarse = mg.build_hierarchy_ell(
        raw["coords"].astype(np.float64), raw["elems"], 1, _free_fn,
        3.0e3, 5.0e3, volume_element(ElementType.P1), fmt="slot",
        pack_bf16=True,
    )
    top = len(metas) - 1
    assert "opk" in arrays[top]
    idx0, inv0 = coarse["free_idx0"], coarse["inv0"]
    coarse_fn = lambda r: jnp.zeros_like(r).at[idx0].set(inv0 @ r[idx0])
    r = jnp.asarray(
        np.random.default_rng(2).standard_normal(metas[top]["op"].n2),
        jnp.float32,
    )
    vc1 = mg.make_vcycle_ell(metas, coarse_fn, nu=2)
    z1 = jax.jit(vc1)(arrays, r)
    a4, m4, s4 = mg.shard_hierarchy_ell(arrays, metas, 4)
    assert "opk" in a4[top]
    vc4 = mg.make_vcycle_ell(m4, coarse_fn, nu=2)
    z4 = jax.jit(shard_map(
        vc4, mesh=make_device_mesh(4, spmv.OP_AXIS), in_specs=(s4, P()),
        out_specs=P(), check_vma=False,
    ))(a4, r)
    np.testing.assert_array_equal(np.asarray(z4), np.asarray(z1))


def _skewed_spd(rng, n_n=4096, n_tail=4):
    """SPD CSR whose slot layout is genuinely skewed: a banded bulk plus
    a few near-dense rows confined to ONE superblock, so that block's
    slot count inflates s_pad far past the other superblocks' and the
    ragged chunking activates."""
    import scipy.sparse as sp

    n = 2 * n_n
    bulk_band = sp.diags(
        [np.ones(n - k) for k in (1, 2, 3)], [1, 2, 3], shape=(n, n)
    )
    tail = sp.random(n_tail, n, density=0.3, random_state=12).tocoo()
    T = sp.coo_matrix((tail.data, (tail.row, tail.col)), shape=(n, n))
    K = (bulk_band + bulk_band.T + T + T.T + 20 * sp.eye(n)).tocsr()
    free = rng.random(n) > 0.15
    return spmv.apply_bc_csr(K, free), free


def test_ragged_slot_matches_dense():
    """fmt="rslot" (chunk-compacted stream, chunk partials folded into
    their superblocks by a segment sum) == the dense slot operator, on an
    operator skewed enough that chunking actually activates
    (meta.n_ch > 0)."""
    rng = np.random.default_rng(5)
    K, free = _skewed_spd(rng)
    n_n = K.shape[0] // 2
    ad, md = spmv.build_slot(K)
    ar, mr = spmv.build_sparse(K, fmt="rslot")
    assert mr.n_ch > 0, "test operator must activate ragged chunking"
    assert mr.n_ch * mr.u < md.n_sb * md.s_pad  # it actually compacts

    v = jnp.asarray(rng.standard_normal(md.n_in), jnp.float32)
    yd = spmv.slot_matvec(ad, md, v)
    yr = spmv.sp_matvec(ar, mr, v)
    # same entries, chunk partials reorder the summation -> f32 roundoff
    np.testing.assert_allclose(
        np.asarray(yr), np.asarray(yd),
        atol=1e-5 * float(jnp.abs(yd).max()),
    )

    # fused sweep (update=True and the masked residual)
    blocks = spmv.diag_blocks_csr(K, n_n)
    a_, b_, c_, d_ = (
        blocks[:, 0, 0], blocks[:, 0, 1], blocks[:, 1, 0], blocks[:, 1, 1]
    )
    det = a_ * d_ - b_ * c_
    inv = (
        np.stack([np.stack([d_, -b_], -1), np.stack([-c_, a_], -1)], -2)
        / det[:, None, None]
    ) * 0.7
    auxd = spmv.build_sweep_aux(inv, free, md)
    auxr = spmv.build_sweep_aux(inv, free, mr)
    z = jnp.asarray(rng.standard_normal(md.n2), jnp.float32)
    r = jnp.asarray(rng.standard_normal(md.n2), jnp.float32)
    for update in (True, False):
        sd = spmv.slot_sweep(ad, md, auxd, z, spmv.pad_rhs(r, md), update=update)
        sr = spmv.slot_sweep(ar, mr, auxr, z, spmv.pad_rhs(r, mr), update=update)
        np.testing.assert_allclose(
            np.asarray(sr), np.asarray(sd),
            atol=1e-5 * float(jnp.abs(sd).max()),
        )


def test_ragged_slot_df_f64_grade():
    """Ragged double-float slot matvec keeps ~1e-14 relative accuracy:
    chunk partials are folded with the same compensated double-float
    reduction as the slots inside a chunk."""
    rng = np.random.default_rng(6)
    K, _ = _skewed_spd(rng)
    K64 = K.astype(np.float64)
    K64.data *= 1.0 + 1e-9 * rng.standard_normal(K64.nnz)  # exercise lo bits
    ar, mr = spmv.build_slot_df(K64, ragged=True)
    assert mr.n_ch > 0
    v_hi = jnp.asarray(rng.standard_normal(mr.n_in), jnp.float32)
    v_lo = jnp.asarray(1e-8 * rng.standard_normal(mr.n_in), jnp.float32)
    with jax.enable_x64(True):
        ref = K64 @ (
            np.asarray(v_hi, np.float64) + np.asarray(v_lo, np.float64)
        )
    oh, ol = spmv.slot_matvec_df(ar, mr, v_hi, v_lo)
    got = np.asarray(oh, np.float64) + np.asarray(ol, np.float64)
    rel = np.abs(got - ref).max() / np.abs(ref).max()
    assert rel < 5e-13, rel


def test_ragged_falls_back_dense_when_uniform():
    """Uniform operators skip ragged chunking (saves <15%): build_sparse
    fmt="rslot" then returns the dense layout (meta.n_ch == 0) and the
    dense application serves it."""
    import scipy.sparse as sp

    rng = np.random.default_rng(7)
    n = 512
    K = (sp.eye(n) * 5 + sp.diags(np.ones(n - 1), 1) + sp.diags(np.ones(n - 1), -1)).tocsr()
    a, m = spmv.build_sparse(K, fmt="rslot")
    assert m.n_ch == 0
    v = jnp.asarray(rng.standard_normal(n), jnp.float32)
    np.testing.assert_allclose(
        np.asarray(spmv.sp_matvec(a, m, v)), K @ np.asarray(v, np.float64),
        rtol=1e-5,
    )
