"""TSX tunnel excavation: Drucker-Prager elastoplasticity on an unstructured
triangle mesh (benchmark C).

Parity target: `tsx-tunnel/pythonFEM.py:1637-1851`.  Behavioral anchors
(SURVEY.md §8.1): 17 accepted load steps / 28 Newton iterations, plastic
onset at step 14, final tunnel-wall displacement U[0, 40] = -1.979450e-03.

The mesh (476 nodes / 887 P1 triangles, from the TU Liberec team) ships with
the package as `data/tsx_tunnel_mesh.npz` (converted from the reference's
`coord.csv`/`elem.csv`).
"""
from __future__ import annotations

import pathlib
from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

from ..mesh.midpoints import promote
from ..mesh.refine import refine_uniform
from ..mesh.structured import Mesh
from ..ops.elements import ElementType
from .config import TsxTunnelConfig

_DATA = pathlib.Path(__file__).parent.parent / "data" / "tsx_tunnel_mesh.npz"


def _elastic_factor(cho, dtype):
    """Prefactored elastic stiffness for newton.newton_solve reuse.

    Enabled only on the f32 fast path; the f64 parity path factors afresh
    each iteration (whether the reuse branch also pays under f64 on the
    GPU is not measured).
    """
    import jax.numpy as jnp

    if dtype != jnp.float32:
        return None
    return cho



class TsxResult(NamedTuple):
    u: jnp.ndarray  # (n_n, 2)
    ep: jnp.ndarray
    zeta_hist: jnp.ndarray
    displ_hist: jnp.ndarray  # tunnel-wall u_x history (T:1813)
    n_steps: int
    n_newton_total: int
    n_plastic: int
    mesh: Mesh
    n_cg_total: int = 0  # cumulative CG iterations (0 on the dense path)


def tsx_mesh(
    etype: ElementType = ElementType.P1, refine_levels: int = 0
) -> Mesh:
    """Load the TSX mesh, optionally refine (P1), then promote to `etype`.

    Dirichlet BCs (`tsx-tunnel/pythonFEM.py:1695-1699`): normal displacement
    clamped on the +-50 box, i.e. u_x fixed where |x| > 49.99 and u_y fixed
    where |y| > 49.99 (homogeneous).
    """
    raw = np.load(_DATA)
    coords, elems = raw["coords"].astype(np.float64), raw["elems"]
    for _ in range(refine_levels):
        coords, elems = refine_uniform(coords, elems)
    coords, elems = promote(etype, coords, elems)

    free = np.ones((coords.shape[0], 2), dtype=bool)
    free[np.abs(coords[:, 0]) > 49.99, 0] = False
    free[np.abs(coords[:, 1]) > 49.99, 1] = False
    dirichlet = np.zeros_like(coords)
    return Mesh(coords, elems, etype, dirichlet=dirichlet, free=free)


def tunnel_wall_edges(mesh: Mesh) -> np.ndarray:
    """Boundary edges of the tunnel wall (the interior boundary).

    All boundary edges whose endpoints are strictly inside the +-50 box —
    i.e. the excavation ellipse (`draw_quantity` hard-codes it as
    2.1875 x 1.75, `tsx-tunnel/pythonFEM.py:1344-1350`).  Includes the
    higher-order edge nodes for P2/P4 meshes.
    """
    from ..mesh.boundary import boundary_edges

    edges = boundary_edges(np.asarray(mesh.elems), mesh.etype)
    c = np.asarray(mesh.coords)
    inner = (np.abs(c[edges[:, 0]]) < 49.0).all(axis=1) & (
        np.abs(c[edges[:, 1]]) < 49.0
    ).all(axis=1)
    return edges[inner]


def initial_state(cfg: TsxTunnelConfig):
    """Initial stress and the derived initial strain (inverse plane-strain
    Hooke), `tsx-tunnel/pythonFEM.py:1675-1681`."""
    s0 = np.asarray(cfg.init_stress, dtype=np.float64)
    tr = s0[0] + s0[1] + s0[3]
    nu, E = cfg.poisson, cfg.young
    e0 = (
        np.array(
            [
                -nu * tr + (1 + nu) * s0[0],
                -nu * tr + (1 + nu) * s0[1],
                0.0,
                -nu * tr + (1 + nu) * s0[3],
            ]
        )
        / E
    )
    return s0, e0


def solve(cfg: TsxTunnelConfig = TsxTunnelConfig()) -> TsxResult:
    """Run the excavation: elastic predictor + load-stepped Newton, one jit.

    Parity: `tsx-tunnel/pythonFEM.py:1763-1832`.  Anchors (SURVEY.md §8.1):
    17 accepted steps, 28 Newton iterations, final u_x(node 40) =
    -1.979450e-03 at zeta = 1.

    cfg.precision == "df32" runs the double-float fast path: the same
    trajectory and ~1e-12 accuracy at pure-f32 speed (see solve/newton.py).
    """
    if cfg.precision == "df32":
        return _solve_df32(cfg)
    import jax

    from ..ops import assembly as asm
    from ..ops.elements import tables, volume_element
    from ..solve.newton import NewtonSettings, build_load_stepper
    from .materials import (
        drucker_prager_fit,
        elastic_tangent_lanes,
        lame_moduli,
    )

    assert cfg.solver in ("dense", "cg", "mg"), (
        f"{cfg.solver!r}: the ell solver runs under precision='df32'"
    )
    mesh = tsx_mesh(cfg.etype, cfg.refine_levels)
    dtype = jnp.dtype(cfg.dtype)
    shear, bulk = lame_moduli(cfg.young, cfg.poisson)
    eta, c = drucker_prager_fit(cfg.cohesion, cfg.friction_angle)
    s0, e0 = initial_state(cfg)

    ref = volume_element(cfg.etype)
    fmap_np, n_free = asm.free_dof_map(mesh.free)
    free_idx = jnp.asarray(np.nonzero(mesh.free.reshape(-1))[0])
    fmap = jnp.asarray(fmap_np)
    # None -> dtype-appropriate default: 1e-14 (f64) / 2e-7 (the f32
    # preconditioned-residual floor; tighter stalls and trips the
    # breakdown guard)
    cg_tol = cfg.cg_tol if cfg.cg_tol is not None else (
        2e-7 if dtype == jnp.float32 else 1e-14
    )

    coords = jnp.asarray(mesh.coords, dtype)
    elems = jnp.asarray(mesh.elems)
    monitor_dof = 2 * cfg.monitor_node  # u_x of the tunnel-wall node

    settings = NewtonSettings(
        maxit=cfg.newton_maxit,
        newton_tol=cfg.newton_tol,
        accept_tol=cfg.accept_tol,
        d_zeta_min=cfg.d_zeta * cfg.d_zeta_min_ratio,
        zeta_max=cfg.zeta_max,
        max_steps=cfg.max_steps,
        step0=0,
        max_trips=cfg.max_trips,
    )

    # every array enters through the jit boundary as an argument
    # (utils/jitsafe.py)
    args = dict(
        coords=coords,
        elems=elems,
        tab=tables(ref),
        fmap=fmap,
        free_idx=free_idx,
        s0=jnp.asarray(s0, dtype),
        e0=jnp.asarray(e0, dtype),
    )
    n_nodes = mesh.n_nodes

    if cfg.support_pressure != 0.0:
        # tunnel support: normal traction on the wall, ramped with zeta;
        # computed eagerly at setup (static geometry), passed as an arg
        from ..ops.elements import surface_element

        edges = tunnel_wall_edges(mesh)
        args["f_ext"] = asm.pressure_traction_vector(
            coords, jnp.asarray(edges), surface_element(cfg.etype),
            jnp.asarray(cfg.support_pressure, dtype), n_nodes,
        )

    if cfg.solver == "mg":
        # geometric multigrid on the refinement hierarchy (P1 only)
        assert cfg.etype == ElementType.P1, "mg solver requires P1"
        from ..solve import multigrid as mg

        raw = np.load(_DATA)
        base_c, base_e = raw["coords"].astype(np.float64), raw["elems"]

        def _free_fn(c):
            fr = np.ones((c.shape[0], 2), dtype=bool)
            fr[np.abs(c[:, 0]) > 49.99, 0] = False
            fr[np.abs(c[:, 1]) > 49.99, 1] = False
            return fr

        args["hier"] = mg.build_hierarchy(
            base_c, base_e, cfg.refine_levels, _free_fn
        )
        fmap0_np, n_free0 = asm.free_dof_map(np.asarray(args["hier"][0].free))
        args["fmap0"] = jnp.asarray(fmap0_np)
        args["free_idx0"] = jnp.asarray(
            np.nonzero(np.asarray(args["hier"][0].free).reshape(-1))[0]
        )
        n_free0_static = n_free0

    @jax.jit
    def run(a):
        geom = asm.compute_geometry(a["coords"], a["elems"], a["tab"])

        # initial-stress force F0 = B^T (w * s0[:3])  (T:1737)
        s0_field = jnp.broadcast_to(a["s0"][:3, None], (3, geom.n_int))
        f0 = asm.internal_force(geom, s0_field)
        rhs0 = -f0 + a["f_ext"] if "f_ext" in a else -f0

        D = elastic_tangent_lanes(shear, bulk, geom.n_int, dtype)

        mg_pre = None
        if cfg.solver == "mg":
            from ..solve import multigrid as mg

            d_fn = lambda g: elastic_tangent_lanes(shear, bulk, g.n_int, dtype)
            mg_levels = mg.build_mg_levels(a["hier"], a["tab"], d_fn)
            lev0 = mg_levels[0]
            K0 = asm.assemble_dense_free(
                asm.element_stiffness(lev0.geom, lev0.d),
                lev0.geom, a["fmap0"], n_free0_static,
            )
            cho0 = jax.scipy.linalg.cho_factor(K0)
            idx0 = a["free_idx0"]

            def coarse_solve(r):
                return jnp.zeros_like(r).at[idx0].set(
                    jax.scipy.linalg.cho_solve(cho0, r[idx0])
                )

            mg_pre = mg.make_vcycle(mg_levels, coarse_solve, nu=cfg.mg_nu)

        # elastic predictor (T:1748): K u = -F0 (+ support traction)
        cho = None
        if cfg.solver == "dense":
            ke = asm.element_stiffness(geom, D)
            K_free = asm.assemble_dense_free(ke, geom, a["fmap"], n_free)
            cho = jax.scipy.linalg.cho_factor(K_free)
            u_el_free = jax.scipy.linalg.cho_solve(cho, rhs0[a["free_idx"]])
            u_elast = (
                jnp.zeros((2 * n_nodes,), dtype).at[a["free_idx"]].set(u_el_free)
            )
        else:
            # matrix-free predictor — the dense K never exists (the
            # reference's scalability cliff, SURVEY.md §8.3)
            from ..solve.cg import block_jacobi_preconditioner, solve_cg

            fmask = (
                jnp.zeros((2 * n_nodes,), bool).at[a["free_idx"]].set(True)
            )
            pre = mg_pre
            if pre is None:
                blocks = asm.node_block_diagonal(geom, D)
                pre = block_jacobi_preconditioner(blocks, fmask.reshape(-1, 2))
            u_elast = solve_cg(
                lambda v: asm.tangent_matvec(geom, D, v),
                rhs0,
                fmask,
                precond=pre,
                tol=cg_tol,
                maxiter=cfg.cg_maxiter,
                structure=cfg.cg_structure,
            ).x

        stepper = build_load_stepper(
            geom,
            a["free_idx"],
            a["fmap"],
            n_free,
            shear,
            bulk,
            eta,
            c,
            settings,
            e0_dir=a["e0"],
            monitor=lambda u, s: u[monitor_dof],
            solver=cfg.solver,
            cg_tol=cg_tol,
            cg_maxiter=cfg.cg_maxiter,
            cg_structure=cfg.cg_structure,
            dense_mode=cfg.dense_mode,
            mg_preconditioner=mg_pre,
            elastic_factor=(
                _elastic_factor(cho, dtype) if cfg.solver == "dense" else None
            ),
            accumulate_ep=not cfg.bug_compatible_ep_reset,
            f_ext_dir=a.get("f_ext"),
        )
        return stepper(cfg.d_zeta * u_elast, 0.0, cfg.d_zeta)

    res = run(args)
    return TsxResult(
        u=res.u.reshape(-1, 2),
        ep=res.ep,
        zeta_hist=res.zeta_hist,
        displ_hist=res.monitor_hist,
        n_steps=int(res.n_steps),
        n_newton_total=int(res.n_newton_total),
        n_plastic=int(res.n_plastic),
        mesh=mesh,
        n_cg_total=int(res.n_cg_total),
    )


def build_df32(
    cfg: TsxTunnelConfig,
    extras: Optional[dict] = None,
    shard_devices: Optional[int] = None,
):
    """Build the jitted df32 tsx solver: returns (run, args, mesh).

    `run(args)` executes the full load-stepped solve on device;
    `run(args, resume)` continues from a carry (the elastic predictor is
    statically skipped — resumed chunks never pay for it);
    `_solve_df32` wraps it into a TsxResult (bench.py times `run` raw).

    `extras`, if given, is populated with auxiliary jitted entry points
    for dispatch-split execution on iterative solvers (cg/mg):
      predict_pass(a, u_hi, u_lo) -> (u_hi', u_lo')  one df32 IR pass of
        the elastic predictor (PCG inner solve);
      start_carry(a, u_hi, u_lo) -> (uit_hi, uit_lo)  the initial Newton
        iterate d_zeta * u_elast as a DF pair.

    `shard_devices` (solver="ell" only): run the PRODUCTION solver
    multi-chip — the assembled slot/ELL operators (MG hierarchy, transfer
    operators, df32 G/S residual operators) are row-partitioned over a
    1D device mesh and the whole solve executes under `shard_map`.  Each
    shard computes its rows with the single-device arithmetic and outputs
    reassemble with exact all_gathers, so the adaptive trajectory matches
    the single-device solve: bitwise on the CPU test mesh
    (tests/test_parallel.py::TestShardedScale), to ~1e-13 on GPUs, whose
    scatter-adds accumulate in a nondeterministic order.  Geometry, DOF vectors
    and the Newton control flow are replicated; only operator rows (the
    dominant memory and per-iteration cost at scale) are distributed.
    """
    import jax

    from ..ops import assembly as asm
    from ..ops import assembly_df as adf
    from ..ops.df32 import DF, df_const
    from ..ops.elements import volume_element
    from ..solve.newton import NewtonSettings, build_load_stepper
    from .materials import drucker_prager_fit, elastic_tangent_lanes, lame_moduli

    assert cfg.solver in ("dense", "cg", "mg", "ell"), cfg.solver
    mesh = tsx_mesh(cfg.etype, cfg.refine_levels)
    shear, bulk = lame_moduli(cfg.young, cfg.poisson)
    eta, c = drucker_prager_fit(cfg.cohesion, cfg.friction_angle)
    s0, e0 = initial_state(cfg)

    ref = volume_element(cfg.etype)
    monitor_node = cfg.monitor_node
    ell = None
    esort = None
    if cfg.solver == "ell":
        # Windowed-ELL multigrid (ops/spmv.py): the elastic hierarchy is
        # assembled host-side with locality node ordering, and the WHOLE
        # problem is permuted onto that ordering (coords/elems/free/
        # monitor) so the V-cycle never touches a permutation gather.
        #
        # P2/P4 (p-multigrid): the high-order node lattice on straight-
        # edged triangles coincides with log2(order) uniform red
        # refinements of the base mesh, so the SAME P1 hierarchy
        # (spectrally equivalent low-order operator on the identical node
        # set) preconditions the high-order tangent CG; nodes are matched
        # by coordinates.  The tangent itself stays the true high-order
        # matrix-free operator.
        p_extra = {
            ElementType.P1: 0, ElementType.P2: 1, ElementType.P4: 2,
        }.get(cfg.etype)
        assert p_extra is not None, (
            "ell solver supports triangle elements (P1/P2/P4)"
        )
        n_levels = cfg.refine_levels + p_extra
        assert n_levels >= 1, "ell solver needs >= 1 hierarchy level"
        from ..ops import spmv
        from ..solve import multigrid as mgm

        raw = np.load(_DATA)

        def _free_of(cc):
            fr = np.ones((cc.shape[0], 2), dtype=bool)
            fr[np.abs(cc[:, 0]) > 49.99, 0] = False
            fr[np.abs(cc[:, 1]) > 49.99, 1] = False
            return fr

        mg_arr_ell, mg_metas_ell, perms, coarse_ell = mgm.build_hierarchy_ell(
            raw["coords"].astype(np.float64), raw["elems"],
            n_levels, _free_of, shear, bulk, ref
            if cfg.etype == ElementType.P1
            else volume_element(ElementType.P1),
            fmt=cfg.spmv_fmt,
        )
        if cfg.etype == ElementType.P1:
            order = np.argsort(np.asarray(perms[-1]), kind="stable")
        else:
            # match the high-order nodes onto the refined-lattice ordering
            from scipy.spatial import cKDTree

            fine_c = np.asarray(coarse_ell["fine_coords"], np.float64)
            assert fine_c.shape[0] == mesh.n_nodes, (
                fine_c.shape, mesh.n_nodes,
            )
            dist, order = cKDTree(
                np.asarray(mesh.coords, np.float64)
            ).query(fine_c)
            scale = np.abs(fine_c).max()
            assert dist.max() < 1e-9 * scale, float(dist.max())
            assert np.unique(order).size == mesh.n_nodes  # bijection
        coords2, elems2, new_of_old = spmv.permute_mesh(
            np.asarray(mesh.coords, np.float64), np.asarray(mesh.elems),
            order,
        )
        # node-locality element sort: the assembled strain/force slot
        # operators (build_residual_slot_df) block output rows by 128
        # consecutive integration points — consecutive elements must
        # reference nearby (permuted) nodes for small slot counts
        esort = np.argsort(elems2.min(axis=1), kind="stable")
        elems2 = elems2[esort]
        free2 = _free_of(coords2)
        mesh = Mesh(
            coords2, elems2, cfg.etype,
            dirichlet=np.zeros_like(coords2), free=free2,
        )
        monitor_node = int(new_of_old[cfg.monitor_node])
        ell = dict(metas=mg_metas_ell, new_of_old=new_of_old)
        if extras is not None:
            # node map for callers that need reference ordering back:
            # u_orig[old] = u_perm[new_of_old[old]]; element (and hence
            # integration-point) order is restored via extras["elem_sort"]
            extras["ell_new_of_old"] = new_of_old
    elastic_slot = None
    if cfg.solver == "cg" and cfg.assembled_cg:
        # assembled-operator CG, element-type generic (config.assembled_cg):
        # RCM-permute the problem onto a locality node ordering, assemble
        # the elastic stiffness once on the host into the compacted-slot
        # format, and run tangent CG as K_elastic (slot matvec) + a
        # low-rank plastic correction — the P4 production path
        from ..ops import spmv

        order = spmv.rcm_node_order(np.asarray(mesh.elems), mesh.n_nodes)
        coords2, elems2, new_of_old = spmv.permute_mesh(
            np.asarray(mesh.coords, np.float64), np.asarray(mesh.elems),
            order,
        )
        esort = np.argsort(elems2.min(axis=1), kind="stable")
        elems2 = elems2[esort]
        free2 = np.asarray(mesh.free)[order]
        mesh = Mesh(
            coords2, elems2, cfg.etype,
            dirichlet=np.zeros_like(coords2), free=free2,
        )
        monitor_node = int(new_of_old[cfg.monitor_node])
        _Ka, _Km, _ = spmv.build_ell_elastic(
            coords2, elems2, ref, shear, bulk, free=free2, fmt="slot"
        )
        elastic_slot = (_Ka, _Km)
        if extras is not None:
            extras["ell_new_of_old"] = new_of_old
    fmap_np, n_free = asm.free_dof_map(mesh.free)
    free_idx = jnp.asarray(np.nonzero(np.asarray(mesh.free).reshape(-1))[0])
    fmap = jnp.asarray(fmap_np)

    gdf = adf.geometry_df(mesh.coords, mesh.elems, ref)
    n_nodes, n_q, n_real = mesh.n_nodes, gdf.hi.n_q, gdf.hi.n_real
    # static plastic-slot cap for the assembled-elastic tangent CG (ell
    # mode): observed plastic fractions are <1% (379/56.8k at level 3);
    # 1/64 with a 1024 floor gives >2x headroom.  Overflow degrades the
    # tangent (extra Newton its), never the residual — newton.py.
    plastic_cap = min(gdf.hi.n_int, max(1024, gdf.hi.n_int // 64))
    if extras is not None and esort is not None:
        # integration-point restore map: sorted[k] = original[esort[k]]
        extras["elem_sort"] = (esort, int(gdf.hi.n_q), int(gdf.hi.n_real))
    res_metas = None
    if cfg.solver == "ell" or elastic_slot is not None or (
        cfg.solver == "dense" and cfg.assembled_cg
    ):
        # assembled df32 strain/force operators for the Newton residual
        # (host setup; the mesh was locality-permuted + element-sorted).
        from ..ops import spmv as _spmv_mod

        # auto = ragged slot: _ragged_pack falls back to the dense slot
        # layout when chunking saves <15% (uniform P1 operators), while
        # operators with outlier slot counts (P4 S: s_pad 1092 for a
        # far smaller mean) get chunked.  Row sharding needs the dense
        # layout (ops/spmv.py shard_rows), so sharded runs default to it.
        _res_fmt = cfg.residual_fmt or (
            "slot" if shard_devices is not None else "rslot"
        )
        _Ga, _Gm, _Sa, _Sm = _spmv_mod.build_residual_slot_df(
            gdf, fmt=_res_fmt, max_overflow_frac=cfg.ell_overflow_frac
        )
        res_metas = (_Gm, _Sm)
    dev_mesh = None
    if shard_devices is not None:
        # Multi-chip production path (docstring): row-shard the hierarchy
        # and the df32 residual operators; build the shard_map spec trees.
        assert cfg.solver == "ell", "shard_devices requires solver='ell'"
        from jax.sharding import NamedSharding
        from jax.sharding import PartitionSpec as SpecP

        from ..ops import spmv as _spmv_mod
        from ..parallel.sharding import make_device_mesh
        from ..solve import multigrid as mgm_sh

        n_dev = int(shard_devices)
        dev_mesh = make_device_mesh(n_dev, _spmv_mod.OP_AXIS)
        # pre-sharding fine operator meta: the corr_dest table is built
        # against the unsharded cell layout (see the corr_mode block)
        fine_op_meta0 = ell["metas"][-1]["op"]
        mg_arr_ell, mg_metas_sh, mg_specs = mgm_sh.shard_hierarchy_ell(
            mg_arr_ell, ell["metas"], n_dev
        )
        ell["metas"] = mg_metas_sh
        _Ga, _Gm, g_specs = _spmv_mod.shard_rows(_Ga, _Gm, n_dev)
        _Sa, _Sm, s_specs = _spmv_mod.shard_rows(_Sa, _Sm, n_dev)
        res_metas = (_Gm, _Sm)
        shard_specs = dict(mg_ell=mg_specs, G_slot=g_specs, S_slot=s_specs)

        def _put_sharded(tree, spec_tree):
            # place shards on their devices up front: each chip holds only
            # its row slice (the capacity story at level >= 4)
            return jax.tree.map(
                lambda x, s: jax.device_put(x, NamedSharding(dev_mesh, s)),
                tree, spec_tree,
            )
    monitor_dof = 2 * monitor_node
    f32 = jnp.float32

    settings = NewtonSettings(
        maxit=cfg.newton_maxit,
        newton_tol=cfg.newton_tol,
        accept_tol=cfg.accept_tol,
        d_zeta_min=cfg.d_zeta * cfg.d_zeta_min_ratio,
        zeta_max=cfg.zeta_max,
        max_steps=cfg.max_steps,
        step0=0,
        max_trips=cfg.max_trips,
    )

    s0_hi, s0_lo = adf.split_f64_np(s0)
    e0_hi, e0_lo = adf.split_f64_np(e0)
    # every array enters through the jit boundary as an argument
    # (utils/jitsafe.py)
    args = dict(
        B_hi=gdf.hi.B, w_hi=gdf.hi.weight,
        edofs=gdf.hi.edofs, edofs_t=gdf.hi.edofs_t,
        B_lo=gdf.B_lo, w_lo=gdf.w_lo, gmap=gdf.gmap,
        fmap=fmap, free_idx=free_idx,
        s0_hi=jnp.asarray(s0_hi), s0_lo=jnp.asarray(s0_lo),
        e0_hi=jnp.asarray(e0_hi), e0_lo=jnp.asarray(e0_lo),
        # runtime zeros for ops.df32.df_pin (df32.py hazard note)
        pinz=jnp.zeros(
            (max(4 * gdf.hi.n_int, 2 * n_nodes),), jnp.float32
        ),
    )
    cg_tol = cfg.cg_tol if cfg.cg_tol is not None else 2e-7
    if cfg.solver in ("cg", "mg", "ell"):
        args["free_mask"] = jnp.asarray(mesh.free)
    if cfg.solver == "ell":
        args["mg_ell"] = mg_arr_ell
        args["inv0"] = coarse_ell["inv0"]
        args["free_idx0"] = coarse_ell["free_idx0"]
        args["G_slot"], args["S_slot"] = _Ga, _Sa
    if (
        cfg.solver == "ell"
        and cfg.corr_mode == "scatter"
        and cfg.etype == ElementType.P1
    ):
        # static-structure tangent refresh (config.corr_mode): host-built
        # scatter-destination table from the exact fine-level CSR the slot
        # operator was packed from.  Runtime element order is the esort
        # permutation of the hierarchy's fine mesh — dest rows follow it.
        # Positions are GLOBAL cells of the unsharded layout; under
        # shard_devices each device shifts by its row-block offset and
        # drops out-of-slice entries (solve/newton.py corr_shard_axis).
        from ..ops import spmv as _spmv_mod3

        args["corr_dest"] = jnp.asarray(
            _spmv_mod3.element_corr_dest(
                coarse_ell["fine_K"],
                (
                    fine_op_meta0
                    if dev_mesh is not None
                    else ell["metas"][-1]["op"]
                ),
                np.asarray(mesh.elems), coarse_ell["fine_free"],
            )
        )
    if elastic_slot is not None:
        args["K_slot"] = elastic_slot[0]
    if res_metas is not None and cfg.solver != "ell":
        args["G_slot"], args["S_slot"] = _Ga, _Sa
    if cfg.support_pressure != 0.0:
        # setup-time f64 traction on host CPU, split exactly into a DF pair
        from ..ops.elements import surface_element

        edges = tunnel_wall_edges(mesh)
        with jax.default_device(jax.devices("cpu")[0]):
            f_ext64 = np.asarray(
                asm.pressure_traction_vector(
                    jnp.asarray(mesh.coords, jnp.float64),
                    jnp.asarray(edges),
                    surface_element(cfg.etype),
                    jnp.asarray(cfg.support_pressure, jnp.float64),
                    n_nodes,
                ),
                np.float64,
            )
        fh, fl = adf.split_f64_np(f_ext64)
        args["f_ext_hi"], args["f_ext_lo"] = jnp.asarray(fh), jnp.asarray(fl)
    if cfg.solver == "mg":
        # f32 hierarchy for the V-cycle preconditioner (preconditioner
        # accuracy is irrelevant to the df32 trajectory — CG measures the
        # true f32 residual and the df32 criterion measures convergence)
        assert cfg.etype == ElementType.P1, "mg solver requires P1"
        from ..solve import multigrid as mgm

        raw = np.load(_DATA)
        base_c = raw["coords"].astype(np.float32)
        base_e = raw["elems"]

        def _free_fn(cc):
            fr = np.ones((cc.shape[0], 2), dtype=bool)
            fr[np.abs(cc[:, 0]) > 49.99, 0] = False
            fr[np.abs(cc[:, 1]) > 49.99, 1] = False
            return fr

        hier = mgm.build_hierarchy(base_c, base_e, cfg.refine_levels, _free_fn)
        fmap0_np, n_free0 = asm.free_dof_map(np.asarray(hier[0].free))
        args["free_idx0"] = jnp.asarray(
            np.nonzero(np.asarray(hier[0].free).reshape(-1))[0]
        )
        from ..ops.elements import tables as _tables

        tab32 = _tables(ref)
        tab32 = type(tab32)(*[jnp.asarray(x, jnp.float32) for x in tab32])

        # HOIST the MG build: per-level geometry/smoother blocks and the
        # coarse Cholesky factor are computed once here (one jitted setup
        # program), not inside every solver dispatch — cuts stepper
        # compile time and per-chunk runtime (ROADMAP r2 #10)
        d_fn = lambda gg: elastic_tangent_lanes(shear, bulk, gg.n_int, f32)

        def _build_mg(h, t, fmap0):
            levels = mgm.build_mg_levels(h, t, d_fn)
            arrays, _ = mgm.mg_level_arrays(levels)
            lev0 = levels[0]
            K0 = asm.assemble_dense_free(
                asm.element_stiffness(lev0.geom, lev0.d),
                lev0.geom, fmap0, n_free0,
            )
            c0, _ = jax.scipy.linalg.cho_factor(K0)
            return arrays, c0

        args["mg_arrays"], args["cho0"] = jax.jit(_build_mg)(
            hier, tab32, jnp.asarray(fmap0_np)
        )
        mg_static = [
            (int(h.coords.shape[0]), n_q, int(h.elems.shape[0]))
            for h in hier
        ]

    def _run_impl(a, resume=None):
        g = adf.GeometryDF(
            hi=asm.Geometry(
                B=a["B_hi"], weight=a["w_hi"], edofs=a["edofs"],
                edofs_t=a["edofs_t"], n_nodes=n_nodes, n_q=n_q, n_real=n_real,
            ),
            B_lo=a["B_lo"], w_lo=a["w_lo"], gmap=a["gmap"],
        )
        n_int = g.hi.n_int

        # initial-stress force F0 = B^T (w * s0[:3]) in double-float (T:1737)
        bc = lambda x: jnp.broadcast_to(x[:3, None], (3, n_int))
        if res_metas is not None and cfg.solver in ("cg", "mg", "ell"):
            # assembled S operator (same sparsity as the Newton residual)
            # instead of the serialized matrix-free scatter
            from ..ops import spmv as _spmv_rt

            s0b = DF(bc(a["s0_hi"]), bc(a["s0_lo"]))
            f0h, f0l = _spmv_rt.sp_matvec_df(
                a["S_slot"], res_metas[1],
                s0b.hi.reshape(-1), s0b.lo.reshape(-1),
            )
            f0 = DF(f0h, f0l)
        else:
            f0 = adf.internal_force_df(g, DF(bc(a["s0_hi"]), bc(a["s0_lo"])))
        rhs = DF(-f0.hi, -f0.lo)
        f_ext = None
        if "f_ext_hi" in a:
            from ..ops.df32 import df_add

            f_ext = DF(a["f_ext_hi"], a["f_ext_lo"])
            rhs = df_add(rhs, f_ext)

        # elastic predictor (T:1748): K u = -F0 (+ support traction),
        # f32 inner solve (Cholesky or PCG) + df32 iterative refinement
        D = elastic_tangent_lanes(shear, bulk, n_int, f32)
        zero_u = DF(
            jnp.zeros((2 * n_nodes,), f32), jnp.zeros((2 * n_nodes,), f32)
        )
        cho = None
        mg_pre = None
        if cfg.solver == "dense":
            # the factor is needed in resumed chunks too (elastic-step
            # reuse inside the stepper); only the predictor solve is
            # statically skipped on resume
            ke = asm.element_stiffness(g.hi, D)
            K_free = asm.assemble_dense_free(ke, g.hi, a["fmap"], n_free)
            cho = jax.scipy.linalg.cho_factor(K_free)
            # explicit elastic inverse (Jacobi-scaled for f32 conditioning):
            # elastic Newton iterations become ONE matmul instead of two
            # row-serial triangular solves
            dsc = jax.lax.rsqrt(jnp.diagonal(K_free))
            Ks = K_free * dsc[:, None] * dsc[None, :]
            cho_s = jax.scipy.linalg.cho_factor(Ks)
            Ki = jax.scipy.linalg.cho_solve(
                cho_s, jnp.eye(n_free, dtype=K_free.dtype)
            )
            Ki = Ki * dsc[:, None] * dsc[None, :]
            if resume is None:
                u_elast = adf.refine_elastic_solve_df(
                    g, cho, a["free_idx"], zero_u, rhs, shear, bulk
                )
            else:
                u_elast = zero_u  # dead: resume supplies the carry
        else:
            from ..solve.cg import block_jacobi_preconditioner, solve_cg

            if cfg.solver == "mg":
                from ..solve import multigrid as mgm

                # precomputed at setup (see _build_mg above) — only the
                # arrays cross the jit boundary
                mg_levels = mgm.mg_levels_from_arrays(
                    a["mg_arrays"], mg_static
                )
                idx0 = a["free_idx0"]

                def coarse_solve(r):
                    return jnp.zeros_like(r).at[idx0].set(
                        jax.scipy.linalg.cho_solve((a["cho0"], False), r[idx0])
                    )

                mg_pre = mgm.make_vcycle(mg_levels, coarse_solve, nu=cfg.mg_nu)
                pre = mg_pre
            elif cfg.solver == "ell":
                from ..solve import multigrid as mgm

                idx0 = a["free_idx0"]

                def coarse_solve(r):
                    # explicit-inverse matmul: triangular solves are
                    # row-serial
                    return jnp.zeros_like(r).at[idx0].set(
                        a["inv0"] @ r[idx0]
                    )

                vc = mgm.make_vcycle_ell(
                    ell["metas"], coarse_solve, nu=cfg.mg_nu,
                    cycle=cfg.mg_cycle,
                )
                mg_pre = lambda r: vc(a["mg_ell"], r)
                pre = mg_pre
            else:
                blocks = asm.node_block_diagonal(g.hi, D)
                pre = block_jacobi_preconditioner(blocks, a["free_mask"])

            if elastic_slot is not None:
                from ..ops import spmv as _spmv_mod2

                K_op = lambda v: _spmv_mod2.sp_matvec(
                    a["K_slot"], elastic_slot[1], v
                )
            elif cfg.solver == "ell" and cfg.etype == ElementType.P1:
                # assembled fine hierarchy operator — the matrix-free
                # fallback made every predictor PCG iteration ~20 ms at
                # level 4 (elastic_apply_gs32 doc)
                from ..ops import spmv as _spmv_mod2

                K_op = lambda v: _spmv_mod2.sp_matvec(
                    a["mg_ell"][-1]["op"], ell["metas"][-1]["op"], v
                )
            elif res_metas is not None:
                # high-order (p-MG) / assembled-residual configs: f32
                # elastic operator through the G/S heads
                K_op = lambda v: adf.elastic_apply_gs32(
                    (a["G_slot"], res_metas[0], a["S_slot"], res_metas[1]),
                    v, shear, bulk,
                )
            else:
                K_op = lambda v: asm.tangent_matvec(g.hi, D, v)

            def solve_fn(r_hi):
                return solve_cg(
                    K_op,
                    r_hi,
                    a["free_mask"],
                    precond=pre,
                    tol=cg_tol,
                    maxiter=cfg.cg_maxiter,
                    structure=cfg.cg_structure,
                ).x

            if resume is None:
                u_elast = adf.refine_elastic_solve_with(
                    g, solve_fn, zero_u, rhs, shear, bulk,
                    iters=cfg.predictor_ir_iters,
                    # assembled K_el u for the IR residual passes — the
                    # matrix-free path was ~40% of the L4 full-solve wall
                    apply_fn=(
                        (
                            lambda u: adf.elastic_apply_slot_df(
                                (
                                    a["G_slot"], res_metas[0],
                                    a["S_slot"], res_metas[1],
                                ),
                                u, shear, bulk,
                            )
                        )
                        if res_metas is not None
                        else None
                    ),
                )
            else:
                u_elast = zero_u  # dead: resume supplies the carry

        d_zeta = df_const(cfg.d_zeta)
        from ..ops.df32 import df_barrier, df_mul

        stepper = build_load_stepper(
            g, a["free_idx"], a["fmap"], n_free, shear, bulk, eta, c,
            settings,
            e0_dir=DF(a["e0_hi"], a["e0_lo"]),
            monitor=lambda u, s: DF(u.hi[monitor_dof], u.lo[monitor_dof]),
            solver=("mg" if cfg.solver == "ell" else cfg.solver),
            cg_tol=cg_tol,
            cg_maxiter=cfg.cg_maxiter,
            cg_structure=cfg.cg_structure,
            cg_eta0=cfg.cg_eta0,
            cg_cap_relax=cfg.cg_cap_relax,
            cg_deflate=cfg.cg_deflate,
            mg_preconditioner=mg_pre,
            elastic_op=(
                # P2/P4 p-multigrid: the fine hierarchy operator is the
                # P1-lattice elastic (preconditioner only) — the tangent
                # stays the true high-order matrix-free operator
                (a["mg_ell"][-1]["op"], ell["metas"][-1]["op"])
                if cfg.solver == "ell" and cfg.etype == ElementType.P1
                else (a["K_slot"], elastic_slot[1])
                if elastic_slot is not None
                else None
            ),
            plastic_cap=plastic_cap,
            corr_dest=a.get("corr_dest"),
            corr_shard_axis=(
                _spmv_mod.OP_AXIS if dev_mesh is not None else None
            ),
            df_residual_op=(
                (a["G_slot"], res_metas[0], a["S_slot"], res_metas[1])
                if res_metas is not None else None
            ),
            # high-order assembled tangent (config.gs_tangent; None =
            # auto: ON for P2/P4 with slot-format residual operators —
            # measured P4 full schedule 0.619 vs 0.703 s matrix-free,
            # identical trajectory, 2026-08-20)
            gs_tangent=bool(cfg.gs_tangent)
            if cfg.gs_tangent is not None
            else (
                cfg.etype != ElementType.P1
                and res_metas is not None
                and isinstance(res_metas[0], _spmv_mod.SlotMeta)
            ),
            elastic_factor=("inv", Ki) if cfg.solver == "dense" else None,
            # Woodbury plastic solves: the tsx plastic set is tiny (3 of
            # ~1k points at level 0), so plastic iterations become
            # matmuls against the explicit elastic inverse (newton.py
            # smw_cap) instead of fresh assembly + Cholesky
            smw_cap=64 if cfg.solver == "dense" else None,
            precision="df32",
            pin_zeros=a["pinz"],
            accumulate_ep=not cfg.bug_compatible_ep_reset,
            f_ext_dir=f_ext,
        )
        return stepper(
            df_barrier(df_mul(u_elast, d_zeta)), 0.0, d_zeta, resume=resume
        )

    if dev_mesh is None:
        run = jax.jit(_run_impl)
    else:
        # shard_map over the whole solve: operator arrays split by row
        # blocks (shard_specs), everything else replicated.  The dispatch
        # to local-kernel + all_gather lives in ops/spmv.py (ShardedMeta);
        # the Newton control flow is replicated, so every device runs the
        # identical adaptive schedule with no host involvement.
        from jax import shard_map as _shard_map
        from jax.sharding import PartitionSpec as SpecP

        from ..solve.newton import LoadSteppingResult

        for k in ("mg_ell", "G_slot", "S_slot"):
            args[k] = _put_sharded(args[k], shard_specs[k])
        aspec = {
            k: shard_specs.get(k, jax.tree.map(lambda _: SpecP(), v))
            for k, v in args.items()
        }
        rp = SpecP()
        rdf = DF(rp, rp)
        out_specs = LoadSteppingResult(
            u=rdf, ep=rdf, zeta_hist=rp, monitor_hist=rdf, n_steps=rp,
            n_newton_total=rp, zeta=rdf, d_zeta=rdf, n_plastic=rp,
            n_cg_total=rp, u_old=rdf, u_it=rdf, d_zeta_old=rdf, aux=rp,
            # deflation ring state is replicated, like the rest of the
            # Newton control flow (mirrors footing.build_df32)
            defl=((rp, rp) if cfg.cg_deflate else None),
        )
        _plain = jax.jit(
            _shard_map(
                lambda a: _run_impl(a, None), mesh=dev_mesh,
                in_specs=(aspec,), out_specs=out_specs, check_vma=False,
            )
        )
        _resume_cache: dict = {}

        def run(a, resume=None):
            if resume is None:
                return _plain(a)
            key = tuple(sorted(dict(resume).keys()))
            if key not in _resume_cache:
                rspec = jax.tree.map(lambda _: SpecP(), dict(resume))
                _resume_cache[key] = jax.jit(
                    _shard_map(
                        _run_impl, mesh=dev_mesh,
                        in_specs=(aspec, rspec), out_specs=out_specs,
                        check_vma=False,
                    )
                )
            return _resume_cache[key](a, dict(resume))

    # dispatch-split helpers assume single-device metas (the ShardedMeta
    # V-cycle only works under shard_map)
    if extras is not None and cfg.solver in ("cg", "mg", "ell") and (
        dev_mesh is None
    ):
        from ..ops.df32 import df_barrier as _dfb
        from ..ops.df32 import df_mul as _dfm
        from ..solve.cg import block_jacobi_preconditioner, solve_cg

        def _geom(a):
            return adf.GeometryDF(
                hi=asm.Geometry(
                    B=a["B_hi"], weight=a["w_hi"], edofs=a["edofs"],
                    edofs_t=a["edofs_t"], n_nodes=n_nodes, n_q=n_q,
                    n_real=n_real,
                ),
                B_lo=a["B_lo"], w_lo=a["w_lo"], gmap=a["gmap"],
            )

        def _pre_of(a, g, D):
            if cfg.solver in ("mg", "ell"):
                from ..solve import multigrid as mgm

                idx0 = a["free_idx0"]
                if cfg.solver == "ell":
                    coarse = lambda r: jnp.zeros_like(r).at[idx0].set(
                        a["inv0"] @ r[idx0]
                    )
                    vc = mgm.make_vcycle_ell(
                        ell["metas"], coarse, nu=cfg.mg_nu,
                        cycle=cfg.mg_cycle,
                    )
                    return lambda r: vc(a["mg_ell"], r)
                coarse = lambda r: jnp.zeros_like(r).at[idx0].set(
                    jax.scipy.linalg.cho_solve((a["cho0"], False), r[idx0])
                )
                mg_levels = mgm.mg_levels_from_arrays(a["mg_arrays"], mg_static)
                return mgm.make_vcycle(mg_levels, coarse, nu=cfg.mg_nu)
            blocks = asm.node_block_diagonal(g.hi, D)
            return block_jacobi_preconditioner(blocks, a["free_mask"])

        @jax.jit
        def predict_pass(a, u_hi, u_lo):
            g = _geom(a)
            n_int = g.hi.n_int
            bc = lambda x: jnp.broadcast_to(x[:3, None], (3, n_int))
            gs_ops = None
            if res_metas is not None:
                gs_ops = (
                    a["G_slot"], res_metas[0], a["S_slot"], res_metas[1]
                )
            if gs_ops is not None:
                from ..ops import spmv as _spmv_p

                s0b = DF(bc(a["s0_hi"]), bc(a["s0_lo"]))
                f0h, f0l = _spmv_p.sp_matvec_df(
                    a["S_slot"], res_metas[1],
                    s0b.hi.reshape(-1), s0b.lo.reshape(-1),
                )
                f0 = DF(f0h, f0l)
            else:
                f0 = adf.internal_force_df(
                    g, DF(bc(a["s0_hi"]), bc(a["s0_lo"]))
                )
            rhs = DF(-f0.hi, -f0.lo)
            if "f_ext_hi" in a:
                from ..ops.df32 import df_add as _dfa

                rhs = _dfa(rhs, DF(a["f_ext_hi"], a["f_ext_lo"]))
            D = elastic_tangent_lanes(shear, bulk, n_int, f32)
            pre = _pre_of(a, g, D)
            u = DF(u_hi, u_lo)
            from ..ops.df32 import df_add as _dfa2

            ku = (
                adf.elastic_apply_slot_df(gs_ops, u, shear, bulk)
                if gs_ops is not None
                else DF(*adf.elastic_apply_df(g, u, shear, bulk))
            )
            r = _dfa2(rhs, DF(-ku.hi, -ku.lo))
            if elastic_slot is not None:
                from ..ops import spmv as _spmv_x

                K_op = lambda v: _spmv_x.sp_matvec(
                    a["K_slot"], elastic_slot[1], v
                )
            elif cfg.solver == "ell" and cfg.etype == ElementType.P1:
                from ..ops import spmv as _spmv_x

                K_op = lambda v: _spmv_x.sp_matvec(
                    a["mg_ell"][-1]["op"], ell["metas"][-1]["op"], v
                )
            elif res_metas is not None:
                K_op = lambda v: adf.elastic_apply_gs32(
                    gs_ops, v, shear, bulk
                )
            else:
                K_op = lambda v: asm.tangent_matvec(g.hi, D, v)
            du = solve_cg(
                K_op,
                r.hi, a["free_mask"], precond=pre, tol=cg_tol,
                maxiter=cfg.cg_maxiter, structure=cfg.cg_structure,
            ).x
            u = _dfa2(u, DF(du, jnp.zeros_like(du)))
            return u.hi, u.lo

        @jax.jit
        def start_carry(a, u_hi, u_lo):
            uit = _dfb(_dfm(DF(u_hi, u_lo), df_const(cfg.d_zeta)))
            return uit.hi, uit.lo

        extras["predict_pass"] = predict_pass
        extras["start_carry"] = start_carry

    return run, args, mesh


def build_df32_chunked(
    cfg: TsxTunnelConfig,
    trips_per_chunk: int = 3,
    max_chunks: int = 200,
    split_predictor: bool = False,
    predictor_ir_iters: int = 4,
):
    """Build a resume-chunked df32 executor: returns (execute, mesh).

    For checkpoint/resume of long runs: `execute()` runs the load loop
    in chunks of `trips_per_chunk` trips, carrying the FULL solver state (df32 pairs
    included) between dispatches on device via the stepper's `resume`
    path — trajectory-identical to the single-dispatch run
    (`tests/test_tsx_tunnel.py::TestDf32FastPath::test_chunked_matches_single_dispatch`).
    Repeated `execute()` calls reuse the compiled programs.
    """
    import dataclasses

    from ..solve import chunked as _chunked

    cfg2 = dataclasses.replace(cfg, max_trips=trips_per_chunk)
    extras: dict = {}
    run, args, mesh = build_df32(cfg2, extras=extras)

    def execute(checkpoint_path=None):
        """Run the chunked schedule (`solve/chunked.py`).  With
        `checkpoint_path`, an interrupted run resumes from the last
        completed chunk, even in a fresh process."""
        import jax as _jax

        initial = None
        if split_predictor:
            # the elastic predictor runs as its own per-IR-pass dispatches
            # (each a few seconds at level 5) and the stepper starts from
            # a resume carry — no dispatch ever bundles predictor + trips
            import jax.numpy as _jnp

            from ..ops.df32 import DF as _DF

            u_hi = _jnp.zeros((2 * mesh.n_nodes,), _jnp.float32)
            u_lo = _jnp.zeros_like(u_hi)
            for _ in range(predictor_ir_iters):
                u_hi, u_lo = extras["predict_pass"](args, u_hi, u_lo)
                _jax.block_until_ready(u_hi)
            uit_hi, uit_lo = extras["start_carry"](args, u_hi, u_lo)
            _jax.block_until_ready(uit_hi)
            initial = dict(
                u_it=_DF(uit_hi, uit_lo),
                u_old=_DF(-uit_hi, -uit_lo),
            )
        return _chunked.run_chunked(
            run, args,
            zeta_max=cfg.zeta_max,
            d_zeta_min=cfg.d_zeta * cfg.d_zeta_min_ratio,
            max_chunks=max_chunks,
            checkpoint_path=checkpoint_path,
            initial_resume=initial,
        )

    return execute, mesh


def run_df32_chunked(
    cfg: TsxTunnelConfig, trips_per_chunk: int = 3, max_chunks: int = 200
):
    """One-shot wrapper around `build_df32_chunked` — (res, mesh)."""
    execute, mesh = build_df32_chunked(cfg, trips_per_chunk, max_chunks)
    return execute(), mesh


def _solve_df32(cfg: TsxTunnelConfig) -> TsxResult:
    """Double-float fast path: f32 hardware, f64-grade trajectory/accuracy.

    State (U, Ep, zeta) and the Newton residual pipeline are two-f32 pairs
    (`ops/assembly_df.py`, `models/materials_df.py`); tangent solves are
    f32 Cholesky with elastic-factor reuse.  Returns f64 results assembled
    on the host from the hi/lo pairs — no f64 op enters the device
    program.
    """
    extras: dict = {}
    run, args, mesh = build_df32(cfg, extras=extras)
    res = run(args)
    return _df32_result(res, extras, cfg, mesh)


def _df32_result(res, extras: dict, cfg: TsxTunnelConfig, mesh) -> TsxResult:
    """Host conversion of a df32 LoadSteppingResult into a TsxResult."""
    f64 = lambda p: np.asarray(p.hi, np.float64) + np.asarray(p.lo, np.float64)
    u = f64(res.u).reshape(-1, 2)
    ep = f64(res.ep)
    if "ell_new_of_old" in extras:
        # restore the reference node ordering (the ell/assembled_cg
        # solvers permute the problem onto a locality ordering) and the
        # element-major integration-point ordering (locality element sort)
        u = u[extras["ell_new_of_old"]]
        esort, n_q, n_real = extras["elem_sort"]
        body = ep[..., : n_real * n_q].reshape(*ep.shape[:-1], n_real, n_q)
        restored = np.empty_like(body)
        restored[..., esort, :] = body
        ep = np.concatenate(
            [
                restored.reshape(*ep.shape[:-1], n_real * n_q),
                ep[..., n_real * n_q:],
            ],
            axis=-1,
        )
        mesh = tsx_mesh(cfg.etype, cfg.refine_levels)
    return TsxResult(
        u=u,
        ep=ep,
        zeta_hist=np.asarray(res.zeta_hist, np.float64),
        displ_hist=f64(res.monitor_hist),
        n_steps=int(res.n_steps),
        n_newton_total=int(res.n_newton_total),
        n_plastic=int(res.n_plastic),
        mesh=mesh,
        n_cg_total=int(res.n_cg_total),
    )


def solve_sharded_scale(
    cfg: Optional[TsxTunnelConfig] = None, n_devices: Optional[int] = None
) -> TsxResult:
    """Multi-chip PRODUCTION solve: the fast_scale path under shard_map.

    Unlike `solve_sharded_df32` (matrix-free CG, element-sharded
    geometry), this shards the operators that make the framework fast at
    scale: the assembled slot/ELL elastic hierarchy, the fused-sweep
    V-cycle levels, the transfer operators and the df32 G/S residual
    operators are row-partitioned over the device mesh
    (`build_df32(shard_devices=...)`, ops/spmv.py ShardedMeta).  Each
    device stores and streams only its row slice — the capacity path past
    the ~3.1 GB single-chip operator footprint at refinement level 5 —
    and the trajectory matches the single-device `fast_scale` solve.
    """
    import jax

    cfg = cfg if cfg is not None else TsxTunnelConfig.fast_scale(1)
    n = n_devices if n_devices is not None else len(jax.devices())
    extras: dict = {}
    run, args, mesh = build_df32(cfg, extras=extras, shard_devices=n)
    res = run(args)
    return _df32_result(res, extras, cfg, mesh)


def solve_sharded(
    cfg: TsxTunnelConfig = TsxTunnelConfig(),
    n_devices: Optional[int] = None,
    check_constants: bool = False,
) -> TsxResult:
    """Multi-chip tsx solve: elements sharded over the device mesh.

    The full load-stepped Newton (matrix-free CG) runs under `shard_map`;
    the only collectives are psums of nodal partials.  Produces the same
    trajectory as `solve(solver="cg")` on any device count.
    `check_constants` lowers the program first and asserts no embedded
    array constants (`utils.jitsafe`).
    """
    import jax

    from ..ops import assembly as asm
    from ..ops.elements import tables, volume_element
    from ..parallel import sharding as shd
    from ..solve.newton import NewtonSettings, build_load_stepper
    from .materials import (
        drucker_prager_fit,
        elastic_tangent_lanes,
        lame_moduli,
    )

    mesh = tsx_mesh(cfg.etype, cfg.refine_levels)
    dtype = jnp.dtype(cfg.dtype)
    shear, bulk = lame_moduli(cfg.young, cfg.poisson)
    eta, c = drucker_prager_fit(cfg.cohesion, cfg.friction_angle)
    s0, e0 = initial_state(cfg)

    ref = volume_element(cfg.etype)
    fmap_np, n_free = asm.free_dof_map(mesh.free)
    free_idx = jnp.asarray(np.nonzero(mesh.free.reshape(-1))[0])
    fmap = jnp.asarray(fmap_np)

    dev_mesh = shd.make_device_mesh(n_devices)
    coords = jnp.asarray(mesh.coords, dtype)
    geom = shd.sharded_geometry(coords, mesh.elems, ref, dev_mesh)

    settings = NewtonSettings(
        maxit=cfg.newton_maxit,
        newton_tol=cfg.newton_tol,
        accept_tol=cfg.accept_tol,
        d_zeta_min=cfg.d_zeta * cfg.d_zeta_min_ratio,
        zeta_max=cfg.zeta_max,
        max_steps=cfg.max_steps,
        step0=0,
        max_trips=cfg.max_trips,
    )
    monitor_dof = 2 * cfg.monitor_node

    def build_fn(local_geom, axis, free_idx_a, fmap_a, e0_a):
        return build_load_stepper(
            local_geom, free_idx_a, fmap_a, n_free, shear, bulk, eta, c,
            settings,
            e0_dir=e0_a,
            monitor=lambda u, s: u[monitor_dof],
            solver="cg",
            axis_name=axis,
        )

    run_sharded = shd.sharded_stepper(dev_mesh, geom, build_fn)
    n_nodes = mesh.n_nodes
    # geometry arrays are jit ARGUMENTS (utils/jitsafe.py) — their
    # NamedShardings ride through the jit boundary unchanged
    args = dict(
        garr=shd.geometry_args(geom),
        fmap=fmap, free_idx=free_idx,
        s0=jnp.asarray(s0, dtype), e0=jnp.asarray(e0, dtype),
    )

    @jax.jit
    def run(a):
        g = asm.Geometry(
            B=a["garr"]["B"], weight=a["garr"]["weight"],
            edofs=a["garr"]["edofs"], edofs_t=a["garr"]["edofs_t"],
            n_nodes=geom.n_nodes, n_q=geom.n_q, n_real=geom.n_real,
        )
        # elastic predictor: replicated dense solve (small), sharded force
        D = elastic_tangent_lanes(shear, bulk, g.n_int, dtype)
        s0_field = jnp.broadcast_to(a["s0"][:3, None], (3, g.n_int))
        f0 = asm.internal_force(g, s0_field)
        ke = asm.element_stiffness(g, D)
        K_free = asm.assemble_dense_free(ke, g, a["fmap"], n_free)
        cho = jax.scipy.linalg.cho_factor(K_free)
        u_el_free = jax.scipy.linalg.cho_solve(cho, -f0[a["free_idx"]])
        u_elast = (
            jnp.zeros((2 * n_nodes,), dtype).at[a["free_idx"]].set(u_el_free)
        )
        return run_sharded(
            a["garr"], cfg.d_zeta * u_elast, 0.0, cfg.d_zeta,
            a["free_idx"], a["fmap"], a["e0"],
        )

    if check_constants:
        from ..utils.jitsafe import assert_no_embedded_constants

        assert_no_embedded_constants(run, (args,))
    res = run(args)
    return TsxResult(
        u=res.u.reshape(-1, 2),
        ep=res.ep,
        zeta_hist=res.zeta_hist,
        displ_hist=res.monitor_hist,
        n_steps=int(res.n_steps),
        n_newton_total=int(res.n_newton_total),
        n_plastic=int(res.n_plastic),
        mesh=mesh,
        n_cg_total=int(res.n_cg_total),
    )


def solve_sharded_df32(
    cfg: Optional[TsxTunnelConfig] = None,
    n_devices: Optional[int] = None,
    check_constants: bool = False,
) -> TsxResult:
    """Multi-chip df32 tsx solve: the fast path sharded over a device mesh.

    Combines the two production modes: elements sharded over the mesh
    (like `solve_sharded`) AND the double-float residual/criterion/state
    (like `build_df32`).  The per-shard internal-force partials are
    combined with the exact compensated all-reduce
    (`ops.df32.df_allreduce` — all-gather + df_add fold; a plain psum of
    hi/lo would break the ~1e-14 floor), so the sharded trajectory
    matches the single-device df32 cg solve.  Every geometry array
    (sharded and replicated) crosses the jit boundary as an argument
    (utils/jitsafe.py).
    """
    import jax

    from ..ops import assembly as asm
    from ..ops import assembly_df as adf
    from ..ops.df32 import DF, df_barrier, df_const, df_mul
    from ..ops.elements import volume_element
    from ..parallel import sharding as shd
    from ..solve.cg import block_jacobi_preconditioner, solve_cg
    from ..solve.newton import NewtonSettings, build_load_stepper
    from .materials import drucker_prager_fit, elastic_tangent_lanes, lame_moduli

    cfg = cfg if cfg is not None else TsxTunnelConfig.fast(solver="cg")
    assert cfg.precision == "df32" and cfg.solver == "cg", (
        cfg.precision, cfg.solver,
    )
    mesh = tsx_mesh(cfg.etype, cfg.refine_levels)
    shear, bulk = lame_moduli(cfg.young, cfg.poisson)
    eta, c = drucker_prager_fit(cfg.cohesion, cfg.friction_angle)
    s0, e0 = initial_state(cfg)
    ref = volume_element(cfg.etype)
    fmap_np, n_free = asm.free_dof_map(mesh.free)
    free_idx = jnp.asarray(np.nonzero(np.asarray(mesh.free).reshape(-1))[0])
    fmap = jnp.asarray(fmap_np)
    n_nodes = mesh.n_nodes
    f32 = jnp.float32
    cg_tol = cfg.cg_tol if cfg.cg_tol is not None else 2e-7

    dev_mesh = shd.make_device_mesh(n_devices)
    gdf_sh, _ = shd.sharded_geometry_df(
        np.asarray(mesh.coords), np.asarray(mesh.elems), ref, dev_mesh
    )
    # replicated global geometry for the one-time elastic predictor
    gdf_g = adf.geometry_df(mesh.coords, mesh.elems, ref)

    settings = NewtonSettings(
        maxit=cfg.newton_maxit,
        newton_tol=cfg.newton_tol,
        accept_tol=cfg.accept_tol,
        d_zeta_min=cfg.d_zeta * cfg.d_zeta_min_ratio,
        zeta_max=cfg.zeta_max,
        max_steps=cfg.max_steps,
        step0=0,
        max_trips=cfg.max_trips,
    )
    monitor_dof = 2 * cfg.monitor_node

    def build_fn(local_gdf, axis, free_idx_a, fmap_a, e0h, e0l, pinz):
        return build_load_stepper(
            local_gdf, free_idx_a, fmap_a, n_free, shear, bulk, eta, c,
            settings,
            e0_dir=DF(e0h, e0l),
            monitor=lambda u, s: DF(u.hi[monitor_dof], u.lo[monitor_dof]),
            solver="cg",
            cg_tol=cg_tol,
            cg_maxiter=cfg.cg_maxiter,
            cg_structure=cfg.cg_structure,
            axis_name=axis,
            precision="df32",
            pin_zeros=pinz,
            accumulate_ep=not cfg.bug_compatible_ep_reset,
        )

    run_sharded = shd.sharded_stepper_df(dev_mesh, gdf_sh, build_fn)

    s0_hi, s0_lo = adf.split_f64_np(s0)
    e0_hi, e0_lo = adf.split_f64_np(e0)
    args = dict(
        B_hi=gdf_g.hi.B, w_hi=gdf_g.hi.weight,
        edofs=gdf_g.hi.edofs, edofs_t=gdf_g.hi.edofs_t,
        B_lo=gdf_g.B_lo, w_lo=gdf_g.w_lo, gmap=gdf_g.gmap,
        garr_sh=shd.geometry_args_df(gdf_sh),
        fmap=fmap, free_idx=free_idx,
        s0_hi=jnp.asarray(s0_hi), s0_lo=jnp.asarray(s0_lo),
        e0_hi=jnp.asarray(e0_hi), e0_lo=jnp.asarray(e0_lo),
        free_mask=jnp.asarray(mesh.free),
        pinz=jnp.zeros(
            (max(4 * gdf_sh.hi.n_int, 2 * n_nodes),), f32
        ),
    )

    @jax.jit
    def run(a):
        g = adf.GeometryDF(
            hi=asm.Geometry(
                B=a["B_hi"], weight=a["w_hi"], edofs=a["edofs"],
                edofs_t=a["edofs_t"], n_nodes=n_nodes,
                n_q=gdf_g.hi.n_q, n_real=gdf_g.hi.n_real,
            ),
            B_lo=a["B_lo"], w_lo=a["w_lo"], gmap=a["gmap"],
        )
        n_int = g.hi.n_int
        bc = lambda x: jnp.broadcast_to(x[:3, None], (3, n_int))
        f0 = adf.internal_force_df(g, DF(bc(a["s0_hi"]), bc(a["s0_lo"])))
        rhs = DF(-f0.hi, -f0.lo)
        D = elastic_tangent_lanes(shear, bulk, n_int, f32)
        blocks = asm.node_block_diagonal(g.hi, D)
        pre = block_jacobi_preconditioner(blocks, a["free_mask"])

        def solve_fn(r_hi):
            return solve_cg(
                lambda v: asm.tangent_matvec(g.hi, D, v),
                r_hi, a["free_mask"], precond=pre, tol=cg_tol,
                maxiter=cfg.cg_maxiter, structure=cfg.cg_structure,
            ).x

        zero_u = DF(
            jnp.zeros((2 * n_nodes,), f32), jnp.zeros((2 * n_nodes,), f32)
        )
        u_elast = adf.refine_elastic_solve_with(
            g, solve_fn, zero_u, rhs, shear, bulk
        )
        d_zeta = df_const(cfg.d_zeta)
        return run_sharded(
            a["garr_sh"], df_barrier(df_mul(u_elast, d_zeta)), 0.0, d_zeta,
            a["free_idx"], a["fmap"], a["e0_hi"], a["e0_lo"], a["pinz"],
        )

    if check_constants:
        from ..utils.jitsafe import assert_no_embedded_constants

        assert_no_embedded_constants(run, (args,))
    res = run(args)
    f64 = lambda p: np.asarray(p.hi, np.float64) + np.asarray(p.lo, np.float64)
    return TsxResult(
        u=f64(res.u).reshape(-1, 2),
        ep=f64(res.ep),
        zeta_hist=np.asarray(res.zeta_hist, np.float64),
        displ_hist=f64(res.monitor_hist),
        n_steps=int(res.n_steps),
        n_newton_total=int(res.n_newton_total),
        n_plastic=int(res.n_plastic),
        mesh=mesh,
        n_cg_total=int(res.n_cg_total),
    )
