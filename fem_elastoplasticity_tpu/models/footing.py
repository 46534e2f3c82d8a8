"""Drucker-Prager strip footing (benchmark B).

Parity target: `Plasticity2D_DP/pythonFEM.py:901-1157`.  A rigid footing
(inhomogeneous Dirichlet on the top edge, x <= 1.0001) is pushed into a
near-incompressible (nu = 0.48) elastoplastic half-space; the load factor
ramps adaptively with the pressure-based d_zeta doubling rule
(P:1109-1110).  Anchors (SURVEY.md §8.4): 17 accepted steps to zeta = 1,
terminating with "maximal load factor".
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..mesh.structured import Mesh, square_mesh
from ..ops import assembly as asm
from ..ops.elements import volume_element
from ..solve.newton import NewtonSettings, build_load_stepper
from ..ops.elements import tables
from .config import FootingConfig
from .tsx_tunnel import _elastic_factor
from .materials import drucker_prager_fit, elastic_tangent_lanes, lame_moduli


class FootingResult(NamedTuple):
    u: jnp.ndarray  # (n_n, 2)
    ep: jnp.ndarray
    zeta_hist: jnp.ndarray
    pressure_hist: jnp.ndarray  # normalized mean footing pressure (P:1105-1107)
    n_steps: int
    n_newton_total: int
    n_plastic: int
    mesh: Mesh
    n_cg_total: int = 0  # cumulative CG iterations (0 on the dense path)


def build_mesh(cfg: FootingConfig) -> Mesh:
    """Footing mesh + BCs (`Plasticity2D_DP/pythonFEM.py:175-184`)."""
    mesh = square_mesh(cfg.level, cfg.etype, cfg.size_xy)
    coords = mesh.coords
    footing = (coords[:, 1] == cfg.size_xy) & (coords[:, 0] <= 1.0001)
    dirichlet = np.zeros((mesh.n_nodes, 2))
    dirichlet[footing, 1] = 1.0
    free = coords > 0.0
    free[footing, 1] = False
    free[coords[:, 0] == cfg.size_xy, 0] = False
    mesh.dirichlet = dirichlet
    mesh.free = free
    return mesh


def solve(cfg: FootingConfig = FootingConfig()) -> FootingResult:
    """Run the footing benchmark.

    cfg.precision == "df32" runs the double-float fast path (f32 hardware,
    f64-grade stopping behavior — see solve/newton.py docstring).
    """
    if cfg.precision == "df32":
        return _solve_df32(cfg)
    mesh = build_mesh(cfg)
    dtype = jnp.dtype(cfg.dtype)
    shear, bulk = lame_moduli(cfg.young, cfg.poisson)
    eta, c = drucker_prager_fit(cfg.cohesion, cfg.friction_angle)

    ref = volume_element(cfg.etype)
    fmap_np, n_free = asm.free_dof_map(mesh.free)
    free_idx = jnp.asarray(np.nonzero(mesh.free.reshape(-1))[0])
    fmap = jnp.asarray(fmap_np)

    coords = jnp.asarray(mesh.coords, dtype)
    elems = jnp.asarray(mesh.elems)
    dirichlet_flat = jnp.asarray(mesh.dirichlet.reshape(-1), dtype)
    footing_nodes = jnp.asarray(mesh.dirichlet[:, 1] > 0)
    n_footing = int((mesh.dirichlet[:, 1] > 0).sum())

    settings = NewtonSettings(
        maxit=cfg.newton_maxit,
        newton_tol=cfg.newton_tol,
        accept_tol=cfg.accept_tol,
        d_zeta_min=cfg.d_zeta * cfg.d_zeta_min_ratio,
        zeta_max=cfg.zeta_max,
        max_steps=cfg.max_steps,
        step0=1,  # reference starts its history at index 1 (P:1025)
    )

    # all arrays pass through the jit boundary (utils/jitsafe.py)
    args = dict(
        coords=coords, elems=elems, tab=tables(ref), fmap=fmap,
        free_idx=free_idx, dirichlet=dirichlet_flat, footing=footing_nodes,
    )
    n_nodes = mesh.n_nodes

    cg_tol = cfg.cg_tol if cfg.cg_tol is not None else (
        2e-7 if dtype == jnp.float32 else 1e-14
    )

    @jax.jit
    def run(a):
        geom = asm.compute_geometry(a["coords"], a["elems"], a["tab"])

        # elastic predictor with inhomogeneous Dirichlet (P:996-1004):
        # Ud = -d_zeta * dirichlet; K u = -K Ud on free DOFs
        ud = -cfg.d_zeta * a["dirichlet"]
        D = elastic_tangent_lanes(shear, bulk, geom.n_int, dtype)
        f = -asm.tangent_matvec(geom, D, ud)
        cho = None
        if cfg.solver == "dense":
            ke = asm.element_stiffness(geom, D)
            K_free = asm.assemble_dense_free(ke, geom, a["fmap"], n_free)
            cho = jax.scipy.linalg.cho_factor(K_free)
            u_free = jax.scipy.linalg.cho_solve(cho, f[a["free_idx"]])
            U_it0 = ud.at[a["free_idx"]].set(u_free)
        else:
            # matrix-free predictor with the Dirichlet lift: U = ud + u,
            # K u = -K ud on free DOFs (u zero on constrained)
            from ..solve.cg import block_jacobi_preconditioner, solve_cg

            fmask = (
                jnp.zeros((2 * n_nodes,), bool).at[a["free_idx"]].set(True)
            )
            blocks = asm.node_block_diagonal(geom, D)
            pre = block_jacobi_preconditioner(blocks, fmask.reshape(-1, 2))
            u = solve_cg(
                lambda v: asm.tangent_matvec(geom, D, v),
                f,
                fmask,
                precond=pre,
                tol=cg_tol,
                maxiter=cfg.cg_maxiter,
                structure=cfg.cg_structure,
            ).x
            U_it0 = ud + u

        def monitor(u, s):
            # normalized mean footing pressure: -mean over footing nodes of
            # the nodal projection of s_yy, / cohesion (P:1105-1107)
            p_node = asm.project_to_nodes(geom, s[1])
            return -jnp.sum(jnp.where(a["footing"], p_node, 0.0)) / (
                n_footing * cfg.cohesion
            )

        def accept_hook(pressure, pressure_old, crit):
            # double d_zeta while the pressure curve is still steep-free
            # and Newton converged tightly (P:1109-1110)
            factor = jnp.where(
                (pressure - pressure_old < 0.1) & (crit < cfg.newton_tol), 2.0, 1.0
            )
            return pressure, factor

        stepper = build_load_stepper(
            geom, a["free_idx"], a["fmap"], n_free, shear, bulk, eta, c,
            settings, e0_dir=None, monitor=monitor, accept_hook=accept_hook,
            solver=cfg.solver, apex_ep_uses_trial=cfg.bug_compatible_apex,
            dense_mode=cfg.dense_mode,
            cg_tol=cg_tol,
            cg_maxiter=cfg.cg_maxiter,
            cg_structure=cfg.cg_structure,
            cg_cap_relax=cfg.cg_cap_relax,
            cg_deflate=(cfg.cg_deflate if cfg.solver == "cg" else 0),
            newton_damping=cfg.newton_damping,
            elastic_factor=(
                _elastic_factor(cho, dtype)
                if cfg.solver == "dense"
                else None
            ),
        )
        return stepper(U_it0, 0.0, cfg.d_zeta)

    res = run(args)
    return FootingResult(
        u=res.u.reshape(-1, 2),
        ep=res.ep,
        zeta_hist=res.zeta_hist,
        pressure_hist=res.monitor_hist,
        n_steps=int(res.n_steps) - 1,  # step counter started at 1
        n_newton_total=int(res.n_newton_total),
        n_plastic=int(res.n_plastic),
        mesh=mesh,
        n_cg_total=int(res.n_cg_total),
    )


def build_df32(cfg: FootingConfig, shard_devices=None):
    """Build the jitted df32 footing solver: returns (run, args, mesh).

    Mirrors `models.tsx_tunnel.build_df32`; the footing's inhomogeneous
    Dirichlet load rides the df32 state (the warm-start extrapolation sets
    the constrained DOFs exactly since they are linear in zeta).
    `run(a, resume=None)` supports the stepper's exact resume carry
    (chunked/checkpointed execution, `build_df32_chunked`).

    `shard_devices` (tangent_mg only): run the footing's PRODUCTION
    scale solver multi-chip — the elastic hierarchy, the transfer
    operators and the df32 G/S residual operators are row-partitioned
    over a 1D device mesh and the whole adaptive solve executes under
    `shard_map` (`ops.spmv.ShardedMeta`).  The per-Newton-iteration
    tangent refresh runs replicated and each device slices its
    superblock range (`solve.multigrid.tangent_vcycle` sharded doc), so
    the trajectory matches the single-device tangent-MG solve: bitwise
    on the CPU test mesh (tests/test_parallel.py), to ~1e-13 on GPUs
    (nondeterministic scatter-add order)."""
    import jax

    from ..ops import assembly as asm
    from ..ops import assembly_df as adf
    from ..ops.df32 import DF, df_const, df_mul, df_pin
    from ..ops.elements import tables, volume_element
    from ..solve.newton import NewtonSettings, build_load_stepper
    from .materials import drucker_prager_fit, elastic_tangent_lanes, lame_moduli

    assert cfg.solver in ("dense", "cg"), cfg.solver
    mesh = build_mesh(cfg)
    shear, bulk = lame_moduli(cfg.young, cfg.poisson)
    eta, c = drucker_prager_fit(cfg.cohesion, cfg.friction_angle)
    ref = volume_element(cfg.etype)

    K_slot = None
    tmg = None
    if cfg.tangent_mg:
        # TRUE tangent multigrid (config.tangent_mg): build the elastic
        # hierarchy once (red refinement of the level-1 mesh, fine-RCM
        # ordering) + the per-level tangent-refresh extras, and run the
        # problem on the hierarchy's fine mesh
        assert cfg.solver == "cg" and not cfg.assembled_cg
        from ..mesh.structured import Mesh as _Mesh
        from ..mesh.structured import square_mesh as _square_mesh
        from ..solve import multigrid as _mgm

        assert cfg.level >= 2, "tangent_mg needs at least one refinement"
        base = _square_mesh(1, cfg.etype, cfg.size_xy)

        def _free_fn(cc):
            footing_m = (cc[:, 1] == cfg.size_xy) & (cc[:, 0] <= 1.0001)
            fr = cc > 0.0
            fr[footing_m, 1] = False
            fr[cc[:, 0] == cfg.size_xy, 0] = False
            return fr

        mg_arr, mg_metas, _perms, mg_coarse = _mgm.build_hierarchy_ell(
            np.asarray(base.coords, np.float64), np.asarray(base.elems),
            cfg.level - 1, _free_fn, shear, bulk, ref,
            fmt="slot", pack_bf16=False, collect_levels=True,
        )
        tmg_arrays, tmg_static = _mgm.build_tangent_hierarchy(
            mg_metas, mg_coarse, ref
        )
        fine = mg_coarse["levels"][-1]
        coords2 = np.asarray(fine["coords"], np.float64)
        elems2 = np.asarray(fine["elems"])
        free2 = np.asarray(fine["free"])
        footing_m = (coords2[:, 1] == cfg.size_xy) & (
            coords2[:, 0] <= 1.0001
        )
        dirichlet2 = np.zeros((coords2.shape[0], 2))
        dirichlet2[footing_m, 1] = 1.0
        mesh = _Mesh(
            coords2, elems2, cfg.etype, dirichlet=dirichlet2, free=free2
        )
        tmg = dict(
            metas=mg_metas, hier=mg_arr,
            tmg_arrays=tmg_arrays, tmg_static=tmg_static,
            inv0=mg_coarse["inv0"], free_idx0=mg_coarse["free_idx0"],
        )
    if cfg.assembled_cg:
        # assembled full-tangent CG (config.assembled_cg): RCM locality
        # ordering, host-assembled elastic slot operator + the scatter
        # destination table for the per-Newton-iteration value refresh
        assert cfg.solver == "cg", "assembled_cg needs solver='cg'"
        from ..mesh.structured import Mesh as _Mesh
        from ..ops import spmv as _spmv_mod

        order = _spmv_mod.rcm_node_order(
            np.asarray(mesh.elems), mesh.n_nodes
        )
        coords2, elems2, new_of_old = _spmv_mod.permute_mesh(
            np.asarray(mesh.coords, np.float64), np.asarray(mesh.elems),
            order,
        )
        esort = np.argsort(elems2.min(axis=1), kind="stable")
        elems2 = elems2[esort]
        free2 = np.asarray(mesh.free)[order]
        dirichlet2 = np.asarray(mesh.dirichlet)[order]
        mesh = _Mesh(
            coords2, elems2, cfg.etype, dirichlet=dirichlet2, free=free2
        )
        _Ka, _Km, _K_csr = _spmv_mod.build_ell_elastic(
            coords2, elems2, ref, shear, bulk, free=free2, fmt="slot"
        )
        _corr_np = _spmv_mod.element_corr_dest(_K_csr, _Km, elems2, free2)
        K_slot = (_Ka, _Km)

    fmap_np, n_free = asm.free_dof_map(mesh.free)
    free_idx = jnp.asarray(np.nonzero(mesh.free.reshape(-1))[0])
    fmap = jnp.asarray(fmap_np)
    gdf = adf.geometry_df(mesh.coords, mesh.elems, ref)
    res_metas = None
    if cfg.solver == "cg" and (tmg is not None or K_slot is not None):
        # assembled df32 strain/force operators for the Newton residual
        # (ops/spmv.py build_residual_slot_df) — the scale paths run on a
        # locality-ordered mesh (hierarchy chain / RCM), so the slot
        # blocks stay compact and the residual skips the matrix-free df32
        # gather/scatter path
        from ..ops import spmv as _spmv_res

        # P1 defaults to the dense slot layout: same format single- and
        # multi-chip (row sharding needs it), so the sharded trajectory
        # stays BIT-identical; higher orders keep the ragged auto layout
        _res_fmt = cfg.residual_fmt or (
            "slot" if gdf.hi.n_q == 1 else "rslot"
        )
        _Ga, _Gm, _Sa, _Sm = _spmv_res.build_residual_slot_df(
            gdf, fmt=_res_fmt
        )
        res_metas = (_Gm, _Sm)
    dev_mesh = None
    if shard_devices is not None:
        # multi-chip production path (docstring): row-shard the hierarchy
        # and the df32 residual operators, keep a replicated fine elastic
        # stream for the tangent refresh, build the shard_map spec trees
        assert tmg is not None, "shard_devices requires tangent_mg"
        from jax.sharding import NamedSharding
        from jax.sharding import PartitionSpec as SpecP

        from ..ops import spmv as _spmv_sh
        from ..parallel.sharding import make_device_mesh
        from ..solve import multigrid as _mgm_sh

        n_dev = int(shard_devices)
        dev_mesh = make_device_mesh(n_dev, _spmv_sh.OP_AXIS)
        # row-shard the tangent-refresh Mhat chain: the
        # fine scatter lands on each device's local hierarchy slice and
        # the coarse value maps run as sharded slot matvecs — no
        # replicated fine elastic copy (tangent_vcycle sharded doc)
        mh_arrs, mh_metas, mh_specs = [], [], []
        for Ma, Mm in zip(
            tmg["tmg_arrays"]["mhat"], tmg["tmg_static"]["mhat_metas"]
        ):
            a2, m2, sp2 = _spmv_sh.shard_rows(Ma, Mm, n_dev)
            mh_arrs.append(a2)
            mh_metas.append(m2)
            mh_specs.append(sp2)
        tmg["tmg_arrays"] = dict(tmg["tmg_arrays"], mhat=mh_arrs)
        tmg["tmg_static"] = dict(
            tmg["tmg_static"], mhat_metas=tuple(mh_metas)
        )
        if getattr(_Gm, "n_ch", 0) or getattr(_Sm, "n_ch", 0):
            # row sharding needs the dense slot layout; uniform-P1
            # operators normally fall back to it anyway (rslot doc)
            from ..ops import spmv as _spmv_res2

            _Ga, _Gm, _Sa, _Sm = _spmv_res2.build_residual_slot_df(
                gdf, fmt="slot"
            )
        hier_sh, metas_sh, mg_specs = _mgm_sh.shard_hierarchy_ell(
            tmg["hier"], tmg["metas"], n_dev
        )
        tmg["hier"], tmg["metas"] = hier_sh, metas_sh
        _Ga, _Gm, g_specs = _spmv_sh.shard_rows(_Ga, _Gm, n_dev)
        _Sa, _Sm, s_specs = _spmv_sh.shard_rows(_Sa, _Sm, n_dev)
        res_metas = (_Gm, _Sm)
        from jax.sharding import PartitionSpec as _SpecP

        tmg_spec = jax.tree.map(
            lambda _: _SpecP(), dict(tmg["tmg_arrays"])
        )
        tmg_spec["mhat"] = mh_specs
        shard_specs = dict(
            mg_hier=mg_specs, G_slot=g_specs, S_slot=s_specs, tmg=tmg_spec
        )

        def _put_sharded(tree, spec_tree):
            return jax.tree.map(
                lambda x, s: jax.device_put(x, NamedSharding(dev_mesh, s)),
                tree, spec_tree,
            )
    if K_slot is not None:
        # the runtime geometry pads elements to a lane multiple; padded
        # slots have zero B/weight (zero stiffness entries), dest -1
        # keeps the scatter aligned and drops them
        _n_pad_e = gdf.hi.n_int // gdf.hi.n_q
        if _corr_np.shape[0] < _n_pad_e:
            _corr_np = np.concatenate(
                [
                    _corr_np,
                    np.full(
                        (_n_pad_e - _corr_np.shape[0],) + _corr_np.shape[1:],
                        -1, _corr_np.dtype,
                    ),
                ],
                axis=0,
            )
        _corr_dest = jnp.asarray(_corr_np)
    n_nodes, n_q, n_real = mesh.n_nodes, gdf.hi.n_q, gdf.hi.n_real
    f32 = jnp.float32

    footing_nodes = jnp.asarray(mesh.dirichlet[:, 1] > 0)
    n_footing = int((mesh.dirichlet[:, 1] > 0).sum())
    # f32 PCG floor (the df32 residual/criterion still deliver the f64
    # stopping behavior — inexact Newton)
    cg_tol = cfg.cg_tol if cfg.cg_tol is not None else 2e-7

    settings = NewtonSettings(
        maxit=cfg.newton_maxit,
        newton_tol=cfg.newton_tol,
        accept_tol=cfg.accept_tol,
        d_zeta_min=cfg.d_zeta * cfg.d_zeta_min_ratio,
        zeta_max=cfg.zeta_max,
        max_steps=cfg.max_steps,
        step0=1,  # reference starts its history at index 1 (P:1025)
        max_trips=cfg.max_trips,
    )

    args = dict(
        B_hi=gdf.hi.B, w_hi=gdf.hi.weight,
        edofs=gdf.hi.edofs, edofs_t=gdf.hi.edofs_t,
        B_lo=gdf.B_lo, w_lo=gdf.w_lo, gmap=gdf.gmap,
        fmap=fmap, free_idx=free_idx,
        dirichlet=jnp.asarray(mesh.dirichlet.reshape(-1), f32),
        footing=footing_nodes,
        pinz=jnp.zeros((max(4 * gdf.hi.n_int, 2 * n_nodes),), f32),
    )
    if K_slot is not None:
        args["K_slot"] = K_slot[0]
        args["corr_dest"] = _corr_dest
    if res_metas is not None:
        args["G_slot"], args["S_slot"] = _Ga, _Sa
    if tmg is not None:
        args["mg_hier"] = tmg["hier"]
        args["tmg"] = tmg["tmg_arrays"]
        args["inv0"] = tmg["inv0"]
        args["free_idx0"] = tmg["free_idx0"]

    def _run_impl(a, resume=None):
        g = adf.GeometryDF(
            hi=asm.Geometry(
                B=a["B_hi"], weight=a["w_hi"], edofs=a["edofs"],
                edofs_t=a["edofs_t"], n_nodes=n_nodes, n_q=n_q, n_real=n_real,
            ),
            B_lo=a["B_lo"], w_lo=a["w_lo"], gmap=a["gmap"],
        )
        n_int = g.hi.n_int

        # elastic predictor with inhomogeneous Dirichlet (P:996-1004):
        # ud = -d_zeta * dirichlet exactly (dirichlet is a 0/1 pattern);
        # solve K u = 0 on free DOFs with u = ud elsewhere, df32-accurate.
        d_zeta = df_const(cfg.d_zeta)
        dir_df = DF(a["dirichlet"], jnp.zeros_like(a["dirichlet"]))
        ud = df_mul(dir_df, DF(-d_zeta.hi, -d_zeta.lo))
        D = elastic_tangent_lanes(shear, bulk, n_int, f32)
        zero_f = DF(
            jnp.zeros((2 * n_nodes,), f32), jnp.zeros((2 * n_nodes,), f32)
        )
        Ki = None
        if cfg.solver == "dense":
            ke = asm.element_stiffness(g.hi, D)
            K_free = asm.assemble_dense_free(ke, g.hi, a["fmap"], n_free)
            cho = jax.scipy.linalg.cho_factor(K_free)
            # explicit Jacobi-scaled elastic inverse: elastic Newton
            # iterations as one matmul (models/tsx_tunnel.py build_df32)
            dsc = jax.lax.rsqrt(jnp.diagonal(K_free))
            Ks = K_free * dsc[:, None] * dsc[None, :]
            Ki = jax.scipy.linalg.cho_solve(
                jax.scipy.linalg.cho_factor(Ks), jnp.eye(n_free, dtype=f32)
            )
            Ki = Ki * dsc[:, None] * dsc[None, :]
            U_it0 = adf.refine_elastic_solve_df(
                g, cho, a["free_idx"], ud, zero_f, shear, bulk
            )
        else:
            # matrix-free df32 predictor with the Dirichlet lift: the
            # initial iterate is U = ud (exact on constrained DOFs); df32
            # iterative refinement drives K U -> 0 on the free subspace
            # with f32 block-Jacobi PCG inner solves (ROADMAP r2 #9)
            from ..solve.cg import block_jacobi_preconditioner, solve_cg

            fmask = (
                jnp.zeros((2 * n_nodes,), bool).at[a["free_idx"]].set(True)
            )
            if tmg is not None:
                # elastic predictor: static elastic hierarchy V-cycle +
                # assembled fine elastic operator
                from ..ops import spmv as _spmv_rt
                from ..solve import multigrid as _mgm_rt

                idx0 = a["free_idx0"]
                coarse0 = lambda r: jnp.zeros_like(r).at[idx0].set(
                    a["inv0"] @ r[idx0]
                )
                vc_el = _mgm_rt.make_vcycle_ell(tmg["metas"], coarse0)
                pre = lambda r: vc_el(a["mg_hier"], r)
                K_op = lambda v: _spmv_rt.sp_matvec(
                    a["mg_hier"][-1]["op"], tmg["metas"][-1]["op"], v
                )
            else:
                blocks = asm.node_block_diagonal(g.hi, D)
                pre = block_jacobi_preconditioner(
                    blocks, fmask.reshape(-1, 2)
                )
                if K_slot is not None:
                    from ..ops import spmv as _spmv_rt

                    K_op = lambda v: _spmv_rt.sp_matvec(
                        a["K_slot"], K_slot[1], v
                    )
                else:
                    K_op = lambda v: asm.tangent_matvec(g.hi, D, v)

            def solve_fn(r_hi):
                return solve_cg(
                    K_op,
                    r_hi, fmask, precond=pre, tol=cg_tol,
                    maxiter=cfg.cg_maxiter, structure=cfg.cg_structure,
                ).x

            U_it0 = adf.refine_elastic_solve_with(
                g, solve_fn, ud, zero_f, shear, bulk,
                # assembled K_el u for the IR residual passes when the
                # G/S slot operators exist (mirrors tsx build_df32)
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

        def monitor(u, s):
            # normalized mean footing pressure (P:1105-1107), f32 head
            p_node = asm.project_to_nodes(g.hi, s.hi[1])
            p = -jnp.sum(jnp.where(a["footing"], p_node, 0.0)) / (
                n_footing * cfg.cohesion
            )
            return DF(p, jnp.zeros_like(p))

        def accept_hook(pressure, pressure_old, crit):
            factor = jnp.where(
                (pressure - pressure_old < 0.1) & (crit < cfg.newton_tol),
                jnp.asarray(2.0, f32),
                jnp.asarray(1.0, f32),
            )
            return pressure, factor

        stepper = build_load_stepper(
            g, a["free_idx"], a["fmap"], n_free, shear, bulk, eta, c,
            settings,
            e0_dir=None,
            monitor=monitor,
            accept_hook=accept_hook,
            solver=cfg.solver,
            cg_tol=cg_tol,
            cg_maxiter=cfg.cg_maxiter,
            cg_structure=cfg.cg_structure,
            cg_eta0=cfg.cg_eta0,
            # tangent_mg runs brush the CG cap near the limit load; the
            # strict policy fragmented the round-3 L4 schedule to 469
            # steps (config.cg_cap_relax doc)
            cg_cap_relax=(
                cfg.cg_cap_relax
                if cfg.cg_cap_relax is not None
                else (1e-2 if cfg.tangent_mg else None)
            ),
            cg_deflate=(cfg.cg_deflate if cfg.solver == "cg" else 0),
            newton_damping=cfg.newton_damping,
            apex_ep_uses_trial=cfg.bug_compatible_apex,
            elastic_factor=("inv", Ki) if cfg.solver == "dense" else None,
            elastic_op=(
                (a["K_slot"], K_slot[1]) if K_slot is not None else None
            ),
            corr_dest=a.get("corr_dest"),
            corr_full=K_slot is not None,
            df_residual_op=(
                (a["G_slot"], res_metas[0], a["S_slot"], res_metas[1])
                if res_metas is not None
                else None
            ),
            tangent_mg=(
                dict(
                    metas=tmg["metas"], arrays=a["mg_hier"],
                    tmg_arrays=a["tmg"], tmg_static=tmg["tmg_static"],
                )
                if tmg is not None
                else None
            ),
            precision="df32",
            pin_zeros=a["pinz"],
        )
        return stepper(
            df_pin(U_it0, a["pinz"]), 0.0, d_zeta, resume=resume
        )

    if dev_mesh is None:
        run = jax.jit(_run_impl)
    else:
        # shard_map over the whole solve (mirrors tsx build_df32):
        # operator arrays split by row blocks, everything else replicated
        from jax import shard_map as _shard_map
        from jax.sharding import PartitionSpec as SpecP

        from ..solve.newton import LoadSteppingResult

        for k in ("mg_hier", "G_slot", "S_slot", "tmg"):
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
            # deflation ring state is replicated (all ops on it are
            # deterministic dots over replicated vectors — bit-identical
            # per device, like the rest of the Newton control flow)
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

    return run, args, mesh


def _package_df32(res, mesh) -> FootingResult:
    f64 = lambda p: np.asarray(p.hi, np.float64) + np.asarray(p.lo, np.float64)
    return FootingResult(
        u=f64(res.u).reshape(-1, 2),
        ep=f64(res.ep),
        zeta_hist=np.asarray(res.zeta_hist, np.float64),
        pressure_hist=f64(res.monitor_hist),
        n_steps=int(res.n_steps) - 1,
        n_newton_total=int(res.n_newton_total),
        n_plastic=int(res.n_plastic),
        mesh=mesh,
        n_cg_total=int(res.n_cg_total),
    )


def _solve_df32(cfg: FootingConfig) -> FootingResult:
    run, args, mesh = build_df32(cfg)
    return _package_df32(run(args), mesh)


def build_df32_chunked(
    cfg: FootingConfig, trips_per_chunk: int = 3, max_chunks: int = 2000
):
    """Resume-chunked df32 footing executor: returns (execute, mesh).

    `execute(checkpoint_path=None)` runs the adaptive pressure schedule
    in `trips_per_chunk`-trip dispatches via the generic chunked driver
    (`solve/chunked.py`) — trajectory-identical to the single-dispatch
    run, and interruption-recoverable with a checkpoint path (mirrors
    `models.tsx_tunnel.build_df32_chunked`)."""
    import dataclasses

    from ..solve import chunked as _chunked

    cfg2 = dataclasses.replace(cfg, max_trips=trips_per_chunk)
    run, args, mesh = build_df32(cfg2)

    def execute(checkpoint_path=None):
        return _chunked.run_chunked(
            run, args,
            zeta_max=cfg.zeta_max,
            d_zeta_min=cfg.d_zeta * cfg.d_zeta_min_ratio,
            max_chunks=max_chunks,
            checkpoint_path=checkpoint_path,
        )

    return execute, mesh
