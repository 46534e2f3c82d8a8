"""Material-parameter ensembles: `vmap` over (cohesion, friction angle).

BASELINE.md config: "64-way (cohesion, friction) ensemble via vmap on the
largest tsx-tunnel mesh, shared assembly structure".  The geometry tables
(B, weights, DOF maps) are computed once and shared; the entire adaptive
load-stepped Newton solve — return mapping, assembly, linear solves,
adaptive d_zeta control — is batched with `vmap`, so XLA fuses the member
solves into batched kernels (batched LU / batched einsum).

Each ensemble member follows its *own* adaptive schedule; `vmap` of
`lax.while_loop` keeps iterating until every member is done, masking
finished lanes.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..models.config import TsxTunnelConfig
from ..models.materials import (
    drucker_prager_fit,
    elastic_tangent_lanes,
    lame_moduli,
)
from ..models.tsx_tunnel import initial_state, tsx_mesh
from ..ops import assembly as asm
from ..ops.elements import tables, volume_element
from ..solve.newton import NewtonSettings, build_load_stepper


class EnsembleResult(NamedTuple):
    u: jnp.ndarray  # (n_b, n_n, 2)
    zeta_hist: jnp.ndarray  # (n_b, max_steps)
    monitor_hist: jnp.ndarray  # (n_b, max_steps)
    n_steps: jnp.ndarray  # (n_b,)
    n_newton_total: jnp.ndarray  # (n_b,)
    n_plastic: jnp.ndarray  # (n_b,)


def material_grid(
    cohesions: np.ndarray, friction_angles: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Cartesian (cohesion x friction) grid -> flat (eta, c) arrays."""
    cc, ff = np.meshgrid(cohesions, friction_angles, indexing="ij")
    eta, c = drucker_prager_fit(cc.ravel(), ff.ravel())
    return eta, c


_RUN_CACHE: dict = {}


def solve_tsx_ensemble(
    etas: jnp.ndarray,
    cs: jnp.ndarray,
    cfg: TsxTunnelConfig = TsxTunnelConfig(),
    solver: Optional[str] = None,
) -> EnsembleResult:
    """Batch of tsx excavation solves over Drucker-Prager parameters.

    Args:
      etas, cs: (n_b,) plane-strain DP parameters per ensemble member
        (see `material_grid`).

    The jitted program is cached per (cfg, solver), so repeated ensemble
    sweeps skip Python retracing (~seconds for the vmapped solver).
    """
    key = (cfg, solver)
    if key in _RUN_CACHE:
        run, args_cached, cfg_dtype = _RUN_CACHE[key]
        res = run(
            args_cached, jnp.asarray(etas, cfg_dtype), jnp.asarray(cs, cfg_dtype)
        )
        return _package(res)
    mesh = tsx_mesh(cfg.etype, cfg.refine_levels)
    dtype = jnp.dtype(cfg.dtype)
    shear, bulk = lame_moduli(cfg.young, cfg.poisson)
    s0, e0 = initial_state(cfg)
    solver = solver or cfg.solver

    ref = volume_element(cfg.etype)
    fmap_np, n_free = asm.free_dof_map(mesh.free)
    free_idx = jnp.asarray(np.nonzero(mesh.free.reshape(-1))[0])
    fmap = jnp.asarray(fmap_np)
    coords = jnp.asarray(mesh.coords, dtype)
    elems = jnp.asarray(mesh.elems)
    monitor_dof = 2 * cfg.monitor_node

    settings = NewtonSettings(
        maxit=cfg.newton_maxit,
        newton_tol=cfg.newton_tol,
        accept_tol=cfg.accept_tol,
        d_zeta_min=cfg.d_zeta * cfg.d_zeta_min_ratio,
        zeta_max=cfg.zeta_max,
        max_steps=cfg.max_steps,
        step0=0,
    )

    args = dict(
        coords=coords, elems=elems, tab=tables(ref), fmap=fmap,
        free_idx=free_idx, s0=jnp.asarray(s0, dtype), e0=jnp.asarray(e0, dtype),
    )
    n_nodes = mesh.n_nodes

    @jax.jit
    def run(a, etas, cs):
        geom = asm.compute_geometry(a["coords"], a["elems"], a["tab"])

        # elastic predictor is material-batch independent: compute once
        s0_field = jnp.broadcast_to(a["s0"][:3, None], (3, geom.n_int))
        f0 = asm.internal_force(geom, s0_field)
        D = elastic_tangent_lanes(shear, bulk, geom.n_int, dtype)
        ke = asm.element_stiffness(geom, D)
        K_free = asm.assemble_dense_free(ke, geom, a["fmap"], n_free)
        cho = jax.scipy.linalg.cho_factor(K_free)
        u_el_free = jax.scipy.linalg.cho_solve(cho, -f0[a["free_idx"]])
        u_elast = jnp.zeros((2 * n_nodes,), dtype).at[a["free_idx"]].set(u_el_free)
        U_it0 = cfg.d_zeta * u_elast

        from ..models.tsx_tunnel import _elastic_factor

        ef = (
            _elastic_factor(cho, dtype)
            if solver == "dense"
            else None
        )

        def one(eta, c):
            stepper = build_load_stepper(
                geom, a["free_idx"], a["fmap"], n_free, shear, bulk, eta, c,
                settings, e0_dir=a["e0"],
                monitor=lambda u, s: u[monitor_dof],
                solver=solver,
                elastic_factor=ef,
            )
            return stepper(U_it0, 0.0, cfg.d_zeta)

        return jax.vmap(one)(etas, cs)

    _RUN_CACHE[key] = (run, args, dtype)
    res = run(args, jnp.asarray(etas, dtype), jnp.asarray(cs, dtype))
    return _package(res)


def solve_tsx_ensemble_df32(
    etas: np.ndarray,
    cs: np.ndarray,
    cfg: TsxTunnelConfig = None,
    shard_devices: Optional[int] = None,
) -> EnsembleResult:
    """Batch of f64-grade (double-float) tsx solves over DP parameters.

    Same batching as `solve_tsx_ensemble`, but each member runs the df32
    fast path (`solve/newton.py` precision="df32"): residual/criterion/
    state in two-f32 pairs, so every member follows the reference's
    1e-12/1e-10 f64 stopping behavior — n_b f64-grade solves at f32
    ensemble speed.  Material constants are computed host-side in f64 and
    enter as vmapped DF arguments (`materials_df.consts_host`).

    `shard_devices`: additionally shard the member axis over a 1D device
    mesh (SURVEY.md §2.4 "64-way" ensembles).  Members are independent,
    so the program needs no collectives: each device vmaps over its local
    member slice with the shared geometry replicated, and per-member
    results concatenate back along the member axis.  Member count is
    padded to a device multiple with copies of member 0 (trimmed from the
    result), so each shard's local batch is identical in shape; member
    results match the single-device vmap ensemble at the f64 floor (~1e-16
    — batched-factorization rounding varies with local batch size;
    tests/test_parallel.py::TestEnsembleSharded).
    """
    from ..models import materials_df as mdf
    from ..models.tsx_tunnel import _DATA  # noqa: F401  (package data)
    from ..ops import assembly_df as adf
    from ..ops.df32 import DF, df_const

    cfg = cfg if cfg is not None else TsxTunnelConfig.fast()
    assert cfg.precision == "df32" and cfg.solver in ("dense", "cg"), (
        "df32 ensemble supports the dense parity mesh (solver='dense') "
        "and refined meshes via matrix-free PCG (solver='cg', "
        "refine_levels >= 1 — ensemble-at-scale)"
    )
    key = ("df32", cfg, shard_devices)
    etas = np.asarray(etas, np.float64)
    cs = np.asarray(cs, np.float64)
    if key in _RUN_CACHE:
        run, args, shear, bulk = _RUN_CACHE[key]
    else:
        mesh = tsx_mesh(cfg.etype, cfg.refine_levels)
        shear, bulk = lame_moduli(cfg.young, cfg.poisson)
        s0, e0 = initial_state(cfg)
        ref = volume_element(cfg.etype)
        fmap_np, n_free = asm.free_dof_map(mesh.free)
        free_idx = jnp.asarray(np.nonzero(mesh.free.reshape(-1))[0])
        gdf = adf.geometry_df(mesh.coords, mesh.elems, ref)
        n_nodes, n_q, n_real = mesh.n_nodes, gdf.hi.n_q, gdf.hi.n_real
        monitor_dof = 2 * cfg.monitor_node
        f32 = jnp.float32
        # f32 PCG floor (cg members; tsx/footing build_df32 use the same)
        cg_tol = cfg.cg_tol if cfg.cg_tol is not None else 2e-7

        settings = NewtonSettings(
            maxit=cfg.newton_maxit,
            newton_tol=cfg.newton_tol,
            accept_tol=cfg.accept_tol,
            d_zeta_min=cfg.d_zeta * cfg.d_zeta_min_ratio,
            zeta_max=cfg.zeta_max,
            max_steps=cfg.max_steps,
            step0=0,
        )
        s0_hi, s0_lo = adf.split_f64_np(s0)
        e0_hi, e0_lo = adf.split_f64_np(e0)
        args = dict(
            B_hi=gdf.hi.B, w_hi=gdf.hi.weight,
            edofs=gdf.hi.edofs, edofs_t=gdf.hi.edofs_t,
            B_lo=gdf.B_lo, w_lo=gdf.w_lo, gmap=gdf.gmap,
            fmap=jnp.asarray(fmap_np), free_idx=free_idx,
            s0_hi=jnp.asarray(s0_hi), s0_lo=jnp.asarray(s0_lo),
            e0_hi=jnp.asarray(e0_hi), e0_lo=jnp.asarray(e0_lo),
            pinz=jnp.zeros((max(4 * gdf.hi.n_int, 2 * n_nodes),), f32),
        )

        def _run_impl(a, consts):
            g = adf.GeometryDF(
                hi=asm.Geometry(
                    B=a["B_hi"], weight=a["w_hi"], edofs=a["edofs"],
                    edofs_t=a["edofs_t"], n_nodes=n_nodes, n_q=n_q,
                    n_real=n_real,
                ),
                B_lo=a["B_lo"], w_lo=a["w_lo"], gmap=a["gmap"],
            )
            n_int = g.hi.n_int
            bc = lambda x: jnp.broadcast_to(x[:3, None], (3, n_int))
            f0 = adf.internal_force_df(g, DF(bc(a["s0_hi"]), bc(a["s0_lo"])))
            rhs = DF(-f0.hi, -f0.lo)

            D = elastic_tangent_lanes(shear, bulk, n_int, f32)
            zero_u = DF(
                jnp.zeros((2 * n_nodes,), f32), jnp.zeros((2 * n_nodes,), f32)
            )
            if cfg.solver == "dense":
                ke = asm.element_stiffness(g.hi, D)
                K_free = asm.assemble_dense_free(
                    ke, g.hi, a["fmap"], n_free
                )
                cho = jax.scipy.linalg.cho_factor(K_free)
                dsc = jax.lax.rsqrt(jnp.diagonal(K_free))
                Ks = K_free * dsc[:, None] * dsc[None, :]
                Ki = jax.scipy.linalg.cho_solve(
                    jax.scipy.linalg.cho_factor(Ks),
                    jnp.eye(n_free, dtype=f32),
                )
                Ki = Ki * dsc[:, None] * dsc[None, :]
                u_elast = adf.refine_elastic_solve_df(
                    g, cho, a["free_idx"], zero_u, rhs, shear, bulk
                )
            else:
                # refined-mesh members (cfg.refine_levels >= 1): the
                # dense elastic factor would be O(n^2) memory x batch —
                # predictor and tangent solves run matrix-free PCG
                # (block-Jacobi), shared elastic structure across members
                from ..solve.cg import (
                    block_jacobi_preconditioner,
                    solve_cg,
                )

                fmask = (
                    jnp.zeros((2 * n_nodes,), bool)
                    .at[a["free_idx"]]
                    .set(True)
                )
                blocks_el = asm.node_block_diagonal(g.hi, D)
                pre_el = block_jacobi_preconditioner(
                    blocks_el, fmask.reshape(-1, 2)
                )

                def solve_fn(r_hi):
                    return solve_cg(
                        lambda v: asm.tangent_matvec(g.hi, D, v),
                        r_hi, fmask, precond=pre_el, tol=cg_tol,
                        maxiter=cfg.cg_maxiter,
                        structure=cfg.cg_structure,
                    ).x

                u_elast = adf.refine_elastic_solve_with(
                    g, solve_fn, zero_u, rhs, shear, bulk
                )
            d_zeta = df_const(cfg.d_zeta)
            from ..ops.df32 import df_barrier, df_mul

            U_it0 = df_barrier(df_mul(u_elast, d_zeta))

            def one(member_consts):
                stepper = build_load_stepper(
                    g, a["free_idx"], a["fmap"], n_free, shear, bulk,
                    0.0, 0.0, settings,
                    e0_dir=DF(a["e0_hi"], a["e0_lo"]),
                    monitor=lambda u, s: DF(u.hi[monitor_dof], u.lo[monitor_dof]),
                    solver=cfg.solver,
                    # under vmap the plastic/elastic cond becomes a select
                    # (both branches run for every member), so the Woodbury
                    # solve replaces 64 batched O(n^3) assembly+factor
                    # passes per Newton iteration with batched matmuls
                    # against the SHARED elastic inverse (members differ
                    # only in cohesion/friction, not elastic moduli)
                    # generous cap; fallback disabled: under vmap the
                    # fallback cond becomes a select that would run the
                    # batched fresh factor every iteration (newton.py)
                    elastic_factor=(
                        ("inv", Ki) if cfg.solver == "dense" else None
                    ),
                    smw_cap=128 if cfg.solver == "dense" else None,
                    smw_fallback=False,
                    cg_tol=cg_tol,
                    cg_maxiter=cfg.cg_maxiter,
                    cg_structure=cfg.cg_structure,
                    cg_eta0=cfg.cg_eta0,
                    precision="df32",
                    pin_zeros=a["pinz"],
                    accumulate_ep=not cfg.bug_compatible_ep_reset,
                    df_consts=member_consts,
                )
                return stepper(U_it0, 0.0, d_zeta)

            return jax.vmap(one)(consts)

        if shard_devices is None:
            run = jax.jit(_run_impl)
        else:
            # member-axis sharding: shard_map over a 1D device mesh.  The
            # geometry args are replicated (SpecP()); every consts leaf and
            # every result leaf carries a leading member axis, so a single
            # PartitionSpec prefix shards them all.  No collectives appear
            # in the program — members never communicate.
            from jax import shard_map as _shard_map
            from jax.sharding import PartitionSpec as SpecP

            from .sharding import make_device_mesh

            n_dev = int(shard_devices)
            dev_mesh = make_device_mesh(n_dev, "members")
            run = jax.jit(
                _shard_map(
                    _run_impl, mesh=dev_mesh,
                    in_specs=(SpecP(), SpecP("members")),
                    out_specs=SpecP("members"),
                    check_vma=False,
                )
            )

        _RUN_CACHE[key] = (run, args, shear, bulk)

    n_b = etas.shape[0]
    if shard_devices is not None and n_b % int(shard_devices):
        # pad to a device multiple with member 0 (trimmed below)
        pad = int(shard_devices) - n_b % int(shard_devices)
        etas = np.concatenate([etas, np.repeat(etas[:1], pad)])
        cs = np.concatenate([cs, np.repeat(cs[:1], pad)])
    consts = mdf.consts_host(shear, bulk, etas, cs)
    res = run(args, consts)
    if etas.shape[0] != n_b:
        res = jax.tree.map(lambda x: x[:n_b], res)
    f64 = lambda p: np.asarray(p.hi, np.float64) + np.asarray(p.lo, np.float64)
    return EnsembleResult(
        u=f64(res.u).reshape(n_b, -1, 2),
        zeta_hist=np.asarray(res.zeta_hist, np.float64),
        monitor_hist=f64(res.monitor_hist),
        n_steps=np.asarray(res.n_steps),
        n_newton_total=np.asarray(res.n_newton_total),
        n_plastic=np.asarray(res.n_plastic),
    )


def _package(res) -> EnsembleResult:
    return EnsembleResult(
        u=res.u.reshape(res.u.shape[0], -1, 2),
        zeta_hist=res.zeta_hist,
        monitor_hist=res.monitor_hist,
        n_steps=res.n_steps,
        n_newton_total=res.n_newton_total,
        n_plastic=res.n_plastic,
    )
