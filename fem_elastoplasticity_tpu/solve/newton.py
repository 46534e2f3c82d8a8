"""Load-stepped semi-smooth Newton, entirely under one `jit`.

Redesign of the reference's host-side Python loops
(`tsx-tunnel/pythonFEM.py:1763-1832`, `Plasticity2D_DP/pythonFEM.py:1028-1131`):
the outer adaptive load stepping is a `lax.while_loop` carrying
`(U, U_old, U_it, Ep, zeta, zeta_old, d_zeta, d_zeta_old, step, ...)`, the
inner Newton iteration a nested `lax.while_loop`, histories are fixed-size
arrays updated in place — zero host round-trips per solve.

The adaptive controller is observable behavior and is reproduced exactly:
  * accept a step when the energy-norm criterion < accept_tol (1e-10),
  * halve d_zeta on divergence (NaN criterion counts as divergence; so does
    a capped, non-converged CG solve — never silent),
  * problem hook may double d_zeta (footing pressure rule),
  * stop when zeta_old >= zeta_max or d_zeta < d_zeta_min,
  * warm start U_it = d_zeta*(U - U_old)/d_zeta_old + U between trips.

Newton semantics parity (P:1040-1087): the iterate is updated *before* the
tolerance test; a NaN criterion aborts without updating; the criterion is
q1/(q2+q3) with q_i energy norms in the **elastic** stiffness, evaluated
matrix-free here.

Precision modes:
  * "native" — all state and ops in `geom`'s dtype (f64 parity / f32 fast).
  * "df32"   — the double-float mode: state (U, Ep, zeta) and the
    Newton residual pipeline are double-float (two-f32 pairs,
    `ops/assembly_df.py` + `models/materials_df.py`, ~1e-14 relative),
    while tangent assembly, linear solves and criterion matvecs stay pure
    f32 (inexact Newton — tangent error only slows convergence, never the
    limit).  This restores the reference's f64 stopping behavior
    (1e-12/1e-10, `tsx-tunnel/pythonFEM.py:1801-1804`) on f32 hardware.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..models.materials import dp_return_map_lanes, elastic_tangent_lanes
from ..ops import assembly as asm
from ..ops.df32 import (
    DF,
    df,
    df_add,
    df_barrier,
    df_const,
    df_div,
    df_mul,
    df_pin,
    df_sub,
    materialize,
)
from .cg import block_jacobi_preconditioner, deflation_harvest, solve_cg


def _spd_solve(K, b):
    """Dense SPD solve via Cholesky."""
    c, lower = jax.scipy.linalg.cho_factor(K)
    return jax.scipy.linalg.cho_solve((c, lower), b)


def _spd_solve_mixed(K, b, ir_iters: int = 3):
    """f64-accurate SPD solve via f32 Cholesky + iterative refinement.

    Where f64 factorization is much slower than f32 it pays to factor
    in f32; with condition numbers ~1e3 (measured, both benchmarks) each refinement step gains ~cond*eps32 ~ 1e-4, so
    `ir_iters=3` reaches ~1e-13 relative — preserving the reference Newton
    trajectories bit-for-bit at the 1e-12 criterion level.  The matrix is
    symmetrically Jacobi-scaled before demotion to keep the f32
    factorization well-posed.
    """
    d = jax.lax.rsqrt(jnp.diagonal(K))
    Ks = K * d[:, None] * d[None, :]
    cho32 = jax.scipy.linalg.cho_factor(Ks.astype(jnp.float32))

    def apply_inv(r):
        y = jax.scipy.linalg.cho_solve(cho32, (r * d).astype(jnp.float32))
        return y.astype(K.dtype) * d

    x = apply_inv(b)
    for _ in range(ir_iters):
        x = x + apply_inv(b - K @ x)
    return x


def _wsel(cond, a, b):
    """Elementwise select over matching pytrees (arrays or DF pairs)."""
    return jax.tree.map(lambda x, y: jnp.where(cond, x, y), a, b)


class LoadSteppingResult(NamedTuple):
    u: jnp.ndarray  # (2*n_n,) converged displacement (DF pair in df32 mode)
    ep: jnp.ndarray  # (4, n_int) plastic strain (DF pair in df32 mode)
    zeta_hist: jnp.ndarray  # (max_steps,)
    monitor_hist: jnp.ndarray  # (max_steps,) (DF pair in df32 mode)
    n_steps: jnp.ndarray  # accepted steps
    n_newton_total: jnp.ndarray  # total inner iterations
    zeta: jnp.ndarray  # final accepted load factor (DF in df32 mode)
    d_zeta: jnp.ndarray
    n_plastic: jnp.ndarray  # integration points with nonzero plastic strain
    n_cg_total: jnp.ndarray  # cumulative inner CG iterations (0 on dense paths)
    # carry tail for exact checkpoint/resume (utils.checkpoint)
    u_old: jnp.ndarray
    u_it: jnp.ndarray
    d_zeta_old: jnp.ndarray
    aux: jnp.ndarray
    # recycled Krylov deflation state (cg_deflate doc): (W, ring) when
    # enabled, None otherwise (an empty pytree node — result/carry
    # structures are unchanged for every pre-existing path)
    defl: object = None


class NewtonSettings(NamedTuple):
    maxit: int
    newton_tol: float
    accept_tol: float
    d_zeta_min: float
    zeta_max: float
    max_steps: int  # history length
    step0: int  # first history index written (footing: 1, tsx: 0)
    max_trips: int = 10000  # safety bound on outer while_loop


def build_load_stepper(
    geom,
    free_idx: jnp.ndarray,
    fmap: jnp.ndarray,
    n_free: int,
    shear: float,
    bulk: float,
    eta: float,
    c: float,
    settings: NewtonSettings,
    e0_dir=None,
    monitor: Optional[Callable] = None,
    accept_hook: Optional[Callable] = None,
    solver: str = "dense",
    cg_tol: float = 1e-14,
    cg_maxiter: int = 2000,
    cg_structure: str = "while",
    cg_eta0: Optional[float] = None,
    cg_eta_safety: float = 0.1,
    cg_cap_relax: Optional[float] = None,
    cg_deflate: int = 0,
    newton_damping: int = 0,
    apex_ep_uses_trial: bool = False,
    axis_name: Optional[str] = None,
    dense_mode: str = "f64",
    mg_preconditioner: Optional[Callable] = None,
    elastic_op=None,
    plastic_cap: Optional[int] = None,
    corr_dest=None,
    corr_full: bool = False,
    corr_shard_axis: Optional[str] = None,
    tangent_mg=None,
    df_residual_op=None,
    gs_tangent: bool = False,
    smw_cap: Optional[int] = None,
    smw_fallback: bool = True,
    elastic_factor=None,
    precision: str = "native",
    pin_zeros=None,
    accumulate_ep: bool = True,
    f_ext_dir=None,
    df_consts=None,
):
    """Build the jittable load-stepping driver.

    Args:
      geom:       precomputed assembly geometry (`ops.assembly.Geometry`;
                  in precision="df32", an `ops.assembly_df.GeometryDF`).
      free_idx:   (n_free,) indices of free DOFs in the flat DOF vector.
      fmap:       (2*n_n,) free-DOF map for dense assembly (dense solver).
      e0_dir:     (4,) initial-strain direction; the return map sees
                  e0 = zeta * e0_dir (tsx excavation).  None -> no e0.
                  A DF pair in df32 mode.
      monitor:    (u_flat, s) -> scalar recorded per accepted step (df32
                  mode: u and s arrive as DF pairs, return a DF scalar).
      accept_hook:(monitor_value, aux, criterion) -> (aux', dzeta_factor);
                  default keeps d_zeta (tsx).  Footing doubles it when the
                  pressure increment is small (P:1109-1110).  The monitor
                  value arrives as a plain scalar (the DF head in df32).
      elastic_op:  optional (arrays, meta) assembled elastic operator
                  (`ops.spmv.build_sparse` format, BCs applied) on the
                  SAME node ordering as `geom`.  With solver="mg", the CG
                  tangent operator becomes `sp_matvec(elastic_op, v) +
                  plastic_correction(v)` — the consistent tangent equals
                  the elastic tangent exactly at non-plastic points, so
                  the correction is gathered over a static `plastic_cap`-
                  sized slot set (`ops.assembly.plastic_slots`) instead of
                  running the serialized full-mesh matrix-free matvec.
      plastic_cap: static size of the plastic slot set (elastic_op mode);
                  overflow beyond the cap degrades the tangent (never the
                  residual): Newton may take extra iterations but the
                  answer is unchanged.
      corr_dest:  optional (n_e, 2n_p, 2n_p) i32 scatter-destination table
                  (`ops.spmv.element_corr_dest`) enabling the
                  static-structure tangent refresh: instead of applying
                  the plastic correction as a gather/segment-sum operator
                  every CG iteration, the per-point correction blocks are
                  scatter-added into a COPY of elastic_op's slot value
                  stream once per Newton iteration — each CG matvec is
                  then a single slot kernel.  Identical operator up to f32
                  summation order.  Must be a jit argument
                  (`utils/jitsafe.py`).
      corr_full:  with corr_dest — refresh from ALL integration points
                  (one batched element_stiffness of d - d_elastic + one
                  full-mesh scatter per Newton iteration) instead of the
                  plastic_cap slot subset.  The assembled FULL-tangent
                  operator for problems whose plastic zone spans most of
                  the domain (footing: ~75% of points at the nu=0.48
                  limit load — the low-rank correction is inapplicable;
                  reference analog: the per-iteration D_p reassembly,
                  `Plasticity2D_DP/pythonFEM.py:1047-1050`).
      tangent_mg: optional bundle dict(metas, arrays, tmg_arrays,
                  tmg_static, nu, omega) — the TRUE tangent multigrid
                  (`solve/multigrid.py build_tangent_hierarchy` /
                  `tangent_vcycle`): every hierarchy level's slot
                  operator is refreshed from the current consistent
                  tangent once per Newton iteration and the V-cycle
                  preconditions CG on the assembled fine tangent.
                  Overrides elastic_op/mg_preconditioner.  For problems
                  where the elastic hierarchy fails (footing at scale).
      df_residual_op: optional (G_arrays, G_meta, S_arrays, S_meta)
                  assembled strain/force operators for the df32 residual
                  (`ops.spmv.build_residual_slot_df`): strains and the
                  internal force run as double-float slot matvecs
                  (~1e-14 relative) instead of the matrix-free
                  gather/scatter path.  Arrays must be jit arguments.
      gs_tangent: iterative solvers without an elastic_op — apply the CG
                  tangent as S(d * (G v)) on the f32 heads of the
                  assembled df32 strain/force slot operators (K_t v =
                  B^T w d B v factored through the same fixed G/S
                  sparsity) instead of the serialized matrix-free
                  gather path.  The high-order (P2/P4) fast-operator
                  path: the assembled per-element stiffness loses to
                  matrix-free there (s_pad ~ 344 at P4), but G/S stream
                  like any slot operator.  Requires df_residual_op in
                  the slot/rslot format.
      smw_cap:    dense solver + ("inv", Ki) elastic factor only: plastic
                  Newton solves use the Woodbury identity over a
                  `smw_cap`-sized plastic slot set (matmuls + a tiny
                  capacitance LU) instead of fresh assembly + Cholesky.
                  Appropriate when the plastic fraction is small (tsx);
                  None = fresh factor.
      smw_fallback: when the runtime plastic count exceeds smw_cap, fall
                  back to the fresh factor via lax.cond (a heavily
                  truncated tangent can stall Newton — measured).  Set
                  False under vmap (ensembles): the cond becomes a select
                  that would execute the batched factor every iteration;
                  rely on a generous cap instead.
      elastic_factor: prefactored elastic stiffness (cho_factor pair) for
                  the dense solver.  When no integration point is plastic
                  the tangent equals the elastic stiffness bitwise, so the
                  factorization is skipped via lax.cond — the trajectory is
                  unchanged.
      solver:     "dense" (reference-parity direct), "cg" (matrix-free
                  block-Jacobi PCG), or "mg" (matrix-free PCG with a
                  caller-supplied geometric-multigrid V-cycle; pass
                  `mg_preconditioner` built by `solve.multigrid.make_vcycle`
                  on the *elastic* hierarchy — an effective preconditioner
                  for the elastoplastic tangent since yielding is local).
      axis_name:  mesh axis over which elements are sharded (shard_map
                  SPMD).  Nodal reductions psum over it; DOF vectors and
                  the Newton control flow are replicated, so every device
                  executes the identical adaptive schedule.
      precision:  "native" or "df32" (see module docstring).  df32 requires
                  solver="dense" and f32 geometry heads.
      pin_zeros:  df32 only — a traced all-zeros f32 array (a real jit
                  argument, length >= max(2*n_dofs, 4*n_int)) used by
                  `ops.df32.df_pin` to protect the double-float state from
                  the measured XLA:CPU EFT-destroying rewrites (df32.py
                  hazard note).  Required in df32 mode.
      accumulate_ep: accumulate plastic strain across accepted steps (the
                  fixed semantics, default).  False reproduces the tsx
                  reference's behavior, which never passes
                  apply_plastic_strain=True so its Ep_old is re-zeroed
                  every step (`tsx-tunnel/pythonFEM.py:1808-1809`) —
                  reference defect #3-bis, PARITY.md.  Affects the plastic
                  tail at ~1.5e-7 relative on the tsx parity mesh.
      df_consts:  df32 only — a `materials_df._Consts` pytree of traced DF
                  scalars overriding the literal-derived material
                  constants (vmapped material ensembles;
                  `materials_df.consts_host`).  eta/c are ignored then.
      cg_eta0:    Eisenstat-Walker-style forcing for the iterative
                  tangent solves: iteration k's CG tolerance is
                  clip(cg_eta_safety * crit_{k-1}, cg_tol, cg_eta0) —
                  the first solve of each Newton sequence runs at the
                  loose cg_eta0 (its increment is dominated by the new
                  load step and gets corrected anyway), later solves
                  tighten with the measured criterion down to the
                  cg_tol floor.  Exactness is untouched: the criterion
                  is evaluated on the dU actually applied, so a loose
                  solve can slow convergence but never fake it.
                  None (default) = fixed cg_tol (prior behavior).
      cg_cap_relax: iterative solvers — accept a CAPPED tangent solve as
                  an inexact-Newton step when it still cut the
                  preconditioned residual by this factor (e.g. 1e-2)
                  instead of declaring divergence.  The capped dU only
                  slows Newton (the criterion measures true convergence;
                  a non-converging sequence still fails via newton_maxit
                  -> step halving), but a cap-as-divergence policy
                  FRAGMENTS adaptive schedules when iteration counts
                  brush the cap: the round-3 footing level-4 run
                  ballooned to 469 steps / 6.6M CG iterations because
                  every capped solve halved d_zeta.
                  Solves that made less progress than the factor (incl.
                  breakdown exits) still read as divergence.  None
                  (default) = strict cap-as-divergence.
      cg_deflate: iterative tangent solves (currently the tangent_mg
                  path) — size k of a recycled Krylov deflation basis
                  (`solve/cg.py` deflate/deflation_harvest docs).  Each
                  tangent solve runs deflated PCG against a ring basis
                  W carried across Newton iterations AND load steps
                  (and through checkpoint/resume); after every solve
                  the solution and the final preconditioned residual
                  are orthonormalized into the ring.  Targets the
                  persistent small-eigenvalue cluster (shear-band
                  modes) that caps the footing's near-limit solves —
                  neither a stronger smoother nor the coarse grid
                  represents it (ROADMAP findings).  Affects only
                  iteration counts/inexactness, never the converged
                  physics (the criterion measures true convergence).
                  0 (default) = off.
      f_ext_dir:  optional (2*n_n,) external load direction ramped with
                  the load factor: the Newton residual becomes
                  F_int(u) - zeta * f_ext_dir (e.g. a tunnel support
                  pressure from `ops.assembly.pressure_traction_vector`).
                  A DF pair in df32 mode.

    Returns run(U_it0, aux0, d_zeta0) -> LoadSteppingResult, jittable.
    In df32 mode U_it0/d_zeta0 are DF pairs and the displacement/ep/zeta/
    monitor outputs are DF pairs (combine with `ops.df32.to_f64` on host).
    """
    df_mode = precision == "df32"
    if df_mode:
        from ..models import materials_df as mdf
        from ..ops import assembly_df as adf

        # dense: f32 Cholesky (+ elastic-factor reuse); cg/mg: matrix-free
        # f32 PCG tangent solves (inexact Newton — the df32 residual and
        # criterion still deliver the f64-grade stopping behavior)
        assert solver in ("dense", "cg", "mg"), solver
        if axis_name is not None:
            # multi-chip df32: matrix-free CG only; the assembled G/S
            # residual operators are global (unsharded) objects
            assert solver == "cg" and df_residual_op is None
        gdf = geom
        geom = gdf.hi
    dtype = geom.B.dtype
    n_dofs = 2 * geom.n_nodes
    free_mask = jnp.zeros((n_dofs,), bool).at[free_idx].set(True)

    def return_map(u_flat, ep, zeta, apply=False):
        """-> (s, ds_f32, ind_p, lam, ep'); s/ep are DF pairs in df32 mode."""
        if df_mode:
            if df_residual_op is not None:
                from ..ops import spmv as _spmv

                Ga, Gm, _, _ = df_residual_op
                eh, el = _spmv.sp_matvec_df(
                    Ga, Gm, u_flat.hi, u_flat.lo, pin=pin_zeros
                )
                n_i = geom.n_int
                e = df_barrier(DF(eh.reshape(3, n_i), el.reshape(3, n_i)))
            else:
                e = adf.strains_df(gdf, u_flat)
            # df glue chains are pinned like stage outputs (df32.py
            # hazard note): fused into a consumer they lose compensation
            e0 = (
                None
                if e0_dir is None
                else df_pin(df_barrier(df_mul(e0_dir, zeta)), pin_zeros)
            )
            # computed once and stored: the force operator gathers each
            # stress value ~2n_p times (ops/df32.py materialize)
            return materialize(mdf.dp_return_map_lanes_df(
                e, ep, shear, bulk, eta, c, e0=e0,
                apply_plastic_strain=apply,
                apex_ep_uses_trial=apex_ep_uses_trial,
                consts=df_consts,
            ))
        e = asm.strains(geom, u_flat)  # (3, n_int) lane-major
        e0 = None if e0_dir is None else zeta * e0_dir
        return dp_return_map_lanes(
            e, ep, shear, bulk, eta, c, e0=e0, apply_plastic_strain=apply,
            apex_ep_uses_trial=apex_ep_uses_trial,
        )

    def residual_force(s, zeta):
        """Newton residual F_int - zeta*f_ext; plain array always."""
        if df_mode:
            if df_residual_op is not None:
                from ..ops import spmv as _spmv

                _, _, Sa, Sm = df_residual_op
                fh, fl = _spmv.sp_matvec_df(
                    Sa, Sm, s.hi[:3].reshape(-1), s.lo[:3].reshape(-1),
                    pin=pin_zeros,
                )
                f = df_barrier(DF(fh, fl))
            else:
                f = adf.internal_force_df(
                    gdf, DF(s.hi[:3], s.lo[:3]), axis_name=axis_name
                )
            if f_ext_dir is not None:
                f = df_sub(f, df_mul(f_ext_dir, zeta))
            return f.hi
        f = asm.internal_force(geom, s[:3], axis_name=axis_name)
        if f_ext_dir is not None:
            f = f - zeta * f_ext_dir
        return f

    def elastic_stress(e):
        # s = 2G dev3(e) + K tr(e) iota3, written component-wise (lane-major)
        t = e[0] + e[1]
        two_g = 2.0 * shear
        return jnp.stack(
            [
                two_g * (e[0] - t / 3.0) + bulk * t,
                two_g * (e[1] - t / 3.0) + bulk * t,
                shear * e[2],
            ],
            axis=0,
        )

    def elastic_apply(v):
        s = elastic_stress(asm.strains(geom, v))
        return asm.internal_force(geom, s, axis_name=axis_name)

    def criterion_norms(dU, U_it):
        # q1 = |dU|_K, q2 = |U_it|_K, q3 = |U_it + dU|_K with ONE batched
        # matvec: q3^2 = q2^2 + 2 dU.K.U_it + q1^2 (K_elast is symmetric).
        # vmap instantiates the elastic-apply program once for both
        # vectors (code-size, solve_cg note) and batches the lanes.
        if elastic_op is not None:
            # assembled elastic matvec (BC rows are unit-diagonal,
            # but dU and U_it vanish on constrained DOFs — homogeneous
            # Dirichlet — so the energy norms are unchanged)
            from ..ops import spmv as _spmv

            op_arr, op_meta = elastic_op
            KdU = _spmv.sp_matvec(op_arr, op_meta, dU)
            KU = _spmv.sp_matvec(op_arr, op_meta, U_it)
        else:
            KdU, KU = jax.vmap(elastic_apply)(jnp.stack([dU, U_it], axis=0))
        q1sq = dU @ KdU
        q2sq = U_it @ KU
        cross = dU @ KU
        q3sq = jnp.maximum(q2sq + 2.0 * cross + q1sq, 0.0)
        return jnp.sqrt(q1sq), jnp.sqrt(q2sq), jnp.sqrt(q3sq)

    def _cg_ok(res):
        """Capped-solve acceptance (cg_cap_relax doc): converged, or made
        enough preconditioned-residual progress to count as an
        inexact-Newton step.  NaN rel_residual compares False.  Deflated
        solves report rel_residual in the UNDEFLATED preconditioner norm
        (cg.py res_rep doc) so this threshold keeps one calibration.
        (A plain 2-norm measure was tried and rejected: even undeflated
        capped solves reduce the 2-norm only to ~0.6 while their M0
        measure shows 1e-3 — the V-cycle norm weights the stiff modes
        completely differently.)"""
        if cg_cap_relax is None:
            return res.converged
        return res.converged | (res.rel_residual <= cg_cap_relax)

    def newton_solve(d, f_int, any_plastic, ind_p=None, eta=None, defl=None):
        """One Newton linear solve: K_tangent dU = -F on free DOFs.

        d: (3, 3, n_int) consistent tangent; ind_p: (n_int,) plastic mask
        (elastic_op mode); eta: traced CG tolerance override (forcing
        term, cg_eta0 doc) — None = the static cg_tol; defl: recycled
        deflation state (cg_deflate doc), passed through unchanged by
        paths that do not use it.  Returns (dU, ok, cg_its, defl) — ok
        is False when an iterative solve hit its cap without converging
        (treated as divergence by the caller, like the NaN guard)."""
        if solver == "dense":
            rhs = -f_int[free_idx]

            def assemble_K():
                ke = asm.element_stiffness(geom, d)
                K_free = asm.assemble_dense_free(ke, geom, fmap, n_free)
                if axis_name is not None:
                    K_free = jax.lax.psum(K_free, axis_name)
                return K_free

            # Cholesky: the consistent tangent is symmetric PSD (associated
            # flow), so Cholesky rather than LU.  An indefinite matrix yields NaN -> the NaN guard
            # treats it as divergence, like the reference (P:1076-1078).
            # Assembly happens INSIDE the fresh branch: elastic-reuse
            # iterations (the majority) skip the per-iteration element
            # stiffness + dense scatter entirely (~0.3 ms each at n=908).
            mixed = dense_mode == "mixed" and dtype == jnp.float64
            fresh = (
                (lambda: _spd_solve_mixed(assemble_K(), rhs))
                if mixed
                else (lambda: _spd_solve(assemble_K(), rhs))
            )
            if elastic_factor is None:
                dU_free = fresh()
            else:
                # elastic iterations: K_free == K_elast bitwise -> reuse a
                # precomputed elastic solve (skips the O(n^3) factor).  An
                # ("inv", Ki) pair applies the explicit inverse as ONE
                # matmul instead of two row-serial triangular solves.
                if (
                    isinstance(elastic_factor, tuple)
                    and elastic_factor[0] == "inv"
                ):
                    Ki = elastic_factor[1]
                    reuse = lambda: Ki @ rhs
                    if smw_cap is not None and ind_p is not None:
                        # Woodbury plastic solve: K_t = K_e + U C U^T with
                        # C = blockdiag(w_p (d_p - d_el)) supported on the
                        # static plastic slot set, so
                        #   K_t^{-1} r = Ki r - Ki U (I + C U^T Ki U)^{-1}
                        #               C U^T Ki r
                        # (push-through identity; no C^{-1}, so singular
                        # per-point corrections are fine).  Plastic
                        # iterations become matmuls + one (3P)^2 f32 LU
                        # instead of a fresh O(n^3) assembly+factor.
                        # When the plastic set exceeds the cap, fall back
                        # to the fresh factor: a heavily-truncated tangent
                        # can stall Newton entirely (measured: cohesion
                        # 1.0 -> 124 plastic points vs cap 64 collapsed
                        # d_zeta at zeta=0.2; tests/test_tsx_tunnel.py
                        # test_smw_cap_overflow_matches_f64).
                        def smw():
                            d_el = elastic_tangent_lanes(
                                shear, bulk, geom.n_int, dtype
                            )
                            idx_p, valid_p = asm.plastic_slots(
                                ind_p, smw_cap
                            )
                            Bp, wdelta, edp = asm.plastic_correction_gather(
                                geom, d - d_el, idx_p, valid_p
                            )
                            P = smw_cap
                            n_p2 = Bp.shape[1]
                            cols = (
                                jnp.arange(3)[:, None, None] * P
                                + jnp.arange(P)[None, None, :]
                            )
                            cols = jnp.broadcast_to(cols, (3, n_p2, P))
                            rows = jnp.broadcast_to(
                                edp[None], (3, n_p2, P)
                            )
                            U = (
                                jnp.zeros((n_dofs, 3 * P), dtype)
                                .at[rows.reshape(-1), cols.reshape(-1)]
                                .add(Bp.reshape(-1))
                            )
                            Uf = U[free_idx]
                            KiU = Ki @ Uf  # (n_free, 3P)
                            M = Uf.T @ KiU  # (3P, 3P)
                            CM = jnp.einsum(
                                "abp,bpj->apj",
                                wdelta,
                                M.reshape(3, P, 3 * P),
                            )
                            A = jnp.eye(3 * P, dtype=dtype) + CM.reshape(
                                3 * P, 3 * P
                            )
                            z = Ki @ rhs
                            t = Uf.T @ z
                            Ct = jnp.einsum(
                                "abp,bp->ap", wdelta, t.reshape(3, P)
                            ).reshape(-1)
                            y = jnp.linalg.solve(A, Ct)
                            return z - KiU @ y

                        if smw_fallback:
                            # Flat 3-way dispatch (reuse/smw/fresh factor):
                            # one lax.switch over a computed branch index
                            # rather than a cond nested inside the
                            # any_plastic cond.  Under
                            # vmap a switch runs every branch as a select —
                            # ensembles disable the fallback and rely on a
                            # generous cap instead (see smw_fallback doc).
                            fresh_factor = fresh
                            n_plastic_now = jnp.sum(ind_p.astype(jnp.int32))
                            branch = jnp.where(
                                any_plastic,
                                jnp.where(n_plastic_now <= smw_cap, 1, 2),
                                0,
                            )
                            dU_free = jax.lax.switch(
                                branch, [reuse, smw, fresh_factor]
                            )
                            dU = (
                                jnp.zeros((n_dofs,), dtype)
                                .at[free_idx]
                                .set(dU_free)
                            )
                            return dU, jnp.asarray(True), jnp.asarray(0), defl
                        fresh = smw
                else:
                    reuse = lambda: jax.scipy.linalg.cho_solve(
                        elastic_factor, rhs
                    )
                dU_free = jax.lax.cond(any_plastic, fresh, reuse)
            dU = jnp.zeros((n_dofs,), dtype).at[free_idx].set(dU_free)
            return dU, jnp.asarray(True), jnp.asarray(0), defl
        if tangent_mg is not None:
            # per-iteration tangent hierarchy refresh (tangent_mg doc)
            from . import multigrid as mgm

            A_op, pre = mgm.tangent_vcycle(
                tangent_mg["metas"], tangent_mg["arrays"],
                tangent_mg["tmg_arrays"], tangent_mg["tmg_static"],
                d, shear, bulk,
                nu=tangent_mg.get("nu", 2),
                omega=tangent_mg.get("omega", 0.7),
            )
            res = solve_cg(
                A_op,
                -f_int,
                free_mask,
                precond=pre,
                tol=cg_tol if eta is None else eta,
                maxiter=cg_maxiter,
                structure=cg_structure,
                deflate=None if defl is None else defl[0],
            )
            if defl is not None:
                # recycle: the solution (A⁻¹b — small-mode amplified)
                # and the unconverged preconditioned residual feed the
                # ring basis for the NEXT solves (cg_deflate doc)
                W, ring = deflation_harvest(
                    defl[0], defl[1], [res.x, res.z],
                    gates=[None, ~res.converged],
                )
                defl = (W, ring)
            import os

            if os.environ.get("FEM_DEBUG_CG"):
                jax.debug.print(
                    "cg-tmg: iters={it} rel={rel} rel2={r2} conv={c} eta={e}",
                    it=res.iters, rel=res.rel_residual,
                    r2=res.rel2_residual, c=res.converged,
                    e=cg_tol if eta is None else eta,
                )
            return res.x, _cg_ok(res), res.iters, defl
        if solver == "mg" and mg_preconditioner is not None:
            pre = mg_preconditioner
        else:
            blocks = asm.node_block_diagonal(geom, d, axis_name=axis_name)
            pre = block_jacobi_preconditioner(blocks, free_mask.reshape(-1, 2))
        if elastic_op is not None and ind_p is not None:
            # assembled-elastic + low-rank plastic correction: the slot/
            # ELL matvec replaces the full-mesh gather/scatter; only the
            # (static-capped) plastic slot set pays gather cost.  Exact: d == d_elastic off the plastic set.
            from ..ops import spmv as _spmv

            op_arr, op_meta = elastic_op
            d_el = elastic_tangent_lanes(shear, bulk, geom.n_int, dtype)
            if corr_dest is not None and corr_full:
                # assembled full-tangent refresh (corr_full doc): batched
                # element stiffness of the tangent deviation + one
                # full-mesh static scatter per Newton iteration.
                # element_stiffness is lane-major (2n_p, 2n_p, n_e) —
                # transpose to corr_dest's (n_e, row, col) layout.
                corr_vals = jnp.transpose(
                    asm.element_stiffness(geom, d - d_el), (2, 0, 1)
                )
            elif corr_dest is not None:
                # static-structure tangent refresh (corr_dest doc): one
                # 36*cap-index scatter per Newton iteration replaces the
                # gather/segment-sum correction in every CG matvec.
                # Invalid/padding slots carry zero wdelta (inert adds);
                # constrained-DOF entries carry dest -1 (mode="drop").
                idx_p, valid_p = asm.plastic_slots(ind_p, plastic_cap)
                Bp, wdelta, edp = asm.plastic_correction_gather(
                    geom, d - d_el, idx_p, valid_p
                )
                corr_vals = jnp.einsum("aip,abp,bjp->pij", Bp, wdelta, Bp)
            if corr_dest is not None:
                dest = (
                    corr_dest
                    if corr_full
                    else corr_dest[idx_p // geom.n_q]
                )
                vals = op_arr["vals"]
                didx = dest.reshape(-1)
                if corr_shard_axis is not None:
                    # row-sharded operator (ops/spmv.py ShardedMeta):
                    # `vals` is this device's contiguous row-block slice,
                    # dest positions are GLOBAL cell indices — shift by
                    # the shard offset so each device applies exactly its
                    # slice of the single-device scatter (bit-identical
                    # local values)
                    didx = didx - jax.lax.axis_index(
                        corr_shard_axis
                    ) * vals.size
                # route negatives (dropped -1 entries; under sharding,
                # cells of earlier shards) to a POSITIVE out-of-bounds
                # index: jnp indexing normalizes negative indices by
                # adding the size (wrap-around) BEFORE the scatter, so a
                # raw -1 under mode="drop" would silently hit the last
                # cell instead of dropping
                didx = jnp.where(didx >= 0, didx, vals.size)
                vals_t = (
                    vals.reshape(-1)
                    .at[didx]
                    .add(
                        corr_vals.reshape(-1).astype(vals.dtype),
                        mode="drop",
                    )
                    .reshape(vals.shape)
                )
                arr_t = dict(op_arr)
                arr_t["vals"] = vals_t
                A_op = lambda v: _spmv.sp_matvec(arr_t, op_meta, v)
            else:
                idx_p, valid_p = asm.plastic_slots(ind_p, plastic_cap)
                Bp, wdelta, edp = asm.plastic_correction_gather(
                    geom, d - d_el, idx_p, valid_p
                )
                A_op = lambda v: _spmv.sp_matvec(
                    op_arr, op_meta, v
                ) + asm.plastic_correction_apply(Bp, wdelta, edp, n_dofs, v)
        elif gs_tangent and df_residual_op is not None:
            # assembled G/S tangent (gs_tangent doc): two slot matvecs on
            # the f32 heads of the residual operators + a per-qp 3x3
            # apply.  f32-accurate operator — CG is inexact anyway; the
            # residual/criterion keep their df32 exactness.
            from ..ops import spmv as _spmv

            Ga, Gm, Sa, Sm = df_residual_op
            assert isinstance(Gm, _spmv.SlotMeta) and isinstance(
                Sm, _spmv.SlotMeta
            ), "gs_tangent needs slot/rslot residual operators"
            G32 = {k: Ga[k] for k in Ga if not k.startswith("vals")}
            G32["vals"] = Ga["vals_hi"]
            S32 = {k: Sa[k] for k in Sa if not k.startswith("vals")}
            S32["vals"] = Sa["vals_hi"]

            def A_op(v):
                e = _spmv.sp_matvec(G32, Gm, jnp.asarray(v, jnp.float32))
                s3 = jnp.einsum(
                    "abn,bn->an", d, e.reshape(3, geom.n_int)
                )
                return _spmv.sp_matvec(S32, Sm, s3.reshape(-1))
        else:
            A_op = lambda v: asm.tangent_matvec(
                geom, d, v, axis_name=axis_name
            )
        # no warm start: x0=None lets solve_cg skip the extra operator /
        # preconditioner instantiations (code-size, solve_cg note) —
        # the tangent changes between Newton iterations anyway
        res = solve_cg(
            A_op,
            -f_int,
            free_mask,
            precond=pre,
            tol=cg_tol if eta is None else eta,
            maxiter=cg_maxiter,
            structure=cg_structure,
            deflate=None if defl is None else defl[0],
        )
        if defl is not None:
            W, ring = deflation_harvest(
                defl[0], defl[1], [res.x, res.z],
                gates=[None, ~res.converged],
            )
            defl = (W, ring)
        import os

        if os.environ.get("FEM_DEBUG_CG"):
            jax.debug.print(
                "cg: b_nan={bn} d_nan={dn} x_nan={xn} iters={it} res={r} "
                "conv={c} bmax={bm} xmax={xm}",
                bn=jnp.isnan(f_int).sum(), dn=jnp.isnan(d).sum(),
                xn=jnp.isnan(res.x).sum(), it=res.iters, r=res.residual,
                c=res.converged, bm=jnp.abs(f_int).max(),
                xm=jnp.abs(res.x).max(),
            )
        return res.x, _cg_ok(res), res.iters, defl

    def inner_newton(U_it, ep, zeta, defl0=None):
        """Semi-smooth Newton at fixed load factor.

        U_it (and ep) are DF pairs in df32 mode; increments and the
        criterion stay plain f32.  defl0: recycled deflation state
        (cg_deflate doc) threaded through every linear solve and
        returned updated."""
        big = jnp.asarray(jnp.inf, dtype)
        u_head = (lambda u: u.hi) if df_mode else (lambda u: u)

        def cond(carry):
            _, _, crit, it, _, fail, _ = carry
            return (~fail) & (crit >= settings.newton_tol) & (it < settings.maxit)

        def body(carry):
            U_it, dU_prev, crit_prev, it, ncg, _, defl = carry
            s_rm, ds_rm, ind_p, _, _ = return_map(U_it, ep, zeta)
            f_int = residual_force(s_rm, zeta)
            any_p = ind_p.any()
            if axis_name is not None:
                any_p = jax.lax.psum(any_p.astype(jnp.int32), axis_name) > 0
            eta = None
            if cg_eta0 is not None and solver != "dense":
                # Eisenstat-Walker forcing (cg_eta0 doc): inf criterion
                # (first iteration) clips to the loose cg_eta0
                eta = jnp.clip(
                    jnp.nan_to_num(
                        crit_prev * cg_eta_safety, posinf=cg_eta0
                    ),
                    cg_tol,
                    cg_eta0,
                )
            dU, ok, cg_its, defl = newton_solve(
                ds_rm, f_int, any_p, ind_p=ind_p, eta=eta, defl=defl
            )
            def _upd(step_vec):
                return (
                    df_pin(df_barrier(df_add(U_it, df(step_vec))), pin_zeros)
                    if df_mode
                    else U_it + step_vec
                )

            if newton_damping:
                # residual-norm backtracking (globalized semi-smooth
                # Newton): the undamped iteration oscillates between
                # active sets at sharply-resolved plastic fronts (the
                # footing level-5 ramp stalls >40 its with crit far
                # above tolerance; the reference never sees this — it
                # cannot represent the mesh size).  Take s*dU with s
                # halved up to `newton_damping` times until the free-DOF
                # residual 2-norm decreases; if it never does, keep the
                # smallest trial (the outer controller's maxit/halving
                # still governs).  Cost: one extra return-map + residual
                # per trial; CG cost (the dominant term) unchanged.
                # crit stays the reference's full-increment measure, so
                # damping can only slow convergence reporting, never
                # fake it.  Single-level lax.while at body top level —
                # never nest lax.cond (CLAUDE.md landmine 9).
                phi0 = jnp.linalg.norm(jnp.where(free_mask, f_int, 0.0))

                def _phi(s_scale):
                    s_c = return_map(_upd(s_scale * dU), ep, zeta)[0]
                    f_c = residual_force(s_c, zeta)
                    return jnp.linalg.norm(jnp.where(free_mask, f_c, 0.0))

                def bt_cond(c):
                    _, phi_s, t = c
                    return (phi_s >= phi0) & (t < newton_damping)

                def bt_body(c):
                    s_scale, _, t = c
                    s2 = jnp.asarray(0.5, s_scale.dtype) * s_scale
                    return (s2, _phi(s2), t + 1)

                one = jnp.asarray(1.0, jnp.float32 if df_mode else dtype)
                s_fin, _, _ = jax.lax.while_loop(
                    bt_cond, bt_body, (one, _phi(one), jnp.asarray(0))
                )
                U_new = _upd(s_fin * dU)
            else:
                U_new = _upd(dU)
            q1, q2, q3 = criterion_norms(dU, u_head(U_it))
            crit = q1 / (q2 + q3)
            fail = jnp.isnan(crit) | ~ok
            import os

            if os.environ.get("FEM_DEBUG_NEWTON"):
                jax.debug.print(
                    "it={it} crit={crit} q1={q1} np={np} dumax={d}",
                    it=it, crit=crit, q1=q1, np=ind_p.sum(),
                    d=jnp.abs(dU).max(),
                )
            U_next = _wsel(fail, U_it, U_new)
            return (
                U_next, dU, crit, it + 1,
                ncg + cg_its.astype(ncg.dtype), fail, defl,
            )

        U, _, crit, nits, ncg, fail, defl = jax.lax.while_loop(
            cond,
            body,
            (
                U_it,
                jnp.zeros((n_dofs,), dtype),
                big,
                jnp.asarray(0),
                jnp.asarray(0),
                jnp.asarray(False),
                defl0,
            ),
        )
        crit = jnp.where(fail, jnp.asarray(jnp.nan, dtype), crit)
        return U, crit, nits, ncg, defl

    if monitor is None:
        monitor = (
            (lambda u, s: df_const(0.0)) if df_mode
            else (lambda u, s: jnp.asarray(0.0, dtype))
        )
    hook = accept_hook if accept_hook is not None else (
        lambda m, aux, crit: (aux, jnp.asarray(1.0, dtype))
    )

    def run(U_it0, aux0, d_zeta0, resume=None):
        """Execute the load-stepping schedule.

        `resume`: optional mapping with keys matching the carry fields
        (`u, u_old, u_it, ep, zeta_old, d_zeta, d_zeta_old, step, aux,
        zeta_hist, monitor_hist, nits_total, ncg_total`) to restart from a
        checkpoint (`utils.checkpoint`); missing keys use fresh values.
        Works in both precisions: df32 carry fields round-trip as DF
        pairs unchanged (`solve/chunked.py`), native floats are cast to
        the solver dtype.
        """
        zeros_h = jnp.zeros((settings.max_steps,), dtype)

        class C(NamedTuple):
            U: jnp.ndarray
            U_old: jnp.ndarray
            U_it: jnp.ndarray
            ep: jnp.ndarray
            zeta_old: jnp.ndarray
            d_zeta: jnp.ndarray
            d_zeta_old: jnp.ndarray
            step: jnp.ndarray
            aux: jnp.ndarray
            zeta_hist: jnp.ndarray
            mon_hist: jnp.ndarray
            nits_total: jnp.ndarray
            ncg_total: jnp.ndarray
            trips: jnp.ndarray
            done: jnp.ndarray
            defl: object = None

        n_int = geom.n_int
        defl0 = (
            None
            if cg_deflate == 0
            else (
                jnp.zeros((n_dofs, cg_deflate), dtype),
                jnp.asarray(0, jnp.int32),
            )
        )
        if df_mode:
            assert pin_zeros is not None, "df32 mode requires pin_zeros"
            U_it0 = df_pin(U_it0, pin_zeros)
            zero_u = DF(jnp.zeros((n_dofs,), dtype), jnp.zeros((n_dofs,), dtype))
            d_zeta0 = d_zeta0 if isinstance(d_zeta0, DF) else df_const(float(d_zeta0))
            c0 = C(
                U=zero_u,
                U_old=DF(-U_it0.hi, -U_it0.lo),
                U_it=U_it0,
                ep=DF(jnp.zeros((4, n_int), dtype), jnp.zeros((4, n_int), dtype)),
                zeta_old=df_const(0.0),
                d_zeta=d_zeta0,
                d_zeta_old=d_zeta0,
                step=jnp.asarray(settings.step0),
                aux=jnp.asarray(aux0, dtype),
                zeta_hist=zeros_h,
                mon_hist=DF(zeros_h, zeros_h),
                nits_total=jnp.asarray(0),
                ncg_total=jnp.asarray(0),
                trips=jnp.asarray(0),
                done=jnp.asarray(False),
                defl=defl0,
            )
        else:
            c0 = C(
                U=jnp.zeros_like(U_it0),
                U_old=-U_it0,
                U_it=U_it0,
                ep=jnp.zeros((4, n_int), dtype),
                zeta_old=jnp.asarray(0.0, dtype),
                d_zeta=jnp.asarray(d_zeta0, dtype),
                d_zeta_old=jnp.asarray(d_zeta0, dtype),
                step=jnp.asarray(settings.step0),
                aux=jnp.asarray(aux0, dtype),
                zeta_hist=zeros_h,
                mon_hist=zeros_h,
                nits_total=jnp.asarray(0),
                ncg_total=jnp.asarray(0),
                trips=jnp.asarray(0),
                done=jnp.asarray(False),
                defl=defl0,
            )
        if resume is not None:
            resume = dict(resume)
            # deflation ring state round-trips as flat keys (npz-able,
            # chunked.carry_of); older checkpoints simply lack them and
            # re-bootstrap from the fresh (zero) basis
            if cg_deflate and "defl_w" in resume:
                resume["defl"] = (
                    jnp.asarray(resume.pop("defl_w"), dtype),
                    jnp.asarray(resume.pop("defl_ring"), jnp.int32),
                )
            else:
                resume.pop("defl_w", None)
                resume.pop("defl_ring", None)
            rename = {
                "u": "U", "u_old": "U_old", "u_it": "U_it",
                "monitor_hist": "mon_hist",
            }

            def _cast(v):
                # df32 carry fields arrive as DF pairs and pass through
                # unchanged (chunked execution / checkpoint round-trips);
                # tuples (the deflation state, pre-cast above) likewise
                if isinstance(v, (DF, tuple)):
                    return v
                a = jnp.asarray(v)
                return jnp.asarray(v, dtype) if a.dtype.kind == "f" else a

            upd = {rename.get(k, k): _cast(v) for k, v in dict(resume).items()}
            c0 = c0._replace(**upd)

        def cond(s):
            return (~s.done) & (s.trips < settings.max_trips)

        def body(s):
            zeta = (
                df_barrier(df_add(s.zeta_old, s.d_zeta))
                if df_mode
                else s.zeta_old + s.d_zeta
            )
            U_conv, crit, nits, ncg, defl = inner_newton(
                s.U_it, s.ep, zeta, s.defl
            )
            accepted = crit < settings.accept_tol  # False for NaN

            s_rm, _, _, _, ep_new = return_map(U_conv, s.ep, zeta, apply=True)
            m = monitor(U_conv, s_rm)
            m_head = m.hi if df_mode else m
            aux_acc, factor = hook(m_head, s.aux, crit)

            U = _wsel(accepted, U_conv, s.U)
            U_old = _wsel(accepted, s.U, s.U_old)
            ep = _wsel(accepted, ep_new, s.ep) if accumulate_ep else s.ep
            zeta_old = _wsel(accepted, zeta, s.zeta_old)
            d_zeta_old = _wsel(accepted, s.d_zeta, s.d_zeta_old)
            # d_zeta: hook factor on accept, halve on reject — both exact
            # scalings, so they commute with the DF representation
            scale = jnp.where(accepted, factor, 0.5)
            d_zeta = (
                DF(s.d_zeta.hi * scale, s.d_zeta.lo * scale)
                if df_mode
                else s.d_zeta * scale
            )
            aux = jnp.where(accepted, aux_acc, s.aux)

            idx = jnp.minimum(s.step, settings.max_steps - 1)
            rec = lambda h, v: h.at[idx].set(jnp.where(accepted, v, h[idx]))
            zeta_head = zeta.hi if df_mode else zeta
            zeta_hist = rec(s.zeta_hist, zeta_head)
            if df_mode:
                mon_hist = DF(rec(s.mon_hist.hi, m.hi), rec(s.mon_hist.lo, m.lo))
            else:
                mon_hist = rec(s.mon_hist, m)
            step = s.step + accepted.astype(s.step.dtype)

            if df_mode:
                ratio = df_div(d_zeta, d_zeta_old)
                U_it = df_pin(
                    df_barrier(df_add(df_mul(df_sub(U, U_old), ratio), U)),
                    pin_zeros,
                )
                ep = df_pin(ep, pin_zeros)
                # the 1e-12 slack absorbs cross-backend rounding in the zeta
                # accumulation (emulated f64 / df32 both round 17*(1/17)
                # just below 1.0 — without slack a spurious step fires)
                done = (
                    df_sub(zeta_old, df_const(settings.zeta_max)).hi >= -1e-12
                ) | (d_zeta.hi < settings.d_zeta_min)
            else:
                U_it = d_zeta * (U - U_old) / d_zeta_old + U
                done = (zeta_old >= settings.zeta_max - 1e-12) | (
                    d_zeta < settings.d_zeta_min
                )
            # the deflation basis advances even on rejected steps — it is
            # a solver aid (affects iteration counts only), and the newest
            # harvest reflects the current tangent best
            return C(
                U=U, U_old=U_old, U_it=U_it, ep=ep, zeta_old=zeta_old,
                d_zeta=d_zeta, d_zeta_old=d_zeta_old, step=step, aux=aux,
                zeta_hist=zeta_hist, mon_hist=mon_hist,
                nits_total=s.nits_total + nits,
                ncg_total=s.ncg_total + ncg.astype(s.ncg_total.dtype),
                trips=s.trips + 1, done=done, defl=defl,
            )

        s = jax.lax.while_loop(cond, body, c0)
        # yielded points = nonzero accumulated plastic strain.  (The yield
        # indicator at the *converged* state is numerically marginal —
        # crit1 ~ 1e-10 — and flips with compilation mode; plastic history
        # is the stable observable.)
        ep_head = s.ep.hi if df_mode else s.ep
        n_plast = jnp.any(ep_head != 0.0, axis=0).sum()
        if axis_name is not None:
            n_plast = jax.lax.psum(n_plast, axis_name)
        return LoadSteppingResult(
            u=s.U,
            ep=s.ep,
            zeta_hist=s.zeta_hist,
            monitor_hist=s.mon_hist,
            n_steps=s.step,
            n_newton_total=s.nits_total,
            zeta=s.zeta_old,
            d_zeta=s.d_zeta,
            n_plastic=n_plast,
            n_cg_total=s.ncg_total,
            u_old=s.U_old,
            u_it=s.U_it,
            d_zeta_old=s.d_zeta_old,
            aux=s.aux,
            defl=s.defl,
        )

    return run
