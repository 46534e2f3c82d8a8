"""Problem configuration dataclasses.

The reference hard-codes all physical and schedule constants inside
`elasticity_fem` (SURVEY.md §5 "Config / flag system"); here they live in
frozen dataclasses whose defaults reproduce each benchmark exactly.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..ops.elements import ElementType


@dataclass(frozen=True)
class ElasticityConfig:
    """Square-with-hole linear elasticity (`Elasticity2D/pythonFEM.py:1052-1179`)."""

    etype: ElementType = ElementType.P1
    level: int = 1
    young: float = 206900.0
    poisson: float = 0.29
    volume_force: tuple = (0.0, -1.0)
    traction_force: tuple = (0.0, 450.0)
    size_xy: float = 10.0
    size_hole: float = 5.0
    dirichlet_scale: float = 0.5  # ud = 0.5 * dirichlet pattern (E:1141)
    dtype: str = "float64"
    # "dense" (reference-parity direct solve) | "cg" (matrix-free
    # block-Jacobi PCG — scales past the reference's dense cliff, which
    # takes >10 min at level 3, E:1151-1159)
    solver: str = "dense"
    cg_tol: float = None  # None -> 1e-12 (f64) / 2e-7 (f32)
    cg_maxiter: int = 5000


@dataclass(frozen=True)
class FootingConfig:
    """Drucker-Prager strip footing (`Plasticity2D_DP/pythonFEM.py:901-1157`)."""

    etype: ElementType = ElementType.P1
    level: int = 1
    young: float = 1e7
    poisson: float = 0.48
    cohesion: float = 450.0
    friction_angle: float = float(np.pi / 9)
    size_xy: float = 10.0
    d_zeta: float = 1e-3
    d_zeta_min_ratio: float = 1.0 / 1300.0
    zeta_max: float = 1.0
    newton_maxit: int = 25
    newton_tol: float = 1e-12
    accept_tol: float = 1e-10
    max_steps: int = 1000  # history buffer length (P:1013)
    # cap on load-loop trips per stepper invocation (resume-chunked
    # execution, solve/chunked.py — see TsxTunnelConfig.max_trips)
    max_trips: int = 10000
    # "dense" | "cg".  An ELL-multigrid footing mode was measured and
    # REJECTED: the elastic V-cycle preconditions this problem's tangent
    # poorly once the plastic zone spans most of the domain (~75% of
    # points at the nu=0.48 limit load) — level 2 took 501 adaptive
    # steps vs 22 with plain block-Jacobi cg (same 17.681 limit
    # pressure).  cg IS the footing scale path (ROADMAP findings).
    solver: str = "dense"
    # solver="cg" + precision="df32": RCM-permute the problem and run
    # tangent CG on an assembled slot operator refreshed from ALL
    # integration points once per Newton iteration (the full-tangent
    # scatter, solve/newton.py corr_full — the elastic+low-rank trick is
    # inapplicable at this problem's ~75% plastic fraction; reference
    # analog: the per-iteration D_p reassembly, P:1047-1050).
    assembled_cg: bool = False
    # solver="cg" + precision="df32" + P1: TRUE tangent multigrid — a
    # red-refinement hierarchy whose every level is refreshed from the
    # current consistent tangent once per Newton iteration
    # (solve/multigrid.py tangent_vcycle).  The scale path past the
    # block-Jacobi CG iteration blowup at level >= 4 (~h^-1 growth at
    # nu=0.48; the ELASTIC hierarchy is measured-rejected at ~75%
    # plastic fraction).  The problem runs on the hierarchy's fine mesh
    # (same node lattice and triangulation as square_mesh(level), fine-
    # RCM node ordering).
    tangent_mg: bool = False
    dense_mode: str = "f64"  # "f64" | "mixed" (f32 Cholesky + f64 refinement)
    # Eisenstat-Walker forcing ceiling for iterative tangent solves
    # (solve/newton.py cg_eta0 doc).  None = fixed cg_tol.
    cg_eta0: float = None
    # iterative tangent solves (solver="cg"); None resolves dtype-aware:
    # 1e-14 (f64) / 2e-7 (f32 preconditioned-residual floor)
    cg_tol: float = None
    cg_maxiter: int = 2000
    cg_structure: str = "while"  # "while" | "scan" (solve/cg.py docstring)
    # accept a CAPPED tangent solve that still cut the preconditioned
    # residual by this factor as an inexact-Newton step instead of
    # divergence (solve/newton.py cg_cap_relax doc — the round-3 L4
    # schedule fragmented to 469 steps under strict cap-as-divergence).
    # None = strict; tangent_mg runs default to 1e-2 (build_df32).
    cg_cap_relax: float = None
    # recycled Krylov deflation basis size for iterative tangent solves
    # (solve/newton.py cg_deflate / solve/cg.py deflate docs): a ring of
    # k orthonormal vectors harvested from every solve and recycled
    # across Newton iterations and load steps, targeting the persistent
    # small-eigenvalue (shear-band) cluster that caps the near-limit
    # solves.  0 = off.
    cg_deflate: int = 0
    # residual-norm backtracking for the semi-smooth Newton iteration
    # (solve/newton.py newton_damping doc): max halvings of the Newton
    # step while the free-DOF residual norm fails to decrease.  0 = the
    # reference's undamped iteration.  Levels >= 5 resolve the footing-
    # edge plastic front sharply enough that the undamped iteration
    # oscillates between active sets (maxit-stall at any tolerance);
    # fast_scale enables 3 halvings there.
    newton_damping: int = 0
    # df32 residual operator format for the scale paths (tangent_mg /
    # assembled_cg): None = "rslot" (ragged compacted-slot, falls back
    # to dense slot when chunking saves <15% — TsxTunnelConfig doc)
    residual_fmt: str = None
    # Reproduce reference defect #2 (apex plastic strain from trial strain,
    # SURVEY.md §2.3) for bit-level comparison runs:
    bug_compatible_apex: bool = False
    dtype: str = "float64"
    # "native" | "df32" (double-float fast path, solve/newton.py docstring)
    precision: str = "native"

    @classmethod
    def fast(cls, **kw):
        """Double-float fast-path preset: all hot ops in f32 hardware, the
        Newton residual/criterion and state in two-f32 pairs.  Follows the
        f64 adaptive schedule (16 accepted steps) with u to ~1e-11 rel.
        newton_tol sits at the df32 criterion floor for this heavily
        plastic, near-incompressible problem (~2e-12 with 775 plastic
        points at nu=0.48) so the pressure-doubling rule (P:1109-1110)
        fires exactly where the f64 run's 1e-12 threshold does; accept_tol
        stays at the reference 1e-10."""
        kw.setdefault("dtype", "float32")
        kw.setdefault("precision", "df32")
        kw.setdefault("newton_tol", 5e-12)
        return cls(**kw)

    @classmethod
    def fast_f32(cls, **kw):
        """Pure-f32 preset (f32 return map + f32 Cholesky).  Tolerances
        sit at the f32 criterion floor; the adaptive schedule may differ
        slightly from the f64 reference trajectory (limit pressure ~1e-4)."""
        kw.setdefault("dtype", "float32")
        kw.setdefault("newton_tol", 1e-6)
        kw.setdefault("accept_tol", 1e-5)
        return cls(**kw)

    @classmethod
    def fast_scale(cls, level: int, **kw):
        """Large-mesh (level >= 4) production preset: tangent multigrid
        + capped-CG relaxation + achievable tolerances.

        The reference tolerances (newton 1e-12 / accept 1e-10) are
        unreachable through f32-preconditioned inexact solves at 50k+
        DOFs: the d_zeta-doubling gate never fires and rejects collapse
        the schedule (a level-4 run fragmented to 469 steps / 6.6M CG
        its).  newton_tol 1e-10 / accept_tol 1e-8 keep the physics
        (level-2 limit pressure agrees with the strict run to 1e-5) with
        a sane schedule: level 4 runs 290 steps / 2270 Newton its /
        3.84M CG its to limit pressure 20.4259 — identical to the strict
        value.  `build_df32_chunked` runs it resumably.

        cg_deflate=16: the recycled A-DEF2 ring halves the near-limit
        capped solves' CG iterations (L4: 3.84M -> 2.84M total its,
        per-Newton-solve 1693 -> 825, identical 20.4259 limit pressure;
        L2 -38% its).  The deflated schedule runs finer steps (L4 290 ->
        ~506).  Set cg_deflate=0 to compare against the undeflated
        baseline."""
        kw.setdefault("solver", "cg")
        kw.setdefault("tangent_mg", True)
        kw.setdefault("cg_maxiter", 3000)
        kw.setdefault("cg_eta0", 1e-2)
        kw.setdefault("newton_tol", 1e-10)
        kw.setdefault("accept_tol", 1e-8)
        kw.setdefault("cg_deflate", 16)
        # level >= 5: globalized (damped) Newton — the undamped
        # iteration stalls on active-set oscillation at the sharply
        # resolved plastic front (newton_damping doc)
        kw.setdefault("newton_damping", 3 if level >= 5 else 0)
        return cls.fast(level=level, **kw)


@dataclass(frozen=True)
class TsxTunnelConfig:
    """TSX tunnel excavation (`tsx-tunnel/pythonFEM.py:1637-1851`)."""

    etype: ElementType = ElementType.P1
    young: float = 60000.0
    poisson: float = 0.2
    cohesion: float = 18.7
    friction_angle: float = float(49.0 * np.pi / 180.0)
    init_stress: tuple = (-45.0, -11.0, 0.0, -60.0)
    d_zeta: float = 1.0 / 17.0
    d_zeta_min_ratio: float = 1.0 / 10.0
    zeta_max: float = 1.0
    newton_maxit: int = 25
    newton_tol: float = 1e-12
    accept_tol: float = 1e-10
    max_steps: int = 100  # history buffer length (T:1758)
    # cap on load-loop trips per stepper invocation; lower it (e.g. 3) to
    # run the schedule in multiple dispatches with resume= chunking
    # (checkpoint/resume, solve/chunked.py)
    max_trips: int = 10000
    monitor_node: int = 40  # tunnel-wall node whose u_x is recorded (T:1813)
    refine_levels: int = 0  # uniform refinements of the P1 mesh before promote
    # "dense" | "cg" | "mg" | "ell" (mg/ell: P1 + refine_levels>0; ell =
    # assembled windowed-ELL multigrid, ops/spmv.py — the problem is
    # permuted onto a locality node ordering, result mesh/u included)
    solver: str = "dense"
    # assembled-operator kernel format for solver="ell": "ell" (windowed
    # ELL) or "slot" (compacted-slot, ops/spmv.py build_slot — a slot
    # count independent of the mesh bandwidth)
    spmv_fmt: str = "slot"
    # plastic tangent correction for the assembled-operator CG
    # (solver="ell", P1): "gather" applies the low-rank B^T (w*delta) B
    # correction as a gather/segment-sum operator every CG iteration;
    # "scatter" refreshes a copy of the fine-level slot VALUE stream once
    # per Newton iteration (static-sparsity scatter via a host-built
    # dest-position table, ops/spmv.py element_corr_dest) so every CG
    # matvec is a single slot kernel.  Same operator up to f32 rounding.
    corr_mode: str = "gather"
    # high-order (P2/P4) tangent CG operator: None = auto (currently the
    # matrix-free path; measured decision pending), True = apply the
    # tangent as S(d * (G v)) on the f32 heads of the assembled df32
    # strain/force slot operators (solve/newton.py gs_tangent), False =
    # matrix-free gather path
    gs_tangent: bool = None
    # df32 elastic-predictor iterative-refinement passes (precision
    # "df32", iterative solvers): each pass gains the inner PCG solve's
    # relative accuracy (~cg_tol); 4 reaches the ~1e-14 df floor with
    # margin.  Each pass is a full inner solve, so shaving one pays
    # where the trajectory tolerates it.
    predictor_ir_iters: int = 4
    # df32 residual operator format: None = auto ("slot" below 100k
    # integration points, "rslot" above: the ragged chunking keeps the
    # slot layout compact at scale); "slot" | "rslot" | "ell" to force
    residual_fmt: str = None
    dense_mode: str = "f64"  # "f64" | "mixed" (f32 Cholesky + f64 refinement)
    # precision="df32": assembled host-built slot operators.
    # solver="cg": tangent CG runs as K_elastic (compacted-slot matvec) +
    # a low-rank plastic correction, and the Newton residual on assembled
    # df32 G/S slot operators — replaces the serialized matrix-free
    # gather path for ANY element type (the ell solver is the
    # P1-multigrid variant); the problem is permuted onto an RCM locality
    # node ordering (result mesh/u/ep restored, like ell).
    # solver="dense": only the df32 G/S residual operators are assembled
    # (no permutation; the tangent stays the dense factor path).
    assembled_cg: bool = False
    # iterative tangent solves (solver="cg"/"mg"); cg_tol None resolves to
    # 1e-14 (native f64) / 2e-7 (df32 — the f32 PCG residual floor; the
    # df32 residual/criterion still deliver f64-grade stopping behavior)
    cg_tol: float = None
    cg_maxiter: int = 2000
    cg_structure: str = "while"  # "while" | "scan" (solve/cg.py docstring)
    # Eisenstat-Walker forcing ceiling for iterative tangent solves
    # (solve/newton.py cg_eta0 doc): iteration k's CG tolerance is
    # clip(0.1 * crit_{k-1}, cg_tol, cg_eta0).  None = fixed cg_tol.
    cg_eta0: float = None
    # capped-CG acceptance factor (solve/newton.py cg_cap_relax doc);
    # None = strict cap-as-divergence (the tsx solves never brush the
    # cap at the documented settings, so this is a safety valve here)
    cg_cap_relax: float = None
    # recycled Krylov deflation basis size for the iterative tangent
    # solves (solve/newton.py cg_deflate doc).  0 = off.
    cg_deflate: int = 0
    dtype: str = "float64"
    # Reproduce reference defect #3-bis (PARITY.md): the tsx reference never
    # applies the plastic-strain update, so Ep_old is re-zeroed each step
    # (`tsx-tunnel/pythonFEM.py:1808-1809`); True restores that behavior for
    # bit-level comparisons against the raw reference (u40 -1.979449671e-3
    # instead of the fixed-semantics -1.979449964e-3, ~1.5e-7 apart).
    bug_compatible_ep_reset: bool = False
    # V-cycle pre/post smoothing sweeps (solver="mg"/"ell"); the V-cycle
    # dominates per-CG-iteration cost at scale, so nu trades
    # preconditioner strength (CG iteration count) against
    # per-application cost
    mg_nu: int = 2
    # V-cycle shape for solver="ell": "v" | "w" (make_vcycle_ell cycle
    # doc — W revisits sub-levels twice; coarse work is cheap at scale)
    mg_cycle: str = "v"
    # windowed-ELL overflow budget (ops/spmv.py build_ell /
    # build_ell_df): larger values shrink the window J (smaller main
    # operator, faster kernel) but grow the exact slot-df overflow side
    # operator; tune on hardware at level >= 4 (ROADMAP r2 #1)
    ell_overflow_frac: float = 0.005
    # Tunnel support pressure (MPa), ramped with the excavation factor and
    # applied as a normal traction on the tunnel-wall edges via the
    # arc-length surface rules (beyond-reference: the reference's surface
    # load hooks are commented out, `tsx-tunnel/pythonFEM.py:1705-1708`).
    support_pressure: float = 0.0
    # "native" | "df32" (double-float fast path, solve/newton.py docstring)
    precision: str = "native"

    @classmethod
    def fast(cls, **kw):
        """Double-float fast-path preset: every hot op in f32 hardware
        (f32 Cholesky + elastic-factor reuse), the Newton residual /
        criterion / state in two-f32 pairs — the reference's 1e-12/1e-10
        tolerances, 17/28 trajectory and ~1e-11 displacement accuracy at
        fast-path speed."""
        kw.setdefault("dtype", "float32")
        kw.setdefault("precision", "df32")
        return cls(**kw)

    @classmethod
    def fast_f32(cls, **kw):
        """Pure-f32 preset: f32 return map, f32 Cholesky,
        tolerances at the f32 criterion floor.  Wall displacement agrees
        with the f64 parity run to ~2e-8 relative on the tsx benchmark; the
        reference's 1e-12/1e-10 tolerances need df32 or f64."""
        kw.setdefault("dtype", "float32")
        kw.setdefault("newton_tol", 1e-6)
        kw.setdefault("accept_tol", 1e-5)
        return cls(**kw)

    @classmethod
    def fast_scale(cls, refine_levels: int, **kw):
        """Large-mesh df32 preset: geometric-multigrid-preconditioned
        inexact-Newton tangent solves at cg_tol 1e-5 (measured
        trajectory-identical digits vs tol 2e-7 at level 2) — ~8 PCG
        iterations per tangent solve instead of 40+.  The V-cycle runs on
        assembled slot operators (solver="ell", ops/spmv.py) — pass
        solver="mg" for the matrix-free variant."""
        kw.setdefault("solver", "ell")
        kw.setdefault("cg_tol", 1e-5)
        kw.setdefault("cg_maxiter", 200)
        # static-structure tangent refresh (corr_mode doc): one scatter
        # per Newton iteration instead of a gather correction per CG
        # iteration, identical trajectories
        kw.setdefault("corr_mode", "scatter")
        # 3 IR passes reach the df floor here (inner MG-PCG at 1e-5):
        # the identical L4 17/52/605 trajectory and u40 to 12 digits;
        # 2 passes cost one extra Newton iteration
        kw.setdefault("predictor_ir_iters", 3)
        # Eisenstat-Walker forcing: -35% CG iterations at an identical
        # trajectory (17/37, monitor to 10 digits, measured level 1);
        # scale-preset only — P4's p-MG tangent needs its 2e-7 floor
        # from the first iteration and is configured separately
        kw.setdefault("cg_eta0", 1e-2)
        return cls.fast(refine_levels=refine_levels, **kw)
