"""Strip-footing Drucker-Prager end-to-end tests (SURVEY.md §8.4 anchors)."""
import numpy as np
import pytest

from fem_elastoplasticity_tpu.models.config import FootingConfig
from fem_elastoplasticity_tpu.models.footing import solve
from fem_elastoplasticity_tpu.ops.elements import ElementType

# pressure history of the unmodified reference run (P1, level 1), captured
# via the in-repo instrumentation described in SURVEY.md §8.4
REFERENCE_PRESSURES = np.array(
    [
        8.39724807,
        13.20017031,
        15.73188141,
        16.14965303,
        16.27589772,
        16.3163306,
        16.38698285,
        16.5422787,
        16.62435145,
        16.69057978,
        16.77442565,
        16.83580515,
        16.85149363,
        16.84581189,
        16.83867399,
        16.83636362,
    ]
)


@pytest.fixture(scope="module")
def result():
    return solve(FootingConfig())


class TestAnchors:
    def test_step_count_and_termination(self, result):
        # 16 accepted steps reach zeta >= 1 ("maximal load factor")
        assert result.n_steps == 16
        assert np.asarray(result.zeta_hist).max() >= 1.0

    def test_adaptive_doubling_schedule(self, result):
        # d_zeta doubles repeatedly: zeta_hist ends at 1.032 (SURVEY §8.4)
        z = np.asarray(result.zeta_hist[1:17])
        assert abs(z[-1] - 1.032) < 1e-12
        assert abs(z[0] - 1e-3) < 1e-15

    def test_pressure_curve(self, result):
        """Fixed-semantics run tracks the reference pressure curve.

        The late-step gap (~2e-5 rel) is the reference's apex-ep aliasing
        defect (SURVEY.md §2.3 #2), which we fix by default."""
        mine = np.asarray(result.pressure_hist[1:17])
        rel = np.abs(mine - REFERENCE_PRESSURES).max() / REFERENCE_PRESSURES.max()
        assert rel < 1e-4

    def test_cg_solver_tracks_dense(self, result):
        """Matrix-free block-Jacobi PCG on the near-incompressible footing
        (nu = 0.48): pressures are identical on the common schedule prefix
        and the limit pressure agrees to ~2e-5.  The adaptive schedules
        fork at one doubling decision (`crit < 1e-12` is a sharp branch on
        a solver-noise-level quantity), so the CG run takes finer steps
        (41 vs 16) but completes the same ramp — legitimate
        schedule-dependence of the reference's controller semantics."""
        r = solve(FootingConfig(solver="cg"))
        p_d = np.asarray(result.pressure_hist)
        p_c = np.asarray(r.pressure_hist)
        np.testing.assert_allclose(p_c[1:8], p_d[1:8], rtol=1e-9)
        assert np.asarray(r.zeta_hist)[r.n_steps] >= 1.0 - 1e-12
        pd, pc = p_d[result.n_steps], p_c[r.n_steps]
        assert abs(pc - pd) / pd < 1e-4

    def test_bug_compatible_mode_matches_reference_tightly(self):
        r = solve(FootingConfig(bug_compatible_apex=True))
        mine = np.asarray(r.pressure_hist[1:17])
        rel = np.abs(mine - REFERENCE_PRESSURES).max() / REFERENCE_PRESSURES.max()
        assert rel < 1e-8

    def test_capped_cg_relax_defragments_schedule(self):
        """cg_cap_relax (solve/newton.py): a capped tangent solve that
        still cut the preconditioned residual 100x counts as an
        inexact-Newton step instead of divergence.  Under a tight
        iteration cap the strict policy collapses d_zeta at the very
        first load step (the footing L4 fragmentation); the relaxed
        policy completes the same truncated ramp
        with the reference pressure."""
        ref = solve(FootingConfig.fast(solver="cg", zeta_max=0.1))
        strict = solve(
            FootingConfig.fast(solver="cg", zeta_max=0.1, cg_maxiter=300)
        )
        # strict cap-as-divergence dies immediately: d_zeta collapses
        assert float(np.asarray(strict.zeta_hist).max()) < 0.01
        relaxed = solve(
            FootingConfig.fast(
                solver="cg", zeta_max=0.1, cg_maxiter=600,
                cg_cap_relax=1e-2,
            )
        )
        assert float(np.asarray(relaxed.zeta_hist).max()) >= 0.1
        p_ref = float(ref.pressure_hist[ref.n_steps])
        p_rel = float(relaxed.pressure_hist[relaxed.n_steps])
        assert abs(p_rel - p_ref) / p_ref < 1e-2
        # de-fragmentation: step count within 2x of the uncapped run
        assert relaxed.n_steps <= 2 * ref.n_steps

    def test_limit_pressure_plateau(self, result):
        # pressure plateaus near the bearing-capacity limit
        p = np.asarray(result.pressure_hist[1:17])
        assert abs(p[-1] - p[-4]) < 0.02 * p[-1]

    def test_plasticity_develops(self, result):
        # ~770 integration points yield by zeta=1 in the reference run
        assert result.n_plastic > 500


# Differential anchors for the non-P1 element types the reference driver
# accepts (`Plasticity2D_DP/pythonFEM.py:901` takes any LagrangeElementType;
# its structured generators cover Q1/P2/Q2 via get_nodes_1/2).  Captured from
# the unmodified reference at level 0 (instrumented /tmp copy, 2026-08-19):
# accepted zeta schedule and the per-step footing pressures (pressure_hist
# re-aligned to the zeta index — the reference writes it one slot ahead,
# PARITY.md).  Bit-level comparison requires bug_compatible_apex=True
# (reference defect #2); fixed-semantics pressures differ by 1e-5..3e-4.
REFERENCE_BY_ETYPE = {
    "Q1": (
        [0.001, 0.002, 0.003, 0.004, 0.005, 0.006, 0.007, 0.008,
         0.009000000000000001, 0.010000000000000002, 0.011000000000000003,
         0.012000000000000004, 0.013000000000000005, 0.014000000000000005,
         0.016000000000000007, 0.01800000000000001, 0.02000000000000001,
         0.022000000000000013, 0.026000000000000013, 0.030000000000000013,
         0.034000000000000016, 0.042000000000000016, 0.05800000000000002,
         0.09000000000000002, 0.15400000000000003, 0.28200000000000003,
         0.538, 1.05],
        [7.066584624066, 11.872691814169, 14.754590995634, 15.864201634820,
         16.380979387862, 16.763258898143, 17.077673840919, 17.353698939237,
         17.602557267730, 17.816820327038, 17.998526575463, 18.135559673360,
         18.246825500316, 18.345782837094, 18.487399304369, 18.621132470342,
         18.731168466610, 18.825099842911, 18.989545158304, 19.130213219380,
         19.167958540875, 19.214533742022, 19.232930754932, 19.211583489123,
         19.190509184119, 19.161095589909, 19.142843433049, 19.137751283878],
    ),
    "P2": (
        [0.001, 0.002, 0.003, 0.004, 0.005, 0.007, 0.011, 0.019, 0.035,
         0.067, 0.131, 0.259, 0.515, 0.771, 1.283],
        [7.017887375300, 10.943356204479, 11.907667438991, 12.034015796235,
         12.071678019092, 12.102540829359, 12.130942950170, 12.149767325164,
         12.158524193373, 12.150197353115, 12.136946342945, 12.135277741367,
         12.137200831039, 12.136897885656, 12.137579537381],
    ),
    "Q2": (
        [0.001, 0.002, 0.003, 0.004, 0.005, 0.006, 0.008, 0.01, 0.012,
         0.016, 0.024, 0.04, 0.07200000000000001, 0.136, 0.264, 0.52, 1.032],
        [6.676910492399, 10.604753582870, 12.040938711140, 12.326762371045,
         12.475859818171, 12.560030120128, 12.692436614590, 12.796671472338,
         12.861323123328, 12.944704396284, 13.030176395875, 13.085259400023,
         13.135558824839, 13.164732847222, 13.172984170041, 13.172490290116,
         13.168795911291],
    ),
}


class TestElementTypes:
    """Q1/P2/Q2 end-to-end footing solves vs the instrumented reference."""

    @pytest.mark.parametrize("etype", ["Q1", "P2", "Q2"])
    def test_schedule_and_pressures_match_reference(self, etype):
        ref_z, ref_p = REFERENCE_BY_ETYPE[etype]
        r = solve(
            FootingConfig(
                etype=getattr(ElementType, etype),
                level=0,
                bug_compatible_apex=True,
            )
        )
        n = int(r.n_steps)
        assert n == len(ref_z)
        np.testing.assert_allclose(
            np.asarray(r.zeta_hist[1 : n + 1]), ref_z, rtol=0, atol=0
        )
        p = np.asarray(r.pressure_hist[1 : n + 1])
        rel = np.abs(p - ref_p).max() / np.max(ref_p)
        assert rel < 1e-11, rel


class TestFastPath:
    def test_df32_fast_preset_follows_f64_schedule(self):
        """The double-float fast preset reproduces the f64 adaptive
        schedule (16 steps, identical zeta history) with the displacement
        field at ~1e-11 and the pressure curve at ~1e-6 relative."""
        rf = solve(FootingConfig.fast())
        r64 = solve(FootingConfig())
        assert rf.n_steps == r64.n_steps == 16
        z32 = np.asarray(rf.zeta_hist[1:17])
        z64 = np.asarray(r64.zeta_hist[1:17])
        np.testing.assert_allclose(z32, z64, rtol=1e-6)
        u_rel = np.abs(rf.u - r64.u).max() / np.abs(r64.u).max()
        assert u_rel < 1e-9
        p_rel = (
            np.abs(rf.pressure_hist[1:17] - r64.pressure_hist[1:17]).max()
            / np.abs(r64.pressure_hist[1:17]).max()
        )
        assert p_rel < 1e-5

    def test_df32_cg_limit_pressure(self):
        """df32 with matrix-free block-Jacobi PCG tangent solves (the
        large-mesh footing path, ROADMAP r2 #9): the inexact tangents at
        nu=0.48 cost extra adaptive steps (26 vs dense 16; native f64 cg
        takes 28 — a solver characteristic, not a df32 artifact) but the
        run completes to zeta=1 with the same bearing-capacity limit."""
        rf = solve(FootingConfig.fast(solver="cg"))
        r64 = solve(FootingConfig())
        assert np.asarray(rf.zeta_hist).max() >= 1.0
        p = float(rf.pressure_hist[rf.n_steps])
        p64 = float(r64.pressure_hist[16])
        assert abs(p - p64) / p64 < 5e-4

    def test_assembled_full_tangent_matches_cg(self):
        """assembled_cg: tangent CG runs on the slot operator refreshed
        from ALL integration points once per Newton iteration (the
        full-tangent scatter, solve/newton.py corr_full — this problem's
        ~75% plastic fraction rules out the elastic+low-rank trick).
        Pressure-curve parity with the matrix-free cg path."""
        rf = solve(FootingConfig.fast(solver="cg", cg_maxiter=4000))
        ra = solve(
            FootingConfig.fast(
                solver="cg", cg_maxiter=4000, assembled_cg=True
            )
        )
        assert np.asarray(ra.zeta_hist).max() >= 1.0
        # same operator up to f32 rounding -> same adaptive schedule
        assert ra.n_steps == rf.n_steps
        np.testing.assert_allclose(
            np.asarray(ra.zeta_hist[1 : ra.n_steps + 1]),
            np.asarray(rf.zeta_hist[1 : rf.n_steps + 1]),
            rtol=1e-9,
        )
        p_a = np.asarray(ra.pressure_hist[1 : ra.n_steps + 1])
        p_f = np.asarray(rf.pressure_hist[1 : rf.n_steps + 1])
        assert np.abs(p_a - p_f).max() / np.abs(p_f).max() < 1e-6

    @pytest.mark.parametrize(
        "etype,level", [(ElementType.Q1, 1), (ElementType.Q2, 1)]
    )
    def test_assembled_quads_match_cg(self, etype, level):
        """Quad elements run the assembled full-tangent scale path too
       : the slot operator build, the corr_full scatter
        table and the G/S residual operators are element-type generic.
        Truncated ramp; the adaptive schedules may fork at sharp
        controller branches (f32 operator rounding), so the check is
        pressure parity."""
        kw = dict(level=level, zeta_max=0.05, etype=etype)
        r0 = solve(FootingConfig.fast(solver="cg", **kw))
        r1 = solve(FootingConfig.fast(solver="cg", assembled_cg=True, **kw))
        p0 = float(r0.pressure_hist[r0.n_steps])
        p1 = float(r1.pressure_hist[r1.n_steps])
        assert abs(p1 - p0) / abs(p0) < 5e-3
        # common-prefix pressures match tightly before any fork
        n = min(r0.n_steps, r1.n_steps, 6)
        np.testing.assert_allclose(
            np.asarray(r1.pressure_hist[1 : n + 1]),
            np.asarray(r0.pressure_hist[1 : n + 1]),
            rtol=1e-5,
        )

    def test_chunked_checkpoint_survives_interruption(self, tmp_path):
        """The generic chunked executor (solve/chunked.py) drives the
        footing df32 solve: an interrupted checkpointed run resumes
        bit-identically to the single-dispatch result (mirrors the tsx
        test: chunked execution is model-generic)."""
        from fem_elastoplasticity_tpu.models import footing as ftg

        cfg = FootingConfig.fast()
        run, args, mesh = ftg.build_df32(cfg)
        full = run(args)
        ck = str(tmp_path / "carry.npz")
        ex1, _ = ftg.build_df32_chunked(cfg, trips_per_chunk=3, max_chunks=2)
        r1 = ex1(checkpoint_path=ck)
        assert int(r1.n_steps) < int(full.n_steps)  # interrupted
        ex2, _ = ftg.build_df32_chunked(cfg, trips_per_chunk=3)
        r2 = ex2(checkpoint_path=ck)
        f64 = lambda p: np.asarray(p.hi, np.float64) + np.asarray(
            p.lo, np.float64
        )
        assert int(r2.n_steps) == int(full.n_steps)
        assert int(r2.n_newton_total) == int(full.n_newton_total)
        np.testing.assert_array_equal(f64(r2.u), f64(full.u))

    @pytest.mark.skipif(
        "FEM_SLOW" not in __import__("os").environ,
        reason="tangent-MG footing runs minutes on the CPU mesh "
        "(set FEM_SLOW=1)",
    )
    def test_tangent_mg_matches_cg_truncated(self):
        """TRUE tangent multigrid (solve/multigrid.py tangent_vcycle):
        every hierarchy level Galerkin-refreshed from the consistent
        tangent per Newton iteration.  The adaptive schedules differ
        (tangent_mg defaults cg_cap_relax=1e-2, so capped solves are
        accepted as inexact-Newton steps instead of halving d_zeta), so
        the check is the physics — the pressure-vs-zeta curve matches
        the block-Jacobi cg path — plus preconditioner quality: fewer
        CG its per Newton iteration.  (Round-3's ~3x held under strict
        cap-as-divergence, which fragmented the schedule onto easier
        sub-steps; with cap-relax the mix includes the hard near-limit
        solves and the measured ratio is ~0.64 — the stressed-tangent
        analysis in the ROADMAP findings.)"""
        kw = dict(solver="cg", level=2, zeta_max=0.2, cg_maxiter=4000)
        r_cg = solve(FootingConfig.fast(**kw))
        r_t = solve(FootingConfig.fast(tangent_mg=True, **kw))
        assert float(np.asarray(r_t.zeta_hist).max()) >= 0.2
        z_c = np.asarray(r_cg.zeta_hist[1 : r_cg.n_steps + 1])
        p_c = np.asarray(r_cg.pressure_hist[1 : r_cg.n_steps + 1])
        z_t = np.asarray(r_t.zeta_hist[1 : r_t.n_steps + 1])
        p_t = np.asarray(r_t.pressure_hist[1 : r_t.n_steps + 1])
        p_c_at_t = np.interp(z_t, z_c, p_c)
        assert np.abs(p_t - p_c_at_t).max() / np.abs(p_c).max() < 2e-3
        per_c = r_cg.n_cg_total / r_cg.n_newton_total
        per_t = r_t.n_cg_total / r_t.n_newton_total
        assert per_t < 0.75 * per_c

    def test_fast_f32_preset_limit_pressure(self):
        """Pure-f32 path: schedule differs (f32 criterion floor) but the
        bearing-capacity limit matches the f64 run to ~1e-4."""
        rf = solve(FootingConfig.fast_f32())
        r64 = solve(FootingConfig())
        p32 = float(rf.pressure_hist[rf.n_steps])
        p64 = float(r64.pressure_hist[16])
        assert abs(p32 - p64) / p64 < 5e-4
        assert np.asarray(rf.zeta_hist).max() >= 1.0
