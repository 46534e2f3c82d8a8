"""Multi-device (shard_map) and ensemble (vmap) tests on the virtual CPU mesh."""
import jax
import numpy as np
import pytest

from fem_elastoplasticity_tpu.models.config import TsxTunnelConfig
from fem_elastoplasticity_tpu.models.tsx_tunnel import solve, solve_sharded
from fem_elastoplasticity_tpu.parallel.ensemble import material_grid, solve_tsx_ensemble


@pytest.fixture(scope="module")
def single_cg():
    return solve(TsxTunnelConfig(solver="cg"))


class TestShardMap:
    @pytest.mark.parametrize("n_devices", [2, 8])
    def test_sharded_matches_single_device(self, single_cg, n_devices):
        if len(jax.devices()) < n_devices:
            pytest.skip("not enough devices")
        r = solve_sharded(TsxTunnelConfig(), n_devices=n_devices)
        assert r.n_steps == single_cg.n_steps
        assert r.n_newton_total == single_cg.n_newton_total
        np.testing.assert_allclose(
            np.asarray(r.u), np.asarray(single_cg.u), atol=1e-14
        )

    @pytest.mark.parametrize("n_devices", [2, 8])
    def test_sharded_df32_matches_single_device(self, n_devices):
        """Multi-chip df32 (solve_sharded_df32): element-sharded fast path
        with the exact compensated all-reduce reproduces the single-device
        df32 cg trajectory to the df32 floor."""
        from fem_elastoplasticity_tpu.models.tsx_tunnel import (
            solve_sharded_df32,
        )

        if len(jax.devices()) < n_devices:
            pytest.skip("not enough devices")
        cfg = TsxTunnelConfig.fast(solver="cg")
        r1 = solve(cfg)
        r = solve_sharded_df32(cfg, n_devices=n_devices)
        assert r.n_steps == r1.n_steps == 17
        np.testing.assert_allclose(
            np.asarray(r.u), np.asarray(r1.u),
            atol=1e-12 * float(np.abs(np.asarray(r1.u)).max()),
        )

    def test_padding_inert(self):
        """887 elements over 8 devices needs padding; results identical."""
        if len(jax.devices()) < 3:
            pytest.skip("not enough devices")
        # 887 is prime: every shard count pads
        r3 = solve_sharded(TsxTunnelConfig(zeta_max=3 / 17), n_devices=3)
        r2 = solve_sharded(TsxTunnelConfig(zeta_max=3 / 17), n_devices=2)
        np.testing.assert_allclose(np.asarray(r3.u), np.asarray(r2.u), atol=1e-14)


class TestShardedScale:
    """Multi-chip PRODUCTION path: the assembled slot/ELL operators, the
    fused-sweep MG hierarchy, the transfer operators and the df32 G/S
    residual operators row-partitioned over the device mesh
    (`build_df32(shard_devices=...)` / `ops.spmv.ShardedMeta`).  Unlike
    TestShardMap (matrix-free CG on the parity mesh), this is the solver
    configuration that runs the at-scale benchmarks."""

    def test_full_schedule_matches_single_device(self):
        """fast_scale(1) (3.5k elements), full 17-step adaptive schedule
        on 8 devices: bit-identical to the single-device solve (the local
        kernels are the unchanged single-device kernels on their rows and
        the gather is exact concatenation)."""
        from fem_elastoplasticity_tpu.models.tsx_tunnel import (
            _solve_df32,
            solve_sharded_scale,
        )

        if len(jax.devices()) < 8:
            pytest.skip("not enough devices")
        # the default scatter tangent refresh runs sharded too: each
        # device shifts the global dest positions by its row-block
        # offset and drops out-of-slice entries (newton corr_shard_axis)
        # — local values equal the single-device slice bit-for-bit
        cfg = TsxTunnelConfig.fast_scale(1)
        r = solve_sharded_scale(cfg, n_devices=8)
        r1 = _solve_df32(cfg)
        assert r.n_steps == r1.n_steps == 17
        assert r.n_newton_total == r1.n_newton_total
        np.testing.assert_array_equal(
            np.asarray(r.zeta_hist), np.asarray(r1.zeta_hist)
        )
        np.testing.assert_array_equal(np.asarray(r.u), np.asarray(r1.u))

    def test_shard_count_invariance(self):
        """Row-block padding differs per shard count (3.5k elements over
        3 vs 5 devices); padded superblocks must stay inert."""
        from fem_elastoplasticity_tpu.models.tsx_tunnel import (
            solve_sharded_scale,
        )

        if len(jax.devices()) < 5:
            pytest.skip("not enough devices")
        cfg = TsxTunnelConfig.fast_scale(1, zeta_max=3.0 / 17.0)
        r3 = solve_sharded_scale(cfg, n_devices=3)
        r5 = solve_sharded_scale(cfg, n_devices=5)
        assert r3.n_steps == r5.n_steps >= 3
        np.testing.assert_array_equal(np.asarray(r3.u), np.asarray(r5.u))

    def test_footing_tangent_mg_sharded_bit_identical(self):
        """The footing's scale path (tangent multigrid) under
        shard_map: hierarchy/transfer/G-S operators row-sharded, the
        per-Newton-iteration tangent refresh replicated with per-device
        superblock slices (solve/multigrid.py tangent_vcycle sharded
        doc).  Truncated ramp, bit-identical to single-device."""
        from fem_elastoplasticity_tpu.models import footing
        from fem_elastoplasticity_tpu.models.config import FootingConfig

        if len(jax.devices()) < 8:
            pytest.skip("not enough devices")
        cfg = FootingConfig.fast(
            solver="cg", level=2, tangent_mg=True, zeta_max=0.004
        )
        run1, args1, _ = footing.build_df32(cfg)
        r1 = run1(args1)
        run8, args8, _ = footing.build_df32(cfg, shard_devices=8)
        r8 = run8(args8)
        assert int(r8.n_steps) == int(r1.n_steps)
        assert int(r8.n_cg_total) == int(r1.n_cg_total)
        f64 = lambda p: np.asarray(p.hi, np.float64) + np.asarray(
            p.lo, np.float64
        )
        np.testing.assert_array_equal(f64(r8.u), f64(r1.u))
        np.testing.assert_array_equal(
            np.asarray(r8.zeta_hist), np.asarray(r1.zeta_hist)
        )

    @pytest.mark.skipif(
        "FEM_SLOW" not in __import__("os").environ,
        reason="level-2 sharded full schedule is slow on the CPU mesh "
        "(set FEM_SLOW=1)",
    )
    def test_level2_full_schedule(self):
        from fem_elastoplasticity_tpu.models.tsx_tunnel import (
            _solve_df32,
            solve_sharded_scale,
        )

        if len(jax.devices()) < 8:
            pytest.skip("not enough devices")
        cfg = TsxTunnelConfig.fast_scale(2)
        r = solve_sharded_scale(cfg, n_devices=8)
        r1 = _solve_df32(cfg)
        assert r.n_steps == r1.n_steps
        np.testing.assert_array_equal(np.asarray(r.u), np.asarray(r1.u))


class TestHardwareSafety:
    """No jitted production program may embed array constants
    (`utils.jitsafe` guard)."""

    def test_guard_detects_embedded_constants(self):
        import jax.numpy as jnp

        from fem_elastoplasticity_tpu.utils.jitsafe import (
            assert_no_embedded_constants,
        )

        big = jnp.arange(1000, dtype=jnp.float32)

        @jax.jit
        def bad(x):
            return x + big  # closure constant — the forbidden idiom

        @jax.jit
        def good(x, t):
            return x + t

        with pytest.raises(AssertionError):
            assert_no_embedded_constants(bad, (jnp.ones((1000,)),))
        assert_no_embedded_constants(good, (jnp.ones((1000,)), big))

    def test_element_sharded_paths_are_constant_free(self):
        """solve_sharded / solve_sharded_df32 lower without embedded
        array constants (geometry passes through args)."""
        from fem_elastoplasticity_tpu.models.tsx_tunnel import (
            solve_sharded_df32,
        )

        if len(jax.devices()) < 2:
            pytest.skip("not enough devices")
        r = solve_sharded(
            TsxTunnelConfig(zeta_max=2 / 17), n_devices=2,
            check_constants=True,
        )
        assert r.n_steps == 2
        rd = solve_sharded_df32(
            TsxTunnelConfig.fast(solver="cg", zeta_max=2 / 17),
            n_devices=2, check_constants=True,
        )
        assert rd.n_steps == 2

    def test_production_df32_program_is_constant_free(self):
        """The single-device production builder (build_df32, ell solver)
        lowers without embedded array constants."""
        from fem_elastoplasticity_tpu.models.tsx_tunnel import build_df32
        from fem_elastoplasticity_tpu.utils.jitsafe import (
            assert_no_embedded_constants,
        )

        cfg = TsxTunnelConfig.fast_scale(1, zeta_max=2 / 17)
        run, args, _ = build_df32(cfg)
        assert_no_embedded_constants(run, (args,))


class TestEnsemble:
    def test_vmap_matches_individual_solves(self):
        cohesions = np.array([15.0, 18.7])
        frictions = np.array([49.0 * np.pi / 180])
        eta, c = material_grid(cohesions, frictions)
        ens = solve_tsx_ensemble(eta, c)
        assert ens.u.shape[0] == 2
        # member 1 is the default material: must match the single solve
        ref = solve(TsxTunnelConfig())
        np.testing.assert_allclose(
            np.asarray(ens.u[1]), np.asarray(ref.u), atol=1e-12
        )
        assert int(ens.n_steps[1]) == ref.n_steps

    def test_weaker_material_yields_more(self):
        eta, c = material_grid(
            np.array([10.0, 18.7]), np.array([49.0 * np.pi / 180])
        )
        ens = solve_tsx_ensemble(eta, c)
        # lower cohesion -> more plastic points, larger wall displacement
        assert int(ens.n_plastic[0]) >= int(ens.n_plastic[1])
        assert abs(float(ens.monitor_hist[0, 16])) >= abs(
            float(ens.monitor_hist[1, 16])
        )


class TestEnsembleSharded:
    """Member-axis device sharding (SURVEY §2.4 '64-way' ensembles)."""

    @pytest.mark.parametrize("n_devices", [4, 8])
    def test_sharded_members_match_vmap_ensemble(self, n_devices):
        """6 members over 4/8 devices (8 pads with member-0 copies):
        every member matches the single-device vmap ensemble at the f64
        floor, with identical adaptive schedules."""
        from fem_elastoplasticity_tpu.parallel.ensemble import (
            solve_tsx_ensemble_df32,
        )

        if len(jax.devices()) < n_devices:
            pytest.skip("not enough devices")
        eta, c = material_grid(
            np.array([15.0, 18.7, 25.0]),
            np.array([49.0 * np.pi / 180, 45.0 * np.pi / 180]),
        )
        e1 = solve_tsx_ensemble_df32(eta, c)
        es = solve_tsx_ensemble_df32(eta, c, shard_devices=n_devices)
        assert es.u.shape == e1.u.shape
        np.testing.assert_array_equal(
            np.asarray(es.n_steps), np.asarray(e1.n_steps)
        )
        np.testing.assert_array_equal(
            np.asarray(es.zeta_hist), np.asarray(e1.zeta_hist)
        )
        np.testing.assert_allclose(
            np.asarray(es.u), np.asarray(e1.u), rtol=0, atol=1e-14
        )


class TestEnsembleDf32:
    def test_member_matches_single_df32_solve(self):
        """Each df32 ensemble member is an f64-grade solve: the reference
        material reproduces the single df32 solve bit-for-bit (17/28
        trajectory, exact u40)."""
        from fem_elastoplasticity_tpu.parallel.ensemble import (
            solve_tsx_ensemble_df32,
        )

        eta, c = material_grid(
            np.array([18.7, 25.0]), np.array([49.0 * np.pi / 180])
        )
        ens = solve_tsx_ensemble_df32(eta, c)
        ref = solve(TsxTunnelConfig.fast())
        assert int(ens.n_steps[0]) == 17
        assert int(ens.n_newton_total[0]) == ref.n_newton_total
        np.testing.assert_allclose(
            np.asarray(ens.u[0]), np.asarray(ref.u), rtol=0, atol=1e-15
        )
        # stiffer member stays elastic
        assert int(ens.n_plastic[1]) == 0

    def test_weak_member_batches_cleanly(self):
        """A weak-material member (cohesion 4: 77 plastic points vs the
        reference's 3) batches with the reference member without
        perturbing it, and completes its own schedule to zeta = 1."""
        from fem_elastoplasticity_tpu.parallel.ensemble import (
            solve_tsx_ensemble_df32,
        )

        eta, c = material_grid(
            np.array([4.0, 18.7]), np.array([49.0 * np.pi / 180])
        )
        ens = solve_tsx_ensemble_df32(eta, c)
        assert np.isfinite(np.asarray(ens.u)).all()
        assert int(ens.n_plastic[0]) > 50
        assert float(np.asarray(ens.zeta_hist)[0].max()) >= 1.0
        ref = solve(TsxTunnelConfig.fast())
        np.testing.assert_allclose(
            np.asarray(ens.u[1]), np.asarray(ref.u), rtol=0, atol=1e-15
        )


class TestEnsembleAtScale:
    """Refined-mesh df32 ensembles (members x
    refine_levels >= 1).  solver='cg' members run matrix-free PCG with
    the shared elastic structure — the dense per-member factor would be
    O(n^2) memory x batch at refined sizes."""

    def test_refined_cg_members_match_single_solve(self):
        """4 members at refine_levels=1 (3.5k elements), truncated
        schedule: the (18.7, 49 deg) member matches the single df32 cg
        solve at the f64 floor (measured 8.8e-18 rel — batched kernels
        round differently than single ones, so not bitwise)."""
        from fem_elastoplasticity_tpu.models import tsx_tunnel as tsx
        from fem_elastoplasticity_tpu.parallel.ensemble import (
            solve_tsx_ensemble_df32,
        )

        cfg = TsxTunnelConfig.fast(
            solver="cg", refine_levels=1, zeta_max=2.0 / 17.0
        )
        eta, c = material_grid(
            np.array([16.0, 18.7]),
            np.array([45.0 * np.pi / 180, 49.0 * np.pi / 180]),
        )
        r = solve_tsx_ensemble_df32(eta, c, cfg=cfg)
        r1 = tsx._solve_df32(cfg)
        u_s = np.asarray(r1.u)
        d = np.abs(r.u[3] - u_s).max()
        assert d < 1e-14 * max(np.abs(u_s).max(), 1e-30), d
        # physics ordering across members: lower cohesion yields more
        assert int(r.n_plastic[0]) >= int(r.n_plastic[3])

    @pytest.mark.skipif(
        "FEM_SLOW" not in __import__("os").environ,
        reason="second refined-ensemble compile (~2 min); the unsharded "
        "refined-member parity test runs every time — set FEM_SLOW=1",
    )
    def test_refined_sharded_members_match_vmap(self):
        """The same refined cg ensemble sharded over 8 devices equals
        the single-device vmap ensemble (members are independent; the
        per-device local batch is the only difference)."""
        from fem_elastoplasticity_tpu.parallel.ensemble import (
            solve_tsx_ensemble_df32,
        )

        if len(jax.devices()) < 8:
            pytest.skip("not enough devices")
        cfg = TsxTunnelConfig.fast(
            solver="cg", refine_levels=1, zeta_max=2.0 / 17.0
        )
        eta, c = material_grid(
            np.array([16.0, 18.7]),
            np.array([45.0 * np.pi / 180, 49.0 * np.pi / 180]),
        )
        e1 = solve_tsx_ensemble_df32(eta, c, cfg=cfg)
        es = solve_tsx_ensemble_df32(eta, c, cfg=cfg, shard_devices=8)
        np.testing.assert_array_equal(
            np.asarray(es.n_steps), np.asarray(e1.n_steps)
        )
        np.testing.assert_allclose(
            np.asarray(es.u), np.asarray(e1.u), rtol=0, atol=1e-14
        )
