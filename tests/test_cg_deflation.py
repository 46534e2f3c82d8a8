"""Recycled-Krylov deflation for the iterative tangent solves.

Unit-level coverage of `solve/cg.py`'s A-DEF2 deflated PCG (`deflate=`)
and the ring-basis harvest (`deflation_harvest`) — the machinery behind
`FootingConfig.cg_deflate` (solve/newton.py).  The model problem is an
SPD matrix with an isolated small-eigenvalue cluster, the f32 analog of
the footing's near-limit tangent spectra (localized shear-band modes —
ROADMAP findings): plain PCG stalls on the cluster, a deflation
basis spanning it removes the slow tail.

The A-DEF2 formulation is load-bearing: the textbook DEF1 variant
(projected search directions) diverges outright in f32 — round-off
re-excites the deflated modes and the projection prevents CG from ever
correcting them [Tang, Nabben, Vuik, Erlangga 2009].  These tests pin
the f32 behavior on the virtual CPU mesh (conftest forces cpu).
"""
import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

from fem_elastoplasticity_tpu.solve.cg import (  # noqa: E402
    CGResult,
    deflation_harvest,
    solve_cg,
)


def _cluster_problem(n=200, k_small=5, lam_small=1e-4, seed=0):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.concatenate(
        [np.full(k_small, lam_small), 1.0 + rng.random(n - k_small)]
    )
    A = (Q * lam) @ Q.T
    A = 0.5 * (A + A.T)
    return A, Q, rng


class TestDeflatedCG:
    def test_zero_basis_is_bitwise_plain_pcg(self):
        """Empty (all-zero) deflation slots must not perturb a single
        bit: the Gram matrix degenerates to the identity and every
        correction multiplies zero columns."""
        A, _, rng = _cluster_problem()
        Aj = jnp.asarray(A, jnp.float32)
        b = jnp.asarray(rng.standard_normal(A.shape[0]), jnp.float32)
        free = jnp.ones((A.shape[0],), bool)
        mv = lambda v: Aj @ v
        r0 = solve_cg(mv, b, free, tol=1e-6, maxiter=500)
        rd = solve_cg(
            mv, b, free, tol=1e-6, maxiter=500,
            deflate=jnp.zeros((A.shape[0], 8), jnp.float32),
        )
        assert int(rd.iters) == int(r0.iters)
        assert float(jnp.abs(rd.x - r0.x).max()) == 0.0

    def test_exact_eigenvector_basis_removes_cluster(self):
        """With the small cluster's eigenvectors in the basis, f32
        deflated PCG converges in a handful of iterations where plain
        PCG needs the full cluster-resolution count, and the returned
        solution matches the f64 direct solve at the f32 floor of the
        cluster-amplified problem."""
        A, Q, rng = _cluster_problem()
        n = A.shape[0]
        Aj = jnp.asarray(A, jnp.float32)
        b = jnp.asarray(rng.standard_normal(n), jnp.float32)
        free = jnp.ones((n,), bool)
        mv = lambda v: Aj @ v
        r_plain = solve_cg(mv, b, free, tol=1e-6, maxiter=500)
        W = jnp.concatenate(
            [jnp.asarray(Q[:, :5], jnp.float32), jnp.zeros((n, 3), jnp.float32)],
            axis=1,
        )
        r_defl = solve_cg(mv, b, free, tol=1e-6, maxiter=500, deflate=W)
        assert bool(r_defl.converged)
        assert int(r_defl.iters) < int(r_plain.iters) // 2
        xs = np.linalg.solve(A, np.asarray(b, np.float64))
        err = np.abs(np.asarray(r_defl.x) - xs).max() / np.abs(xs).max()
        assert err < 5e-3  # f32 floor on a kappa ~ 2e4 problem

    def test_constrained_dofs_stay_zero(self):
        """Deflation respects the free-DOF projector: basis columns with
        constrained-DOF content are masked, the solution stays zero on
        constrained DOFs."""
        A, Q, rng = _cluster_problem()
        n = A.shape[0]
        Aj = jnp.asarray(A, jnp.float32)
        b = jnp.asarray(rng.standard_normal(n), jnp.float32)
        free = jnp.ones((n,), bool).at[:10].set(False)
        mv = lambda v: Aj @ v
        W = jnp.asarray(Q[:, :5], jnp.float32)  # NOT masked by caller
        r = solve_cg(mv, b, free, tol=1e-6, maxiter=500, deflate=W)
        assert float(jnp.abs(r.x[:10]).max()) == 0.0
        assert bool(jnp.isfinite(r.x).all())

    def test_harvested_ring_accelerates_repeated_solves(self):
        """Recycling across solves (the Newton-loop pattern): harvesting
        each solve's solution into the ring basis makes later solves
        against the same operator cheaper — the cluster content of
        A⁻¹b accumulates in span(W)."""
        A, _, rng = _cluster_problem()
        n = A.shape[0]
        Aj = jnp.asarray(A, jnp.float32)
        free = jnp.ones((n,), bool)
        mv = lambda v: Aj @ v
        W = jnp.zeros((n, 8), jnp.float32)
        ring = jnp.asarray(0, jnp.int32)
        iters = []
        for i in range(8):
            bi = jnp.asarray(rng.standard_normal(n), jnp.float32)
            r = solve_cg(mv, bi, free, tol=1e-6, maxiter=500, deflate=W)
            assert bool(r.converged)
            xs = np.linalg.solve(A, np.asarray(bi, np.float64))
            err = np.abs(np.asarray(r.x) - xs).max() / np.abs(xs).max()
            assert err < 5e-3
            # x always; the final preconditioned residual only when the
            # solve capped (the newton_solve gating) — here: never
            W, ring = deflation_harvest(
                W, ring, [r.x, r.z], gates=[None, ~r.converged]
            )
            iters.append(int(r.iters))
        # once the ring spans the 5-dim cluster the count drops hard
        assert min(iters[5:]) <= iters[0] // 2, iters

    def test_harvest_discards_dependent_and_respects_gate(self):
        """A candidate already in span(W) must not consume a slot; a
        False gate skips the insert entirely."""
        n = 50
        rng = np.random.default_rng(1)
        v = jnp.asarray(rng.standard_normal(n), jnp.float32)
        W = jnp.zeros((n, 4), jnp.float32)
        ring = jnp.asarray(0, jnp.int32)
        W, ring = deflation_harvest(W, ring, [v])
        assert int(ring) == 1
        np.testing.assert_allclose(
            float(jnp.linalg.norm(W[:, 0])), 1.0, rtol=1e-5
        )
        # same vector again: dependent, discarded
        W2, ring2 = deflation_harvest(W, ring, [2.0 * v])
        assert int(ring2) == 1
        assert float(jnp.abs(W2 - W).max()) == 0.0
        # gated off: untouched even though independent
        u = jnp.asarray(rng.standard_normal(n), jnp.float32)
        W3, ring3 = deflation_harvest(
            W, ring, [u], gates=[jnp.asarray(False)]
        )
        assert int(ring3) == 1
        assert float(jnp.abs(W3 - W).max()) == 0.0

    def test_result_carries_final_vectors(self):
        """CGResult.r / .z are the unscaled final residual and
        preconditioned residual (the harvest inputs)."""
        A, _, rng = _cluster_problem(n=80, k_small=2, lam_small=1e-2)
        Aj = jnp.asarray(A, jnp.float32)
        b = jnp.asarray(100.0 * rng.standard_normal(80), jnp.float32)
        free = jnp.ones((80,), bool)
        r = solve_cg(lambda v: Aj @ v, b, free, tol=1e-5, maxiter=500)
        assert isinstance(r, CGResult) and r.r is not None
        # the recurrence residual agrees with the true residual only to
        # the f32 recurrence-drift floor; the harvest needs magnitude
        # and direction at that level, nothing tighter
        got_r = np.asarray(r.r, np.float64)
        bmax = float(np.abs(np.asarray(b)).max())
        assert got_r.shape == (80,)
        assert np.abs(got_r).max() < 1e-3 * bmax  # converged-scale
        assert np.asarray(r.z).shape == (80,)


class TestDeflationIntegration:
    """End-to-end coverage of cg_deflate through the Newton load loop,
    the chunked checkpoint carry, and the sharded out_specs (the three
    gaps ADVICE r4 flagged: the machinery was unit-tested only)."""

    @pytest.mark.skipif(
        "FEM_SLOW" not in __import__("os").environ,
        reason="two full footing schedules (~2 min solo; the truncated "
        "checkpoint/sharded tests below cover the deflated Newton path "
        "on every run) — set FEM_SLOW=1",
    )
    def test_footing_newton_deflated_cuts_cg_work(self):
        """`FootingConfig(cg_deflate=k)` through the REAL footing Newton
        load loop: the recycled ring targets the persistent near-limit
        small-eigenvalue cluster, so cumulative CG iterations drop
        hard (measured on this mesh: 196k -> 104k its at k=16, and a
        saner schedule: 24 -> 18 accepted steps) while the bearing-
        capacity limit pressure is physics-identical."""
        from fem_elastoplasticity_tpu.models.config import FootingConfig
        from fem_elastoplasticity_tpu.models.footing import solve

        r0 = solve(FootingConfig.fast(solver="cg"))
        rd = solve(FootingConfig.fast(solver="cg", cg_deflate=16))
        assert float(np.asarray(rd.zeta_hist).max()) >= 1.0
        p0 = float(r0.pressure_hist[r0.n_steps])
        pd = float(rd.pressure_hist[rd.n_steps])
        assert abs(pd - p0) / abs(p0) < 1e-4  # measured 5.6e-6
        assert rd.n_cg_total < 0.8 * r0.n_cg_total  # measured 0.53

    def test_chunked_checkpoint_roundtrips_deflation_ring(self, tmp_path):
        """Interrupt + resume a deflated run through the chunked
        executor: the defl_w/defl_ring carry must round-trip through the
        npz checkpoint bit-exactly — the resumed run's trajectory equals
        the single-dispatch run's."""
        from fem_elastoplasticity_tpu.models import footing as ftg
        from fem_elastoplasticity_tpu.models.config import FootingConfig

        cfg = FootingConfig.fast(solver="cg", cg_deflate=8, zeta_max=0.05)
        run, args, mesh = ftg.build_df32(cfg)
        full = run(args)
        assert full.defl is not None  # ring state surfaced in the result
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
        assert int(r2.n_cg_total) == int(full.n_cg_total)
        np.testing.assert_array_equal(f64(r2.u), f64(full.u))

    def test_sharded_footing_deflated_bit_identical(self):
        """cg_deflate>0 under shard_map (footing tangent-MG scale path):
        the replicated defl out_specs entry must thread through — this
        is exactly the pytree-mismatch class ADVICE r4 flagged — and the
        trajectory stays bit-identical to single-device."""
        import jax

        from fem_elastoplasticity_tpu.models import footing
        from fem_elastoplasticity_tpu.models.config import FootingConfig

        if len(jax.devices()) < 8:
            pytest.skip("not enough devices")
        cfg = FootingConfig.fast(
            solver="cg", level=2, tangent_mg=True, cg_deflate=8,
            zeta_max=0.004,
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

    @pytest.mark.skipif(
        "FEM_SLOW" not in __import__("os").environ,
        reason="8-device tsx fast_scale compile is heavy on the 1-core "
        "suite box; the footing sharded-deflated case covers the "
        "out_specs defl contract every run — set FEM_SLOW=1",
    )
    def test_sharded_tsx_deflated_traces_and_runs(self):
        """TsxTunnelConfig.cg_deflate>0 through solve_sharded_scale: the
        tsx sharded out_specs carries the defl entry (the ADVICE r4
        medium finding — previously a trace-time pytree mismatch).
        Truncated schedule; parity vs the single-device deflated run."""
        import jax

        from fem_elastoplasticity_tpu.models.tsx_tunnel import (
            TsxTunnelConfig,
            _solve_df32,
            solve_sharded_scale,
        )

        if len(jax.devices()) < 8:
            pytest.skip("not enough devices")
        cfg = TsxTunnelConfig.fast_scale(
            1, zeta_max=3.0 / 17.0, cg_deflate=4
        )
        r = solve_sharded_scale(cfg, n_devices=8)
        r1 = _solve_df32(cfg)
        assert r.n_steps == r1.n_steps >= 3
        np.testing.assert_array_equal(np.asarray(r.u), np.asarray(r1.u))
