"""Projected preconditioned CG unit tests."""
import numpy as np


import jax.numpy as jnp

from fem_elastoplasticity_tpu.solve.cg import (
    block_jacobi_preconditioner,
    solve_cg,
)


def _spd(n, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n))
    return A @ A.T + n * np.eye(n)


class TestSolveCG:
    def test_matches_direct_solve(self):
        n = 64
        A = _spd(n)
        b = np.random.default_rng(1).normal(size=2 * n)  # (n_n=n, 2) dofs
        K = np.kron(A, np.eye(2))  # SPD on 2n dofs
        free = np.ones((n, 2), bool)
        res = solve_cg(
            lambda v: jnp.asarray(K) @ v, jnp.asarray(b), jnp.asarray(free),
            tol=1e-14, maxiter=2000,
        )
        ref = np.linalg.solve(K, b)
        np.testing.assert_allclose(np.asarray(res.x), ref, rtol=1e-9)

    def test_projector_keeps_constrained_dofs_zero(self):
        n = 32
        K = np.kron(_spd(n, 2), np.eye(2))
        free = np.ones((n, 2), bool)
        free[:5] = False
        b = np.random.default_rng(3).normal(size=2 * n)
        res = solve_cg(
            lambda v: jnp.asarray(K) @ v, jnp.asarray(b), jnp.asarray(free),
            tol=1e-13,
        )
        x = np.asarray(res.x).reshape(n, 2)
        assert np.abs(x[:5]).max() == 0.0
        # solution solves the reduced system
        f = free.reshape(-1)
        ref = np.linalg.solve(K[np.ix_(f, f)], b[f])
        np.testing.assert_allclose(np.asarray(res.x)[f], ref, rtol=1e-8)

    def test_scan_structure_matches_while(self):
        # the fixed-trip lax.scan form (solve_cg docstring) produces the
        # identical iterate sequence:
        # same x, same iteration count, same convergence flag
        n = 48
        K = np.kron(_spd(n, 7), np.eye(2))
        free = np.ones((n, 2), bool)
        free[:3] = False
        b = np.random.default_rng(8).normal(size=2 * n)
        kw = dict(tol=1e-13, maxiter=300)
        r_w = solve_cg(
            lambda v: jnp.asarray(K) @ v, jnp.asarray(b), jnp.asarray(free),
            structure="while", **kw,
        )
        r_s = solve_cg(
            lambda v: jnp.asarray(K) @ v, jnp.asarray(b), jnp.asarray(free),
            structure="scan", **kw,
        )
        assert int(r_s.iters) == int(r_w.iters)
        assert bool(r_s.converged) and bool(r_w.converged)
        np.testing.assert_array_equal(np.asarray(r_s.x), np.asarray(r_w.x))

    def test_scan_structure_cap_hit_flags_nonconverged(self):
        n = 64
        K = np.kron(_spd(n, 9), np.eye(2))
        b = np.random.default_rng(10).normal(size=2 * n)
        res = solve_cg(
            lambda v: jnp.asarray(K) @ v, jnp.asarray(b),
            jnp.ones((n, 2), bool), tol=1e-14, maxiter=3, structure="scan",
        )
        assert not bool(res.converged)
        assert int(res.iters) == 3
        assert np.isfinite(np.asarray(res.x)).all()

    def test_block_jacobi_reduces_iterations(self):
        n = 200
        # badly scaled block-diagonal-dominant matrix
        rng = np.random.default_rng(4)
        scales = 10.0 ** rng.uniform(-3, 3, n)
        K = np.kron(np.diag(scales), np.eye(2)) + 1e-3 * np.kron(
            _spd(n, 5) / n, np.eye(2)
        )
        K = (K + K.T) / 2
        free = np.ones((n, 2), bool)
        b = rng.normal(size=2 * n)
        A = lambda v: jnp.asarray(K) @ v
        plain = solve_cg(A, jnp.asarray(b), jnp.asarray(free), tol=1e-10, maxiter=5000)
        blocks = jnp.asarray(
            np.stack([K[2 * i : 2 * i + 2, 2 * i : 2 * i + 2] for i in range(n)])
        )
        pre = block_jacobi_preconditioner(blocks, jnp.asarray(free))
        prec = solve_cg(
            A, jnp.asarray(b), jnp.asarray(free), precond=pre, tol=1e-10, maxiter=5000
        )
        assert int(prec.iters) < int(plain.iters) / 3
        np.testing.assert_allclose(np.asarray(prec.x), np.asarray(plain.x), rtol=1e-6)

    def test_warm_start(self):
        n = 64
        K = np.kron(_spd(n, 6), np.eye(2))
        free = np.ones((n, 2), bool)
        b = np.random.default_rng(7).normal(size=2 * n)
        ref = solve_cg(lambda v: jnp.asarray(K) @ v, jnp.asarray(b), jnp.asarray(free), tol=1e-13)
        warm = solve_cg(
            lambda v: jnp.asarray(K) @ v, jnp.asarray(b), jnp.asarray(free),
            x0=ref.x, tol=1e-13,
        )
        assert int(warm.iters) <= 1
