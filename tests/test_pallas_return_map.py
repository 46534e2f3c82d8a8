"""Lane-major return map (`dp_return_map_lanes`) against a NumPy f64
return map written independently with the projector matrices."""
import numpy as np


import jax.numpy as jnp

from fem_elastoplasticity_tpu.models.materials import (
    DEV4,
    IOTA4,
    VOL4,
    dp_return_map_lanes,
    drucker_prager_fit,
    lame_moduli,
)

G, K = lame_moduli(60000.0, 0.2)
ETA, C = drucker_prager_fit(18.7, 49 * np.pi / 180)


def _sample(n=1024, seed=0):
    rng = np.random.default_rng(seed)
    return (
        jnp.asarray(rng.normal(0, 2e-3, (3, n))),
        jnp.asarray(rng.normal(0, 2e-4, (4, n))),
        jnp.asarray(rng.normal(0, 1e-3, 4)),
    )


def numpy_return_map(e3, ep, e0, apply_plastic_strain=False,
                     apex_ep_uses_trial=False):
    """Point-major f64 Drucker-Prager update (SURVEY.md §2.3), one branch
    per point set.  Returns s (4, n), ds (3, 3, n), plastic mask, smooth
    mask, lam (n,), ep (4, n) — the lane-major layout of the kernel."""
    e3 = np.asarray(e3, np.float64).T
    ep = np.asarray(ep, np.float64).T
    n = e3.shape[0]
    r2 = np.sqrt(2.0)
    e4 = np.concatenate([e3, np.zeros((n, 1))], axis=1) + np.asarray(e0)
    et = e4 - ep
    dev = et @ DEV4.T
    tr = et @ IOTA4
    s_tr = 2.0 * G * dev + K * et @ VOL4.T
    norm = np.sqrt(np.maximum(np.einsum("ni,ni->n", et, dev), 0.0))
    rho, p = 2.0 * G * norm, K * tr
    crit1 = rho / r2 + ETA * p - C
    crit2 = ETA * p - K * ETA**2 * rho / (G * r2) - C
    plastic = crit1 > 0
    smooth = plastic & (crit2 <= 0)
    apex = plastic & (crit2 > 0)
    nh = dev / np.where(norm > 0, norm, 1.0)[:, None]
    m = r2 * G * nh + K * ETA * IOTA4
    denom_s = G + K * ETA**2
    lam = np.zeros(n)
    lam[smooth] = crit1[smooth] / denom_s
    lam[apex] = (ETA * p[apex] - C) / (K * ETA**2)
    s = s_tr.copy()
    s[smooth] = s_tr[smooth] - lam[smooth, None] * m[smooth]
    s[apex] = (C / ETA) * IOTA4
    d_el = 2.0 * G * DEV4[:3, :3] + K * VOL4[:3, :3]
    ds = np.broadcast_to(d_el, (n, 3, 3)).copy()
    ca = 2.0 * r2 * G * G * lam / np.where(rho > 0, rho, 1.0)
    n3, m3 = nh[:, :3], m[:, :3]
    ds_s = (
        d_el
        - ca[:, None, None] * (DEV4[:3, :3] - n3[:, :, None] * n3[:, None])
        - m3[:, :, None] * m3[:, None] / denom_s
    )
    ds[smooth] = ds_s[smooth]
    ds[apex] = 0.0
    ep_new = ep.copy()
    if apply_plastic_strain:
        flow = np.array([1.0, 1.0, 2.0, 1.0]) * (nh / r2 + ETA / 3.0 * IOTA4)
        ep_new[smooth] = ep[smooth] + lam[smooth, None] * flow[smooth]
        base = et if apex_ep_uses_trial else e4
        ep_new[apex] = base[apex] - C / (3.0 * K * ETA) * IOTA4
    return s.T, ds.transpose(1, 2, 0), plastic, smooth, lam, ep_new.T


def _rel(a, b):
    b = np.asarray(b)
    return float(np.abs(np.asarray(a, np.float64) - b).max() / np.abs(b).max())


class TestKernelVsLanes:
    def test_f64_exact(self):
        e3, ep, e0 = _sample()
        s_l, ds_l, ind_l, lam_l, ep_l = dp_return_map_lanes(
            e3, ep, G, K, ETA, C, e0=e0, apply_plastic_strain=True
        )
        s_r, ds_r, ind_r, _, lam_r, ep_r = numpy_return_map(
            e3, ep, e0, apply_plastic_strain=True
        )
        np.testing.assert_array_equal(np.asarray(ind_l), ind_r)
        assert _rel(s_l, s_r) < 1e-12
        assert _rel(ds_l, ds_r) < 1e-9
        assert _rel(lam_l, lam_r) < 1e-12
        assert _rel(ep_l, ep_r) < 1e-12

    def test_f32_accuracy(self):
        e3, ep, e0 = _sample(seed=1)
        s_l, *_ = dp_return_map_lanes(
            e3.astype(jnp.float32), ep.astype(jnp.float32), G, K, ETA, C,
            e0=e0.astype(jnp.float32),
        )
        s_r, *_ = numpy_return_map(e3, ep, e0)
        assert s_l.dtype == jnp.float32
        assert _rel(s_l, s_r) < 1e-5

    def test_all_branches_hit(self):
        e3, ep, e0 = _sample(seed=2)
        _, _, ind_l, lam, _ = dp_return_map_lanes(e3, ep, G, K, ETA, C, e0=e0)
        _, _, plastic, smooth, _, _ = numpy_return_map(e3, ep, e0)
        # elastic, smooth-return and apex-return points all occur
        assert 0 < smooth.sum() < plastic.sum() < e3.shape[1]
        np.testing.assert_array_equal(np.asarray(lam) > 0, plastic)
        np.testing.assert_array_equal(np.asarray(ind_l), plastic)

    def test_bug_compat_apex_mode(self):
        e3, ep, e0 = _sample(seed=3)
        for flag in (False, True):
            _, _, _, _, ep_l = dp_return_map_lanes(
                e3, ep, G, K, ETA, C, e0=e0,
                apply_plastic_strain=True, apex_ep_uses_trial=flag,
            )
            *_, ep_r = numpy_return_map(
                e3, ep, e0, apply_plastic_strain=True, apex_ep_uses_trial=flag
            )
            assert _rel(ep_l, ep_r) < 1e-12


class TestFastPath:
    def test_tsx_fast_f32_preset(self):
        """Pure-f32 preset, tolerances at the f32 criterion floor; the
        df32 preset is covered in test_tsx_tunnel."""
        from fem_elastoplasticity_tpu.models.config import TsxTunnelConfig
        from fem_elastoplasticity_tpu.models.tsx_tunnel import solve

        r = solve(TsxTunnelConfig.fast_f32())
        assert r.n_steps == 17
        anchor = -1.979450e-03
        assert abs(float(r.u[40, 0]) - anchor) / abs(anchor) < 1e-5
