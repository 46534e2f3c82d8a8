"""Constitutive models: plane-strain isotropic elasticity and
elastic-perfectly-plastic Drucker-Prager with associated flow.

Design: the return mapping is fully branchless (`jnp.where` over the
elastic / smooth-return / apex-return partitions), so one fused
elementwise kernel handles every integration point — no boolean gather /
scatter as in the reference (`tsx-tunnel/pythonFEM.py:990-1157`).

State conventions (parity with the reference, SURVEY.md §2.3):
  * 2D strain arrives in 3-component Voigt form [e11, e22, 2*e12] (from B),
  * stress / plastic strain carry the plane-strain 4th component
    [s11, s22, s12, s33] with projectors iota=[1,1,0,1],
    VOL4 = outer(iota, iota), DEV4 = diag(1,1,1/2,1) - VOL4/3,
  * the consistent tangent is returned as (..., 3, 3) acting on the
    3-component strain.

Two reference defects are fixed here (documented in SURVEY.md §2.3):
  1. `lambda` at apex points is the scalar (eta*p_tr - c)/denom_a; the
     reference computes an outer product with wrong precedence
     (`tsx-tunnel/pythonFEM.py:1114`) and crashes into a silent None.
  2. the apex plastic-strain update uses the *total* strain E4, where the
     reference accidentally uses the trial strain because `E_tr -= ep_prev`
     aliases E4 in place (`tsx-tunnel/pythonFEM.py:1054-1057`).
     `apex_ep_uses_trial=True` restores bug-compatibility if ever needed.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

SQRT2 = float(np.sqrt(2.0))

IOTA4 = np.array([1.0, 1.0, 0.0, 1.0])
VOL4 = np.outer(IOTA4, IOTA4)
DEV4 = np.diag([1.0, 1.0, 0.5, 1.0]) - VOL4 / 3.0
IOTA3 = np.array([1.0, 1.0, 0.0])
VOL3 = VOL4[:3, :3]
DEV3 = DEV4[:3, :3]
# engineering-shear doubling pattern for plastic strain updates
EPS_SCALE = np.array([1.0, 1.0, 2.0, 1.0])


def lame_moduli(young: float, poisson: float):
    """(shear G, bulk K) from (E, nu) — `tsx-tunnel/pythonFEM.py:1665-1666`."""
    shear = young / (2.0 * (1.0 + poisson))
    bulk = young / (3.0 * (1.0 - 2.0 * poisson))
    return shear, bulk


def drucker_prager_fit(cohesion: float, friction_angle: float):
    """Plane-strain DP fit to Mohr-Coulomb: (eta, c).

    `tsx-tunnel/pythonFEM.py:1671-1672`.
    """
    t = np.tan(friction_angle)
    den = np.sqrt(9.0 + 12.0 * t * t)
    return 3.0 * t / den, 3.0 * cohesion / den


def elastic_tangent(shear, bulk, dtype=jnp.float64):
    """Plane-strain elastic 3x3 tangent: 2G*DEV3 + K*VOL3."""
    return 2.0 * shear * jnp.asarray(DEV3, dtype) + bulk * jnp.asarray(VOL3, dtype)


def elastic_tangent_lanes(shear, bulk, n: int, dtype=jnp.float64):
    """Elastic tangent broadcast lane-major to (3, 3, n) — built from
    scalars only (no array constants; see ops/assembly.py docstring)."""
    d = jnp.full((n,), 4.0 * shear / 3.0 + bulk, dtype)
    o = jnp.full((n,), -2.0 * shear / 3.0 + bulk, dtype)
    g = jnp.full((n,), shear, dtype)
    z = jnp.zeros((n,), dtype)
    return jnp.stack(
        [
            jnp.stack([d, o, z], axis=0),
            jnp.stack([o, d, z], axis=0),
            jnp.stack([z, z, g], axis=0),
        ],
        axis=0,
    )


class ReturnMapResult(NamedTuple):
    """Per-integration-point constitutive outputs.

    s:      (n, 4) stress
    ds:     (n, 3, 3) consistent tangent on the 2D Voigt strain
    ind_p:  (n,) bool, plastic points (smooth or apex)
    lam:    (n,) plastic multiplier
    ep:     (n, 4) updated plastic strain (equals ep_prev unless
            `apply_plastic_strain=True` was requested)
    """

    s: jnp.ndarray
    ds: jnp.ndarray
    ind_p: jnp.ndarray
    lam: jnp.ndarray
    ep: jnp.ndarray


def dp_return_map_lanes(
    e3: jnp.ndarray,
    ep_prev: jnp.ndarray,
    shear,
    bulk,
    eta,
    c,
    e0: Optional[jnp.ndarray] = None,
    apply_plastic_strain: bool = False,
    apex_ep_uses_trial: bool = False,
):
    """Lane-major Drucker-Prager return map (the only implementation).

    All arrays are structure-of-arrays with the integration-point axis
    minor (lanes): e3 (3, n), ep_prev (4, n), outputs s (4, n),
    ds (3, 3, n), ind_p (n,), lam (n,), ep (4, n).  Every projector
    contraction is written as explicit per-component formulas — no (n, 4)
    matmuls over a 4-wide minor axis, so XLA fuses the whole update into
    one elementwise kernel.

    Math per SURVEY.md §2.3 (same as `drucker_prager_return_map`).
    """
    dtype = e3.dtype
    n = e3.shape[1]
    shear = jnp.broadcast_to(jnp.asarray(shear, dtype), (n,))
    bulk = jnp.broadcast_to(jnp.asarray(bulk, dtype), (n,))
    eta = jnp.broadcast_to(jnp.asarray(eta, dtype), (n,))
    c = jnp.broadcast_to(jnp.asarray(c, dtype), (n,))

    zero = jnp.zeros((n,), dtype)
    e4 = jnp.stack([e3[0], e3[1], e3[2], zero], axis=0)
    if e0 is not None:
        e0 = jnp.asarray(e0, dtype)
        e4 = e4 + (e0[:, None] if e0.ndim == 1 else e0)

    et = e4 - ep_prev
    tr = et[0] + et[1] + et[3]
    # dev4 @ et, explicit: slot 2 halves (engineering shear), iota = [1,1,0,1]
    dev0 = et[0] - tr / 3.0
    dev1 = et[1] - tr / 3.0
    dev2 = et[2] / 2.0
    dev3_ = et[3] - tr / 3.0

    two_g = 2.0 * shear
    ktr = bulk * tr
    s_tr = jnp.stack(
        [two_g * dev0 + ktr, two_g * dev1 + ktr, two_g * dev2, two_g * dev3_ + ktr],
        axis=0,
    )

    norm_sq = jnp.maximum(
        et[0] * dev0 + et[1] * dev1 + et[2] * dev2 + et[3] * dev3_, 0.0
    )
    norm_e = jnp.sqrt(norm_sq)
    rho_tr = two_g * norm_e
    p_tr = bulk * tr

    denom_a = bulk * eta * eta
    denom_s = shear + denom_a
    crit1 = rho_tr / SQRT2 + eta * p_tr - c
    crit2 = eta * p_tr - denom_a * rho_tr / (shear * SQRT2) - c

    ind_p = crit1 > 0.0
    ind_s = ind_p & (crit2 <= 0.0)
    ind_a = ind_p & (crit2 > 0.0)

    lam_s = crit1 / denom_s
    lam_a = (eta * p_tr - c) / denom_a  # reference defect #1 fixed
    lam = jnp.where(ind_s, lam_s, jnp.where(ind_a, lam_a, 0.0))

    inv_norm = jnp.where(norm_e > 0.0, 1.0 / jnp.where(norm_e > 0.0, norm_e, 1.0), 0.0)
    n0 = dev0 * inv_norm
    n1 = dev1 * inv_norm
    n2 = dev2 * inv_norm
    n3 = dev3_ * inv_norm

    sg = SQRT2 * shear
    ke = bulk * eta
    m0 = sg * n0 + ke
    m1 = sg * n1 + ke
    m2 = sg * n2
    m3 = sg * n3 + ke

    s_apex_d = c / eta  # iota-scaled apex stress
    s_out = []
    for k, (mk, apex_k) in enumerate(
        [(m0, s_apex_d), (m1, s_apex_d), (m2, 0.0), (m3, s_apex_d)]
    ):
        sk = jnp.where(
            ind_s,
            s_tr[k] - lam_s * mk,
            jnp.where(ind_a, apex_k if k != 2 else zero, s_tr[k]),
        )
        s_out.append(sk)
    s = jnp.stack(s_out, axis=0)

    # consistent tangent (3, 3, n): ds_el - coef*(Dev3 - nn^T) - mm^T/denom_s
    # written entry-wise from the DEV3/VOL3 projector values — no (3,3)
    # array constants (utils/jitsafe.py)
    safe_rho = jnp.where(rho_tr > 0.0, rho_tr, 1.0)
    ca = jnp.where(ind_s, 2.0 * SQRT2 * shear * shear * lam_s / safe_rho, 0.0)
    ms = jnp.where(ind_s, 1.0 / denom_s, 0.0)
    e_diag = 4.0 * shear / 3.0 + bulk  # 2G*(2/3) + K
    e_off = -2.0 * shear / 3.0 + bulk  # 2G*(-1/3) + K
    d00 = e_diag - ca * (2.0 / 3.0 - n0 * n0) - m0 * m0 * ms
    d11 = e_diag - ca * (2.0 / 3.0 - n1 * n1) - m1 * m1 * ms
    d22 = shear - ca * (0.5 - n2 * n2) - m2 * m2 * ms
    d01 = e_off - ca * (-1.0 / 3.0 - n0 * n1) - m0 * m1 * ms
    d02 = ca * n0 * n2 - m0 * m2 * ms
    d12 = ca * n1 * n2 - m1 * m2 * ms
    not_a = jnp.where(ind_a, 0.0, 1.0)
    d00, d11, d22 = d00 * not_a, d11 * not_a, d22 * not_a
    d01, d02, d12 = d01 * not_a, d02 * not_a, d12 * not_a
    ds = jnp.stack(
        [
            jnp.stack([d00, d01, d02], axis=0),
            jnp.stack([d01, d11, d12], axis=0),
            jnp.stack([d02, d12, d22], axis=0),
        ],
        axis=0,
    )

    if apply_plastic_strain:
        # ep += lam_s * [1,1,2,1] o (n_hat/sqrt2 + eta/3 * iota) on smooth
        f0 = n0 / SQRT2 + eta / 3.0
        f1 = n1 / SQRT2 + eta / 3.0
        f2 = 2.0 * (n2 / SQRT2)
        f3 = n3 / SQRT2 + eta / 3.0
        flow = jnp.stack([f0, f1, f2, f3], axis=0)
        ep_smooth = ep_prev + lam_s[None, :] * flow
        apex_base = et if apex_ep_uses_trial else e4
        apex_shift = c / (3.0 * bulk * eta)
        ep_apex = jnp.stack(
            [
                apex_base[0] - apex_shift,
                apex_base[1] - apex_shift,
                apex_base[2],
                apex_base[3] - apex_shift,
            ],
            axis=0,
        )
        ep = jnp.where(
            ind_s[None, :], ep_smooth, jnp.where(ind_a[None, :], ep_apex, ep_prev)
        )
    else:
        ep = ep_prev

    return s, ds, ind_p, lam, ep


def drucker_prager_return_map(
    e3: jnp.ndarray,
    ep_prev: jnp.ndarray,
    shear,
    bulk,
    eta,
    c,
    e0: Optional[jnp.ndarray] = None,
    apply_plastic_strain: bool = False,
    apex_ep_uses_trial: bool = False,
) -> ReturnMapResult:
    """Drucker-Prager elastic-predictor / plastic-corrector update.

    Point-major convenience API: e3 (n, 3), ep_prev (n, 4), outputs in the
    same orientation.  Thin transpose wrapper over `dp_return_map_lanes`
    (the lane-major layout), so both entry points share one
    implementation.  Math per SURVEY.md §2.3; see module docstring for the
    two reference defects fixed here.

    Args:
      e3:       (n, 3) total 2D strain [e11, e22, 2e12].
      ep_prev:  (n, 4) plastic strain from the previous accepted step.
      shear, bulk, eta, c: scalars or (n,) material fields.
      e0:       optional (4,) or (n, 4) initial strain (tsx excavation).
      apply_plastic_strain: update `ep` (once per accepted load step).
      apex_ep_uses_trial: reproduce reference defect #2.
    """
    e0_l = None
    if e0 is not None:
        e0_l = jnp.asarray(e0, e3.dtype)
        if e0_l.ndim == 2:
            e0_l = e0_l.T
    s, ds, ind_p, lam, ep = dp_return_map_lanes(
        e3.T,
        ep_prev.T,
        shear,
        bulk,
        eta,
        c,
        e0=e0_l,
        apply_plastic_strain=apply_plastic_strain,
        apex_ep_uses_trial=apex_ep_uses_trial,
    )
    return ReturnMapResult(
        s=s.T, ds=ds.transpose(2, 0, 1), ind_p=ind_p, lam=lam, ep=ep.T
    )
