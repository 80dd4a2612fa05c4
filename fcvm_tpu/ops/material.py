"""Constitutive model: linear elasticity + von Mises radial return + damage.

Batched device form of the reference's material routines:

* ``hooke``      -> :func:`hooke_dmat`            (``fcVM.py:570-582``)
* ``vmises_original_optimised`` -> :func:`radial_return`  (``fcVM.py:2468-2492``)
* ``update_PEEQ_CSR`` -> :func:`update_peeq_csr`  (``fcVM.py:2084-2137``)

All functions are pure, branch-free (masked arithmetic instead of ``if``),
and operate on arbitrarily batched leading dimensions so one ``jit`` covers
every Gauss point of the mesh.
"""

from __future__ import annotations

import jax.numpy as jnp


def hooke_dmat(e: jnp.ndarray, nu: jnp.ndarray) -> jnp.ndarray:
    """Isotropic 6x6 elasticity matrix in Voigt order [xx,yy,zz,xy,zx,yz].

    Engineering shear strains (factor ``sd`` on the shear diagonal), matching
    the reference (``fcVM.py:570-582``).
    """
    e = jnp.asarray(e)
    nu = jnp.asarray(nu)
    dm = e * (1.0 - nu) / (1.0 + nu) / (1.0 - 2.0 * nu)
    od = nu / (1.0 - nu)
    sd = 0.5 * (1.0 - 2.0 * nu) / (1.0 - nu)
    one = jnp.ones_like(e)
    dmat = jnp.zeros(e.shape + (6, 6), dtype=e.dtype)
    dmat = dmat.at[..., 0, 0].set(one).at[..., 1, 1].set(one).at[..., 2, 2].set(one)
    dmat = dmat.at[..., 3, 3].set(sd).at[..., 4, 4].set(sd).at[..., 5, 5].set(sd)
    for i, j in ((0, 1), (0, 2), (1, 2), (1, 0), (2, 0), (2, 1)):
        dmat = dmat.at[..., i, j].set(od)
    return dmat * dm[..., None, None]


def shear_modulus(e, nu):
    return e / (1.0 + nu) / 2.0


def hardening_modulus(e, et_e):
    """Plastic hardening modulus H from the tangent/elastic ratio Et/E.

    The reference caps Et/E at 0.95 (``fcVM.py:952-954``)."""
    et_e = jnp.minimum(et_e, 0.95)
    et = et_e * e
    return et / (1.0 - et_e)


def von_mises(sig: jnp.ndarray):
    """Deviator, pressure and von Mises stress of Voigt stresses (..., 6)."""
    p = (sig[..., 0] + sig[..., 1] + sig[..., 2]) / 3.0
    dev = sig.at[..., 0].add(-p).at[..., 1].add(-p).at[..., 2].add(-p)
    svm = jnp.sqrt(
        1.5 * (dev[..., 0] ** 2 + dev[..., 1] ** 2 + dev[..., 2] ** 2)
        + 3.0 * (dev[..., 3] ** 2 + dev[..., 4] ** 2 + dev[..., 5] ** 2)
    )
    return dev, p, svm


def radial_return(sig_test: jnp.ndarray, sig_yield: jnp.ndarray, h, g):
    """Return trial stresses to the von Mises surface with isotropic hardening.

    Batched masked form of the reference's scalar routine
    (``fcVM.py:2468-2492``): scale the deviator by
    ``1 - (1 - sy/svm) * 3G / (H + 3G)`` where the point is plastic.

    Args:
      sig_test: (..., 6) trial stress.
      sig_yield: (...,) current yield stress.
      h: hardening modulus H; g: shear modulus G (scalars or broadcastable).

    Returns:
      (sig_new, plastic) where ``plastic`` is a (...,) bool mask of plastic
      Gauss points (the reference's ``pgp``).
    """
    dev, p, svm = von_mises(sig_test)
    plastic = svm >= sig_yield
    svm_safe = jnp.where(svm == 0.0, 1.0, svm)
    fac_plastic = 1.0 - (1.0 - sig_yield / svm_safe) * 3.0 * g / (h + 3.0 * g)
    fac = jnp.where(plastic, fac_plastic, 1.0)
    sig_new = dev * fac[..., None]
    sig_new = sig_new.at[..., 0].add(p).at[..., 1].add(p).at[..., 2].add(p)
    return sig_new, plastic


def update_peeq_csr(
    sig_test: jnp.ndarray,
    sig_new: jnp.ndarray,
    sig_yield: jnp.ndarray,
    peeq: jnp.ndarray,
    csr: jnp.ndarray,
    e,
    nu,
    et_e,
    ultimate_strain,
):
    """End-of-step damage/ductility state update (``fcVM.py:2084-2137``).

    Per Gauss point: plastic increment ``DL = (svm_test - sy) / (3G + H)``,
    PEEQ accumulation, isotropic hardening ``sy += Et * DL``, triaxiality
    ``T = p / sy``, critical strain ``eps_cr = sqrt(e) * eps_u * exp(-1.5 T)``
    (floored at 1e-6), and Miner-rule damage ``CSR += DL / eps_cr``.

    Args:
      sig_test: (..., 6) trial stresses accumulated over the converged step.
      sig_new: (..., 6) returned stresses.
      sig_yield, peeq, csr: (...,) state arrays (returned updated).

    Returns:
      (sig_yield, peeq, csr, triax, pressure, sigmises, ecr) all (...,).
    """
    g = shear_modulus(e, nu)
    et_e_c = jnp.minimum(et_e, 0.95)
    et = et_e_c * e
    h = et / (1.0 - et_e_c)
    ultimate = jnp.where(ultimate_strain == 0.0, 1.0e12, ultimate_strain)
    alpha = jnp.sqrt(jnp.e) * ultimate  # triaxiality T = 1/3 in uniaxial test
    beta = 1.5

    _, _, svm_test = von_mises(sig_test)
    _, p_n, svm_new = von_mises(sig_new)

    dl = jnp.where(
        svm_test > sig_yield, (svm_test - sig_yield) / (3.0 * g + h), 0.0
    )
    peeq = peeq + dl
    sig_yield = sig_yield + et * dl

    triax = p_n / sig_yield
    ecr = jnp.maximum(alpha * jnp.exp(-beta * triax), 1.0e-6)
    csr = csr + dl / ecr

    return sig_yield, peeq, csr, triax, p_n, svm_new, ecr
