"""McICA cloud sampling.

Reference parity: ``extensions/cloud_optics/mo_cloud_sampling.F90`` --
``sampled_mask_max_ran`` (:125-192, maximum-random overlap),
``sampled_mask_exp_ran`` (:200-285, exponential-random overlap with a
per-interface correlation parameter), and ``draw_samples`` (:36-120,
band->g-point cloud placement by boolean mask).

Design: the per-column layer sweep carrying "reuse or redraw the random
deviates" becomes a lax.scan over layers with the deviate vector as carry;
first/last-cloudy-layer trimming is implied by the cf > 0 masking.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..optical_props import OpticalProps1scl, OpticalProps2str


def sampled_mask_max_ran(randoms: jnp.ndarray, cloud_frac: jnp.ndarray) -> jnp.ndarray:
    """Maximum-random overlap cloud mask.

    randoms: (ncol, nlay, ngpt) uniform deviates; cloud_frac: (ncol, nlay).
    Returns bool mask (ncol, nlay, ngpt): cloudy g-points per layer.
    """
    cf = cloud_frac

    def step(carry, xs):
        local_rands = carry  # (ncol, ngpt)
        rnd_l, cf_l, cf_prev = xs  # (ncol, ngpt), (ncol,), (ncol,)
        # same deviates if the layer above is cloudy, fresh ones otherwise
        local = jnp.where((cf_prev > 0.0)[:, None], local_rands, rnd_l)
        mask_l = (local > (1.0 - cf_l[:, None])) & (cf_l > 0.0)[:, None]
        return local, mask_l

    rnds = jnp.moveaxis(randoms, 1, 0)  # (nlay, ncol, ngpt)
    cfs = jnp.moveaxis(cf, 1, 0)  # (nlay, ncol)
    cf_prev = jnp.concatenate([jnp.zeros_like(cfs[:1]), cfs[:-1]], axis=0)
    _, masks = jax.lax.scan(step, rnds[0], (rnds, cfs, cf_prev))
    return jnp.moveaxis(masks, 0, 1)


def sampled_mask_exp_ran(
    randoms: jnp.ndarray, cloud_frac: jnp.ndarray, overlap_param: jnp.ndarray
) -> jnp.ndarray:
    """Exponential-random overlap cloud mask.

    overlap_param: (ncol, nlay-1) correlation between adjacent layers'
    deviates (rho); rho = 1 reduces to maximum overlap.
    """
    cf = cloud_frac

    def step(carry, xs):
        local_rands = carry
        rnd_l, cf_l, cf_prev, rho = xs
        corr = (
            rho[:, None] * (local_rands - 0.5)
            + jnp.sqrt(1.0 - rho[:, None] ** 2) * (rnd_l - 0.5)
            + 0.5
        )
        local = jnp.where((cf_prev > 0.0)[:, None], corr, rnd_l)
        mask_l = (local > (1.0 - cf_l[:, None])) & (cf_l > 0.0)[:, None]
        return local, mask_l

    rnds = jnp.moveaxis(randoms, 1, 0)
    cfs = jnp.moveaxis(cf, 1, 0)
    cf_prev = jnp.concatenate([jnp.zeros_like(cfs[:1]), cfs[:-1]], axis=0)
    rho = jnp.concatenate(
        [jnp.zeros_like(overlap_param[:, :1]), overlap_param], axis=1
    )  # rho[l] correlates layer l with l-1
    rhos = jnp.moveaxis(rho, 1, 0)
    _, masks = jax.lax.scan(step, rnds[0], (rnds, cfs, cf_prev, rhos))
    return jnp.moveaxis(masks, 0, 1)


def draw_samples(cloud_mask: jnp.ndarray, clouds):
    """Band-defined cloud properties -> McICA-sampled g-point properties.

    cloud_mask: (ncol, nlay, ngpt) bool on the TARGET g-point grid; clouds:
    band-resolved OpticalProps (ngpt == nband). Cloudy g-points take their
    band's value, clear ones zero (reference apply_cloud_mask :291-307).
    """
    # the caller supplies a mask on the gpt grid of some target spectral
    # mapping that shares the cloud bands; expand band values to that grid
    from ..spectral import SpectralMapping

    ngpt = cloud_mask.shape[-1]
    if ngpt == clouds.spectral.ngpt:
        expand = lambda x: x
        spectral = clouds.spectral
    else:
        raise ValueError(
            "draw_samples: build the mask on the target g-point grid and "
            "expand cloud bands with draw_samples_to(spectral, ...)"
        )
    tau = jnp.where(cloud_mask, expand(clouds.tau), 0.0)
    if isinstance(clouds, OpticalProps2str):
        ssa = jnp.where(cloud_mask, expand(clouds.ssa), 0.0)
        g = jnp.where(cloud_mask, expand(clouds.g), 0.0)
        return OpticalProps2str(tau, ssa, g, spectral)
    return OpticalProps1scl(tau, spectral)


def draw_samples_to(target_spectral, cloud_mask: jnp.ndarray, clouds):
    """draw_samples with band->g-point expansion onto ``target_spectral``
    (the usual McICA use: band cloud optics onto the k-distribution grid)."""
    if clouds.spectral.ngpt != target_spectral.nband:
        raise ValueError("draw_samples_to: clouds must be band-resolved")
    expand = target_spectral.expand
    tau = jnp.where(cloud_mask, expand(clouds.tau), 0.0)
    if isinstance(clouds, OpticalProps2str):
        ssa = jnp.where(cloud_mask, expand(clouds.ssa), 0.0)
        g = jnp.where(cloud_mask, expand(clouds.g), 0.0)
        return OpticalProps2str(tau, ssa, g, target_spectral)
    return OpticalProps1scl(tau, target_spectral)
