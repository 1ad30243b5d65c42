"""NN gas optics: input packing, batched-MLP prediction with fused
postprocessing, and the LW/SW entry points.

Reference parity:
  - input packing + min-max scaling: ``compute_nn_inputs``
    (mo_gas_optics_rrtmgp.F90:618-798). Hardcoded power scalings precede
    min-max: log(play), h2o**(1/4), o3**(1/4); feature order comes from the
    model's input_names; gases missing from the input get either zero or a
    scenario reference VMR (config.nn_scenario_index).
  - prediction + postprocessing: ``predict_nn_lw_blas`` / ``predict_nn_sw_blas``
    (mo_gas_optics_kernels.F90:690-1018) and the output_sgemm_* kernels
    (mod_network_rrtmgp.F90:125-409):
      tau   = (ystd*y + ymean)**8 * col_dry
      pfrac = y**2                      (single "both" model: raw halves)
      SW:   tau_tot = tau_abs + tau_ray; ssa = tau_ray / tau_tot; g = 0
  - column dry amount: ``get_col_dry`` (mo_gas_optics_rrtmgp.F90:1662-1707).

Design: the whole pipeline (pack -> scale -> MLP -> postproc) is pure jnp on
(ncol*nlay, features) batches; XLA fuses the elementwise stages around the
GEMMs, which run at ``config.MATMUL_PRECISION``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax.numpy as jnp

from ..config import config
from ..constants import constants
from ..gas_concs import GasConcs, get_ref_vmr
from ..models.network import NNModel
from ..spectral import SpectralMapping
from .planck import PlanckTable, compute_planck_source_nn


def get_col_dry(vmr_h2o: jnp.ndarray, plev: jnp.ndarray, latitude: Optional[jnp.ndarray] = None) -> jnp.ndarray:
    """Column dry-air amount [molec/cm2] per layer via hydrostatics.

    vmr_h2o: (ncol, nlay); plev: (ncol, nlay+1) [Pa]; latitude (ncol,)
    optional -> Helmert gravity. Reference get_col_dry
    (mo_gas_optics_rrtmgp.F90:1662-1707).
    """
    if latitude is not None:
        g0 = constants.helmert1 - constants.helmert2 * jnp.cos(
            2.0 * jnp.pi * latitude / 180.0
        )
    else:
        g0 = jnp.full(plev.shape[:1], constants.grav, plev.dtype)
    delta_plev = jnp.abs(plev[:, :-1] - plev[:, 1:])
    fact = 1.0 / (1.0 + vmr_h2o)
    m_air = (constants.m_dry + constants.m_h2o * vmr_h2o) * fact
    return (
        10.0 * delta_plev * constants.avogad * fact
        / (1000.0 * m_air * 100.0 * g0[:, None])
    )


def interp_tlev(tlay: jnp.ndarray, play: jnp.ndarray, plev: jnp.ndarray) -> jnp.ndarray:
    """Pressure-weighted interpolation of layer temperatures to levels,
    with linear extrapolation at the boundaries (reference
    mo_gas_optics_rrtmgp.F90:326-335)."""
    t_top = tlay[:, 0] + (plev[:, 0] - play[:, 0]) * (tlay[:, 1] - tlay[:, 0]) / (
        play[:, 1] - play[:, 0]
    )
    interior = (
        play[:, :-1] * tlay[:, :-1] * (plev[:, 1:-1] - play[:, 1:])
        + play[:, 1:] * tlay[:, 1:] * (play[:, :-1] - plev[:, 1:-1])
    ) / (plev[:, 1:-1] * (play[:, :-1] - play[:, 1:]))
    t_bot = tlay[:, -1] + (plev[:, -1] - play[:, -1]) * (tlay[:, -1] - tlay[:, -2]) / (
        play[:, -1] - play[:, -2]
    )
    return jnp.concatenate([t_top[:, None], interior, t_bot[:, None]], axis=1)


def compute_nn_inputs(
    play: jnp.ndarray,
    tlay: jnp.ndarray,
    gas_desc: GasConcs,
    model: NNModel,
) -> jnp.ndarray:
    """Pack and scale NN input features -> (ncol, nlay, n_inputs).

    Feature semantics per the model's input_names: 'tlay' (K), 'play'
    (log Pa), 'h2o'/'o3' (vmr**0.25), other gases raw VMR; all min-max
    scaled with the model's coefficients. Missing gases use zero or the
    configured scenario VMR.
    """
    ncol, nlay = play.shape
    feats = []
    for i, name in enumerate(model.input_names):
        if name == "tlay":
            v = tlay
        elif name == "play":
            v = jnp.log(play)
        elif name in ("h2o", "o3"):
            v = jnp.sqrt(jnp.sqrt(gas_desc.get_vmr(name, ncol, nlay)))
        elif name in gas_desc:
            v = gas_desc.get_vmr(name, ncol, nlay)
        else:
            ref = 0.0 if config.nn_scenario_index == 0 else get_ref_vmr(config.nn_scenario_index, name)
            v = jnp.full((ncol, nlay), ref, play.dtype)
        feats.append(v)
    x = jnp.stack(feats, axis=-1)
    return (x - model.input_min) / (model.input_max - model.input_min)


def predict_tau(model: NNModel, nn_inputs: jnp.ndarray, col_dry: jnp.ndarray) -> jnp.ndarray:
    """Absorption (or Rayleigh) optical depth:
    (ystd*y + ymean)**8 * col_dry (output_sgemm_tau postprocessing)."""
    raw = model.apply_raw(nn_inputs)
    y = model.output_std * raw + model.output_mean
    y2 = y * y
    y4 = y2 * y2
    return (y4 * y4) * col_dry[..., None]


def predict_pfrac(model: NNModel, nn_inputs: jnp.ndarray) -> jnp.ndarray:
    """Planck fraction: final activation then square
    (output_sgemm_pfrac postprocessing)."""
    y = model.apply_with_final_activation(nn_inputs)
    return y * y


def predict_nn_lw(
    models: Sequence[NNModel],
    nn_inputs: jnp.ndarray,
    col_dry: jnp.ndarray,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """LW prediction -> (tau, pfrac), each (ncol, nlay, ngpt).

    Two-model mode (absorption + planck_frac nets) or single combined
    "lw_both" model predicting 2*ngpt outputs split into tau || pfrac
    (predict_nn_lw_blas, mo_gas_optics_kernels.F90:690-862).
    """
    if len(models) == 2:
        tau = predict_tau(models[0], nn_inputs, col_dry)
        pfrac = predict_pfrac(models[1], nn_inputs)
        return tau, pfrac
    (model,) = models
    raw = model.apply_raw(nn_inputs)  # (..., 2*ngpt)
    ngpt = model.n_outputs // 2
    y = model.output_std[:ngpt] * raw[..., :ngpt] + model.output_mean[:ngpt]
    y2 = y * y
    y4 = y2 * y2
    tau = (y4 * y4) * col_dry[..., None]
    pfrac = raw[..., ngpt:] * raw[..., ngpt:]
    return tau, pfrac


def predict_nn_sw(
    models: Sequence[NNModel],
    nn_inputs: jnp.ndarray,
    col_dry: jnp.ndarray,
    with_rayleigh: bool = True,
):
    """SW prediction -> (tau_tot, ssa) or absorption tau only
    (predict_nn_sw_blas, mo_gas_optics_kernels.F90:869-1018)."""
    if not with_rayleigh:
        return predict_tau(models[0], nn_inputs, col_dry), None
    tau_abs = predict_tau(models[0], nn_inputs, col_dry)
    tau_ray = predict_tau(models[1], nn_inputs, col_dry)
    tau_tot = tau_abs + tau_ray
    tau_tot_safe = jnp.where(tau_tot > 0, tau_tot, 1.0)
    ssa = jnp.where(tau_tot > 0, tau_ray / tau_tot_safe, 0.0)
    return tau_tot, ssa


def gas_optics_lw_nn(
    models: Sequence[NNModel],
    play: jnp.ndarray,
    plev: jnp.ndarray,
    tlay: jnp.ndarray,
    tsfc: jnp.ndarray,
    gas_desc: GasConcs,
    spectral: SpectralMapping,
    planck_table: PlanckTable,
    col_dry: Optional[jnp.ndarray] = None,
    tlev: Optional[jnp.ndarray] = None,
    top_at_1: bool = True,
    save_pfrac: bool = False,
):
    """Full LW NN gas-optics path (gas_optics_int NN branch,
    mo_gas_optics_rrtmgp.F90:371-408).

    Returns (tau, SourceFuncLW-fields tuple): see gasoptics.gas_optics for
    the packaged front-end.
    """
    from ..sources import SourceFuncLW

    ncol, nlay = play.shape
    if tlev is None:
        tlev = interp_tlev(tlay, play, plev)
    if col_dry is None:
        col_dry = get_col_dry(gas_desc.get_vmr("h2o", ncol, nlay), plev)

    nn_inputs = compute_nn_inputs(play, tlay, gas_desc, models[0])
    tau, pfrac = predict_nn_lw(models, nn_inputs, col_dry)
    lay_src, lev_src, sfc_src, sfc_jac = compute_planck_source_nn(
        pfrac, tlay, tlev, tsfc, spectral, planck_table, top_at_1=top_at_1
    )
    sources = SourceFuncLW(
        lay_source=lay_src,
        lev_source=lev_src,
        sfc_source=sfc_src,
        sfc_source_jac=sfc_jac,
        spectral=spectral,
        planck_frac=pfrac if save_pfrac else None,
    )
    return tau, sources


def gas_optics_sw_nn(
    models: Sequence[NNModel],
    play: jnp.ndarray,
    plev: jnp.ndarray,
    tlay: jnp.ndarray,
    gas_desc: GasConcs,
    spectral: SpectralMapping,
    solar_source: jnp.ndarray,
    col_dry: Optional[jnp.ndarray] = None,
    with_rayleigh: bool = True,
):
    """Full SW NN gas-optics path (gas_optics_ext NN branch,
    mo_gas_optics_rrtmgp.F90:529-599). Returns (tau, ssa_or_None, toa_src)
    where toa_src is the per-column spectral solar source
    (solar_source broadcast, :594-599)."""
    ncol, nlay = play.shape
    if col_dry is None:
        col_dry = get_col_dry(gas_desc.get_vmr("h2o", ncol, nlay), plev)
    nn_inputs = compute_nn_inputs(play, tlay, gas_desc, models[0])
    tau, ssa = predict_nn_sw(models, nn_inputs, col_dry, with_rayleigh)
    toa_src = jnp.broadcast_to(solar_source[None, :], (ncol, spectral.ngpt))
    return tau, ssa, toa_src
