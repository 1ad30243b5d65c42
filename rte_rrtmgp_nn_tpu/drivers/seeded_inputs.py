"""Driver inputs generated inside the package from a seed.

Every end-to-end path (RFMIP clear sky, all sky, GCM blocks) can run from
these inputs alone, with no external data directory:

- ``make_rfmip(seed)``: an ``RFMIPData`` of the reference RFMIP file's
  shape -- 100 sites x 18 experiments = 1800 columns x 60 layers, surface
  first (``top_at_1=False``), experiment-major column order, every gas the
  LW g-128 model reads (its 18 ``input_names``: tlay, play and 16 gases,
  CFCs and HFCs included) stored as full (ncol, nlay) fields the way
  ``read_rfmip`` stores them, plus ``sfc_emis``, ``sfc_alb``, ``sza`` with
  night columns (sza >= 90) and ``tsi``. Profiles are built from a surface
  temperature, a tropospheric lapse rate, a tropopause, a warm
  stratopause, a relative-humidity water-vapour profile and an ozone layer
  peaking near 10 hPa; each experiment scales the well-mixed gases and may
  shift temperature and humidity, as the RFMIP perturbation experiments do.
- ``make_gcm_block(seed, ncol)``: the same generator at GCM block size
  (57,600 columns by default), returned as an ``RFMIPData``.
- ``make_allsky_atmosphere(seed, ncol)``: a ``GarandAtmosphere`` of ncol
  present-day columns for the all-sky drivers, and ``make_cloud_fields``:
  liquid/ice water paths and effective radii placed where
  ``drivers.allsky.make_clouds`` places them, with water paths and radii
  drawn from the seed.
- ``make_cloud_optics(seed, kind)``: a LUT ``CloudOptics`` of the
  reference coefficient files' table shapes -- 16 LW or 14 SW bands (the
  g-128 / g-112 band limits), 20 liquid sizes over 2.5-21.5 um, 18 ice
  sizes over 10-180 um, 3 ice roughness categories. Extinction follows
  the geometric-optics 1.5/r_e law; single-scattering albedo and
  asymmetry vary smoothly by band and size.
- ``make_atmosphere(ncol, nlay)``: a small idealized atmosphere (a
  power-law temperature profile with uniform noise, five gases) for the
  k-distribution LUT path and its tests.
- ``load_models(seed)``: the NN models.
    * LW: ``artifacts/lw-g128-demo_both_128_128_HR_8.62e-02_FRC_1.55e+00.nc``,
      the repository's trained g-128 "both" model at the shipped
      architecture's full width (18 -> 128 -> 128 -> 256, softsign,
      linear output; tau and Planck fraction halves).
    * SW absorption: ``artifacts/sw-g112-demo_absorption_48_48_*.nc``, the
      repository's trained g-112 absorption model (7 -> 48 -> 48 -> 112).
    * SW Rayleigh: no g-112 Rayleigh model ships with the repository, so
      one is drawn from the seed at the absorption net's widths
      (7 -> 48 -> 48 -> 112). Its output mean is set per g-point to
      k_ray^(1/8), with k_ray = 5e-27 cm2 * (nu / 18000 cm-1)^4 at the
      band-centre wavenumber nu -- the molecular Rayleigh cross section
      scaled by nu^4 -- and its output std to 2% of the mean, so
      tau_ray / col_dry stays positive and of physical magnitude.

All arrays are host numpy (float32 unless ``dtype`` says otherwise), so a
caller chooses the device by where it runs the drivers.
"""
from __future__ import annotations

import glob
import os

import numpy as np

from ..gas_concs import GasConcs
from .allsky import make_clouds
from .allsky_io import GarandAtmosphere
from .rfmip_io import RFMIPData

ARTIFACTS_DIR = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), os.pardir, os.pardir,
    "artifacts")
LW_MODEL_FILE = "lw-g128-demo_both_128_128_HR_8.62e-02_FRC_1.55e+00.nc"
SW_ABS_MODEL_GLOB = "sw-g112-demo_absorption_48_48_*.nc"

RFMIP_NSITES = 100
RFMIP_NEXP = 18
RFMIP_NLAY = 60
GCM_BLOCK_NCOL = 57_600

# Per-experiment multipliers of the present-day well-mixed gases and
# temperature / humidity perturbations, in the spirit of the RFMIP
# experiment list: present day, pre-industrial, future, 4xCO2, 0.5xCO2,
# +4 K, humid and dry perturbations, halocarbon-free and so on.
#          co2   ch4   n2o   halo   dT    rh
_EXPERIMENTS = np.array([
    [1.00, 1.00, 1.00, 1.00, 0.0, 1.00],
    [0.72, 0.39, 0.84, 0.00, 0.0, 1.00],
    [1.27, 1.40, 1.12, 0.90, 0.0, 1.00],
    [4.00, 1.00, 1.00, 1.00, 0.0, 1.00],
    [0.50, 1.00, 1.00, 1.00, 0.0, 1.00],
    [1.00, 1.00, 1.00, 1.00, 4.0, 1.00],
    [1.00, 1.00, 1.00, 1.00, 4.0, 1.25],
    [1.00, 1.00, 1.00, 1.00, 0.0, 1.25],
    [1.00, 1.00, 1.00, 1.00, 0.0, 0.60],
    [1.00, 0.39, 1.00, 1.00, 0.0, 1.00],
    [1.00, 1.00, 0.84, 1.00, 0.0, 1.00],
    [1.00, 1.00, 1.00, 0.00, 0.0, 1.00],
    [2.00, 1.00, 1.00, 1.00, 0.0, 1.00],
    [1.00, 2.00, 1.00, 1.00, 0.0, 1.00],
    [1.00, 1.00, 1.00, 0.50, 0.0, 1.00],
    [0.72, 1.00, 1.00, 1.00, -4.0, 1.00],
    [3.00, 2.20, 1.30, 0.80, 2.0, 1.10],
    [1.50, 1.20, 1.10, 0.95, 1.0, 1.05],
])

# Present-day global means [mol/mol] of the well-mixed gases the LW model
# reads (inside the model's input_min/max ranges).
_PRESENT_DAY = {
    "co2": 397.5e-6, "ch4": 1831.5e-9, "n2o": 326.9e-9, "co": 1.2e-7,
    "o2": 0.209, "n2": 0.781,
}
_HALOCARBONS = {
    "cfc11": 233.1e-12, "cfc12": 520.6e-12, "ccl4": 83.1e-12,
    "cfc22": 229.5e-12, "hfc143a": 15.3e-12, "hfc125": 15.4e-12,
    "hfc23": 26.9e-12, "hfc32": 8.3e-12, "hfc134a": 80.5e-12,
    "cf4": 81.1e-12,
}


def _saturation_vmr(t, p):
    """Water-vapour saturation VMR over liquid (Bolton 1980)."""
    es = 611.2 * np.exp(17.67 * (t - 273.15) / (t - 29.65))
    return es / p


def _profiles(rng, nsites, nlay):
    """Per-site pressure, temperature, water-vapour and ozone profiles,
    surface first. Returns plev (nsites, nlay+1), play, tlay_base,
    tlev_base, tsfc_base, rh_sfc, psfc."""
    psfc = rng.uniform(97_000.0, 103_000.0, nsites)
    high = rng.random(nsites) < 0.15  # elevated sites
    psfc[high] = rng.uniform(60_000.0, 90_000.0, high.sum())
    # levels from the surface to 1 Pa, stepping in log-pressure as
    # x**2.2 so that about half of the layers lie in the troposphere
    ptop = 1.0
    frac = np.linspace(0.0, 1.0, nlay + 1) ** 2.2
    plev = np.exp(np.log(psfc)[:, None] * (1.0 - frac)
                  + np.log(ptop) * frac[None, :])
    play = 0.5 * (plev[:, 1:] + plev[:, :-1])

    t_air = rng.uniform(222.0, 305.0, nsites)
    t_trop = np.clip(t_air - rng.uniform(60.0, 95.0, nsites), 188.0, 225.0)
    t_strat = rng.uniform(255.0, 280.0, nsites)  # stratopause, ~100 Pa
    kappa = 0.19  # R * lapse / g for 6.5 K/km

    def temperature(p):
        lp = np.log(p)
        tropo = t_air[:, None] * (p / psfc[:, None]) ** kappa
        p_trop = psfc[:, None] * (t_trop[:, None] / t_air[:, None]) ** (1.0 / kappa)
        # tropopause to 20 hPa isothermal-ish, warming to the stratopause
        # near 1 hPa, cooling above it
        lp_trop, lp_20, lp_1 = np.log(p_trop), np.log(2000.0), np.log(100.0)
        w_up = np.clip((lp_20 - lp) / (lp_20 - lp_1), 0.0, 1.0)
        strat = t_trop[:, None] + (t_strat[:, None] - t_trop[:, None]) * w_up
        meso = t_strat[:, None] - 12.0 * np.clip((lp_1 - lp), 0.0, None)
        t = np.where(lp > lp_trop, tropo, np.where(lp > lp_1, strat, meso))
        return np.clip(t, 170.0, 330.0)

    tlay = temperature(play) + rng.normal(0.0, 0.7, play.shape)
    tlev = temperature(plev)
    tlev[:, 0] = t_air
    tsfc = t_air + rng.uniform(-2.0, 3.0, nsites)
    rh_sfc = rng.uniform(0.5, 0.9, nsites)
    return plev, play, tlay, tlev, tsfc, rh_sfc, psfc


def make_rfmip(seed: int = 0, nsites: int = RFMIP_NSITES,
               nexp: int = RFMIP_NEXP, nlay: int = RFMIP_NLAY,
               dtype=np.float32) -> RFMIPData:
    """An ``RFMIPData`` of (nexp * nsites) columns, drawn from ``seed``
    (see the module docstring). Columns are experiment-major, as
    ``read_rfmip`` orders them; level 0 is the surface."""
    rng = np.random.default_rng(seed)
    plev, play, tlay0, tlev0, tsfc0, rh_sfc, psfc = _profiles(
        rng, nsites, nlay)
    exps = _EXPERIMENTS[np.arange(nexp) % len(_EXPERIMENTS)]

    def per_exp(site_field):
        a = np.broadcast_to(site_field, (nexp,) + site_field.shape)
        return a.reshape((nexp * nsites,) + site_field.shape[1:])

    ncol = nexp * nsites
    dT = np.repeat(exps[:, 4], nsites)
    rh = np.repeat(exps[:, 5], nsites)
    p_lay, p_lev = per_exp(play), per_exp(plev)
    t_lay = per_exp(tlay0) + dT[:, None]
    t_lev = per_exp(tlev0) + dT[:, None]
    tsfc = per_exp(tsfc0) + dT
    ps = per_exp(psfc)

    # water vapour: surface RH scaled by the experiment, decaying as
    # (p/psfc)^3, floored at a stratospheric 4 ppmv, capped at saturation
    q_sfc = (per_exp(rh_sfc) * rh)[:, None] * _saturation_vmr(
        t_lev[:, :1], ps[:, None])
    h2o = q_sfc * (p_lay / ps[:, None]) ** 3
    h2o = np.minimum(h2o, 0.95 * _saturation_vmr(t_lay, p_lay))
    h2o = np.clip(np.maximum(h2o, 4e-6), 4e-6, 0.04)
    # ozone: a layer peaking near 10 hPa over a tropospheric background
    o3_peak = per_exp(rng.uniform(6e-6, 1.1e-5, nsites))[:, None]
    lp = np.log(p_lay / 1000.0)
    o3 = o3_peak * np.exp(-0.5 * (lp / 1.3) ** 2) + 3e-8

    concs = {"h2o": h2o, "o3": o3}
    scale = {"co2": exps[:, 0], "ch4": exps[:, 1], "n2o": exps[:, 2]}
    for g, v in _PRESENT_DAY.items():
        s = np.repeat(scale.get(g, np.ones(nexp)), nsites)
        concs[g] = np.broadcast_to((v * s)[:, None], (ncol, nlay))
    for g, v in _HALOCARBONS.items():
        s = np.repeat(exps[:, 3], nsites)
        concs[g] = np.broadcast_to((v * s)[:, None], (ncol, nlay))
    concs = {g: np.ascontiguousarray(v, dtype) for g, v in concs.items()}

    # solar geometry: ~1/3 of the sites are in night (sza >= 90 deg)
    mu0 = rng.uniform(-0.5, 1.0, nsites)
    sza = np.degrees(np.arccos(np.clip(mu0, -1.0, 1.0)))
    sfc_alb = rng.uniform(0.04, 0.6, nsites)
    sfc_emis = rng.uniform(0.93, 1.0, nsites)
    tsi = 1360.85 * rng.uniform(0.967, 1.034, nsites)

    c = lambda a: np.ascontiguousarray(a, dtype)
    return RFMIPData(
        play=c(p_lay), plev=c(p_lev), tlay=c(t_lay), tlev=c(t_lev),
        tsfc=c(tsfc), sfc_emis=c(per_exp(sfc_emis)),
        sfc_alb=c(per_exp(sfc_alb)), sza=c(per_exp(sza)),
        tsi=c(per_exp(tsi)), gas_concs=GasConcs(concs),
        nexp=nexp, nsites=nsites, nlay=nlay, top_at_1=False,
    )


def make_atmosphere(ncol=4, nlay=20, t_iso=None, rng=None, dtype=None):
    """(play, plev, tlay, tlev, tsfc, GasConcs) of ``ncol`` identical
    pressure grids from 40 Pa to the surface (top first), with a power-law
    temperature profile plus uniform noise from ``rng`` (or isothermal at
    ``t_iso``) and h2o/co2/o3/n2o/ch4; device arrays of ``dtype``
    (default float64)."""
    import jax.numpy as jnp

    dtype = dtype or jnp.float64
    rng = rng or np.random.default_rng(1)
    plev = np.exp(np.linspace(np.log(40.0), np.log(101325.0), nlay + 1))
    plev = np.broadcast_to(plev, (ncol, nlay + 1)).copy()
    play = 0.5 * (plev[:, 1:] + plev[:, :-1])
    if t_iso is not None:
        tlay = np.full((ncol, nlay), t_iso)
        tlev = np.full((ncol, nlay + 1), t_iso)
        tsfc = np.full((ncol,), t_iso)
    else:
        prof = 220 + 70 * (play / play.max()) ** 0.3
        tlay = prof + rng.uniform(-5, 5, (ncol, nlay))
        tlev = np.concatenate([tlay[:, :1], 0.5 * (tlay[:, 1:] + tlay[:, :-1]), tlay[:, -1:]], 1)
        tsfc = tlev[:, -1] + rng.uniform(0, 5, ncol)
    gc = GasConcs.create(
        {"h2o": 3e-3 * (play / play.max()) ** 1.5 + 1e-6, "co2": 4e-4, "o3": 5e-7,
         "n2o": 3.2e-7, "ch4": 1.8e-6}
    )
    to = lambda x: jnp.asarray(x, dtype)
    return to(play), to(plev), to(tlay), to(tlev), to(tsfc), gc


def make_gcm_block(seed: int = 0, ncol: int = GCM_BLOCK_NCOL,
                   nlay: int = RFMIP_NLAY, dtype=np.float32) -> RFMIPData:
    """A GCM block of ``ncol`` columns from the RFMIP generator (all 18
    experiments, ncol / 18 sites rounded up, cut to ncol)."""
    nsites = -(-ncol // RFMIP_NEXP)
    data = make_rfmip(seed, nsites=nsites, nexp=RFMIP_NEXP, nlay=nlay,
                      dtype=dtype)
    if data.ncol == ncol:
        return data
    return data.block(0, ncol)


def make_allsky_atmosphere(seed: int = 0, ncol: int = 1800,
                           nlay: int = RFMIP_NLAY,
                           dtype=np.float32) -> GarandAtmosphere:
    """ncol present-day columns (experiment 1 of the generator) as a
    ``GarandAtmosphere`` for ``allsky_lw`` / ``allsky_sw``."""
    d = make_rfmip(seed, nsites=ncol, nexp=1, nlay=nlay, dtype=dtype)
    return GarandAtmosphere(play=d.play, plev=d.plev, tlay=d.tlay,
                            tlev=d.tlev, gas_concs=d.gas_concs)


def make_cloud_fields(seed: int, play, tlay, co):
    """(lwp, iwp, rel, rei) where ``make_clouds`` puts clouds, with water
    paths drawn log-normally around its 10 g/m2 and effective radii drawn
    uniformly inside the table's valid range."""
    rng = np.random.default_rng(seed)
    lwp, iwp, rel, rei = (np.asarray(a) for a in make_clouds(
        np.asarray(play), np.asarray(tlay), co))
    shape = lwp.shape
    lwp = lwp * rng.lognormal(0.0, 0.5, shape)
    iwp = iwp * rng.lognormal(0.0, 0.5, shape)
    rel = np.where(lwp > 0.0, rng.uniform(co.radliq_lwr, co.radliq_upr,
                                          shape), 0.0)
    rei = np.where(iwp > 0.0, rng.uniform(co.radice_lwr, co.radice_upr,
                                          shape), 0.0)
    dt = np.asarray(play).dtype
    return tuple(np.asarray(a, dt) for a in (lwp, iwp, rel, rei))


def make_cloud_optics(seed: int = 0, kind: str = "lw", dtype=None):
    """A LUT ``CloudOptics`` of the reference coefficient files' shapes
    (see the module docstring)."""
    import jax.numpy as jnp

    from ..extensions.cloud_optics import CloudOptics
    from ..gasoptics.planck import lw_spectral_g128, sw_spectral_g112
    from ..spectral import SpectralMapping

    if kind not in ("lw", "sw"):
        raise ValueError(f"kind must be 'lw' or 'sw', got {kind!r}")
    rng = np.random.default_rng(seed + (0 if kind == "lw" else 1))
    wvn = (lw_spectral_g128() if kind == "lw"
           else sw_spectral_g112()).band_lims_wvn_array
    nband, nliq, nice, nrgh = wvn.shape[0], 20, 18, 3
    radliq = np.linspace(2.5, 21.5, nliq)
    radice = np.linspace(10.0, 180.0, nice)
    nu = wvn.mean(axis=1)
    x = (np.log(nu) - np.log(nu).min()) / np.ptp(np.log(nu))  # 0..1 by band

    def tables(rad, rho, nrep):
        shape = (nrep, nband, rad.size)
        wiggle = 1.0 + 0.15 * rng.uniform(-1.0, 1.0, (nrep, nband, 1))
        ext = wiggle * 1.5 / (rho * rad)[None, None, :] * np.ones(shape)
        if kind == "lw":
            ssa = (0.25 + 0.45 * x[None, :, None]
                   + 0.1 * (rad / rad.max())[None, None, :])
        else:
            ssa = (1.0 - 1e-5 - 0.25 * (1.0 - x[None, :, None]) ** 3
                   * (rad / rad.max())[None, None, :])
        noise = 0.02 * rng.uniform(-1.0, 1.0, shape) * (1.0 - ssa)
        ssa = np.clip(ssa + noise, 0.05, 1.0 - 1e-5)
        asy = np.clip(0.75 + 0.12 * (rad / rad.max())[None, None, :]
                      + 0.03 * rng.uniform(-1.0, 1.0, shape), 0.0, 0.95)
        return ext, ssa, asy

    liq = tables(radliq, 1.0, 1)
    ice = tables(radice, 0.917, nrgh)
    dtype = dtype or jnp.float32
    arr = lambda a: jnp.asarray(a, dtype)
    return CloudOptics(
        spectral=SpectralMapping.bands_only(wvn),
        radliq_lwr=float(radliq[0]), radliq_upr=float(radliq[-1]),
        radice_lwr=float(radice[0]), radice_upr=float(radice[-1]),
        lut_extliq=arr(liq[0][0]), lut_ssaliq=arr(liq[1][0]),
        lut_asyliq=arr(liq[2][0]),
        lut_extice=arr(ice[0]), lut_ssaice=arr(ice[1]),
        lut_asyice=arr(ice[2]),
    )


def _rayleigh_model(seed: int, like):
    """A g-112 Rayleigh net at the absorption net's widths, weights from
    ``seed``, output scaling from the nu^4 law (module docstring)."""
    import jax.numpy as jnp

    from ..gasoptics.planck import sw_spectral_g112
    from ..models.network import NNModel

    rng = np.random.default_rng(seed + 112)
    dims = like.dims
    weights, biases = [], []
    for n_in, n_out in zip(dims[:-1], dims[1:]):
        weights.append(rng.normal(0.0, 1.0 / np.sqrt(n_in), (n_in, n_out)))
        biases.append(rng.normal(0.0, 0.1, (n_out,)))
    spec = sw_spectral_g112()
    nu = spec.band_lims_wvn_array.mean(axis=1)[spec.gpt2band]
    k_ray = 5e-27 * (nu / 18_000.0) ** 4
    mean = k_ray ** 0.125
    f32 = lambda a: jnp.asarray(a, jnp.float32)
    return NNModel(
        weights=tuple(f32(w) for w in weights),
        biases=tuple(f32(b) for b in biases),
        activations=like.activations,
        input_names=like.input_names,
        input_min=like.input_min, input_max=like.input_max,
        output_mean=f32(mean), output_std=f32(0.02 * mean),
    )


def load_models(seed: int = 0):
    """(lw_models, sw_models): ``[lw_both]`` and ``[absorption, rayleigh]``
    as the drivers take them (module docstring)."""
    from ..models.network import load_model_netcdf

    lw = load_model_netcdf(os.path.join(ARTIFACTS_DIR, LW_MODEL_FILE))
    sw_files = sorted(glob.glob(os.path.join(ARTIFACTS_DIR, SW_ABS_MODEL_GLOB)))
    if not sw_files:
        raise FileNotFoundError(
            f"no {SW_ABS_MODEL_GLOB} under {os.path.normpath(ARTIFACTS_DIR)}")
    sw_abs = load_model_netcdf(sw_files[0])
    return [lw], [sw_abs, _rayleigh_model(seed, sw_abs)]
