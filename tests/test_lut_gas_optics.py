"""LUT gas-optics tests against synthetic k-distributions.

The real k-distribution files are externally staged (not in the reference
repo), so the LUT path is validated with synthetic-but-structured data:
loader roundtrip, gas pruning, minor-gas reduction, interpolation
consistency, physics limits (isothermal blackbody via LUT Planck sources),
and SW energy accounting.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest

from rte_rrtmgp_nn_tpu.drivers.seeded_inputs import make_atmosphere
from rte_rrtmgp_nn_tpu.gasoptics.kdist import load_kdist
from rte_rrtmgp_nn_tpu.gasoptics.lut_gas_optics import (
    compute_optimal_angles,
    gas_optics_lw_lut,
    gas_optics_sw_lut,
)
from rte_rrtmgp_nn_tpu.gasoptics.synthetic import generate_kdist_nc
from rte_rrtmgp_nn_tpu.ops.gas_optics_lut import compute_col_gas, interpolation
from rte_rrtmgp_nn_tpu.ops.lw_solver import lw_solver_noscat
from rte_rrtmgp_nn_tpu.ops.sw_solver import sw_solver_2stream
from rte_rrtmgp_nn_tpu.rte import rte_lw, rte_sw

SIGMA = 5.670374419e-8
GASES = ["h2o", "co2", "o3", "n2o", "ch4"]


@pytest.fixture(scope="module")
def lw_kdist_file(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("kdist") / "synthetic-lw.nc")
    generate_kdist_nc(p, kind="lw", gpts_per_band=4, nband=16)
    return p


@pytest.fixture(scope="module")
def sw_kdist_file(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("kdist") / "synthetic-sw.nc")
    generate_kdist_nc(p, kind="sw", gpts_per_band=4, nband=14)
    return p


class TestLoader:
    def test_load_full(self, lw_kdist_file):
        kd = load_kdist(lw_kdist_file, GASES)
        assert kd.is_internal_source
        assert kd.ngpt == 64 and kd.nband == 16
        assert kd.gas_names == tuple(GASES)
        assert kd.minor_lower.n_minor == 2 and kd.minor_upper.n_minor == 1
        assert kd.kmajor.shape == (14, 60, 9, 64)
        assert kd.nflav >= 2
        # every gpt has valid flavor indices
        gf = np.asarray(kd.gpoint_flavor)
        assert gf.min() >= 0 and gf.max() < kd.nflav

    def test_gas_pruning_and_minor_reduction(self, lw_kdist_file):
        """Loading with fewer gases prunes minors whose gas is absent."""
        kd = load_kdist(lw_kdist_file, ["h2o", "co2", "o3", "ch4"])  # no n2o
        assert "n2o" not in kd.gas_names
        assert kd.minor_lower.n_minor == 1  # the n2o minor is gone
        assert kd.minor_lower.kminor.shape[-1] == 4  # only ch4's 4 gpts remain

    def test_missing_key_gas_raises(self, lw_kdist_file):
        with pytest.raises(ValueError, match="key species"):
            load_kdist(lw_kdist_file, ["h2o", "co2"])  # o3/ch4 are key somewhere

    def test_zero_key_band_resolves_in_reduced_space(self, tmp_path):
        """(0,0) key-species bands rewrite to (2,2) AFTER gas reduction
        (reference create_key_species_reduce THEN create_flavor,
        mo_gas_optics_rrtmgp.F90:1509-1514): with the file's second gas
        pruned, (2,2) must mean the second AVAILABLE gas -- the loader
        must neither raise on the pruned file-gas nor point the flavor at
        the wrong species."""
        from rte_rrtmgp_nn_tpu.gasoptics.synthetic import generate_kdist_nc

        path = str(tmp_path / "kd_zero_key.nc")
        # co2 (file gas 2) is never key so it can be pruned; band 4 has
        # no key species at all
        generate_kdist_nc(path, kind="lw", gases=("h2o", "co2", "o3"),
                          nband=4, key_pairs=[(1, 1), (3, 3), (1, 3), (0, 0)])
        kd = load_kdist(path, ["h2o", "o3"])
        assert kd.gas_names == ("h2o", "o3")
        # the zero-key band's flavor pair is (2,2) = o3 in REDUCED space
        assert (2, 2) in kd.flavor
        iflav = kd.flavor.index((2, 2))
        gf = np.asarray(kd.gpoint_flavor)
        g2b = np.asarray(kd.spectral.gpt2band)
        assert np.all(gf[g2b == 3] == iflav)
        # unpruned load: reduced list == file list, so the zero-key band's
        # flavor is (2,2) = co2 there (reference semantics)
        kd_full = load_kdist(path, ["h2o", "co2", "o3"])
        assert (2, 2) in kd_full.flavor
        gf_full = np.asarray(kd_full.gpoint_flavor)
        assert np.all(
            gf_full[g2b == 3] == kd_full.flavor.index((2, 2)))

    def test_sw_load(self, sw_kdist_file):
        kd = load_kdist(sw_kdist_file, GASES)
        assert not kd.is_internal_source
        assert kd.krayl is not None and kd.krayl.shape[0] == 2
        assert kd.tsi_default == pytest.approx(1360.85)
        src = np.asarray(kd.solar_source())
        assert src.shape == (56,) and np.all(src > 0)
        src_tsi = np.asarray(kd.solar_source(tsi=1400.0))
        assert np.sum(src_tsi) == pytest.approx(1400.0, rel=1e-6)


class TestInterpolation:
    def test_indices_in_range(self, lw_kdist_file):
        kd = load_kdist(lw_kdist_file, GASES)
        play, plev, tlay, tlev, tsfc, gc = make_atmosphere()
        from rte_rrtmgp_nn_tpu.gasoptics.nn_gas_optics import get_col_dry

        col_dry = get_col_dry(gc.get_vmr("h2o", 4, 20), plev)
        col_gas = compute_col_gas(kd, gc, col_dry)
        ic = interpolation(kd, play, tlay, col_gas)
        assert int(jnp.min(ic.jtemp)) >= 0 and int(jnp.max(ic.jtemp)) <= kd.ntemp - 2
        assert int(jnp.min(ic.jpress)) >= 0 and int(jnp.max(ic.jpress)) <= kd.npres - 2
        assert int(jnp.min(ic.jeta)) >= 0 and int(jnp.max(ic.jeta)) <= kd.neta - 2
        # tropo flag: high-pressure layers are 'lower' atmosphere
        tropo = np.asarray(ic.tropo)
        assert tropo[0, -1] and not tropo[0, 0]  # surface True, TOA False
        # fractions within [0,1] for in-range profiles
        assert float(jnp.min(ic.feta)) >= -1e-6 and float(jnp.max(ic.feta)) <= 1 + 1e-6


class TestLWPath:
    def test_tau_positive_finite(self, lw_kdist_file):
        kd = load_kdist(lw_kdist_file, GASES)
        play, plev, tlay, tlev, tsfc, gc = make_atmosphere()
        props, sources = gas_optics_lw_lut(kd, play, plev, tlay, tsfc, gc, tlev=tlev)
        tau = np.asarray(props.tau)
        assert np.all(np.isfinite(tau)) and np.all(tau >= 0) and tau.max() > 0.01
        assert np.all(np.asarray(sources.lay_source) >= 0)

    def test_isothermal_blackbody_through_lut(self, tmp_path):
        """Full LUT chain at constant T with thick optics must emit
        sigma*T^4 -- validates pfrac + totplnk + sources + solver units.
        Needs the pfrac_uniform table: the closed-form answer mixes TOA-layer
        pfrac (saturated g-points) with surface pfrac (any thin ones), which
        only cancels when pfrac is vertically homogeneous."""
        path = str(tmp_path / "lw_uniform.nc")
        generate_kdist_nc(path, kind="lw", gpts_per_band=4, pfrac_uniform=True)
        kd = load_kdist(path, GASES)
        T = 280.0
        play, plev, tlay, tlev, tsfc, gc = make_atmosphere(t_iso=T)
        props, sources = gas_optics_lw_lut(kd, play, plev, tlay, tsfc, gc, tlev=tlev)
        import dataclasses

        thick = dataclasses.replace(props, tau=props.tau * 200.0)
        emis = jnp.ones((4, kd.nband))
        sol = rte_lw(thick, True, sources, emis)
        up = np.asarray(jnp.sum(sol.flux_up, -1))
        bb = SIGMA * T**4
        np.testing.assert_allclose(up[:, -1], bb, rtol=2e-3)
        np.testing.assert_allclose(up[:, 0], bb, rtol=2e-3)

    def test_save_pfrac_sums_to_nband(self, lw_kdist_file):
        kd = load_kdist(lw_kdist_file, GASES)
        play, plev, tlay, tlev, tsfc, gc = make_atmosphere()
        _, sources = gas_optics_lw_lut(kd, play, plev, tlay, tsfc, gc, tlev=tlev, save_pfrac=True)
        assert sources.planck_frac is not None
        total = float(jnp.sum(sources.planck_frac[0, 0]))
        assert total == pytest.approx(kd.nband, rel=1e-5)

    def test_optimal_angles(self, lw_kdist_file):
        kd = load_kdist(lw_kdist_file, GASES)
        play, plev, tlay, tlev, tsfc, gc = make_atmosphere()
        props, _ = gas_optics_lw_lut(kd, play, plev, tlay, tsfc, gc, tlev=tlev)
        ang = np.asarray(compute_optimal_angles(kd, props.tau))
        assert ang.shape == (4, kd.ngpt)
        assert np.all(ang > 0.9) and np.all(ang < 2.5)

    def test_col_dry_override(self, lw_kdist_file):
        kd = load_kdist(lw_kdist_file, GASES)
        play, plev, tlay, tlev, tsfc, gc = make_atmosphere()
        from rte_rrtmgp_nn_tpu.gasoptics.nn_gas_optics import get_col_dry

        cd = get_col_dry(gc.get_vmr("h2o", 4, 20), plev)
        p1, _ = gas_optics_lw_lut(kd, play, plev, tlay, tsfc, gc, tlev=tlev)
        p2, _ = gas_optics_lw_lut(kd, play, plev, tlay, tsfc, gc, tlev=tlev, col_dry=cd)
        np.testing.assert_allclose(np.asarray(p1.tau), np.asarray(p2.tau), rtol=1e-6)


class TestSWPath:
    def test_sw_props_and_conservation(self, sw_kdist_file):
        kd = load_kdist(sw_kdist_file, GASES)
        play, plev, tlay, tlev, tsfc, gc = make_atmosphere()
        props, src = gas_optics_sw_lut(kd, play, plev, tlay, gc)
        ssa = np.asarray(props.ssa)
        assert np.all(ssa >= 0) and np.all(ssa <= 1.0)
        mu0 = jnp.full((4,), 0.8)
        alb = jnp.zeros((4, kd.ngpt))
        sol = rte_sw(props, True, mu0, src.toa_source, alb, alb)
        incident = np.asarray(src.toa_source).sum(-1) * 0.8
        up_toa = np.asarray(jnp.sum(sol.flux_up, -1))[:, 0]
        dn_sfc = np.asarray(jnp.sum(sol.flux_dn, -1))[:, -1]
        # absorbed + reflected + transmitted == incident (within 2-stream tolerance)
        assert np.all(up_toa >= -1e-6) and np.all(up_toa < incident)
        assert np.all(dn_sfc > 0) and np.all(dn_sfc < incident)


class TestSolarSourceWiring:
    """resolve_solar_source: k-distribution NRLSSI2 terms must drive the SW
    TOA source whenever a kdist is supplied (reference
    mo_gas_optics_rrtmgp.F90:594-599, variability :1058-1095)."""

    def test_matching_gpts_uses_kdist_terms(self, sw_kdist_file):
        from rte_rrtmgp_nn_tpu.drivers.rfmip import resolve_solar_source

        kd = load_kdist(sw_kdist_file, GASES)
        src = resolve_solar_source(kd.spectral, kd)
        np.testing.assert_allclose(src, np.asarray(kd.solar_source()), rtol=1e-12)
        # the facular/sunspot terms must be in there (not quiet-only)
        assert not np.allclose(src, np.asarray(kd.solar_quiet))

    def test_band_remap_conserves_band_totals(self, sw_kdist_file):
        from rte_rrtmgp_nn_tpu.drivers.rfmip import resolve_solar_source
        from rte_rrtmgp_nn_tpu.gasoptics.planck import _mapping_from_counts

        kd = load_kdist(sw_kdist_file, GASES)
        target = _mapping_from_counts(
            (2,) * kd.nband, kd.spectral.band_lims_wvn_array)
        src = resolve_solar_source(target, kd)
        assert src.shape == (target.ngpt,)
        ref = np.asarray(kd.solar_source())
        for ib in range(kd.nband):
            s, e = target.band_lims_gpt[ib]
            ks, ke = kd.spectral.band_lims_gpt[ib]
            np.testing.assert_allclose(
                src[s:e].sum(), ref[ks:ke].sum(), rtol=1e-10)

    def test_band_mismatch_raises(self, sw_kdist_file, lw_kdist_file):
        from rte_rrtmgp_nn_tpu.drivers.rfmip import resolve_solar_source

        kd = load_kdist(sw_kdist_file, GASES)
        kd_lw = load_kdist(lw_kdist_file, GASES)
        with pytest.raises(ValueError):
            resolve_solar_source(kd_lw.spectral, kd)

    def test_no_kdist_falls_back(self):
        from rte_rrtmgp_nn_tpu.drivers.rfmip import (
            default_solar_source,
            resolve_solar_source,
        )
        from rte_rrtmgp_nn_tpu.gasoptics.planck import sw_spectral_g112

        spec = sw_spectral_g112()
        np.testing.assert_allclose(
            resolve_solar_source(spec), default_solar_source(spec))

    def test_sw_driver_end_to_end_with_kdist(self, sw_kdist_file):
        """rfmip_clear_sky_sw(kdist=...) must produce the same fluxes as
        passing resolve_solar_source explicitly, and different fluxes from
        the brightness-temperature default (the NRLSSI2 spectral shape
        redistributes absorption even under TSI renormalization)."""
        import dataclasses

        from rte_rrtmgp_nn_tpu.drivers.rfmip import (
            resolve_solar_source,
            rfmip_clear_sky_sw,
        )
        from rte_rrtmgp_nn_tpu.drivers.seeded_inputs import (
            load_models,
            make_rfmip,
        )
        from rte_rrtmgp_nn_tpu.gasoptics.planck import sw_spectral_g112

        data = make_rfmip(seed=0, nsites=10)
        idx = np.arange(0, data.ncol, 23)[:8]  # 8 columns
        data = dataclasses.replace(
            data,
            play=data.play[idx], plev=data.plev[idx], tlay=data.tlay[idx],
            tlev=data.tlev[idx], tsfc=data.tsfc[idx],
            sfc_emis=data.sfc_emis[idx], sfc_alb=data.sfc_alb[idx],
            sza=data.sza[idx], tsi=data.tsi[idx],
            gas_concs=type(data.gas_concs)({
                k: (v[idx] if v.ndim == 2 else v)
                for k, v in data.gas_concs.concs.items()
            }),
            nexp=1, nsites=len(idx),
        )
        _, models = load_models(seed=0)
        kd = load_kdist(sw_kdist_file, GASES)
        spec = sw_spectral_g112()
        via_kdist = rfmip_clear_sky_sw(data, models, kdist=kd)
        explicit = rfmip_clear_sky_sw(
            data, models, solar_source=resolve_solar_source(spec, kd))
        np.testing.assert_array_equal(
            np.asarray(via_kdist.flux_dn), np.asarray(explicit.flux_dn))
        default = rfmip_clear_sky_sw(data, models)
        assert np.all(np.isfinite(np.asarray(via_kdist.flux_dn)))
        assert not np.allclose(
            np.asarray(via_kdist.flux_dn), np.asarray(default.flux_dn))
