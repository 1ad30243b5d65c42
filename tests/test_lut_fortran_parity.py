"""Independent cross-validation of the LUT kernels.

The vectorized JAX formulation (dense per-g-point gathers) is checked
against a direct numpy transcription of the Fortran kernel semantics
(1-based indices, per-(col,lay,flavor) loops) written from
``mo_gas_optics_kernels.F90:47-144`` (interpolation), ``:300-356``
(gas_optical_depths_major / interpolate3D_byflav), ``:360-462`` (minor),
and ``:469-511`` (rayleigh). A shared-misunderstanding bug between the
synthetic generator and the JAX kernels cannot hide from this test.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from rte_rrtmgp_nn_tpu.gasoptics.kdist import load_kdist
from rte_rrtmgp_nn_tpu.gasoptics.synthetic import generate_kdist_nc
from rte_rrtmgp_nn_tpu.ops.gas_optics_lut import (
    compute_col_gas,
    compute_tau_absorption,
    compute_tau_rayleigh,
    interpolation,
)

from test_lut_gas_optics import GASES, make_atmosphere


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("kd")
    plw = str(d / "lw.nc")
    psw = str(d / "sw.nc")
    generate_kdist_nc(plw, kind="lw", gpts_per_band=4, nband=16)
    generate_kdist_nc(psw, kind="sw", gpts_per_band=4, nband=14)
    kd = load_kdist(plw, GASES, dtype=jnp.float64)
    kd_sw = load_kdist(psw, GASES, dtype=jnp.float64)
    atmos = make_atmosphere(ncol=3, nlay=10, dtype=jnp.float64)
    return kd, kd_sw, atmos


def fortran_interpolation(kd, play, tlay, col_gas):
    """1-based transcription of the reference `interpolation` kernel."""
    ncol, nlay = play.shape
    nflav = kd.nflav
    ntemp, npres, neta = kd.ntemp, kd.npres, kd.neta
    temp_ref = np.asarray(kd.temp_ref)
    press_ref_log = np.asarray(kd.press_ref_log)
    temp_ref_min = temp_ref[0]
    temp_ref_delta = (temp_ref[-1] - temp_ref[0]) / (ntemp - 1)
    press_ref_log_delta = (press_ref_log[-1] - press_ref_log[0]) / (npres - 1)
    vmr_ref = np.asarray(kd.vmr_ref)  # (2, 1+ngas, ntemp)
    flavor = np.asarray(kd.flavor)  # (nflav, 2), 0-based col_gas indices

    jtemp = np.zeros((ncol, nlay), int)  # 1-based
    jpress = np.zeros((ncol, nlay), int)
    tropo = np.zeros((ncol, nlay), bool)
    ftemp = np.zeros((ncol, nlay))
    fpress = np.zeros((ncol, nlay))
    jeta = np.zeros((2, nflav, ncol, nlay), int)  # 1-based
    col_mix = np.zeros((2, nflav, ncol, nlay))
    fmajor = np.zeros((2, 2, 2, nflav, ncol, nlay))
    fminor = np.zeros((2, 2, nflav, ncol, nlay))

    cg = np.asarray(col_gas)
    for icol in range(ncol):
        for ilay in range(nlay):
            t = float(tlay[icol, ilay])
            jt = int((t - (temp_ref_min - temp_ref_delta)) / temp_ref_delta)
            jt = min(ntemp - 1, max(1, jt))
            jtemp[icol, ilay] = jt
            ft = (t - temp_ref[jt - 1]) / temp_ref_delta
            ftemp[icol, ilay] = ft

            pl = np.log(float(play[icol, ilay]))
            locpress = 1.0 + (pl - press_ref_log[0]) / press_ref_log_delta
            jp = min(npres - 1, max(1, int(locpress)))
            jpress[icol, ilay] = jp
            fp = locpress - jp
            fpress[icol, ilay] = fp
            trop = pl > kd.press_ref_trop_log
            tropo[icol, ilay] = trop
            itropo = 1 if trop else 2  # 1-based

            for iflav in range(nflav):
                ig1, ig2 = flavor[iflav]
                for itemp in (1, 2):
                    r = (
                        vmr_ref[itropo - 1, ig1, jt + itemp - 2 + 1 - 1]
                        / vmr_ref[itropo - 1, ig2, jt + itemp - 2 + 1 - 1]
                    )
                    # note: vmr_ref temperature index = jtemp + itemp - 1 (1-based)
                    cm = cg[icol, ilay, ig1] + r * cg[icol, ilay, ig2]
                    col_mix[itemp - 1, iflav, icol, ilay] = cm
                    eta = cg[icol, ilay, ig1] / cm if cm > 2 * np.finfo(float).tiny else 0.5
                    loceta = eta * (neta - 1)
                    je = min(int(loceta) + 1, neta - 1)
                    jeta[itemp - 1, iflav, icol, ilay] = je
                    feta = loceta % 1.0
                    ftemp_term = (2 - itemp) + (2 * itemp - 3) * ft
                    fminor[0, itemp - 1, iflav, icol, ilay] = (1 - feta) * ftemp_term
                    fminor[1, itemp - 1, iflav, icol, ilay] = feta * ftemp_term
                    fmajor[0, 0, itemp - 1, iflav, icol, ilay] = (1 - fp) * fminor[0, itemp - 1, iflav, icol, ilay]
                    fmajor[1, 0, itemp - 1, iflav, icol, ilay] = (1 - fp) * fminor[1, itemp - 1, iflav, icol, ilay]
                    fmajor[0, 1, itemp - 1, iflav, icol, ilay] = fp * fminor[0, itemp - 1, iflav, icol, ilay]
                    fmajor[1, 1, itemp - 1, iflav, icol, ilay] = fp * fminor[1, itemp - 1, iflav, icol, ilay]
    return jtemp, jpress, tropo, jeta, col_mix, fmajor, fminor


def fortran_tau_major(kd, itp):
    """1-based transcription of gas_optical_depths_major."""
    jtemp, jpress, tropo, jeta, col_mix, fmajor, fminor = itp
    ncol, nlay = jtemp.shape
    ngpt = kd.ngpt
    kmajor = np.asarray(kd.kmajor)  # (ntemp, npres+1, neta, ngpt) C-order
    gpoint_flavor = np.asarray(kd.gpoint_flavor)  # (ngpt, 2) 0-based [lower, upper]
    blg = kd.spectral.band_lims_gpt_array

    tau = np.zeros((ncol, nlay, ngpt))
    for icol in range(ncol):
        for ilay in range(nlay):
            itropo = 1 if tropo[icol, ilay] else 2
            for ib in range(kd.nband):
                gptS, gptE = blg[ib]
                iflav = gpoint_flavor[gptS, itropo - 1]
                jp_eff = jpress[icol, ilay] + itropo  # 1-based into npres+1 dim
                jt = jtemp[icol, ilay]
                for g in range(gptS, gptE):
                    acc = 0.0
                    for itemp in (1, 2):
                        je = jeta[itemp - 1, iflav, icol, ilay]
                        scale = col_mix[itemp - 1, iflav, icol, ilay]
                        acc += scale * (
                            fmajor[0, 0, itemp - 1, iflav, icol, ilay]
                            * kmajor[jt + itemp - 2, jp_eff - 2, je - 1, g]
                            + fmajor[1, 0, itemp - 1, iflav, icol, ilay]
                            * kmajor[jt + itemp - 2, jp_eff - 2, je, g]
                            + fmajor[0, 1, itemp - 1, iflav, icol, ilay]
                            * kmajor[jt + itemp - 2, jp_eff - 1, je - 1, g]
                            + fmajor[1, 1, itemp - 1, iflav, icol, ilay]
                            * kmajor[jt + itemp - 2, jp_eff - 1, je, g]
                        )
                    tau[icol, ilay, g] = acc
    return tau


def fortran_tau_minor(kd, minor, atmos_is_lower, itp, play, tlay, col_gas):
    """1-based transcription of gas_optical_depths_minor
    (mo_gas_optics_kernels.F90:360-462) for one atmosphere, with the
    troposphere mask standing in for the contiguous layer_limits ranges."""
    jtemp, jpress, tropo, jeta, col_mix, fmajor, fminor = itp
    ncol, nlay = jtemp.shape
    ngpt = kd.ngpt
    kminor = np.asarray(minor.kminor)  # (ntemp, neta, ncontrib) C-order
    gf = np.asarray(kd.gpoint_flavor)  # (ngpt, 2) 0-based [lower, upper]
    cg = np.asarray(col_gas)
    pa_to_hpa = 0.01

    tau = np.zeros((ncol, nlay, ngpt))
    for im in range(minor.n_minor):
        gptS, gptE = minor.limits_gpt[im]  # 0-based half-open
        ks = minor.kminor_start[im]  # 0-based
        for icol in range(ncol):
            for ilay in range(nlay):
                in_atmos = tropo[icol, ilay] if atmos_is_lower else not tropo[icol, ilay]
                if not in_atmos:
                    continue
                scaling = cg[icol, ilay, minor.idx_minor[im]]
                if minor.scales_with_density[im]:
                    scaling = scaling * (
                        pa_to_hpa * play[icol, ilay] / tlay[icol, ilay]
                    )
                    iscl = minor.idx_minor_scaling[im]
                    if iscl > 0:
                        vmr_fact = 1.0 / cg[icol, ilay, 0]
                        dry_fact = 1.0 / (
                            1.0 + cg[icol, ilay, 1 + kd.gas_names.index("h2o")] * vmr_fact
                        )
                        if minor.scale_by_complement[im]:
                            scaling = scaling * (
                                1.0 - cg[icol, ilay, iscl] * vmr_fact * dry_fact
                            )
                        else:
                            scaling = scaling * (
                                cg[icol, ilay, iscl] * vmr_fact * dry_fact
                            )
                iflav = gf[gptS, 0 if atmos_is_lower else 1]
                jt = jtemp[icol, ilay]  # 1-based
                for g in range(gptS, gptE):
                    krow = ks + (g - gptS)
                    # interpolate2D_byflav (:1089-1107), 1-based indices
                    val = (
                        fminor[0, 0, iflav, icol, ilay]
                        * kminor[jt - 1, jeta[0, iflav, icol, ilay] - 1, krow]
                        + fminor[1, 0, iflav, icol, ilay]
                        * kminor[jt - 1, jeta[0, iflav, icol, ilay], krow]
                        + fminor[0, 1, iflav, icol, ilay]
                        * kminor[jt, jeta[1, iflav, icol, ilay] - 1, krow]
                        + fminor[1, 1, iflav, icol, ilay]
                        * kminor[jt, jeta[1, iflav, icol, ilay], krow]
                    )
                    tau[icol, ilay, g] += scaling * val
    return tau


def fortran_interpolate1d(val, offset, delta, table):
    """1-based transcription of interpolate1D (:1024-1043)."""
    val0 = (val - offset) / delta
    frac = val0 - int(val0)
    index = min(table.shape[0] - 1, max(1, int(val0) + 1))  # 1-based
    return table[index - 1] + frac * (table[index] - table[index - 1])


def fortran_planck_source(kd, itp, tlay, tlev, tsfc, sfc_lay_1based):
    """1-based transcription of compute_Planck_source (:514-611)."""
    jtemp, jpress, tropo, jeta, col_mix, fmajor, fminor = itp
    ncol, nlay = jtemp.shape
    ngpt, nband = kd.ngpt, kd.nband
    pfracin = np.asarray(kd.pfracin)  # (ntemp, npres+1, neta, ngpt) C-order
    totplnk = np.asarray(kd.planck.totplnk)  # (nPlanckTemp, nband)
    gf = np.asarray(kd.gpoint_flavor)
    blg = kd.spectral.band_lims_gpt_array
    tmin, tdelta = kd.planck.temp_ref_min, kd.planck.totplnk_delta
    delta_tsfc = 1.0

    pfrac = np.zeros((ncol, nlay, ngpt))
    lay_source = np.zeros((ncol, nlay, ngpt))
    lev_source = np.zeros((ncol, nlay + 1, ngpt))
    sfc_source = np.zeros((ncol, ngpt))
    sfc_source_jac = np.zeros((ncol, ngpt))

    for icol in range(ncol):
        for ilay in range(nlay):
            b_lev = fortran_interpolate1d(tlev[icol, ilay], tmin, tdelta, totplnk)
            b_lay = fortran_interpolate1d(tlay[icol, ilay], tmin, tdelta, totplnk)
            itropo = 1 if tropo[icol, ilay] else 2
            jt = jtemp[icol, ilay]  # 1-based
            jp_eff = jpress[icol, ilay] + itropo  # 1-based into npres+1 dim
            for ib in range(nband):
                gptS, gptE = blg[ib]
                iflav = gf[gptS, itropo - 1]
                for g in range(gptS, gptE):
                    # interpolate3D_byflav with scaling = (1, 1) (:1136-1165)
                    acc = 0.0
                    for itemp in (1, 2):
                        je = jeta[itemp - 1, iflav, icol, ilay]  # 1-based
                        acc += (
                            fmajor[0, 0, itemp - 1, iflav, icol, ilay]
                            * pfracin[jt + itemp - 2, jp_eff - 2, je - 1, g]
                            + fmajor[1, 0, itemp - 1, iflav, icol, ilay]
                            * pfracin[jt + itemp - 2, jp_eff - 2, je, g]
                            + fmajor[0, 1, itemp - 1, iflav, icol, ilay]
                            * pfracin[jt + itemp - 2, jp_eff - 1, je - 1, g]
                            + fmajor[1, 1, itemp - 1, iflav, icol, ilay]
                            * pfracin[jt + itemp - 2, jp_eff - 1, je, g]
                        )
                    pfrac[icol, ilay, g] = acc
                    lev_source[icol, ilay, g] = acc * b_lev[ib]
                    lay_source[icol, ilay, g] = acc * b_lay[ib]
        b_sfc = fortran_interpolate1d(tsfc[icol], tmin, tdelta, totplnk)
        b_sfc_jac = fortran_interpolate1d(
            tsfc[icol] + delta_tsfc, tmin, tdelta, totplnk)
        b_top = fortran_interpolate1d(tlev[icol, nlay], tmin, tdelta, totplnk)
        for ib in range(nband):
            gptS, gptE = blg[ib]
            for g in range(gptS, gptE):
                lev_source[icol, nlay, g] = pfrac[icol, nlay - 1, g] * b_top[ib]
                sfc_source[icol, g] = pfrac[icol, sfc_lay_1based - 1, g] * b_sfc[ib]
                sfc_source_jac[icol, g] = pfrac[icol, sfc_lay_1based - 1, g] * (
                    b_sfc_jac[ib] - b_sfc[ib]
                )
    return lay_source, lev_source, sfc_source, sfc_source_jac, pfrac


class TestFortranParity:
    def test_interpolation_indices(self, setup):
        kd, _, atmos = setup
        play, plev, tlay, tlev, tsfc, gc = atmos
        from rte_rrtmgp_nn_tpu.gasoptics.nn_gas_optics import get_col_dry

        col_dry = get_col_dry(gc.get_vmr("h2o", 3, 10), plev)
        col_gas = compute_col_gas(kd, gc, col_dry)
        ic = interpolation(kd, play, tlay, col_gas)
        jt_f, jp_f, tropo_f, jeta_f, colmix_f, fmajor_f, fminor_f = fortran_interpolation(
            kd, np.asarray(play), np.asarray(tlay), col_gas
        )
        np.testing.assert_array_equal(np.asarray(ic.jtemp), jt_f - 1)
        np.testing.assert_array_equal(np.asarray(ic.jpress), jp_f - 1)
        np.testing.assert_array_equal(np.asarray(ic.tropo), tropo_f)
        # jeta: ours (ncol, nlay, nflav, 2) 0-based vs theirs (2, nflav, ncol, nlay) 1-based
        je_ours = np.moveaxis(np.asarray(ic.jeta), (0, 1, 2, 3), (2, 3, 1, 0))
        np.testing.assert_array_equal(je_ours, jeta_f - 1)
        cm_ours = np.moveaxis(np.asarray(ic.col_mix), (0, 1, 2, 3), (2, 3, 1, 0))
        np.testing.assert_allclose(cm_ours, colmix_f, rtol=1e-12)
        fe_ours = np.asarray(ic.feta)  # (ncol, nlay, nflav, 2)
        # fminor[ieta, itemp] = w_eta * ftemp_term; reconstruct and compare
        ftt = np.stack([1 - np.asarray(ic.ftemp), np.asarray(ic.ftemp)], -1)  # (ncol,nlay,2)
        fm0 = (1 - fe_ours) * ftt[:, :, None, :]
        fm1 = fe_ours * ftt[:, :, None, :]
        np.testing.assert_allclose(
            np.moveaxis(fm0, (0, 1, 2, 3), (2, 3, 1, 0)), fminor_f[0], rtol=1e-12
        )
        np.testing.assert_allclose(
            np.moveaxis(fm1, (0, 1, 2, 3), (2, 3, 1, 0)), fminor_f[1], rtol=1e-12
        )

    def test_tau_major_matches(self, setup):
        kd, _, atmos = setup
        play, plev, tlay, tlev, tsfc, gc = atmos
        from rte_rrtmgp_nn_tpu.gasoptics.nn_gas_optics import get_col_dry
        from rte_rrtmgp_nn_tpu.ops.gas_optics_lut import tau_major

        col_dry = get_col_dry(gc.get_vmr("h2o", 3, 10), plev)
        col_gas = compute_col_gas(kd, gc, col_dry)
        ic = interpolation(kd, play, tlay, col_gas)
        ours = np.asarray(tau_major(kd, ic))
        itp = fortran_interpolation(kd, np.asarray(play), np.asarray(tlay), col_gas)
        ref = fortran_tau_major(kd, itp)
        np.testing.assert_allclose(ours, ref, rtol=1e-10)

    def test_tau_minor_matches(self, setup):
        """Minor-gas tau (density scaling, complement, scaling gas, upper
        atmosphere) vs the 1-based transcription of
        gas_optical_depths_minor (:360-462)."""
        kd, _, atmos = setup
        play, plev, tlay, tlev, tsfc, gc = atmos
        from rte_rrtmgp_nn_tpu.gasoptics.nn_gas_optics import get_col_dry
        from rte_rrtmgp_nn_tpu.ops.gas_optics_lut import tau_minor_one_atmos

        assert kd.minor_lower.n_minor >= 2, "need >=2 lower minor intervals"
        assert kd.minor_upper.n_minor >= 1
        assert any(kd.minor_lower.scales_with_density)
        assert any(kd.minor_lower.scale_by_complement)
        assert any(i > 0 for i in kd.minor_lower.idx_minor_scaling)

        col_dry = get_col_dry(gc.get_vmr("h2o", 3, 10), plev)
        col_gas = compute_col_gas(kd, gc, col_dry)
        ic = interpolation(kd, play, tlay, col_gas)
        idx_h2o = 1 + kd.gas_names.index("h2o")
        zeros = jnp.zeros((3, 10, kd.ngpt), jnp.float64)
        itp = fortran_interpolation(kd, np.asarray(play), np.asarray(tlay), col_gas)
        for minor, lower in ((kd.minor_lower, True), (kd.minor_upper, False)):
            ours = np.asarray(tau_minor_one_atmos(
                kd, minor, lower, ic, play, tlay, col_gas, idx_h2o, zeros))
            ref = fortran_tau_minor(
                kd, minor, lower, itp, np.asarray(play), np.asarray(tlay),
                col_gas)
            np.testing.assert_allclose(ours, ref, rtol=1e-10)

    def test_tau_absorption_matches(self, setup):
        """Full major+minor absorption tau vs the composed transcriptions
        (compute_tau_absorption :150-295)."""
        kd, _, atmos = setup
        play, plev, tlay, tlev, tsfc, gc = atmos
        from rte_rrtmgp_nn_tpu.gasoptics.nn_gas_optics import get_col_dry

        col_dry = get_col_dry(gc.get_vmr("h2o", 3, 10), plev)
        col_gas = compute_col_gas(kd, gc, col_dry)
        ic = interpolation(kd, play, tlay, col_gas)
        ours = np.asarray(compute_tau_absorption(kd, ic, play, tlay, col_gas))
        itp = fortran_interpolation(kd, np.asarray(play), np.asarray(tlay), col_gas)
        ref = fortran_tau_major(kd, itp)
        ref += fortran_tau_minor(
            kd, kd.minor_lower, True, itp, np.asarray(play), np.asarray(tlay), col_gas)
        ref += fortran_tau_minor(
            kd, kd.minor_upper, False, itp, np.asarray(play), np.asarray(tlay), col_gas)
        np.testing.assert_allclose(ours, ref, rtol=1e-10)

    def test_planck_source_matches(self, setup):
        """LUT Planck source vs the 1-based transcription of
        compute_Planck_source (:514-611), canonical orientation.

        The flipped orientation is NOT compared against the reference: this
        fork's single-lev_source refactor pairs the flipped down-source with
        the physically upper layer edge (see compute_planck_source_nn
        docstring); this framework canonicalizes instead, so flipped inputs
        reproduce flipped canonical fluxes exactly -- asserted by
        tests/test_verification_invariants.py::test_vertical_reverse."""
        kd, _, atmos = setup
        play, plev, tlay, tlev, tsfc, gc = atmos
        from rte_rrtmgp_nn_tpu.gasoptics.nn_gas_optics import get_col_dry
        from rte_rrtmgp_nn_tpu.ops.gas_optics_lut import compute_planck_source

        col_dry = get_col_dry(gc.get_vmr("h2o", 3, 10), plev)
        col_gas = compute_col_gas(kd, gc, col_dry)
        ic = interpolation(kd, play, tlay, col_gas)
        lay, lev, sfc, sfc_jac = compute_planck_source(
            kd, ic, tlay, tlev, tsfc, top_at_1=True)
        itp = fortran_interpolation(kd, np.asarray(play), np.asarray(tlay), col_gas)
        lay_f, lev_f, sfc_f, sfc_jac_f, _ = fortran_planck_source(
            kd, itp, np.asarray(tlay), np.asarray(tlev), np.asarray(tsfc),
            sfc_lay_1based=10)
        np.testing.assert_allclose(np.asarray(lay), lay_f, rtol=1e-10)
        np.testing.assert_allclose(np.asarray(sfc), sfc_f, rtol=1e-10)
        np.testing.assert_allclose(np.asarray(sfc_jac), sfc_jac_f, rtol=1e-10)
        np.testing.assert_allclose(np.asarray(lev), lev_f, rtol=1e-10)

    def test_rayleigh_scaling(self, setup):
        """tau_rayleigh = k * (col_h2o + col_dry): verify the moist-column
        scaling against a direct computation at one point."""
        _, kd_sw, atmos = setup
        play, plev, tlay, tlev, tsfc, gc = atmos
        from rte_rrtmgp_nn_tpu.gasoptics.nn_gas_optics import get_col_dry

        col_dry = get_col_dry(gc.get_vmr("h2o", 3, 10), plev)
        col_gas = compute_col_gas(kd_sw, gc, col_dry)
        ic = interpolation(kd_sw, play, tlay, col_gas)
        tau_r = np.asarray(compute_tau_rayleigh(kd_sw, ic, col_gas, col_dry))
        # synthetic krayl is eta/temp-uniform per band: expected value is
        # exactly sigma_band * moist column
        krayl = np.asarray(kd_sw.krayl)
        idx_h2o = 1 + kd_sw.gas_names.index("h2o")
        moist = np.asarray(col_gas[..., idx_h2o] + col_dry)
        for ib, (s, e) in enumerate(kd_sw.spectral.band_lims_gpt):
            sigma = krayl[0, 0, 0, s]
            itropo = np.where(np.asarray(ic.tropo), 0, 1)
            sig = krayl[itropo, 0, 0, s]  # upper/lower differ by 1%
            np.testing.assert_allclose(
                tau_r[..., s], sig * moist, rtol=1e-6
            )
