"""Native host-runtime library tests (C++ classic-netCDF reader, feature
packing, col_dry). Skipped when the shared library cannot be built."""
import numpy as np
import pytest

from rte_rrtmgp_nn_tpu.utils import ncio
from rte_rrtmgp_nn_tpu.utils.native import (
    KIND_LOG_P,
    KIND_QUARTER_ROOT,
    KIND_RAW_T,
    KIND_RAW_VMR,
    available,
    col_dry_native,
    pack_features_native,
)

pytestmark = pytest.mark.skipif(not available(), reason="native lib not built")



@pytest.fixture
def cloud_lut_nc(tmp_path):
    """The seeded LW cloud-optics LUT written as a netCDF-3 classic file
    with the reference coefficient file's variable names and shapes."""
    from rte_rrtmgp_nn_tpu.drivers.seeded_inputs import make_cloud_optics

    co = make_cloud_optics(seed=0, kind="lw")
    f64 = lambda a: np.asarray(a, np.float64)
    path = str(tmp_path / "cloud-optics-coeffs-lw.nc")
    dims = {"nband": co.nband, "nsize_liq": co.lut_extliq.shape[1],
            "nsize_ice": co.lut_extice.shape[2],
            "nrghice": co.lut_extice.shape[0], "pair": 2}
    variables = {
        "bnd_limits_wavenumber": (("nband", "pair"),
                                  co.spectral.band_lims_wvn_array),
        "radliq_lwr": ((), np.float64(co.radliq_lwr)),
        "lut_extliq": (("nband", "nsize_liq"), f64(co.lut_extliq)),
        "lut_extice": (("nrghice", "nband", "nsize_ice"), f64(co.lut_extice)),
    }
    ncio.write_nc(path, dims, variables)
    return path


class TestNativeNC:
    def test_reader_matches_scipy(self, cloud_lut_nc):
        from rte_rrtmgp_nn_tpu.utils.native import NativeNCFile

        with NativeNCFile(cloud_lut_nc) as nf, ncio.NCFile(cloud_lut_nc) as pf:
            for var in ("lut_extliq", "lut_extice", "radliq_lwr", "bnd_limits_wavenumber"):
                a = nf.read(var)
                b = np.asarray(pf.read(var), np.float64)
                assert a.shape == b.shape
                np.testing.assert_allclose(a, b, rtol=1e-7)
            assert nf.dim_size("nband") == 16
            with pytest.raises(KeyError):
                nf.read("not_a_var")

    def test_reads_synthetic_kdist(self, tmp_path):
        """Our own netCDF-3 writer output parses with the C++ reader."""
        from rte_rrtmgp_nn_tpu.gasoptics.synthetic import generate_kdist_nc
        from rte_rrtmgp_nn_tpu.utils.native import NativeNCFile

        p = str(tmp_path / "syn.nc")
        generate_kdist_nc(p, kind="lw", gpts_per_band=4, nband=4)
        with NativeNCFile(p) as nf, ncio.NCFile(p) as pf:
            np.testing.assert_allclose(
                nf.read("kmajor"), np.asarray(pf.read("kmajor"), np.float64), rtol=1e-7
            )


class TestNativeCompute:
    def test_pack_features_matches_numpy(self):
        r = np.random.default_rng(0)
        n = 10000
        play = r.uniform(100, 1e5, n)
        tlay = r.uniform(180, 320, n)
        h2o = r.uniform(1e-8, 4e-2, n)
        co2 = np.full(n, 4e-4)
        fmin = np.array([160, 5.15e-3, 1.01e-2, 0], np.float32)
        fmax = np.array([340, 11.6, 0.508, 1e-3], np.float32)
        out = pack_features_native(
            [tlay, play, h2o, co2],
            [KIND_RAW_T, KIND_LOG_P, KIND_QUARTER_ROOT, KIND_RAW_VMR],
            fmin, fmax,
        )
        ref = np.stack([tlay, np.log(play), np.sqrt(np.sqrt(h2o)), co2], -1)
        ref = ((ref - fmin) / (fmax - fmin)).astype(np.float32)
        np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-6)

    def test_col_dry_matches_reference_formula(self):
        r = np.random.default_rng(1)
        q = r.uniform(1e-8, 3e-2, (50, 12))
        pv = np.sort(r.uniform(100, 1e5, (50, 13)), axis=1)
        cd = col_dry_native(q, pv)
        dp = np.abs(pv[:, :-1] - pv[:, 1:])
        fact = 1.0 / (1.0 + q)
        m_air = (0.028964 + 0.018016 * q) * fact
        ref = 10.0 * dp * 6.02214076e23 * fact / (1000.0 * m_air * 100.0 * 9.80665)
        np.testing.assert_allclose(cd, ref, rtol=1e-12)
