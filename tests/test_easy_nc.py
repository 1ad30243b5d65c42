"""General OO netCDF access (utils/easy_nc.py) vs the reference's
easy_netcdf.F90 capability surface: define/put/get with attributes,
indexed slabs, transpose/permute toggles, precision control, append
mode, and file-to-file copying."""
import numpy as np
import pytest

from rte_rrtmgp_nn_tpu.utils.easy_nc import EasyNC, write_dict
from rte_rrtmgp_nn_tpu.utils.ncio import NCFile

@pytest.fixture
def rng():
    return np.random.default_rng(7)


def _roundtrip_file(tmp_path, rng):
    path = str(tmp_path / "rt.nc")
    with EasyNC(path, "w") as f:
        f.define_dimension("col", 5)
        f.define_dimension("lay", 3)
        f.define_variable("temp", ("col", "lay"), units="K",
                          long_name="temperature", fill_value=-999.0)
        f.put("temp", np.arange(15, dtype=np.float64).reshape(5, 3))
        f.put("p0", 1013.25)
        f.put("levels", np.array([1.0, 2.0, 3.0]), dims=("lay",), units="Pa")
        f.put("counts", np.arange(5, dtype=np.int64), dims=("col",))
        f.put_attribute("temp", "comment", "made up")
        f.put_global_attributes(title="roundtrip", institution="rte-framework",
                                conventions="CF-1.7")
    return path


class TestWriteRead:
    def test_roundtrip_values_and_attrs(self, tmp_path, rng):
        path = _roundtrip_file(tmp_path, rng)
        with EasyNC(path) as f:
            assert f.exists("temp") and not f.exists("nope")
            assert f.get_rank("temp") == 2 and f.get_rank("nope") == -1
            assert f.get_outer_dimension("temp") == 5
            assert f.dim_size("lay") == 3
            np.testing.assert_allclose(
                f.get("temp"), np.arange(15).reshape(5, 3))
            assert f.get("p0") == pytest.approx(1013.25)
            assert f.get("counts").dtype.kind == "i"  # int64 narrowed, kept integral
            assert f.get_attribute("temp", "units") == "K"
            assert f.get_attribute("temp", "long_name") == "temperature"
            assert f.get_attribute("temp", "comment") == "made up"
            assert f.attribute_exists("temp", "units")
            assert not f.attribute_exists("temp", "absent")
            assert f.get_global_attribute("title") == "roundtrip"
            assert f.global_attribute_exists("conventions")
            # put_global_attributes always stamps a command-line history
            assert ":" in f.get_global_attribute("history")

    def test_readable_by_plain_ncfile(self, tmp_path, rng):
        path = _roundtrip_file(tmp_path, rng)
        with NCFile(path) as f:
            assert f.var_dims("temp") == ("col", "lay")
            np.testing.assert_allclose(f.read("levels"), [1, 2, 3])

    def test_indexed_get_and_put(self, tmp_path, rng):
        path = str(tmp_path / "idx.nc")
        data = rng.standard_normal((4, 6)).astype(np.float32)
        with EasyNC(path, "w") as f:
            f.define_dimension("rec", 4)
            f.define_dimension("x", 6)
            f.define_variable("v", ("rec", "x"), dtype=np.float32)
            for i in range(4):  # slab writes along the outermost axis
                f.put("v", data[i], index=i)
        with EasyNC(path) as f:
            np.testing.assert_array_equal(f.get("v", index=2), data[2])
            np.testing.assert_array_equal(f.get("v"), data)

    def test_transpose_and_permute_toggles(self, tmp_path, rng):
        path = str(tmp_path / "perm.nc")
        mat = rng.standard_normal((3, 5)).astype(np.float32)
        cube = rng.standard_normal((2, 3, 4)).astype(np.float32)
        with EasyNC(path, "w") as f:
            f.transpose_matrices()
            f.permute_3d_arrays((2, 0, 1))
            f.put("m", mat, dims=("a", "b"))
            f.put("c", cube, dims=("p", "q", "r"))
        with EasyNC(path) as f:
            assert f.get("m").shape == (5, 3)  # stored transposed
            f.transpose_matrices()
            np.testing.assert_array_equal(f.get("m"), mat)  # get undoes it
            np.testing.assert_array_equal(
                f.get("c"), np.transpose(cube, (2, 0, 1)))

    def test_double_precision_toggle(self, tmp_path, rng):
        path = str(tmp_path / "dp.nc")
        with EasyNC(path, "w") as f:
            f.double_precision()
            f.put("x", np.linspace(0, 1, 7), dims=("n",))
        with EasyNC(path) as f:
            assert f.get("x").dtype == np.float64

    def test_append_mode(self, tmp_path, rng):
        path = _roundtrip_file(tmp_path, rng)
        with EasyNC(path, "a") as f:
            f.put("extra", np.full(3, 9.0), dims=("lay",))
            f.put_global_attribute("appended", "yes")
        with EasyNC(path) as f:
            np.testing.assert_allclose(f.get("extra"), 9.0)
            np.testing.assert_allclose(f.get("temp"),
                                       np.arange(15).reshape(5, 3))
            assert f.get_global_attribute("appended") == "yes"

    def test_copy_between_files(self, tmp_path, rng):
        src_path = _roundtrip_file(tmp_path, rng)
        dst_path = str(tmp_path / "copy.nc")
        with EasyNC(src_path) as src, EasyNC(dst_path, "w") as dst:
            dst.copy_dimensions(src)
            dst.copy_variable(src, "temp")
            dst.copy_variable_definition(src, "levels")
        with EasyNC(dst_path) as f:
            np.testing.assert_allclose(f.get("temp"),
                                       np.arange(15).reshape(5, 3))
            assert f.get_attribute("temp", "units") == "K"
            assert f.exists("levels") and f.dim_size("col") == 5

    def test_write_dict_oneshot(self, tmp_path, rng):
        path = str(tmp_path / "dict.nc")
        write_dict(path, {"a": rng.standard_normal(4), "b": 3.0},
                   source="unit test")
        with EasyNC(path) as f:
            assert f.get("a").shape == (4,)
            assert f.get("b") == pytest.approx(3.0)
            assert f.get_global_attribute("source") == "unit test"


class TestHDF5Read:
    def test_global_attribute_from_reference_model(self, tmp_path):
        """An HDF5 (netCDF-4) model file laid out like the reference's
        neural/data models: global attributes + nn_weights_1."""
        h5py = pytest.importorskip("h5py")
        path = str(tmp_path / "lw-g128-both.nc")
        with h5py.File(path, "w") as h:
            h.attrs["emulator_target"] = "rrtmgp-data-lw-g128-210809.nc"
            h.attrs["input_scaling_info"] = "min-max"
            h.create_dataset("nn_weights_1",
                             data=np.zeros((128, 18), np.float32))
        with EasyNC(path) as f:
            assert f.get_global_attribute("emulator_target") == (
                "rrtmgp-data-lw-g128-210809.nc")
            assert f.global_attribute_exists("input_scaling_info")
            assert not f.global_attribute_exists("nonexistent_attr")
            assert f.get_rank("nn_weights_1") >= 1
            assert f.get_outer_dimension("nonexistent") == -1


def test_put_respects_defined_variable_dtype(tmp_path):
    """put() must cast to an explicitly-defined variable's dtype, not the
    global precision toggle (a float64 variable must keep full precision
    even when double_precision() was never called)."""
    path = str(tmp_path / "dtype.nc")
    with EasyNC(path, "w") as f:
        f.define_dimension("x", 1)
        f.define_variable("v", ("x",), dtype=np.float64)
        f.put("v", np.array([1.0 + 1e-12]))
    with EasyNC(path) as f:
        got = f.get("v")
        assert got.dtype == np.float64
        assert got[0] != 1.0  # the 1e-12 survived
