"""General-purpose object-oriented netCDF access.

Analogue of the reference's ``easy_netcdf.F90``
(``examples/rrtmgp-nn-training/easy_netcdf.F90:55-117`` type
definition): one class that opens/creates files, defines dimensions
and variables with units/long-name attributes, reads and writes scalars
through 4-D arrays (optionally indexed along the slowest dimension),
handles variable and global attributes, optional write-time transposes /
permutations, single/double output precision, and copying dimensions /
variable definitions / variables between files.

Reading supports both on-disk netCDF formats (HDF5-backed netCDF-4 and
classic netCDF-3) by delegating to :class:`~.ncio.NCFile`; writing
produces classic netCDF-3 via scipy, readable by every netCDF tool
including the reference's Fortran loaders.

Conventions:
  - Arrays are stored/returned in C (row-major) order exactly as netCDF
    stores them, i.e. the FIRST numpy axis is the netCDF outermost
    (slowest-varying, Fortran-last) dimension.
  - ``index=`` arguments select along that outermost axis, mirroring the
    reference's ``get_real_*_indexed`` / ``put_real_*_indexed``
    (easy_netcdf.F90:828-905, 1815-1905).
  - Permutations are 0-based numpy axis tuples (the reference's
    1-based Fortran ``ipermute``, easy_netcdf.F90:370-395).
"""
from __future__ import annotations

import os
import sys
import time
from typing import Any, Mapping, Sequence

import numpy as np

from .ncio import NCFile

__all__ = ["EasyNC"]


def _decode(value: Any) -> Any:
    if isinstance(value, bytes):
        return value.decode("utf-8", "ignore")
    if isinstance(value, np.bytes_):
        return bytes(value).decode("utf-8", "ignore")
    return value


class EasyNC:
    """Open (``mode='r'``), create (``'w'``) or append to (``'a'``) a
    netCDF file with a high-level get/put interface.

    Mirrors the procedure surface of the reference's ``netcdf_file`` type
    (easy_netcdf.F90:58-117). Write modes produce netCDF-3 classic.
    """

    def __init__(self, path: str, mode: str = "r", verbose: int = 0):
        if mode not in ("r", "w", "a"):
            raise ValueError(f"mode must be 'r', 'w' or 'a', got {mode!r}")
        self.path = path
        self.mode = mode
        self.verbose = verbose
        self._double = False          # double_precision(), F90:343-353
        self._transpose_2d = False    # transpose_matrices(), F90:358-368
        self._permute: dict[int, tuple[int, ...]] = {}  # permute_*_arrays()
        self._r: NCFile | None = None
        self._w = None
        if mode == "r":
            self._r = NCFile(path)
        else:
            from scipy.io import netcdf_file

            if mode == "w":
                d = os.path.dirname(os.path.abspath(path))
                os.makedirs(d, exist_ok=True)
            self._w = netcdf_file(path, mode, mmap=False)

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        if self._r is not None:
            self._r.close()
            self._r = None
        if self._w is not None:
            self._w.close()
            self._w = None

    def is_open(self) -> bool:
        return self._r is not None or self._w is not None

    def __enter__(self) -> "EasyNC":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- configuration toggles (easy_netcdf.F90:328-395) ----------------------
    def set_verbose(self, level: int = 2) -> None:
        self.verbose = level

    def double_precision(self, is_double: bool = True) -> None:
        """Write floating-point data as float64 instead of float32."""
        self._double = is_double

    def transpose_matrices(self, do_transpose: bool = True) -> None:
        """Transpose 2-D arrays on put and get."""
        self._transpose_2d = do_transpose

    def permute_3d_arrays(self, perm: Sequence[int]) -> None:
        """Permute 3-D arrays on write with the 0-based axis order ``perm``."""
        self._permute[3] = tuple(perm)

    def permute_4d_arrays(self, perm: Sequence[int]) -> None:
        self._permute[4] = tuple(perm)

    # -- introspection (easy_netcdf.F90:497-660) ------------------------------
    def _vars(self):
        if self._w is not None:
            return self._w.variables
        return {n: None for n in self._r.variables()}

    def exists(self, name: str) -> bool:
        return name in self._vars()

    def get_rank(self, name: str) -> int:
        """Number of dimensions of ``name``, or -1 if absent (F90:497-530)."""
        if not self.exists(name):
            return -1
        if self._w is not None:
            return len(self._w.variables[name].shape)
        return len(self._r.var_dims(name))

    def _var_shape(self, name: str) -> tuple:
        if self._w is not None:
            return tuple(self._w.variables[name].shape)
        if self._r._h5 is not None:
            return tuple(self._r._h5[name].shape)
        return tuple(self._r._nc3.variables[name].shape)

    def _var_dtype(self, name: str):
        if self._w is not None:
            d = self._w.variables[name].data.dtype
        elif self._r._h5 is not None:
            d = self._r._h5[name].dtype
        else:
            d = self._r._nc3.variables[name].data.dtype
        return np.dtype(d).newbyteorder("=")

    def get_outer_dimension(self, name: str) -> int:
        """Length of the slowest-varying dimension, or -1 if absent
        (F90:535-560). Metadata-only: never loads the variable's data."""
        if not self.exists(name):
            return -1
        shape = self._var_shape(name)
        return int(shape[0]) if shape else 1

    def dim_size(self, name: str) -> int:
        if self._w is not None:
            n = self._w.dimensions.get(name)
            if n is None:
                raise KeyError(f"{self.path}: no dimension {name!r}")
            return int(n)
        return self._r.dim_size(name)

    # -- attributes (easy_netcdf.F90:586-660, 906-1010, 1922-2058) ------------
    def attribute_exists(self, var_name: str, attr_name: str) -> bool:
        try:
            self.get_attribute(var_name, attr_name)
            return True
        except KeyError:
            return False

    def global_attribute_exists(self, attr_name: str) -> bool:
        try:
            self.get_global_attribute(attr_name)
            return True
        except KeyError:
            return False

    def get_attribute(self, var_name: str, attr_name: str) -> Any:
        """Variable attribute value (strings decoded)."""
        if self._w is not None:
            attrs = self._w.variables[var_name]._attributes
            if attr_name not in attrs:
                raise KeyError(f"{var_name}: no attribute {attr_name!r}")
            return _decode(attrs[attr_name])
        if self._r._h5 is not None:
            attrs = self._r._h5[var_name].attrs
            if attr_name not in attrs:
                raise KeyError(f"{var_name}: no attribute {attr_name!r}")
            return _decode(attrs[attr_name])
        attrs = self._r._nc3.variables[var_name]._attributes
        if attr_name not in attrs:
            raise KeyError(f"{var_name}: no attribute {attr_name!r}")
        return _decode(attrs[attr_name])

    def get_global_attribute(self, attr_name: str) -> Any:
        if self._w is not None:
            attrs = self._w._attributes
        elif self._r._h5 is not None:
            attrs = self._r._h5.attrs
        else:
            attrs = self._r._nc3._attributes
        if attr_name not in attrs:
            raise KeyError(f"{self.path}: no global attribute {attr_name!r}")
        return _decode(attrs[attr_name])

    def put_attribute(self, var_name: str, attr_name: str, value: Any) -> None:
        self._require_write()
        setattr(self._w.variables[var_name], attr_name, value)

    def put_global_attribute(self, attr_name: str, value: Any) -> None:
        self._require_write()
        setattr(self._w, attr_name, value)

    def put_global_attributes(
        self,
        title: str | None = None,
        institution: str | None = None,
        input_data: str | None = None,
        creator_name: str | None = None,
        creator_email: str | None = None,
        contributor_name: str | None = None,
        project: str | None = None,
        comment: str | None = None,
        conventions: str | None = None,
        references: str | None = None,
        prior_history: str | None = None,
    ) -> None:
        """Standard global-attribute set + a timestamped command-line history
        entry (easy_netcdf.F90:2009-2058)."""
        self._require_write()
        stamp = time.strftime("%Y-%m-%d %H:%M:%S")
        entry = f"{stamp}: {' '.join(sys.argv)}"
        history = f"{prior_history}\n{entry}" if prior_history else entry
        named = {
            "title": title,
            "institution": institution,
            "input_data": input_data,
            "creator_name": creator_name,
            "creator_email": creator_email,
            "contributor_name": contributor_name,
            "project": project,
            "comment": comment,
            "conventions": conventions,
            "references": references,
        }
        for k, v in named.items():
            if v is not None:
                setattr(self._w, k, v)
        self._w.history = history

    # -- reading (easy_netcdf.F90:665-905) -------------------------------------
    def get(self, name: str, index: int | None = None, dtype=None) -> Any:
        """Read a variable. 0-D returns a python scalar. ``index`` selects
        one slab along the outermost (slowest) axis, like the reference's
        ``get_real_*_indexed`` routines."""
        if self._w is not None:
            arr = np.array(self._w.variables[name][...])
        else:
            arr = self._r.read(name)
        if dtype is not None:
            arr = arr.astype(dtype)
        elif arr.dtype.byteorder == ">":  # classic netCDF is big-endian on disk
            arr = arr.astype(arr.dtype.newbyteorder("="))
        if index is not None:
            arr = arr[index]
        if self._transpose_2d and arr.ndim == 2:
            arr = arr.T
        if arr.ndim == 0:
            return arr.item()
        return arr

    def get_strings(self, name: str) -> list[str]:
        if self._r is not None:
            return self._r.read_strings(name)
        raise NotImplementedError("get_strings is read-mode only")

    # -- definition + writing (easy_netcdf.F90:1034-1905) ----------------------
    def define_dimension(self, name: str, size: int | None = None) -> None:
        """``size=None`` creates the unlimited (record) dimension."""
        self._require_write()
        if name not in self._w.dimensions:
            self._w.createDimension(name, None if size is None else int(size))

    def define_variable(
        self,
        name: str,
        dims: Sequence[str] = (),
        dtype: Any = None,
        units: str | None = None,
        long_name: str | None = None,
        standard_name: str | None = None,
        fill_value: float | None = None,
    ) -> None:
        """Define ``name`` over already-defined ``dims`` with optional CF
        attributes (easy_netcdf.F90 define_variable)."""
        self._require_write()
        if name in self._w.variables:
            return
        dtype = np.dtype(dtype if dtype is not None else
                         (np.float64 if self._double else np.float32))
        if dtype == np.int64:  # classic netCDF-3 has no 64-bit int
            dtype = np.dtype(np.int32)
        var = self._w.createVariable(name, dtype, tuple(dims))
        if units is not None:
            var.units = units
        if long_name is not None:
            var.long_name = long_name
        if standard_name is not None:
            var.standard_name = standard_name
        if fill_value is not None:
            var._FillValue = np.asarray(fill_value, dtype)

    def put(
        self,
        name: str,
        data: Any,
        dims: Sequence[str] | None = None,
        units: str | None = None,
        long_name: str | None = None,
        index: int | None = None,
    ) -> None:
        """Write a scalar/array. If the variable is undefined, ``dims``
        names its dimensions (auto-defined from the data shape when new).
        ``index`` writes one slab along the outermost axis. Write-time
        transpose/permute toggles apply (easy_netcdf.F90:1292-1471)."""
        self._require_write()
        arr = np.asarray(data)
        if self._transpose_2d and arr.ndim == 2:
            arr = arr.T
        perm = self._permute.get(arr.ndim)
        if perm is not None:
            arr = np.transpose(arr, perm)
        existing = self._w.variables.get(name)
        if existing is not None:
            # an already-defined variable's dtype wins (never silently
            # truncate a float64 variable through the _double toggle)
            arr = arr.astype(existing.data.dtype.newbyteorder("="))
        elif arr.dtype.kind == "f":
            arr = arr.astype(np.float64 if self._double else np.float32)
        elif arr.dtype == np.int64:
            arr = arr.astype(np.int32)
        if name not in self._w.variables:
            if dims is None:
                if arr.ndim:
                    raise ValueError(
                        f"{name}: undefined variable needs dims= to be created")
                dims = ()
            full_shape = arr.shape if index is None else (None,) + arr.shape
            for d, n in zip(dims, full_shape):
                if d not in self._w.dimensions:
                    self.define_dimension(d, n)
            self.define_variable(name, dims, dtype=arr.dtype,
                                 units=units, long_name=long_name)
        var = self._w.variables[name]
        if index is not None:
            var[index] = arr
        elif arr.ndim == 0:
            var.data[()] = arr.item()
        else:
            var[...] = arr

    # -- copying between files (easy_netcdf.F90 copy_* :110-113) ---------------
    def copy_dimensions(self, src: "EasyNC") -> None:
        """Copy every dimension of ``src`` into this (write-mode) file."""
        self._require_write()
        if src._r is None or src._r._nc3 is None:
            raise NotImplementedError("copy_dimensions needs a classic-format source")
        for dname, dsize in src._r._nc3.dimensions.items():
            self.define_dimension(dname, dsize)

    def copy_variable_definition(self, src: "EasyNC", name: str) -> None:
        """Copy a variable's dims + dtype + attributes (no data read)."""
        self._require_write()
        dims = src._r.var_dims(name) if src._r is not None else src._w.variables[name].dimensions
        for d, n in zip(dims, src._var_shape(name)):
            self.define_dimension(d, n)
        self.define_variable(name, dims, dtype=src._var_dtype(name))
        for attr in ("units", "long_name", "standard_name"):
            if src.attribute_exists(name, attr):
                self.put_attribute(name, attr, src.get_attribute(name, attr))

    def copy_variable(self, src: "EasyNC", name: str) -> None:
        """Copy definition, attributes, and data of one variable."""
        self.copy_variable_definition(src, name)
        self.put(name, src.get(name))

    # -- internals --------------------------------------------------------------
    def _require_write(self) -> None:
        if self._w is None:
            raise IOError(f"{self.path} is open read-only")


def write_dict(path: str, variables: Mapping[str, Any], **global_attrs) -> None:
    """One-shot writer: each variable gets auto-named dimensions."""
    with EasyNC(path, "w") as f:
        for name, data in variables.items():
            arr = np.asarray(data)
            dims = tuple(f"{name}_dim{i}" for i in range(arr.ndim))
            f.put(name, arr, dims=dims)
        for k, v in global_attrs.items():
            f.put_global_attribute(k, v)
