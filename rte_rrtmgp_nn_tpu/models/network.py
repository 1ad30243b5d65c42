"""Neural-network gas-optics models: the reference-compatible model format
and batched inference.

Reference parity:
  - model netCDF format: dims ``nn_layers``/``nn_dim_input``, vars
    ``nn_dimsize``, ``nn_weights_i``, ``nn_bias_i``, ``nn_activation_char``,
    ``nn_inputs_char``, ``nn_input_coeffs_min/max``,
    ``nn_output_coeffs_mean/std`` -- written by
    ``ml_load_save_preproc.py:21-171``, read by
    ``mod_network_rrtmgp.F90:58-122``. The shipped ``neural/data/*.nc``
    models load unchanged.
  - activations: ``neural/mod_activation.F90`` (gaussian, relu, sigmoid,
    hard_sigmoid, softsign, tanh, linear).
  - inference: ``mod_network.F90 output_sgemm_flat`` (a GEMM + fused
    bias/activation per layer); here one jnp dot chain that XLA compiles,
    at ``config.MATMUL_PRECISION``.

Weight convention: numpy arrays read from the file have shape
(n_in, n_out) (C-order view of the Fortran (n_out, n_in)); inference is
``y = x @ W + b`` with x (nbatch, n_in).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..config import MATMUL_PRECISION
from ..utils import ncio

_ACTIVATIONS: dict[str, Callable] = {
    "linear": lambda x: x,
    "relu": lambda x: jnp.maximum(x, 0.0),
    "sigmoid": lambda x: 1.0 / (1.0 + jnp.exp(-x)),
    "hard_sigmoid": lambda x: jnp.clip(0.2 * x + 0.5, 0.0, 1.0),
    "softsign": lambda x: x / (jnp.abs(x) + 1.0),
    "tanh": jnp.tanh,
    "gaussian": lambda x: jnp.exp(-(x * x)),
}


@dataclasses.dataclass(frozen=True)
class NNModel:
    """An MLP with input min-max scaling and optional output standardization
    coefficients (reference rrtmgp_network_type)."""

    weights: tuple  # of (n_in, n_out) arrays
    biases: tuple  # of (n_out,) arrays
    activations: tuple  # of str, one per layer (last is the output layer)
    input_names: tuple  # of str
    input_min: jnp.ndarray  # (n_inputs,)
    input_max: jnp.ndarray  # (n_inputs,)
    output_mean: jnp.ndarray | None = None  # (n_out,)
    output_std: jnp.ndarray | None = None  # (n_out,)

    @property
    def n_inputs(self) -> int:
        return self.weights[0].shape[0]

    @property
    def n_outputs(self) -> int:
        return self.weights[-1].shape[1]

    @property
    def n_layers(self) -> int:
        return len(self.weights)

    @property
    def dims(self) -> list[int]:
        return [self.n_inputs] + [w.shape[1] for w in self.weights]

    def apply_raw(self, x: jnp.ndarray) -> jnp.ndarray:
        """Raw network output (final linear layer + bias, NO output
        activation -- matching output_sgemm_lw/_tau which apply
        postprocessing instead). x: (..., n_inputs) already scaled."""
        h = x
        for w, b, act in zip(self.weights[:-1], self.biases[:-1], self.activations[:-1]):
            h = _ACTIVATIONS[act](jnp.dot(h, w, precision=MATMUL_PRECISION) + b)
        return (jnp.dot(h, self.weights[-1], precision=MATMUL_PRECISION)
                + self.biases[-1])

    def apply_with_final_activation(self, x: jnp.ndarray) -> jnp.ndarray:
        """Network output including the configured final activation
        (matching output_sgemm_flat / the pfrac kernel's final
        bias_and_activation)."""
        raw = self.apply_raw(x)
        return _ACTIVATIONS[self.activations[-1]](raw)


jax.tree_util.register_dataclass(
    NNModel,
    data_fields=["weights", "biases", "input_min", "input_max", "output_mean", "output_std"],
    meta_fields=["activations", "input_names"],
)


def load_model_netcdf(path: str, dtype=jnp.float32) -> NNModel:
    """Load a model in the reference netCDF format
    (mod_network_rrtmgp.F90:58-122). Works for the shipped
    ``neural/data/*.nc`` files."""
    with ncio.NCFile(path) as f:
        num_layers = f.dim_size("nn_layers")
        nx = f.dim_size("nn_dim_input")
        dimsize = f.read("nn_dimsize").astype(int)
        weights, biases = [], []
        d_in = nx
        for n in range(1, num_layers + 1):
            w = f.read(f"nn_weights_{n}", dtype=np.float32)
            b = f.read(f"nn_bias_{n}", dtype=np.float32)
            # stored C-order shape (n_in, n_out)
            if w.shape != (d_in, int(dimsize[n - 1])):
                w = w.reshape(d_in, int(dimsize[n - 1]))
            weights.append(jnp.asarray(w, dtype))
            biases.append(jnp.asarray(b, dtype))
            d_in = int(dimsize[n - 1])
        try:
            acts = tuple(a.lower() for a in f.read_strings("nn_activation_char"))
        except KeyError:
            acts = tuple(a.lower() for a in f.read_strings("nn_activation"))
        names = tuple(s.lower() for s in f.read_strings("nn_inputs_char"))
        in_min = jnp.asarray(f.read("nn_input_coeffs_min", np.float32), dtype)
        in_max = jnp.asarray(f.read("nn_input_coeffs_max", np.float32), dtype)
        out_mean = out_std = None
        if f.has_var("nn_output_coeffs_mean"):
            out_mean = jnp.asarray(f.read("nn_output_coeffs_mean", np.float32), dtype)
        if f.has_var("nn_output_coeffs_std"):
            out_std = jnp.asarray(f.read("nn_output_coeffs_std", np.float32), dtype)
    return NNModel(
        weights=tuple(weights),
        biases=tuple(biases),
        activations=acts,
        input_names=names,
        input_min=in_min,
        input_max=in_max,
        output_mean=out_mean,
        output_std=out_std,
    )


def save_model_netcdf(path: str, model: NNModel, string_len: int = 32,
                      attrs=None) -> None:
    """Write the reference model format (ml_load_save_preproc.py:21-171),
    as netCDF-3 classic so any netCDF reader (including the reference's
    Fortran loader) can open it.

    attrs: optional mapping written as GLOBAL attributes (ignored by every
    loader, incl. the reference Fortran one). The training loops record the
    full 8-metric radiation-eval vector + final score here so the artifact
    carries its own provenance (filenames alone proved ambiguous)."""
    nlayers = model.n_layers
    dims: dict[str, int] = {
        "nn_layers": nlayers,
        "nn_dim_input": model.n_inputs,
        "string_len": string_len,
    }
    variables: dict[str, tuple[Sequence[str], np.ndarray]] = {
        "nn_dimsize": (("nn_layers",), np.asarray(model.dims[1:], np.int32)),
        "nn_activation_char": (
            ("nn_layers", "string_len"),
            ncio.strings_to_chararray(list(model.activations), string_len),
        ),
        "nn_inputs_char": (
            ("nn_dim_input", "string_len"),
            ncio.strings_to_chararray(list(model.input_names), string_len),
        ),
        "nn_input_coeffs_min": (("nn_dim_input",), np.asarray(model.input_min, np.float32)),
        "nn_input_coeffs_max": (("nn_dim_input",), np.asarray(model.input_max, np.float32)),
    }
    dim_names = ["nn_dim_input"]
    for i, size in enumerate(model.dims[1:-1], start=1):
        dn = f"nn_dim_hidden{i}"
        dims[dn] = size
        dim_names.append(dn)
    dims["nn_dim_outp"] = model.n_outputs
    dim_names.append("nn_dim_outp")
    for n in range(1, nlayers + 1):
        variables[f"nn_weights_{n}"] = (
            (dim_names[n - 1], dim_names[n]),
            np.asarray(model.weights[n - 1], np.float32),
        )
        variables[f"nn_bias_{n}"] = ((dim_names[n],), np.asarray(model.biases[n - 1], np.float32))
    if model.output_mean is not None:
        variables["nn_output_coeffs_mean"] = (
            ("nn_dim_outp",),
            np.asarray(model.output_mean, np.float32),
        )
    if model.output_std is not None:
        variables["nn_output_coeffs_std"] = (
            ("nn_dim_outp",),
            np.asarray(model.output_std, np.float32),
        )
    ncio.write_nc(path, dims, variables, attrs=attrs)
