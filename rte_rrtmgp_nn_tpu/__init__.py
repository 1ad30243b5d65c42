"""rte_rrtmgp_nn_tpu: a JAX/XLA radiative-transfer framework with the
capabilities of RTE+RRTMGP-NN, run on NVIDIA GPUs.

Layers (bottom-up), mirroring the reference's structure (SURVEY.md section 1):
  config/constants      runtime flags, physical constants
  spectral/optical_props/gas_concs/sources/fluxes   core data model
  ops/                  compute kernels: LW/SW solvers, adding, scans,
                        gas-optics kernels
  gasoptics/            k-distribution LUT gas optics + NN gas optics
  models/               NN model format (reference-compatible netCDF)
  extensions/           cloud optics, McICA sampling, heating rates, BCs
  parallel/             mesh/sharding for multi-chip column parallelism
  drivers/              RFMIP clear-sky and all-sky end-to-end drivers
  training/             NN training with radiation-in-the-loop evaluation
"""

from .config import config, config_override, set_checks
from .constants import constants
from .fluxes import (
    FluxesBroadband,
    FluxesByband,
    FluxesBygpoint,
    reduce_broadband,
    reduce_byband,
)
from .gas_concs import GasConcs, get_ref_vmr
from .optical_props import (
    OpticalProps1scl,
    OpticalProps2str,
    OpticalPropsNstr,
    delta_scale,
    increment,
    subset,
    validate,
    zeros_1scl,
    zeros_2str,
    zeros_nstr,
)
from .rte import rte_lw, rte_sw
from .sources import SourceFuncLW, SourceFuncSW
from .spectral import SpectralMapping

# gas optics
from .gasoptics.kdist import KDist, load_kdist
from .gasoptics.lut_gas_optics import (
    compute_optimal_angles,
    gas_optics_lw_lut,
    gas_optics_sw_lut,
)
from .gasoptics.nn_gas_optics import (
    gas_optics_lw_nn,
    gas_optics_sw_nn,
    get_col_dry,
    interp_tlev,
)
from .gasoptics.planck import (
    PlanckTable,
    lw_spectral_g128,
    lw_spectral_g256,
    sw_spectral_g112,
    sw_spectral_g224,
)

# NN models
from .models.network import NNModel, load_model_netcdf, save_model_netcdf

# extensions
from .extensions.cloud_optics import CloudOptics, cloud_optics, load_cloud_optics
from .extensions.cloud_sampling import (
    draw_samples_to,
    sampled_mask_exp_ran,
    sampled_mask_max_ran,
)
from .extensions.compute_bc import compute_bc
from .extensions.heating_rates import compute_heating_rate, compute_heating_rate_kday
from .extensions.solar_variability import SolarVar

__version__ = "0.1.0"
