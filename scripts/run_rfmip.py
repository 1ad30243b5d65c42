#!/usr/bin/env python
"""Run the RFMIP clear-sky LW + SW examples and write RFMIP-layout flux
files.

The in-process equivalent of the reference's run-rfmip-examples.py
(examples/rfmip-clear-sky/run-rfmip-examples.py), which shells out to the
rrtmgp_rfmip_lw/sw Fortran executables with a block size; here the
drivers are jitted functions and blocking is optional column streaming.

Outputs r{l,s}{u,d}_<tag>.nc in --output-dir with (expt, site, level)
layout, directly comparable with the published RFMIP result files via
rte_rrtmgp_nn_tpu.drivers.flux_output.compare_flux_files.

Usage:
    python scripts/run_rfmip.py [--input FILE] [--models-dir DIR]
        [--output-dir DIR] [--what lw,sw]
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

REF = "/root/reference"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--input", default=os.path.join(
        REF, "examples/rfmip-clear-sky",
        "multiple_input4MIPs_radiation_RFMIP_UColorado-RFMIP-1-2_none.nc"))
    ap.add_argument("--models-dir", default=os.path.join(REF, "neural/data"))
    ap.add_argument("--output-dir", default=".")
    ap.add_argument("--what", default="lw,sw", help="comma list: lw, sw")
    ap.add_argument("--tag", default="Efx_RTE-RRTMGP-NN-JAX-181204_rad-irf_r1i1p1f1_gn",
                    help="output filename tag (RFMIP convention)")
    ap.add_argument("--n-gauss-angles", type=int, default=1)
    args = ap.parse_args()

    import numpy as np

    from rte_rrtmgp_nn_tpu.drivers.flux_output import write_fluxes_rfmip
    from rte_rrtmgp_nn_tpu.drivers.rfmip import rfmip_clear_sky_lw, rfmip_clear_sky_sw
    from rte_rrtmgp_nn_tpu.drivers.rfmip_io import read_rfmip
    from rte_rrtmgp_nn_tpu.models.network import load_model_netcdf

    what = [w.strip() for w in args.what.split(",") if w.strip()]
    unknown = set(what) - {"lw", "sw"}
    if unknown or not what:
        ap.error(f"--what must be a comma list of lw, sw (got {args.what!r})")

    data = read_rfmip(args.input)
    os.makedirs(args.output_dir, exist_ok=True)

    if "lw" in what:
        models = [load_model_netcdf(os.path.join(args.models_dir, "lw-g128-210809_both_BEST.nc"))]
        t0 = time.perf_counter()
        fb = rfmip_clear_sky_lw(data, models, n_gauss_angles=args.n_gauss_angles)
        up, dn = np.asarray(fb.flux_up), np.asarray(fb.flux_dn)
        dt = time.perf_counter() - t0
        print(f"LW: {data.ncol} columns in {dt:.2f}s "
              f"({data.ncol/dt:,.0f} cols/s incl. compile)")
        print(f"    mean flux up  : {up.mean():10.4f} W/m2")
        print(f"    mean flux down: {dn.mean():10.4f} W/m2")
        for name, arr in (("rlu", up), ("rld", dn)):
            path = os.path.join(args.output_dir, f"{name}_{args.tag}.nc")
            write_fluxes_rfmip(path, {name: arr}, data.plev, data.nexp, data.nsites)
            print(f"    wrote {path}")

    if "sw" in what:
        models = [
            load_model_netcdf(os.path.join(args.models_dir, "sw-g112-210809_absorption_BEST.nc")),
            load_model_netcdf(os.path.join(args.models_dir, "sw-g112-210809_rayleigh_BEST.nc")),
        ]
        t0 = time.perf_counter()
        fb = rfmip_clear_sky_sw(data, models)
        up, dn = np.asarray(fb.flux_up), np.asarray(fb.flux_dn)
        dt = time.perf_counter() - t0
        print(f"SW: {data.ncol} columns in {dt:.2f}s "
              f"({data.ncol/dt:,.0f} cols/s incl. compile)")
        print(f"    mean flux up  : {up.mean():10.4f} W/m2")
        print(f"    mean flux down: {dn.mean():10.4f} W/m2")
        for name, arr in (("rsu", up), ("rsd", dn)):
            path = os.path.join(args.output_dir, f"{name}_{args.tag}.nc")
            write_fluxes_rfmip(path, {name: arr}, data.plev, data.nexp, data.nsites)
            print(f"    wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
