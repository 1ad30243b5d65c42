#!/usr/bin/env python
"""Run the clear-sky regression harness and print the verification table.

The in-process equivalent of the reference's regression flow
(tests/clear_sky_regression.F90 driven by tests/verification.py): every
LW and SW solver variant over one atmosphere with the LUT gas-optics
path, cross-checked (vertical-reversal, subset, increment identities,
TSI scaling) and written as named broadband fields.

The reference's real k-distribution files are not shipped; by default a
reference-format synthetic k-distribution (gasoptics/synthetic.py)
exercises the identical code path. Pass --kdist-lw/--kdist-sw to use
real files.

Usage:
    JAX_PLATFORMS=cpu python scripts/run_regression.py [--ncol 8]
        [--output test_atmospheres.nc]
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# regression numerics are platform-independent: the goldens are written
# on the CPU
os.environ["JAX_PLATFORMS"] = "cpu"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ncol", type=int, default=8)
    ap.add_argument("--nlay", type=int, default=20)
    ap.add_argument("--kdist-lw", default=None, help="real LW k-distribution netCDF")
    ap.add_argument("--kdist-sw", default=None, help="real SW k-distribution netCDF")
    ap.add_argument("--output", default="test_atmospheres.nc")
    ap.add_argument("--fail-tol", type=float, default=1e-5)
    args = ap.parse_args()

    import jax.numpy as jnp

    from rte_rrtmgp_nn_tpu.drivers.clear_sky_regression import (
        run_lw_variants,
        run_sw_variants,
        verify_variants,
        write_fields,
    )
    from rte_rrtmgp_nn_tpu.gasoptics.kdist import load_kdist
    from rte_rrtmgp_nn_tpu.gasoptics.synthetic import generate_kdist_nc

    from rte_rrtmgp_nn_tpu.drivers.seeded_inputs import make_atmosphere

    GASES = ["h2o", "co2", "o3", "n2o", "ch4"]  # make_atmosphere's gases

    # each band takes its real file when given, synthetic otherwise -- a
    # single supplied file must be USED, not silently dropped
    d = None
    if args.kdist_lw:
        kd_lw = load_kdist(args.kdist_lw, GASES)
        print(f"LW k-distribution: {args.kdist_lw}")
    else:
        d = d or tempfile.mkdtemp()
        plw = os.path.join(d, "lw.nc")
        generate_kdist_nc(plw, kind="lw", gpts_per_band=4, nband=16)
        kd_lw = load_kdist(plw, GASES)
        print("LW k-distribution: synthetic (gasoptics/synthetic.py)")
    if args.kdist_sw:
        kd_sw = load_kdist(args.kdist_sw, GASES)
        print(f"SW k-distribution: {args.kdist_sw}")
    else:
        d = d or tempfile.mkdtemp()
        psw = os.path.join(d, "sw.nc")
        generate_kdist_nc(psw, kind="sw", gpts_per_band=4, nband=14)
        kd_sw = load_kdist(psw, GASES)
        print("SW k-distribution: synthetic (gasoptics/synthetic.py)")

    play, plev, tlay, tlev, tsfc, gc = make_atmosphere(ncol=args.ncol, nlay=args.nlay)
    emis = jnp.full((args.ncol, kd_lw.nband), 0.97, play.dtype)
    fields = run_lw_variants(kd_lw, play, plev, tlay, tlev, tsfc, gc, emis)
    mu0 = jnp.full((args.ncol,), 0.7, play.dtype)
    alb = jnp.full((args.ncol, kd_sw.nband), 0.12, play.dtype)
    fields.update(run_sw_variants(kd_sw, play, plev, tlay, gc, mu0, alb))

    # per-check thresholds: identity checks at fail_tol; different-input
    # checks (interpolated tlev, linearized Jacobian) at their physical
    # agreement levels (mirrors verify_variants)
    loose = {"lw_notlev": 0.05, "lw_jacobian": 5e-3}
    checks = verify_variants(fields, fail_tol=args.fail_tol)
    print(f"{len(fields)} fields, {args.ncol} cols x {args.nlay} layers")
    print("--------")
    failed = []
    for name, v in sorted(checks.items()):
        tol = loose.get(name, args.fail_tol)
        status = "ok" if v < tol else "FAIL"
        if status == "FAIL":
            failed.append(name)
        print(f"  {name:12s} max rel diff {v:12.3e}  (tol {tol:.0e})  {status}")
    print("--------")

    write_fields(args.output, fields)
    print(f"wrote {len(fields)} broadband fields to {args.output}")
    if failed:
        print(f"FAILED checks: {failed}")
        return 1
    print("all verification checks passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
