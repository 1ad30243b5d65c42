#!/usr/bin/env python3
"""Measure, on one GPU, the implementation choices the package made for it.

    python3 -u scripts/probe_gpu_choices.py [--probe NAME ...] [--out FILE.json]

1. Matmul precision: GPU float32 fluxes against the float64 CPU reference
   with the package's HIGHEST precision and with DEFAULT (TF32 on the
   card), clear sky and all sky at 1800 columns, plus the driver times.
2. Band -> g-point expansion: the exact gather that ``SpectralMapping``
   uses against a one-hot matrix product (HIGHEST and DEFAULT), alone at
   (60, 1800) and end to end through ``allsky_lw`` / ``allsky_sw``.
3. Cloud-LUT interpolation: the gather in ``extensions.cloud_optics``
   against a one-hot row pick of a 3-term bf16-split table, alone and end
   to end through the all-sky drivers.

Every time is the median of repeated calls that each end in
``block_until_ready``, printed beside the card's name and power limit.
Refuses to run without a GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

import chip_smoke  # noqa: E402  (card line, comparison helpers)


def median_time(fn, *args, n=15, **kw):
    import jax

    jax.block_until_ready(fn(*args, **kw))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args, **kw))
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


# ---- one-hot forms the package replaced, kept here to time against ------

def expand_onehot(spec, band_values, precision):
    import jax.numpy as jnp
    import numpy as np

    oh = (spec.gpt2band[None, :] == np.arange(spec.nband)[:, None])
    return jnp.dot(band_values, jnp.asarray(oh, band_values.dtype),
                   precision=precision)


def from_table_onehot_split(mask, wp_, re, offset, upr, ext_t, ssa_t, asy_t):
    """The previous f32 cloud-LUT interpolation: a one-hot row pick of a
    3-term bf16-split [values | forward differences] table."""
    import jax
    import jax.numpy as jnp

    nband, nsteps = ext_t.shape
    dtype = re.dtype
    step_size = (upr - offset) / (nsteps - 1)
    fidx = (re - offset) / step_size
    index = jnp.clip(jnp.floor(fidx).astype(jnp.int32), 0, nsteps - 2)
    fint = (fidx - index)[..., None]
    m = mask[..., None]
    cat = jnp.concatenate([t.T.astype(dtype) for t in (ext_t, ssa_t, asy_t)],
                          axis=1)
    dcat = jnp.concatenate([cat[1:] - cat[:-1],
                            jnp.zeros((1, cat.shape[1]), dtype)], axis=0)
    tbl = jnp.concatenate([cat, dcat], axis=1)
    hi = tbl.astype(jnp.bfloat16).astype(dtype)
    mid = (tbl - hi).astype(jnp.bfloat16).astype(dtype)
    lo = tbl - hi - mid
    k = jax.lax.broadcasted_iota(jnp.int32, (*re.shape, nsteps), re.ndim)
    oh = (k == index[..., None]).astype(dtype)
    g = (jnp.dot(oh, hi) + jnp.dot(oh, mid)) + jnp.dot(oh, lo)
    vals = g[..., :3 * nband] + fint * g[..., 3 * nband:]
    e_v, s_v, a_v = (vals[..., :nband], vals[..., nband:2 * nband],
                     vals[..., 2 * nband:])
    t = jnp.where(m, wp_[..., None] * e_v, 0.0)
    ts = t * s_v
    tsg = ts * a_v
    return t, jnp.where(m, ts, 0.0), jnp.where(m, tsg, 0.0)


# ---- probes ----------------------------------------------------------------

def probe_precision(card, res):
    import jax
    import jax.numpy as jnp
    import numpy as np

    import rte_rrtmgp_nn_tpu.models.network as network
    from rte_rrtmgp_nn_tpu.drivers import seeded_inputs as si
    from rte_rrtmgp_nn_tpu.drivers.allsky import allsky_lw, allsky_sw
    from rte_rrtmgp_nn_tpu.drivers.rfmip import (
        rfmip_clear_sky_lw,
        rfmip_clear_sky_sw,
    )

    lw, sw = si.load_models(0)
    data = si.make_rfmip(0)
    atm = si.make_allsky_atmosphere(1, ncol=data.ncol)
    co_lw, co_sw = si.make_cloud_optics(0, "lw"), si.make_cloud_optics(0, "sw")
    cl_lw = si.make_cloud_fields(2, atm.play, atm.tlay, co_lw)
    cl_sw = si.make_cloud_fields(2, atm.play, atm.tlay, co_sw)
    calls = {
        "clear-sky LW": lambda m, c, dt: rfmip_clear_sky_lw(data, m[0], dtype=dt),
        "clear-sky SW": lambda m, c, dt: rfmip_clear_sky_sw(data, m[1], dtype=dt),
        "all-sky LW": lambda m, c, dt: allsky_lw(atm, c[0], m[0], dtype=dt,
                                                 clouds=cl_lw),
        "all-sky SW": lambda m, c, dt: allsky_sw(atm, c[1], m[1], dtype=dt,
                                                 clouds=cl_sw),
    }
    cpu = jax.devices("cpu")[0]
    with jax.enable_x64(True), jax.default_device(cpu):
        to64 = lambda t: jax.tree.map(
            lambda a: jnp.asarray(np.asarray(a), jnp.float64), t)
        m64, c64 = to64((lw, sw)), to64((co_lw, co_sw))
        ref = {k: jax.tree.map(np.asarray, f(m64, c64, jnp.float64))
               for k, f in calls.items()}
    out = {}
    for pname, prec in (("HIGHEST", jax.lax.Precision.HIGHEST),
                        ("DEFAULT", jax.lax.Precision.DEFAULT)):
        network.MATMUL_PRECISION = prec
        jax.clear_caches()
        for k, f in calls.items():
            got = f((lw, sw), (co_lw, co_sw), jnp.float32)
            t = median_time(f, (lw, sw), (co_lw, co_sw), jnp.float32, n=7)
            row = {"ms": t * 1e3}
            for fld in ("flux_up", "flux_dn", "flux_dn_dir"):
                r = getattr(ref[k], fld)
                if r is None:
                    continue
                d = np.abs(np.asarray(getattr(got, fld), np.float64) - r)
                row[fld] = {"max": float(d.max()), "mean": float(d.mean())}
            out[f"{k} {pname}"] = row
            print(f"precision {pname:7s} {k}: {row}  [{card}]", flush=True)
    network.MATMUL_PRECISION = jax.lax.Precision.HIGHEST
    jax.clear_caches()
    res["precision"] = out


def probe_expand_and_lut(card, res):
    import jax
    import jax.numpy as jnp
    import numpy as np

    import rte_rrtmgp_nn_tpu.extensions.cloud_optics as cloud_mod
    from rte_rrtmgp_nn_tpu.drivers import seeded_inputs as si
    from rte_rrtmgp_nn_tpu.drivers.allsky import allsky_lw, allsky_sw
    from rte_rrtmgp_nn_tpu.gasoptics.planck import (
        lw_spectral_g128,
        sw_spectral_g112,
    )
    from rte_rrtmgp_nn_tpu.spectral import SpectralMapping

    out = {}
    rng = np.random.default_rng(0)
    for spec in (lw_spectral_g128(), sw_spectral_g112()):
        x = jnp.asarray(rng.uniform(0, 1, (60, 1800, spec.nband)), jnp.float32)
        g = jax.jit(spec.expand)
        tg = median_time(g, x, n=50)
        row = {"gather_ms": tg * 1e3}
        for pname, prec in (("HIGHEST", jax.lax.Precision.HIGHEST),
                            ("DEFAULT", jax.lax.Precision.DEFAULT)):
            f = jax.jit(lambda v, p=prec: expand_onehot(spec, v, p))
            row[f"onehot_{pname}_ms"] = median_time(f, x, n=50) * 1e3
            row[f"onehot_{pname}_max_rel_err"] = float(jnp.max(
                jnp.abs(f(x) - g(x)) / jnp.abs(g(x))))
        out[f"expand nband={spec.nband} (60,1800)"] = row
        print(f"expand nband {spec.nband}: {row}  [{card}]", flush=True)

    lw, sw = si.load_models(0)
    atm = si.make_allsky_atmosphere(1, ncol=1800)
    co_lw, co_sw = si.make_cloud_optics(0, "lw"), si.make_cloud_optics(0, "sw")
    cl_lw = si.make_cloud_fields(2, atm.play, atm.tlay, co_lw)
    cl_sw = si.make_cloud_fields(2, atm.play, atm.tlay, co_sw)
    e2e = lambda: {
        "allsky_lw_ms": median_time(allsky_lw, atm, co_lw, lw, clouds=cl_lw,
                                    n=9) * 1e3,
        "allsky_sw_ms": median_time(allsky_sw, atm, co_sw, sw, clouds=cl_sw,
                                    n=9) * 1e3}
    jax.clear_caches()
    out["allsky gather expand + gather LUT"] = base = e2e()
    gather_expand = SpectralMapping.expand
    SpectralMapping.expand = lambda self, v: expand_onehot(
        self, v, jax.lax.Precision.HIGHEST)
    jax.clear_caches()
    out["allsky onehot-HIGHEST expand + gather LUT"] = e2e()
    SpectralMapping.expand = gather_expand

    # cloud LUT alone and end to end
    lwp, iwp, rel, rei = (jnp.asarray(a.T) for a in cl_lw)
    for name, fn in (("gather", cloud_mod._from_table),
                     ("onehot_split3", from_table_onehot_split)):
        f = jax.jit(lambda m, w, r, f=fn: f(
            m, w, r, co_lw.radliq_lwr, co_lw.radliq_upr, co_lw.lut_extliq,
            co_lw.lut_ssaliq, co_lw.lut_asyliq))
        out[f"cloud LUT liquid {name} (60,1800,16) ms"] = median_time(
            f, lwp > 0, lwp, rel, n=50) * 1e3
    gather_tbl = cloud_mod._from_table
    cloud_mod._from_table = from_table_onehot_split
    jax.clear_caches()
    out["allsky gather expand + onehot_split3 LUT"] = e2e()
    cloud_mod._from_table = gather_tbl
    jax.clear_caches()
    out["allsky gather expand + gather LUT (again)"] = e2e()
    for k, v in out.items():
        print(f"{k}: {v}  [{card}]", flush=True)
    res["expand_lut"] = out
    del base


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--probe", nargs="+", default=list(PROBES),
                    choices=list(PROBES), help="probes to run, in order")
    ap.add_argument("--out", help="write the results to this JSON file "
                    "after every probe")
    args = ap.parse_args(argv)
    plat = os.environ.get("JAX_PLATFORMS", "")
    if plat and "cpu" not in plat.split(","):
        os.environ["JAX_PLATFORMS"] = plat + ",cpu"
    import jax

    from rte_rrtmgp_nn_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if jax.devices()[0].platform != "gpu":
        print("probe_gpu_choices: needs a GPU", file=sys.stderr)
        return 2
    card = chip_smoke.card_line()
    print(card, flush=True)
    res = {"card": card, "device_kind": jax.devices()[0].device_kind}
    for name in args.probe:
        t0 = time.perf_counter()
        PROBES[name](card, res)
        print(f"probe {name} took {time.perf_counter() - t0:.1f} s",
              flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(res, f, indent=1)
    return 0


PROBES = {"precision": probe_precision, "forms": probe_expand_and_lut}


if __name__ == "__main__":
    sys.exit(main())
