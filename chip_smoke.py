#!/usr/bin/env python3
"""Smoke run of the radiation paths on one NVIDIA GPU.

    python3 chip_smoke.py               # phases 0-4 on one card
    python3 chip_smoke.py --four-cards  # only the 4-card mesh phase

Phases, all in this one process (it is the only one that opens the card):

0. Device: the first JAX device must be a GPU; anything else exits non-zero
   (there is no CPU fallback). Prints the card's name and power limit
   (nvidia-smi), ``device_kind``, the JAX version and the compile cache.
1. Clear sky at the RFMIP size (1800 columns x 60 layers, seeded inputs):
   ``rfmip_clear_sky_lw`` and ``rfmip_clear_sky_sw`` three times each; the
   first call includes compilation.
2. All sky, 1800 columns: ``allsky_lw`` and ``allsky_sw`` likewise.
3. A GCM block of 57,600 columns: clear-sky LW+SW through the drivers, then
   a ``drivers.gcm`` all-sky sweep over 4 such blocks resident on the card.
   Prints the peak device memory.
4. Reference: the same drivers at float64 on the host CPU backend of this
   process, on the phase-1 and phase-2 inputs and on the first 1800 columns
   of the phase-3 block. Every broadband flux (up, down, SW direct) must
   agree within max |d| <= 0.05 W/m2 and mean |d| <= 5e-3 W/m2. SW TOA down
   must equal TSI * mu0 on day columns and be exactly 0 on night columns.

``--four-cards`` runs LW+SW clear sky at 4 x 1800 columns through the staged
cores under ``shard_map`` on a ('col',) = 4 mesh, and the ('col', 'gpt') =
2 x 2 spectral-output forward, each against the same call on one card, to
the phase-4 tolerance.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform", "kind", "count"}}``, printed only when
every phase passed.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

MAX_ABS_TOL = 0.05   # W/m2, largest |GPU f32 - CPU f64| allowed per flux
MEAN_ABS_TOL = 5e-3  # W/m2, mean |GPU f32 - CPU f64| allowed per flux
NCOL_RFMIP = 1800
NCOL_GCM_BLOCK = 57_600
N_GCM_BLOCKS = 4


class PhaseFailure(RuntimeError):
    pass


def card_line() -> str:
    """``name, power.limit`` of the first GPU, as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        raise PhaseFailure(f"nvidia-smi failed: {e}") from e
    return out.stdout.strip().splitlines()[0]


def timed(fn, *args, repeat=3, **kwargs):
    """Run ``fn`` ``repeat`` times, blocking on each result. Returns the
    last result and the wall times [s]; the first includes compilation."""
    import jax

    times, out = [], None
    for _ in range(repeat):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args, **kwargs))
        times.append(time.perf_counter() - t0)
    return out, times


def report_times(label, times, card):
    cold, warm = times[0], times[1:]
    print(f"{label}: cold {cold * 1e3:.3f} ms (incl. compile), warm "
          + ", ".join(f"{t * 1e3:.3f}" for t in warm) + f" ms  [{card}]")


def compare(label, got, ref, fields, failures):
    """Print max/mean |got - ref| per flux field; append tolerance
    breaches to ``failures``."""
    import numpy as np

    worst = []
    for f in fields:
        g = np.asarray(getattr(got, f), np.float64)
        r = np.asarray(getattr(ref, f), np.float64)
        if g.shape != r.shape:
            raise PhaseFailure(f"{label} {f}: shape {g.shape} vs {r.shape}")
        if not np.all(np.isfinite(g)):
            raise PhaseFailure(f"{label} {f}: non-finite values")
        d = np.abs(g - r)
        print(f"  {label} {f}: max|d| {d.max():.3e}  mean|d| {d.mean():.3e}"
              f"  W/m2 (mean flux {r.mean():.3f})")
        if d.max() > MAX_ABS_TOL or d.mean() > MEAN_ABS_TOL:
            worst.append(f"{f} max {d.max():.3e} mean {d.mean():.3e}")
    if worst:
        failures.append(f"{label} outside tolerance: " + "; ".join(worst))


def check_sw_toa(label, fb, data):
    """TOA SW down == TSI * mu0 on day columns, exact zeros at night."""
    import numpy as np

    toa = -1 if not data.top_at_1 else 0
    day = data.sza < 90.0 - 0.5 * np.finfo(np.float32).eps
    mu0 = np.cos(np.deg2rad(np.asarray(data.sza, np.float64)))
    dn = np.asarray(fb.flux_dn, np.float64)
    want = np.asarray(data.tsi, np.float64) * mu0
    err = np.abs(dn[day, toa] - want[day])
    if not np.all(err <= 1e-5 * want[day] + 1e-3):
        raise PhaseFailure(f"{label}: TOA SW down differs from TSI*mu0 by "
                           f"up to {err.max():.3e} W/m2")
    for f in ("flux_up", "flux_dn", "flux_dn_dir"):
        if np.any(np.asarray(getattr(fb, f))[~day] != 0.0):
            raise PhaseFailure(f"{label}: {f} nonzero on a night column")
    print(f"  {label}: TOA down == TSI*mu0 on {day.sum()} day columns "
          f"(max |d| {err.max():.3e}), exact 0 on {(~day).sum()} night")


def run_one_card(card, nsites=100, ncol_block=NCOL_GCM_BLOCK,
                 n_blocks=N_GCM_BLOCKS):
    """Phases 1-4 (module docstring); the sizes shrink only for
    rehearsals on the CPU."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rte_rrtmgp_nn_tpu.drivers import seeded_inputs as si
    from rte_rrtmgp_nn_tpu.drivers.allsky import allsky_lw, allsky_sw
    from rte_rrtmgp_nn_tpu.drivers.gcm import gcm_host_columns, gcm_sweep_allsky
    from rte_rrtmgp_nn_tpu.drivers.rfmip import (
        rfmip_clear_sky_lw,
        rfmip_clear_sky_sw,
    )

    gpu = jax.devices()[0]
    lw_models, sw_models = si.load_models(seed=0)
    data = si.make_rfmip(seed=0, nsites=nsites)
    ncol = data.ncol

    print("phase 1: clear sky, RFMIP size "
          f"({data.ncol} columns x {data.nlay} layers)")
    lw1, t = timed(rfmip_clear_sky_lw, data, lw_models)
    report_times("  rfmip_clear_sky_lw", t, card)
    sw1, t = timed(rfmip_clear_sky_sw, data, sw_models)
    report_times("  rfmip_clear_sky_sw", t, card)

    print(f"phase 2: all sky, {ncol} columns")
    atm = si.make_allsky_atmosphere(seed=1, ncol=ncol)
    co_lw = si.make_cloud_optics(seed=0, kind="lw")
    co_sw = si.make_cloud_optics(seed=0, kind="sw")
    clouds_lw = si.make_cloud_fields(2, atm.play, atm.tlay, co_lw)
    clouds_sw = si.make_cloud_fields(2, atm.play, atm.tlay, co_sw)
    lw2, t = timed(allsky_lw, atm, co_lw, lw_models, clouds=clouds_lw)
    report_times("  allsky_lw", t, card)
    sw2, t = timed(allsky_sw, atm, co_sw, sw_models, clouds=clouds_sw)
    report_times("  allsky_sw", t, card)

    print(f"phase 3: GCM block, {ncol_block} columns")
    block = si.make_gcm_block(seed=3, ncol=ncol_block)
    lw3, t = timed(rfmip_clear_sky_lw, block, lw_models)
    report_times(f"  rfmip_clear_sky_lw {ncol_block}", t, card)
    sw3, t = timed(rfmip_clear_sky_sw, block, sw_models)
    report_times(f"  rfmip_clear_sky_sw {ncol_block}", t, card)
    hosts = [gcm_host_columns(block)] + [
        gcm_host_columns(si.make_gcm_block(seed=3 + i, ncol=ncol_block))
        for i in range(1, n_blocks)]
    host = {k: np.concatenate([h[k] for h in hosts]) for k in hosts[0]}
    del hosts
    t0 = time.perf_counter()
    sweep = gcm_sweep_allsky(host, lw_models, sw_models, co_lw, co_sw,
                             block_size=ncol_block,
                             top_at_1=block.top_at_1, resident=True)
    wall = time.perf_counter() - t0
    diag = sweep["diagnostics"]
    print(f"  gcm_sweep_allsky resident, {n_blocks} x {ncol_block} "
          f"columns: sweep {sweep['elapsed_s'] * 1e3:.3f} ms "
          f"({sweep['columns_per_s']:.1f} columns/s), wall incl. staging "
          f"and compile {wall:.3f} s  [{card}]")
    print(f"  means: OLR {sweep['mean_olr']:.3f}, LW sfc dn "
          f"{sweep['mean_lw_sfc_dn']:.3f}, SW sfc dn "
          f"{sweep['mean_sw_sfc_dn']:.3f} W/m2")
    if diag.shape != (n_blocks * ncol_block, 3) or not np.all(
            np.isfinite(diag)):
        raise PhaseFailure("GCM sweep diagnostics malformed or non-finite")
    if not (100.0 < sweep["mean_olr"] < 350.0
            and 50.0 < sweep["mean_lw_sfc_dn"] < 500.0
            and 0.0 < sweep["mean_sw_sfc_dn"] < 1400.0):
        raise PhaseFailure("GCM sweep means outside physical ranges")
    stats = gpu.memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    print("  peak device memory: "
          + (f"{peak / 2**30:.3f} GiB" if peak is not None else "not reported")
          + f"  [{card}]")

    print("phase 4: GPU float32 vs CPU float64 reference")
    cpu = jax.devices("cpu")[0]
    nref = min(NCOL_RFMIP, ncol_block)
    lw3s, sw3s = (jax.tree.map(lambda a: np.asarray(a)[:nref], fb)
                  for fb in (lw3, sw3))
    block_s = block.block(0, nref)
    with jax.enable_x64(True), jax.default_device(cpu):
        to64 = lambda ms: [jax.tree.map(
            lambda a: jnp.asarray(np.asarray(a), jnp.float64), m) for m in ms]
        lw64, sw64 = to64(lw_models), to64(sw_models)
        co_lw64, co_sw64 = (jax.tree.map(
            lambda a: jnp.asarray(np.asarray(a), jnp.float64), c)
            for c in (co_lw, co_sw))
        f64 = jnp.float64
        ref = {
            "lw1": rfmip_clear_sky_lw(data, lw64, dtype=f64),
            "sw1": rfmip_clear_sky_sw(data, sw64, dtype=f64),
            "lw2": allsky_lw(atm, co_lw64, lw64, dtype=f64,
                             clouds=clouds_lw),
            "sw2": allsky_sw(atm, co_sw64, sw64, dtype=f64,
                             clouds=clouds_sw),
            "lw3": rfmip_clear_sky_lw(block_s, lw64, dtype=f64),
            "sw3": rfmip_clear_sky_sw(block_s, sw64, dtype=f64),
        }
        ref = jax.tree.map(np.asarray, jax.block_until_ready(ref))
    up_dn = ("flux_up", "flux_dn")
    sw_f = up_dn + ("flux_dn_dir",)
    failures = []
    compare(f"clear-sky LW {ncol}", lw1, ref["lw1"], up_dn, failures)
    compare(f"clear-sky SW {ncol}", sw1, ref["sw1"], sw_f, failures)
    compare(f"all-sky LW {ncol}", lw2, ref["lw2"], up_dn, failures)
    compare(f"all-sky SW {ncol}", sw2, ref["sw2"], sw_f, failures)
    compare(f"GCM-block LW slice {nref}", lw3s, ref["lw3"], up_dn, failures)
    compare(f"GCM-block SW slice {nref}", sw3s, ref["sw3"], sw_f, failures)
    check_sw_toa(f"clear-sky SW {ncol}", sw1, data)
    check_sw_toa(f"GCM-block SW {ncol_block}", sw3, block)
    if failures:
        raise PhaseFailure("; ".join(failures))


def run_four_cards(card):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from rte_rrtmgp_nn_tpu.drivers import seeded_inputs as si
    from rte_rrtmgp_nn_tpu.drivers.rfmip import (
        _lw_core_lay_major_jit,
        _sw_core_lay_major_jit,
        default_solar_source,
        lw_core_sharded,
        sw_core_sharded,
    )
    from rte_rrtmgp_nn_tpu.fluxes import FluxesBroadband
    from rte_rrtmgp_nn_tpu.gasoptics.planck import (
        PlanckTable,
        lw_spectral_g128,
        sw_spectral_g112,
    )
    from rte_rrtmgp_nn_tpu.parallel.sharding import make_mesh

    devs = jax.devices()
    if len(devs) < 4:
        raise PhaseFailure(f"--four-cards needs 4 GPUs, JAX sees {len(devs)}")
    f32 = jnp.float32
    lw_models, sw_models = si.load_models(seed=0)
    data = si.make_rfmip(seed=4, nsites=4 * 100)  # 4 x 1800 columns
    lw_spec, sw_spec = lw_spectral_g128(), sw_spectral_g112()
    table = PlanckTable.compute(lw_spec.band_lims_wvn_array, dtype=f32)
    solar = jnp.asarray(default_solar_source(sw_spec), f32)
    mu0 = np.cos(np.deg2rad(data.sza))
    usecol = data.sza < 90.0 - 0.5 * np.finfo(np.float32).eps
    concs = {k: np.asarray(v, np.float32)
             for k, v in data.gas_concs.concs.items()}
    emis = np.broadcast_to(data.sfc_emis[:, None],
                           (data.ncol, lw_spec.nband)).astype(np.float32)
    lw_args = (data.play, data.plev, data.tlay, data.tlev, data.tsfc, emis,
               concs)
    sw_args = (data.play, data.plev, data.tlay, data.sfc_alb,
               mu0.astype(np.float32), usecol, data.tsi, concs)

    print(f"four cards: clear sky LW+SW, {data.ncol} columns on a "
          "('col',)=4 mesh vs one card")
    on0 = lambda a: jax.device_put(a, devs[0])
    lw_one, t = timed(_lw_core_lay_major_jit, lw_models, table, lw_spec,
                      *jax.tree.map(on0, lw_args), top_at_1=data.top_at_1)
    report_times("  LW one card", t, card)
    sw_one, t = timed(_sw_core_lay_major_jit, sw_models, sw_spec, solar,
                      *jax.tree.map(on0, sw_args), top_at_1=data.top_at_1)
    report_times("  SW one card", t, card)

    mesh = make_mesh(n_col=4, n_gpt=1, devices=devs[:4])
    col = NamedSharding(mesh, P("col"))
    rep = NamedSharding(mesh, P())
    put = lambda a: jax.device_put(a, col if np.ndim(a) else rep)
    lw_fn = jax.jit(lw_core_sharded(mesh, lw_models, table, lw_spec,
                                    data.top_at_1))
    (up, dn), t = timed(lw_fn, *jax.tree.map(put, lw_args))
    report_times("  LW 4 cards", t, card)
    lw_four = FluxesBroadband(flux_up=up, flux_dn=dn, flux_net=dn - up)
    sw_fn = jax.jit(sw_core_sharded(mesh, sw_models, sw_spec, solar,
                                    data.top_at_1))
    (up, dn, dr), t = timed(sw_fn, *jax.tree.map(put, sw_args))
    report_times("  SW 4 cards", t, card)
    sw_four = FluxesBroadband(flux_up=up, flux_dn=dn, flux_net=dn - up,
                              flux_dn_dir=dr)
    failures = []
    compare("col=4 LW vs one card", lw_four, lw_one, ("flux_up", "flux_dn"),
            failures)
    compare("col=4 SW vs one card", sw_four, sw_one,
            ("flux_up", "flux_dn", "flux_dn_dir"), failures)

    print("four cards: ('col','gpt')=2x2 spectral-output forward vs one card")
    from rte_rrtmgp_nn_tpu.gas_concs import GasConcs
    from rte_rrtmgp_nn_tpu.gasoptics.nn_gas_optics import gas_optics_lw_nn
    from rte_rrtmgp_nn_tpu.optical_props import OpticalProps1scl
    from rte_rrtmgp_nn_tpu.rte import rte_lw

    nsub = NCOL_RFMIP
    sub = data.block(0, nsub)
    fargs = (sub.play, sub.plev, sub.tlay, sub.tlev, sub.tsfc,
             np.ascontiguousarray(emis[:nsub]),
             {k: np.asarray(v, np.float32)
              for k, v in sub.gas_concs.concs.items()})

    def fwd(models, play, plev, tlay, tlev, tsfc, emis_b, concs):
        tau, sources = gas_optics_lw_nn(
            models, play, plev, tlay, tsfc, GasConcs(concs), lw_spec,
            table, tlev=tlev, top_at_1=sub.top_at_1)
        sol = rte_lw(OpticalProps1scl(tau, lw_spec), sub.top_at_1,
                     sources, emis_b, n_gauss_angles=1)
        return sol.flux_up, sol.flux_dn

    (up1, dn1), t = timed(jax.jit(fwd), lw_models,
                          *jax.tree.map(on0, fargs))
    report_times("  spectral forward one card", t, card)
    mesh22 = make_mesh(n_col=2, n_gpt=2, devices=devs[:4])
    col22 = NamedSharding(mesh22, P("col"))
    rep22 = NamedSharding(mesh22, P())
    sh3 = NamedSharding(mesh22, P("col", None, "gpt"))
    put22 = lambda a: jax.device_put(a, col22 if np.ndim(a) else rep22)
    (up4, dn4), t = timed(jax.jit(fwd, out_shardings=(sh3, sh3)),
                          jax.device_put(lw_models, rep22),
                          *jax.tree.map(put22, fargs))
    report_times("  spectral forward 2x2", t, card)
    if up4.sharding.spec != P("col", None, "gpt"):
        raise PhaseFailure(f"2x2 output sharding is {up4.sharding.spec}")
    bb = lambda u, d: FluxesBroadband(
        flux_up=np.asarray(u).sum(-1), flux_dn=np.asarray(d).sum(-1),
        flux_net=None)
    compare("col x gpt 2x2 broadband vs one card", bb(up4, dn4),
            bb(up1, dn1), ("flux_up", "flux_dn"), failures)
    g = lambda a: FluxesBroadband(flux_up=np.asarray(a), flux_dn=None,
                                  flux_net=None)
    compare("col x gpt 2x2 per-g-point up vs one card", g(up4), g(up1),
            ("flux_up",), failures)
    if failures:
        raise PhaseFailure("; ".join(failures))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card mesh phase")
    args = ap.parse_args(argv)

    # the float64 reference needs the host CPU backend beside the GPU
    plat = os.environ.get("JAX_PLATFORMS", "")
    if plat and "cpu" not in plat.split(","):
        os.environ["JAX_PLATFORMS"] = plat + ",cpu"

    import jax

    from rte_rrtmgp_nn_tpu.utils.compile_cache import enable_compile_cache

    cache_dir = enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, but JAX's first device is "
              f"{dev.platform} ({dev.device_kind}); refusing to run on it",
              file=sys.stderr)
        return 2
    card = card_line()
    print(f"phase 0: {card}")
    print(f"  device_kind {dev.device_kind}, {len(jax.devices())} device(s), "
          f"jax {jax.__version__}, compile cache {cache_dir}")
    try:
        if args.four_cards:
            run_four_cards(card)
        else:
            run_one_card(card)
    except PhaseFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
