"""Benchmark: RFMIP clear-sky LW+SW with NN gas optics on one GPU.

    python bench.py

Prints the card's name and power limit (nvidia-smi), then ONE JSON line:
{"metric", "value", "unit", "vs_baseline", ..., "device"}.

Workload: the reference's headline benchmark shape (BASELINE.md), 1800
columns x 60 layers of seeded RFMIP-shaped inputs
(``drivers/seeded_inputs.py``), LW g-128 + SW g-112 NN gas optics and
solvers, timed through the driver entry points ``rfmip_clear_sky_lw`` and
``rfmip_clear_sky_sw`` (host staging included): the median of 20 calls,
each ending in ``block_until_ready``, after one warm-up call that compiles.
Baseline: the reference's best CPU numbers (Intel ifort+MKL,
refactored+NN): LW 183.4 ms + SW 271.0 ms for 1800 columns -> 3961
columns/s.

Refuses to run unless JAX's first device is a GPU; ``JAX_PLATFORMS=cpu``
set explicitly runs it on the CPU, and the output then names that device.
"""
from __future__ import annotations

import json
import os
import sys
import time

BASELINE_COLS_PER_S = 1800.0 / (0.1834 + 0.2710)  # reference Intel CPU LW+SW
N_ITER = 20


def _median_call_s(fn, *args) -> float:
    import jax

    times = []
    for _ in range(N_ITER):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def main() -> int:
    explicit_cpu = os.environ.get("JAX_PLATFORMS") == "cpu"
    import jax
    import numpy as np

    from rte_rrtmgp_nn_tpu.drivers import seeded_inputs as si
    from rte_rrtmgp_nn_tpu.drivers.rfmip import (
        rfmip_clear_sky_lw,
        rfmip_clear_sky_sw,
    )
    from rte_rrtmgp_nn_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform == "gpu":
        from chip_smoke import card_line

        card = card_line()
    elif explicit_cpu:
        card = f"cpu ({dev.device_kind})"
    else:
        print(f"bench.py: needs a GPU, but JAX's first device is "
              f"{dev.platform}; set JAX_PLATFORMS=cpu to run on the CPU",
              file=sys.stderr)
        return 2

    data = si.make_rfmip(seed=0)
    lw_models, sw_models = si.load_models(seed=0)
    ncol = data.ncol
    t0 = time.perf_counter()
    lw = jax.block_until_ready(rfmip_clear_sky_lw(data, lw_models))
    jax.block_until_ready(rfmip_clear_sky_sw(data, sw_models))
    setup_s = time.perf_counter() - t0
    lw_s = _median_call_s(rfmip_clear_sky_lw, data, lw_models)
    sw_s = _median_call_s(rfmip_clear_sky_sw, data, sw_models)

    cols_per_s = ncol / (lw_s + sw_s)
    result = {
        "metric": "rfmip_clearsky_lw_sw_columns_per_s_per_chip",
        "value": cols_per_s,
        "unit": "columns/s",
        "vs_baseline": cols_per_s / BASELINE_COLS_PER_S,
        "lw_ms": lw_s * 1e3,
        "sw_ms": sw_s * 1e3,
        "first_calls_incl_compile_s": setup_s,
        "timing": f"median of {N_ITER} driver calls, each blocked",
        "ncol": ncol,
        "card": card,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }
    if not np.all(np.isfinite(np.asarray(lw.flux_dn))):
        result["warning"] = "non-finite LW fluxes"
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
