"""Summarize a jax.profiler trace: per-op device time, aggregated by name.

Usage: python scripts/trace_summarize.py <trace_dir_or_json.gz> [top_n] [iters]

Reads the newest plugins/profile/*/‌*.trace.json.gz under the given
directory and keeps events on device tracks (pid names containing
"/device:" or "GPU"). Totals are RAW SUMS over every traced iteration;
pass ``iters`` (the loop count of the capture script) to additionally
print per-call totals -- without it, do NOT compare 'total device time'
against per-call anchors.
"""
from __future__ import annotations

import collections
import glob
import gzip
import json
import os
import sys


def load_trace(path: str) -> dict:
    if os.path.isdir(path):
        cands = sorted(glob.glob(
            os.path.join(path, "plugins", "profile", "*", "*.trace.json.gz")))
        if not cands:
            raise FileNotFoundError(f"no trace.json.gz under {path}")
        path = cands[-1]
    with gzip.open(path, "rt") as f:
        return json.load(f)


def main() -> None:
    path = sys.argv[1]
    top_n = int(sys.argv[2]) if len(sys.argv) > 2 else 30
    iters = int(sys.argv[3]) if len(sys.argv) > 3 else None
    trace = load_trace(path)
    events = trace["traceEvents"]

    pid_names = {}
    tid_names = {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            pid_names[e["pid"]] = e["args"].get("name", "")
        if e.get("ph") == "M" and e.get("name") == "thread_name":
            tid_names[(e["pid"], e["tid"])] = e["args"].get("name", "")

    device_pids = {
        pid for pid, name in pid_names.items()
        if "GPU" in name or "/device:" in name or "Device" in name
    }

    durs = collections.defaultdict(float)
    counts = collections.defaultdict(int)
    total = 0.0
    for e in events:
        if e.get("ph") != "X" or e.get("pid") not in device_pids:
            continue
        tname = tid_names.get((e["pid"], e["tid"]), "")
        if "step" in tname.lower():
            continue  # step track duplicates the op track
        name = e["name"]
        dur = float(e.get("dur", 0.0))
        durs[name] += dur
        counts[name] += 1
        total += dur

    print(f"pids (device): { {p: pid_names[p] for p in device_pids} }")
    print(f"total device time: {total/1e3:.3f} ms"
          + (f"  ({total/1e3/iters:.3f} ms/call over {iters} iters)"
             if iters else "  (sum over ALL traced iterations)"))
    print(f"{'op':<64} {'total_us':>10} {'n':>5} {'us/ea':>9}")
    for name, d in sorted(durs.items(), key=lambda kv: -kv[1])[:top_n]:
        print(f"{name[:64]:<64} {d:10.1f} {counts[name]:5d} "
              f"{d/max(counts[name],1):9.1f}")


if __name__ == "__main__":
    main()
