"""Where one corrtime block of the headline µVT run spends device time.

    python tools/trace_block.py [--steps 250]

Builds the 10.8k-atom MOF+H2 µVT Ewald system (models.systems.mof_h2_gcmc,
n_side=21, float32), warms up, then traces three windows with
``jax.profiler``, each in its own trace:

- ``chunk``: ``metropolis.run_chunk`` of ``--steps`` MC steps;
- ``refresh``: the per-corrtime ``metropolis.initialize`` with the
  frozen-reuse fast path (what the run loop calls every block);
- ``full_init``: a full ``metropolis.initialize`` (the O(N^2) pair pass
  over every row, as at start-up).

For each window it reports wall time, device busy time (the union of
the kernel intervals on the GPU's stream lines) and the idle share, and
the refresh's share of a block's device time.  Prints one JSON line per
window plus a summary, and writes ``chiprun_out/trace_block.json``.
Needs a GPU.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402


def device_busy_ns(pb_path):
    """Union of event intervals on the GPU device plane's stream lines
    (all its lines if none is named as a stream)."""
    from jax.profiler import ProfileData
    pd = ProfileData.from_file(pb_path)
    spans = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = list(plane.lines)
        streams = [ln for ln in lines if ln.name.startswith("Stream")]
        for ln in streams or lines:
            for ev in ln.events:
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    spans.sort()
    busy, end = 0.0, None
    for s, e in spans:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy, len(spans)


def traced(fn):
    """Run fn once under the profiler; the wall time covers the call
    alone (starting and stopping the profiler is excluded)."""
    with tempfile.TemporaryDirectory() as d:
        with jax.profiler.trace(d):
            t0 = time.perf_counter()
            out = fn()
            jax.block_until_ready(out)
            wall = time.perf_counter() - t0
        pb = glob.glob(os.path.join(d, "**", "*.xplane.pb"),
                       recursive=True)
        if not pb:
            raise RuntimeError("profiler wrote no .xplane.pb")
        busy, n = device_busy_ns(pb[0])
    if n == 0:
        raise RuntimeError("trace holds no device events")
    return out, wall, busy * 1e-9, n


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=250)
    args = ap.parse_args()
    from mpmc_tpu.utils import compile_cache
    compile_cache.enable()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"trace_block needs a GPU; JAX found {dev.platform}")
    from mpmc_tpu.mc import metropolis
    from mpmc_tpu.models import systems
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0].strip()
    params, state, cfg, thermo = systems.mof_h2_gcmc(
        n_side=21, spacing=4.0, n_h2=256, capacity=512,
        temperature=77.0, pressure=1.0)
    fr = metropolis.frozen_refresh_rows(params, cfg)
    st = metropolis.initialize(state, params, cfg, thermo)
    st, _ = metropolis.run_chunk(st, params, cfg, thermo, args.steps)
    st = metropolis.initialize(st, params, cfg, thermo, frozen_rows=fr)
    jax.block_until_ready(metropolis.initialize(st, params, cfg, thermo)
                          .energy.total)          # all three compiled
    rows = []
    windows = (
        ("chunk", lambda: metropolis.run_chunk(st, params, cfg, thermo,
                                               args.steps)[0].pos),
        ("refresh", lambda: metropolis.initialize(
            st, params, cfg, thermo, frozen_rows=fr).energy.total),
        ("full_init", lambda: metropolis.initialize(
            st, params, cfg, thermo).energy.total))
    for name, fn in windows:
        _, wall, busy, n = traced(fn)
        rows.append({"window": name, "wall_s": wall, "device_busy_s": busy,
                     "idle_share": 1.0 - busy / wall, "events": n})
        print(json.dumps(rows[-1]), flush=True)
    by = {r["window"]: r for r in rows}
    summary = {
        "card": card, "platform": dev.platform,
        "device_kind": dev.device_kind, "device_count": len(jax.devices()),
        "n_atom_slots": int(params.n_atoms_max), "steps": args.steps,
        "frozen_rows": fr,
        "refresh_share_of_block_device_time":
            by["refresh"]["device_busy_s"]
            / (by["refresh"]["device_busy_s"] + by["chunk"]["device_busy_s"]),
        "full_init_vs_chunk_device_time":
            by["full_init"]["device_busy_s"] / by["chunk"]["device_busy_s"],
    }
    print(json.dumps(summary), flush=True)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "trace_block.json"),
              "w") as f:
        json.dump({"summary": summary, "windows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
