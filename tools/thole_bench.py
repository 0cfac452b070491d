"""Time the Thole SCF matvec kernel against XLA's plain version on a GPU.

    python tools/thole_bench.py [--tune] [--no-e2e] [--steps 16]

Three settings, as the kernel's keep-or-remove decision needs them: the
10.8k-atom MOF+H2 polar system (models.systems.mof_h2_gcmc, n_side=21)
at the derived cutoff and at rc = 14 A, and the 53.7k-atom system
(n_side=37) at rc = 14 A.  For each setting:

- one matvec: the plain jnp ``thole.dipole_matvec`` as XLA compiles it,
  the Triton kernel dense, and the kernel tile-culled on cell-sorted
  sites (the per-solve sort + visit table timed apart), each compared
  with the jnp reference evaluated in float64 (relative L2 error);
- per polar MC step (unless --no-e2e): ``metropolis.run_chunk`` of the
  µVT system with the kernel route and with the plain route.

``--tune`` first times the dense and culled matvec at 10.8k over a few
(rows, columns, warps, stages) block configurations.  Prints one JSON
line per measurement, the card's name and power limit, and writes
everything to ``chiprun_out/thole_bench.json``.  Needs a GPU; exits
non-zero if any measurement failed.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

TUNE_BLOCKS = [(32, 64, 4, 2), (32, 32, 4, 2), (32, 32, 2, 2),
               (16, 32, 2, 2), (16, 32, 4, 2), (16, 64, 2, 2),
               (16, 64, 4, 2), (32, 16, 2, 2), (16, 16, 1, 2),
               (8, 64, 2, 2), (32, 32, 8, 2)]


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0].strip()


@contextlib.contextmanager
def plain_route():
    """Run the jnp reference where production would run the kernel (a
    measurement-only switch: patches ops.route for the duration)."""
    from mpmc_tpu.ops import route
    orig = route.thole_kernel
    route.thole_kernel = lambda cfg, interpret=False: False
    jax.clear_caches()
    try:
        yield
    finally:
        route.thole_kernel = orig
        jax.clear_caches()


def timeit(fn, *args, n=20):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n, out


def rel_l2(a, ref):
    a = np.asarray(a, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(a - ref) / np.linalg.norm(ref))


def system(n_side, rc):
    from mpmc_tpu.models import systems
    n_h2, cap = (256, 512) if n_side == 21 else (512, 1024)
    params, state, cfg, thermo = systems.mof_h2_gcmc(
        n_side=n_side, spacing=4.0, n_h2=n_h2, capacity=cap,
        temperature=77.0, pressure=1.0, polarization=True,
        dtype="float32")
    cfg = dataclasses.replace(cfg, cutoff=rc)
    return params, state, cfg, thermo


def matvec_setting(name, n_side, rc, blocks_list, rows):
    from mpmc_tpu.ops import pairs, thole
    from mpmc_tpu.ops.pallas import thole_kernel as tk
    params, state, cfg, _ = system(n_side, rc)
    alive = state.atom_alive(params)
    pol_ok = alive & (params.polar > 0)
    box = state.box
    rcj = pairs.derived_cutoff(box, cfg)
    lam = jnp.asarray(cfg.polar_damp, jnp.float32)
    mu = jnp.where(pol_ok[:, None], jax.random.normal(
        jax.random.PRNGKey(0), state.pos.shape, jnp.float32) * 0.05, 0.0)
    cfg64 = dataclasses.replace(cfg, dtype="float64")
    ref = jax.jit(lambda m: thole.dipole_matvec(
        state.pos.astype(jnp.float64), box.astype(jnp.float64), alive,
        params, cfg64, m))(mu.astype(jnp.float64))
    ref = np.asarray(ref)
    base = {"setting": name, "n_sites": int(state.pos.shape[0]),
            "n_polar": int(np.asarray(pol_ok).sum()), "rc": float(rcj)}
    with plain_route():
        f_plain = jax.jit(lambda m: thole.dipole_matvec(
            state.pos, box, alive, params, cfg, m))
        t, out = timeit(f_plain, mu)
    rows.append(dict(base, impl="xla_plain", ms=t * 1e3,
                     rel_l2_vs_f64=rel_l2(out, ref)))
    print(json.dumps(rows[-1]), flush=True)
    for bi, bj, nw, ns in blocks_list:
        blk = dict(bi=bi, bj=bj, num_warps=nw, num_stages=ns)
        tag = f"{bi}x{bj}w{nw}s{ns}"
        try:
            f_dense = jax.jit(lambda m: tk.dipole_field(
                state.pos, box, pol_ok, m, params.mol_id, rcj, lam,
                cfg.polar_damp_type, ortho=True, **blk))
            t, out = timeit(f_dense, mu)
            rows.append(dict(base, impl="kernel_dense", blocks=tag,
                             ms=t * 1e3, rel_l2_vs_f64=rel_l2(out, ref)))
            print(json.dumps(rows[-1]), flush=True)

            def prep(pos):
                perm, inv = thole.cull_perm(pos, box, pol_ok, rcj)
                pos_s, ok_s, _, mol_s = thole._sorted_sites(
                    perm, pos, pol_ok, params)
                n_pad, _, _ = tk.grid_shape(pos.shape[0], bi, bj)
                visit = thole.cull_visit(pos_s, ok_s, box, rcj, bi, bj,
                                         n_pad)
                return perm, inv, pos_s, ok_s, mol_s, visit

            f_prep = jax.jit(prep)
            t_prep, (perm, inv, pos_s, ok_s, mol_s, visit) = timeit(
                f_prep, state.pos)
            f_cull = jax.jit(lambda m: tk.dipole_field(
                pos_s, box, ok_s, m, mol_s, rcj, lam, cfg.polar_damp_type,
                ortho=True, visit=visit, **blk))
            t, out_s = timeit(f_cull, mu[perm])
            out = np.asarray(out_s)[np.asarray(inv)]
            rows.append(dict(base, impl="kernel_culled", blocks=tag,
                             ms=t * 1e3, sort_and_visit_ms=t_prep * 1e3,
                             visit_fraction=float(np.asarray(
                                 visit).mean()),
                             rel_l2_vs_f64=rel_l2(out, ref)))
            print(json.dumps(rows[-1]), flush=True)
        except Exception as e:  # recorded and reported, never hidden
            traceback.print_exc()
            rows.append(dict(base, impl="kernel", blocks=tag,
                             error=f"{type(e).__name__}: {e}"[:400]))
            print(json.dumps(rows[-1]), flush=True)


def e2e_setting(name, n_side, rc, steps, rows):
    from mpmc_tpu.mc import metropolis
    params, state, cfg0, thermo = system(n_side, rc)

    def run(label, cfg):
        t0 = time.perf_counter()
        st = metropolis.initialize(state, params, cfg, thermo)
        st, stats = metropolis.run_chunk(st, params, cfg, thermo, steps)
        jax.block_until_ready(st.energy.total)
        t_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        st, stats = metropolis.run_chunk(st, params, cfg, thermo, steps)
        jax.block_until_ready(st.energy.total)
        dt = time.perf_counter() - t0
        iters = int(np.asarray(stats.polar_iters))
        rows.append({"setting": name, "impl": label, "steps": steps,
                     "ms_per_step": dt / steps * 1e3,
                     "polar_iters": iters,
                     "compile_and_first_chunk_s": t_first})
        print(json.dumps(rows[-1]), flush=True)

    with plain_route():
        run("xla_plain", cfg0)
    jax.clear_caches()
    # polar_cull: "auto" culls only with an explicit cutoff; the other
    # variant times the kernel route with culling forced on / off
    other = "on" if rc is None else "off"
    run("kernel_route", cfg0)
    run(f"kernel_route_polar_cull_{other}",
        dataclasses.replace(cfg0, polar_cull=other))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tune", action="store_true")
    ap.add_argument("--no-e2e", action="store_true")
    ap.add_argument("--steps", type=int, default=16)
    args = ap.parse_args()
    jax.config.update("jax_enable_x64", True)
    from mpmc_tpu.utils import compile_cache
    compile_cache.enable()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"thole_bench needs a GPU; JAX found {dev.platform}")
    from mpmc_tpu.ops.pallas import thole_kernel as tk
    header = {"card": card(), "platform": dev.platform,
              "device_kind": dev.device_kind,
              "device_count": len(jax.devices()),
              "default_blocks": [tk.BI, tk.BJ, tk.NUM_WARPS,
                                 tk.NUM_STAGES]}
    print(json.dumps(header), flush=True)
    rows = []
    default = [(tk.BI, tk.BJ, tk.NUM_WARPS, tk.NUM_STAGES)]
    failed = False
    settings = [("10.8k_derived_rc", 21, None),
                ("10.8k_rc14", 21, 14.0),
                ("53.7k_rc14", 37, 14.0)]
    if args.tune:
        for name, n_side, rc in settings[:2]:
            matvec_setting(name + "_tune", n_side, rc, TUNE_BLOCKS, rows)
    for name, n_side, rc in settings:
        try:
            matvec_setting(name, n_side, rc, default, rows)
            if not args.no_e2e:
                e2e_setting(name, n_side, rc,
                            args.steps if n_side == 21
                            else max(args.steps // 2, 4), rows)
        except Exception as e:
            traceback.print_exc()
            failed = True
            rows.append({"setting": name,
                         "error": f"{type(e).__name__}: {e}"[:400]})
    failed = failed or any("error" in r for r in rows)
    header["peak_bytes_in_use"] = dev.memory_stats().get(
        "peak_bytes_in_use")
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "thole_bench.json"),
              "w") as f:
        json.dump({"header": header, "rows": rows}, f, indent=1)
    print(json.dumps(header), flush=True)
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
