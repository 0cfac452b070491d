"""Smoke run of the MC main path on one GPU — the quickest proof that the
system still starts and computes correctly on the card.

    python chip_smoke.py           # one card, the phases below
    python chip_smoke.py --four    # only the 4-card PT ladder check

Phases, in order (a failure in any phase exits non-zero):

1. card-only tests: ``pytest -m gpu`` in a child process, before this
   process touches the card (one JAX process per card);
2. parity: the five golden configurations of tests/test_golden.py in
   float64 on the card, against their pinned per-term energies;
3. headline deck: the 10.8k-atom MOF+H2 µVT Ewald system written out as
   a PQR + deck and run through the CLI (``mpmc_tpu.__main__.main``) in
   float32 for a few corrtime blocks; every block's carried energy is
   checked against the refresh, and the final state against a fresh
   ``metropolis.initialize``;
4. batched chains: the same system with ``chains 128``;
5. polarization: a polar µVT deck on the same system with ``cutoff 14``
   through the CLI, then the Thole matvec kernel against the plain
   float64 jnp reference at 10.8k and 53.7k atoms.

``--four`` runs an 8-replica parallel-tempering ladder of the 10.8k µVT
system spread over 4 cards (``chain_devices 4``) and the same ladder,
seeds and rounds on one card, and compares them.

Prints, before the last line, the card's name and power limit, each
phase's compile and steady seconds, and the peak device memory; the
last line is ``{"ok": true, "device": {...}}``.  Needs a GPU: without
one (or outside a checkout of the repo) it exits non-zero and prints no
result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import xml.etree.ElementTree as ET

REPO = os.path.dirname(os.path.abspath(__file__))

# Energy bookkeeping bound in float32, per term, in K: the bound of the
# repo's own f32 drift tests (carried per-move deltas vs a from-scratch
# recompute: rel 2e-4, abs 5e-2 K).  The relative part is taken of the
# term's largest magnitude across the batch: a chain that empties sums
# its insert/delete deltas back to ~0, and their rounding (a few ulps of
# one molecule's self energy) is what remains.
F32_DRIFT_REL = 2e-4
F32_DRIFT_ABS = 5e-2
# float64 parity bound of tests/test_golden.py
GOLDEN_REL, GOLDEN_ABS = 1e-10, 1e-9
# Thole matvec vs the float64 jnp reference, relative L2 of the field:
# the kernel and the reference evaluate the same f32 pair formulas
# (contractions kept out of TF32 by the float32 matmul precision), so
# only the summation order differs.
MATVEC_REL_L2 = 1e-5

TERMS = ("rd", "lrc", "es_real", "es_recip", "es_self", "es_excl",
         "polar", "vdw")


class SmokeFailure(Exception):
    pass


def fail(msg):
    raise SmokeFailure(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi found no GPU: {out.stderr.strip()[:200]}")
    return out.stdout.strip().splitlines()


def preflight():
    if not os.path.isdir(os.path.join(REPO, "mpmc_tpu")):
        sys.exit("chip_smoke.py must run from a checkout of the repo "
                 "(mpmc_tpu/ not found beside it)")
    if shutil.which("nvidia-smi") is None:
        sys.exit("no GPU: nvidia-smi not found")
    try:
        return card_line()
    except (SmokeFailure, OSError, subprocess.SubprocessError) as e:
        sys.exit(str(e))


# --------------------------------------------------------------------------
# phase 1: card-only tests, in a child process
# --------------------------------------------------------------------------

def phase_gpu_tests(report):
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        xml = os.path.join(tmp, "gpu.xml")
        env = dict(os.environ, MPMC_TEST_PLATFORM="gpu")
        proc = subprocess.run(
            [sys.executable, "-m", "pytest", "tests", "-m", "gpu", "-q",
             "-p", "no:cacheprovider", f"--junitxml={xml}"],
            cwd=REPO, env=env, capture_output=True, text=True,
            timeout=900)
        print(proc.stdout[-3000:], flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-3000:], file=sys.stderr)
            fail(f"pytest -m gpu exited {proc.returncode}")
        suite = ET.parse(xml).getroot()
        suite = suite if suite.tag == "testsuite" else suite[0]
        n = {k: int(suite.get(k, 0))
             for k in ("tests", "failures", "errors", "skipped")}
    if n["tests"] == 0 or n["failures"] or n["errors"] or n["skipped"]:
        fail(f"card-only tests incomplete: {n}")
    report("gpu_tests", time.perf_counter() - t0, None,
           f"{n['tests']} passed")


# --------------------------------------------------------------------------
# helpers for the in-process phases
# --------------------------------------------------------------------------

@contextlib.contextmanager
def spy(module, name, calls):
    """Wrap module.name so every call appends (args, kwargs, result,
    t_done) to ``calls`` — read-only instrumentation of the run loop."""
    import jax
    orig = getattr(module, name)

    def wrapped(*args, **kwargs):
        out = orig(*args, **kwargs)
        jax.block_until_ready(out)
        calls.append((args, kwargs, out, time.perf_counter()))
        return out

    # traced callers reach for the un-jitted body (fn.__wrapped__)
    wrapped.__wrapped__ = getattr(orig, "__wrapped__", orig)
    setattr(module, name, wrapped)
    try:
        yield orig
    finally:
        setattr(module, name, orig)


def check_drift(carried, fresh, label):
    """Per-term f32 bookkeeping check (arrays broadcast over chains)."""
    import numpy as np
    worst = 0.0
    for term in TERMS:
        a = np.asarray(getattr(carried, term), np.float64)
        b = np.asarray(getattr(fresh, term), np.float64)
        if not (np.all(np.isfinite(a)) and np.all(np.isfinite(b))):
            fail(f"{label}: non-finite {term}")
        scale = max(float(np.max(np.abs(a))), float(np.max(np.abs(b))))
        excess = np.abs(a - b) - (F32_DRIFT_ABS + F32_DRIFT_REL * scale)
        if np.any(excess > 0):
            fail(f"{label}: {term} carried {a} vs fresh {b} exceeds "
                 f"rel {F32_DRIFT_REL} + abs {F32_DRIFT_ABS} K")
        worst = max(worst, float(np.max(np.abs(a - b))))
    return worst


def write_system(path, n_side, n_h2, capacity, polarization=False):
    """The bench system (models.systems.mof_h2_gcmc) as a PQR file;
    returns (box edge, the builder's (params, state, cfg, thermo))."""
    from mpmc_tpu.io import pqr as pqr_io
    from mpmc_tpu.models import systems
    built = systems.mof_h2_gcmc(
        n_side=n_side, spacing=4.0, n_h2=n_h2, capacity=capacity,
        temperature=77.0, pressure=1.0, polarization=polarization,
        dtype="float32")
    params, state = built[0], built[1]
    pqr_io.write_state(path, params, state, ["H2"])
    return float(n_side * 4.0), built


def deck(pqr, box_len, numsteps, corrtime, extra=""):
    return f"""job_name chip_smoke
ensemble uvt
numsteps {numsteps}
corrtime {corrtime}
seed 11
temperature 77
pressure 1.0
basis1 {box_len} 0 0
basis2 0 {box_len} 0
basis3 0 0 {box_len}
insert_probability 0.5
move_factor 1.0
rot_factor 3.14159
cavity_autoreject_absolute 1.0
allow_charged_cell on
max_molecules 256
pqr_input {pqr}
{extra}
"""


def run_cli(tmp, name, text):
    from mpmc_tpu import __main__ as cli
    path = os.path.join(tmp, f"{name}.inp")
    with open(path, "w") as f:
        f.write(text)
    cli.main([path])


def block_times(calls, t0):
    """(compile + first block seconds, steady seconds per block).  The
    steady figure is the median block: the second block also carries
    the first calls of the per-block host path (observables, slices),
    which compile."""
    import numpy as np
    ts = [c[3] for c in calls]
    first = ts[0] - t0
    steady = float(np.median(np.diff(ts))) if len(ts) > 1 else None
    return first, steady


# --------------------------------------------------------------------------
# phase 2: float64 parity of the golden configurations
# --------------------------------------------------------------------------

def phase_parity(report):
    import jax
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import test_golden
    from mpmc_tpu.ops import energy as energy_mod
    t0 = time.perf_counter()
    for name in sorted(test_golden.GOLDEN):
        params, state, cfg, thermo = test_golden._build(name)
        if cfg.dtype != "float64":
            fail(f"golden {name} is not float64")
        e, _ = energy_mod.total_energy(state.pos, state.box,
                                       state.mol_alive, params, cfg,
                                       thermo)
        jax.block_until_ready(e)
        if e.rd.devices().pop().platform != "gpu":
            fail("golden parity did not run on the GPU")
        for term, want in test_golden.GOLDEN[name].items():
            got = float(getattr(e, term))
            if abs(got - want) > GOLDEN_ABS + GOLDEN_REL * abs(want):
                fail(f"golden {name}.{term}: {got!r} vs {want!r}")
        print(f"parity {name}: all terms within rel {GOLDEN_REL} "
              f"abs {GOLDEN_ABS}", flush=True)
    report("parity_f64", time.perf_counter() - t0, None,
           f"{len(test_golden.GOLDEN)} golden configs")


# --------------------------------------------------------------------------
# phase 3: the headline deck through the CLI
# --------------------------------------------------------------------------

def phase_headline(tmp, report):
    from mpmc_tpu.mc import metropolis
    pqr = os.path.join(tmp, "mof_h2.pqr")
    box_len, _ = write_system(pqr, 21, 256, 512)
    calls = []
    t0 = time.perf_counter()
    with spy(metropolis, "initialize", calls) as init_orig:
        run_cli(tmp, "headline", deck(pqr, box_len, 1000, 250))
    blocks = [c for c in calls if c[1].get("frozen_rows") is not None]
    if len(blocks) != 4:
        fail(f"headline deck: expected 4 refreshes, saw {len(blocks)}")
    worst = 0.0
    for k, (args, _, out, _) in enumerate(blocks):
        worst = max(worst, check_drift(args[0].energy, out.energy,
                                       f"headline block {k}"))
    args = blocks[-1][0]
    fresh = init_orig(*args)         # full refresh, no frozen reuse
    worst = max(worst, check_drift(args[0].energy, fresh.energy,
                                   "headline final vs fresh initialize"))
    n_atoms = int(args[1].n_atoms_max)
    first, steady = block_times(blocks, t0)
    report("headline_uvt_ewald_cli", first, steady,
           f"{n_atoms} atom slots, 4 blocks x 250 steps, worst carried-"
           f"vs-fresh term |dE| {worst:.3g} K "
           f"(bound rel {F32_DRIFT_REL} + abs {F32_DRIFT_ABS} K)")
    return pqr, box_len


# --------------------------------------------------------------------------
# phase 4: 128 batched chains
# --------------------------------------------------------------------------

def phase_chains(tmp, pqr, box_len, report):
    import numpy as np

    from mpmc_tpu.parallel import multichain
    calls = []
    t0 = time.perf_counter()
    with spy(multichain, "initialize_batched", calls):
        run_cli(tmp, "chains", deck(pqr, box_len, 400, 100,
                                    "chains 128"))
    blocks = [c for c in calls if c[1].get("frozen_rows") is not None]
    if len(blocks) != 4:
        fail(f"chains: expected 4 refreshes, saw {len(blocks)}")
    worst = 0.0
    for k, (args, _, out, _) in enumerate(blocks):
        if args[0].pos.shape[0] != 128:
            fail("chains: batch is not 128 chains")
        worst = max(worst, check_drift(args[0].energy, out.energy,
                                       f"chains block {k}"))
    n = np.asarray(blocks[-1][2].mol_alive).sum(axis=1)
    first, steady = block_times(blocks, t0)
    report("chains_128_cli", first, steady,
           f"4 blocks x 100 steps x 128 chains, N per chain "
           f"{int(n.min())}..{int(n.max())}, worst |dE| {worst:.3g} K")


# --------------------------------------------------------------------------
# phase 5: polarization (rc = 14 A) + matvec vs reference
# --------------------------------------------------------------------------

def matvec_check(n_side, n_h2, capacity, rc):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mpmc_tpu.models import systems
    from mpmc_tpu.ops import pairs, thole
    from mpmc_tpu.ops.pallas import thole_kernel as tk
    params, state, cfg, _ = systems.mof_h2_gcmc(
        n_side=n_side, spacing=4.0, n_h2=n_h2, capacity=capacity,
        polarization=True, dtype="float32")
    cfg = dataclasses.replace(cfg, cutoff=rc)
    alive = state.atom_alive(params)
    pol_ok = alive & (params.polar > 0)
    rcj = pairs.derived_cutoff(state.box, cfg)
    lam = jnp.asarray(cfg.polar_damp, jnp.float32)
    mu = jnp.where(pol_ok[:, None], jax.random.normal(
        jax.random.PRNGKey(3), state.pos.shape, jnp.float32) * 0.05, 0.0)
    ref = np.asarray(thole.dipole_matvec(
        state.pos.astype(jnp.float64), state.box.astype(jnp.float64),
        alive, params, dataclasses.replace(cfg, dtype="float64"),
        mu.astype(jnp.float64)))
    dense = tk.dipole_field(state.pos, state.box, pol_ok, mu,
                            params.mol_id, rcj, lam, cfg.polar_damp_type,
                            ortho=True)
    perm, inv = thole.cull_perm(state.pos, state.box, pol_ok, rcj)
    pos_s, ok_s, _, mol_s = thole._sorted_sites(perm, state.pos, pol_ok,
                                                params)
    n_pad, _, _ = tk.grid_shape(pos_s.shape[0])
    visit = thole.cull_visit(pos_s, ok_s, state.box, rcj, tk.BI, tk.BJ,
                             n_pad)
    culled = tk.dipole_field(pos_s, state.box, ok_s, mu[perm], mol_s, rcj,
                             lam, cfg.polar_damp_type, ortho=True,
                             visit=visit)[inv]
    errs = []
    for label, got in (("dense", dense), ("culled", culled)):
        err = (np.linalg.norm(np.asarray(got, np.float64) - ref)
               / np.linalg.norm(ref))
        if not err <= MATVEC_REL_L2:
            fail(f"matvec {label} at {state.pos.shape[0]} sites: rel L2 "
                 f"{err:.3g} > {MATVEC_REL_L2}")
        errs.append(f"{label} {err:.3g}")
    prec = jax.config.jax_default_matmul_precision
    return (f"{state.pos.shape[0]} sites rc {float(rcj):g}: f32 kernel "
            f"(matmul precision {prec}) rel L2 vs f64 jnp reference "
            + ", ".join(errs)
            + f" (bound {MATVEC_REL_L2}, visit fraction "
              f"{float(np.asarray(visit).mean()):.3f})")


def phase_polar(tmp, report):
    import jax

    from mpmc_tpu.mc import metropolis
    from mpmc_tpu.ops import route
    pqr = os.path.join(tmp, "mof_h2_polar.pqr")
    box_len, built = write_system(pqr, 21, 256, 512, polarization=True)
    cfg = dataclasses.replace(built[2], cutoff=14.0)
    if not route.thole_kernel(cfg):
        fail("the Thole kernel route is off on the GPU")
    calls = []
    t0 = time.perf_counter()
    with spy(metropolis, "initialize", calls):
        run_cli(tmp, "polar", deck(pqr, box_len, 96, 32,
                                   "cutoff 14\npolarization on\n"
                                   "polar_precision 1e-6"))
    blocks = [c for c in calls if c[1].get("frozen_rows") is not None]
    if len(blocks) != 3:
        fail(f"polar deck: expected 3 refreshes, saw {len(blocks)}")
    worst = 0.0
    for k, (args, _, out, _) in enumerate(blocks):
        worst = max(worst, check_drift(args[0].energy, out.energy,
                                       f"polar block {k}"))
    first, steady = block_times(blocks, t0)
    report("polar_rc14_cli", first, steady,
           f"3 blocks x 32 steps, worst |dE| {worst:.3g} K")
    t0 = time.perf_counter()
    lines = [matvec_check(21, 256, 512, 14.0),
             matvec_check(37, 512, 1024, 14.0)]
    jax.clear_caches()
    for ln in lines:
        print("matvec " + ln, flush=True)
    report("matvec_vs_reference", time.perf_counter() - t0, None,
           "; ".join(lines))


# --------------------------------------------------------------------------
# --four: PT ladder over 4 cards vs 1 card
# --------------------------------------------------------------------------

def phase_four(tmp, report):
    import jax
    import numpy as np

    from mpmc_tpu.parallel import multichain, replica
    if len(jax.devices()) < 4:
        fail(f"--four needs 4 GPUs, JAX sees {len(jax.devices())}")
    pqr = os.path.join(tmp, "mof_h2.pqr")
    box_len, _ = write_system(pqr, 21, 256, 512)
    base = deck(pqr, box_len, 800, 200,
                "parallel_tempering on\nn_replicas 8\n"
                "max_temperature 160\nptemp_freq 50")
    runs = {}
    for label, extra in (("1card", ""), ("4cards", "chain_devices 4\n")):
        swaps, refresh = [], []
        t0 = time.perf_counter()
        with spy(replica, "host_swap", swaps), \
                spy(multichain, "initialize_batched", refresh), \
                spy(multichain, "initialize_batched_sharded", refresh):
            run_cli(tmp, f"pt_{label}", base + extra)
        blocks = [c for c in refresh
                  if c[1].get("frozen_rows") is not None]
        devs = set()
        for c in blocks:
            devs |= {d.id for d in c[2].pos.devices()}
        temps = [np.asarray(c[2][0]) for c in swaps]
        gaps = np.diff([c[3] for c in swaps])
        # the refresh closes each block: its time is from the block's
        # last swap to the refresh's completion
        t_swaps = np.array([c[3] for c in swaps])
        refresh_s = [c[3] - t_swaps[t_swaps < c[3]].max() for c in blocks]
        first, steady = block_times(blocks, t0)
        runs[label] = (temps, [c[2].energy for c in blocks], devs)
        report(f"pt8_{label}", first, steady,
               f"{len(swaps)} swap rounds, median {np.median(gaps):.3f} "
               f"s between swaps, last refresh {refresh_s[-1]:.3f} s, "
               f"replica states on devices {sorted(devs)}")
    t1, e1, d1 = runs["1card"]
    t4, e4, d4 = runs["4cards"]
    if d4 != {d.id for d in jax.devices()[:4]}:
        fail(f"4-card ladder placed its replicas on devices {sorted(d4)}")
    if len(t1) != len(t4) or any(not np.array_equal(a, b)
                                 for a, b in zip(t1, t4)):
        fail("swapped temperatures differ between 1 and 4 cards")
    # same ladder, same seeds: the energies may differ only by f32
    # reduction order (another device count can compile other fusions),
    # so they are held to the script's f32 bound, per term and replica
    worst = max(check_drift(a, b, f"4-card vs 1-card block {k}")
                for k, (a, b) in enumerate(zip(e1, e4)))
    exact = all(np.array_equal(np.asarray(x), np.asarray(y))
                for a, b in zip(e1, e4)
                for x, y in zip(jax.tree_util.tree_leaves(a),
                                jax.tree_util.tree_leaves(b)))
    print(f"four-card PT: swapped temperatures identical over "
          f"{len(t1)} rounds; replica energies "
          f"{'bit-exact' if exact else 'not bit-exact'}, worst per-term "
          f"|dE| {worst:.3g} K (bound rel {F32_DRIFT_REL} + abs "
          f"{F32_DRIFT_ABS} K)", flush=True)


# --------------------------------------------------------------------------

def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card parallel-tempering check")
    args = ap.parse_args()
    cards = preflight()
    card = cards[0].strip()
    sys.path.insert(0, REPO)
    rows = []

    def report(phase, compile_s, steady_s, note):
        rows.append(phase)
        steady = "n/a" if steady_s is None else f"{steady_s:.3f}"
        print(f"phase {phase} [{card}]: compile+first {compile_s:.2f} s, "
              f"steady {steady} s/block; {note}", flush=True)

    try:
        if not args.four:
            phase_gpu_tests(report)
        import jax
        from mpmc_tpu.utils import compile_cache
        compile_cache.enable()
        jax.config.update("jax_enable_x64", True)
        dev = jax.devices()[0]
        if dev.platform != "gpu":
            fail(f"JAX found no GPU (platform {dev.platform})")
        with tempfile.TemporaryDirectory() as tmp:
            if args.four:
                phase_four(tmp, report)
            else:
                phase_parity(report)
                pqr, box_len = phase_headline(tmp, report)
                phase_chains(tmp, pqr, box_len, report)
                phase_polar(tmp, report)
        peak = max(d.memory_stats().get("peak_bytes_in_use", 0)
                   for d in jax.local_devices())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
    print(f"card: {', '.join(c.strip() for c in cards)}")
    print(f"peak_bytes_in_use: {peak}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
