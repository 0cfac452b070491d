"""Benchmarks: MC steps/sec of the scan-path MC step on a GPU.

    python bench.py

Rows (one JSON line each; the headline prints LAST):

    1. lj_nvt          NVT Lennard-Jones-only fluid, 10k atoms, C=128
    2. nvt_ewald       NVT, charged framework + H2 sorbate, C=128
    3. polar_gcmc      polarizable GCMC (Thole SCF), single chain: plain
                       Metropolis and delayed acceptance
    4. gcmc (headline) GCMC H2-in-MOF, LJ + Ewald, 128 batched chains

Every row names the device it ran on (platform, device_kind, device
count) and the card's name and power limit as nvidia-smi reports them.
Needs a GPU: on any other backend it exits non-zero before measuring.
Any exception exits non-zero.  ``vs_baseline`` is computed against the
single-core-C algorithmic estimates in BASELINE.md.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# single-core-C estimates per config (BASELINE.md: O(N^2) resum per step;
# conservative fast end of each band)
BASELINES = {
    "lj_nvt": 100.0,       # LJ-only: cheapest per-pair kernel
    "nvt_ewald": 10.0,     # + erfc/exclusion/recip bookkeeping
    "gcmc": 10.0,
    "polar_gcmc": 1.0,     # + Thole SCF iterations dominate
}


def _time_batched(state, params, cfg, thermo, n_chains, chunk, n_chunks=3):
    import jax

    from mpmc_tpu.mc import metropolis
    from mpmc_tpu.parallel import multichain

    state = metropolis.initialize(state, params, cfg, thermo)
    states = multichain.stack_states(state, n_chains)
    states = multichain.initialize_batched(states, params, cfg, thermo)
    states, _ = multichain.run_chunk_batched(states, params, cfg, thermo,
                                             chunk)
    jax.block_until_ready(states.energy.rd)
    t0 = time.perf_counter()
    for _ in range(n_chunks):
        states, _ = multichain.run_chunk_batched(states, params, cfg,
                                                 thermo, chunk)
    jax.block_until_ready(states.energy.rd)
    wall = time.perf_counter() - t0
    return n_chunks * chunk * n_chains / wall


def bench_gcmc():
    """Headline: ~9.3k-atom framework + up to 512 H2 (x3 sites), C=128
    independent GCMC chains batched on one device."""
    from mpmc_tpu.models import systems

    params, state, cfg, thermo = systems.mof_h2_gcmc(
        n_side=21, spacing=4.0, n_h2=256, capacity=512,
        temperature=77.0, pressure=1.0)
    sps = _time_batched(state, params, cfg, thermo, n_chains=128,
                        chunk=128, n_chunks=4)
    return {"metric": "agg_mc_steps_per_sec_10k_mof_h2_gcmc_ewald",
            "value": round(sps, 2), "unit": "steps/s",
            "vs_baseline": round(sps / BASELINES["gcmc"], 2),
            "method": "batched_scan_c128"}


def bench_lj_nvt():
    """BASELINE config 1: neutral LJ fluid, 10k atoms, NVT, C=128
    batched chains."""
    from mpmc_tpu.models import systems

    params, state, cfg, thermo = systems.lj_fluid(n=10000)
    sps = _time_batched(state, params, cfg, thermo, n_chains=128,
                        chunk=64)
    return {"metric": "agg_mc_steps_per_sec_10k_lj_nvt",
            "value": round(sps, 2), "unit": "steps/s",
            "vs_baseline": round(sps / BASELINES["lj_nvt"], 2),
            "method": "batched_scan_c128"}


def bench_nvt_ewald():
    """BASELINE config 2: charged rigid framework + point-charge
    sorbates, NVT (displace/rotate only), C=128 batched chains."""
    from mpmc_tpu.models import systems

    params, state, cfg, thermo = systems.mof_h2_gcmc(
        n_side=21, spacing=4.0, n_h2=256, capacity=512)
    cfg = dataclasses.replace(cfg, ensemble="nvt")
    sps = _time_batched(state, params, cfg, thermo, n_chains=128,
                        chunk=64)
    return {"metric": "agg_mc_steps_per_sec_10k_mof_h2_nvt_ewald",
            "value": round(sps, 2), "unit": "steps/s",
            "vs_baseline": round(sps / BASELINES["nvt_ewald"], 2),
            "method": "batched_scan_c128"}


def bench_polar_gcmc():
    """BASELINE config 4: polarizable GCMC (Thole dipole SCF), single
    chain; races plain Metropolis against delayed acceptance (same
    stationary distribution, tests/test_thole.py)."""
    import jax

    from mpmc_tpu.mc import metropolis
    from mpmc_tpu.models import systems

    params, state, cfg, thermo = systems.mof_h2_gcmc(
        n_side=21, spacing=4.0, n_h2=256, capacity=512,
        polarization=True)
    state = metropolis.initialize(state, params, cfg, thermo)
    chunk = 64

    def time_cfg(c):
        st, _ = metropolis.run_chunk(state, params, c, thermo, chunk)
        jax.block_until_ready(st.energy.rd)
        t0 = time.perf_counter()
        for _ in range(3):
            st, _ = metropolis.run_chunk(st, params, c, thermo, chunk)
        jax.block_until_ready(st.energy.rd)
        return 3 * chunk / (time.perf_counter() - t0)

    sps, method = max(
        (time_cfg(cfg), "metropolis"),
        (time_cfg(dataclasses.replace(cfg, polar_delayed=True)),
         "delayed_acceptance"))
    return {"metric": "mc_steps_per_sec_10k_mof_h2_polar_gcmc_thole_scf",
            "value": round(sps, 2), "unit": "steps/s",
            "vs_baseline": round(sps / BASELINES["polar_gcmc"], 2),
            "method": method}


def _device_fields():
    import jax
    dev = jax.devices()[0]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0].strip()
    return {"platform": dev.platform, "device_kind": dev.device_kind,
            "device_count": len(jax.devices()), "card": card}


def main():
    import jax

    from mpmc_tpu.utils import compile_cache
    compile_cache.enable()
    if jax.devices()[0].platform != "gpu":
        sys.exit(f"bench.py measures on a GPU; JAX found "
                 f"{jax.devices()[0].platform}")
    dev = _device_fields()
    results = []
    for fn in (bench_lj_nvt, bench_nvt_ewald, bench_polar_gcmc,
               bench_gcmc):
        row = dict(fn(), **dev)
        results.append(row)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
