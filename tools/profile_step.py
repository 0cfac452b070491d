"""Per-component step profiler: where does one MC step's time go?

Times the energy-path building blocks (full pair pass, Ewald reciprocal,
static field, SCF matvec, warm SCF solve) and the end-to-end step/chunk
rates on the current backend (host fetches to synchronise, warm-up with
identical static arguments).

    python tools/profile_step.py [--cpu] [--n-side 21] [--chains 256]
        [--polar]
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax
import numpy as np


def timed(fn, *args, n=10):
    r = fn(*args)
    np.asarray(jax.tree_util.tree_leaves(r)[0])
    t0 = time.perf_counter()
    for _ in range(n):
        r = fn(*args)
    np.asarray(jax.tree_util.tree_leaves(r)[0])
    return (time.perf_counter() - t0) / n


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--n-side", type=int, default=21)
    ap.add_argument("--n-h2", type=int, default=256)
    ap.add_argument("--capacity", type=int, default=512)
    ap.add_argument("--chains", type=int, default=256)
    ap.add_argument("--polar", action="store_true")
    args = ap.parse_args(argv)
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp

    from mpmc_tpu.mc import metropolis
    from mpmc_tpu.models import systems
    from mpmc_tpu.ops import ewald, pairs, thole
    from mpmc_tpu.parallel import multichain

    params, state, cfg, thermo = systems.mof_h2_gcmc(
        n_side=args.n_side, n_h2=args.n_h2, capacity=args.capacity,
        polarization=args.polar)
    state = metropolis.initialize(state, params, cfg, thermo)
    N = state.pos.shape[0]
    print(f"backend={jax.default_backend()}  atoms={N}  "
          f"polar={args.polar}")

    alive = state.atom_alive(params)
    rc = pairs.derived_cutoff(state.box, cfg)
    alpha = pairs.derived_alpha(rc, cfg)

    pp = jax.jit(lambda p: pairs.pair_pass(
        p, state.box, alive, params, cfg, thermo.temperature,
        split_frozen=True))
    print(f"full pair pass      : {timed(pp, state.pos)*1e3:9.2f} ms")

    re = jax.jit(lambda p: ewald.recip_energy(
        p, params.charge, alive, state.box, alpha, cfg.ewald_kmax))
    print(f"ewald reciprocal    : {timed(re, state.pos)*1e3:9.2f} ms")

    mp = jax.jit(lambda p: pairs.mol_pair_pass(
        p, state.box, alive, params, cfg, thermo.temperature,
        jnp.asarray(1)))
    print(f"delta pass (1 mol)  : {timed(mp, state.pos)*1e3:9.2f} ms")

    if args.polar:
        sf = jax.jit(lambda p: thole.static_field(
            p, state.box, alive, params, cfg))
        e0 = sf(state.pos)
        print(f"static field        : {timed(sf, state.pos)*1e3:9.2f} ms")
        mv = jax.jit(lambda m: thole.dipole_matvec(
            state.pos, state.box, alive, params, cfg, m))
        print(f"SCF matvec          : {timed(mv, e0)*1e3:9.2f} ms")
        scf = jax.jit(lambda e, m0: thole.solve_scf(
            state.pos, state.box, alive, params, cfg, e, m0))
        mu, _, _ = scf(e0, jnp.zeros_like(e0))
        print(f"SCF solve (warm)    : {timed(scf, e0, mu)*1e3:9.2f} ms")

    # end-to-end single chain
    st, _ = metropolis.run_chunk(state, params, cfg, thermo, 64)
    np.asarray(st.energy.rd)
    t0 = time.perf_counter()
    st, _ = metropolis.run_chunk(st, params, cfg, thermo, 64)
    np.asarray(st.energy.rd)
    dt = (time.perf_counter() - t0) / 64
    print(f"MC step (1 chain)   : {dt*1e3:9.2f} ms  ({1/dt:8.0f} steps/s)")

    if args.chains > 1:
        states = multichain.stack_states(state, args.chains)
        sts, _ = multichain.run_chunk_batched(states, params, cfg, thermo,
                                              64)
        np.asarray(sts.energy.rd)
        t0 = time.perf_counter()
        sts, _ = multichain.run_chunk_batched(sts, params, cfg, thermo, 64)
        np.asarray(sts.energy.rd)
        dt = (time.perf_counter() - t0) / 64
        print(f"MC step ({args.chains:4d} ch)  : {dt*1e3:9.2f} ms  "
              f"({args.chains/dt:8.0f} agg steps/s)")


if __name__ == "__main__":
    main()
