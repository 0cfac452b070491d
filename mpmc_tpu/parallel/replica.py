"""Replica parallelism + parallel tempering over a device mesh.

Rebuild of the reference's entire distributed story (SURVEY.md §2 "MPI
layer" / "Parallel tempering"; §5 "Distributed comm backend"):

- reference: 1 MPI rank = 1 full system replica; here 1 mesh-axis slot =
  1 replica, run under ``shard_map`` so each device advances its own
  Markov chain with zero cross-device traffic between swap attempts;
- reference: ``MPI_Sendrecv`` neighbor temperature swaps every
  ``ptemp_freq`` steps with P = min(1, exp((bi-bj)(Ei-Ej))); here a
  ``lax.ppermute`` exchange of (E, T) between devices + a shared-key
  coin so both partners take the same decision without a second round-trip;
- reference: per-corrtime ``MPI_Reduce`` of observables to rank 0; here
  ``psum``/mean over the replica axis (or host-side reads — replicated
  arrays are globally addressable).

Temperature (not configuration) is what swaps, exactly like the
reference: each chain keeps its state and inherits the partner's T, which
is legal because ``Thermo`` is a pytree input to the jitted step — no
recompilation on swap.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from mpmc_tpu.config import RunConfig, Thermo
from mpmc_tpu.mc import metropolis
from mpmc_tpu.state import Params, SimState

AXIS = "replica"


def geometric_ladder(t_min: float, t_max: float, n: int) -> np.ndarray:
    """Geometric temperature ladder (reference: `parallel_tempering` +
    `max_temperature`, SURVEY.md §2 "Parallel tempering")."""
    if n == 1:
        return np.array([t_min])
    return t_min * (t_max / t_min) ** (np.arange(n) / (n - 1))


def default_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (AXIS,))


def stack_states(state: SimState, n: int, seed: int = 0) -> SimState:
    """Replicate one SimState n times with decorrelated PRNG keys."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    batched = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (n,) + x.shape), state)
    return dataclasses.replace(batched, key=keys)


def stack_thermo(thermo: Thermo, temps, dtype) -> Thermo:
    """Replicate Thermo across replicas with a per-replica T ladder."""
    n = len(temps)
    batched = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (n,) + x.shape), thermo)
    return dataclasses.replace(
        batched, temperature=jnp.asarray(np.asarray(temps), dtype))


def stack_thermo_fugacity(thermo: Thermo, fug_rows, dtype) -> Thermo:
    """Replicate Thermo across replicas with a per-replica FUGACITY
    ladder at one shared temperature (fixed-T grand-canonical expanded
    ensemble — 'pressure parallel tempering').  ``fug_rows`` is [R, S]
    per-replica per-species fugacities, normally one composition ray
    scaled by a geometric ladder."""
    rows = np.asarray(fug_rows, np.float64)
    batched = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (rows.shape[0],) + x.shape),
        thermo)
    return dataclasses.replace(batched,
                               fugacity=jnp.asarray(rows, dtype))


def host_swap_fugacity(fug_rows, n_mols, parity: int,
                       rng) -> Tuple[np.ndarray, int]:
    """Host-side neighbor FUGACITY swap for a fixed-T grand-canonical
    ladder.  With beta shared, the general µVT swap rule
    ln P = (b_i - b_j)(U_i - U_j) + sum_s (N_si - N_sj) ln(f_sj / f_si)
    loses its energy term, and with every species scaled by the same
    ladder ratio the species sum collapses onto the TOTAL movable
    count: ln P = (N_i - N_j) ln(F_j / F_i) with F the row sum.
    Swaps the full per-species fugacity row between partners.  Returns
    (fug_rows [R, S], accepted count)."""
    fugs = np.array(fug_rows, np.float64)
    tot = fugs.sum(axis=1)
    n = np.asarray(n_mols, np.float64)
    n_acc = 0
    for lo in range(parity, fugs.shape[0] - 1, 2):
        ln_p = ((n[lo] - n[lo + 1])
                * np.log(tot[lo + 1] / tot[lo]))
        if np.log(rng.random()) < ln_p:
            fugs[[lo, lo + 1]] = fugs[[lo + 1, lo]]
            n_acc += 1
    return fugs, n_acc


def host_swap(temps, energies, parity: int, rng,
              n_mols=None) -> Tuple[np.ndarray, int]:
    """Host-side neighbor temperature swap for single-device PT (replicas
    batched on one chip; the mesh version in PTRunner uses ppermute).
    Pairs (p, p+1), (p+2, p+3), ...; acceptance
    P = min(1, exp[(b_i - b_j)(E_i - E_j)]) — the reference's rule
    (SURVEY.md §2 "Parallel tempering")."""
    temps = np.array(temps, np.float64)
    energies = np.asarray(energies, np.float64)
    n_acc = 0
    for lo in range(parity, len(temps) - 1, 2):
        ln_p = ((1.0 / temps[lo] - 1.0 / temps[lo + 1])
                * (energies[lo] - energies[lo + 1]))
        if n_mols is not None:
            # grand-canonical ladder: + (N_i - N_j) ln(T_i/T_j)
            # (see _ladder_swap_core)
            ln_p += ((float(n_mols[lo]) - float(n_mols[lo + 1]))
                     * np.log(temps[lo] / temps[lo + 1]))
        if np.log(rng.random()) < ln_p:
            temps[lo], temps[lo + 1] = temps[lo + 1], temps[lo]
            n_acc += 1
    return temps, n_acc


class PTRunner:
    """Compiled parallel-tempering round: chunk of MC steps then one
    neighbor swap attempt.  One replica per mesh slot."""

    def __init__(self, params: Params, cfg: RunConfig, mesh: Mesh,
                 steps_per_round: int):
        self.params, self.cfg, self.mesh = params, cfg, mesh
        self.steps = steps_per_round
        self.R = mesh.shape[AXIS]
        self._step = metropolis.make_step_fn(params, cfg)
        self._compiled = {}

    # ---------------------------------------------------------------- local
    def _chunk(self, state, thermo):
        def body(carry, _):
            st, stats = carry
            return self._step(st, stats, thermo), None
        (st, stats), _ = jax.lax.scan(
            body, (state, metropolis.MCStats.zero()), None,
            length=self.steps)
        return st, stats

    def _swap(self, thermo, energy, shared_key, parity, n_mols=None):
        """Neighbor temperature swap; pairs are (p,p+1),(p+2,p+3),... for
        parity p in {0,1}.  Returns (new_thermo, accepted?).  ``n_mols``
        (µVT ladders): per-replica molecule count for the
        grand-canonical (beta_j/beta_i)^dN swap factor (see
        _ladder_swap_core)."""
        R = self.R
        perm = []
        for lo in range(parity, R - 1, 2):
            perm += [(lo, lo + 1), (lo + 1, lo)]
        if not perm:
            return thermo, jnp.zeros((), bool)
        i = jax.lax.axis_index(AXIS)
        hi = parity + 2 * ((R - parity) // 2)
        in_pair = (i >= parity) & (i < hi)
        left = ((i - parity) % 2) == 0
        partner = jnp.where(left, i + 1, i - 1)
        t_other = jax.lax.ppermute(thermo.temperature, AXIS, perm)
        e_other = jax.lax.ppermute(energy, AXIS, perm)
        # shared coin: both partners fold the same pair id into the same
        # round key -> identical u -> identical decision (the rebuild of
        # the reference's single-rank-decides MPI_Sendrecv protocol).
        pair_lo = jnp.minimum(i, partner)
        u = jax.random.uniform(jax.random.fold_in(shared_key, pair_lo))
        dtype = energy.dtype
        ln_p = ((1.0 / thermo.temperature - 1.0 / t_other)
                * (energy - e_other)).astype(dtype)
        if n_mols is not None:
            n = n_mols.astype(dtype)
            n_other = jax.lax.ppermute(n, AXIS, perm)
            ln_p = ln_p + (n - n_other) * (
                jnp.log(thermo.temperature.astype(dtype))
                - jnp.log(t_other.astype(dtype)))
        accept = in_pair & (jnp.log(u.astype(dtype)) < ln_p)
        new_t = jnp.where(accept, t_other, thermo.temperature)
        return dataclasses.replace(thermo, temperature=new_t), accept

    # --------------------------------------------------------------- global
    def _build(self, parity: int):
        take0 = lambda t: jax.tree_util.tree_map(lambda x: x[0], t)
        add0 = lambda t: jax.tree_util.tree_map(lambda x: x[None], t)

        def local(state_b, thermo_b, shared_key):
            state, thermo = take0(state_b), take0(thermo_b)
            st, stats = self._chunk(state, thermo)
            n_uvt = (st.n_molecules(self.params)
                     if self.cfg.ensemble == "uvt" else None)
            new_thermo, acc = self._swap(
                thermo, st.energy.total, shared_key, parity,
                n_mols=n_uvt)
            # replica-mean observables over the mesh (the MPI_Reduce analog).
            # acc_frac is reduced in-mesh so multi-host callers never
            # have to fetch the replica-sharded acc (non-addressable
            # shards under jax.distributed)
            mean_e = jax.lax.pmean(st.energy.total, AXIS)
            mean_n = jax.lax.pmean(
                st.n_molecules(self.params).astype(st.pos.dtype), AXIS)
            acc_frac = jax.lax.pmean(acc.astype(st.pos.dtype), AXIS)
            return (add0(st), add0(new_thermo), add0(stats), acc[None],
                    mean_e, mean_n, acc_frac)

        spec_r, spec0 = P(AXIS), P()
        # check_vma=False: the MC step's lax.switch mixes replica-varying
        # data with replicated zero-constants per branch, which the static
        # varying-axis analysis can't unify; correctness is unaffected.
        f = jax.shard_map(
            local, mesh=self.mesh,
            in_specs=(spec_r, spec_r, spec0),
            out_specs=(spec_r, spec_r, spec_r, spec_r, spec0, spec0,
                       spec0),
            check_vma=False)
        return jax.jit(f)

    def round(self, states, thermos, shared_key, parity: int):
        """One PT round. states/thermos are replica-batched pytrees
        (leading dim R); returns (states, thermos, stats, swap_accepts,
        mean_energy, mean_N, swap_accept_fraction)."""
        if parity not in self._compiled:
            self._compiled[parity] = self._build(parity)
        return self._compiled[parity](states, thermos, shared_key)


def run_parallel_tempering(params, state, cfg, thermo, temps,
                           n_rounds: int, steps_per_round: int,
                           mesh: Mesh | None = None, seed: int = 0):
    """Drive a full PT run: replicate, alternate even/odd swap rounds.

    Returns (states, thermos, history) where history is a list of dicts
    with per-round replica-mean observables and swap acceptance.
    """
    temps = np.asarray(temps, np.float64)
    if mesh is None:
        mesh = default_mesh(len(temps))
    R = mesh.shape[AXIS]
    if len(temps) != R:
        raise ValueError(f"{len(temps)} temperatures for {R} mesh slots")
    if metropolis.spinflip_active(cfg):
        # per-replica rot_f tables need host-side eigensolve refreshes
        # the fully on-device mesh rounds cannot perform — the
        # host-swap driver (mc/run.run_mc_pt) supports spinflip ladders
        raise ValueError("mesh parallel tempering does not support "
                         "quantum_rotation spinflip moves — use the "
                         "single-chip PT driver (run_mc_pt)")

    state = metropolis.initialize(state, params, cfg, thermo)
    states = stack_states(state, R, seed=seed)
    thermos = stack_thermo(thermo, temps, cfg.jdtype)
    runner = PTRunner(params, cfg, mesh, steps_per_round)
    master = jax.random.PRNGKey(seed + 7)
    history = []
    for r in range(n_rounds):
        shared = jax.random.fold_in(master, r)
        states, thermos, stats, acc, me, mn, accf = runner.round(
            states, thermos, shared, parity=r % 2)
        history.append({
            "round": r,
            "mean_energy": float(me),
            "mean_N": float(mn),
            "swap_acceptance": float(accf),
            "temperatures": np.asarray(thermos.temperature).tolist(),
        })
    return states, thermos, history

# --------------------------------------------------------------------------
# Single-device parallel tempering: on-device ladder swaps
# --------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("parity",))
def ladder_swap(temps, energies, key, parity, n_mols=None):
    """Vectorized on-device neighbor temperature swap (single-chip PT).

    Same physics as ``host_swap``/``PTRunner._swap`` (SURVEY.md §2
    "Parallel tempering": pairs (p,p+1),(p+2,p+3),... for parity p,
    P = min(1, exp[(b_i - b_j)(E_i - E_j)]), shared coin per pair) but
    computed entirely on device so a PT round needs ZERO host syncs
    (a blocking device-to-host fetch per round would otherwise bound
    swap-heavy PT rounds).

    Returns (per-replica new temperatures as a tuple of scalars so the
    caller can rebuild per-replica ``Thermo`` without eager slicing,
    number of accepted swaps).  ``energies`` may be per-replica scalars
    or EnergyBreakdown pytrees — the .total sum is taken IN-JIT (an
    eager .total costs 7 dispatches per replica per round)."""
    temps = jnp.stack(list(temps))
    energies = jnp.stack([e.total if hasattr(e, "total") else e
                          for e in energies]).astype(temps.dtype)
    n = (jnp.stack(list(n_mols)) if n_mols is not None else None)
    new_t, n_acc = _ladder_swap_core(temps, energies, key, parity,
                                     n_mols=n)
    R = temps.shape[0]
    return tuple(new_t[r] for r in range(R)), n_acc


@functools.partial(jax.jit, static_argnames=("sp_ids",))
def movable_counts_per_species(mol_alive, mol_frozen, mol_species,
                               sp_ids):
    """Per-replica per-species alive movable counts [R, S] for the
    fugacity-ladder swap (``sp_ids`` = cfg.insert_species)."""
    mov = mol_alive & ~mol_frozen
    return jnp.stack([jnp.sum(mov & (mol_species == s), axis=-1)
                      for s in sp_ids], axis=-1)


@functools.partial(jax.jit, static_argnames=("parity", "sp_ids"))
def ladder_swap_fugacity_batched(fug, counts, key, parity, sp_ids):
    """On-device neighbor FUGACITY swap for a fixed-T grand-canonical
    ladder (the pt_fugacity path, run.run_mc_pt_fug).  General
    per-species rule: with beta shared, exchanging configurations
    between rungs i and j accepts with
        ln P = sum_s (N_si - N_sj) ln(f_sj / f_si)
    (host_swap_fugacity's total-N rule is the common-composition-ray
    special case; the ATM2K_A3*V factors cancel in the ratio so raw
    atm fugacities are fine).  ``fug`` [R, n_species] full thermo
    fugacity rows — swapped whole; ``counts`` [R, S] per-replica alive
    counts of each insertable species (``sp_ids`` column order);
    shared coin per pair exactly like _ladder_swap_core.  Returns
    ([R, n_species] new rows, accepted count)."""
    fug = jnp.asarray(fug)
    R = fug.shape[0]
    i = jnp.arange(R)
    hi = parity + 2 * ((R - parity) // 2)
    in_pair = (i >= parity) & (i < hi)
    left = in_pair & (((i - parity) % 2) == 0)
    partner = jnp.where(in_pair, jnp.where(left, i + 1, i - 1), i)
    cols = jnp.asarray(sp_ids)
    lnf = jnp.log(jnp.maximum(fug[:, cols], 1e-300))
    n = counts.astype(fug.dtype)
    ln_p = jnp.sum((n - n[partner]) * (lnf[partner] - lnf), axis=-1)
    pair_lo = jnp.minimum(i, partner)
    u = jax.random.uniform(key, (R,), fug.dtype)[pair_lo]
    accept = in_pair & (jnp.log(jnp.maximum(u, 1e-300)) < ln_p)
    new_f = jnp.where(accept[:, None], fug[partner], fug)
    n_acc = jnp.sum(accept.astype(jnp.int32)) // 2
    return new_f, n_acc


@jax.jit
def movable_counts(mol_alive, mol_frozen, mol_species):
    """Per-replica alive movable-molecule counts [R] for the µVT ladder
    swap's grand-canonical (beta_j/beta_i)^dN factor."""
    return jnp.sum(mol_alive & ~mol_frozen & (mol_species >= 0),
                   axis=-1)


@functools.partial(jax.jit, static_argnames=("parity",))
def ladder_swap_batched(temps, energy, key, parity, n_mols=None):
    """Array-interface ladder swap for the stacked-replica (multi-chain)
    PT path: ``temps`` [R], ``energy`` a batched EnergyBreakdown (leaf
    shape [R]) or an [R] array.  Returns ([R] new temps, accepts)."""
    temps = jnp.asarray(temps)
    e = energy.total if hasattr(energy, "total") else jnp.asarray(energy)
    return _ladder_swap_core(temps, e.astype(temps.dtype), key, parity,
                             n_mols=n_mols)


def _ladder_swap_core(temps, energies, key, parity, n_mols=None):
    R = temps.shape[0]
    i = jnp.arange(R)
    hi = parity + 2 * ((R - parity) // 2)
    in_pair = (i >= parity) & (i < hi)
    left = in_pair & (((i - parity) % 2) == 0)
    partner = jnp.where(in_pair, jnp.where(left, i + 1, i - 1), i)
    t_other = temps[partner]
    e_other = energies[partner]
    # shared coin: both partners read the pair-lo lane -> same decision
    pair_lo = jnp.minimum(i, partner)
    u = jax.random.uniform(key, (R,), temps.dtype)[pair_lo]
    ln_p = (1.0 / temps - 1.0 / t_other) * (energies - e_other)
    if n_mols is not None:
        # grand-canonical ladder (same fugacity, different T): the
        # configurational weight is (beta f V)^N e^{-beta U}/N!
        # (b_insert uses beta f V/(N+1)), so a temperature swap also
        # carries (beta_j/beta_i)^{N_i - N_j}
        #   = exp[(N_i - N_j) ln(T_i/T_j)]
        # — symmetric between partners.  Without it every µVT swap
        # decision violates detailed balance in N.
        n = jnp.asarray(n_mols).astype(temps.dtype)
        ln_p = ln_p + (n - n[partner]) * (jnp.log(temps)
                                          - jnp.log(t_other))
    accept = in_pair & (jnp.log(jnp.maximum(u, 1e-300)) < ln_p)
    new_t = jnp.where(accept, t_other, temps)
    n_acc = jnp.sum(accept.astype(jnp.int32)) // 2
    return new_t, n_acc
