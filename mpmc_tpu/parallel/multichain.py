"""Many independent MC chains per chip via vmap.

The reference's only throughput axis is replicas (1 MPI rank = 1 chain,
SURVEY.md §2 "MPI layer").  Here the same design maps *within* a device:
a batch of chains advances in lockstep under ``vmap``, turning the many
small per-step ops (an [A,N] delta tile, an [K] structure-factor update,
[N,3] selects) into batched [C,...] ops wide enough to fill the device.
Across chips, parallel/replica.py shards further over the mesh.

Statistical note: chains share the move-*type* schedule when the branch
pick is vmapped (lax.switch over a batched index executes all branches
and selects), but every chain draws its own target molecule, displacement
and acceptance coin from its own PRNG stream — each chain remains a valid
Metropolis chain; only cross-chain correlation of the move-type sequence
is introduced, which does not bias per-chain stationary distributions.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from mpmc_tpu.config import RunConfig, Thermo
from mpmc_tpu.mc import metropolis
from mpmc_tpu.state import Params, SimState


def stack_states(state: SimState, n: int, seed: int = 0) -> SimState:
    """Replicate one SimState n times with decorrelated PRNG keys."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    batched = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (n,) + x.shape), state)
    import dataclasses
    return dataclasses.replace(batched, key=keys)


@functools.partial(jax.jit,
                   static_argnames=("cfg", "n_steps", "thermo_batched"))
def run_chunk_batched(states: SimState, params: Params, cfg: RunConfig,
                      thermo: Thermo, n_steps: int,
                      thermo_batched: bool = False):
    """Advance a batch of chains n_steps each; returns (states, stats)
    with a leading chain dimension on both.

    The move *type* for each step is drawn once from a chunk-level key
    and shared by every chain, keeping the lax.switch index scalar so
    only one branch executes per step (see module docstring for why this
    is statistically sound).  Targets, displacements and acceptance coins
    stay per-chain.

    ``thermo_batched``: Thermo also carries a leading chain dimension
    (parallel tempering — per-replica temperatures).  Move-type
    probabilities are taken from replica 0 (they are shared; only T
    differs across a PT ladder)."""
    step = metropolis.make_step_fn(params, cfg)
    pick, _ = metropolis.make_branch_picker(cfg)
    t_axis = 0 if thermo_batched else None
    vstep = jax.vmap(step, in_axes=(0, 0, t_axis, None))
    pick_thermo = (jax.tree_util.tree_map(lambda x: x[0], thermo)
                   if thermo_batched else thermo)
    n_chains = states.pos.shape[0]
    stats0 = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (n_chains,) + x.shape),
        metropolis.MCStats.zero())
    # chunk key: deterministic in (seed, global step counter), disjoint
    # from the per-chain streams (distinct fold_in constant)
    chunk_key = jax.random.fold_in(
        jax.random.fold_in(jax.random.PRNGKey(cfg.seed ^ 0x5DEECE66),
                           states.step[0].astype(jnp.int32)), 1)

    def body(carry, i):
        st, stats = carry
        t = pick(jax.random.fold_in(chunk_key, i), pick_thermo)
        return vstep(st, stats, thermo, t), None

    (states, stats), _ = jax.lax.scan(
        body, (states, stats0), jnp.arange(n_steps))
    return states, stats


@functools.partial(jax.jit, static_argnames=("cfg", "thermo_batched",
                                             "frozen_rows"))
def initialize_batched(states: SimState, params: Params, cfg: RunConfig,
                       thermo: Thermo,
                       thermo_batched: bool = False,
                       frozen_rows: int = 0) -> SimState:
    """Batched full-energy refresh.  Sequential over chains (lax.map):
    vmapping the O(N^2) pair pass would materialize a
    [chains, pair_chunk, N, 3] displacement tile — tens of GB at large
    chain counts — and the refresh runs only once per corrtime.

    ``frozen_rows`` (static, metropolis.frozen_refresh_rows) enables the
    frozen-reuse fast refresh per chain — pass it only on refreshes of
    states whose e_frozen is already valid."""
    fn = metropolis.initialize.__wrapped__   # un-jitted body
    if thermo_batched:
        return jax.lax.map(
            lambda st: fn(st[0], params, cfg, st[1],
                          frozen_rows=frozen_rows), (states, thermo))
    return jax.lax.map(lambda s: fn(s, params, cfg, thermo,
                                    frozen_rows=frozen_rows), states)


# ---------------------------------------------------------------------------
# Multi-device chain sharding (``chain_devices N``)
# ---------------------------------------------------------------------------
# The dp (data-parallel) axis of the rebuild: C independent chains split
# C/D per device over a 1-D jax.sharding.Mesh.  Chains never communicate
# (the reference's MPI ranks are fully independent too, SURVEY.md §2
# "MPI layer"), so every wrapper below is an embarrassingly-parallel
# shard_map — no collectives; cross-chain observable reduction happens
# on the host once per corrtime, exactly like the single-device driver.

AXIS = "chains"


def chain_mesh(n_devices: int):
    """1-D device mesh for chain sharding (first n_devices devices)."""
    import numpy as np
    from jax.sharding import Mesh
    devs = jax.devices()[:n_devices]
    if len(devs) < n_devices:
        raise ValueError(f"chain_devices {n_devices} but only "
                         f"{len(jax.devices())} devices visible")
    return Mesh(np.array(devs), (AXIS,))


def shard_batched(tree, mesh):
    """Place any replica-stacked pytree (leading [C] on every leaf —
    stack_states states, stack_thermo PT ladders) with the chain axis
    split over the mesh."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    return jax.device_put(tree, NamedSharding(mesh, P(AXIS)))


def replicate(tree, mesh):
    """Place a pytree (params, a shared Thermo) on every device of the
    mesh once, so the shard_mapped chunks read a local copy instead of
    broadcasting it from the default device on every call."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    return jax.device_put(tree, NamedSharding(mesh, P()))


def shard_chains(states: SimState, mesh) -> SimState:
    """Place a stacked-chain state with the chain axis split over the
    mesh (every SimState leaf carries a leading [C] after
    stack_states)."""
    C = int(states.pos.shape[0])
    D = mesh.shape[AXIS]
    if C % D:
        raise ValueError(f"chains {C} not divisible by "
                         f"chain_devices {D}")
    return shard_batched(states, mesh)


def _spec_tuple(thermo_batched=False):
    """(states, params, thermo) in_specs: states sharded over AXIS,
    params replicated, thermo sharded only when its leaves carry the
    chain dim (PT ladders)."""
    from jax.sharding import PartitionSpec as P
    th = P(AXIS) if thermo_batched else P()
    return (P(AXIS), P(), th)


@functools.lru_cache(maxsize=64)
def _sharded_scan_fn(mesh, cfg, n_steps, thermo_batched):
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    def local(st, params, thermo):
        return run_chunk_batched.__wrapped__(
            st, params, cfg, thermo, n_steps,
            thermo_batched=thermo_batched)

    return jax.jit(shard_map(local, mesh=mesh,
                             in_specs=_spec_tuple(thermo_batched),
                             out_specs=(P(AXIS), P(AXIS)),
                             check_vma=False))


def run_chunk_batched_sharded(states, params, cfg, thermo, n_steps,
                              mesh, thermo_batched=False):
    """``run_chunk_batched`` over a chain-sharded state: each device
    advances its local C/D chains with the identical shared move-type
    schedule (the chunk key depends only on cfg.seed and the step
    counter, equal across shards), so per-chain trajectories are
    BIT-identical to the unsharded batch."""
    return _sharded_scan_fn(mesh, cfg, n_steps, thermo_batched)(
        states, params, thermo)


@functools.lru_cache(maxsize=64)
def _sharded_init_fn(mesh, cfg, frozen_rows, thermo_batched):
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    def local(st, params, thermo):
        return initialize_batched.__wrapped__(
            st, params, cfg, thermo, thermo_batched=thermo_batched,
            frozen_rows=frozen_rows)

    return jax.jit(shard_map(local, mesh=mesh,
                             in_specs=_spec_tuple(thermo_batched),
                             out_specs=P(AXIS), check_vma=False))


def initialize_batched_sharded(states, params, cfg, thermo, mesh,
                               frozen_rows: int = 0,
                               thermo_batched=False):
    """Per-corrtime refresh over the mesh: the unsharded version is a
    sequential lax.map over ALL chains (deliberately, for pair-tile
    memory); sharding turns that into D concurrent maps of C/D
    chains."""
    return _sharded_init_fn(mesh, cfg, int(frozen_rows),
                            thermo_batched)(states, params, thermo)
