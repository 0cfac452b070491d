"""Multi-host parallel tempering: the reference's MPI job spanning
nodes, rebuilt on ``jax.distributed`` + the existing replica mesh.

The reference scales past one node by launching MPI ranks across hosts —
each rank a full replica, swaps over the interconnect (SURVEY.md §2 "MPI
layer", §5 "Distributed comm backend").  The rebuild keeps the exact
same shape: every process contributes its local devices to one global
``Mesh`` over the replica axis, `parallel/replica.PTRunner` runs
unchanged (its ``ppermute``/``pmean`` collectives ride NVLink within a
host and the network across hosts — XLA picks the transport), and the only
multi-host-specific work is (a) the ``jax.distributed`` bootstrap and
(b) turning host-local replica stacks into globally-sharded arrays.

Launch (one command per host):

    python -m mpmc_tpu --distributed \
        --coordinator host0:1234 --num-processes 4 --process-id $RANK \
        run.inp

or rely on the environment auto-detection of a cluster scheduler that
provides it (e.g. SLURM) by passing ``--distributed`` alone; with nothing
to detect, give all three options.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import numpy as np


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Bootstrap jax.distributed.  With no arguments, relies on the
    environment's cluster auto-detection; explicit arguments mirror the
    reference's mpirun rank wiring."""
    kw = {}
    if coordinator is not None:
        kw["coordinator_address"] = coordinator
    if num_processes is not None:
        kw["num_processes"] = num_processes
    if process_id is not None:
        kw["process_id"] = process_id
    jax.distributed.initialize(**kw)


def global_replica_mesh(n_replicas: Optional[int] = None):
    """Mesh over ALL devices of ALL processes (replica axis)."""
    from mpmc_tpu.parallel import replica
    devs = jax.devices()          # global device list under jax.distributed
    if n_replicas is not None:
        if n_replicas > len(devs):
            raise ValueError(
                f"{n_replicas} replicas > {len(devs)} global devices")
        devs = devs[:n_replicas]
    from jax.sharding import Mesh
    return Mesh(np.array(devs), (replica.AXIS,))


def distribute(tree, mesh):
    """Shard a FULL replica-stacked pytree (leading dim R, identical on
    every host — build it deterministically) over the mesh's replica
    axis as global arrays.

    ``host_local_array_to_global_array`` expects each process to hand
    over only ITS slice of the global array; passing the full stack from
    every host would silently double the replica axis (each device then
    runs the wrong ladder rung — caught by test_multihost.py).  The
    local slice is the set of replica rows owned by this process's
    devices in the mesh's device order."""
    import jax.tree_util as jtu
    from jax.experimental import multihost_utils
    from jax.sharding import PartitionSpec as P
    spec = P(mesh.axis_names[0])
    if jax.process_count() == 1:
        from jax.sharding import NamedSharding
        sh = NamedSharding(mesh, spec)
        return jtu.tree_map(lambda x: jax.device_put(x, sh), tree)
    devs = list(mesh.devices.ravel())
    mine = [i for i, d in enumerate(devs)
            if d.process_index == jax.process_index()]
    lo, hi = min(mine), max(mine) + 1
    if mine != list(range(lo, hi)):
        raise ValueError("this process's mesh slots are not contiguous; "
                         "reorder the mesh device array")
    n = len(devs)

    def slice_rows(x):
        r = x.shape[0]
        per = r // n       # rows per device (replica axis evenly split)
        return x[lo * per:hi * per]

    return multihost_utils.host_local_array_to_global_array(
        jtu.tree_map(slice_rows, tree), mesh, spec)


def run_parallel_tempering(params, state, cfg, thermo, temps,
                           n_rounds: int, steps_per_round: int,
                           seed: int = 0, log=None):
    """Multi-host PT drive: every process runs this same function with
    the same inputs; history/logging happen on process 0 only.

    Single-process calls degrade to the one-slice behavior (the test
    path), so the same entry point serves laptop CPU meshes and pods.
    """
    from mpmc_tpu.mc import metropolis
    from mpmc_tpu.parallel import replica

    temps = np.asarray(temps, np.float64)
    mesh = global_replica_mesh(len(temps))
    R = mesh.shape[replica.AXIS]

    state = metropolis.initialize(state, params, cfg, thermo)
    states = distribute(replica.stack_states(state, R, seed=seed), mesh)
    thermos = distribute(
        replica.stack_thermo(thermo, temps, cfg.jdtype), mesh)
    runner = replica.PTRunner(params, cfg, mesh, steps_per_round)
    master = jax.random.PRNGKey(seed + 7)
    history = []
    is_root = jax.process_index() == 0
    for r in range(n_rounds):
        shared = jax.random.fold_in(master, r)
        states, thermos, stats, acc, me, mn, accf = runner.round(
            states, thermos, shared, parity=r % 2)
        if is_root:
            # me/mn/accf are pmean-replicated scalars — addressable on
            # every process; the replica-sharded acc/states are NOT
            # (jax.distributed), so only reduced quantities are logged
            row = {
                "round": r,
                "mean_energy": float(me),
                "mean_N": float(mn),
                "swap_acceptance": float(accf),
            }
            history.append(row)
            if log is not None:
                print(f"PT round {r}: <E>={row['mean_energy']:.3f} "
                      f"swap_acc={row['swap_acceptance']:.2f}",
                      file=log, flush=True)
    return states, thermos, history
