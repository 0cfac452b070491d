"""Isotherm campaigns: restart-aware pressure sweeps with
uncertainty-targeted stopping.

The production workflow MPMC users script by hand — one job per
pressure, eyeballing convergence, re-queueing crashed points
(SURVEY.md §5 "Failure detection": recovery = manual restart) —
becomes one restartable driver:

- each pressure point runs C vmapped GCMC chains on one chip;
- the point stops when the cross-chain standard error of <N> falls
  under ``target_rel_sem`` (the chain-spread SEM needs no
  autocorrelation analysis) or at ``max_steps``.  Caveat: batched
  chains share the move-TYPE schedule (parallel/multichain design), so
  a common fluctuation component is invisible to the chain spread and
  the true error can exceed the SEM by a small factor at short run
  lengths — tighten target_rel_sem rather than trusting 1x SEM for
  publication-grade error bars;
- successive points warm-start from the previous pressure's final
  chain states (sorption ladders equilibrate far faster than fresh
  starts);
- after every point the campaign writes a checkpoint (batched-state
  pytree + a JSON manifest of completed rows), so a killed campaign
  resumes at the first incomplete pressure.

Pressure enters through ``Thermo`` (a pytree), so the whole sweep runs
on one compiled step function — no recompilation between points.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional

import jax
import numpy as np


@dataclasses.dataclass
class PointResult:
    pressure_atm: float
    fugacity_atm: float
    n_mean: float
    n_sem: float
    wt_pct: float
    qst_kj_mol: float
    steps: int
    #: multi-sorbate extras, flattened into row(): per-species loadings
    #: ``n_<name>`` (+``_sem``), fugacities ``f_<name>``, and pairwise
    #: adsorption selectivities ``S_<i>_<j>`` = (x_i/x_j)/(y_i/y_j)
    extra: dict = dataclasses.field(default_factory=dict)

    def row(self):
        d = dataclasses.asdict(self)
        d.update(d.pop("extra"))
        return d

    @classmethod
    def from_row(cls, r):
        """Inverse of row(): unknown keys go back into ``extra`` (also
        reads pre-``extra`` manifests)."""
        names = {f.name for f in dataclasses.fields(cls)} - {"extra"}
        return cls(**{k: v for k, v in r.items() if k in names},
                   extra={k: v for k, v in r.items() if k not in names})


def _chain_obs(su, states, chains):
    """Per-chain observables dicts via ONE jitted call and ONE host
    fetch per block (run.observables_batched; the per-chain path costs
    C x ~15 device-to-host round-trips)."""
    from mpmc_tpu.mc import run as run_mod
    return run_mod.observables_batched(su, states, chains)


def _species_stats(su, per_species, fugacities):
    """Flattened per-species extras for a mixture point: chain-mean
    loadings with cross-chain SEM, fugacities, and pairwise adsorption
    selectivities S_ij = (x_i/x_j)/(y_i/y_j) (output.py's in-run
    formula, post-point)."""
    names = su.species_names
    if len(names) < 2:
        return {}
    out = {}
    means = {}
    for i, nm in enumerate(names):
        per_chain = np.array([np.mean(v) for v in per_species[nm]])
        means[nm] = float(per_chain.mean())
        out[f"n_{nm}"] = means[nm]
        out[f"n_{nm}_sem"] = (float(per_chain.std(ddof=1)
                                    / np.sqrt(len(per_chain)))
                              if len(per_chain) > 1 else float("inf"))
        out[f"f_{nm}"] = float(fugacities[i])
    for i, ni in enumerate(names):
        for j, nj in enumerate(names):
            if j <= i:
                continue
            fi, fj = float(fugacities[i]), float(fugacities[j])
            if means[nj] > 0 and fi > 0 and fj > 0:
                out[f"S_{ni}_{nj}"] = ((means[ni] / means[nj])
                                       / (fi / fj))
            else:
                out[f"S_{ni}_{nj}"] = float("nan")
    return out


def run_point(su, states, thermo, chains, corrtime, min_steps, max_steps,
              target_rel_sem, equil_blocks, log=None,
              fugacities=None, sample_sink=None) -> tuple:
    """Run one pressure point to its uncertainty target.  Returns
    (states, stats_dict).  ``sample_sink``: optional open text file —
    one JSON record per (block, chain) sample (instantaneous U and
    per-species N), the per-point stream analyze.gcmc_mbar consumes."""
    from mpmc_tpu.mc import metropolis
    from mpmc_tpu.parallel import multichain
    from mpmc_tpu.utils.averages import Averages

    avgs = Averages()
    chain_n: List[List[float]] = [[] for _ in range(chains)]
    per_species = {nm: [[] for _ in range(chains)]
                   for nm in su.species_names}
    corr = max(corrtime, 1)
    steps = 0
    block = 0
    refresh_rows = metropolis.frozen_refresh_rows(su.params, su.cfg)
    while True:
        states, _ = multichain.run_chunk_batched(
            states, su.params, su.cfg, thermo, corr)
        states = multichain.initialize_batched(
            states, su.params, su.cfg, thermo,
            frozen_rows=refresh_rows)
        steps += corr
        block += 1
        if block <= equil_blocks:
            continue
        per_chain = _chain_obs(su, states, chains)
        for c, o in enumerate(per_chain):
            chain_n[c].append(o["N"])
            for nm in su.species_names:
                per_species[nm][c].append(o[f"N_{nm}"])
            avgs.add(o)
            if sample_sink is not None:
                rec = {"step": steps, "chain": c,
                       "energy_total": o["energy_total"], "N": o["N"]}
                rec.update({f"N_{nm}": o[f"N_{nm}"]
                            for nm in su.species_names})
                sample_sink.write(json.dumps(rec) + "\n")
        means = np.array([np.mean(v) for v in chain_n])
        n_mean = float(means.mean())
        n_sem = float(means.std(ddof=1) / np.sqrt(chains)) \
            if chains > 1 else float("inf")
        done_unc = (chains > 1 and n_mean > 0
                    and n_sem / n_mean <= target_rel_sem
                    and steps >= min_steps)
        if log is not None:
            print(f"  block {block}: <N>={n_mean:.3f} sem={n_sem:.4f} "
                  f"({steps} steps)", file=log, flush=True)
        if done_unc or steps >= max_steps:
            return states, {
                "n_mean": n_mean, "n_sem": n_sem, "steps": steps,
                "wt_pct": avgs.mean("wt_pct"),
                "qst_kj_mol": avgs.qst(float(thermo.temperature)),
                "extra": _species_stats(
                    su, per_species,
                    fugacities if fugacities is not None
                    else [float("nan")] * len(su.species_names)),
            }


def run_isotherm(job, pressures, chains=16, target_rel_sem=0.02,
                 min_steps=2000, max_steps=50000, equil_blocks=2,
                 checkpoint_dir: Optional[str] = None, log=None,
                 warm_start=True,
                 samples_dir: Optional[str] = None) -> List[PointResult]:
    """Sweep ``pressures`` (atm) and return one PointResult per point.

    With ``checkpoint_dir``, completed points are recorded in
    ``manifest.json`` and the batched chain states in ``states.npz``;
    rerunning the same campaign resumes after the last completed
    pressure.

    With ``samples_dir``, every point writes ``point_NNN.jsonl`` — a
    run_meta header plus one record per (block, chain) sample — ready
    for ``analyze.py gcmc-mbar`` to reweight the whole campaign into a
    continuous-fugacity isotherm/Qst curve.
    """
    from mpmc_tpu.io import checkpoint as ckpt
    from mpmc_tpu.mc import metropolis
    from mpmc_tpu.mc import run as run_mod
    from mpmc_tpu.parallel import multichain

    su = run_mod.setup(job)
    state = metropolis.initialize(su.state, su.params, su.cfg, su.thermo)
    states = multichain.stack_states(state, chains, seed=su.cfg.seed)

    results: List[PointResult] = []
    done_pressures: List[float] = []
    manifest_path = states_path = None
    if checkpoint_dir:
        os.makedirs(checkpoint_dir, exist_ok=True)
        manifest_path = os.path.join(checkpoint_dir, "manifest.json")
        states_path = os.path.join(checkpoint_dir, "states.npz")
        if os.path.exists(manifest_path):
            with open(manifest_path) as f:
                saved = json.load(f)
            results = [PointResult.from_row(r) for r in saved["rows"]]
            done_pressures = [r.pressure_atm for r in results]
            if os.path.exists(states_path) and done_pressures:
                states = ckpt.load(states_path, like=states)[0]
                if log is not None:
                    print(f"resuming: {len(results)} points done",
                          file=log, flush=True)

    if samples_dir:
        os.makedirs(samples_dir, exist_ok=True)
    for p_i, p_atm in enumerate(pressures):
        if any(abs(p_atm - d) < 1e-12 for d in done_pressures):
            continue
        jb = dataclasses.replace(job, pressure=p_atm)
        fug = run_mod.compute_fugacities(jb, su.species_names,
                                         len(su.species))
        import jax.numpy as jnp
        thermo = su.thermo.replace(
            pressure=jnp.asarray(p_atm, su.cfg.jdtype),
            fugacity=jnp.asarray(np.resize(
                np.asarray(fug, np.float64),
                np.asarray(su.thermo.fugacity).shape), su.cfg.jdtype))
        if log is not None:
            print(f"pressure {p_atm} atm (fugacity {fug[0]:.5g} atm)",
                  file=log, flush=True)
        if not warm_start:
            states = multichain.stack_states(state, chains,
                                             seed=su.cfg.seed)
        sink = None
        if samples_dir:
            sink = open(os.path.join(samples_dir,
                                     f"point_{p_i:03d}.jsonl"), "w")
            sink.write(json.dumps({"run_meta": {
                "species": list(su.species_names),
                "ensemble": str(su.cfg.ensemble),
                "temperature": float(jb.temperature),
                "pressure": float(p_atm),
                "fugacities": [float(v) for v in fug],
                "volume": float(abs(np.linalg.det(
                    np.asarray(su.state.box)))),
                "n_chains": int(chains)}}) + "\n")
        try:
            states, stats = run_point(
                su, states, thermo, chains, su.cfg.corrtime, min_steps,
                max_steps, target_rel_sem, equil_blocks, log=log,
                fugacities=fug, sample_sink=sink)
        finally:
            if sink is not None:
                sink.close()
        results.append(PointResult(
            pressure_atm=p_atm, fugacity_atm=float(fug[0]),
            n_mean=stats["n_mean"], n_sem=stats["n_sem"],
            wt_pct=stats["wt_pct"], qst_kj_mol=stats["qst_kj_mol"],
            steps=stats["steps"], extra=stats["extra"]))
        done_pressures.append(p_atm)
        if checkpoint_dir:
            ckpt.save(states_path, states)
            with open(manifest_path, "w") as f:
                json.dump({"rows": [r.row() for r in results]}, f,
                          indent=1)
    return results


def write_csv(results: List[PointResult], path: str) -> None:
    import csv
    rows = [r.row() for r in results]
    # union of keys, first-row order first: rows can differ (e.g. a
    # campaign resumed from a pre-``extra`` manifest mixes plain and
    # per-species rows)
    fields = list(rows[0])
    for r in rows[1:]:
        fields.extend(k for k in r if k not in fields)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields, restval="")
        w.writeheader()
        w.writerows(rows)
