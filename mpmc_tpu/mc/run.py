"""High-level run driver: input files -> system -> MC loop -> outputs.

Rebuild of the reference's setup + main-loop orchestration (SURVEY.md §3.1
call stack: setup_system() -> mc(); src/io/input.c, src/mc/mc.c [C]).
The corrtime structure is preserved: the inner loop is a jit-compiled
lax.scan chunk of ``corrtime`` steps; at each boundary the driver refreshes
cached energies (full recompute — washes out delta accumulation), samples
observables, writes outputs, and applies simulated-annealing decay.
"""
from __future__ import annotations

import dataclasses
import functools
import sys
import time
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mpmc_tpu.config import RunConfig, Thermo
from mpmc_tpu.io import input_script, output as output_io, pqr as pqr_io
from mpmc_tpu.mc import fugacity as fug_mod
from mpmc_tpu.mc import metropolis
from mpmc_tpu.ops import energy as energy_mod
from mpmc_tpu.ops import pairs as pairs_mod
from mpmc_tpu.state import Params, SimState, Species, build_system
from mpmc_tpu.utils.averages import Averages, sorbed_mass_obs


@dataclasses.dataclass
class Setup:
    params: Params
    state: SimState
    cfg: RunConfig
    thermo: Thermo
    species: Tuple[Species, ...]
    species_names: List[str]
    frozen_mass: float
    # species indices whose PQR atoms were 'S'-flagged (mc/spectre.py)
    spectre_species: Tuple[int, ...] = ()


def _species_from_atoms(atoms) -> Species:
    atoms = sorted(atoms, key=lambda a: a.serial)
    return Species(
        name=atoms[0].mol_name,
        atom_names=tuple(a.name for a in atoms),
        pos=np.stack([a.xyz for a in atoms]),
        mass=np.array([a.mass for a in atoms]),
        charge=np.array([a.charge for a in atoms]),
        polar=np.array([a.polar for a in atoms]),
        eps=np.array([a.eps for a in atoms]),
        sig=np.array([a.sig for a in atoms]),
        omega=np.array([a.omega for a in atoms]),
        c6=np.array([a.c6 for a in atoms]),
        c8=np.array([a.c8 for a in atoms]),
        c10=np.array([a.c10 for a in atoms]),
        gwp_alpha=np.array([a.gwp_alpha for a in atoms]))


def compute_fugacities(job: input_script.Job, names, nsp=None):
    """Per-species fugacities [atm] for the job's (T, P): explicit
    ``fugacities`` list > per-species EoS fits > ideal f = P
    (SURVEY.md §2 "Fugacity EoS")."""
    nsp = nsp if nsp is not None else max(len(names), 1)
    if job.fugacities is not None:
        return list(job.fugacities) + [0.0] * (nsp - len(job.fugacities))
    fug = []
    for n in names:
        key = fug_mod.guess_species_key(n)
        if job.fugacity_eos.get(key, False):
            fug.append(fug_mod.fugacity(key, job.temperature,
                                        job.pressure))
        else:
            fug.append(job.pressure)
    return fug or [job.pressure]


def setup(job: input_script.Job,
          frame: Optional[pqr_io.PqrFrame] = None) -> Setup:
    """Build (params, state, cfg, thermo) from a parsed Job."""
    if frame is None:
        if not job.pqr_input:
            raise ValueError("pqr_input is required")
        frame = pqr_io.read(job.pqr_input)
    basis = job.basis
    if job.read_pqr_box and frame.box is not None:
        basis = frame.box   # reference's read_pqr_box (SURVEY §2.9 "Cell")
    if basis is None:
        raise ValueError("no cell: provide basis1/2/3, abcbasis, or "
                         "read_pqr_box with a CRYST1 record")
    job = dataclasses.replace(job, basis=basis)

    frozen = sorted(frame.frozen, key=lambda a: a.serial)
    frozen_pos = np.stack([a.xyz for a in frozen]) if frozen else None
    fp = None
    if frozen:
        fp = {k: np.array([getattr(a, k2) for a in frozen])
              for k, k2 in [("charge", "charge"), ("mass", "mass"),
                            ("polar", "polar"), ("eps", "eps"),
                            ("sig", "sig"), ("omega", "omega"),
                            ("c6", "c6"), ("c8", "c8"), ("c10", "c10"),
                            ("gwp_alpha", "gwp_alpha")]}

    # group movable molecules into species by mol_name
    species: List[Species] = []
    names: List[str] = []
    instances: Dict[str, List[List]] = {}
    for mol_id, atoms in sorted(frame.movable_molecules().items()):
        nm = atoms[0].mol_name
        if nm not in names:
            names.append(nm)
            species.append(_species_from_atoms(atoms))
            instances[nm] = []
        sp = species[names.index(nm)]
        if len(atoms) != sp.natoms:
            raise ValueError(
                f"molecule {mol_id} ({nm}) has {len(atoms)} atoms; species "
                f"template has {sp.natoms}")
        instances[nm].append(
            np.stack([a.xyz for a in sorted(atoms, key=lambda x: x.serial)]))

    # insertion template (GCMC)
    insert_names: List[str] = []
    if job.insert_input:
        tf = pqr_io.read(job.insert_input)
        mols = tf.movable_molecules() or {0: tf.atoms}
        for _, atoms in sorted(mols.items()):
            nm = atoms[0].mol_name
            if nm not in names:
                names.append(nm)
                species.append(_species_from_atoms(atoms))
                instances[nm] = []
            insert_names.append(nm)
    elif job.cfg.ensemble == "uvt":
        insert_names = list(names)    # clone existing sorbates

    if job.vib_omega > 0.0:
        # quantum_vibration: the stretch fundamental applies to the
        # sorbate species (the reference's PQR carries no column for
        # it, so it arrives via the vib_omega option); non-linear
        # species are skipped downstream by qvib.vibration_table
        species = [dataclasses.replace(sp, vib_omega=job.vib_omega)
                   for sp in species]

    insert_species = tuple(names.index(n) for n in insert_names)
    if job.cfg.tmmc and len(insert_species) != 1:
        raise ValueError(
            "tmmc requires exactly one insert species (the collection "
            f"matrix is over a scalar macrostate N); got {insert_names}")
    counts = [len(instances[n]) for n in names]
    capacity = [c + (job.max_molecules if i in insert_species else 0)
                for i, c in enumerate(counts)]
    capacity = [max(c, 1) for c in capacity]
    initial_pos = {i: np.stack(instances[n]) if instances[n] else None
                   for i, n in enumerate(names)}
    initial_pos = {i: v for i, v in initial_pos.items() if v is not None}

    b = np.asarray(basis, np.float64)
    cfg = dataclasses.replace(
        job.cfg, insert_species=insert_species,
        # exactly-diagonal basis -> the Thole kernel takes the cheap
        # 1-D min-image path (config.RunConfig.ortho_box)
        ortho_box=bool(np.all(b == np.diag(np.diag(b)))))
    params, state = build_system(
        job.basis, frozen_pos=frozen_pos, frozen_params=fp,
        species=tuple(species), capacity=tuple(capacity),
        initial_counts=tuple(counts), initial_pos=initial_pos,
        dtype=cfg.jdtype, seed=cfg.seed)
    if job.scale_charge != 1.0:
        params = dataclasses.replace(
            params, charge=params.charge * job.scale_charge)
    if cfg.extrapolate_disp_coeffs:
        # Tang-Toennies recursion C10 = (49/40) C8^2/C6 for atoms with
        # C6/C8 but no C10 (SURVEY §2.9 "RD" [L])
        c6 = np.asarray(params.c6)
        c8 = np.asarray(params.c8)
        c10 = np.array(params.c10, np.float64, copy=True)
        m = (c10 == 0) & (c6 > 0) & (c8 > 0)
        c10[m] = 49.0 / 40.0 * c8[m] ** 2 / c6[m]
        params = dataclasses.replace(
            params, c10=jnp.asarray(c10, cfg.jdtype))
    if cfg.cell_list:
        from mpmc_tpu.ops import celllist
        params = celllist.attach(params, state.pos, state.box, cfg)

    if cfg.coulomb == "ewald" and not cfg.spectre:
        # (SPECTRE exempt: its mobile free charges are individually
        # non-neutral by construction and the per-corrtime
        # renormalization governs the total — mc/spectre.py)
        # Non-neutral cells are handled CORRECTLY since r3: the
        # uniform-background (jellium) correction -pi Q^2/(2 a^2 V)
        # rides in es_self (ops/ewald.background_correction) and the
        # scan path carries the quadratic insert/delete delta
        # (metropolis._background_delta).  The explicit opt-in stays: a
        # net charge is usually an input mistake, and the jellium
        # convention (tinfoil + compensating background) should be a
        # deliberate choice.
        q = np.asarray(params.charge, np.float64)
        alive = np.asarray(state.atom_alive(params))
        net = float(np.sum(np.where(alive, q, 0.0)))
        nets = [net] + [
            float(np.sum(np.asarray(species[s].charge, np.float64)))
            for s in insert_species]
        bad = max(abs(x) for x in nets)
        if bad > 1e-3:
            if cfg.allow_charged_cell:
                import warnings
                warnings.warn(
                    f"Ewald with a non-neutral cell: |sum q| = "
                    f"{bad:.6g} e — applying the uniform-background "
                    "(jellium) correction; energies follow the "
                    "tinfoil + compensating-background convention")
            else:
                raise ValueError(
                    f"Ewald with a non-neutral cell: |sum q| = "
                    f"{bad:.6g} e (cell or insertable species). Set "
                    "allow_charged_cell to compute it in the jellium "
                    "convention (uniform neutralizing background).")

    # fugacities: explicit list > per-species EoS > ideal (f = P)
    nsp = max(len(species), 1)
    fug = compute_fugacities(job, names, nsp)

    thermo = Thermo.make(
        temperature=job.temperature, pressure=job.pressure, fugacity=fug,
        nve_energy=job.total_energy,
        move_factor=job.move_factor, rot_factor=job.rot_factor,
        insert_probability=job.insert_probability,
        volume_probability=job.volume_probability,
        volume_change_factor=job.volume_change_factor,
        spinflip_probability=job.spinflip_probability,
        n_species=nsp, dtype=cfg.jdtype)

    frozen_mass = float(sum(a.mass for a in frozen))
    # species whose source atoms carry the PQR 'S' flag (SPECTRE sites)
    spectre_flags: Dict[str, bool] = {}
    for mol_id, atoms in sorted(frame.movable_molecules().items()):
        spectre_flags.setdefault(atoms[0].mol_name,
                                 atoms[0].flag.upper().startswith("S"))
    spectre_species = tuple(i for i, n in enumerate(names)
                            if spectre_flags.get(n, False))
    return Setup(params, state, cfg, thermo, tuple(species), names,
                 frozen_mass, spectre_species)


@functools.partial(jax.jit, static_argnums=(2, 3))
def _obs_device_batched(states, params, n_species, has_mu):
    """Per-chain observable arrays for a whole chain batch in ONE
    compiled computation: energy terms, volume, N, per-species N, and
    the mean squared induced dipole.  params is an ARGUMENT, not a
    closure, so its arrays are not baked into the program as
    constants."""

    def one(st):
        e = st.reported_energy()
        terms = jnp.stack([e.total, e.rd, e.lrc, e.es, e.es_real,
                           e.es_recip, e.es_self, e.es_excl, e.polar,
                           e.vdw])
        vol = jnp.abs(jnp.linalg.det(st.box))
        n = st.n_molecules(params)
        ns = jnp.stack([st.n_molecules_of(params, i)
                        for i in range(n_species)])
        if has_mu:
            pol = (params.polar > 0) & st.atom_alive(params)
            mu2 = jnp.sum(st.mu * st.mu, axis=1)
            npol = jnp.sum(pol)
            mu2m = (jnp.sum(jnp.where(pol, mu2, 0.0))
                    / jnp.maximum(npol, 1))
        else:
            npol = jnp.zeros((), jnp.int32)
            mu2m = jnp.zeros((), terms.dtype)
        dof = jnp.sum(jnp.where(
            st.mol_alive & ~params.mol_frozen
            & (params.mol_species >= 0), params.mol_dof, 0.0))
        return terms, vol, n, ns, mu2m, npol, dof

    return jax.vmap(one)(states)


@jax.jit
def _slice_chain(states, k):
    """Chain k's state (state.slice_chain — shared with the per-replica
    output writers)."""
    from mpmc_tpu.state import slice_chain
    return slice_chain(states, k)


def _hist_make(job, box):
    """Population histogram for a multi-chain/replica driver, or None
    when not requested (the single-chain driver builds its own)."""
    if not (job.pop_histogram or job.histogram_output):
        return None
    from mpmc_tpu.utils.histogram import PopulationHistogram
    return PopulationHistogram(np.asarray(box), job.hist_resolution)


def _hist_accumulate(hist, states, params, n):
    """Bin every chain/replica's movable COMs into one shared histogram
    — the reference's cross-rank MPI_Reduce of per-rank population
    histograms to rank 0 (SURVEY §2 "Histogram",
    update_root_histogram): each rank (here: chain or ladder rung)
    contributes its per-corrtime binning to a single grid."""
    from mpmc_tpu.state import all_molecule_coms
    coms = np.asarray(jax.vmap(
        lambda p: all_molecule_coms(p, params))(states.pos))
    alive = np.asarray(states.mol_alive)
    base = (~np.asarray(params.mol_frozen)
            & (np.asarray(params.mol_species) >= 0))
    for c in range(n):
        hist.add(coms[c][alive[c] & base])


def _hist_finish(hist, job, n, writer, what="chains"):
    if hist is None:
        return
    path = job.histogram_output or "histogram.dx"
    hist.write_dx(path)
    print(f"population histogram ({n} {what} reduced) written to "
          f"{path}", file=writer.log)


def _qrot_init_batched(su: Setup, states, temps, lmax: int):
    """Per-chain spin/rot_f initialization for the batched drivers
    (chains N, parallel tempering).  Chains start from the SAME
    configuration, so ONE eigensolve set serves every chain; the
    per-chain F tables evaluate it at each chain's temperature.
    Returns (states, per-chain eigs caches)."""
    from mpmc_tpu.ops import qrot
    cfg, params = su.cfg, su.params
    C = int(states.pos.shape[0])
    qr_rng = np.random.default_rng(cfg.seed + 977)
    # normal-H2 initial mixture per chain: 3:1 ortho:para (decorrelated
    # across chains; same convention as the single-chain driver)
    spins0 = (qr_rng.random((C, int(params.n_mols_max))) < 0.75
              ).astype(np.int32)
    st0 = _slice_chain(states, 0)
    eigs0 = qrot.eigen_tables(
        st0.pos, st0.box, st0.atom_alive(params), st0.mol_alive, params,
        cfg, su.thermo, list(su.species), lmax=lmax)
    tables = np.stack([
        qrot.table_from_eigs(eigs0, params.n_mols_max, t) for t in temps])
    states = states.replace(spin=jnp.asarray(spins0),
                            rot_f=jnp.asarray(tables, cfg.jdtype))
    return states, [eigs0] * C


def _qrot_refresh_batched(su: Setup, states, temps, lmax: int):
    """Per-corrtime hindered-rotor refresh for batched drivers:
    eigensolves at each chain's CURRENT positions and temperature →
    ([C,M,2] rot_f, per-chain eigs caches).  Host-level by design
    (numpy eigensolves over a spherical-harmonic basis, ops/qrot.py) —
    the same cadence and staleness contract as the single-chain
    driver's per-corrtime refresh."""
    from mpmc_tpu.ops import qrot
    cfg, params = su.cfg, su.params
    C = int(states.pos.shape[0])
    tables, eigs_all = [], []
    for c in range(C):
        st = _slice_chain(states, c)
        th = su.thermo.replace(
            temperature=jnp.asarray(temps[c], cfg.jdtype))
        eigs = qrot.eigen_tables(
            st.pos, st.box, st.atom_alive(params), st.mol_alive, params,
            cfg, th, list(su.species), lmax=lmax)
        eigs_all.append(eigs)
        tables.append(qrot.table_from_eigs(eigs, params.n_mols_max,
                                           temps[c]))
    return np.stack(tables), eigs_all


def observables_batched(su: Setup, states, n_chains: int):
    """Per-chain observables dicts for a batched-chain state — the
    multi-chain analog of observables() built from ONE jitted call and
    ONE host fetch.  The naive per-chain path (tree_map slice +
    observables() per chain) costs C x ~15 separate device-to-host
    round-trips per corrtime block — pure dispatch latency.  Key-for-key
    equality with observables() is pinned by tests/test_parallel.py.
    polar_rrms_debye is omitted for a chain with no alive polarizable
    sites, matching observables()."""
    params = su.params
    has_mu = states.mu is not None
    terms, vol, n, ns, mu2m, npol, dof = jax.device_get(
        _obs_device_batched(states, params, len(su.species_names),
                            has_mu))
    masses = np.array([sp.total_mass for sp in su.species], np.float64)
    names = ("energy_total", "energy_rd", "energy_lrc", "energy_es",
             "energy_es_real", "energy_es_recip", "energy_es_self",
             "energy_es_excl", "energy_polar", "energy_vdw")
    out = []
    for c in range(n_chains):
        obs = {k: float(terms[c, i]) for i, k in enumerate(names)}
        obs["volume"] = float(vol[c])
        obs["N"] = float(n[c])
        obs["N2"] = obs["N"] ** 2
        obs["UN"] = obs["energy_total"] * obs["N"]
        if su.cfg.ensemble == "nve":
            k = float(su.thermo.nve_energy) - obs["energy_total"]
            obs["T_kinetic"] = 2.0 * k / max(float(dof[c]), 1.0)
        if has_mu and int(npol[c]) > 0:
            # omitted (not 0) when a chain has no alive polarizable
            # sites — same semantics as observables()
            from mpmc_tpu.constants import DEBYE_PER_EA
            obs["polar_rrms_debye"] = float(
                np.sqrt(mu2m[c]) * DEBYE_PER_EA)
        total_amu = 0.0
        for i, nm in enumerate(su.species_names):
            obs[f"N_{nm}"] = float(ns[c, i])
            total_amu += float(ns[c, i]) * float(masses[i])
        obs.update(sorbed_mass_obs(total_amu, obs["volume"],
                                   su.frozen_mass))
        out.append(obs)
    if states.spin is not None and states.rot_f is not None:
        # quantum-rotation spin observables (same keys/semantics as
        # observables()): three extra fetches, only when qrot is on
        spin_h, rotf_h, alive_h = jax.device_get(
            (states.spin, states.rot_f, states.mol_alive))
        mask0 = (~np.asarray(params.mol_frozen)
                 & (np.asarray(params.mol_species) >= 0)
                 & (np.asarray(params.mol_natoms) >= 2))
        for c in range(n_chains):
            am = np.asarray(alive_h[c]) & mask0
            if am.any():
                sp_c = np.asarray(spin_h[c])[am].astype(int)
                ft = np.asarray(rotf_h[c])[am]
                out[c]["ortho_fraction"] = float(sp_c.mean())
                out[c]["energy_qrot"] = float(
                    ft[np.arange(len(sp_c)), sp_c].mean())
    return out


def observables(su: Setup, state: SimState, stats=None) -> Dict[str, float]:
    params = su.params
    e = state.reported_energy()
    obs = {
        "energy_total": float(e.total), "energy_rd": float(e.rd),
        "energy_lrc": float(e.lrc), "energy_es": float(e.es),
        "energy_es_real": float(e.es_real),
        "energy_es_recip": float(e.es_recip),
        "energy_es_self": float(e.es_self),
        "energy_es_excl": float(e.es_excl),
        "energy_polar": float(e.polar), "energy_vdw": float(e.vdw),
        "volume": float(jnp.abs(jnp.linalg.det(state.box))),
        "N": float(state.n_molecules(params)),
    }
    obs["N2"] = obs["N"] ** 2
    obs["UN"] = obs["energy_total"] * obs["N"]
    if su.cfg.ensemble == "nve":
        # kinetic temperature of the demon reservoir: T = 2(E - U)/F
        f_dof = float(np.sum(np.where(
            np.asarray(state.mol_alive)
            & ~np.asarray(params.mol_frozen)
            & (np.asarray(params.mol_species) >= 0),
            np.asarray(params.mol_dof), 0.0)))
        k = float(su.thermo.nve_energy) - obs["energy_total"]
        obs["T_kinetic"] = 2.0 * k / max(f_dof, 1.0)
    if state.mu is not None:
        # RMS induced dipole per polarizable site [Debye] — the
        # reference's polar_rrms diagnostic (SURVEY §2.9 "Polarization")
        from mpmc_tpu.constants import DEBYE_PER_EA
        pol = (np.asarray(params.polar) > 0) & np.asarray(
            state.atom_alive(params))
        if pol.any():
            mu2 = np.asarray(jnp.sum(state.mu * state.mu, axis=1))[pol]
            obs["polar_rrms_debye"] = float(
                np.sqrt(mu2.mean()) * DEBYE_PER_EA)
    if state.spin is not None and state.rot_f is not None:
        alive_m = (np.asarray(state.mol_alive)
                   & ~np.asarray(params.mol_frozen)
                   & (np.asarray(params.mol_species) >= 0)
                   & (np.asarray(params.mol_natoms) >= 2))
        if alive_m.any():
            sp = np.asarray(state.spin)[alive_m]
            ft = np.asarray(state.rot_f)[alive_m]
            obs["ortho_fraction"] = float(sp.mean())
            obs["energy_qrot"] = float(
                ft[np.arange(len(sp)), sp].mean())
    total_sorb_amu = 0.0
    for i, nm in enumerate(su.species_names):
        n_i = float(state.n_molecules_of(params, i))
        obs[f"N_{nm}"] = n_i
        total_sorb_amu += n_i * su.species[i].total_mass
    obs.update(sorbed_mass_obs(total_sorb_amu, obs["volume"],
                               su.frozen_mass))
    if stats is not None:
        att = np.maximum(np.asarray(stats.attempts), 1)
        acc = np.asarray(stats.accepts) / att
        for i, nm in enumerate(("displace", "insert", "delete", "volume",
                                "spinflip")):
            obs[f"acc_{nm}"] = float(acc[i])
    return obs


def run_te(job: input_script.Job, log=None):
    """ensemble te: one energy() call + per-term printout
    (SURVEY.md §2 "Single point" — the parity workhorse)."""
    su = setup(job)
    if job.spatial_devices > 1:
        # multi-chip single point: O(N^2) pair matrix, Ewald k-table,
        # and polar SCF matvec row-sharded over the mesh
        # (parallel/spatial.total_energy_sharded)
        import jax
        from mpmc_tpu.parallel import spatial
        devs = jax.devices()[:job.spatial_devices]
        if len(devs) < job.spatial_devices:
            raise ValueError(
                f"spatial_devices {job.spatial_devices} but only "
                f"{len(jax.devices())} devices available")
        mesh = jax.sharding.Mesh(np.array(devs), (spatial.AXIS,))
        e, _ = spatial.total_energy_sharded(
            su.state.pos, su.state.box, su.state.mol_alive, su.params,
            su.cfg, su.thermo, mesh)
        print(f"spatial sharding: {job.spatial_devices} devices",
              file=log or sys.stdout)
    else:
        e, _ = energy_mod.total_energy(
            su.state.pos, su.state.box, su.state.mol_alive, su.params,
            su.cfg, su.thermo)
    output_io.print_energy_report(e, file=log)
    if job.polarizability_tensor:
        from mpmc_tpu.ops import thole
        alpha = np.asarray(thole.polarizability_tensor(
            su.state.pos, su.state.box,
            su.state.atom_alive(su.params), su.params, su.cfg))
        p = log or sys.stdout
        print("=== polarizability tensor (A^3) ===", file=p)
        for row in alpha:
            print("  " + "  ".join(f"{v:12.6f}" for v in row), file=p)
    return e


def _frame_pressure(su, state, job) -> float:
    """Instantaneous pressure [atm] via the volume-perturbation virial,
    P = (N kT - dU/dlnV)/V (SURVEY.md §2 "Replay": calc_pressure [M])."""
    from mpmc_tpu.constants import ATM2K_A3
    from mpmc_tpu.mc import moves as moves_mod
    dlnv = job.calc_pressure_dv
    es = []
    for sgn in (+1.0, -1.0):
        p2, b2 = moves_mod.scale_volume(
            state.pos, state.box, su.params, state.mol_alive,
            jnp.asarray(sgn * dlnv, su.cfg.jdtype))
        e2, _ = energy_mod.total_energy(
            p2, b2, state.mol_alive, su.params, su.cfg, su.thermo)
        es.append(float(e2.total))
    du_dlnv = (es[0] - es[1]) / (2.0 * dlnv)
    v = float(jnp.abs(jnp.linalg.det(state.box)))
    n = float(state.n_molecules(su.params))
    return (n * job.temperature - du_dlnv) / v / ATM2K_A3


def run_replay(job: input_script.Job, log=None):
    """ensemble replay: recompute energies/averages over a trajectory;
    optional instantaneous pressure via the volume-perturbation virial
    estimate (SURVEY.md §2 "Replay").  With the native codec available
    the trajectory is parsed to packed arrays and same-layout frames
    write positions directly into the padded state — no per-atom Python
    objects on the hot path."""

    def topo_sig(fr):
        return (len(fr.frozen),
                tuple((a[0].mol_name, len(a)) for a in
                      (ats for _, ats in sorted(
                          fr.movable_molecules().items()))))

    def refresh_positions(su, fr):
        """Fast path: same topology as the previous frame — write the new
        coordinates (and cell) into the existing padded state instead of
        rebuilding the whole system (big trajectories are setup-bound
        otherwise)."""
        pos = np.asarray(su.state.pos).copy()
        frozen = sorted(fr.frozen, key=lambda a: a.serial)
        for i, a in enumerate(frozen):
            pos[i] = a.xyz
        spec = np.asarray(su.params.mol_species)
        slot_cursor = {i: 0 for i in range(len(su.species_names))}
        slots_of = {i: np.nonzero(spec == i)[0]
                    for i in range(len(su.species_names))}
        mol_atoms = np.asarray(su.params.mol_atoms)
        for _, atoms in sorted(fr.movable_molecules().items()):
            si = su.species_names.index(atoms[0].mol_name)
            slot = slots_of[si][slot_cursor[si]]
            slot_cursor[si] += 1
            idx = mol_atoms[slot]
            for k, a in enumerate(sorted(atoms, key=lambda x: x.serial)):
                pos[idx[k]] = a.xyz
        state = su.state.replace(pos=jnp.asarray(pos, su.cfg.jdtype))
        if job.read_pqr_box and fr.box is not None:
            state = state.replace(box=jnp.asarray(fr.box, su.cfg.jdtype))
        return dataclasses.replace(su, state=state)

    def dest_map(su, serials, mol_ids, flags, mol_name_of):
        """File-row -> padded-slot index map (built once per topology):
        frozen rows sorted by serial occupy the padded prefix; movable
        molecules in ascending mol_id claim species slots in order."""
        n = len(serials)
        dest = np.empty(n, np.int64)
        frozen_rows = np.nonzero(flags)[0]
        dest[frozen_rows[np.argsort(serials[frozen_rows],
                                    kind="stable")]] = np.arange(
            len(frozen_rows))
        spec = np.asarray(su.params.mol_species)
        mol_atoms = np.asarray(su.params.mol_atoms)
        slots_of = {i: list(np.nonzero(spec == i)[0])
                    for i in range(len(su.species_names))}
        cursor = {i: 0 for i in slots_of}
        mov = np.nonzero(~flags)[0]
        for mid in np.unique(mol_ids[mov]):
            rows = mov[mol_ids[mov] == mid]
            rows = rows[np.argsort(serials[rows], kind="stable")]
            si = su.species_names.index(mol_name_of(rows[0]))
            slot = slots_of[si][cursor[si]]
            cursor[si] += 1
            dest[rows] = mol_atoms[slot][:len(rows)]
        return dest

    def layout_frame(su, arr, nl):
        """(dest row map, mol_alive) for writing this frame into su's
        EXISTING padded slots, or None when it does not fit (unknown
        species, species-template mismatch, counts over capacity, or a
        changed frozen prefix).  A fitting frame relayouts with no
        re-setup — and, crucially for GCMC trajectories whose N changes
        almost every frame, no new array shapes and therefore no jit
        recompile: the padded capacity only ratchets up when a frame
        breaks the running molecule-count maximum."""
        flags_np = np.frombuffer(arr["flags"], np.uint8) == ord("F")
        frozen_rows = np.nonzero(flags_np)[0]
        serials, mol_ids = arr["ids"][:, 0], arr["ids"][:, 1]
        spec = np.asarray(su.params.mol_species)
        mol_atoms = np.asarray(su.params.mol_atoms)
        # frozen prefix: same atom count as at setup
        n_frozen_prev = int(np.asarray(su.params.mol_natoms)[
            np.asarray(su.params.mol_frozen)].sum())
        if len(frozen_rows) != n_frozen_prev:
            return None
        n = len(serials)
        dest = np.empty(n, np.int64)
        dest[frozen_rows[np.argsort(serials[frozen_rows],
                                    kind="stable")]] = np.arange(
            len(frozen_rows))
        slots_of = {i: np.nonzero(spec == i)[0]
                    for i in range(len(su.species_names))}
        cursor = {i: 0 for i in slots_of}
        alive = np.asarray(su.state.mol_alive).copy()
        alive[~np.asarray(su.params.mol_frozen)] = False
        mov = np.nonzero(~flags_np)[0]
        for mid in np.unique(mol_ids[mov]):
            rows = mov[mol_ids[mov] == mid]
            rows = rows[np.argsort(serials[rows], kind="stable")]
            name = arr["mol_names"][rows[0] * nl:(rows[0] + 1) * nl] \
                .split(b"\0")[0].decode()
            if name not in su.species_names:
                return None
            si = su.species_names.index(name)
            if (cursor[si] >= len(slots_of[si])
                    or len(rows) != su.species[si].natoms):
                return None
            slot = slots_of[si][cursor[si]]
            cursor[si] += 1
            dest[rows] = mol_atoms[slot][:len(rows)]
            alive[slot] = True
        return dest, alive

    from mpmc_tpu.io import native as native_io
    # streaming generator: one frame in memory at a time (constant
    # memory on multi-GB trajectories)
    frames_arr = native_io.stream_frames_arrays(job.pqr_input) \
        if native_io.available() else None
    avgs = Averages()
    su = None

    if frames_arr is not None:
        # zero-object fast path: the C parser hands packed arrays;
        # same-key frames write positions straight into the padded
        # state, and changed-topology frames relayout into the existing
        # slots whenever they fit (layout_frame above)
        prev_key = None
        dest = None
        nl = native_io._NAME_LEN
        for arr in frames_arr:
            key = (arr["flags"], arr["ids"][:, 1].tobytes(),
                   arr["mol_names"])
            if su is None or key != prev_key:
                fit = (layout_frame(su, arr, nl)
                       if su is not None else None)
                if fit is None:
                    su = setup(job,
                               frame=native_io.frame_from_arrays(arr))
                    flags_np = np.frombuffer(arr["flags"],
                                             np.uint8) == ord("F")
                    dest = dest_map(
                        su, arr["ids"][:, 0], arr["ids"][:, 1],
                        flags_np,
                        lambda row: arr["mol_names"][
                            row * nl:(row + 1) * nl].split(
                                b"\0")[0].decode())
                    st = su.state
                else:
                    dest, alive = fit
                    pos = np.asarray(su.state.pos).copy()
                    pos[dest] = arr["num"][:, :3]
                    st = su.state.replace(
                        pos=jnp.asarray(pos, su.cfg.jdtype),
                        mol_alive=jnp.asarray(alive))
                    if job.read_pqr_box and arr["box"] is not None:
                        st = st.replace(box=jnp.asarray(
                            arr["box"], su.cfg.jdtype))
                    su = dataclasses.replace(su, state=st)
            else:
                pos = np.asarray(su.state.pos).copy()
                pos[dest] = arr["num"][:, :3]
                st = su.state.replace(pos=jnp.asarray(pos, su.cfg.jdtype))
                if job.read_pqr_box and arr["box"] is not None:
                    st = st.replace(box=jnp.asarray(arr["box"],
                                                    su.cfg.jdtype))
                su = dataclasses.replace(su, state=st)
            prev_key = key
            state = metropolis.initialize(su.state, su.params, su.cfg,
                                          su.thermo)
            obs = observables(su, state)
            if job.calc_pressure:
                obs["pressure_atm"] = _frame_pressure(su, state, job)
            avgs.add(obs)
        writer = output_io.RunWriter(job, su.species_names if su else [],
                                     log=log)
        writer.final_averages(avgs, job.temperature)
        writer.close()
        return avgs

    frames = pqr_io.read_frames(job.pqr_input)
    su = None
    sig_prev = None
    for fr in frames:
        sig = topo_sig(fr)
        if su is not None and sig == sig_prev:
            su = refresh_positions(su, fr)
        else:
            su = setup(job, frame=fr)
        sig_prev = sig
        state = metropolis.initialize(su.state, su.params, su.cfg, su.thermo)
        obs = observables(su, state)
        if job.calc_pressure:
            obs["pressure_atm"] = _frame_pressure(su, state, job)
        avgs.add(obs)
    writer = output_io.RunWriter(job, su.species_names if su else [],
                                 log=log)
    writer.final_averages(avgs, job.temperature)
    writer.close()
    return avgs


def run_mc_pt(job: input_script.Job, log=None, jsonl_path=None):
    """Parallel-tempering MC: a geometric temperature ladder of replicas
    batched on-device, neighbor temperature swaps every ``ptemp_freq``
    steps (SURVEY.md §2 "Parallel tempering" — the reference's MPI-rank
    ladder becomes a vmapped replica batch on one chip, or a mesh of
    chips via parallel/replica.PTRunner).  Observables are reported for
    replica 0 — the base-temperature chain."""
    import numpy as _np

    from mpmc_tpu.parallel import multichain, replica

    su = setup(job)
    cfg, params, thermo = su.cfg, su.params, su.thermo
    if cfg.ensemble == "nve":
        # Ray's microcanonical acceptance never reads the temperature a
        # ladder would swap — every replica would sample the identical
        # distribution while reporting swap acceptances
        raise ValueError("parallel tempering is undefined for ensemble "
                         "nve (the NVE acceptance does not read T)")
    R = job.n_replicas or max(len(jax.devices()), 4)
    t_max = job.max_temperature or 2.0 * job.temperature
    temps = replica.geometric_ladder(job.temperature, t_max, R)
    writer = output_io.RunWriter(job, su.species_names, log=log,
                                 jsonl_path=jsonl_path)
    writer.log_meta(ensemble=cfg.ensemble, temperature=job.temperature,
                    pressure=job.pressure, fugacities=thermo.fugacity,
                    volume=float(np.abs(np.linalg.det(
                        np.asarray(su.state.box)))), n_chains=R)
    print(f"parallel tempering: {R} replicas, T = "
          + " ".join(f"{t:.2f}" for t in temps), file=writer.log)

    state = metropolis.initialize(su.state, params, cfg, thermo)
    states = multichain.stack_states(state, R, seed=cfg.seed)
    thermos = replica.stack_thermo(thermo, temps, cfg.jdtype)
    rng = _np.random.default_rng(cfg.seed + 101)
    qrot_eigs = None
    if metropolis.spinflip_active(cfg):
        # per-replica spin/rot_f state: the eigensolves are cached so a
        # temperature swap rebuilds each replica's F table at its new T
        # WITHOUT re-solving (ops/qrot.eigen_tables)
        states, qrot_eigs = _qrot_init_batched(
            su, states, temps, job.quantum_rotation_level_max)
    mesh = None
    r_loc = R
    if job.chain_devices > 1:
        # dp axis over the PT ladder: R/D replicas per device — every
        # chunk/refresh below runs shard_mapped with the per-replica
        # thermos sharded alongside (thermo_batched in_specs); the
        # ladder swap stays a global [R] op (GSPMD inserts the
        # cross-shard exchange).
        if R % job.chain_devices:
            raise ValueError(f"n_replicas {R} not divisible by "
                             f"chain_devices {job.chain_devices}")
        mesh = multichain.chain_mesh(job.chain_devices)
        r_loc = R // job.chain_devices
        states = multichain.shard_chains(states, mesh)
        thermos = multichain.shard_batched(thermos, mesh)
        params = multichain.replicate(params, mesh)
        print(f"chain sharding: {job.chain_devices} devices x "
              f"{r_loc} replicas", file=writer.log)
    avgs = Averages()
    swap_acc, swap_att = 0, 0
    corr = max(cfg.corrtime, 1)
    ptf = max(min(job.ptemp_freq, corr), 1)
    n_blocks = max(cfg.numsteps // corr, 1)
    refresh_rows = metropolis.frozen_refresh_rows(params, cfg)
    # cross-replica population histogram (reference MPI_Reduce analog:
    # every ladder rung bins, exactly like ranks — _hist_accumulate)
    hist = _hist_make(job, su.state.box)
    t0 = time.time()
    parity = 0
    for block in range(n_blocks):
        for _ in range(max(corr // ptf, 1)):
            if mesh is not None:
                states, stats = multichain.run_chunk_batched_sharded(
                    states, params, cfg, thermos, ptf, mesh,
                    thermo_batched=True)
            else:
                states, stats = multichain.run_chunk_batched(
                    states, params, cfg, thermos, ptf,
                    thermo_batched=True)
            energies = np.asarray(states.energy.total)
            # µVT ladders carry the grand-canonical
            # (beta_j/beta_i)^dN swap factor (replica.host_swap)
            n_uvt = (np.asarray(
                states.mol_alive
                & ~np.asarray(params.mol_frozen)
                & (np.asarray(params.mol_species) >= 0)).sum(axis=-1)
                if cfg.ensemble == "uvt" else None)
            temps, acc = replica.host_swap(temps, energies, parity,
                                           rng, n_mols=n_uvt)
            swap_acc += acc
            thermos = replica.stack_thermo(thermo, temps, cfg.jdtype)
            if mesh is not None:
                thermos = multichain.shard_batched(thermos, mesh)
            if cfg.feynman_hibbs or cfg.feynman_kleinert:
                # FH/FK energies are T-dependent: refresh caches
                # after a swap
                if mesh is not None:
                    states = multichain.initialize_batched_sharded(
                        states, params, cfg, thermos, mesh,
                        thermo_batched=True)
                else:
                    states = multichain.initialize_batched(
                        states, params, cfg, thermos,
                        thermo_batched=True)
            if qrot_eigs is not None:
                # rot_f is T-dependent too: rebuild each replica's
                # (F_para, F_ortho) from its CACHED eigensolves at
                # its possibly-new temperature — cheap Boltzmann
                # sums, no new eigensolves (ops/qrot.table_from_eigs)
                from mpmc_tpu.ops import qrot
                tables = _np.stack([
                    qrot.table_from_eigs(qrot_eigs[r],
                                         params.n_mols_max, temps[r])
                    for r in range(R)])
                states = states.replace(
                    rot_f=jnp.asarray(tables, cfg.jdtype))
            swap_att += max((R - parity) // 2, 0)
            parity ^= 1
        if mesh is not None:
            states = multichain.initialize_batched_sharded(
                states, params, cfg, thermos, mesh,
                thermo_batched=True, frozen_rows=refresh_rows)
        else:
            states = multichain.initialize_batched(
                states, params, cfg, thermos, thermo_batched=True,
                frozen_rows=refresh_rows)
        if qrot_eigs is not None:
            # per-corrtime hindered-rotor refresh at each replica's
            # current positions AND temperature (same staleness
            # contract as the single-chain driver)
            tables, qrot_eigs = _qrot_refresh_batched(
                su, states, temps, job.quantum_rotation_level_max)
            states = states.replace(rot_f=jnp.asarray(tables,
                                                      cfg.jdtype))
        # report the base-temperature replica (wherever T0 currently
        # lives); batched observables = one jitted call + one fetch
        # instead of ~15 scalar D2H round-trips per block
        k = int(np.argmin(temps))
        st0 = _slice_chain(states, k)
        obs_all = observables_batched(su, states, R)
        obs = obs_all[k]
        obs["swap_acceptance"] = swap_acc / max(swap_att, 1)
        avgs.add(obs)
        writer.log_block(int(st0.step), obs, None)
        writer.log_ladder(int(st0.step), temps, obs_all)
        writer.write_restart(params, st0)
        writer.write_parallel_restarts(params, states, R)
        writer.append_trajectory(params, st0)
        writer.append_parallel_trajectories(params, states, R)
        if hist is not None:
            _hist_accumulate(hist, states, params, R)
    wall = time.time() - t0
    steps_done = n_blocks * corr
    _hist_finish(hist, job, R, writer, what="replicas")
    writer.final_averages(avgs, float(np.min(temps)))
    print(f"swap acceptance: {swap_acc}/{swap_att}", file=writer.log)
    print(f"steps/sec: {steps_done * R / max(wall, 1e-9):.2f} aggregate "
          f"({R} replicas x {steps_done} steps in {wall:.2f}s)",
          file=writer.log)
    writer.close()
    return avgs


def run_mc_pt_fug(job: input_script.Job, log=None, jsonl_path=None):
    """Fixed-T FUGACITY-ladder parallel tempering (`pt_fugacity on`):
    R grand-canonical replicas at the SAME temperature, each at one
    rung of a geometric fugacity ladder from the job pressure to
    ``max_pressure``; neighbor swaps exchange fugacity rows with
    ln P = (N_i - N_j) ln(F_j / F_i) — the beta-equal limit of the
    general µVT swap rule (replica.host_swap_fugacity).  High-pressure
    rungs shuttle configurations into the slow low-pressure chains,
    and the per-block ladder records (pt_fug) from ONE run feed
    analyze.pt_gcmc_mbar -> a continuous-pressure isotherm + Qst(f)
    curve.  Beyond the reference (its PT swaps temperature only,
    SURVEY.md §2 "Parallel tempering").  Runs the batched scan path
    with host swaps."""
    import numpy as _np

    from mpmc_tpu.parallel import multichain, replica

    su = setup(job)
    cfg, params, thermo = su.cfg, su.params, su.thermo
    if cfg.ensemble != "uvt" or not cfg.insert_species:
        raise ValueError("pt_fugacity needs ensemble uvt with an "
                         "insertable sorbate (the ladder axis is the "
                         "grand-canonical fugacity)")
    if job.pressure <= 0:
        raise ValueError("pt_fugacity needs pressure > 0 (the ladder "
                         "base rung)")
    R = job.n_replicas or max(len(jax.devices()), 4)
    p_max = job.max_pressure or 10.0 * job.pressure
    if p_max <= job.pressure:
        raise ValueError(f"max_pressure {p_max} must exceed the base "
                         f"pressure {job.pressure}")
    scales = np.geomspace(1.0, p_max / job.pressure, R)
    base = np.asarray(thermo.fugacity, np.float64)
    fug_rows = scales[:, None] * base[None, :]
    writer = output_io.RunWriter(job, su.species_names, log=log,
                                 jsonl_path=jsonl_path)
    writer.log_meta(ensemble=cfg.ensemble, temperature=job.temperature,
                    pressure=job.pressure, fugacities=thermo.fugacity,
                    volume=float(np.abs(np.linalg.det(
                        np.asarray(su.state.box)))), n_chains=R)
    print(f"fugacity-ladder PT: {R} replicas at T={job.temperature}, "
          "F_total = "
          + " ".join(f"{v:.4g}" for v in fug_rows.sum(axis=1)),
          file=writer.log)

    state = metropolis.initialize(su.state, params, cfg, thermo)
    states = multichain.stack_states(state, R, seed=cfg.seed)
    thermos = replica.stack_thermo_fugacity(thermo, fug_rows, cfg.jdtype)
    rng = _np.random.default_rng(cfg.seed + 103)
    qrot_eigs = None
    temps_const = [float(job.temperature)] * R
    if metropolis.spinflip_active(cfg):
        states, qrot_eigs = _qrot_init_batched(
            su, states, temps_const, job.quantum_rotation_level_max)
    avgs = Averages()
    swap_acc, swap_att = 0, 0
    corr = max(cfg.corrtime, 1)
    ptf = max(min(job.ptemp_freq, corr), 1)
    n_blocks = max(cfg.numsteps // corr, 1)
    refresh_rows = metropolis.frozen_refresh_rows(params, cfg)
    hist = _hist_make(job, su.state.box)
    t0 = time.time()
    parity = 0
    for block in range(n_blocks):
        for _ in range(max(corr // ptf, 1)):
            states, stats = multichain.run_chunk_batched(
                states, params, cfg, thermos, ptf,
                thermo_batched=True)
            n_mov = np.asarray(
                states.mol_alive
                & ~np.asarray(params.mol_frozen)
                & (np.asarray(params.mol_species) >= 0)).sum(axis=-1)
            fug_rows, acc = replica.host_swap_fugacity(
                fug_rows, n_mov, parity, rng)
            swap_acc += acc
            thermos = dataclasses.replace(
                thermos, fugacity=jnp.asarray(fug_rows, cfg.jdtype))
            swap_att += max((R - parity) // 2, 0)
            parity ^= 1
            # no energy/rot_f refresh needed: beta is shared, so a
            # fugacity swap changes acceptance rules only — cached
            # energies and rotor tables stay valid (FH/FK included)
        states = multichain.initialize_batched(
            states, params, cfg, thermos, thermo_batched=True,
            frozen_rows=refresh_rows)
        if qrot_eigs is not None:
            tables, qrot_eigs = _qrot_refresh_batched(
                su, states, temps_const, job.quantum_rotation_level_max)
            states = states.replace(rot_f=jnp.asarray(tables,
                                                      cfg.jdtype))
        # report the base-pressure rung (wherever it currently lives)
        f_tot = fug_rows.sum(axis=1)
        k = int(np.argmin(f_tot))
        st0 = _slice_chain(states, k)
        obs_all = observables_batched(su, states, R)
        obs = obs_all[k]
        obs["swap_acceptance"] = swap_acc / max(swap_att, 1)
        avgs.add(obs)
        writer.log_block(int(st0.step), obs, None)
        writer.log_ladder(int(st0.step), temps_const, obs_all,
                          fugacities=f_tot)
        writer.write_restart(params, st0)
        writer.write_parallel_restarts(params, states, R)
        writer.append_trajectory(params, st0)
        writer.append_parallel_trajectories(params, states, R)
        if hist is not None:
            _hist_accumulate(hist, states, params, R)
    wall = time.time() - t0
    steps_done = n_blocks * corr
    _hist_finish(hist, job, R, writer, what="replicas")
    writer.final_averages(avgs, float(job.temperature))
    print(f"swap acceptance: {swap_acc}/{swap_att}", file=writer.log)
    print(f"steps/sec: {steps_done * R / max(wall, 1e-9):.2f} aggregate "
          f"({R} replicas x {steps_done} steps in {wall:.2f}s)",
          file=writer.log)
    writer.close()
    return avgs


def run_mc_chains(job: input_script.Job, log=None, jsonl_path=None):
    """Many independent chains batched on-device (``chains N``): the
    replica-throughput production mode — observables are averaged across
    chains each corrtime (cross-chain averaging is the reference's MPI
    observable reduce, SURVEY.md §2 "MPI layer"); restart/trajectory
    follow chain 0."""
    from mpmc_tpu.parallel import multichain

    su = setup(job)
    cfg, params, thermo = su.cfg, su.params, su.thermo
    writer = output_io.RunWriter(job, su.species_names, log=log,
                                 jsonl_path=jsonl_path)
    writer.log_meta(ensemble=cfg.ensemble, temperature=job.temperature,
                    pressure=job.pressure, fugacities=thermo.fugacity,
                    volume=float(np.abs(np.linalg.det(
                        np.asarray(su.state.box)))), n_chains=job.chains)
    C = job.chains
    print(f"batched chains: {C}", file=writer.log)
    if cfg.spectre:
        print("WARNING: spectre charge renormalization runs only in the "
              "single-chain driver (chains 1)", file=writer.log)
    state = metropolis.initialize(su.state, params, cfg, thermo)
    states = multichain.stack_states(state, C, seed=cfg.seed)
    qrot_on = metropolis.spinflip_active(cfg)
    if qrot_on:
        # per-chain spin/rot_f state; the eigs caches are rebuilt per
        # corrtime, so the returned caches are not kept here
        states, _ = _qrot_init_batched(
            su, states, [float(thermo.temperature)] * C,
            job.quantum_rotation_level_max)
    mesh = None
    c_loc = C
    if job.chain_devices > 1:
        # dp axis: C/D chains per device over a 1-D mesh; every chunk
        # and refresh below runs shard_mapped (the
        # reference's MPI-rank independence, one device = D ranks)
        mesh = multichain.chain_mesh(job.chain_devices)
        if C % job.chain_devices:
            raise ValueError(f"chains {C} not divisible by "
                             f"chain_devices {job.chain_devices}")
        c_loc = C // job.chain_devices
        states = multichain.shard_chains(states, mesh)
        params, thermo = multichain.replicate((params, thermo), mesh)
        print(f"chain sharding: {job.chain_devices} devices x "
              f"{c_loc} chains", file=writer.log)
    avgs = Averages()
    corr = max(cfg.corrtime, 1)
    n_blocks = max(cfg.numsteps // corr, 1)
    refresh_rows = metropolis.frozen_refresh_rows(params, cfg)
    # chain-summed TMMC host accumulator (f64, flushed per corrtime —
    # see the single-chain driver note); all chains sample one state so
    # their collection statistics pool
    tmmc_host = 0.0
    # population histogram reduced over ALL chains (the reference
    # MPI-reduces per-rank histograms to rank 0 — _hist_accumulate)
    hist = _hist_make(job, states.box[0])
    t0 = time.time()
    for block in range(n_blocks):
        if mesh is not None:
            states, stats = multichain.run_chunk_batched_sharded(
                states, params, cfg, thermo, corr, mesh)
            states = multichain.initialize_batched_sharded(
                states, params, cfg, thermo, mesh,
                frozen_rows=refresh_rows)
        else:
            states, stats = multichain.run_chunk_batched(
                states, params, cfg, thermo, corr)
            states = multichain.initialize_batched(
                states, params, cfg, thermo, frozen_rows=refresh_rows)
        if qrot_on:
            # per-corrtime hindered-rotor refresh (tracks annealing T)
            tables, _ = _qrot_refresh_batched(
                su, states, [float(thermo.temperature)] * C,
                job.quantum_rotation_level_max)
            states = states.replace(rot_f=jnp.asarray(tables,
                                                      cfg.jdtype))
        # per-chain observables -> cross-chain mean (+ _sem spread);
        # ONE jitted call + ONE host fetch for the whole batch
        per_chain = observables_batched(su, states, C)
        # mean over the chains that REPORT each key (polar_rrms is
        # omitted for chains whose polarizable sites all died)
        all_keys = []
        for o in per_chain:
            all_keys.extend(k for k in o if k not in all_keys)
        obs = {k: float(np.mean([o[k] for o in per_chain if k in o]))
               for k in all_keys}
        obs["N_sem_chains"] = float(np.std([o["N"] for o in per_chain])
                                    / np.sqrt(max(C, 1)))
        att = np.maximum(np.asarray(stats.attempts).sum(0), 1)
        acc = np.asarray(stats.accepts).sum(0) / att
        for i, nm in enumerate(("displace", "insert", "delete", "volume",
                                "spinflip")):
            obs[f"acc_{nm}"] = float(acc[i])
        avgs.add(obs)
        st0 = _slice_chain(states, 0)
        writer.log_block(int(st0.step), obs, None)
        writer.write_restart(params, st0)
        writer.write_parallel_restarts(params, states, C)
        writer.append_trajectory(params, st0)
        writer.append_parallel_trajectories(params, states, C)
        if hist is not None:
            _hist_accumulate(hist, states, params, C)
        if job.adapt_moves:
            scale = float(np.clip(
                np.sqrt(max(obs["acc_displace"], 1e-3) / 0.5), 0.5, 2.0))
            rc_now = float(pairs_mod.derived_cutoff(st0.box, cfg))
            thermo = thermo.replace(
                move_factor=jnp.asarray(
                    np.clip(float(thermo.move_factor) * scale, 1e-3,
                            rc_now), cfg.jdtype),
                rot_factor=jnp.asarray(
                    np.clip(float(thermo.rot_factor) * scale, 1e-3,
                            np.pi), cfg.jdtype))
        if cfg.tmmc and states.tmmc_c is not None:
            tmmc_host = tmmc_host + np.asarray(
                states.tmmc_c, np.float64).sum(axis=0)
            states = states.replace(
                tmmc_c=jnp.zeros_like(states.tmmc_c))
        if cfg.tmmc_bias and np.ndim(tmmc_host):
            # shared bias from the chain-summed collection (all chains
            # sample the same state, so their statistics pool)
            from mpmc_tpu import analyze as analyze_mod
            eta = analyze_mod.tmmc_eta(tmmc_host)
            if eta is not None:
                thermo = thermo.replace(
                    tmmc_eta=jnp.asarray(eta, cfg.jdtype))
        if job.simulated_annealing:
            new_t = max(float(thermo.temperature)
                        * job.simulated_annealing_schedule,
                        job.simulated_annealing_target)
            thermo = thermo.replace(
                temperature=jnp.asarray(new_t, cfg.jdtype))
    wall = time.time() - t0
    steps_done = n_blocks * corr
    _hist_finish(hist, job, C, writer)
    if cfg.tmmc and np.ndim(tmmc_host):
        # independent chains at the same (T, f): collection matrices sum
        path = output_io.write_tmmc(
            job.tmmc_output or "tmmc.json",
            tmmc_host,
            temperature=float(thermo.temperature),
            fugacities=[float(f) for f in np.asarray(thermo.fugacity)],
            volume=float(np.abs(np.linalg.det(np.asarray(st0.box)))),
            species=su.species_names,
            insert_species=cfg.insert_species[0])
        print(f"tmmc collection matrix ({C} chains summed) written to "
              f"{path}", file=writer.log)
    writer.final_averages(avgs, float(thermo.temperature),
                          fugacities=np.asarray(thermo.fugacity))
    print(f"steps/sec: {steps_done * C / max(wall, 1e-9):.2f} aggregate "
          f"({C} chains x {steps_done} steps in {wall:.2f}s)",
          file=writer.log)
    writer.close()
    return Setup(params, st0, cfg, thermo, su.species, su.species_names,
                 su.frozen_mass), avgs


def run_mc(job: input_script.Job, log=None, jsonl_path=None):
    """The main MC loop (ensemble nvt/uvt/npt/nve)."""
    if job.pt_fugacity:     # implies parallel tempering (fugacity axis)
        return run_mc_pt_fug(job, log=log, jsonl_path=jsonl_path)
    if job.parallel_tempering:
        return run_mc_pt(job, log=log, jsonl_path=jsonl_path)
    if job.chains > 1:
        return run_mc_chains(job, log=log, jsonl_path=jsonl_path)
    su = setup(job)
    cfg, params = su.cfg, su.params
    thermo = su.thermo
    writer = output_io.RunWriter(job, su.species_names, log=log,
                                 jsonl_path=jsonl_path)
    writer.log_meta(ensemble=cfg.ensemble, temperature=job.temperature,
                    pressure=job.pressure, fugacities=thermo.fugacity,
                    volume=float(np.abs(np.linalg.det(
                        np.asarray(su.state.box)))))
    if job.unknown_options:
        print(f"WARNING: unknown options ignored: {job.unknown_options}",
              file=writer.log)
    if cfg.tmmc_bias:
        print("tmmc_bias: flat-histogram sampling — raw block averages "
              "are bias-weighted; read the isotherm from 'analyze tmmc' "
              "on the collection matrix", file=writer.log)
    state = metropolis.initialize(su.state, params, cfg, thermo)
    if job.frozen_output:
        # framework-only PQR, written once (SURVEY §2.9 "I/O")
        frame = pqr_io.read(job.pqr_input)
        pqr_io.write(job.frozen_output, frame.frozen,
                     remark="frozen framework")
    avgs = Averages()
    # TMMC host-side float64 accumulator: the device collection matrix is
    # flushed into it (and zeroed) every corrtime so the f32 on-device
    # sums never approach the 2^24 increment ceiling on long production
    # runs (r2 advisor finding); 0.0 broadcasts to the matrix on first use
    tmmc_host = 0.0
    # quantum rotation: spinflip is a per-step MC move driven by cached
    # hindered-rotor free energies, refreshed at every corrtime
    # (SURVEY.md §2 "Quantum rotation" / "Moves / checkpoint").
    # Must run BEFORE a checkpoint load so the resume template has the
    # spin/rot_f leaves a quantum-rotation checkpoint carries.
    if cfg.quantum_rotation:
        from mpmc_tpu.ops import qrot
        qr_rng = np.random.default_rng(cfg.seed + 977)
        # normal-H2 initial mixture: 3:1 ortho:para
        spins0 = (qr_rng.random(params.n_mols_max) < 0.75).astype(np.int32)
        table = qrot.free_energy_table(
            state.pos, state.box, state.atom_alive(params),
            state.mol_alive, params, cfg, thermo, list(su.species),
            lmax=job.quantum_rotation_level_max)
        state = state.replace(spin=jnp.asarray(spins0),
                              rot_f=jnp.asarray(table, cfg.jdtype))
    if job.checkpoint_input:
        from mpmc_tpu.io import checkpoint as ckpt
        state, avgs, _ckpt_extra = ckpt.load(job.checkpoint_input, state)
        if "tmmc_host" in _ckpt_extra:
            tmmc_host = np.asarray(_ckpt_extra["tmmc_host"], np.float64)
        print(f"resumed exactly from {job.checkpoint_input} at step "
              f"{int(np.asarray(state.step))}", file=writer.log)
    hist = None
    if job.pop_histogram or job.histogram_output:
        from mpmc_tpu.state import all_molecule_coms
        from mpmc_tpu.utils.histogram import PopulationHistogram
        hist = PopulationHistogram(np.asarray(state.box),
                                   job.hist_resolution)
    corr = max(cfg.corrtime, 1)
    n_blocks = max(cfg.numsteps // corr, 1)
    t0 = time.time()
    steps_done = 0
    spectre_idx = None
    if cfg.spectre:
        from mpmc_tpu.mc import spectre as spectre_mod
        spectre_idx = spectre_mod.spectre_atom_indices(
            params, su.spectre_species)
        print(f"spectre: {len(spectre_idx)} free-charge sites",
              file=writer.log)
    spatial_mesh = None
    if job.spatial_devices > 1 and cfg.ensemble in ("nvt", "uvt", "npt",
                                                    "nve"):
        # in-loop spatial sharding of the scan-path MC step: state
        # replicated, O(A N)/O(N^2) pair passes split over the mesh
        # (parallel/spatial.run_chunk_spatial — r2 verdict item 3)
        from mpmc_tpu.parallel import spatial
        if not spatial.mc_supported(cfg):
            raise ValueError(
                "spatial_devices with this configuration is "
                "unsupported in the MC loop (needs the scan-path jnp "
                "surface: no cdvdw/cell_list/rd_crystal/mol_cache/"
                "spectre; polarization only on the direct damped "
                "field, not polar_ewald/polar_wolf)")
        devs = jax.devices()[:job.spatial_devices]
        if len(devs) < job.spatial_devices:
            raise ValueError(
                f"spatial_devices {job.spatial_devices} but only "
                f"{len(jax.devices())} devices available")
        spatial_mesh = jax.sharding.Mesh(np.array(devs),
                                         (spatial.AXIS,))
        print(f"spatial MC step: {job.spatial_devices} devices "
              "(replicated state, sharded pair passes)",
              file=writer.log)
    refresh_rows = metropolis.frozen_refresh_rows(params, cfg)
    spectre_on = spectre_idx is not None and len(spectre_idx)
    for block in range(n_blocks):
        if spatial_mesh is not None:
            from mpmc_tpu.parallel import spatial
            state, stats = spatial.run_chunk_spatial(
                state, params, cfg, thermo, corr, spatial_mesh)
        else:
            state, stats = metropolis.run_chunk(state, params, cfg,
                                                thermo, corr)
        steps_done += corr
        if spectre_on:
            # renormalize free charges, then let the full refresh below
            # rebuild every charge-dependent cache (mc/spectre.py)
            from mpmc_tpu.mc import spectre as spectre_mod
            params = spectre_mod.apply(params, spectre_idx, cfg)
            su = dataclasses.replace(su, params=params)
        # per-corrtime refresh; frozen-reuse fast path where provably
        # safe (fr=0 under NPT/FH/FK/spectre — frozen_refresh_rows)
        if spatial_mesh is not None:
            from mpmc_tpu.parallel import spatial
            state = spatial.initialize_spatial(
                state, params, cfg, thermo, spatial_mesh,
                frozen_rows=refresh_rows)
        else:
            state = metropolis.initialize(state, params, cfg, thermo,
                                          frozen_rows=refresh_rows)
        if cfg.quantum_rotation:
            from mpmc_tpu.ops import qrot
            table = qrot.free_energy_table(
                state.pos, state.box, state.atom_alive(params),
                state.mol_alive, params, cfg, thermo, list(su.species),
                lmax=job.quantum_rotation_level_max)
            state = state.replace(rot_f=jnp.asarray(table, cfg.jdtype))
        obs = observables(su, state, stats)
        if spectre_idx is not None and len(spectre_idx):
            qs = np.asarray(params.charge)[spectre_idx]
            obs["spectre_total_charge"] = float(np.sum(np.abs(qs)))
            obs["spectre_max_abs_charge"] = float(np.max(np.abs(qs)))
        if cfg.quantum_vibration:
            from mpmc_tpu.ops import qvib
            vt = qvib.vibration_table(
                state.pos, state.box, state.atom_alive(params),
                state.mol_alive, params, cfg, thermo, list(su.species))
            ok = ~np.isnan(vt[:, 0])
            if ok.any():
                hw = {i: float(sp.vib_omega) * qvib.CM1_K
                      for i, sp in enumerate(su.species)}
                sidx = np.asarray(params.mol_species)[ok]
                free = np.array([hw.get(int(s), 0.0) for s in sidx])
                obs["qvib_zpe"] = float(vt[ok, 0].mean())
                obs["qvib_fundamental_shift"] = float(
                    ((vt[ok, 1] - vt[ok, 0]) - free).mean())
        avgs.add(obs)
        writer.log_block(int(state.step), obs, stats)
        writer.write_restart(params, state)
        writer.append_trajectory(params, state)
        writer.write_dipoles(params, state)
        if hist is not None:
            from mpmc_tpu.state import all_molecule_coms
            coms = np.asarray(all_molecule_coms(state.pos, params))
            sel = (np.asarray(state.mol_alive)
                   & ~np.asarray(params.mol_frozen)
                   & (np.asarray(params.mol_species) >= 0))
            hist.add(coms[sel])
        if cfg.tmmc and state.tmmc_c is not None:
            # flush to host f64 each corrtime (per-block f32 sums stay
            # far below the 2^24 ceiling; the running total is exact)
            tmmc_host = tmmc_host + np.asarray(state.tmmc_c, np.float64)
            state = state.replace(tmmc_c=jnp.zeros_like(state.tmmc_c))
        if job.checkpoint_output:
            from mpmc_tpu.io import checkpoint as ckpt
            ckpt.save(job.checkpoint_output, state, avgs,
                      extra=({"tmmc_host": np.asarray(tmmc_host).tolist()}
                             if cfg.tmmc else None))
        if job.adapt_moves:
            # nudge displacement/rotation sizes toward ~50% acceptance
            # (reference's move_factor/rot_factor adaptation, SURVEY §2
            # "MC main loop" [M]); sqrt damping keeps it stable
            acc = obs.get("acc_displace", 0.5)
            scale = float(np.clip(np.sqrt(max(acc, 1e-3) / 0.5), 0.5, 2.0))
            rc_now = float(pairs_mod.derived_cutoff(state.box, cfg))
            new_mf = float(np.clip(float(thermo.move_factor) * scale,
                                   1e-3, rc_now))
            new_rf = float(np.clip(float(thermo.rot_factor) * scale,
                                   1e-3, np.pi))
            thermo = thermo.replace(
                move_factor=jnp.asarray(new_mf, cfg.jdtype),
                rot_factor=jnp.asarray(new_rf, cfg.jdtype))
        if cfg.tmmc_bias and np.ndim(tmmc_host):
            # rebuild the flat-histogram bias from the accumulated
            # collection matrix (the collection itself stays unbiased,
            # so this never perturbs the lnΠ estimator)
            from mpmc_tpu import analyze as analyze_mod
            eta = analyze_mod.tmmc_eta(tmmc_host)
            if eta is not None:
                thermo = thermo.replace(
                    tmmc_eta=jnp.asarray(eta, cfg.jdtype))
        if job.simulated_annealing:
            new_t = max(float(thermo.temperature)
                        * job.simulated_annealing_schedule,
                        job.simulated_annealing_target)
            thermo = thermo.replace(
                temperature=jnp.asarray(new_t, cfg.jdtype))
    wall = time.time() - t0
    if hist is not None:
        path = job.histogram_output or "histogram.dx"
        hist.write_dx(path)
        print(f"population histogram written to {path}", file=writer.log)
    if cfg.tmmc and np.ndim(tmmc_host):
        path = output_io.write_tmmc(
            job.tmmc_output or "tmmc.json", tmmc_host,
            temperature=float(thermo.temperature),
            fugacities=[float(f) for f in np.asarray(thermo.fugacity)],
            volume=float(np.abs(np.linalg.det(np.asarray(state.box)))),
            species=su.species_names,
            insert_species=cfg.insert_species[0])
        print(f"tmmc collection matrix written to {path}",
              file=writer.log)
    if job.pqr_output:
        pqr_io.write_state(job.pqr_output, params, state, su.species_names,
                           remark=f"final step {int(np.asarray(state.step))}")
    writer.final_averages(avgs, float(thermo.temperature),
                          fugacities=np.asarray(thermo.fugacity))
    print(f"steps/sec: {steps_done / max(wall, 1e-9):.2f}  "
          f"({steps_done} steps in {wall:.2f}s)", file=writer.log)
    writer.close()
    return Setup(params, state, cfg, thermo, su.species,
                 su.species_names, su.frozen_mass), avgs


def run(job: input_script.Job, **kw):
    if job.cfg.ensemble in ("nvt", "uvt", "npt", "nve"):
        return run_mc(job, **kw)
    if job.cfg.ensemble == "te":
        return run_te(job, **kw)
    if job.cfg.ensemble == "replay":
        return run_replay(job, **kw)
    if job.cfg.ensemble == "surf":
        from mpmc_tpu.mc import surface
        kw.pop("jsonl_path", None)
        return surface.run_surface(job, **kw)
    if job.cfg.ensemble == "surf_fit":
        from mpmc_tpu.mc import surface
        kw.pop("jsonl_path", None)
        return surface.run_surface_fit(job, **kw)
    if job.cfg.ensemble == "surf_multi_fit":
        from mpmc_tpu.mc import surface
        kw.pop("jsonl_path", None)
        return surface.run_surface_multi_fit(job, **kw)
    raise NotImplementedError(
        f"ensemble {job.cfg.ensemble!r} not yet implemented")
