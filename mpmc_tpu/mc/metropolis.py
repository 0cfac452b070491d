"""The Metropolis Monte Carlo engine: one jit-compiled step under lax.scan.

Rebuild of the reference's MC main loop + acceptance machinery
(SURVEY.md §2 "MC main loop" / "Moves / checkpoint" /
"Boltzmann/acceptance", src/mc/mc.c + mc_moves.c [C]; call stack §3.1):

- move selection by probability thresholds (displace | insert | delete |
  volume), ensemble-gated statically;
- delta energy via the O(A*N) molecule pair pass + cached Ewald structure
  factor (the functional analog of the reference's per-pair
  ``recalculate_energy`` caching, §1 "delta energy");
- ensemble-specific acceptance rules (§3.3): NVT exp(-b dE); uVT insert
  (fV/kT(N+1)) exp(-b dE), delete (N kT/fV) exp(-b dE); NPT
  exp(-b dE - b P dV + (N+1) dlnV);
- ``cavity_autoreject_absolute`` overlap short-circuit;
- polarization SCF re-solved per trial (warm-started from the cached
  dipoles) — the reference's per-step bottleneck, here a masked CG.

Everything is fixed-shape: GCMC inserts claim dead species slots, deletes
clear alive flags (SURVEY.md §7 "Core state").
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp

from mpmc_tpu.config import RunConfig, Thermo
from mpmc_tpu.constants import ATM2K_A3
from mpmc_tpu.mc import moves
from mpmc_tpu.ops import energy as energy_mod
from mpmc_tpu.ops import ewald, pairs, thole
from mpmc_tpu.state import (EnergyBreakdown, Params, SimState, mol_rows,
                            mol_rows_update)

# global move-type ids (stats indexing)
DISPLACE, INSERT, DELETE, VOLUME, SPINFLIP = 0, 1, 2, 3, 4
N_MOVE_TYPES = 5


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MCStats:
    attempts: jax.Array   # [N_MOVE_TYPES] int32
    accepts: jax.Array    # [N_MOVE_TYPES] int32
    polar_iters: jax.Array  # total SCF iterations this chunk

    @classmethod
    def zero(cls):
        z = jnp.zeros(N_MOVE_TYPES, jnp.int32)
        return cls(z, z, jnp.zeros((), jnp.int32))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Candidate:
    """A proposed state + the information needed for acceptance.

    Two position encodings (statically chosen per (cfg.ensemble,
    polarization, cdvdw) in make_step_fn):

    - full mode: ``pos`` holds the complete candidate array (volume moves
      rescale everything; polarization/cdvdw need full trial positions);
    - row mode: ``pos`` is None and only ``(mol, rows)`` carry the moved
      molecule's trial coordinates — acceptance then scatters A rows
      instead of selecting the whole [N,3] array, which removes the
      O(N) per-step HBM traffic that dominates large-N batched chains.
    """
    pos: Optional[jax.Array]
    box: jax.Array
    mol_alive: jax.Array
    sk_re: Optional[jax.Array]
    sk_im: Optional[jax.Array]
    denergy: EnergyBreakdown       # all slots except polar
    ln_bias: jax.Array             # ensemble proposal-bias log factor
    hard_reject: jax.Array         # bool
    spin_mol: jax.Array = dataclasses.field(
        default_factory=lambda: jnp.asarray(-1, jnp.int32))
    # >=0: molecule whose nuclear-spin species flips on accept
    mol: jax.Array = dataclasses.field(
        default_factory=lambda: jnp.asarray(0, jnp.int32))
    rows: Optional[jax.Array] = None   # [A,3] trial rows (row mode)
    # cache mode: the moved molecule's fresh per-column-molecule partial
    # sums [M] (rd, es_real, lrc) — scattered into the cache_* matrices'
    # row+column ``mol`` on accept
    col_rd: Optional[jax.Array] = None
    col_es: Optional[jax.Array] = None
    col_lrc: Optional[jax.Array] = None
    # polar delta-field mode: the trial static field (O(A N) update of
    # the cached e0 — ops/thole.field_delta); None when the config
    # rebuilds the field in full
    e0: Optional[jax.Array] = None
    # analytic initial CG residual for the candidate polar solve
    # (ops/thole.residual_delta) — skips the warm start's full matvec
    r0: Optional[jax.Array] = None


def cache_eligible(cfg: RunConfig) -> bool:
    """Static gate for the molecule-pair energy cache: fixed box (no
    NPT volume rescales), pairwise-only terms (no polarization / cdvdw
    many-body re-solves), and the dense jnp delta path (the cell-list
    culled path doesn't emit per-molecule partials)."""
    return (cfg.mol_cache
            and cfg.ensemble in ("nvt", "uvt", "nve")
            and not cfg.polarization
            and not cfg.cdvdw
            and not cfg.rd_crystal
            and not cfg.cell_list
            # SPECTRE rewrites params.charge every corrtime; cached ES
            # entries written with the old charges would go stale
            and not cfg.spectre)


def spinflip_active(cfg: RunConfig) -> bool:
    """Spinflip carries its rotor free-energy change only in ln_bias,
    which Ray's NVE acceptance rule replaces with the kinetic-reservoir
    weight — under NVE every flip would be accepted unconditionally
    (denergy = 0), breaking ortho/para detailed balance.  Exclude the
    move there instead (SURVEY §2 "Quantum rotation"; ADVICE r1)."""
    return cfg.quantum_rotation and cfg.ensemble != "nve"


def _movable_mask(params: Params, mol_alive):
    return mol_alive & ~params.mol_frozen & (params.mol_species >= 0)


def _insertable_mask(params: Params, cfg: RunConfig):
    m = jnp.zeros_like(params.mol_frozen)
    for s in cfg.insert_species:
        m = m | (params.mol_species == s)
    return m


def _overlap_r2(min_r2, cfg, dtype):
    if cfg.cavity_autoreject_absolute > 0.0:
        thr = jnp.asarray(cfg.cavity_autoreject_absolute, dtype)
        return min_r2 < thr * thr
    return jnp.zeros((), bool)


def _overlap(pt, cfg, dtype):
    return _overlap_r2(pt.min_r2, cfg, dtype)


def _pol_sk(state: SimState, cfg):
    """Cached pre-move structure factor for the polar_ewald field delta
    (thole.move_deltas ``sk``) — available whenever the energy path
    maintains S(k); None otherwise (move_deltas recomputes)."""
    if cfg.coulomb == "ewald":
        return (state.sk_re, state.sk_im)
    return None


def _recip_delta(state: SimState, cfg, d_re, d_im):
    """New (sk, es_recip delta) after adding (d_re, d_im) to S(k)."""
    new_re = state.sk_re + d_re
    new_im = state.sk_im + d_im
    rc = pairs.derived_cutoff(state.box, cfg)
    alpha = pairs.derived_alpha(rc, cfg)
    kv, pw = ewald.ktable(state.box, cfg)
    e_new = ewald.recip_energy_from_sk(new_re, new_im, state.box, alpha,
                                       kv, pw)
    return new_re, new_im, e_new - state.energy.es_recip


def _mol_structure_factor(pos, box, params, cfg, mol):
    ok = (jnp.arange(params.max_atoms_per_mol)
          < params.mol_natoms[mol])
    kv, _ = ewald.ktable(box, cfg)
    return ewald.mol_structure_factor(mol_rows(pos, params, mol),
                                      mol_rows(params.charge, params, mol),
                                      ok, kv)


def _mol_sf_rows(rows, box, params, cfg, mol):
    """Structure factor of one molecule from explicit trial rows."""
    ok = (jnp.arange(params.max_atoms_per_mol)
          < params.mol_natoms[mol])
    kv, _ = ewald.ktable(box, cfg)
    return ewald.mol_structure_factor(rows,
                                      mol_rows(params.charge, params, mol),
                                      ok, kv)


def _mol_sf_delta(pos, new_rows, box, params, cfg, mol):
    """S(k) change of moving one molecule, in one fused evaluation:
    the trial rows enter with +q and the current rows with -q."""
    ok = (jnp.arange(params.max_atoms_per_mol)
          < params.mol_natoms[mol])
    kv, _ = ewald.ktable(box, cfg)
    rows = jnp.concatenate([new_rows, mol_rows(pos, params, mol)])
    q = mol_rows(params.charge, params, mol)
    return ewald.mol_structure_factor(
        rows, jnp.concatenate([q, -q]), jnp.concatenate([ok, ok]), kv)


def _mol_self_energy(params, cfg, box, mol):
    """Self-energy of one molecule's charges (GCMC +/- delta): Ewald
    -ke a/sqrt(pi) sum q^2, Wolf -ke (erfc(a rc)/2rc + a/sqrt(pi))
    sum q^2 — both per-charge constants, so insert/delete deltas are
    exact (ops/ewald.self_energy / wolf_self_energy)."""
    if cfg.coulomb not in ("ewald", "wolf"):
        return jnp.zeros((), params.charge.dtype)
    rc = pairs.derived_cutoff(box, cfg)
    alpha = pairs.derived_alpha(rc, cfg)
    ok = (jnp.arange(params.max_atoms_per_mol)
          < params.mol_natoms[mol])
    q2 = jnp.where(ok, mol_rows(params.charge, params, mol) ** 2, 0.0)
    from mpmc_tpu.constants import KE
    coef = alpha / jnp.sqrt(jnp.pi)
    if cfg.coulomb == "wolf":
        from jax.scipy.special import erfc
        coef = coef + erfc(alpha * rc) / (2.0 * rc)
    return -KE * coef * jnp.sum(q2)


def _background_delta(state, params, cfg, mol, sign):
    """Jellium-background delta for inserting (sign=+1) / deleting
    (sign=-1) molecule ``mol``:  c_bg [(Q + sign q_m)^2 - Q^2]
    (ops/ewald.background_correction; r2 verdict item 6).  Exact zero
    for neutral templates — the common case — since q_m = 0."""
    from mpmc_tpu.ops import ewald
    rc = pairs.derived_cutoff(state.box, cfg)
    alpha = pairs.derived_alpha(rc, cfg)
    volume = jnp.abs(jnp.linalg.det(state.box))
    ok = (jnp.arange(params.max_atoms_per_mol)
          < params.mol_natoms[mol])
    q_m = jnp.sum(jnp.where(ok, mol_rows(params.charge, params, mol),
                            0.0))
    q_tot = jnp.sum(jnp.where(state.atom_alive(params), params.charge,
                              0.0))
    c_bg = ewald.background_coefficient(alpha, volume)
    return c_bg * (2.0 * sign * q_tot * q_m + q_m * q_m)


def make_branch_picker(cfg: RunConfig):
    """(pick_branch(key, thermo) -> branch index, branch_ids) for the
    ensemble's move table — move-type probabilities follow the reference
    (SURVEY.md §2 "Moves / checkpoint": insert_probability split evenly
    between insert and delete; volume_probability for NPT;
    spinflip_probability carves out the spinflip move when
    quantum_rotation is on)."""
    if cfg.ensemble == "uvt" and cfg.insert_species:
        ids = [DISPLACE, INSERT, DELETE]

        def pick_base(key, thermo):
            k1, k2 = jax.random.split(key)
            u = jax.random.uniform(k1)
            coin = jax.random.uniform(k2) < 0.5
            return jnp.where(u < thermo.insert_probability,
                             jnp.where(coin, 1, 2), 0)
    elif cfg.ensemble == "npt":
        ids = [DISPLACE, VOLUME]

        def pick_base(key, thermo):
            u = jax.random.uniform(key)
            return jnp.where(u < thermo.volume_probability, 1, 0)
    else:   # nvt / nve / single-molecule ensembles
        ids = [DISPLACE]

        def pick_base(key, thermo):
            return jnp.zeros((), jnp.int32)

    if not spinflip_active(cfg):
        if cfg.quantum_rotation and cfg.ensemble == "nve":
            import warnings
            warnings.warn("quantum_rotation spinflip moves are disabled "
                          "under ensemble nve (the rotor free-energy "
                          "change has no kinetic-reservoir counterpart)")
        return pick_base, jnp.asarray(ids)

    n_base = len(ids)
    ids = ids + [SPINFLIP]

    def pick_branch(key, thermo):
        ks, kb = jax.random.split(key)
        u = jax.random.uniform(ks)
        return jnp.where(u < thermo.spinflip_probability,
                         jnp.asarray(n_base, jnp.int32),
                         pick_base(kb, thermo))
    return pick_branch, jnp.asarray(ids)


def make_step_fn(params: Params, cfg: RunConfig):
    """Build the jitted single-step function for this (params, cfg)."""
    dtype = cfg.jdtype
    zero = jnp.zeros((), dtype)
    ez = EnergyBreakdown.zero(dtype)
    # row mode (see Candidate): acceptance scatters only the moved
    # molecule's rows.  Volume moves rescale every position and the
    # polarization/cdvdw terms evaluate full trial geometries, so those
    # configurations keep the full-array candidate.
    row_level = (cfg.ensemble != "npt" and not cfg.polarization
                 and not cfg.cdvdw)
    # cache mode: molecule-pair energy cache (ops/pairs.pair_matrix) —
    # displace reads its old interactions from the cache (one pass),
    # delete reads everything from it (zero passes)
    cache_mode = cache_eligible(cfg)
    zcol = jnp.zeros((params.n_mols_max,), dtype)
    # polar delta field: update the cached e0 in O(A N) per move instead
    # of rebuilding the O(N^2) direct field per trial
    pol_delta = cfg.polarization and thole.field_delta_supported(cfg)
    # analytic initial residual: also skip the candidate solve's warm-up
    # matvec (npt excluded — the volume branch rescales every position,
    # so no O(A N) residual update exists and the branch pytrees must
    # agree under lax.switch)
    pol_resid = (pol_delta and thole.residual_supported(cfg)
                 and cfg.ensemble != "npt")
    # delayed-acceptance polar MC (RunConfig.polar_delayed): stage-1
    # filter with the zodid surrogate, SCF only for survivors under a
    # scalar lax.cond (a real branch at C=1 — under vmapped chains the
    # cond lowers to a select that runs both sides, so the batched
    # driver keeps plain Metropolis economics but identical sampling).
    # NVE excluded: the microcanonical rule has no Boltzmann split.
    pol_da = (cfg.polarization and cfg.polar_delayed
              and cfg.ensemble != "nve")

    def eb(rd=None, lrc=None, es_real=None, es_recip=None, es_self=None,
           es_excl=None):
        return EnergyBreakdown(
            rd=zero if rd is None else rd,
            lrc=zero if lrc is None else lrc,
            es_real=zero if es_real is None else es_real,
            es_recip=zero if es_recip is None else es_recip,
            es_self=zero if es_self is None else es_self,
            es_excl=zero if es_excl is None else es_excl,
            polar=zero, vdw=zero)

    # ------------------------------------------------------------------ moves
    def b_displace(state: SimState, thermo: Thermo, key):
        k_sel, k_mv = jax.random.split(key)
        movable = _movable_mask(params, state.mol_alive)
        mol, cnt = moves.pick_random_true(k_sel, movable)
        alive = state.atom_alive(params)
        idx_rows, new_rows = moves.displace_rows(state.pos, params, mol,
                                                 k_mv, thermo.move_factor,
                                                 thermo.rot_factor)
        col_rd = col_es = col_lrc = None
        if cache_mode:
            # one pass: the old interactions come from the cache row
            newp = pairs.mol_pair_partials(state.pos, state.box, alive,
                                           params, cfg, thermo.temperature,
                                           mol, row_pos=new_rows)
            new_pos = None
            d_rd = jnp.sum(newp.rd) - jnp.sum(state.cache_rd[mol])
            d_es = jnp.sum(newp.es_real) - jnp.sum(state.cache_es[mol])
            new_min_r2 = newp.min_r2
            col_rd, col_es = newp.rd, newp.es_real
            col_lrc = state.cache_lrc[mol]   # tails are r-independent
        elif row_level:
            new_pos = None
            old = pairs.mol_pair_pass(state.pos, state.box, alive, params,
                                      cfg, thermo.temperature, mol)
            new = pairs.mol_pair_pass(state.pos, state.box, alive,
                                      params, cfg, thermo.temperature,
                                      mol, row_pos=new_rows)
            d_rd = new.rd - old.rd
            d_es = new.es_real - old.es_real
            new_min_r2 = new.min_r2
        else:
            old = pairs.mol_pair_pass(state.pos, state.box, alive, params,
                                      cfg, thermo.temperature, mol)
            curr = mol_rows(state.pos, params, mol)
            v = (jnp.arange(curr.shape[0])
                 < params.mol_natoms[mol])[:, None]
            new_pos = mol_rows_update(state.pos, params, mol,
                                      jnp.where(v, new_rows, curr))
            new = pairs.mol_pair_pass(new_pos, state.box, alive, params,
                                      cfg, thermo.temperature, mol)
            d_rd = new.rd - old.rd
            d_es = new.es_real - old.es_real
            new_min_r2 = new.min_r2
        if cfg.coulomb == "ewald":
            d_re, d_im = _mol_sf_delta(state.pos, new_rows, state.box,
                                       params, cfg, mol)
            sk_re, sk_im, d_recip = _recip_delta(state, cfg, d_re, d_im)
        else:
            sk_re, sk_im, d_recip = state.sk_re, state.sk_im, zero
        d = eb(rd=d_rd, es_real=d_es, es_recip=d_recip)
        reject = (cnt == 0) | _overlap_r2(new_min_r2, cfg, dtype)
        e0_d, r0_d = (thole.move_deltas(
            state.pos, state.box, alive, params, cfg, mol, state.e0,
            state.mu, state.r_pol, new_rows=new_rows,
            with_residual=pol_resid, sk=_pol_sk(state, cfg))
            if pol_delta else (None, None))
        return Candidate(new_pos, state.box, state.mol_alive, sk_re, sk_im,
                         d, zero, reject, mol=mol.astype(jnp.int32),
                         rows=new_rows if row_level else None,
                         col_rd=col_rd, col_es=col_es, col_lrc=col_lrc,
                         e0=e0_d, r0=r0_d)

    def b_insert(state: SimState, thermo: Thermo, key):
        k_sp, k_slot, k_cell, k_place = jax.random.split(key, 4)
        ns = len(cfg.insert_species)
        j = jax.random.randint(k_sp, (), 0, ns)
        si = jnp.asarray(cfg.insert_species)[j]
        dead = ~state.mol_alive & (params.mol_species == si)
        slot, free = moves.pick_random_true(k_slot, dead)
        cav_bias = zero
        cav_reject = jnp.zeros((), bool)
        com = None
        if cfg.cavity_bias:
            # propose only inside open cells; the nonuniform proposal
            # density 1/(n_open * v_cell) vs 1/V multiplies acceptance by
            # the open volume fraction f = n_open / G^3 (SURVEY.md §2
            # "Boltzmann/acceptance": cavity-bias correction)
            cell, n_open = moves.pick_random_true(k_cell,
                                                  state.cavity_open)
            com = moves.cell_com(k_cell, cell, cfg.cavity_grid, state.box,
                                 dtype)
            g3 = jnp.asarray(cfg.cavity_grid ** 3, dtype)
            cav_bias = (jnp.log(jnp.maximum(n_open.astype(dtype), 1e-30))
                        - jnp.log(g3))
            cav_reject = n_open == 0
        rows = moves.place_rows(params, slot, si, k_place, state.box,
                                com=com, dtype=dtype)
        col_rd = col_es = col_lrc = None
        if cache_mode:
            new_pos = None
            p = pairs.mol_pair_partials(state.pos, state.box,
                                        state.atom_alive(params), params,
                                        cfg, thermo.temperature, slot,
                                        row_pos=rows)
            inter_rd, inter_es = jnp.sum(p.rd), jnp.sum(p.es_real)
            inter_lrc, inter_min_r2 = jnp.sum(p.lrc), p.min_r2
            col_rd, col_es, col_lrc = p.rd, p.es_real, p.lrc
            intra = pairs.intra_terms(state.pos, state.box, params, cfg,
                                      slot, row_pos=rows)
        elif row_level:
            new_pos = None
            inter = pairs.mol_pair_pass(state.pos, state.box,
                                        state.atom_alive(params), params,
                                        cfg, thermo.temperature, slot,
                                        row_pos=rows)
            intra = pairs.intra_terms(state.pos, state.box, params, cfg,
                                      slot, row_pos=rows)
        else:
            curr = mol_rows(state.pos, params, slot)
            v = (jnp.arange(curr.shape[0])
                 < params.mol_natoms[slot])[:, None]
            new_pos = mol_rows_update(state.pos, params, slot,
                                      jnp.where(v, rows, curr))
            alive = state.atom_alive(params)      # old alive (cols)
            inter = pairs.mol_pair_pass(new_pos, state.box, alive, params,
                                        cfg, thermo.temperature, slot)
            intra = pairs.intra_terms(new_pos, state.box, params, cfg, slot)
        if not cache_mode:
            inter_rd, inter_es = inter.rd, inter.es_real
            inter_lrc, inter_min_r2 = inter.lrc_coeff, inter.min_r2
        new_alive_mol = state.mol_alive.at[slot].set(True)
        d_self = _mol_self_energy(params, cfg, state.box, slot)
        volume = jnp.abs(jnp.linalg.det(state.box))
        d_lrc = zero
        if cfg.rd_potential in ("lj", "disp_expansion") and cfg.rd_lrc:
            own = pairs.mol_lrc_self_coefficient(
                params, cfg, pairs.derived_cutoff(state.box, cfg), slot)
            d_lrc = (inter_lrc + 0.5 * own) / volume
        if cfg.coulomb == "ewald":
            n_re, n_im = _mol_sf_rows(rows, state.box, params, cfg, slot)
            sk_re, sk_im, d_recip = _recip_delta(state, cfg, n_re, n_im)
            # jellium background delta: c_bg [(Q+q_m)^2 - Q^2] — exact 0
            # for the (usual) neutral templates (ewald.background_*)
            d_self = d_self + _background_delta(state, params, cfg, slot,
                                                sign=1.0)
        else:
            sk_re, sk_im, d_recip = state.sk_re, state.sk_im, zero
        d = eb(rd=inter_rd, lrc=d_lrc, es_real=inter_es,
               es_recip=d_recip, es_self=d_self, es_excl=intra)
        n_s = jnp.sum(state.mol_alive & (params.mol_species == si))
        f = thermo.fugacity[si] * ATM2K_A3          # K / A^3
        ln_bias = jnp.log(jnp.maximum(f * volume, 1e-300)) \
            - jnp.log(thermo.temperature * (n_s + 1.0)) + cav_bias
        reject = ((free == 0) | _overlap_r2(inter_min_r2, cfg, dtype)
                  | cav_reject)
        e0_d, r0_d = (thole.move_deltas(
            state.pos, state.box, state.atom_alive(params), params,
            cfg, slot, state.e0, state.mu, state.r_pol, new_rows=rows,
            insert=True, with_residual=pol_resid,
            sk=_pol_sk(state, cfg))
            if pol_delta else (None, None))
        return Candidate(new_pos, state.box, new_alive_mol, sk_re, sk_im,
                         d, ln_bias.astype(dtype), reject,
                         mol=slot.astype(jnp.int32),
                         rows=rows if row_level else None,
                         col_rd=col_rd, col_es=col_es, col_lrc=col_lrc,
                         e0=e0_d, r0=r0_d)

    def b_delete(state: SimState, thermo: Thermo, key):
        k_sp, k_slot = jax.random.split(key)
        # species-first pick, mirroring b_insert: the (fV)/(N_s kT)
        # acceptance assumes the reverse move selects uniformly among
        # molecules OF THE SAME SPECIES — drawing from the pooled set
        # would break detailed balance for multi-sorbate GCMC
        ns = len(cfg.insert_species)
        j = jax.random.randint(k_sp, (), 0, ns)
        si_pick = jnp.asarray(cfg.insert_species)[j]
        cand_mask = (_movable_mask(params, state.mol_alive)
                     & (params.mol_species == si_pick))
        slot, cnt = moves.pick_random_true(k_slot, cand_mask)
        si = params.mol_species[slot]
        col_rd = col_es = col_lrc = None
        if cache_mode:
            # zero passes: the molecule's interactions ARE its cache row
            inter_rd = jnp.sum(state.cache_rd[slot])
            inter_es = jnp.sum(state.cache_es[slot])
            inter_lrc = jnp.sum(state.cache_lrc[slot])
            col_rd = col_es = col_lrc = zcol
        else:
            alive = state.atom_alive(params)
            inter = pairs.mol_pair_pass(state.pos, state.box, alive, params,
                                        cfg, thermo.temperature, slot)
            inter_rd, inter_es = inter.rd, inter.es_real
            inter_lrc = inter.lrc_coeff
        intra = pairs.intra_terms(state.pos, state.box, params, cfg, slot)
        d_self = _mol_self_energy(params, cfg, state.box, slot)
        volume = jnp.abs(jnp.linalg.det(state.box))
        d_lrc = zero
        if cfg.rd_potential in ("lj", "disp_expansion") and cfg.rd_lrc:
            own = pairs.mol_lrc_self_coefficient(
                params, cfg, pairs.derived_cutoff(state.box, cfg), slot)
            d_lrc = (inter_lrc + 0.5 * own) / volume
        if cfg.coulomb == "ewald":
            o_re, o_im = _mol_structure_factor(state.pos, state.box, params,
                                               cfg, slot)
            sk_re, sk_im, d_recip = _recip_delta(state, cfg, -o_re, -o_im)
            # c_bg [(Q-q_m)^2 - Q^2]: NOT the negated insert delta (the
            # term is quadratic in Q), so it rides outside the -d_self
            d_bg = _background_delta(state, params, cfg, slot, sign=-1.0)
        else:
            sk_re, sk_im, d_recip = state.sk_re, state.sk_im, zero
            d_bg = zero
        d = eb(rd=-inter_rd, lrc=-d_lrc, es_real=-inter_es,
               es_recip=d_recip, es_self=-d_self + d_bg, es_excl=-intra)
        new_alive_mol = state.mol_alive.at[slot].set(False)
        n_s = jnp.sum(state.mol_alive & (params.mol_species == si))
        f = thermo.fugacity[si] * ATM2K_A3
        ln_bias = (jnp.log(jnp.maximum(n_s.astype(dtype), 1e-30)
                           * thermo.temperature)
                   - jnp.log(jnp.maximum(f * volume, 1e-300)))
        if cfg.cavity_bias:
            # reverse move is a cavity-biased insertion: divide by f_cav
            n_open = jnp.sum(state.cavity_open.astype(jnp.int32))
            g3 = jnp.asarray(cfg.cavity_grid ** 3, dtype)
            ln_bias = ln_bias - (
                jnp.log(jnp.maximum(n_open.astype(dtype), 1e-30))
                - jnp.log(g3))
        reject = cnt == 0
        e0_d, r0_d = (thole.move_deltas(
            state.pos, state.box, state.atom_alive(params), params,
            cfg, slot, state.e0, state.mu, state.r_pol, delete=True,
            with_residual=pol_resid, sk=_pol_sk(state, cfg))
            if pol_delta else (None, None))
        return Candidate(None if row_level else state.pos, state.box,
                         new_alive_mol, sk_re, sk_im,
                         d, ln_bias.astype(dtype), reject,
                         mol=slot.astype(jnp.int32),
                         rows=(mol_rows(state.pos, params, slot)
                               if row_level else None),
                         col_rd=col_rd, col_es=col_es, col_lrc=col_lrc,
                         e0=e0_d, r0=r0_d)

    def b_volume(state: SimState, thermo: Thermo, key):
        k_v, _ = jax.random.split(key)
        u = jax.random.uniform(k_v, dtype=dtype)
        d_lnv = (2.0 * u - 1.0) * thermo.volume_change_factor
        new_pos, new_box = moves.scale_volume(state.pos, state.box, params,
                                              state.mol_alive, d_lnv)
        cfg_np = dataclasses.replace(cfg, polarization=False, cdvdw=False)
        # split_frozen so the delta stays in active-part space (volume
        # moves are only sensible without a frozen framework, where the
        # frozen part is identically zero anyway)
        e_new, _, aux = energy_mod.total_energy(
            new_pos, new_box, state.mol_alive, params, cfg_np, thermo,
            split_frozen=True)
        # polar/vdw slots excluded here; handled by the common paths
        old_np = dataclasses.replace(state.energy, polar=zero, vdw=zero)
        d = e_new.sub(old_np)
        v_old = jnp.abs(jnp.linalg.det(state.box))
        v_new = jnp.abs(jnp.linalg.det(new_box))
        n = jnp.sum(_movable_mask(params, state.mol_alive)).astype(dtype)
        p_ka3 = thermo.pressure * ATM2K_A3
        ln_bias = ((n + 1.0) * d_lnv
                   - p_ka3 * (v_new - v_old) / thermo.temperature)
        sk_re = aux.get("sk_re", state.sk_re)
        sk_im = aux.get("sk_im", state.sk_im)
        e0_d = (thole.static_field(
                    new_pos, new_box,
                    state.mol_alive[params.mol_id] & params.atom_ok,
                    params, cfg)
                if pol_delta else None)
        return Candidate(new_pos, new_box, state.mol_alive, sk_re, sk_im,
                         d, ln_bias.astype(dtype), jnp.zeros((), bool),
                         e0=e0_d)

    def b_spinflip(state: SimState, thermo: Thermo, key):
        """Ortho<->para flip of one rotor using the cached hindered-rotor
        free energies (SURVEY.md §2 "Moves / checkpoint": spinflip via the
        quantum-rotation eigenspectrum).  No positions change; acceptance
        exp(-(F_new - F_old)/T)."""
        k_sel, _ = jax.random.split(key)
        eligible = (_movable_mask(params, state.mol_alive)
                    & (params.mol_natoms >= 2))
        mol, cnt = moves.pick_random_true(k_sel, eligible)
        s_cur = state.spin[mol]
        d_f = (state.rot_f[mol, 1 - s_cur] - state.rot_f[mol, s_cur])
        ln_bias = (-d_f / thermo.temperature).astype(dtype)
        return Candidate(None if row_level else state.pos, state.box,
                         state.mol_alive, state.sk_re, state.sk_im, ez,
                         ln_bias, cnt == 0, spin_mol=mol.astype(jnp.int32),
                         mol=mol.astype(jnp.int32),
                         rows=(mol_rows(state.pos, params, mol)
                               if row_level else None),
                         col_rd=(state.cache_rd[mol] if cache_mode
                                 else None),
                         col_es=(state.cache_es[mol] if cache_mode
                                 else None),
                         col_lrc=(state.cache_lrc[mol] if cache_mode
                                  else None),
                         e0=state.e0 if pol_delta else None,
                         r0=state.r_pol if pol_resid else None)

    # branch table per ensemble (static)
    if cfg.ensemble == "uvt" and cfg.insert_species:
        branches = [b_displace, b_insert, b_delete]
    elif cfg.ensemble == "npt":
        branches = [b_displace, b_volume]
    else:   # nvt / nve / single-molecule ensembles
        branches = [b_displace]
    if spinflip_active(cfg):
        branches = branches + [b_spinflip]
    pick_branch, branch_ids = make_branch_picker(cfg)

    # transition-matrix MC collection (RunConfig.tmmc): every µVT step
    # adds the attempt's acceptance PROBABILITY (not the realized
    # accept) to C[N, stay/up/down] at the pre-move macrostate N — the
    # classic low-variance TMMC estimator.  Insert/delete are branch
    # indices 1/2 in the µVT table above (static).
    tmmc_on = (cfg.tmmc and cfg.ensemble == "uvt"
               and len(cfg.insert_species) == 1)
    # tmmc + polar_delayed composes (r3 verdict item 5): the collection
    # records X = 1{stage-1 accept} * min(1, a2) (importance-weighted
    # by min(1,a1)/min(1,a1*e^dEta) under tmmc_bias), a conditionally
    # unbiased estimator of the DA kernel's own acceptance probability
    # min(1,a1)*min(1,a2) — the exact a2 is computed precisely for the
    # survivors X needs it for.  DA satisfies pointwise detailed
    # balance w.r.t. the same target (Christen & Fox 2005), so the lnPi
    # links remain consistent; variance sits between the closed-form
    # and realized-0/1 collectors.  Under tmmc_bias the eta delta
    # enters the STAGE-1 filter (the biased chain's target carries the
    # full e^eta factor there; stage 2 stays bias-free).
    tmmc_sp = cfg.insert_species[0] if tmmc_on else -1

    # ------------------------------------------------------------------ step
    def step(state: SimState, stats: MCStats, thermo: Thermo,
             move_t=None):
        """One Metropolis step.  ``move_t``: externally-chosen branch
        index (scalar).  The batched-chain driver shares one move-type
        draw across all vmapped chains so lax.switch keeps a scalar index
        and executes a single branch (vmapping a batched switch would run
        every branch for every chain)."""
        if move_t is None:
            key_next, k_type, k_move, k_acc = jax.random.split(state.key, 4)
            t = pick_branch(k_type, thermo)
        else:
            key_next, k_move, k_acc = jax.random.split(state.key, 3)
            t = move_t
        cand = jax.lax.switch(t, branches, state, thermo, k_move)

        # coupled-dipole vdW: a many-body term with no cheap delta — the
        # 3P x 3P eigensolve reruns per candidate, exactly like the
        # reference recomputes vdw() in every energy() call (SURVEY §3.2)
        if cfg.cdvdw:
            from mpmc_tpu.ops import vdw as vdw_mod
            alive_v = cand.mol_alive[params.mol_id] & params.atom_ok
            vdw_new = vdw_mod.vdw_energy(cand.pos, cand.box, alive_v,
                                         params, cfg)
            d_vdw = vdw_new - state.energy.vdw
        else:
            vdw_new = state.energy.vdw
            d_vdw = zero

        # flat-histogram eta delta, computed EARLY: under pol_da it
        # must enter the stage-1 filter (the biased chain's target is
        # pi*e^eta and DA puts the whole bias in stage 1)
        d_eta = zero
        n_cur = None
        if tmmc_on:
            n_cur = jnp.sum(state.mol_alive
                            & (params.mol_species == tmmc_sp))
            if cfg.tmmc_bias and thermo.tmmc_eta is not None:
                d_n = ((t == 1).astype(jnp.int32)
                       - (t == 2).astype(jnp.int32))
                n_to = jnp.clip(n_cur + d_n, 0,
                                thermo.tmmc_eta.shape[0] - 1)
                d_eta = (thermo.tmmc_eta[n_to]
                         - thermo.tmmc_eta[n_cur]).astype(dtype)

        # polarization: re-solve SCF on the candidate (common to all moves)
        acc1 = d_surr = k_acc2 = None
        if cfg.polarization:
            alive_c = cand.mol_alive[params.mol_id] & params.atom_ok
            if pol_delta:
                e0_new = cand.e0
            else:
                e0_new = thole.static_field(cand.pos, cand.box, alive_c,
                                            params, cfg)
        if pol_da:
            # delayed acceptance (Christen & Fox 2005): stage 1 filters
            # the trial with the zodid surrogate — free given e0 — so
            # the SCF solve runs only for stage-1 survivors.  Stage 2
            # below corrects with the exact-vs-surrogate difference,
            # restoring detailed balance w.r.t. the SCF target exactly.
            alive_o = state.mol_alive[params.mol_id] & params.atom_ok
            d_surr = (thole.zodid_energy(e0_new, alive_c, params)
                      - thole.zodid_energy(state.e0, alive_o, params))
            k_acc, k_acc2 = jax.random.split(k_acc)
            u1 = jax.random.uniform(k_acc, dtype=dtype)
            du1 = cand.denergy.total + d_surr + d_vdw
            acc1 = ((~cand.hard_reject)
                    & (jnp.log(u1)
                       < cand.ln_bias + d_eta
                       - du1 / thermo.temperature))
            r_skip = state.r_pol if pol_resid else jnp.zeros_like(state.mu)

            def _scf(_):
                mu_n, it, r_n = thole.solve_scf(
                    cand.pos, cand.box, alive_c, params, cfg, e0_new,
                    mu0=state.mu, r0=cand.r0 if pol_resid else None)
                if r_n is None:     # jacobi/direct solvers
                    r_n = jnp.zeros_like(state.mu)
                return mu_n, it.astype(jnp.int32), r_n

            def _keep(_):
                return state.mu, jnp.zeros((), jnp.int32), r_skip

            mu_new, iters, r_new = jax.lax.cond(acc1, _scf, _keep, None)
            pol_new = thole.polar_energy(mu_new, e0_new)
            d_polar = pol_new - state.energy.polar
        elif cfg.polarization:
            mu_new, iters, r_new = thole.solve_scf(
                cand.pos, cand.box, alive_c, params, cfg, e0_new,
                mu0=state.mu, r0=cand.r0 if pol_resid else None)
            pol_new = thole.polar_energy(mu_new, e0_new)
            d_polar = pol_new - state.energy.polar
        else:
            e0_new, mu_new = state.e0, state.mu
            r_new = state.r_pol
            iters = jnp.zeros((), jnp.int32)
            d_polar = zero

        du = cand.denergy.total + d_polar + d_vdw
        if cfg.ensemble == "nve":
            # Ray's microcanonical MC (SURVEY §2 "MC main loop": NVE
            # [L]; Ray, PRA 44, 4061 (1991)): the kinetic reservoir
            # K = E_total - U weights configurations as K^(F/2 - 1),
            # F = total kinetic DOF of the movable molecules, so
            #   P_acc = min[1, (K_new/K_old)^(F/2-1)],  K_new > 0.
            # E_total comes from the ``total_energy`` option in the same
            # convention as the reported energy (active + frozen).
            u_off = (state.e_frozen.total if state.e_frozen is not None
                     else zero)
            u_old = state.energy.total + u_off
            k_old = thermo.nve_energy - u_old
            k_new = k_old - du
            f_dof = jnp.sum(jnp.where(
                _movable_mask(params, state.mol_alive),
                params.mol_dof, 0.0))
            g = 0.5 * f_dof - 1.0
            ln_acc = jnp.where(
                (k_new > 0) & (k_old > 0),
                g * (jnp.log(jnp.maximum(k_new, 1e-300))
                     - jnp.log(jnp.maximum(k_old, 1e-300))),
                -jnp.inf)
        else:
            ln_acc = cand.ln_bias - du / thermo.temperature
        # flat-histogram TMMC bias (cfg.tmmc_bias): the CHAIN accepts
        # with ln_acc + η(N') − η(N), the COLLECTION below records the
        # unbiased probability — bias moves the walker, never the
        # estimator
        ln_eff = ln_acc + d_eta if tmmc_on else ln_acc

        if pol_da:
            # stage 2: proposal bias and every non-polar term cancelled
            # in stage 1; only the exact-vs-surrogate polar difference
            # remains.  Stage-1 rejects carry acc1 = False.
            u2 = jax.random.uniform(k_acc2, dtype=dtype)
            accept = acc1 & (jnp.log(u2)
                             < -(d_polar - d_surr) / thermo.temperature)
        else:
            u = jax.random.uniform(k_acc, dtype=dtype)
            accept = (~cand.hard_reject) & (jnp.log(u) < ln_eff)

        if tmmc_on:
            # conditional-mean collection: per-type attempt counts and
            # acceptance-probability sums, so the move-type-selection
            # randomness divides out of P(N->N±1) (make_branch_picker
            # splits insert_probability EXACTLY 50/50 between insert and
            # delete, so the selection factors cancel in the lnΠ links —
            # analyze.tmmc_lnpi relies on that symmetry)
            tdt = state.tmmc_c.dtype
            if pol_da:
                # delayed-acceptance estimator (module-level note at
                # tmmc_on): X = 1{acc1} * [min(1,a1)/min(1,a1*e^dEta)]
                # * min(1,a2) — unbiased for the UNBIASED DA kernel's
                # acceptance probability, with a2 exact for survivors
                ln1 = cand.ln_bias - du1 / thermo.temperature
                ln2 = -(d_polar - d_surr) / thermo.temperature
                x = jnp.exp(jnp.minimum(ln1, 0.0)
                            - jnp.minimum(ln1 + d_eta, 0.0)
                            + jnp.minimum(ln2, 0.0))
                a_pr = jnp.where(acc1, x, 0.0).astype(tdt)
            else:
                a_pr = jnp.where(
                    cand.hard_reject, jnp.zeros((), tdt),
                    jnp.exp(jnp.minimum(ln_acc, 0.0)).astype(tdt))
            is_i = (t == 1).astype(tdt)
            is_d = (t == 2).astype(tdt)
            new_tmmc = (state.tmmc_c
                        .at[n_cur, 0].add(is_i)
                        .at[n_cur, 1].add(is_i * a_pr)
                        .at[n_cur, 2].add(is_d)
                        .at[n_cur, 3].add(is_d * a_pr))
        else:
            new_tmmc = state.tmmc_c

        new_energy = state.energy.add(cand.denergy)
        if cfg.polarization:
            new_energy = dataclasses.replace(new_energy, polar=pol_new)
        if cfg.cdvdw:
            new_energy = dataclasses.replace(new_energy, vdw=vdw_new)
        sel = lambda a, b: (a if a is None or b is None
                            else jax.tree_util.tree_map(
                                lambda x, y: jnp.where(accept, x, y), a, b))
        if row_level:
            # write only the moved molecule's rows — O(A), not O(N);
            # slice read-modify-write (slots are contiguous) instead of
            # a batched scatter, which this backend lowers poorly
            cur = mol_rows(state.pos, params, cand.mol)
            v = (jnp.arange(cur.shape[0])
                 < params.mol_natoms[cand.mol])[:, None]
            new_pos = mol_rows_update(
                state.pos, params, cand.mol,
                jnp.where(accept & v, cand.rows, cur))
            new_box = state.box
        else:
            new_pos = sel(cand.pos, state.pos)
            new_box = sel(cand.box, state.box)
        if cache_mode:
            # symmetric row+column scatter of the fresh partials — O(M)
            m = cand.mol

            def upd(cache, col):
                row = jnp.where(accept, col, cache[m])
                return cache.at[m, :].set(row).at[:, m].set(row)

            new_cache_rd = upd(state.cache_rd, cand.col_rd)
            new_cache_es = upd(state.cache_es, cand.col_es)
            new_cache_lrc = upd(state.cache_lrc, cand.col_lrc)
        else:
            new_cache_rd = state.cache_rd
            new_cache_es = state.cache_es
            new_cache_lrc = state.cache_lrc
        new_state = SimState(
            pos=new_pos,
            box=new_box,
            mol_alive=sel(cand.mol_alive, state.mol_alive),
            key=key_next,
            mu=sel(mu_new, state.mu),
            energy=new_energy.select(accept, state.energy),
            step=state.step + 1,
            sk_re=sel(cand.sk_re, state.sk_re),
            sk_im=sel(cand.sk_im, state.sk_im),
            e0=sel(e0_new, state.e0),
            r_pol=(sel(r_new, state.r_pol) if pol_resid
                   else state.r_pol),
            e_frozen=state.e_frozen,
            cavity_open=state.cavity_open,
            spin=(state.spin if state.spin is None else jnp.where(
                accept & (cand.spin_mol >= 0),
                state.spin.at[jnp.maximum(cand.spin_mol, 0)].set(
                    1 - state.spin[jnp.maximum(cand.spin_mol, 0)]),
                state.spin)),
            rot_f=state.rot_f,
            cache_rd=new_cache_rd,
            cache_es=new_cache_es,
            cache_lrc=new_cache_lrc,
            tmmc_c=new_tmmc,
        )
        gid = branch_ids[t]
        new_stats = MCStats(
            attempts=stats.attempts.at[gid].add(1),
            accepts=stats.accepts.at[gid].add(accept.astype(jnp.int32)),
            polar_iters=stats.polar_iters + iters,
        )
        return new_state, new_stats

    return step


@functools.partial(jax.jit, static_argnames=("cfg", "n_steps"))
def run_chunk(state: SimState, params: Params, cfg: RunConfig,
              thermo: Thermo, n_steps: int):
    """Run ``n_steps`` Metropolis steps under lax.scan; returns
    (state, MCStats accumulated over the chunk)."""
    step = make_step_fn(params, cfg)

    def body(carry, _):
        st, stats = carry
        st, stats = step(st, stats, thermo)
        return (st, stats), None

    (state, stats), _ = jax.lax.scan(
        body, (state, MCStats.zero()), None, length=n_steps)
    return state, stats


def frozen_refresh_rows(params: Params, cfg: RunConfig) -> int:
    """Static row count F for the frozen-reuse fast refresh, or 0.

    Returns F > 0 iff reusing ``state.e_frozen`` across a per-corrtime
    refresh is provably safe: every frozen atom occupies a slot row < F
    (frozen-prefix layout, so the row-restricted pair pass reproduces the
    active split exactly), no move in the ensemble can touch a frozen
    coordinate or the box (NPT volume moves rescale everything), and no
    per-corrtime mechanism rewrites what the frozen terms depend on
    (FH/FK: temperature via annealing or PT swaps; SPECTRE: charges).
    Host-side — call once per driver, pass the result as the static
    ``frozen_rows`` argument of ``initialize``."""
    import numpy as np
    if cfg.ensemble == "npt" or cfg.feynman_hibbs or cfg.feynman_kleinert:
        return 0
    if getattr(cfg, "spectre", False) or cfg.rd_crystal:
        return 0
    af = (np.asarray(params.mol_frozen)[np.asarray(params.mol_id)]
          & np.asarray(params.atom_ok)).astype(bool)
    n_f = int(af.sum())
    if n_f == 0 or not af[:n_f].all():
        return 0
    return n_f


@functools.partial(jax.jit, static_argnames=("cfg", "frozen_rows"))
def initialize(state: SimState, params: Params, cfg: RunConfig,
               thermo: Thermo, frozen_rows: int = 0) -> SimState:
    """Full-energy refresh: recompute every cached quantity from scratch
    (run at start and every corrtime to wash out delta-accumulation error —
    the functional analog of the reference's full re-sum).

    ``state.energy`` holds only the *active* (sorbate-involving) part; the
    constant frozen-framework terms live in ``state.e_frozen`` so the huge
    framework self/exclusion sums never enter the per-move accumulators.

    ``frozen_rows`` (static, from ``frozen_refresh_rows``) enables the
    fast refresh: the frozen-frozen sums are reused from
    ``state.e_frozen`` and only rows >= frozen_rows re-sum — the
    framework-dominated O(N^2) pass shrinks to O(N_sorbate * N).  Only
    pass a non-zero value on a refresh of a state whose e_frozen is
    already valid (never on the first initialize after build_system)."""
    reuse = frozen_rows > 0 and state.e_frozen is not None
    e, e_frozen, aux = energy_mod.total_energy(
        state.pos, state.box, state.mol_alive, params, cfg, thermo,
        mu0=state.mu, split_frozen=True,
        frozen_cached=state.e_frozen if reuse else None,
        active_row_start=frozen_rows if reuse else 0)
    # without polarization there are no dipoles to carry: dropping mu
    # from the state removes a dead [N,3] select/copy from every MC step
    mu_out = aux.get("mu", state.mu) if cfg.polarization else None
    cavity_open = state.cavity_open
    if cfg.cavity_bias:
        cavity_open = moves.cavity_open_grid(
            state.pos, state.box, state.atom_alive(params),
            cfg.cavity_grid, jnp.asarray(cfg.cavity_radius, cfg.jdtype))
    # molecule-pair cache: build once (entries stay exact under the
    # accept-time scatters, so later refreshes keep it) — except when
    # pair values depend on temperature (FH/FK), which annealing or PT
    # may have changed since the entries were written
    c_rd, c_es, c_lrc = state.cache_rd, state.cache_es, state.cache_lrc
    if cache_eligible(cfg):
        t_dep = cfg.feynman_hibbs or cfg.feynman_kleinert
        if c_rd is None or t_dep:
            c_rd, c_es, c_lrc = pairs.pair_matrix(
                state.pos, state.box, state.atom_alive(params), params,
                cfg, thermo.temperature)
    else:
        c_rd = c_es = c_lrc = None
    # TMMC collection matrix: allocate once (first initialize); later
    # refreshes must NOT reset it — it is an accumulated statistic
    tmmc_c = state.tmmc_c
    if cfg.tmmc and tmmc_c is None:
        # rows = total molecule-slot count + 1 (static shape; an upper
        # bound on the species capacity — unreachable rows stay zero and
        # tmmc_lnpi's connected-window walk never enters them); columns =
        # (n_ins_attempts, Σ a_ins, n_del_attempts, Σ a_del)
        tmmc_c = jnp.zeros((params.n_mols_max + 1, 4), cfg.jdtype)
    return state.replace(
        energy=e, e_frozen=e_frozen,
        sk_re=aux.get("sk_re"), sk_im=aux.get("sk_im"),
        mu=mu_out, e0=aux.get("e0"), r_pol=aux.get("r_pol"),
        cavity_open=cavity_open,
        cache_rd=c_rd, cache_es=c_es, cache_lrc=c_lrc,
        tmmc_c=tmmc_c)
