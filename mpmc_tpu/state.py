"""Core data model: padded-array system state (the SimState pytree).

This replaces the reference's linked-list world (``system_t`` ->
``molecule_t`` -> ``atom_t`` -> ``pair_t``, SURVEY.md §1 layer 1,
src/include/structs.h [M]) with fixed-capacity, masked arrays so every MC
step has static shapes and zero recompilation:

- Atoms live in one padded array of length ``n_atoms_max``.  Frozen
  (framework) atoms occupy a fixed prefix; each sorbate species gets a pool
  of fixed "slots", each slot sized to that species' template atom count.
- GCMC insert = claim a dead slot of the right species and write template
  coordinates; delete = clear the slot's alive flag.  (SURVEY.md §7
  "Core state".)
- Static per-atom parameters (charge, LJ eps/sigma, polarizability, mass,
  C6/C8/C10, omega) never change after construction — they are part of
  ``Params``, a constant pytree threaded through lax.scan, NOT of the
  mutable ``SimState``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from mpmc_tpu.ops import pbc


# ---------------------------------------------------------------------------
# Species template (host-side description of one rigid molecule type)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Species:
    """A rigid molecule template (the analog of the reference's
    ``insert_input`` PQR template, SURVEY.md §2 "PQR reader")."""
    name: str
    atom_names: tuple
    pos: np.ndarray          # (A,3) template coords, COM at origin
    mass: np.ndarray         # (A,) amu
    charge: np.ndarray       # (A,) e
    polar: np.ndarray        # (A,) A^3
    eps: np.ndarray          # (A,) K
    sig: np.ndarray          # (A,) A
    omega: np.ndarray = None   # (A,) a.u. — coupled-dipole vdW frequency
    c6: np.ndarray = None      # (A,) dispersion coefficients (PHAHST)
    c8: np.ndarray = None
    c10: np.ndarray = None
    gwp_alpha: np.ndarray = None  # (A,) Gaussian charge width [A]
    # spectroscopic stretch fundamental [cm^-1] for quantum_vibration
    # (diatomics; 0 = not configured) — see ops/qvib.py
    vib_omega: float = 0.0

    def __post_init__(self):
        a = len(self.atom_names)
        for f in ("omega", "c6", "c8", "c10", "gwp_alpha"):
            if getattr(self, f) is None:
                object.__setattr__(self, f, np.zeros(a))
        # re-center template on its center of mass
        m = np.asarray(self.mass, dtype=np.float64)
        p = np.asarray(self.pos, dtype=np.float64).reshape(a, 3)
        if m.sum() > 0:
            p = p - (m[:, None] * p).sum(0) / m.sum()
        object.__setattr__(self, "pos", p)

    @property
    def natoms(self):
        return len(self.atom_names)

    @property
    def total_mass(self):
        return float(np.sum(self.mass))


# ---------------------------------------------------------------------------
# Params: immutable arrays describing the padded system
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Params:
    """Constant (per-run) arrays.  N = n_atoms_max, M = n_mols_max,
    A = max atoms per molecule."""
    # per-atom static parameters [N]
    charge: jax.Array
    mass: jax.Array
    polar: jax.Array
    eps: jax.Array
    sig: jax.Array
    omega: jax.Array
    c6: jax.Array
    c8: jax.Array
    c10: jax.Array
    gwp_alpha: jax.Array
    # topology
    mol_id: jax.Array      # [N] int32: owning molecule slot (pad rows -> M-1 sentinel ok)
    atom_ok: jax.Array     # [N] bool: structural mask (real atom row)
    mol_species: jax.Array  # [M] int32: species index, -1 = frozen framework
    mol_frozen: jax.Array   # [M] bool
    mol_atoms: jax.Array    # [M, A] int32 atom indices (padded with first idx)
    mol_natoms: jax.Array   # [M] int32
    mol_start: jax.Array    # [M] int32: first atom row (molecules are
    #                         contiguous ranges — basis of the cumsum
    #                         per-molecule reductions in ops/pairs.py)
    mol_dof: jax.Array      # [M] kinetic degrees of freedom (3 point /
    #                         5 linear / 6 nonlinear; 0 frozen) — Ray's
    #                         NVE MC exponent (mc/metropolis.py)
    mol_mass: jax.Array     # [M] total mass
    # rigid templates for GCMC insertion: [S, A, 3] COM-centered coords
    # (the analog of the reference's insert_input template molecule,
    # SURVEY.md §2 "PQR reader")
    species_pos: jax.Array
    species_natoms: jax.Array  # [S] int32
    # static site list for coupled-dipole vdW (alpha>0 and omega>0) —
    # fixes the 3P x 3P eigenproblem shape under jit (ops/vdw.py)
    vdw_sites: Optional[jax.Array] = None
    # framework spatial index for the culled delta pass (ops/celllist.py);
    # attached by celllist.attach when cfg.cell_list is on
    cell_index: Optional["object"] = None

    @property
    def n_atoms_max(self):
        return self.charge.shape[0]

    @property
    def n_mols_max(self):
        return self.mol_species.shape[0]

    @property
    def max_atoms_per_mol(self):
        return self.mol_atoms.shape[1]


# ---------------------------------------------------------------------------
# SimState: the mutable (functionally-updated) simulation state
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SimState:
    pos: jax.Array        # [N,3]
    box: jax.Array        # [3,3] row-vector cell
    mol_alive: jax.Array  # [M] bool (frozen molecules always True)
    key: jax.Array        # threefry PRNG key
    mu: jax.Array         # [N,3] induced dipoles (warm start for SCF)
    energy: "EnergyBreakdown"
    step: jax.Array       # int64 counter
    # cached quantities for the delta-energy MC path (None when unused):
    sk_re: Optional[jax.Array] = None   # [Nk] Ewald structure factor (re)
    sk_im: Optional[jax.Array] = None   # [Nk] (im)
    e0: Optional[jax.Array] = None      # [N,3] static field (polarization)
    # final CG residual of the last polar solve (b - A mu): seeds the
    # next move's analytic initial residual (ops/thole.residual_delta),
    # saving the warm start's full matvec.  None unless
    # thole.residual_supported(cfg).
    r_pol: Optional[jax.Array] = None
    # constant frozen-framework energy (kept OUT of the delta accumulators;
    # the reference's forever-cached frozen pairs, SURVEY.md §1):
    e_frozen: Optional["EnergyBreakdown"] = None
    # cavity-bias occupancy grid [G^3] (True = open), refreshed per
    # corrtime (SURVEY.md §2 "Cavity bias"):
    cavity_open: Optional[jax.Array] = None
    # quantum rotation (spinflip move): per-molecule nuclear-spin species
    # [M] (0=para, 1=ortho) and cached rotational free energies [M,2]
    # (F_para, F_ortho), refreshed per corrtime (SURVEY.md §2 "Moves"):
    spin: Optional[jax.Array] = None
    rot_f: Optional[jax.Array] = None
    # molecule-pair energy cache [M,M] (ops/pairs.pair_matrix): the
    # reference's per-pair energy caching at molecule granularity —
    # displace reads its old interactions from cache_* rows (one pass
    # instead of two), delete needs no pass at all.  None when the
    # configuration is ineligible (metropolis.cache_eligible).
    cache_rd: Optional[jax.Array] = None
    cache_es: Optional[jax.Array] = None
    cache_lrc: Optional[jax.Array] = None
    # transition-matrix MC collection matrix [cap+1, 4] (RunConfig.tmmc):
    # per-macrostate (n_ins_attempts, Σ a_ins, n_del_attempts, Σ a_del)
    # acceptance-probability statistics; allocated by
    # metropolis.initialize, updated every µVT step, never reset by
    # refreshes (it is a statistic, not a cache).  None unless cfg.tmmc.
    tmmc_c: Optional[jax.Array] = None

    def atom_alive(self, params: Params):
        return self.mol_alive[params.mol_id] & params.atom_ok

    def reported_energy(self) -> "EnergyBreakdown":
        """Full physical energy: MC-accumulated active part + constant
        frozen-framework part."""
        if self.e_frozen is None:
            return self.energy
        return self.energy.add(self.e_frozen)

    def n_molecules(self, params: Params):
        """Number of alive, non-frozen molecules (total)."""
        return jnp.sum(self.mol_alive & ~params.mol_frozen
                       & (params.mol_species >= 0))

    def n_molecules_of(self, params: Params, species: int):
        return jnp.sum(self.mol_alive & (params.mol_species == species))

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class EnergyBreakdown:
    """Per-term energy slots, mirroring the reference's observables
    (SURVEY.md §2 "Energy dispatcher": rd, es real, es recip, polar, vdw,
    lrc)."""
    rd: jax.Array
    lrc: jax.Array
    es_real: jax.Array
    es_recip: jax.Array
    es_self: jax.Array
    es_excl: jax.Array
    polar: jax.Array
    vdw: jax.Array

    @property
    def es(self):
        return self.es_real + self.es_recip + self.es_self + self.es_excl

    @property
    def total(self):
        return (self.rd + self.lrc + self.es_real + self.es_recip
                + self.es_self + self.es_excl + self.polar + self.vdw)

    @classmethod
    def zero(cls, dtype=jnp.float32):
        z = jnp.zeros((), dtype)
        return cls(z, z, z, z, z, z, z, z)

    def add(self, other):
        return jax.tree_util.tree_map(jnp.add, self, other)

    def sub(self, other):
        return jax.tree_util.tree_map(jnp.subtract, self, other)

    def select(self, pred, other):
        """Field-wise ``pred ? self : other``."""
        return jax.tree_util.tree_map(
            lambda a, b: jnp.where(pred, a, b), self, other)


# ---------------------------------------------------------------------------
# System builder (host side, numpy)
# ---------------------------------------------------------------------------

def _round_up(x, m):
    return ((x + m - 1) // m) * m


def build_system(
    box,
    frozen_pos=None,
    frozen_params: Optional[dict] = None,
    species: tuple = (),
    capacity: tuple = (),
    initial_counts: tuple = (),
    initial_pos: Optional[dict] = None,
    dtype=jnp.float32,
    pad_atoms_to: int = 8,
    seed: int = 0,
):
    """Build (Params, SimState) from a frozen framework + sorbate species.

    Args:
      box: (3,3) cell.
      frozen_pos: (F,3) framework atom coords or None.
      frozen_params: dict of per-frozen-atom arrays
        (charge/mass/polar/eps/sig/omega/c6/c8/c10), each (F,).
      species: tuple of Species templates.
      capacity: per-species max molecule count (slot pool size).
      initial_counts: per-species initially-alive molecule count.
      initial_pos: optional {species_index: (n_i, A_i, 3) coords} to place the
        initially-alive molecules; otherwise slots are placed on a grid.
      pad_atoms_to: round n_atoms_max up to a multiple (vector widths).
    """
    box = np.asarray(box, dtype=np.float64)
    F = 0 if frozen_pos is None else len(frozen_pos)
    fp = frozen_params or {}

    def fget(name, default=0.0):
        v = fp.get(name)
        return (np.full(F, default, np.float64) if v is None
                else np.asarray(v, np.float64))

    n_sorb_atoms = sum(s.natoms * c for s, c in zip(species, capacity))
    N_real = F + n_sorb_atoms
    n_frozen_mols = 1 if F > 0 else 0
    M = n_frozen_mols + sum(capacity)
    # Width of the per-molecule atom-index table.  Deliberately capped at
    # the largest *movable* species — the frozen framework molecule is never
    # displaced/inserted/deleted, so its (possibly huge) atom list must not
    # inflate the O(A*N) delta-energy tile (mol_pair_pass).
    A = max([1] + [s.natoms for s in species])
    # pad the atom axis so mol_start[m] + A stays in bounds for EVERY
    # molecule: keeps a contiguous [A, ...] row window valid for any
    # slice-based row access (mol_rows is currently gather-backed — see
    # its docstring — but the layout guarantee is cheap: <= A-1 rows)
    N = _round_up(max(N_real, 1) + max(0, A - 1), pad_atoms_to)

    # --- per-atom arrays
    def zeros():
        return np.zeros(N, np.float64)

    charge, mass, polar, eps, sig = zeros(), zeros(), zeros(), zeros(), zeros()
    omega, c6, c8, c10, gwp_alpha = (zeros(), zeros(), zeros(), zeros(),
                                     zeros())
    mol_id = np.full(N, max(M - 1, 0), np.int32)
    atom_ok = np.zeros(N, bool)
    pos = np.zeros((N, 3), np.float64)

    if F > 0:
        pos[:F] = np.asarray(frozen_pos, np.float64)
        charge[:F] = fget("charge")
        mass[:F] = fget("mass")
        polar[:F] = fget("polar")
        eps[:F] = fget("eps")
        sig[:F] = fget("sig")
        omega[:F] = fget("omega")
        c6[:F] = fget("c6")
        c8[:F] = fget("c8")
        c10[:F] = fget("c10")
        gwp_alpha[:F] = fget("gwp_alpha")
        mol_id[:F] = 0
        atom_ok[:F] = True

    # --- molecule tables
    mol_species = np.full(M, -1, np.int32)
    mol_frozen = np.zeros(M, bool)
    mol_natoms = np.zeros(M, np.int32)
    mol_start = np.zeros(M, np.int32)
    mol_dof = np.zeros(M, np.float64)
    mol_mass = np.zeros(M, np.float64)
    mol_alive = np.zeros(M, bool)
    if F > 0:
        mol_frozen[0] = True
        mol_natoms[0] = F
        mol_mass[0] = float(fget("mass").sum())
        mol_alive[0] = True

    cursor = F
    mslot = n_frozen_mols
    rng = np.random.default_rng(seed)
    inv_box = np.linalg.inv(box)
    counts = list(initial_counts) + [0] * (len(species) - len(initial_counts))
    grid_n = int(np.ceil(max(sum(counts), 1) ** (1 / 3)))
    grid_pts = np.stack(np.meshgrid(*[(np.arange(grid_n) + 0.5) / grid_n] * 3,
                                    indexing="ij"), -1).reshape(-1, 3)
    gp = 0
    for si, (sp, cap) in enumerate(zip(species, capacity)):
        a = sp.natoms
        for j in range(cap):
            sl = slice(cursor, cursor + a)
            charge[sl] = sp.charge
            mass[sl] = sp.mass
            polar[sl] = sp.polar
            eps[sl] = sp.eps
            sig[sl] = sp.sig
            omega[sl] = sp.omega
            c6[sl] = sp.c6
            c8[sl] = sp.c8
            c10[sl] = sp.c10
            gwp_alpha[sl] = sp.gwp_alpha
            mol_id[sl] = mslot
            atom_ok[sl] = True
            mol_species[mslot] = si
            mol_natoms[mslot] = a
            mol_start[mslot] = cursor
            mol_mass[mslot] = sp.total_mass
            mol_dof[mslot] = _species_dof(sp)
            if j < counts[si]:
                mol_alive[mslot] = True
                if initial_pos is not None and si in initial_pos:
                    pos[sl] = np.asarray(initial_pos[si][j], np.float64)
                else:
                    com = grid_pts[gp % len(grid_pts)] @ box
                    gp += 1
                    pos[sl] = sp.pos + com
            else:
                # park dead slots at the origin; they are masked out anyway
                pos[sl] = sp.pos
            cursor += a
            mslot += 1

    # mol_atoms index table, padded with each molecule's first atom index
    mol_atoms = np.zeros((M, A), np.int32)
    for m in range(M):
        s0, na = int(mol_start[m]), int(mol_natoms[m])
        idx = np.arange(s0, s0 + na)[:A]   # frozen molecule truncates to A
        if len(idx) == 0:
            idx = np.zeros(1, np.int64)
        mol_atoms[m] = np.concatenate(
            [idx, np.full(A - len(idx), idx[0])])[:A]

    # species templates, padded to [S, A, 3]
    S = max(len(species), 1)
    species_pos = np.zeros((S, A, 3), np.float64)
    species_natoms = np.zeros(S, np.int32)
    for si, sp in enumerate(species):
        species_pos[si, :sp.natoms] = sp.pos
        species_natoms[si] = sp.natoms

    f = lambda x: jnp.asarray(x, dtype)
    params = Params(
        charge=f(charge), mass=f(mass), polar=f(polar), eps=f(eps),
        sig=f(sig), omega=f(omega), c6=f(c6), c8=f(c8), c10=f(c10),
        gwp_alpha=f(gwp_alpha),
        mol_id=jnp.asarray(mol_id), atom_ok=jnp.asarray(atom_ok),
        mol_species=jnp.asarray(mol_species),
        mol_frozen=jnp.asarray(mol_frozen),
        mol_atoms=jnp.asarray(mol_atoms),
        mol_natoms=jnp.asarray(mol_natoms),
        mol_start=jnp.asarray(mol_start),
        mol_dof=f(mol_dof),
        mol_mass=f(mol_mass),
        species_pos=f(species_pos),
        species_natoms=jnp.asarray(species_natoms),
        vdw_sites=jnp.asarray(
            np.nonzero((polar > 0) & (omega > 0))[0].astype(np.int32)),
    )
    state = SimState(
        pos=f(pos), box=f(box), mol_alive=jnp.asarray(mol_alive),
        key=jax.random.PRNGKey(seed),
        mu=jnp.zeros((N, 3), dtype),
        energy=EnergyBreakdown.zero(dtype),
        step=jnp.zeros((), jnp.int64 if jax.config.jax_enable_x64 else jnp.int32),
    )
    return params, state


def _species_dof(sp) -> float:
    """Kinetic degrees of freedom of a rigid species: 3 (point mass),
    5 (linear rotor), 6 (nonlinear) — the F entering Ray's NVE MC
    acceptance exponent F/2 - 1 (mc/metropolis.py)."""
    m = np.asarray(sp.mass, np.float64)
    p = np.asarray(sp.pos, np.float64)[m > 0]
    if len(p) <= 1:
        return 3.0
    d = p - p[0]
    # colinear if all mass points lie on one axis
    n = d[np.argmax(np.sum(d * d, 1))]
    nn = np.linalg.norm(n)
    if nn < 1e-9:
        return 3.0
    n = n / nn
    perp = d - np.outer(d @ n, n)
    return 5.0 if np.max(np.abs(perp)) < 1e-8 else 6.0


def mol_rows(arr, params: Params, mol):
    """[A, ...] rows of molecule ``mol`` — the single row-access chokepoint
    for every hot path.

    Implementation note (r2): molecule slots are contiguous
    (``mol_start``), so a ``lax.dynamic_slice`` looks natural — but
    under vmapped multi-chain batching the batched
    dynamic_slice/dynamic_update_slice pair lowers to a full-array
    select and ran ~3x slower than the ``mol_atoms`` row gather on the
    backend this was first written for.  So this stays a
    gather of the precomputed index row.  Padded entries duplicate the
    molecule's first atom index; every consumer masks rows by
    ``arange(A) < mol_natoms[mol]`` and writes go through
    mol_rows_update's blend, so either padding convention is safe."""
    idx = params.mol_atoms[mol]
    if arr.ndim == 1:
        # 2-D gather form (1-D gathers stress the compile service —
        # CLAUDE.md landmine)
        return arr[:, None][idx][:, 0]
    return arr[idx]


def mol_rows_update(arr, params: Params, mol, rows_new):
    """Write an [A, ...] row window back at molecule ``mol``'s slots.
    The caller blends rows beyond natoms with their CURRENT values
    (read-modify-write via mol_rows + jnp.where(valid, new, cur)).

    Padded ``mol_atoms`` entries duplicate the first atom's index, so
    rows beyond natoms are forced to duplicate ``rows_new[0]`` here —
    every write to the duplicated index carries the identical value,
    keeping the scatter deterministic."""
    valid = jnp.arange(rows_new.shape[0]) < params.mol_natoms[mol]
    if rows_new.ndim > 1:
        valid = valid.reshape((-1,) + (1,) * (rows_new.ndim - 1))
    rows_new = jnp.where(valid, rows_new, rows_new[0])
    return arr.at[params.mol_atoms[mol]].set(rows_new)


def molecule_com(pos, params: Params, mol: int | jax.Array):
    """Center of mass of one molecule slot (jit-safe dynamic index)."""
    idx = params.mol_atoms[mol]
    na = params.mol_natoms[mol]
    amask = (jnp.arange(idx.shape[0]) < na)[:, None]
    m = params.mass[idx][:, None] * amask
    denom = jnp.maximum(jnp.sum(m), 1e-30)
    return jnp.sum(m * pos[idx], axis=0) / denom


def slice_chain(states, k):
    """Chain/replica ``k`` of a stacked (leading-[C]) state pytree as
    ONE compiled dispatch — an eager per-leaf slice costs one device op
    per leaf (~30 dispatches).  The single
    chokepoint for the run drivers AND the per-replica output writers
    (restart/trajectory), so batched-state slicing semantics can never
    drift between them."""
    return jax.tree_util.tree_map(lambda x: x[k], states)


def all_molecule_coms(pos, params: Params):
    """[M,3] centers of mass for every molecule slot."""
    idx = params.mol_atoms                     # [M,A]
    amask = (jnp.arange(idx.shape[1])[None, :]
             < params.mol_natoms[:, None])     # [M,A]
    m = params.mass[idx] * amask               # [M,A]
    denom = jnp.maximum(jnp.sum(m, axis=1, keepdims=True), 1e-30)
    return jnp.einsum("ma,maj->mj", m, pos[idx]) / denom
