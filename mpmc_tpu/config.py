"""Simulation configuration: the rebuild of the reference's input-script
option surface (SURVEY.md §2.9, src/io/input.c [C]).

``RunConfig`` is a plain frozen dataclass holding *static* options — values
that select code paths and therefore must be Python-level constants under
jit (potential selection, ensemble, solver choice, capacities).  Continuous
per-run numbers that the MC kernel consumes (temperature, pressure, move
sizes, fugacities) live in ``Thermo``, a pytree, so they can change without
recompilation (e.g. simulated annealing, parallel tempering swaps).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp


# ---------------------------------------------------------------------------
# Static options (hashable; part of the jit closure)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RunConfig:
    # --- job control (SURVEY §2.9 "Job/control")
    job_name: str = "mpmc_tpu"
    ensemble: str = "nvt"          # uvt | nvt | npt | nve | surf | replay | te
    numsteps: int = 0
    corrtime: int = 1000
    seed: int = 0

    # --- cutoffs / cell
    cutoff: Optional[float] = None   # None -> half min perpendicular width
    wrapall: bool = True
    # Derived, not a user option: the basis is exactly diagonal
    # (orthorhombic).  Set automatically by mc/run.setup() from the
    # resolved basis and by the models/systems.py builders; the Thole
    # matvec kernel's min-image then drops the exact-zero triclinic
    # cross terms (12 ops vs 36 per pair — BIT-identical displacements,
    # since IEEE x + 0.0 == x).  Isotropic NPT volume scaling preserves
    # diagonality.  False is always safe (general path).
    ortho_box: bool = False

    # --- repulsion-dispersion (SURVEY §2.9 "RD")
    rd_potential: str = "lj"       # lj | sg | dreiding | b14_7 | disp_expansion | none
    rd_lrc: bool = True
    rd_only: bool = False
    mixing_rule: str = "lb"        # lb | waldman_hagler
    damp_dispersion: bool = True   # Tang–Toennies damping for disp_expansion
    # periodic-image RD lattice sum (SURVEY §2 "Lennard-Jones RD":
    # rd_crystal [M]): sum the RD potential over all cell images within
    # rd_crystal_order shells instead of the cutoff minimum-image sum —
    # converged lattice energies for small crystal cells where a cutoff
    # cannot fit.  Implies rd_lrc off (the image shells ARE the tail).
    rd_crystal: bool = False
    rd_crystal_order: int = 2
    # fill missing per-atom C10 from the Tang-Toennies recursion
    # C10 = (49/40) C8^2 / C6 (SURVEY §2.9 "RD":
    # extrapolate_disp_coeffs [L]) at system build
    extrapolate_disp_coeffs: bool = False

    # --- electrostatics (SURVEY §2.9 "ES")
    coulomb: str = "ewald"         # ewald | wolf | cutoff | none
    ewald_alpha: Optional[float] = None   # None -> 3.5 / cutoff
    ewald_kmax: int = 7
    wolf_alpha: Optional[float] = None
    # matmul structure factor (extension, ``ewald_mxu``): separable
    # per-axis phase tables contracted as dense matmuls over the full
    # k-cube — 3 sin/cos per atom instead of one per (atom, k)
    # (ops/ewald.py::structure_factor_mxu).  Same k-sphere, identical
    # energies; wins for large ewald_kmax where the full S(k) is
    # trig-bound.
    ewald_mxu: bool = False
    # Ewald assumes a neutral cell (SURVEY §2 "Ewald electrostatics": no
    # uniform-background correction is applied).  setup() errors on
    # |sum q| beyond roundoff unless this is on, which downgrades the
    # error to a warning and proceeds (net-charge term still omitted).
    allow_charged_cell: bool = False

    # --- polarization (SURVEY §2.9 "Polarization")
    polarization: bool = False
    polar_solver: str = "cg"       # cg | jacobi | direct | palmo
    polar_max_iter: int = 64
    # convergence threshold (RMS field residual per component); warm-started
    # CG typically converges in 2-4 iterations per MC move at 1e-6.
    # 0 -> fixed polar_max_iter iterations.
    polar_precision: float = 1e-6
    # "residual" (default, the tighter [M] deviation): stop on the RMS
    # field residual per component, polar_precision in e/A^2-field
    # units.  "dipole": the REFERENCE's rule — stop on the RMS dipole
    # CHANGE per iteration, polar_precision in DEBYE (SURVEY §2 "Thole
    # iterative solvers" [L unit]); same fixed point, typically fewer
    # iterations at the same nominal value.
    polar_precision_mode: str = "residual"   # residual | dipole
    polar_damp_type: str = "exponential"   # exponential | linear | none
    polar_damp: float = 2.1304
    polar_ewald: bool = False      # full-Ewald static field (else damped direct)
    polar_wolf: bool = False       # Wolf damped-shifted static field
    polar_wolf_alpha: Optional[float] = None
    polar_gamma: float = 1.0       # over-relaxation (jacobi)
    # tile-culled SCF matvec (GPU kernel route): on an orthorhombic box
    # with the CG solver the dipole matvec cell-sorts the sites per solve
    # and the kernel skips whole tiles whose blocks are provably beyond
    # rc (conservative AABB min-image bound) — exact (skipped pairs are
    # already cutoff-masked zeros).  "auto" engages it for an EXPLICIT
    # cutoff (on an H100 at rc = 14 A: 1.36 vs 2.29 ms per polar step at
    # 10.8k sites, 4.07 vs 24.8 at 53.7k); at the derived rc = L/2 the
    # dense kernel was as fast (PERF.md), so "on" only forces it there;
    # "off" always dense.  Triclinic cells keep the dense pass
    # regardless (the AABB bound assumes axis alignment).
    polar_cull: str = "auto"       # auto | on | off
    # delayed-acceptance polar MC (two-stage Metropolis, Christen & Fox
    # 2005): filter every trial with the zeroth-iteration ("zodid")
    # surrogate U* = U_nonpolar - (ke/2) sum alpha |E0|^2 — essentially
    # free given the cached per-move field delta — and run the full SCF
    # only for stage-1 survivors; stage 2 accepts with
    # min(1, exp(-(dU_polar - dU_surrogate)/T)), which restores exact
    # detailed balance w.r.t. the SCF target.  Skips the dominant
    # O(N'^2)-matvec solve on every surrogate-rejected move.  Opt-in;
    # changes the Markov chain (same stationary distribution, different
    # trajectories), ignored under ensemble nve (the microcanonical rule
    # has no Boltzmann split to stage).
    polar_delayed: bool = False

    # --- coupled-dipole many-body vdW (SURVEY §2.9 "vdW": cdvdw family)
    cdvdw: bool = False
    # pair repulsion paired with cdvdw (SURVEY §2 "Coupled-dipole vdW":
    # cdvdw_sig_repulsion / cdvdw_9th_repulsion / cdvdw_exp_repulsion [M]).
    # With many-body dispersion active, the LJ r^-6 attraction would
    # double-count dispersion, so the RD term becomes repulsion-only:
    #   sig: C6_ij sig_ij^6 / r^12     9th: C6_ij sig_ij^3 / r^9
    #   exp: Born-Mayer A_ij exp(-B_ij r) (disp_expansion column
    #        convention: eps = A [K], sig = B [1/A])
    # where C6_ij = (3/2) hbar w_i w_j/(w_i+w_j) a_i a_j is the London
    # coefficient of the same Drude parameters the cdvdw eigensolve uses —
    # see ops/potentials.py::cdvdw_repulsion_energy for the derivation.
    cdvdw_repulsion: str = "none"  # none | sig | 9th | exp

    # --- quantum corrections (SURVEY §2.9 "Quantum")
    feynman_hibbs: bool = False
    feynman_hibbs_order: int = 2   # 2 | 4
    # Feynman-Kleinert variational effective potential (SURVEY §2.9 [L]):
    # self-consistent Gaussian-smeared pair LJ with harmonic trial; the
    # high-T limit is exactly feynman_hibbs order 2.  Mutually exclusive
    # with feynman_hibbs.  See ops/lj.py::feynman_kleinert_from_derivs.
    feynman_kleinert: bool = False
    # quantum rotation: enables the spinflip move (ortho<->para via cached
    # hindered-rotor free energies, refreshed per corrtime)
    quantum_rotation: bool = False
    # quantum vibration: per-corrtime stretch eigenspectra of diatomic
    # sorbates in the crystal field (ops/qvib.py); diagnostic observable
    # (adsorption-induced fundamental shift), like the reference's
    # spectra printouts (SURVEY §2.9 [L])
    quantum_vibration: bool = False

    # --- SPECTRE massive-polarizability free charges (SURVEY §2 [M];
    # PQR 'S'-flagged sites; per-corrtime charge renormalization —
    # see mc/spectre.py for the documented contract)
    spectre: bool = False
    spectre_max_charge: float = 1.0
    spectre_max_target: float = 0.0   # 0 -> no total-charge rescale

    # --- ensembles / moves (static structure; magnitudes live in Thermo)
    cavity_autoreject_absolute: float = 0.0   # r_min; 0 disables
    insert_species: Tuple[int, ...] = ()      # species eligible for GCMC
    # cavity-biased insertion (SURVEY §2 "Cavity bias"): propose GCMC
    # insertions only into grid cells with no atom within cavity_radius;
    # the acceptance picks up the open-cell volume fraction.  The grid is
    # refreshed at every corrtime boundary (the reference also updates
    # it periodically rather than per-step).
    cavity_bias: bool = False
    cavity_grid: int = 10
    cavity_radius: float = 2.5
    # transition-matrix MC collection (SURVEY §2 "MC main loop" family;
    # our documented extension — single-run flat-window isotherms): every
    # µVT insert/delete attempt accumulates its acceptance probability
    # into C[N, (n_ins, Σa_ins, n_del, Σa_del)]; ``analyze tmmc`` turns
    # the matrix into lnΠ(N)
    # and reweights to any fugacity.  Requires exactly one insert
    # species and no
    # polar_delayed (the two-stage acceptance has no closed-form
    # per-attempt probability — enforced in io/input_script).
    tmmc: bool = False
    # flat-histogram sampling on top of tmmc: the chain's insert/delete
    # acceptance is multiplied by exp(η(N') − η(N)) with η = −lnΠ̂
    # rebuilt from the collection matrix every corrtime (Thermo.tmmc_eta
    # — a pytree leaf, so the per-corrtime update does not recompile).
    # The COLLECTION stays unbiased (the classic TMMC loop: bias changes
    # where the chain walks, never the estimator), so lnΠ stays exact
    # while the walker diffuses across free-energy barriers in N.
    # Caveat: raw ⟨N⟩/⟨U⟩ block averages from a biased run are
    # bias-weighted — read the isotherm from ``analyze tmmc`` instead
    # (run.py prints a warning).
    tmmc_bias: bool = False

    # --- precision / performance
    # framework cell lists (ops/celllist.py, our documented extension —
    # the reference is pure O(N^2), SURVEY §1): cull the per-move delta
    # pass to the cells within cutoff+reach of the moved molecule.
    # Requires an explicit ``cutoff`` << L/2, a frozen framework, and a
    # fixed box; exact (no skin).  Takes effect once the runner attaches
    # an index (celllist.attach).
    cell_list: bool = False
    dtype: str = "float32"         # float32 | float64
    pair_chunk: int = 512          # row-block size for O(N^2) passes
    # In-loop spatial sharding (r2 verdict item 3): ("axis name", D)
    # when the MC step runs under a shard_map over a D-device mesh with
    # REPLICATED state — ops/pairs.mol_pair_pass slices its column axis
    # per device and psums the scalars, pair_pass round-robins its row
    # blocks, so the per-move O(A N) and per-refresh O(N^2) passes cost
    # 1/D per device (parallel/spatial.run_chunk_spatial).  Static, so
    # sharded and unsharded traces never share a jit cache entry.
    spatial_axis: Optional[Tuple[str, int]] = None
    # molecule-pair energy cache (ops/pairs.pair_matrix + SimState
    # cache_*): displace = one pass, delete = zero passes.  Opt-in:
    # the vmapped [C,M,M] row/col scatters cost more than they save at
    # large chain counts.  Eligibility: metropolis.cache_eligible.
    mol_cache: bool = False

    @property
    def jdtype(self):
        return jnp.float64 if self.dtype == "float64" else jnp.float32


# ---------------------------------------------------------------------------
# Thermodynamic / move-size inputs (pytree; can change without recompile)
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Thermo:
    """Continuous knobs consumed inside the jitted MC step.

    fugacity: per-species fugacity in atm (uVT acceptance, SURVEY §3.3).
    move probabilities follow the reference's semantics: a move type is
    picked by comparing one uniform draw against cumulative probabilities
    (insert/delete split the remainder of insert_probability in half).
    """
    temperature: jax.Array                   # K
    pressure: jax.Array                      # atm (NPT)
    fugacity: jax.Array                      # [n_species] atm
    move_factor: jax.Array                   # A, displacement half-width
    rot_factor: jax.Array                    # rad, max rotation angle
    insert_probability: jax.Array            # P(insert or delete)
    volume_probability: jax.Array            # P(volume move)
    volume_change_factor: jax.Array          # max |d ln V|
    spinflip_probability: jax.Array          # reserved (quantum rotation)
    # NVE: fixed total (kinetic + potential) energy [K] for Ray's
    # microcanonical acceptance (the ``total_energy`` option)
    nve_energy: jax.Array = None
    # flat-histogram TMMC bias η(N) [n_mols_max+1] (RunConfig.tmmc_bias):
    # None until the first per-corrtime rebuild resolves a lnΠ window
    # (the None→array transition recompiles once, like state.mu)
    tmmc_eta: jax.Array = None

    @classmethod
    def make(cls, temperature=298.0, pressure=1.0, fugacity=(),
             move_factor=1.0, rot_factor=1.0, insert_probability=0.0,
             volume_probability=0.0, volume_change_factor=0.05,
             spinflip_probability=0.0, nve_energy=0.0, n_species=None,
             dtype=jnp.float32):
        fug = jnp.atleast_1d(jnp.asarray(fugacity, dtype))
        if n_species is not None and fug.shape[0] < max(n_species, 1):
            fug = jnp.concatenate(
                [fug, jnp.zeros(max(n_species, 1) - fug.shape[0], dtype)])
        s = lambda v: jnp.asarray(v, dtype)
        return cls(
            temperature=s(temperature), pressure=s(pressure), fugacity=fug,
            move_factor=s(move_factor), rot_factor=s(rot_factor),
            insert_probability=s(insert_probability),
            volume_probability=s(volume_probability),
            volume_change_factor=s(volume_change_factor),
            spinflip_probability=s(spinflip_probability),
            nve_energy=s(nve_energy),
        )

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)
