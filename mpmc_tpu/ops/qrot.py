"""Quantum rotation: hindered-rigid-rotor eigenspectra for linear sorbates.

Rebuild of the reference's quantum-rotation subsystem (SURVEY.md §2
"Quantum rotation", src/quantum_rotation/*.c [M], build flag
-DQM_ROTATION): each H2-like linear rotor in the crystal field gets a
Hamiltonian in the spherical-harmonic basis |l m| (l <= lmax),

    H = B l(l+1) delta + <l m| V(Omega) |l' m'>,

with B = hbar^2 / 2I computed from the species geometry and V(Omega) the
interaction energy of the molecule rotated to orientation Omega about its
COM (evaluated with the production pair engine, vmapped over a
Gauss-Legendre x uniform-phi quadrature grid).  LAPACK dsyev becomes
jnp.linalg.eigh.

Nuclear-spin symmetry: para-H2 couples only even-l states, ortho-H2 only
odd-l (the reference's ortho/para machinery feeding its spinflip move).
``symmetry_free_energies`` gives F_sigma = -T ln sum_{l in sigma, m}
exp(-E_lm / T) per symmetry; the spinflip acceptance uses
exp(-(F_new - F_old)/T).

Host-level analysis code by design (the reference also runs it outside
the hot loop, at corrtime, on LAPACK): numpy + scipy spherical harmonics
for the basis, jax only for the vmapped potential evaluations.
"""
from __future__ import annotations

from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from scipy.special import sph_harm_y

from mpmc_tpu.constants import HBAR2_KB_AMU_A2
from mpmc_tpu.ops import pairs as pairs_mod
from mpmc_tpu.state import molecule_com


def rotational_constant(species) -> float:
    """B [K] = hbar^2 / (2 I kB) from the template geometry (perpendicular
    moment of inertia about the COM, amu A^2)."""
    pos = np.asarray(species.pos, np.float64)
    mass = np.asarray(species.mass, np.float64)
    # linear molecule: I = sum m_i |r_i|^2 (distances from COM; template is
    # COM-centered already)
    inertia = float(np.sum(mass * np.sum(pos * pos, axis=1)))
    if inertia <= 0:
        raise ValueError(f"species {species.name}: zero moment of inertia")
    return HBAR2_KB_AMU_A2 / (2.0 * inertia)


def quadrature_grid(n_theta: int = 16, n_phi: int = 32):
    """(theta[g], phi[g], w[g]): Gauss-Legendre x uniform-phi quadrature,
    exact for spherical harmonics up to degree ~n_theta."""
    x, wx = np.polynomial.legendre.leggauss(n_theta)
    theta = np.arccos(x)
    phi = (np.arange(n_phi) + 0.5) * 2.0 * np.pi / n_phi
    th, ph = np.meshgrid(theta, phi, indexing="ij")
    w = np.broadcast_to(wx[:, None] * (2.0 * np.pi / n_phi),
                        th.shape)
    return th.reshape(-1), ph.reshape(-1), w.reshape(-1)


def orientation_axes(theta, phi):
    """Unit vectors for the grid orientations [G,3]."""
    st = np.sin(theta)
    return np.stack([st * np.cos(phi), st * np.sin(phi),
                     np.cos(theta)], axis=-1)


def potential_on_grid(pos, box, atom_alive, params, cfg, temperature,
                      mol: int, axes) -> np.ndarray:
    """V(Omega_g) [K]: interaction energy of molecule ``mol`` with its
    environment when its symmetry axis points along axes[g].

    The molecule's atoms are placed along the axis at their COM-frame
    axial coordinates (linear rotor: template z coordinate = signed
    distance from COM).  Uses the same pair terms the MC engine uses
    (RD + ES real; reciprocal-space change with orientation is second
    order and omitted, as is consistent at fixed COM)."""
    axes = jnp.asarray(axes, pos.dtype)
    idx = params.mol_atoms[mol]
    na = params.mol_natoms[mol]
    ok = jnp.arange(idx.shape[0]) < na
    com = molecule_com(pos, params, mol)
    rel = pos[idx] - com
    # signed axial coordinate of each atom (linear molecule)
    d = jnp.linalg.norm(rel, axis=1)
    sign = jnp.where(jnp.sum(rel * rel[0], axis=1) >= 0, 1.0, -1.0)
    s = jnp.where(d > 1e-9, sign * d, 0.0)

    def energy_at(axis):
        new = com + s[:, None] * axis[None, :]
        new = jnp.where(ok[:, None], new, new[0])
        p = pos.at[idx].set(new.astype(pos.dtype))
        t = pairs_mod.mol_pair_pass(p, box, atom_alive, params, cfg,
                                    temperature, mol)
        return t.rd + t.es_real

    return np.asarray(jax.jit(jax.vmap(energy_at))(axes))


def rotor_hamiltonian(v_grid, theta, phi, w, lmax: int, b_const: float):
    """Dense Hamiltonian in the |l m| basis (complex Hermitian)."""
    nlm = (lmax + 1) ** 2
    y = np.zeros((nlm, len(theta)), np.complex128)
    ll = np.zeros(nlm)
    k = 0
    for l in range(lmax + 1):
        for m in range(-l, l + 1):
            y[k] = sph_harm_y(l, m, theta, phi)
            ll[k] = l * (l + 1)
            k += 1
    h = (y * (w * v_grid)[None, :]) @ y.conj().T
    h = h + np.diag(b_const * ll)
    return h, ll


def rotational_levels(pos, box, atom_alive, params, cfg, temperature,
                      mol: int, species, lmax: int = 4,
                      n_theta: int = 16, n_phi: int = 32):
    """Eigenvalues [K] and their l quantum numbers (by dominant weight)
    for one molecule in its current environment."""
    theta, phi, w = quadrature_grid(n_theta, n_phi)
    axes = orientation_axes(theta, phi)
    v = potential_on_grid(pos, box, atom_alive, params, cfg, temperature,
                          mol, axes)
    b_const = rotational_constant(species)
    h, ll = rotor_hamiltonian(v - v.mean(), theta, phi, w, lmax, b_const)
    evals, evecs = np.linalg.eigh(h)
    # parity label for ortho/para: expected l from <l(l+1)> per eigenvector
    weights = np.abs(evecs) ** 2
    l_of = np.round((np.sqrt(4 * (weights.T @ ll) + 1) - 1) / 2).astype(int)
    return evals + v.mean(), l_of


def symmetry_free_energies(evals, l_of, temperature) -> Tuple[float, float]:
    """(F_para, F_ortho) [K]: -T ln Z over even-l / odd-l levels."""
    def f(par):
        sel = (l_of % 2) == par
        if not np.any(sel):
            return np.inf
        e = evals[sel]
        e0 = e.min()
        return e0 - temperature * np.log(
            np.sum(np.exp(-(e - e0) / temperature)))
    return f(0), f(1)


def eigen_tables(pos, box, atom_alive, mol_alive, params, cfg, thermo,
                 species_list, lmax: int = 4):
    """{mol: (evals, l_of)} hindered-rotor eigensolves for every alive
    movable linear rotor — the position-dependent part of the spinflip
    cache.  The explicit temperature enters only the Boltzmann sums in
    table_from_eigs, so a parallel-tempering temperature swap can
    rebuild rot_f from these WITHOUT new eigensolves (the potential
    surface itself keeps the per-corrtime staleness contract)."""
    M = int(params.n_mols_max)
    eigs = {}
    alive_m = np.asarray(mol_alive)
    spec = np.asarray(params.mol_species)
    frozen = np.asarray(params.mol_frozen)
    natoms = np.asarray(params.mol_natoms)
    for m in range(M):
        sidx = int(spec[m])
        if not alive_m[m] or frozen[m] or sidx < 0 or natoms[m] < 2:
            continue
        try:
            eigs[m] = rotational_levels(
                pos, box, atom_alive, params, cfg, thermo.temperature, m,
                species_list[sidx], lmax=lmax)
        except ValueError:
            continue   # zero moment of inertia: not a rotor
    return eigs


def table_from_eigs(eigs, n_mols: int, temperature) -> np.ndarray:
    """[M,2] (F_para, F_ortho) [K] from cached eigensolves at the given
    temperature (zeros for non-rotor slots)."""
    table = np.zeros((int(n_mols), 2), np.float64)
    t = float(temperature)
    for m, (evals, l_of) in eigs.items():
        table[m] = symmetry_free_energies(evals, l_of, t)
    return table


def level_arrays(eigs, n_mols: int, lmax: int):
    """Array form of an ``eigen_tables`` cache for ON-DEVICE F(T)
    rebuilds: (levels [M,L] f64, parity [M,L] int32, valid [M,L] bool)
    with L = (lmax+1)^2 padded lanes.  Rows absent from ``eigs``
    (non-rotor slots) are all-invalid — ``free_energies_from_levels``
    maps them to the same zeros ``table_from_eigs`` leaves."""
    L = (int(lmax) + 1) ** 2
    M = int(n_mols)
    levels = np.zeros((M, L), np.float64)
    par = np.zeros((M, L), np.int32)
    valid = np.zeros((M, L), bool)
    for m, (evals, l_of) in eigs.items():
        n = min(len(evals), L)
        levels[m, :n] = np.asarray(evals)[:n]
        par[m, :n] = np.asarray(l_of)[:n] % 2
        valid[m, :n] = True
    return levels, par, valid


def free_energies_from_levels(levels, par, valid, temperature):
    """Pure-jnp ``table_from_eigs``: [M,2] (F_para, F_ortho) [K] from the
    ``level_arrays`` form at the given (traced) temperature.

    This is the per-swap parallel-tempering rebuild (SURVEY.md §2
    "Quantum rotation" + "Parallel tempering"): a temperature swap keeps
    each replica's configuration — and therefore its cached hindered-rotor
    eigensolves — and only re-evaluates the Boltzmann sums at the new T,
    so the rebuild can run inside a jitted PT round instead of forcing a
    host sync (ops/qrot.table_from_eigs is its host-numpy twin;
    test_qrot pins the two equal)."""
    t = jnp.asarray(temperature, levels.dtype)

    def f(p):
        sel = valid & (par == p)
        e = jnp.where(sel, levels, jnp.inf)
        e0 = jnp.min(e, axis=1)                      # inf when no levels
        has = jnp.isfinite(e0)
        z = jnp.sum(jnp.where(sel, jnp.exp(-(levels
                                             - jnp.where(has, e0, 0.0)
                                             [:, None]) / t), 0.0),
                    axis=1)
        fp = e0 - t * jnp.log(jnp.maximum(z, 1e-300))
        return jnp.where(has, fp, jnp.inf)

    f_para, f_ortho = f(0), f(1)
    has_rotor = jnp.any(valid, axis=1)
    return jnp.where(has_rotor[:, None],
                     jnp.stack([f_para, f_ortho], axis=1), 0.0)


def free_energy_table(pos, box, atom_alive, mol_alive, params, cfg,
                      thermo, species_list, lmax: int = 4) -> np.ndarray:
    """[M,2] table of (F_para, F_ortho) [K] for every alive movable
    linear rotor (zeros elsewhere) — the per-corrtime cache behind the
    per-step spinflip move (SURVEY.md §2 "Moves / checkpoint")."""
    eigs = eigen_tables(pos, box, atom_alive, mol_alive, params, cfg,
                        thermo, species_list, lmax=lmax)
    return table_from_eigs(eigs, int(params.n_mols_max),
                           thermo.temperature)


def spinflip_sweep(pos, box, atom_alive, params, cfg, thermo, species_list,
                   mol_slots: List[int], spins: np.ndarray, rng,
                   lmax: int = 4) -> Tuple[np.ndarray, int, float]:
    """One spinflip attempt per listed molecule using cached eigenspectra
    (the reference's spinflip move, SURVEY.md §2 "Moves / checkpoint":
    ortho<->para via the quantum-rotation eigenspectrum).  Returns
    (new_spins, n_flips, mean_rotational_energy)."""
    t = float(thermo.temperature)
    n_flips = 0
    e_rot_sum = 0.0
    spins = spins.copy()
    for j, mol in enumerate(mol_slots):
        sp = species_list[int(np.asarray(params.mol_species)[mol])]
        evals, l_of = rotational_levels(
            pos, box, atom_alive, params, cfg, thermo.temperature, mol, sp,
            lmax=lmax)
        f_para, f_ortho = symmetry_free_energies(evals, l_of, t)
        f_cur = f_ortho if spins[j] else f_para
        f_new = f_para if spins[j] else f_ortho
        e_rot_sum += f_cur
        if np.log(rng.random()) < -(f_new - f_cur) / t:
            spins[j] = 1 - spins[j]
            n_flips += 1
    return spins, n_flips, e_rot_sum / max(len(mol_slots), 1)
