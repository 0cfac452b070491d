"""Periodic-image RD lattice sum (rd_crystal) — validated against the
known simple-cubic Lennard-Jones lattice sums and the delta-vs-recompute
bookkeeping invariant (SURVEY.md §2 "Lennard-Jones RD": rd_crystal [M])."""
import jax.numpy as jnp
import numpy as np
import pytest

from helpers import free_atoms
from mpmc_tpu.config import RunConfig, Thermo
from mpmc_tpu.mc import metropolis
from mpmc_tpu.ops import energy as energy_mod

# Simple-cubic LJ lattice sums A_n = sum_{p != 0} |p|^-n over integer
# triples, in units of the nearest-neighbor distance (standard values,
# e.g. Ashcroft & Mermin tab. 20.1 convention):
A12_SC = 6.2021888
A6_SC = 8.4019238


def sc_lattice(m, a):
    g = np.arange(m) * a
    return np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)


def crystal_energy(order, m=3, a=3.6, eps=100.0, sig=3.2):
    coords = sc_lattice(m, a)
    params, state = free_atoms(m * a * np.eye(3), coords, eps=eps, sig=sig)
    cfg = RunConfig(ensemble="nvt", coulomb="none", dtype="float64",
                    rd_crystal=True, rd_crystal_order=order, rd_lrc=False,
                    pair_chunk=32)
    thermo = Thermo.make(temperature=100.0, n_species=1, dtype=jnp.float64)
    e, aux = energy_mod.total_energy(state.pos, state.box, state.mol_alive,
                                     params, cfg, thermo)
    return float(e.rd), coords.shape[0], eps, sig, a


def test_sc_lj_lattice_sum():
    """Energy/atom of a simple-cubic LJ crystal matches the analytic
    lattice-sum constants: U/N = 2 eps [A12 (sig/a)^12 - A6 (sig/a)^6]."""
    u, n, eps, sig, a = crystal_energy(order=3)
    expected = 2.0 * eps * (A12_SC * (sig / a) ** 12
                            - A6_SC * (sig / a) ** 6)
    assert u / n == pytest.approx(expected, rel=2e-3)


def test_order_convergence():
    """The image sum converges as the shell order grows (the r^-6 tail
    falls off as 1/R^3)."""
    u2, n, eps, sig, a = crystal_energy(order=2)
    u3, *_ = crystal_energy(order=3)
    u4, *_ = crystal_energy(order=4)
    expected = 2.0 * eps * (A12_SC * (sig / a) ** 12
                            - A6_SC * (sig / a) ** 6) * n
    assert abs(u3 - expected) < abs(u2 - expected)
    assert abs(u4 - expected) < 0.6 * abs(u2 - expected)


def test_rd_crystal_mc_bookkeeping():
    """Delta-energy accumulation through displace moves must match a fresh
    full recompute (the crystal sum's own-image terms rotate with the
    molecule)."""
    rng = np.random.default_rng(3)
    L, n = 11.0, 12
    coords = rng.uniform(0, L, (n, 3))
    params, state = free_atoms(L * np.eye(3), coords, eps=80.0, sig=3.0)
    cfg = RunConfig(ensemble="nvt", coulomb="none", dtype="float64",
                    rd_crystal=True, rd_crystal_order=1, rd_lrc=False,
                    pair_chunk=16)
    thermo = Thermo.make(temperature=250.0, move_factor=0.7, rot_factor=0.4,
                         n_species=1, dtype=jnp.float64)
    state = metropolis.initialize(state, params, cfg, thermo)
    state, stats = metropolis.run_chunk(state, params, cfg, thermo, 250)
    fresh = metropolis.initialize(state, params, cfg, thermo)
    assert float(state.energy.rd) == pytest.approx(
        float(fresh.energy.rd), rel=1e-9, abs=1e-7)
    assert 0 < int(stats.accepts[0]) < 250


def test_rd_crystal_gcmc_bookkeeping():
    """GCMC insert/delete with the crystal sum: the one-sided delta
    (inter + own-image terms) must match the triangular full pass."""
    from mpmc_tpu.state import Species, build_system
    rng = np.random.default_rng(4)
    L, cap, n0 = 10.0, 16, 6
    sp = Species(name="Ar", atom_names=("Ar",), pos=np.zeros((1, 3)),
                 mass=np.array([39.9]), charge=np.array([0.0]),
                 polar=np.array([0.0]), eps=np.array([90.0]),
                 sig=np.array([3.1]))
    params, state = build_system(
        L * np.eye(3), species=(sp,), capacity=(cap,), initial_counts=(n0,),
        initial_pos={0: rng.uniform(0, L, (n0, 1, 3))}, dtype=jnp.float64)
    cfg = RunConfig(ensemble="uvt", coulomb="none", dtype="float64",
                    rd_crystal=True, rd_crystal_order=1, rd_lrc=False,
                    insert_species=(0,), pair_chunk=16)
    thermo = Thermo.make(temperature=200.0, fugacity=[2.0],
                         move_factor=0.7, rot_factor=0.4,
                         insert_probability=0.5, n_species=1,
                         dtype=jnp.float64)
    state = metropolis.initialize(state, params, cfg, thermo)
    state, stats = metropolis.run_chunk(state, params, cfg, thermo, 250)
    fresh = metropolis.initialize(state, params, cfg, thermo)
    assert float(state.energy.rd) == pytest.approx(
        float(fresh.energy.rd), rel=1e-9, abs=1e-7)
    assert int(stats.attempts[1]) > 0 and int(stats.attempts[2]) > 0
