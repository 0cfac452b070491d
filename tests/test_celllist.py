"""Framework cell lists (ops/celllist.py): the culled per-move delta pass
must be EXACT — same pairs as the dense O(A*N) pass, no skin — and the MC
bookkeeping invariant must hold against dense full recomputes."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from mpmc_tpu.config import RunConfig, Thermo
from mpmc_tpu.mc import metropolis
from mpmc_tpu.models import systems
from mpmc_tpu.ops import celllist, pairs


def _mof(cutoff=6.0, polar=False, n_side=6, n_h2=12, capacity=24):
    params, state, cfg, thermo = systems.mof_h2_gcmc(
        n_side=n_side, spacing=4.0, n_h2=n_h2, capacity=capacity,
        temperature=77.0, pressure=2.0, dtype="float64",
        polarization=polar)
    cfg = dataclasses.replace(cfg, cutoff=cutoff, cell_list=True)
    # min_reduction=None: force the index even on this deliberately tiny
    # test system (profitability is a production concern, exactness isn't)
    params = celllist.attach(params, state.pos, state.box, cfg,
                             min_reduction=None)
    assert params.cell_index is not None
    return params, state, cfg, thermo


def test_culled_equals_dense():
    """Every alive molecule's culled delta terms match the dense pass to
    summation rounding (rd, es_real, lrc are pair-for-pair identical)."""
    params, state, cfg, thermo = _mof()
    cfg_dense = dataclasses.replace(cfg, cell_list=False)
    alive = state.atom_alive(params)
    for mol in range(1, int(params.n_mols_max)):
        if not bool(state.mol_alive[mol]):
            continue
        culled = pairs.mol_pair_pass(state.pos, state.box, alive, params,
                                     cfg, thermo.temperature, mol)
        dense = pairs.mol_pair_pass(state.pos, state.box, alive, params,
                                    cfg_dense, thermo.temperature, mol)
        for slot in ("rd", "es_real", "lrc_coeff"):
            a, b = float(getattr(culled, slot)), float(getattr(dense, slot))
            assert a == pytest.approx(b, rel=1e-12, abs=1e-10), (mol, slot)


def test_culled_covers_boundary_molecules():
    """Molecules straddling the periodic boundary gather wrapped cells."""
    params, state, cfg, thermo = _mof()
    cfg_dense = dataclasses.replace(cfg, cell_list=False)
    # move the first sorbate to a cell corner (worst case for wrapping)
    idx = np.asarray(params.mol_atoms[1])
    na = int(params.mol_natoms[1])
    pos = np.asarray(state.pos).copy()
    tmpl = np.asarray(params.species_pos[0])[:na]
    pos[idx[:na]] = tmpl + np.array([0.05, 0.02, -0.03])
    pos_j = jnp.asarray(pos)
    alive = state.atom_alive(params)
    culled = pairs.mol_pair_pass(pos_j, state.box, alive, params, cfg,
                                 thermo.temperature, 1)
    dense = pairs.mol_pair_pass(pos_j, state.box, alive, params, cfg_dense,
                                thermo.temperature, 1)
    assert float(culled.rd) == pytest.approx(float(dense.rd), rel=1e-12)
    assert float(culled.es_real) == pytest.approx(float(dense.es_real),
                                                  rel=1e-12, abs=1e-10)


def test_gcmc_bookkeeping_with_cell_list():
    """Hundreds of culled-delta GCMC steps agree with a dense full-pass
    recompute — proves the culled pair set is exact through inserts,
    deletes, displacements and rotations."""
    params, state, cfg, thermo = _mof()
    state = metropolis.initialize(state, params, cfg, thermo)
    state, stats = metropolis.run_chunk(state, params, cfg, thermo, 300)
    fresh = metropolis.initialize(state, params, cfg, thermo)
    for slot in ("rd", "es_real", "es_recip", "es_self", "es_excl", "lrc"):
        assert float(getattr(state.energy, slot)) == pytest.approx(
            float(getattr(fresh.energy, slot)), rel=1e-8, abs=1e-6), slot
    assert int(stats.attempts[1]) > 0 and int(stats.attempts[2]) > 0
    assert int(stats.accepts.sum()) > 0


def test_asymmetric_template_coverage():
    """Species whose mass COM differs from its site centroid (off-center
    massless sites): reach must be measured from the unweighted centroid
    the runtime query centers on, not the mass COM the template is stored
    around (ADVICE r1, `_species_reach`).  Geometry chosen so the old
    COM-based reach (2.5 A) under-covers the true query radius (3.2 A)
    and the resulting 4-cell grid (edge 8.75 < 9.2) drops near-cutoff
    pairs for some placements."""
    from mpmc_tpu.state import Species, build_system
    n_side, spacing = 7, 5.0
    ijk = np.stack(np.meshgrid(*[np.arange(n_side)] * 3,
                               indexing="ij"), -1).reshape(-1, 3)
    fpos = (ijk + 0.5) * spacing
    F = len(fpos)
    z = np.zeros(F)
    fp = {"charge": z, "mass": np.full(F, 12.0), "polar": z,
          "eps": np.full(F, 40.0), "sig": np.full(F, 3.0),
          "omega": z, "c6": z, "c8": z, "c10": z, "gwp_alpha": z}
    # heavy atom at the Chebyshev center of the site set, a cluster of
    # massless sites left, one far massless site right
    sp = Species(
        name="AS", atom_names=("A", "L1", "L2", "L3", "L4"),
        pos=np.array([[0.0, 0, 0], [-2, 0, 0], [-2, 0.1, 0],
                      [-2, -0.1, 0], [2.5, 0, 0]]),
        mass=np.array([16.0, 1e-6, 1e-6, 1e-6, 1e-6]),
        charge=np.zeros(5), polar=np.zeros(5),
        eps=np.full(5, 25.0), sig=np.full(5, 2.8))
    box = np.eye(3) * (n_side * spacing)
    params, state = build_system(
        box, frozen_pos=fpos, frozen_params=fp, species=(sp,),
        capacity=(2,), initial_counts=(1,), dtype=jnp.float64)
    cfg = RunConfig(ensemble="nvt", cutoff=6.0, cell_list=True,
                    dtype="float64", coulomb="none")
    params = celllist.attach(params, state.pos, state.box, cfg,
                             min_reduction=None)
    assert params.cell_index is not None
    cfg_dense = dataclasses.replace(cfg, cell_list=False)
    mol = 1
    idx = np.asarray(params.mol_atoms[mol])
    na = int(params.mol_natoms[mol])
    tmpl = np.asarray(params.species_pos[0])[:na]
    alive = state.atom_alive(params)
    # reach must be the max template distance from the unweighted
    # centroid (~3.2 A here), not from the mass COM (~2.5 A)
    cen = tmpl.mean(axis=0)
    want = float(np.linalg.norm(tmpl - cen, axis=1).max())
    assert celllist._species_reach(params) == pytest.approx(want, abs=1e-6)
    assert want > float(np.linalg.norm(tmpl, axis=1).max()) + 0.5

    t = jnp.asarray(300.0, jnp.float64)
    rng = np.random.default_rng(3)
    # deterministic worst case under the buggy COM-based grid (G=4,
    # edge 8.75): query centroid just left of a cell boundary, framework
    # atom at x=17.5 inside the uncovered sliver yet within the cutoff
    # of the far +x site — plus a randomized sweep
    bases = [np.array([8.70, 2.5, 2.5]) - cen]
    bases += list(rng.uniform(0.0, n_side * spacing, (60, 3)))
    for base in bases:
        pos = np.asarray(state.pos).copy()
        pos[idx[:na]] = base + tmpl
        pos_j = jnp.asarray(pos)
        culled = pairs.mol_pair_pass(pos_j, state.box, alive, params,
                                     cfg, t, mol)
        dense = pairs.mol_pair_pass(pos_j, state.box, alive, params,
                                    cfg_dense, t, mol)
        assert float(culled.rd) == pytest.approx(
            float(dense.rd), rel=1e-12, abs=1e-10), base


def test_attach_refuses_npt_and_degrades_gracefully():
    params, state, cfg, thermo = systems.lj_fluid(n=32, dtype="float64")
    # no frozen framework -> attach is a no-op
    cfg2 = dataclasses.replace(cfg, cutoff=4.0, cell_list=True)
    p2 = celllist.attach(params, state.pos, state.box, cfg2)
    assert p2.cell_index is None
    with pytest.raises(ValueError):
        celllist.build_cell_index(
            params, state.pos, state.box,
            dataclasses.replace(cfg2, ensemble="npt"))
