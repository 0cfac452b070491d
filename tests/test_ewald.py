"""Ewald electrostatics parity against analytic lattice (Madelung) sums
(SURVEY.md §4: "golden per-term energies ... Madelung constants for Ewald").
"""
import jax.numpy as jnp
import numpy as np
import pytest

from mpmc_tpu.config import RunConfig, Thermo
from mpmc_tpu.constants import KE
from mpmc_tpu.ops import energy as energy_mod
from mpmc_tpu.ops import ewald, pairs

from helpers import two_species_lattice, free_atoms

MADELUNG_NACL = 1.747564594633182
MADELUNG_CSCL = 1.762674773070988


def cfg_es(**kw):
    kw.setdefault("rd_potential", "none")
    kw.setdefault("coulomb", "ewald")
    kw.setdefault("dtype", "float64")
    kw.setdefault("rd_lrc", False)
    return RunConfig(**kw)


def thermo():
    return Thermo.make(temperature=300.0, n_species=2, dtype=jnp.float64)


def nacl_cells(ncell=2, a=5.64):
    """Rock-salt supercell: returns (box, na_coords, cl_coords)."""
    base_na = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5],
                        [0, 0.5, 0.5]])
    base_cl = base_na + np.array([0.5, 0, 0])
    na, cl = [], []
    for i in range(ncell):
        for j in range(ncell):
            for k in range(ncell):
                off = np.array([i, j, k])
                na.append((base_na + off) * a)
                cl.append((base_cl + off) * a)
    box = ncell * a * np.eye(3)
    return box, np.concatenate(na) , np.concatenate(cl)


def test_madelung_nacl():
    a = 5.64
    box, na, cl = nacl_cells(2, a)
    params, state = two_species_lattice(box, na, cl)
    cfg = cfg_es(ewald_kmax=10)
    e, _ = energy_mod.total_energy(state.pos, state.box, state.mol_alive,
                                   params, cfg, thermo())
    n_ions = len(na) + len(cl)
    r_nn = a / 2
    expect = -n_ions * MADELUNG_NACL * KE / (2 * r_nn)
    assert float(e.es) == pytest.approx(expect, rel=1e-6)


def test_madelung_cscl():
    a = 4.11  # CsCl lattice constant; nn distance = a*sqrt(3)/2
    n = 3
    cs, cl = [], []
    for i in range(n):
        for j in range(n):
            for k in range(n):
                cs.append(np.array([i, j, k], float) * a)
                cl.append((np.array([i, j, k], float) + 0.5) * a)
    box = n * a * np.eye(3)
    params, state = two_species_lattice(box, np.array(cs), np.array(cl))
    cfg = cfg_es(ewald_kmax=10)
    e, _ = energy_mod.total_energy(state.pos, state.box, state.mol_alive,
                                   params, cfg, thermo())
    n_ions = 2 * n ** 3
    r_nn = a * np.sqrt(3) / 2
    expect = -n_ions * MADELUNG_CSCL * KE / (2 * r_nn)
    assert float(e.es) == pytest.approx(expect, rel=1e-6)


def test_ewald_alpha_invariance():
    """Total Ewald energy must be independent of the splitting alpha."""
    box, na, cl = nacl_cells(2)
    params, state = two_species_lattice(box, na, cl)
    outs = []
    # alpha*rc must stay >= ~3.5 for the real-space truncation error to be
    # below 1e-6 (rc = 5.64 here); the default is exactly 3.5/rc.
    for alpha in (0.62, 0.7, 0.8):
        cfg = cfg_es(ewald_kmax=12, ewald_alpha=alpha)
        e, _ = energy_mod.total_energy(state.pos, state.box, state.mol_alive,
                                       params, cfg, thermo())
        outs.append(float(e.es))
    np.testing.assert_allclose(outs, outs[0], rtol=2e-6)


def test_intramolecular_exclusion():
    """A rigid 2-charge molecule alone in a box: with the direct
    intramolecular interaction excluded, the only remaining electrostatic
    energy is the interaction with its own periodic images — a dipole
    lattice term that (a) is alpha-invariant, (b) decays ~1/L^3 with box
    size, and (c) is tiny vs the raw intramolecular energy (~1e4 K)."""
    from mpmc_tpu.state import Species, build_system
    sp = Species(name="dip", atom_names=("P", "M"),
                 pos=np.array([[0, 0, 0], [1.1, 0, 0.3]]),
                 mass=np.array([1.0, 1.0]),
                 charge=np.array([0.5, -0.5]),
                 polar=np.zeros(2), eps=np.zeros(2), sig=np.zeros(2))
    es = {}
    for L in (30.0, 60.0):
        box = L * np.eye(3)
        params, state = build_system(box, species=(sp,), capacity=(1,),
                                     initial_counts=(1,), dtype=jnp.float64)
        vals = []
        for alpha in (3.5 / (L / 2), 4.5 / (L / 2)):
            cfg = cfg_es(ewald_kmax=14, ewald_alpha=alpha)
            e, _ = energy_mod.total_energy(
                state.pos, state.box, state.mol_alive, params, cfg, thermo())
            vals.append(float(e.es))
        np.testing.assert_allclose(vals, vals[0], atol=1e-6)
        es[L] = vals[0]
        assert abs(float(e.es_excl)) > 1.0  # the correction is non-zero
    # image interaction decays ~1/L^3 and is small vs intramolecular scale
    assert abs(es[30.0]) < 20.0
    assert abs(es[60.0]) < abs(es[30.0]) / 6.0


def test_structure_factor_delta_update():
    """Moving one molecule: S(k) delta update == recompute from scratch."""
    rng = np.random.default_rng(5)
    L = 14.0
    coords = rng.uniform(0, L, (10, 3))
    box = L * np.eye(3)
    params, state = two_species_lattice(box, coords[:5], coords[5:],
                                        qa=0.3, qb=-0.3)
    alive = state.atom_alive(params)
    kv = ewald.kvectors(state.box, 6)
    sk_re, sk_im = ewald.structure_factor(state.pos, params.charge, alive, kv)
    # move molecule 4 (atom 4)
    new_pos = state.pos.at[4].add(jnp.asarray([1.3, -0.7, 0.2]))
    idx = params.mol_atoms[4]
    ok = jnp.arange(idx.shape[0]) < params.mol_natoms[4]
    old_re, old_im = ewald.mol_structure_factor(
        state.pos[idx], params.charge[idx], ok, kv)
    nre, nim = ewald.mol_structure_factor(
        new_pos[idx], params.charge[idx], ok, kv)
    upd_re = sk_re - old_re + nre
    upd_im = sk_im - old_im + nim
    ref_re, ref_im = ewald.structure_factor(new_pos, params.charge, alive, kv)
    np.testing.assert_allclose(np.asarray(upd_re), np.asarray(ref_re),
                               atol=1e-10)
    np.testing.assert_allclose(np.asarray(upd_im), np.asarray(ref_im),
                               atol=1e-10)


def test_wolf_approximates_ewald_nacl():
    box, na, cl = nacl_cells(2)
    params, state = two_species_lattice(box, na, cl)
    e_ref, _ = energy_mod.total_energy(
        state.pos, state.box, state.mol_alive, params,
        cfg_es(ewald_kmax=10), thermo())
    e_wolf, _ = energy_mod.total_energy(
        state.pos, state.box, state.mol_alive, params,
        cfg_es(coulomb="wolf"), thermo())
    assert float(e_wolf.es) == pytest.approx(float(e_ref.es), rel=2e-2)


def test_total_es_invariant_under_ewald_parameters():
    """The physical electrostatic energy must be independent of the
    splitting parameter alpha and (converged) kmax — a stringent
    cross-check of real/recip/self/exclusion consistency."""
    import dataclasses
    from mpmc_tpu.config import Thermo
    from mpmc_tpu.models import systems
    from mpmc_tpu.ops import energy as energy_mod
    params, state, cfg, thermo = systems.mof_h2_gcmc(
        n_side=4, n_h2=8, capacity=16, dtype="float64")
    cfg = dataclasses.replace(cfg, rd_potential="none", rd_lrc=False)
    # alpha*rc >= 3.5 keeps the real-space sum converged; kmax=14 keeps
    # the reciprocal sum converged for every alpha here.  The individual
    # terms shift by ~1e5 K across these parameters and must cancel.
    ref = None
    rc = 8.0
    for alpha in (0.4375, 0.50, 0.55):
        c = dataclasses.replace(cfg, cutoff=rc, ewald_alpha=float(alpha),
                                ewald_kmax=14)
        e, _ = energy_mod.total_energy(state.pos, state.box,
                                       state.mol_alive, params, c, thermo)
        es = float(e.es)
        if ref is None:
            ref = es
        else:
            assert es == pytest.approx(ref, abs=0.5), alpha


class TestMxuStructureFactor:
    """Separable matmul S(k) (ops/ewald.py::structure_factor_mxu):
    identical physics to the half-space path on the same k-sphere."""

    def _random_system(self, seed=0, n=40, triclinic=True):
        rng = np.random.default_rng(seed)
        if triclinic:
            box = jnp.asarray([[14.0, 0.0, 0.0], [2.5, 13.0, 0.0],
                               [-1.5, 3.0, 12.0]], jnp.float64)
        else:
            box = jnp.eye(3, dtype=jnp.float64) * 13.0
        pos = jnp.asarray(rng.uniform(0, 10, (n, 3)), jnp.float64)
        q = rng.uniform(-1, 1, n)
        q = jnp.asarray(q - q.mean(), jnp.float64)
        alive = jnp.asarray(rng.random(n) < 0.9)
        return box, pos, q, alive

    def test_sf_matches_direct_on_rect_table(self):
        box, pos, q, alive = self._random_system()
        kmax = 5
        import dataclasses
        cfg = cfg_es(ewald_mxu=True, ewald_kmax=kmax)
        kv, _ = ewald.ktable(box, cfg)
        d_re, d_im = ewald.structure_factor(pos, q, alive, kv)
        m_re, m_im = ewald.structure_factor_mxu(pos, q, alive, box, kmax)
        np.testing.assert_allclose(np.asarray(m_re), np.asarray(d_re),
                                   atol=1e-9)
        np.testing.assert_allclose(np.asarray(m_im), np.asarray(d_im),
                                   atol=1e-9)

    def test_recip_energy_matches_half_space(self):
        for seed in (0, 3):
            box, pos, q, alive = self._random_system(seed)
            alpha = 0.35
            e_half, _ = ewald.recip_energy(pos, q, alive, box, alpha,
                                           cfg_es(ewald_kmax=6))
            e_mxu, _ = ewald.recip_energy(
                pos, q, alive, box, alpha,
                cfg_es(ewald_mxu=True, ewald_kmax=6))
            assert float(e_mxu) == pytest.approx(float(e_half), rel=1e-12)

    def test_gcmc_bookkeeping_with_mxu(self):
        import dataclasses
        from mpmc_tpu.mc import metropolis
        from mpmc_tpu.models import systems
        params, state, cfg, thermo_ = systems.mof_h2_gcmc(
            n_side=3, n_h2=6, capacity=12, ewald_kmax=4)
        cfg = dataclasses.replace(cfg, dtype="float64", ewald_mxu=True)
        import jax
        to64 = lambda x: (x.astype(jnp.float64)
                          if hasattr(x, "dtype") and x.dtype == jnp.float32
                          else x)
        state = jax.tree_util.tree_map(to64, state)
        params = jax.tree_util.tree_map(to64, params)
        state = metropolis.initialize(state, params, cfg, thermo_)
        assert state.sk_re.shape[0] == (2 * 4 + 1) ** 3
        st, stats = metropolis.run_chunk(state, params, cfg, thermo_, 200)
        st2 = metropolis.initialize(st, params, cfg, thermo_)
        assert float(st.energy.total) == pytest.approx(
            float(st2.energy.total), abs=1e-8)
        assert int(np.asarray(stats.accepts).sum()) > 0


# --------------------------------------------------------------------------
# Charged-cell jellium correction (r2 verdict item 6)

# Wigner (one-component-plasma) lattice constant: potential at a unit
# point charge in a simple-cubic array with uniform neutralizing
# background is -2.837297479/L; the energy per charge is half that.
WIGNER = 2.837297479


def test_charged_cell_wigner_lattice_energy():
    """One +1 charge in a cubic box + the uniform-background correction
    must reproduce the Wigner jellium Madelung energy -xi/(2L) ke and be
    alpha/cutoff independent (the correction is what removes the
    alpha-dependence of a non-neutral Ewald sum)."""
    L = 10.0
    box = L * np.eye(3)
    params, state = free_atoms(box, [[0.0, 0.0, 0.0]], eps=0.0, sig=0.0,
                               charge=1.0)
    expect = -WIGNER / (2.0 * L) * KE
    vals = []
    for cut, kmax in ((0.5 * L, 12), (0.35 * L, 16)):
        cfg = cfg_es(cutoff=cut, ewald_kmax=kmax,
                     allow_charged_cell=True)
        e, _ = energy_mod.total_energy(state.pos, state.box,
                                       state.mol_alive, params, cfg,
                                       thermo())
        vals.append(float(e.es))
    assert vals[0] == pytest.approx(expect, rel=2e-4)
    assert vals[1] == pytest.approx(expect, rel=2e-4)
    # alpha differs (3.5/cutoff) but the corrected totals agree
    assert vals[0] == pytest.approx(vals[1], rel=2e-4)


def test_charged_cell_background_removes_alpha_dependence():
    """Without the correction a net-charge cell's recip+self sum is
    gauge-dependent in alpha; with it the dependence cancels.  A 2-charge
    (+1,+1) cell checked across a 2x alpha range."""
    L = 12.0
    box = L * np.eye(3)
    params, state = free_atoms(box, [[0.0, 0.0, 0.0],
                                     [0.31 * L, 0.47 * L, 0.11 * L]],
                               eps=0.0, sig=0.0, charge=1.0)
    es, es_nobg = [], []
    for cut in (0.5 * L, 0.3 * L):
        cfg = cfg_es(cutoff=cut, ewald_kmax=16, allow_charged_cell=True)
        e, _ = energy_mod.total_energy(state.pos, state.box,
                                       state.mol_alive, params, cfg,
                                       thermo())
        alpha = float(pairs.derived_alpha(
            pairs.derived_cutoff(state.box, cfg), cfg))
        bg = float(ewald.background_correction(
            params.charge, state.atom_alive(params),
            jnp.asarray(alpha, jnp.float64), jnp.asarray(L ** 3,
                                                         jnp.float64)))
        es.append(float(e.es))
        es_nobg.append(float(e.es) - bg)
    assert es[0] == pytest.approx(es[1], rel=2e-4)
    # the uncorrected sums disagree by far more than the corrected ones
    assert abs(es_nobg[0] - es_nobg[1]) > 1e3 * abs(es[0] - es[1])


def test_charged_species_gcmc_background_bookkeeping():
    """GCMC of a CHARGED template (jellium counter-background): the
    scan path's insert/delete background deltas must track the full
    recompute exactly (the delta is quadratic in the net charge Q, so
    any error compounds across exchanges)."""
    import dataclasses

    from mpmc_tpu.mc import metropolis
    from mpmc_tpu.config import Thermo as _Th

    from helpers import atom_species
    from mpmc_tpu.state import build_system

    L = 12.0
    box = L * np.eye(3)
    rng = np.random.default_rng(5)
    coords = rng.uniform(1.0, L - 1.0, (6, 3))
    sp = atom_species(eps=10.0, sig=2.5, charge=0.5)
    params, state = build_system(
        box, species=(sp,), capacity=(12,), initial_counts=(6,),
        initial_pos={0: coords[:, None, :]}, dtype=jnp.float64)
    cfg = cfg_es(ensemble="uvt", cutoff=0.5 * L, ewald_kmax=8,
                 insert_species=(0,), allow_charged_cell=True)
    th = _Th.make(temperature=300.0, fugacity=(2.0,),
                  insert_probability=0.6, move_factor=1.0,
                  rot_factor=0.1, n_species=1, dtype=jnp.float64)
    state = metropolis.initialize(state, params, cfg, th)
    st, stats = metropolis.run_chunk(state, params, cfg, th, 300)
    acc = np.asarray(stats.accepts)
    assert acc[metropolis.INSERT] + acc[metropolis.DELETE] > 0
    fresh = metropolis.initialize(st, params, cfg, th)
    for term in ("es_real", "es_recip", "es_self", "es_excl"):
        assert float(getattr(st.energy, term)) == pytest.approx(
            float(getattr(fresh.energy, term)), rel=1e-9, abs=1e-9), term
