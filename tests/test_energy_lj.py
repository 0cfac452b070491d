"""LJ pair-energy parity: analytic dimer, brute-force periodic sums,
analytic long-range tail (SURVEY.md §4 test strategy: analytic cases)."""
import jax.numpy as jnp
import numpy as np
import pytest

from mpmc_tpu.config import RunConfig, Thermo
from mpmc_tpu.ops import energy as energy_mod
from mpmc_tpu.ops import pairs as pairs_mod

from helpers import free_atoms


def lj(r, eps, sig):
    return 4 * eps * ((sig / r) ** 12 - (sig / r) ** 6)


def make_cfg(**kw):
    kw.setdefault("coulomb", "none")
    kw.setdefault("dtype", "float64")
    return RunConfig(**kw)


def thermo(n_species=1):
    return Thermo.make(temperature=100.0, n_species=n_species,
                       dtype=jnp.float64)


def test_lj_dimer_analytic():
    box = 100.0 * np.eye(3)
    r = 3.9
    params, state = free_atoms(box, [[0, 0, 0], [r, 0, 0]],
                               eps=36.7, sig=2.96)
    cfg = make_cfg(rd_lrc=False, cutoff=20.0)
    e, _ = energy_mod.total_energy(state.pos, state.box, state.mol_alive,
                                   params, cfg, thermo())
    assert float(e.rd) == pytest.approx(lj(r, 36.7, 2.96), rel=1e-12)
    assert float(e.total) == pytest.approx(lj(r, 36.7, 2.96), rel=1e-12)


def test_lj_brute_force_periodic():
    rng = np.random.default_rng(42)
    L = 18.0
    n = 40
    coords = rng.uniform(0, L, (n, 3))
    eps, sig = 120.0, 3.4
    box = L * np.eye(3)
    params, state = free_atoms(box, coords, eps=eps, sig=sig)
    rc = 7.5
    cfg = make_cfg(rd_lrc=False, cutoff=rc, pair_chunk=16)
    e, _ = energy_mod.total_energy(state.pos, state.box, state.mol_alive,
                                   params, cfg, thermo())
    # brute force with min image
    u = 0.0
    for i in range(n):
        for j in range(i + 1, n):
            d = coords[i] - coords[j]
            d -= L * np.round(d / L)
            r = np.linalg.norm(d)
            if r < rc:
                u += lj(r, eps, sig)
    assert float(e.rd) == pytest.approx(u, rel=1e-11)


def test_lj_lrc_analytic_homogeneous():
    # N identical atoms, every atom its own molecule:
    # U_tail = (8 pi N^2 / 3V) eps sig^3 [ (1/3)(sig/rc)^9 - (sig/rc)^3 ]
    rng = np.random.default_rng(1)
    L, n, eps, sig, rc = 20.0, 25, 90.0, 3.1, 8.0
    coords = rng.uniform(0, L, (n, 3))
    box = L * np.eye(3)
    params, state = free_atoms(box, coords, eps=eps, sig=sig)
    cfg = make_cfg(rd_lrc=True, cutoff=rc)
    e, _ = energy_mod.total_energy(state.pos, state.box, state.mol_alive,
                                   params, cfg, thermo())
    v = L ** 3
    expect = (8 * np.pi * n * n / (3 * v)) * eps * sig ** 3 * (
        (sig / rc) ** 9 / 3 - (sig / rc) ** 3)
    assert float(e.lrc) == pytest.approx(expect, rel=1e-12)


def test_pair_chunking_invariance():
    rng = np.random.default_rng(7)
    L = 15.0
    coords = rng.uniform(0, L, (23, 3))
    box = L * np.eye(3)
    params, state = free_atoms(box, coords)
    alive = state.atom_alive(params)
    outs = []
    for chunk in (4, 7, 23, 64):
        cfg = make_cfg(cutoff=6.0, pair_chunk=chunk)
        pt = pairs_mod.pair_pass(state.pos, state.box, alive, params, cfg,
                                 jnp.asarray(100.0))
        outs.append(float(pt.rd))
    np.testing.assert_allclose(outs, outs[0], rtol=1e-13)


def test_dead_molecules_do_not_contribute():
    box = 50.0 * np.eye(3)
    params, state = free_atoms(box, [[0, 0, 0], [4.0, 0, 0], [8.0, 0, 0]])
    cfg = make_cfg(rd_lrc=False, cutoff=20.0)
    # kill the middle molecule
    state2 = state.replace(mol_alive=state.mol_alive.at[1].set(False))
    e, _ = energy_mod.total_energy(state2.pos, state2.box, state2.mol_alive,
                                   params, cfg, thermo())
    expect = lj(8.0, 120.0, 3.4)
    assert float(e.rd) == pytest.approx(expect, rel=1e-12)


def test_feynman_hibbs_second_order_matches_numeric():
    from mpmc_tpu.ops import lj as lj_ops
    eps, sig, r, m, T = 34.2, 2.96, 3.3, 2.016, 77.0
    # numeric derivatives of LJ
    h = 1e-5
    f = lambda x: 4 * eps * ((sig / x) ** 12 - (sig / x) ** 6)
    v1 = (f(r + h) - f(r - h)) / (2 * h)
    v2 = (f(r + h) - 2 * f(r) + f(r - h)) / h ** 2
    mu_red = m * m / (m + m)
    from mpmc_tpu.constants import HBAR2_KB_AMU_A2
    expect = HBAR2_KB_AMU_A2 / (24 * T * mu_red) * (v2 + 2 * v1 / r)
    got = float(lj_ops.feynman_hibbs(jnp.asarray(r), eps, sig, mu_red, T, 2))
    assert got == pytest.approx(expect, rel=1e-5)


class TestFeynmanKleinert:
    """FK variational effective potential (SURVEY §2.9 "Quantum" [L];
    Feynman & Kleinert PRA 34, 5080 (1986))."""

    def test_harmonic_pair_is_exact(self):
        """For V = (1/2) k r^2 the FK smearing is exact and W - V is the
        full quantum-oscillator free-energy shift 3T ln[sinh x / x]."""
        from mpmc_tpu.constants import HBAR2_KB_AMU_A2
        from mpmc_tpu.ops import lj as lj_ops
        k, mu, T = 800.0, 1.0, 40.0            # K/A^2, amu, K
        for r in (0.5, 2.0, 5.0):
            rj = jnp.float64(r)
            got = float(lj_ops.feynman_kleinert_from_derivs(
                rj, k * rj, jnp.float64(k), jnp.float64(0.0),
                jnp.float64(0.0), mu, T))
            x = np.sqrt(HBAR2_KB_AMU_A2 * (k / mu)) / (2 * T)
            want = 3 * T * np.log(np.sinh(x) / x)
            assert got == pytest.approx(want, rel=1e-10), r

    def test_high_temperature_limit_is_fh2(self):
        """T -> inf: W - V -> hbar^2 beta / 24 mu * lap V (FH order 2)."""
        from mpmc_tpu.ops import lj as lj_ops
        eps, sig, mu = 34.2, 2.96, 1.008
        for r in (2.7, 2.9, 4.0):
            T = 5000.0
            fk = float(lj_ops.feynman_kleinert(jnp.float64(r), eps, sig,
                                               mu, T))
            fh = float(lj_ops.feynman_hibbs(jnp.float64(r), eps, sig, mu,
                                            T, 2))
            assert fk == pytest.approx(fh, rel=2e-2), r

    def test_stronger_than_fh_at_low_temperature(self):
        """At low T in the repulsive region the resummed FK correction
        stays finite and positive while remaining same-signed as FH."""
        from mpmc_tpu.ops import lj as lj_ops
        eps, sig, mu, T, r = 34.2, 2.96, 1.008, 10.0, 2.8
        fk = float(lj_ops.feynman_kleinert(jnp.float64(r), eps, sig, mu, T))
        assert np.isfinite(fk) and fk > 0.0

    def test_mc_bookkeeping_with_fk(self):
        from mpmc_tpu.config import Thermo
        from mpmc_tpu.mc import metropolis
        from mpmc_tpu.state import build_system
        from tests.helpers import atom_species
        rng = np.random.default_rng(11)
        L = 14.0
        # non-overlapping start (2x2x2 sublattice + jitter): a sub-A
        # overlap makes the FK wall ~1e7 K and the resulting f64
        # cancellation noise would swamp the 1e-9 bookkeeping check
        g = np.stack(np.meshgrid(*[np.arange(2)] * 3,
                                 indexing="ij"), -1).reshape(-1, 3)
        coords = g * (L / 2) + 2.0 + rng.uniform(-0.5, 0.5, (8, 3))
        sp = atom_species(name="H2", mass=2.016)
        params, state = build_system(
            L * np.eye(3), species=(sp,), capacity=(8,),
            initial_counts=(8,), initial_pos={0: coords[:, None, :]},
            dtype=jnp.float64)
        cfg = make_cfg(cutoff=6.0, rd_lrc=False, feynman_kleinert=True)
        thermo_ = Thermo.make(temperature=30.0, move_factor=0.4,
                              rot_factor=0.0, n_species=1, dtype=cfg.jdtype)
        st = metropolis.initialize(state, params, cfg, thermo_)
        st, _ = metropolis.run_chunk(st, params, cfg, thermo_, 120)
        st2 = metropolis.initialize(st, params, cfg, thermo_)
        assert float(st.energy.total) == pytest.approx(
            float(st2.energy.total), abs=1e-9)

    def test_input_script_option(self):
        from mpmc_tpu.io import input_script
        job = input_script.parse(
            "ensemble nvt\nbasis1 20 0 0\nbasis2 0 20 0\nbasis3 0 0 20\n"
            "feynman_kleinert on\n")
        assert job.cfg.feynman_kleinert


def test_mol_pair_pass_matches_full_difference():
    """Delta-energy contract: mol_pair_pass(mol) == (terms of full system)
    - (terms of system without mol)."""
    rng = np.random.default_rng(3)
    L = 16.0
    coords = rng.uniform(0, L, (12, 3))
    box = L * np.eye(3)
    params, state = free_atoms(box, coords)
    cfg = make_cfg(cutoff=6.5, rd_lrc=True)
    t = jnp.asarray(100.0)
    alive = state.atom_alive(params)
    mol = 5
    full = pairs_mod.pair_pass(state.pos, state.box, alive, params, cfg, t)
    alive_wo = alive & (params.mol_id != mol)
    without = pairs_mod.pair_pass(state.pos, state.box, alive_wo, params,
                                  cfg, t)
    molp = pairs_mod.mol_pair_pass(state.pos, state.box, alive, params, cfg,
                                   t, mol)
    assert float(molp.rd) == pytest.approx(float(full.rd - without.rd),
                                           rel=1e-11)
    # lrc: full counts unordered pairs once; mol pass counts mol's ordered
    # inter pairs once per direction/2? -> contract: coefficient diff equals
    # the one-sided sum.
    assert float(molp.lrc_coeff) == pytest.approx(
        float(full.lrc_coeff - without.lrc_coeff), rel=1e-11)


class TestGwpCoulomb:
    def test_gwp_vs_analytic_and_point_limit(self):
        import dataclasses
        import jax.numpy as jnp
        from scipy.special import erf as s_erf
        from mpmc_tpu.config import RunConfig, Thermo
        from mpmc_tpu.constants import KE
        from mpmc_tpu.ops import energy as energy_mod
        from mpmc_tpu.state import Species, build_system
        w = 0.4
        sp = Species(name="G", atom_names=("G",), pos=np.zeros((1, 3)),
                     mass=np.array([1.0]), charge=np.array([0.5]),
                     polar=np.zeros(1), eps=np.zeros(1), sig=np.zeros(1),
                     gwp_alpha=np.array([w]))
        cfg = RunConfig(ensemble="nvt", rd_potential="none", coulomb="gwp",
                        rd_lrc=False, dtype="float64")
        r = 3.0
        params, state = build_system(
            np.eye(3) * 30.0, species=(sp,), capacity=(2,),
            initial_counts=(2,),
            initial_pos={0: np.array([[[0., 0., 0.]], [[0., 0., r]]])},
            dtype=cfg.jdtype)
        thermo = Thermo.make(n_species=1, dtype=cfg.jdtype)
        e, _ = energy_mod.total_energy(state.pos, state.box,
                                       state.mol_alive, params, cfg,
                                       thermo)
        want = KE * 0.25 * s_erf(r / np.sqrt(2 * (w * w + w * w))) / r
        assert float(e.es_real) == pytest.approx(want, rel=1e-10)
        # zero width -> point-charge 1/r
        params0 = dataclasses.replace(
            params, gwp_alpha=jnp.zeros_like(params.gwp_alpha))
        e0, _ = energy_mod.total_energy(state.pos, state.box,
                                        state.mol_alive, params0, cfg,
                                        thermo)
        assert float(e0.es_real) == pytest.approx(KE * 0.25 / r, rel=1e-12)


def test_polarizability_tensor_two_site():
    """Two polarizable sites on the z axis: alpha_zz = 2a/(1-2a t),
    alpha_xx = 2a/(1+a t) with t = 2/r^3 resp. 1/r^3 (undamped)."""
    from mpmc_tpu.config import RunConfig
    from mpmc_tpu.ops import thole
    from mpmc_tpu.state import Species, build_system
    a, r = 1.0, 4.0
    sp = Species(name="P", atom_names=("P",), pos=np.zeros((1, 3)),
                 mass=np.array([1.0]), charge=np.zeros(1),
                 polar=np.array([a]), eps=np.zeros(1), sig=np.zeros(1))
    cfg = RunConfig(ensemble="nvt", rd_potential="none", coulomb="none",
                    rd_lrc=False, polarization=True, polar_solver="direct",
                    polar_damp_type="none", dtype="float64")
    params, state = build_system(
        np.eye(3) * 40.0, species=(sp,), capacity=(2,), initial_counts=(2,),
        initial_pos={0: np.array([[[0., 0., 0.]], [[0., 0., r]]])},
        dtype=cfg.jdtype)
    alpha = np.asarray(thole.polarizability_tensor(
        state.pos, state.box, state.atom_alive(params), params, cfg))
    tz, tx = 2.0 / r**3, 1.0 / r**3
    assert alpha[2, 2] == pytest.approx(2 * a / (1 - a * tz), rel=1e-9)
    assert alpha[0, 0] == pytest.approx(2 * a / (1 + a * tx), rel=1e-9)
    assert abs(alpha[0, 1]) < 1e-12


def test_disp_expansion_lrc_matches_direct_integral():
    """PHAHST tail: total energy with rd_lrc on must equal the cutoff sum
    plus the analytic C6/C8/C10 tail for a 2-atom system."""
    import dataclasses
    import jax.numpy as jnp
    from mpmc_tpu.config import RunConfig, Thermo
    from mpmc_tpu.models import systems
    from mpmc_tpu.ops import energy as energy_mod
    from mpmc_tpu.state import Species, build_system
    c6, c8, c10 = 900.0, 3000.0, 9000.0
    sp = Species(name="X", atom_names=("X",), pos=np.zeros((1, 3)),
                 mass=np.array([20.0]), charge=np.zeros(1),
                 polar=np.zeros(1), eps=np.array([1e5]),
                 sig=np.array([1.9]), c6=np.array([c6]),
                 c8=np.array([c8]), c10=np.array([c10]))
    L, rc = 30.0, 7.0
    cfg = RunConfig(ensemble="nvt", rd_potential="disp_expansion",
                    coulomb="none", rd_lrc=True, cutoff=rc,
                    dtype="float64")
    params, state = build_system(
        np.eye(3) * L, species=(sp,), capacity=(2,), initial_counts=(2,),
        initial_pos={0: np.array([[[5., 5., 5.]], [[9., 5., 5.]]])},
        dtype=cfg.jdtype)
    thermo = Thermo.make(temperature=100.0, n_species=1, dtype=cfg.jdtype)
    e, _ = energy_mod.total_energy(state.pos, state.box, state.mol_alive,
                                   params, cfg, thermo)
    # analytic: (1/2V)[2*T_pair + 2*T_self], T same for identical atoms
    t = -4 * np.pi * (c6 / (3 * rc**3) + c8 / (5 * rc**5)
                      + c10 / (7 * rc**7))
    want = (2 * t + 2 * t * 0.5 * 2) / (2 * L**3) * 2
    want = (1.0 / L**3) * 2 * t     # (1/2V)(2*T_12 + T_11 + T_22)
    assert float(e.lrc) == pytest.approx(want, rel=1e-12)
    # and GCMC bookkeeping stays consistent with the new tail
    from mpmc_tpu.mc import metropolis
    cfg2 = dataclasses.replace(cfg, ensemble="uvt", insert_species=(0,),
                               cutoff=rc)
    params2, state2 = build_system(
        np.eye(3) * L, species=(sp,), capacity=(12,), initial_counts=(2,),
        initial_pos={0: np.array([[[5., 5., 5.]], [[9., 5., 5.]]])},
        dtype=cfg2.jdtype)
    thermo2 = Thermo.make(temperature=150.0, fugacity=(80.0,),
                          insert_probability=0.5, n_species=1,
                          dtype=cfg2.jdtype)
    st = metropolis.initialize(state2, params2, cfg2, thermo2)
    st, stats = metropolis.run_chunk(st, params2, cfg2, thermo2, 400)
    st2 = metropolis.initialize(st, params2, cfg2, thermo2)
    assert float(st.energy.lrc) == pytest.approx(float(st2.energy.lrc),
                                                 rel=1e-10, abs=1e-12)
    assert int(np.asarray(stats.accepts)[1]) > 0


def test_fk_helpers_f32_accuracy():
    """_xcothx_m1/_ln_sinhc must stay accurate in f32 across the
    series/exp-form cutover: the first exp/log-only rewrite lost the
    x^2-scale signal to 1 - e^-2x cancellation for x in [1e-3, 5e-3]
    (sign flips, >100% error) — f32 runs evaluate FK per move, so
    this regression test pins the whole range."""
    import numpy as np

    from mpmc_tpu.ops import lj as lj_ops

    for x in (1e-4, 5e-4, 1e-3, 2e-3, 5e-3, 0.02, 0.09, 0.11,
              0.5, 2.0, 45.0):
        exact_m1 = x / np.tanh(x) - 1.0
        exact_ls = (np.log(np.sinh(min(x, 40.0)) / x) if x < 40
                    else x - np.log(2 * x))
        got_m1 = float(lj_ops._xcothx_m1(jnp.float32(x)))
        got_ls = float(lj_ops._ln_sinhc(jnp.float32(x)))
        assert got_m1 == pytest.approx(exact_m1, rel=5e-5), x
        assert got_ls == pytest.approx(exact_ls, rel=2e-4, abs=1e-10), x
