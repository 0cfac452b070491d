"""Coupled-dipole many-body vdW vs analytic two-oscillator physics."""
import dataclasses
import numpy as np
import pytest
import jax.numpy as jnp

from mpmc_tpu.config import RunConfig, Thermo
from mpmc_tpu.constants import HARTREE_K
from mpmc_tpu.mc import metropolis
from mpmc_tpu.models import systems
from mpmc_tpu.ops import vdw as vdw_mod
from mpmc_tpu.state import Species, build_system


def drude_pair(r, alpha=1.0, omega=0.5):
    """Analytic coupled-Drude dimer energy [K] (undamped, isotropic)."""
    a = alpha / r**3
    modes = (np.sqrt(1 + 2 * a) + np.sqrt(1 - 2 * a)
             + 2 * np.sqrt(1 + a) + 2 * np.sqrt(1 - a) - 6.0)
    return 0.5 * HARTREE_K * omega * modes


def _dimer(r, alpha=1.0, omega=0.5):
    sp = Species(
        name="DR", atom_names=("D",), pos=np.zeros((1, 3)),
        mass=np.array([1.0]), charge=np.zeros(1),
        polar=np.array([alpha]), eps=np.zeros(1), sig=np.zeros(1),
        omega=np.array([omega]))
    cfg = RunConfig(ensemble="nvt", rd_potential="none", coulomb="none",
                    cdvdw=True, polar_damp_type="none", dtype="float64",
                    rd_lrc=False)
    params, state = build_system(
        np.eye(3) * 60.0, species=(sp,), capacity=(2,),
        initial_counts=(2,),
        initial_pos={0: np.array([[[0., 0., 0.]], [[0., 0., r]]])},
        dtype=cfg.jdtype)
    return params, state, cfg


def test_two_oscillators_match_analytic():
    for r in (3.0, 4.0, 6.0, 10.0):
        params, state, cfg = _dimer(r)
        e = vdw_mod.vdw_energy(state.pos, state.box,
                               state.atom_alive(params), params, cfg)
        assert float(e) == pytest.approx(drude_pair(r), rel=1e-7), r


def test_london_limit():
    """Large-r limit: E -> -(3/4) hbar w alpha^2 / r^6 (London C6)."""
    r = 14.0
    params, state, cfg = _dimer(r)
    e = float(vdw_mod.vdw_energy(state.pos, state.box,
                                 state.atom_alive(params), params, cfg))
    london = -0.75 * HARTREE_K * 0.5 * 1.0**2 / r**6
    assert e == pytest.approx(london, rel=1e-3)


def test_dead_sites_cancel():
    params, state, cfg = _dimer(4.0)
    # kill molecule 1: energy must be exactly zero (single free oscillator)
    state = state.replace(mol_alive=state.mol_alive.at[1].set(False))
    e = float(vdw_mod.vdw_energy(state.pos, state.box,
                                 state.atom_alive(params), params, cfg))
    assert e == pytest.approx(0.0, abs=1e-10)


def _dimer_rep(r, repulsion, sig=3.0, eps=30.0, alpha=1.0, omega=0.5):
    sp = Species(
        name="DR", atom_names=("D",), pos=np.zeros((1, 3)),
        mass=np.array([1.0]), charge=np.zeros(1),
        polar=np.array([alpha]), eps=np.array([eps]),
        sig=np.array([sig]), omega=np.array([omega]))
    cfg = RunConfig(ensemble="nvt", rd_potential="lj", coulomb="none",
                    cdvdw=True, cdvdw_repulsion=repulsion,
                    polar_damp_type="none", dtype="float64",
                    rd_lrc=False)
    params, state = build_system(
        np.eye(3) * 60.0, species=(sp,), capacity=(2,),
        initial_counts=(2,),
        initial_pos={0: np.array([[[0., 0., 0.]], [[0., 0., r]]])},
        dtype=cfg.jdtype)
    return params, state, cfg


class TestCdvdwRepulsion:
    """cdvdw_sig/9th/exp repulsion variants (SURVEY §2 cdvdw family [M];
    documented contract in ops/potentials.cdvdw_repulsion_energy)."""

    def test_sig_repulsion_analytic(self):
        from mpmc_tpu.ops import pairs
        r, sig, alpha, omega = 3.5, 3.0, 1.2, 0.6
        params, state, cfg = _dimer_rep(r, "sig", sig=sig, alpha=alpha,
                                        omega=omega)
        pt = pairs.pair_pass(state.pos, state.box,
                             state.atom_alive(params), params, cfg, 300.0)
        c6 = 0.75 * HARTREE_K * omega * alpha ** 2
        assert float(pt.rd) == pytest.approx(c6 * sig**6 / r**12, rel=1e-10)

    def test_9th_matches_sig_at_contact(self):
        from mpmc_tpu.ops import pairs
        sig = 3.1
        for rep in ("sig", "9th"):
            params, state, cfg = _dimer_rep(sig, rep, sig=sig)
            pt = pairs.pair_pass(state.pos, state.box,
                                 state.atom_alive(params), params, cfg,
                                 300.0)
            if rep == "sig":
                ref = float(pt.rd)
            else:
                assert float(pt.rd) == pytest.approx(ref, rel=1e-10)

    def test_exp_is_born_mayer(self):
        from mpmc_tpu.ops import pairs
        r, a_k, b_inv_a = 3.5, 40000.0, 3.0
        params, state, cfg = _dimer_rep(r, "exp", sig=b_inv_a, eps=a_k)
        pt = pairs.pair_pass(state.pos, state.box,
                             state.atom_alive(params), params, cfg, 300.0)
        assert float(pt.rd) == pytest.approx(a_k * np.exp(-b_inv_a * r),
                                             rel=1e-10)

    def test_mc_bookkeeping_with_sig_repulsion(self):
        params, state, cfg = _dimer_rep(5.0, "sig")
        thermo = Thermo.make(temperature=50.0, move_factor=0.3,
                             rot_factor=0.0, n_species=1, dtype=cfg.jdtype)
        state = metropolis.initialize(state, params, cfg, thermo)
        st, stats = metropolis.run_chunk(state, params, cfg, thermo, 150)
        st2 = metropolis.initialize(st, params, cfg, thermo)
        assert float(st.energy.total) == pytest.approx(
            float(st2.energy.total), abs=1e-9)

    def test_lrc_tail_matches_numeric_integral(self):
        import scipy.integrate as si
        from mpmc_tpu.ops import potentials
        sig, alpha, omega, rc = 3.0, 1.0, 0.5, 9.0
        c6 = 0.75 * HARTREE_K * omega * alpha ** 2
        for rep, f in (("sig", lambda r: c6 * sig**6 / r**12),
                       ("9th", lambda r: c6 * sig**3 / r**9)):
            cfg = RunConfig(cdvdw_repulsion=rep)
            got = float(potentials.cdvdw_repulsion_tail_coefficient(
                jnp.float64(sig), jnp.float64(sig), jnp.float64(alpha),
                jnp.float64(alpha), jnp.float64(omega), jnp.float64(omega),
                jnp.float64(rc), cfg))
            want = 4 * np.pi * si.quad(
                lambda r: f(r) * r * r, rc, np.inf)[0]
            assert got == pytest.approx(want, rel=1e-8), rep

    def test_input_script_option(self):
        from mpmc_tpu.io import input_script
        job = input_script.parse(
            "ensemble nvt\nbasis1 20 0 0\nbasis2 0 20 0\nbasis3 0 0 20\n"
            "cdvdw on\ncdvdw_sig_repulsion on\n")
        assert job.cfg.cdvdw and job.cfg.cdvdw_repulsion == "sig"


def test_mc_with_cdvdw_accumulates_consistently():
    params, state, cfg = _dimer(5.0)
    thermo = Thermo.make(temperature=50.0, move_factor=0.3, rot_factor=0.0,
                         n_species=1, dtype=cfg.jdtype)
    state = metropolis.initialize(state, params, cfg, thermo)
    assert float(state.energy.vdw) != 0.0
    st, stats = metropolis.run_chunk(state, params, cfg, thermo, 200)
    st2 = metropolis.initialize(st, params, cfg, thermo)
    assert float(st.energy.total) == pytest.approx(
        float(st2.energy.total), abs=1e-9)
    assert int(np.asarray(stats.accepts)[0]) > 0
