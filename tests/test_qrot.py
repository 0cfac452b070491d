"""Quantum rotation: free-rotor analytics and hindered-rotor physics."""
import numpy as np
import pytest

from mpmc_tpu.config import RunConfig, Thermo
from mpmc_tpu.constants import HBAR2_KB_AMU_A2
from mpmc_tpu.models import systems
from mpmc_tpu.ops import qrot
from mpmc_tpu.state import build_system


def h2_system(box_len=30.0, with_frozen=False):
    sp = systems.h2_bss3()
    fpos = fp = None
    coulomb = "none"
    if with_frozen:
        # a charged site: the H2 charge sites (off-COM) make V(Omega)
        # anisotropic
        fpos = np.array([[5.0, 5.0, 5.0]])
        fp = {"charge": np.array([0.8]), "mass": np.array([40.0]),
              "eps": np.array([60.0]), "sig": np.array([3.2]),
              "polar": np.array([0.0])}
        coulomb = "cutoff"
    cfg = RunConfig(ensemble="nvt", rd_potential="lj", coulomb=coulomb,
                    rd_lrc=False, dtype="float64")
    params, state = build_system(
        np.eye(3) * box_len, frozen_pos=fpos, frozen_params=fp,
        species=(sp,), capacity=(1,), initial_counts=(1,),
        initial_pos={0: (sp.pos + np.full(3, box_len / 2))[None]},
        dtype=cfg.jdtype)
    return sp, params, state, cfg


def test_rotational_constant_h2():
    sp = systems.h2_bss3()
    b = qrot.rotational_constant(sp)
    inertia = 2 * 1.008 * 0.371 ** 2
    assert b == pytest.approx(HBAR2_KB_AMU_A2 / (2 * inertia), rel=1e-12)
    assert 80.0 < b < 95.0     # physical H2 ballpark


def test_free_rotor_spectrum():
    """Isolated H2: eigenvalues B l(l+1) with degeneracy 2l+1."""
    sp, params, state, cfg = h2_system()
    evals, l_of = qrot.rotational_levels(
        state.pos, state.box, state.atom_alive(params), params, cfg,
        300.0, mol=0, species=sp, lmax=3)
    b = qrot.rotational_constant(sp)
    want = np.concatenate([[b * l * (l + 1)] * (2 * l + 1)
                           for l in range(4)])
    np.testing.assert_allclose(np.sort(evals), np.sort(want),
                               rtol=1e-8, atol=1e-8)
    for l in range(4):
        assert np.sum(l_of == l) == 2 * l + 1


def test_hindered_rotor_splits_levels():
    sp, params, state, cfg = h2_system(box_len=30.0, with_frozen=True)
    # move H2 near the frozen LJ site to hinder rotation
    state = state.replace(pos=state.pos.at[1:4].add(
        np.array([6.6, 5.0, 5.0]) - np.asarray(state.pos)[1]))
    evals, l_of = qrot.rotational_levels(
        state.pos, state.box, state.atom_alive(params), params, cfg,
        300.0, mol=1, species=sp, lmax=3)
    # anisotropic environment splits the (formerly 3-fold) first excited
    # manifold and shifts levels off the free-rotor B l(l+1) ladder
    b = qrot.rotational_constant(sp)
    e = np.sort(evals) - np.sort(evals)[0]
    first_manifold = e[1:4]
    assert first_manifold.max() - first_manifold.min() > 1e-2
    free = np.sort(np.concatenate(
        [[b * l * (l + 1)] * (2 * l + 1) for l in range(4)]))
    assert np.max(np.abs(e - free)) > 1.0


def test_symmetry_free_energies_and_spinflip():
    sp, params, state, cfg = h2_system()
    evals, l_of = qrot.rotational_levels(
        state.pos, state.box, state.atom_alive(params), params, cfg,
        40.0, mol=0, species=sp, lmax=3)
    f_para, f_ortho = qrot.symmetry_free_energies(evals, l_of, 40.0)
    b = qrot.rotational_constant(sp)
    # low T: F_para ~ 0 (l=0), F_ortho ~ 2B - T ln 9 (l=1, 9 ortho states
    # counting m and the threefold nuclear degeneracy is NOT included —
    # spatial only: 3 states)
    assert f_para == pytest.approx(0.0, abs=1e-2)
    assert f_ortho == pytest.approx(2 * b - 40.0 * np.log(3.0), rel=1e-3)

    thermo = Thermo.make(temperature=40.0, n_species=1, dtype=cfg.jdtype)
    rng = np.random.default_rng(0)
    spins = np.array([1])   # start ortho
    flips = 0
    for _ in range(20):
        spins, nf, e_rot = qrot.spinflip_sweep(
            state.pos, state.box, state.atom_alive(params), params, cfg,
            thermo, [sp], [0], spins, rng, lmax=3)
        flips += nf
    # ortho -> para is strongly downhill at 40 K: should have flipped and
    # stayed para
    assert spins[0] == 0 and flips >= 1


def test_quantum_rotation_cli_run(tmp_path):
    import io
    from mpmc_tpu.io import input_script
    from mpmc_tpu.mc import run as run_mod
    d = 0.371
    pqr = tmp_path / "h2.pqr"
    pqr.write_text(
        "ATOM 1 H2G H2 1 M 10.0 10.0 10.0 0.0 -0.93634 0.0 34.2 2.96\n"
        f"ATOM 2 H2E H2 1 M 10.0 10.0 {10 + d} 1.008 0.46817 0.0 0.0 0.0\n"
        f"ATOM 3 H2E H2 1 M 10.0 10.0 {10 - d} 1.008 0.46817 0.0 0.0 0.0\n"
        "END\n")
    job = input_script.parse(f"""
ensemble nvt
numsteps 2000
corrtime 250
temperature 40
basis1 20 0 0
basis2 0 20 0
basis3 0 0 20
coulomb off
rd_lrc off
precision float64
quantum_rotation on
quantum_rotation_level_max 3
spinflip_probability 0.3
pqr_input {pqr}
""")
    log = io.StringIO()
    _, avgs = run_mod.run(job, log=log)
    assert "ortho_fraction" in avgs.samples
    assert "energy_qrot" in avgs.samples
    # at 40 K para is strongly favoured (dF ~ 2B - T ln3 ~ +130 K):
    # the per-step spinflip move must relax toward para
    assert np.mean(avgs.samples["ortho_fraction"][2:]) < 0.4
    assert avgs.mean("acc_spinflip") >= 0.0


class TestQuantumVibration:
    """Stretch eigenspectra (SURVEY §2.9 quantum_vibration [L];
    documented contract in ops/qvib.py)."""

    def test_free_molecule_harmonic_ladder(self):
        import dataclasses
        from mpmc_tpu.ops import qvib
        sp, params, state, cfg = h2_system()
        sp = dataclasses.replace(sp, vib_omega=4401.21)
        levels, hw = qvib.vibrational_levels(
            state.pos, state.box, state.atom_alive(params), params, cfg,
            300.0, mol=0, species=sp)
        assert hw == pytest.approx(4401.21 * qvib.CM1_K, rel=1e-12)
        # isolated molecule: bare oscillator ladder E_n = hw (n + 1/2)
        for n in range(3):
            assert levels[n] == pytest.approx(hw * (n + 0.5), rel=2e-3), n
        assert levels[1] - levels[0] == pytest.approx(hw, rel=2e-3)

    def test_geometry_three_site_h2(self):
        from mpmc_tpu.ops import qvib
        sp = systems.h2_bss3()
        s, b0, mu = qvib.stretch_geometry(sp)
        assert b0 == pytest.approx(0.742, rel=1e-12)
        assert mu == pytest.approx(1.008 / 2, rel=1e-12)

    def test_confinement_blueshifts_fundamental(self):
        """A repulsive LJ site beyond each end of the bond stiffens the
        stretch: (E1-E0) > hbar w."""
        import dataclasses
        from mpmc_tpu.ops import qvib
        sp, params, state, cfg = h2_system(box_len=30.0)
        sp = dataclasses.replace(sp, vib_omega=4401.21)
        # free reference
        free, hw = qvib.vibrational_levels(
            state.pos, state.box, state.atom_alive(params), params, cfg,
            300.0, mol=0, species=sp)
        # walls: frozen LJ atoms on the molecular axis (z), close enough
        # that the repulsive wall rises over the stretch grid
        fpos = np.array([[15.0, 15.0, 17.4], [15.0, 15.0, 12.6]])
        fp = {"charge": np.zeros(2), "mass": np.full(2, 40.0),
              "eps": np.full(2, 60.0), "sig": np.full(2, 3.2),
              "polar": np.zeros(2)}
        params2, state2 = build_system(
            np.eye(3) * 30.0, frozen_pos=fpos, frozen_params=fp,
            species=(sp,), capacity=(1,), initial_counts=(1,),
            initial_pos={0: (sp.pos + np.full(3, 15.0))[None]},
            dtype=cfg.jdtype)
        conf, _ = qvib.vibrational_levels(
            state2.pos, state2.box, state2.atom_alive(params2), params2,
            cfg, 300.0, mol=0, species=sp)
        assert np.all(np.isfinite(conf))
        assert (conf[1] - conf[0]) > (free[1] - free[0])

    def test_cli_reports_qvib_observables(self, tmp_path):
        import io
        from mpmc_tpu.io import input_script
        from mpmc_tpu.mc import run as run_mod
        d = 0.371
        pqr = tmp_path / "h2.pqr"
        pqr.write_text(
            "ATOM 1 H2G H2 1 M 10.0 10.0 10.0 0.0 0.0 0.0 34.2 2.96\n"
            f"ATOM 2 H2E H2 1 M 10.0 10.0 {10 + d} 1.008 0.0 0.0 0.0 0.0\n"
            f"ATOM 3 H2E H2 1 M 10.0 10.0 {10 - d} 1.008 0.0 0.0 0.0 0.0\n"
            "END\n")
        job = input_script.parse(f"""
ensemble nvt
numsteps 400
corrtime 200
temperature 40
basis1 20 0 0
basis2 0 20 0
basis3 0 0 20
coulomb off
rd_lrc off
precision float64
quantum_vibration on
vib_omega 4401.21
pqr_input {pqr}
""")
        log = io.StringIO()
        _, avgs = run_mod.run(job, log=log)
        assert "qvib_zpe" in avgs.samples
        assert "qvib_fundamental_shift" in avgs.samples
        from mpmc_tpu.ops import qvib
        hw = 4401.21 * qvib.CM1_K
        assert avgs.mean("qvib_zpe") == pytest.approx(hw / 2, rel=5e-3)
        assert abs(avgs.mean("qvib_fundamental_shift")) < 0.05 * hw


def test_spinflip_excluded_under_nve():
    """Spinflip's rotor free-energy change lives only in ln_bias, which
    Ray's NVE rule discards — the move must be excluded there instead of
    silently accepting every flip (ADVICE r1)."""
    import warnings

    from mpmc_tpu.config import RunConfig
    from mpmc_tpu.mc import metropolis

    cfg = RunConfig(ensemble="nve", quantum_rotation=True)
    assert not metropolis.spinflip_active(cfg)
    with pytest.warns(UserWarning, match="nve"):
        _, ids = metropolis.make_branch_picker(cfg)
    assert ids.shape[0] == 1 and int(ids[0]) == metropolis.DISPLACE
    # every other ensemble keeps the move
    for ens in ("nvt", "uvt", "npt"):
        cfg = RunConfig(ensemble=ens, quantum_rotation=True)
        assert metropolis.spinflip_active(cfg)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            _, ids = metropolis.make_branch_picker(cfg)
        assert int(ids[-1]) == metropolis.SPINFLIP


def test_spinflip_staleness_quantified():
    """VERDICT r1 item 9: spinflip accepts against rot_f cached at the
    last corrtime refresh while molecules move every step — the same
    per-corrtime semantics as the reference (SURVEY §2 "Quantum
    rotation").  This pins the bias magnitude: after 200 displaces on a
    deliberately hot/dense system, the stale-vs-fresh flip acceptance
    probability error is nonzero (staleness is real) but bounded; users
    control it via corrtime.  Deterministic (fixed seed)."""
    import dataclasses

    import jax.numpy as jnp

    from mpmc_tpu.mc import metropolis
    from mpmc_tpu.models import systems
    from mpmc_tpu.ops import qrot

    params, state, cfg, thermo = systems.mof_h2_gcmc(
        n_side=3, n_h2=6, capacity=8, dtype="float64")
    cfg = dataclasses.replace(cfg, ensemble="nvt", quantum_rotation=True)
    state = metropolis.initialize(state, params, cfg, thermo)
    sp = (systems.h2_bss3(),)
    t0 = qrot.free_energy_table(state.pos, state.box,
                                state.atom_alive(params),
                                state.mol_alive, params, cfg, thermo, sp)
    M = int(params.n_mols_max)
    state = state.replace(spin=jnp.zeros((M,), jnp.int32),
                          rot_f=jnp.asarray(t0))
    st, stats = metropolis.run_chunk(state, params, cfg, thermo, 200)
    assert int(np.asarray(stats.accepts)[0]) > 0
    t1 = qrot.free_energy_table(st.pos, st.box, st.atom_alive(params),
                                st.mol_alive, params, cfg, thermo, sp)
    mv = (~np.asarray(params.mol_frozen) & np.asarray(st.mol_alive)
          & (np.asarray(params.mol_natoms) >= 2))
    d_stale = (t0[:, 1] - t0[:, 0])[mv]
    d_fresh = (t1[:, 1] - t1[:, 0])[mv]
    T = float(thermo.temperature)
    p_stale = np.minimum(1.0, np.exp(-d_stale / T))
    p_fresh = np.minimum(1.0, np.exp(-d_fresh / T))
    bias = float(np.max(np.abs(p_stale - p_fresh)))
    # measured 2026-08-17: ~0.13 on this system after 200 un-refreshed
    # steps.  If this regresses past 0.3 the caching contract changed;
    # if it hits ~0 the test lost its teeth (system no longer hindered).
    assert 0.005 < bias < 0.3, bias


# ---------------------------------------------------------------------------
# Batched drivers: chains N and parallel tempering with spinflips
# ---------------------------------------------------------------------------

def test_table_from_eigs_swap_rebuild_identity():
    """The PT swap-time rebuild (cached eigensolves -> F tables at a NEW
    temperature) must equal a from-scratch free_energy_table at that
    temperature whenever the potential surface is T-independent (no
    FH/FK) — the identity run_mc_pt relies on after every ladder
    swap."""
    import types
    sp, params, state, cfg = h2_system(box_len=30.0, with_frozen=True)
    th1 = types.SimpleNamespace(temperature=77.0)
    th2 = types.SimpleNamespace(temperature=150.0)
    eigs = qrot.eigen_tables(
        state.pos, state.box, state.atom_alive(params), state.mol_alive,
        params, cfg, th1, [sp], lmax=3)
    rebuilt = qrot.table_from_eigs(eigs, params.n_mols_max, 150.0)
    fresh = qrot.free_energy_table(
        state.pos, state.box, state.atom_alive(params), state.mol_alive,
        params, cfg, th2, [sp], lmax=3)
    np.testing.assert_allclose(rebuilt, fresh, rtol=1e-12, atol=1e-12)
    # and the table really is T-dependent (the rebuild is not a no-op)
    t1 = qrot.table_from_eigs(eigs, params.n_mols_max, 77.0)
    assert np.max(np.abs(t1 - rebuilt)) > 1e-3


def test_free_energies_from_levels_matches_host():
    """The on-device F(T) rebuild (level_arrays +
    free_energies_from_levels, the on-device per-swap rebuild) must match
    the host table_from_eigs at every temperature — same Boltzmann
    sums, array form."""
    import types

    import jax

    sp, params, state, cfg = h2_system(box_len=30.0, with_frozen=True)
    th = types.SimpleNamespace(temperature=77.0)
    eigs = qrot.eigen_tables(
        state.pos, state.box, state.atom_alive(params), state.mol_alive,
        params, cfg, th, [sp], lmax=3)
    lv, pr, va = qrot.level_arrays(eigs, params.n_mols_max, 3)
    fn = jax.jit(qrot.free_energies_from_levels)
    for t in (40.0, 77.0, 150.0):
        host = qrot.table_from_eigs(eigs, params.n_mols_max, t)
        dev = np.asarray(fn(lv, pr, va, t))
        np.testing.assert_allclose(dev, host, rtol=1e-12, atol=1e-12)
    # non-rotor (empty) rows map to the same zeros
    lv0, pr0, va0 = qrot.level_arrays({}, 3, 2)
    np.testing.assert_array_equal(np.asarray(fn(lv0, pr0, va0, 50.0)),
                                  np.zeros((3, 2)))


def _h2_deck(tmp_path, extra, numsteps=1500, temperature=40):
    d = 0.371
    pqr = tmp_path / "h2.pqr"
    pqr.write_text(
        "ATOM 1 H2G H2 1 M 10.0 10.0 10.0 0.0 -0.93634 0.0 34.2 2.96\n"
        f"ATOM 2 H2E H2 1 M 10.0 10.0 {10 + d} 1.008 0.46817 0.0 0.0 0.0\n"
        f"ATOM 3 H2E H2 1 M 10.0 10.0 {10 - d} 1.008 0.46817 0.0 0.0 0.0\n"
        "END\n")
    from mpmc_tpu.io import input_script
    return input_script.parse(f"""
ensemble nvt
numsteps {numsteps}
corrtime 250
temperature {temperature}
basis1 20 0 0
basis2 0 20 0
basis3 0 0 20
coulomb off
rd_lrc off
precision float64
quantum_rotation on
quantum_rotation_level_max 3
spinflip_probability 0.3
pqr_input {pqr}
""" + extra)


def test_quantum_rotation_chains_cli(tmp_path):
    """chains N + quantum_rotation: per-chain spin/rot_f state on the
    batched scan path — cross-chain mean ortho fraction relaxes toward
    para at 40 K, same physics as the single-chain CLI test."""
    import io
    from mpmc_tpu.mc import run as run_mod
    job = _h2_deck(tmp_path, "chains 3\n")
    log = io.StringIO()
    _, avgs = run_mod.run(job, log=log)
    assert "ortho_fraction" in avgs.samples
    assert "energy_qrot" in avgs.samples
    assert np.mean(avgs.samples["ortho_fraction"][2:]) < 0.4
    assert avgs.mean("acc_spinflip") >= 0.0


def test_quantum_rotation_parallel_tempering_cli(tmp_path):
    """Parallel tempering + quantum_rotation spinflips (scan path):
    per-replica rot_f tables follow the ladder — rebuilt from cached
    eigensolves at every temperature swap, eigensolves refreshed per
    corrtime.  The reported (base-T) replica must relax toward para."""
    import io
    from mpmc_tpu.mc import run as run_mod
    job = _h2_deck(tmp_path,
                   "parallel_tempering on\nn_replicas 3\n"
                   "max_temperature 120\nptemp_freq 125\n",
                   numsteps=1500)
    log = io.StringIO()
    avgs = run_mod.run(job, log=log)
    assert "ortho_fraction" in avgs.samples
    assert "swap_acceptance" in avgs.samples
    assert np.mean(avgs.samples["ortho_fraction"][2:]) < 0.45


def test_spinflip_staleness_guard_warns_at_parse():
    """r2 verdict item 7: the documented staleness contract is
    self-enforcing — corrtime beyond the measured-bias bound with
    spinflips on warns at parse time, citing the quantifying test."""
    import warnings

    import pytest

    from mpmc_tpu.io.input_script import parse, SPINFLIP_CORRTIME_BOUND

    base = """
ensemble nvt
temperature 77
numsteps 1000
corrtime {corr}
quantum_rotation on
spinflip_probability 0.1
basis1 20 0 0
basis2 0 20 0
basis3 0 0 20
pqr_input x.pqr
"""
    with pytest.warns(UserWarning, match="stale"):
        parse(base.format(corr=SPINFLIP_CORRTIME_BOUND + 1))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        parse(base.format(corr=SPINFLIP_CORRTIME_BOUND))
