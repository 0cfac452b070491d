"""Replica-parallel / parallel-tempering tests on the 8-device virtual
CPU mesh (SURVEY.md §5 "Distributed comm backend" rebuild)."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from mpmc_tpu.mc import metropolis
from mpmc_tpu.models import systems
from mpmc_tpu.ops import pairs as pairs_mod
from mpmc_tpu.parallel import multichain, replica


@pytest.fixture(scope="module")
def mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return replica.default_mesh(8)


def test_geometric_ladder():
    t = replica.geometric_ladder(100.0, 800.0, 4)
    assert np.allclose(t, [100.0, 200.0, 400.0, 800.0])
    assert replica.geometric_ladder(50.0, 500.0, 1) == [50.0]


def test_pt_round_runs_and_preserves_ladder(mesh8):
    params, state, cfg, thermo = systems.mof_h2_gcmc(
        n_side=3, n_h2=4, capacity=8, ewald_kmax=3, dtype="float64")
    temps = replica.geometric_ladder(77.0, 400.0, 8)
    states, thermos, hist = replica.run_parallel_tempering(
        params, state, cfg, thermo, temps, n_rounds=3, steps_per_round=5,
        mesh=mesh8)
    # the T multiset is invariant under swaps (temperature exchange only)
    final_t = np.sort(np.asarray(thermos.temperature))
    assert np.allclose(final_t, np.sort(temps), rtol=1e-12)
    assert all(np.isfinite(h["mean_energy"]) for h in hist)
    # every chain advanced steps_per_round * n_rounds steps
    assert np.all(np.asarray(states.step) == 15)


def test_pt_swap_decision_is_symmetric(mesh8):
    """Partners must agree: after a swap round the temperature ladder is a
    permutation pairing only (p,p+1) neighbors."""
    params, state, cfg, thermo = systems.lj_fluid(n=8, dtype="float64")
    temps = np.array([10.0, 20.0, 40.0, 80.0, 160.0, 320.0, 640.0, 1280.0])
    runner = replica.PTRunner(params, cfg, mesh8, steps_per_round=1)
    st = metropolis.initialize(state, params, cfg, thermo)
    states = replica.stack_states(st, 8)
    thermos = replica.stack_thermo(thermo, temps, cfg.jdtype)
    key = jax.random.PRNGKey(3)
    _, new_thermos, _, acc, _, _, accf = runner.round(states, thermos,
                                                      key, parity=0)
    new_t = np.asarray(new_thermos.temperature)
    acc = np.asarray(acc)
    for lo in range(0, 8, 2):
        if acc[lo]:
            assert acc[lo + 1]
            assert new_t[lo] == temps[lo + 1] and new_t[lo + 1] == temps[lo]
        else:
            assert new_t[lo] == temps[lo] and new_t[lo + 1] == temps[lo + 1]


def test_replica_chains_decorrelated(mesh8):
    params, state, cfg, thermo = systems.lj_fluid(n=16, dtype="float64")
    st = metropolis.initialize(state, params, cfg, thermo)
    states = replica.stack_states(st, 8)
    keys = np.asarray(jax.random.key_data(states.key)) \
        if hasattr(jax.random, "key_data") else np.asarray(states.key)
    assert len(np.unique(keys, axis=0)) == 8


def test_multichain_matches_physics():
    """Batched chains advance independently and keep delta-accumulated
    energies consistent with a full recompute."""
    from mpmc_tpu.parallel import multichain
    params, state, cfg, thermo = systems.mof_h2_gcmc(
        n_side=3, n_h2=4, capacity=8, ewald_kmax=3, dtype="float64")
    state = metropolis.initialize(state, params, cfg, thermo)
    states = multichain.stack_states(state, 4)
    states = multichain.initialize_batched(states, params, cfg, thermo)
    st, stats = multichain.run_chunk_batched(states, params, cfg, thermo,
                                             200)
    assert np.all(np.asarray(st.step) == 200)
    # chains diverged (independent targets/coins)
    assert len({float(e) for e in np.asarray(st.energy.total)}) > 1
    # per-chain accumulated == recomputed (f64)
    st2 = multichain.initialize_batched(st, params, cfg, thermo)
    np.testing.assert_allclose(np.asarray(st.energy.total),
                               np.asarray(st2.energy.total),
                               rtol=1e-9, atol=1e-7)
    # shared move-type schedule: per-chain attempt vectors are identical
    att = np.asarray(stats.attempts)
    assert np.all(att == att[0])


def test_parallel_tempering_cli_path(tmp_path):
    """PT through the input-script surface (single-device batched path)."""
    import io
    from mpmc_tpu.io import input_script
    from mpmc_tpu.mc import run as run_mod
    pqr = tmp_path / "ar.pqr"
    pqr.write_text(
        "ATOM 1 Ar AR 1 M 0.0 0.0 0.0 39.948 0.0 0.0 119.8 3.405\n"
        "ATOM 2 Ar AR 2 M 3.9 0.0 0.0 39.948 0.0 0.0 119.8 3.405\n"
        "END\n")
    job = input_script.parse(f"""
ensemble nvt
numsteps 400
corrtime 100
temperature 100
basis1 15 0 0
basis2 0 15 0
basis3 0 0 15
precision float64
parallel_tempering on
max_temperature 800
n_replicas 4
ptemp_freq 25
pqr_input {pqr}
""")
    log = io.StringIO()
    jsonl = tmp_path / "obs.jsonl"
    avgs = run_mod.run(job, log=log, jsonl_path=str(jsonl))
    text = log.getvalue()
    assert "parallel tempering: 4 replicas" in text
    assert "swap acceptance:" in text
    assert avgs.mean("energy_total") != 0.0
    assert 0.0 <= avgs.mean("swap_acceptance") <= 1.0
    # the JSONL stream carries one full-ladder record per block — the
    # MBAR reweighting input (analyze.pt_mbar)
    from mpmc_tpu import analyze
    temps, us, ns, _ = analyze._read_ladder(str(jsonl))
    assert temps.shape == (4, 4) and us.shape == (4, 4)
    assert np.allclose(np.sort(temps, axis=1), np.sort(temps[0]))
    res = analyze.pt_mbar(str(jsonl), n_t=5)
    assert res["ladder_t"].size == 4 and res["converged"]
    assert np.all(np.isfinite(res["u_mean"]))


def test_parallel_tempering_uvt_cli_path(tmp_path):
    """µVT PT through the scan path: exercises the grand-canonical
    (beta_j/beta_i)^dN host_swap factor end-to-end (run_mc_pt computes
    per-replica molecule counts for the ladder decision)."""
    import io
    from mpmc_tpu.io import input_script
    from mpmc_tpu.mc import run as run_mod
    pqr = tmp_path / "ar.pqr"
    pqr.write_text(
        "ATOM 1 Ar AR 1 M 0.0 0.0 0.0 39.948 0.0 0.0 119.8 3.405\n"
        "END\n")
    job = input_script.parse(f"""
ensemble uvt
numsteps 200
corrtime 50
temperature 100
pressure 1.0
h2_fugacity off
insert_probability 0.4
basis1 15 0 0
basis2 0 15 0
basis3 0 0 15
precision float64
parallel_tempering on
max_temperature 400
n_replicas 4
ptemp_freq 25
pqr_input {pqr}
""")
    log = io.StringIO()
    avgs = run_mod.run(job, log=log)
    text = log.getvalue()
    assert "parallel tempering: 4 replicas" in text
    assert 0.0 <= avgs.mean("swap_acceptance") <= 1.0
    assert avgs.mean("N") >= 0.0


def test_chains_option_cli(tmp_path):
    import io
    from mpmc_tpu.io import input_script
    from mpmc_tpu.mc import run as run_mod
    pqr = tmp_path / "ar.pqr"
    pqr.write_text(
        "ATOM 1 Ar AR 1 M 3.0 3.0 3.0 39.948 0.0 0.0 119.8 3.405\n"
        "ATOM 2 Ar AR 2 M 9.0 9.0 9.0 39.948 0.0 0.0 119.8 3.405\nEND\n")
    job = input_script.parse(f"""
ensemble uvt
numsteps 300
corrtime 100
temperature 150
pressure 40
basis1 12 0 0
basis2 0 12 0
basis3 0 0 12
insert_probability 0.5
chains 6
precision float64
pqr_input {pqr}
""")
    log = io.StringIO()
    su, avgs = run_mod.run(job, log=log)
    assert "batched chains: 6" in log.getvalue()
    assert "aggregate" in log.getvalue()
    assert avgs.mean("N") > 0
    assert "N_sem_chains" in avgs.samples


class TestSpatialSharding:
    def test_pair_pass_sharded_matches_single(self, mesh8):
        from mpmc_tpu.parallel import spatial
        params, state, cfg, thermo = systems.mof_h2_gcmc(
            n_side=4, n_h2=8, capacity=16, dtype="float64")
        alive = state.atom_alive(params)
        mesh = spatial.default_mesh(8)
        mesh = jax.sharding.Mesh(np.asarray(mesh.devices), (spatial.AXIS,))
        t1 = pairs_mod.pair_pass(state.pos, state.box, alive, params, cfg,
                                 thermo.temperature)
        t2 = spatial.pair_pass_sharded(state.pos, state.box, alive, params,
                                       cfg, thermo.temperature, mesh)
        for f in ("rd", "es_real", "es_excl", "lrc_coeff", "min_r2"):
            assert float(getattr(t1, f)) == pytest.approx(
                float(getattr(t2, f)), rel=1e-10), f

    def test_recip_sharded_matches_single(self, mesh8):
        from mpmc_tpu.ops import ewald
        from mpmc_tpu.parallel import spatial
        params, state, cfg, thermo = systems.mof_h2_gcmc(
            n_side=4, n_h2=8, capacity=16, dtype="float64")
        alive = state.atom_alive(params)
        mesh = jax.sharding.Mesh(
            np.asarray(jax.devices()[:8]), (spatial.AXIS,))
        rc = pairs_mod.derived_cutoff(state.box, cfg)
        alpha = pairs_mod.derived_alpha(rc, cfg)
        e1, _ = ewald.recip_energy(state.pos, params.charge, alive,
                                   state.box, alpha, cfg.ewald_kmax)
        e2 = spatial.recip_energy_sharded(state.pos, params.charge, alive,
                                          state.box, alpha, cfg.ewald_kmax,
                                          mesh)
        assert float(e1) == pytest.approx(float(e2), rel=1e-12)

    def test_solve_scf_sharded_matches_single(self, mesh8):
        """Row-sharded Thole PCG == single-device solve_scf: same fixed
        point, same iteration count (the recurrence is replicated; only
        the matvec summation order differs)."""
        from mpmc_tpu.ops import thole
        from mpmc_tpu.parallel import spatial
        params, state, cfg, thermo = systems.mof_h2_gcmc(
            n_side=4, n_h2=8, capacity=16, dtype="float64",
            polarization=True)
        alive = state.atom_alive(params)
        mesh = jax.sharding.Mesh(
            np.asarray(jax.devices()[:8]), (spatial.AXIS,))
        e0 = thole.static_field(state.pos, state.box, alive, params, cfg)
        mu1, it1, _ = thole.solve_scf(state.pos, state.box, alive,
                                      params, cfg, e0)
        mu2, it2 = spatial.solve_scf_sharded(state.pos, state.box, alive,
                                             params, cfg, e0, mesh)
        assert int(it1) == int(it2)
        np.testing.assert_allclose(np.asarray(mu1), np.asarray(mu2),
                                   rtol=1e-9, atol=1e-12)
        e_1 = thole.polar_energy(mu1, e0)
        e_2 = thole.polar_energy(mu2, e0)
        assert float(e_1) == pytest.approx(float(e_2), rel=1e-10)

    @pytest.mark.parametrize("polar", [False, True])
    def test_total_energy_sharded_matches_single(self, mesh8, polar):
        """Multi-chip `ensemble te`: every term of the sharded
        full-system energy matches ops/energy.total_energy."""
        from mpmc_tpu.ops import energy as energy_mod
        from mpmc_tpu.parallel import spatial
        params, state, cfg, thermo = systems.mof_h2_gcmc(
            n_side=4, n_h2=8, capacity=16, dtype="float64",
            polarization=polar)
        mesh = jax.sharding.Mesh(
            np.asarray(jax.devices()[:8]), (spatial.AXIS,))
        e1, _ = energy_mod.total_energy(
            state.pos, state.box, state.mol_alive, params, cfg, thermo)
        e2, _ = spatial.total_energy_sharded(
            state.pos, state.box, state.mol_alive, params, cfg, thermo,
            mesh)
        for f in ("rd", "lrc", "es_real", "es_recip", "es_self",
                  "es_excl", "polar", "vdw", "total"):
            v1, v2 = float(getattr(e1, f)), float(getattr(e2, f))
            assert v1 == pytest.approx(v2, rel=1e-9, abs=1e-10), f

    def test_te_cli_spatial_devices(self, tmp_path, mesh8):
        """`ensemble te` + `spatial_devices 8` runs the sharded path and
        reports the same per-term energies as the single-device run."""
        import io
        from mpmc_tpu.io import input_script
        from mpmc_tpu.mc import run as run_mod
        pqr = tmp_path / "ar2.pqr"
        pqr.write_text(   # neutral dipole molecule + LJ atom
            "ATOM 1 A D 1 M 0.0 0.0 0.0 20.0 0.3 0.0 119.8 3.405\n"
            "ATOM 2 B D 1 M 1.1 0.0 0.0 20.0 -0.3 0.0 119.8 3.405\n"
            "ATOM 3 Ar AR 2 M 3.9 0.0 0.0 39.948 0.0 0.0 119.8 3.405\n"
            "END\n")
        base = f"""
ensemble te
temperature 150
basis1 15 0 0
basis2 0 15 0
basis3 0 0 15
precision float64
pqr_input {pqr}
"""
        e1 = run_mod.run(input_script.parse(base), log=io.StringIO())
        log = io.StringIO()
        e2 = run_mod.run(input_script.parse(
            base + "spatial_devices 8\n"), log=log)
        assert "spatial sharding: 8 devices" in log.getvalue()
        assert float(e1.total) == pytest.approx(float(e2.total),
                                                rel=1e-10)


def test_chains_npt_cli(tmp_path):
    """Batched chains with NPT volume moves (full-pass candidate under
    vmap) stay correct: <V> tracks the ideal-gas (N+1)kT/P."""
    import io
    from mpmc_tpu.constants import ATM2K_A3
    from mpmc_tpu.io import input_script
    from mpmc_tpu.mc import run as run_mod
    pqr = tmp_path / "id.pqr"
    pqr.write_text("\n".join(
        f"ATOM {i+1} He HE {i+1} M {2+3*i} 5.0 5.0 4.0 0.0 0.0 0.0 0.0"
        for i in range(3)) + "\nEND\n")
    t, p_atm = 200.0, 60.0
    job = input_script.parse(f"""
ensemble npt
numsteps 4000
corrtime 500
temperature {t}
pressure {p_atm}
volume_probability 0.3
volume_change_factor 0.3
basis1 10 0 0
basis2 0 10 0
basis3 0 0 10
rd_lrc off
chains 6
pair_chunk 32
precision float64
pqr_input {pqr}
""")
    su, avgs = run_mod.run(job, log=io.StringIO())
    expect = 4 * t / (p_atm * ATM2K_A3)     # (N+1)kT/P ideal gas
    got = np.mean(avgs.samples["volume"][2:])
    assert got == pytest.approx(expect, rel=0.25)


def test_chains_annealing_and_adapt(tmp_path):
    import io
    from mpmc_tpu.io import input_script
    from mpmc_tpu.mc import run as run_mod
    pqr = tmp_path / "ar.pqr"
    pqr.write_text(
        "ATOM 1 Ar AR 1 M 3.0 3.0 3.0 39.948 0.0 0.0 119.8 3.405\nEND\n")
    job = input_script.parse(f"""
ensemble nvt
numsteps 400
corrtime 100
temperature 300
simulated_annealing on
simulated_annealing_schedule 0.5
adapt_moves on
move_factor 4.9
chains 4
basis1 10 0 0
basis2 0 10 0
basis3 0 0 10
precision float64
pqr_input {pqr}
""")
    su, avgs = run_mod.run(job, log=io.StringIO())
    assert float(su.thermo.temperature) == pytest.approx(300 * 0.5 ** 4)
    assert float(su.thermo.move_factor) != pytest.approx(4.9)
    assert "acc_displace" in avgs.samples


def test_multihost_entry_single_process(mesh8):
    """The multi-host PT entry point (parallel/multihost.py) on its
    single-process degenerate path: global mesh over the 8 virtual
    devices, distributed replica arrays, PTRunner rounds."""
    from mpmc_tpu.parallel import multihost
    import io
    params, state, cfg, thermo = systems.mof_h2_gcmc(
        n_side=3, n_h2=4, capacity=8, ewald_kmax=3, corrtime=4)
    temps = replica.geometric_ladder(77.0, 200.0, 8)
    log = io.StringIO()
    states, thermos, history = multihost.run_parallel_tempering(
        params, state, cfg, thermo, temps, n_rounds=3,
        steps_per_round=4, log=log)
    assert len(history) == 3
    assert np.isfinite(history[-1]["mean_energy"])
    # the temperature multiset is conserved by swaps
    final_t = np.sort(np.asarray(thermos.temperature))
    np.testing.assert_allclose(final_t, np.sort(temps), rtol=1e-6)
    assert "PT round 0" in log.getvalue()
    # replica arrays actually live sharded over the mesh
    assert len(states.pos.sharding.device_set) == 8


def test_multihost_replica_count_guard():
    from mpmc_tpu.parallel import multihost
    with pytest.raises(ValueError):
        multihost.global_replica_mesh(10 ** 6)


def test_batched_chains_with_polar_delta_field():
    """Vmapped chains with polarization: the per-move delta static
    field must stay exact per chain (vs full rebuild) and energies
    must close against a recompute."""
    import dataclasses
    import jax.numpy as jnp
    from mpmc_tpu.ops import thole
    from mpmc_tpu.parallel import multichain
    params, state, cfg, thermo = systems.mof_h2_gcmc(
        n_side=3, n_h2=4, capacity=8, polarization=True)
    cfg = dataclasses.replace(cfg, dtype="float64")
    to64 = lambda x: (x.astype(jnp.float64)
                      if hasattr(x, "dtype") and x.dtype == jnp.float32
                      else x)
    state = jax.tree_util.tree_map(to64, state)
    params = jax.tree_util.tree_map(to64, params)
    state = metropolis.initialize(state, params, cfg, thermo)
    states = multichain.stack_states(state, 3)
    sts, stats = multichain.run_chunk_batched(states, params, cfg,
                                              thermo, 60)
    assert int(np.asarray(stats.accepts).sum()) > 0
    for c in range(3):
        st = jax.tree_util.tree_map(lambda x: x[c], sts)
        e0_full = thole.static_field(st.pos, st.box,
                                     st.atom_alive(params), params, cfg)
        assert float(jnp.max(jnp.abs(st.e0 - e0_full))) < 1e-12, c
        st2 = metropolis.initialize(st, params, cfg, thermo)
        assert float(st.energy.total) == pytest.approx(
            float(st2.energy.total), abs=1e-9), c


def test_ladder_swap_matches_rule():
    """On-device ladder_swap implements the host_swap/PTRunner rule:
    equal-T pairs always exchange (ln_p = 0 > log u), parity selects the
    pair offsets, and the temperature multiset is preserved."""
    key = jax.random.PRNGKey(0)
    t4 = (jnp.float64(100.0),) * 4
    e4 = tuple(jnp.float64(v) for v in (-5.0, -4.0, -3.0, -2.0))
    new_t, n_acc = replica.ladder_swap(t4, e4, key, 0)
    assert int(n_acc) == 2          # pairs (0,1), (2,3) both accept
    new_t, n_acc = replica.ladder_swap(t4, e4, key, 1)
    assert int(n_acc) == 1          # only (1,2) at odd parity
    # distinct ladder: multiset invariant whatever is accepted
    t = tuple(jnp.float64(v) for v in (77.0, 120.0, 200.0, 350.0))
    new_t, _ = replica.ladder_swap(t, e4, key, 0)
    assert sorted(float(x) for x in new_t) == pytest.approx(
        [77.0, 120.0, 200.0, 350.0])
    # R=2 odd parity: no pairs, no swaps
    new_t, n_acc = replica.ladder_swap(t[:2], e4[:2], key, 1)
    assert int(n_acc) == 0
    assert [float(x) for x in new_t] == [77.0, 120.0]


def test_uvt_ladder_swap_grand_canonical_factor():
    """µVT PT swaps must carry (beta_j/beta_i)^(N_i-N_j): at equal
    energies the Boltzmann term is 0 and the sign of
    (N_i - N_j) ln(T_i/T_j) alone decides — deterministically, since
    log(u) < 0 always.  Checked across host_swap, ladder_swap, and
    ladder_swap_batched (the three swap implementations)."""
    key = jax.random.PRNGKey(5)
    temps = (jnp.float64(100.0), jnp.float64(200.0))
    e = (jnp.float64(-3.0), jnp.float64(-3.0))

    # N_lo < N_hi: ln_p = (0-50) ln(100/200) = +34.7 -> always accept
    new_t, n_acc = replica.ladder_swap(
        temps, e, key, 0, n_mols=(jnp.int32(0), jnp.int32(50)))
    assert int(n_acc) == 1 and float(new_t[0]) == 200.0
    # N_lo > N_hi: ln_p = -34.7 -> always reject
    new_t, n_acc = replica.ladder_swap(
        temps, e, key, 0, n_mols=(jnp.int32(50), jnp.int32(0)))
    assert int(n_acc) == 0 and float(new_t[0]) == 100.0
    # without n_mols (NVT ladder): ln_p = 0 -> always accept
    new_t, n_acc = replica.ladder_swap(temps, e, key, 0)
    assert int(n_acc) == 1

    # batched array interface agrees
    new_t, n_acc = replica.ladder_swap_batched(
        jnp.asarray([100.0, 200.0]), jnp.asarray([-3.0, -3.0]), key, 0,
        n_mols=jnp.asarray([50, 0]))
    assert int(n_acc) == 0

    # host_swap agrees (numpy path used by the scan-path PT driver)
    rng = np.random.default_rng(0)
    t, acc = replica.host_swap(np.array([100.0, 200.0]),
                               np.array([-3.0, -3.0]), 0, rng,
                               n_mols=np.array([0, 50]))
    assert acc == 1 and t[0] == 200.0
    rng = np.random.default_rng(0)
    t, acc = replica.host_swap(np.array([100.0, 200.0]),
                               np.array([-3.0, -3.0]), 0, rng,
                               n_mols=np.array([50, 0]))
    assert acc == 0 and t[0] == 100.0


def test_mesh_pt_rejects_spinflip():
    """The fully on-device mesh PT rounds cannot host-refresh the
    T-dependent rot_f tables — run_parallel_tempering must refuse with
    a clear error (the host-swap CLI driver run_mc_pt DOES support
    spinflip ladders; tests/test_qrot.py exercises it end to end)."""
    import dataclasses

    params, state, cfg, thermo = systems.mof_h2_gcmc(
        n_side=3, n_h2=4, capacity=8, ewald_kmax=3, dtype="float32")
    c = dataclasses.replace(cfg, ensemble="nvt", coulomb="wolf",
                            quantum_rotation=True)
    with pytest.raises(ValueError, match="spinflip"):
        replica.run_parallel_tempering(params, state, c, thermo,
                                       [100.0] * 2, n_rounds=1,
                                       steps_per_round=4)


def test_observables_batched_matches_per_chain(tmp_path):
    """run.observables_batched (one jitted call + one fetch for the
    chain batch) must agree key-for-key with the per-chain
    observables() slices — including polar (mu present) and per-species
    loadings."""
    from mpmc_tpu.io import input_script
    from mpmc_tpu.mc import run as run_mod
    from mpmc_tpu.parallel import multichain

    p = tmp_path / "m.pqr"
    p.write_text(
        "ATOM 1 F1 MOF 1 F 1.0 1.0 1.0 20.0 0.25 0.4 60.0 3.0\n"
        "ATOM 2 F2 MOF 1 F 5.0 5.0 5.0 20.0 -0.25 0.4 60.0 3.0\n"
        "ATOM 3 He HE 2 M 2.5 2.5 2.5 4.0 0.0 0.2 10.0 2.6\n"
        "ATOM 4 Xe XE 3 M 7.5 7.5 7.5 131.0 0.0 0.3 200.0 4.0\n"
        "END\n")
    job = input_script.parse(f"""
ensemble uvt
numsteps 100
corrtime 10
temperature 120
pressure 2.0
basis1 10 0 0
basis2 0 10 0
basis3 0 0 10
cutoff 4.5
coulomb cutoff
polarization on
polar_max_iter 12
insert_probability 0.4
max_molecules 6
pqr_input {p}
""")
    su = run_mod.setup(job)
    state = metropolis.initialize(su.state, su.params, su.cfg, su.thermo)
    C = 3
    states = multichain.stack_states(state, C, seed=11)
    states, _ = multichain.run_chunk_batched(states, su.params, su.cfg,
                                             su.thermo, 8)
    states = multichain.initialize_batched(states, su.params, su.cfg,
                                           su.thermo)
    fast = run_mod.observables_batched(su, states, C)
    for c in range(C):
        st = jax.tree_util.tree_map(lambda x: x[c], states)
        ref = run_mod.observables(su, st)
        assert set(ref) <= set(fast[c]), (set(ref) - set(fast[c]))
        for k, v in ref.items():
            assert fast[c][k] == pytest.approx(v, rel=1e-12,
                                               abs=1e-12), (c, k)
    # chains diverged (the comparison is not vacuous)
    assert fast[0]["energy_total"] != fast[1]["energy_total"]


class TestChainSharding:
    """chain_devices N: the dp axis — C chains split C/D per device
    over a 1-D mesh (parallel/multichain *_sharded).  Chains are
    independent and the shared move-type schedule depends only on
    (seed, step), so sharding must be BIT-exact vs the single-device
    batch on every path."""

    def test_scan_path_bit_exact(self):
        params, state, cfg, thermo = systems.mof_h2_gcmc(
            n_side=3, n_h2=8, capacity=16, ewald_kmax=3,
            dtype="float64")
        state = metropolis.initialize(state, params, cfg, thermo)
        states = multichain.stack_states(state, 8, seed=3)
        a, sa = multichain.run_chunk_batched(states, params, cfg,
                                             thermo, 40)
        mesh = multichain.chain_mesh(4)
        sh = multichain.shard_chains(states, mesh)
        b, sb = multichain.run_chunk_batched_sharded(
            sh, params, cfg, thermo, 40, mesh)
        np.testing.assert_array_equal(np.asarray(a.pos),
                                      np.asarray(b.pos))
        np.testing.assert_array_equal(np.asarray(a.energy.total),
                                      np.asarray(b.energy.total))
        np.testing.assert_array_equal(np.asarray(sa.accepts),
                                      np.asarray(sb.accepts))
        a2 = multichain.initialize_batched(a, params, cfg, thermo)
        b2 = multichain.initialize_batched_sharded(b, params, cfg,
                                                   thermo, mesh)
        np.testing.assert_array_equal(np.asarray(a2.energy.total),
                                      np.asarray(b2.energy.total))

    def test_chain_devices_cli_matches_unsharded(self, tmp_path):
        """chains 6 / chain_devices 3 through the CLI: identical
        averages to the single-device run (bit-exact trajectories)."""
        import io
        from mpmc_tpu.io import input_script
        from mpmc_tpu.mc import run as run_mod
        pqr = tmp_path / "ar.pqr"
        pqr.write_text(
            "ATOM 1 Ar AR 1 M 3.0 3.0 3.0 39.948 0.0 0.0 119.8 3.405\n"
            "ATOM 2 Ar AR 2 M 9.0 9.0 9.0 39.948 0.0 0.0 119.8 3.405\n"
            "END\n")
        deck = f"""
ensemble uvt
numsteps 300
corrtime 100
temperature 150
pressure 40
basis1 12 0 0
basis2 0 12 0
basis3 0 0 12
insert_probability 0.5
chains 6
precision float64
pqr_input {pqr}
"""
        log1, log2 = io.StringIO(), io.StringIO()
        _, avgs1 = run_mod.run(input_script.parse(deck), log=log1)
        _, avgs2 = run_mod.run(
            input_script.parse(deck + "chain_devices 3\n"), log=log2)
        assert "chain sharding: 3 devices x 2 chains" in log2.getvalue()
        for k in ("N", "energy_total", "acc_displace", "acc_insert"):
            np.testing.assert_array_equal(avgs1.samples[k],
                                          avgs2.samples[k]), k

    def test_pt_chain_devices_cli_matches_unsharded(self, tmp_path):
        """parallel_tempering + chain_devices 2: the PT ladder sharded
        R/D per device (thermos sharded alongside, thermo_batched
        in_specs) must reproduce the single-device ladder exactly."""
        import io
        from mpmc_tpu.io import input_script
        from mpmc_tpu.mc import run as run_mod
        pqr = tmp_path / "ar.pqr"
        pqr.write_text(
            "ATOM 1 Ar AR 1 M 3.0 3.0 3.0 39.948 0.0 0.0 119.8 3.405\n"
            "ATOM 2 Ar AR 2 M 9.0 9.0 9.0 39.948 0.0 0.0 119.8 3.405\n"
            "ATOM 3 Ar AR 3 M 3.0 9.0 3.0 39.948 0.0 0.0 119.8 3.405\n"
            "END\n")
        deck = f"""
ensemble nvt
numsteps 200
corrtime 100
ptemp_freq 50
temperature 100
parallel_tempering on
n_replicas 4
max_temperature 300
basis1 12 0 0
basis2 0 12 0
basis3 0 0 12
precision float64
pqr_input {pqr}
"""
        log1, log2 = io.StringIO(), io.StringIO()
        avgs1 = run_mod.run(input_script.parse(deck), log=log1)
        avgs2 = run_mod.run(
            input_script.parse(deck + "chain_devices 2\n"), log=log2)
        assert "chain sharding: 2 devices x 2 replicas" in log2.getvalue()
        for k in ("energy_total", "swap_acceptance"):
            np.testing.assert_array_equal(avgs1.samples[k],
                                          avgs2.samples[k]), k

    def test_pt_uvt_chain_devices_matches_unsharded(self, tmp_path):
        """µVT PT + chain_devices: the grand-canonical ladder swap reads
        per-replica molecule counts off the SHARDED alive mask
        — sharded == unsharded."""
        import io
        from mpmc_tpu.io import input_script
        from mpmc_tpu.mc import run as run_mod
        pqr = tmp_path / "ar.pqr"
        pqr.write_text(
            "ATOM 1 Ar AR 1 M 3.0 3.0 3.0 39.948 0.0 0.0 119.8 3.405\n"
            "ATOM 2 Ar AR 2 M 9.0 9.0 9.0 39.948 0.0 0.0 119.8 3.405\n"
            "END\n")
        deck = f"""
ensemble uvt
numsteps 200
corrtime 100
ptemp_freq 50
temperature 150
pressure 40
insert_probability 0.5
parallel_tempering on
n_replicas 4
max_temperature 450
basis1 12 0 0
basis2 0 12 0
basis3 0 0 12
precision float64
pqr_input {pqr}
"""
        log1, log2 = io.StringIO(), io.StringIO()
        avgs1 = run_mod.run(input_script.parse(deck), log=log1)
        avgs2 = run_mod.run(
            input_script.parse(deck + "chain_devices 2\n"), log=log2)
        assert "chain sharding: 2 devices x 2 replicas" in log2.getvalue()
        for k in ("N", "energy_total", "swap_acceptance"):
            np.testing.assert_array_equal(avgs1.samples[k],
                                          avgs2.samples[k]), k

    def test_indivisible_chains_raise(self):
        params, state, cfg, thermo = systems.lj_fluid(n=16,
                                                      dtype="float64")
        state = metropolis.initialize(state, params, cfg, thermo)
        states = multichain.stack_states(state, 6)
        mesh = multichain.chain_mesh(4)
        with pytest.raises(ValueError, match="divisible"):
            multichain.shard_chains(states, mesh)


def test_host_swap_fugacity_rule():
    """ln P = (N_i - N_j) ln(F_j / F_i): equal loadings swap freely,
    and rows are exchanged whole (the ladder multiset is conserved)."""
    rng = np.random.default_rng(5)
    rows = np.array([[1.0, 0.5], [2.0, 1.0], [4.0, 2.0], [8.0, 4.0]])
    # equal N -> ln_p = 0 -> every attempted pair swaps (log u < 0 a.s.)
    out, acc = replica.host_swap_fugacity(rows, [3, 3, 3, 3], 0, rng)
    assert acc == 2
    np.testing.assert_allclose(out[0], rows[1])
    np.testing.assert_allclose(out[1], rows[0])
    np.testing.assert_allclose(out[2], rows[3])
    # multiset conserved over many randomized rounds
    cur = rows.copy()
    n = rng.integers(0, 20, size=4)
    for p in (0, 1, 0, 1, 0):
        cur, _ = replica.host_swap_fugacity(cur, n, p, rng)
    np.testing.assert_allclose(np.sort(cur.sum(axis=1)),
                               np.sort(rows.sum(axis=1)))


def test_ladder_swap_fugacity_batched_rule():
    """On-device fugacity swap: equal per-species counts give ln_p = 0
    (every attempted pair swaps), rows are exchanged whole, the ladder
    multiset is conserved, and the general per-species rule matches a
    hand-computed ln P for one known pair."""
    import jax
    import jax.numpy as jnp
    rows = jnp.asarray([[1.0, 0.5], [2.0, 1.0], [4.0, 2.0],
                        [8.0, 4.0]], jnp.float64)
    sp = (0, 1)
    eq = jnp.full((4, 2), 3.0, jnp.float64)
    key = jax.random.PRNGKey(3)
    out, acc = replica.ladder_swap_fugacity_batched(rows, eq, key, 0, sp)
    assert int(acc) == 2
    np.testing.assert_allclose(np.asarray(out)[0], np.asarray(rows)[1])
    np.testing.assert_allclose(np.asarray(out)[1], np.asarray(rows)[0])
    np.testing.assert_allclose(np.asarray(out)[2], np.asarray(rows)[3])
    # multiset conserved over randomized rounds with unequal counts
    cur = rows
    counts = jnp.asarray(np.random.default_rng(9).integers(
        0, 12, size=(4, 2)), jnp.float64)
    for i, p in enumerate((0, 1, 0, 1, 0)):
        cur, _ = replica.ladder_swap_fugacity_batched(
            cur, counts, jax.random.PRNGKey(50 + i), p, sp)
    np.testing.assert_allclose(
        np.sort(np.asarray(cur).sum(axis=1)),
        np.sort(np.asarray(rows).sum(axis=1)))
    # a strongly downhill pair must swap: N high where f low
    steep = jnp.asarray([[1e-6, 1e-6], [10.0, 10.0]], jnp.float64)
    n2 = jnp.asarray([[40.0, 40.0], [0.0, 0.0]], jnp.float64)
    out2, acc2 = replica.ladder_swap_fugacity_batched(
        steep, n2, jax.random.PRNGKey(0), 0, sp)
    assert int(acc2) == 1
    np.testing.assert_allclose(np.asarray(out2)[0], np.asarray(steep)[1])


def test_pt_fugacity_ladder_ideal_gas(tmp_path):
    """Fugacity-ladder PT through the input-script surface: ideal-gas
    rungs must each hold their own <N> = f V / kT line (swaps preserve
    every rung's grand-canonical distribution), and one run's pt_fug
    ladder records reweight into a continuous linear isotherm
    (analyze.pt_gcmc_mbar)."""
    import io
    from mpmc_tpu import analyze
    from mpmc_tpu.constants import ATM2K_A3
    from mpmc_tpu.io import input_script
    from mpmc_tpu.mc import run as run_mod
    pqr = tmp_path / "he.pqr"
    pqr.write_text(
        "ATOM 1 He HE 1 M 5.0 5.0 5.0 4.0026 0.0 0.0 0.0 0.0\nEND\n")
    job = input_script.parse(f"""
ensemble uvt
numsteps 6000
corrtime 300
temperature 100
pressure 2.0
max_pressure 16.0
pt_fugacity on
n_replicas 4
ptemp_freq 75
basis1 20 0 0
basis2 0 20 0
basis3 0 0 20
cutoff 8.0
coulomb off
rd_lrc off
insert_probability 0.6
max_molecules 96
precision float64
pqr_input {pqr}
""")
    log = io.StringIO()
    jsonl = tmp_path / "obs.jsonl"
    avgs = run_mod.run(job, log=log, jsonl_path=str(jsonl))
    text = log.getvalue()
    assert "fugacity-ladder PT: 4 replicas" in text
    assert "swap acceptance:" in text
    assert 0.0 < avgs.mean("swap_acceptance") <= 1.0
    temps, us, ns, fugs = analyze._read_ladder(str(jsonl))
    assert fugs is not None and fugs.shape == ns.shape
    # the ladder multiset is conserved under swaps
    np.testing.assert_allclose(
        np.sort(fugs, axis=1),
        np.broadcast_to(np.sort(fugs[0]), fugs.shape))
    v, T = 20.0 ** 3, 100.0
    # per-rung sampled means vs the ideal line (correlated-noise
    # tolerance — see test_campaign's note on shared-schedule chains)
    skip = 1
    for fv in np.sort(fugs[0]):
        sel = np.abs(fugs[skip:] - fv) < 1e-9
        mean_n = ns[skip:][sel].mean()
        expect = fv * ATM2K_A3 * v / T
        assert mean_n == pytest.approx(expect, rel=0.35), fv
    res = analyze.pt_gcmc_mbar(str(jsonl), n_f=6, skip=0.2)
    assert res["converged"] and res["temperature"] == T
    expect = res["f_grid"] * ATM2K_A3 * v / T
    np.testing.assert_allclose(res["n_mean"], expect, rtol=0.35)
    assert np.all(np.diff(res["n_mean"]) > 0)
    # a temperature-ladder reweight must refuse this stream
    with pytest.raises(ValueError, match="pt_gcmc_mbar"):
        analyze.pt_mbar(str(jsonl))


def test_chains_histogram_reduced_over_all_chains(tmp_path):
    """r2 verdict item 4: `pop_histogram` + `chains C` bins EVERY
    chain's movable COMs (the reference's MPI_Reduce of per-rank
    histograms to rank 0), and `parallel_restarts` adds per-chain
    trajectory streams next to the per-chain restarts."""
    import io
    import os

    from mpmc_tpu.io import input_script
    from mpmc_tpu.mc import run as run_mod
    from mpmc_tpu.mc.run import _hist_accumulate
    from mpmc_tpu.parallel import multichain
    from mpmc_tpu.utils.histogram import PopulationHistogram

    # unit-level: a stacked C-chain state bins C x n_alive COMs
    params, state, cfg, thermo = systems.mof_h2_gcmc(
        n_side=3, n_h2=5, capacity=8, dtype="float64")
    states = multichain.stack_states(state, 3)
    hist = PopulationHistogram(np.asarray(state.box), 2.0)
    _hist_accumulate(hist, states, params, 3)
    assert hist.counts.sum() == 3 * 5
    assert hist.n_frames == 3

    # CLI-level: chains + pop_histogram writes one reduced .dx; with
    # parallel_restarts the trajectory gets per-chain -rK streams
    pqr = tmp_path / "ar.pqr"
    pqr.write_text(
        "ATOM 1 Ar AR 1 M 3.0 3.0 3.0 39.948 0.0 0.0 119.8 3.405\n"
        "ATOM 2 Ar AR 2 M 9.0 9.0 9.0 39.948 0.0 0.0 119.8 3.405\nEND\n")
    dx = tmp_path / "pop.dx"
    traj = tmp_path / "traj.pqr"
    rst = tmp_path / "restart.pqr"
    job = input_script.parse(f"""
ensemble nvt
numsteps 200
corrtime 100
temperature 150
basis1 12 0 0
basis2 0 12 0
basis3 0 0 12
chains 3
precision float64
pop_histogram on
histogram_output {dx}
traj_output {traj}
pqr_restart {rst}
parallel_restarts on
pqr_input {pqr}
""")
    log = io.StringIO()
    run_mod.run(job, log=log)
    assert "3 chains reduced" in log.getvalue()
    txt = dx.read_text()
    assert "gridpositions" in txt or os.path.getsize(dx) > 0
    # NVT, 2 movables, 3 chains, 2 blocks: normalized total = mean
    # population per frame = 2 (frames = chains x blocks — a chain-0-
    # only binning with the same frame count would read 2/3)
    vals = []
    in_data = False
    for line in txt.splitlines():
        if line.startswith("object 3"):
            in_data = True
            continue
        if in_data:
            if line.startswith(("attribute", "object")):
                break
            vals.extend(float(v) for v in line.split())
    assert sum(vals) == pytest.approx(2.0, abs=1e-4)   # dx %.6g text
    for k in (1, 2):
        assert os.path.exists(f"{traj}-r{k}")
        assert os.path.exists(f"{rst}-r{k}")


class TestSpatialMCStep:
    """r2 verdict item 3: the MC step itself sharded over the mesh
    (state replicated, pair passes split, psum-reduced scalars)."""

    def test_chunk_matches_unsharded(self, mesh8):
        from mpmc_tpu.parallel import spatial

        params, state, cfg, thermo = systems.mof_h2_gcmc(
            n_side=4, n_h2=8, capacity=16, dtype="float64")
        assert spatial.mc_supported(cfg)
        state = metropolis.initialize(state, params, cfg, thermo)
        st_u, stats_u = metropolis.run_chunk(state, params, cfg, thermo,
                                             150)
        st_s, stats_s = spatial.run_chunk_spatial(state, params, cfg,
                                                  thermo, 150, mesh8)
        # identical RNG + psum-reduced scalars: same trajectory (f64
        # reassociation only)
        np.testing.assert_array_equal(np.asarray(st_u.mol_alive),
                                      np.asarray(st_s.mol_alive))
        np.testing.assert_allclose(np.asarray(st_s.pos),
                                   np.asarray(st_u.pos), atol=1e-9)
        np.testing.assert_array_equal(np.asarray(stats_u.attempts),
                                      np.asarray(stats_s.attempts))
        np.testing.assert_array_equal(np.asarray(stats_u.accepts),
                                      np.asarray(stats_s.accepts))
        assert float(st_s.energy.total) == pytest.approx(
            float(st_u.energy.total), rel=1e-10, abs=1e-8)

    def test_bookkeeping_and_sharded_refresh(self, mesh8):
        from mpmc_tpu.parallel import spatial

        params, state, cfg, thermo = systems.mof_h2_gcmc(
            n_side=4, n_h2=8, capacity=16, dtype="float64")
        state = metropolis.initialize(state, params, cfg, thermo)
        st, stats = spatial.run_chunk_spatial(state, params, cfg,
                                              thermo, 200, mesh8)
        assert np.asarray(stats.accepts).sum() > 0
        fr = metropolis.frozen_refresh_rows(params, cfg)
        fresh = spatial.initialize_spatial(st, params, cfg, thermo,
                                           mesh8, frozen_rows=fr)
        for term in ("rd", "es_real", "es_recip", "es_self", "es_excl",
                     "lrc"):
            assert float(getattr(st.energy, term)) == pytest.approx(
                float(getattr(fresh.energy, term)), rel=1e-9,
                abs=1e-9), term

    def test_gate(self):
        from mpmc_tpu.parallel import spatial
        import dataclasses as _dc

        params, state, cfg, thermo = systems.mof_h2_gcmc(
            n_side=3, n_h2=4, capacity=6, dtype="float64")
        assert spatial.mc_supported(cfg)
        # polarization IS carried (r3) on the direct damped field only
        assert spatial.mc_supported(_dc.replace(cfg, polarization=True))
        assert not spatial.mc_supported(
            _dc.replace(cfg, polarization=True, polar_ewald=True))
        assert not spatial.mc_supported(_dc.replace(cfg, cell_list=True))


def test_spatial_mc_step_polar_matches_unsharded(mesh8):
    """r3: the spatially-sharded MC step carries POLARIZATION on the
    direct damped field — static_field/dipole_matvec row blocks
    round-robin across the mesh (thole._rowblock_scan) — and must
    reproduce the unsharded trajectory (identical accepts, f64 psum
    reassociation only)."""
    from mpmc_tpu.parallel import spatial

    params, state, cfg, thermo = systems.mof_h2_gcmc(
        n_side=3, n_h2=5, capacity=8, polarization=True,
        dtype="float64")
    assert spatial.mc_supported(cfg)
    state = metropolis.initialize(state, params, cfg, thermo)
    st_u, stats_u = metropolis.run_chunk(state, params, cfg, thermo, 60)
    st_s, stats_s = spatial.run_chunk_spatial(state, params, cfg,
                                              thermo, 60, mesh8)
    np.testing.assert_array_equal(np.asarray(stats_u.accepts),
                                  np.asarray(stats_s.accepts))
    np.testing.assert_allclose(np.asarray(st_s.pos),
                               np.asarray(st_u.pos), atol=1e-9)
    assert float(st_s.energy.polar) == pytest.approx(
        float(st_u.energy.polar), rel=1e-9, abs=1e-9)
    # sharded refresh closes the loop on the polar bookkeeping
    fresh = spatial.initialize_spatial(st_s, params, cfg, thermo, mesh8)
    assert float(st_s.energy.polar) == pytest.approx(
        float(fresh.energy.polar), rel=1e-8, abs=1e-8)
