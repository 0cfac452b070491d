"""Thole polarization parity: closed-form single-site induction, CG vs
direct dense solve (SURVEY.md §7: "verify rebuilt CG against direct 3Nx3N
solve on small dimers to 1e-10"), damping behavior."""
import jax.numpy as jnp
import numpy as np
import pytest

from mpmc_tpu.config import RunConfig, Thermo
from mpmc_tpu.constants import KE
from mpmc_tpu.ops import energy as energy_mod
from mpmc_tpu.ops import thole

from helpers import atom_species, free_atoms
from mpmc_tpu.state import Species, build_system


def cfg_polar(**kw):
    kw.setdefault("rd_potential", "none")
    kw.setdefault("coulomb", "none")
    kw.setdefault("polarization", True)
    kw.setdefault("polar_damp_type", "none")
    kw.setdefault("polar_max_iter", 200)
    kw.setdefault("polar_precision", 1e-12)
    kw.setdefault("dtype", "float64")
    kw.setdefault("rd_lrc", False)
    return RunConfig(**kw)


def thermo(n=2):
    return Thermo.make(temperature=300.0, n_species=n, dtype=jnp.float64)


def build_charge_plus_polarizable(d=4.0, q=0.8, alpha=1.5, L=200.0):
    chg = atom_species("Q", eps=0.0, sig=0.0, charge=q, polar=0.0)
    pol = atom_species("P", eps=0.0, sig=0.0, charge=0.0, polar=alpha)
    box = L * np.eye(3)
    return build_system(
        box, species=(chg, pol), capacity=(1, 1), initial_counts=(1, 1),
        initial_pos={0: np.zeros((1, 1, 3)),
                     1: np.array([[[d, 0.0, 0.0]]])},
        dtype=jnp.float64)


def test_single_site_induction_closed_form():
    """One charge + one isolated polarizable site:
    mu = alpha q / d^2,  U = -ke alpha q^2 / (2 d^4)."""
    d, q, alpha = 4.0, 0.8, 1.5
    params, state = build_charge_plus_polarizable(d, q, alpha)
    cfg = cfg_polar(cutoff=50.0)
    e, aux = energy_mod.total_energy(state.pos, state.box, state.mol_alive,
                                     params, cfg, thermo())
    expect = -0.5 * KE * alpha * q * q / d ** 4
    assert float(e.polar) == pytest.approx(expect, rel=1e-10)
    mu = np.asarray(aux["mu"])
    # polarizable site is the second real atom
    i = int(np.argmax(np.asarray(params.polar) > 0))
    np.testing.assert_allclose(mu[i], [alpha * q / d ** 2, 0, 0], atol=1e-12)


def test_cg_matches_direct_solver():
    """Random cluster of charged + polarizable sites: CG and dense-direct
    dipoles agree to 1e-10 (SURVEY.md §7)."""
    rng = np.random.default_rng(11)
    n = 8
    coords = rng.uniform(0, 6.0, (n, 3)) + np.arange(n)[:, None] * 0.5
    box = 100.0 * np.eye(3)
    charges = rng.uniform(-0.5, 0.5, n)
    charges -= charges.mean()
    # build n single-atom species so each atom can have its own charge
    species = tuple(
        Species(name=f"s{i}", atom_names=(f"s{i}",), pos=np.zeros((1, 3)),
                mass=np.ones(1), charge=np.array([charges[i]]),
                polar=np.array([0.8]), eps=np.zeros(1), sig=np.zeros(1))
        for i in range(n))
    params, state = build_system(
        box, species=species, capacity=(1,) * n, initial_counts=(1,) * n,
        initial_pos={i: coords[i][None, None, :] for i in range(n)},
        dtype=jnp.float64)
    alive = state.atom_alive(params)
    t = thermo()
    for damp in ("none", "exponential"):
        cfg = cfg_polar(cutoff=45.0, polar_damp_type=damp)
        e0 = thole.static_field(state.pos, state.box, alive, params, cfg)
        mu_cg, it, _ = thole.solve_scf(state.pos, state.box, alive,
                                       params, cfg, e0)
        cfg_d = cfg_polar(cutoff=45.0, polar_damp_type=damp,
                          polar_solver="direct")
        mu_direct, _, _ = thole.solve_scf(state.pos, state.box, alive,
                                          params, cfg_d, e0)
        np.testing.assert_allclose(np.asarray(mu_cg), np.asarray(mu_direct),
                                   atol=1e-10)
        assert int(it) < 200


def test_jacobi_matches_cg_when_converged():
    params, state = build_charge_plus_polarizable(3.5, 0.6, 1.2)
    alive = state.atom_alive(params)
    cfg = cfg_polar(cutoff=50.0)
    e0 = thole.static_field(state.pos, state.box, alive, params, cfg)
    mu_cg, _, _ = thole.solve_scf(state.pos, state.box, alive, params,
                                  cfg, e0)
    cfg_j = cfg_polar(cutoff=50.0, polar_solver="jacobi", polar_max_iter=60)
    mu_j, _, _ = thole.solve_scf(state.pos, state.box, alive, params,
                                 cfg_j, e0)
    np.testing.assert_allclose(np.asarray(mu_j), np.asarray(mu_cg),
                               atol=1e-10)


def test_exponential_damping_reduces_field_at_short_range():
    d_short = 0.8
    params, state = build_charge_plus_polarizable(d_short, 0.8, 1.0)
    alive = state.atom_alive(params)
    cfg_n = cfg_polar(cutoff=50.0, polar_damp_type="none")
    cfg_e = cfg_polar(cutoff=50.0, polar_damp_type="exponential")
    f_n = np.asarray(thole.static_field(state.pos, state.box, alive, params,
                                        cfg_n))
    f_e = np.asarray(thole.static_field(state.pos, state.box, alive, params,
                                        cfg_e))
    i = int(np.argmax(np.asarray(params.polar) > 0))
    assert np.linalg.norm(f_e[i]) < np.linalg.norm(f_n[i])
    # and at long range damping is irrelevant
    params2, state2 = build_charge_plus_polarizable(8.0, 0.8, 1.0)
    alive2 = state2.atom_alive(params2)
    f_n2 = np.asarray(thole.static_field(state2.pos, state2.box, alive2,
                                         params2, cfg_n))
    f_e2 = np.asarray(thole.static_field(state2.pos, state2.box, alive2,
                                         params2, cfg_e))
    i2 = int(np.argmax(np.asarray(params2.polar) > 0))
    np.testing.assert_allclose(f_e2[i2], f_n2[i2], rtol=1e-4)


def test_two_polarizable_sites_mutual_induction():
    """Two mutually-polarizing sites flanking a charge: energy must be lower
    (more negative) than the independent-site sum (cooperative alignment
    along the axis)."""
    q, alpha, d = 0.7, 1.0, 3.0
    chg = atom_species("Q", eps=0, sig=0, charge=q, polar=0.0)
    pol = atom_species("P", eps=0, sig=0, charge=0.0, polar=alpha)
    box = 150.0 * np.eye(3)
    params, state = build_system(
        box, species=(chg, pol), capacity=(1, 2), initial_counts=(1, 2),
        initial_pos={0: np.zeros((1, 1, 3)),
                     1: np.array([[[d, 0, 0]], [[-d, 0, 0]]])},
        dtype=jnp.float64)
    cfg = cfg_polar(cutoff=40.0)
    e, aux = energy_mod.total_energy(state.pos, state.box, state.mol_alive,
                                     params, cfg, thermo())
    # closed form: by symmetry mu_(+d) = +mu x, mu_(-d) = -mu x; the partner
    # dipole's field at each site opposes its own moment:
    #   mu = alpha (q/d^2 - mu/(4 d^3))  ->  mu = (alpha q/d^2)/(1 + alpha/(4 d^3))
    #   U = -(ke/2) * 2 * mu * (q/d^2) = -ke mu q / d^2
    mu = (alpha * q / d ** 2) / (1.0 + alpha / (4 * d ** 3))
    expect = -KE * mu * q / d ** 2
    assert float(e.polar) == pytest.approx(expect, rel=1e-10)
    single = -0.5 * KE * alpha * q * q / d ** 4
    # mutual term weakens induction vs two independent sites
    assert float(e.polar) > 2 * single


class TestEwaldField:
    def _water_like(self, box_len, dtype="float64"):
        import numpy as onp
        from mpmc_tpu.config import RunConfig
        from mpmc_tpu.state import Species, build_system
        sp = Species(
            name="W", atom_names=("O", "H", "H"),
            pos=onp.array([[0.0, 0.0, 0.0], [0.76, 0.59, 0.0],
                           [-0.76, 0.59, 0.0]]),
            mass=onp.array([16.0, 1.0, 1.0]),
            charge=onp.array([-0.8, 0.4, 0.4]),
            polar=onp.array([1.2, 0.3, 0.3]),
            eps=onp.zeros(3), sig=onp.zeros(3))
        cfg = RunConfig(ensemble="nvt", rd_potential="none",
                        coulomb="ewald", ewald_kmax=8, rd_lrc=False,
                        polarization=True, polar_ewald=True,
                        polar_max_iter=64, dtype=dtype)
        rng = onp.random.default_rng(4)
        coms = rng.uniform(box_len * 0.3, box_len * 0.7, size=(4, 3))
        params, state = build_system(
            onp.eye(3) * box_len, species=(sp,), capacity=(4,),
            initial_counts=(4,),
            initial_pos={0: coms[:, None, :] + sp.pos[None]},
            dtype=cfg.jdtype)
        return params, state, cfg

    def test_ewald_field_matches_direct_in_big_box(self):
        """Isolated cluster in a huge box: the tinfoil-boundary Ewald
        field reduces to the direct damped field plus the uniform surface
        dipole term +4 pi P / (3V)."""
        params, state, cfg = self._water_like(60.0)
        alive = state.atom_alive(params)
        e_ew = np.asarray(thole.static_field_ewald(
            state.pos, state.box, alive, params, cfg))
        e_dir = np.asarray(thole.static_field_direct(
            state.pos, state.box, alive, params, cfg))
        am = np.asarray(alive)
        q = np.asarray(params.charge) * am
        p_tot = (q[:, None] * np.asarray(state.pos)).sum(0)
        corr = 4.0 * np.pi * p_tot / (3.0 * 60.0 ** 3)
        scale = float(np.max(np.abs(e_dir)))
        np.testing.assert_allclose(e_ew[am], (e_dir + corr)[am],
                                   atol=0.02 * scale)

    def test_ewald_field_sees_periodic_images(self):
        """Small periodic box: image fields make ewald differ from direct."""
        params, state, cfg = self._water_like(9.0)
        alive = state.atom_alive(params)
        e_ew = thole.static_field_ewald(state.pos, state.box, alive,
                                        params, cfg)
        e_dir = thole.static_field_direct(state.pos, state.box, alive,
                                          params, cfg)
        assert float(jnp.max(jnp.abs(e_ew - e_dir))) > 1e-4

    def test_scf_runs_with_ewald_field(self):
        from mpmc_tpu.config import Thermo
        from mpmc_tpu.mc import metropolis
        params, state, cfg = self._water_like(12.0)
        thermo = Thermo.make(temperature=200.0, n_species=1,
                             dtype=cfg.jdtype)
        state = metropolis.initialize(state, params, cfg, thermo)
        assert np.isfinite(float(state.energy.polar))
        assert float(state.energy.polar) < 0.0   # induction is attractive
        st, _ = metropolis.run_chunk(state, params, cfg, thermo, 50)
        st2 = metropolis.initialize(st, params, cfg, thermo)
        # finite SCF iteration count -> slight warm-start path dependence
        assert float(st.energy.total) == pytest.approx(
            float(st2.energy.total), abs=1e-4)


def test_wolf_field_limits():
    """alpha -> 0 and large rc: the Wolf field reduces to the direct
    damped field (shift vanishes, erfc -> 1)."""
    import dataclasses
    from mpmc_tpu.config import RunConfig
    from mpmc_tpu.state import Species, build_system
    import numpy as onp
    sp = Species(
        name="W", atom_names=("A", "B"),
        pos=onp.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]]),
        mass=onp.ones(2), charge=onp.array([0.5, -0.5]),
        polar=onp.array([0.8, 0.8]), eps=onp.zeros(2), sig=onp.zeros(2))
    cfg = RunConfig(ensemble="nvt", rd_potential="none", coulomb="wolf",
                    rd_lrc=False, polarization=True, polar_wolf=True,
                    polar_wolf_alpha=1e-6, dtype="float64")
    rng = onp.random.default_rng(2)
    coms = rng.uniform(25.0, 35.0, size=(3, 3))
    params, state = build_system(
        onp.eye(3) * 60.0, species=(sp,), capacity=(3,),
        initial_counts=(3,), initial_pos={0: coms[:, None] + sp.pos[None]},
        dtype=cfg.jdtype)
    alive = state.atom_alive(params)
    e_wolf = np.asarray(thole.static_field_wolf(
        state.pos, state.box, alive, params, cfg))
    e_dir = np.asarray(thole.static_field_direct(
        state.pos, state.box, alive, params, cfg))
    # alpha -> 0: wolf = direct MINUS the shift field sum_j q_j rhat/rc^2
    pos = np.asarray(state.pos)
    q = np.asarray(params.charge)
    mol = np.asarray(params.mol_id)
    am = np.asarray(alive)
    rc = 30.0
    shift = np.zeros_like(pos)
    for i in range(len(pos)):
        if not am[i]:
            continue
        for j in range(len(pos)):
            if not am[j] or mol[i] == mol[j]:
                continue
            d = pos[i] - pos[j]
            r = np.linalg.norm(d)
            if r < rc:
                shift[i] += q[j] * d / (r * rc * rc)
    scale = float(np.max(np.abs(e_dir)))
    np.testing.assert_allclose(e_wolf, e_dir - shift, atol=1e-6 * scale)
    # and with a physical alpha it differs (screening is real)
    cfg2 = dataclasses.replace(cfg, polar_wolf_alpha=0.2)
    e_w2 = thole.static_field_wolf(state.pos, state.box, alive, params,
                                   cfg2)
    assert float(jnp.max(jnp.abs(e_w2 - e_dir))) > 1e-6


def test_linear_damping_limits():
    """Thole linear damping: ->1 beyond the screening radius, ->0 at
    contact, monotone in between."""
    r = jnp.linspace(0.01, 5.0, 200)
    d1, d2 = thole._damping(r, 2.0, "linear")
    d1, d2 = np.asarray(d1), np.asarray(d2)
    assert np.all(d1[r >= 2.0] == 1.0) and np.all(d2[r >= 2.0] == 1.0)
    assert d1[0] < 1e-4 and d2[0] < 1e-6
    assert np.all(np.diff(d1) >= -1e-12) and np.all(np.diff(d2) >= -1e-12)
    # SCF runs with linear damping selected from the input grammar
    from mpmc_tpu.io import input_script
    job = input_script.parse("polar_damp_type linear\npolar_damp 2.0\n"
                             "polarization on\nbasis1 10 0 0\n"
                             "basis2 0 10 0\nbasis3 0 0 10\n")
    assert job.cfg.polar_damp_type == "linear"


def test_field_delta_matches_full_rebuild_over_gcmc_chunk():
    """The O(A N) per-move static-field update (thole.field_delta) must
    leave the cached e0 exactly equal to a full rebuild after a GCMC
    chunk with accepted displaces, inserts and deletes."""
    import dataclasses
    import jax
    from mpmc_tpu.mc import metropolis
    from mpmc_tpu.models import systems
    params, state, cfg, thermo_ = systems.mof_h2_gcmc(
        n_side=3, n_h2=6, capacity=12, polarization=True)
    cfg = dataclasses.replace(cfg, dtype="float64")
    to64 = lambda x: (x.astype(jnp.float64)
                      if hasattr(x, "dtype") and x.dtype == jnp.float32
                      else x)
    state = jax.tree_util.tree_map(to64, state)
    params = jax.tree_util.tree_map(to64, params)
    assert thole.field_delta_supported(cfg)
    state = metropolis.initialize(state, params, cfg, thermo_)
    st, stats = metropolis.run_chunk(state, params, cfg, thermo_, 250)
    acc = np.asarray(stats.accepts)
    assert acc[0] > 0 and acc[1] + acc[2] > 0
    e0_full = thole.static_field(st.pos, st.box, st.atom_alive(params),
                                 params, cfg)
    assert float(jnp.max(jnp.abs(st.e0 - e0_full))) < 1e-12
    st2 = metropolis.initialize(st, params, cfg, thermo_)
    assert float(st.energy.total) == pytest.approx(
        float(st2.energy.total), abs=1e-9)


def test_residual_delta_exact_per_move_type():
    """The O(A N) analytic initial CG residual (thole.residual_delta)
    must equal the full b - A mu for displace, insert and delete
    candidates to machine precision (it replaces the warm start's full
    matvec — VERDICT r1 item 1c)."""
    import jax
    from mpmc_tpu.mc import metropolis
    from mpmc_tpu.models import systems
    params, state, cfg, thermo_ = systems.mof_h2_gcmc(
        n_side=4, n_h2=6, capacity=12, polarization=True, dtype="float64")
    assert thole.residual_supported(cfg)
    state = metropolis.initialize(state, params, cfg, thermo_)
    alive = state.atom_alive(params)

    def full_residual(pos, alive_m, mu, e0):
        pol_ok = alive_m & (params.polar > 0)
        mask = pol_ok[:, None]
        inv_a = jnp.where(pol_ok,
                          1.0 / jnp.maximum(params.polar, 1e-30),
                          0.0)[:, None]
        t_mu = thole.dipole_matvec(pos, state.box, alive_m, params, cfg,
                                   mu)
        return jnp.where(mask, jnp.where(mask, e0, 0.0)
                         - (inv_a * mu - t_mu), 0.0)

    # the carried state residual is the true one (initialize re-grounds)
    r_true = full_residual(state.pos, alive, state.mu, state.e0)
    assert float(jnp.max(jnp.abs(state.r_pol - r_true))) < 1e-14

    mf = np.asarray(params.mol_frozen)
    ma = np.asarray(state.mol_alive)
    mol = int(np.where(~mf & ma)[0][2])
    idx = params.mol_atoms[mol]

    new_rows = state.pos[idx] + jnp.asarray([0.4, -0.2, 0.15])
    e0_n = thole.field_delta(state.pos, state.box, alive, params, cfg,
                             mol, state.e0, new_rows=new_rows)
    r0 = thole.residual_delta(state.pos, state.box, alive, params, cfg,
                              mol, state.mu, state.r_pol, state.e0, e0_n,
                              new_rows=new_rows)
    ref = full_residual(state.pos.at[idx].set(new_rows), alive,
                        state.mu, e0_n)
    assert float(jnp.max(jnp.abs(r0 - ref))) < 1e-14

    e0_d = thole.field_delta(state.pos, state.box, alive, params, cfg,
                             mol, state.e0, delete=True)
    r0_d = thole.residual_delta(state.pos, state.box, alive, params, cfg,
                                mol, state.mu, state.r_pol, state.e0,
                                e0_d, delete=True)
    alive_d = (state.mol_alive.at[mol].set(False)[params.mol_id]
               & params.atom_ok)
    ref_d = full_residual(state.pos, alive_d, state.mu, e0_d)
    assert float(jnp.max(jnp.abs(r0_d - ref_d))) < 1e-14

    slot = int(np.where(~ma & ~mf)[0][0])
    sidx = params.mol_atoms[slot]
    tmpl = jnp.asarray(np.asarray(
        params.species_pos[int(params.mol_species[slot])]))
    rows = tmpl[:sidx.shape[0]] + jnp.asarray([7.3, 9.1, 3.3])
    e0_i = thole.field_delta(state.pos, state.box, alive, params, cfg,
                             slot, state.e0, new_rows=rows, insert=True)
    r0_i = thole.residual_delta(state.pos, state.box, alive, params, cfg,
                                slot, state.mu, state.r_pol, state.e0,
                                e0_i, new_rows=rows, insert=True)
    alive_i = (state.mol_alive.at[slot].set(True)[params.mol_id]
               & params.atom_ok)
    ref_i = full_residual(state.pos.at[sidx].set(rows), alive_i,
                          state.mu, e0_i)
    assert float(jnp.max(jnp.abs(r0_i - ref_i))) < 1e-14


def test_residual_mode_bookkeeping_over_gcmc_chunk():
    """A polar GCMC chunk running the analytic-residual CG path must
    keep energies consistent with a from-scratch initialize, and the
    carried r_pol must stay a valid residual (drift bounded by solver
    tolerance) through accepted displaces/inserts/deletes."""
    import jax
    from mpmc_tpu.mc import metropolis
    from mpmc_tpu.models import systems
    params, state, cfg, thermo_ = systems.mof_h2_gcmc(
        n_side=3, n_h2=6, capacity=12, polarization=True, dtype="float64")
    import dataclasses
    assert thole.residual_supported(cfg)
    state = metropolis.initialize(state, params, cfg, thermo_)
    st, stats = metropolis.run_chunk(state, params, cfg, thermo_, 250)
    acc = np.asarray(stats.accepts)
    assert acc[0] > 0 and acc[1] + acc[2] > 0
    st2 = metropolis.initialize(st, params, cfg, thermo_)
    assert float(st.energy.total) == pytest.approx(
        float(st2.energy.total), abs=1e-9)
    assert float(st.energy.polar) == pytest.approx(
        float(st2.energy.polar), abs=1e-9)


def test_zodid_energy_is_uncoupled_limit():
    """zodid_energy == polar_energy(alpha*E0, E0) by construction, and
    equals the full SCF energy exactly when only ONE polarizable site
    exists (no dipole-dipole coupling to iterate)."""
    params, state = build_charge_plus_polarizable(d=4.0)
    cfg = cfg_polar(cutoff=50.0)
    pos, box = state.pos, state.box
    alive = state.atom_alive(params)
    e0 = thole.static_field(pos, box, alive, params, cfg)
    ez = thole.zodid_energy(e0, alive, params)
    mu_z = jnp.where((alive & (params.polar > 0))[:, None],
                     params.polar[:, None] * e0, 0.0)
    assert float(ez) == pytest.approx(
        float(thole.polar_energy(mu_z, e0)), rel=1e-14)
    mu, _, _ = thole.solve_scf(pos, box, alive, params, cfg, e0)
    assert float(ez) == pytest.approx(
        float(thole.polar_energy(mu, e0)), rel=1e-12)


def test_delayed_acceptance_bookkeeping_and_scf_skip():
    """polar_delayed (two-stage Metropolis) GCMC chunk: the skipped-SCF
    branch must never leak into carried state (energies re-ground to a
    from-scratch initialize at 1e-9), and the chunk must spend fewer
    total SCF iterations than plain Metropolis on the same run (stage-1
    rejects skip the solve entirely — the point of the algorithm)."""
    import dataclasses
    import jax
    from mpmc_tpu.mc import metropolis
    from mpmc_tpu.models import systems
    params, state, cfg, thermo_ = systems.mof_h2_gcmc(
        n_side=3, n_h2=6, capacity=12, polarization=True, dtype="float64")
    cfg_da = dataclasses.replace(cfg, polar_delayed=True)
    state = metropolis.initialize(state, params, cfg, thermo_)
    st_p, stats_p = metropolis.run_chunk(state, params, cfg, thermo_, 250)
    st_d, stats_d = metropolis.run_chunk(state, params, cfg_da, thermo_,
                                         250)
    acc = np.asarray(stats_d.accepts)
    assert acc[0] > 0                     # displaces still get accepted
    st2 = metropolis.initialize(st_d, params, cfg_da, thermo_)
    assert float(st_d.energy.total) == pytest.approx(
        float(st2.energy.total), abs=1e-9)
    assert float(st_d.energy.polar) == pytest.approx(
        float(st2.energy.polar), abs=1e-9)
    assert int(stats_d.polar_iters) < int(stats_p.polar_iters)


def test_delayed_acceptance_same_equilibrium():
    """Delayed acceptance targets the SAME stationary distribution as
    plain Metropolis (Christen & Fox 2005) — NVT means of the polar and
    total energy must agree within combined statistical error on a small
    polarizable system."""
    import dataclasses
    import jax
    from mpmc_tpu.mc import metropolis
    from mpmc_tpu.models import systems
    params, state, cfg, thermo_ = systems.mof_h2_gcmc(
        n_side=3, n_h2=6, capacity=8, polarization=True, dtype="float64")
    cfg = dataclasses.replace(cfg, ensemble="nvt")
    cfg_da = dataclasses.replace(cfg, polar_delayed=True)
    state = metropolis.initialize(state, params, cfg, thermo_)

    def run_means(c, seed):
        st = state.replace(key=jax.random.PRNGKey(seed))
        samples = []
        for _ in range(12):               # 12 blocks x 150 steps
            st, _ = metropolis.run_chunk(st, params, c, thermo_, 150)
            samples.append(float(st.energy.polar))
            st = metropolis.initialize(st, params, c, thermo_)
        s = np.asarray(samples[2:])       # drop equilibration blocks
        return s.mean(), s.std(ddof=1) / np.sqrt(len(s))

    m_p, e_p = run_means(cfg, 11)
    m_d, e_d = run_means(cfg_da, 12)
    tol = 5.0 * float(np.hypot(e_p, e_d))
    assert abs(m_p - m_d) < max(tol, 0.05 * abs(m_p))


def test_polar_precision_mode_dipole_same_fixed_point():
    """polar_precision_mode 'dipole' (the reference's per-iteration RMS
    dipole-change rule, polar_precision in Debye) converges to the same
    SCF fixed point as the residual rule — fewer-or-equal iterations at
    a physically matched threshold, energies agreeing within the
    stopping tolerance."""
    import dataclasses

    from mpmc_tpu.models import systems
    from mpmc_tpu.ops import thole

    params, state, cfg, thermo = systems.mof_h2_gcmc(
        n_side=3, n_h2=6, capacity=8, polarization=True,
        dtype="float64")
    alive = state.atom_alive(params)
    e0 = thole.static_field(state.pos, state.box, alive, params, cfg)
    mu_r, it_r, _ = thole.solve_scf(state.pos, state.box, alive, params,
                                    cfg, e0)
    cfg_d = dataclasses.replace(cfg, polar_precision_mode="dipole",
                                polar_precision=1e-5)   # Debye
    mu_d, it_d, _ = thole.solve_scf(state.pos, state.box, alive, params,
                                    cfg_d, e0)
    assert int(it_d) >= 1
    u_r = float(thole.polar_energy(mu_r, e0))
    u_d = float(thole.polar_energy(mu_d, e0))
    assert u_d == pytest.approx(u_r, rel=1e-5)
    # a looser Debye threshold never takes more iterations (on this
    # weakly-polarized system the converged dipoles are ~1e-2 D RMS, so
    # a 1e-2 D threshold may legitimately stop at zero — the
    # reference's rule would too; only monotonicity is contractual)
    cfg_loose = dataclasses.replace(cfg_d, polar_precision=1e-3)
    mu_l, it_l, _ = thole.solve_scf(state.pos, state.box, alive, params,
                                    cfg_loose, e0)
    assert int(it_l) <= int(it_d)


def test_polar_precision_mode_parses():
    from mpmc_tpu.io.input_script import parse

    job = parse("""
ensemble te
temperature 300
polarization on
polar_precision_mode dipole
polar_precision 0.001
basis1 10 0 0
basis2 0 10 0
basis3 0 0 10
pqr_input x.pqr
""")
    assert job.cfg.polar_precision_mode == "dipole"
    with pytest.raises(ValueError, match="polar_precision_mode"):
        parse("""
ensemble te
temperature 300
polar_precision_mode bogus
basis1 10 0 0
basis2 0 10 0
basis3 0 0 10
pqr_input x.pqr
""")


def _polar_gcmc_chain_stats(cfg, state0, params, thermo_, n_blocks,
                            block, drift_cfg=None):
    """Run a polar GCMC chain in per-corrtime blocks under ``cfg``;
    return (per-block arrays: n_mols, u_pol, gc acceptance rate) and —
    when ``drift_cfg`` (a tight-residual config) is given — the max
    carried-dipole / carried-energy drift vs an exactly-converged solve
    at the same configurations, measured at every block end BEFORE the
    refresh (the warm-start drift bound of r3 verdict item 1a)."""
    import jax

    from mpmc_tpu.constants import DEBYE_PER_EA
    from mpmc_tpu.mc import metropolis

    st = metropolis.initialize(state0, params, cfg, thermo_)
    ns, us, accs = [], [], []
    max_mu_drift_debye, max_u_drift_k = 0.0, 0.0
    for _ in range(n_blocks):
        st, stats = metropolis.run_chunk(st, params, cfg, thermo_, block)
        ns.append(float(jnp.sum(st.mol_alive
                                & (params.mol_species == 0))))
        us.append(float(st.energy.polar))
        a = np.asarray(stats.attempts)[1:3].sum()
        accs.append(np.asarray(stats.accepts)[1:3].sum() / max(a, 1))
        if drift_cfg is not None:
            alive = st.atom_alive(params)
            e0 = thole.static_field(st.pos, st.box, alive, params,
                                    drift_cfg)
            mu_x, _, _ = thole.solve_scf(st.pos, st.box, alive, params,
                                         drift_cfg, e0)
            pol_ok = np.asarray(alive & (params.polar > 0))
            d = np.asarray(st.mu - mu_x)[pol_ok]
            rms = float(np.sqrt((d * d).sum(-1).mean())) * DEBYE_PER_EA
            max_mu_drift_debye = max(max_mu_drift_debye, rms)
            u_x = float(thole.polar_energy(mu_x, e0))
            max_u_drift_k = max(max_u_drift_k,
                                abs(float(st.energy.polar) - u_x))
        st = metropolis.initialize(st, params, cfg, thermo_)
    return (np.asarray(ns), np.asarray(us), np.asarray(accs),
            max_mu_drift_debye, max_u_drift_k)


def test_dipole_mode_gcmc_observable_parity():
    """Sampling accuracy of the reference-parity stopping rule (r3
    verdict item 1a): polar GCMC under ``polar_precision_mode dipole``
    @1e-3 Debye (the bench's ref_stopping_rule operating point) vs the
    residual-1e-6 default — <N>, <U_pol>, and the insert/delete
    acceptance rate agree within blocked error bars, and the carried
    warm-start dipoles / polar energy never drift from an
    exactly-converged solve by more than the stopping rule's own scale
    (so the loose rule's bias is bounded, not just statistically
    invisible)."""
    import dataclasses

    from mpmc_tpu.models import systems

    params, state, cfg, thermo_ = systems.mof_h2_gcmc(
        n_side=3, n_h2=6, capacity=12, polarization=True,
        dtype="float64")
    cfg = dataclasses.replace(cfg, polar_delayed=True,
                              polar_precision=1e-6)
    cfg_dip = dataclasses.replace(cfg, polar_precision_mode="dipole",
                                  polar_precision=1e-3)
    tight = dataclasses.replace(cfg, polar_precision=1e-10)

    n_blocks, block, burn = 14, 150, 2
    n_r, u_r, a_r, _, _ = _polar_gcmc_chain_stats(
        cfg, state, params, thermo_, n_blocks, block)
    n_d, u_d, a_d, mu_drift, u_drift = _polar_gcmc_chain_stats(
        cfg_dip, state, params, thermo_, n_blocks, block,
        drift_cfg=tight)

    def close(x, y, abs_floor):
        mx, my = x[burn:].mean(), y[burn:].mean()
        ex = x[burn:].std(ddof=1) / np.sqrt(len(x) - burn)
        ey = y[burn:].std(ddof=1) / np.sqrt(len(y) - burn)
        assert abs(mx - my) < max(5.0 * float(np.hypot(ex, ey)),
                                  abs_floor), (mx, my, ex, ey)

    close(n_r, n_d, 0.5)
    close(u_r, u_d, 0.05 * max(abs(u_r.mean()), 1e-3))
    close(a_r, a_d, 0.05)
    # drift bounds: the rule stops on 1e-3 D RMS *change per CG
    # update*; the accumulated absolute error must stay the same order
    # (a few multiples), and the energy bias far below kT = 77 K so the
    # acceptance-probability error exp(-dU_err/T) is ~1.
    assert mu_drift < 5e-3, mu_drift
    assert u_drift < 1.0, u_drift


def test_dipole_mode_drift_bounded_larger_system():
    """The RMS-dilution concern at scale (r3 verdict item 1a): the
    dipole-change rule averages a LOCAL move's pending update over ALL
    polarizable sites, so on a large framework it can stop while the
    local dipoles are individually unconverged — and the polar-energy
    error sums First-order-coherently over sites.  Measured on this
    ~1k-framework system (MEASURE_DIPOLE_TOL.json, r4): the
    reference-typical 1e-3 Debye setting drifts U_pol by up to 5.5 K
    (~7% acceptance distortion at 77 K) — and at the 10.8k bench size
    1e-3 drifts 198.7 K and 3e-4 drifts 14.1 K (size-inconsistent
    rule; MEASURE_DIPOLE_TOL_BENCH.json), which is why the bench's
    validated reference-rule point is 1e-4 Debye.  This regression
    gate asserts the 1k-site calibration point: 3e-4 bounds at
    0.063 K measured (0.5 K gate), with dipole drift at the rule's
    own scale."""
    import dataclasses

    from mpmc_tpu.models import systems

    params, state, cfg, thermo_ = systems.mof_h2_gcmc(
        n_side=10, n_h2=24, capacity=48, polarization=True,
        dtype="float64", corrtime=100)
    cfg = dataclasses.replace(cfg, polar_delayed=True,
                              polar_precision_mode="dipole",
                              polar_precision=3e-4)
    tight = dataclasses.replace(cfg, polar_precision_mode="residual",
                                polar_precision=1e-10)
    _, _, _, mu_drift, u_drift = _polar_gcmc_chain_stats(
        cfg, state, params, thermo_, n_blocks=4, block=100,
        drift_cfg=tight)
    assert mu_drift < 1.5e-3, mu_drift
    # kT = 77 K; bias in the carried energy stays orders below it
    assert u_drift < 0.5, u_drift


def test_move_deltas_matches_sequential():
    """The fused move_deltas (one shared pass per displacement tile)
    must reproduce field_delta + residual_delta to f64 roundoff for
    every move type (r4; the per-survivor stage-2 cost lever)."""
    import dataclasses

    import jax

    from mpmc_tpu.mc import metropolis
    from mpmc_tpu.models import systems
    from mpmc_tpu.state import mol_rows

    params, state, cfg, thermo_ = systems.mof_h2_gcmc(
        n_side=3, n_h2=6, capacity=12, polarization=True,
        dtype="float64")
    state = metropolis.initialize(state, params, cfg, thermo_)
    alive = state.atom_alive(params)
    mol = int(np.asarray(params.mol_frozen).argmin())
    rows = mol_rows(state.pos, params, mol) + jnp.asarray(
        [[0.3, -0.2, 0.15]])
    # a dead slot for the insert case
    dead = int(np.asarray(~state.mol_alive
                          & (params.mol_species == 0)).argmax())
    rows_ins = jnp.broadcast_to(jnp.asarray([4.1, 5.2, 6.3]),
                                mol_rows(state.pos, params, dead).shape)

    for kw in ({"new_rows": rows},
               {"new_rows": rows_ins, "insert": True, "_mol": dead},
               {"delete": True}):
        m = kw.pop("_mol", mol)
        e0_ref = thole.field_delta(state.pos, state.box, alive, params,
                                   cfg, m, state.e0, **kw)
        r_ref = thole.residual_delta(state.pos, state.box, alive,
                                     params, cfg, m, state.mu,
                                     state.r_pol, state.e0, e0_ref,
                                     **kw)
        e0_f, r_f = thole.move_deltas(state.pos, state.box, alive,
                                      params, cfg, m, state.e0,
                                      state.mu, state.r_pol, **kw)
        np.testing.assert_allclose(np.asarray(e0_f), np.asarray(e0_ref),
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(np.asarray(r_f), np.asarray(r_ref),
                                   rtol=0, atol=1e-12)
        # and without the residual
        e0_only, r_none = thole.move_deltas(
            state.pos, state.box, alive, params, cfg, m, state.e0,
            None, None, with_residual=False, **kw)
        assert r_none is None
        np.testing.assert_allclose(np.asarray(e0_only),
                                   np.asarray(e0_ref), rtol=0,
                                   atol=1e-12)


@pytest.mark.parametrize("variant", ["wolf", "ewald"])
def test_field_delta_variant_matches_full_rebuild(variant):
    """r4 verdict item 1 (polar fast path for the production field
    variants): the per-move delta field must equal a full static_field
    rebuild of the post-move configuration for polar_wolf (pairwise
    shifted kernel) and polar_ewald (real-space tiles + the k-space
    term, linear in S(k)) — displace, insert and delete."""
    import dataclasses

    from mpmc_tpu.mc import metropolis
    from mpmc_tpu.models import systems
    from mpmc_tpu.state import mol_rows

    params, state, cfg, thermo_ = systems.mof_h2_gcmc(
        n_side=3, n_h2=6, capacity=12, polarization=True,
        dtype="float64")
    kw_v = ({"polar_wolf": True} if variant == "wolf"
            else {"polar_ewald": True})
    cfg = dataclasses.replace(cfg, **kw_v)
    assert thole.field_delta_supported(cfg)
    assert thole.residual_supported(cfg)
    state = metropolis.initialize(state, params, cfg, thermo_)
    alive = state.atom_alive(params)
    sk = (state.sk_re, state.sk_im)
    # the carried e0 is the variant's field (initialize went through
    # static_field's dispatcher)
    e0_ref0 = thole.static_field(state.pos, state.box, alive, params,
                                 cfg)
    np.testing.assert_allclose(np.asarray(state.e0),
                               np.asarray(e0_ref0), rtol=0, atol=1e-12)
    tol = 1e-10

    mf = np.asarray(params.mol_frozen)
    ma = np.asarray(state.mol_alive)
    mol = int(np.where(~mf & ma)[0][1])
    idx = params.mol_atoms[mol]

    # displace
    rows = mol_rows(state.pos, params, mol) + jnp.asarray(
        [[0.4, -0.2, 0.15]])
    e0_d = thole.field_delta(state.pos, state.box, alive, params, cfg,
                             mol, state.e0, new_rows=rows, sk=sk)
    ref = thole.static_field(state.pos.at[idx].set(rows), state.box,
                             alive, params, cfg)
    np.testing.assert_allclose(np.asarray(e0_d), np.asarray(ref),
                               rtol=0, atol=tol)

    # delete
    e0_del = thole.field_delta(state.pos, state.box, alive, params, cfg,
                               mol, state.e0, delete=True, sk=sk)
    alive_d = (state.mol_alive.at[mol].set(False)[params.mol_id]
               & params.atom_ok)
    ref_d = thole.static_field(state.pos, state.box, alive_d, params,
                               cfg)
    np.testing.assert_allclose(np.asarray(e0_del), np.asarray(ref_d),
                               rtol=0, atol=tol)

    # insert into a dead slot
    slot = int(np.where(~ma & ~mf)[0][0])
    sidx = params.mol_atoms[slot]
    tmpl = jnp.asarray(np.asarray(
        params.species_pos[int(params.mol_species[slot])]))
    rows_i = tmpl[:sidx.shape[0]] + jnp.asarray([7.3, 9.1, 3.3])
    e0_i = thole.field_delta(state.pos, state.box, alive, params, cfg,
                             slot, state.e0, new_rows=rows_i,
                             insert=True, sk=sk)
    alive_i = (state.mol_alive.at[slot].set(True)[params.mol_id]
               & params.atom_ok)
    ref_i = thole.static_field(state.pos.at[sidx].set(rows_i), state.box,
                               alive_i, params, cfg)
    np.testing.assert_allclose(np.asarray(e0_i), np.asarray(ref_i),
                               rtol=0, atol=tol)

    # the analytic residual rides the variant field deltas unchanged
    # (dipole tiles are field-variant independent): check the displace
    r0 = thole.residual_delta(state.pos, state.box, alive, params, cfg,
                              mol, state.mu, state.r_pol, state.e0,
                              e0_d, new_rows=rows)
    pol_ok = alive & (params.polar > 0)
    mask = pol_ok[:, None]
    inv_a = jnp.where(pol_ok, 1.0 / jnp.maximum(params.polar, 1e-30),
                      0.0)[:, None]
    pos_n = state.pos.at[idx].set(rows)
    t_mu = thole.dipole_matvec(pos_n, state.box, alive, params, cfg,
                               state.mu)
    r_ref = jnp.where(mask, jnp.where(mask, e0_d, 0.0)
                      - (inv_a * state.mu - t_mu), 0.0)
    np.testing.assert_allclose(np.asarray(r0), np.asarray(r_ref),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("variant", ["wolf", "ewald"])
def test_field_delta_variant_gcmc_chunk_bookkeeping(variant):
    """A polar-delayed GCMC chunk on the wolf / full-Ewald field (the
    r5-widened fast path: delta field + analytic residual + scan-path
    PDA) must keep the cached e0 equal to a rebuild and the energies
    consistent with a from-scratch initialize."""
    import dataclasses

    import jax

    from mpmc_tpu.mc import metropolis
    from mpmc_tpu.models import systems

    params, state, cfg, thermo_ = systems.mof_h2_gcmc(
        n_side=3, n_h2=6, capacity=12, polarization=True,
        dtype="float64")
    kw_v = ({"polar_wolf": True} if variant == "wolf"
            else {"polar_ewald": True})
    cfg = dataclasses.replace(cfg, polar_delayed=True,
                              **kw_v)
    assert thole.field_delta_supported(cfg)
    state = metropolis.initialize(state, params, cfg, thermo_)
    st, stats = metropolis.run_chunk(state, params, cfg, thermo_, 400)
    acc = np.asarray(stats.accepts)
    # delayed acceptance: stage 1 kills most attempts — require some
    # accepted moves including at least one insert/delete
    assert acc.sum() > 0 and acc[1] + acc[2] > 0
    e0_full = thole.static_field(st.pos, st.box, st.atom_alive(params),
                                 params, cfg)
    assert float(jnp.max(jnp.abs(st.e0 - e0_full))) < 1e-9
    st2 = metropolis.initialize(st, params, cfg, thermo_)
    assert float(st.energy.total) == pytest.approx(
        float(st2.energy.total), abs=1e-9)
    assert float(st.energy.polar) == pytest.approx(
        float(st2.energy.polar), abs=1e-9)


def test_field_delta_ewald_mxu_cube_layout():
    """polar_ewald's delta field must also work over the matmul cube-table
    S(k) representation (ewald_mxu): move_deltas and the
    static_field_ewald rebuild both ride ewald.ktable's layout, so the
    delta must equal the rebuild in either representation."""
    import dataclasses

    from mpmc_tpu.mc import metropolis
    from mpmc_tpu.models import systems
    from mpmc_tpu.state import mol_rows

    params, state, cfg, thermo_ = systems.mof_h2_gcmc(
        n_side=3, n_h2=6, capacity=12, polarization=True,
        dtype="float64")
    cfg = dataclasses.replace(cfg, polar_ewald=True,
                              ewald_mxu=True)
    assert thole.field_delta_supported(cfg)
    state = metropolis.initialize(state, params, cfg, thermo_)
    alive = state.atom_alive(params)
    sk = (state.sk_re, state.sk_im)
    e0_ref0 = thole.static_field(state.pos, state.box, alive, params,
                                 cfg)
    np.testing.assert_allclose(np.asarray(state.e0),
                               np.asarray(e0_ref0), rtol=0, atol=1e-12)
    mf = np.asarray(params.mol_frozen)
    ma = np.asarray(state.mol_alive)
    mol = int(np.where(~mf & ma)[0][1])
    idx = params.mol_atoms[mol]
    rows = mol_rows(state.pos, params, mol) + jnp.asarray(
        [[0.4, -0.2, 0.15]])
    e0_d = thole.field_delta(state.pos, state.box, alive, params, cfg,
                             mol, state.e0, new_rows=rows, sk=sk)
    ref = thole.static_field(state.pos.at[idx].set(rows), state.box,
                             alive, params, cfg)
    np.testing.assert_allclose(np.asarray(e0_d), np.asarray(ref),
                               rtol=0, atol=1e-10)


def test_dipole_mode_always_applies_one_iteration():
    """r5 regression test for the zero-iteration warm-start hole
    (caught by the in-situ bench drift gate): dipole mode is DO-WHILE
    — a warm-started solve must apply >= 1 CG iteration even when the
    pending update looks converged, so the carried dipoles track a
    slightly-moved static field instead of lagging it."""
    params, state = build_charge_plus_polarizable(d=4.0)
    alive = state.atom_alive(params)
    cfg = cfg_polar(cutoff=50.0, polar_precision_mode="dipole",
                    polar_precision=1e-4)
    e0 = thole.static_field(state.pos, state.box, alive, params, cfg)
    mu, it, r = thole.solve_scf(state.pos, state.box, alive, params,
                                cfg, e0)
    assert int(it) >= 1
    # re-solve from the converged state: still >= 1 iteration
    mu2, it2, _ = thole.solve_scf(state.pos, state.box, alive, params,
                                  cfg, e0, mu0=mu, r0=r)
    assert int(it2) >= 1
    # a small field perturbation must move the solution toward the NEW
    # fixed point (the old skip could return mu unchanged)
    e0b = e0 * 1.001
    mu3, it3, _ = thole.solve_scf(state.pos, state.box, alive, params,
                                  cfg, e0b, mu0=mu)
    assert int(it3) >= 1
    cfg_t = cfg_polar(cutoff=50.0, polar_precision=1e-12)
    mu_exact, _, _ = thole.solve_scf(state.pos, state.box, alive,
                                     params, cfg_t, e0b)
    gap_new = float(jnp.max(jnp.abs(mu3 - mu_exact)))
    gap_old = float(jnp.max(jnp.abs(mu - mu_exact)))
    assert gap_new < gap_old


# ---------------------------------------------------------------------------
# tile-culled SCF matvec (r6): cell-sorted visit table + culled CG path
# ---------------------------------------------------------------------------


def _random_polar_cloud(seed=0, n=700, L=40.0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, L, (n, 3)).astype(np.float32)
    ok = rng.uniform(size=n) > 0.15
    mu = np.where(ok[:, None],
                  rng.normal(size=(n, 3)).astype(np.float32) * 0.01, 0.0)
    return pos, ok, mu, L


def test_cull_visit_table_is_conservative():
    """Every tile the visit table culls must contain NO cross pair
    inside rc (checked exactly in f64 against brute-force min-image
    distances) — the property that makes the culled matvec exact."""
    pos, ok, _, L = _random_polar_cloud()
    rc = 9.0
    box = jnp.eye(3, dtype=jnp.float32) * L
    perm, inv = thole.cull_perm(jnp.asarray(pos), box, jnp.asarray(ok),
                                jnp.asarray(rc, jnp.float32))
    perm = np.asarray(perm)
    assert np.array_equal(np.sort(np.asarray(inv)[perm]),
                          np.arange(len(pos)))   # inverse really inverts
    pos_s, ok_s = pos[perm], ok[perm]

    from mpmc_tpu.ops.pallas import thole_kernel as tk
    ti, tj = 32, 64
    n_pad, ni, nj = tk.grid_shape(len(pos), ti, tj)
    visit = np.asarray(thole.cull_visit(
        jnp.asarray(pos_s), jnp.asarray(ok_s), box,
        jnp.asarray(rc, jnp.float32), ti, tj, n_pad))
    assert visit.shape == (ni, nj)
    # culling must actually happen on this geometry (rc << L)
    assert visit.mean() < 0.95

    pos_p = np.pad(pos_s, ((0, n_pad - len(pos)), (0, 0))).astype(
        np.float64)
    ok_p = np.pad(ok_s, (0, n_pad - len(pos)))
    d = pos_p[:, None, :] - pos_p[None, :, :]
    d -= L * np.round(d / L)
    inside = ((d * d).sum(-1) < rc * rc) & ok_p[:, None] & ok_p[None, :]
    np.fill_diagonal(inside, False)
    for i_blk in range(ni):
        for j_blk in range(nj):
            if visit[i_blk, j_blk] == 0:
                sub = inside[i_blk * ti:(i_blk + 1) * ti,
                             j_blk * tj:(j_blk + 1) * tj]
                assert not sub.any(), (i_blk, j_blk)


def test_culled_dipole_kernel_bit_identical():
    """The visit-table kernel skips only tiles whose pairs the cutoff
    mask already zeroes, so the accumulated field is bit-identical to
    the dense pass (interpret mode, same block sizes)."""
    pos, ok, mu, L = _random_polar_cloud(seed=1)
    rc = 9.0
    box = jnp.eye(3, dtype=jnp.float32) * L
    perm, _ = thole.cull_perm(jnp.asarray(pos), box, jnp.asarray(ok),
                              jnp.asarray(rc, jnp.float32))
    perm = np.asarray(perm)
    pos_s, ok_s, mu_s = (jnp.asarray(pos[perm]), jnp.asarray(ok[perm]),
                         jnp.asarray(mu[perm]))
    mol = jnp.arange(len(pos), dtype=jnp.int32)

    from mpmc_tpu.ops.pallas import thole_kernel as tk
    ti, tj = 32, 64
    n_pad, _, _ = tk.grid_shape(len(pos), ti, tj)
    visit = thole.cull_visit(pos_s, ok_s, box,
                             jnp.asarray(rc, jnp.float32), ti, tj,
                             n_pad)
    assert float(jnp.mean(visit)) < 0.9     # tiles really are skipped
    kw = dict(interpret=True, ortho=True, bi=ti, bj=tj)
    args = (pos_s, box, ok_s, mu_s, mol, jnp.asarray(rc, jnp.float32),
            jnp.asarray(2.1304, jnp.float32), "exponential")
    dense = np.asarray(tk.dipole_field(*args, **kw))
    culled = np.asarray(tk.dipole_field(*args, visit=visit, **kw))
    np.testing.assert_array_equal(dense, culled)


def test_solve_scf_culled_matches_plain():
    """End-to-end culled CG (interpret-mode kernel, sorted space) vs the
    plain jnp CG: same fixed point, same iteration count, and the
    returned recurrence residual survives the round trip through the
    permutation."""
    rng = np.random.default_rng(3)
    site = atom_species("Q", eps=0.0, sig=0.0, charge=0.5, polar=0.8)
    boxL, n_mol = 30.0, 60
    params, state = build_system(
        np.eye(3) * boxL, species=(site,), capacity=(n_mol,),
        initial_counts=(n_mol,),
        initial_pos={0: rng.uniform(0, boxL, (n_mol, 1, 3))},
        dtype=jnp.float32)
    cfg = RunConfig(rd_potential="none", coulomb="none",
                    polarization=True, polar_damp_type="exponential",
                    polar_max_iter=100, polar_precision=1e-7,
                    dtype="float32", rd_lrc=False, cutoff=8.0,
                    ortho_box=True)
    assert thole.cull_supported(cfg)
    assert not thole.cull_supported(
        RunConfig(**{**cfg.__dict__, "cutoff": None}))       # derived rc
    assert thole.cull_supported(                             # forced
        RunConfig(**{**cfg.__dict__, "cutoff": None, "polar_cull": "on"}))
    assert not thole.cull_supported(
        RunConfig(**{**cfg.__dict__, "polar_cull": "off"}))
    assert not thole.cull_supported(
        RunConfig(**{**cfg.__dict__, "ortho_box": False}))   # triclinic
    alive = state.atom_alive(params)
    e0 = thole.static_field(state.pos, state.box, alive, params, cfg)
    mu_p, it_p, r_p = thole.solve_scf(state.pos, state.box, alive,
                                      params, cfg, e0)
    mu_c, it_c, r_c = thole.solve_scf(state.pos, state.box, alive,
                                      params, cfg, e0, interpret=True)
    assert int(it_p) == int(it_c)
    np.testing.assert_allclose(np.asarray(mu_c), np.asarray(mu_p),
                               atol=5e-6)
    np.testing.assert_allclose(np.asarray(r_c), np.asarray(r_p),
                               atol=5e-6)


def test_polar_cull_large_system_promotion():
    """No size-based promotion: polar_cull auto culls only with an
    explicit cutoff, at any system size (the old auto -> on promotion
    for >= 49,152 atoms at the derived rc was never measured on the
    GPU); explicit on/off always win, and triclinic, non-CG and
    non-polar configs stay dense."""
    import dataclasses

    base = RunConfig(polarization=True, ortho_box=True)
    assert not thole.cull_supported(base)          # derived rc, any N
    assert thole.cull_supported(dataclasses.replace(base, cutoff=14.0))
    assert thole.cull_supported(dataclasses.replace(base, polar_cull="on"))
    assert not thole.cull_supported(
        dataclasses.replace(base, cutoff=14.0, polar_cull="off"))
    assert not thole.cull_supported(
        dataclasses.replace(base, cutoff=14.0, ortho_box=False))
    assert not thole.cull_supported(
        dataclasses.replace(base, cutoff=14.0, polar_solver="jacobi"))
    assert not thole.cull_supported(
        dataclasses.replace(base, cutoff=14.0, polarization=False))


def test_culled_solve_passes_sorted_mol_ids(monkeypatch):
    """Every per-site array the sorted-space matvec reads — positions,
    masks, AND molecule ids — arrives in the cell-sorted order (the
    unpermuted mol_id was a latent trap: harmless for the dipole mode,
    wrong for any mode that reads it)."""
    from mpmc_tpu.ops.pallas import thole_kernel as tk
    rng = np.random.default_rng(5)
    site = atom_species("Q", eps=0.0, sig=0.0, charge=0.5, polar=0.8)
    boxL, n_mol = 30.0, 40
    params, state = build_system(
        np.eye(3) * boxL, species=(site,), capacity=(n_mol,),
        initial_counts=(n_mol,),
        initial_pos={0: rng.uniform(0, boxL, (n_mol, 1, 3))},
        dtype=jnp.float32)
    cfg = RunConfig(rd_potential="none", coulomb="none",
                    polarization=True, polar_max_iter=3,
                    polar_precision=0.0, dtype="float32", rd_lrc=False,
                    cutoff=8.0, ortho_box=True)
    alive = state.atom_alive(params)
    pol_ok = alive & (params.polar > 0)
    seen = []
    real = tk.dipole_field

    def spy(pos, box, site_ok, mu, mol_id, *a, **kw):
        seen.append((np.asarray(pos), np.asarray(mol_id)))
        return real(pos, box, site_ok, mu, mol_id, *a, **kw)

    monkeypatch.setattr(tk, "dipole_field", spy)
    e0 = thole.static_field(state.pos, state.box, alive, params, cfg)
    thole.solve_scf(state.pos, state.box, alive, params, cfg, e0,
                    interpret=True)
    assert seen
    perm, _ = thole.cull_perm(state.pos, state.box, pol_ok,
                              jnp.asarray(8.0, jnp.float32))
    perm = np.asarray(perm)
    pos_k, mol_k = seen[0]
    np.testing.assert_array_equal(pos_k, np.asarray(state.pos)[perm])
    np.testing.assert_array_equal(mol_k, np.asarray(params.mol_id)[perm])
    assert not np.array_equal(mol_k, np.asarray(params.mol_id))


def test_cull_visit_margin_covers_f32_rounding():
    """cull_visit compares against rc widened by an f32 margin: two
    blocks whose exact gap is a hair above rc (closer than f32 can
    resolve at this box size) stay visited, while a gap clearly above
    rc still culls."""
    from mpmc_tpu.ops.pallas import thole_kernel as tk
    L, rc = 80.0, 10.0
    box = jnp.eye(3, dtype=jnp.float32) * L
    bi = bj = 16
    n_pad, _, _ = tk.grid_shape(2 * bi, bi, bj)
    for gap, want in ((rc * (1 + 2e-7), 1), (rc * 1.001, 0)):
        pos = np.zeros((2 * bi, 3), np.float32)
        pos[:bi, 0] = 20.0
        pos[bi:, 0] = np.float32(20.0 + gap)
        ok = jnp.ones(2 * bi, bool)
        visit = np.asarray(thole.cull_visit(
            jnp.asarray(pos), ok, box, jnp.asarray(rc, jnp.float32),
            bi, bj, n_pad))
        assert visit[0, 1] == want, (gap, visit)
