"""Molecule-pair energy cache (ops/pairs.pair_matrix + cache-mode
metropolis): the reference's per-pair energy caching (SURVEY §1 "delta
energy") at molecule granularity."""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from mpmc_tpu.config import RunConfig, Thermo
from mpmc_tpu.mc import metropolis
from mpmc_tpu.models import systems
from mpmc_tpu.ops import pairs


def _sys(**kw):
    params, state, cfg, thermo = systems.mof_h2_gcmc(
        n_side=4, n_h2=8, capacity=16, **kw)
    cfg = dataclasses.replace(cfg, dtype="float64", mol_cache=True)
    to64 = lambda x: (x.astype(jnp.float64)
                      if hasattr(x, "dtype") and x.dtype == jnp.float32
                      else x)
    state = jax.tree_util.tree_map(to64, state)
    return (jax.tree_util.tree_map(to64, params), state, cfg, thermo)


def test_pair_matrix_rows_match_mol_pass():
    params, state, cfg, thermo = _sys()
    alive = state.atom_alive(params)
    c_rd, c_es, c_lrc = pairs.pair_matrix(
        state.pos, state.box, alive, params, cfg, thermo.temperature)
    assert float(jnp.max(jnp.abs(c_rd - c_rd.T))) < 1e-10
    alive_m = np.asarray(state.mol_alive)
    for m in range(1, 9):
        if not alive_m[m]:
            continue
        t = pairs.mol_pair_pass(state.pos, state.box, alive, params, cfg,
                                thermo.temperature, jnp.asarray(m))
        assert float(jnp.sum(c_rd[m])) == pytest.approx(float(t.rd),
                                                        abs=1e-9)
        assert float(jnp.sum(c_es[m])) == pytest.approx(float(t.es_real),
                                                        abs=1e-9)
        assert float(jnp.sum(c_lrc[m])) == pytest.approx(
            float(t.lrc_coeff), rel=1e-10)


def test_pair_matrix_total_matches_full_pass():
    params, state, cfg, thermo = _sys()
    alive = state.atom_alive(params)
    c_rd, c_es, _ = pairs.pair_matrix(
        state.pos, state.box, alive, params, cfg, thermo.temperature)
    act, _ = pairs.pair_pass(state.pos, state.box, alive, params, cfg,
                             thermo.temperature, split_frozen=True)
    assert float(jnp.sum(c_rd)) / 2 == pytest.approx(float(act.rd),
                                                     abs=1e-8)
    assert float(jnp.sum(c_es)) / 2 == pytest.approx(float(act.es_real),
                                                     abs=1e-8)


def test_partials_match_mol_pass_with_trial_rows():
    from mpmc_tpu.mc import moves
    params, state, cfg, thermo = _sys()
    alive = state.atom_alive(params)
    key = jax.random.PRNGKey(7)
    mol = jnp.asarray(2)
    _, rows = moves.displace_rows(state.pos, params, mol, key,
                                  thermo.move_factor, thermo.rot_factor)
    p = pairs.mol_pair_partials(state.pos, state.box, alive, params, cfg,
                                thermo.temperature, mol, row_pos=rows)
    t = pairs.mol_pair_pass(state.pos, state.box, alive, params, cfg,
                            thermo.temperature, mol, row_pos=rows)
    assert float(jnp.sum(p.rd)) == pytest.approx(float(t.rd), abs=1e-9)
    assert float(jnp.sum(p.es_real)) == pytest.approx(float(t.es_real),
                                                      abs=1e-9)
    assert float(p.min_r2) == pytest.approx(float(t.min_r2), rel=1e-12)


def test_gcmc_cache_never_drifts():
    """After a GCMC chunk (displace/insert/delete mix) the cache must
    equal a fresh pair_matrix at the final configuration to fp noise —
    entries are whole pass outputs, never accumulated increments."""
    params, state, cfg, thermo = _sys()
    state = metropolis.initialize(state, params, cfg, thermo)
    assert state.cache_rd is not None
    st, stats = metropolis.run_chunk(state, params, cfg, thermo, 400)
    acc = np.asarray(stats.accepts)
    assert acc[0] > 0 and (acc[1] > 0 or acc[2] > 0)   # moves happened
    alive2 = st.atom_alive(params)
    f_rd, f_es, f_lrc = pairs.pair_matrix(
        st.pos, st.box, alive2, params, cfg, thermo.temperature)
    assert float(jnp.max(jnp.abs(st.cache_rd - f_rd))) < 1e-9
    assert float(jnp.max(jnp.abs(st.cache_es - f_es))) < 1e-9
    assert float(jnp.max(jnp.abs(st.cache_lrc - f_lrc))) < 1e-7
    # and the accumulated energy still closes against a full recompute
    st2 = metropolis.initialize(st, params, cfg, thermo)
    assert float(st.energy.total) == pytest.approx(
        float(st2.energy.total), abs=1e-8)


def test_cache_matches_uncached_trajectory_start():
    """One step from identical states: cached and uncached modes accept
    the same move with the same energy delta (same RNG stream)."""
    params, state, cfg, thermo = _sys()
    cfg_nc = dataclasses.replace(cfg, mol_cache=False)
    s_c = metropolis.initialize(state, params, cfg, thermo)
    s_n = metropolis.initialize(state, params, cfg_nc, thermo)
    a, _ = metropolis.run_chunk(s_c, params, cfg, thermo, 25)
    b, _ = metropolis.run_chunk(s_n, params, cfg_nc, thermo, 25)
    assert float(a.energy.total) == pytest.approx(float(b.energy.total),
                                                  abs=1e-8)
    np.testing.assert_allclose(np.asarray(a.pos), np.asarray(b.pos),
                               atol=1e-9)


def test_cache_eligibility_gates():
    base = RunConfig(ensemble="uvt", mol_cache=True)
    assert metropolis.cache_eligible(base)
    for kw in (dict(ensemble="npt"), dict(polarization=True),
               dict(cdvdw=True), dict(rd_crystal=True, rd_lrc=False),
               dict(cell_list=True), dict(mol_cache=False)):
        assert not metropolis.cache_eligible(
            dataclasses.replace(base, **kw)), kw


def test_cache_ineligible_with_spectre():
    """SPECTRE rewrites params.charge every corrtime, so cached
    molecule-pair ES entries would go stale (ADVICE r1)."""
    cfg = RunConfig(ensemble="nvt", mol_cache=True)
    assert metropolis.cache_eligible(cfg)
    assert not metropolis.cache_eligible(
        dataclasses.replace(cfg, spectre=True))
