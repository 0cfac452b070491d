"""Pair passes against an unchunked float64 direct sum, and the Thole
Pallas-Triton kernel on the CPU: interpret mode against the jnp
reference, lowering for the CUDA platform, and the route that chooses
it."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mpmc_tpu.models import systems
from mpmc_tpu.ops import pairs
from mpmc_tpu.ops import pbc as pbc_ops

_TERMS = ("rd", "es_real", "es_excl", "lrc_coeff", "min_r2")


def _f64(params, state, cfg):
    """The same system with every float leaf in float64."""
    to64 = lambda t: jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float64)
        if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating)
        else x, t)
    return to64(params), to64(state), dataclasses.replace(cfg,
                                                          dtype="float64")


def _direct_terms(pos, box, alive, params, cfg, temperature, rows=None,
                  row_start=0):
    """Unchunked direct sum of the pair-pass terms over the whole [R, N]
    displacement matrix — ``rows`` (default: all, triangular j > i, plus
    the columns below ``row_start`` that a row-restricted pass sees) or
    one molecule's rows against every other molecule."""
    n = pos.shape[0]
    rc = pairs.derived_cutoff(box, cfg)
    alpha = pairs.derived_alpha(rc, cfg)
    mol_rows = rows is not None
    idx = (jnp.asarray(rows) if mol_rows
           else jnp.arange(row_start, n))
    dr = pbc_ops.min_image(pos[idx][:, None, :] - pos[None, :, :], box)
    r2 = jnp.sum(dr * dr, -1)
    cols = jnp.arange(n)
    ok = alive[idx][:, None] & alive[None, :]
    if not mol_rows:
        ok = ok & ((cols[None, :] > idx[:, None])
                   | (cols[None, :] < row_start))
    same = params.mol_id[idx][:, None] == params.mol_id[None, :]
    if mol_rows:
        ok = ok & ~same
    inter, intra = ok & ~same, ok & same
    act = inter & (r2 < rc * rc)
    rd_u, es_u, ex_u, tc = pairs._tile_values(r2, idx, params, cfg, rc,
                                              alpha, temperature)
    s = lambda v, m: (float(jnp.sum(jnp.where(m, v, 0.0)))
                      if v is not None else 0.0)
    return {"rd": s(rd_u, act), "es_real": s(es_u, act),
            "es_excl": s(ex_u, intra), "lrc_coeff": s(tc, inter),
            "min_r2": float(jnp.min(jnp.where(inter, r2, jnp.inf)))}


def _compare_full(params, state, cfg, thermo, chunk=16, row_start=0):
    params, state, cfg = _f64(params, state, cfg)
    cfg = dataclasses.replace(cfg, pair_chunk=chunk)
    alive = state.atom_alive(params)
    t = thermo.temperature.astype(jnp.float64)
    got = pairs.pair_pass(state.pos, state.box, alive, params, cfg, t,
                          row_start=row_start)
    want = _direct_terms(state.pos, state.box, alive, params, cfg, t,
                         row_start=row_start)
    for name in _TERMS:
        assert float(getattr(got, name)) == pytest.approx(
            want[name], rel=1e-10, abs=1e-9), name


def test_pair_pass_matches_direct_sum_mof():
    params, state, cfg, thermo = systems.mof_h2_gcmc(
        n_side=4, n_h2=8, capacity=16, dtype="float32")
    _compare_full(params, state, cfg, thermo)


def test_pair_pass_matches_direct_sum_lj_fluid():
    params, state, cfg, thermo = systems.lj_fluid(n=64, dtype="float32")
    _compare_full(params, state, cfg, thermo, chunk=24)


def test_pair_pass_row_restricted_matches_direct_sum():
    """row_start > 0 (the frozen-reuse fast refresh): rows start mid-
    array, and the frozen-prefix rows reappear as columns."""
    from mpmc_tpu.mc import metropolis
    params, state, cfg, thermo = systems.mof_h2_gcmc(
        n_side=5, n_h2=16, capacity=32, dtype="float32")
    F = metropolis.frozen_refresh_rows(params, cfg)
    assert 0 < F < int(params.n_atoms_max)
    _compare_full(params, state, cfg, thermo, chunk=32, row_start=F)


def _rd_variant_system(rd):
    import numpy as onp

    from mpmc_tpu.config import RunConfig, Thermo
    from mpmc_tpu.state import Species, build_system
    sp = Species(
        name="X", atom_names=("X",), pos=onp.zeros((1, 3)),
        mass=onp.array([20.0]), charge=onp.array([0.1]),
        polar=onp.zeros(1),
        eps=onp.array([1.0e5 if rd == "disp_expansion" else 80.0]),
        sig=onp.array([1.9 if rd == "disp_expansion" else 3.2]),
        c6=onp.array([900.0]), c8=onp.array([3000.0]),
        c10=onp.array([9000.0]))
    cfg = RunConfig(ensemble="nvt", rd_potential=rd, coulomb="cutoff",
                    rd_lrc=False, dtype="float32")
    rng = onp.random.default_rng(8)
    coms = rng.uniform(1.0, 15.0, (12, 3))
    params, state = build_system(
        onp.eye(3) * 16.0, species=(sp,), capacity=(12,),
        initial_counts=(12,), initial_pos={0: coms[:, None]},
        dtype=cfg.jdtype)
    thermo = Thermo.make(temperature=200.0, n_species=1, dtype=cfg.jdtype)
    return params, state, cfg, thermo


@pytest.mark.parametrize("rd", ["sg", "dreiding", "b14_7",
                                "disp_expansion"])
def test_pair_pass_matches_direct_sum_rd_variants(rd):
    params, state, cfg, thermo = _rd_variant_system(rd)
    _compare_full(params, state, cfg, thermo, chunk=5)
    # the per-move molecule pass too
    params, state, cfg = _f64(params, state, cfg)
    alive = state.atom_alive(params)
    t = thermo.temperature.astype(jnp.float64)
    got = pairs.mol_pair_pass(state.pos, state.box, alive, params, cfg,
                              t, jnp.asarray(2))
    rows = np.flatnonzero(np.asarray(params.mol_id) == 2)
    want = _direct_terms(state.pos, state.box, alive, params, cfg, t,
                         rows=rows)
    for name in ("rd", "es_real"):
        assert float(getattr(got, name)) == pytest.approx(
            want[name], rel=1e-10, abs=1e-9), name


def test_mol_pair_pass_matches_direct_sum():
    """The per-move delta pass for several molecules."""
    params, state, cfg, thermo = systems.mof_h2_gcmc(
        n_side=4, n_h2=8, capacity=16, dtype="float32")
    params, state, cfg = _f64(params, state, cfg)
    alive = state.atom_alive(params)
    t = thermo.temperature.astype(jnp.float64)
    for mol in (1, 3, 7):
        got = pairs.mol_pair_pass(state.pos, state.box, alive, params,
                                  cfg, t, jnp.asarray(mol))
        rows = np.flatnonzero(np.asarray(params.mol_id) == mol)
        want = _direct_terms(state.pos, state.box, alive, params, cfg, t,
                             rows=rows)
        for name in ("rd", "es_real", "lrc_coeff", "min_r2"):
            assert float(getattr(got, name)) == pytest.approx(
                want[name], rel=1e-10, abs=1e-9), (mol, name)


def test_route_chooses_kernel_only_where_asked():
    """ops.route is the one switch: never on the CPU unless a test asks
    for interpret mode, never for f64 or an unknown damping model,
    never inside the spatially sharded step."""
    from mpmc_tpu.ops import route
    _, _, cfg, _ = systems.mof_h2_gcmc(n_side=3, n_h2=2, capacity=4,
                                       polarization=True)
    assert jax.default_backend() == "cpu"
    assert not route.thole_kernel(cfg)
    assert route.thole_kernel(cfg, interpret=True)
    assert not route.thole_kernel(
        dataclasses.replace(cfg, dtype="float64"), interpret=True)
    assert route.thole_kernel(
        dataclasses.replace(cfg, polar_damp_type="linear"), interpret=True)
    assert not route.thole_kernel(
        dataclasses.replace(cfg, spatial_axis=("x", 2)), interpret=True)


@pytest.mark.parametrize("mode", ["dipole", "charge"])
def test_thole_kernel_lowers_for_cuda(mode):
    """The kernel's Triton lowering (what the GPU compiles) succeeds for
    both modes, both min-image forms and the culled variant — checked
    here without a card by lowering for the CUDA platform."""
    from mpmc_tpu.ops.pallas import thole_kernel as tk
    params, state, cfg, _ = systems.mof_h2_gcmc(
        n_side=3, n_h2=4, capacity=8, polarization=True, dtype="float32")
    alive = state.atom_alive(params)
    rc = pairs.derived_cutoff(state.box, cfg)
    lam = jnp.asarray(cfg.polar_damp, jnp.float32)
    fn = tk.dipole_field if mode == "dipole" else tk.charge_field
    src = (jnp.zeros(state.pos.shape, jnp.float32) if mode == "dipole"
           else params.charge)
    n_pad, ni, nj = tk.grid_shape(state.pos.shape[0])
    visit = jnp.ones((ni, nj), jnp.int32)
    for ortho, vis in ((True, None), (False, visit)):
        f = jax.jit(lambda s: fn(state.pos, state.box, alive, s,
                                 params.mol_id, rc, lam, "exponential",
                                 ortho=ortho, visit=vis))
        text = f.trace(src).lower(lowering_platforms=("cuda",)).as_text()
        assert f"thole_{mode}_field" in text


class TestTholeKernels:
    def _system(self):
        params, state, cfg, thermo = systems.mof_h2_gcmc(
            n_side=4, n_h2=8, capacity=16, polarization=True,
            dtype="float32")
        return params, state, cfg

    def test_charge_field_matches_jnp(self):
        from mpmc_tpu.ops import thole
        from mpmc_tpu.ops.pallas import thole_kernel as tk
        params, state, cfg = self._system()
        alive = state.atom_alive(params)
        rc = pairs.derived_cutoff(state.box, cfg)
        e_jnp = thole.static_field_direct(state.pos, state.box, alive,
                                          params, cfg)
        e_pal = tk.charge_field(
            state.pos, state.box, alive, params.charge, params.mol_id,
            rc, jnp.asarray(cfg.polar_damp, jnp.float32),
            cfg.polar_damp_type, interpret=True)
        np.testing.assert_allclose(np.asarray(e_pal), np.asarray(e_jnp),
                                   rtol=2e-4, atol=2e-6)

    def test_dipole_field_matches_jnp(self):
        from mpmc_tpu.ops import thole
        from mpmc_tpu.ops.pallas import thole_kernel as tk
        params, state, cfg = self._system()
        alive = state.atom_alive(params)
        pol_ok = alive & (params.polar > 0)
        rc = pairs.derived_cutoff(state.box, cfg)
        key = jax.random.PRNGKey(0)
        mu = jnp.where(pol_ok[:, None],
                       jax.random.normal(key, state.pos.shape,
                                         jnp.float32) * 0.05, 0.0)
        e_jnp = thole.dipole_matvec(state.pos, state.box, alive, params,
                                    cfg, mu)
        e_pal = tk.dipole_field(
            state.pos, state.box, pol_ok, mu, params.mol_id, rc,
            jnp.asarray(cfg.polar_damp, jnp.float32),
            cfg.polar_damp_type, interpret=True)
        np.testing.assert_allclose(np.asarray(e_pal), np.asarray(e_jnp),
                                   rtol=2e-4, atol=2e-6)


def test_thole_kernel_ortho_fast_path_exact():
    """cfg.ortho_box min-image in the Thole kernel: the per-pair
    displacements are bit-identical on a diagonal box (IEEE
    x + 0.0 == x), so the summed fields may differ only by the
    reassociation of the tile reduction."""
    from mpmc_tpu.ops.pallas import thole_kernel as tk
    params, state, cfg, thermo = systems.mof_h2_gcmc(
        n_side=4, n_h2=8, capacity=16, polarization=True,
        dtype="float32")
    alive = state.atom_alive(params)
    pol_ok = alive & (params.polar > 0)
    rc = pairs.derived_cutoff(state.box, cfg)
    lam = jnp.asarray(cfg.polar_damp, jnp.float32)
    mu = jnp.where(pol_ok[:, None],
                   jax.random.normal(jax.random.PRNGKey(2),
                                     state.pos.shape, jnp.float32) * 0.05,
                   0.0)
    for fn, src, okr in ((tk.charge_field, params.charge, alive),
                         (tk.dipole_field, mu, pol_ok)):
        gen = fn(state.pos, state.box, okr, src, params.mol_id, rc, lam,
                 cfg.polar_damp_type, interpret=True, ortho=False)
        fast = fn(state.pos, state.box, okr, src, params.mol_id, rc, lam,
                  cfg.polar_damp_type, interpret=True, ortho=True)
        np.testing.assert_allclose(np.asarray(gen), np.asarray(fast),
                                   rtol=5e-7, atol=1e-9)


def test_thole_kernels_linear_damping():
    from mpmc_tpu.ops import thole
    from mpmc_tpu.ops.pallas import thole_kernel as tk
    params, state, cfg, thermo = systems.mof_h2_gcmc(
        n_side=4, n_h2=8, capacity=16, polarization=True, dtype="float32")
    cfg = dataclasses.replace(cfg, polar_damp_type="linear",
                              polar_damp=2.0)
    alive = state.atom_alive(params)
    rc = pairs.derived_cutoff(state.box, cfg)
    e_jnp = thole.static_field_direct(state.pos, state.box, alive, params,
                                      cfg)
    e_pal = tk.charge_field(
        state.pos, state.box, alive, params.charge, params.mol_id, rc,
        jnp.asarray(cfg.polar_damp, jnp.float32), cfg.polar_damp_type,
        interpret=True)
    np.testing.assert_allclose(np.asarray(e_pal), np.asarray(e_jnp),
                               rtol=2e-4, atol=2e-6)
