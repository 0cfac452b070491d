"""Card-only tests: the Thole Triton kernel as the GPU compiles it.

Marked ``gpu``: they skip on the CPU and run with
``MPMC_TEST_PLATFORM=gpu python -m pytest tests/ -m gpu``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpmc_tpu.models import systems
from mpmc_tpu.ops import pairs, route, thole

pytestmark = pytest.mark.gpu


def _polar(cutoff):
    params, state, cfg, thermo = systems.mof_h2_gcmc(
        n_side=8, n_h2=32, capacity=64, polarization=True,
        dtype="float32")
    return params, state, dataclasses.replace(cfg, cutoff=cutoff), thermo


def test_route_engages_kernel_on_gpu():
    _, _, cfg, _ = _polar(None)
    assert route.thole_kernel(cfg)
    assert not route.thole_kernel(dataclasses.replace(cfg,
                                                      dtype="float64"))


@pytest.mark.parametrize("cutoff", [None, 8.0])
def test_compiled_matvec_matches_f64_reference(cutoff):
    """Dense and culled compiled kernels against the jnp reference in
    float64: only the summation order differs, so the relative L2 error
    of the field stays at f32 rounding level; the culled kernel equals
    the dense one bit for bit."""
    from mpmc_tpu.ops.pallas import thole_kernel as tk
    params, state, cfg, _ = _polar(cutoff)
    alive = state.atom_alive(params)
    pol_ok = alive & (params.polar > 0)
    rc = pairs.derived_cutoff(state.box, cfg)
    lam = jnp.asarray(cfg.polar_damp, jnp.float32)
    mu = jnp.where(pol_ok[:, None], jax.random.normal(
        jax.random.PRNGKey(1), state.pos.shape, jnp.float32) * 0.05, 0.0)
    ref = thole.dipole_matvec(
        state.pos.astype(jnp.float64), state.box.astype(jnp.float64),
        alive, params, dataclasses.replace(cfg, dtype="float64"),
        mu.astype(jnp.float64))
    got = tk.dipole_field(state.pos, state.box, pol_ok, mu, params.mol_id,
                          rc, lam, cfg.polar_damp_type, ortho=True)
    ref = np.asarray(ref)
    err = np.linalg.norm(np.asarray(got, np.float64) - ref)
    assert err / np.linalg.norm(ref) <= 1e-5
    perm, _ = thole.cull_perm(state.pos, state.box, pol_ok, rc)
    pos_s, ok_s, _, mol_s = thole._sorted_sites(perm, state.pos, pol_ok,
                                                params)
    n_pad, _, _ = tk.grid_shape(pos_s.shape[0])
    visit = thole.cull_visit(pos_s, ok_s, state.box, rc, tk.BI, tk.BJ,
                             n_pad)
    dense = tk.dipole_field(pos_s, state.box, ok_s, mu[perm], mol_s, rc,
                            lam, cfg.polar_damp_type, ortho=True)
    culled = tk.dipole_field(pos_s, state.box, ok_s, mu[perm], mol_s, rc,
                             lam, cfg.polar_damp_type, ortho=True,
                             visit=visit)
    np.testing.assert_array_equal(np.asarray(dense), np.asarray(culled))


def test_compiled_solve_matches_plain_cg():
    """The culled CG on the card converges to the plain jnp CG's fixed
    point (both f32 on the GPU; the plain one forced through the jnp
    reference by a float64-free copy of the solve)."""
    params, state, cfg, _ = _polar(8.0)
    cfg = dataclasses.replace(cfg, polar_precision=1e-7,
                              polar_max_iter=200)
    alive = state.atom_alive(params)
    e0 = thole.static_field(state.pos, state.box, alive, params, cfg)
    mu_k, it_k, _ = thole.solve_scf(state.pos, state.box, alive, params,
                                    cfg, e0)
    cfg64 = dataclasses.replace(cfg, dtype="float64")
    e0_64 = thole.static_field(state.pos.astype(jnp.float64),
                               state.box.astype(jnp.float64), alive,
                               params, cfg64)
    mu_r, _, _ = thole.solve_scf(state.pos.astype(jnp.float64),
                                 state.box.astype(jnp.float64), alive,
                                 params, cfg64, e0_64)
    mu_r = np.asarray(mu_r)
    rel = (np.linalg.norm(np.asarray(mu_k, np.float64) - mu_r)
           / np.linalg.norm(mu_r))
    assert int(it_k) > 0 and rel < 1e-4
