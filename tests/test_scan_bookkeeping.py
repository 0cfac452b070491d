"""The scan-path MC step across its configuration surface.

One parametrised test: each case runs a short chunk of the lax.scan
Metropolis step (metropolis.run_chunk) on a small float64 system and
asserts three things —

1. the carried per-move energy bookkeeping equals a fresh full
   ``metropolis.initialize`` of the final state, term by term;
2. the move counters and the occupancy stay within the slots (every
   step attempts exactly one move, accepts <= attempts, per-species
   counts within [0, capacity]);
3. a second run from the same state and seed is bit-identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpmc_tpu.mc import metropolis
from mpmc_tpu.models import systems

N_STEPS = 48


def _mof(**kw):
    return systems.mof_h2_gcmc(n_side=3, n_h2=4, capacity=8,
                               ewald_kmax=3, dtype="float64", **kw)


def _mix():
    return systems.mof_h2_ch4_gcmc(n_side=3, n_h2=3, n_ch4=3, capacity=6,
                                   ewald_kmax=3, dtype="float64")


def _lj():
    return systems.lj_fluid(n=32, dtype="float64")


def _rd_variant(rd):
    from mpmc_tpu.config import RunConfig, Thermo
    from mpmc_tpu.state import Species, build_system
    sp = Species(
        name="X", atom_names=("X",), pos=np.zeros((1, 3)),
        mass=np.array([20.0]), charge=np.array([0.1]),
        polar=np.zeros(1),
        eps=np.array([1.0e5 if rd == "disp_expansion" else 80.0]),
        sig=np.array([1.9 if rd == "disp_expansion" else 3.2]),
        c6=np.array([900.0]), c8=np.array([3000.0]),
        c10=np.array([9000.0]))
    cfg = RunConfig(ensemble="nvt", rd_potential=rd, coulomb="cutoff",
                    rd_lrc=False, dtype="float64", ortho_box=True)
    coms = np.random.default_rng(8).uniform(1.0, 15.0, (12, 3))
    params, state = build_system(
        np.eye(3) * 16.0, species=(sp,), capacity=(12,),
        initial_counts=(12,), initial_pos={0: coms[:, None]},
        dtype=cfg.jdtype)
    thermo = Thermo.make(temperature=200.0, move_factor=0.5,
                         n_species=1, dtype=cfg.jdtype)
    return params, state, cfg, thermo


# case id -> (system builder, RunConfig overrides, Thermo overrides)
_POLAR = dict(polar_precision=1e-10, polar_max_iter=200)
CASES = {
    # NVT on the H2 framework, each electrostatics path
    "nvt-es-none": (_mof, dict(ensemble="nvt", coulomb="none"), {}),
    "nvt-es-cutoff": (_mof, dict(ensemble="nvt", coulomb="cutoff"), {}),
    "nvt-es-wolf": (_mof, dict(ensemble="nvt", coulomb="wolf"), {}),
    "nvt-es-ewald": (_mof, dict(ensemble="nvt"), {}),
    "nvt-es-ewald-mxu": (_mof, dict(ensemble="nvt", ewald_mxu=True), {}),
    "nvt-es-gwp": (_mof, dict(ensemble="nvt", coulomb="gwp"), {}),
    "nvt-cutoff-explicit": (_mof, dict(ensemble="nvt", cutoff=5.0), {}),
    "nvt-no-lrc": (_mof, dict(ensemble="nvt", rd_lrc=False), {}),
    "nvt-rd-none": (_mof, dict(ensemble="nvt", rd_potential="none"), {}),
    "nvt-overlap-reject": (_mof, dict(ensemble="nvt",
                                      cavity_autoreject_absolute=2.5), {}),
    "nvt-large-moves": (_mof, dict(ensemble="nvt"),
                        dict(move_factor=3.0)),
    "nvt-rotations-only": (_mof, dict(ensemble="nvt"),
                           dict(move_factor=0.0)),
    "nvt-mixing-wh": (_mof, dict(ensemble="nvt",
                                 mixing_rule="waldman_hagler"), {}),
    "nvt-pair-chunk": (_mof, dict(ensemble="nvt", pair_chunk=16), {}),
    "nvt-triclinic-flag": (_mof, dict(ensemble="nvt", ortho_box=False), {}),
    "nvt-fh2": (_mof, dict(ensemble="nvt", feynman_hibbs=True), {}),
    "nvt-fh4": (_mof, dict(ensemble="nvt", feynman_hibbs=True,
                           feynman_hibbs_order=4), {}),
    "nvt-fk": (_mof, dict(ensemble="nvt", feynman_kleinert=True), {}),
    "nvt-mol-cache": (_mof, dict(ensemble="nvt", mol_cache=True), {}),
    "nvt-cell-list": (_mof, dict(ensemble="nvt", cutoff=4.5,
                                 cell_list=True), {}),
    "nvt-spinflip": (_mof, dict(ensemble="nvt", quantum_rotation=True),
                     dict(spinflip_probability=0.3)),
    "nvt-lj-fluid": (_lj, {}, {}),
    "nvt-lj-fluid-no-lrc": (_lj, dict(rd_lrc=False), {}),
    "nvt-lj-fluid-mol-cache": (_lj, dict(mol_cache=True), {}),
    "nvt-rd-sg": (lambda: _rd_variant("sg"), {}, {}),
    "nvt-rd-dreiding": (lambda: _rd_variant("dreiding"), {}, {}),
    "nvt-rd-b14_7": (lambda: _rd_variant("b14_7"), {}, {}),
    "nvt-rd-disp_expansion": (lambda: _rd_variant("disp_expansion"),
                              {}, {}),
    "nvt-rd-disp_expansion-lrc": (lambda: _rd_variant("disp_expansion"),
                                  dict(rd_lrc=True), {}),
    "nvt-rd-disp_expansion-undamped": (
        lambda: _rd_variant("disp_expansion"),
        dict(damp_dispersion=False), {}),
    # NVE (Ray's microcanonical rule)
    "nve-es-none": (_mof, dict(ensemble="nve", coulomb="none"),
                    dict(nve_energy=500.0)),
    "nve-es-ewald": (_mof, dict(ensemble="nve"), dict(nve_energy=500.0)),
    "nve-lj-fluid": (_lj, dict(ensemble="nve"), dict(nve_energy=0.0)),
    # µVT (GCMC) on the H2 framework
    "uvt-es-none": (_mof, dict(coulomb="none"), {}),
    "uvt-es-cutoff": (_mof, dict(coulomb="cutoff"), {}),
    "uvt-es-wolf": (_mof, dict(coulomb="wolf"), {}),
    "uvt-es-ewald": (_mof, {}, {}),
    "uvt-es-ewald-mxu": (_mof, dict(ewald_mxu=True), {}),
    "uvt-es-gwp": (_mof, dict(coulomb="gwp"), {}),
    "uvt-high-fugacity": (_mof, {}, dict(fugacity=[50.0])),
    "uvt-low-fugacity": (_mof, {}, dict(fugacity=[1e-3])),
    "uvt-insert-heavy": (_mof, {}, dict(insert_probability=0.9)),
    "uvt-overlap-insert": (_mof, dict(cavity_autoreject_absolute=2.5),
                           {}),
    "uvt-cavity-bias": (_mof, dict(cavity_bias=True, cavity_grid=4,
                                   cavity_radius=1.5), {}),
    "uvt-fh2": (_mof, dict(feynman_hibbs=True), {}),
    "uvt-fk": (_mof, dict(feynman_kleinert=True), {}),
    "uvt-mol-cache": (_mof, dict(mol_cache=True), {}),
    "uvt-spinflip": (_mof, dict(quantum_rotation=True),
                     dict(spinflip_probability=0.3)),
    "uvt-tmmc": (_mof, dict(tmmc=True), {}),
    "uvt-tmmc-bias": (_mof, dict(tmmc=True, tmmc_bias=True), {}),
    "uvt-multisorbate-wolf": (_mix, dict(coulomb="wolf"), {}),
    "uvt-multisorbate-ewald": (_mix, {}, {}),
    "uvt-multisorbate-none": (_mix, dict(coulomb="none"), {}),
    "uvt-lj-fluid": (_lj, dict(ensemble="uvt", insert_species=(0,)),
                     dict(insert_probability=0.5, fugacity=[5.0])),
    # NPT (volume moves rescale everything)
    "npt-es-none": (_mof, dict(ensemble="npt", coulomb="none"),
                    dict(volume_probability=0.2, pressure=50.0)),
    "npt-es-ewald": (_mof, dict(ensemble="npt"),
                     dict(volume_probability=0.2, pressure=50.0)),
    "npt-lj-fluid": (_lj, dict(ensemble="npt"),
                     dict(volume_probability=0.2, pressure=50.0)),
    "npt-es-wolf": (_mof, dict(ensemble="npt", coulomb="wolf"),
                    dict(volume_probability=0.2, pressure=50.0)),
    # polarization (Thole SCF) through the jnp reference
    "nvt-polar-direct": (lambda: _mof(polarization=True),
                         dict(ensemble="nvt", **_POLAR), {}),
    "uvt-polar-direct": (lambda: _mof(polarization=True), dict(**_POLAR),
                         {}),
    "uvt-polar-wolf": (lambda: _mof(polarization=True),
                       dict(polar_wolf=True, **_POLAR), {}),
    "uvt-polar-ewald": (lambda: _mof(polarization=True),
                        dict(polar_ewald=True, **_POLAR), {}),
    "uvt-polar-delayed": (lambda: _mof(polarization=True),
                          dict(polar_delayed=True, **_POLAR), {}),
    "uvt-polar-delayed-wolf": (lambda: _mof(polarization=True),
                               dict(polar_delayed=True, polar_wolf=True,
                                    **_POLAR), {}),
    "uvt-polar-delayed-tmmc": (lambda: _mof(polarization=True),
                               dict(polar_delayed=True, tmmc=True,
                                    **_POLAR), {}),
    "uvt-polar-dipole-rule": (lambda: _mof(polarization=True),
                              dict(polar_precision_mode="dipole",
                                   polar_precision=1e-9,
                                   polar_max_iter=200), {}),
    "uvt-polar-cutoff": (lambda: _mof(polarization=True),
                         dict(cutoff=5.0, **_POLAR), {}),
    "nvt-polar-linear-damping": (lambda: _mof(polarization=True),
                                 dict(ensemble="nvt",
                                      polar_damp_type="linear",
                                      polar_damp=2.0, **_POLAR), {}),
}


def _build(case):
    builder, cfg_kw, th_kw = CASES[case]
    params, state, cfg, thermo = builder()
    cfg = dataclasses.replace(cfg, **cfg_kw)
    if th_kw:
        kw = {k: (jnp.asarray(v, cfg.jdtype) if k != "fugacity"
                  else jnp.asarray(v, cfg.jdtype)) for k, v in th_kw.items()}
        thermo = thermo.replace(**kw)
    if cfg.quantum_rotation:
        # a fixed per-molecule (F_para, F_ortho) table: the spinflip
        # move reads it, the per-corrtime eigensolve refresh is the
        # driver's job (mc/run.py)
        m = int(params.n_mols_max)
        state = state.replace(
            spin=jnp.asarray(np.arange(m) % 2, jnp.int32),
            rot_f=jnp.asarray(np.tile([0.0, 15.0], (m, 1)), cfg.jdtype))
    if cfg.cell_list:
        from mpmc_tpu.ops import celllist
        params = celllist.attach(params, state.pos, state.box, cfg,
                                 min_reduction=None)
    return params, state, cfg, thermo


def _counts(st, params, n_species):
    return [int(st.n_molecules_of(params, s)) for s in range(n_species)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_scan_path_bookkeeping(case):
    params, state, cfg, thermo = _build(case)
    st0 = metropolis.initialize(state, params, cfg, thermo)
    st1, stats = metropolis.run_chunk(st0, params, cfg, thermo, N_STEPS)

    # 1. carried energy == fresh recompute of the final configuration
    fresh = metropolis.initialize(st1, params, cfg, thermo)
    tol = 1e-6 if cfg.polarization else 1e-8
    for name in ("rd", "lrc", "es_real", "es_recip", "es_self", "es_excl",
                 "polar", "vdw"):
        a = float(getattr(st1.energy, name))
        b = float(getattr(fresh.energy, name))
        assert a == pytest.approx(b, rel=tol, abs=tol * 10), (case, name)
    assert np.isfinite(float(st1.energy.total))

    # 2. counters and occupancy within the slots
    att = np.asarray(stats.attempts)
    acc = np.asarray(stats.accepts)
    assert att.sum() == N_STEPS
    assert (acc >= 0).all() and (acc <= att).all()
    n_species = int(params.n_species) if hasattr(params, "n_species") \
        else len(thermo.fugacity)
    cap = [int(np.sum(np.asarray(params.mol_species) == s))
           for s in range(n_species)]
    for n, c in zip(_counts(st1, params, n_species), cap):
        assert 0 <= n <= c, (case, n, c)
    assert int(st1.step) == int(st0.step) + N_STEPS

    # 3. same seed, same state -> the identical trajectory
    st2, stats2 = metropolis.run_chunk(st0, params, cfg, thermo, N_STEPS)
    np.testing.assert_array_equal(np.asarray(st2.pos), np.asarray(st1.pos))
    np.testing.assert_array_equal(np.asarray(st2.mol_alive),
                                  np.asarray(st1.mol_alive))
    np.testing.assert_array_equal(np.asarray(stats2.accepts), acc)
    for a, b in zip(jax.tree_util.tree_leaves(st2.energy),
                    jax.tree_util.tree_leaves(st1.energy)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
