"""The shipped example decks must keep running (reduced step counts)."""
import io
import os

import numpy as np
import pytest

from mpmc_tpu.io import input_script
from mpmc_tpu.mc import run as run_mod

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")


def _shrunk(path, tmp_path, steps=600, corr=200, f64=True):
    text = open(path).read()
    out = []
    for line in text.splitlines():
        t = line.split()
        if t and t[0] == "numsteps":
            line = f"numsteps {steps}"
        elif t and t[0] == "corrtime":
            line = f"corrtime {corr}"
        elif t and t[0] in ("pqr_input",):
            line = f"pqr_input {os.path.join(EXAMPLES, os.path.basename(t[1]))}"
        elif t and t[0] in ("pqr_restart", "traj_output",
                            "histogram_output", "checkpoint_output",
                            "tmmc_output", "energy_output"):
            line = f"{t[0]} {tmp_path / os.path.basename(t[1])}"
        out.append(line)
    if f64:
        out.append("precision float64")
    return input_script.parse("\n".join(out))


def test_h2_sorption_deck(tmp_path):
    job = _shrunk(os.path.join(EXAMPLES, "h2_sorption.inp"), tmp_path)
    su, avgs = run_mod.run(job, log=io.StringIO())
    assert np.isfinite(avgs.mean("energy_total"))
    assert (tmp_path / "restart.pqr").exists()
    assert (tmp_path / "h2_density.dx").exists()


def test_h2_quantum_fk_deck(tmp_path):
    """The FK quantum deck runs AS SHIPPED (f32)."""
    job = _shrunk(os.path.join(EXAMPLES, "h2_quantum_fk.inp"), tmp_path,
                  f64=False)
    assert job.cfg.feynman_kleinert and not job.unknown_options
    log = io.StringIO()
    su, avgs = run_mod.run(job, log=log)
    assert np.isfinite(avgs.mean("energy_total"))
    assert (tmp_path / "restart.pqr").exists()


def test_h2_isotherm_ladder_deck(tmp_path):
    """The fugacity-ladder PT deck runs AS SHIPPED (f32)."""
    job = _shrunk(os.path.join(EXAMPLES, "h2_isotherm_ladder.inp"),
                  tmp_path, steps=800, corr=400, f64=False)
    assert job.pt_fugacity and not job.unknown_options
    log = io.StringIO()
    avgs = run_mod.run(job, log=log)
    assert "fugacity-ladder PT: 8 replicas" in log.getvalue()
    assert np.isfinite(avgs.mean("energy_total"))
    assert 0.0 <= avgs.mean("swap_acceptance") <= 1.0


def test_co2_n2_separation_deck(tmp_path):
    job = _shrunk(os.path.join(EXAMPLES, "co2_n2_separation.inp"),
                  tmp_path, steps=1000, corr=250)
    log = io.StringIO()
    run_mod.run(job, log=log)
    assert "N_CO2" in log.getvalue()


def test_h2_polar_tmmc_deck(tmp_path):
    """The r4 polar-GCMC + TMMC composition deck runs AS SHIPPED (f32):
    the delayed-acceptance filter screens, survivors pay the exact SCF, and the
    collection matrix records the DA estimator — one run, usable by
    `analyze tmmc`."""
    import json

    job = _shrunk(os.path.join(EXAMPLES, "h2_polar_tmmc.inp"), tmp_path,
                  f64=False)
    assert (job.cfg.polar_delayed and job.cfg.tmmc
            and job.cfg.polarization and not job.unknown_options)
    log = io.StringIO()
    su, avgs = run_mod.run(job, log=log)
    assert np.isfinite(avgs.mean("energy_total"))
    with open(tmp_path / "tmmc_polar.json") as f:
        rec = json.load(f)
    c = np.asarray(rec["c"])
    assert c[:, 0].sum() + c[:, 2].sum() > 100
    assert (c[:, 1] <= c[:, 0] + 1e-6).all()


def test_h2_polar_wolf_deck(tmp_path):
    """The r5 wolf-field polar deck runs AS SHIPPED (f32): delayed
    acceptance on the polar_wolf static field (the field-variant fast
    path of r4 verdict item 1)."""
    job = _shrunk(os.path.join(EXAMPLES, "h2_polar_wolf_gcmc.inp"),
                  tmp_path, steps=300, corr=150, f64=False)
    assert job.cfg.polar_wolf and job.cfg.polar_delayed
    assert not job.unknown_options
    log = io.StringIO()
    su, avgs = run_mod.run(job, log=log)
    assert np.isfinite(avgs.mean("energy_total"))


def test_h2_polar_cutoff_deck(tmp_path):
    """The explicit-cutoff polar deck runs AS SHIPPED (f32): the
    tile-culled SCF matvec gate accepts it (polar_cull auto + explicit
    cutoff + ortho + CG — the kernel route engages it on a GPU) and the
    scan-path delayed acceptance runs."""
    import dataclasses

    from mpmc_tpu.ops import thole

    job = _shrunk(os.path.join(EXAMPLES, "h2_polar_cutoff_gcmc.inp"),
                  tmp_path, steps=300, corr=150, f64=False)
    assert job.cfg.cutoff == 6.0 and job.cfg.polar_cull == "auto"
    assert job.cfg.polar_delayed and not job.unknown_options
    # ortho_box is detected from the basis at run time (mc/run.py)
    assert thole.cull_supported(
        dataclasses.replace(job.cfg, ortho_box=True))
    log = io.StringIO()
    su, avgs = run_mod.run(job, log=log)
    assert su.cfg.ortho_box
    assert np.isfinite(avgs.mean("energy_total"))
    assert avgs.count() == 2
