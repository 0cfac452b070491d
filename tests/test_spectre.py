"""SPECTRE free-charge treatment (SURVEY §2 "SPECTRE" [M]; documented
contract in mc/spectre.py)."""
import io

import numpy as np
import pytest

from mpmc_tpu.io import input_script
from mpmc_tpu.mc import run as run_mod
from mpmc_tpu.mc import spectre as spectre_mod


def test_renormalize_clamps_and_rescales():
    q = np.array([0.0, 2.0, -3.0, 0.4, 1.0])
    idx = np.array([1, 2, 3])
    out = spectre_mod.renormalize_charges(q, idx, max_charge=1.0,
                                          max_target=0.0)
    np.testing.assert_allclose(out, [0.0, 1.0, -1.0, 0.4, 1.0])
    # with a target the set is rescaled onto sum|q| = target
    out = spectre_mod.renormalize_charges(q, idx, max_charge=5.0,
                                          max_target=2.7)
    assert np.sum(np.abs(out[idx])) == pytest.approx(2.7)
    np.testing.assert_allclose(out[[0, 4]], [0.0, 1.0])   # untouched
    # signs preserved
    assert out[1] > 0 and out[2] < 0


def _spectre_deck(tmp_path, max_charge=0.5, target=0.0):
    pqr = tmp_path / "sp.pqr"
    # two framework charges + two mobile spectre charges (flag S)
    pqr.write_text(
        "ATOM 1 FW FRZ 1 F 2.0 2.0 2.0 40.0 0.5 0.0 50.0 3.0\n"
        "ATOM 2 FW FRZ 1 F 10.0 10.0 10.0 40.0 -0.5 0.0 50.0 3.0\n"
        "ATOM 3 SP SPC 2 S 5.0 5.0 5.0 10.0 0.9 0.0 20.0 3.0\n"
        "ATOM 4 SP SPC 3 S 8.0 8.0 8.0 10.0 -0.9 0.0 20.0 3.0\n"
        "END\n")
    extra = f"spectre_max_target {target}\n" if target else ""
    return input_script.parse(f"""
ensemble nvt
numsteps 300
corrtime 100
temperature 200
basis1 14 0 0
basis2 0 14 0
basis3 0 0 14
precision float64
rd_lrc off
spectre on
spectre_max_charge {max_charge}
{extra}
pqr_input {pqr}
""")


def test_parse_options(tmp_path):
    job = _spectre_deck(tmp_path, max_charge=0.25, target=1.5)
    assert job.cfg.spectre
    assert job.cfg.spectre_max_charge == 0.25
    assert job.cfg.spectre_max_target == 1.5


def test_run_renormalizes_and_reports(tmp_path):
    job = _spectre_deck(tmp_path, max_charge=0.5)
    log = io.StringIO()
    _, avgs = run_mod.run(job, log=log)
    assert "spectre_total_charge" in avgs.samples
    # |q| starts at 0.9 and must be clamped to 0.5 from the first
    # corrtime on
    assert max(avgs.samples["spectre_max_abs_charge"]) <= 0.5 + 1e-12
    assert "spectre: 2 free-charge sites" in log.getvalue()


def test_run_with_target_rescale(tmp_path):
    job = _spectre_deck(tmp_path, max_charge=2.0, target=1.0)
    log = io.StringIO()
    _, avgs = run_mod.run(job, log=log)
    np.testing.assert_allclose(avgs.samples["spectre_total_charge"], 1.0)


