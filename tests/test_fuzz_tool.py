"""The corruption-fuzz campaign CLI stays wired (tools/fuzz.py).

The real campaigns run 10k-48k trials offline / in CI; this lane keeps
the tool importable and its replay contract working: a short campaign
over every family exits 0, a single-trial --only replay exits 0, and a
bad family selection exits 2.
"""

from go_dicom_codec_jax.tools import fuzz


def test_short_campaign_all_families(capsys):
    assert fuzz.main(["--trials", "30"]) == 0
    out = capsys.readouterr().out
    assert '"failures": 0' in out


def test_only_replay_single_trial(capsys):
    assert fuzz.main(["--only", "30795"]) == 0
    assert '"trials": 1' in capsys.readouterr().out


def test_no_families_selected(capsys):
    assert fuzz.main(["--trials", "5", "--families", "nope"]) == 2
