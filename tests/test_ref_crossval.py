"""Cross-validation vs the LITERAL reference implementation.

Each test drives framework code and reference code (imported or
source-slice-exec'd from /root/reference by tools/ref_crossval.py) with
identical injected random draws and asserts every row of the section's
deviation table stays within its documented bound: parity claims
measured against the reference's own math, not against the repo
oracles.

The full sweep (incl. the long microsound e2e modes) lives in
`python tools/ref_crossval.py`; here every section runs with its default
(CI-sized) configs.
"""
import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import ref_crossval as rc  # noqa: E402


def _assert_rows(rows):
    assert rows, "section produced no rows"
    bad = [r for r in rows if not r.ok]
    assert not bad, "\n".join(
        f"{r.name}: {r.dev_dbfs:.1f} dBFS (bound {r.bound}) {r.note}"
        for r in bad)


def test_microsound_kernels_vs_reference():
    _assert_rows(rc.crossval_microsound_kernels())


@pytest.mark.parametrize("mode", ["Gaussian click", "Noise burst",
                                  "Wavelet atoms"])
def test_microsound_e2e_vs_reference(mode):
    _assert_rows(rc.crossval_microsound_e2e(modes=[mode]))


def test_tape_vs_reference():
    _assert_rows(rc.crossval_tape())


def test_scrub_vs_reference():
    _assert_rows(rc.crossval_scrub())


def test_patternlab_vs_reference():
    _assert_rows(rc.crossval_patternlab())


def test_grid_vs_reference():
    _assert_rows(rc.crossval_grid())


def test_forestfire_vs_reference():
    _assert_rows(rc.crossval_forestfire())
