"""The control (the plain reference with the seed's search budget one
lower, `-k 1`) comes out as not correct on every seed, in both of the
tiny cells' alphabets."""

import os

import pytest


@pytest.mark.parametrize("workload", ["tiny_mg.wgsim", "tiny_single.wgsim"])
@pytest.mark.parametrize("seed", [1, 2**31 + 7, 2**40 + 3])
def test_control_fails_the_comparison(checkout, workload, seed, monkeypatch):
    from portbench.control import control_reading
    monkeypatch.chdir(checkout)
    r = control_reading(workload, seed, n_calls=4,
                        root=os.path.join(checkout, "portbench"), workers=2)
    assert r["checked_reads"] > 0
    assert r["control_wrong_reads"] > 0
