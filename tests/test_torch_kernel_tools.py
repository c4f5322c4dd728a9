"""The kernel tools under tools/, checked on the CPU where they can be: the
phase probes of tools/kernel_phases.py are spliced into the search kernel's
source at exact lines of it, so each anchor must be found once in the
current source (an edit of the kernel that breaks the tool shows here, not
first on a card), and every tool refuses to run without a CUDA device."""

import os
import sys

import pytest
import torch

from bwbble_tpu_torch.engine import kernel

TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")
sys.path.insert(0, TOOLS)

import kernel_ab  # noqa: E402
import kernel_phases  # noqa: E402
import paths_ab  # noqa: E402
import probes_ab  # noqa: E402


def test_phase_probes_find_their_anchors_in_the_kernel_source():
    with open(os.path.join(kernel.CSRC, "ring_search.cu")) as f:
        src = f.read()
    traced = kernel_phases.trace_source(src)
    for anchor, text, _after in kernel_phases._PROBES:
        assert src.count(anchor) == 1
        assert text in traced
    for k in range(len(kernel_phases.PHASES)):
        assert f"PH({k});" in traced


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA device is "
                    "present: the tools would run")
@pytest.mark.parametrize("run", [
    lambda tmp: kernel_ab.main(["a.cu", "--workdir", tmp]),
    lambda tmp: kernel_phases.main(["--workdir", tmp]),
    lambda tmp: paths_ab.run_one(paths_ab.HERE, tmp, "0T"),
    lambda tmp: probes_ab.main(["a.cu"]),
], ids=["kernel_ab", "kernel_phases", "paths_ab", "probes_ab"])
def test_tools_refuse_to_run_without_a_card(run, tmp_path):
    with pytest.raises(RuntimeError, match="CUDA device only"):
        run(str(tmp_path))
