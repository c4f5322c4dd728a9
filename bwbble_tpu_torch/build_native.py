"""Build the native C++ runtime: `python -m bwbble_tpu_torch.build_native`."""

from __future__ import annotations

import os
import subprocess
import sys


def build(verbose: bool = True) -> str:
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(here)
    out_dir = os.path.join(root, "native", "build")
    os.makedirs(out_dir, exist_ok=True)

    src = os.path.join(root, "native", "bwbble_native.cpp")
    out = os.path.join(out_dir, "libbwbble_native.so")
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-march=native",
           src, "-o", out]
    if verbose:
        print(" ".join(cmd))
    subprocess.run(cmd, check=True)

    # mg-ref toolchain: one multi-call binary + the three tool names
    mgref_src = os.path.join(root, "native", "mgref.cpp")
    mgref = os.path.join(out_dir, "mgref")
    cmd = ["g++", "-O3", "-std=c++17", mgref_src, "-o", mgref]
    if verbose:
        print(" ".join(cmd))
    subprocess.run(cmd, check=True)
    for tool in ("data_prep", "comb", "sam_pad"):
        link = os.path.join(out_dir, tool)
        if not os.path.exists(link):
            os.symlink("mgref", link)
    return out


if __name__ == "__main__":
    path = build()
    print(f"built {path}")
    sys.exit(0)
