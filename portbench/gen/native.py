"""g++ builds of the benchmark's frozen native tools (`sais.cpp`,
`mgref.cpp`), each into a fixed directory named by its source's hash, so
that a checkout builds each once and a changed source builds anew."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

HERE = os.path.dirname(os.path.abspath(__file__))


def _build(src_name: str, build_dir: str, shared: bool) -> str:
    src = os.path.join(HERE, src_name)
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    stem = os.path.splitext(src_name)[0]
    out = os.path.join(build_dir, f"{stem}_{digest}" + (".so" if shared
                                                        else ""))
    if os.path.exists(out):
        return out
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-std=c++17", src, "-o", tmp]
    if shared:
        cmd[3:3] = ["-shared", "-fPIC"]
    subprocess.run(cmd, check=True)
    os.replace(tmp, out)
    return out


def mgref(build_dir: str) -> str:
    """Path of the mg-ref multi-call binary (data_prep, comb)."""
    return _build("mgref.cpp", build_dir, shared=False)


class Sais:
    """The SA-IS suffix sorter and the occurrence-checkpoint builder."""

    def __init__(self, build_dir: str):
        lib = ctypes.CDLL(_build("sais.cpp", build_dir, shared=True))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.bwbble_sais_u8.argtypes = [u8p, i64p, ctypes.c_int64]
        lib.bwbble_sais_u8.restype = ctypes.c_int
        lib.bwbble_build_occ.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64,
                                         ctypes.c_int64, i64p]
        lib.bwbble_build_occ.restype = None
        self._lib = lib

    def suffix_array(self, seq):
        import numpy as np
        seq = np.ascontiguousarray(seq, dtype=np.uint8)
        out = np.empty(seq.shape[0], dtype=np.int64)
        rc = self._lib.bwbble_sais_u8(
            seq.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_int64(seq.shape[0]))
        if rc != 0:
            raise RuntimeError(f"SA-IS failed with code {rc}")
        return out

    def build_occ(self, bwt, sa0: int, interval: int):
        import numpy as np
        bwt = np.ascontiguousarray(bwt, dtype=np.uint8)
        n = bwt.shape[0]
        out = np.zeros((-(-n // interval), 16), dtype=np.int64)
        self._lib.bwbble_build_occ(
            bwt.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_int64(n), ctypes.c_int64(sa0), ctypes.c_int64(interval),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        return out
