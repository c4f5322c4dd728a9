"""ctypes bridge to the native C++ runtime (libbwbble_native.so).

The native library provides the host-side heavy lifting the reference does in
C/C++ (mg-aligner/is.c SA-IS, bwt.c index construction, io.c packing): SA-IS
suffix-array construction, BWT/occ/SA-sample builds, and 4-bit packing.  It is
built from native/ via `python -m bwbble_tpu_torch.build_native` (or the Makefile)
and loaded lazily; every caller has a numpy fallback so the pure-Python path
stays functional.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

_lock = threading.Lock()
_native = None
_tried = False


def _lib_candidates():
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(here)
    for d in (os.path.join(here, "_lib"), os.path.join(root, "native", "build"), root):
        yield os.path.join(d, "libbwbble_native.so")


class _Native:
    def __init__(self, lib: ctypes.CDLL):
        self._has_calc_d = hasattr(lib, "bwbble_calc_d_multiref")
        self._has_gold = hasattr(lib, "bwbble_gold_align_multiref")
        if self._has_gold:
            lib.bwbble_gold_align_multiref.argtypes = [
                ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int8),
                ctypes.POINTER(ctypes.c_int8),
                ctypes.c_int64, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_int64)]
            lib.bwbble_gold_align_multiref.restype = ctypes.c_int64
        if self._has_calc_d:
            lib.bwbble_calc_d_multiref.argtypes = [
                ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
                ctypes.POINTER(ctypes.c_int8), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64)]
            lib.bwbble_calc_d_multiref.restype = ctypes.c_int
        # fused-rank-row variants (one 128-byte row per block replaces ~5
        # scattered cache lines per rank query; FMIndex.fused_planes)
        self._has_fused = (self._has_gold and self._has_calc_d
                           and hasattr(lib, "bwbble_gold_align_multiref_f")
                           and hasattr(lib, "bwbble_calc_d_multiref_f"))
        if self._has_fused:
            lib.bwbble_gold_align_multiref_f.argtypes = (
                list(lib.bwbble_gold_align_multiref.argtypes)
                + [ctypes.POINTER(ctypes.c_uint64)])
            lib.bwbble_gold_align_multiref_f.restype = ctypes.c_int64
            lib.bwbble_calc_d_multiref_f.argtypes = (
                list(lib.bwbble_calc_d_multiref.argtypes)
                + [ctypes.POINTER(ctypes.c_uint64)])
            lib.bwbble_calc_d_multiref_f.restype = ctypes.c_int
        self._lib = lib
        lib.bwbble_sais_u8.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64]
        lib.bwbble_sais_u8.restype = ctypes.c_int
        lib.bwbble_build_occ.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
        lib.bwbble_build_occ.restype = None
        self._has_pre_scan = hasattr(lib, "bwbble_pre_scan")
        if self._has_pre_scan:
            lib.bwbble_pre_scan.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                ctypes.c_int64, ctypes.POINTER(ctypes.c_int32)]
            lib.bwbble_pre_scan.restype = ctypes.c_int64
        self._has_fastq = hasattr(lib, "bwbble_fastq_scan")
        if self._has_fastq:
            lib.bwbble_fastq_scan.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64)]
            lib.bwbble_fastq_scan.restype = ctypes.c_int64
            lib.bwbble_fastq_fill.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_int8),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64)]
            lib.bwbble_fastq_fill.restype = ctypes.c_int

    def suffix_array(self, seq: np.ndarray) -> np.ndarray:
        seq = np.ascontiguousarray(seq, dtype=np.uint8)
        n = seq.shape[0]
        out = np.empty(n, dtype=np.int64)
        rc = self._lib.bwbble_sais_u8(
            seq.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_int64(n))
        if rc != 0:
            raise RuntimeError(f"native SA-IS failed with code {rc}")
        return out

    def build_occ(self, bwt: np.ndarray, sa0: int, interval: int) -> np.ndarray:
        """Occurrence checkpoints [num_occ, 16], inclusive at k*interval,
        skipping the sa0 sentinel row (compute_O, bwt.c:280-291)."""
        bwt = np.ascontiguousarray(bwt, dtype=np.uint8)
        n = bwt.shape[0]
        num_occ = (n + interval - 1) // interval
        out = np.zeros((num_occ, 16), dtype=np.int64)
        self._lib.bwbble_build_occ(
            bwt.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_int64(n), ctypes.c_int64(sa0), ctypes.c_int64(interval),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        return out


    def calc_d_multiref(self, planes: np.ndarray, occ: np.ndarray,
                        Carr: np.ndarray, length: int, sa0: int,
                        interval: int, nucl_bases: np.ndarray,
                        read: np.ndarray, read_len: int,
                        fused: np.ndarray | None = None
                        ) -> np.ndarray | None:
        """Unbounded-interval-list D bounds for one read (the reference's
        calculate_d, inexact_match.c:171-254); None if the library predates
        the function.  planes: uint64 [4, nwords] BWT bit planes; fused:
        optional FMIndex.fused_planes() rank rows (same results, ~fewer
        cache misses per rank query)."""
        if not self._has_calc_d:
            return None
        D = np.zeros((read_len + 1, 2), dtype=np.int64)
        read = np.ascontiguousarray(read[:read_len], dtype=np.int8)
        args = [
            planes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            ctypes.c_int64(planes.shape[1]),
            occ.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            Carr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_int64(length), ctypes.c_int64(sa0),
            ctypes.c_int64(interval),
            nucl_bases.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_int(nucl_bases.shape[1]),
            read.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            ctypes.c_int64(read_len),
            D.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))]
        if fused is not None and self._has_fused:
            rc = self._lib.bwbble_calc_d_multiref_f(
                *args,
                fused.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
        else:
            rc = self._lib.bwbble_calc_d_multiref(*args)
        if rc != 0:
            raise RuntimeError(f"native calc_d failed with code {rc}")
        return D

    def gold_align_multiref(self, planes, occ, Carr, length, sa0, interval,
                            tables, pp, seq, rc, read_len, cap=4096,
                            stats: dict | None = None, fused=None):
        """Native bounded DFS for one read (the gold engine's
        inexact_match); returns (meta int64 [n,8], paths uint8 [n,256]) or
        None when unsupported / capacity exceeded (caller falls back to
        the Python gold engine).  fused: optional FMIndex.fused_planes()
        rank rows (same results, fewer cache misses per rank query)."""
        if not self._has_gold:
            return None
        meta = np.zeros((cap, 8), dtype=np.int64)
        paths = np.zeros((cap, 256), dtype=np.uint8)
        pops = np.zeros(1, dtype=np.int64)
        seq = np.ascontiguousarray(seq[:read_len], dtype=np.int8)
        rc = np.ascontiguousarray(rc[:read_len], dtype=np.int8)
        args = [
            planes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            ctypes.c_int64(planes.shape[1]),
            occ.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            Carr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_int64(length), ctypes.c_int64(sa0),
            ctypes.c_int64(interval),
            tables.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            pp.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            seq.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            rc.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            ctypes.c_int64(read_len), ctypes.c_int64(cap),
            meta.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            paths.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            pops.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))]
        if fused is not None and self._has_fused:
            n = self._lib.bwbble_gold_align_multiref_f(
                *args,
                fused.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
        else:
            n = self._lib.bwbble_gold_align_multiref(*args)
        if stats is not None:
            stats["pops"] = int(pops[0])
        if n < 0:
            return None
        return meta[:n], paths[:n]

    def pre_scan(self, data: np.ndarray, n: int) -> np.ndarray | None:
        """Per-entry interval counts of a `.pre` file's variable-size records
        (the sequential walk in load_precalc_sa_intervals, align.c:226-238);
        None if unsupported, raises on truncated input."""
        if not self._has_pre_scan:
            return None
        data = np.ascontiguousarray(data, dtype=np.uint8)
        cnt = np.empty(n, dtype=np.int32)
        got = self._lib.bwbble_pre_scan(
            data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_int64(data.shape[0]), ctypes.c_int64(n),
            cnt.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        if got != n:
            raise ValueError(f".pre file truncated (decoded {got} of {n})")
        return cnt

    def parse_fastq(self, data: bytes):
        """Two-pass FASTQ parse into fixed-shape nt4 batches; returns
        (seq, rc, lengths, name_off, name_len, qual_off) or None if the
        library predates the parser or the input is malformed (the caller
        falls back to the Python parser for proper error reporting)."""
        if not self._has_fastq:
            return None
        buf = np.frombuffer(data, dtype=np.uint8)
        n = buf.shape[0]
        ml = ctypes.c_int64(0)
        p = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        count = self._lib.bwbble_fastq_scan(p, n, ctypes.byref(ml))
        if count < 0:
            return None
        count, max_len = int(count), int(ml.value)
        seq = np.full((count, max_len), 4, dtype=np.int8)
        rc = np.full((count, max_len), 4, dtype=np.int8)
        lengths = np.zeros(count, dtype=np.int32)
        name_off = np.zeros(count, dtype=np.int64)
        name_len = np.zeros(count, dtype=np.int64)
        qual_off = np.zeros(count, dtype=np.int64)
        rcode = self._lib.bwbble_fastq_fill(
            p, n, count, max_len,
            seq.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            rc.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            name_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            name_len.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            qual_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        if rcode != 0:
            return None
        return seq, rc, lengths, name_off, name_len, qual_off


def get_native():
    """Return the native bridge, or None if the library isn't built."""
    global _native, _tried
    if _native is not None or _tried:
        return _native
    with _lock:
        if _native is None and not _tried:
            for path in _lib_candidates():
                if os.path.exists(path):
                    try:
                        _native = _Native(ctypes.CDLL(path))
                        break
                    except OSError:
                        continue
            _tried = True
    return _native
