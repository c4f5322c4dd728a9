"""The search kernel's source (csrc/ring_search.cu), compiled with g++
against csrc/warp_emu.h, a CPU stand-in for the warp intrinsics it uses,
and run on CPU tensors through the same C entry point the wrapper calls,
held against the plain PyTorch version (engine/inexact.py): every per-read
output, path, overflow reason and counter equal, tolerance zero, and for a
fixed batch `walk_paths` over its arena equal to its in-kernel walk.  This
checks the kernel's logic (warp-uniform control, the parallel push and
merge, shared-memory staging) without a card; it says nothing of speed."""

import ctypes
import dataclasses
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from bwbble_tpu_torch import worlds
from bwbble_tpu_torch.align.params import AlnParams
from bwbble_tpu_torch.align.precalc import build_precalc_gold, read_indices
from bwbble_tpu_torch.engine import kernel
from bwbble_tpu_torch.engine.device_index import from_fmindex
from bwbble_tpu_torch.engine.inexact import (EngineConfig, alloc_outputs,
                                             fixed_search_plain, result_dict,
                                             ring_search_plain, ring_statics,
                                             unpack_paths, walk_paths)
from bwbble_tpu_torch.gold.engine import calculate_d

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    """The kernel's source built for the CPU: the dynamic shared memory and
    the launch are the two lines that differ from a CUDA build."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("emu")
    with open(os.path.join(kernel.CSRC, "ring_search.cu")) as f:
        src = f.read()
    src = src.replace("#include <cuda_runtime.h>", '#include "warp_emu.h"')
    src = src.replace(
        "extern __shared__ __align__(16) unsigned char smem_raw[];",
        "unsigned char* smem_raw = emu_sm;")
    src, n = re.subn(r"kern<<<([^,]+), ([^,]+), ([^,]+), "
                     r"\(cudaStream_t\)stream>>>\(",
                     r"emu_launch(kern, \1, \2, \3, ", src)
    assert n == 1 and "emu_sm" in src
    cpp, so = str(d / "ring_emu.cpp"), str(d / "libring_emu.so")
    with open(cpp, "w") as f:
        f.write(src)
    r = subprocess.run(["g++", "-std=c++20", "-O1", "-fPIC", "-shared",
                        "-pthread", "-I", kernel.CSRC, "-o", so, cpp],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-3000:]
    lib = ctypes.CDLL(so)
    kernel._bind_ring_search(lib)
    return lib


def _emulated(lib, didx, rc, ln, D, Ds, params, cfg, lanes, seeds,
              events=(None, None)):
    """kernel._launch's work on CPU tensors, through the emulated build
    (`events`: the two event handles the launch records, or nulls); a
    range-sharded index (`didx.tp_tables`) goes in as its shards."""
    fixed = lanes is None
    x64 = didx.idt == torch.int64
    Q, Lmax = rc.shape
    S = ring_statics(params, cfg, Lmax, Ds.shape[1], fixed=fixed,
                     seed_slots=0 if seeds is None else seeds[0].shape[1],
                     x64=x64)
    lanes = Q if fixed else max(1, min(int(lanes), Q))
    assert kernel.block_smem_bytes(S) == lib.ring_search_lane_smem(
        S.NB, S.Lmax, S.DS, S.XC, int(x64), S.NFRAME)
    hp = kernel.param_block(params, S, Q, Lmax, int(didx.length), lanes)
    q_alns, q_meta, q_paths = alloc_outputs(Q, S, "cpu")
    arena = torch.full((lanes, S.NFRAME, S.ROWW), -7, dtype=torch.int32)
    counter = torch.zeros((1,), dtype=torch.int32)
    sp = [x.data_ptr() for x in seeds] if seeds is not None else [None] * 3
    ptrs, tp, nloc = kernel.shard_args(didx)
    rc_ = lib.ring_search_launch(
        hp.ctypes.data, hp.size, int(S.multiref), int(fixed), int(x64),
        ptrs.ctypes.data, tp, nloc, didx.Carr.data_ptr(), rc.data_ptr(),
        ln.data_ptr(), D.data_ptr(), Ds.data_ptr(), *sp, arena.data_ptr(),
        counter.data_ptr(), q_alns.data_ptr(), q_meta.data_ptr(),
        q_paths.data_ptr(), None, *events)
    assert rc_ == 0
    return dict(result_dict(q_alns, q_meta, q_paths), arena=arena), S


def _exact_d(idx, rd, params):
    sl = int(params.seed_length)
    D = np.zeros((rd.count, rd.max_len + 1, 2), dtype=np.int32)
    Ds = np.zeros((rd.count, sl + 1, 2), dtype=np.int32)
    for r in range(rd.count):
        n = int(rd.lengths[r])
        D[r, :n + 1] = calculate_d(idx, rd.seq[r], n, params)
        if n > sl:
            Ds[r] = calculate_d(idx, rd.seq[r], sl, params)
    return D, Ds


P3 = AlnParams(max_diff=3, batch_size=128)
P3S = dataclasses.replace(P3, precalc_len=4, use_precalc=True)
PS = AlnParams(max_diff=3, batch_size=128, is_multiref=False)
CFG = EngineConfig(cap=4096, acap=24, kx=2, max_iters=20_000, xcap=128)
# small capacities: list, ACAP, work and frame overflows
TIGHT = EngineConfig(cap=400, acap=3, kx=2, max_iters=300, xcap=2)
# more frames a read than shared memory keeps parents of: the walk reads
# the arena
WIDE = EngineConfig(cap=65536, acap=24, kx=2, max_iters=20_000, xcap=128)

# (name, world, params, cfg, lanes or None, seeded, int64)
CASES = [
    ("ring", "mixed", P3, CFG, 4, False, False),
    ("fixed", "mixed", P3, CFG, None, False, False),
    ("seeded ring", "mixed", P3S, CFG, 4, True, False),
    ("seeded fixed int64", "mixed", P3S, CFG, None, True, True),
    ("tight fixed", "mixed", P3, TIGHT, None, False, False),
    ("fixed, parents from the arena", "mixed", P3, WIDE, None, False, False),
    ("single ring", "single", PS, EngineConfig(cap=4096, kx=4), 4, False,
     False),
    ("single fixed int64", "single", PS, EngineConfig(cap=4096, kx=4), None,
     False, True),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_emulated_kernel_equals_plain_version(emu_lib, case):
    _name, world, p, cfg, lanes, seeded, x64 = case
    make = worlds.mixed_world if world == "mixed" else \
        worlds.single_genome_world
    idx, rd = make(n_reads=8)
    didx = from_fmindex(idx, use_int64=x64, device="cpu")
    it = didx.idt
    D, Ds = _exact_d(idx, rd, p)
    a = [torch.from_numpy(np.asarray(rd.rc, dtype=np.int8)),
         torch.from_numpy(rd.lengths.astype(np.int32)),
         torch.from_numpy(D).to(it), torch.from_numpy(Ds).to(it)]
    sd = None
    if seeded:
        table = build_precalc_gold(idx, AlnParams(), k=4)
        ri = read_indices(np.asarray(rd.rc, dtype=np.int8),
                          rd.lengths.astype(np.int32), k=4)
        sL, sU, scnt, _ = table.lookup_batch(ri, 8)
        sd = (torch.from_numpy(sL.astype(np.int64)).to(it),
              torch.from_numpy(sU.astype(np.int64)).to(it),
              torch.from_numpy(scnt.astype(np.int32)))
    got, S = _emulated(emu_lib, didx, *a, p, cfg, lanes, sd)
    assert (S.NFRAME > kernel.PAR_MAX) == (cfg is WIDE)
    if lanes is None:
        ref = fixed_search_plain(didx, *a, p, cfg, sd)
    else:
        ref = ring_search_plain(didx, *a, p, cfg, rd.count, sd)
    bad = [k for k, v in ref.items() if k not in ("o_lane", "arena")
           and not torch.equal(v.to(torch.int64), got[k].to(torch.int64))]
    assert not bad
    assert int(got["pops"].sum()) > 0
    if lanes is None:
        live = torch.arange(S.ACAP)[None, :] < got["n_alns"][:, None]
        li, si = live.nonzero(as_tuple=True)
        w = walk_paths(got["arena"], li, got["o_node"][li, si],
                       nroot=S.NROOT, nslot=S.NSLOT, nc=S.NC,
                       pathcap=S.PATHCAP, nw=S.NW).numpy()
        inker = unpack_paths(got["paths"].numpy(), S.PATHCAP)
        assert (w == inker[li.numpy(), si.numpy()]).all()


@pytest.mark.parametrize("events", [(None, None), (1, 2)],
                         ids=["null handles", "two handles"])
def test_launch_records_its_events_right_around_the_kernel(emu_lib, events):
    """`ring_search_launch` records the first event right before the
    kernel's launch and the second right after it, in C (nothing of the
    caller between them), and takes null handles as no record."""
    idx, rd = worlds.mixed_world(n_reads=4)
    didx = from_fmindex(idx, device="cpu")
    D, Ds = _exact_d(idx, rd, P3)
    a = [torch.from_numpy(np.asarray(rd.rc, dtype=np.int8)),
         torch.from_numpy(rd.lengths.astype(np.int32)),
         torch.from_numpy(D), torch.from_numpy(Ds)]
    emu_lib.emu_trace.restype = ctypes.c_char_p
    before = emu_lib.emu_trace().decode()
    got, _S = _emulated(emu_lib, didx, *a, P3, CFG, None, None, events)
    trace = emu_lib.emu_trace().decode()[len(before):]
    assert trace == ("k" if events[0] is None else "r1kr2")
    ref = fixed_search_plain(didx, *a, P3, CFG, None)
    assert torch.equal(ref["n_alns"].to(torch.int64),
                       got["n_alns"].to(torch.int64))
