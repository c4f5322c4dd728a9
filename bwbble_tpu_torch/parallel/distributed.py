"""Multi-process alignment runtime (torch.distributed).

Counterpart of bwbble_tpu/parallel/distributed.py.  The reference saturates
one node with OpenMP threads over an embarrassingly-parallel read loop
(inexact_match.c:92-168, the -t flag).  The multi-process analog is one
process per host (or several on one card): reads shard contiguously across
processes (the FM-index is replicated; a process's own devices compose via
the --mesh path), each process aligns its shard through the normal
pipeline, and results merge deterministically: `.aln` files are headerless
sequences of per-read records (formats/aln.py), so concatenating the
contiguous shard parts in process-rank order is byte-identical to a
single-process run.  No collective runs inside the hot loop (data
parallelism over reads never needs one); torch.distributed supplies process
identity and startup coordination only.

Wire format of the rendezvous: each process writes `<out>.part<rank>`
atomically (tmp + rename); rank 0 waits for all parts and concatenates.
This survives processes finishing in any order and needs only the shared
filesystem the reference pipeline already assumes for its stage files.
"""

from __future__ import annotations

import os
import time


def init(coordinator: str, num_processes: int, process_id: int) -> None:
    """Join the process group (idempotent): gloo over TCP, rank 0 binding
    the port of `coordinator` ("host:port")."""
    import torch.distributed as dist
    if dist.is_initialized():
        return
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def shard_bounds(n: int, num_processes: int, rank: int) -> tuple[int, int]:
    """Contiguous balanced [lo, hi) read range for `rank` (the first
    n % p shards carry one extra read)."""
    base, extra = divmod(n, num_processes)
    lo = rank * base + min(rank, extra)
    return lo, lo + base + (1 if rank < extra else 0)


def shard_reads(reads, num_processes: int, rank: int):
    """Slice a Reads batch to this process's contiguous shard."""
    from bwbble_tpu_torch.formats.fastq import Reads
    lo, hi = shard_bounds(reads.count, num_processes, rank)
    return Reads(names=reads.names[lo:hi], seq=reads.seq[lo:hi],
                 rc=reads.rc[lo:hi], qual=reads.qual[lo:hi],
                 lengths=reads.lengths[lo:hi])


def part_path(out_path: str, rank: int) -> str:
    return f"{out_path}.part{rank}"


def write_part(out_path: str, rank: int, data: bytes) -> None:
    """Atomic part write (tmp + rename) so rank 0's wait loop never sees
    a half-written file."""
    p = part_path(out_path, rank)
    tmp = p + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, p)


def merge_parts(out_path: str, num_processes: int,
                timeout_s: float = 600.0) -> None:
    """Rank 0: wait for every part and concatenate them in rank order
    (byte-identical to the single-process `.aln` because records are
    per-read and shards are contiguous in read order)."""
    deadline = time.time() + timeout_s
    paths = [part_path(out_path, r) for r in range(num_processes)]
    while True:
        if all(os.path.exists(p) for p in paths):
            break
        if time.time() > deadline:
            missing = [p for p in paths if not os.path.exists(p)]
            raise TimeoutError(f"distributed merge: missing parts {missing}")
        time.sleep(0.05)
    tmp = out_path + ".tmp"
    with open(tmp, "wb") as out:
        for p in paths:
            with open(p, "rb") as f:
                out.write(f.read())
    os.replace(tmp, out_path)
    for p in paths:
        os.remove(p)
