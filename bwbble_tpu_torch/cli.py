"""`bwbble` command-line interface of the PyTorch/CUDA port.

Counterpart of bwbble_tpu/cli.py: subcommands `index`, `fasta2ref`, `align`,
`aln2sam` and `eval` with the reference's single-letter flags and positional
arguments (mg-aligner/main.c:72-160) and the same derived file names
(`<fasta>.{ref,ann,bwt,pre}`).  Engine options are long options only
(--engine, --batch, --arena, --queued, --device, --mesh, --dist), so every
reference invocation works verbatim.  `-P` reads the seed table
`<fasta>.pre`, built at first use on the `--device` given (on the host with
`--engine gold`).  `--mesh DP[,TP]` spreads the run over a grid of devices
(parallel/shard.py: every CUDA device, or DP*TP copies of `--device cpu`);
`--dist HOST:PORT,NPROCS,RANK` over processes (parallel/distributed.py).

Run as `python -m bwbble_tpu_torch ...`.
"""

from __future__ import annotations

import getopt
import sys
import time

import numpy as np


def _usage() -> int:
    print("Usage:   bwbble command [options]")
    print("Command: index    index sequences in the FASTA format")
    print("         align    exact or inexact read alignment")
    print("         fasta2ref    constructs a single linear reference "
          "from the input file")
    print("         aln2sam  convert alignment results to SAM file format "
          "for single-end mapping")
    return 1


def read_external_sa(path: str, n: int) -> np.ndarray:
    """Stream a 40-bit/entry external suffix array (eSAIS format) into the
    (n+1)-row full SA expected by FMIndex.build (esa2bwt, bwt.c:132-158):
    row 0 is the virtual total-'$' (value n), rows 1..n come from the file."""
    raw = np.fromfile(path, dtype=np.uint8)
    if raw.shape[0] < 5 * n:
        raise ValueError(f"external SA file {path} too short: "
                         f"{raw.shape[0]} bytes < {5 * n}")
    raw = raw[:5 * n].reshape(n, 5).astype(np.int64)
    vals = (raw[:, 0] | (raw[:, 1] << 8) | (raw[:, 2] << 16)
            | (raw[:, 3] << 24) | (raw[:, 4] << 32))
    return np.concatenate([np.array([n], dtype=np.int64), vals])


def cmd_index(argv: list[str]) -> int:
    from bwbble_tpu_torch.formats.fasta import fasta2ref, read_ref
    from bwbble_tpu_torch.index.fmindex import FMIndex

    try:
        opts, args = getopt.getopt(argv, "e:")
    except getopt.GetoptError as e:
        print(e)
        return 1
    if not args:
        print("Usage: bwbble index [options] <seq_fasta>")
        print("Options: e    file with the SA precomputed by the external "
              "memory eSAIS algorithm.")
        return 1
    esa = dict(opts).get("-e")
    fasta = args[0]
    print("**** BWT Index ****")
    t = time.time()
    if esa is None:
        codes, _ann = fasta2ref(fasta, fasta + ".ref", fasta + ".ann")
        idx = FMIndex.build(codes)
    else:
        codes = read_ref(fasta + ".ref")
        idx = FMIndex.build(codes, full_sa=read_external_sa(
            esa, codes.shape[0]))
    print(f"Total BWT construction time: {time.time() - t:.2f} sec")
    idx.store(fasta + ".bwt")
    return 0


def cmd_fasta2ref(argv: list[str]) -> int:
    from bwbble_tpu_torch.formats.fasta import fasta2ref
    if not argv:
        print("Usage: bwbble fasta2ref <seq_fasta>")
        return 1
    fasta2ref(argv[0], argv[0] + ".ref", argv[0] + ".ann")
    return 0


def cmd_align(argv: list[str]) -> int:
    from bwbble_tpu_torch.align.params import AlnParams
    from bwbble_tpu_torch.align.pipeline import align_reads_gold
    from bwbble_tpu_torch.formats.aln import write_aln_file
    from bwbble_tpu_torch.formats.fastq import read_fastq
    from bwbble_tpu_torch.index.fmindex import FMIndex

    long_opts = ["engine=", "batch=", "arena=", "queued", "device=",
                 "mesh=", "dist="]
    try:
        opts, args = getopt.gnu_getopt(argv, "M:O:E:n:k:o:e:l:m:t:SP",
                                       long_opts)
    except getopt.GetoptError as e:
        print(e)
        return 1
    if len(args) < 3:
        print("Usage: bwbble align [options] <seq_fasta> <reads_fastq> "
              "<output_aln>")
        return 1
    kw: dict = {}
    engine = "device"
    batch = None
    arena = None
    queued = False
    device = None
    mesh_spec = None
    dist_spec = None
    flag_kw = {"-M": "mm_score", "-O": "gapo_score", "-E": "gape_score",
               "-n": "max_diff", "-k": "max_diff_seed", "-o": "max_gapo",
               "-e": "max_gape", "-l": "seed_length", "-m": "max_entries",
               "-t": "n_threads"}
    for o, v in opts:
        if o in flag_kw:
            kw[flag_kw[o]] = int(v)
        elif o == "-S":
            kw["is_multiref"] = False
        elif o == "-P":
            kw["use_precalc"] = True
        elif o == "--engine":
            engine = v
        elif o == "--batch":
            batch = int(v)
        elif o == "--arena":
            arena = int(v)
        elif o == "--queued":
            queued = True
        elif o == "--device":
            device = v
        elif o == "--mesh":
            mesh_spec = v
        elif o == "--dist":
            # --dist HOST:PORT,NPROCS,RANK — multi-process data parallelism
            # over reads (parallel/distributed.py); run one process per
            # host with the same command line except RANK
            dist_spec = v
    fasta, fastq, alnf = args[0], args[1], args[2]
    if batch is not None:
        kw["batch_size"] = batch
    params = AlnParams(**kw)

    print("**** BWBBLE Read Alignment ****")
    t = time.time()
    idx = FMIndex.load(fasta + ".bwt", load_sa=False)
    print(f"Total BWT loading time: {time.time() - t:.2f} sec")
    t = time.time()
    reads = read_fastq(fastq)
    print(f"Total read loading time: {time.time() - t:.2f} sec")

    dist_rank, dist_n = 0, 1
    if dist_spec is not None:
        from bwbble_tpu_torch.parallel import distributed as DX
        coord, n_s, r_s = dist_spec.rsplit(",", 2)
        dist_n, dist_rank = int(n_s), int(r_s)
        DX.init(coord, dist_n, dist_rank)
        reads = DX.shard_reads(reads, dist_n, dist_rank)
        print(f"dist: process {dist_rank}/{dist_n} aligning "
              f"{reads.count} reads")

    precalc = None
    if params.use_precalc:
        from bwbble_tpu_torch.align.precalc import load_or_build_precalc
        t = time.time()
        precalc = load_or_build_precalc(idx, params, fasta + ".pre",
                                        engine=engine, device=device)
        print("Total pre-calculated intervals loading time: "
              f"{time.time() - t:.2f} sec")

    t = time.time()
    if engine == "gold":
        alns = align_reads_gold(idx, reads, params, precalc=precalc)
    else:
        from bwbble_tpu_torch.engine.device_index import from_fmindex
        from bwbble_tpu_torch.engine.inexact import EngineConfig
        from bwbble_tpu_torch.engine.pipeline import align_reads_device
        cfg = EngineConfig(cap=arena or int(params.arena_cap))
        mesh = None
        if mesh_spec is not None:
            # --mesh DP[,TP]: run the sharded pipeline over a device mesh
            # (dp = read data-parallelism, tp = index range-sharding);
            # output is byte-identical to single-device alignment
            import torch

            from bwbble_tpu_torch.parallel.shard import make_mesh
            parts = [int(x) for x in mesh_spec.split(",")]
            dp, tp = parts[0], parts[1] if len(parts) > 1 else 1
            host = device is not None and torch.device(device).type != "cuda"
            mesh = make_mesh(dp, tp, [device] * (dp * tp) if host else None)
        didx = from_fmindex(idx, device=device)
        st: dict = {}
        alns = align_reads_device(idx, didx, reads, params, cfg,
                                  precalc=precalc, queued=queued, mesh=mesh,
                                  device=device, stats=st)
        if st.get("gold_pool"):
            print(f"Gold pool: {st['gold_workers']} {st['gold_pool']}, "
                  f"started in {st['gold_pool_start_s']:.2f} sec")
    print(f"Total read alignment time: {time.time() - t:.2f} sec")
    if dist_spec is not None:
        from bwbble_tpu_torch.formats.aln import encode_alns
        DX.write_part(alnf, dist_rank,
                      b"".join(encode_alns(a) for a in alns))
        if dist_rank == 0:
            DX.merge_parts(alnf, dist_n)
    else:
        write_aln_file(alnf, alns)
    return 0


def device_sa_resolver(idx, device=None):
    """rows -> text positions through lockstep invPsi walks on the device
    (engine/rank.py:sa_resolve; reference hot path bwt.c:320-329), in the
    index's own layout (int64 from 2^31 positions).  `device` None means
    CUDA, and without one this raises: there is no fallback to the host
    loop."""
    import torch

    from bwbble_tpu_torch.engine.device_index import from_fmindex
    from bwbble_tpu_torch.engine.rank import sa_resolve
    didx = from_fmindex(idx, device=device)

    def resolve(rows):
        rows = np.asarray(rows, dtype=np.int64)
        if rows.shape[0] == 0:
            return rows
        out = sa_resolve(didx, torch.from_numpy(rows).to(didx.idt))
        return out.cpu().numpy().astype(np.int64)
    return resolve


def cmd_aln2sam(argv: list[str]) -> int:
    from bwbble_tpu_torch.align.pipeline import alns_to_sam
    from bwbble_tpu_torch.formats.aln import read_aln_file
    from bwbble_tpu_torch.formats.fasta import read_ann
    from bwbble_tpu_torch.formats.fastq import read_fastq
    from bwbble_tpu_torch.index.fmindex import FMIndex

    try:
        opts, args = getopt.gnu_getopt(argv, "n:So", ["device="])
    except getopt.GetoptError as e:
        print(e)
        return 1
    if len(args) < 4:
        print("Usage: bwbble aln2sam [-S, -n] <seq_fasta> <reads_fastq> "
              "<alns_aln> <out_sam>")
        return 1
    max_diff = 6
    device = None
    for o, v in opts:
        if o == "-n":
            max_diff = int(v)
        elif o == "--device":
            device = v
    fasta, fastq, alnf, samf = args[:4]
    idx = FMIndex.load(fasta + ".bwt", load_sa=True)
    ann = read_ann(fasta + ".ann")
    reads = read_fastq(fastq)
    per_read = read_aln_file(alnf)
    # SA rows resolve on the device in one batch (`--device cpu`: the same
    # ops on CPU tensors)
    sam = alns_to_sam(idx, ann, reads, per_read, max_diff=max_diff,
                      sa_resolver=device_sa_resolver(idx, device))
    with open(samf, "w") as f:
        f.write(sam)
    return 0


def cmd_eval(argv: list[str]) -> int:
    """Simulation-truth evaluation (eval_alns, align.c:655-722; not exposed
    by the reference CLI)."""
    from bwbble_tpu_torch.align.evaluate import eval_alns
    from bwbble_tpu_torch.formats.aln import read_aln_file
    from bwbble_tpu_torch.formats.fastq import read_fastq
    from bwbble_tpu_torch.index.fmindex import FMIndex

    try:
        opts, args = getopt.gnu_getopt(argv, "n:S")
    except getopt.GetoptError as e:
        print(e)
        return 1
    if len(args) < 3:
        print("Usage: bwbble eval [-S, -n] <seq_fasta> <reads_fastq> "
              "<alns_aln>")
        return 1
    is_multiref, max_diff = True, 6
    for o, v in opts:
        if o == "-S":
            is_multiref = False
        elif o == "-n":
            max_diff = int(v)
    print("**** BWBBLE Alignment Evaluation ****")
    idx = FMIndex.load(args[0] + ".bwt", load_sa=True)
    reads = read_fastq(args[1])
    eval_alns(idx, reads, read_aln_file(args[2]), is_multiref=is_multiref,
              max_diff=max_diff)
    return 0


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        return _usage()
    cmd, rest = argv[0], argv[1:]
    if cmd == "index":
        return cmd_index(rest)
    if cmd == "align":
        return cmd_align(rest)
    if cmd == "fasta2ref":
        return cmd_fasta2ref(rest)
    if cmd == "aln2sam":
        return cmd_aln2sam(rest)
    if cmd == "eval":
        return cmd_eval(rest)
    print(f"Error: Unknown command '{cmd}'")
    return _usage()


if __name__ == "__main__":
    sys.exit(main())
