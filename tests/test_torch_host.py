"""Host-side modules of the port: each copied module differs from its
bwbble_tpu original only in the package name, and the copied codecs, index
construction and gold engine produce the same bytes.  Tolerance: zero (bytes)."""

import inspect
import os
import re

import numpy as np
import pytest

from bwbble_tpu import testutil as j_testutil
from bwbble_tpu.align.params import AlnParams as JParams
from bwbble_tpu.align.pipeline import align_reads_gold as j_align_gold
from bwbble_tpu.formats.aln import write_aln_file as j_write_aln
from bwbble_tpu.formats.fasta import fasta2ref as j_fasta2ref
from bwbble_tpu.formats.fastq import read_fastq as j_read_fastq
from bwbble_tpu.index import FMIndex as JFMIndex
from bwbble_tpu.parallel import distributed as j_dist

from bwbble_tpu_torch import cli
from bwbble_tpu_torch.formats.aln import read_aln_file
from bwbble_tpu_torch.parallel import distributed as t_dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

COPIED = [
    "constants.py", "align/params.py", "align/eval.py", "align/evaluate.py",
    "align/pipeline.py", "align/__init__.py", "formats/__init__.py",
    "formats/fasta.py", "formats/fastq.py", "formats/aln.py",
    "formats/sam.py", "native.py",
    "build_native.py", "index/__init__.py", "index/suffix_array.py",
    "index/fmindex.py", "gold/__init__.py", "gold/engine.py", "testutil.py",
    "__main__.py",
]


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_differs_only_in_package_name(rel):
    with open(os.path.join(ROOT, "bwbble_tpu", rel)) as f:
        orig = f.read()
    with open(os.path.join(ROOT, "bwbble_tpu_torch", rel)) as f:
        copy = f.read()
    assert re.sub(r"\bbwbble_tpu\b", "bwbble_tpu_torch", orig) == copy


# parallel/distributed.py: the host functions are copies; `init` differs
# (torch.distributed in place of jax.distributed)
DIST_COPIED = ["shard_bounds", "shard_reads", "part_path", "write_part",
               "merge_parts"]


@pytest.mark.parametrize("name", DIST_COPIED)
def test_copied_distributed_function_differs_only_in_package_name(name):
    orig = inspect.getsource(getattr(j_dist, name))
    copy = inspect.getsource(getattr(t_dist, name))
    assert re.sub(r"\bbwbble_tpu\b", "bwbble_tpu_torch", orig) == copy


def test_index_and_gold_align_round_trip_bytes(tmp_path):
    """`index` + `align --engine gold` through the port's CLI give the same
    .ref/.ann/.bwt/.aln bytes as the JAX package's host modules."""
    fa = str(tmp_path / "w.fa")
    fq = str(tmp_path / "w.fq")
    j_testutil.random_genome_fasta(fa, {"21": 20_000}, seed=5,
                                   iupac_frac=0.004)
    j_testutil.simulate_reads_fastq(fa, fq, 24, read_len=40, num_mm=1,
                                    seed=6)
    assert cli.main(["index", fa]) == 0
    assert cli.main(["align", "-n", "2", "--engine", "gold", fa, fq,
                     str(tmp_path / "t.aln")]) == 0

    jfa = str(tmp_path / "j.fa")
    with open(fa, "rb") as f, open(jfa, "wb") as g:
        g.write(f.read())
    codes, _ = j_fasta2ref(jfa, jfa + ".ref", jfa + ".ann")
    jidx = JFMIndex.build(codes)
    jidx.store(jfa + ".bwt")
    j_write_aln(str(tmp_path / "j.aln"),
                j_align_gold(jidx, j_read_fastq(fq), JParams(max_diff=2)))
    for ext in (".ref", ".ann", ".bwt"):
        with open(fa + ext, "rb") as f, open(jfa + ext, "rb") as g:
            assert f.read() == g.read(), ext
    with open(tmp_path / "t.aln", "rb") as f, \
            open(tmp_path / "j.aln", "rb") as g:
        data = f.read()
        assert data == g.read()
    assert sum(1 for a in read_aln_file(str(tmp_path / "t.aln")) if a) > 0
