"""Nothing the harness or the reference loads is JAX or the JAX package;
the reference loads nothing of the program either (top-level module
names, compared whole: the port's name begins with the JAX package's)."""

import json
import os
import subprocess
import sys

REF = """
import json, os, sys
from portbench import check, world
w = world.ensure({"kind": "single", "chrom": "chr1", "genome_bp": 20000,
                  "genome_seed": 3, "repeat_frac": 0.0, "repeat_block": 500,
                  "repeat_mut_rate": 0.05}, os.path.join(ROOT, ".cache"))
from portbench.gen import donor, reads
haps = donor.haplotypes(w, {"vcf_sample": "S1", "mut_rate": 0.001,
                            "indel_frac": 0.15, "indel_extend": 0.3,
                            "seed": 1})
pool = reads.make_pool(haps, {"read_len": 60, "error_rate": 0.01,
                              "reverse_share": 0.5}, 1, 1, 4)
out = check.reference_records(w.bwt, {"max_diff": 2, "is_multiref": False},
                              [pool[0, i].tobytes() for i in range(4)], 2)
assert len(out) == 4 and all(out)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_reference_loads_neither_jax_nor_the_program(checkout):
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    r = subprocess.run([sys.executable, "-c", REF.replace("ROOT", repr(
        os.path.join(checkout, "portbench")))], cwd=checkout,
        capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    top = set(json.loads(r.stdout.strip().splitlines()[-1]))
    assert not top & {"jax", "jaxlib", "flax", "bwbble_tpu",
                      "bwbble_tpu_torch", "torch"}


def test_harness_without_the_program_prints_no_result(tmp_path):
    import shutil
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    shutil.copytree(os.path.join(repo, "portbench"),
                    os.path.join(tmp_path, "portbench"),
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(os.path.join(repo, "BENCHMARK.json"), tmp_path)
    code = ("from portbench import run; run.run_cell('microbe5m_single.wgsim',"
            " 1, 1.0, False, device='cpu')")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode != 0
    assert not any(ln.startswith("{") for ln in r.stdout.splitlines())
