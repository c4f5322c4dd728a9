"""The world of a configuration (its genome and `.bwt`), built once into a
fixed directory of the checkout, `portbench/.cache/world-<key>`, where the
key is the hash of the configuration's `world` section: configurations
that name the same world share it.  A world is built under a temporary
name and renamed when whole, so a run that is cut leaves no half world.

Kinds: `multi_genome` (a genome with diverged repeats and a synthetic VCF
folded in by mg-ref's `data_prep` and `comb`, as `worlds.chr21_world`) and
`single` (a genome of the same generator, indexed as it is).  The world
keeps its plain genome, `genome.fa`, and its VCF, `variants.vcf`, from
which the donor of the reads is made (`gen/donor.py`)."""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import subprocess
import time

from portbench.gen import genome as gen_genome
from portbench.gen import native as gen_native
from portbench.gen.index import build_bwt

VERSION = 2     # of the frozen generators: a new version builds anew


@dataclasses.dataclass
class World:
    path: str
    genome_fa: str
    bwt: str
    vcf: str | None     # the population's variants, where the world has them
    built_s: dict       # seconds of each step, when this run built it


def key_of(world: dict) -> str:
    text = json.dumps({"version": VERSION, "world": world}, sort_keys=True)
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def ensure(world: dict, cache_root: str, log=lambda msg: None) -> World:
    """The world described by `world`, built if it is not in the cache."""
    final = os.path.join(cache_root, f"world-{key_of(world)}")
    built: dict = {}
    if not os.path.exists(os.path.join(final, "ref.bwt")):
        tmp = f"{final}.building"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        _build(world, tmp, os.path.join(cache_root, "build"), built, log)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
    vcf = os.path.join(final, "variants.vcf")
    return World(path=final, genome_fa=os.path.join(final, "genome.fa"),
                 bwt=os.path.join(final, "ref.bwt"),
                 vcf=vcf if os.path.exists(vcf) else None, built_s=built)


def _step(built: dict, name: str, log, fn, *args, **kw) -> None:
    t = time.perf_counter()
    fn(*args, **kw)
    built[name] = time.perf_counter() - t
    log(f"world: {name} {built[name]:.1f} s")


def _build(w: dict, d: str, build_dir: str, built: dict, log) -> None:
    fa = os.path.join(d, "genome.fa")
    kind = w["kind"]
    if kind not in ("single", "multi_genome"):
        raise ValueError(f"unknown world kind {kind!r}")
    _step(built, "genome", log, gen_genome.random_genome_with_repeats_fasta,
          fa, w["chrom"], int(w["genome_bp"]), seed=int(w["genome_seed"]),
          repeat_frac=float(w["repeat_frac"]), block=int(w["repeat_block"]),
          mut_rate=float(w["repeat_mut_rate"]))
    indexed = fa
    if kind == "multi_genome":
        vcf = os.path.join(d, "variants.vcf")
        _step(built, "vcf", log, gen_genome.synthetic_vcf, fa, vcf,
              snp_rate=float(w["snp_rate"]),
              indel_rate=float(w["indel_rate"]), seed=int(w["vcf_seed"]))
        indexed = os.path.join(d, "mg_bubble.fa")

        def fold():
            exe = gen_native.mgref(build_dir)
            os.makedirs(os.path.join(d, "mg-ref-output"), exist_ok=True)
            subprocess.run([exe, "data_prep", "-c", vcf], check=True, cwd=d,
                           stdout=subprocess.DEVNULL)
            subprocess.run([exe, "comb", "-w", str(int(w["comb_width"])), fa,
                            os.path.join(d, "mg.fa"), indexed,
                            os.path.join(d, "bubble.data")],
                           check=True, cwd=d, stdout=subprocess.DEVNULL)
        _step(built, "fold", log, fold)
    _step(built, "index", log, build_bwt, indexed,
          os.path.join(d, "ref.bwt"), build_dir)
    # the plain genome and the VCF (the donor's sources), and the index
    for name in os.listdir(d):
        if name not in ("genome.fa", "variants.vcf", "ref.bwt"):
            p = os.path.join(d, name)
            shutil.rmtree(p) if os.path.isdir(p) else os.remove(p)
