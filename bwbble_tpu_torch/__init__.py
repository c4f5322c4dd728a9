"""bwbble_tpu_torch — the PyTorch/CUDA port of the bwbble multi-genome
short-read aligner (BWT/FM-index alignment against an IUPAC-widened SNP
reference plus indel "bubbles").

The package mirrors the layout of the JAX package it is ported from, module
for module, so each counterpart is found under the same name:

- host side (Python + C++): the sequence/file-format codecs (`.ann`, `.ref`,
  `.bwt`, `.aln`, SAM), SA-IS index construction and the gold search engine
  are copies of the JAX-free modules, byte-compatible by construction;
- device side (`engine/`): the device FM-index (int32, and the int64
  whole-genome layout), batched rank ops, interval lists, D bounds, exact
  search, the inexact search (fixed batches and the ring queue) and the
  alignment pipeline as plain functions on torch tensors with an explicit
  `device` argument (None means CUDA; without a CUDA device the entry points
  raise, they never carry on on the CPU by themselves);
- `benchmarks/`: the row-fetch probes the kernel design rests on;
- `csrc/`: hand-written CUDA C++ kernels, built at first use with nvcc and
  bound through ctypes (`engine/kernel.py`, `benchmarks/kernels.py`).

Nothing here imports jax or the JAX package.
"""

__version__ = "0.1.0"

from bwbble_tpu_torch.align.params import AlnParams  # noqa: F401
