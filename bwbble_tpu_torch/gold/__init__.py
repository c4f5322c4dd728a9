"""Gold model: host-side reimplementation of the reference search semantics.

Replicates mg-aligner's exact/inexact search, D-bound computation, and result
evaluation bit-for-bit (including exploration order and quirks Q1/Q6), as:
- the correctness oracle for the TPU engines in bwbble_tpu_torch.engine;
- the overflow fallback when a read exceeds the device engines' fixed
  capacities (interval-list cap / search-arena cap).
"""
