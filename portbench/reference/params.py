"""Alignment parameters.

Frozen copy of bwbble_tpu_torch/align/params.py for the plain reference.

Mirrors the reference's `aln_params_t` and its defaults
(mg-aligner/align.h:48-79, align.c:22-38) with the same CLI surface
(main.c:100-117), plus TPU-specific engine knobs that have no counterpart in
the reference (batch sizes, fixed capacities, index sharding).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class AlnParams:
    # scoring (align.c:23-25)
    mm_score: int = 3          # -M
    gapo_score: int = 11       # -O
    gape_score: int = 4        # -E

    # search budget (align.c:26-31)
    max_diff: int = 0          # -n
    max_gapo: int = 1          # -o
    max_gape: int = 6          # -e
    seed_length: int = 32      # -l
    max_diff_seed: int = 2     # -k
    max_entries: int = 3_000_000   # -m

    # heuristics (align.c:35-36)
    max_best: int = 30
    no_indel_length: int = 5

    # modes (align.c:32-34, 37)
    use_precalc: bool = False  # -P
    is_multiref: bool = True   # cleared by -S
    n_threads: int = 1         # -t (host-side; device engine batches instead)

    # --- TPU engine knobs (no reference counterpart) ---
    precalc_len: int = 12          # PRECALC_INTERVAL_LENGTH (align.h:31);
                                   # parameterized here so tests can exercise
                                   # the -P path with small tables
    batch_size: int = 2048         # reads per device batch
    exact_intv_cap: int = 16       # fixed capacity of per-lane SA-interval lists
    arena_cap: int = 32768         # per-lane arena rows (engine frames)
    use_int64: bool = False        # (hi,lo) index pairs for >2^31 genomes

    def score(self, num_mm: int, num_gapo: int, num_gape: int) -> int:
        """Alignment score (inexact_match.c:21-23)."""
        return (num_mm * self.mm_score + num_gapo * self.gapo_score
                + num_gape * self.gape_score)

    @property
    def num_score_buckets(self) -> int:
        """Max distinct score + 1 (heap bucket count, inexact_match.c:513)."""
        return self.score(self.max_diff + 1, self.max_gapo + 1, self.max_gape + 1)
