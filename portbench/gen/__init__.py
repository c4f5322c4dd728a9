"""Frozen generators of the benchmark's worlds and reads.

Copies, kept with the benchmark, of the program's synthetic-world code
(`bwbble_tpu_torch/testutil.py`, `worlds.py`, the `.bwt` build of
`index/fmindex.py` and `formats/fasta.py`, the SA-IS and mg-ref tools of
`native/`), so that a change to the program never changes what the
benchmark measures it on.  The read simulator is vectorised; its draws
follow the traffic files under `portbench/traffic/`.
"""
