"""The benchmark of the PyTorch/CUDA port, `bwbble_tpu_torch`: one run of
one cell is `python3 -m portbench.run` (see README.md)."""
