"""Published peaks of the card the benchmark runs on (NVIDIA's data sheet,
H100 SXM, at its full power limit of 700 W)."""

H100_HBM_BYTES_S = 3.35e12
