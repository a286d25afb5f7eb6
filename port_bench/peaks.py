"""The published peak of the card the benchmark runs on that its
rooflines use: the HBM3 bandwidth of NVIDIA's data sheet of the H100 SXM,
at its 700 W power limit (a card set lower may run below it)."""

H100_HBM_BYTES_PER_S = 3.35e12
