"""The benchmark of conjugategradient_tpu_torch: time to tolerance of CG
solves on the card, one cell a run (``python3 -m cgbench.run``; README.md)."""
