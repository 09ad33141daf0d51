"""Measurement, data and scale tools of the port, run on a CUDA device (the
data tools and ``--gen-only`` on the host alone)."""
