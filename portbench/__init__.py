"""The benchmark of `linemod_tpu_torch` (see README.md)."""
