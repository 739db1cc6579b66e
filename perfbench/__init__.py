"""The benchmark of afp_tpu_torch: one cell per run, driven by data
(`perfbench/README.md`)."""
