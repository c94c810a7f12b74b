"""The benchmark of `karpenter_tpu_torch`: one cell run once per call of
`benchmark/run.py` (see `harness.main`)."""
