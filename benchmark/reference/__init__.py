"""The plain reference the benchmark judges the program's answers against.

Plain Python and NumPy only: it imports nothing of `karpenter_tpu_torch`,
`karpenter_tpu` or `jax`, and takes nothing the program made. It reads the
benchmark's own generated inputs (`catalog.table`, the pod specs of
`benchmark.inputs`) and, to judge them, the program's answers as plain
data (pod keys, instance-type names, zone values)."""
