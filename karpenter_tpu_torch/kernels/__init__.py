"""Hand-written CUDA kernels and their wrappers: the pack (K1 feasibility,
K2 pack_scan, K3 sparsify), the delta solve (K4 recredit), the
consolidation proposers (K5 globalpack, K6 score_subsets, K7 anneal) and
the per-pod pack (K1 over the pods, K8 perpod_pack). Each wrapper launches
its kernel for CUDA tensors and runs its plain PyTorch version for CPU
tensors."""
