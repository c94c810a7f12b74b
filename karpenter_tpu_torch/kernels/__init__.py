"""Hand-written CUDA kernels of the pack (K1 feasibility, K2 pack_scan,
K3 sparsify) and of the delta solve (K4 recredit), and their wrappers. Each
wrapper launches its kernel for CUDA tensors and runs its plain PyTorch
version for CPU tensors."""
