"""Device tensors and the grouped pack (plain PyTorch versions)."""
