"""Device operations: each hand-written CUDA kernel's wrapper beside its
plain PyTorch version (predict.py), and the kernels' build (_build.py)."""
