"""Dense transformer model in plain PyTorch, compiled by ``stitched_jit``."""
