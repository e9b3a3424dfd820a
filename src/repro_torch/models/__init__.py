"""Dense transformer model in PyTorch, compiled by ``stitched_jit``."""
