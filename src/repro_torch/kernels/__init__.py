"""Plain PyTorch oracles (the generated kernels live in ``core.codegen``)."""
