"""Hand-written CUDA kernels (``csrc/``), their plain versions and
oracles (``ref``), and the model-facing switch (``ops``).  The generated
kernels live in ``core.codegen``."""
