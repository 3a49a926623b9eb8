"""The port's hand-written kernels (CUDA C++ under ``csrc/``), each with
its plain PyTorch version, its wrapper and its launch counter.  Nothing is
built or loaded at import: ``build.load()`` compiles at first launch."""
