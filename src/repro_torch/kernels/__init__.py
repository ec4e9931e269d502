"""Hand-written CUDA kernels, their plain PyTorch versions and the dispatch.

`ops` is the one entry point: a CUDA tensor launches the kernel built from
`csrc/` (see `build`), a CPU tensor takes the plain version in `ref`.
"""
