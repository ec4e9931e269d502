"""The design variants that `repro_torch.kernels.probe_variants` times on the
card still patch the tree's kernel sources, on the CPU.

Each variant is the tree's `csrc/common.cuh` and `csrc/<library>.cu` with
a few texts replaced; each text must occur exactly once, so an edit to a
kernel that the variants no longer match fails here, not in a chip run.
No CUDA, no JAX.
"""
import re

import pytest

from repro_torch.kernels import build, probe_variants

CASES = [(name, lib) for name, libs in probe_variants.VARIANTS.items()
         for lib in libs]


@pytest.mark.parametrize("name,lib", CASES)
def test_variant_patches_apply_once(name, lib):
    files = probe_variants.variant_sources(name, lib)
    assert set(files) == {"common.cuh", f"{lib}.cu"}
    for fname, patches in probe_variants.VARIANTS[name][lib].items():
        tree = (build.CSRC / fname).read_text()
        assert files[fname] != tree
        for old, new in patches:
            assert tree.count(old) == 1
            assert new in files[fname]


def test_variant_names_the_kernels_it_times():
    """`thread` launches its own kernel in place of the tile kernel, and
    the profiler pattern of the library names both."""
    src = probe_variants.variant_sources("thread", "dht_probe")["dht_probe.cu"]
    assert "lookup_thread_kernel<<<" in src
    assert "  lookup_kernel<<<" not in src
    pattern = probe_variants.KERNEL_RE["dht_probe"]
    assert re.search(pattern, "lookup_thread_kernel(unsigned int const*)")
    assert re.search(pattern, "(anonymous namespace)::lookup_kernel(x)")
    assert not re.search(pattern, "insert_count_kernel(x)")
