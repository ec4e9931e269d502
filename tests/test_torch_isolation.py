"""The port stands alone and never hides the device or the kernel.

  * importing every `repro_torch` module pulls in neither `jax` nor the
    reference package `repro` (checked in a fresh interpreter);
  * `Local()` with no visible card and no device raises;
  * `kernels.ops` on CPU tensors takes the plain version and counts no
    kernel launch; an unknown backend raises.
Tolerance: exact (ops results equal the plain versions bit for bit).
"""
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.api import Local
from repro_torch.core import dht
from repro_torch.kernels import ops, ref

SRC = Path(repro_torch.__file__).resolve().parents[1]


def test_port_imports_no_jax_and_no_reference():
    names = sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))
    assert "repro_torch.kernels.ops" in names and len(names) > 15
    code = (
        "import importlib, sys\n"
        f"for n in {names!r}: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=SRC,
                         env={**os.environ, "PYTHONPATH": str(SRC)},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_local_without_card_or_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Local()
    assert Local(device="cpu").device.type == "cpu"


def _lane(rng, shape):
    return torch.from_numpy(
        rng.integers(0, 1 << 30, size=shape).astype(np.int32))


def test_ops_on_cpu_take_the_plain_version_and_count_nothing():
    ops.reset_launches()
    rng = np.random.default_rng(0)
    bases = torch.from_numpy(rng.integers(0, 5, size=(5, 40)).astype(
        np.uint8))
    lengths = torch.full((5,), 40, dtype=torch.int32)
    lanes = ops.kmer_extract(bases, lengths, k=21)
    want = ref.kmer_extract_ref(bases, lengths, k=21)
    for g, w in zip(lanes, want):
        assert torch.equal(g, w)
    hi, lo = _lane(rng, (50,)), _lane(rng, (50,))
    valid = torch.ones(50, dtype=torch.bool)
    t = dht.empty_table(64)
    got = ops.dht_insert(*t, hi, lo, valid)
    for g, w in zip(got, ref.dht_insert_ref(*t, hi, lo, valid)):
        assert torch.equal(g, w)
    table = dht.HashTable(*got[:4])
    assert torch.equal(ops.dht_lookup(*table, hi, lo),
                       ref.dht_lookup_ref(*table, hi, lo, valid))
    side = (torch.zeros(64, dtype=torch.int32),
            torch.zeros(64, dtype=torch.int32),
            torch.zeros(64, dtype=torch.bool),
            torch.zeros(64, dtype=torch.bool))
    kw = dict(seed_len=21, positions=(0, 16, 19))
    got = ops.seed_probe(bases, lengths, *table, *side, **kw)
    want = ref.seed_probe_ref(bases, lengths, *table, *side, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert ops.LAUNCHES == dict.fromkeys(ops.KERNELS, 0)


def test_unknown_backend_raises():
    t = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown"):
        ops.dht_lookup(*dht.empty_table(4), t, t, backend="pallas")
