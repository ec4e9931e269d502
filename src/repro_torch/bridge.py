"""Carry state between the reference package and the port via numpy.

The port imports nothing of the reference.  A caller that has both (the
tests) turns a reference record into numpy arrays and hands it over:

    kset_t = bridge.to_torch(jax_kset, KmerSet, device="cpu")
    plan_t = bridge.plan_from_fields(fields)   # reference plan's asdict
    out = bridge.to_numpy(port_record)         # nested dict of arrays

so a stage of the port can start from the reference's output of the stage
before it.  uint32 lanes become int32 tensors with the same bits
(`core.types`) and come back as uint32 arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.api.plan import AssemblyPlan
from repro_torch.core.alignment import SeedIndex
from repro_torch.core.dht import HashTable
from repro_torch.core.kmer_analysis import ExtensionPolicy

# Fields that hold uint32 lanes in the reference.
LANE_FIELDS = frozenset({"hi", "lo", "hash", "slot_hi", "slot_lo"})
_NESTED = {(SeedIndex, "table"): HashTable}


def tensor(a, device=None) -> torch.Tensor:
    """numpy (or array-like) -> tensor; uint32 becomes int32, same bits."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def to_torch(record, cls, device=None):
    """A port record of NamedTuple type `cls` from any object with the same
    field names whose values are arrays (or Python ints, kept as they are).
    """
    vals = {}
    for name in cls._fields:
        v = getattr(record, name)
        if (cls, name) in _NESTED:
            vals[name] = to_torch(v, _NESTED[cls, name], device)
        elif isinstance(v, (bool, int, float)):
            vals[name] = v
        else:
            vals[name] = tensor(v, device)
    return cls(**vals)


def to_numpy(obj, name: str = ""):
    """Port record, dict, or tensor -> nested dict of numpy arrays; lanes
    come back as uint32."""
    if isinstance(obj, torch.Tensor):
        a = obj.detach().cpu().numpy()
        return a.view(np.uint32) if name in LANE_FIELDS else a
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return {f: to_numpy(getattr(obj, f), f) for f in obj._fields}
    if isinstance(obj, dict):
        return {k: to_numpy(v, k) for k, v in obj.items()}
    return obj


def plan_from_fields(fields: dict) -> AssemblyPlan:
    """The port's plan from a reference plan's fields (`dataclasses.asdict`
    with `policy` as a plain tuple).  The reference's kernel backend names
    a JAX backend and does not carry over."""
    fields = dict(fields)
    fields["policy"] = ExtensionPolicy(*fields["policy"])
    fields["kernel_backend"] = None
    if fields.get("dataset_shape") is not None:
        fields["dataset_shape"] = tuple(fields["dataset_shape"])
    return AssemblyPlan(**fields)
