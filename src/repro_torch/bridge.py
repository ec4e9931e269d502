"""Carry state between the reference package and the port via numpy.

The port imports nothing of the reference.  A caller that has both (the
tests) turns a reference record into numpy arrays and hands it over:

    kset_t = bridge.to_torch(jax_kset, KmerSet, device="cpu")
    plan_t = bridge.plan_from_fields(fields)   # reference plan's asdict
    out = bridge.to_numpy(port_record)         # nested dict of arrays

so a stage of the port can start from the reference's output of the stage
before it (k-mer sets, contigs, seed indexes, walk tables, links,
scaffolds, scaffold sequences).  uint32 lanes become int32 tensors with
the same bits (`core.types`) and come back as uint32 arrays.

The LM's weights cross the same way: `lm_from_numpy(cfg, params)` builds
the port's `Transformer` from the reference's `init_params` pytree (as
numpy arrays, every layer parameter stacked on a leading `layers` axis),
and `lm_to_numpy(model)` gives that pytree back.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.api.plan import AssemblyPlan
from repro_torch.core.alignment import SeedIndex
from repro_torch.core.dht import HashTable
from repro_torch.core.kmer_analysis import ExtensionPolicy
from repro_torch.core.local_assembly import WalkTables
from repro_torch.models import attention, ffn, transformer

# Fields that hold uint32 lanes in the reference.
LANE_FIELDS = frozenset({"hi", "lo", "hash", "slot_hi", "slot_lo"})
# Fields that hold a record (or a tuple of records, one per walk rung).
_NESTED = {(SeedIndex, "table"): HashTable, (WalkTables, "tables"): HashTable}


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
    def one(v, nested):
        if nested is not None:
            return to_torch(v, nested, device)
        if isinstance(v, (bool, int, float)):
            return v
        return tensor(v, device)

    vals = {}
    for name in cls._fields:
        v = getattr(record, name)
        nested = _NESTED.get((cls, name))
        if isinstance(v, (tuple, list)) and not hasattr(v, "_fields"):
            vals[name] = tuple(one(x, nested) for x in v)
        else:
            vals[name] = one(v, nested)
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
    if isinstance(obj, (tuple, list)):
        return [to_numpy(v, name) for v in obj]
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


_ATTN = ("wq", "wk", "wv", "wo")
_GLU = ("wi", "wg", "wo")


def lm_from_numpy(cfg, params, device=None) -> transformer.Transformer:
    """The port's dense model from the reference's params pytree; the
    stacked `layers` axis is unstacked into one module a layer."""
    def t(a):
        return tensor(a, device)

    stack = params["layers"]
    dense = []
    for i in range(cfg.n_layers):
        attn = attention.Attention(*(t(stack["attn"][n][i]) for n in _ATTN))
        mlp = (ffn.GLU(*(t(stack["mlp"][n][i]) for n in _GLU))
               if "mlp" in stack else None)
        dense.append(transformer.DenseLayer(attn, t(stack["ln1"][i]),
                                            t(stack["ln2"][i]), mlp))
    lm_head = t(params["lm_head"]) if "lm_head" in params else None
    return transformer.Transformer(cfg, t(params["embed"]),
                                   t(params["ln_f"]), dense, lm_head)


def lm_to_numpy(model: transformer.Transformer) -> dict:
    """The reference's params pytree (numpy) from the port's model."""
    def a(p):
        return p.detach().cpu().numpy()

    def stacked(get):
        return np.stack([a(get(lp)) for lp in model.layers])

    out = {"embed": a(model.embed), "ln_f": a(model.ln_f), "layers": {
        "attn": {n: stacked(lambda lp, n=n: getattr(lp.attn, n))
                 for n in _ATTN},
        "ln1": stacked(lambda lp: lp.ln1),
        "ln2": stacked(lambda lp: lp.ln2)}}
    if model.layers and model.layers[0].mlp is not None:
        out["layers"]["mlp"] = {n: stacked(lambda lp, n=n: getattr(lp.mlp, n))
                                for n in _GLU}
    if model.lm_head is not None:
        out["lm_head"] = a(model.lm_head)
    return out
