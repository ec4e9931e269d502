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
the port's model from the reference's `init_params` pytree as numpy
arrays (dense and MoE: every layer parameter stacked on a leading
`layers` axis, an MoE layer's `moe` holding `router`, the expert stacks
`wi` / `wg` / `wo` and its `shared` GLU; hybrid: `mamba` leaves stacked
[groups, attn_every, ...], `mamba_tail` [rest, ...] and one `shared`
block; xLSTM: `pairs` leaves stacked [n_layers // 2, ...], each pair's
`m`, `s`, `ln_m` and `ln_s`; a frontend's stub projection `frontend`;
enc-dec: `enc` and `dec` stacked [layers, ...] beside `pos_dec`,
`pos_enc`, `ln_enc` and `lm_head`), and `lm_to_numpy(model)` gives that
pytree back.  `grads_to_numpy(model)` gives the gradients in that
pytree, and `opt_state_from_numpy` / `opt_state_to_numpy` map the
reference's optimizer state (`MomentState` leaves of that pytree) onto
the port's, one entry a parameter name, and back.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.api.plan import AssemblyPlan
from repro_torch.core.alignment import SeedIndex
from repro_torch.core.dht import HashTable
from repro_torch.core.kmer_analysis import ExtensionPolicy
from repro_torch.core.local_assembly import WalkTables
from repro_torch.models import attention, encdec, ffn, ssm, transformer
from repro_torch.train import optimizer as opt

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
_MOE = ("router", "wi", "wg", "wo")


def _index(tree, idx):
    """One layer's subtree of a stacked pytree."""
    if isinstance(tree, dict):
        return {k: _index(v, idx) for k, v in tree.items()}
    return tree[idx]


def _stack(trees):
    """Stack the subtrees of a list of layers on a new leading axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def _glu(p, t) -> ffn.GLU:
    return ffn.GLU(*(t(p[n]) for n in _GLU))


def _attn(p, t) -> attention.Attention:
    return attention.Attention(*(t(p[n]) for n in _ATTN))


def _dense_layer(p, t) -> transformer.DenseLayer:
    attn = _attn(p["attn"], t)
    mlp = _glu(p["mlp"], t) if "mlp" in p else None
    moe = None
    if "moe" in p:
        m = p["moe"]
        moe = ffn.MoE(*(t(m[n]) for n in _MOE),
                      _glu(m["shared"], t) if "shared" in m else None)
    return transformer.DenseLayer(attn, t(p["ln1"]), t(p["ln2"]), mlp, moe)


def _mamba_layer(p, t) -> transformer.MambaLayer:
    return transformer.MambaLayer(
        ssm.Mamba2(*(t(p["mixer"][n]) for n in ssm.MAMBA2_PARAMS)),
        t(p["ln"]))


def _xlstm_pair(p, t) -> transformer.XLSTMPair:
    return transformer.XLSTMPair(
        ssm.MLSTM(*(t(p["m"][n]) for n in ssm.MLSTM_PARAMS)),
        ssm.SLSTM(*(t(p["s"][n]) for n in ssm.SLSTM_PARAMS)),
        t(p["ln_m"]), t(p["ln_s"]))


def _enc_layer(p, t) -> encdec.EncLayer:
    return encdec.EncLayer(_attn(p["attn"], t), _glu(p["mlp"], t),
                           t(p["ln1"]), t(p["ln2"]))


def _dec_layer(p, t) -> encdec.DecLayer:
    return encdec.DecLayer(_attn(p["attn"], t), _attn(p["xattn"], t),
                           _glu(p["mlp"], t), t(p["ln1"]), t(p["ln2"]),
                           t(p["ln3"]))


def _numpy(p):
    return p.detach().cpu().numpy()


def _tree(module, names, leaf=_numpy) -> dict:
    return {n: leaf(getattr(module, n)) for n in names}


def _dense_tree(lp: transformer.DenseLayer, leaf=_numpy) -> dict:
    out = {"attn": _tree(lp.attn, _ATTN, leaf),
           "ln1": leaf(lp.ln1), "ln2": leaf(lp.ln2)}
    if lp.moe is not None:
        out["moe"] = _tree(lp.moe, _MOE, leaf)
        if lp.moe.shared is not None:
            out["moe"]["shared"] = _tree(lp.moe.shared, _GLU, leaf)
    if lp.mlp is not None:
        out["mlp"] = _tree(lp.mlp, _GLU, leaf)
    return out


def _mamba_tree(lp: transformer.MambaLayer, leaf=_numpy) -> dict:
    return {"mixer": _tree(lp.mixer, ssm.MAMBA2_PARAMS, leaf),
            "ln": leaf(lp.ln)}


def _enc_tree(lp: encdec.EncLayer, leaf=_numpy) -> dict:
    return {"attn": _tree(lp.attn, _ATTN, leaf),
            "mlp": _tree(lp.mlp, _GLU, leaf),
            "ln1": leaf(lp.ln1), "ln2": leaf(lp.ln2)}


def _dec_tree(lp: encdec.DecLayer, leaf=_numpy) -> dict:
    return {"attn": _tree(lp.attn, _ATTN, leaf),
            "xattn": _tree(lp.xattn, _ATTN, leaf),
            "mlp": _tree(lp.mlp, _GLU, leaf), "ln1": leaf(lp.ln1),
            "ln2": leaf(lp.ln2), "ln3": leaf(lp.ln3)}


def _xlstm_tree(lp: transformer.XLSTMPair, leaf=_numpy) -> dict:
    return {"m": _tree(lp.m, ssm.MLSTM_PARAMS, leaf),
            "s": _tree(lp.s, ssm.SLSTM_PARAMS, leaf),
            "ln_m": leaf(lp.ln_m), "ln_s": leaf(lp.ln_s)}


def lm_from_numpy(cfg, params, device=None):
    """The port's model (a `Transformer` for the dense, MoE and vlm
    families, a `HybridLM` for the hybrid one, an `XLSTMLM` for xLSTM, an
    `EncDecLM` for enc-dec) from the reference's params pytree; stacked
    layer axes are unstacked into one module a layer (or pair)."""
    def t(a):
        return tensor(a, device)

    lm_head = t(params["lm_head"]) if "lm_head" in params else None
    embed, ln_f = t(params["embed"]), t(params["ln_f"])
    if cfg.family == "encdec":
        return encdec.EncDecLM(
            cfg, embed, t(params["pos_dec"]), t(params["pos_enc"]),
            [_enc_layer(_index(params["enc"], i), t)
             for i in range(cfg.n_enc_layers)],
            [_dec_layer(_index(params["dec"], i), t)
             for i in range(cfg.n_layers)],
            ln_f, t(params["ln_enc"]), lm_head)
    frontend = t(params["frontend"]) if "frontend" in params else None
    if cfg.family == "hybrid":
        n_groups, rem = divmod(cfg.n_layers, cfg.attn_every)
        groups = [[_mamba_layer(_index(params["mamba"], (g, i)), t)
                   for i in range(cfg.attn_every)] for g in range(n_groups)]
        tail = [_mamba_layer(_index(params["mamba_tail"], i), t)
                for i in range(rem)]
        return transformer.HybridLM(cfg, embed, ln_f, groups, tail,
                                    _dense_layer(params["shared"], t),
                                    lm_head, frontend)
    if cfg.xlstm:
        pairs = [_xlstm_pair(_index(params["pairs"], i), t)
                 for i in range(cfg.n_layers // 2)]
        return transformer.XLSTMLM(cfg, embed, ln_f, pairs, lm_head,
                                   frontend)
    dense = [_dense_layer(_index(params["layers"], i), t)
             for i in range(cfg.n_layers)]
    return transformer.Transformer(cfg, embed, ln_f, dense, lm_head,
                                   frontend)


def _lm_tree(model, leaf=_numpy) -> dict:
    """The reference's params pytree of the port's model, each parameter
    mapped through leaf(p) and stacked on the reference's layer axes."""
    out = {"embed": leaf(model.embed), "ln_f": leaf(model.ln_f)}
    if isinstance(model, encdec.EncDecLM):
        out.update(pos_dec=leaf(model.pos_dec),
                   pos_enc=leaf(model.pos_enc),
                   enc=_stack([_enc_tree(lp, leaf) for lp in model.enc]),
                   dec=_stack([_dec_tree(lp, leaf) for lp in model.dec]),
                   ln_enc=leaf(model.ln_enc),
                   lm_head=leaf(model.lm_head))
        return out
    if isinstance(model, transformer.HybridLM):
        out["mamba"] = _stack([_stack([_mamba_tree(lp, leaf) for lp in g])
                               for g in model.mamba])
        if len(model.mamba_tail):
            out["mamba_tail"] = _stack([_mamba_tree(lp, leaf)
                                        for lp in model.mamba_tail])
        out["shared"] = _dense_tree(model.shared, leaf)
    elif isinstance(model, transformer.XLSTMLM):
        out["pairs"] = _stack([_xlstm_tree(lp, leaf) for lp in model.pairs])
    else:
        out["layers"] = _stack([_dense_tree(lp, leaf) for lp in model.layers])
    if model.lm_head is not None:
        out["lm_head"] = leaf(model.lm_head)
    if model.frontend is not None:
        out["frontend"] = leaf(model.frontend)
    return out


def lm_to_numpy(model) -> dict:
    """The reference's params pytree (numpy) from the port's model."""
    return _lm_tree(model)


def grads_to_numpy(model) -> dict:
    """The parameters' gradients as the reference's params pytree (zeros
    where a parameter has none, as `jax.grad` gives)."""
    return _lm_tree(model, lambda p: np.zeros(p.shape, np.float32)
                    if p.grad is None else _numpy(p.grad))


def _param_names(model) -> dict:
    """The reference's params pytree with each leaf the array of the
    port's parameter names stacked into it: its shape is the leaf's layer
    axes (0-d for a leaf that is not stacked)."""
    ids = {id(p): n for n, p in model.named_parameters()}
    names = _map(np.asarray, _lm_tree(model, lambda p: ids[id(p)]))
    seen = sorted(n for a in _leaves(names) for n in a.reshape(-1))
    if seen != sorted(ids.values()):
        raise ValueError("the parameter tree does not cover the model's "
                         "parameters once each")
    return names


def _map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _block_rows(names, shape, what) -> int:
    """Blocks a stacked leaf's moment has for each of its layers: the
    reference quantizes the stack flattened, the port each layer, and the
    two cut alike only if a layer fills whole blocks."""
    n = int(np.prod(shape, dtype=np.int64))
    if names.size > 1 and n % opt.BLOCK:
        raise ValueError(
            f"{what}: a layer's {n} entries fill no whole number of "
            f"{opt.BLOCK}-entry blocks, so the reference's blocks of the "
            f"stacked leaf and the port's of each layer differ")
    return -(-n // opt.BLOCK)


def opt_state_from_numpy(model, state, device=None) -> dict:
    """The port's optimizer state, {"m": {name: MomentState}, "v": ...,
    "step"}, from the reference's `init_state` / `apply_updates` state as
    numpy (`MomentState(value, scale)` leaves of the stacked params
    pytree).  fp32 moments unstack into one tensor a parameter; int8
    moments split their blocks by layer, which needs every stacked layer to
    fill whole blocks (else ValueError)."""
    names = _param_names(model)
    params = dict(model.named_parameters())
    out = {"m": {}, "v": {}, "step": tensor(np.asarray(state["step"],
                                                       np.int32), device)}
    for key in ("m", "v"):
        def one(ns, st):
            shape = params[ns.reshape(-1)[0]].shape
            if st.scale is None:
                vals = np.asarray(st.value).reshape((ns.size,) + shape)
                scales = [None] * ns.size
            else:
                nb = _block_rows(ns, shape, ns.reshape(-1)[0])
                vals = np.asarray(st.value).reshape(ns.size, nb, -1)
                scales = np.asarray(st.scale).reshape(ns.size, nb, 1)
            for i, n in enumerate(ns.reshape(-1)):
                out[key][str(n)] = opt.MomentState(
                    tensor(vals[i], device),
                    None if scales[i] is None else tensor(scales[i], device))

        _map(one, names, state[key])
    return out


def opt_state_to_numpy(model, state) -> dict:
    """The reference's optimizer state (numpy, the stacked params pytree
    of `MomentState`s) from the port's; the inverse of
    `opt_state_from_numpy`."""
    names = _param_names(model)
    params = dict(model.named_parameters())

    def one(ns, moments):
        flat = [moments[n] for n in ns.reshape(-1)]
        shape = params[ns.reshape(-1)[0]].shape
        if flat[0].scale is None:
            value = np.stack([_numpy(m.value) for m in flat])
            return opt.MomentState(value.reshape(ns.shape + shape), None)
        _block_rows(ns, shape, ns.reshape(-1)[0])
        return opt.MomentState(
            np.concatenate([_numpy(m.value) for m in flat]),
            np.concatenate([_numpy(m.scale) for m in flat]))

    return {"m": _map(lambda ns: one(ns, state["m"]), names),
            "v": _map(lambda ns: one(ns, state["v"]), names),
            "step": np.asarray(_numpy(state["step"]), np.int32)}
