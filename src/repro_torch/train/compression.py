"""Int8 gradient compression with error feedback (mirrors
`repro.train.compression`).

Blockwise absmax int8 (the optimizer's `_quantize`, 256 entries a block)
quarters the bytes of a gradient all-reduce; the quantization error is
carried to the next step and added back before compressing, so the
compressed signal's mean tracks the true gradient.  Over {name: tensor}
dicts:

    err = init_error(grads)
    comp, err = compress_with_feedback(grads, err)
    # comp["q"] (int8) and comp["scale"] would ride the all-reduce
    grads = decompress(comp, grads)

On one card there is no all-reduce to carry the payload; the functions
stand as the reference's do, outside its train loop.
"""
from __future__ import annotations

import torch

from .optimizer import _dequantize as _dq
from .optimizer import _quantize as _q


def init_error(params) -> dict:
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.items()}


def compress_with_feedback(grads: dict, err: dict):
    """(comp, new_err): comp = {"q": {name: int8}, "scale": {name: fp32}},
    new_err the part of grads + err the int8 blocks do not carry."""
    qs, scales, news = {}, {}, {}
    for n, g in grads.items():
        x = g.to(torch.float32) + err[n]
        qs[n], scales[n] = _q(x)
        news[n] = x - _dq(qs[n], scales[n], g.shape)
    return {"q": qs, "scale": scales}, news


def decompress(comp: dict, template: dict) -> dict:
    """{name: tensor} of the template's shapes and dtypes from comp."""
    return {n: _dq(comp["q"][n], comp["scale"][n], t.shape).to(t.dtype)
            for n, t in template.items()}
