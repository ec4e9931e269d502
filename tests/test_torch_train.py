"""The port's training path against the JAX package (CPU).

  * `data.tokens.synthetic_token_stream`: the reference's batches bit for
    bit; and the reference's one timing fault the port does not copy (its
    thread drops a batch it made whenever the queue stays full for a
    second, so a slow consumer skips batches);
  * `train.optimizer._quantize` / `_dequantize` and `train.compression`
    bit for bit;
  * `apply_updates` from the same state and the same bridged gradients
    for 5 steps on a llama of d_model 256 (so that each layer's tensors
    fill whole 256-entry blocks, where the reference's blocks of its
    stacked leaves and the port's of each layer agree): the parameters
    and the fp32 moments at 1e-6, the int8 moments within 1 and their
    scales at 1e-6; the bridge refuses int8 moments whose blocks differ;
    and the reference's int8 second moment, which flushes a block's small
    entries to zero (ROADMAP Queue 3), pinned in both packages;
  * the `Checkpointer`: plain nested dicts of fp32, int8, int32 and bool
    saved by either package restore in the other, `keep=3`, the worker
    thread's save with `wait()`, `restore(step=)`, no `.tmp` left, a
    worker's write error raised at `wait()`, a bfloat16 leaf refused;
  * `StragglerMonitor`: the same flags on the same step times;
  * `train("llama3.2-3b", smoke=True)` against the reference's `train()`
    from the same weights (both packages' init replaced through
    monkeypatch), 6 steps with a checkpoint at 3 and 6: every loss and
    gradient norm at 1e-4 relative; a run resumed to 7 steps equals the
    reference's resumed run, and both replay the stream's first batch at
    step 6 (ROADMAP Queue 3), so the loss differs from an uninterrupted
    run's by more than 1e-3; SIGTERM stops a run with a final checkpoint.

The reference's `train()` is given a prefetch deep enough for its whole
run (its own default of 2 drops batches while its first step compiles).
"""
import dataclasses
import functools
import os
import signal
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.train as jlaunch
import repro.models.transformer as jtransformer
from repro.data import tokens as jtokens
from repro.models import registry as jregistry
from repro.train import compression as jcompression
from repro.train import optimizer as jopt
from repro.train.checkpoint import Checkpointer as JCheckpointer
from repro_torch import bridge
from repro_torch.data import tokens
from repro_torch.launch import train as launch
from repro_torch.models import registry, transformer
from repro_torch.train import compression
from repro_torch.train import optimizer as opt
from repro_torch.train.checkpoint import Checkpointer

TOL = 1e-4
UPDATE_TOL = 1e-6
ARCH = "llama3.2-3b"


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def test_token_stream_equals_reference_bit_for_bit():
    kw = dict(vocab=1000, batch=4, seq=16, seed=3)
    ref, port = jtokens.synthetic_token_stream(**kw), \
        tokens.synthetic_token_stream(**kw)
    for _ in range(3):
        want, got = next(ref), next(port)
        assert got["tokens"].dtype == torch.int32
        np.testing.assert_array_equal(got["tokens"].numpy(),
                                      np.asarray(want["tokens"]))
    port.close()


def test_reference_stream_skips_batches_behind_a_slow_consumer():
    kw = dict(vocab=1000, batch=4, seq=16, seed=5, prefetch=1)
    ref, port = jtokens.synthetic_token_stream(**kw), \
        tokens.synthetic_token_stream(**kw)
    want = [next(port)["tokens"].numpy() for _ in range(10)]
    port.close()
    first = np.asarray(next(ref)["tokens"])
    time.sleep(2.5)  # the reference's queue stays full for over a second
    got = [first] + [np.asarray(next(ref)["tokens"]) for _ in range(2)]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert not np.array_equal(got[2], want[2])  # batch 2 was dropped
    assert any(np.array_equal(got[2], w) for w in want[3:])


@pytest.mark.parametrize("shape", [(3, 100), (513,), (256,), (2, 0)])
def test_quantize_and_compression_equal_reference(shape):
    rng = np.random.default_rng(sum(shape) + 7)
    x = rng.standard_normal(shape).astype(np.float32) * 3
    if x.size > 256:
        x.reshape(-1)[:256] = 0.0  # an all-zero block: scale 0
    q, s = opt._quantize(torch.from_numpy(x))
    jq, js = jopt._quantize(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        opt._dequantize(q, s, shape).numpy(),
        np.asarray(jopt._dequantize(jq, js, shape)))
    grads = {"w": x, "b": rng.standard_normal((7,)).astype(np.float32)}
    tg = {k: torch.from_numpy(v) for k, v in grads.items()}
    jg = {k: jnp.asarray(v) for k, v in grads.items()}
    err, jerr = compression.init_error(tg), jcompression.init_error(jg)
    for _ in range(3):
        comp, err = compression.compress_with_feedback(tg, err)
        jcomp, jerr = jcompression.compress_with_feedback(jg, jerr)
        for part in ("q", "scale"):
            for k in grads:
                np.testing.assert_array_equal(comp[part][k].numpy(),
                                              np.asarray(jcomp[part][k]))
        for k in grads:
            np.testing.assert_array_equal(err[k].numpy(),
                                          np.asarray(jerr[k]))
        out, jout = compression.decompress(comp, tg), \
            jcompression.decompress(jcomp, jg)
        for k in grads:
            np.testing.assert_array_equal(out[k].numpy(),
                                          np.asarray(jout[k]))


def _wide_llama():
    """SMOKE llama at d_model 256 (4 heads of 64, 2 KV heads, d_ff 256):
    every tensor of a layer fills whole 256-entry blocks."""
    return dataclasses.replace(registry.get(ARCH, smoke=True), d_model=256,
                               d_ff=256)


@pytest.mark.parametrize("quantize", [False, True])
def test_apply_updates_equals_reference(quantize):
    cfg = _wide_llama()
    gen = torch.Generator()
    gen.manual_seed(1)
    model = transformer.init_params(cfg, gen, device="cpu")
    # copies: the port updates its parameters in place
    params = jax.tree.map(np.array, bridge.lm_to_numpy(model))
    acfg = opt.AdamConfig(quantize_moments=quantize)
    jcfg = jopt.AdamConfig(quantize_moments=quantize)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init_state(jp, jcfg)
    state = opt.init_state(model, acfg)
    rng = np.random.default_rng(2)
    for step in range(5):
        # fp32: the first two steps' norms exceed grad_clip, the rest do
        # not.  int8: every norm stays under it, so both clip factors are
        # exactly 1 (the norms' fp32 sums run in another order, and the
        # last bit of a clip factor below 1 can flip an int8 rounding,
        # which moves that entry's parameter by ~lr / 30 from then on)
        scale = 0.05 if step < 2 and not quantize else 1e-3
        grads = jax.tree.map(lambda a: (rng.standard_normal(a.shape)
                                        * scale).astype(np.float32), params)
        gmodel = bridge.lm_from_numpy(cfg, grads, device="cpu")
        tgrads = {n: g.detach() for n, g in gmodel.named_parameters()}
        gn = opt.apply_updates(model, tgrads, state, acfg)
        jp, jstate, jgn = jopt.apply_updates(
            jp, jax.tree.map(jnp.asarray, grads), jstate, jcfg)
        np.testing.assert_allclose(float(gn), float(jgn), rtol=UPDATE_TOL)
    assert int(state["step"]) == int(jstate["step"]) == 5
    got = dict(_leaves(bridge.lm_to_numpy(model)))
    for key, want in _leaves(jax.tree.map(np.asarray, jp)):
        np.testing.assert_allclose(got[key], want, rtol=0, atol=UPDATE_TOL,
                                   err_msg=key)
    mine = bridge.opt_state_to_numpy(model, state)
    want_state = jax.tree.map(np.asarray, jstate)
    for part in ("m", "v"):
        got = dict(_leaves(mine[part]))
        for key, w in _leaves(want_state[part]):
            g = got[key]
            if not quantize:
                assert g.scale is None and w.scale is None
                np.testing.assert_allclose(g.value, w.value, rtol=0,
                                           atol=UPDATE_TOL, err_msg=key)
                continue
            assert g.value.dtype == np.int8 and g.value.shape == \
                w.value.shape
            assert np.abs(g.value.astype(np.int32) - w.value).max() <= 1, key
            np.testing.assert_allclose(g.scale, w.scale, rtol=UPDATE_TOL,
                                       atol=1e-12, err_msg=key)
    # the bridge carries the reference's state into the port and back
    back = bridge.opt_state_to_numpy(
        model, bridge.opt_state_from_numpy(model, want_state, device="cpu"))
    for part in ("m", "v"):
        got = dict(_leaves(back[part]))
        for key, w in _leaves(want_state[part]):
            np.testing.assert_array_equal(got[key].value, w.value)
            if quantize:
                np.testing.assert_array_equal(got[key].scale, w.scale)


def test_int8_second_moment_flushes_small_entries_as_the_reference():
    """Reference fault (ROADMAP Queue 3): absmax int8 rounds the entries
    of a block of v below its max / 254 to zero, so an entry whose
    gradient then shrinks takes a step of |mh| / sqrt(vh) in the hundreds,
    where fp32 moments keep it under 1.  Both packages take the same
    steps."""
    rng = np.random.default_rng(12)
    g1 = rng.standard_normal(256).astype(np.float32)
    grads = (g1, g1 * np.float32(1e-3))  # the gradient shrinks 1000x
    ratio = {}
    for quant in (False, True):
        kw = dict(weight_decay=0.0, grad_clip=1e9, quantize_moments=quant)
        acfg, jcfg = opt.AdamConfig(**kw), jopt.AdamConfig(**kw)
        params = {"w": torch.zeros(256)}
        jparams = {"w": jnp.zeros(256, jnp.float32)}
        state, jstate = opt.init_state(params, acfg), \
            jopt.init_state(jparams, jcfg)
        for g in grads:
            before = params["w"].clone()
            opt.apply_updates(params, {"w": torch.from_numpy(g)}, state,
                              acfg)
            jparams, jstate, _ = jopt.apply_updates(
                jparams, {"w": jnp.asarray(g)}, jstate, jcfg)
        np.testing.assert_allclose(params["w"].numpy(),
                                   np.asarray(jparams["w"]), rtol=1e-5)
        ratio[quant] = float((params["w"] - before).abs().max()) / acfg.lr
    assert ratio[False] < 1.0 and ratio[True] > 100.0, ratio


def test_bridge_refuses_int8_moments_whose_blocks_differ():
    cfg = registry.get(ARCH, smoke=True)  # d_model 64: a norm is 64 entries
    model = transformer.init_params(cfg, device="cpu")
    acfg = opt.AdamConfig(quantize_moments=True)
    state = opt.init_state(model, acfg)
    with pytest.raises(ValueError, match="whole number"):
        bridge.opt_state_to_numpy(model, state)
    fp32 = bridge.opt_state_to_numpy(model,
                                     opt.init_state(model, opt.AdamConfig()))
    assert fp32["m"]["layers"]["ln1"].value.shape == (cfg.n_layers,
                                                      cfg.d_model)


def _plain_tree(rng):
    return {"a": rng.standard_normal((3, 5)).astype(np.float32),
            "nested": {"q": rng.integers(-127, 128, (4, 8)).astype(np.int8),
                       "step": np.asarray(7, np.int32),
                       "flag": np.asarray([True, False, True])}}


def _assert_tree_equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.dtype == np.asarray(w).dtype and g.shape == np.shape(w), k
        np.testing.assert_array_equal(g, np.asarray(w))


def test_checkpoints_cross_between_the_packages(tmp_path):
    rng = np.random.default_rng(4)
    tree = _plain_tree(rng)
    ttree = jax.tree.map(torch.from_numpy, tree)
    jtree = jax.tree.map(jnp.asarray, tree)
    JCheckpointer(str(tmp_path / "ref")).save(3, jtree, blocking=True)
    got, step = Checkpointer(str(tmp_path / "ref")).restore(
        jax.tree.map(torch.zeros_like, ttree))
    assert step == 3
    _assert_tree_equal(got, tree)
    Checkpointer(str(tmp_path / "port")).save(4, ttree)
    got, step = JCheckpointer(str(tmp_path / "port")).restore(
        jax.tree.map(jnp.zeros_like, jtree))
    assert step == 4
    _assert_tree_equal(jax.tree.map(np.asarray, got), tree)


def test_checkpointer_keeps_three_saves_async_and_raises_worker_errors(
        tmp_path):
    d = tmp_path / "ck"
    ck = Checkpointer(str(d))
    assert ck.keep == 3
    rng = np.random.default_rng(6)
    trees = {}
    for step in (2, 4, 6, 8):
        trees[step] = jax.tree.map(torch.from_numpy, _plain_tree(rng))
        ck.save(step, trees[step], blocking=False)
    ck.wait()
    assert ck.list_steps() == [4, 6, 8] and ck.latest_step() == 8
    template = jax.tree.map(torch.zeros_like, trees[2])
    for step in (4, 6, 8):
        got, s = ck.restore(template, step=step)
        assert s == step
        _assert_tree_equal(got, jax.tree.map(torch.Tensor.numpy,
                                             trees[step]))
    assert not [p for p in d.iterdir() if p.name.startswith(".tmp")]
    (d / "step_0000000011").write_text("")  # blocks step 11's publish
    ck.save(11, trees[8], blocking=False)
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()  # the error was raised once
    assert not [p for p in d.iterdir() if p.name.startswith(".tmp")]
    (d / "step_0000000011").unlink()
    with pytest.raises(TypeError, match="numpy"):
        ck.save(12, {"w": torch.zeros(2, dtype=torch.bfloat16)})
    assert ck.restore(template)[1] == 8


def test_straggler_monitor_flags_as_the_reference():
    rng = np.random.default_rng(8)
    times = 0.1 + 0.002 * rng.standard_normal(60)
    times[[10, 25, 26, 40]] = [0.5, 0.3, 0.9, 0.2]
    ours, ref = launch.StragglerMonitor(3.0), jlaunch.StragglerMonitor(3.0)
    flags = [(ours.observe(i, t), ref.observe(i, t))
             for i, t in enumerate(times)]
    assert all(a == b for a, b in flags)
    assert ours.flagged == ref.flagged and len(ours.flagged) >= 2
    assert (ours.mean, ours.var) == (ref.mean, ref.var)


# ---- train(): the port against the reference, from the same weights ----

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' train() from the port's seeded init: 6 steps with a
    checkpoint every 3, resumed to 7; the port also uninterrupted to 7.
    Returns {name: (losses, gnorms)}."""
    mp = pytest.MonkeyPatch()
    root = tmp_path_factory.mktemp("train")
    cfg = registry.get(ARCH, smoke=True)
    gen = torch.Generator()
    gen.manual_seed(11)
    params = bridge.lm_to_numpy(transformer.init_params(cfg, gen,
                                                        device="cpu"))
    gnorms = []
    mp.setattr(transformer, "init_params",
               lambda cfg, gen=None, device=None, **kw:
               bridge.lm_from_numpy(cfg, params, device=device))
    mp.setattr(jtransformer, "init_params",
               lambda cfg, key, **kw:
               (jax.tree.map(jnp.asarray, params), None))
    mp.setattr(jlaunch, "synthetic_token_stream", functools.partial(
        jtokens.synthetic_token_stream, prefetch=64))
    apply_port, apply_ref = opt.apply_updates, jopt.apply_updates

    def port_apply(*a, **kw):
        gn = apply_port(*a, **kw)
        gnorms.append(float(gn))
        return gn

    def ref_apply(*a, **kw):
        out = apply_ref(*a, **kw)
        jax.debug.callback(lambda g: gnorms.append(float(g)), out[2])
        return out

    mp.setattr(opt, "apply_updates", port_apply)
    mp.setattr(jopt, "apply_updates", ref_apply)
    out = {}
    try:
        for name, fn, kw in (
                ("port", launch.train, dict(device="cpu")),
                ("ref", jlaunch.train, {})):
            for run, steps in (("", 6), ("_resumed", 7)):
                tcfg = (launch.TrainConfig if name == "port" else
                        jlaunch.TrainConfig)(
                    steps=steps, batch=2, seq=32, ckpt_every=3,
                    ckpt_dir=str(root / name), log_every=100)
                gnorms.clear()
                _, losses, _ = fn(ARCH, tcfg, smoke=True, **kw)
                out[name + run] = (list(losses), list(gnorms))
        gnorms.clear()
        tcfg = launch.TrainConfig(steps=7, batch=2, seq=32, ckpt_every=100,
                                  ckpt_dir=str(root / "whole"),
                                  log_every=100)
        _, losses, _ = launch.train(ARCH, tcfg, smoke=True, device="cpu")
        out["port_whole"] = (list(losses), list(gnorms))
    finally:
        mp.undo()
    out["root"] = root
    return out


def test_train_equals_reference_train(runs):
    losses, gnorms = runs["port"]
    want_losses, want_gnorms = runs["ref"]
    assert len(losses) == len(gnorms) == len(want_losses) == 6
    np.testing.assert_allclose(losses, want_losses, rtol=TOL)
    np.testing.assert_allclose(gnorms, want_gnorms, rtol=TOL)
    assert losses[-1] < losses[0]
    ck = Checkpointer(str(runs["root"] / "port" / ARCH))
    assert ck.list_steps() == [3, 6, 7]


def test_resumed_train_replays_the_first_batch_as_the_reference(runs):
    (resumed, _), (want, _) = runs["port_resumed"], runs["ref_resumed"]
    whole = runs["port_whole"][0]
    assert len(resumed) == len(want) == 1  # step 6 only
    np.testing.assert_allclose(resumed, want, rtol=TOL)
    np.testing.assert_allclose(whole[:6], runs["port"][0], rtol=1e-6)
    # step 6 of the resumed runs trains on batch 0, not batch 6
    assert abs(resumed[0] - whole[6]) > 1e-3


def test_sigterm_stops_train_with_a_final_checkpoint(tmp_path, monkeypatch):
    step_fn = launch.train_step
    calls = []

    def step(*a, **kw):
        calls.append(1)
        if len(calls) == 3:  # the handler is installed by now
            os.kill(os.getpid(), signal.SIGTERM)
        return step_fn(*a, **kw)

    monkeypatch.setattr(launch, "train_step", step)
    tcfg = launch.TrainConfig(steps=50, batch=2, seq=16, ckpt_every=100,
                              ckpt_dir=str(tmp_path), log_every=100)
    _, losses, _ = launch.train(ARCH, tcfg, smoke=True, device="cpu")
    assert len(losses) == 3
    assert Checkpointer(str(tmp_path / ARCH)).list_steps() == [3]
    assert signal.getsignal(signal.SIGTERM) is not None
