"""Training launcher (mirrors `repro.launch.train`).

Fault-tolerance posture, as the reference's:
  * periodic checkpoints on a worker thread (train/checkpoint.py) with
    atomic publish, and a final blocking one;
  * auto-resume from the latest checkpoint at startup: a restarted job
    loses at most `ckpt_every` steps;
  * preemption hook: SIGTERM requests a final blocking checkpoint of the
    step reached, then the loop stops;
  * straggler monitor: each step's wall time feeds an EWMA z-score, and
    steps slower than `straggler_z` sigma are logged.

A step (`train_step`) is `loss_fn`'s forward, autograd's backward and
the optimizer's in-place `apply_updates`, eagerly on one device; the
forward is the plain path, as the reference's training forward is (its
`loss_fn` defaults to `use_kernel=False`, and no kernel of either package
has a backward).  Like the reference, a resumed run draws its token
batches from the stream's first batch again (ROADMAP.md Queue 3); the
enc-dec and frontend families take `smoke_batch(cfg, B, S, seed + step)`
instead.

Usage (the SMOKE configuration on the CPU):
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --steps 50 \\
        --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import signal
import time

import torch

from repro_torch.data.tokens import synthetic_token_stream
from repro_torch.models import layers, registry
from repro_torch.train import optimizer as opt
from repro_torch.train.checkpoint import Checkpointer


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    batch: int = 8
    seq: int = 128
    ckpt_every: int = 20
    ckpt_dir: str = "checkpoints"
    log_every: int = 10
    straggler_z: float = 3.0
    adam: opt.AdamConfig = dataclasses.field(default_factory=opt.AdamConfig)


class StragglerMonitor:
    """EWMA step-time z-score tracker."""

    def __init__(self, z: float, alpha: float = 0.1):
        self.z = z
        self.alpha = alpha
        self.mean = None
        self.var = 0.0
        self.flagged = []

    def observe(self, step: int, dt: float) -> bool:
        if self.mean is None:
            self.mean = dt
            return False
        sd = max(self.var ** 0.5, 1e-6)
        is_straggler = dt > self.mean + self.z * sd and step > 5
        if is_straggler:
            self.flagged.append((step, dt))
        d = dt - self.mean
        self.mean += self.alpha * d
        self.var = (1 - self.alpha) * (self.var + self.alpha * d * d)
        return is_straggler


def train_step(cfg, model, opt_state: dict, batch: dict,
               adam: opt.AdamConfig, *, on_phase=None):
    """One step in place: the loss's forward, backward and AdamW over
    every parameter; the gradients are dropped after the update.  Returns
    (loss, gnorm), device tensors.  `on_phase(name)`, if given, is called
    after each of "forward", "backward" and "apply_updates"."""
    mark = on_phase or (lambda name: None)
    loss = registry.model_fns(cfg)["loss_fn"](cfg, model, batch)
    mark("forward")
    loss.backward()
    mark("backward")
    params = opt.named(model)
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
             for n, p in params.items()}
    gnorm = opt.apply_updates(params, grads, opt_state, adam)
    del grads
    for p in params.values():
        p.grad = None
    mark("apply_updates")
    return loss.detach(), gnorm


def train(arch_id: str, tcfg: TrainConfig, *, smoke: bool = True,
          resume: bool = True, seed: int = 0, device=None):
    """Train `arch_id` for tcfg.steps steps (from the latest checkpoint
    under tcfg.ckpt_dir/arch_id, if any and `resume`), on the card unless
    `device` is given.  Weights come from the registry's init_params on a
    torch.Generator seeded with `seed`.  Returns (model, the losses of the
    steps run, the StragglerMonitor)."""
    cfg = registry.get(arch_id, smoke=smoke)
    fns = registry.model_fns(cfg)
    device = layers.resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    model = fns["init_params"](cfg, gen, device=device)
    params = opt.named(model)
    opt_state = opt.init_state(params, tcfg.adam)
    ckpt = Checkpointer(f"{tcfg.ckpt_dir}/{arch_id}")
    start_step = 0
    if resume and ckpt.latest_step() is not None:
        (saved, opt_state), start_step = ckpt.restore((params, opt_state))
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(saved[n])
        del saved
        print(f"resumed from step {start_step}")

    stream = synthetic_token_stream(
        vocab=cfg.vocab, batch=tcfg.batch, seq=tcfg.seq, seed=seed)

    # preemption hook: one final blocking checkpoint on SIGTERM
    preempted = {"flag": False}

    def on_sigterm(signum, frame):
        preempted["flag"] = True

    old = signal.signal(signal.SIGTERM, on_sigterm)
    monitor = StragglerMonitor(tcfg.straggler_z)
    losses = []
    try:
        for step in range(start_step, tcfg.steps):
            batch = next(stream)
            if cfg.family == "encdec" or cfg.frontend:
                batch = registry.smoke_batch(cfg, tcfg.batch, tcfg.seq,
                                             seed + step)
            batch = {k: v.to(device) for k, v in batch.items()}
            t0 = time.perf_counter()
            loss, gnorm = train_step(cfg, model, opt_state, batch,
                                     tcfg.adam)
            loss = float(loss)  # waits for the step's work
            dt = time.perf_counter() - t0
            if monitor.observe(step, dt):
                print(f"step {step}: STRAGGLER ({dt:.3f}s vs "
                      f"{monitor.mean:.3f}s mean)")
            losses.append(loss)
            if step % tcfg.log_every == 0:
                print(f"step {step} loss {loss:.4f} "
                      f"gnorm {float(gnorm):.3f} {dt:.3f}s")
            if (step + 1) % tcfg.ckpt_every == 0:
                ckpt.save(step + 1, (params, opt_state), blocking=False)
            if preempted["flag"]:
                print(f"preempted at step {step}: final checkpoint")
                ckpt.save(step + 1, (params, opt_state), blocking=True)
                break
        else:
            ckpt.save(tcfg.steps, (params, opt_state), blocking=True)
    finally:
        ckpt.wait()
        signal.signal(signal.SIGTERM, old)
        stream.close()
    return model, losses, monitor


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    tcfg = TrainConfig(steps=args.steps, batch=args.batch, seq=args.seq,
                       ckpt_dir=args.ckpt_dir)
    _, losses, monitor = train(args.arch, tcfg, smoke=args.smoke,
                               device=args.device)
    if losses:
        print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f}); "
              f"stragglers flagged: {len(monitor.flagged)}")


if __name__ == "__main__":
    main()
