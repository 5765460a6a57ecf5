"""Fault-tolerant training entry point (the torch counterpart of
``repro.launch.train``, with its flags, prints and summary).

  PYTHONPATH=src python -m repro_torch.launch.train --arch deepfm \
      --reduced --steps 200 --batch 256 --ckpt-dir /tmp/ckpt \
      --resume auto --ckpt-every 50 [--fail-at-step 120] \
      [--grad-compression int8_ef] [--device cpu]

Features, each on the card and on the CPU alike:
  * auto-resume from the latest committed checkpoint;
  * failure injection (--fail-at-step waits for the checkpointer, then
    raises mid-run; rerunning with --resume auto continues from the last
    commit: the restart test);
  * async atomic checkpointing every K steps;
  * int8 error-feedback gradient compression (optional);
  * straggler/heartbeat policies fed this rank's step times;
  * cosine LR schedule, grad clipping, loss/throughput logging.

One step (``make_step``) runs ``repro``'s order: the loss and its
gradients, the optional compression, the LR scale from the step before
its increment (so the first update of a run has lr 0), clipping and the
AdamW update, in place on the model's parameters.  DeepFM's FM term runs
K8 forward and K8's hand-written backward on the card.  The weights are
drawn from ``torch.Generator(device).manual_seed(0)``.

As in ``repro``, a resumed run draws the data stream again from its
start (seed 0, batch 0 at the resumed step) and the error-feedback
residual is not checkpointed, so a resumed run does not equal an
uninterrupted one (ROADMAP queue 3).  ``--device`` (default ``cuda``)
picks the device.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Iterator

import torch

from repro_torch.checkpoint import Checkpointer, latest_step, restore_checkpoint
from repro_torch.configs import get_arch
from repro_torch.data import lm_batches, random_graph, recsys_batches
from repro_torch.device import resolve_device
from repro_torch.distributed.fault_tolerance import (
    HeartbeatMonitor,
    StragglerPolicy,
)
from repro_torch.models import gnn as gnn_mod
from repro_torch.models import recsys as recsys_mod
from repro_torch.models import transformer as tfm
from repro_torch.optim import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    cosine_warmup,
    ef_compress_grads,
    ef_init,
)


def _on(device: torch.device, batches: Iterator[dict]) -> Iterator[dict]:
    for b in batches:
        yield {k: torch.as_tensor(v, device=device) for k, v in b.items()}


def build_family(arch_id: str, reduced: bool, batch: int, seq: int,
                 device=None):
    """(spec, cfg, loss_fn(model, batch), init_fn(generator), batches on
    ``device``) for ``arch_id``'s family, from ``repro``'s data: the LM
    token stream, the recsys click logs, or one random graph (512 nodes,
    2048 edges) repeated as a constant batch."""
    device = resolve_device(device)
    spec = get_arch(arch_id)
    cfg = spec.reduced() if reduced else spec.config
    if spec.family == "lm":
        loss_fn = lambda m, b: tfm.train_loss(m, b, cfg)
        init_fn = lambda gen: tfm.init_params(gen, cfg)
        data = _on(device, lm_batches(cfg.vocab, batch, seq, seed=0))
    elif spec.family == "recsys":
        loss_fn = lambda m, b: recsys_mod.bce_loss(m, b, cfg)
        init_fn = lambda gen: recsys_mod.init_params(gen, cfg)
        data = _on(device, recsys_batches(cfg.vocab_sizes, batch, seed=0))
    else:
        g = random_graph(512, 2048, cfg.d_feat, cfg.n_vars, seed=0)
        const = {
            "node_feats": torch.as_tensor(g.node_feats, device=device),
            "edges": torch.as_tensor(g.edges, device=device),
            "targets": torch.as_tensor(g.targets, device=device),
        }
        loss_fn = lambda m, b: gnn_mod.mse_loss(m, b, cfg)
        init_fn = lambda gen: gnn_mod.init_params(gen, cfg)

        def graph_gen():
            while True:
                yield const

        data = graph_gen()
    return spec, cfg, loss_fn, init_fn, data


def make_step(loss_fn: Callable, acfg: AdamWConfig, warmup: int, total: int,
              compression: str = "none") -> Callable:
    """``step_fn(model, opt, ef, batch) -> (model, opt, ef, {"loss",
    "grad_norm"})``, ``repro``'s jitted step written out: the loss and
    its gradients (zeros for a parameter the loss does not use, as
    ``jax.grad`` gives), int8 error feedback when ``compression`` is
    ``"int8_ef"``, the cosine-warmup LR scale from ``opt["step"]`` before
    its increment, then clipping and AdamW.  The model's parameters and
    the moments are updated in place; nothing syncs with the host."""
    use_compression = compression == "int8_ef"

    def step_fn(model, opt, ef, batch):
        params = dict(model.named_parameters())
        loss = loss_fn(model, batch)
        raw = torch.autograd.grad(loss, list(params.values()),
                                  allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g
                 for (n, p), g in zip(params.items(), raw)}
        if use_compression:
            grads, ef = ef_compress_grads(grads, ef)
        lr_scale = cosine_warmup(opt["step"], warmup=warmup, total=total)
        _, opt, metrics = adamw_update(params, grads, opt, acfg, lr_scale)
        return model, opt, ef, {"loss": loss.detach(), **metrics}

    return step_fn


def _world() -> tuple:
    """(world size, rank) of the ``torch.distributed`` group, (1, 0)
    without one."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", choices=["auto", "none"], default="none")
    ap.add_argument("--fail-at-step", type=int, default=-1)
    ap.add_argument("--grad-compression", choices=["none", "int8_ef"],
                    default="none")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-out", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    spec, cfg, loss_fn, init_fn, data = build_family(
        args.arch, args.reduced, args.batch, args.seq, device
    )
    acfg = AdamWConfig(lr=args.lr)
    model = init_fn(torch.Generator(device).manual_seed(0))
    params = dict(model.named_parameters())
    opt = adamw_init(params)
    ef = ef_init(params) if args.grad_compression == "int8_ef" else None
    start = 0

    if (args.resume == "auto" and args.ckpt_dir
            and latest_step(args.ckpt_dir) is not None):
        start, state = restore_checkpoint(
            args.ckpt_dir, {"params": params, "opt": opt}
        )
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(state["params"][name])
        opt = state["opt"]
        print(f"resumed from step {start}")

    step_fn = make_step(loss_fn, acfg, args.warmup, args.steps,
                        args.grad_compression)
    ck = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    world, rank = _world()
    hb = HeartbeatMonitor(n_hosts=world, timeout=300.0)
    straggle = StragglerPolicy()
    losses = []
    t_start = time.time()
    for s in range(start, args.steps):
        if s == args.fail_at_step:
            if ck:
                ck.wait()
            raise RuntimeError(f"injected failure at step {s} (restart test)")
        batch = next(data)
        t0 = time.time()
        model, opt, ef, metrics = step_fn(model, opt, ef, batch)
        losses.append(float(metrics["loss"]))  # the step's one host sync
        dt = time.time() - t0
        hb.beat(rank)
        straggle.report(rank, dt)
        if (s + 1) % args.log_every == 0:
            print(f"step {s+1}: loss={losses[-1]:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} {dt*1e3:.0f}ms")
        if ck and (s + 1) % args.ckpt_every == 0:
            ck.save_async(s + 1, {"params": params, "opt": opt})
    if ck:
        ck.save_async(args.steps, {"params": params, "opt": opt})
        ck.wait()
    wall = time.time() - t_start
    summary = {
        "arch": args.arch,
        "steps_run": args.steps - start,
        "first_loss": losses[0] if losses else None,
        "last_loss": losses[-1] if losses else None,
        "wall_s": round(wall, 2),
        "stragglers": straggle.stragglers(),
        "dead_hosts": hb.dead_hosts(),
    }
    print(json.dumps(summary))
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump({"losses": losses, **summary}, f)
    return summary


if __name__ == "__main__":
    main()
