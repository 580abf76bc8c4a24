"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[...]`` (port of ``repro.launch.train``).

Initializes a model from seed 0 and trains it with BWQ-A (AdamW without
weight decay, a cosine schedule from 2e-3, re-quantization and precision
adjustment every ``--requant-every`` steps, alpha raised by
``--delta-alpha`` at each of them) on the synthetic bigram stream.  Runs
use the reduced config by default (``--tiny``); ``--no-tiny`` trains the
registered config at full width.  Everything runs on ``--device``
(default ``cuda``; the launcher raises without a card unless given
``--device cpu``).

Beyond the reference's flags: ``--device``, and ``--layers N`` (cut the
depth to N layers; 0 keeps the config's).  ``--no-tiny`` keeps the
registered config's weight-block geometry (phi3: 8x128), where the
reference replaces it with the default 9x8; the tiny config takes the
reference's 9x8.  A model the port trains thus deploys at the geometry
its serve launcher serves.  ``--ckpt-dir D`` saves a checkpoint every
``max(steps // 4, 1)`` steps into D (the reference's format, read by
``python -m repro_torch.launch.serve --ckpt D``) and resumes from the
latest one there, the data pipeline starting at the resumed step.

Under a mesh every rank runs this same command.  ``--mesh single`` /
``multi`` is the reference's production mesh
(``launch.mesh.make_production_mesh``: 256 or 512 ranks, which fail with
``make_mesh``'s error without such a process group); beyond the
reference, ``--mesh-shape D,M`` trains on a ``(data, model)`` mesh of D x
M ranks.  A process group not yet initialized is initialized from the
environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``,
as ``torchrun`` sets them) with ``--dist-backend`` (gloo by default: ranks
sharing one card cannot use NCCL), and destroyed at the end.  Every rank
holds the whole train state and trains on its rows of each global batch
(``train.step.data_parallel``); checkpoints are sharded one file a host
coordinate.  Only rank 0 prints.  The MoE family's load-balancing term,
a statistic of the whole batch, is summed over the data axes
(``dist.parallel.batch_sum``).

Every decoder-only family trains: dense, MoE (cross entropy plus ``0.01
x`` the load-balancing term), and vlm, ssm and hybrid.  A vlm model
trains text-only on the bigram stream, as the reference's launcher
trains it.  The encoder-decoder family is refused before the model is
built (``NotImplementedError``): the stream yields no ``frames``, so the
reference's launcher fails at its first step (``KeyError: 'frames'``);
train it through :class:`~repro_torch.train.Trainer` on
``data.lm_batch_for`` batches, which carry frames.

``main(argv)`` returns the :class:`~repro_torch.train.Trainer` it ran;
``make_trainer(args)`` builds the launcher's trainer without running it
(what ``repro_torch.train.loop.run_with_restarts`` rebuilds after a
crash).
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional


def build_parser() -> argparse.ArgumentParser:
    from ..configs import REGISTRY
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True, choices=sorted(REGISTRY))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--tiny", action="store_true", default=True)
    ap.add_argument("--no-tiny", dest="tiny", action="store_false")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0 = the "
                         "config's)")
    ap.add_argument("--quant-mode", default="fake",
                    choices=["none", "bitplane", "fake"])
    ap.add_argument("--act-bits", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--requant-every", type=int, default=50)
    ap.add_argument("--delta-alpha", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda",
                    help="device to train on (cuda raises without a card)")
    ap.add_argument("--mesh", default="none",
                    choices=["none", "single", "multi"])
    ap.add_argument("--mesh-shape", default="",
                    help="D,M: train on a (data, model) process mesh of "
                         "D x M ranks")
    ap.add_argument("--dist-backend", default="gloo",
                    help="the process group's backend when this launcher "
                         "initializes it")
    return ap


def config(args):
    """The model config of parsed launcher arguments."""
    from ..configs import REGISTRY, QuantConfig
    cfg = REGISTRY[args.arch]
    if args.tiny:
        cfg = cfg.tiny(dtype="float32")
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if args.quant_mode == "none":
        return cfg.with_quant(QuantConfig(mode="none"))
    if args.tiny:
        return cfg.with_quant(QuantConfig(mode=args.quant_mode, n_bits=8,
                                          act_bits=args.act_bits))
    return cfg.with_quant(dataclasses.replace(
        cfg.quant, mode=args.quant_mode, n_bits=8, act_bits=args.act_bits))


def make_mesh_of(args):
    """The mesh ``--mesh`` / ``--mesh-shape`` name (None for neither),
    over the process group, which is initialized from the environment
    first when it is not yet (the caller then destroys it)."""
    import os

    import torch
    import torch.distributed as dist

    from .mesh import make_mesh, make_production_mesh
    if args.mesh == "none" and not args.mesh_shape:
        return None
    if args.mesh != "none" and args.mesh_shape:
        raise SystemExit("--mesh and --mesh-shape are exclusive")
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        dist.init_process_group(args.dist_backend, init_method="env://")
    dev = torch.device(args.device).type
    if args.mesh_shape:
        shape = tuple(int(x) for x in args.mesh_shape.split(","))
        return make_mesh(shape, ("data", "model"), dev)
    return make_production_mesh(multi_pod=args.mesh == "multi",
                                device_type=dev)


def make_trainer(args):
    """The launcher's trainer over a fresh seed-0 init (not yet restored
    from ``--ckpt-dir``)."""
    from ..models.api import build
    from ..models.transformer import check_trainable
    from ..optim import adamw, cosine_schedule
    from ..train import Trainer, TrainerConfig
    cfg = config(args)
    check_trainable(cfg)
    if cfg.is_encdec:
        raise NotImplementedError(
            f"the launcher does not train the {cfg.family!r} family "
            f"(encoder-decoder, {cfg.name}): its bigram stream carries no "
            f"frames, so the loss has no encoder input (the reference's "
            f"launcher fails at its first step with KeyError: 'frames'); "
            f"train it through Trainer on repro_torch.data.lm_batch_for "
            f"batches")
    api = build(cfg)
    params = api.init(seed=0, device=args.device)
    return Trainer(
        api.loss, adamw(weight_decay=0.0), cosine_schedule(2e-3, args.steps),
        params,
        TrainerConfig(total_steps=args.steps,
                      ckpt_every=max(args.steps // 4, 1)
                      if args.ckpt_dir else 0,
                      ckpt_dir=args.ckpt_dir,
                      log_every=max(args.steps // 10, 1),
                      requant_interval=args.requant_every,
                      alpha_round_steps=args.requant_every,
                      delta_alpha=args.delta_alpha))


def main(argv: Optional[List[str]] = None):
    import torch.distributed as dist

    from ..data import make_lm_pipeline
    from ..dist.sharding import use_mesh
    args = build_parser().parse_args(argv)
    owned = not dist.is_initialized()
    try:
        mesh = make_mesh_of(args)
        with use_mesh(mesh):
            trainer = make_trainer(args)
            resumed = trainer.try_restore()
            data = make_lm_pipeline(config(args), args.seq, args.batch,
                                    start_step=resumed)
            trainer.run(data, steps=args.steps)
        rank = dist.get_rank() if mesh is not None else 0
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()
    if rank == 0:
        for h in trainer.history:
            print(f"step {h['step']:6d} ce={h['ce']:.4f} "
                  f"bits={h['avg_bitwidth']:.2f} "
                  f"comp={h['compression_x']:.1f}x")
    return trainer


if __name__ == "__main__":
    main()
