"""CIFAR CNN launcher: ``python -m repro_torch.launch.cifar [...]`` (port of
``examples/cifar_bwq.py``, the paper's Table II + Fig. 9 pipeline, with
the logic of ``benchmarks/common.py::train_quantized_cnn`` and
``cnn_accuracy``).

For each ``--scheme`` it trains a CIFAR-style CNN on the synthetic
template stream (``SyntheticCIFAR``, batches of ``--batch``, noise 0.5):

* ``float`` — no quantization;
* ``bsq``   — BWQ-A bit-plane mode with one whole-layer block (the BSQ
  baseline);
* ``bwq``   — BWQ-A bit-plane mode at the paper's 9x8 OU-sized blocks.

Training is SGD (momentum 0.9, weight decay 1e-4) under a cosine schedule
from 0.05, with re-quantization and precision adjustment every
``--requant-every`` steps and alpha raised by ``DELTA_ALPHA`` at each of
them (quantized schemes), ``ACT_BITS``-bit PACT activations.  Each
scheme reports its accuracy on ``--eval-batches`` held-out batches of 128
(steps 50,000 on, seed 0) and its ``quant_stats`` compression.  The BWQ
tree is deployed (``--deploy-bits``; the bit-plane layout under
``--backend bitplane``) and its accuracy is measured again through
``--backend``: ``kernel`` runs every conv through ``packed_matmul``,
``bitplane`` through ``bitplane_matmul``.  The BWQ-H simulator then reads
the trained bit-width maps: BWQ-H against ISAAC (and BSQ at its trained
bits against ISAAC, on the BSQ tree), speedup and energy saving, with
``SIM_POSITIONS`` VMM invocations a layer at ``SIM_ACT_BITS``-bit inputs as
the reference's example.  These are outputs of an analytical ReRAM model, not measurements.

Defaults are the reference's models at full width: ResNet-20 (widths
16/32/64) or VGG-16-BN (to 512) on 32x32x3 images, 10 classes.
``--tiny`` runs ResNet-8 on 8x8 images, or VGG-11 on 32x32 (five 2x2
pools need 32 pixels), at batch 4 with one eval batch of 4.  Everything
runs on ``--device`` (default ``cuda``; the launcher raises without a card
unless given ``--device cpu``).

``main(argv)`` returns a dict: per scheme its metrics (``results``) and
its :class:`~repro_torch.train.Trainer` (``trainers``), the BWQ deploy
(``deployed``) and the simulator's figures (``sim``).
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional

PAPER_WB = dict(wb_rows=9, wb_cols=8)      # OU-sized blocks (paper)
BSQ_WB = dict(wb_rows=0, wb_cols=0)        # whole-layer blocks (BSQ)
SCHEMES = ("float", "bsq", "bwq")
DEFAULT_DEPTH = {"resnet": 20, "vgg": 16}
TINY_DEPTH = {"resnet": 8, "vgg": 11}
EVAL_STEP = 50_000                         # held-out batches start here
SEED = 0
ACT_BITS = 8                               # PACT activations while training
DELTA_ALPHA = 5e-3                         # alpha raised at each requant
SIM_POSITIONS, SIM_ACT_BITS = 64, 3        # simulator: VMMs a layer, bits


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.cifar")
    ap.add_argument("--model", default="resnet", choices=["resnet", "vgg"])
    ap.add_argument("--depth", type=int, default=0,
                    help="0 = ResNet-20 / VGG-16 (ResNet-8 / VGG-11 with "
                         "--tiny)")
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--scheme", nargs="+", default=list(SCHEMES),
                    choices=SCHEMES)
    ap.add_argument("--backend", default="kernel",
                    choices=["dense", "kernel", "bitplane", "ref"])
    ap.add_argument("--deploy-bits", type=int, default=8, choices=[8, 4])
    ap.add_argument("--requant-every", type=int, default=40)
    ap.add_argument("--eval-batches", type=int, default=4)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="device to run on (cuda raises without a card)")
    return ap


def geometry(args) -> Dict[str, int]:
    """depth, image side, eval batch of parsed arguments."""
    tiny = args.tiny
    depth = args.depth or (TINY_DEPTH if tiny else DEFAULT_DEPTH)[args.model]
    image = 8 if tiny and args.model == "resnet" else 32
    return dict(depth=depth, image=image, eval_batch=4 if tiny else 128,
                eval_batches=1 if tiny else args.eval_batches)


def quant_config(scheme: str, act_bits: int = ACT_BITS):
    from ..configs.base import QuantConfig
    if scheme == "float":
        return QuantConfig(mode="none")
    wb = PAPER_WB if scheme == "bwq" else BSQ_WB
    return QuantConfig(mode="bitplane", n_bits=8, act_bits=act_bits, **wb)


def optimizer():
    """The reference trainer's SGD (its weight decay reaches every float
    leaf, the frozen quantization metadata too, as the reference's)."""
    from ..optim import sgd
    return sgd(momentum=0.9, weight_decay=1e-4)


def lr_schedule(steps: int):
    from ..optim import cosine_schedule
    return cosine_schedule(0.05, steps)


def train_quantized_cnn(scheme: str, args, device):
    """Train one scheme's CNN: ``(qc, apply_fn, trainer)``."""
    from ..data import SyntheticCIFAR
    from ..models.cnn import MODELS, cnn_loss
    from ..train import Trainer, TrainerConfig
    geo = geometry(args)
    qc = quant_config(scheme)
    init_fn, apply_fn = MODELS[args.model]
    params = init_fn(qc, depth=geo["depth"], seed=SEED, device=device)

    def loss_fn(p, b):
        return cnn_loss(apply_fn, p, b, qc)

    steps = args.steps
    q = qc.enabled
    tr = Trainer(loss_fn, optimizer(), lr_schedule(steps), params,
                 TrainerConfig(total_steps=steps,
                               log_every=max(steps // 6, 1),
                               requant_interval=args.requant_every if q else 0,
                               alpha_round_steps=args.requant_every if q
                               else 0,
                               delta_alpha=DELTA_ALPHA if q else 0.0))
    gen = SyntheticCIFAR(image=geo["image"], batch=args.batch, noise=0.5,
                         seed=SEED)

    def data():
        step = 0
        while True:
            yield step, gen.batch_at(step)
            step += 1

    tr.run(data(), steps=steps)
    return qc, apply_fn, tr


def eval_batches(args) -> List[Dict[str, Any]]:
    """The held-out batches ``cnn_accuracy`` scores (host tensors)."""
    from ..data import SyntheticCIFAR
    geo = geometry(args)
    gen = SyntheticCIFAR(image=geo["image"], batch=geo["eval_batch"],
                         noise=0.5, seed=0)
    return [gen.batch_at(EVAL_STEP + i) for i in range(geo["eval_batches"])]


def cnn_accuracy(apply_fn, params, qc, batches, device,
                 backend: str = "dense") -> float:
    import torch
    accs = []
    with torch.no_grad():
        for b in batches:
            logits = apply_fn(params, b["images"].to(device), qc, backend)
            accs.append(float(torch.mean(
                (torch.argmax(logits, -1).cpu() == b["labels"].long())
                .to(torch.float32))))
    return sum(accs) / len(accs)


def simulate(params_by_scheme: Dict[str, Any],
             stats: Dict[str, Dict]) -> Dict[str, Dict]:
    """BWQ-H against ISAAC on the BWQ tree's learned maps; BSQ at its
    trained bits (rounded, at least 1) against ISAAC on the BSQ tree's
    layers.  Analytical ReRAM-model outputs."""
    from ..hw import (bsq_scheme, bwq_scheme, isaac_scheme,
                      speedup_and_energy_saving, workloads_from_params)
    out = {}
    if "bwq" in params_by_scheme:
        wls = workloads_from_params(params_by_scheme["bwq"],
                                    positions=SIM_POSITIONS,
                                    act_bits=SIM_ACT_BITS)
        sp, en = speedup_and_energy_saving(wls, bwq_scheme(), isaac_scheme())
        out["bwq_vs_isaac"] = dict(speedup_x=sp, energy_saving_x=en,
                                   layers=len(wls))
    if "bsq" in params_by_scheme:
        bits = max(1, round(stats["bsq"]["avg_bitwidth"]))
        wls = workloads_from_params(params_by_scheme["bsq"],
                                    positions=SIM_POSITIONS,
                                    act_bits=SIM_ACT_BITS)
        sp, en = speedup_and_energy_saving(wls, bsq_scheme(bits),
                                           isaac_scheme())
        out["bsq_vs_isaac"] = dict(speedup_x=sp, energy_saving_x=en,
                                   layers=len(wls), layer_bits=bits)
    return out


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    from ..core.device import resolve_device
    from ..serve.deploy import default_deploy_layout, to_serving_params
    from ..train.step import quant_stats
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    batches = eval_batches(args)
    results: Dict[str, Dict] = {}
    trainers, trained = {}, {}
    deployed = None
    for scheme in args.scheme:
        t0 = time.perf_counter()
        qc, apply_fn, tr = train_quantized_cnn(scheme, args, device)
        params = tr.state.params
        st = {k: float(v) for k, v in quant_stats(params).items()}
        res = dict(train_s=time.perf_counter() - t0,
                   loss=[h["loss"] for h in tr.history],
                   acc=cnn_accuracy(apply_fn, params, qc, batches, device),
                   **st)
        if scheme == "bwq":
            layout = default_deploy_layout(args.backend)
            deployed = to_serving_params(params, args.deploy_bits,
                                         layout=layout, device=device)
            res.update(deploy=dict(bits=args.deploy_bits, layout=layout,
                                   backend=args.backend),
                       acc_deployed=cnn_accuracy(apply_fn, deployed, qc,
                                                 batches, device,
                                                 args.backend))
        results[scheme] = res
        trainers[scheme], trained[scheme] = tr, params
        line = (f"{scheme:6s} acc={res['acc']:.3f} "
                f"compression={res['compression_x']:.1f}x")
        if "acc_deployed" in res:
            line += (f" deployed int{args.deploy_bits} {args.backend}: "
                     f"acc={res['acc_deployed']:.3f}")
        print(line)
    sim = simulate({k: v for k, v in trained.items() if k != "float"},
                   results)
    for name, r in sim.items():
        print(f"{name} (ReRAM simulator): {r['speedup_x']:.2f}x speedup, "
              f"{r['energy_saving_x']:.2f}x energy")
    return dict(args=vars(args), geometry=geometry(args), results=results,
                trainers=trainers, deployed=deployed, sim=sim)


if __name__ == "__main__":
    main()
