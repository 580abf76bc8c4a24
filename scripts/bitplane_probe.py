#!/usr/bin/env python3
"""How the per-block bit-width draw of a full-width phi3 bit-plane tree
shapes greedy decoding, on one NVIDIA GPU, run from the repository root:

    python3 scripts/bitplane_probe.py

For each draw (16 tokens, B=4 prompts of 128): the tokens, and the drafts
accepted by speculative decoding for each (speculate_planes, draft_gamma)
of ``chip_smoke.SPEC``, quantizer-free and with 8-bit activations and an
int8 KV cache.  It is the evidence for ``chip_smoke.BW_PROB``.  (The
kernel's own timings are ``scripts/matmul_probe.py``'s.)
"""
import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

DRAWS = {"uniform": [1.0] * 9, "high": [1] * 6 + [6] * 3,
         "mostly8": [1] * 8 + [16]}


def draws():
    from repro_torch.configs import REGISTRY
    from repro_torch.models.api import build
    from repro_torch.serve.deploy import to_serving_params
    from repro_torch.serve.engine import ServeEngine
    qat = build(REGISTRY[cs.ARCH]).init(seed=0, device="cuda")
    tok = torch.randint(0, REGISTRY[cs.ARCH].vocab, (cs.B, cs.P),
                        generator=torch.Generator(device="cuda")
                        .manual_seed(3), device="cuda", dtype=torch.int32)
    for name, p in DRAWS.items():
        g = torch.Generator(device="cuda").manual_seed(7)
        pr = torch.tensor(p, dtype=torch.float, device="cuda")
        layers = dict(qat["layers"])
        for sub, leaf in cs.LAYER_LEAVES:
            fq = layers[sub][leaf]
            bw = torch.multinomial(pr, fq.bitwidth.numel(), replacement=True,
                                   generator=g).reshape(fq.bitwidth.shape)
            layers[sub] = dict(layers[sub])
            layers[sub][leaf] = dataclasses.replace(fq, bitwidth=bw.float())
        bp = to_serving_params(dict(qat, layers=layers), 8, layout="bitplane",
                               device="cuda")
        for act, kv in ((32, 32), (8, 8)):
            api = cs.api_for(act)
            eng = ServeEngine(api, bp, kv_quant_bits=kv, backend="bitplane",
                              attn_backend="fused", device="cuda")
            r = cs.greedy(eng, tok, 16)
            print(name, act, kv, "tokens", r["tokens"][:, :10].tolist(),
                  flush=True)
            for k, gm in cs.SPEC:
                e2 = ServeEngine(api, bp, kv_quant_bits=kv,
                                 backend="bitplane", attn_backend="fused",
                                 speculate_planes=k, draft_gamma=gm,
                                 device="cuda")
                s = cs.spec_drive(e2, tok, 16)
                print(name, act, kv, "spec", k, gm, s["accepted_drafts"],
                      s["drafted"], "same",
                      bool(torch.equal(s["tokens"], r["tokens"])),
                      cs.compare(s, r)["err"], flush=True)
        del bp


def main() -> int:
    if not torch.cuda.is_available():
        print("bitplane_probe: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    draws()
    return 0


if __name__ == "__main__":
    sys.exit(main())
