"""Hand-written CUDA kernels, each beside its plain PyTorch version.

packed_matmul   — int8/int4 per-WB-scale dequant matmul (packed layout)
bitplane_matmul — bit-plane-sliced mixed-precision matmul (bit-plane
                  layout; also the speculative draft)
paged_attention — fused paged decode attention with in-kernel KV dequant
pact_quant      — fused PACT clip + quantize (on no model path)
"""
from .bitplane_matmul import bitplane_matmul
from .packed_matmul import packed_matmul
from .pact_kernel import pact_quant
from .paged_attention import paged_attention
from . import ref

KERNELS = (packed_matmul, paged_attention, bitplane_matmul, pact_quant)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}
