"""Hand-written CUDA kernels of the serving path, each beside its plain
PyTorch version.

packed_matmul   — int8/int4 per-WB-scale dequant matmul (deployment)
paged_attention — fused paged decode attention with in-kernel KV dequant
"""
from .packed_matmul import packed_matmul
from .paged_attention import paged_attention
from . import ref

KERNELS = (packed_matmul, paged_attention)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}
