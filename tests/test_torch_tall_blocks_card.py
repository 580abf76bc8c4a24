"""Weight blocks taller than the stream regime's x stage (wbr = 3072 > 2048
rows: BSQ's whole-layer blocks) through both weight-matmul kernels on the
card, against their plain versions, within 1e-4 of the largest output
(``chip_smoke.PM_TOL_REL`` / ``BM_TOL_REL``).  The stream plan cuts such
a block into K slices on unit rows (``kernels.tiling._plan``); the plan
itself is checked on the CPU in tests/test_torch_matmul_plan.py.  Needs
an NVIDIA GPU and skips without one; ``python3 chip_smoke.py``'s kernel
phase runs the same shapes on the card.
"""
import pytest

torch = pytest.importorskip("torch")

TOL_REL = 1e-4
WBR, WBC, N = 3072, 128, 3072


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


def _operands(fmt, m, k, dev):
    g = torch.Generator(device=dev).manual_seed(m + k)
    gr, gc = -(-k // WBR), N // WBC
    x = torch.randn((m, k), generator=g, device=dev)
    scale = torch.rand((gr, gc), generator=g, device=dev) * 1e-2 + 1e-3
    if fmt == "bitplane":
        rows8 = gr * WBR // 8
        planes = torch.randint(0, 256, (8, rows8, N), generator=g,
                               device=dev, dtype=torch.uint8)
        sign = torch.randint(0, 256, (rows8, N), generator=g, device=dev,
                             dtype=torch.uint8)
        occ = torch.randint(0, 9, (gr, gc), generator=g, device=dev)
        mask = (torch.arange(8, device=dev)[:, None, None] < occ).float()
        return x, (planes, sign, mask, scale)
    if fmt == "int8":
        w = torch.randint(-128, 128, (gr * WBR, N), generator=g, device=dev,
                          dtype=torch.int32).to(torch.int8)
    else:
        w = torch.randint(0, 256, (gr * WBR // 2, N), generator=g,
                          device=dev, dtype=torch.int32).to(torch.uint8)
    return x, (w, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["int8", "int4", "bitplane"])
@pytest.mark.parametrize("m,k", [(4, 3072), (8, 8192), (16, 3072)])
def test_tall_blocks_match_plain_on_card(cuda_device, fmt, m, k):
    from repro_torch.kernels import bitplane_matmul, packed_matmul
    from repro_torch.kernels.ref import bitplane_matmul_ref, packed_matmul_ref
    from repro_torch.kernels.tiling import matmul_plan
    torch.backends.cuda.matmul.allow_tf32 = False
    x, ops = _operands(fmt, m, k, cuda_device)
    unit = {"int8": 1, "int4": 2, "bitplane": 8}[fmt]
    assert matmul_plan(m, k, N, unit=unit, wbr=WBR).regime == "stream"
    if fmt == "bitplane":
        got = bitplane_matmul(x, *ops, wbr=WBR, wbc=WBC)
        want = bitplane_matmul_ref(x, *ops, WBR, WBC)
    else:
        bits = 8 if fmt == "int8" else 4
        got = packed_matmul(x, *ops, bits=bits, wbr=WBR, wbc=WBC)
        want = packed_matmul_ref(x, *ops, bits, WBR, WBC)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    assert err <= TOL_REL * float(want.abs().max()), err
    assert bool(torch.isfinite(got).all())
