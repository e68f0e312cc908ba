"""The CUDA kernels against their plain twins, on the card.

Marked `cuda`: each test skips where no CUDA device is present (decided in
the fixture, at run time). This file imports no jax, so it runs on a
machine with only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_cuda.py

(`--noconftest` skips tests/conftest.py, which configures jax.)
"""
import pytest
import torch

from otto_tpu_torch.ops.kernels import gather, segscan


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize(
    "B,S,P,W", [(3, 9, 300, 300), (1, 1000, 104, 150), (2, 7, 4000, 4000),
                (2, 5, 15000, 3)],
)
def test_cuda_gather_matches_twin(cuda_device, dtype, B, S, P, W):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    vals = torch.randint(-1000, 1000, (B, S, P), generator=g,
                         device=cuda_device).to(dtype)
    idx = torch.randint(0, P, (S, W), generator=g, device=cuda_device,
                        dtype=torch.int32)
    before = gather.launches
    got = gather.gather_rows(vals, idx, check=True)
    torch.cuda.synchronize()
    assert gather.launches == before + 1
    assert torch.equal(got, gather.gather_rows_ref(vals, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("red", ["sum", "min", "max"])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("P", [1, 31, 1000])
def test_cuda_segscan_matches_twin(cuda_device, red, dtype, P):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    B, S = 3, 9
    vals = torch.randint(-50, 50, (B, S, P), generator=g,
                         device=cuda_device).to(dtype)
    first = torch.rand((S, P), generator=g, device=cuda_device) < 0.05
    before = segscan.launches
    got = segscan.segmented_scan(vals, first, red)
    torch.cuda.synchronize()
    assert segscan.launches == before + 1
    # small integer values: float sums are exact in any order here
    assert torch.equal(got, segscan.segmented_scan_ref(vals, first, red))
