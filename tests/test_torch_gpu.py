"""The paged MLA attention CUDA kernels (K1 decode, K2 chunked prefill)
against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA device (the
kernels have no CPU mode); on a machine with one:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

The module imports no JAX, so it runs where only PyTorch is installed.
Shapes and adversarial tables are those of the CPU parity tests in
``tests/test_torch_kernels.py``.  Tolerances: f32 1e-4 (summation order
and exp/exp2 rounding, ~1e-6 measured on an H100); bf16 2e-2 (one bf16
step of the output, 2^-6 at |o| < 4, plus that noise).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref as tref
from repro_torch.kernels.mla_decode import mla_decode_paged_kernel
from repro_torch.kernels.mla_prefill import mla_prefill_paged_kernel

pytestmark = pytest.mark.gpu

DECODE_CASES = [
    (3, 4, 32, 8, 16, 4, 16, [37, 0, -1]),   # ragged, first token, inactive
    (2, 8, 64, 16, 4, 6, 10, [15, 23]),      # block-boundary ends
    (4, 2, 16, 8, 4, 5, 7, [19, 3, 4, -1]),  # interleaved, tiny blocks
    (8, 128, 512, 64, 16, 9, 80, [143, 0, 16, 15, 100, -1, 64, 31]),
]
PREFILL_CASES = [
    (3, 6, 4, 32, 8, 4, 8, 16, [0, 5, 11], [6, 3, 0]),   # first, ragged, idle
    (2, 8, 8, 64, 16, 8, 3, 8, [8, 15], [8, 1]),         # boundary + 1-tail
    (2, 5, 4, 32, 8, 16, 2, 6, [0, 27], [5, 5]),         # deep start
    (3, 32, 128, 512, 64, 16, 9, 40, [0, 100, 20], [32, 17, 0]),
]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _on(dev, dtype, *arrays):
    out = [torch.from_numpy(np.array(a)).to(dev) for a in arrays]
    return [t.to(dtype) if t.is_floating_point() else t for t in out]


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_kernel_on_card(case, dtype, tol):
    dev = _cuda()
    B, H, Dl, Dr, bs, nb, N, idx = case
    rng = np.random.default_rng(0)
    args = _on(dev, dtype, rng.standard_normal((B, H, Dl + Dr)),
               rng.standard_normal((N, bs, Dl)),
               rng.standard_normal((N, bs, Dr)),
               rng.integers(0, N, (B, nb)).astype(np.int32),
               np.asarray(idx, np.int32))
    for rescale in tref.RESCALES:
        got = mla_decode_paged_kernel(*args, rescale=rescale)
        _close(got, tref.mla_decode_paged_ref(*args, rescale=rescale), tol)
        assert (got[torch.as_tensor(idx) < 0] == 0).all()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", PREFILL_CASES)
def test_prefill_kernel_on_card(case, dtype, tol):
    dev = _cuda()
    B, C, H, Dl, Dr, bs, nb, N, lengths, n_valid = case
    rng = np.random.default_rng(1)
    args = _on(dev, dtype, rng.standard_normal((B, C, H, Dl + Dr)),
               rng.standard_normal((N, bs, Dl)),
               rng.standard_normal((N, bs, Dr)),
               rng.integers(0, N, (B, nb)).astype(np.int32),
               np.asarray(lengths, np.int32), np.asarray(n_valid, np.int32))
    for rescale in tref.RESCALES:
        got = mla_prefill_paged_kernel(*args, rescale=rescale)
        _close(got, tref.mla_prefill_paged_ref(*args, rescale=rescale), tol)
        for b in range(B):
            assert (got[b, n_valid[b]:] == 0).all()


def test_kernel_rejects_what_it_does_not_take():
    dev = _cuda()
    q = torch.zeros((2, 4, 40), device=dev)
    ckv = torch.zeros((6, 4, 32), device=dev)
    krope = torch.zeros((6, 4, 8), device=dev)
    bt = torch.zeros((2, 3), dtype=torch.int32, device=dev)
    idx = torch.zeros(2, dtype=torch.int32, device=dev)
    for bad in (dict(q=q.half()), dict(bt=bt.long()),
                dict(ckv=torch.zeros((6, 4, 24), device=dev),
                     q=torch.zeros((2, 4, 32), device=dev)),
                dict(q=q.transpose(0, 1).contiguous().transpose(0, 1)),
                dict(idx=idx.cpu())):
        a = dict(q=q, ckv=ckv, krope=krope, bt=bt, idx=idx, **{})
        a.update(bad)
        with pytest.raises(ValueError):
            mla_decode_paged_kernel(a["q"], a["ckv"], a["krope"], a["bt"],
                                    a["idx"])
    before = mla_decode_paged_kernel.launches
    mla_decode_paged_kernel(q, ckv, krope, bt, idx)
    torch.cuda.synchronize()
    assert mla_decode_paged_kernel.launches == before + 1
