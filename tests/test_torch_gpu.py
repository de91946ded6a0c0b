"""The CUDA kernels against their plain PyTorch versions, on the card: the
paged MLA attention kernels (K1 decode, K2 chunked prefill; bf16 / f32
and int8 / fp8 pools), the contiguous-cache decode kernel K3 and flash
attention (K4 forward, K5 dQ, K6 dK/dV), and one bf16 training step of
the smoke model with the flash kernels against the dense path.  bf16 K1,
K2 and K3 run the tensor-core split walk (csrc/mla_decode_tc.cuh); its
cases put indices around split boundaries and are also held against the
walk's CPU models ``ref.mla_decode_split_ref`` and
``ref.mla_prefill_split_ref`` with the wrapper's plan.  bf16 K4 runs the
tensor-core walk of csrc/flash_attention_fwd_tc.cuh and bf16 K5 / K6 the
walks of csrc/flash_attention_bwd_tc.cuh; their cases put query tiles,
the causal diagonal, windows and offsets across tile edges, drive K6's
loop over GQA / MQA query heads and check the route each launch recorded
(``last_plan``).  The seeded sampler's PRNG (``runtime.prng``) gives
the Random123 known answers on the card and the CPU's bits, and the
sampler the CPU's tokens except where a row's two best perturbed scores
lie within a few ulps (the Gumbel noise's two logarithms may round
differently on the two devices).

Every test here is marked ``gpu`` and skips without a CUDA device (the
kernels have no CPU mode); on a machine with one:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

The module imports no JAX, so it runs where only PyTorch is installed.
Shapes and adversarial tables are those of the CPU parity tests in
``tests/test_torch_kernels.py``.  Tolerances: f32 1e-4 (summation order
and exp/exp2 rounding, ~1e-6 measured on an H100); bf16 2e-2 (one bf16
step of the output, 2^-6 at |o| < 4, plus that noise).  Flash attention
is held row by row (``_row_close``: the largest |a_r - b_r| / |b_r| of a
query's out or dQ, a key's dK or dV), f32 1e-4 and bf16
``FLASH_ROW_TOL``: bf16 rounds P and dS to bf16 for the tensor cores
where the plain versions keep f32, a few 2^-9 steps per element; a
skipped tile of 32 keys moves a row that sees n keys by ~sqrt(32 / n).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import cache as tcache
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ref as tref
from repro_torch.kernels.mla_decode import (mla_decode_kernel,
                                            mla_decode_paged_kernel)
from repro_torch.kernels.mla_prefill import mla_prefill_paged_kernel
from repro_torch.runtime import prng
from repro_torch.runtime.steps import sample_scores, sample_tokens

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


# (B, H, S, Dl, Dr, index): ragged S, the first token, a full cache, the
# widths of DeepSeek-V2 with an S that is no multiple of the tile
K3_CASES = [(2, 8, 100, 32, 8, 57), (1, 4, 64, 32, 8, 0),
            (1, 16, 256, 64, 16, 255), (3, 128, 2081, 512, 64, 2050)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", K3_CASES)
def test_contiguous_decode_kernel_on_card(case, dtype, tol):
    """K3 against its plain version, both rescales; the cache's tail past
    index poisoned with 1e4 must not matter; index -1 gives zero rows."""
    dev = _cuda()
    B, H, S, Dl, Dr, index = case
    g = torch.Generator(device=dev)
    g.manual_seed(S)
    q, ckv, krope = (torch.randn(shape, generator=g, device=dev).to(dtype)
                     for shape in ((B, H, Dl + Dr), (B, S, Dl), (B, S, Dr)))
    clean = [t.clone() for t in (ckv, krope)]
    ckv[:, index + 1:] = 1e4
    krope[:, index + 1:] = 1e4
    for rescale in tref.RESCALES:
        got = mla_decode_kernel(q, ckv, krope, index, rescale=rescale)
        _close(got, tref.mla_decode_ref(q, *clean, index, rescale=rescale),
               tol)
        _close(got, tref.mla_decode_ref(q, *clean, index), tol)
        assert (mla_decode_kernel(q, ckv, krope, -1, rescale=rescale)
                == 0).all()


def test_contiguous_decode_kernel_reads_strided_views():
    """Views of a larger cache (batch and position strides of the parent,
    an offset start) are read in place and agree with contiguous copies;
    one launch each."""
    dev = _cuda()
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    big = torch.randn((4, 50, 96), generator=g, device=dev)
    q = torch.randn((2, 8, 40), generator=g, device=dev)
    ckv, krope = big[::2, 5:42, :32], big[::2, 5:42, 64:72]
    assert not ckv.is_contiguous()
    before = mla_decode_kernel.launches
    got = mla_decode_kernel(q, ckv, krope, 30)
    want = mla_decode_kernel(q, ckv.contiguous(), krope.contiguous(), 30)
    torch.cuda.synchronize()
    _close(got, want, 1e-6)
    _close(got, tref.mla_decode_ref(q, ckv, krope, 30), 1e-4)
    assert mla_decode_kernel.launches == before + 2


# The tensor-core split walk of bf16 K3 / K1 (csrc/mla_decode_tc.cuh).
# K3 (B, H, S, index): on a 132-SM card B = 1, H = 64 splits the range
# into 64-position tiles and B = 8, H = 128 (index + 1 in 2049..2560)
# into 320-position splits, so these indices end one short of, on, and
# one past a split boundary; S = 40 is shorter than one split.
K3_SPLIT_CASES = [(1, 64, 300, 62), (1, 64, 300, 63), (1, 64, 300, 64),
                  (8, 128, 2300, 2238), (8, 128, 2300, 2239),
                  (8, 128, 2300, 2240), (8, 128, 40, 39)]
# K1: B = 4, H = 128 and 40 blocks of 16 give 10 splits of 64 positions
K1_SPLIT_INDICES = [[62, 63, 64, 639], [-1, 0, 127, 128]]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", K3_SPLIT_CASES)
def test_contiguous_decode_split_boundaries_on_card(case, dtype, tol):
    """K3 at indices around split boundaries, both rescales, held row by
    row and elementwise against the plain walk; bf16 (the tensor-core
    walk) also against the split walk's CPU model with the plan the
    wrapper launched, f32 runs the CUDA-core walk (no splits)."""
    dev = _cuda()
    B, H, S, index = case
    g = torch.Generator(device=dev)
    g.manual_seed(index)
    q, ckv, krope = (torch.randn(shape, generator=g, device=dev).to(dtype)
                     for shape in ((B, H, 576), (B, S, 512), (B, S, 64)))
    for rescale in tref.RESCALES:
        got = mla_decode_kernel(q, ckv, krope, index, rescale=rescale)
        torch.cuda.synchronize()
        plan = mla_decode_kernel.last_plan
        assert (plan["n_split"] > 0) == (dtype == torch.bfloat16), plan
        wants = [tref.mla_decode_ref(q, ckv, krope, index, rescale=rescale)]
        if plan["n_split"]:
            wants.append(tref.mla_decode_split_ref(
                q, ckv, krope, index, split_pos=plan["split_pos"],
                rescale=rescale))
        for want in wants:
            _row_close(got, want, tol)
            _close(got, want, tol)


@pytest.mark.parametrize("pool", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("idx", K1_SPLIT_INDICES)
def test_paged_decode_split_boundaries_on_card(idx, pool):
    """bf16 K1 on bf16 / int8 / fp8 pools at indices around its split
    boundaries (an inactive slot and a first token included) against the
    split walk's CPU model and the plain walk, both rescales."""
    dev = _cuda()
    B, H, Dl, Dr, bs, nb, N = 4, 128, 512, 64, 16, 40, 200
    if pool == "bf16":
        g = torch.Generator(device=dev)
        g.manual_seed(nb)
        ckv, krope = (torch.randn(s, generator=g, device=dev).bfloat16()
                      for s in ((N, bs, Dl), (N, bs, Dr)))
        qkw = {}
    else:
        ckv, krope, cs, rs = _quantized_pool(dev, N, bs, Dl, Dr, pool, nb)
        qkw = dict(ckv_scales=cs, krope_scales=rs)
    rng = np.random.default_rng(1)
    q, bt, ind = _on(dev, torch.bfloat16, rng.standard_normal((B, H, Dl + Dr)),
                     rng.permutation(np.arange(1, N))[:B * nb].reshape(
                         B, nb).astype(np.int32), np.asarray(idx, np.int32))
    for rescale in tref.RESCALES:
        got = mla_decode_paged_kernel(q, ckv, krope, bt, ind,
                                      rescale=rescale, **qkw)
        torch.cuda.synchronize()
        plan = mla_decode_paged_kernel.last_plan
        assert plan["n_split"] > 0, plan
        for want in (tref.mla_decode_split_ref(
                q, ckv, krope, ind, split_pos=plan["split_pos"],
                rescale=rescale, block_tables=bt, **qkw),
                tref.mla_decode_paged_ref(q, ckv, krope, bt, ind,
                                          rescale=rescale, **qkw)):
            _row_close(got, want, 2e-2)
            _close(got, want, 2e-2)
        assert (got[ind < 0] == 0).all()


@pytest.mark.parametrize("offset", [5, 3])
def test_contiguous_decode_kernel_reads_strided_bf16_views(offset):
    """bf16 views of a larger cache: position stride 96 and a 16-byte
    aligned start take the tensor-core walk; a position stride of 100
    elements (rows 8-byte aligned) takes the CUDA-core walk.  Each agrees
    with contiguous copies and the plain walk."""
    dev = _cuda()
    g = torch.Generator(device=dev)
    g.manual_seed(offset)
    width = 96 if offset == 5 else 100
    big = torch.randn((4, 150, width), generator=g, device=dev).bfloat16()
    q = torch.randn((2, 8, 40), generator=g, device=dev).bfloat16()
    ckv, krope = big[::2, offset:140, :32], big[::2, offset:140, 64:72]
    for rescale in tref.RESCALES:
        got = mla_decode_kernel(q, ckv, krope, 130, rescale=rescale)
        assert (mla_decode_kernel.last_plan["n_split"] > 0) == (width == 96)
        want = mla_decode_kernel(q, ckv.contiguous(), krope.contiguous(), 130,
                                 rescale=rescale)
        torch.cuda.synchronize()
        _close(got, want, 1e-6 if width == 96 else 2e-2)
        _close(got, tref.mla_decode_ref(q, ckv, krope, 130, rescale=rescale),
               2e-2)


def _quantized_pool(dev, N, bs, Dl, Dr, cache_dtype, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    qdtype, qmax = tcache.cache_dtype_info(cache_dtype)
    ckv, cs = tcache.quantize_latent(
        torch.randn((N, bs, Dl), generator=g, device=dev), qmax, qdtype)
    krope, rs = tcache.quantize_latent(
        torch.randn((N, bs, Dr), generator=g, device=dev), qmax, qdtype)
    return ckv, krope, cs, rs


@pytest.mark.parametrize("cache_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_quantized_paged_kernels_on_card(dtype, tol, cache_dtype):
    """K1 and K2 on an int8 / fp8 pool with per-slot scales against their
    plain versions given the same pool (both rescales), at the adversarial
    shapes of the bf16 cases (first token, inactive slot, idle rows)."""
    dev = _cuda()
    for (B, H, Dl, Dr, bs, nb, N, idx), pre in zip(DECODE_CASES,
                                                    PREFILL_CASES):
        ckv, krope, cs, rs = _quantized_pool(dev, N, bs, Dl, Dr,
                                             cache_dtype, N)
        rng = np.random.default_rng(0)
        q, bt, ind = _on(dev, dtype, rng.standard_normal((B, H, Dl + Dr)),
                         rng.integers(0, N, (B, nb)).astype(np.int32),
                         np.asarray(idx, np.int32))
        qkw = dict(ckv_scales=cs, krope_scales=rs)
        for rescale in tref.RESCALES:
            got = mla_decode_paged_kernel(q, ckv, krope, bt, ind,
                                          rescale=rescale, **qkw)
            _close(got, tref.mla_decode_paged_ref(
                q, ckv, krope, bt, ind, rescale=rescale, **qkw), tol)
        B, C, H, Dl, Dr, bs, nb, N, lengths, n_valid = pre
        ckv, krope, cs, rs = _quantized_pool(dev, N, bs, Dl, Dr,
                                             cache_dtype, N + 1)
        q, bt, ln, nv = _on(dev, dtype,
                            rng.standard_normal((B, C, H, Dl + Dr)),
                            rng.integers(0, N, (B, nb)).astype(np.int32),
                            np.asarray(lengths, np.int32),
                            np.asarray(n_valid, np.int32))
        qkw = dict(ckv_scales=cs, krope_scales=rs)
        for rescale in tref.RESCALES:
            got = mla_prefill_paged_kernel(q, ckv, krope, bt, ln, nv,
                                           rescale=rescale, **qkw)
            _close(got, tref.mla_prefill_paged_ref(
                q, ckv, krope, bt, ln, nv, rescale=rescale, **qkw), tol)


def test_quantized_kernels_reject_bad_scales():
    dev = _cuda()
    ckv, krope, cs, rs = _quantized_pool(dev, 6, 4, 32, 8, "int8", 0)
    q = torch.zeros((2, 4, 40), device=dev)
    bt = torch.zeros((2, 3), dtype=torch.int32, device=dev)
    idx = torch.zeros(2, dtype=torch.int32, device=dev)
    for bad in (dict(ckv_scales=cs), dict(krope_scales=rs),
                dict(ckv_scales=cs.double(), krope_scales=rs),
                dict(ckv_scales=cs[:, :2], krope_scales=rs),
                dict(ckv_scales=cs[..., 0], krope_scales=rs)):
        with pytest.raises(ValueError):
            mla_decode_paged_kernel(q, ckv, krope, bt, idx, **bad)
        with pytest.raises(ValueError):
            mla_prefill_paged_kernel(q[:, None], ckv, krope, bt, idx, idx,
                                     **bad)
    with pytest.raises(ValueError):              # codes without scales
        mla_decode_paged_kernel(q, ckv, krope, bt, idx)
    with pytest.raises(ValueError):              # scales on a float pool
        mla_decode_paged_kernel(q, ckv.float(), krope.float(), bt, idx,
                                ckv_scales=cs, krope_scales=rs)
    with pytest.raises(ValueError):              # K3 takes no int8 cache
        mla_decode_kernel(q, ckv[:2], krope[:2], 1)
    with pytest.raises(ValueError):              # a strided last dimension
        mla_decode_kernel(q, torch.zeros((2, 5, 64), device=dev)[..., ::2],
                          torch.zeros((2, 5, 8), device=dev), 1)
    before = mla_decode_paged_kernel.launches
    mla_decode_paged_kernel(q, ckv, krope, bt, idx, ckv_scales=cs,
                            krope_scales=rs)
    torch.cuda.synchronize()
    assert mla_decode_paged_kernel.launches == before + 1


# bf16 K2 on the tensor-core walk (csrc/mla_prefill_paged.cu, a CTA for
# 64 heads of one (request, chunk row)).  (B, C, H, Dl, Dr, bs, nb, N,
# lengths, n_valid): chunk rows whose limit lengths[b] + c falls on the
# 64-position tile edges 63 and 127 (and one past), n_valid < C, an idle
# request, a one-row chunk; then a table as wide as the pool (199 blocks:
# 11 splits of 320 positions on a 132-SM card, most of them empty for
# these rows).
PREFILL_TC_CASES = [
    (4, 8, 128, 512, 64, 16, 12, 60, [56, 124, 0, 3], [8, 5, 0, 1]),
    (3, 4, 64, 512, 64, 16, 199, 200, [300, 0, 1000], [4, 2, 3]),
]


@pytest.mark.parametrize("pool", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", PREFILL_TC_CASES)
def test_prefill_tc_route_boundaries_on_card(case, dtype, pool):
    """K2 at tile edges, with idle rows and a pool-wide table, both
    rescales: bf16 q runs the tensor-core walk (``last_plan`` n_split >
    0) and is held row by row and elementwise against the plain walk and
    the split walk's CPU model with the launched plan; f32 q stays on
    ``attend_rows`` (n_split 0).  Rows past n_valid are exactly 0."""
    dev = _cuda()
    B, C, H, Dl, Dr, bs, nb, N, lengths, n_valid = case
    if pool == "bf16":
        g = torch.Generator(device=dev)
        g.manual_seed(N)
        ckv, krope = (torch.randn(s, generator=g, device=dev).to(dtype)
                      for s in ((N, bs, Dl), (N, bs, Dr)))
        qkw = {}
    else:
        ckv, krope, cs, rs = _quantized_pool(dev, N, bs, Dl, Dr, pool, N)
        qkw = dict(ckv_scales=cs, krope_scales=rs)
    rng = np.random.default_rng(nb)
    bt = np.stack([rng.permutation(np.arange(1, N))[:nb] for _ in range(B)])
    q, bt, ln, nv = _on(dev, dtype, rng.standard_normal((B, C, H, Dl + Dr)),
                        bt.astype(np.int32), np.asarray(lengths, np.int32),
                        np.asarray(n_valid, np.int32))
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    for rescale in tref.RESCALES:
        got = mla_prefill_paged_kernel(q, ckv, krope, bt, ln, nv,
                                       rescale=rescale, **qkw)
        torch.cuda.synchronize()
        plan = mla_prefill_paged_kernel.last_plan
        assert (plan["n_split"] > 0) == (dtype == torch.bfloat16), plan
        wants = [tref.mla_prefill_paged_ref(q, ckv, krope, bt, ln, nv,
                                            rescale=rescale, **qkw)]
        if plan["n_split"]:
            assert plan["grid"] == (-(-H // 64), plan["n_split"], B * C)
            wants.append(tref.mla_prefill_split_ref(
                q, ckv, krope, bt, ln, nv, split_pos=plan["split_pos"],
                rescale=rescale, **qkw))
        for want in wants:
            _row_close(got, want, tol)
            _close(got, want, tol)
        for b in range(B):
            assert (got[b, n_valid[b]:] == 0).all()


# (B, H, Hkv, Lq, Lk, Dqk, Dv, window, q_offset), as the CPU parity grid
FLASH_CASES = [
    (1, 4, 4, 64, 64, 32, 32, None, 0),      # MHA
    (2, 4, 2, 48, 48, 16, 16, None, 0),      # GQA 2:1
    (1, 8, 1, 33, 70, 16, 24, None, 0),      # MQA, ragged, Dv != Dqk
    (1, 4, 2, 96, 96, 32, 32, 8, 0),         # window
    (1, 2, 2, 32, 64, 16, 16, None, 32),     # q_offset
    (2, 4, 4, 40, 40, 40, 24, None, 0),      # MLA-like 24 + 16 split
    (1, 2, 1, 100, 130, 576, 512, None, 0),  # the widest head dims
    (2, 4, 4, 70, 70, 192, 128, None, 0),    # DeepSeek-V2 head dims
    (1, 4, 2, 2112, 2112, 192, 128, None, 0),  # long: key tiles past 2048
]


FLASH_ROW_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


def _row_close(got, want, tol):
    """max_r |a_r - b_r| / |b_r| <= tol over the rows of the last
    dimension; a row under 1 % of the median row norm (dQ of query 0 is 0
    in exact arithmetic, noise on both sides) is measured against that
    1 %."""
    a = got.float().reshape(-1, got.shape[-1])
    b = want.float().reshape(-1, want.shape[-1])
    norm = b.norm(dim=-1)
    floor = (0.01 * norm.median()).clamp_min(1e-30)
    err = ((a - b).norm(dim=-1) / torch.maximum(norm, floor)).max().item()
    assert err <= tol, err


@pytest.mark.parametrize("layout", ["bhld", "blhd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernels_on_card(case, dtype, layout):
    """K4, K5, K6 against their plain versions; 'blhd' passes (B, L, H, D)
    tensors as transposed views, as the MLA path does."""
    dev = _cuda()
    B, H, Hkv, Lq, Lk, D, Dv, window, q_offset = case
    g = torch.Generator(device=dev)
    g.manual_seed(0)

    def rn(b, h, n, d):
        if layout == "bhld":
            return torch.randn((b, h, n, d), generator=g, device=dev).to(dtype)
        return torch.randn((b, n, h, d), generator=g, device=dev).to(
            dtype).transpose(1, 2)

    q, k, v, do = rn(B, H, Lq, D), rn(B, Hkv, Lk, D), rn(B, Hkv, Lk, Dv), \
        rn(B, H, Lq, Dv)
    kw = dict(causal=True, window=window, q_offset=q_offset, scale=D ** -0.5)
    out, lse = tfa.flash_fwd_kernel(q, k, v, **kw)
    out_p, lse_p = tfa.flash_fwd_plain(q, k, v, **kw)
    assert out.stride() == tuple(out.stride()) and \
        (out.transpose(1, 2).is_contiguous() == (layout == "blhd"))
    tol = FLASH_ROW_TOL[dtype]
    _row_close(out, out_p, tol)
    # the f32 lse: the same f32 scores summed in another order
    _close(lse, lse_p, 1e-4)
    delta = (do.float() * out_p.float()).sum(-1).contiguous()
    dq = tfa.flash_bwd_dq_kernel(q, k, v, do, lse_p, delta, **kw)
    dk, dv = tfa.flash_bwd_dkv_kernel(q, k, v, do, lse_p, delta, **kw)
    torch.cuda.synchronize()
    _row_close(dq, tfa.flash_bwd_dq_plain(q, k, v, do, lse_p, delta, **kw),
               tol)
    dk_p, dv_p = tfa.flash_bwd_dkv_plain(q, k, v, do, lse_p, delta, **kw)
    _row_close(dk, dk_p, tol)
    _row_close(dv, dv_p, tol)


# K4's tensor-core walk (csrc/flash_attention_fwd_tc.cuh: 128 query rows,
# 64 keys a tile): Lq off the 128-row query tile (200, 130, 257); the
# causal diagonal cutting key tiles mid-way (a query offset of 36 or
# 120); a window (alone and with an offset); GQA and MQA at the path's
# head dims; rows that attend no key at all (window 8 behind an offset
# of 100 over 32 keys: out 0, lse -2^30).
FLASH_TC_CASES = [
    (1, 4, 4, 200, 200, 192, 128, None, 0),
    (1, 2, 2, 100, 136, 64, 64, None, 36),
    (1, 2, 2, 130, 250, 128, 128, None, 120),
    (1, 4, 2, 257, 257, 192, 128, 100, 0),
    (1, 4, 4, 200, 330, 64, 48, 70, 130),
    (2, 8, 2, 190, 190, 192, 128, None, 0),
    (1, 8, 1, 129, 129, 256, 256, None, 0),
    (1, 2, 2, 64, 32, 32, 32, 8, 100),
]


@pytest.mark.parametrize("layout", ["bhld", "blhd"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", FLASH_TC_CASES)
def test_flash_fwd_tc_route_boundaries_on_card(case, dtype, layout):
    """K4 at the tensor-core walk's boundaries: bf16 runs the walk
    (``last_plan`` route 'tc', 128 x 64 tiles), f32 the WMMA kernel; out
    held row by row against the plain version, lse within 1e-4 (rows that
    attend no key: exactly -2^30)."""
    dev = _cuda()
    B, H, Hkv, Lq, Lk, D, Dv, window, q_offset = case
    g = torch.Generator(device=dev)
    g.manual_seed(Lq + Lk)

    def rn(b, h, n, d):
        if layout == "bhld":
            return torch.randn((b, h, n, d), generator=g, device=dev).to(dtype)
        return torch.randn((b, n, h, d), generator=g, device=dev).to(
            dtype).transpose(1, 2)

    q, k, v = rn(B, H, Lq, D), rn(B, Hkv, Lk, D), rn(B, Hkv, Lk, Dv)
    kw = dict(causal=True, window=window, q_offset=q_offset, scale=D ** -0.5)
    out, lse = tfa.flash_fwd_kernel(q, k, v, **kw)
    torch.cuda.synchronize()
    plan = tfa.flash_fwd_kernel.last_plan
    if dtype == torch.bfloat16:
        assert plan == dict(route="tc", tiles=(128, 64),
                            grid=(-(-Lq // 128), B * H)), plan
    else:
        assert plan["route"] == "wmma", plan
    out_p, lse_p = tfa.flash_fwd_plain(q, k, v, **kw)
    _row_close(out, out_p, FLASH_ROW_TOL[dtype])
    _close(lse, lse_p, 1e-4)
    if window is not None and Lk <= q_offset - window:   # no key seen
        assert (out == 0).all() and (lse == tfa.NEG_INF).all()


@pytest.mark.parametrize("layout", ["bhld", "blhd"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", FLASH_TC_CASES)
def test_flash_bwd_tc_route_boundaries_on_card(case, dtype, layout):
    """K5 and K6 at their tensor-core walks' boundaries
    (csrc/flash_attention_bwd_tc.cuh: 64-key tiles, 128 query rows a K5
    CTA, 64 keys a K6 CTA walking 64-query tiles over the G query heads):
    bf16 runs the walks (``last_plan`` route 'tc'), f32 the WMMA kernels;
    dQ, dK and dV held row by row against the plain versions.  GQA (8 : 2)
    and MQA (8 : 1) drive K6's head loop; rows that attend no key give
    finite, exactly zero gradients."""
    dev = _cuda()
    B, H, Hkv, Lq, Lk, D, Dv, window, q_offset = case
    g = torch.Generator(device=dev)
    g.manual_seed(Lq + 2 * Lk)

    def rn(b, h, n, d):
        if layout == "bhld":
            return torch.randn((b, h, n, d), generator=g, device=dev).to(dtype)
        return torch.randn((b, n, h, d), generator=g, device=dev).to(
            dtype).transpose(1, 2)

    q, k, v, do = rn(B, H, Lq, D), rn(B, Hkv, Lk, D), rn(B, Hkv, Lk, Dv), \
        rn(B, H, Lq, Dv)
    kw = dict(causal=True, window=window, q_offset=q_offset, scale=D ** -0.5)
    out_p, lse_p = tfa.flash_fwd_plain(q, k, v, **kw)
    delta = (do.float() * out_p.float()).sum(-1).contiguous()
    dq = tfa.flash_bwd_dq_kernel(q, k, v, do, lse_p, delta, **kw)
    dk, dv = tfa.flash_bwd_dkv_kernel(q, k, v, do, lse_p, delta, **kw)
    torch.cuda.synchronize()
    plans = (tfa.flash_bwd_dq_kernel.last_plan,
             tfa.flash_bwd_dkv_kernel.last_plan)
    if dtype == torch.bfloat16:
        rows = 128 if D <= 192 and Dv <= 128 else 64
        assert plans == (
            dict(route="tc", tiles=(rows, 64), grid=(-(-Lq // rows), B * H)),
            dict(route="tc", tiles=(64, 64), grid=(-(-Lk // 64), B * Hkv))), \
            plans
    else:
        assert [p["route"] for p in plans] == ["wmma", "wmma"], plans
    tol = FLASH_ROW_TOL[dtype]
    _row_close(dq, tfa.flash_bwd_dq_plain(q, k, v, do, lse_p, delta, **kw),
               tol)
    dk_p, dv_p = tfa.flash_bwd_dkv_plain(q, k, v, do, lse_p, delta, **kw)
    _row_close(dk, dk_p, tol)
    _row_close(dv, dv_p, tol)
    for grad in (dq, dk, dv):
        assert torch.isfinite(grad).all()
        if window is not None and Lk <= q_offset - window:   # no key seen
            assert (grad == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_function_gradients_on_card(dtype):
    """The autograd Function on the card against autograd through the
    dense oracle (GQA, window, offset), counting one launch each: f32
    elementwise within 5e-4; bf16 out, dQ, dK, dV each within 1e-2
    relative L2 as a whole (the Function takes delta from the bf16
    output, as the reference does, autograd from the exact one, which
    dominates dQ on rows whose softmax is nearly one-hot; ~2.5e-3 on an
    H100, a skipped key tile >= 0.03)."""
    dev = _cuda()
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    mk = lambda *s: torch.randn(s, generator=g, device=dev).to(
        dtype).requires_grad_()
    q, k, v = mk(2, 6, 50, 24), mk(2, 3, 80, 24), mk(2, 3, 80, 20)
    w = torch.randn((2, 6, 50, 20), generator=g, device=dev).to(dtype)
    before = (tfa.flash_fwd_kernel.launches, tfa.flash_bwd_dq_kernel.launches,
              tfa.flash_bwd_dkv_kernel.launches)
    grads = []
    for fn in (lambda: tfa.flash_attention(q, k, v, True, 24, 30),
               lambda: tref.flash_attention_ref(q, k, v, causal=True,
                                                window=24, q_offset=30)):
        q.grad = k.grad = v.grad = None
        out = fn()
        out.backward(w)
        grads.append([out.detach()] + [t.grad.clone() for t in (q, k, v)])
    for a, b in zip(*grads):
        if dtype == torch.float32:
            _close(a, b, 5e-4)
        else:
            assert _rel_l2(a, b) <= 1e-2
    assert (tfa.flash_fwd_kernel.launches, tfa.flash_bwd_dq_kernel.launches,
            tfa.flash_bwd_dkv_kernel.launches) == tuple(n + 1 for n in before)


def test_flash_kernels_reject_what_they_do_not_take():
    dev = _cuda()
    q = torch.zeros((1, 4, 8, 16), device=dev)
    k = torch.zeros((1, 2, 8, 16), device=dev)
    v = torch.zeros((1, 2, 8, 16), device=dev)
    kw = dict(scale=0.25)
    for bad in ((q.half(), k, v), (q, k.cpu(), v),
                (q, torch.zeros((1, 3, 8, 16), device=dev), v),
                (q, k, torch.zeros((1, 2, 9, 16), device=dev)),
                (torch.zeros((1, 4, 8, 16, 2), device=dev)[..., 0], k, v),
                (torch.zeros((1, 4, 8, 600), device=dev),
                 torch.zeros((1, 2, 8, 600), device=dev), v)):
        with pytest.raises(ValueError):
            tfa.flash_fwd_kernel(*bad, **kw)
    out, lse = tfa.flash_fwd_kernel(q, k, v, **kw)
    with pytest.raises(ValueError):      # lse must be f32 (B, H, Lq)
        tfa.flash_bwd_dq_kernel(q, k, v, out, lse.double(), lse, **kw)


# bf16 kernel path vs dense path on the smoke model's dense first layer
# (no router), per leaf |a - b| / |b|: the two round to bf16 at other
# points (P and dS for the tensor cores; the output), a few 2^-9 steps of
# the attention output carried through one layer and the head.
BF16_GRAD_REL_L2 = 5e-2


def _kernel_vs_ref_grads(cfg, params, toks, labels, dtype):
    """(loss, gradients) of ``lm_loss`` for impl 'kernel' and 'ref'."""
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime import lm_loss

    leaves = list(tree_leaves(params))
    out = {}
    for impl in ("ref", "kernel"):
        for t in leaves:
            t.requires_grad_(True)
        loss, _ = lm_loss(params, cfg, toks, labels, impl=impl,
                          compute_dtype=dtype)
        out[impl] = (loss.item(), torch.autograd.grad(loss, leaves))
        for t in leaves:
            t.requires_grad_(False)
    return out


def _rel_l2(a, b):
    a, b = a.float(), b.float()
    return (a - b).norm().item() / max(b.norm().item(), 1e-30)


def test_smoke_train_step_kernel_matches_ref_on_card():
    """The flash kernels against the dense attention path on the smoke
    model.  f32 at drop-free MoE capacity: the loss within 1e-5 relative,
    each leaf's gradient within 1e-4 relative L2 (summation order).  bf16
    on the dense first layer alone (in bf16 a near-tie in the top-k
    routing moves whole expert leaves, so the router stays out): the loss
    within 1e-3 relative, each leaf's gradient within
    ``BF16_GRAD_REL_L2``, and one ``make_train_step`` step's loss and
    gradient norm within the same bounds.  Then one bf16 step of the
    whole smoke model through ``make_train_step`` launches each kernel
    once per MLA layer, with a finite loss."""
    import dataclasses

    from repro_torch import configs, models, optim
    from repro_torch.nn import module as nnm
    from repro_torch.runtime import TrainStepConfig, make_train_step

    dev = _cuda()
    cfg = configs.smoke("deepseek-v2-236b")
    cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    rng = np.random.default_rng(3)
    # 256 positions: several key and query tiles per (batch, head)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 256))).to(dev)
    labels = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 256))).to(dev)
    params = nnm.init_params(models.model_defs(cfg), seed=0,
                             dtype=torch.float32, device=dev)
    out = _kernel_vs_ref_grads(cfg, params, toks, labels, torch.float32)
    assert out["kernel"][0] == pytest.approx(out["ref"][0], rel=1e-5)
    for a, b in zip(out["kernel"][1], out["ref"][1]):
        assert _rel_l2(a, b) <= 1e-4

    dense = dataclasses.replace(cfg, n_layers=1)
    assert [d.ffn for d in dense.layer_plan()[0]] == ["dense"]
    params = nnm.init_params(models.model_defs(dense), seed=0,
                             dtype=torch.bfloat16, device=dev)
    out = _kernel_vs_ref_grads(dense, params, toks, labels, torch.bfloat16)
    assert out["kernel"][0] == pytest.approx(out["ref"][0], rel=1e-3)
    for a, b in zip(out["kernel"][1], out["ref"][1]):
        assert _rel_l2(a, b) <= BF16_GRAD_REL_L2
    opt = optim.AdamWConfig(lr=1e-3)
    metrics = {}
    for impl in ("ref", "kernel"):
        p = nnm.init_params(models.model_defs(dense), seed=0,
                            dtype=torch.bfloat16, device=dev)
        step = make_train_step(dense, opt, TrainStepConfig(impl=impl))
        metrics[impl] = step(p, optim.adamw_init(p, opt),
                             {"tokens": toks, "labels": labels})[2]
    assert float(metrics["kernel"]["loss"]) == pytest.approx(
        float(metrics["ref"]["loss"]), rel=1e-3)
    assert float(metrics["kernel"]["grad_norm"]) == pytest.approx(
        float(metrics["ref"]["grad_norm"]), rel=BF16_GRAD_REL_L2)

    params = nnm.init_params(models.model_defs(cfg), seed=0,
                             dtype=torch.bfloat16, device=dev)
    step = make_train_step(cfg, opt, TrainStepConfig(impl="kernel"))
    before = (tfa.flash_fwd_kernel.launches, tfa.flash_bwd_dq_kernel.launches,
              tfa.flash_bwd_dkv_kernel.launches)
    _, _, m = step(params, optim.adamw_init(params, opt),
                   {"tokens": toks, "labels": labels})
    assert np.isfinite(float(m["loss"]))
    assert (tfa.flash_fwd_kernel.launches, tfa.flash_bwd_dq_kernel.launches,
            tfa.flash_bwd_dkv_kernel.launches) == tuple(
                n + cfg.n_layers for n in before)


# ------------------------------------------------------- seeded sampling --

# Random123's kat_vectors for threefry2x32_20: (key, counter, output)
THREEFRY_KAT = [((0x00000000, 0x00000000), (0x00000000, 0x00000000),
                 (0x6b200159, 0x99ba4efe)),
                ((0xffffffff, 0xffffffff), (0xffffffff, 0xffffffff),
                 (0x1cb996fc, 0xbb002be7)),
                ((0x13198a2e, 0x03707344), (0x243f6a88, 0x85a308d3),
                 (0xc4923a9c, 0x483df7a0))]
# a mismatch of the card's token against the CPU's is allowed only on a
# row whose two best CPU scores lie within this many ulps of the larger
# (the Gumbel noise differs by ~1 ulp, the add rounds once more)
TIE_ULPS = 4


def test_threefry_known_answers_on_card():
    dev = _cuda()
    for key, ctr, want in THREEFRY_KAT:
        words = [torch.tensor([v], dtype=torch.int64, device=dev)
                 for v in key + ctr]
        got = prng.threefry2x32(*words)
        assert tuple(int(w[0]) for w in got) == want


def test_prng_bits_on_card_equal_the_cpus():
    """fold(fold(PRNGKey(s), rid), pos) keys over a grid, and their
    random bits and uniforms, bit for bit on the card and the CPU."""
    dev = _cuda()
    rids = torch.arange(64).repeat_interleave(16)
    poss = torch.arange(16).repeat(64) * 97 + 5
    for seed in (0, 7, 2**32 - 1):
        keys = {d: prng.fold_in(prng.fold_in(prng.PRNGKey(seed, d),
                                             rids.to(d)), poss.to(d))
                for d in ("cpu", dev)}
        assert torch.equal(keys[dev].cpu(), keys["cpu"])
        for shape in ((7,), (3, 1000)):
            assert torch.equal(prng.random_bits(keys[dev], shape).cpu(),
                               prng.random_bits(keys["cpu"], shape))
            assert torch.equal(prng.uniform(keys[dev], shape).cpu(),
                               prng.uniform(keys["cpu"], shape))
            assert torch.equal(prng.randint(keys[dev], shape, 0, 102400)
                               .cpu(), prng.randint(keys["cpu"], shape, 0,
                                                    102400))


def near_tie(scores: torch.Tensor) -> torch.Tensor:
    """Rows whose two best scores lie within TIE_ULPS ulps of the best."""
    top = torch.topk(scores, 2, dim=-1).values
    ulp = torch.finfo(torch.float32).eps * top[:, 0].abs().clamp_min(1.0)
    return (top[:, 0] - top[:, 1]) <= TIE_ULPS * ulp


@pytest.mark.parametrize("top_k", [0, 50])
def test_sampler_on_card_matches_the_cpu(top_k):
    """B = 8 rows of V = 102,400 logits, 16 positions each, temperature
    0.7: the card's tokens are the CPU's except on near-tie rows, and at
    most 1 of the 128 draws differs."""
    dev = _cuda()
    g = torch.Generator().manual_seed(0)
    logits = torch.randn((8, 102400), generator=g) * 4
    kw = dict(temperature=0.7, top_k=top_k, sample_seed=0)
    mismatched = 0
    for draw in range(16):
        rids = torch.arange(8, dtype=torch.int64) * 3
        poss = torch.full((8,), 100 + draw, dtype=torch.int64)
        cpu_scores = sample_scores(logits, rids, poss, **kw)
        want = torch.argmax(cpu_scores, dim=-1)
        got = sample_tokens(logits.to(dev), rids.to(dev), poss.to(dev),
                            **kw).cpu()
        bad = got != want
        assert not (bad & ~near_tie(cpu_scores)).any()
        mismatched += int(bad.sum())
    assert mismatched <= 1


# ------------------------------------------- CUDA graphs of the engine ----
#
# The smoke model in f32 at drop-free MoE capacity (the seed has no greedy
# near-ties), served eagerly and from CUDA graphs (runtime.graphs) by the
# synchronous and the async engine.  A replay runs the kernels an eager
# step launches on the same inputs, so tokens agree exactly.


def _smoke_model(dtype=torch.float32, drop_free=True):
    import dataclasses

    from repro_torch import configs, models
    from repro_torch.nn import module as nnm
    dev = _cuda()
    cfg = configs.smoke("deepseek-v2-236b")
    if drop_free:
        cfg = dataclasses.replace(cfg,
                                  capacity_factor=cfg.n_experts / cfg.top_k)
    return cfg, nnm.init_params(models.model_defs(cfg), seed=0, dtype=dtype,
                                device=dev)


def _smoke_requests(vocab, n_fork=1):
    from repro_torch.runtime import Request, SamplingParams
    rng = np.random.default_rng(3)
    specs = [(12, 9, 0), (9, 7, 0), (17, 8, 1), (8, 10, 2)]
    return [Request(rid=3 * i, prompt=rng.integers(0, vocab, p)
                    .astype(np.int32), arrival=a,
                    sampling=SamplingParams(max_tokens=g,
                                            n=n_fork if i == 1 else 1))
            for i, (p, g, a) in enumerate(specs)]


def _smoke_engine(cfg, params, engine="sync", dtype=torch.float32, **kw):
    from repro_torch.runtime import AsyncPagedMLAEngine, PagedMLAEngine
    cls = AsyncPagedMLAEngine if engine == "async" else PagedMLAEngine
    kw.setdefault("num_blocks", 64)
    return cls(cfg, params, block_size=4, max_batch=4, max_blocks_per_req=12,
               scheme="seq", impl="kernel", prefill_chunk=8,
               compute_dtype=dtype, device="cuda", **kw)


COUNTERS = ("steps", "decode_tokens", "prefill_tokens", "prompt_tokens",
            "prefill_chunks", "admissions", "mid_gen_admissions",
            "preemptions", "scheme_switches", "schemes_used")


def _serve(eng, reqs):
    s = eng.run(reqs)
    assert len(eng.sched.finished) == len(reqs) + sum(
        r.sampling.n - 1 for r in reqs)
    return ({r.rid: (tuple(r.output), r.finish_reason)
             for r in eng.sched.finished}, {k: s[k] for k in COUNTERS})


@pytest.mark.parametrize("sampling", [{}, dict(temperature=0.8, top_k=5,
                                               sample_seed=7)],
                         ids=["greedy", "seeded"])
@pytest.mark.parametrize("cache_dtype", ["bf16", "fp8"])
def test_graphs_match_eager_on_card(cache_dtype, sampling):
    """Sync eager, sync graphs and async graphs: the same tokens and the
    same EngineStats counters, on an unquantized (the compute dtype) and
    an fp8 pool, with an n = 2 fork and a small pool that preempts."""
    cfg, params = _smoke_model()
    for num_blocks in (64, 10):
        runs = [_serve(_smoke_engine(cfg, params, engine, num_blocks=num_blocks,
                                     cache_dtype=cache_dtype,
                                     cuda_graphs=graphs, **sampling),
                       _smoke_requests(cfg.vocab, n_fork=2))
                for engine, graphs in (("sync", False), ("sync", True),
                                       ("async", True), ("async", False))]
        for toks, stats in runs[1:]:
            assert toks == runs[0][0]
            assert stats == runs[0][1]


@pytest.mark.parametrize("cache_dtype", ["bf16", "fp8"])
def test_serving_is_bitwise_repeatable_on_card(cache_dtype):
    """bf16 at the config's own MoE capacity, so rows compete for expert
    slots, with idle rows and chunk padding writing the null block: two
    eager serves, a graph serve and an async serve leave the same tokens
    and the same pool bytes, null block included."""
    cfg, params = _smoke_model(torch.bfloat16, drop_free=False)
    runs = []
    for engine, graphs in (("sync", False), ("sync", False), ("sync", True),
                           ("async", True)):
        eng = _smoke_engine(cfg, params, engine, dtype=torch.bfloat16,
                            cache_dtype=cache_dtype, cuda_graphs=graphs)
        toks, _ = _serve(eng, _smoke_requests(cfg.vocab, n_fork=2))
        runs.append((toks, [t.contiguous().view(torch.uint8).cpu()
                            for t in tcache.pool_leaves(eng.pool)]))
    for toks, pool in runs[1:]:
        assert toks == runs[0][0]
        assert all(torch.equal(a, b) for a, b in zip(pool, runs[0][1]))


def test_graph_replays_count_kernel_launches_on_card():
    """K1 / K2 launches counted through replays equal layers x decode
    ticks and layers x prefill chunks; the plans recorded at capture are
    the eager plans, bf16 on the tensor-core walk."""
    from repro_torch.kernels.mla_decode import mla_decode_paged_kernel as k1
    from repro_torch.kernels.mla_prefill import mla_prefill_paged_kernel as k2
    cfg, params = _smoke_model(torch.bfloat16)
    for engine in ("sync", "async"):
        eng = _smoke_engine(cfg, params, engine, dtype=torch.bfloat16)
        eng.warm_up()
        assert eng.stats.capture_s > 0
        k1.launches = k2.launches = 0
        s = eng.run(_smoke_requests(cfg.vocab))
        ticks = sum(s["schemes_used"].values())
        assert k1.launches == cfg.n_layers * ticks > 0
        assert k2.launches == cfg.n_layers * s["prefill_chunks"] > 0
        plans = eng.graph_plans()
        eager = _smoke_engine(cfg, params, engine, dtype=torch.bfloat16,
                              cuda_graphs=False)
        eager.run(_smoke_requests(cfg.vocab))
        dec = plans[f"{eng._decode_kind}/seq"]["mla_decode_paged_kernel"]
        pre = plans["chunk/seq"]["mla_prefill_paged_kernel"]
        assert dec == k1.last_plan and pre == k2.last_plan
        assert dec["n_split"] > 0 and pre["n_split"] > 0


def test_graph_addresses_stay_fixed_on_card():
    """The pool's leaves and the static input buffers keep their storage
    across replays; a pool leaf replaced behind the graph's back makes
    the next replay raise."""
    from repro_torch.core import cache as tcache
    cfg, params = _smoke_model()
    eng = _smoke_engine(cfg, params, "async")
    eng.warm_up()
    ptrs = [t.data_ptr() for t in tcache.pool_leaves(eng.pool)] + [
        t.data_ptr() for d in eng._inputs.values() for t in d.values()]
    eng.run(_smoke_requests(cfg.vocab))
    assert ptrs == [t.data_ptr() for t in tcache.pool_leaves(eng.pool)] + [
        t.data_ptr() for d in eng._inputs.values() for t in d.values()]
    g = eng._graphs[("sample", "seq")]
    g.check_addresses()
    layer = next(iter(eng.pool.values())) if isinstance(eng.pool, dict) \
        else eng.pool[0]
    while "ckv" not in layer:
        layer = next(iter(layer.values())) if isinstance(layer, dict) \
            else layer[0]
    layer["ckv"] = layer["ckv"].clone()
    with pytest.raises(RuntimeError, match="moved since capture"):
        g.replay()


def test_broken_capture_raises_on_card():
    """A step that waits for the host cannot be captured: the capture
    raises, and the engine raises instead of running the step eagerly."""
    from repro_torch.runtime import StepGraph
    dev = _cuda()
    x = torch.ones(4, device=dev)

    def syncs(x):
        return x * float(x.sum().item())

    with pytest.raises(RuntimeError):
        StepGraph(syncs, {"x": x}).capture()
    cfg, params = _smoke_model()
    eng = _smoke_engine(cfg, params, "sync")
    real = eng._step_fn

    def broken(kind, scheme):
        fn = real(kind, scheme)

        def run(**inputs):
            out = fn(**inputs)
            return out[torch.nonzero(out[:, 0] > 0)[:, 0]]
        return run

    eng._step_fn = broken
    with pytest.raises(RuntimeError):
        eng.run(_smoke_requests(cfg.vocab))
    assert not eng._graphs


def test_async_readback_waits_on_its_event_only_on_card(monkeypatch):
    """Steady decode ticks of the async engine make no synchronizing call:
    under ``set_sync_debug_mode('error')`` and with the device-wide and
    stream-wide synchronize disabled, the ticks run, and each reads its
    ids after waiting on the step's event."""
    from repro_torch.runtime import Request, SamplingParams
    cfg, params = _smoke_model()
    eng = _smoke_engine(cfg, params, "async")
    eng.warm_up()
    rng = np.random.default_rng(5)
    for i in range(3):
        eng.submit(Request(rid=i, prompt=rng.integers(0, cfg.vocab, 6)
                           .astype(np.int32),
                           sampling=SamplingParams(max_tokens=20)))
    while eng.sched.waiting or eng.stats.steps < 3:
        eng.step()
    waits = []
    real_sync = torch.cuda.Event.synchronize

    def counted(ev):
        waits.append(ev)
        return real_sync(ev)

    def refuse(*a, **k):
        raise AssertionError("a decode tick synchronized the device")

    monkeypatch.setattr(torch.cuda.Event, "synchronize", counted)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(torch.cuda.Stream, "synchronize", refuse)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(5):
            inf = eng._inflight
            eng.step()
            assert inf is not None and any(w is inf.ready for w in waits)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    monkeypatch.undo()
    eng.run([])
    sync = _smoke_engine(cfg, params, "sync", cuda_graphs=False)
    rng = np.random.default_rng(5)
    for i in range(3):
        sync.submit(Request(rid=i, prompt=rng.integers(0, cfg.vocab, 6)
                            .astype(np.int32),
                            sampling=SamplingParams(max_tokens=20)))
    sync.run([])
    assert {r.rid: r.output for r in eng.sched.finished} == \
        {r.rid: r.output for r in sync.sched.finished}


def test_graph_engines_leave_no_memory_behind_on_card():
    """An engine's graphs go with it: building, serving and closing more
    graph engines leaves no more device memory allocated than the first
    one did (cuBLAS keeps a workspace per stream it ran on, so the
    warm-ups share one side stream)."""
    import gc
    cfg, params = _smoke_model(torch.bfloat16)

    def cycle():
        eng = _smoke_engine(cfg, params, "async", dtype=torch.bfloat16)
        eng.warm_up()
        eng.run(_smoke_requests(cfg.vocab))
        eng.close()
        del eng
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return torch.cuda.memory_allocated()

    first = cycle()
    assert [cycle() for _ in range(3)] == [first] * 3
