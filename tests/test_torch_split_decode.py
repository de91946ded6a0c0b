"""The split-KV walk of the tensor-core decode kernels (K3 and K1 for
bf16 q, ``csrc/mla_decode_tc.cuh``), modelled on the CPU by
``ref.mla_decode_split_ref``, against the JAX package's Pallas kernels in
interpret mode; and the host-side plan that picks the splits.

Inputs are made with numpy from a seed and fed to both packages in f32.
The cases put indices before, on and after split boundaries, leave
splits empty (an index before them, an index of -1), take index 0, a
cache length that is no multiple of the 64-position tile, a cache
shorter than one split, and int8 / fp8 pools with per-slot scales, in
both rescale modes.  Tolerance: ``TOL`` of ``tests/test_torch_kernels.py``
(f32; the splits sum in another order than the Pallas kernels' one walk,
~1e-7 measured).

The CUDA kernels themselves are held against these walks on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cache as jcache
from repro.kernels import mla_decode as jdec
from repro_torch.core import cache as tcache
from repro_torch.kernels import _launch
from repro_torch.kernels import ref as tref

from test_torch_kernels import TOL, _close

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


# ----------------------------------------------------------- contiguous --

# (B, H, S, Dl, Dr, index, split_pos)
CONTIGUOUS_CASES = [
    (2, 4, 200, 32, 8, 63, 64),      # ends a split exactly
    (2, 4, 200, 32, 8, 64, 64),      # one position into the next split
    (2, 4, 200, 32, 8, 62, 64),      # one short of the boundary
    (2, 4, 200, 32, 8, 199, 64),     # S = 200: a ragged last tile
    (2, 4, 200, 32, 8, 150, 64),     # the last split empty
    (1, 8, 300, 64, 16, 255, 128),   # two tiles a split, on a boundary
    (1, 8, 300, 64, 16, 299, 128),   # the last split one tile, ragged
    (2, 4, 40, 32, 8, 39, 128),      # S shorter than one split
    (2, 4, 100, 32, 8, 0, 64),       # the first token alone
    (2, 4, 100, 32, 8, -1, 64),      # no position: zero rows
]


@pytest.mark.parametrize("rescale", tref.RESCALES)
@pytest.mark.parametrize("B,H,S,Dl,Dr,index,split_pos", CONTIGUOUS_CASES)
def test_contiguous_split_walk_matches_pallas(B, H, S, Dl, Dr, index,
                                              split_pos, rescale):
    rng = np.random.default_rng(S + index)
    q = rng.standard_normal((B, H, Dl + Dr)).astype(np.float32)
    ckv = rng.standard_normal((B, S, Dl)).astype(np.float32)
    krope = rng.standard_normal((B, S, Dr)).astype(np.float32)
    got = tref.mla_decode_split_ref(_t(q), _t(ckv), _t(krope), index,
                                    split_pos=split_pos, rescale=rescale)
    want = jdec.mla_decode_kernel(jnp.asarray(q), jnp.asarray(ckv),
                                  jnp.asarray(krope), index, rescale=rescale,
                                  interpret=True)
    _close(got, want, TOL)
    _close(got, tref.mla_decode_ref(_t(q), _t(ckv), _t(krope), index,
                                    rescale=rescale), TOL)
    if index < 0:
        assert (got == 0).all()


# ---------------------------------------------------------------- paged --

# (B, H, Dl, Dr, bs, nb, N, indices, split_pos): 14 blocks of 16 reach
# 224 positions, so splits of 64 end at 63, 127, 191 and the fourth
# holds 32; requests end before, on and after those boundaries, one is
# inactive, one holds a single token.
PAGED_CASES = [
    (4, 4, 32, 8, 16, 14, 64, [63, 64, 0, -1], 64),
    (4, 4, 32, 8, 16, 14, 64, [127, 128, 126, 223], 64),
    (3, 8, 64, 16, 4, 20, 40, [79, 5, 64], 64),     # small blocks
    (2, 4, 32, 8, 8, 10, 30, [79, 30], 128),        # one split of 80
]


def _paged(B, H, Dl, Dr, bs, nb, N, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Dl + Dr)).astype(np.float32)
    ckv = rng.standard_normal((N, bs, Dl)).astype(np.float32)
    krope = rng.standard_normal((N, bs, Dr)).astype(np.float32)
    bt = rng.permutation(np.arange(1, N))[:B * nb] if N > B * nb \
        else rng.integers(0, N, B * nb)
    return q, ckv, krope, bt.reshape(B, nb).astype(np.int32)


@pytest.mark.parametrize("rescale", tref.RESCALES)
@pytest.mark.parametrize("B,H,Dl,Dr,bs,nb,N,idx,split_pos", PAGED_CASES)
def test_paged_split_walk_matches_pallas(B, H, Dl, Dr, bs, nb, N, idx,
                                         split_pos, rescale):
    q, ckv, krope, bt = _paged(B, H, Dl, Dr, bs, nb, N, nb + N)
    idx = np.asarray(idx, np.int32)
    got = tref.mla_decode_split_ref(_t(q), _t(ckv), _t(krope), _t(idx),
                                    split_pos=split_pos, rescale=rescale,
                                    block_tables=_t(bt))
    want = jdec.mla_decode_paged_kernel(*map(jnp.asarray,
                                             (q, ckv, krope, bt, idx)),
                                        rescale=rescale, interpret=True)
    _close(got, want, TOL)
    assert (got.numpy()[idx < 0] == 0).all()


@pytest.mark.parametrize("rescale", tref.RESCALES)
@pytest.mark.parametrize("cache_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("case", PAGED_CASES[:2] + PAGED_CASES[3:])
def test_quantized_split_walk_matches_pallas(case, cache_dtype, rescale):
    """int8 / fp8 codes with per-slot scales, quantized by each package
    (bit-equal, tests/test_torch_quant.py)."""
    B, H, Dl, Dr, bs, nb, N, idx, split_pos = case
    q, ckv, krope, bt = _paged(B, H, Dl, Dr, bs, nb, N, 5 * N)
    idx = np.asarray(idx, np.int32)
    jdt, qmax = jcache.cache_dtype_info(cache_dtype)
    tdt, _ = tcache.cache_dtype_info(cache_dtype)
    jc, jcs = jcache.quantize_latent(jnp.asarray(ckv), qmax, jdt)
    jr, jrs = jcache.quantize_latent(jnp.asarray(krope), qmax, jdt)
    tc, tcs = tcache.quantize_latent(_t(ckv), qmax, tdt)
    tr, trs = tcache.quantize_latent(_t(krope), qmax, tdt)
    got = tref.mla_decode_split_ref(_t(q), tc, tr, _t(idx),
                                    split_pos=split_pos, rescale=rescale,
                                    block_tables=_t(bt), ckv_scales=tcs,
                                    krope_scales=trs)
    want = jdec.mla_decode_paged_kernel(jnp.asarray(q), jc, jr,
                                        jnp.asarray(bt), jnp.asarray(idx),
                                        ckv_scales=jcs, krope_scales=jrs,
                                        rescale=rescale, interpret=True)
    _close(got, want, TOL)
    _close(got, tref.mla_decode_paged_ref(_t(q), tc, tr, _t(bt), _t(idx),
                                          rescale=rescale, ckv_scales=tcs,
                                          krope_scales=trs), TOL)


def test_merge_skips_empty_splits_and_rejects_unknown_rescale():
    acc = torch.ones((1, 1, 4))
    live = (acc, torch.full((1, 1, 1), 3.0), torch.full((1, 1, 1), 2.0))
    empty = (torch.full((1, 1, 4), float("nan")),
             torch.full((1, 1, 1), tref.NEG_INF), torch.zeros((1, 1, 1)))
    for rescale in tref.RESCALES:
        np.testing.assert_array_equal(
            tref.merge_splits([empty, live, empty], rescale).numpy(),
            np.full((1, 1, 4), 0.5, np.float32))
        assert (tref.merge_splits([empty], rescale) == 0).all()
    with pytest.raises(ValueError):
        tref.merge_splits([live], "add")
    with pytest.raises(ValueError):
        tref.mla_decode_split_ref(torch.zeros((1, 1, 40)),
                                  torch.zeros((1, 8, 32)),
                                  torch.zeros((1, 8, 8)), 3, split_pos=96)


# ----------------------------------------------------------- the plan ----


@pytest.mark.parametrize("n_pos,B,H", [
    (2079, 8, 128), (1088, 8, 128), (1, 8, 128), (65, 1, 64), (0, 4, 16),
    (100_000, 2, 128), (4096, 64, 128), (4096, 128, 128), (300, 3, 4)])
def test_split_plan_fills_one_wave_with_whole_tiles(n_pos, B, H):
    """Whole tiles a split, no split empty, one wave of CTAs on the SMs,
    and the shortest such split: one tile shorter would need a second
    wave."""
    sms = 132
    n_split, split_pos = _launch.split_plan(n_pos, B, H, sms)
    tiles = -(-n_pos // _launch.TC_POS)
    ctas = -(-H // _launch.TC_ROWS) * B
    per = split_pos // _launch.TC_POS
    assert split_pos % _launch.TC_POS == 0 and n_split >= 1
    assert n_split * split_pos >= n_pos                  # covers the range
    assert (n_split - 1) * split_pos < max(n_pos, 1)     # no empty split
    assert ctas * n_split <= max(sms, ctas)              # one wave
    if per > 1:
        assert ctas * -(-tiles // (per - 1)) > sms


def test_tensor_core_route_takes_only_what_its_copies_can():
    bf, f32 = torch.bfloat16, torch.float32
    q = torch.zeros((2, 4, 576), dtype=bf)
    ckv, krope = torch.zeros((2, 9, 512), dtype=bf), torch.zeros((2, 9, 64),
                                                                dtype=bf)
    assert _launch.tc_walk_takes(q, 512, 64, (ckv, krope), (4608, 512))
    assert not _launch.tc_walk_takes(q.to(f32), 512, 64, (ckv, krope))
    assert not _launch.tc_walk_takes(q, 512, 68, (ckv, krope))   # Dr % 8
    assert not _launch.tc_walk_takes(q, 512, 72, (ckv, krope))   # > 576
    assert not _launch.tc_walk_takes(q, 512, 64, (ckv[:, :, 1:],))
    assert not _launch.tc_walk_takes(q, 512, 64, (ckv,), (4608, 516))
    assert _launch.tc_walk_takes(torch.zeros((1, 1, 24), dtype=bf), 16, 8)
