"""The split-KV walk that bf16 K2 (paged chunked prefill) runs on the
tensor cores (``csrc/mla_prefill_paged.cu`` on ``csrc/mla_decode_tc.cuh``),
modelled on the CPU by ``ref.mla_prefill_split_ref``, against the JAX
package's Pallas kernel in interpret mode; and the host-side plans that
pick the routes of K2 and of the flash-attention forward K4.

Inputs are made with numpy from a seed and fed to both packages in f32.
The cases put chunk rows whose last position falls one short of, on and
one past a 64-position tile edge and a split edge, take n_valid 0, 1 and
C, and int8 / fp8 pools with per-slot scales, in both rescale modes.
Tolerance: ``TOL`` of ``tests/test_torch_kernels.py`` (f32; the splits
and tiles sum in another order than the Pallas kernel's one walk).

The CUDA kernels themselves are held against these walks on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cache as jcache
from repro.kernels.mla_prefill import mla_prefill_paged_kernel as j_prefill
from repro_torch.core import cache as tcache
from repro_torch.kernels import _launch
from repro_torch.kernels import ref as tref

from test_torch_kernels import TOL, _close

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


# (B, C, H, Dl, Dr, bs, nb, N, lengths, n_valid, split_pos): chunk row c
# of request b attends positions <= lengths[b] + c
CASES = [
    # rows end at 56..63 (the last on the first tile's edge) and at 60
    # alone; an idle request
    (3, 8, 4, 32, 8, 16, 6, 24, [56, 60, 0], [8, 1, 0], 64),
    # rows end at 58..63 and 122..127: a full first split, then a full
    # second one (split edges at 64 and 128)
    (2, 6, 4, 32, 8, 16, 10, 24, [58, 122], [6, 6], 64),
    # rows cross the split edge at 128 (124..129) and the tile edge at
    # 64 inside one split of 128 (61..65, two of them padding)
    (2, 6, 8, 64, 16, 8, 20, 48, [124, 61], [6, 3], 128),
]


def _inputs(B, C, H, Dl, Dr, bs, nb, N, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, C, H, Dl + Dr)).astype(np.float32)
    ckv = rng.standard_normal((N, bs, Dl)).astype(np.float32)
    krope = rng.standard_normal((N, bs, Dr)).astype(np.float32)
    bt = rng.permutation(np.arange(1, N))[:B * nb] if N > B * nb \
        else rng.integers(0, N, B * nb)
    return q, ckv, krope, bt.reshape(B, nb).astype(np.int32)


@pytest.mark.parametrize("rescale", tref.RESCALES)
@pytest.mark.parametrize("B,C,H,Dl,Dr,bs,nb,N,lengths,n_valid,split_pos",
                         CASES)
def test_prefill_split_walk_matches_pallas(B, C, H, Dl, Dr, bs, nb, N,
                                           lengths, n_valid, split_pos,
                                           rescale):
    q, ckv, krope, bt = _inputs(B, C, H, Dl, Dr, bs, nb, N, nb + N)
    ln = np.asarray(lengths, np.int32)
    nv = np.asarray(n_valid, np.int32)
    got = tref.mla_prefill_split_ref(*map(_t, (q, ckv, krope, bt, ln, nv)),
                                     split_pos=split_pos, rescale=rescale)
    want = j_prefill(*map(jnp.asarray, (q, ckv, krope, bt, ln, nv)),
                     rescale=rescale, interpret=True)
    _close(got, want, TOL)
    _close(got, tref.mla_prefill_paged_ref(*map(_t, (q, ckv, krope, bt, ln,
                                                     nv)),
                                           rescale=rescale), TOL)
    for b in range(B):                        # rows past n_valid: exact 0
        assert (got.numpy()[b, n_valid[b]:] == 0).all()


@pytest.mark.parametrize("rescale", tref.RESCALES)
@pytest.mark.parametrize("cache_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("case", CASES[1:])
def test_quantized_prefill_split_walk_matches_pallas(case, cache_dtype,
                                                     rescale):
    """int8 / fp8 codes with per-slot scales, quantized by each package
    (bit-equal, tests/test_torch_quant.py)."""
    B, C, H, Dl, Dr, bs, nb, N, lengths, n_valid, split_pos = case
    q, ckv, krope, bt = _inputs(B, C, H, Dl, Dr, bs, nb, N, 3 * N)
    ln = np.asarray(lengths, np.int32)
    nv = np.asarray(n_valid, np.int32)
    jdt, qmax = jcache.cache_dtype_info(cache_dtype)
    tdt, _ = tcache.cache_dtype_info(cache_dtype)
    jc, jcs = jcache.quantize_latent(jnp.asarray(ckv), qmax, jdt)
    jr, jrs = jcache.quantize_latent(jnp.asarray(krope), qmax, jdt)
    tc, tcs = tcache.quantize_latent(_t(ckv), qmax, tdt)
    tr, trs = tcache.quantize_latent(_t(krope), qmax, tdt)
    got = tref.mla_prefill_split_ref(_t(q), tc, tr, _t(bt), _t(ln), _t(nv),
                                     split_pos=split_pos, rescale=rescale,
                                     ckv_scales=tcs, krope_scales=trs)
    want = j_prefill(jnp.asarray(q), jc, jr, jnp.asarray(bt),
                     jnp.asarray(ln), jnp.asarray(nv), ckv_scales=jcs,
                     krope_scales=jrs, rescale=rescale, interpret=True)
    _close(got, want, TOL)


# ------------------------------------------------------------ the plans --


def _pool(dtype, Dl=512, Dr=64):
    return (torch.zeros((10, 16, Dl), dtype=dtype),
            torch.zeros((10, 16, Dr), dtype=dtype))


@pytest.mark.parametrize("B,C,H,nb", [(8, 32, 128, 68), (1, 1, 128, 40),
                                      (2, 4, 64, 560), (3, 7, 100, 9)])
def test_prefill_plan_takes_the_walk_for_bf16(B, C, H, nb):
    """bf16 q: the tensor-core walk with K1's split plan for B x C rows of
    heads, over the table's reach, on grid (ceil(H / 64), n_split,
    B x C); at the serving load (8 x 32 chunk rows) one split."""
    q = torch.zeros((B, C, H, 576), dtype=torch.bfloat16)
    plan = _launch.prefill_plan(q, 512, 64, nb, 16, _pool(torch.bfloat16),
                                sms=132)
    n_split, split_pos = _launch.split_plan(nb * 16, B * C, H, 132)
    assert plan == dict(n_split=n_split, split_pos=split_pos,
                        grid=(-(-H // 64), n_split, B * C))
    assert plan["n_split"] >= 1 and plan["split_pos"] % 64 == 0
    if B * C == 256:
        assert plan["n_split"] == 1


def test_prefill_plan_keeps_the_cuda_core_walk_for_the_rest():
    """f32 q, a rope width the walk's copies cannot take, unaligned pool
    pages and more (request, chunk row) pairs than the grid's z holds run
    ``attend_rows``: n_split 0 on grid (ceil(C x H / 16), B)."""
    rows = dict(n_split=0, split_pos=0, grid=(-(-32 * 128 // 16), 8))
    q = torch.zeros((8, 32, 128, 576), dtype=torch.bfloat16)
    assert _launch.prefill_plan(q.float(), 512, 64, 68, 16,
                                _pool(torch.float32), sms=132) == rows
    q68 = torch.zeros((8, 32, 128, 580), dtype=torch.bfloat16)
    assert _launch.prefill_plan(q68, 512, 68, 68, 16,
                                _pool(torch.bfloat16, Dr=68), sms=132) == rows
    ckv, krope = _pool(torch.bfloat16)
    assert _launch.prefill_plan(q, 512, 64, 68, 16,
                                (ckv.reshape(-1)[4:], krope),
                                sms=132) == rows
    wide = torch.zeros((1, 65536, 1, 576), dtype=torch.bfloat16)
    assert _launch.prefill_plan(wide, 512, 64, 4, 16, _pool(torch.bfloat16),
                                sms=132)["n_split"] == 0


def _blhd(B, H, L, D, dtype=torch.bfloat16):
    """(B, L, H, D) memory as a (B, H, L, D) view, as the MLA path passes
    it."""
    return torch.zeros((B, L, H, D), dtype=dtype).transpose(1, 2)


def test_flash_fwd_plan_takes_the_walk_at_the_paths_shapes():
    """The training / prefill path's bf16 views (q/k (2,128,4096,192), v
    (...,128)) run the tensor-core walk: 128 query rows and 64 keys a
    CTA, grid (32, 256)."""
    q, v = _blhd(2, 128, 4096, 192), _blhd(2, 128, 4096, 128)
    out = _blhd(2, 128, 4096, 128)
    assert _launch.flash_fwd_tc_takes(q, q, v, out, 0.1)
    assert _launch.flash_fwd_plan(q, q, v, out, 0.1) == dict(
        route="tc", tiles=(128, 64), grid=(32, 256))
    # GQA, a ragged Lq, head dims 256 / 16
    q, k = torch.zeros((1, 8, 130, 256), dtype=torch.bfloat16), \
        torch.zeros((1, 2, 70, 256), dtype=torch.bfloat16)
    v = torch.zeros((1, 2, 70, 16), dtype=torch.bfloat16)
    out = torch.zeros((1, 8, 130, 16), dtype=torch.bfloat16)
    assert _launch.flash_fwd_plan(q, k, v, out, 0.1) == dict(
        route="tc", tiles=(128, 64), grid=(2, 8))
    assert _launch.flash_fwd_plan(q, k, v, out, -0.5)["route"] == "wmma"


@pytest.mark.parametrize("Dqk,Dv,dtype,tiles", [
    (192, 128, torch.float32, (32, 32)),
    (40, 24, torch.bfloat16, (64, 64)),       # not multiples of 16
    (576, 512, torch.bfloat16, (16, 16)),     # above 256
    (576, 512, torch.float32, (16, 32)),
    (272, 16, torch.bfloat16, (64, 64)),
])
def test_flash_fwd_plan_keeps_wmma_for_the_rest(Dqk, Dv, dtype, tiles):
    """f32 and head dims the walk does not take run the WMMA kernel with
    the tiles ``choose_tiles`` picks (the kernel refuses any other)."""
    q, v = torch.zeros((1, 2, 100, Dqk), dtype=dtype), \
        torch.zeros((1, 2, 100, Dv), dtype=dtype)
    out = torch.zeros((1, 2, 100, Dv), dtype=dtype)
    assert not _launch.flash_fwd_tc_takes(q, q, v, out, 0.1)
    assert _launch.flash_fwd_plan(q, q, v, out, 0.1) == dict(
        route="wmma", tiles=tiles, grid=(-(-100 // tiles[0]), 2))


def test_flash_fwd_plan_keeps_wmma_for_unaligned_operands():
    """The walk copies 16 bytes at a time: a view whose start or row
    stride is not 16-byte aligned runs the WMMA kernel."""
    base = torch.zeros((1, 2, 64, 72), dtype=torch.bfloat16)
    q, v = base[..., 8:72], torch.zeros((1, 2, 64, 64), dtype=torch.bfloat16)
    assert _launch.flash_fwd_tc_takes(q, q, v, v, 0.1)   # stride 72, at 8
    assert not _launch.flash_fwd_tc_takes(base[..., 4:68], q, v, v, 0.1)
    odd = torch.zeros((1, 2, 64, 68), dtype=torch.bfloat16)[..., :64]
    assert not _launch.flash_fwd_tc_takes(odd, q, v, v, 0.1)   # stride 68


def test_wmma_shared_memory_follows_the_kernels_formula():
    """``flash_fwd_smem`` is csrc/flash_attention_fwd.cu's fwd_smem: bf16,
    64 x 64 tiles at 192 / 128 (rows padded by 16 bytes, arrays rounded
    to 128 bytes) is 129,792 bytes, above the two-a-SM limit, so the
    path's WMMA tiles were 64 x 32."""
    assert _launch.flash_fwd_smem(2, 64, 64, 192, 128) == 129792
    assert _launch.flash_fwd_smem(2, 64, 32, 192, 128) == 96000
    assert _launch.flash_wmma_tiles(2, 192, 128) == (64, 32)
    with pytest.raises(ValueError):
        _launch.flash_wmma_tiles(4, 4096, 4096)
