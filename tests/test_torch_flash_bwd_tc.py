"""The tensor-core walks that bf16 K5 (dQ) and K6 (dK, dV) run on the card
(``csrc/flash_attention_bwd_tc.cuh``), modelled on the CPU: the plan that
picks their route, the tile classes of each walk (``_launch.flash_dq_walk``,
``flash_dkv_walk``: the blocks a warp skips, takes whole, or masks pair by
pair) checked exhaustively against the mask, and the walks' arithmetic
(``flash_attention.flash_bwd_walk_ref``: f32 p and dS rounded to bf16
only as operands of the accumulating products) against the JAX package's
Pallas backward in interpret mode and the port's plain versions.

Inputs come from numpy with fixed seeds.  Tolerances: in f32 the model
is the plain versions' arithmetic summed in other blocks, 1e-5 abs+rel
(reduction order, ~1e-7 measured).  In bf16, the model against the
Pallas backward is held row by row (the largest |a_r - b_r| / |b_r| of a
query's dQ or a key's dK / dV) within 3e-2, ``FLASH_ROW_TOL`` of
``tests/test_torch_gpu.py``: the model rounds P and dS to bf16 before the
accumulating products where the Pallas kernel keeps f32, a few 2^-9
steps per term, while a block skipped or left unmasked moves a row by
O(1) (an unmasked pair of a row that attends no key makes it inf / NaN).

The CUDA kernels themselves are held against the plain versions on the
card by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jflash
from repro_torch.kernels import _launch
from repro_torch.kernels import flash_attention as tfa

torch.set_num_threads(2)

ROW_TOL = 3e-2


def _meta(B, H, L, D, blhd=True):
    """A (B, H, L, D) bf16 tensor without storage, laid out (B, L, H, D)
    as the MLA path passes it (``blhd``) or contiguous."""
    if blhd:
        return torch.empty((B, L, H, D), dtype=torch.bfloat16,
                           device="meta").transpose(1, 2)
    return torch.empty((B, H, L, D), dtype=torch.bfloat16, device="meta")


# ------------------------------------------------------------ the plans --


def test_flash_bwd_plan_takes_the_walks_at_the_paths_shapes():
    """The training path's bf16 views (q/k (2,128,4096,192), v
    (...,128)): K5 on its walk with 128 query rows and 64 keys a CTA,
    grid (32, 256); K6 on its walk with 64 keys a CTA and 64-query tiles,
    grid (64, 256)."""
    q, k = _meta(2, 128, 4096, 192), _meta(2, 128, 4096, 192)
    v, do = _meta(2, 128, 4096, 128), _meta(2, 128, 4096, 128)
    assert _launch.flash_bwd_tc_takes(q, k, v, do, (q,), 0.07)
    assert _launch.flash_bwd_plan("dq", q, k, v, do, (q,), 0.07) == dict(
        route="tc", tiles=(128, 64), grid=(32, 256))
    assert _launch.flash_bwd_plan("dkv", q, k, v, do, (k, v), 0.07) == dict(
        route="tc", tiles=(64, 64), grid=(64, 256))


@pytest.mark.parametrize("H,Hkv,Dqk,Dv,rows", [
    (8, 2, 256, 256, 64),      # GQA, the widest head dims: 64 rows a CTA
    (8, 1, 128, 160, 64),      # MQA, Dv above 128
    (4, 4, 16, 16, 128),
    (6, 3, 192, 128, 128),
])
def test_flash_bwd_plan_tiles_and_grid(H, Hkv, Dqk, Dv, rows):
    """Head dims multiples of 16 up to 256 take the walks; K5's CTA
    holds 64 query rows where 128 would not fit shared memory; K6's grid
    runs over key tiles and key heads."""
    q, do = _meta(3, H, 130, Dqk, False), _meta(3, H, 130, Dv, False)
    k, v = _meta(3, Hkv, 200, Dqk, False), _meta(3, Hkv, 200, Dv, False)
    assert _launch.flash_dq_tc_rows(Dqk, Dv) == rows
    assert _launch.flash_bwd_plan("dq", q, k, v, do, (q,), 0.1) == dict(
        route="tc", tiles=(rows, 64), grid=(-(-130 // rows), 3 * H))
    assert _launch.flash_bwd_plan("dkv", q, k, v, do, (k, v), 0.1) == dict(
        route="tc", tiles=(64, 64), grid=(4, 3 * Hkv))


@pytest.mark.parametrize("Dqk,Dv,dtype,dq_tiles,dkv_tiles", [
    (192, 128, torch.float32, (16, 32), (16, 32)),
    (192, 128, "misaligned", (32, 64), (32, 32)),
    (40, 24, torch.bfloat16, (64, 64), (64, 64)),     # not multiples of 16
    (576, 512, torch.bfloat16, (16, 16), (32, 16)),   # above 256
    (272, 16, torch.bfloat16, (32, 32), (32, 32)),
])
def test_flash_bwd_plan_keeps_wmma_for_the_rest(Dqk, Dv, dtype, dq_tiles,
                                                dkv_tiles):
    """f32, head dims the walks do not take and operands their 16-byte
    copies cannot move run the WMMA kernels, with the tiles
    ``choose_tiles`` picks from ``dq_smem`` / ``dkv_smem`` (the kernels
    refuse any other)."""
    if dtype == "misaligned":        # a row stride of 200 + 4 elements
        base = torch.zeros((1, 2, 100, Dqk + 4), dtype=torch.bfloat16)
        q = base[..., :Dqk]
        v = torch.zeros((1, 2, 100, Dv), dtype=torch.bfloat16)
    else:
        q = torch.zeros((1, 2, 100, Dqk), dtype=dtype)
        v = torch.zeros((1, 2, 100, Dv), dtype=dtype)
    assert not _launch.flash_bwd_tc_takes(q, q, v, v, (q, q, v), 0.1)
    assert _launch.flash_bwd_plan("dq", q, q, v, v, (q,), 0.1) == dict(
        route="wmma", tiles=dq_tiles, grid=(-(-100 // dq_tiles[0]), 2))
    assert _launch.flash_bwd_plan("dkv", q, q, v, v, (q, v), 0.1) == dict(
        route="wmma", tiles=dkv_tiles, grid=(-(-100 // dkv_tiles[1]), 2))


def test_flash_bwd_plan_keeps_wmma_for_a_non_positive_scale():
    q, v = _meta(1, 2, 64, 64, False), _meta(1, 2, 64, 64, False)
    assert _launch.flash_bwd_plan("dq", q, q, v, v, (q,), 0.1)["route"] \
        == "tc"
    for kind in ("dq", "dkv"):
        assert _launch.flash_bwd_plan(kind, q, q, v, v, (q, v),
                                      -0.5)["route"] == "wmma"


def test_wmma_backward_shared_memory_follows_the_kernels_formulas():
    """``flash_dq_smem`` / ``flash_dkv_smem`` are dq_smem / dkv_smem of
    csrc/flash_attention_bwd_{dq,dkv}.cu: bf16 64 x 64 tiles at 192 / 128
    take 180,736 and 223,744 bytes, so the WMMA kernels ran one 8-warp
    CTA an SM at that size and take smaller tiles by the two-a-SM rule."""
    assert _launch.flash_dq_smem(2, 64, 64, 192, 128) == 180736
    assert _launch.flash_dkv_smem(2, 64, 64, 192, 128) == 223744
    assert _launch.flash_dq_smem(2, 32, 64, 192, 128) == 111872
    assert _launch.flash_dkv_smem(2, 32, 32, 192, 128) == 99584
    with pytest.raises(ValueError):
        _launch.flash_wmma_tiles(4, 4096, 4096, _launch.flash_dkv_smem)


# ------------------------------------------------------ the tile classes --


LQ = (1, 16, 63, 64, 65, 130, 200)
LK = (1, 17, 64, 65, 129, 250)


def _classes(walk_blocks, Lq, Lk):
    """(pairs covered by a non-skip block, count; pairs in interior
    blocks) from (rows, keys, cls) blocks, both (Lq, Lk)."""
    cover = np.zeros((Lq, Lk), np.int64)
    interior = []
    for rows, keys, cls in walk_blocks:
        if cls != "skip":
            cover[rows, keys] += 1
        if cls == "interior":
            interior.append((rows, keys))
    return cover, interior


@pytest.mark.parametrize("offsets", [range(0, 131, 4), range(1, 131, 4),
                                     range(2, 131, 4), range(3, 131, 4)])
@pytest.mark.parametrize("window", [None, 1, 8, 70])
@pytest.mark.parametrize("causal", [True, False])
def test_walk_tile_classes_match_the_mask(causal, window, offsets):
    """Over a grid of Lq and Lk (on, one past and off the 16-, 32- and
    64-wide blocks) and every query offset 0-130 (so the diagonal and the
    window edge fall at every place inside a block), for K5's key walk
    and K6's query walk: every pair the mask admits lies in exactly one
    block the walk visits and does not skip; every pair of an 'interior'
    block is admitted, and an interior block lies wholly inside Lk (and,
    for K6, Lq).  So no attended pair is dropped or counted twice, and no
    masked pair escapes its mask -- rows that attend no key (a window
    behind the offset) included."""
    for q_offset, Lq, Lk in itertools.product(offsets, LQ, LK):
        opts = dict(causal=causal, window=window, q_offset=q_offset)
        mask = tfa._mask(Lq, 0, Lk, device="cpu", **opts).numpy()
        for rows in (128, 64):
            dq = ((slice(r0, min(r0 + 16, Lq)), slice(k0, k0 + 64), c)
                  for r0, k0, c in _launch.flash_dq_walk(
                      Lq, Lk, rows=rows, **opts) if r0 < Lq)
            cover, interior = _classes(dq, Lq, Lk)
            assert (cover[mask] == 1).all() and cover.max() <= 1, \
                (q_offset, Lq, Lk, rows)
            for r, kk in interior:
                assert kk.stop <= Lk and mask[r, kk].all(), \
                    (q_offset, Lq, Lk, r)
        dkv = ((slice(qb0, qb0 + 32), slice(kb0, kb0 + 16), c)
               for _, _, kb0, qb0, c in _launch.flash_dkv_walk(
                   Lq, Lk, **opts))
        cover, interior = _classes(dkv, Lq, Lk)
        assert (cover[mask] == 1).all() and cover.max() <= 1, \
            (q_offset, Lq, Lk)
        for r, kk in interior:
            assert r.stop <= Lq and kk.stop <= Lk and mask[r, kk].all(), \
                (q_offset, Lq, Lk, r)


def test_walks_visit_only_tiles_inside_the_ranges():
    """Causal at L = 4096 (the training path): K5's CTA of the last 128
    rows visits all 64 key tiles and its first only two (longest first
    on the card); K6's first key tile visits every query tile, its last
    one; neither walk takes a tile above the diagonal."""
    walk = list(_launch.flash_dq_walk(4096, 4096, causal=True, window=None,
                                      q_offset=0, rows=128))
    tiles = lambda r: {k0 for r0, k0, _ in walk if r <= r0 < r + 128}
    assert tiles(3968) == set(range(0, 4096, 64))
    assert tiles(0) == {0, 64}
    assert all(c == "skip" for r0, k0, c in walk if k0 > r0 + 15)
    dkv = list(_launch.flash_dkv_walk(4096, 4096, causal=True, window=None,
                                      q_offset=0))
    assert {q0 for k0, q0, *_ in dkv if k0 == 0} == set(range(0, 4096, 64))
    assert {q0 for k0, q0, *_ in dkv if k0 == 4032} == {4032}
    assert all(c == "skip" for _, _, kb0, qb0, c in dkv if kb0 > qb0 + 31)


# ------------------------------------------------------- the arithmetic --


# (B, H, Hkv, Lq, Lk, Dqk, Dv, window, q_offset): Lq off the 128-row and
# 64-query tiles, the diagonal cutting key tiles (offset 36), GQA and MQA
# (K6's head loop), a window with an offset, rows that attend no key
# (window 8 behind an offset of 100 over 32 keys)
CASES = {
    "ragged": (1, 2, 2, 130, 130, 32, 16, None, 0),
    "diagonal_gqa": (1, 4, 2, 100, 136, 32, 32, None, 36),
    "window_mqa": (1, 4, 1, 70, 90, 16, 32, 24, 10),
    "no_key_rows": (1, 2, 2, 40, 32, 16, 16, 8, 100),
}


def _inputs(case, dtype):
    B, H, Hkv, Lq, Lk, D, Dv, _, _ = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case) + 40)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(dtype)
    return f(B, H, Lq, D), f(B, Hkv, Lk, D), f(B, Hkv, Lk, Dv), \
        f(B, H, Lq, Dv)


def _row_rel(got, want):
    """max_r |a_r - b_r| / |b_r| over the rows of the last dimension; a
    row under 1 % of the median row norm (dQ of query 0, a key no query
    sees) is measured against that 1 %."""
    a = got.float().reshape(-1, got.shape[-1])
    b = want.float().reshape(-1, want.shape[-1])
    norm = b.norm(dim=-1)
    floor = (0.01 * norm.median()).clamp_min(1e-30)
    return ((a - b).norm(dim=-1) / torch.maximum(norm, floor)).max().item()


def _opts(case):
    _, _, _, _, _, D, _, window, q_offset = CASES[case]
    return dict(causal=True, window=window, q_offset=q_offset,
                scale=D ** -0.5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_walk_model_is_the_plain_backward_in_f32(case):
    """In f32 (rounding to f32 is no rounding) the walks' model is the
    plain versions' arithmetic over other blocks: what it skips and where
    it masks change nothing."""
    q, k, v, do = _inputs(case, torch.float32)
    kw = _opts(case)
    out, lse = tfa.flash_fwd_plain(q, k, v, **kw)
    delta = (do * out).sum(-1)
    got = tfa.flash_bwd_walk_ref(q, k, v, do, lse, delta, **kw)
    want = (tfa.flash_bwd_dq_plain(q, k, v, do, lse, delta, **kw),
            *tfa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, **kw))
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                   rtol=1e-5)


@functools.lru_cache(maxsize=None)
def _pallas_grads(case):
    """dQ, dK, dV of the JAX package's flash attention (Pallas forward
    and backward in interpret mode, 64 x 64 blocks) in bf16 for the
    cotangent dO, and its lse, as f32 numpy."""
    q, k, v, do = (jnp.asarray(t.float().numpy(), jnp.bfloat16)
                   for t in _inputs(case, torch.bfloat16))
    kw = _opts(case)
    fwd = lambda q, k, v: jflash(q, k, v, True, kw["window"],
                                 kw["q_offset"], kw["scale"], 64, 64, True)
    out, vjp = jax.vjp(jax.jit(fwd), q, k, v)
    grads = jax.jit(vjp)(do)
    return [np.array(g.astype(jnp.float32)) for g in grads], \
        np.array(out.astype(jnp.float32))


@pytest.mark.parametrize("case", sorted(CASES))
def test_walk_model_in_bf16_matches_pallas_backward(case):
    """bf16 inputs: the model (P and dS rounded to bf16 before the
    accumulating products, the rest f32) against the Pallas backward,
    row by row within ``ROW_TOL``; rows that attend no key give exact
    zeros on both sides."""
    q, k, v, do = _inputs(case, torch.bfloat16)
    kw = _opts(case)
    (j_dq, j_dk, j_dv), j_out = _pallas_grads(case)
    _, lse = tfa.flash_fwd_plain(q, k, v, **kw)
    # delta from the bf16 output, as both packages' backward takes it
    delta = (do.float() * torch.from_numpy(j_out)).sum(-1)
    got = tfa.flash_bwd_walk_ref(q, k, v, do, lse, delta, **kw)
    for a, b in zip(got, (j_dq, j_dk, j_dv)):
        assert a.dtype == torch.bfloat16 and torch.isfinite(a).all()
        assert _row_rel(a, torch.from_numpy(b)) <= ROW_TOL
    if case == "no_key_rows":
        for a in got:
            assert (a == 0).all()
