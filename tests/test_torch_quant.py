"""Parity of the port's int8 / fp8 latent pool with the JAX package:
quantization and pool writes bit for bit, the quantized paged kernels'
plain versions against the Pallas kernels in interpret mode, the decode
and prefill schemes on a quantized pool against the fp32 oracle, and the
quantized engines' greedy tokens.

Inputs are made with numpy from a seed and fed to both packages.
Tolerances: codes and scales bit-equal (fp8 through a uint8 view; block 0
skipped, its contents after duplicate writes are unspecified in both);
kernel vs kernel on the same quantized pool 2e-5 (f32; summation order,
~1e-7 measured); exp_add vs mul 1e-5; the quantized layer against the
exact f32 one at the JAX package's bounds, int8 5e-2 and fp8 2e-1
(quantization error of unit-normal latents: int8 ~7e-3, fp8 ~7e-2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models as jmodels
from repro.core import cache as jcache
from repro.core import mla as jmla
from repro.kernels.mla_decode import mla_decode_paged_kernel as j_decode
from repro.kernels.mla_prefill import mla_prefill_paged_kernel as j_prefill
from repro.runtime import PagedMLAEngine as JEngine
from repro.runtime import Request as JRequest
from repro.runtime import SamplingParams as JSP
import repro_torch.configs as tconfigs
from repro_torch.core import cache as tcache
from repro_torch.core import mla as tmla
from repro_torch.kernels import ref as tref
from repro_torch.kernels.mla_decode import mla_decode_paged_kernel
from repro_torch.kernels.mla_prefill import mla_prefill_paged_kernel
from repro_torch.launch import serve as tserve
from repro_torch.runtime import PagedMLAEngine as TEngine
from repro_torch.runtime import Request as TRequest
from repro_torch.runtime import SamplingParams as TSP
from repro_torch.weights import from_jax_params

from _torch_parity import np_params, to_jax

# the suite runs in parallel worker processes: a small intra-op pool
# keeps these tests from crowding the others (and is faster at this size)
torch.set_num_threads(2)

CACHE_DTYPES = ("int8", "fp8")
ORACLE_TOL = {"int8": 5e-2, "fp8": 2e-1}
KERNEL_TOL = 2e-5
RESCALE_TOL = 1e-5
MCFG_KW = dict(d_model=64, n_heads=4, q_lora_rank=48, kv_lora_rank=32,
               qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)
ARCH = "deepseek-v2-236b"


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _bits(a) -> np.ndarray:
    """The raw bytes of a JAX array or a tensor (int8 / fp8 / f32)."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.uint8) if a.element_size() == 1 else a
        return a.numpy().view(np.uint8)
    a = np.asarray(a)
    return a.view(np.uint8)


# ----------------------------------------------------------------- pools --


@pytest.mark.parametrize("cache_dtype", CACHE_DTYPES)
def test_quantize_latent_is_bit_equal(cache_dtype):
    """Codes and scales of ``quantize_latent`` equal the JAX package's bit
    for bit over magnitudes 1e-6 .. 1e8, with an all-zero row (scale 1,
    codes 0) and exact ties of int8 rounding; dequantize agrees too."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal((8, 40)) * 10.0 ** m
                        for m in (-6, -1, 0, 3, 8)]).astype(np.float32)
    x[3] = 0.0
    x[4, :3] = [127.0, -63.5, 0.5]           # int8 codes at .5 ties
    jdt, jq = jcache.cache_dtype_info(cache_dtype)
    tdt, tq = tcache.cache_dtype_info(cache_dtype)
    assert jq == tq
    jcodes, jscale = jcache.quantize_latent(jnp.asarray(x), jq, jdt)
    tcodes, tscale = tcache.quantize_latent(_t(x), tq, tdt)
    np.testing.assert_array_equal(_bits(tcodes), _bits(jcodes))
    np.testing.assert_array_equal(_bits(tscale), _bits(jscale))
    assert tscale[3, 0] == 1.0 and (tcodes[3].float() == 0).all()
    np.testing.assert_array_equal(
        tcache.dequantize_latent(tcodes, tscale).numpy(),
        np.asarray(jcache.dequantize_latent(jcodes, jscale)))


@pytest.mark.parametrize("cache_dtype", CACHE_DTYPES)
def test_pool_writes_are_bit_equal(cache_dtype):
    """The same write sequence (a chunk with invalid rows routed to the
    null block, two decode writes, a copy_block and a batched copy_blocks)
    leaves every pool leaf bit-equal to the JAX package's (block 0
    skipped), and the gathered view dequantizes identically."""
    rng = np.random.default_rng(1)
    N, bs, Dl, Dr, B, C = 12, 4, 32, 8, 3, 6
    jp = jcache.paged_latent_cache(N, bs, Dl, Dr, jnp.float32,
                                   cache_dtype=cache_dtype)
    tp = tcache.paged_latent_cache(N, bs, Dl, Dr, torch.float32, "cpu",
                                   cache_dtype)
    assert sorted(tp) == sorted(jp)
    bt = np.asarray([[1, 2, 3], [4, 5, 0], [6, 0, 0]], np.int32)
    lens = np.asarray([0, 2, 0], np.int32)
    nv = np.asarray([6, 3, 0], np.int32)
    ckv = rng.standard_normal((B, C, Dl)).astype(np.float32)
    kr = rng.standard_normal((B, C, Dr)).astype(np.float32)
    decode = [(np.asarray(L, np.int32),
               (rng.standard_normal((B, Dl)) * 3).astype(np.float32),
               rng.standard_normal((B, Dr)).astype(np.float32))
              for L in ([6, 5, 0], [7, 6, 0])]

    # eagerly: under jit XLA turns amax / qmax into amax * (1 / qmax), one
    # ulp off IEEE division in ~4 % of the scales; eager JAX and the port
    # divide
    jp = jcache.update_latent_paged_chunk(jp, bt, lens, nv, ckv, kr)
    for L, c1, k1 in decode:
        jp = jcache.update_latent_paged(jp, bt, L, c1, k1)
    jp = jcache.copy_block_paged(jp, 2, 9)
    jp = jcache.copy_blocks_paged(jp, jnp.asarray([1, 5]),
                                  jnp.asarray([10, 11]))
    tcache.update_latent_paged_chunk(tp, _t(bt), _t(lens), _t(nv), _t(ckv),
                                     _t(kr))
    for L, c1, k1 in decode:
        tcache.update_latent_paged(tp, _t(bt), _t(L), _t(c1), _t(k1))
    tcache.copy_block_paged(tp, 2, 9)
    tcache.copy_blocks_paged(tp, _t(np.asarray([1, 5])),
                             _t(np.asarray([10, 11])))
    for k in jp:
        assert tp[k].dtype == (torch.float32 if k.endswith("_scale")
                               else tcache.cache_dtype_info(cache_dtype)[0])
        np.testing.assert_array_equal(_bits(tp[k][1:]), _bits(jp[k][1:]), k)
    got = tcache.gather_latent_paged(tp, _t(bt))
    want = jcache.gather_latent_paged(jp, jnp.asarray(bt))
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy()[:2], np.asarray(b)[:2])


@pytest.mark.parametrize("cache_dtype", ("bf16",) + CACHE_DTYPES)
@pytest.mark.parametrize("kind", ["decode", "chunk"])
def test_rows_sharing_a_pool_slot_write_the_last_rows_values(kind,
                                                             cache_dtype):
    """Idle rows and chunk padding all write into the null block: a batched
    write leaves every leaf bit-equal to writing the rows one by one in
    order (the last row's values where rows share a slot), so the pool's
    content does not depend on which of several writes lands first."""
    rng = np.random.default_rng(4)
    N, bs, Dl, Dr, C = 8, 4, 16, 8, 3
    bt = torch.tensor([[0, 0], [3, 4], [0, 0], [5, 1], [0, 0]],
                      dtype=torch.int32)
    lens = torch.tensor([0, 5, 0, 2, 0], dtype=torch.int32)
    nv = torch.tensor([0, 3, 0, 2, 0], dtype=torch.int32)
    B = len(lens)
    shape = (B,) if kind == "decode" else (B, C)
    ckv = _t(rng.standard_normal(shape + (Dl,)).astype(np.float32))
    kr = _t(rng.standard_normal(shape + (Dr,)).astype(np.float32))

    def write(pool, rows):
        if kind == "decode":
            tcache.update_latent_paged(pool, bt[rows], lens[rows], ckv[rows],
                                       kr[rows])
        else:
            tcache.update_latent_paged_chunk(pool, bt[rows], lens[rows],
                                             nv[rows], ckv[rows], kr[rows])

    def pool():
        return tcache.paged_latent_cache(N, bs, Dl, Dr, torch.float32, "cpu",
                                         cache_dtype)
    got, want = pool(), pool()
    write(got, slice(None))
    for b in range(B):
        write(want, slice(b, b + 1))
    for k in got:
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]), k)


def test_pool_bytes_and_names():
    for cd in (None, "bf16", "int8", "fp8"):
        assert tcache.bytes_per_token_latent(512, 64, 2, cd) == \
            jcache.bytes_per_token_latent(512, 64, 2, cd)
    with pytest.raises(ValueError, match="cache_dtype"):
        tcache.cache_dtype_info("int4")
    pool = tcache.paged_latent_cache(3, 2, 16, 8, torch.bfloat16, "cpu",
                                     "bf16")
    assert not tcache.is_quantized_pool(pool) and \
        pool["ckv"].dtype == torch.bfloat16


# ----------------------------------------------------- quantized kernels --


def _quantize(ckv, krope, cache_dtype):
    """(JAX operands, torch operands): codes and scales of both leaves,
    quantized by each package (bit-equal, test above)."""
    jdt, q = jcache.cache_dtype_info(cache_dtype)
    tdt, _ = tcache.cache_dtype_info(cache_dtype)
    jc, jcs = jcache.quantize_latent(jnp.asarray(ckv), q, jdt)
    jr, jrs = jcache.quantize_latent(jnp.asarray(krope), q, jdt)
    tc, tcs = tcache.quantize_latent(_t(ckv), q, tdt)
    tr, trs = tcache.quantize_latent(_t(krope), q, tdt)
    return (jc, jr, jcs, jrs), (tc, tr, tcs, trs)


def _latents(N, bs, Dl, Dr, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((N, bs, Dl)).astype(np.float32),
            rng.standard_normal((N, bs, Dr)).astype(np.float32))


# the adversarial tables of the JAX package's quantized-pool tests
@pytest.mark.parametrize("B,H,Dl,Dr,bs,nb,N,idx,table", [
    (3, 4, 32, 8, 8, 4, 16, [5, 31, 12], "scrambled"),
    (2, 4, 32, 8, 8, 4, 12, [17, -1], "null_holes"),
    (2, 8, 64, 16, 4, 3, 10, [0, 9], "stale"),
])
@pytest.mark.parametrize("cache_dtype", CACHE_DTYPES)
def test_quantized_decode_matches_jax(B, H, Dl, Dr, bs, nb, N, idx, table,
                                      cache_dtype):
    """Plain quantized K1 (both rescales) against the JAX kernel with
    scales in interpret mode and the port's quantized oracle; the oracle
    against the exact f32 one within the quantization bound.  Null blocks
    mid-table, an inactive slot, and stale blocks poisoned with 1e4."""
    ckv, krope = _latents(N, bs, Dl, Dr, B + N)
    q = np.random.default_rng(7).standard_normal(
        (B, H, Dl + Dr)).astype(np.float32)
    rng = np.random.default_rng(3)
    if table == "null_holes":
        bt = rng.integers(1, N, (B, nb))
        bt[:, 1] = 0
    else:
        bt = rng.permutation(np.arange(1, N))[:B * nb].reshape(B, nb)
    if table == "stale":
        outside = np.setdiff1d(np.arange(N), bt.ravel())
        ckv[outside] = 1e4
        krope[outside] = 1e4
    bt = bt.astype(np.int32)
    idx = np.asarray(idx, np.int32)
    (jc, jr, jcs, jrs), (tc, tr, tcs, trs) = _quantize(ckv, krope,
                                                       cache_dtype)
    args = (_t(q), tc, tr, _t(bt), _t(idx))
    qkw = dict(ckv_scales=tcs, krope_scales=trs)
    oracle = tref.mla_decode_paged_ref(*args, **qkw)
    exact = tref.mla_decode_paged_ref(_t(q), _t(ckv), _t(krope), _t(bt),
                                      _t(idx))
    assert (oracle - exact).abs().max() <= ORACLE_TOL[cache_dtype]
    for rescale in tref.RESCALES:
        want = j_decode(jnp.asarray(q), jc, jr, bt, idx, ckv_scales=jcs,
                        krope_scales=jrs, rescale=rescale, interpret=True)
        got = mla_decode_paged_kernel(*args, rescale=rescale, **qkw)
        _close(got, np.asarray(want), KERNEL_TOL)
        _close(got, oracle.numpy(), KERNEL_TOL)
        assert (got[idx < 0] == 0).all()


@pytest.mark.parametrize("B,C,H,Dl,Dr,bs,nb,N,lengths,n_valid", [
    (3, 6, 4, 32, 8, 4, 8, 16, [0, 5, 11], [6, 3, 0]),   # ragged + idle row
    (2, 4, 4, 32, 8, 8, 3, 8, [8, 15], [4, 1]),  # boundary start + 1-tail
])
@pytest.mark.parametrize("cache_dtype", CACHE_DTYPES)
def test_quantized_prefill_matches_jax(B, C, H, Dl, Dr, bs, nb, N, lengths,
                                       n_valid, cache_dtype):
    ckv, krope = _latents(N, bs, Dl, Dr, 11)
    q = np.random.default_rng(5).standard_normal(
        (B, C, H, Dl + Dr)).astype(np.float32)
    bt = np.random.default_rng(9).integers(1, N, (B, nb)).astype(np.int32)
    bt[0, -1] = 0                         # null tail block
    lengths = np.asarray(lengths, np.int32)
    n_valid = np.asarray(n_valid, np.int32)
    (jc, jr, jcs, jrs), (tc, tr, tcs, trs) = _quantize(ckv, krope,
                                                       cache_dtype)
    args = (_t(q), tc, tr, _t(bt), _t(lengths), _t(n_valid))
    qkw = dict(ckv_scales=tcs, krope_scales=trs)
    oracle = tref.mla_prefill_paged_ref(*args, **qkw)
    for rescale in tref.RESCALES:
        want = j_prefill(jnp.asarray(q), jc, jr, bt, lengths, n_valid,
                         ckv_scales=jcs, krope_scales=jrs, rescale=rescale,
                         interpret=True)
        got = mla_prefill_paged_kernel(*args, rescale=rescale, **qkw)
        _close(got, np.asarray(want), KERNEL_TOL)
        _close(got, oracle.numpy(), KERNEL_TOL)
        for b in range(B):
            assert (got[b, n_valid[b]:] == 0).all()


@pytest.mark.parametrize("cache_dtype", CACHE_DTYPES)
def test_quantized_exp_add_matches_mul_and_chunk1_equals_decode(cache_dtype):
    """On a quantized pool: the AMLA exponent-add walk agrees with the
    classic multiply (1e-5), and a one-token prefill chunk at position L
    equals the decode kernel at index L (the triangle identity)."""
    B, H, Dl, Dr, bs, nb, N = 3, 4, 32, 8, 8, 3, 10
    ckv, krope = _latents(N, bs, Dl, Dr, 9)
    q = _t(np.random.default_rng(2).standard_normal(
        (B, H, Dl + Dr)).astype(np.float32))
    bt = _t(np.random.default_rng(13).integers(0, N, (B, nb)).astype(
        np.int32))
    L = _t(np.asarray([0, 7, 23], np.int32))
    _, (tc, tr, tcs, trs) = _quantize(ckv, krope, cache_dtype)
    qkw = dict(ckv_scales=tcs, krope_scales=trs)
    outs = {r: mla_decode_paged_kernel(q, tc, tr, bt, L, rescale=r, **qkw)
            for r in tref.RESCALES}
    _close(outs["exp_add"], outs["mul"].numpy(), RESCALE_TOL)
    pre = mla_prefill_paged_kernel(q[:, None], tc, tr, bt, L,
                                   torch.ones(B, dtype=torch.int32), **qkw)
    _close(pre[:, 0], outs["exp_add"].numpy(), RESCALE_TOL)


def test_kernels_refuse_one_scale_without_the_other():
    _, (tc, tr, tcs, _) = _quantize(*_latents(4, 4, 16, 8, 0), "int8")
    q = torch.zeros((1, 2, 24))
    bt = torch.zeros((1, 2), dtype=torch.int32)
    i = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="both"):
        mla_decode_paged_kernel(q, tc, tr, bt, i, ckv_scales=tcs)
    with pytest.raises(ValueError, match="both"):
        mla_prefill_paged_kernel(q[:, None], tc, tr, bt, i, i,
                                 krope_scales=tcs)


# ------------------------------------------------- schemes vs fp32 oracle --


@pytest.fixture(scope="module")
def mla_params():
    cfg = tmla.MLAConfig(**MCFG_KW)
    jp = np_params(jmla.mla_defs(jmla.MLAConfig(**MCFG_KW)), 0)
    tp = jax.tree.map(lambda a: _t(a), jp)
    return cfg, tmla.attach_absorbed_tree(tp, cfg)


def _scatter_history(pool, bt, ckv_hist, krope_hist):
    """Write a (B, S, D) history token by token through the decode write
    path (quantize-on-write for a quantized pool)."""
    B, S = ckv_hist.shape[:2]
    for t in range(S):
        tcache.update_latent_paged(pool, bt, torch.full((B,), t,
                                                        dtype=torch.int32),
                                   ckv_hist[:, t], krope_hist[:, t])
    return pool


@pytest.mark.parametrize("cache_dtype", CACHE_DTYPES)
def test_decode_schemes_on_quantized_pool_vs_fp32(cache_dtype, mla_params):
    """A decode layer over a quantize-on-write pool against the same layer
    over the exact f32 pool, every scheme and both paths (the kernel path
    on seq / rc / ru; naive and 'gather' on the dequantized view), at the
    JAX package's bounds; the write stays quantized with scale amax/qmax."""
    cfg, params = mla_params
    bs, nb, N = 4, 3, 12
    lengths = torch.tensor([3, 11, 7], dtype=torch.int32)
    B, S = len(lengths), bs * nb
    rng = np.random.default_rng(21)
    hist = _t((rng.standard_normal((B, S, cfg.d_model)) * 0.1).astype(
        np.float32))
    ckv_h, krope_h = tmla._kv_latent(params, cfg, hist,
                                     torch.arange(S).expand(B, S))
    bt = _t(rng.permutation(np.arange(1, N))[:B * nb].reshape(B, nb).astype(
        np.int32))
    x_t = _t((rng.standard_normal((B, cfg.d_model)) * 0.1).astype(
        np.float32))
    qdtype, qmax = tcache.cache_dtype_info(cache_dtype)
    for scheme in tmla.SCHEMES:
        for impl in tmla.IMPLS:
            pool_f = _scatter_history(tcache.paged_latent_cache(
                N, bs, cfg.kv_lora_rank, cfg.qk_rope_dim, torch.float32,
                "cpu"), bt, ckv_h, krope_h)
            pool_q = _scatter_history(tcache.paged_latent_cache(
                N, bs, cfg.kv_lora_rank, cfg.qk_rope_dim, torch.float32,
                "cpu", cache_dtype), bt, ckv_h, krope_h)
            want, _ = tmla.mla_decode_paged(params, cfg, x_t, pool_f, bt,
                                            lengths, scheme=scheme)
            got, pool_q = tmla.mla_decode_paged(params, cfg, x_t, pool_q, bt,
                                                lengths, scheme=scheme,
                                                impl=impl)
            _close(got, want.numpy(), ORACLE_TOL[cache_dtype])
            assert pool_q["ckv"].dtype == qdtype
            for b in range(B):
                L = int(lengths[b])
                page, slot = int(bt[b, L // bs]), L % bs
                row = tcache.dequantize_latent(pool_q["ckv"][page, slot],
                                               pool_q["ckv_scale"][page, slot])
                assert float(pool_q["ckv_scale"][page, slot, 0]) == \
                    pytest.approx(float(row.abs().max()) / qmax, rel=0.2)


@pytest.mark.parametrize("cache_dtype", CACHE_DTYPES)
def test_prefill_schemes_on_quantized_pool_vs_fp32(cache_dtype, mla_params):
    """Chunked prefill into a quantized pool through the kernel path, seq /
    rc / ru, against the f32 gather reference (valid rows only)."""
    cfg, params = mla_params
    bs, nb, N, C = 4, 3, 10, 5
    lengths = torch.tensor([0, 4], dtype=torch.int32)
    n_valid = torch.tensor([5, 3], dtype=torch.int32)
    rng = np.random.default_rng(33)
    x = _t((rng.standard_normal((2, C, cfg.d_model)) * 0.1).astype(
        np.float32))
    bt = _t(rng.permutation(np.arange(1, N))[:2 * nb].reshape(2, nb).astype(
        np.int32))
    for scheme in ("seq", "rc", "ru"):
        pools = [tcache.paged_latent_cache(N, bs, cfg.kv_lora_rank,
                                           cfg.qk_rope_dim, torch.float32,
                                           "cpu", cd)
                 for cd in (None, cache_dtype)]
        want, _ = tmla.mla_prefill_chunk_paged(params, cfg, x, pools[0], bt,
                                               lengths, n_valid,
                                               scheme=scheme)
        got, pool_q = tmla.mla_prefill_chunk_paged(params, cfg, x, pools[1],
                                                   bt, lengths, n_valid,
                                                   scheme=scheme,
                                                   impl="kernel")
        for b in range(2):
            nv = int(n_valid[b])
            _close(got[b, :nv], want[b, :nv].numpy(), ORACLE_TOL[cache_dtype])
        assert pool_q["ckv"].dtype == tcache.cache_dtype_info(cache_dtype)[0]


# ---------------------------------------------------------- the engines --


@pytest.fixture(scope="module")
def models_pair():
    jcfg = jconfigs.smoke(ARCH)
    tcfg = tconfigs.smoke(ARCH)
    jp = np_params(jmodels.model_defs(jcfg), 0)
    return jcfg, tcfg, to_jax(jp), from_jax_params(jp, tcfg, device="cpu")


def _requests(Req, SP, vocab):
    rng = np.random.default_rng(7)
    return [Req(rid=i, prompt=rng.integers(0, vocab, (p,)).astype(np.int32),
                arrival=a, sampling=SP(max_tokens=g))
            for i, (p, g, a) in enumerate([(9, 4, 0), (13, 3, 1), (5, 5, 3)])]


def _engine(Engine, Req, SP, cfg, params, dtype, cache_dtype, **kw):
    eng = Engine(cfg, params, num_blocks=24, block_size=8, max_batch=2,
                 compute_dtype=dtype, scheme="seq", prefill_chunk=8,
                 cache_dtype=cache_dtype, **kw)
    summary = eng.run(_requests(Req, SP, cfg.vocab))
    return {r.rid: list(r.output) for r in eng.sched.finished}, summary


@pytest.mark.parametrize("cache_dtype", CACHE_DTYPES)
def test_quantized_engine_tokens_match_jax(models_pair, cache_dtype):
    """The engine serving from an int8 / fp8 pool gives the JAX engine's
    greedy tokens (both attention impls; the smoke model at the config's
    own MoE capacity, as the JAX package's test runs it), and prices its
    pool at the quantized bytes per token."""
    jcfg, tcfg, jp, tp = models_pair
    want, jsum = _engine(JEngine, JRequest, JSP, jcfg, jp, jnp.float32,
                         cache_dtype)
    for impl in ("ref", "kernel"):
        got, tsum = _engine(TEngine, TRequest, TSP, tcfg, tp, torch.float32,
                            cache_dtype, impl=impl, device="cpu")
        assert got == want and len(got) == 3
        assert tsum["cache_dtype"] == cache_dtype == jsum["cache_dtype"]
        assert tsum["cache_token_bytes"] == jsum["cache_token_bytes"]


def test_engine_rejects_what_jax_rejects(models_pair):
    _, tcfg, _, tp = models_pair
    kw = dict(num_blocks=8, block_size=8, max_batch=1,
              compute_dtype=torch.float32, scheme="seq", device="cpu")
    with pytest.raises(ValueError, match="cache_dtype"):
        TEngine(tcfg, tp, cache_dtype="int4", **kw)
    with pytest.raises(NotImplementedError, match="chunked"):
        TEngine(tcfg, tp, prefill_mode="per_request", cache_dtype="int8",
                **kw)


def test_quantized_cli_on_cpu(capsys):
    for cd in CACHE_DTYPES:
        tserve.main(["--arch", ARCH, "--smoke", "--paged", "--impl", "kernel",
                     "--device", "cpu", "--batch", "2", "--prompt-len", "9",
                     "--gen", "4", "--cache-dtype", cd])
        assert "[serve] paged: 6 decode tokens" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="chunked"):
        tserve.main(["--arch", ARCH, "--smoke", "--paged", "--device", "cpu",
                     "--cache-dtype", "int8", "--prefill-chunk", "0"])
