"""Parity of the port's contiguous-cache serving path with the JAX package:
kernel K3's plain version and the dense oracle, ``core.mla.mla_decode``
for every scheme, the contiguous prefill / serve steps on the smoke
model, and the engine's per-request prefill.

Inputs are made with numpy from a seed and fed to both packages; the
Pallas kernels run in interpret mode.  Tolerances: K3 1e-5 in f32 (the
blockwise online softmax and the exact one sum in other orders, and exp2
/ exp round differently in the two frameworks, ~1e-7) and 2e-2 in bf16
(one bf16 step of an output below 4 is 2^-6 = 1.6e-2); one MLA layer
2e-5 (the JAX package's f32 kernel tolerance); whole-model logits 1e-4
(four layers of that noise).  Caches are copies of the same f32 values,
compared at 2e-5.  The smoke model runs at drop-free MoE capacity, as the
other engine parity tests do.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models as jmodels
from repro.core import cache as jcache
from repro.core import mla as jmla
from repro.kernels import ops as jkops
from repro.kernels import ref as jref
from repro.kernels.mla_decode import mla_decode_kernel as j_decode
from repro.runtime import PagedMLAEngine as JEngine
from repro.runtime import Request as JRequest
from repro.runtime import SamplingParams as JSP
from repro.runtime import make_prefill_step as j_prefill_step
from repro.runtime import make_serve_step as j_serve_step
import repro_torch.configs as tconfigs
import repro_torch.models as tmodels
from repro_torch.core import cache as tcache
from repro_torch.core import mla as tmla
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.mla_decode import mla_decode_kernel
from repro_torch.launch import serve as tserve
from repro_torch.runtime import PagedMLAEngine as TEngine
from repro_torch.runtime import Request as TRequest
from repro_torch.runtime import SamplingParams as TSP
from repro_torch.runtime import make_prefill_step as t_prefill_step
from repro_torch.runtime import make_serve_step as t_serve_step
from repro_torch.runtime import scatter_prefill_to_paged
from repro_torch.weights import from_jax_params

from _torch_parity import np_params, to_jax

# the suite runs in parallel worker processes: a small intra-op pool
# keeps these tests from crowding the others (and is faster at this size)
torch.set_num_threads(2)

ARCH = "deepseek-v2-236b"
K3_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
LAYER_TOL = 2e-5
LOGITS_TOL = 1e-4
MCFG_KW = dict(d_model=64, n_heads=4, q_lora_rank=48, kv_lora_rank=32,
               qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _drop_free(cfg):
    return dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)


# ------------------------------------------------------------------- K3 ---


def _k3_inputs(B, H, S, Dl, Dr, dtype, seed):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((B, H, Dl + Dr), (B, S, Dl), (B, S, Dr))]
    jax_in = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays]
    torch_in = [_t(a).to(getattr(torch, dtype)) for a in arrays]
    return jax_in, torch_in


# the grid of the JAX package's own K3 test (tests/test_kernels.py)
@pytest.mark.parametrize("B,H,S,Dl,Dr,index,block", [
    (1, 4, 64, 32, 8, 0, 32),       # first token
    (2, 8, 100, 32, 8, 57, 32),     # mid-cache, ragged S
    (1, 16, 256, 64, 16, 255, 64),  # full cache
    (2, 128, 128, 512, 64, 100, 64),  # deepseek-v2 head/latent dims
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k3_plain_and_oracle_match_jax(B, H, S, Dl, Dr, index, block, dtype):
    """The port's oracle against the JAX oracle, and K3's plain version
    (the wrapper on CPU tensors, both rescales, the JAX tile size and the
    wrapper's own) against the JAX kernel in interpret mode."""
    (jq, jc, jr), (tq, tc, tr) = _k3_inputs(B, H, S, Dl, Dr, dtype, S + H)
    tol = K3_TOL[dtype]
    want = jref.mla_decode_ref(jq, jc, jr, index)
    _close(tref.mla_decode_ref(tq, tc, tr, index).float(),
           np.asarray(want, np.float32), tol)
    for rescale in tref.RESCALES:
        jk = j_decode(jq, jc, jr, index, block_k=block, rescale=rescale,
                      interpret=True)
        got = tref.mla_decode_ref(tq, tc, tr, index, rescale=rescale,
                                  block_k=block)
        assert got.dtype == tq.dtype and got.shape == (B, H, Dl)
        _close(got.float(), np.asarray(jk, np.float32), tol)
        _close(mla_decode_kernel(tq, tc, tr, index, rescale=rescale).float(),
               np.asarray(jk, np.float32), tol)


def test_k3_masks_beyond_index():
    """Entries past ``index`` do not influence the result (poisoned with
    1e4), in the oracle and in both rescales of the plain version, which
    matches the JAX kernel on the poisoned cache."""
    (jq, jc, jr), (tq, tc, tr) = _k3_inputs(1, 4, 64, 32, 8, "float32", 5)
    tc_p, tr_p = tc.clone(), tr.clone()
    tc_p[:, 20:] = 1e4
    tr_p[:, 20:] = 1e4
    want = j_decode(jq, jc.at[:, 20:].set(1e4), jr.at[:, 20:].set(1e4), 19,
                    block_k=16, interpret=True)
    for rescale in (None,) + tref.RESCALES:
        kw = dict(rescale=rescale, block_k=16)
        clean = tref.mla_decode_ref(tq, tc, tr, 19, **kw)
        poisoned = tref.mla_decode_ref(tq, tc_p, tr_p, 19, **kw)
        _close(poisoned, clean.numpy(), 1e-6)
        _close(poisoned, np.asarray(want), K3_TOL["float32"])


def test_k3_strided_views_negative_index_and_ops():
    """The plain version reads a strided view as it is (no padding, no
    copy needed), gives zero rows for index -1 as the kernel does, and
    ``ops.mla_decode_attention`` routes 'ref' to the oracle and 'kernel'
    to K3's wrapper (its plain version here)."""
    rng = np.random.default_rng(9)
    q = _t(rng.standard_normal((2, 4, 40)).astype(np.float32))
    big = _t(rng.standard_normal((2, 30, 48)).astype(np.float32))
    ckv, krope = big[:, 3:26, :32], big[:, 3:26, 40:]       # views
    assert not ckv.is_contiguous()
    for rescale in tref.RESCALES:
        got = mla_decode_kernel(q, ckv, krope, 17, rescale=rescale)
        want = tref.mla_decode_ref(q, ckv.contiguous(), krope.contiguous(),
                                   17)
        _close(got, want.numpy(), 1e-5)
        assert (mla_decode_kernel(q, ckv, krope, -1, rescale=rescale)
                == 0).all()
    before = mla_decode_kernel.launches
    _close(tops.mla_decode_attention(q, ckv, krope, 17, impl="kernel"),
           tops.mla_decode_attention(q, ckv, krope, 17, impl="ref").numpy(),
           1e-5)
    assert mla_decode_kernel.launches == before      # no launch on the CPU
    with pytest.raises(TypeError):
        mla_decode_kernel(q, ckv, krope, torch.tensor(17))
    with pytest.raises(ValueError):
        mla_decode_kernel(q, ckv, krope, 17, rescale="fma")


# ---------------------------------------------------- contiguous cache ---


def test_latent_cache_writes_match_jax():
    rng = np.random.default_rng(2)
    jc = jcache.latent_cache(3, 10, 32, 8, jnp.float32)
    tc = tcache.latent_cache(3, 10, 32, 8, torch.float32, "cpu")
    for index, n in ((0, 4), (4, 1), (9, 1)):
        c = rng.standard_normal((3, n, 32)).astype(np.float32)
        r = rng.standard_normal((3, n, 8)).astype(np.float32)
        jc = jcache.update_latent(jc, c, r, index)
        out = tcache.update_latent(tc, _t(c), _t(r), index)
        assert out is tc
    for k in ("ckv", "krope"):
        np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]))


@pytest.fixture(scope="module")
def mla_setup():
    jcfg = jmla.MLAConfig(**MCFG_KW)
    tcfg = tmla.MLAConfig(**MCFG_KW)
    jp = jmla.prepare_serving(to_jax(np_params(jmla.mla_defs(jcfg), 0)),
                              jcfg, "ru")
    tp = tmla.attach_absorbed_tree(
        {k: jax.tree.map(lambda a: _t(np.asarray(a)), v)
         for k, v in jp.items() if k != "w_absorb"}, tcfg)
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("scheme", tmla.SCHEMES)
@pytest.mark.parametrize("impl", tmla.IMPLS)
def test_mla_decode_matches_jax(mla_setup, scheme, impl):
    """Three decode steps of one MLA layer over a contiguous cache (a
    random prefix of 5 entries, capacity 12, ragged against the kernel's
    tiles), every scheme: outputs and both cache leaves after each step."""
    jcfg, tcfg, jp, tp = mla_setup
    rng = np.random.default_rng(4)
    B, S = 3, 12
    ckv = np.zeros((B, S, 32), np.float32)
    kr = np.zeros((B, S, 8), np.float32)
    ckv[:, :5] = rng.standard_normal((B, 5, 32)) * 0.5
    kr[:, :5] = rng.standard_normal((B, 5, 8)) * 0.5
    jcache = {"ckv": jnp.asarray(ckv), "krope": jnp.asarray(kr)}
    tcache_ = {"ckv": _t(ckv), "krope": _t(kr)}
    kern = None
    if impl == "kernel":
        def kern(q, c, r, i, softmax_scale):
            return jkops.mla_decode_attention(q, c, r, i, impl="kernel",
                                              softmax_scale=softmax_scale)
    step = jax.jit(lambda x, cache, i: jmla.mla_decode(
        jp, jcfg, x, cache, i, scheme=scheme, decode_kernel=kern))
    for index in (5, 6, 7):
        x = (rng.standard_normal((B, 64)) * 0.5).astype(np.float32)
        want, jcache = step(jnp.asarray(x), jcache, jnp.int32(index))
        got, tcache_ = tmla.mla_decode(tp, tcfg, _t(x), tcache_, index,
                                       scheme=scheme, impl=impl)
        _close(got, np.asarray(want), LAYER_TOL)
        for k in ("ckv", "krope"):
            _close(tcache_[k], np.asarray(jcache[k]), LAYER_TOL)


# ------------------------------------------------- the smoke model, e2e ---


@pytest.fixture(scope="module")
def models_pair():
    jcfg = _drop_free(jconfigs.smoke(ARCH))
    tcfg = _drop_free(tconfigs.smoke(ARCH))
    jp = np_params(jmodels.model_defs(jcfg), 0)
    return jcfg, tcfg, to_jax(jp), from_jax_params(jp, tcfg, device="cpu")


def _jax_greedy(jcfg, jp, toks, gen, scheme, impl="ref"):
    """JAX's contiguous prefill + serve steps: (tokens (B, gen), logits
    of the prefill and of every decode step)."""
    if scheme == "ru":
        jp = jmla.attach_absorbed_tree(jp, jcfg.mla_config())
    B, L = toks.shape
    prefill = j_prefill_step(jcfg, None, batch=B, capacity=L + gen + 1,
                             compute_dtype=jnp.float32, impl=impl,
                             scheme=scheme)
    step = j_serve_step(jcfg, None, compute_dtype=jnp.float32, impl=impl,
                        scheme=scheme)
    logits, cache = prefill(jp, jnp.asarray(toks, jnp.int32))
    rows, out = [np.asarray(logits)], [np.asarray(jnp.argmax(logits, -1))]
    for i in range(gen - 1):
        logits, cache = step(jp, jnp.asarray(out[-1]), cache, L + i)
        rows.append(np.asarray(logits))
        out.append(np.asarray(jnp.argmax(logits, -1)))
    return np.stack(out, 1), rows


def _torch_greedy(tcfg, tp, toks, gen, scheme, impl):
    if scheme == "ru":
        tp = tmla.attach_absorbed_tree(tp, tcfg.mla_config())
    B, L = toks.shape
    prefill = t_prefill_step(tcfg, capacity=L + gen + 1,
                             compute_dtype=torch.float32, impl=impl,
                             scheme=scheme)
    step = t_serve_step(tcfg, compute_dtype=torch.float32, impl=impl,
                        scheme=scheme)
    logits, cache = prefill(tp, _t(toks).long())
    rows, out = [logits.numpy()], [torch.argmax(logits, -1)]
    for i in range(gen - 1):
        logits, cache = step(tp, out[-1], cache, L + i)
        rows.append(logits.numpy())
        out.append(torch.argmax(logits, -1))
    return torch.stack(out, 1).numpy(), rows


@pytest.mark.parametrize("scheme", tmla.SCHEMES)
def test_contiguous_steps_match_jax(models_pair, scheme):
    """make_prefill_step + make_serve_step on the smoke model (1 dense + 3
    MoE layers), batch 2 x 11 prompt tokens, 6 generated: greedy tokens
    identical to the JAX package's steps and every logits row within
    1e-4, under impl 'ref' and 'kernel' (flash-attention forward + K3,
    their plain versions here).  The JAX kernel path (Pallas in interpret
    mode) is held to the same tokens for 'seq'."""
    jcfg, tcfg, jp, tp = models_pair
    toks = np.random.default_rng(6).integers(0, jcfg.vocab, (2, 11))
    gen = 6
    want, want_rows = _jax_greedy(jcfg, jp, toks, gen, scheme)
    if scheme == "seq":
        jk, _ = _jax_greedy(jcfg, jp, toks, gen, scheme, impl="kernel")
        np.testing.assert_array_equal(jk, want)
    for impl in ("ref", "kernel"):
        got, rows = _torch_greedy(tcfg, tp, toks, gen, scheme, impl)
        np.testing.assert_array_equal(got, want)
        for a, b in zip(rows, want_rows):
            _close(a, b, LOGITS_TOL)


def test_paged_entry_points_scale_embeddings(models_pair):
    """With ``embed_scale`` set (gemma-style sqrt(d_model)), the paged
    prefill chunk and decode step scale the token embeddings as the JAX
    package's do (they used to skip it; no MLA config sets it yet)."""
    jcfg, tcfg, jp, tp = models_pair
    jcfg = dataclasses.replace(jcfg, embed_scale=True)
    tcfg = dataclasses.replace(tcfg, embed_scale=True)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab, (2, 5))
    bt = np.asarray([[1, 2], [3, 4]], np.int32)
    lens, nv = np.zeros(2, np.int32), np.asarray([5, 4], np.int32)
    jpool = jmodels.init_paged_cache(jcfg, 6, 4, jnp.float32)
    tpool = tmodels.init_paged_cache(tcfg, 6, 4, torch.float32, "cpu")
    want, jpool = jax.jit(lambda t, pool: jmodels.prefill_chunk_paged(
        jp, jcfg, t, pool, bt, lens, nv, compute_dtype=jnp.float32))(
            jnp.asarray(toks, jnp.int32), jpool)
    got, _ = tmodels.prefill_chunk_paged(
        tp, tcfg, _t(toks).long(), tpool, _t(bt), _t(lens), _t(nv),
        compute_dtype=torch.float32)
    _close(got, np.asarray(want), LOGITS_TOL)
    tok = np.asarray([7, 9], np.int32)
    want, _ = jax.jit(lambda t, pool: jmodels.decode_step(
        jp, jcfg, t, pool, None, compute_dtype=jnp.float32,
        block_tables=bt, lengths=nv))(jnp.asarray(tok), jpool)
    got, _ = tmodels.decode_step(tp, tcfg, _t(tok).long(), tpool, _t(bt),
                                 _t(nv), compute_dtype=torch.float32)
    _close(got, np.asarray(want), LOGITS_TOL)


def _paged_pool(tcfg, **kw):
    return tmodels.init_paged_cache(tcfg, 6, 4, torch.float32, "cpu", **kw)


def test_prefill_returns_capacity_cache(models_pair):
    """The prefill cache has ``capacity`` positions per layer, the L
    entries first and zeros after, and its entries equal the chunked
    paged prefill's pool rows for the same prompt."""
    jcfg, tcfg, _, tp = models_pair
    toks = _t(np.random.default_rng(8).integers(0, tcfg.vocab, (1, 7)))
    _, cache = t_prefill_step(tcfg, capacity=13,
                              compute_dtype=torch.float32)(tp, toks)
    pool = _paged_pool(tcfg)
    bt = torch.tensor([[1, 2, 3, 0]], dtype=torch.int32)
    tmodels.prefill_chunk_paged(tp, tcfg, toks, pool, bt,
                                torch.tensor([0], dtype=torch.int32),
                                torch.tensor([7], dtype=torch.int32),
                                compute_dtype=torch.float32)
    layers = list(zip(tmodels.lm.layers(tcfg, cache),
                      tmodels.lm.layers(tcfg, pool)))
    assert len(layers) == tcfg.n_layers
    for (_, c), (_, p) in layers:
        for k in ("ckv", "krope"):
            assert c[k].shape[:2] == (1, 13)
            assert (c[k][:, 7:] == 0).all()
            _close(c[k][0, :7], p[k][1:3].reshape(8, -1)[:7].numpy(),
                   LAYER_TOL)
    # the per-request handoff writes the same rows into the pool
    pool2 = _paged_pool(tcfg)
    scatter_prefill_to_paged(pool2, cache, bt[0])
    for (_, a), (_, b) in zip(tmodels.lm.layers(tcfg, pool2),
                              tmodels.lm.layers(tcfg, pool)):
        for k in ("ckv", "krope"):
            _close(a[k][1:3].reshape(8, -1)[:7], b[k][1:3].reshape(
                8, -1)[:7].numpy(), LAYER_TOL)


def _shared_prefix_requests(Req, SP, vocab, n=4, pre=12):
    """The JAX package's shared-prefix stream (tests/test_prefix_cache.py):
    a 12-token preamble, tails of 5 / 9 / 14, 2-5 generated tokens."""
    rng = np.random.default_rng(5)
    preamble = rng.integers(0, vocab, (pre,)).astype(np.int32)
    reqs = []
    for i in range(n):
        tail = rng.integers(0, vocab,
                            (int(rng.choice([5, 9, 14])),)).astype(np.int32)
        reqs.append(Req(rid=i, prompt=np.concatenate([preamble, tail]),
                        arrival=2 * i,
                        sampling=SP(max_tokens=int(rng.integers(2, 6)))))
    return reqs


def _engine_outputs(Engine, Req, SP, cfg, params, dtype, **kw):
    eng = Engine(cfg, params, num_blocks=40, block_size=4, max_batch=2,
                 compute_dtype=dtype, scheme="seq", **kw)
    eng.run(_shared_prefix_requests(Req, SP, cfg.vocab))
    return {r.rid: list(r.output) for r in eng.sched.finished}, eng.summary()


def test_per_request_engine_matches_jax_and_contiguous(models_pair):
    """``prefill_mode='per_request'`` gives the JAX engine's greedy tokens
    (impl 'kernel': the flash forward's and the paged decode kernel's
    plain versions here), turns the prefix cache off, and the port's
    chunked engine and its contiguous greedy give the same tokens."""
    jcfg, tcfg, jp, tp = models_pair
    want, jsum = _engine_outputs(JEngine, JRequest, JSP, jcfg, jp,
                                 jnp.float32, prefill_mode="per_request")
    got, tsum = _engine_outputs(TEngine, TRequest, TSP, tcfg, tp,
                                torch.float32, impl="kernel", device="cpu",
                                prefill_mode="per_request")
    assert got == want
    assert tsum["prefix_hit_tokens"] == 0 == jsum["prefix_hit_tokens"]
    assert tsum["prefill_tokens"] == jsum["prefill_tokens"]
    chunked, csum = _engine_outputs(TEngine, TRequest, TSP, tcfg, tp,
                                    torch.float32, impl="kernel",
                                    device="cpu", prefill_chunk=6)
    assert chunked == want and csum["prefix_hit_tokens"] > 0
    for r in _shared_prefix_requests(TRequest, TSP, tcfg.vocab):
        got, _ = _torch_greedy(tcfg, tp, np.asarray(r.prompt)[None],
                               r.sampling.max_tokens, "seq", "kernel")
        assert list(got[0]) == want[r.rid], r.rid


def test_scatter_refuses_a_quantized_pool(models_pair):
    _, tcfg, _, tp = models_pair
    _, cache = t_prefill_step(tcfg, capacity=8, compute_dtype=torch.float32)(
        tp, torch.zeros((1, 5), dtype=torch.long))
    with pytest.raises(NotImplementedError, match="chunked"):
        scatter_prefill_to_paged(_paged_pool(tcfg, cache_dtype="int8"),
                                 cache, torch.tensor([1, 2], dtype=torch.int32))


def test_contiguous_cli_on_cpu(capsys):
    """The contiguous launcher: the auto_dispatch line, and the same
    greedy sample for every scheme and both impls."""
    samples = set()
    for extra in (["--scheme", "auto"], ["--scheme", "rc", "--impl", "kernel"],
                  ["--scheme", "naive"]):
        tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch",
                     "2", "--prompt-len", "9", "--gen", "4"] + extra)
        out = capsys.readouterr().out
        assert "[serve] decoded 3 steps" in out
        assert ("auto_dispatch(h100, L=13, B=2) -> scheme"
                in out) == (extra[1] == "auto")
        samples.add(out.split("[serve] sample:")[1].strip())
    assert len(samples) == 1
    with pytest.raises(SystemExit):
        tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                     "--cache-dtype", "int8"])           # needs --paged
