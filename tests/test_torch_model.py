"""Parity of the port's model code with the JAX package on the small
configs: configs and layer plans, parameter definitions and init, the
weight bridge, base layers, the paged latent pool, MLA decode / chunked
prefill for every scheme on both attention paths, MoE with its aux terms,
and the model's logits.

Inputs are made with numpy (or by the JAX package's own init) and fed to
both packages; the port gets the JAX weights through
``repro_torch.weights.from_jax_params``.  Everything is f32.  Tolerances:
2e-5 abs+rel for one layer (the JAX package's f32 kernel tolerance;
reduction order and exp/rsqrt rounding differ between the frameworks at
~1e-7), 1e-4 for whole-model logits (four layers of that noise).  Pool
writes are copies and compared bit for bit.
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
from repro.models import blocks as jblocks
from repro.models import moe as jmoe
from repro.nn import layers as jnl
from repro.nn import module as jnnm
import repro_torch.configs as tconfigs
import repro_torch.models as tmodels
from repro_torch.core import cache as tcache
from repro_torch.core import mla as tmla
from repro_torch.models import blocks as tblocks
from repro_torch.models import common as tcommon
from repro_torch.models import moe as tmoe
from repro_torch.nn import layers as tnl
from repro_torch.nn import module as tnnm
from repro_torch.weights import from_jax_params

from _torch_parity import np_params, to_jax

# the suite runs in parallel worker processes: a small intra-op pool
# keeps these tests from crowding the others (and is faster at this size)
torch.set_num_threads(2)

TOL = 2e-5
ARCH = "deepseek-v2-236b"
MCFG_KW = dict(d_model=64, n_heads=4, q_lora_rank=48, kv_lora_rank=32,
               qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _drop_free(cfg):
    return dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


# ------------------------------------------------------ configs + plans ---


@pytest.mark.parametrize("arch", sorted(jconfigs._MODULES))
def test_layer_plan_matches_every_jax_config(arch):
    """The port's ModelConfig computes the same layer plan as the JAX
    package's for every config there (full and smoke)."""
    for jcfg in (jconfigs.full(arch), jconfigs.smoke(arch)):
        tcfg = tcommon.ModelConfig(**dataclasses.asdict(jcfg))
        want = [[dataclasses.asdict(s) for s in part]
                if isinstance(part, list) else part
                for part in jcfg.layer_plan()]
        got = [[dataclasses.asdict(s) for s in part]
               if isinstance(part, list) else part
               for part in tcfg.layer_plan()]
        assert got == want
        assert dataclasses.asdict(tcfg.mla_config()) == \
            dataclasses.asdict(jcfg.mla_config())


def test_deepseek_configs_match():
    """DeepSeek-V2's configs, and whisper's, now registered
    (tests/test_torch_whisper.py), field for field."""
    for arch in (ARCH, "whisper-medium"):
        assert dataclasses.asdict(tconfigs.full(arch)) == \
            dataclasses.asdict(jconfigs.full(arch))
        assert dataclasses.asdict(tconfigs.smoke(arch)) == \
            dataclasses.asdict(jconfigs.smoke(arch))


def test_param_defs_and_count_match_jax():
    cfg = tconfigs.smoke(ARCH)
    full = tconfigs.full(ARCH)
    assert tnnm.count_params(tmodels.model_defs(cfg)) == \
        jnnm.count_params(jmodels.model_defs(jconfigs.smoke(ARCH)))
    assert tmodels.lm.param_count(full) == \
        jmodels.lm.param_count(jconfigs.full(ARCH))


def test_init_matches_jax_distributions():
    """Same distributions as the JAX init (not the same bits): every leaf
    has the std its JAX definition implies — period leaves counting the
    stacking axis in their fan-in, as the JAX package draws them
    stacked — within 10% where the leaf is large enough to measure;
    ones / zeros exact."""
    cfg = tconfigs.smoke(ARCH)
    tp = tnnm.init_params(tmodels.model_defs(cfg), seed=0, device="cpu")
    want = from_jax_params(
        np_params(jmodels.model_defs(jconfigs.smoke(ARCH)), 0), cfg,
        device="cpu")
    t_leaves = jax.tree_util.tree_leaves(tp)
    j_leaves = jax.tree_util.tree_leaves(want)
    assert len(t_leaves) == len(j_leaves)
    for a, b in zip(t_leaves, j_leaves):
        assert a.shape == b.shape and a.dtype == b.dtype
        if (b == 1).all() or (b == 0).all():
            assert torch.equal(a, b)
        elif b.numel() >= 4096:
            assert abs(a.std().item() / b.std().item() - 1) < 0.1
    bf = tnnm.init_params({"w": tnnm.P((64, 64), (None, None))}, seed=1,
                          dtype=torch.bfloat16, device="cpu")["w"]
    assert bf.dtype == torch.bfloat16 and abs(bf.float().std() - 1 / 8) < 0.02


def test_weights_bridge_is_exact_and_unstacks_periods():
    jcfg, tcfg = jconfigs.smoke(ARCH), tconfigs.smoke(ARCH)
    jp = np_params(jmodels.model_defs(jcfg), 3)
    tp = from_jax_params(jp, tcfg, device="cpu")
    _, _, n_periods, _ = tcfg.layer_plan()
    assert len(tp["period"]) == n_periods == 3
    for p in range(n_periods):
        np.testing.assert_array_equal(
            tp["period"][p]["s0"]["ffn"]["gate_up"].numpy(),
            jp["period"]["s0"]["ffn"]["gate_up"][p])
    np.testing.assert_array_equal(tp["prefix"]["l0"]["attn"]["w_uq"].numpy(),
                                  jp["prefix"]["l0"]["attn"]["w_uq"])
    bf = from_jax_params(_tree_np(jax.tree.map(
        lambda a: a.astype(jnp.bfloat16), jp)), tcfg, device="cpu")
    assert bf["embed"]["table"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        bf["embed"]["table"].float().numpy(),
        np.asarray(jnp.asarray(jp["embed"]["table"]).astype(jnp.bfloat16)
                   .astype(jnp.float32)))
    bad = dict(jp, ln_f={"scale": np.ones(3, np.float32)})
    with pytest.raises(ValueError):
        from_jax_params(bad, tcfg, device="cpu")


# ----------------------------------------------------------- nn layers ----


def test_layers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = np.asarray([[0, 1, 2, 7, 100], [3, 4, 5, 6, 9]], np.int32)
    scale = rng.standard_normal(16).astype(np.float32)
    _close(tnl.rmsnorm({"scale": _t(scale)}, _t(x)),
           jnl.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)))
    for xx in (x, x[:, :, 0]):
        _close(tnl.apply_rope(_t(xx), _t(pos), 500.0),
               jnl.apply_rope(jnp.asarray(xx), jnp.asarray(pos), 500.0))
    table = rng.standard_normal((11, 16)).astype(np.float32)
    ids = np.asarray([[1, 10, 3]])
    emb = tnl.embed({"table": _t(table)}, _t(ids).long(), torch.float32)
    _close(emb, jnl.embed({"table": jnp.asarray(table)}, jnp.asarray(ids),
                          jnp.float32))
    _close(tnl.unembed({"table": _t(table)}, emb),
           jnl.unembed({"table": jnp.asarray(table)}, jnp.asarray(emb)))
    for kind in ("swiglu", "gelu"):
        jp = np_params(jnl.mlp_defs(16, 24, kind, bias=True), 1)
        tp = jax.tree.map(_t, jp)
        _close(tnl.mlp(tp, _t(x), kind), jnl.mlp(jp, jnp.asarray(x), kind))


# ------------------------------------------------------------------ pool ---


def test_pool_writes_are_bit_equal_to_jax():
    """The same write sequence — chunk writes with padding and idle rows,
    single-token writes, one CoW copy and a batched copy — leaves every
    non-null block bit-equal (the null block absorbs garbage by contract,
    with duplicate writes in unspecified order)."""
    rng = np.random.default_rng(0)
    N, bs, Dl, Dr, B, nb, C = 12, 4, 8, 4, 3, 3, 5
    bt = np.asarray([[3, 7, 0], [5, 1, 9], [0, 0, 0]], np.int32)
    jp = jcache.paged_latent_cache(N, bs, Dl, Dr, jnp.float32)
    tp = tcache.paged_latent_cache(N, bs, Dl, Dr, torch.float32, "cpu")
    lens = np.asarray([0, 2, 0], np.int32)
    nv = np.asarray([5, 4, 0], np.int32)
    ckv = rng.standard_normal((B, C, Dl)).astype(np.float32)
    kr = rng.standard_normal((B, C, Dr)).astype(np.float32)
    jp = jcache.update_latent_paged_chunk(jp, bt, lens, nv, ckv, kr)
    tcache.update_latent_paged_chunk(tp, _t(bt), _t(lens), _t(nv), _t(ckv),
                                     _t(kr))
    for L in (np.asarray([5, 6, 0], np.int32), np.asarray([6, 7, 0], np.int32)):
        c1 = rng.standard_normal((B, Dl)).astype(np.float32)
        k1 = rng.standard_normal((B, Dr)).astype(np.float32)
        jp = jcache.update_latent_paged(jp, bt, L, c1, k1)
        tcache.update_latent_paged(tp, _t(bt), _t(L), _t(c1), _t(k1))
    jp = jcache.copy_block_paged(jp, 7, 10)
    tcache.copy_block_paged(tp, 7, 10)
    jp = jcache.copy_blocks_paged(jp, jnp.asarray([3, 5]), jnp.asarray([11, 2]))
    tcache.copy_blocks_paged(tp, _t(np.asarray([3, 5])), _t(np.asarray([11, 2])))
    for k in ("ckv", "krope"):
        np.testing.assert_array_equal(tp[k].numpy()[1:], np.asarray(jp[k])[1:])
    got = tcache.gather_latent_paged(tp, _t(bt))
    want = jcache.gather_latent_paged(jp, jnp.asarray(bt))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy()[:2], np.asarray(b)[:2])
    np.testing.assert_array_equal(
        tcache.paged_valid_mask(7, _t(lens)).numpy(),
        np.asarray(jcache.paged_valid_mask(7, jnp.asarray(lens))))


def test_cache_bytes_match_jax():
    for cd in (None, "bf16", "int8", "fp8"):
        assert tcache.cache_element_bytes(512, 64, 2, cd) == \
            jcache.cache_element_bytes(512, 64, 2, cd)
    with pytest.raises(ValueError):
        tcache.bytes_per_token_latent(512, 64, 2, "int4")


# ------------------------------------------------------------------- MLA ---


@pytest.fixture(scope="module")
def mla_setup():
    jcfg = jmla.MLAConfig(**MCFG_KW)
    tcfg = tmla.MLAConfig(**MCFG_KW)
    jp = jmla.prepare_serving(to_jax(np_params(jmla.mla_defs(jcfg), 0)),
                              jcfg, "ru")
    tp = tmla.attach_absorbed_tree(
        {k: v for k, v in jax.tree.map(_t, _tree_np(jp)).items()
         if k != "w_absorb"}, tcfg)
    return jcfg, tcfg, jp, tp


def test_attach_absorbed_matches_jax(mla_setup):
    jcfg, _, jp, tp = mla_setup
    _close(tp["w_absorb"], jp["w_absorb"])
    tree = tmla.attach_absorbed_tree({"layers": [{"a": dict(tp)}]},
                                     tmla.MLAConfig(**MCFG_KW))
    assert "w_absorb" in tree["layers"][0]["a"]


def _paged_state(seed=0):
    rng = np.random.default_rng(seed)
    N, bs, nb = 20, 8, 4
    pool_ckv = (rng.standard_normal((N, bs, 32)) * 0.5).astype(np.float32)
    pool_kr = (rng.standard_normal((N, bs, 8)) * 0.5).astype(np.float32)
    bt = rng.permutation(np.arange(1, N))[:3 * nb].reshape(3, nb)
    bt = bt.astype(np.int32)
    bt[2, 2:] = 0                                   # null tail entries
    return pool_ckv, pool_kr, bt


@pytest.mark.parametrize("scheme", tmla.SCHEMES)
@pytest.mark.parametrize("impl", tmla.IMPLS)
def test_mla_decode_paged_matches_jax(mla_setup, scheme, impl):
    jcfg, tcfg, jp, tp = mla_setup
    ckv, kr, bt = _paged_state()
    lengths = np.asarray([5, 31, 8], np.int32)       # block boundary at 8
    x = (np.random.default_rng(1).standard_normal((3, 64)) * 0.5
         ).astype(np.float32)
    jpool = {"ckv": jnp.asarray(ckv), "krope": jnp.asarray(kr)}
    tpool = {"ckv": _t(ckv), "krope": _t(kr)}
    kern = None
    if impl == "kernel":
        def kern(q, c, r, t, i, softmax_scale):
            return jkops.mla_decode_paged_attention(
                q, c, r, t, i, impl="kernel", softmax_scale=softmax_scale)
    want, jpool = jax.jit(lambda x, pool: jmla.mla_decode_paged(
        jp, jcfg, x, pool, bt, lengths, scheme=scheme,
        decode_kernel=kern))(jnp.asarray(x), jpool)
    got, tpool = tmla.mla_decode_paged(tp, tcfg, _t(x), tpool, _t(bt),
                                       _t(lengths), scheme=scheme, impl=impl)
    _close(got, want)
    for k in ("ckv", "krope"):
        _close(tpool[k][1:], np.asarray(jpool[k])[1:])


@pytest.mark.parametrize("scheme", tmla.SCHEMES)
@pytest.mark.parametrize("impl", tmla.IMPLS)
def test_mla_prefill_chunk_paged_matches_jax(mla_setup, scheme, impl):
    jcfg, tcfg, jp, tp = mla_setup
    ckv, kr, bt = _paged_state(2)
    lengths = np.asarray([0, 24, 0], np.int32)
    n_valid = np.asarray([6, 5, 0], np.int32)        # idle row 2
    x = (np.random.default_rng(3).standard_normal((3, 6, 64)) * 0.5
         ).astype(np.float32)
    jpool = {"ckv": jnp.asarray(ckv), "krope": jnp.asarray(kr)}
    tpool = {"ckv": _t(ckv), "krope": _t(kr)}
    want, jpool = jax.jit(lambda x, pool: jmla.mla_prefill_chunk_paged(
        jp, jcfg, x, pool, bt, lengths, n_valid, scheme=scheme,
        impl="pallas" if impl == "kernel" else "gather"))(jnp.asarray(x),
                                                          jpool)
    got, tpool = tmla.mla_prefill_chunk_paged(
        tp, tcfg, _t(x), tpool, _t(bt), _t(lengths), _t(n_valid),
        scheme=scheme, impl=impl)
    for b in range(2):                     # idle rows are garbage by contract
        _close(got[b, :n_valid[b]], np.asarray(want)[b, :n_valid[b]])
    for k in ("ckv", "krope"):
        _close(tpool[k][1:], np.asarray(jpool[k])[1:])


def test_mla_rejects_unknown_scheme_and_impl(mla_setup):
    _, tcfg, _, tp = mla_setup
    ckv, kr, bt = _paged_state()
    pool = {"ckv": _t(ckv), "krope": _t(kr)}
    args = (tp, tcfg, torch.zeros(3, 64), pool, _t(bt),
            torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        tmla.mla_decode_paged(*args, scheme="mha")
    with pytest.raises(ValueError):
        tmla.mla_decode_paged(*args, impl="pallas")


# ------------------------------------------------------------------- MoE ---


@pytest.mark.parametrize("drop_free", [True, False])
def test_moe_matches_jax(drop_free):
    """Outputs and aux terms (balance, z-loss, dropped fraction); at the
    config's own capacity tokens are dropped, identically at equal
    shapes."""
    jcfg = jconfigs.smoke(ARCH)
    if drop_free:
        jcfg = _drop_free(jcfg)
    tcfg = tcommon.ModelConfig(**dataclasses.asdict(jcfg))
    jp = np_params(jmoe.moe_defs(jcfg), 5)
    tp = jax.tree.map(_t, jp)
    x = np.random.default_rng(6).standard_normal((4, 7, 64)).astype(np.float32)
    want, jaux = jax.jit(lambda x: jmoe.moe_apply(jp, jcfg, x))(
        jnp.asarray(x))
    got, taux = tmoe.moe_apply(tp, tcfg, _t(x))
    _close(got, want)
    for k in ("balance", "z_loss", "dropped_frac"):
        _close(taux[k], jaux[k])
    assert (float(taux["dropped_frac"]) == 0.0) == drop_free


def test_moe_topk_ties_go_to_the_lower_index():
    cfg = dataclasses.replace(tconfigs.smoke(ARCH), capacity_factor=4.0)
    tp = tnnm.init_params(tmoe.moe_defs(cfg), seed=0, device="cpu")
    tp["router"] = torch.zeros_like(tp["router"])    # all experts tie
    jp = {k: (jax.tree.map(lambda a: jnp.asarray(a.numpy()), v)
              if isinstance(v, dict) else jnp.asarray(v.numpy()))
          for k, v in tp.items()}
    x = np.random.default_rng(0).standard_normal((5, 64)).astype(np.float32)
    jcfg = jconfigs.smoke(ARCH)
    jcfg = dataclasses.replace(jcfg, capacity_factor=4.0)
    _close(tmoe.moe_apply(tp, cfg, _t(x))[0],
           jax.jit(lambda x: jmoe.moe_apply(jp, jcfg, x)[0])(jnp.asarray(x)))


# ----------------------------------------------------------- the model ----


@pytest.mark.parametrize("impl", ["ref", "kernel"])
def test_model_logits_match_jax(impl):
    """One chunked prefill then one decode step of the whole smoke model
    (1 dense + 3 MoE layers), logits and pools against the JAX package."""
    jcfg = _drop_free(jconfigs.smoke(ARCH))
    tcfg = _drop_free(tconfigs.smoke(ARCH))
    jp = jmla.attach_absorbed_tree(
        to_jax(np_params(jmodels.model_defs(jcfg), 2)), jcfg.mla_config())
    tp = tmla.attach_absorbed_tree(from_jax_params(_tree_np(jp), tcfg,
                                                   device="cpu"),
                                   tcfg.mla_config())
    N, bs = 12, 4
    jpool = jmodels.init_paged_cache(jcfg, N, bs, jnp.float32)
    tpool = tmodels.init_paged_cache(tcfg, N, bs, torch.float32, "cpu")
    bt = np.asarray([[1, 2, 3], [4, 5, 0], [0, 0, 0]], np.int32)
    toks = np.random.default_rng(4).integers(0, 256, (3, 6)).astype(np.int32)
    lens = np.asarray([0, 0, 0], np.int32)
    nv = np.asarray([6, 3, 0], np.int32)
    jimpl = "kernel" if impl == "kernel" else "ref"
    want, jpool = jax.jit(lambda t, pool: jmodels.prefill_chunk_paged(
        jp, jcfg, t, pool, bt, lens, nv, compute_dtype=jnp.float32,
        impl=jimpl, scheme="seq"))(jnp.asarray(toks), jpool)
    got, tpool = tmodels.prefill_chunk_paged(
        tp, tcfg, _t(toks).long(), tpool, _t(bt), _t(lens), _t(nv),
        compute_dtype=torch.float32, impl=impl, scheme="seq")
    _close(got[:2], np.asarray(want)[:2], 1e-4)
    tok = np.asarray([7, 9, 0], np.int32)
    dl = np.asarray([6, 3, 0], np.int32)
    for scheme in ("ru",):
        want, _ = jax.jit(lambda t, pool, scheme=scheme: jmodels.decode_step(
            jp, jcfg, t, pool, None, compute_dtype=jnp.float32, impl=jimpl,
            scheme=scheme, block_tables=bt, lengths=dl))(jnp.asarray(tok),
                                                         jpool)
        tcopy = jax.tree.map(torch.clone, tpool)
        got, _ = tmodels.decode_step(tp, tcfg, _t(tok).long(), tcopy,
                                     _t(bt), _t(dl),
                                     compute_dtype=torch.float32, impl=impl,
                                     scheme=scheme)
        _close(got[:2], np.asarray(want)[:2], 1e-4)
    for (desc, a), (_, b) in zip(tmodels.lm.layers(tcfg, tpool),
                                 [(None, jpool["prefix"]["l0"])] + [
                                     (None, jax.tree.map(lambda x, p=p: x[p],
                                                         jpool["period"]["s0"]))
                                     for p in range(3)]):
        _close(a["ckv"][1:], np.asarray(b["ckv"])[1:])


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "xlstm-350m",
                                  "whisper-medium"])
def test_unported_mixers_raise(arch):
    """The recurrent families and the encoder-decoder are ported (their
    parity: tests/test_torch_recurrent.py, tests/test_torch_whisper.py):
    the parameter definitions have the JAX package's shapes, inits and
    count (whisper's per-layer encoder and decoder dicts those of the
    reference's stacked leaves, less the layer axis), and a mixer
    neither package has still raises."""
    jcfg = jconfigs.smoke(arch)
    cfg = tcommon.ModelConfig(**dataclasses.asdict(jcfg))
    kind = lambda _, p: (p.shape, p.init)
    defs = tmodels.model_defs(cfg)
    jdefs = jmodels.model_defs(jcfg)
    assert tnnm.count_params(defs) == jnnm.count_params(jdefs)
    if arch == "whisper-medium":
        assert set(defs) == set(jdefs)
        for name, node in defs.items():
            if isinstance(node, list):       # stacked on 'layers' there
                want = jnnm.map_defs(lambda _, p: (p.shape[1:], p.init),
                                     jdefs[name])
                assert len(node) == jnnm.map_defs(
                    lambda _, p: p.shape[0], jdefs[name])["ln1"]["scale"]
                assert all(tnnm.map_defs(kind, n) == want for n in node)
            else:
                assert tnnm.map_defs(kind, node) == \
                    jnnm.map_defs(kind, jdefs[name])
        return
    for desc, node in tmodels.lm.layers(cfg, defs):
        assert tnnm.map_defs(kind, node) == \
            jnnm.map_defs(kind, jblocks.sub_defs(jcfg, desc))
    with pytest.raises(ValueError, match="gru"):
        tblocks.sub_defs(cfg, tmodels.Sub(mixer="gru"))
