"""Parity of the port's attention families (dense MHA / GQA / MQA with
sliding windows and local:global layers, MoE over GQA, a VLM's patch
prefix) with the JAX package, on the CPU: the six configs, the KV cache,
``gqa_decode``, the GQA sublayer in every mode, whole smoke models
(forward, prefill + decode), the loss and its gradients, the weight
bridge, the serving and training CLIs.

Inputs come from numpy with fixed seeds: weights are drawn in the JAX
layout (``_torch_parity.np_params``) and moved into the port with
``weights.from_jax_params``.  Everything is f32, MoE configs at
drop-free capacity (``capacity_factor = n_experts / top_k``).  The JAX
package's ``impl='kernel'`` runs its Pallas flash attention in interpret
mode; the port's runs K4's plain blockwise version (CPU tensors).

Tolerances: 1e-5 abs+rel for one attention call or one sublayer (f32
reduction order and exp rounding differ between the frameworks at
~1e-7), 1e-4 for whole-model logits and gradients (a few layers of that
noise); cache writes are copies, compared bit for bit.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models as jmodels
from repro.core import attention as jattn
from repro.core import cache as jcache
from repro.models import blocks as jblocks
from repro.nn import module as jnnm
from repro.runtime import lm_loss as jlm_loss
import repro_torch.configs as tconfigs
import repro_torch.models as tmodels
from repro_torch.core import attention as tattn
from repro_torch.core import cache as tcache
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.models import blocks as tblocks
from repro_torch.nn import module as tnnm
from repro_torch.optim import adamw as tadamw
from repro_torch.runtime import lm_loss, make_prefill_step, make_serve_step
from repro_torch.runtime import prng
from repro_torch.weights import from_jax_params

from _torch_parity import np_params, to_jax

torch.set_num_threads(2)

ARCHS = ("phi3-mini-3.8b", "starcoder2-7b", "granite-34b", "gemma3-1b",
         "granite-moe-1b-a400m", "internvl2-26b")
ONE_TOL = 1e-5
MODEL_TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol, err_msg=what)


def _drop_free(cfg):
    if not cfg.n_experts:
        return cfg
    return dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)


def _flat(tree, prefix=""):
    """{path: leaf} of a port tree (period list entries by index)."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}/{i}").items()}
    return {prefix: tree}


@functools.lru_cache(maxsize=None)
def _pair(arch: str, seed: int = 0):
    """(jcfg, tcfg, JAX params, port params) of ``arch``'s smoke config at
    drop-free capacity, holding the same f32 values."""
    jcfg = _drop_free(jconfigs.smoke(arch))
    tcfg = _drop_free(tconfigs.smoke(arch))
    host = np_params(jmodels.model_defs(jcfg), seed)
    return jcfg, tcfg, to_jax(host), from_jax_params(host, tcfg,
                                                     device="cpu")


def _inputs(cfg, B=2, L=12, seed=3):
    """(tokens (B, L) int32, embeds (B, P, D) f32 for a VLM else None)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, L)).astype(np.int32)
    emb = None
    if cfg.family == "vlm":
        emb = (rng.standard_normal((B, cfg.n_patches, cfg.d_model))
               * 0.02).astype(np.float32)
    return toks, emb


def _emb(emb, jax_side: bool):
    if emb is None:
        return None
    return jnp.asarray(emb) if jax_side else _t(emb)


# ------------------------------------------------------------- configs ---


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_jax(arch):
    """FULL, SMOKE and SKIP_SHAPES field for field, and the same layer
    plan (gemma3's six-layer periods, granite-moe's all-MoE stack)."""
    assert arch in tconfigs.ARCHS
    for part in ("full", "smoke"):
        t, j = getattr(tconfigs, part)(arch), getattr(jconfigs, part)(arch)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert [[dataclasses.asdict(s) for s in p] if isinstance(p, list)
                else p for p in t.layer_plan()] == \
            [[dataclasses.asdict(s) for s in p] if isinstance(p, list)
             else p for p in j.layer_plan()]
    assert tconfigs.skip_shapes(arch) == jconfigs.skip_shapes(arch)
    assert tmodels.lm.param_count(tconfigs.full(arch)) == \
        jmodels.lm.param_count(jconfigs.full(arch))


def test_shapes_and_registry_match_jax():
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    for arch in ("deepseek-v2-236b", "deepseek-v3-671b"):
        assert tconfigs.skip_shapes(arch) == jconfigs.skip_shapes(arch)
    # the recurrent families and the encoder-decoder are registered
    # (tests/test_torch_recurrent.py, tests/test_torch_whisper.py)
    for part in ("full", "smoke"):
        assert dataclasses.asdict(getattr(tconfigs, part)("whisper-medium")) \
            == dataclasses.asdict(getattr(jconfigs, part)("whisper-medium"))
    for arch in ("jamba-1.5-large-398b", "xlstm-350m", "whisper-medium"):
        assert tconfigs.skip_shapes(arch) == jconfigs.skip_shapes(arch)


# ------------------------------------------------------------ KV cache ---


@pytest.mark.parametrize("index,n_new", [
    (0, 5), (3, 1), (6, 4),
    (9, 3),      # runs past the end: clamped to S - n_new = 7
    (40, 1),     # far past: the last slot
    (-2, 2),     # negative: counts from the end, S - 2
    (-30, 2),    # then clamped to 0
])
def test_update_kv_is_bit_equal_to_jax(index, n_new):
    """kv_cache zeros, then update_kv at ``index`` — including starts the
    reference's dynamic_update_slice clamps — bit for bit, in place."""
    B, S, Hkv, Dh = 2, 10, 3, 8
    rng = np.random.default_rng(index + 47)
    k0, v0 = (rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32)
              for _ in range(2))
    kn, vn = (rng.standard_normal((B, n_new, Hkv, Dh)).astype(np.float32)
              for _ in range(2))
    jc = jcache.kv_cache(B, S, Hkv, Dh, jnp.float32)
    tc = tcache.kv_cache(B, S, Hkv, Dh, torch.float32, "cpu")
    assert tc["k"].shape == jc["k"].shape and not tc["k"].any()
    want = jcache.update_kv({"k": jnp.asarray(k0), "v": jnp.asarray(v0)},
                            jnp.asarray(kn), jnp.asarray(vn), index)
    tc = {"k": _t(k0), "v": _t(v0)}
    k_ptr = tc["k"].data_ptr()
    got = tcache.update_kv(tc, _t(kn), _t(vn), index)
    assert got["k"].data_ptr() == k_ptr            # in place
    for name in ("k", "v"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))


@pytest.mark.parametrize("H,Hkv,window,index", [
    (4, 1, None, 9),      # MQA
    (6, 2, None, 13),     # G = 3
    (6, 2, 5, 13),        # G = 3, the window cuts
    (4, 4, 4, 3),         # MHA, the window reaches before position 0
    (4, 1, 8, 15),        # MQA, the window ends at the last slot
])
def test_gqa_decode_matches_jax(H, Hkv, window, index):
    B, S, Dh = 2, 16, 16
    rng = np.random.default_rng(H * 100 + index)
    q = rng.standard_normal((B, H, Dh)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32)
            for _ in range(2))
    want = jattn.gqa_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            index, window=window)
    got = tattn.gqa_decode(_t(q), _t(k), _t(v), index, window=window)
    assert got.shape == (B, H, Dh)
    _close(got, want, ONE_TOL)


@pytest.mark.parametrize("impl", ["ref", "kernel"])
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("layer", ["local", "global"])
def test_gqa_sublayer_matches_jax(layer, mode, impl):
    """One gemma3 smoke sublayer (MQA, a window of 8 on the local layer,
    rope base 1e6 on the global one) through sub_apply: its output, and
    in 'prefill' its KV cache, in 'decode' the cache it updated.  The JAX
    side's 'kernel' is its Pallas flash attention in interpret mode."""
    jcfg, tcfg, _, _ = _pair("gemma3-1b")
    period = tcfg.layer_plan()[1]
    desc = period[0] if layer == "local" else period[-1]
    assert (desc.window is not None) == (layer == "local")
    host = np_params(jblocks.sub_defs(jcfg, desc), 5)
    jp = to_jax(host)
    tp = jax.tree.map(lambda a: _t(a), host)
    B, L, cap = 2, 13, 20
    rng = np.random.default_rng(6)
    if mode == "decode":
        x = rng.standard_normal((B, jcfg.d_model)).astype(np.float32)
        kc, vc = (rng.standard_normal((B, cap, 1, 16)).astype(np.float32)
                  for _ in range(2))
        jctx = jblocks.Ctx(mode="decode", positions=None, index=L,
                           cache={"k": jnp.asarray(kc), "v": jnp.asarray(vc)},
                           impl=impl)
        tctx = tblocks.Ctx(mode="decode", index=L, impl=impl,
                           cache={"k": _t(kc), "v": _t(vc)})
    else:
        x = rng.standard_normal((B, L, jcfg.d_model)).astype(np.float32)
        pos = np.broadcast_to(np.arange(L), (B, L))
        jctx = jblocks.Ctx(mode=mode, positions=jnp.asarray(pos), impl=impl,
                           capacity=cap)
        tctx = tblocks.Ctx(mode=mode, positions=_t(pos), impl=impl,
                           capacity=cap)
    want_x, want_c, _ = jax.jit(lambda p, x: jblocks.sub_apply(
        p, jcfg, desc, x, jctx))(jp, jnp.asarray(x))
    got_x, got_c, _ = tblocks.sub_apply(tp, tcfg, desc, _t(x), tctx)
    _close(got_x, want_x, ONE_TOL)
    if mode == "train":
        assert got_c is None
        return
    for name in ("k", "v"):
        assert got_c[name].shape == want_c[name].shape
        _close(got_c[name], want_c[name], ONE_TOL, name)


def test_gqa_sublayer_refuses_what_the_port_does_not_run():
    jcfg, tcfg, _, tp = _pair("starcoder2-7b")
    desc = tcfg.layer_plan()[1][0]
    p = tp["period"][0]["s0"]
    x = torch.zeros((1, 4, tcfg.d_model))
    pos = torch.arange(4)[None]
    with pytest.raises(NotImplementedError, match="'pallas'"):
        tblocks.sub_apply(p, tcfg, desc, x, tblocks.Ctx(
            mode="train", positions=pos, impl="pallas"))
    with pytest.raises(NotImplementedError,
                       match="chunked paged prefill requires MLA"):
        tblocks.sub_apply(p, tcfg, desc, x, tblocks.Ctx(mode="prefill_chunk"))
    with pytest.raises(NotImplementedError,
                       match="paged serving requires MLA attention"):
        tmodels.init_paged_cache(tcfg, 8, 4, torch.float32, "cpu")


@pytest.mark.parametrize("mixer", ["mamba", "mlstm", "slstm"])
def test_recurrent_mixers_point_at_the_roadmap(mixer):
    """The recurrent mixers are ported (ROADMAP.md queue 1, item 17;
    their parity: tests/test_torch_recurrent.py): a sublayer of each
    built on an attention family's config has the JAX package's
    parameter definitions, leaf for leaf; a mixer neither package has
    raises."""
    jcfg = jconfigs.smoke("phi3-mini-3.8b")
    tcfg = tconfigs.smoke("phi3-mini-3.8b")
    desc = tmodels.Sub(mixer=mixer)
    kind = lambda _, p: (p.shape, p.axes, p.init, p.scale)
    assert tnnm.map_defs(kind, tblocks.sub_defs(tcfg, desc)) == \
        jnnm.map_defs(kind, jblocks.sub_defs(jcfg, desc))
    with pytest.raises(ValueError, match="gru"):
        tblocks.sub_defs(tcfg, tmodels.Sub(mixer="gru"))


def test_windowed_layer_cache_capacity_is_capped_at_max_seq():
    """init_cache: a windowed layer's KV cache holds min(capacity,
    max_seq) positions, a global layer's the capacity, as in the
    reference."""
    jcfg, tcfg, _, _ = _pair("gemma3-1b")
    cap = tcfg.max_seq + 9
    want = jmodels.init_cache(jcfg, 1, cap, jnp.float32)
    got = tmodels.init_cache(tcfg, 1, cap, torch.float32, "cpu")
    for i, (desc, c) in enumerate(tmodels.lm.layers(tcfg, got)):
        p, s = divmod(i, 6)
        assert c["k"].shape == want["period"][f"s{s}"]["k"].shape[1:]
        assert c["k"].shape[1] == (tcfg.max_seq if desc.window else cap)


# ------------------------------------------------------ whole models ---


@functools.lru_cache(maxsize=None)
def _jax_forward(arch: str, L: int):
    jcfg, _, jp, _ = _pair(arch)
    toks, emb = _inputs(jcfg, L=L)
    logits, aux = jax.jit(lambda p, t, e: jmodels.forward(
        p, jcfg, t, embeds=e, compute_dtype=jnp.float32))(
            jp, jnp.asarray(toks), _emb(emb, True))
    return np.asarray(logits), jax.tree.map(np.asarray, aux)


@pytest.mark.parametrize("impl", ["ref", "kernel"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax(arch, impl):
    jcfg, tcfg, _, tp = _pair(arch)
    toks, emb = _inputs(jcfg, L=12)
    want, waux = _jax_forward(arch, 12)
    got, aux = tmodels.forward(tp, tcfg, _t(toks).long(),
                               embeds=_emb(emb, False),
                               compute_dtype=torch.float32, impl=impl)
    assert got.shape == want.shape == (2, 12 + jcfg.n_patches, jcfg.vocab)
    _close(got, want, MODEL_TOL)
    for k in ("balance", "z_loss", "dropped_frac"):
        # dropped_frac = 1 - kept / total: f32 noise ~1e-7 around 0
        assert float(aux[k]) == pytest.approx(float(waux[k]), rel=1e-5,
                                              abs=1e-6), k


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax_and_forward(arch):
    """The contiguous steps: prefill of 12 tokens (after the VLM's
    patches) into a cache of P + 12 + 5 positions, then 4 greedy decode
    steps whose index counts every cached position, patches included:
    each logits row against the JAX package's and against the port's own
    teacher-forced forward over the sequence so far (impl 'ref' and
    'kernel')."""
    jcfg, tcfg, jp, tp = _pair(arch)
    toks, emb = _inputs(jcfg, L=12)
    P, gen = jcfg.n_patches, 4
    cap = P + 12 + gen + 1
    jpre = jax.jit(lambda p, t, e: jmodels.prefill(
        p, jcfg, t, embeds=e, capacity=cap, compute_dtype=jnp.float32))
    jstep = jax.jit(lambda p, t, c, i: jmodels.decode_step(
        p, jcfg, t, c, i, compute_dtype=jnp.float32))
    jl, jc = jpre(jp, jnp.asarray(toks), _emb(emb, True))
    want = [np.asarray(jl)]
    seq = toks
    for i in range(gen):
        nxt = np.argmax(want[-1], -1).astype(np.int32)
        seq = np.concatenate([seq, nxt[:, None]], 1)
        jl, jc = jstep(jp, jnp.asarray(nxt), jc, P + 12 + i)
        want.append(np.asarray(jl))
    for impl in ("ref", "kernel"):
        pre = make_prefill_step(tcfg, capacity=cap,
                                compute_dtype=torch.float32, impl=impl)
        step = make_serve_step(tcfg, compute_dtype=torch.float32, impl=impl)
        logits, cache = pre(tp, _t(toks).long(), _emb(emb, False))
        _close(logits, want[0], MODEL_TOL, f"{impl} prefill")
        for i in range(gen):
            logits, cache = step(tp, _t(seq[:, 12 + i]).long(), cache,
                                 P + 12 + i)
            _close(logits, want[i + 1], MODEL_TOL, f"{impl} step {i}")
        full, _ = tmodels.forward(tp, tcfg, _t(seq).long(),
                                  embeds=_emb(emb, False),
                                  compute_dtype=torch.float32, impl=impl)
        _close(logits, full[:, -1], MODEL_TOL, f"{impl} against forward")


@pytest.mark.parametrize("arch", ARCHS)
def test_weights_bridge_carries_every_gqa_leaf(arch):
    """from_jax_params: every leaf of the JAX tree lands in the port's
    tree bit for bit, gemma3's two six-layer periods and granite-moe's
    four MoE layers unstacked; a wrong shape is refused."""
    jcfg, tcfg, _, _ = _pair(arch)
    host = np_params(jmodels.model_defs(jcfg), 9)
    tp = from_jax_params(host, tcfg, device="cpu")
    got = _flat(tp)
    _, period, n_periods, _ = tcfg.layer_plan()
    assert len(tp["period"]) == n_periods
    n_host = sum(np.asarray(a).size for a in jax.tree.leaves(host))
    assert sum(t.numel() for t in got.values()) == n_host
    for p in range(n_periods):
        for i in range(len(period)):
            for name in ("w_q", "w_k", "w_v", "w_o"):
                np.testing.assert_array_equal(
                    tp["period"][p][f"s{i}"]["attn"][name].numpy(),
                    host["period"][f"s{i}"]["attn"][name][p])
    bad = jax.tree.map(lambda a: a, host)
    bad["period"]["s0"]["attn"]["w_k"] = np.zeros((1, 2, 3), np.float32)
    with pytest.raises(ValueError, match="w_k"):
        from_jax_params(bad, tcfg, device="cpu")


# --------------------------------------------------- loss + gradients ---


@functools.lru_cache(maxsize=None)
def _jax_grads(arch: str, impl: str):
    jcfg, _, jp, _ = _pair(arch)
    toks, emb = _inputs(jcfg, L=12, seed=8)
    labels = np.roll(toks, -1, 1)
    labels[:, -1] = -100
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, t, lb, e: jlm_loss(p, jcfg, t, lb, embeds=e,
                                     compute_dtype=jnp.float32, impl=impl),
        has_aux=True))(jp, jnp.asarray(toks), jnp.asarray(labels),
                       _emb(emb, True))
    return float(loss), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("impl", ["ref", "kernel"])
@pytest.mark.parametrize("arch", ["gemma3-1b", "granite-moe-1b-a400m",
                                  "internvl2-26b"])
def test_loss_and_every_gradient_match_jax(arch, impl):
    """lm_loss and the gradient of every leaf, f32 (the MoE at drop-free
    capacity; the VLM scores its text positions only)."""
    jcfg, tcfg, _, tp = _pair(arch)
    toks, emb = _inputs(jcfg, L=12, seed=8)
    labels = np.roll(toks, -1, 1)
    labels[:, -1] = -100
    j_loss, j_grads = _jax_grads(arch, impl)
    params = jax.tree.map(torch.clone, tp)
    leaves = [t.requires_grad_(True) for t in tadamw.tree_leaves(params)]
    loss, _ = lm_loss(params, tcfg, _t(toks).long(), _t(labels).long(),
                      embeds=_emb(emb, False), compute_dtype=torch.float32,
                      impl=impl)
    grads = torch.autograd.grad(loss, leaves)
    assert float(loss.detach()) == pytest.approx(j_loss, rel=1e-5)
    it = iter(grads)
    got = _flat(tadamw.tree_map(lambda _: next(it), params))
    want = _flat(from_jax_params(j_grads, tcfg, device="cpu"))
    assert set(got) == set(want)
    for path in got:
        _close(got[path], want[path], MODEL_TOL, path)
    assert float(got["/period/0/s0/attn/w_k"].abs().max()) > 0


def test_vlm_loss_chunk_matches_dense():
    """The vocab-chunked loss drops the patch positions as the dense one
    does."""
    _, tcfg, _, tp = _pair("internvl2-26b")
    toks, emb = _inputs(tcfg, L=12, seed=8)
    labels = _t(np.roll(toks, -1, 1)).long()
    dense, _ = lm_loss(tp, tcfg, _t(toks).long(), labels, embeds=_t(emb),
                       compute_dtype=torch.float32)
    chunked, _ = lm_loss(tp, tcfg, _t(toks).long(), labels, embeds=_t(emb),
                         compute_dtype=torch.float32, loss_chunk=5)
    assert float(chunked) == pytest.approx(float(dense), rel=1e-6)


# ------------------------------------------------------ embeds + CLIs ---


@pytest.mark.parametrize("seed", [0, 3])
def test_prng_normal_matches_jax(seed):
    """runtime.prng.normal against jax.random.normal under the second key
    of a split, as the serve launcher draws a VLM's patches: the uniform
    draws are bit for bit; erfinv may round differently (<= 32 ulps)."""
    shape = (2, 8, 64)
    want = np.asarray(jax.random.normal(
        jax.random.split(jax.random.PRNGKey(seed + 1))[1], shape,
        jnp.float32))
    got = prng.normal(prng.split(prng.PRNGKey(seed + 1))[1], shape).numpy()
    ulps = np.abs(got - want) / np.spacing(np.abs(want))
    assert ulps.max() <= 32
    emb = tserve.stub_embeds(tconfigs.smoke("internvl2-26b"), 2, seed, "cpu")
    _close(emb[:, :, :64].numpy() / 0.02, want[:, :, :64], 1e-5)
    assert tserve.stub_embeds(tconfigs.smoke("gemma3-1b"), 2, seed,
                              "cpu") is None


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_on_each_arch(arch, capsys):
    """The contiguous launcher serves each arch's smoke model ('seq'
    without an auto_dispatch line), the same greedy sample under 'ref'
    and 'kernel'; --paged refuses with the reference's error."""
    samples = set()
    for impl in ("ref", "kernel"):
        tserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                     "--batch", "2", "--prompt-len", "9", "--gen", "4",
                     "--impl", impl])
        out = capsys.readouterr().out
        assert "[serve] decoded 3 steps" in out and "scheme=seq" in out
        assert "auto_dispatch" not in out
        assert ("after 8 patches" in out) == (arch == "internvl2-26b")
        samples.add(out.split("[serve] sample:")[1].strip())
    assert len(samples) == 1
    with pytest.raises(NotImplementedError,
                       match="PagedMLAEngine requires an MLA model"):
        tserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                     "--paged"])


def test_train_cli_on_the_vlm(tmp_path, capsys):
    """The training launcher on the VLM (its batches carry the patch
    prefix, drawn as the reference draws them) with the kernels' plain
    versions: the loss logged at step 20 is below step 10's."""
    tlaunch.main(["--arch", "internvl2-26b", "--smoke", "--steps", "20",
                  "--batch", "4", "--seq", "32", "--device", "cpu",
                  "--impl", "kernel", "--ckpt-every", "10",
                  "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    losses = [float(line.split("loss=")[1].split()[0])
              for line in out.splitlines() if line.startswith("[loop] step")]
    assert len(losses) == 2 and losses[1] < losses[0]
    make = tlaunch.batch_maker(tconfigs.smoke("internvl2-26b"), "cpu",
                               torch.float32)
    b = make(np.full((2, 16), 5, np.int32), np.zeros((2, 16), np.int32))
    assert b["embeds"].shape == (2, 8, 64)
    want = jax.random.normal(jax.random.PRNGKey(5), (2, 8, 64)) * 0.02
    _close(b["embeds"], want, 1e-5)
