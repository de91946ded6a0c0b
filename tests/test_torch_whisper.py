"""Parity of the port's encoder-decoder (``whisper-medium``) with the JAX
package, on the CPU: the config, the parameter definitions, layer norm,
the decoder embedding and its position clamp, the encoder, the
teacher-forced decoder and the whole forward, prefill with its self and
cross caches and four contiguous decode steps, the loss and every
gradient, one AdamW step, the weight bridge, checkpoints both ways, and
the serving and training CLIs; then K4-K6's plain versions and their
tensor-core walks without a mask, at the lengths whisper gives them.

Inputs come from numpy with fixed seeds: weights are drawn in the JAX
layout (``_torch_parity.np_params``) and moved into the port with
``weights.from_jax_params`` (the JAX package's stacked encoder and
decoder become per-layer lists).  The smoke config (3 decoder layers, 2
encoder layers, d_model 64, 16 frames), everything f32.  The JAX
package's whisper attends in plain ``gqa_attention`` under every impl but
'chunked'; the port's 'kernel' runs K4-K6's plain blockwise versions
(CPU tensors).

Tolerances: 1e-5 abs+rel for one layer, the encoder, the decoder and
whole-model logits and caches (f32 reduction order and exp / rsqrt
rounding differ between the frameworks at ~1e-7; the smoke logits are
O(0.1)); 1e-4 for gradients and the step's parameters, as the other
families' parity tests hold them; bf16 embeddings bit for bit.
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
from repro import optim as joptim
from repro.checkpoint import CheckpointStore as JStore
from repro.core import attention as jattn
from repro.models import whisper as jwhisper
from repro.nn import layers as jnl
from repro.nn import module as jnnm
from repro.runtime import TrainStepConfig as JTrainStepConfig
from repro.runtime import lm_loss as jlm_loss
from repro.runtime import make_train_step as jmake_train_step
from repro.runtime import spec as jspec
import repro_torch.configs as tconfigs
import repro_torch.models as tmodels
from repro_torch import optim as toptim
from repro_torch.checkpoint import CheckpointStore as TStore
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.kernels import _launch
from repro_torch.kernels import flash_attention as tfa
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.models import whisper as twhisper
from repro_torch.nn import layers as tnl
from repro_torch.nn import module as tnnm
from repro_torch.optim import adamw as tadamw
from repro_torch.runtime import (TrainStepConfig, lm_loss, make_prefill_step,
                                 make_serve_step, make_train_step)
from repro_torch.runtime import spec as tspec
from repro_torch.weights import from_jax_params, opt_state_from_jax

from _torch_parity import np_params, to_jax

torch.set_num_threads(2)

ARCH = "whisper-medium"
TOL = 1e-5
GRAD_TOL = 1e-4
JCFG = jconfigs.smoke(ARCH)
TCFG = tconfigs.smoke(ARCH)
B, L = 2, 12


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol, err_msg=what)


def _flat(tree, prefix=""):
    """{path: leaf} of a port tree (list entries by index)."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}/{i}").items()}
    return {prefix: tree}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _pair(seed: int = 0):
    """(JAX params, port params) of the smoke config, the same f32
    values."""
    host = np_params(jmodels.model_defs(JCFG), seed)
    return to_jax(host), from_jax_params(host, TCFG, device="cpu")


def _inputs(seed=3, n=L):
    """(tokens (B, n) int32, frames (B, n_frames, D) f32)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, JCFG.vocab, (B, n)).astype(np.int32)
    frames = (rng.standard_normal((B, JCFG.n_frames, JCFG.d_model))
              * 0.02).astype(np.float32)
    return toks, frames


def _xla(fn, *args):
    """``fn(*args)`` through the JAX package, compiled with XLA's excess
    precision off.  By default XLA's CPU compiler may keep a bf16
    intermediate in f32, and it does so with the decoder embedding's
    bf16 add (``_dec_embed``: ~2e-4 on an embedding, ~1.5e-3 on the
    smoke logits); off, the compiled function gives eager JAX's values
    bit for bit, the rounding the reference's code asks for and the port
    does."""
    compiled = jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})
    return compiled(*args)


def _jimpl(impl):
    """The JAX package's whisper switches on 'chunked' alone."""
    return "chunked" if impl == "chunked" else "ref"


# ------------------------------------------------------- config + defs ---


def test_config_matches_jax():
    """FULL, SMOKE and SKIP_SHAPES field for field, and the parameter
    counts at both sizes (whisper-medium: 24 + 24 layers, ~0.80 B with
    the 32,776 decoder positions)."""
    assert ARCH in tconfigs.ARCHS
    for part in ("full", "smoke"):
        t, j = getattr(tconfigs, part)(ARCH), getattr(jconfigs, part)(ARCH)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert twhisper.param_count(t) == jwhisper.param_count(j)
    assert tconfigs.skip_shapes(ARCH) == jconfigs.skip_shapes(ARCH)


@pytest.mark.parametrize("part", ["smoke", "full"])
def test_param_defs_match_jax(part):
    """Every leaf of the port's definitions has the reference's shape,
    axes, init and standard deviation: the encoder's and the decoder's
    per-layer dicts are the slices of the reference's stacked leaves,
    drawn with the stacked layout's fan-in."""
    jcfg, tcfg = getattr(jconfigs, part)(ARCH), getattr(tconfigs, part)(ARCH)
    jdefs, tdefs = jmodels.model_defs(jcfg), tmodels.model_defs(tcfg)
    std = lambda p: None if p.init in ("zeros", "ones") else tnnm._std(
        tnnm.P(p.shape, p.axes, p.init, p.scale))
    kind = lambda _, p: (p.shape, p.axes, p.init, std(p))
    sliced = lambda _, p: (p.shape[1:], p.axes[1:], p.init, std(p))
    assert set(tdefs) == set(jdefs)
    for name in ("embed", "pos_dec", "ln_enc", "ln_dec"):
        assert tnnm.map_defs(kind, tdefs[name]) == \
            jnnm.map_defs(kind, jdefs[name])
    for name, n in (("encoder", tcfg.n_enc_layers),
                    ("decoder", tcfg.n_layers)):
        assert len(tdefs[name]) == n
        want = jnnm.map_defs(sliced, jdefs[name])
        for layer in tdefs[name]:
            assert tnnm.map_defs(kind, layer) == want
    assert tnnm.count_params(tdefs) == jnnm.count_params(jdefs)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_jax(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3 + 0.5
    p = {"scale": rng.standard_normal(64).astype(np.float32),
         "bias": rng.standard_normal(64).astype(np.float32)}
    want = jnl.layernorm(jax.tree.map(jnp.asarray, p),
                         jnp.asarray(x).astype(dtype))
    got = tnl.layernorm(jax.tree.map(_t, p),
                        _t(x).to(getattr(torch, dtype)))
    assert str(got.dtype).endswith(dtype)
    _close(got.float(), np.asarray(want.astype(jnp.float32)),
           TOL if dtype == "float32" else 1e-2)
    assert tnnm.map_defs(lambda _, q: (q.shape, q.init),
                         tnl.layernorm_defs(64)) == \
        jnnm.map_defs(lambda _, q: (q.shape, q.init), jnl.layernorm_defs(64))


@pytest.mark.parametrize("n,start", [
    (12, 0), (12, 5),
    (12, 116),       # the last slice that fits: max_seq - L
    (12, 117),       # past it: clamped to 116
    (1, 127),        # a decode step at the last position
    (1, 200),        # far past: clamped to 127
    (1, -3),         # negative: counts from the end, max_seq - 3
    (12, -130),      # then clamped to 0
])
def test_dec_embed_rounds_in_bf16_and_clamps_like_jax(n, start):
    """The decoder embedding: token rows plus position rows, added in
    bf16 whatever the compute dtype, the position slice's start taken as
    ``dynamic_slice_in_dim`` takes it (a negative one from the end, then
    clamped to [0, max_seq - L]).  Bit for
    bit, and the f32 decoder input carries the bf16 rounding."""
    jp, tp = _pair()
    toks, _ = _inputs(seed=n + abs(start), n=n)
    want = jwhisper._dec_embed(jp, JCFG, jnp.asarray(toks), start)
    got = twhisper._dec_embed(tp, TCFG, _t(toks).long(), start)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    S = TCFG.max_seq
    lo = min(max(start + S if start < 0 else start, 0), S - n)
    np.testing.assert_array_equal(
        got.float().numpy(), (tp["embed"]["table"][_t(toks).long()].to(
            torch.bfloat16) + tp["pos_dec"][lo:lo + n].to(
                torch.bfloat16)).float().numpy())


# -------------------------------------------------------- whole model ---


@functools.lru_cache(maxsize=None)
def _jax_forward(impl: str):
    jp, _ = _pair()
    toks, frames = (jnp.asarray(a) for a in _inputs())
    enc = _xla(lambda p, f: jwhisper.encode(p, JCFG, f), jp, frames)
    dec = _xla(lambda p, t, e: jwhisper.decoder_forward(
        p, JCFG, t, e, compute_dtype=jnp.float32, impl=impl), jp, toks, enc)
    logits, aux = _xla(lambda p, t, f: jmodels.forward(
        p, JCFG, t, embeds=f, compute_dtype=jnp.float32, impl=impl),
        jp, toks, frames)
    return _np_tree((enc, dec, logits, aux))


@pytest.mark.parametrize("impl", ["ref", "kernel", "chunked"])
def test_encode_decoder_and_forward_match_jax(impl):
    """encode (bidirectional), decoder_forward (causal self-attention,
    cross-attention over the 16 encoded frames) and forward: hidden
    states, logits and the zero aux terms."""
    _, tp = _pair()
    toks, frames = _inputs()
    enc_w, dec_w, logits_w, aux_w = _jax_forward(_jimpl(impl))
    enc = twhisper.encode(tp, TCFG, _t(frames), impl=impl)
    _close(enc, enc_w, TOL, "encode")
    dec = twhisper.decoder_forward(tp, TCFG, _t(toks).long(), _t(enc_w),
                                   compute_dtype=torch.float32, impl=impl)
    _close(dec, dec_w, TOL, "decoder_forward")
    logits, aux = tmodels.forward(tp, TCFG, _t(toks).long(),
                                  embeds=_t(frames),
                                  compute_dtype=torch.float32, impl=impl)
    assert logits.shape == (B, L, TCFG.vocab)
    _close(logits, logits_w, TOL, "forward")
    assert set(aux) == set(aux_w)
    for k, v in aux.items():
        assert float(v) == float(aux_w[k]) == 0.0


@functools.lru_cache(maxsize=None)
def _jax_serve(impl: str, gen: int = 4):
    """The JAX package's prefill of 12 tokens into a cache of 12 + gen +
    1 positions and ``gen`` greedy decode steps at index 12 + i: every
    logits row, the caches after prefill and at the end, the tokens."""
    jp, _ = _pair()
    toks, frames = _inputs()
    cap = L + gen + 1
    jl, jc = _xla(lambda p, t, f: jmodels.prefill(
        p, JCFG, t, embeds=f, capacity=cap, compute_dtype=jnp.float32,
        impl=impl), jp, jnp.asarray(toks), jnp.asarray(frames))
    caches = [_np_tree(jc)]
    step = lambda p, t, c, i: jmodels.decode_step(
        p, JCFG, t, c, i, compute_dtype=jnp.float32)
    logits, seq = [np.asarray(jl)], toks
    for i in range(gen):
        nxt = np.argmax(logits[-1], -1).astype(np.int32)
        seq = np.concatenate([seq, nxt[:, None]], 1)
        jl, jc = _xla(step, jp, jnp.asarray(nxt), jc, jnp.int32(L + i))
        logits.append(np.asarray(jl))
    caches.append(_np_tree(jc))
    return logits, caches, seq


def _hold_cache(got, want, what):
    for part in ("self", "cross"):
        assert len(got[part]) == TCFG.n_layers
        for i, layer in enumerate(got[part]):
            for name in ("k", "v"):
                assert layer[name].shape == want[part][name][i].shape
                _close(layer[name], want[part][name][i], TOL,
                       f"{what} {part}[{i}].{name}")


@pytest.mark.parametrize("impl", ["ref", "kernel", "chunked"])
def test_prefill_and_decode_match_jax_and_forward(impl):
    """The contiguous steps: prefill (the encoder, each layer's cross K/V
    of the 16 frames, the prompt's self K/V padded to capacity), then 4
    greedy decode steps whose index counts decoder tokens alone: each
    logits row and both caches against the JAX package's, the greedy
    tokens identical, and the last step against the port's own
    teacher-forced forward over the sequence so far."""
    _, tp = _pair()
    toks, frames = _inputs()
    gen = 4
    want, caches, seq = _jax_serve(_jimpl(impl), gen)
    pre = make_prefill_step(TCFG, capacity=L + gen + 1,
                            compute_dtype=torch.float32, impl=impl)
    step = make_serve_step(TCFG, compute_dtype=torch.float32, impl=impl)
    logits, cache = pre(tp, _t(toks).long(), _t(frames))
    _close(logits, want[0], TOL, "prefill")
    _hold_cache(cache, caches[0], "prefill")
    got_seq = [torch.argmax(logits, -1)]
    for i in range(gen):
        logits, cache = step(tp, got_seq[-1], cache, L + i)
        _close(logits, want[i + 1], TOL, f"step {i}")
        got_seq.append(torch.argmax(logits, -1))
    _hold_cache(cache, caches[1], "decode")
    np.testing.assert_array_equal(torch.stack(got_seq[:-1], 1).numpy(),
                                  seq[:, L:])
    full, _ = tmodels.forward(tp, TCFG, _t(seq).long(), embeds=_t(frames),
                              compute_dtype=torch.float32, impl=impl)
    _close(logits, full[:, -1], TOL, "against forward")


def test_init_cache_has_the_reference_layout():
    """init_cache: per decoder layer, a self K/V of ``capacity``
    positions and a cross K/V of n_frames, zeros, the reference's
    stacked leaves layer by layer."""
    want = jmodels.init_cache(JCFG, 2, 20, jnp.float32)
    got = tmodels.init_cache(TCFG, 2, 20, torch.float32, "cpu")
    for part in ("self", "cross"):
        assert len(got[part]) == TCFG.n_layers
        for i, layer in enumerate(got[part]):
            for name in ("k", "v"):
                assert layer[name].shape == want[part][name].shape[1:]
                assert layer[name].dtype == torch.float32
                assert not layer[name].any()
    assert got["cross"][0]["k"].shape[1] == TCFG.n_frames


def test_paged_entry_points_and_drafts_refuse_encdec():
    """As in the reference: the paged entry points raise for the
    encoder-decoder, and so does a shallow draft of it (the same
    exception type and message as ``repro.runtime.spec``)."""
    _, tp = _pair()
    with pytest.raises(NotImplementedError,
                       match="paged serving targets decoder-only MLA"):
        tmodels.init_paged_cache(TCFG, 8, 4, torch.float32, "cpu")
    for fn in (tmodels.decode_step, tmodels.prefill_chunk_paged,
               tmodels.verify_chunk_paged):
        with pytest.raises(NotImplementedError,
                           match="paged serving targets decoder-only MLA"):
            fn(tp, TCFG, None, None, None, None, None)
    with pytest.raises(NotImplementedError) as want:
        jspec.shallow_draft(JCFG, None, 1)
    with pytest.raises(NotImplementedError) as got:
        tspec.shallow_draft(TCFG, tp, 1)
    assert str(got.value) == str(want.value)


# --------------------------------------------------- loss + gradients ---


def _labels(toks):
    labels = np.roll(toks, -1, 1)
    labels[:, -1] = -100
    return labels


@functools.lru_cache(maxsize=None)
def _jax_grads(impl: str):
    jp, _ = _pair()
    toks, frames = _inputs(seed=8)
    (loss, _), grads = _xla(jax.value_and_grad(
        lambda p, t, lb, f: jlm_loss(p, JCFG, t, lb, embeds=f,
                                     compute_dtype=jnp.float32, impl=impl),
        has_aux=True), jp, jnp.asarray(toks), jnp.asarray(_labels(toks)),
        jnp.asarray(frames))
    return float(loss), _np_tree(grads)


@pytest.mark.parametrize("impl", ["ref", "kernel", "chunked"])
def test_loss_and_every_gradient_match_jax(impl):
    """lm_loss over the decoder tokens and the gradient of every leaf,
    the encoder's and the frames' path included, f32."""
    _, tp = _pair()
    toks, frames = _inputs(seed=8)
    j_loss, j_grads = _jax_grads(_jimpl(impl))
    params = tadamw.tree_map(torch.clone, tp)
    leaves = [t.requires_grad_(True) for t in tadamw.tree_leaves(params)]
    loss, metrics = lm_loss(params, TCFG, _t(toks).long(),
                            _t(_labels(toks)).long(), embeds=_t(frames),
                            compute_dtype=torch.float32, impl=impl)
    grads = torch.autograd.grad(loss, leaves)
    assert float(loss.detach()) == pytest.approx(j_loss, rel=TOL)
    assert float(metrics["dropped_frac"]) == 0.0
    it = iter(grads)
    got = _flat(tadamw.tree_map(lambda _: next(it), params))
    want = _flat(from_jax_params(j_grads, TCFG, device="cpu"))
    assert set(got) == set(want)
    for path in got:
        _close(got[path], want[path], GRAD_TOL, path)
    assert float(got["/encoder/0/attn/w_k"].abs().max()) > 0
    assert float(got["/decoder/2/cross_attn/w_v"].abs().max()) > 0


def test_remat_on_matches_off():
    """``cfg.remat`` runs each encoder and decoder layer of the training
    forward under ``torch.utils.checkpoint``: the same loss and
    gradients as without it."""
    _, tp = _pair()
    toks, frames = _inputs(seed=8)
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(TCFG, remat=remat)
        params = tadamw.tree_map(torch.clone, tp)
        leaves = [t.requires_grad_(True) for t in tadamw.tree_leaves(params)]
        loss, _ = lm_loss(params, cfg, _t(toks).long(),
                          _t(_labels(toks)).long(), embeds=_t(frames),
                          compute_dtype=torch.float32, impl="kernel")
        out.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        _close(a, b, 1e-6)


def test_train_step_matches_jax():
    """One full step (loss, gradients, clip, AdamW with a cosine
    schedule): params and moments match the JAX step, so the decay
    counts each per-layer list as the reference's stacked axis (its
    layer norms' and biases' (layers, D) leaves decay)."""
    jp, tp = _pair(seed=4)
    tp = tadamw.tree_map(torch.clone, tp)
    toks, frames = _inputs(seed=8)
    lr = (3e-3, 2, 10)
    jopt = joptim.AdamWConfig(lr=joptim.cosine(*lr))
    topt = toptim.AdamWConfig(lr=toptim.cosine(*lr))
    jstep, _ = jmake_train_step(JCFG, None, jopt, JTrainStepConfig(
        compute_dtype=jnp.float32))
    args = (jp, joptim.adamw_init(jp, jopt),
            {"tokens": jnp.asarray(toks), "labels": jnp.asarray(_labels(toks)),
             "embeds": jnp.asarray(frames)})
    jp, js, jm = jstep.lower(*args).compile(compiler_options={
        "xla_allow_excess_precision": False})(*args)     # as _xla
    tstep = make_train_step(TCFG, topt, TrainStepConfig(
        compute_dtype=torch.float32, impl="kernel"))
    tp, ts, tm = tstep(tp, toptim.adamw_init(tp, topt),
                       {"tokens": _t(toks).long(),
                        "labels": _t(_labels(toks)).long(),
                        "embeds": _t(frames)})
    for k in ("loss", "ce", "grad_norm", "lr"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=TOL), k
    want_p = _flat(from_jax_params(_np_tree(jp), TCFG, device="cpu"))
    for path, got in _flat(tp).items():
        _close(got, want_p[path], GRAD_TOL, path)
    want = opt_state_from_jax(_np_tree(js), TCFG, device="cpu")
    for key in ("mu", "nu"):
        for path, got in _flat(ts[key]).items():
            _close(got, _flat(want[key])[path], GRAD_TOL, f"{key}{path}")


# ------------------------------------------------ weights + checkpoints ---


def test_weights_bridge_carries_every_whisper_leaf():
    """from_jax_params: every leaf of the JAX tree lands in the port's
    tree bit for bit, the stacked encoder and decoder unstacked layer by
    layer; a wrong shape is refused."""
    host = np_params(jmodels.model_defs(JCFG), 9)
    tp = from_jax_params(host, TCFG, device="cpu")
    assert len(tp["encoder"]) == 2 and len(tp["decoder"]) == 3
    n_host = sum(np.asarray(a).size for a in jax.tree.leaves(host))
    assert sum(t.numel() for t in _flat(tp).values()) == n_host
    for name in ("encoder", "decoder"):
        for i, layer in enumerate(tp[name]):
            for path, leaf in _flat(layer).items():
                node = host[name]
                for k in path.strip("/").split("/"):
                    node = node[k]
                np.testing.assert_array_equal(leaf.numpy(), node[i])
    np.testing.assert_array_equal(tp["pos_dec"].numpy(), host["pos_dec"])
    bad = jax.tree.map(lambda a: a, host)
    bad["decoder"]["cross_attn"]["w_k"] = np.zeros((3, 2, 3), np.float32)
    with pytest.raises(ValueError, match="w_k"):
        from_jax_params(bad, TCFG, device="cpu")


def test_checkpoints_cross_read_both_ways(tmp_path):
    """A params + f32 AdamW-state checkpoint of whisper written by either
    package restores in the other, leaf for leaf (the port's encoder and
    decoder lists stored stacked, the JAX layout)."""
    jp, tp = _pair(seed=6)
    ts = toptim.adamw_init(tp, toptim.AdamWConfig())
    ts["mu"] = tadamw.tree_map(lambda p: p * 0.5, tp)
    js = {"step": jnp.int32(0),
          "mu": jax.tree.map(lambda p: p * 0.5, jp),
          "nu": jax.tree.map(jnp.zeros_like, jp)}
    jtree, ttree = {"params": jp, "opt": js}, {"params": tp, "opt": ts}

    TStore(str(tmp_path / "t")).save(3, ttree, data_state={"step": 3})
    restored, meta = JStore(str(tmp_path / "t")).restore(3, _np_tree(jtree))
    assert meta["data_state"] == {"step": 3}
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(jtree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    JStore(str(tmp_path / "j")).save(4, jtree, data_state={"step": 4})
    got, meta = TStore(str(tmp_path / "j")).restore(4, ttree)
    assert meta["data_state"] == {"step": 4}
    want = _flat(ttree)
    for path, leaf in _flat(got).items():
        np.testing.assert_array_equal(leaf.numpy(), want[path].numpy(),
                                      err_msg=path)


# ------------------------------------------------------------ the CLIs ---


def test_frames_are_drawn_as_the_jax_launchers_draw_them():
    """The serve launcher's frames: normal * 0.02 under the second key of
    split(PRNGKey(seed + 1)), shape (B, n_frames, D) (uniform bits equal;
    erfinv may round differently, <= 32 ulps); the trainer's under
    PRNGKey(the batch's first token)."""
    for seed in (0, 3):
        want = np.asarray(jax.random.normal(
            jax.random.split(jax.random.PRNGKey(seed + 1))[1],
            (2, 16, 64), jnp.float32)) * 0.02
        got = tserve.stub_embeds(TCFG, 2, seed, "cpu")
        assert got.shape == (2, 16, 64)
        _close(got.numpy(), want, 1e-6)
    make = tlaunch.batch_maker(TCFG, "cpu", torch.float32)
    b = make(np.full((2, 16), 5, np.int32), np.zeros((2, 16), np.int32))
    assert b["embeds"].shape == (2, 16, 64)
    _close(b["embeds"], jax.random.normal(jax.random.PRNGKey(5),
                                          (2, 16, 64)) * 0.02, 1e-6)


@pytest.mark.parametrize("impl", ["ref", "kernel"])
def test_serve_cli_equals_a_direct_prefill_and_decode(impl, capsys):
    """``launch/serve.py --arch whisper-medium --smoke``: the printed
    greedy tokens are those of a direct prefill + decode on the same
    draws (weights from --seed, prompts under rng(seed + 1), frames from
    ``stub_embeds``), whose index counts decoder tokens alone; --paged
    refuses with the reference's error."""
    gen, n = 5, 9
    tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch",
                 "2", "--prompt-len", str(n), "--gen", str(gen), "--impl",
                 impl, "--seed", "2"])
    out = capsys.readouterr().out
    assert "[serve] decoded 4 steps" in out and "scheme=seq" in out
    assert "over 16 frames" in out and "patches" not in out
    printed = out.split("[serve] sample:")[1].strip()

    params = tnnm.init_params(tmodels.model_defs(TCFG), seed=2,
                              dtype=torch.float32, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, TCFG.vocab, (2, n)))
    frames = tserve.stub_embeds(TCFG, 2, 2, "cpu")
    kw = dict(compute_dtype=torch.float32, impl=impl)
    logits, cache = tmodels.prefill(params, TCFG, toks, embeds=frames,
                                    capacity=n + gen + 1, **kw)
    seq = [torch.argmax(logits, -1)]
    for i in range(gen - 1):
        logits, cache = tmodels.decode_step_contiguous(
            params, TCFG, seq[-1], cache, n + i, **kw)
        seq.append(torch.argmax(logits, -1))
    assert printed == str(torch.stack(seq, 1).numpy()[0][:16])
    with pytest.raises(NotImplementedError,
                       match="PagedMLAEngine requires an MLA model"):
        tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                     "--paged"])


def test_train_cli_equals_a_direct_train_step_run(tmp_path, capsys):
    """``launch/train.py --arch whisper-medium --smoke``: the loss it logs
    at step 10 and the parameters it checkpoints there are those of ten
    direct ``make_train_step`` calls on the same data, frames and
    schedule (a batch the loop re-dispatched as a straggler applied
    twice, as the loop does); a second launch resumes from that
    checkpoint and logs step 20."""
    argv = ["--arch", ARCH, "--smoke", "--batch", "4", "--seq", "32",
            "--device", "cpu", "--impl", "kernel", "--ckpt-every", "10",
            "--ckpt-dir", str(tmp_path)]
    tlaunch.main(argv + ["--steps", "10"])
    out = capsys.readouterr().out
    logged = [line.split("loss=")[1].split()[0]
              for line in out.splitlines() if line.startswith("[loop] step")]
    twice = {int(line.split("step=")[1].split()[0])
             for line in out.splitlines() if "straggler" in line}

    params = tnnm.init_params(tmodels.model_defs(TCFG), seed=0,
                              dtype=torch.float32, device="cpu")
    opt_cfg = toptim.AdamWConfig(lr=toptim.cosine(3e-4, warmup=20,
                                                   total=10))
    opt = toptim.adamw_init(params, opt_cfg)
    step = make_train_step(TCFG, opt_cfg, TrainStepConfig(
        compute_dtype=torch.float32, impl="kernel"))
    data = SyntheticLM(DataConfig(vocab=TCFG.vocab, seq_len=32,
                                  global_batch=4, seed=0))
    make = tlaunch.batch_maker(TCFG, "cpu", torch.float32)
    for s in range(10):
        batch = make(*data.next_batch())
        for _ in range(2 if s in twice else 1):
            params, opt, m = step(params, opt, batch)
    assert logged == [f"{float(m['loss']):.4g}"]
    saved, _ = TStore(str(tmp_path)).restore(10, {"params": params,
                                                 "opt": opt})
    want = _flat(params)
    for path, leaf in _flat(saved["params"]).items():
        _close(leaf, want[path], 1e-6, path)

    tlaunch.main(argv + ["--steps", "20"])
    out = capsys.readouterr().out
    assert "[loop] resumed from checkpoint step=10" in out
    assert [line for line in out.splitlines()
            if line.startswith("[loop] step step=20 ")]


# ---------------------------- K4-K6 without a mask, at whisper's lengths ---


# (Lq, Lk): cross-attention's L decoder queries over 1,500 frames (Lq off
# the 128-row and 64-query tiles, Lk 23 x 64 + 28), and more queries than
# keys, both off the tiles; head dims 64 (whisper's)
NO_MASK = [(130, 1500), (200, 100)]


def _qkvdo(Lq, Lk, seed, H=2, D=64):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f(2, Lq, H, D), f(2, Lk, H, D), f(2, Lk, H, D), f(2, Lq, H, D)


@pytest.mark.parametrize("Lq,Lk", NO_MASK)
def test_flash_plain_without_a_mask_matches_jax_gqa_attention(Lq, Lk):
    """K4's, K5's and K6's plain versions (the wrappers' CPU path) with
    ``causal=False`` at Lq != Lk, against the reference's
    ``gqa_attention(causal=False)`` and its VJP; the walks' CPU model of
    K5 / K6 (``flash_bwd_walk_ref``) against the plain versions."""
    q, k, v, do = _qkvdo(Lq, Lk, Lq + Lk)
    jout, vjp = jax.vjp(lambda q, k, v: jattn.gqa_attention(
        q, k, v, causal=False), *map(jnp.asarray, (q, k, v)))
    jdq, jdk, jdv = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (_t(a).transpose(1, 2) for a in (q, k, v, do))
    kw = dict(causal=False, window=None, q_offset=0, scale=64 ** -0.5)
    out, lse = tfa.flash_fwd_kernel(tq, tk, tv, **kw)
    _close(out.transpose(1, 2), jout, TOL, "out")
    delta = (tdo * out).sum(-1)
    dq = tfa.flash_bwd_dq_kernel(tq, tk, tv, tdo, lse, delta, **kw)
    dk, dv = tfa.flash_bwd_dkv_kernel(tq, tk, tv, tdo, lse, delta, **kw)
    for got, want, name in ((dq, jdq, "dq"), (dk, jdk, "dk"),
                            (dv, jdv, "dv")):
        _close(got.transpose(1, 2), want, TOL, name)
    walk = tfa.flash_bwd_walk_ref(tq, tk, tv, tdo, lse, delta, **kw)
    for got, want in zip(walk, (dq, dk, dv)):
        _close(got, want, TOL)


@pytest.mark.parametrize("Lq,Lk", NO_MASK + [(256, 1500), (1500, 1500)])
def test_walks_without_a_mask_cover_every_pair_once(Lq, Lk):
    """K5's key walk and K6's query walk with ``causal=False`` at
    whisper's lengths (the encoder's 1,500 x 1,500, cross-attention's
    queries over 1,500 frames): every pair lies in exactly one block the
    walk visits and does not skip; an 'interior' block lies wholly inside
    Lq and Lk, so only the key tail (28 live keys of the last 64-key
    tile) and the query tail are masked pair by pair."""
    opts = dict(causal=False, window=None, q_offset=0)
    rows = _launch.flash_dq_tc_rows(64, 64)
    cover = np.zeros((Lq, Lk), np.int64)
    for r0, k0, cls in _launch.flash_dq_walk(Lq, Lk, rows=rows, **opts):
        assert cls != "skip" or r0 >= Lq
        if r0 < Lq:
            cover[r0:r0 + 16, k0:k0 + 64] += 1
            assert (cls == "edge") == (k0 + 64 > Lk), (r0, k0)
    assert (cover == 1).all()
    cover[:] = 0
    for k0, _, kb0, qb0, cls in _launch.flash_dkv_walk(Lq, Lk, **opts):
        if cls != "skip":
            cover[qb0:qb0 + 32, kb0:kb0 + 16] += 1
        live = kb0 < Lk and qb0 < Lq
        assert (cls != "skip") == live, (kb0, qb0)
        if live:
            assert (cls == "edge") == (kb0 + 16 > Lk or qb0 + 32 > Lq)
    assert (cover == 1).all()
    k_last = (Lk - 1) // 64 * 64            # K6's last key CTA
    assert {kb0 for k0, _, kb0, _, cls in _launch.flash_dkv_walk(
        Lq, Lk, **opts) if k0 == k_last and cls != "skip"} == \
        set(range(k_last, Lk, 16))
