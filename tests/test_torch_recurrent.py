"""Parity of the port's recurrent families with the JAX package, on the
CPU: the causal conv, Mamba (Jamba's sequence mixer) and the xLSTM mixers
(mLSTM, sLSTM) alone and in their sublayers, the two configs, whole
smoke models (forward under every impl, prefill + decode, greedy
tokens), the loss and every gradient, the weight bridge, the serving and
training CLIs, and the two faults of the reference the port keeps.

Inputs come from numpy with fixed seeds: weights are drawn in the JAX
layout (``_torch_parity.np_params``) and moved into the port with
``weights.from_jax_params``.  Everything is f32, Jamba's MoE at drop-free
capacity.  Tolerances: the causal conv bit for bit (the same f32 adds in
the same order); 1e-5 abs+rel for one mixer (the Mamba scan combines in
another order than the reference's associative scan, the mLSTM sums in
another order: ~1e-7); 3e-4 / 1e-4 (abs / rel) for a prefill and a
decode step against the teacher-forced forward, as ``tests/test_models.py``
holds the JAX package; 1e-4 for whole-model logits against JAX and for
gradients.  xLSTM trains at L <= 64: at 128 positions a chunk its
gradients are not finite in either package (the last test).
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
from repro.models import blocks as jblocks
from repro.models import mamba as jmamba
from repro.models import xlstm as jxlstm
from repro.nn import layers as jnl
from repro.runtime import lm_loss as jlm_loss
import repro_torch.configs as tconfigs
import repro_torch.models as tmodels
from repro_torch.core import cache as tcache
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.models import blocks as tblocks
from repro_torch.models import mamba as tmamba
from repro_torch.models import xlstm as txlstm
from repro_torch.nn import layers as tnl
from repro_torch.optim import adamw as tadamw
from repro_torch.runtime import lm_loss, make_prefill_step, make_serve_step
from repro_torch.weights import from_jax_params

from _torch_parity import np_params, to_jax

torch.set_num_threads(2)

ARCHS = ("jamba-1.5-large-398b", "xlstm-350m")
JAMBA, XLSTM = ARCHS
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
    """(jcfg, tcfg, JAX params, port params) of ``arch``'s smoke config
    at drop-free capacity, holding the same f32 values."""
    jcfg = _drop_free(jconfigs.smoke(arch))
    tcfg = _drop_free(tconfigs.smoke(arch))
    host = np_params(jmodels.model_defs(jcfg), seed)
    return jcfg, tcfg, to_jax(host), from_jax_params(host, tcfg,
                                                     device="cpu")


@functools.lru_cache(maxsize=None)
def _mixer(arch: str, mixer: str, seed: int = 4):
    """(cfg, JAX params, port params) of one mixer of ``arch``'s smoke
    config."""
    cfg = jconfigs.smoke(arch)
    defs = {"mamba": jmamba.mamba_defs, "mlstm": jxlstm.mlstm_defs,
            "slstm": jxlstm.slstm_defs}[mixer](cfg)
    host = np_params(defs, seed)
    return cfg, to_jax(host), jax.tree.map(_t, host)


def _jax_layers(cfg, tree):
    """(descriptor, per-layer node) of a JAX-layout tree (params or
    caches) in stack order, each period's stacked leaves taken at that
    period: the counterpart of the port's ``lm.layers``."""
    prefix, period, n_periods, suffix = cfg.layer_plan()
    for i, desc in enumerate(prefix):
        yield desc, tree["prefix"][f"l{i}"]
    for p in range(n_periods):
        for i, desc in enumerate(period):
            yield desc, jax.tree.map(lambda a: np.asarray(a)[p],
                                     tree["period"][f"s{i}"])
    for i, desc in enumerate(suffix):
        yield desc, tree["suffix"][f"l{i}"]


def _first_layer(cfg) -> str:
    """The path of the first layer of ``cfg``'s stack in a port tree
    (xLSTM's smoke stack is one period long, so unrolled)."""
    return "/period/0/s0" if cfg.layer_plan()[2] else "/prefix/l0"


def _x(shape, seed=7):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ------------------------------------------------------------- configs ---


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_jax(arch):
    """FULL, SMOKE and SKIP_SHAPES field for field, the same layer plan
    (Jamba's 8-layer period: attention at offset 3, MoE every second
    layer; xLSTM's 7 mLSTM + 1 sLSTM) and the same parameter count (Jamba
    398 B at full size)."""
    assert arch in tconfigs.ARCHS
    for part in ("full", "smoke"):
        t, j = getattr(tconfigs, part)(arch), getattr(jconfigs, part)(arch)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert [[dataclasses.asdict(s) for s in p] if isinstance(p, list)
                else p for p in t.layer_plan()] == \
            [[dataclasses.asdict(s) for s in p] if isinstance(p, list)
             else p for p in j.layer_plan()]
    assert tconfigs.skip_shapes(arch) == jconfigs.skip_shapes(arch)
    n = tmodels.lm.param_count(tconfigs.full(arch))
    assert n == jmodels.lm.param_count(jconfigs.full(arch))
    if arch == JAMBA:
        assert abs(n / 398e9 - 1) < 0.1
        _, period, n_periods, _ = tconfigs.full(arch).layer_plan()
        assert (len(period), n_periods) == (8, 9)
        assert [(d.mixer, d.ffn) for d in period[:4]] == [
            ("mamba", "dense"), ("mamba", "moe"), ("mamba", "dense"),
            ("attn", "moe")]


# --------------------------------------------------------- causal conv ---


@pytest.mark.parametrize("L", [1, 3, 9])
def test_causal_conv1d_is_bit_equal_to_jax(L):
    """The sequence form (one add per tap, in x's dtype) and the step form
    (f32 products summed tap by tap with fused multiply-adds, rounded to
    x's dtype) bit for bit, in f32 and bf16, and the step's new conv
    state.  At batch 4: below batch 3 XLA's CPU dot sums the taps in
    other orders (plain adds at batch 1), so its bits depend on the
    batch there."""
    W, C = 4, 24
    host = np_params(jnl.causal_conv1d_defs(C, W), 1)
    host["b"] = _x((C,), 2)
    x = _x((4, L, C), 3)
    state = _x((4, W - 1, C), 4)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), host)
        tp = jax.tree.map(lambda a: _t(a).to(tdt), host)
        want = jnl.causal_conv1d(jp, jnp.asarray(x, jdt))
        got = tnl.causal_conv1d(tp, _t(x).to(tdt))
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))
        w_out, w_state = jnl.causal_conv1d_step(
            jp, jnp.asarray(x[:, 0], jdt), jnp.asarray(state, jdt))
        g_out, g_state = tnl.causal_conv1d_step(
            tp, _t(x[:, 0]).to(tdt), _t(state).to(tdt))
        assert g_out.dtype == tdt and g_state.shape == (4, W - 1, C)
        np.testing.assert_array_equal(g_out.float().numpy(),
                                      np.asarray(w_out, np.float32))
        np.testing.assert_array_equal(g_state.float().numpy(),
                                      np.asarray(w_state, np.float32))


# --------------------------------------------------------------- Mamba ---


@functools.lru_cache(maxsize=None)
def _jax_mamba(L: int):
    cfg, jp, _ = _mixer(JAMBA, "mamba")
    out, state = jax.jit(lambda p, x: jmamba.mamba_forward(
        p, cfg, x, return_state=True))(jp, jnp.asarray(_x((2, L, 64))))
    return np.asarray(out), jax.tree.map(np.asarray, state)


@pytest.mark.parametrize("L", [2, 12, 300, 512])
def test_mamba_forward_matches_jax(L):
    """mamba_forward on the Jamba smoke config: the output and the decode
    state (the conv state padded in front when L < width - 1; the last
    SSM state), at one chunk (2, 12, 300: c = L) and at two (512)."""
    cfg, _, tp = _mixer(JAMBA, "mamba")
    want, wstate = _jax_mamba(L)
    got, state = tmamba.mamba_forward(tp, tconfigs.smoke(JAMBA),
                                      _t(_x((2, L, 64))), return_state=True)
    _close(got, want, ONE_TOL, "out")
    np.testing.assert_array_equal(state["conv"].numpy(), wstate["conv"])
    _close(state["ssm"], wstate["ssm"], ONE_TOL, "ssm")
    assert state["ssm"].dtype == torch.float32


def test_mamba_step_matches_jax():
    """Six decode steps from the state a 12-position prefill left: each
    output and the state after the last, against the JAX package's
    mamba_step and against the forward over the 18 positions."""
    cfg, jp, tp = _mixer(JAMBA, "mamba")
    tcfg = tconfigs.smoke(JAMBA)
    x = _x((2, 18, 64), 8)
    _, jstate = jmamba.mamba_forward(jp, cfg, jnp.asarray(x[:, :12]),
                                     return_state=True)
    _, tstate = tmamba.mamba_forward(tp, tcfg, _t(x[:, :12]),
                                     return_state=True)
    full, _ = tmamba.mamba_forward(tp, tcfg, _t(x))
    jstep = jax.jit(lambda p, x, s: jmamba.mamba_step(p, cfg, x, s))
    for i in range(12, 18):
        want, jstate = jstep(jp, jnp.asarray(x[:, i]), jstate)
        got, tstate = tmamba.mamba_step(tp, tcfg, _t(x[:, i]), tstate)
        _close(got, want, ONE_TOL, f"step {i}")
        _close(got, full[:, i], ONE_TOL, f"step {i} vs forward")
    _close(tstate["ssm"], jstate["ssm"], ONE_TOL)
    np.testing.assert_array_equal(tstate["conv"].numpy(),
                                  np.asarray(jstate["conv"]))


def test_mamba_scan_slices_change_no_value(monkeypatch):
    """A scan step over slices of d_inner (as at Jamba's full width) gives
    the unsliced values, forward and backward, and so does remat: the
    scan is elementwise in d_inner, so only the summation order of the
    products around it may move: each tensor within 1e-6 of its norm."""
    _, _, tp = _mixer(JAMBA, "mamba")
    tcfg = tconfigs.smoke(JAMBA)
    x = _t(_x((2, 512, 64), 9))

    def run(cfg):
        p = tadamw.tree_map(lambda a: a.clone().requires_grad_(True), tp)
        out, state = tmamba.mamba_forward(p, cfg, x, return_state=True)
        g = torch.autograd.grad(out.square().sum(),
                                list(tadamw.tree_leaves(p)))
        return [out.detach(), state["ssm"].detach()] + list(g)

    whole = run(tcfg)
    # 2 x 256 x 8 x 4 bytes: a slice of 8 of the 128 inner channels
    monkeypatch.setattr(tmamba, "SCAN_SLICE_BYTES", 2 * 256 * 8 * 4 * 8)
    sliced = run(tcfg)
    remat = run(dataclasses.replace(tcfg, remat=True))
    for a, b, c in zip(whole, sliced, remat):
        for other in (b, c):
            assert float((other - a).norm() / a.norm()) < 1e-6


# --------------------------------------------------------------- xLSTM ---


@pytest.mark.parametrize("L", [12, 256])
def test_mlstm_forward_matches_jax(L):
    """mlstm_forward on the xLSTM smoke config: output and state (C, n),
    at one chunk (12) and at two of 128 (256)."""
    cfg, jp, tp = _mixer(XLSTM, "mlstm")
    x = _x((2, L, 64), 10)
    want, wstate = jax.jit(lambda p, x: jxlstm.mlstm_forward(
        p, cfg, x, return_state=True))(jp, jnp.asarray(x))
    got, state = txlstm.mlstm_forward(tp, tconfigs.smoke(XLSTM), _t(x),
                                      return_state=True)
    _close(got, want, ONE_TOL, "out")
    for k in ("C", "n"):
        _close(state[k], wstate[k], ONE_TOL, k)


def test_slstm_forward_matches_jax():
    cfg, jp, tp = _mixer(XLSTM, "slstm")
    x = _x((2, 40, 64), 11)
    want, wstate = jax.jit(lambda p, x: jxlstm.slstm_forward(
        p, cfg, x, return_state=True))(jp, jnp.asarray(x))
    got, state = txlstm.slstm_forward(tp, tconfigs.smoke(XLSTM), _t(x),
                                      return_state=True)
    _close(got, want, ONE_TOL, "out")
    for k in ("h", "c", "n", "m"):
        _close(state[k], wstate[k], ONE_TOL, k)


@pytest.mark.parametrize("mixer", ["mlstm", "slstm"])
def test_xlstm_steps_match_jax(mixer):
    """Five decode steps from the initial state (sLSTM's m at -1e30)
    against the JAX package's steps and the port's forward."""
    cfg, jp, tp = _mixer(XLSTM, mixer)
    tcfg = tconfigs.smoke(XLSTM)
    jmod = {"mlstm": (jxlstm.mlstm_step, jxlstm.mlstm_state_init),
            "slstm": (jxlstm.slstm_step, jxlstm.slstm_state_init)}[mixer]
    tstep, tinit, tfwd = {
        "mlstm": (txlstm.mlstm_step, txlstm.mlstm_state_init,
                  txlstm.mlstm_forward),
        "slstm": (txlstm.slstm_step, txlstm.slstm_state_init,
                  txlstm.slstm_forward)}[mixer]
    x = _x((2, 5, 64), 12)
    jstate, tstate = jmod[1](cfg, 2), tinit(tcfg, 2, "cpu")
    assert jax.tree.map(np.shape, jstate) == {
        k: tuple(v.shape) for k, v in tstate.items()}
    full, _ = tfwd(tp, tcfg, _t(x))
    jstep = jax.jit(lambda p, x, s: jmod[0](p, cfg, x, s))
    for i in range(5):
        want, jstate = jstep(jp, jnp.asarray(x[:, i]), jstate)
        got, tstate = tstep(tp, tcfg, _t(x[:, i]), tstate)
        _close(got, want, ONE_TOL, f"step {i}")
        _close(got, full[:, i], ONE_TOL, f"step {i} vs forward")
    for k in tstate:
        _close(tstate[k], jstate[k], ONE_TOL, k)


@pytest.mark.parametrize("mixer", ["mamba", "mlstm", "slstm"])
def test_recurrent_sublayers_match_jax(mixer):
    """One sublayer (mixer + its FFN) through sub_apply: sub_defs equal the
    JAX ones; 'train' and 'prefill' outputs and the prefill's state;
    'decode' from that state, its state overwritten in place; sub_cache
    shapes and dtypes as the reference's."""
    arch = JAMBA if mixer == "mamba" else XLSTM
    jcfg, tcfg, _, _ = _pair(arch)
    desc = next(d for d, _ in tmodels.lm.layers(tcfg, _pair(arch)[3])
                if d.mixer == mixer)
    defs = jblocks.sub_defs(jcfg, desc)
    assert jax.tree.map(lambda p: p.shape, defs) == jax.tree.map(
        lambda p: p.shape, tblocks.sub_defs(tcfg, desc))
    host = np_params(defs, 5)
    jp, tp = to_jax(host), jax.tree.map(_t, host)
    B, L = 2, 12
    x = _x((B, L, jcfg.d_model), 13)
    pos = np.broadcast_to(np.arange(L), (B, L))
    want = {}
    for mode in ("train", "prefill"):
        jctx = jblocks.Ctx(mode=mode, positions=jnp.asarray(pos), capacity=L)
        want[mode] = jax.jit(lambda p, x, c=jctx: jblocks.sub_apply(
            p, jcfg, desc, x, c))(jp, jnp.asarray(x))
        got = tblocks.sub_apply(tp, tcfg, desc, _t(x), tblocks.Ctx(
            mode=mode, positions=_t(pos), capacity=L, impl="chunked"))
        _close(got[0], want[mode][0], ONE_TOL, mode)
        assert (got[1] is None) == (mode == "train")
    state = got[1]
    x_t = _x((B, jcfg.d_model), 14)
    w_x, w_state, _ = jax.jit(lambda p, x, s: jblocks.sub_apply(
        p, jcfg, desc, x, jblocks.Ctx(mode="decode", positions=None,
                                      index=L, cache=s)))(
        jp, jnp.asarray(x_t), want["prefill"][1])
    ptrs = {k: v.data_ptr() for k, v in state.items()}
    g_x, g_state, _ = tblocks.sub_apply(tp, tcfg, desc, _t(x_t), tblocks.Ctx(
        mode="decode", index=L, cache=state))
    assert g_state is state and ptrs == {k: v.data_ptr()
                                         for k, v in state.items()}
    _close(g_x, w_x, ONE_TOL, "decode")
    for k in state:
        _close(state[k], w_state[k], ONE_TOL, k)
    jc = jblocks.sub_cache(jcfg, desc, 3, 9, jnp.float32)
    tc = tblocks.sub_cache(tcfg, desc, 3, 9, torch.float32, "cpu")
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in tc.items()} == \
        {k: (v.shape, f"torch.{v.dtype}") for k, v in jc.items()}
    assert not any(v.any() for k, v in tc.items() if k != "m")


# ------------------------------------------------------ whole models ---


def _tokens(cfg, B=2, L=12, seed=3):
    return np.random.default_rng(seed).integers(0, cfg.vocab,
                                                (B, L)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_forward(arch: str, L: int):
    jcfg, _, jp, _ = _pair(arch)
    logits, aux = jax.jit(lambda p, t: jmodels.forward(
        p, jcfg, t, compute_dtype=jnp.float32))(
            jp, jnp.asarray(_tokens(jcfg, L=L)))
    return np.asarray(logits), jax.tree.map(np.asarray, aux)


@pytest.mark.parametrize("impl", ["ref", "chunked", "kernel"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax(arch, impl):
    """The whole smoke model (Jamba: 16 layers in two 8-layer periods,
    two attention layers; xLSTM: 7 mLSTM + 1 sLSTM), logits and the MoE
    aux terms, under every attention impl."""
    jcfg, tcfg, _, tp = _pair(arch)
    want, waux = _jax_forward(arch, 12)
    got, aux = tmodels.forward(tp, tcfg, _t(_tokens(jcfg)).long(),
                               compute_dtype=torch.float32, impl=impl)
    assert got.shape == want.shape == (2, 12, jcfg.vocab)
    _close(got, want, MODEL_TOL)
    for k in ("balance", "z_loss", "dropped_frac"):
        assert float(aux[k]) == pytest.approx(float(waux[k]), rel=1e-5,
                                              abs=1e-6), k


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax_and_forward(arch):
    """The contiguous steps: a prefill of 12 tokens into a cache of 18
    positions (KV caches for Jamba's attention layers, states for the
    recurrent ones), then 5 greedy decode steps: each logits row against
    the JAX package's, the greedy tokens equal to its, and the last row
    against the teacher-forced forward (3e-4 / 1e-4), under 'ref',
    'chunked' and 'kernel'."""
    jcfg, tcfg, jp, tp = _pair(arch)
    toks = _tokens(jcfg)
    gen, cap = 5, 18
    jl, jc = jax.jit(lambda p, t: jmodels.prefill(
        p, jcfg, t, capacity=cap, compute_dtype=jnp.float32))(
            jp, jnp.asarray(toks))
    jstep = jax.jit(lambda p, t, c, i: jmodels.decode_step(
        p, jcfg, t, c, i, compute_dtype=jnp.float32))
    want = [np.asarray(jl)]
    seq = toks
    for i in range(gen):
        nxt = np.argmax(want[-1], -1).astype(np.int32)
        seq = np.concatenate([seq, nxt[:, None]], 1)
        jl, jc = jstep(jp, jnp.asarray(nxt), jc, 12 + i)
        want.append(np.asarray(jl))
    for impl in ("ref", "chunked", "kernel"):
        pre = make_prefill_step(tcfg, capacity=cap,
                                compute_dtype=torch.float32, impl=impl)
        step = make_serve_step(tcfg, compute_dtype=torch.float32, impl=impl)
        logits, cache = pre(tp, _t(toks).long())
        _close(logits, want[0], MODEL_TOL, f"{impl} prefill")
        for i in range(gen):
            assert np.array_equal(torch.argmax(logits, -1).numpy(),
                                  seq[:, 12 + i])
            logits, cache = step(tp, _t(seq[:, 12 + i]).long(), cache,
                                 12 + i)
            _close(logits, want[i + 1], MODEL_TOL, f"{impl} step {i}")
        full, _ = tmodels.forward(tp, tcfg, _t(seq).long(),
                                  compute_dtype=torch.float32, impl=impl)
        np.testing.assert_allclose(logits.numpy(), full[:, -1].numpy(),
                                   atol=3e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_state_has_no_capacity_axis(arch):
    """init_cache: a recurrent layer's state does not grow with the
    capacity (Jamba's attention layers keep a KV cache of it), and its
    shapes are the reference's."""
    jcfg, tcfg, _, _ = _pair(arch)
    for cap in (8, 40):
        want = jmodels.init_cache(jcfg, 2, cap, jnp.float32)
        got = tmodels.init_cache(tcfg, 2, cap, torch.float32, "cpu")
        pairs = list(zip(tmodels.lm.layers(tcfg, got),
                         _jax_layers(jcfg, want)))
        assert len(pairs) == tcfg.n_layers
        for (desc, g), (_, w) in pairs:
            assert {k: tuple(v.shape) for k, v in g.items()} == \
                {k: v.shape for k, v in w.items()}
            assert ("k" in g) == (desc.mixer == "attn")
            if "k" in g:
                assert g["k"].shape[1] == cap


@pytest.mark.parametrize("arch", ARCHS)
def test_weights_bridge_carries_every_recurrent_leaf(arch):
    """from_jax_params: every leaf lands bit for bit, each period's leaves
    unstacked (Jamba's two 8-layer periods; xLSTM's 8-layer smoke stack
    is one period, unrolled); a wrong shape is refused."""
    jcfg, tcfg, _, _ = _pair(arch)
    host = np_params(jmodels.model_defs(jcfg), 9)
    tp = from_jax_params(host, tcfg, device="cpu")
    n_host = sum(np.asarray(a).size for a in jax.tree.leaves(host))
    assert sum(t.numel() for t in _flat(tp).values()) == n_host
    pairs = list(zip(tmodels.lm.layers(tcfg, tp), _jax_layers(jcfg, host)))
    assert len(pairs) == tcfg.n_layers
    for (_, t_node), (_, j_node) in pairs:
        t_flat, j_flat = _flat(t_node), _flat(j_node)
        assert set(t_flat) == set(j_flat)
        for name, leaf in j_flat.items():
            np.testing.assert_array_equal(t_flat[name].numpy(), leaf)
    bad = jax.tree.map(lambda a: a, host)
    name = "A_log" if arch == JAMBA else "qkv"
    node = bad["period"]["s0"] if tcfg.layer_plan()[2] else \
        bad["prefix"]["l0"]
    node["attn"][name] = np.zeros((1, 2), np.float32)
    with pytest.raises(ValueError, match=name):
        from_jax_params(bad, tcfg, device="cpu")


# --------------------------------------------------- loss + gradients ---


@functools.lru_cache(maxsize=None)
def _jax_grads(arch: str, impl: str, L: int):
    jcfg, _, jp, _ = _pair(arch)
    toks = _tokens(jcfg, L=L, seed=8)
    labels = np.roll(toks, -1, 1)
    labels[:, -1] = -100
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, t, lb: jlm_loss(p, jcfg, t, lb, compute_dtype=jnp.float32,
                                  impl=impl), has_aux=True))(
        jp, jnp.asarray(toks), jnp.asarray(labels))
    return float(loss), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("arch,impl,L", [
    (JAMBA, "ref", 12), (JAMBA, "chunked", 12), (JAMBA, "kernel", 12),
    (XLSTM, "ref", 64)])
def test_loss_and_every_gradient_match_jax(arch, impl, L):
    """lm_loss and the gradient of every leaf, f32 (Jamba's MoE at
    drop-free capacity; xLSTM at 64 positions, inside one finite
    chunk)."""
    jcfg, tcfg, _, tp = _pair(arch)
    toks = _tokens(jcfg, L=L, seed=8)
    labels = np.roll(toks, -1, 1)
    labels[:, -1] = -100
    j_loss, j_grads = _jax_grads(arch, "kernel" if impl == "kernel"
                                 else impl, L)
    params = tadamw.tree_map(torch.clone, tp)
    leaves = [t.requires_grad_(True) for t in tadamw.tree_leaves(params)]
    loss, _ = lm_loss(params, tcfg, _t(toks).long(), _t(labels).long(),
                      compute_dtype=torch.float32, impl=impl)
    grads = torch.autograd.grad(loss, leaves)
    assert float(loss.detach()) == pytest.approx(j_loss, rel=1e-5)
    it = iter(grads)
    got = _flat(tadamw.tree_map(lambda _: next(it), params))
    want = _flat(from_jax_params(j_grads, tcfg, device="cpu"))
    assert set(got) == set(want)
    for path in got:
        assert torch.isfinite(got[path]).all(), path
        _close(got[path], want[path], MODEL_TOL, path)
    mixer = "A_log" if arch == JAMBA else "qkv"
    assert float(got[f"{_first_layer(tcfg)}/attn/{mixer}"].abs().max()) > 0


# -------------------------------------------------------------- CLIs ---


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_on_each_arch(arch, capsys):
    """The contiguous launcher serves both smoke models ('seq', no
    auto_dispatch line) with the same greedy sample under 'ref',
    'chunked' and 'kernel'; --paged refuses with the reference's
    error."""
    samples = set()
    for impl in ("ref", "chunked", "kernel"):
        tserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                     "--batch", "2", "--prompt-len", "9", "--gen", "4",
                     "--impl", impl])
        out = capsys.readouterr().out
        assert "[serve] decoded 3 steps" in out and "scheme=seq" in out
        assert "auto_dispatch" not in out
        samples.add(out.split("[serve] sample:")[1].strip())
    assert len(samples) == 1
    with pytest.raises(NotImplementedError,
                       match="PagedMLAEngine requires an MLA model"):
        tserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                     "--paged"])


@pytest.mark.parametrize("arch,impl", [(JAMBA, "chunked"), (XLSTM, "ref")])
def test_train_cli_on_each_arch(arch, impl, tmp_path, capsys):
    """The training launcher: the loss logged at step 20 is below step
    10's (xLSTM at 64 positions)."""
    tlaunch.main(["--arch", arch, "--smoke", "--steps", "20", "--batch",
                  "4", "--seq", "64" if arch == XLSTM else "32",
                  "--device", "cpu", "--impl", impl, "--ckpt-every", "10",
                  "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    losses = [float(line.split("loss=")[1].split()[0])
              for line in out.splitlines() if line.startswith("[loop] step")]
    assert len(losses) == 2 and losses[1] < losses[0]


# ------------------------------------------- faults of the reference ---


def test_mlstm_grads_are_not_finite_at_a_128_chunk_in_both():
    """A fault of the reference, kept in the port for parity (ROADMAP.md
    queue 3): mlstm_forward takes exp over the whole (c, c) square of a
    chunk before masking its upper triangle, so at c = 128 the upper
    entries overflow to inf and the backward multiplies them by 0.  At
    L = 128 both packages' gradients hold NaN while the forward stays
    finite; at L = 64 both are finite."""
    cfg, jp, tp = _mixer(XLSTM, "mlstm")
    tcfg = tconfigs.smoke(XLSTM)
    for L, finite in ((64, True), (128, False)):
        x = _x((1, L, 64), 15)
        jout, jg = jax.value_and_grad(lambda p: jnp.sum(jxlstm.mlstm_forward(
            p, cfg, jnp.asarray(x))[0] ** 2))(jp)
        p = tadamw.tree_map(lambda a: a.clone().requires_grad_(True), tp)
        out = txlstm.mlstm_forward(p, tcfg, _t(x))[0].square().sum()
        tg = torch.autograd.grad(out, list(tadamw.tree_leaves(p)))
        assert np.isfinite(float(jout)) and torch.isfinite(out)
        j_ok = all(np.isfinite(np.asarray(g)).all()
                   for g in jax.tree.leaves(jg))
        t_ok = all(torch.isfinite(g).all() for g in tg)
        assert j_ok == t_ok == finite, L


def test_mamba_refuses_the_lengths_the_reference_cannot_reshape():
    """A fault of the reference (ROADMAP.md queue 3): the scan splits L
    into max(1, L // 256) chunks of L // n positions and reshapes, so an
    L they do not tile (513 = 2 x 256 + 1) raises in the JAX package;
    the port raises at the same lengths instead of padding, and runs the
    lengths around it."""
    cfg, jp, tp = _mixer(JAMBA, "mamba")
    tcfg = tconfigs.smoke(JAMBA)
    x = _x((1, 513, 64), 16)
    with pytest.raises(TypeError, match="reshape"):
        jmamba.mamba_forward(jp, cfg, jnp.asarray(x))
    with pytest.raises(ValueError, match="513"):
        tmamba.mamba_forward(tp, tcfg, _t(x))
    with pytest.raises(ValueError, match="257"):        # chunks of 128
        txlstm.mlstm_forward(_mixer(XLSTM, "mlstm")[2],
                             tconfigs.smoke(XLSTM), _t(_x((1, 257, 64))))
    for L in (511, 512):
        assert tmamba.mamba_forward(tp, tcfg, _t(x[:, :L]))[0].shape[1] == L
    assert tcache.mamba_state(1, 8, 4, 4, torch.float32, "cpu")["ssm"] \
        .shape == (1, 8, 4)
