"""Parity of the port's training path with the JAX package, on the CPU:
schedules, AdamW, the loss and its gradients, the train step, the data
pipeline, checkpoints, the training loop and the CLI.

Inputs come from numpy with fixed seeds: weights are drawn in the JAX
layout (``_torch_parity.np_params``) and moved into the port with
``weights.from_jax_params``; both packages get the same token batches.
The model is the f32 DeepSeek-V2 smoke config (MLA + MoE, 4 layers) at
drop-free MoE capacity (``capacity_factor = n_experts / top_k``), so
routing does not depend on the batch split; ``impl='kernel'`` runs the
flash-attention kernels' plain versions in the port and the Pallas
kernels in interpret mode in the JAX package.

Tolerances (f32): the loss 1e-5 relative; gradients 1e-4 abs+rel (four
layers of ~1e-7 reduction-order noise, amplified through the MoE gates);
one AdamW step 3e-5 abs+rel on params (the first step moves a param by
lr * g / (|g| + 1e-8): where |g| is near 1e-8 the frameworks' ~1e-10
gradient noise changes that ratio by up to ~1 %, i.e. ~1.5e-5 at lr
1.5e-3; a wrong update moves it by up to 2 lr) and 1e-4 abs+rel on the
moments; bf16 moments one bf16 step (2^-7 relative, either side may
round the other way).
"""
import dataclasses
import functools
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models as jmodels
from repro import optim as joptim
from repro.checkpoint import CheckpointStore as JStore
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.runtime import LoopConfig as JLoopConfig
from repro.runtime import TrainLoop as JTrainLoop
from repro.runtime import TrainStepConfig as JTrainStepConfig
from repro.runtime import lm_loss as jlm_loss
from repro.runtime import make_train_step as jmake_train_step
import repro_torch.configs as tconfigs
from repro_torch import optim as toptim
from repro_torch.checkpoint import CheckpointStore as TStore
from repro_torch.data import DataConfig, DataState, SyntheticLM
from repro_torch.launch import train as tlaunch
from repro_torch.optim import adamw as tadamw
from repro_torch.runtime import (LoopConfig, SimulatedFailure, TrainLoop,
                                 TrainStepConfig, lm_loss, make_train_step)
from repro_torch.weights import from_jax_params, opt_state_from_jax

from _torch_parity import np_params, to_jax

torch.set_num_threads(2)

ARCH = "deepseek-v2-236b"
B, L = 2, 16


def _drop_free(cfg):
    return dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)


JCFG = _drop_free(jconfigs.smoke(ARCH))
TCFG = _drop_free(tconfigs.smoke(ARCH))


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol, err_msg=what)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t).astype(jnp.float32))


def _flat(tree, prefix=""):
    """{path: leaf} of a port tree (period list entries by index)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


def _np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x), tree)


def _params(seed=0):
    """(JAX params, port params) holding the same f32 values."""
    host = np_params(jmodels.model_defs(JCFG), seed)
    return to_jax(host), from_jax_params(host, TCFG, device="cpu")


def _batch(seed=1, b=B, length=L):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, JCFG.vocab, (b, length)).astype(np.int32)
    labels = rng.integers(0, JCFG.vocab, (b, length)).astype(np.int32)
    return toks, labels


def _t_batch(toks, labels):
    return {"tokens": torch.from_numpy(toks.copy()),
            "labels": torch.from_numpy(labels.copy())}


def _port_grads(params, toks, labels, **kw):
    leaves = [t.requires_grad_(True) for t in tadamw.tree_leaves(params)]
    loss, metrics = lm_loss(params, TCFG if "cfg" not in kw else kw.pop("cfg"),
                            torch.from_numpy(toks), torch.from_numpy(labels),
                            compute_dtype=torch.float32, **kw)
    grads = torch.autograd.grad(loss, leaves)
    for t in leaves:
        t.requires_grad_(False)
    it = iter(grads)
    return loss, metrics, tadamw.tree_map(lambda _: next(it), params)


# ---------------------------------------------------------------- optim ---


@pytest.mark.parametrize("name", ["constant", "linear_warmup", "cosine"])
def test_schedules_match_jax(name):
    """Identical f32 values, except that the two frameworks' f32 cos may
    round the last bit apart, which (1 + cos) near the end of the decay
    turns into a few ulps of the rate: 1e-6 relative for the cosine."""
    args = {"constant": (3e-4,), "linear_warmup": (3e-4, 7),
            "cosine": (3e-4, 5, 23)}[name]
    jfn, tfn = getattr(joptim, name)(*args), getattr(toptim, name)(*args)
    rel = 1e-6 if name == "cosine" else 0.0
    for step in range(0, 30):
        want = np.float32(jfn(jnp.int32(step)))
        got = tfn(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert abs(np.float32(got.item()) - want) <= rel * want, step


def test_global_norm_and_clip_match_jax():
    rng = np.random.default_rng(3)
    tree = {"a": rng.standard_normal((5, 7)).astype(np.float32),
            "b": [rng.standard_normal((3,)).astype(np.float32)]}
    jn = joptim.global_norm(to_jax(tree))
    tt = tadamw.tree_map(torch.from_numpy, tree)
    _close(toptim.global_norm(tt), jn, 1e-6)
    jg, jn2 = joptim.clip_by_global_norm(to_jax(tree), 0.5)
    tg, tn2 = toptim.clip_by_global_norm(tt, 0.5)
    _close(tn2, jn2, 1e-6)
    _close(tg["a"], jg["a"], 1e-6)
    _close(tg["b"][0], jg["b"][0], 1e-6)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax_and_slicing_changes_nothing(
        moment_dtype, monkeypatch):
    """Three AdamW steps on a small tree (a matrix that decays, a vector
    that does not, a 0-d leaf) match the JAX package, with the in-place
    update cut into slices of 7 elements (forcing the sliced path)."""
    monkeypatch.setattr(tadamw, "SLICE_ELEMENTS", 7)
    rng = np.random.default_rng(5)
    p = {"w": rng.standard_normal((6, 4)).astype(np.float32),
         "s": rng.standard_normal((9,)).astype(np.float32),
         "z": np.float32(0.5)}
    cfgs = (joptim.AdamWConfig(lr=joptim.cosine(1e-2, 2, 10),
                               moment_dtype=getattr(jnp, moment_dtype),
                               grad_clip=0.7),
            toptim.AdamWConfig(lr=toptim.cosine(1e-2, 2, 10),
                               moment_dtype=getattr(torch, moment_dtype),
                               grad_clip=0.7))
    jp, js = to_jax(p), joptim.adamw_init(to_jax(p), cfgs[0])
    tp = tadamw.tree_map(lambda a: torch.tensor(a), p)
    ts = toptim.adamw_init(tp, cfgs[1])
    tol = 1e-6 if moment_dtype == "float32" else 2 ** -8
    for i in range(3):
        g = {k: rng.standard_normal(np.shape(v)).astype(np.float32)
             for k, v in p.items()}
        jp, js, jm = joptim.adamw_update(cfgs[0], jp, to_jax(g), js)
        tp, ts, tm = toptim.adamw_update(
            cfgs[1], tp, tadamw.tree_map(lambda a: torch.tensor(a), g), ts)
        assert int(ts["step"]) == int(js["step"]) == i + 1
        _close(tm["grad_norm"], jm["grad_norm"], 1e-6)
        _close(tm["lr"], jm["lr"], 1e-7)
        for k in p:
            _close(tp[k], jp[k], 1e-6, k)
            _close(_np(ts["mu"][k]), _np(js["mu"][k]), tol, k)
            _close(_np(ts["nu"][k]), _np(js["nu"][k]), tol, k)
            assert ts["mu"][k].dtype == getattr(torch, moment_dtype)


# ------------------------------------------------------ loss + gradient ---


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(impl: str, loss_chunk: int = 0):
    jp, _ = _params()
    toks, labels = _batch()
    fn = functools.partial(jlm_loss, cfg=JCFG, compute_dtype=jnp.float32,
                           impl=impl, loss_chunk=loss_chunk)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, t, lb: fn(p, tokens=t, labels=lb), has_aux=True))(
            jp, jnp.asarray(toks), jnp.asarray(labels))
    return float(loss), _np_tree(metrics), _np_tree(grads)


@pytest.mark.parametrize("impl", ["ref", "kernel"])
def test_lm_loss_and_every_gradient_match_jax(impl):
    """The loss, its aux terms and the gradient of every leaf — the
    router's included, which the loss reaches through the gate weights
    and the balance / z-loss terms — match jax.value_and_grad."""
    j_loss, j_metrics, j_grads = _jax_loss_and_grads(impl)
    _, tp = _params()
    loss, metrics, grads = _port_grads(tp, *_batch(), impl=impl)
    assert float(loss) == pytest.approx(j_loss, rel=1e-5)
    for k in ("ce", "balance", "z_loss", "dropped_frac"):
        assert float(metrics[k]) == pytest.approx(float(j_metrics[k]),
                                                  rel=1e-5, abs=1e-7), k
    want = _flat(from_jax_params(j_grads, TCFG, device="cpu"))
    got = _flat(grads)
    assert set(got) == set(want)
    for path in got:
        _close(got[path], want[path], 1e-4, path)
    router = [p for p in got if p.endswith("ffn/router")]
    assert router and all(float(got[p].abs().max()) > 0 for p in router)


def test_router_gradient_includes_the_aux_terms():
    """With the balance and z-loss terms weighted up, the router gradient
    changes (they reach it), and still matches JAX."""
    _, tp = _params()
    toks, labels = _batch()
    cfg = dataclasses.replace(TCFG, router_aux_coef=1.0)
    jcfg = dataclasses.replace(JCFG, router_aux_coef=1.0)
    _, _, g_aux = _port_grads(tp, toks, labels, impl="ref", cfg=cfg)
    _, _, g_plain = _port_grads(tp, toks, labels, impl="ref")
    path = "/prefix/l1/ffn/router" if "l1" in tp["prefix"] \
        else "/period/0/s0/ffn/router"
    a, b = _flat(g_aux)[path], _flat(g_plain)[path]
    assert float((a - b).abs().max()) > 1e-6
    jp, _ = _params()
    jg = jax.grad(lambda p: jlm_loss(p, jcfg, jnp.asarray(toks),
                                     jnp.asarray(labels),
                                     compute_dtype=jnp.float32)[0])(jp)
    _close(a, _flat(from_jax_params(_np_tree(jg), TCFG,
                                    device="cpu"))[path], 1e-4)


@pytest.mark.parametrize("impl", ["ref", "kernel"])
def test_lm_loss_and_every_gradient_match_jax_with_token_drops(impl):
    """At the config's own MoE capacity factor (1.25, as full-width
    training runs it) the batch overflows some experts and drops tokens;
    the loss and every leaf's gradient through the capacity and drop path
    still match jax.value_and_grad.  Both packages see the whole batch
    (no microbatches), so they make the same drop decisions."""
    jcfg, tcfg = jconfigs.smoke(ARCH), tconfigs.smoke(ARCH)
    assert tcfg.capacity_factor == jcfg.capacity_factor == 1.25
    jp, tp = _params()
    toks, labels = _batch()
    (j_loss, j_metrics), j_grads = jax.jit(jax.value_and_grad(
        lambda p, t, lb: jlm_loss(p, jcfg, t, lb, compute_dtype=jnp.float32,
                                  impl=impl), has_aux=True))(
            jp, jnp.asarray(toks), jnp.asarray(labels))
    loss, metrics, grads = _port_grads(tp, toks, labels, impl=impl, cfg=tcfg)
    assert float(metrics["dropped_frac"]) > 0
    assert float(loss) == pytest.approx(float(j_loss), rel=1e-5)
    for k in ("ce", "balance", "z_loss", "dropped_frac"):
        assert float(metrics[k]) == pytest.approx(float(j_metrics[k]),
                                                  rel=1e-5, abs=1e-7), k
    want = _flat(from_jax_params(_np_tree(j_grads), tcfg, device="cpu"))
    got = _flat(grads)
    assert set(got) == set(want)
    for path in got:
        _close(got[path], want[path], 1e-4, path)


def test_loss_chunk_matches_dense_and_jax():
    """Vocab-chunked CE (chunk 6 over 16 positions: padded last chunk)
    gives the dense loss and gradients, and JAX's chunked values."""
    _, tp = _params()
    toks, labels = _batch()
    labels[0, 3] = -100           # a masked position
    dense = _port_grads(tp, toks, labels, impl="ref")
    chunked = _port_grads(tp, toks, labels, impl="ref", loss_chunk=6)
    assert float(chunked[0]) == pytest.approx(float(dense[0]), rel=1e-6)
    for path, g in _flat(chunked[2]).items():
        _close(g, _flat(dense[2])[path], 1e-5, path)
    jp, _ = _params()
    j_loss = jlm_loss(jp, JCFG, jnp.asarray(toks), jnp.asarray(labels),
                      compute_dtype=jnp.float32, loss_chunk=6)[0]
    assert float(chunked[0]) == pytest.approx(float(j_loss), rel=1e-5)


@pytest.mark.parametrize("scheme", ["rc", "ru", "auto"])
def test_training_rejects_decode_schemes(scheme):
    """Training runs MLA in MHA mode; a decode scheme is refused, not
    silently ignored."""
    _, tp = _params()
    toks, labels = _batch()
    with pytest.raises(ValueError, match="scheme"):
        lm_loss(tp, TCFG, torch.from_numpy(toks), torch.from_numpy(labels),
                compute_dtype=torch.float32, scheme=scheme)


def test_remat_on_matches_off():
    """Under cfg.remat each period layer recomputes its forward in the
    backward pass (torch.utils.checkpoint); loss and gradients do not
    change, for the kernel impl too."""
    _, tp = _params()
    toks, labels = _batch()
    cfg_on = dataclasses.replace(TCFG, remat=True)
    assert cfg_on.layer_plan()[2] > 1        # there are periods to remat
    off = _port_grads(tp, toks, labels, impl="kernel")
    on = _port_grads(tp, toks, labels, impl="kernel", cfg=cfg_on)
    assert float(on[0]) == float(off[0])
    for path, g in _flat(on[2]).items():
        _close(g, _flat(off[2])[path], 1e-6, path)


# ---------------------------------------------------------- train step ---


@pytest.mark.parametrize("impl", ["ref", "kernel"])
def test_train_step_matches_jax(impl):
    """One full step (loss, grads, clip, AdamW with a cosine schedule):
    params, mu, nu, grad_norm and lr match the JAX step."""
    lr = (3e-3, 2, 10)
    jp, tp = _params()
    toks, labels = _batch()
    jopt = joptim.AdamWConfig(lr=joptim.cosine(*lr))
    topt = toptim.AdamWConfig(lr=toptim.cosine(*lr))
    jstep, _ = jmake_train_step(JCFG, None, jopt, JTrainStepConfig(
        compute_dtype=jnp.float32, impl=impl))
    jp, js, jm = jstep(jp, joptim.adamw_init(jp, jopt),
                       {"tokens": jnp.asarray(toks),
                        "labels": jnp.asarray(labels)})
    tstep = make_train_step(TCFG, topt, TrainStepConfig(
        compute_dtype=torch.float32, impl=impl))
    tp, ts, tm = tstep(tp, toptim.adamw_init(tp, topt),
                       _t_batch(toks, labels))
    for k in ("loss", "ce", "grad_norm", "lr"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5), k
    assert int(ts["step"]) == int(js["step"]) == 1
    want = opt_state_from_jax(_np_tree(js), TCFG, device="cpu")
    for path, got in _flat(tp).items():
        _close(got, _flat(from_jax_params(_np_tree(jp), TCFG,
                                          device="cpu"))[path], 3e-5, path)
    for key in ("mu", "nu"):
        for path, got in _flat(ts[key]).items():
            _close(got, _flat(want[key])[path], 1e-4, f"{key}{path}")


def test_dropped_frac_trajectory_matches_jax_at_the_full_expert_ratio():
    """Five training steps of both packages from the same weights and
    batches on the smoke config given the full config's 160 experts, top
    6, at its capacity 1.25, in f32 (the full-width run's schedule,
    cosine(3e-4, 20, 100)): loss and ``dropped_frac`` step by step.
    Tolerances: loss 1e-4 relative (five steps of f32 noise through
    AdamW); ``dropped_frac`` (the MoE layers' fractions summed) one
    routed slot (1 / (tokens x top_k)): a near tie of two experts' gates
    may route one assignment apart."""
    jcfg = dataclasses.replace(jconfigs.smoke(ARCH), n_experts=160, top_k=6)
    tcfg = dataclasses.replace(tconfigs.smoke(ARCH), n_experts=160, top_k=6)
    assert tcfg.capacity_factor == jcfg.capacity_factor == 1.25
    host = np_params(jmodels.model_defs(jcfg), 3)
    jp, tp = to_jax(host), from_jax_params(host, tcfg, device="cpu")
    lr = (3e-4, 20, 100)
    jopt = joptim.AdamWConfig(lr=joptim.cosine(*lr))
    topt = toptim.AdamWConfig(lr=toptim.cosine(*lr))
    jstep, _ = jmake_train_step(jcfg, None, jopt, JTrainStepConfig(
        compute_dtype=jnp.float32))
    tstep = make_train_step(tcfg, topt, TrainStepConfig(
        compute_dtype=torch.float32))
    js, ts = joptim.adamw_init(jp, jopt), toptim.adamw_init(tp, topt)
    data = SyntheticLM(DataConfig(vocab=tcfg.vocab, seq_len=32,
                                  global_batch=8, seed=0))
    one_slot = 1.0 / (8 * 32 * tcfg.top_k)
    traj = []
    for _ in range(5):
        toks, labels = data.next_batch()
        jp, js, jm = jstep(jp, js, {"tokens": jnp.asarray(toks),
                                    "labels": jnp.asarray(labels)})
        tp, ts, tm = tstep(tp, ts, _t_batch(toks, labels))
        traj.append((float(jm["loss"]), float(tm["loss"]),
                     float(jm["dropped_frac"]), float(tm["dropped_frac"])))
    for i, (jl, tl, jd, td) in enumerate(traj):
        assert tl == pytest.approx(jl, rel=1e-4), (i, traj)
        assert abs(td - jd) <= one_slot + 1e-7, (i, traj)
    assert all(d > 0 for _, _, d, _ in traj)


def test_train_step_bf16_moments_match_jax():
    jp, tp = _params()
    toks, labels = _batch()
    jopt = joptim.AdamWConfig(lr=1e-3, moment_dtype=jnp.bfloat16)
    topt = toptim.AdamWConfig(lr=1e-3, moment_dtype=torch.bfloat16)
    jstep, _ = jmake_train_step(JCFG, None, jopt, JTrainStepConfig(
        compute_dtype=jnp.float32))
    jp, js, _ = jstep(jp, joptim.adamw_init(jp, jopt),
                      {"tokens": jnp.asarray(toks),
                       "labels": jnp.asarray(labels)})
    tstep = make_train_step(TCFG, topt, TrainStepConfig(
        compute_dtype=torch.float32))
    tp, ts, _ = tstep(tp, toptim.adamw_init(tp, topt), _t_batch(toks, labels))
    for key in ("mu", "nu"):
        want = _flat(from_jax_params(_np_tree(
            jax.tree.map(lambda x: x.astype(jnp.float32), js[key])), TCFG,
            device="cpu"))
        for path, got in _flat(ts[key]).items():
            assert got.dtype == torch.bfloat16
            _close(got.float(), want[path], 2 ** -7, f"{key}{path}")


def test_microbatches_match_full_batch():
    """Two microbatches of 2 rows == one batch of 4 (mean of means with
    equal token counts; drop-free routing does not see the split).  The
    MoE balance term is a product of two batch means, not a mean over
    tokens, so it is weighted 0 here (in both packages it differs between
    the split and the whole batch)."""
    cfg = dataclasses.replace(TCFG, router_aux_coef=0.0)
    toks, labels = _batch(b=4)
    opt = toptim.AdamWConfig(lr=1e-3)
    results = []
    for mb in (1, 2):
        _, tp = _params()
        step = make_train_step(cfg, opt, TrainStepConfig(
            compute_dtype=torch.float32, microbatches=mb))
        results.append(step(tp, toptim.adamw_init(tp, opt),
                            _t_batch(toks, labels)))
    (p1, _, m1), (p2, _, m2) = results
    assert float(m2["ce"]) == pytest.approx(float(m1["ce"]), rel=1e-5)
    assert float(m2["grad_norm"]) == pytest.approx(float(m1["grad_norm"]),
                                                   rel=1e-4)
    for path, a in _flat(p1).items():
        _close(_flat(p2)[path], a, 1e-5, path)


# ---------------------------------------------------------------- data ---


def test_synthetic_lm_is_deterministic_and_restorable():
    cfg = DataConfig(vocab=256, seq_len=32, global_batch=4, seed=3)
    a, b = SyntheticLM(cfg), SyntheticLM(cfg)
    for _ in range(3):
        ta, la = a.next_batch()
        tb, lb = b.next_batch()
        np.testing.assert_array_equal(ta, tb)
        np.testing.assert_array_equal(ta[:, 1:], la[:, :-1])
    assert ta.shape == (4, 32) and ta.dtype == np.int32
    assert 0 <= ta.min() and ta.max() < 256
    state = a.state_dict()
    want = a.next_batch()
    c = SyntheticLM(cfg)
    c.load_state_dict(state)
    for x, y in zip(c.next_batch(), want):
        np.testing.assert_array_equal(x, y)
    # the global batch is independent of the host count
    two = SyntheticLM(dataclasses.replace(cfg, n_hosts=2, host_id=1))
    np.testing.assert_array_equal(two.peek_global(5), a.peek_global(5))
    # the reference's mixture: ~75 % of tokens from the first 32 ids
    big = SyntheticLM(DataConfig(vocab=1000, seq_len=2000, global_batch=4))
    narrow = float(np.mean(big.next_batch()[0] < 32))
    assert 0.74 < narrow < 0.80
    assert DataState(5).step == 5


# --------------------------------------------------------- checkpoints ---


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoints_cross_read_both_ways(tmp_path, dtype):
    """A params + f32 AdamW-state checkpoint written by either package
    restores in the other, leaf for leaf (the port's period list is
    stored stacked, the JAX layout).  bf16 leaves go both ways bit for
    bit: both packages store them as 2-byte voids."""
    jp, tp = _params()
    if dtype == "bfloat16":
        jp = jax.tree.map(lambda p: p.astype(jnp.bfloat16), jp)
        tp = tadamw.tree_map(lambda p: p.to(torch.bfloat16), tp)
    opt = toptim.AdamWConfig()
    ts = toptim.adamw_init(tp, opt)      # f32 moments
    ts["mu"] = tadamw.tree_map(lambda p: p.float() * 0.5, tp)
    js = {"step": jnp.int32(0),
          "mu": jax.tree.map(lambda p: p.astype(jnp.float32) * 0.5, jp),
          "nu": jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), jp)}
    jtree = {"params": jp, "opt": js}
    ttree = {"params": tp, "opt": ts}

    TStore(str(tmp_path / "t")).save(3, ttree, data_state={"step": 3})
    restored, meta = JStore(str(tmp_path / "t")).restore(
        3, jax.tree.map(np.asarray, jtree))
    assert meta["step"] == 3 and meta["data_state"] == {"step": 3}
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(jtree)):
        b = np.asarray(b)
        if b.dtype == jnp.bfloat16:               # bit for bit
            a, b = np.asarray(a).view(np.uint16), b.view(np.uint16)
        np.testing.assert_array_equal(np.asarray(a), b)

    JStore(str(tmp_path / "j")).save(4, jtree, data_state={"step": 4})
    store = TStore(str(tmp_path / "j"))
    assert store.latest_step() == 4
    got, meta = store.restore(4, ttree)
    assert meta["data_state"] == {"step": 4}
    for path, leaf in _flat(got).items():
        want = _flat(ttree)[path]
        assert leaf.dtype == want.dtype, path
        if leaf.dtype == torch.bfloat16:          # bit for bit
            leaf, want = leaf.view(torch.int16), want.view(torch.int16)
        np.testing.assert_array_equal(leaf.numpy(), want.numpy(),
                                      err_msg=path)


def test_checkpoint_bf16_leaves_round_trip_as_uint16(tmp_path):
    """A checkpoint in the port's older form (bf16 leaves stored as uint16
    bit patterns and listed under ``bf16`` in meta.json) restores bit for
    bit."""
    tree = {"w": torch.randn(3, 5).to(torch.bfloat16),
            "layers": [{"b": torch.randn(4).to(torch.bfloat16)},
                       {"b": torch.randn(4).to(torch.bfloat16)}],
            "bias": torch.randn(7).to(torch.bfloat16)}

    def u16(t):
        return t.view(torch.int16).numpy().view(np.uint16)

    d = tmp_path / "step_00000005"
    os.makedirs(d)
    np.savez(d / "arrays.npz", w=u16(tree["w"]), bias=u16(tree["bias"]),
             layers__b=np.stack([u16(t["b"]) for t in tree["layers"]]))
    with open(d / "meta.json", "w") as f:
        json.dump({"step": 5, "data_state": {}, "meta": {},
                   "bf16": ["/bias", "/layers/b", "/w"], "done": True}, f)
    got, meta = TStore(str(tmp_path)).restore(5, tree)
    assert meta["step"] == 5
    for k in ("w", "bias"):
        assert got[k].dtype == torch.bfloat16 and torch.equal(got[k],
                                                              tree[k])
    for g, t in zip(got["layers"], tree["layers"]):
        assert torch.equal(g["b"], t["b"])


def test_checkpoint_bf16_leaves_round_trip_as_v2(tmp_path):
    tree = {"w": torch.randn(3, 5).to(torch.bfloat16),
            "layers": [{"b": torch.randn(4).to(torch.bfloat16)},
                       {"b": torch.randn(4).to(torch.bfloat16)}],
            "step": torch.tensor(7, dtype=torch.int32)}
    store = TStore(str(tmp_path), keep=2)
    store.save(1, tree)
    with open(tmp_path / "step_00000001" / "meta.json") as f:
        meta = json.load(f)
    assert meta["done"] and sorted(meta["bf16"]) == ["/layers/b", "/w"]
    with np.load(tmp_path / "step_00000001" / "arrays.npz") as z:
        # the JAX package's own storage of a bf16 leaf (2-byte voids)
        assert z["w"].dtype == np.dtype("V2") \
            and z["layers__b"].shape == (2, 4)
    got, _ = store.restore(1, tree)
    assert torch.equal(got["w"], tree["w"]) and got["w"].dtype == \
        torch.bfloat16
    assert torch.equal(got["layers"][1]["b"], tree["layers"][1]["b"])
    assert int(got["step"]) == 7
    for s in (2, 3):              # keep-2 garbage collection
        store.save(s, tree, blocking=False)
    store.wait()
    assert store.steps() == [2, 3]
    os.makedirs(tmp_path / "step_00000009")      # no meta: a partial save
    assert store.latest_step() == 3


# ---------------------------------------------------------------- loop ---


def _fresh(opt):
    _, tp = _params(seed=2)
    return tp, toptim.adamw_init(tp, opt)


def _data():
    return SyntheticLM(DataConfig(vocab=TCFG.vocab, seq_len=16,
                                  global_batch=4))


def test_loss_decreases():
    """The port's mirror of the JAX package's loss-decreases test, on the
    MLA smoke config."""
    opt = toptim.AdamWConfig(lr=3e-3)
    step = make_train_step(TCFG, opt, TrainStepConfig(
        compute_dtype=torch.float32))
    p, o = _fresh(opt)
    d = _data()
    losses = []
    for _ in range(25):
        p, o, m = step(p, o, _t_batch(*d.next_batch()))
        losses.append(float(m["loss"]))
    assert sum(losses[-5:]) / 5 < sum(losses[:5]) / 5 - 0.05


def test_resume_after_failure_is_bitwise_identical(tmp_path):
    """Kill the loop at step 4, relaunch from scratch: it resumes from the
    step-4 checkpoint and ends bitwise equal to an uninterrupted run."""
    opt = toptim.AdamWConfig(lr=1e-3)
    step = make_train_step(TCFG, opt, TrainStepConfig(
        compute_dtype=torch.float32))
    kw = dict(total_steps=6, ckpt_every=2, log_every=0, async_save=False)
    la = TrainLoop(LoopConfig(ckpt_dir=str(tmp_path / "a"), **kw), step,
                   *_fresh(opt), _data(), log=lambda *_: None)
    la.run()
    lb = TrainLoop(LoopConfig(ckpt_dir=str(tmp_path / "b"), fail_at_step=4,
                              **kw), step, *_fresh(opt), _data(),
                   log=lambda *_: None)
    with pytest.raises(SimulatedFailure):
        lb.run()
    lb2 = TrainLoop(LoopConfig(ckpt_dir=str(tmp_path / "b"), **kw), step,
                    *_fresh(opt), _data(), log=lambda *_: None)
    assert lb2.step == 4 and lb2.data.state.step == 4
    lb2.run()
    for path, a in _flat({"p": la.params, "o": la.opt_state}).items():
        b = _flat({"p": lb2.params, "o": lb2.opt_state})[path]
        assert torch.equal(a, b), path


def test_async_save_is_not_torn_by_in_place_steps(tmp_path):
    """The in-place optimizer overwrites params while an async save is
    writing: the checkpoint must hold the values at save time."""
    opt = toptim.AdamWConfig(lr=1e-2)
    step = make_train_step(TCFG, opt, TrainStepConfig(
        compute_dtype=torch.float32))
    loop = TrainLoop(LoopConfig(total_steps=3, ckpt_every=1, log_every=0,
                                async_save=True, keep=5,
                                ckpt_dir=str(tmp_path)),
                     step, *_fresh(opt), _data(), log=lambda *_: None)
    loop.run()
    store = TStore(str(tmp_path))
    got, _ = store.restore(3, {"params": loop.params})
    first, _ = store.restore(1, {"params": loop.params})
    for path, a in _flat(got).items():
        assert torch.equal(a, _flat({"params": loop.params})[path])
    assert any(not torch.equal(a, _flat(got)[p])
               for p, a in _flat(first).items())


def _straggler_once(calls, n):
    calls["n"] += 1
    if calls["n"] == n:
        time.sleep(0.3)


def test_straggler_redispatch_applies_the_batch_twice_in_both(tmp_path):
    """The reference's re-dispatch runs the step again on the params the
    slow step already returned, so the straggling batch is applied twice
    (a fault of the reference, ported as is; ROADMAP.md queue 3): after
    N steps with S straggler events, a step that adds 1 has added N + S,
    in both packages."""
    kw = dict(total_steps=14, ckpt_every=100, log_every=0,
              straggler_factor=5.0, straggler_warmup=8)
    jcalls = {"n": 0}

    def jstep(params, opt, batch):
        _straggler_once(jcalls, 12)
        return {"w": params["w"] + 1.0}, opt, {"loss": jnp.float32(1.0)}

    jloop = JTrainLoop(JLoopConfig(ckpt_dir=str(tmp_path / "j"), **kw),
                       jstep, {"w": jnp.zeros(())}, {"step": jnp.int32(0)},
                       JSyntheticLM(JDataConfig(vocab=16, seq_len=4,
                                                global_batch=2)),
                       log=lambda *_: None)
    jloop.run()
    tcalls = {"n": 0}

    def tstep(params, opt, batch):
        _straggler_once(tcalls, 12)
        params["w"].add_(1.0)
        return params, opt, {"loss": torch.tensor(1.0)}

    tloop = TrainLoop(LoopConfig(ckpt_dir=str(tmp_path / "t"), **kw),
                      tstep, {"w": torch.zeros(())},
                      {"step": torch.tensor(0, dtype=torch.int32)},
                      SyntheticLM(DataConfig(vocab=16, seq_len=4,
                                             global_batch=2)),
                      log=lambda *_: None)
    tloop.run()
    for loop, calls, w in ((jloop, jcalls, float(jloop.params["w"])),
                           (tloop, tcalls, float(tloop.params["w"]))):
        assert len(loop.straggler_events) >= 1
        assert calls["n"] == 14 + len(loop.straggler_events)
        assert w == 14 + len(loop.straggler_events)     # applied twice


def _masked(line):
    """A loop line with its measured times (``ms``, ``time_s``,
    ``deadline_s``) blanked: text lines field by field, JSON lines by
    key."""
    if line.startswith("{"):
        rec = json.loads(line)
        for k in ("ms", "time_s", "deadline_s"):
            rec.pop(k, None)
        return rec
    return " ".join(f.split("=")[0] + "=*"
                    if f.split("=")[0] in ("ms", "time_s", "deadline_s")
                    else f for f in line.split())


def _both_loops(tmp_path, tag, jlog, tlog, total=6):
    """Run the JAX and the port's ``TrainLoop`` on a step that adds 1 to
    ``w`` and reports ``w / 3`` as the loss (log every 2 steps, a
    checkpoint every 3), the given loggers each."""
    kw = dict(total_steps=total, ckpt_every=3, log_every=2,
              async_save=False, straggler_warmup=10_000)

    def jstep(params, opt, batch):
        w = params["w"] + 1.0
        return {"w": w}, opt, {"loss": w / 3.0}

    def tstep(params, opt, batch):
        params["w"].add_(1.0)
        return params, opt, {"loss": params["w"] / 3.0}

    jloop = JTrainLoop(JLoopConfig(ckpt_dir=str(tmp_path / f"j{tag}"), **kw),
                       jstep, {"w": jnp.zeros(())}, {"step": jnp.int32(0)},
                       JSyntheticLM(JDataConfig(vocab=16, seq_len=4,
                                                global_batch=2)), log=jlog)
    jloop.run()
    tloop = TrainLoop(LoopConfig(ckpt_dir=str(tmp_path / f"t{tag}"), **kw),
                      tstep, {"w": torch.zeros(())},
                      {"step": torch.tensor(0, dtype=torch.int32)},
                      SyntheticLM(DataConfig(vocab=16, seq_len=4,
                                             global_batch=2)), log=tlog)
    tloop.run()


def test_train_loop_logs_the_reference_records(tmp_path, capsys):
    """``TrainLoop`` writes the reference's records through
    ``as_logger(log, "loop")``: with the same bare sink both loops give
    the same lines (``ms`` masked), a resumed loop its ``resumed from
    checkpoint`` record, a JSON ``StructLogger`` the same JSON records
    and honours its level, and ``log=None`` prints nothing."""
    from repro.obs import StructLogger as JStructLogger
    from repro_torch.obs import StructLogger

    jlines, tlines = [], []
    _both_loops(tmp_path, "a", jlines.append, tlines.append, total=3)
    _both_loops(tmp_path, "a", jlines.append, tlines.append)
    assert jlines[0] == "[loop] step step=2 loss=0.6667 ms=" + \
        jlines[0].split("ms=")[1]
    assert "[loop] resumed from checkpoint step=3" in tlines
    assert [_masked(x) for x in tlines] == [_masked(x) for x in jlines]
    assert len(tlines) == 4

    jjson, tjson = [], []
    _both_loops(tmp_path, "b",
                JStructLogger("loop", sink=jjson.append, json_mode=True),
                StructLogger("loop", sink=tjson.append, json_mode=True))
    assert [_masked(x) for x in tjson] == [_masked(x) for x in jjson]
    assert _masked(tjson[0]) == {"logger": "loop", "level": "info",
                                 "msg": "step", "step": 2,
                                 "loss": pytest.approx(2 / 3)}
    assert len(tjson) == 3

    quiet = []
    _both_loops(tmp_path, "c",
                JStructLogger("loop", sink=quiet.append, level="warning"),
                StructLogger("loop", sink=quiet.append, level="warning"))
    capsys.readouterr()
    _both_loops(tmp_path, "d", None, None)
    assert quiet == [] and capsys.readouterr().out == ""


def test_train_cli_runs_on_cpu_and_loss_falls(tmp_path, capsys):
    """``python -m repro_torch.launch.train --smoke --steps 20 --device
    cpu``: the loss logged at step 20 is below step 10's."""
    tlaunch.main(["--arch", ARCH, "--smoke", "--steps", "20", "--batch", "4",
                  "--seq", "32", "--device", "cpu", "--ckpt-every", "10",
                  "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    losses = [float(line.split("loss=")[1].split()[0])
              for line in out.splitlines() if line.startswith("[loop] step")]
    assert len(losses) == 2 and losses[1] < losses[0]
    assert "[train] done at step 20" in out
    assert TStore(str(tmp_path)).steps() == [10, 20]
