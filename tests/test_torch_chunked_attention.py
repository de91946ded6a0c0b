"""Parity of the port's memory-bounded attention
(``repro_torch.core.chunked_attention``) with the JAX package's, on the
CPU: the q-block scan and the block-pair walk, forward and the gradients
of their recompute-from-lse backwards, over causal and windowed masks,
query offsets, GQA, ragged lengths, rows that see no key and non-default
block sizes; and the ``'chunked'`` impl in whole smoke models (MLA with
its softmax scale, GQA with windows).

Inputs come from numpy with fixed seeds.  Tolerances: 1e-5 abs+rel in
f32 (the same products and exps summed in another order, ~1e-7); bf16
2e-2 (both sides round the probabilities and the output to bf16, and an
element may land one bf16 step apart); 1e-4 for whole-model logits.
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
from repro.core import chunked_attention as jca
from repro.runtime import lm_loss as jlm_loss
import repro_torch.configs as tconfigs
import repro_torch.models as tmodels
from repro_torch.core import chunked_attention as tca
from repro_torch.optim import adamw as tadamw
from repro_torch.runtime import lm_loss
from repro_torch.weights import from_jax_params

from _torch_parity import np_params, to_jax

torch.set_num_threads(2)

TOL = 1e-5

# (B, Lq, Lk, H, Hkv, Dqk, Dv, causal, window, q_offset, scale, block_q,
#  block_k)
CASES = {
    "causal-ragged": (2, 40, 40, 4, 4, 16, 16, True, None, 0, None, 16, 16),
    "window-gqa": (1, 37, 37, 6, 2, 16, 16, True, 9, 0, None, 8, 16),
    "q-offset": (2, 10, 30, 4, 2, 8, 8, True, None, 20, None, 4, 8),
    "cross-mqa": (2, 13, 29, 4, 1, 16, 16, False, None, 0, None, 256, 256),
    "window-offset": (1, 12, 24, 2, 1, 8, 8, True, 6, 5, None, 8, 8),
    "mla-dims": (2, 33, 33, 4, 4, 24, 16, True, None, 0, 0.3, 32, 16),
    # queries 18..23 over 20 keys, window 3: queries 22 and 23 see none
    "no-keys": (1, 6, 20, 2, 2, 8, 8, True, 3, 18, None, 4, 8),
}
FNS = ("chunked_attention", "chunked_attention_pairs")


def _inputs(case, seed=0):
    B, Lq, Lk, H, Hkv, Dqk, Dv = case[:7]
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f(B, Lq, H, Dqk), f(B, Lk, Hkv, Dqk), f(B, Lk, Hkv, Dv), \
        f(B, Lq, H, Dv)


def _kwargs(name, case):
    causal, window, q_offset, scale, bq, bk = case[7:]
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              softmax_scale=scale, block_q=bq)
    if name == "chunked_attention_pairs":
        kw["block_k"] = bk
    return kw


@functools.lru_cache(maxsize=None)
def _jax_out_and_grads(name, case_id, dtype_name):
    case = CASES[case_id]
    kw = _kwargs(name, case)
    fn = getattr(jca, name)
    dt = jnp.dtype(dtype_name)
    q, k, v, do = (jnp.asarray(a, dt) for a in _inputs(case))
    call = jax.jit(lambda q, k, v: fn(q, k, v, kw["causal"], kw["window"],
                                      kw["q_offset"], kw["softmax_scale"],
                                      *([kw["block_q"], kw["block_k"]]
                                        if "block_k" in kw
                                        else [kw["block_q"]])))
    out, vjp = jax.vjp(call, q, k, v)
    grads = vjp(do)
    return [np.asarray(a, np.float32) for a in (out, *grads)]


def _port_out_and_grads(name, case, dtype):
    q, k, v, do = (torch.from_numpy(a).to(dtype).requires_grad_(True)
                   for a in _inputs(case))
    out = getattr(tca, name)(q, k, v, **_kwargs(name, case))
    grads = torch.autograd.grad(out, (q, k, v), do.detach())
    assert out.dtype == dtype and all(g.dtype == dtype for g in grads)
    return [t.detach().float().numpy() for t in (out, *grads)]


@pytest.mark.parametrize("case_id", sorted(CASES))
@pytest.mark.parametrize("name", FNS)
def test_forward_and_grads_match_jax(name, case_id):
    """out, dq, dk, dv in f32 against the JAX function and its
    custom_vjp at 1e-5."""
    want = _jax_out_and_grads(name, case_id, "float32")
    got = _port_out_and_grads(name, CASES[case_id], torch.float32)
    for what, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL, err_msg=what)
    if case_id == "no-keys":       # rows that see no key: zeros
        assert not np.any(got[0][:, 4:]) and not np.any(got[1][:, 4:])
        assert np.all(np.any(got[0][:, :4], axis=-1))


@pytest.mark.parametrize("name", FNS)
def test_bf16_matches_jax(name):
    """bf16 operands: outputs and gradients in bf16, within a few bf16
    steps of the JAX package's."""
    want = _jax_out_and_grads(name, "window-gqa", "bfloat16")
    got = _port_out_and_grads(name, CASES["window-gqa"], torch.bfloat16)
    for what, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, atol=2e-2, rtol=2e-2, err_msg=what)


def test_pair_list_matches_jax_and_skips_blocks():
    """The static pair list equals the reference's over a grid of masks;
    causal attention visits (nq + 1) / (2 nq) of the square, a window
    fewer, and no pair lies past lk_valid."""
    for nq, nk, bq, bk in ((4, 4, 8, 8), (3, 5, 16, 8), (5, 2, 4, 16)):
        for causal in (True, False):
            for window in (None, 3, 12):
                for q_off in (0, 7):
                    for lkv in (nk * bk, nk * bk - 5):
                        args = (nq, nk, bq, bk, q_off, causal, window, lkv)
                        assert tca._pair_list(*args) == \
                            jca._pair_list(*args), args
    assert len(tca._pair_list(8, 8, 4, 4, 0, True, None, 32)) == 36
    assert len(tca._pair_list(8, 8, 4, 4, 0, True, 4, 32)) == 15


def test_autograd_keeps_only_q_k_v_out_lse():
    """The backward recomputes from lse: the graph holds q, k, v, the
    output and the (B, Lq, H) lse, nothing of the size of a score
    block."""
    q, k, v = (torch.randn(1, 64, 2, 8, requires_grad=True)
               for _ in range(3))
    out = tca.chunked_attention_pairs(q, k, v, block_q=16, block_k=16)
    saved = out.grad_fn.saved_tensors
    assert [tuple(t.shape) for t in saved] == [
        (1, 64, 2, 8)] * 4 + [(1, 64, 2)]


# -------------------------------------------------- the 'chunked' impl ---


def _drop_free(cfg):
    if not cfg.n_experts:
        return cfg
    return dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "gemma3-1b"])
def test_chunked_impl_matches_jax_in_a_model(arch):
    """A whole smoke model under impl='chunked' (MLA in MHA mode with its
    softmax scale; MQA with windowed and global layers): forward logits
    against the JAX package's 'chunked' and the port's 'ref', and the
    loss and every leaf's gradient against the JAX package's
    'chunked'."""
    jcfg = _drop_free(jconfigs.smoke(arch))
    tcfg = _drop_free(tconfigs.smoke(arch))
    host = np_params(jmodels.model_defs(jcfg), 1)
    tp = from_jax_params(host, tcfg, device="cpu")
    toks = np.random.default_rng(2).integers(0, jcfg.vocab,
                                             (2, 20)).astype(np.int32)
    labels = np.roll(toks, -1, 1)
    labels[:, -1] = -100
    want = jax.jit(lambda p, t: jmodels.forward(
        p, jcfg, t, compute_dtype=jnp.float32, impl="chunked")[0])(
            to_jax(host), jnp.asarray(toks))
    t = torch.from_numpy(toks).long()
    got = {impl: tmodels.forward(tp, tcfg, t, compute_dtype=torch.float32,
                                 impl=impl)[0]
           for impl in ("chunked", "ref")}
    np.testing.assert_allclose(got["chunked"].numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got["chunked"].numpy(), got["ref"].numpy(),
                               atol=1e-4, rtol=1e-4)

    (j_loss, _), j_grads = jax.jit(jax.value_and_grad(
        lambda p: jlm_loss(p, jcfg, jnp.asarray(toks), jnp.asarray(labels),
                           compute_dtype=jnp.float32, impl="chunked"),
        has_aux=True))(to_jax(host))
    params = tadamw.tree_map(torch.clone, tp)
    leaves = [x.requires_grad_(True) for x in tadamw.tree_leaves(params)]
    loss, _ = lm_loss(params, tcfg, t, torch.from_numpy(labels).long(),
                      compute_dtype=torch.float32, impl="chunked")
    grads = torch.autograd.grad(loss, leaves)
    assert float(loss.detach()) == pytest.approx(float(j_loss), rel=1e-5)
    want_g = tadamw.tree_leaves(from_jax_params(
        jax.tree.map(np.asarray, j_grads), tcfg, device="cpu"))
    for g, w in zip(grads, want_g):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-4,
                                   rtol=1e-4)
