"""Parity of the port's flash attention (kernels K4, K5, K6: forward, dQ,
dK/dV) with the JAX package, on the CPU.

On CPU tensors the port's ``torch.autograd.Function`` runs the kernels'
plain blockwise versions; the JAX side runs the Pallas kernels in
interpret mode (as ``tests/test_kernels.py`` does) and the dense oracle
``flash_attention_ref``.  Inputs come from numpy with fixed seeds, over
the reference's grid: MHA, GQA 2:1, MQA with ragged lengths and
Dv != Dqk, sliding windows, a query offset, and an MLA-like 24 + 16 split
of the query/key width, in f32 and bf16.

Tolerances: f32 forward 2e-5 and backward 5e-4 abs+rel, the reference's
own (tests/test_kernels.py; reduction order differs between the
frameworks at ~1e-7, and the backward sums over more terms).  bf16 2e-2,
the reference's bf16 tolerance: both sides compute in f32 from the same
bf16 inputs and round the result to bf16, so they may differ by one bf16
step (2^-8 relative).  The log-sum-exp is f32 in both dtypes: 2e-5.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import attention as jattn
from repro.kernels.flash_attention import _fwd as jfa_fwd
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels import ref as jref
from repro_torch.core import attention as tattn
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

torch.set_num_threads(2)

# (B, H, Hkv, Lq, Lk, Dqk, Dv, window, q_offset)
CASES = {
    "mha": (1, 4, 4, 64, 64, 32, 32, None, 0),
    "gqa2": (2, 4, 2, 48, 48, 16, 16, None, 0),
    "mqa_ragged_dv": (1, 8, 1, 33, 70, 16, 24, None, 0),
    "window8": (1, 4, 2, 96, 96, 32, 32, 8, 0),
    "window32": (1, 4, 2, 96, 96, 32, 32, 32, 0),
    "q_offset": (1, 2, 2, 32, 64, 16, 16, None, 32),
    "mla_24_16": (2, 4, 4, 40, 40, 24 + 16, 24, None, 0),
}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL_FWD = {"float32": 2e-5, "bfloat16": 2e-2}
TOL_BWD = {"float32": 5e-4, "bfloat16": 2e-2}


def _inputs(case: str):
    B, H, Hkv, Lq, Lk, D, Dv, _, _ = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f(B, H, Lq, D), f(B, Hkv, Lk, D), f(B, Hkv, Lk, Dv), \
        f(B, H, Lq, Dv)


def _as_dtype(arrays, jdt):
    """numpy f32 arrays rounded to the dtype (so both sides see the same
    values), as f32 numpy."""
    return [np.asarray(jnp.asarray(a, jdt).astype(jnp.float32))
            for a in arrays]


@functools.lru_cache(maxsize=None)
def _jax_results(case: str, dtype: str):
    """JAX Pallas kernel (interpret) out, lse and the gradients of
    sum(out * w), plus the dense oracle's out."""
    _, _, _, _, _, D, _, window, q_offset = CASES[case]
    jdt = DTYPES[dtype][0]
    q, k, v, w = [jnp.asarray(a, jdt) for a in _inputs(case)]
    scale = D ** -0.5

    def fwd(q, k, v):
        return jflash(q, k, v, True, window, q_offset, None,
                      16, 16, True)

    out = jax.jit(fwd)(q, k, v)
    _, lse = jax.jit(functools.partial(
        jfa_fwd, causal=True, window=window, q_offset=q_offset, scale=scale,
        block_q=16, block_k=16, interpret=True))(q, k, v)
    grads = jax.jit(jax.grad(
        lambda q, k, v: jnp.sum(fwd(q, k, v).astype(jnp.float32)
                                * w.astype(jnp.float32)),
        (0, 1, 2)))(q, k, v)
    oracle = jref.flash_attention_ref(q, k, v, causal=True, window=window,
                                      q_offset=q_offset)
    as_np = lambda x: np.asarray(x.astype(jnp.float32))
    return as_np(out), np.asarray(lse), [as_np(g) for g in grads], \
        as_np(oracle)


def _torch_inputs(case: str, dtype: str, requires_grad: bool = False):
    jdt, tdt = DTYPES[dtype]
    arrays = _as_dtype(_inputs(case), jdt)
    return [torch.from_numpy(a.copy()).to(tdt)
            .requires_grad_(requires_grad and i < 3)
            for i, a in enumerate(arrays)]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_forward_matches_jax(case, dtype):
    """Out and lse of the Function's forward (the plain version of K4)
    against the Pallas kernel, and out against the dense oracle."""
    _, _, _, _, _, D, _, window, q_offset = CASES[case]
    q, k, v, _ = _torch_inputs(case, dtype)
    j_out, j_lse, _, j_oracle = _jax_results(case, dtype)
    out = tfa.flash_attention(q, k, v, True, window, q_offset)
    _, lse = tfa.flash_fwd_kernel(q, k, v, causal=True, window=window,
                                  q_offset=q_offset, scale=D ** -0.5)
    assert out.dtype == q.dtype and out.shape == j_out.shape
    _close(out.float(), j_out, TOL_FWD[dtype])
    _close(out.float(), j_oracle, TOL_FWD[dtype])
    _close(lse, j_lse, 2e-5)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_backward_matches_jax(case, dtype):
    """dQ, dK, dV from autograd through the Function (the plain versions
    of K5 and K6) against jax.grad through the Pallas custom_vjp."""
    _, _, _, _, _, _, _, window, q_offset = CASES[case]
    q, k, v, w = _torch_inputs(case, dtype, requires_grad=True)
    _, _, j_grads, _ = _jax_results(case, dtype)
    out = tfa.flash_attention(q, k, v, True, window, q_offset)
    torch.sum(out.float() * w.float()).backward()
    for got, want in zip((q.grad, k.grad, v.grad), j_grads):
        assert got.dtype == q.dtype
        _close(got.float(), want, TOL_BWD[dtype])


def test_backward_matches_autograd_through_the_dense_oracle():
    """The custom backward equals autograd through the port's own dense
    oracle (f32, GQA, window and offset together)."""
    rng = np.random.default_rng(7)
    mk = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).requires_grad_()
    q, k, v = mk(2, 6, 50, 24), mk(2, 3, 80, 24), mk(2, 3, 80, 20)
    w = torch.from_numpy(rng.standard_normal((2, 6, 50, 20)).astype(
        np.float32))
    grads = []
    for fn in (lambda: tfa.flash_attention(q, k, v, True, 24, 30),
               lambda: tref.flash_attention_ref(q, k, v, causal=True,
                                                window=24, q_offset=30)):
        q.grad = k.grad = v.grad = None
        torch.sum(fn() * w).backward()
        grads.append([t.grad.clone() for t in (q, k, v)])
    for a, b in zip(*grads):
        _close(a, b, 5e-4)


def test_fully_masked_rows_give_zero_out_and_neg_inf_lse():
    """Rows that attend nothing (a window past every key) return out 0
    and lse = -2^30 + log 1, and get zero gradients."""
    q = torch.randn(1, 2, 8, 16, requires_grad=True)
    k = torch.randn(1, 2, 8, 16, requires_grad=True)
    v = torch.randn(1, 2, 8, 16, requires_grad=True)
    # q_offset 100, window 4: every query attends keys > 96 — none exist
    out, lse = tfa.flash_fwd_kernel(q, k, v, causal=True, window=4,
                                    q_offset=100, scale=0.25)
    assert torch.equal(out, torch.zeros_like(out))
    assert torch.equal(lse, torch.full_like(lse, tfa.NEG_INF))
    tfa.flash_attention(q, k, v, True, 4, 100).sum().backward()
    for t in (q, k, v):
        assert torch.equal(t.grad, torch.zeros_like(t))


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    before = (tfa.flash_fwd_kernel.launches, tfa.flash_bwd_dq_kernel.launches,
              tfa.flash_bwd_dkv_kernel.launches)
    q, k, v, _ = _torch_inputs("gqa2", "float32", requires_grad=True)
    tfa.flash_attention(q, k, v).sum().backward()
    assert (tfa.flash_fwd_kernel.launches, tfa.flash_bwd_dq_kernel.launches,
            tfa.flash_bwd_dkv_kernel.launches) == before


@pytest.mark.parametrize("impl", ["ref", "kernel"])
def test_ops_attention_matches_jax(impl):
    """``ops.attention`` for both impls against the JAX package's
    ``ops.attention(impl='ref')`` on (B, L, H, D) tensors passed as
    transposed views, as the MLA path passes them."""
    from repro.kernels import ops as jops
    rng = np.random.default_rng(11)
    q = rng.standard_normal((2, 40, 4, 24)).astype(np.float32)
    k = rng.standard_normal((2, 40, 2, 24)).astype(np.float32)
    v = rng.standard_normal((2, 40, 2, 16)).astype(np.float32)
    want = jops.attention(*(jnp.asarray(a).swapaxes(1, 2) for a in (q, k, v)),
                          impl="ref", softmax_scale=0.3)
    got = tops.attention(*(torch.from_numpy(a).transpose(1, 2)
                           for a in (q, k, v)), impl=impl,
                         softmax_scale=0.3)
    _close(got, want, 2e-5)


@pytest.mark.parametrize("window", [None, 8])
def test_gqa_attention_matches_jax(window):
    rng = np.random.default_rng(12)
    q = rng.standard_normal((2, 24, 6, 16)).astype(np.float32)
    k = rng.standard_normal((2, 24, 3, 16)).astype(np.float32)
    v = rng.standard_normal((2, 24, 3, 12)).astype(np.float32)
    want = jattn.gqa_attention(*(jnp.asarray(a) for a in (q, k, v)),
                               window=window)
    got = tattn.gqa_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              window=window)
    _close(got, want, 2e-5)
