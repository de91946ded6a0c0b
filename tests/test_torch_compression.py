"""Error-feedback top-k gradient compression of the port
(``repro_torch.optim.compression``) against the JAX package's, on the
CPU: ``compress``, ``init_error`` and ``compression_ratio`` on trees of
nested dicts and lists drawn with numpy from a seed, leaves below and
above ``min_elems``, f32 and bf16 gradients, ties planted at the
threshold, and errors carried over several steps.  The sent gradient and
the new error must equal the reference's bit for bit (signed zeros
included), and ``sent + error`` must equal ``grad + error_in`` exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro_torch import optim as toptim
from repro_torch.optim.adamw import tree_leaves

SHAPES = {"small": (7, 9),          # 63 < min_elems: passes through
          "edge": (32, 32),         # exactly min_elems: compressed
          "wide": (64, 300),
          "stack": (3, 40, 50)}


def _tree(rng, ties: bool):
    """{"w": [leaf, leaf], "blk": {"a": leaf, "b": leaf}} of f32 leaves.
    ``ties``: magnitudes from a few values, so the k-th largest is tied
    with many entries."""
    def leaf(shape):
        if ties:
            return (rng.integers(-4, 5, shape) * 0.25).astype(np.float32)
        return rng.standard_normal(shape).astype(np.float32)
    return {"w": [leaf(SHAPES["small"]), leaf(SHAPES["edge"])],
            "blk": {"a": leaf(SHAPES["wide"]), "b": leaf(SHAPES["stack"])}}


def _to_torch(tree, dtype=torch.float32):
    return jax.tree.map(lambda a: torch.from_numpy(a).to(dtype), tree)


def _bits(x):
    a = x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)
    return a.view(np.uint32)


def _assert_bitwise(got, want, what):
    g, w = list(tree_leaves(got)), jax.tree.leaves(want)
    assert len(g) == len(w)
    for i, (a, b) in enumerate(zip(g, w)):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b),
                                      err_msg=f"{what} leaf {i}")


@pytest.mark.parametrize("fraction", [0.01, 0.1, 0.5])
@pytest.mark.parametrize("ties", [False, True], ids=["normal", "ties"])
def test_compress_matches_jax_over_carried_steps(fraction, ties):
    """Four steps with the error carried: sent and error bitwise equal
    to the reference's at every step; the sum is exact; a tie at the
    threshold sends every tied entry (more than k)."""
    rng = np.random.default_rng(11 + int(ties))
    cfg_j = joptim.TopKConfig(fraction=fraction)
    cfg_t = toptim.TopKConfig(fraction=fraction)
    jerr = joptim.init_error(_tree(rng, ties))
    terr = toptim.init_error(_to_torch(_tree(rng, ties)))
    _assert_bitwise(terr, jerr, "init_error")
    for step in range(4):
        g = _tree(rng, ties)
        jsent, jerr = joptim.compress(cfg_j, jax.tree.map(jnp.asarray, g),
                                      jerr)
        tg = _to_torch(g)
        terr_in = jax.tree.map(torch.clone, terr)
        tsent, terr = toptim.compress(cfg_t, tg, terr)
        _assert_bitwise(tsent, jsent, f"sent, step {step}")
        _assert_bitwise(terr, jerr, f"error, step {step}")
        for s, e, gi, ei in zip(tree_leaves(tsent), tree_leaves(terr),
                                tree_leaves(tg), tree_leaves(terr_in)):
            assert torch.equal(s + e, gi + ei)
        small, wide = tsent["w"][0], tsent["blk"]["a"]
        assert torch.equal(small, tg["w"][0] + terr_in["w"][0])
        k = max(1, int(wide.numel() * fraction))
        kept = int((wide != 0).sum())
        if ties:
            assert kept > k
        else:
            assert kept == k


def test_compress_bf16_gradients_and_min_elems():
    """bf16 gradients are widened to f32 before the error is added, as
    in the reference; ``min_elems`` decides which leaves pass whole."""
    rng = np.random.default_rng(5)
    g32 = _tree(rng, False)
    tg = _to_torch(g32, torch.bfloat16)
    jg = jax.tree.map(lambda t: jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16), tg)
    for min_elems in (1, 1024, 6001):
        cj = joptim.TopKConfig(fraction=0.05, min_elems=min_elems)
        ct = toptim.TopKConfig(fraction=0.05, min_elems=min_elems)
        jsent, jerr = joptim.compress(cj, jg, joptim.init_error(jg))
        tsent, terr = toptim.compress(ct, tg, toptim.init_error(tg))
        _assert_bitwise(tsent, jsent, f"sent, min_elems {min_elems}")
        _assert_bitwise(terr, jerr, f"error, min_elems {min_elems}")
        whole = [t.numel() < min_elems for t in tree_leaves(tg)]
        for passed, e in zip(whole, tree_leaves(terr)):
            assert passed == (not bool(e.any()) and e.numel() < min_elems)


@pytest.mark.parametrize("fraction,min_elems", [(0.01, 1024), (0.25, 1),
                                                (0.001, 5000)])
def test_compression_ratio_matches_jax(fraction, min_elems):
    tree = _tree(np.random.default_rng(0), False)
    want = joptim.compression_ratio(
        joptim.TopKConfig(fraction=fraction, min_elems=min_elems),
        jax.tree.map(jnp.asarray, tree))
    got = toptim.compression_ratio(
        toptim.TopKConfig(fraction=fraction, min_elems=min_elems),
        _to_torch(tree))
    assert got == want


def test_compress_keeps_the_input_and_dropped_signs():
    """``compress`` leaves its inputs as they were (the port reuses its
    own temporaries in place, never the caller's), and a dropped
    negative entry sends -0.0, as ``g * mask`` does in the reference."""
    g = {"x": torch.linspace(-3.0, 2.0, 2048)}
    e = toptim.init_error(g)
    g0, e0 = g["x"].clone(), e["x"].clone()
    sent, err = toptim.compress(toptim.TopKConfig(fraction=0.01), g, e)
    assert torch.equal(g["x"], g0) and torch.equal(e["x"], e0)
    dropped_neg = (g0 < 0) & (sent["x"] == 0)
    assert dropped_neg.any()
    assert torch.signbit(sent["x"][dropped_neg]).all()
    assert int((sent["x"] != 0).sum()) == 20
