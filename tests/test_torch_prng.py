"""Parity of the port's ``runtime.prng`` with ``jax.random`` (jax's
default threefry2x32, partitionable counters, Gumbel mode 'low') and of
its ``SyntheticLM`` with the JAX package's.

Held exactly: the Random123 known-answer vectors of threefry2x32_20, the
key words of ``PRNGKey`` / ``fold_in`` / ``split``, 32-bit random bits,
float32 ``uniform`` (bit patterns), int32 ``randint`` and the data
pipeline's batches.  Gumbel noise goes through two logarithms, which
XLA's CPU backend and PyTorch compute with different polynomials: some
values differ in the last place, so it is held to two units in the last
place of max(|g|, 1) (the uniform underneath it is held exactly).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng as jprng

from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.runtime import prng

SEEDS = [0, 3, 2**31 + 5, 2**32 - 1]
FOLDS = [0, 1, 7, 2**31 + 3]
SHAPES = [(1,), (5,), (3, 7), (2, 2, 9), (1000,)]

# Random123's kat_vectors for threefry2x32_20: (key, counter, output)
KAT = [((0x00000000, 0x00000000), (0x00000000, 0x00000000),
        (0x6b200159, 0x99ba4efe)),
       ((0xffffffff, 0xffffffff), (0xffffffff, 0xffffffff),
        (0x1cb996fc, 0xbb002be7)),
       ((0x13198a2e, 0x03707344), (0x243f6a88, 0x85a308d3),
        (0xc4923a9c, 0x483df7a0))]


def _t(*vals):
    return torch.tensor(vals, dtype=torch.int64)


def _words(x):
    return np.asarray(x).astype(np.int64).tolist()


def _keys(seed):
    """(jax key, port key) pairs: the seed's key and its folds."""
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    yield jk, tk
    for d in FOLDS:
        yield jax.random.fold_in(jk, d), prng.fold_in(tk, d)


@pytest.mark.parametrize("key,ctr,want", KAT)
def test_threefry_known_answers(key, ctr, want):
    got = prng.threefry2x32(_t(key[0]), _t(key[1]), _t(ctr[0]), _t(ctr[1]))
    assert tuple(int(w[0]) for w in got) == want
    jax_out = jprng.threefry_2x32(np.uint32(key), np.uint32(ctr))
    assert tuple(_words(jax_out)) == want


@pytest.mark.parametrize("rnd", range(20))
def test_every_round_rotation_is_held(rnd, monkeypatch):
    """The 20 rounds' rotation amounts are the schedule the known answers
    pin: changing any one amount changes the nonzero vectors' answers
    (the all-zero vector rotates zeros through its first four rounds)."""
    assert len(prng.SCHEDULE) == 20
    bad = list(prng.SCHEDULE)
    bad[rnd] = bad[rnd] % 31 + 1
    monkeypatch.setattr(prng, "SCHEDULE", tuple(bad))
    for key, ctr, want in KAT[1:]:
        got = prng.threefry2x32(_t(key[0]), _t(key[1]), _t(ctr[0]),
                                _t(ctr[1]))
        assert tuple(int(w[0]) for w in got) != want


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_fold_in_and_split_match_jax(seed):
    for jk, tk in _keys(seed):
        assert _words(jk) == tk.tolist()
        for num in (2, 3, 5):
            assert _words(jax.random.split(jk, num)) == \
                prng.split(tk, num).tolist()
    # a batch of folds at once (the sampler's form)
    rows = [0, 1, 5, 2**32 - 1]
    want = [_words(jax.random.fold_in(jax.random.PRNGKey(seed), r))
            for r in rows]
    got = prng.fold_in(prng.PRNGKey(seed), torch.tensor(rows)).tolist()
    assert got == want


@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_match_jax(seed):
    for jk, tk in _keys(seed):
        for shape in SHAPES:
            want = _words(jax.random.bits(jk, shape, jnp.uint32))
            assert prng.random_bits(tk, shape).tolist() == want


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_matches_jax_bit_for_bit(seed):
    for jk, tk in _keys(seed):
        for shape in SHAPES:
            want = np.asarray(jax.random.uniform(jk, shape))
            got = prng.uniform(tk, shape).numpy()
            np.testing.assert_array_equal(got.view(np.int32),
                                          want.view(np.int32))
            tiny = np.finfo(np.float32).tiny
            want = np.asarray(jax.random.uniform(jk, shape, minval=tiny))
            got = prng.uniform(tk, shape, minval=tiny).numpy()
            np.testing.assert_array_equal(got.view(np.int32),
                                          want.view(np.int32))


@pytest.mark.parametrize("seed", SEEDS)
def test_randint_matches_jax(seed):
    ranges = [(0, 102400), (0, 32), (-5, 7), (0, 2**31 - 1), (0, 70000),
              (3, 3), (9, 2)]
    for jk, tk in _keys(seed):
        for shape in SHAPES[:4]:
            for lo, hi in ranges:
                want = np.asarray(jax.random.randint(jk, shape, lo, hi,
                                                     dtype=jnp.int32))
                got = prng.randint(tk, shape, lo, hi)
                assert got.dtype == torch.int32
                np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_matches_jax_within_two_ulps(seed):
    for jk, tk in _keys(seed):
        want = np.asarray(jax.random.gumbel(jk, (4096,)))
        got = prng.gumbel(tk, (4096,)).numpy()
        ulp = np.spacing(np.maximum(np.abs(want), np.float32(1.0)))
        assert np.all(np.abs(got - want) <= 2 * ulp)


def test_first_cpu_log_runs_on_one_thread():
    """Importing ``runtime.prng`` takes a one-element log (one thread)
    before ``gumbel`` can take its first: a process's first VML log on
    two threads at once can come back hundreds of ulps off (the comment
    under ``prng.gumbel``).  Run in a fresh process, where no log has been
    taken yet."""
    import subprocess
    import sys
    code = (
        "import torch\n"
        "sizes = []\n"
        "real = torch.log\n"
        "torch.log = lambda x: sizes.append(x.numel()) or real(x)\n"
        "from repro_torch.runtime import prng\n"
        "assert sizes == [1], sizes\n"
        "prng.gumbel(prng.PRNGKey(0), (4096,))\n"
        "assert sizes == [1, 4096, 4096], sizes\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_categorical_matches_jax():
    """``categorical`` over a batch of keys equals jax's vmapped
    ``categorical`` (rows far from ties: the Gumbel noise's last place
    cannot move them)."""
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((64, 50)) * 4).astype(np.float32)
    keys = [jax.random.fold_in(jax.random.PRNGKey(9), i) for i in range(64)]
    want = np.asarray(jax.vmap(jax.random.categorical)(
        jnp.stack(keys), jnp.asarray(logits)))
    got = prng.categorical(prng.fold_in(prng.PRNGKey(9), torch.arange(64)),
                           torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("cfg", [
    dict(seed=0, n_hosts=1, host_id=0, vocab=256, seq_len=16, batch=4),
    dict(seed=3, n_hosts=2, host_id=1, vocab=102400, seq_len=33, batch=8),
    dict(seed=7, n_hosts=4, host_id=2, vocab=50, seq_len=9, batch=4),
    dict(seed=2**31 + 1, n_hosts=1, host_id=0, vocab=1000, seq_len=64,
         batch=2),
])
def test_synthetic_lm_batches_equal_the_reference(cfg):
    cfg = dict(cfg)
    batch = cfg.pop("batch")
    t = SyntheticLM(DataConfig(global_batch=batch, **cfg))
    j = JSyntheticLM(JDataConfig(global_batch=batch, **cfg))
    for _ in range(3):                        # steps 0, 1, 2
        for a, b in zip(t.next_batch(), j.next_batch()):
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)
    for step in (5, 2**20):
        np.testing.assert_array_equal(t.peek_global(step),
                                      j.peek_global(step))
    # restoring a state replays the same stream
    t2 = SyntheticLM(dataclasses.replace(t.cfg))
    t2.load_state_dict(j.state_dict())
    np.testing.assert_array_equal(t2.next_batch()[0], j.next_batch()[0])
