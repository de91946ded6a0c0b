"""Parity of the port's paged MLA attention kernels (K1 decode, K2 chunked
prefill) with the JAX package.

On this CPU the port's wrappers run their plain PyTorch versions; each is
held against ``repro.kernels.ref`` (the exact oracle) and against the
Pallas kernels in interpret mode, on adversarial block tables (null,
stale and interleaved blocks, block-boundary lengths, index -1,
n_valid 0) in both rescale modes.  Inputs are made with numpy from a
seed and fed to both packages.

Tolerances (f32): the blockwise online softmax and the exact softmax sum
in different orders, and exp2/exp round differently in the two
frameworks; measured differences are ~1e-7, so 2e-5 (the JAX package's
own f32 kernel tolerance) bounds them.  ``exp_add`` is bit-exact.

The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_gpu.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import mla_decode as jdec
from repro.kernels import ref as jref
from repro.kernels.mla_prefill import mla_prefill_paged_kernel as j_prefill
from repro_torch.kernels import build, ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.mla_decode import mla_decode_paged_kernel
from repro_torch.kernels.mla_prefill import mla_prefill_paged_kernel

# the suite runs in parallel worker processes: a small intra-op pool
# keeps these tests from crowding the others (and is faster at this size)
torch.set_num_threads(2)

TOL = 2e-5


def _pool(N, bs, Dl, Dr, seed):
    rng = np.random.default_rng(seed)
    ckv = rng.standard_normal((N, bs, Dl)).astype(np.float32)
    krope = rng.standard_normal((N, bs, Dr)).astype(np.float32)
    return ckv, krope


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


# ------------------------------------------------------------- exp_add ----


def test_exp_add_rescale_is_bit_exact():
    """The values of the JAX package's own exactness test, including the
    2**-126 underflow (biased exponent 1: any d <= -1 flushes to 0)."""
    x = np.asarray([1.5, -3.25, 0.0, 2.0 ** -126, 1e30], np.float32)
    d = np.asarray([-3, -1, -4, -5, -20], np.int32)
    got = tref.exp_add_rescale(_t(x), _t(d)).numpy()
    want = np.asarray([1.5 * 2.0 ** -3, -3.25 * 0.5, 0.0, 0.0,
                       1e30 * 2.0 ** -20], np.float32)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tref.exp_add_rescale(_t(x), _t(np.zeros_like(d))).numpy(), x)


def test_exp_add_rescale_bits_match_jax():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(4096) * 10.0 ** rng.integers(-40, 38, 4096)
         ).astype(np.float32)
    x[::17] = 0.0
    d = rng.integers(-254, 1, 4096).astype(np.int32)
    got = tref.exp_add_rescale(_t(x), _t(d)).numpy()
    want = np.asarray(jdec.exp_add_rescale(jnp.asarray(x), jnp.asarray(d)))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


class _Ref:
    """A mutable cell with the ``ref[...]`` interface of Pallas scratch."""

    def __init__(self, a):
        self.a = a

    def __getitem__(self, _):
        return self.a

    def __setitem__(self, _, v):
        self.a = v


@pytest.mark.parametrize("rescale", tref.RESCALES)
def test_softmax_tile_update_matches_jax(rescale):
    """Three tiles of the online-softmax update, masked lanes included,
    against the JAX package's helper on the same inputs."""
    rng = np.random.default_rng(1)
    R, bs, Dl = 6, 8, 16
    acc = np.zeros((R, Dl), np.float32)
    m = np.full((R, 1), tref.NEG_INF, np.float32)
    l = np.zeros((R, 1), np.float32)
    j_acc, j_m, j_l = _Ref(jnp.asarray(acc)), _Ref(jnp.asarray(m)), \
        _Ref(jnp.asarray(l))
    t_acc, t_m, t_l = _t(acc), _t(m), _t(l)
    for tile in range(3):
        s = (rng.standard_normal((R, bs)) * 4).astype(np.float32)
        mask = rng.random((R, bs)) < 0.7
        mask[0] = tile == 2                 # row 0 live in the last tile only
        s = np.where(mask, s, tref.NEG_INF).astype(np.float32)
        ckv = rng.standard_normal((bs, Dl)).astype(np.float32)
        jdec.softmax_tile_update(jnp.asarray(s), jnp.asarray(mask),
                                 jnp.asarray(ckv), j_acc, j_m, j_l,
                                 rescale=rescale)
        t_acc, t_m, t_l = tref.softmax_tile_update(
            _t(s), _t(mask), _t(ckv), t_acc, t_m, t_l, rescale=rescale)
    np.testing.assert_array_equal(t_m.numpy(), np.asarray(j_m.a))
    _close(t_l.numpy(), j_l.a)
    _close(t_acc.numpy(), j_acc.a)


def test_unknown_rescale_raises():
    with pytest.raises(ValueError):
        tref.softmax_tile_update(torch.zeros(1, 1), torch.ones(1, 1, dtype=bool),
                                 torch.zeros(1, 1), torch.zeros(1, 1),
                                 torch.zeros(1, 1), torch.zeros(1, 1),
                                 rescale="add")


# ----------------------------------------------------------- K1 decode ----

# (B, H, Dl, Dr, bs, nb, N, indices): null/stale/interleaved entries come
# from tables drawn over the whole pool, block 0 (null) included
DECODE_CASES = [
    (3, 4, 32, 8, 16, 4, 16, [37, 0, -1]),   # ragged, first token, inactive
    (2, 8, 64, 16, 4, 6, 10, [15, 23]),            # block-boundary ends
    (4, 2, 16, 8, 4, 5, 7, [19, 3, 4, -1]),        # interleaved, tiny blocks
]


def _decode_inputs(B, H, Dl, Dr, bs, nb, N, seed=0):
    ckv, krope = _pool(N, bs, Dl, Dr, seed)
    rng = np.random.default_rng(seed + 1)
    q = rng.standard_normal((B, H, Dl + Dr)).astype(np.float32)
    bt = rng.integers(0, N, (B, nb)).astype(np.int32)
    return q, ckv, krope, bt


@pytest.mark.parametrize("B,H,Dl,Dr,bs,nb,N,idx", DECODE_CASES)
def test_decode_plain_matches_oracle_and_pallas(B, H, Dl, Dr, bs, nb, N, idx):
    q, ckv, krope, bt = _decode_inputs(B, H, Dl, Dr, bs, nb, N)
    idx = np.asarray(idx, np.int32)
    jargs = [jnp.asarray(a) for a in (q, ckv, krope, bt, idx)]
    targs = [_t(a) for a in (q, ckv, krope, bt, idx)]
    want = np.asarray(jref.mla_decode_paged_ref(*jargs))
    _close(tref.mla_decode_paged_ref(*targs), want)
    for rescale in tref.RESCALES:
        got = mla_decode_paged_kernel(*targs, rescale=rescale)
        pallas = jdec.mla_decode_paged_kernel(*jargs, rescale=rescale,
                                              interpret=True)
        _close(got, want)
        _close(got, pallas)
        assert (got.numpy()[idx < 0] == 0).all()


def test_decode_plain_ignores_unreferenced_pages():
    """Blocks the table does not reference, poisoned with 1e4, change
    nothing; neither do stale blocks past each index."""
    B, H, Dl, Dr, bs, nb, N = 2, 4, 32, 8, 4, 4, 12
    q, ckv, krope, _ = _decode_inputs(B, H, Dl, Dr, bs, nb, N, seed=3)
    bt = np.asarray([[3, 7, 9, 0], [5, 2, 11, 10]], np.int32)
    idx = np.asarray([9, 7], np.int32)       # blocks 9 / 11, 10 are stale
    poisoned = [i for i in range(N) if i not in bt]
    ckv_p, krope_p = ckv.copy(), krope.copy()
    ckv_p[poisoned] = 1e4
    krope_p[poisoned] = 1e4
    for rescale in tref.RESCALES:
        a = mla_decode_paged_kernel(*map(_t, (q, ckv, krope, bt, idx)),
                                    rescale=rescale)
        b = mla_decode_paged_kernel(*map(_t, (q, ckv_p, krope_p, bt, idx)),
                                    rescale=rescale)
        np.testing.assert_array_equal(a.numpy(), b.numpy())


# ---------------------------------------------------------- K2 prefill ----

PREFILL_CASES = [
    (3, 6, 4, 32, 8, 4, 8, 16, [0, 5, 11], [6, 3, 0]),   # first, ragged, idle
    (2, 8, 8, 64, 16, 8, 3, 8, [8, 15], [8, 1]),         # boundary + 1-tail
    (2, 5, 4, 32, 8, 16, 2, 6, [0, 27], [5, 5]),         # deep start
]


@pytest.mark.parametrize("B,C,H,Dl,Dr,bs,nb,N,lengths,n_valid",
                         PREFILL_CASES)
def test_prefill_plain_matches_oracle_and_pallas(B, C, H, Dl, Dr, bs, nb, N,
                                                 lengths, n_valid):
    ckv, krope = _pool(N, bs, Dl, Dr, 0)
    rng = np.random.default_rng(1)
    q = rng.standard_normal((B, C, H, Dl + Dr)).astype(np.float32)
    bt = rng.integers(0, N, (B, nb)).astype(np.int32)
    ln = np.asarray(lengths, np.int32)
    nv = np.asarray(n_valid, np.int32)
    jargs = [jnp.asarray(a) for a in (q, ckv, krope, bt, ln, nv)]
    targs = [_t(a) for a in (q, ckv, krope, bt, ln, nv)]
    want = np.asarray(jref.mla_prefill_paged_ref(*jargs))
    _close(tref.mla_prefill_paged_ref(*targs), want)
    for rescale in tref.RESCALES:
        got = mla_prefill_paged_kernel(*targs, rescale=rescale)
        _close(got, want)
        _close(got, j_prefill(*jargs, rescale=rescale, interpret=True))
        for b in range(B):                   # rows past n_valid: exact 0
            assert (got.numpy()[b, n_valid[b]:] == 0).all()


@pytest.mark.parametrize("rescale", tref.RESCALES)
def test_prefill_chunk1_equals_decode(rescale):
    """A one-token chunk at position L (its latent already in the pool) is
    the decode kernel at index L — K2 really is K1's multi-query sibling."""
    B, H, Dl, Dr, bs, nb, N = 3, 4, 32, 8, 4, 6, 14
    q, ckv, krope, _ = _decode_inputs(B, H, Dl, Dr, bs, nb, N, seed=7)
    bt = np.random.default_rng(7).integers(1, N, (B, nb)).astype(np.int32)
    ln = np.asarray([0, 7, 20], np.int32)
    dec = mla_decode_paged_kernel(*map(_t, (q, ckv, krope, bt, ln)),
                                  rescale=rescale)
    pre = mla_prefill_paged_kernel(
        _t(q[:, None]), _t(ckv), _t(krope), _t(bt), _t(ln),
        torch.ones(B, dtype=torch.int32), rescale=rescale)
    _close(pre[:, 0], dec)


def test_ops_dispatch():
    q, ckv, krope, bt = _decode_inputs(2, 4, 32, 8, 4, 3, 6)
    idx = np.asarray([5, 11], np.int32)
    args = [_t(a) for a in (q, ckv, krope, bt, idx)]
    _close(ops.mla_decode_paged_attention(*args, impl="ref"),
           ops.mla_decode_paged_attention(*args, impl="kernel"))
    with pytest.raises(ValueError):
        ops.mla_decode_paged_attention(*args, impl="pallas")


# ------------------------------------------------------ no fallback -------


def test_non_cpu_tensors_never_take_the_plain_version():
    """Only CPU tensors run the plain version: anything else goes to the
    kernel's checks and raises rather than computing somewhere else."""
    q, ckv, krope, bt = (torch.empty(s, device="meta") for s in
                         ((2, 4, 40), (6, 4, 32), (6, 4, 8), (2, 3)))
    idx = torch.empty(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        mla_decode_paged_kernel(q, ckv, krope, bt.int(), idx)
    with pytest.raises(ValueError, match="CUDA"):
        mla_prefill_paged_kernel(q[:, None], ckv, krope, bt.int(), idx, idx)


def test_cuda_call_on_a_cpu_box_raises():
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device")
    with pytest.raises((RuntimeError, AssertionError)):
        torch.zeros(1, device="cuda")
    from repro_torch import configs, models
    from repro_torch.nn import module as nnm
    with pytest.raises(RuntimeError):     # entry points default to cuda
        nnm.init_params(models.model_defs(configs.smoke("deepseek-v2-236b")),
                        seed=0)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(FileNotFoundError):
        build.load("mla_decode_paged")


def test_library_path_tracks_the_sources():
    p = build.library_path("mla_decode_paged")
    assert p.parent == build.BUILD_DIR and p.name.startswith(
        "mla_decode_paged-") and p.suffix == ".so"
    assert p != build.library_path("mla_prefill_paged")
