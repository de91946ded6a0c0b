"""The port's cost model against the JAX package's: every function of
``hwmodel.attention_costs``, ``core.schemes``, ``hwmodel.platforms`` and
``hwmodel.roofline`` returns the reference's value (exactly: the same
float arithmetic in the same order) over a grid of MLA configs, schemes,
cache lengths, batches, block sizes and cache dtypes; and the port
passes the ten checks of tests/test_paper_claims.py.
"""
import dataclasses
import itertools

import pytest

import repro.configs as jconfigs
from repro.core import schemes as jschemes
from repro.hwmodel import attention_costs as jac
from repro.hwmodel import platforms as jplat
from repro.hwmodel import roofline as jroof
import repro_torch.configs as tconfigs
from repro_torch.core import cache as tcache
from repro_torch.core import mla as tmla
from repro_torch.core import schemes as tschemes
from repro_torch.core.schemes import PlatformPoint, auto_dispatch
from repro_torch.hwmodel import attention_costs as ac
from repro_torch.hwmodel import platforms as tplat
from repro_torch.hwmodel import roofline as R

SCHEMES = ("seq", "rc", "ru", "naive")
LENGTHS = (1, 17, 1024, 32768)
BATCHES = (1, 7, 64)
BLOCKS = (0, 16)
CACHE_DTYPES = (None, "bf16", "int8", "fp8")
PLATS = ("h100", "a100", "tpu_v5e", "edge_tpu")


def _mla_pairs():
    """(port MLAConfig, JAX MLAConfig) of the paper's Table 1 and the
    registered configs, full and smoke."""
    yield ac.DSV3_MLA, jac.DSV3_MLA
    for arch in ("deepseek-v2-236b", "deepseek-v3-671b"):
        for get in ("full", "smoke"):
            yield (getattr(tconfigs, get)(arch).mla_config(),
                   getattr(jconfigs, get)(arch).mla_config())


MLA_PAIRS = list(_mla_pairs())


def _same(a, b):
    """Equal results: Costs field by field, dicts key by key, floats
    exactly."""
    if hasattr(a, "breakdown"):
        assert (a.flops, a.bytes, a.breakdown, a.oi) == \
            (b.flops, b.bytes, b.breakdown, b.oi)
    else:
        assert a == b


# ------------------------------------------------------------- constants --


def test_table1_instantiations_equal_the_reference():
    assert dataclasses.asdict(ac.DSV3_MLA) == dataclasses.asdict(jac.DSV3_MLA)
    for name in ("MHA_L", "MHA_S"):
        t, j = getattr(ac, name), getattr(jac, name)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.param_count() == j.param_count()
    for arch in ("deepseek-v2-236b", "deepseek-v3-671b"):
        for get in ("full", "smoke"):
            assert dataclasses.asdict(getattr(tconfigs, get)(arch)) == \
                dataclasses.asdict(getattr(jconfigs, get)(arch))


def test_platforms_and_energy_model_equal_the_reference():
    assert {k: dataclasses.asdict(v) for k, v in tplat.PLATFORMS.items()} \
        == {k: dataclasses.asdict(v) for k, v in jplat.PLATFORMS.items()}
    for tops in (0.5, 2.0, 12.5):
        for e_bit in (8.0, 3.5):
            t = tplat.EnergyModel(tops, e_bit)
            j = jplat.EnergyModel(tops, e_bit)
            assert t.e_op_pj == j.e_op_pj
            for fl, by in ((1e9, 1e6), (3.3e12, 7.1e9)):
                assert t.energy_pj(fl, by) == j.energy_pj(fl, by)


# ------------------------------------------------------ attention_costs --


@pytest.mark.parametrize("pair", range(len(MLA_PAIRS)))
def test_mla_decode_and_verify_costs(pair):
    tm, jm = MLA_PAIRS[pair]
    for s, L, B, bs, rope in itertools.product(SCHEMES, LENGTHS, BATCHES,
                                               BLOCKS, (False, True)):
        for dp, cw in ((1, None), (2, 0.75), (4, 1.0138889)):
            kw = dict(scheme=s, cache_len=L, batch=B, paged_block=bs,
                      rope=rope, dp_shards=dp, cache_dtype_bytes=cw)
            _same(ac.mla_decode_cost(tm, **kw), jac.mla_decode_cost(jm, **kw))
            _same(ac.mla_decode_cost(tm, include_io=True, **kw),
                  jac.mla_decode_cost(jm, include_io=True, **kw))
            for k in (0, 3):
                _same(ac.mla_verify_cost(tm, k=k, **kw),
                      jac.mla_verify_cost(jm, k=k, **kw))
        for k, frac in ((1, 0.0), (4, 0.25)):
            kw = dict(scheme=s, cache_len=L, k=k, batch=B, paged_block=bs,
                      draft_bytes_frac=frac)
            _same(ac.spec_break_even(tm, **kw), jac.spec_break_even(jm, **kw))
        for rescale in ("exp_add", "mul"):
            kw = dict(cache_len=L, batch=B, paged_block=bs, rescale=rescale)
            assert ac.rescale_multiplies(tm, **kw) == \
                jac.rescale_multiplies(jm, **kw)


@pytest.mark.parametrize("pair", range(len(MLA_PAIRS)))
def test_mla_prefill_costs(pair):
    tm, jm = MLA_PAIRS[pair]
    for L, B, rope in itertools.product((8, 100, 2048), (1, 5), (False, True)):
        for P in (0, 3, L // 2):
            for cw in (None, 0.5234):
                kw = dict(seq_len=L, batch=B, rope=rope, cached_prefix=P,
                          cache_dtype_bytes=cw)
                _same(ac.mla_prefill_cost(tm, **kw),
                      jac.mla_prefill_cost(jm, **kw))
                for C, bs, impl in itertools.product((1, 32), (4, 16),
                                                     ("pallas", "gather")):
                    kw2 = dict(kw, chunk=C, paged_block=bs, impl=impl)
                    _same(ac.mla_prefill_chunk_cost(tm, **kw2),
                          jac.mla_prefill_chunk_cost(jm, **kw2))
            kw = dict(seq_len=L, cached_prefix=P, batch=B, rope=rope)
            _same(ac.prefix_hit_savings(tm, **kw),
                  jac.prefix_hit_savings(jm, **kw))


def test_mha_costs_chain_ops_and_softmax():
    for name in ("MHA_L", "MHA_S"):
        t, j = getattr(ac, name), getattr(jac, name)
        for L, B, io in itertools.product(LENGTHS, BATCHES, (False, True)):
            _same(ac.mha_decode_cost(t, cache_len=L, batch=B, include_io=io),
                  jac.mha_decode_cost(j, cache_len=L, batch=B, include_io=io))
            for causal in (False, True):
                kw = dict(seq_len=L, batch=B, causal=causal, include_io=io)
                _same(ac.mha_prefill_cost(t, **kw),
                      jac.mha_prefill_cost(j, **kw))
    for tm, jm in MLA_PAIRS:
        for o, L, B, rope in itertools.product(("123", "132", "213", "ru"),
                                               LENGTHS, BATCHES,
                                               (False, True)):
            assert ac.score_chain_ops(tm, o, L, B, rope) == \
                jac.score_chain_ops(jm, o, L, B, rope)
    for h, L, B, ops in itertools.product((1, 128), LENGTHS, BATCHES, (5, 3)):
        assert ac.softmax_flops(h, L, B, ops) == jac.softmax_flops(h, L, B, ops)
    for bad in (lambda m: ac.score_chain_ops(m, "321", 8),
                lambda m: ac.mla_prefill_chunk_cost(m, seq_len=8, chunk=4,
                                                    paged_block=4,
                                                    impl="x"),
                lambda m: ac.mla_verify_cost(m, scheme="seq", cache_len=8,
                                             k=-1)):
        with pytest.raises(ValueError):
            bad(ac.DSV3_MLA)


# --------------------------------------------------------------- schemes --


@pytest.mark.parametrize("plat", PLATS)
def test_scheme_times_and_dispatch(plat):
    tp, jp = tplat.PLATFORMS[plat], jplat.PLATFORMS[plat]
    for tm, jm in MLA_PAIRS:
        for cd in CACHE_DTYPES:
            assert tschemes.cache_width(tm, tp, cd) == \
                jschemes.cache_width(jm, jp, cd)
            for L, B, bs in itertools.product(LENGTHS, BATCHES, BLOCKS):
                kw = dict(cache_len=L, batch=B, paged_block=bs,
                          cache_dtype=cd)
                for s in SCHEMES:
                    assert tschemes.step_time(s, tm, tp, **kw) == \
                        jschemes.step_time(s, jm, jp, **kw)
                    assert tschemes.verify_time(s, tm, tp, k=3, **kw) == \
                        jschemes.verify_time(s, jm, jp, k=3, **kw)
                for vk in (0, 1, 4):
                    assert tschemes.auto_dispatch(tm, tp, verify_k=vk,
                                                  dp_shards=2, **kw) == \
                        jschemes.auto_dispatch(jm, jp, verify_k=vk,
                                               dp_shards=2, **kw)
            for L, B, P in ((64, 1, 0), (1000, 3, 100), (4096, 8, 2048)):
                for C, bs, impl in ((0, 0, "pallas"), (32, 16, "pallas"),
                                    (32, 16, "gather")):
                    kw = dict(seq_len=L, batch=B, cached_prefix=P, chunk=C,
                              paged_block=bs, impl=impl, cache_dtype=cd)
                    assert tschemes.prefill_time(tm, tp, **kw) == \
                        jschemes.prefill_time(jm, jp, **kw)
            for bs, n in ((4, 1), (16, 3)):
                assert tschemes.cow_copy_time(tm, tp, bs, n, cd) == \
                    jschemes.cow_copy_time(jm, jp, bs, n, cd)
                for L in (15, 16, 100):
                    assert tschemes.fork_time(tm, tp, L, n + 1, bs, cd) == \
                        jschemes.fork_time(jm, jp, L, n + 1, bs, cd)


# -------------------------------------------------------------- roofline --


def test_roofline_functions():
    tp, jp = tplat.PLATFORMS["h100"], jplat.PLATFORMS["h100"]
    em_t, em_j = tplat.EnergyModel(2.0), jplat.EnergyModel(2.0)
    methods = ("mla_seq", "mla_rc", "mla_ru", "mla_naive", "mha_l", "mha_s")
    for m, L, B in itertools.product(methods, LENGTHS, BATCHES):
        for sm in (False, True):
            t = R.decode_cost(m, cache_len=L, batch=B, with_softmax=sm)
            j = jroof.decode_cost(m, cache_len=L, batch=B, with_softmax=sm)
            _same(t, j)
            assert R.attainable_time(t, tp) == jroof.attainable_time(j, jp)
            assert R.throughput(t, tp) == jroof.throughput(j, jp)
            assert R.energy_pj(t, em_t) == jroof.energy_pj(j, em_j)
    tm, jm = MLA_PAIRS[1]
    _same(R.decode_cost("mla_rc", cache_len=64, mla_cfg=tm, rope=True),
          jroof.decode_cost("mla_rc", cache_len=64, mla_cfg=jm, rope=True))
    for m in ("mla", "mha_l", "mha_s"):
        for L in (128, 4096):
            _same(R.prefill_cost(m, seq_len=L, batch=2),
                  jroof.prefill_cost(m, seq_len=L, batch=2))
    with pytest.raises(ValueError):
        R.decode_cost("gqa", cache_len=8)
    for args in ((1e15, 3e12, 1e10, 4, 989e12, 3.35e12, 4.5e11),
                 (5e12, 8e12, 0.0, 1, 197e12, 819e9, 5e10)):
        t, j = R.three_term(*args), jroof.three_term(*args)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (t.bound, t.t_total, t.roofline_fraction) == \
            (j.bound, j.t_total, j.roofline_fraction)


# ---------------------------------------- tests/test_paper_claims.py ------


def test_table1_param_counts_exact():
    assert round(tmla.param_count(ac.DSV3_MLA, rope=False) / 1e6) == 174
    assert round(ac.MHA_L.param_count() / 1e6) == 470
    assert round(ac.MHA_S.param_count() / 1e6) == 172


def test_fig2_naive_order_worst_at_long_cache():
    for L in (4096, 32768, 131072):
        costs = {o: ac.score_chain_ops(ac.DSV3_MLA, o, L)
                 for o in ("123", "132", "213", "ru")}
        assert costs["132"] == max(costs.values())
    big = 4_000_000
    c = {o: ac.score_chain_ops(ac.DSV3_MLA, o, big) for o in ("123", "213")}
    assert abs(c["123"] - c["213"]) / c["123"] < 0.05


def test_fig2_seq_order_never_more_ops_than_rc():
    for L in (128, 4096, 131072):
        assert ac.score_chain_ops(ac.DSV3_MLA, "123", L) <= \
            ac.score_chain_ops(ac.DSV3_MLA, "213", L)


def test_fig3_rc_trades_ops_for_bytes_vs_ru():
    for L in (1024, 16384, 131072):
        rc = ac.mla_decode_cost(ac.DSV3_MLA, scheme="rc", cache_len=L)
        ru = ac.mla_decode_cost(ac.DSV3_MLA, scheme="ru", cache_len=L)
        assert rc.flops > ru.flops
        assert rc.bytes < ru.bytes


def test_fig3_mla_bytes_scale_better_than_mha():
    small = R.decode_cost("mla_rc", cache_len=1024)
    big = R.decode_cost("mla_rc", cache_len=131072)
    small_m = R.decode_cost("mha_l", cache_len=1024)
    big_m = R.decode_cost("mha_l", cache_len=131072)
    assert (big.bytes - small.bytes) < (big_m.bytes - small_m.bytes) / 20


def test_fig4_oi_trends():
    L = (1024, 16384, 131072)
    mha = [R.decode_cost("mha_l", cache_len=n).oi for n in L]
    mha_s = [R.decode_cost("mha_s", cache_len=n).oi for n in L]
    ru = [R.decode_cost("mla_ru", cache_len=n).oi for n in L]
    rc = [R.decode_cost("mla_rc", cache_len=n).oi for n in L]
    assert max(mha) < 2 and max(mha_s) < 2
    assert max(mha) / min(mha) < 1.5
    assert ru[-1] / ru[0] > 10
    assert min(rc) > 20 * max(mha)
    assert rc[-1] / rc[0] < 2.5


def test_fig4_prefill_oi_high_everywhere():
    for m in ("mla_rc", "mha_l", "mha_s"):
        assert R.prefill_cost(m, seq_len=4096).oi > 500


def test_fig5_dispatch_crossover():
    rich = PlatformPoint("rich", 200e12, 400e9)
    poor = PlatformPoint("poor", 0.5e12, 400e9)
    L = 8192

    def t(s, p):
        c = ac.mla_decode_cost(ac.DSV3_MLA, scheme=s, cache_len=L)
        return max(c.flops / p.peak_flops, c.bytes / p.hbm_bw)

    assert t("rc", rich) < t("ru", rich)
    assert t("ru", poor) < t("rc", poor)
    assert auto_dispatch(ac.DSV3_MLA, poor, L, candidates=("rc", "ru")) == "ru"
    assert auto_dispatch(ac.DSV3_MLA, rich, L, candidates=("rc", "ru")) == "rc"


def test_beyond_paper_seq_dominates_two_term():
    for L in (1024, 32768, 262144):
        seq = ac.mla_decode_cost(ac.DSV3_MLA, scheme="seq", cache_len=L)
        rc = ac.mla_decode_cost(ac.DSV3_MLA, scheme="rc", cache_len=L)
        assert seq.bytes == rc.bytes
        assert seq.flops <= rc.flops


def test_mla_cache_bytes_per_token():
    lat = tcache.bytes_per_token_latent(512, 64)
    dense = tcache.bytes_per_token_dense(128, 128)
    assert lat == 1152 and dense == 65536
    assert dense / lat > 50
