"""The port's sharded paged MLA serving on the CPU over gloo: a (data,
model) mesh of ranks (``launch.mesh``), the sharding rules and specs
(``nn.sharding``, ``runtime.steps``), ``weights.shard_params`` and the
paged engine's ``mesh=`` / ``shard_policy=``.

In-process (no ranks): ``make_rules`` equals the JAX package's for every
mode x every config x five mesh shapes (the JAX side gets a stand-in with
``axis_names`` and ``devices.shape``: no JAX devices), the paged pool's
specs equal ``cache_pspecs(paged=True)``'s, each rank's shards from
``shard_params`` tile every leaf, and the engine pads ``max_batch`` to a
DP multiple.

One spawned world a mesh shape, every case in one spawn (as the
reference batches its cases into one subprocess): on (2, 2), the smoke
DeepSeek-V2 (8 experts, top-2, 4 heads) at drop-free MoE capacity gives
the JAX engine's greedy tokens at ``mesh=None`` (and the port's on one
device) for the four schemes x {'gather', 'kernel'} and under every
policy; the dense MLA config (the reference's ``DENSE``) gives its
seeded samples and replays a recompute preemption; the paged steps'
logits agree with one device's within 1e-4 and their pool writes within
1e-5 (the reference's bounds, ``tests/test_mesh_paged.py``); every
rank's pool is bitwise equal to every other's after every serve; at
capacity 1.25 an MoE layer gives, on each DP shard, what one device
gives on that shard's tokens alone (each shard counts its own capacity;
'serve_2dtp' counts the whole batch's); ``gather_tensor`` inverts
``shard_params`` on every leaf.  (1, 2) and (2, 1) serve one scheme.
"""
import dataclasses
import hashlib
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch import models as tmodels
from repro_torch.launch.mesh import Mesh, launch
from repro_torch.models.common import ModelConfig as TModelConfig
from repro_torch.nn import sharding as tshd

torch.set_num_threads(2)

ARCH = "deepseek-v2-236b"
SCHEMES = ("naive", "seq", "rc", "ru")
IMPLS = {"gather": "ref", "kernel": "kernel"}
POLICIES = ("serve", "serve_2dtp", "dp", "tp")
DENSE_KW = dict(name="mla-dense-smoke", family="dense", n_layers=2,
                d_model=64, n_heads=4, n_kv_heads=4, d_ff=64, vocab=256,
                attn_kind="mla", q_lora_rank=48, kv_lora_rank=32,
                qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16, max_seq=128,
                remat=False)
# (prompt length, tokens generated, arrival step), prompt seed: the
# reference's loads
GREEDY = ([(8, 3, 0), (11, 3, 1)], 3)
SAMPLED = ([(8, 6, 0), (11, 5, 1)], 3)
PREEMPT = ([(6, 10, 0), (6, 10, 0)], 19)
SAMPLE_KW = dict(temperature=0.8, top_k=5, sample_seed=3)
PREEMPT_KW = dict(temperature=0.7, top_k=8, sample_seed=1)


def _drop_free(cfg):
    return dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)


def _requests(Req, SP, load, vocab=256):
    specs, seed = load
    rng = np.random.default_rng(seed)
    return [Req(rid=i, prompt=rng.integers(0, vocab, (p,)).astype(np.int32),
                arrival=a, sampling=SP(max_tokens=g))
            for i, (p, g, a) in enumerate(specs)]


def _serve(Engine, Req, SP, cfg, params, load, *, num_blocks=24, **kw):
    """The reference's engine set-up (block 4, 2 slots, chunk 5); returns
    the engine and {rid: tokens}."""
    kw.setdefault("scheme", "seq")
    eng = Engine(cfg, params, num_blocks=num_blocks, block_size=4,
                 max_batch=2, prefill_chunk=5, **kw)
    eng.run(_requests(Req, SP, load))
    return eng, {r.rid: [int(t) for t in r.output]
                 for r in eng.sched.finished}


def _digest(pool) -> str:
    from repro_torch.core.cache import pool_leaves
    h = hashlib.sha256()
    for t in pool_leaves(pool):
        h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


# ------------------------------------------------------------ the world --


def _world(mesh, moe_np, dense_np, full: bool):
    """Every case of one mesh shape, on this rank; returns its results
    (tokens, errors, pool digests) for the test process to compare."""
    from repro_torch import models
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.core.mla import attach_absorbed_tree
    from repro_torch.nn.sharding import gather_tensor
    from repro_torch.runtime import PagedMLAEngine, Request, SamplingParams
    from repro_torch.runtime.steps import (attach_absorbed_sharded,
                                           commit_params, make_shard,
                                           paged_param_shardings)
    from repro_torch.weights import from_jax_params

    moe_cfg = _drop_free(tconfigs.smoke(ARCH))
    dense_cfg = TModelConfig(**DENSE_KW)
    moe = from_jax_params(moe_np, moe_cfg, device="cpu")
    dense = from_jax_params(dense_np, dense_cfg, device="cpu")
    out = {"env": {k: os.environ.get(k) for k in RANK_ENV}}

    def serve(key, cfg, params, load, mesh=mesh, **kw):
        eng, got = _serve(PagedMLAEngine, Request, SamplingParams, cfg,
                          params, load, compute_dtype=torch.float32,
                          device="cpu", mesh=mesh, **kw)
        out[key], out[f"pool_{key}"] = got, _digest(eng.pool)
        return eng

    if not full:
        serve("greedy_serve_seq_kernel", moe_cfg, moe, GREEDY, impl="kernel")
        return out

    def policy_runs(policy, mesh):
        """The four schemes x both impls under ``policy``, on a mesh of
        its own (its own groups: the policies run in threads, their
        collectives overlap)."""
        for scheme in SCHEMES:
            for name, impl in IMPLS.items():
                serve(f"greedy_{policy}_{scheme}_{name}", moe_cfg, moe,
                      GREEDY, mesh=mesh, scheme=scheme, impl=impl,
                      shard_policy=policy)
        if policy == "dp":
            eng = serve("preempt", dense_cfg, dense, PREEMPT, mesh=mesh,
                        num_blocks=7, **PREEMPT_KW)
            out["preemptions"] = eng.stats.preemptions
        if policy in ("tp", "serve_2dtp"):
            name = "gather" if policy == "tp" else "kernel"
            serve(f"sample_{name}", dense_cfg, dense, SAMPLED, mesh=mesh,
                  impl=IMPLS[name], **SAMPLE_KW)

    meshes = {p: mesh if p == "serve" else
              make_mesh(mesh.shape, mesh.axis_names, mesh.device)
              for p in POLICIES}
    with ThreadPoolExecutor(len(POLICIES)) as pool:
        for job in [pool.submit(policy_runs, p, m) for p, m in
                    meshes.items()]:
            job.result()

    # ---- the paged steps against one device (the reference's case),
    # under every policy, 'seq' and 'ru' (the lora dim's two contractions)
    pool0 = models.init_paged_cache(dense_cfg, 16, 4, torch.float32, "cpu")
    bt = torch.tensor([[1, 2, 3, 0], [4, 5, 6, 0]], dtype=torch.int32)
    lens = torch.tensor([5, 9], dtype=torch.int32)
    tok = torch.tensor([7, 8])
    toks = torch.as_tensor(np.random.default_rng(7).integers(
        0, dense_cfg.vocab, (2, 4)))
    nv = torch.tensor([4, 3], dtype=torch.int32)
    one = attach_absorbed_tree(dense, dense_cfg.mla_config())
    for policy in POLICIES:
        shard = make_shard(mesh, dense_cfg, policy)
        shards = attach_absorbed_sharded(
            commit_params(dense, dense_cfg, mesh, policy), dense_cfg, shard)
        for scheme in ("seq", "ru"):
            f32 = dict(compute_dtype=torch.float32, scheme=scheme)
            key = f"{policy}_{scheme}"
            l0, p0 = models.decode_step(one, dense_cfg, tok, _clone(pool0),
                                        bt, lens, impl="ref", **f32)
            l1, p1 = models.decode_step(shards, dense_cfg, tok,
                                        _clone(pool0), bt, lens,
                                        impl="kernel", shard=shard, **f32)
            out[f"decode_step_err_{key}"] = float((l0 - l1).abs().max())
            out[f"decode_pool_err_{key}"] = max(
                float((a - b).abs().max())
                for a, b in zip(_leaves(p0), _leaves(p1)))
            c0, q0 = models.prefill_chunk_paged(one, dense_cfg, toks,
                                                _clone(pool0), bt, lens, nv,
                                                impl="ref", **f32)
            c1, q1 = models.prefill_chunk_paged(shards, dense_cfg, toks,
                                                _clone(pool0), bt, lens, nv,
                                                impl="kernel", shard=shard,
                                                **f32)
            out[f"prefill_step_err_{key}"] = float((c0 - c1).abs().max())
            # block 0 (null) takes the chunk padding; the claim covers
            # the allocated blocks
            out[f"prefill_pool_err_{key}"] = max(
                float((a[1:] - b[1:]).abs().max())
                for a, b in zip(_leaves(q0), _leaves(q1)))

    # ---- the last MoE layer at capacity 1.25, on 4 rows x 32 tokens: on
    # each DP shard what one device gives on that shard's tokens alone
    cap_cfg = tconfigs.smoke(ARCH)
    full = from_jax_params(moe_np, cap_cfg, device="cpu")
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (4, 32, cap_cfg.d_model)).astype(np.float32))
    last = len(full["period"]) - 1
    ffn = full["period"][last]["s0"]["ffn"]
    for policy in ("serve", "serve_2dtp"):
        shard = make_shard(mesh, cap_cfg, policy)
        mine = commit_params(full, cap_cfg, mesh, policy)["period"][last]
        lffn = shard.local(mine, shard.axes["period"][last])["s0"]["ffn"]
        rows = shard.local_rows(x)
        got, _ = models.moe.moe_apply(lffn, cap_cfg, rows, shard=shard)
        alone, aux = models.moe.moe_apply(ffn, cap_cfg, rows)
        whole = shard.local_rows(models.moe.moe_apply(ffn, cap_cfg, x)[0])
        out[f"moe_{policy}_alone_err"] = float((got - alone).abs().max())
        out[f"moe_{policy}_whole_err"] = float((got - whole).abs().max())
        out[f"moe_{policy}_dropped"] = float(aux["dropped_frac"])

    # ---- shard_params -> gather_tensor, every leaf, every policy
    for policy in POLICIES:
        rules = tshd.make_rules(mesh, mode=policy, cfg=moe_cfg)
        mine = commit_params(moe, moe_cfg, mesh, policy)
        specs = paged_param_shardings(moe, moe_cfg, mesh, rules)
        out[f"round_trip_{policy}"] = [
            i for i, (whole, got, spec) in enumerate(zip(
                _leaves(moe), _leaves(mine), _leaves(specs)))
            if not torch.equal(gather_tensor(got, spec, mesh), whole)]
    eng = PagedMLAEngine(dense_cfg, dense, num_blocks=12, block_size=4,
                         max_batch=3, compute_dtype=torch.float32,
                         scheme="seq", mesh=mesh, device="cpu")
    out["padded_max_batch"] = eng.sched.max_batch
    return out


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ----------------------------------------------------- the test process --


@pytest.fixture(scope="module")
def np_trees():
    """The JAX-layout weights of the MoE smoke model and the dense MLA
    config (numpy leaves: both packages take them)."""
    import repro.configs as jconfigs
    import repro.models as jmodels
    from repro.models.common import ModelConfig as JModelConfig
    from _torch_parity import np_params

    jmoe = _drop_free(jconfigs.smoke(ARCH))
    jdense = JModelConfig(**DENSE_KW)
    return {"moe": (jmoe, np_params(jmodels.model_defs(jmoe), 0)),
            "dense": (jdense, np_params(jmodels.model_defs(jdense), 1))}


SHAPES = [(2, 2), (1, 2), (2, 1)]
# what launch() sets for CPU ranks while they start, and this process's
# environment before the launches
RANK_ENV = {"GLOO_SOCKET_IFNAME": "lo", "OMP_WAIT_POLICY": "PASSIVE"}
ENV_BEFORE = {}


@pytest.fixture(scope="module")
def worlds(np_trees):
    """The three worlds, launched together from threads of this process
    (each rank is a process of its own): the references are computed
    here while they run."""
    ENV_BEFORE.update(os.environ)
    pool = ThreadPoolExecutor(len(SHAPES))
    jobs = {shape: pool.submit(
        launch, _world, shape, device="cpu",
        args=(np_trees["moe"][1], np_trees["dense"][1], shape == (2, 2)))
        for shape in SHAPES}
    yield jobs
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def world22(worlds, reference):
    return worlds[(2, 2)].result()


@pytest.fixture(scope="module")
def reference(np_trees, worlds):
    """Tokens of the JAX engine at mesh=None and of the port's engine on
    one device, for every load the world serves."""
    import jax.numpy as jnp
    from repro.runtime import PagedMLAEngine as JEngine
    from repro.runtime import Request as JReq
    from repro.runtime import SamplingParams as JSP
    from _torch_parity import to_jax
    from repro_torch.runtime import PagedMLAEngine, Request, SamplingParams
    from repro_torch.weights import from_jax_params

    jmoe_cfg, moe_np = np_trees["moe"]
    jdense_cfg, dense_np = np_trees["dense"]
    jmoe, jdense = to_jax(moe_np), to_jax(dense_np)
    tmoe_cfg = _drop_free(tconfigs.smoke(ARCH))
    tdense_cfg = TModelConfig(**DENSE_KW)
    tmoe = from_jax_params(moe_np, tmoe_cfg, device="cpu")
    tdense = from_jax_params(dense_np, tdense_cfg, device="cpu")

    def jax_run(cfg, params, load, **kw):
        return _serve(JEngine, JReq, JSP, cfg, params, load,
                      compute_dtype=jnp.float32, **kw)[1]

    def port_run(cfg, params, load, **kw):
        return _serve(PagedMLAEngine, Request, SamplingParams, cfg, params,
                      load, compute_dtype=torch.float32, device="cpu",
                      **kw)[1]

    out = {}
    for scheme in SCHEMES:
        out[f"jax_greedy_{scheme}"] = jax_run(jmoe_cfg, jmoe, GREEDY,
                                              scheme=scheme)
        for name, impl in IMPLS.items():
            out[f"port_greedy_{scheme}_{name}"] = port_run(
                tmoe_cfg, tmoe, GREEDY, scheme=scheme, impl=impl)
    out["jax_sample"] = jax_run(jdense_cfg, jdense, SAMPLED, **SAMPLE_KW)
    out["port_sample"] = port_run(tdense_cfg, tdense, SAMPLED, **SAMPLE_KW)
    out["jax_preempt"] = jax_run(jdense_cfg, jdense, PREEMPT, num_blocks=40,
                                 **PREEMPT_KW)
    return out


class _JaxMesh:
    """What the JAX ``make_rules`` reads of a mesh: no devices needed."""

    def __init__(self, shape, axes=("data", "model")):
        self.axis_names = axes
        self.devices = np.empty(shape, dtype=object)


MESHES = [(1, 1), (2, 2), (1, 4), (4, 1), (16, 16)]


@pytest.mark.parametrize("mode", ("train",) + POLICIES)
def test_make_rules_match_jax(mode):
    import repro.configs as jconfigs
    from repro.nn.sharding import make_rules as jmake_rules

    for arch in tconfigs.ARCHS:
        for shape in MESHES:
            for smoke in (False, True):
                get = "smoke" if smoke else "full"
                jcfg = getattr(jconfigs, get)(arch)
                tcfg = getattr(tconfigs, get)(arch)
                want = jmake_rules(_JaxMesh(shape), mode=mode, cfg=jcfg)
                got = tshd.make_rules(Mesh(("data", "model"), shape),
                                      mode=mode, cfg=tcfg)
                assert got == want, (arch, shape, get)
        assert tshd.make_rules(Mesh(("data", "model"), (2, 2)), mode=mode) \
            == jmake_rules(_JaxMesh((2, 2)), mode=mode)


def test_cache_pspecs_paged_pool_replicated():
    """Every leaf of the paged pool (quantized scale leaves too) is
    replicated over every mesh axis, as in the JAX package."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as PS
    import repro.configs as jconfigs
    import repro.models as jmodels
    from repro.runtime.steps import cache_pspecs as jcache_pspecs
    from repro_torch.runtime.steps import cache_pspecs

    rules = {"batch": "data", "cache_seq": None}
    for cd in ("bf16", "int8"):
        jcfg = jconfigs.smoke(ARCH)
        jpool = jax.eval_shape(lambda: jmodels.init_paged_cache(
            jcfg, 4, 2, jnp.float32, cache_dtype=cd))
        want = {tuple(s) for s in jax.tree.leaves(
            jcache_pspecs(jpool, rules, paged=True),
            is_leaf=lambda x: isinstance(x, PS))}
        pool = tmodels.init_paged_cache(tconfigs.smoke(ARCH), 4, 2,
                                        torch.float32, "cpu", cd)
        got = list(_leaves(cache_pspecs(pool, rules, paged=True)))
        assert len(got) == 4 * (2 if cd == "bf16" else 4)
        assert want == {()} and set(got) == {()}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cache_pspecs(pool, rules)


@pytest.mark.parametrize("policy", POLICIES)
def test_shard_params_tile_every_leaf(policy):
    """Each (2, 2) rank's shards, laid out by the spec (major axis first),
    rebuild every leaf of the smoke DeepSeek-V2 tree with ``w_absorb``;
    a leaf already at its shard's shape is kept."""
    from repro_torch.core import mla as tmla
    from repro_torch.nn import module as tnnm
    from repro_torch.runtime.steps import paged_param_shardings
    from repro_torch.weights import shard_params

    cfg = tconfigs.smoke(ARCH)
    params = tmla.attach_absorbed_tree(
        tnnm.init_params(tmodels.model_defs(cfg), seed=0, device="cpu"),
        cfg.mla_config())
    meshes = [Mesh(("data", "model"), (2, 2), (d, m))
              for d in range(2) for m in range(2)]
    shards = [shard_params(params, cfg, mesh, policy) for mesh in meshes]
    rules = tshd.make_rules(meshes[0], mode=policy, cfg=cfg)
    specs = list(_leaves(paged_param_shardings(params, cfg, meshes[0],
                                               rules)))
    split = 0
    for i, (whole, entries) in enumerate(zip(_leaves(params), specs)):
        parts = {(m.index("data"), m.index("model")): list(_leaves(s))[i]
                 for m, s in zip(meshes, shards)}

        def rebuild(coords, dims):
            """Concatenate the parts along each split dim, minor axis
            first (as gather_tensor gathers)."""
            if not dims:
                return parts[coords]
            dim, names = dims[-1]
            ax = {"data": 0, "model": 1}[names[-1]]
            pieces = []
            for k in range(2):
                c = list(coords)
                c[ax] = k
                pieces.append(rebuild(tuple(c), dims[:-1] + (
                    [(dim, names[:-1])] if names[:-1] else [])))
            return torch.cat(pieces, dim=dim)

        dims = [(d, tshd._names(e, meshes[0])) for d, e in enumerate(entries)
                if tshd._names(e, meshes[0])]
        split += bool(dims)
        assert torch.equal(rebuild((0, 0), dims), whole), (i, entries)
        again = shard_params(shards[1], cfg, meshes[1], policy)
        assert torch.equal(list(_leaves(again))[i],
                           list(_leaves(shards[1]))[i])
    # 'dp' replicates every weight
    assert split == 0 if policy == "dp" else split > 10


def test_engine_pads_max_batch_and_refuses_what_is_not_ported():
    """``max_batch`` 3 at dp 2 gives 4 slots (a geometry-only mesh: the
    engine's set-up runs no collective); graphs, speculative decoding, a
    per-request prefill and the async engine under a mesh raise."""
    from repro_torch.nn import module as tnnm
    from repro_torch.runtime import AsyncPagedMLAEngine, PagedMLAEngine

    cfg = TModelConfig(**DENSE_KW)
    params = tnnm.init_params(tmodels.model_defs(cfg), seed=0, device="cpu")
    mesh = Mesh(("data", "model"), (2, 2))
    kw = dict(num_blocks=12, block_size=4, max_batch=3, scheme="seq",
              compute_dtype=torch.float32, device="cpu", mesh=mesh)
    assert PagedMLAEngine(cfg, params, **kw).sched.max_batch == 4
    for bad in (dict(cuda_graphs=True), dict(spec_k=2),
                dict(prefill_mode="per_request")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            PagedMLAEngine(cfg, params, **dict(kw, **bad))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        AsyncPagedMLAEngine(cfg, params, **kw)


def test_serve_cli_mesh_refusals():
    """The CLI refuses, before it spawns a rank, what a mesh does not run
    (the contiguous path first of all)."""
    from repro_torch.launch import serve

    base = ["--arch", ARCH, "--smoke", "--device", "cpu", "--mesh", "2x2"]
    for extra in ([], ["--paged", "--spec-k", "2"],
                  ["--paged", "--engine", "async"]):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            serve.main(base + extra)


# ------------------------------------------------------ (2, 2) world --


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("impl", tuple(IMPLS))
def test_engine_greedy_token_identical(world22, reference, scheme, impl):
    """(dp=2, model=2) under 'serve' == the JAX engine at mesh=None ==
    the port on one device, greedy, per scheme x impl, on every rank."""
    want = reference[f"jax_greedy_{scheme}"]
    assert reference[f"port_greedy_{scheme}_{impl}"] == want
    for rank in world22:
        assert rank[f"greedy_serve_{scheme}_{impl}"] == want


@pytest.mark.parametrize("policy", POLICIES[1:])
def test_engine_every_policy_token_identical(world22, reference, policy):
    """'serve_2dtp', 'dp' and 'tp' give the single device's tokens too,
    for the four schemes x both impls."""
    for rank in world22:
        for scheme in SCHEMES:
            for impl in IMPLS:
                assert rank[f"greedy_{policy}_{scheme}_{impl}"] \
                    == reference[f"jax_greedy_{scheme}"], (scheme, impl)


@pytest.mark.parametrize("impl", tuple(IMPLS))
def test_engine_seeded_sampling_token_identical(world22, reference, impl):
    assert reference["port_sample"] == reference["jax_sample"]
    for rank in world22:
        assert rank[f"sample_{impl}"] == reference["jax_sample"]


def test_engine_preemption_replay_matches(world22, reference):
    for rank in world22:
        assert rank["preemptions"] > 0
        assert rank["preempt"] == reference["jax_preempt"]


def test_paged_steps_accept_mesh(world22):
    """The paged decode step and chunk under the mesh ('kernel') against
    one device ('ref'), under every policy, schemes 'seq' and 'ru':
    logits within 1e-4, pool writes within 1e-5."""
    for rank in world22:
        for policy in POLICIES:
            for scheme in ("seq", "ru"):
                key = f"{policy}_{scheme}"
                assert rank[f"decode_step_err_{key}"] < 1e-4, key
                assert rank[f"decode_pool_err_{key}"] < 1e-5, key
                assert rank[f"prefill_step_err_{key}"] < 1e-4, key
                assert rank[f"prefill_pool_err_{key}"] < 1e-5, key


def test_pool_replicas_bitwise_equal(world22):
    """After every serve, every rank's pool (block 0 included) has the
    same bytes."""
    keys = [k for k in world22[0] if k.startswith("pool_")]
    assert len(keys) == 4 * 8 + 3
    for k in keys:
        assert len({rank[k] for rank in world22}) == 1, k


def test_moe_capacity_per_dp_shard(world22):
    """At capacity 1.25 a sharded MoE layer gives, on each DP shard, what
    one device gives on that shard's tokens alone (tokens dropped there),
    and not what it gives on the whole batch; 'serve_2dtp' counts the
    whole batch's capacity."""
    for rank in world22:
        assert rank["moe_serve_dropped"] > 0
        assert rank["moe_serve_alone_err"] < 1e-5
        assert rank["moe_serve_whole_err"] > 1e-3
        assert rank["moe_serve_2dtp_whole_err"] < 1e-5
    assert rank["padded_max_batch"] == 4


@pytest.mark.parametrize("policy", POLICIES)
def test_shard_gather_round_trip(world22, policy):
    """``gather_tensor`` of every rank's shards rebuilds every leaf."""
    for rank in world22:
        assert rank[f"round_trip_{policy}"] == []


# --------------------------------------------------- (1, 2) and (2, 1) --


def test_launch_leaves_the_environment_as_it_was(worlds):
    """The ranks start with what ``launch`` sets for them (where this
    process had not set it); this process's environment is as it was
    before the launches, which ran at the same time from three
    threads."""
    for shape in SHAPES:
        for rank in worlds[shape].result():
            assert rank["env"] == {k: ENV_BEFORE.get(k, v)
                                   for k, v in RANK_ENV.items()}
    assert {k: os.environ.get(k) for k in RANK_ENV} \
        == {k: ENV_BEFORE.get(k) for k in RANK_ENV}


@pytest.mark.parametrize("shape", SHAPES[1:])
def test_other_mesh_shapes(worlds, reference, shape):
    ranks = worlds[shape].result()
    for rank in ranks:
        assert rank["greedy_serve_seq_kernel"] == reference["jax_greedy_seq"]
    assert len({r["pool_greedy_serve_seq_kernel"] for r in ranks}) == 1
