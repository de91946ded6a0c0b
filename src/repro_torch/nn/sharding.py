"""Logical-axis -> mesh-axis rules (MaxText-style), spec utilities and one
rank's view of a sharded step (port of ``repro.nn.sharding``).

Mesh axes ('data', 'model'); see ``launch.mesh``.  Logical axes of the
model zoo's weights and activations:

  'batch'    activation batch                -> DP over 'data'
  'embed'    d_model dim of weights          -> FSDP over 'data' [train]
  'vocab'    embedding-table / logits vocab  -> 'model'
  'heads'    attention heads                 -> 'model'
  'kv_heads' kv heads (GQA)                  -> 'model' when divisible else None
  'mlp'      ffn hidden                      -> 'model'
  'experts'  MoE expert dim                  -> 'model'  (expert parallelism)
  'q_lora'/'kv_lora'  MLA latent dims        -> None (small, replicated)
  'layers'   scan dim of stacked weights     -> None
  'seq'      sequence dim of activations     -> None

A spec is a tuple with one entry per dimension: None (replicated), a
mesh axis, or a tuple of mesh axes (the first the major one), as JAX's
``PartitionSpec``.  Where JAX places a leaf with ``NamedSharding``, the
port keeps this rank's slice (:func:`shard_tensor`); :func:`gather_tensor`
is the inverse.  :class:`Shard` is what a sharded step consults: the
rules, this rank's batch rows, and the collectives its layers run.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from . import collectives as coll
from . import module as nnm

Rules = Dict[str, Any]
MODES = ("train", "serve", "serve_2dtp", "dp", "tp")


def make_rules(mesh, *, mode: str = "train", cfg=None) -> Rules:
    """Sharding policy.

    mode='train'      FSDP (weights' embed dim over DP axes, ZeRO-3) + TP
                      over 'model' — the throughput-optimal policy when
                      every step touches all weights with large batches.
    mode='serve'      same layout (baseline; weights are re-gathered every
                      step).
    mode='serve_2dtp' NO data-axis dim on any weight's contracting-with-x
                      dim; instead weights are 2D-sharded over ('model' x
                      'data') on head/expert/ffn and lora dims, so they
                      stay RESIDENT and per-step collectives are
                      activation-sized.
    mode='dp'         pure data-parallel: replicate weights, shard batch
                      only.
    mode='tp'         TP without FSDP: the model-axis sharding of 'train'
                      without the per-layer weight re-gathers.

    ``cfg`` (a ModelConfig) enables divisibility adjustment: any logical
    axis whose dimension does not divide by its mesh axis size falls back
    to replication (e.g. gemma3's 4 heads or granite's MQA kv=1 cannot
    shard over a 16-way 'model' axis)."""
    if mode not in MODES:
        raise ValueError(f"unknown sharding mode {mode!r}; expected {MODES}")
    axes = mesh.axis_names
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    dp_axes = tuple(a for a in ("pod", "data") if a in axes)
    dp: Any = dp_axes if len(dp_axes) > 1 else dp_axes[0]
    model_size = sizes.get("model", 1)
    rules: Rules = {
        "batch": dp,
        "embed": dp,  # ZeRO-3 / FSDP weight sharding
        "vocab": "model",
        "heads": "model",
        "kv_heads": "model",
        "mlp": "model",
        "experts": "model",
        "q_lora": None,
        "kv_lora": None,
        "layers": None,
        "seq": None,
        "act_embed": None,   # activation d_model dim
        "act_heads": "model",
        "cache_seq": None,   # 'model' for serve_2dtp distributed decode
        "expert_mlp": None,
    }
    if mode == "dp":
        rules.update({"embed": None, "vocab": None, "heads": None,
                      "kv_heads": None, "mlp": None, "experts": None,
                      "act_heads": None})
        return rules
    if mode == "tp":
        rules["embed"] = None
    if mode == "serve_2dtp":
        data_ax = "data" if "data" in axes else None
        rules.update({
            "embed": None,                 # weights resident, not FSDP
            "q_lora": data_ax,             # MLA q path 2D: lora x heads
            "expert_mlp": data_ax,         # MoE experts 2D: E x F
            "mlp": (("model",) + ((data_ax,) if data_ax else ()))
            if cfg is None or not cfg.n_experts else "model",
            "cache_seq": "model",          # distributed flash-decode
        })
    if cfg is not None:
        def rule_size(axis):
            r = rules[axis]
            names = r if isinstance(r, tuple) else (r,) if r else ()
            n = 1
            for a in names:
                n *= sizes.get(a, 1)
            return n

        def fallback(axis, dim, downgrade=None):
            if rules[axis] and dim % rule_size(axis) != 0:
                rules[axis] = downgrade

        fallback("embed", cfg.d_model)
        fallback("vocab", cfg.vocab)
        fallback("heads", cfg.n_heads)
        fallback("kv_heads", cfg.n_kv_heads)
        if rules["heads"] is None:
            rules["act_heads"] = None
        mlp_dims = [d for d in (cfg.d_ff, cfg.d_inner if cfg.family in
                                ("hybrid", "ssm") else 0,
                                cfg.first_dense_d_ff,
                                cfg.n_shared_experts * cfg.moe_d_ff) if d]
        for d in mlp_dims:
            fallback("mlp", d, "model" if isinstance(rules["mlp"], tuple)
                     and d % model_size == 0 else None)
        if cfg.n_experts:
            fallback("experts", cfg.n_experts)
        if cfg.q_lora_rank:
            fallback("q_lora", cfg.q_lora_rank)
        if cfg.moe_d_ff:
            fallback("expert_mlp", cfg.moe_d_ff)
    return rules


def spec(axes: Tuple[Optional[str], ...], rules: Rules) -> tuple:
    return tuple(rules.get(a) if a is not None else None for a in axes)


def param_specs(defs, rules: Rules):
    """Spec tree for a P-def tree."""
    return nnm.map_defs(lambda _, p: spec(p.axes, rules), defs)


def _names(entry, mesh) -> Tuple[str, ...]:
    """The mesh axes of one spec entry (major first), those the mesh
    has."""
    names = entry if isinstance(entry, tuple) else (entry,) if entry else ()
    return tuple(a for a in names if a in mesh.axis_names)


def shard_tensor(t: torch.Tensor, entries: tuple, mesh) -> torch.Tensor:
    """This rank's slice of the full tensor ``t`` under the spec
    ``entries`` (one per dimension): the counterpart of placing ``t``
    with a ``NamedSharding``."""
    if len(entries) != t.dim():
        raise ValueError(f"spec {entries} for a {t.dim()}-d tensor")
    whole = t
    for dim, entry in enumerate(entries):
        names = _names(entry, mesh)
        n = math.prod(mesh.size(a) for a in names)
        if n == 1:
            continue
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not "
                             f"divide over {names} ({n})")
        idx = 0
        for a in names:
            idx = idx * mesh.size(a) + mesh.index(a)
        k = t.shape[dim] // n
        t = t.narrow(dim, idx * k, k)
    # a slice of the major dim is contiguous already: copy it all the
    # same, or the shard would keep the whole leaf's storage alive
    return t.contiguous() if t is whole \
        else t.clone(memory_format=torch.contiguous_format)


def gather_tensor(t: torch.Tensor, entries: tuple, mesh) -> torch.Tensor:
    """Inverse of :func:`shard_tensor`: all-gather every dimension the
    spec shards, over each of its mesh axes (the minor one first)."""
    for dim, entry in enumerate(entries):
        for a in reversed(_names(entry, mesh)):
            t = coll.all_gather(t, mesh, a, dim)
    return t


class Shard:
    """One rank's part in a paged step of ``cfg`` sharded by ``policy``
    over ``mesh``: batch rows over 'data' (this rank's are :meth:`rows`),
    weight dimensions by the policy's rules.  ``axes`` is the model's
    tree of logical axes (its weights' ``P.axes``), which :meth:`local`
    walks.  A dimension on 'model' stays this rank's part (heads, the
    vocab, the FFN hidden dim, experts), and the layers reduce their
    partial outputs over 'model'.  FSDP's 'embed' on 'data' (under
    'serve') is gathered before use, as the reference re-gathers it every
    step (:meth:`local`).  The dimensions 'serve_2dtp' puts on 'data'
    ('q_lora', 'expert_mlp' and the data part of 'mlp') stay resident:
    the layers that contract them gather the tokens over 'data' instead
    and sum over 'data' as well (:meth:`spans`), as the reference's
    2D-sharded expert bank does."""

    def __init__(self, mesh, policy: str, cfg, axes):
        bad = set(mesh.axis_names) - {"data", "model"}
        if bad:
            raise NotImplementedError(f"mesh axes {sorted(bad)}: the port "
                                      f"shards over ('data', 'model')")
        self.mesh = mesh
        self.policy = policy
        self.rules = make_rules(mesh, mode=policy, cfg=cfg)
        self.axes = axes
        self.dp = mesh.size("data")

    def _on(self, logical: str, axis: str) -> bool:
        return axis in _names(self.rules.get(logical), self.mesh) \
            and self.mesh.size(axis) > 1

    def splits(self, logical: str) -> bool:
        """Whether the rules put ``logical`` on a 'model' axis of more
        than one rank (then a layer holds this rank's part of it)."""
        return self._on(logical, "model")

    def spans(self, logical: str) -> bool:
        """Whether the rules put ``logical`` on a 'data' axis of more than
        one rank."""
        return self._on(logical, "data")

    def part(self, logical: str, n_local: int) -> int:
        """Offset of this rank's part (``n_local`` long) of a
        'model'-split dimension ``logical``."""
        return self.mesh.index("model") * n_local if self.splits(logical) \
            else 0

    def rows(self, n: int) -> Tuple[int, int]:
        """[lo, hi) of this DP shard's rows of an n-row batch."""
        if n % self.dp:
            raise ValueError(f"a batch of {n} rows does not divide over "
                             f"{self.dp} DP shards: pad it (the engine "
                             f"pads max_batch to a DP multiple)")
        k = n // self.dp
        i = self.mesh.index("data")
        return i * k, (i + 1) * k

    def local_rows(self, t):
        lo, hi = self.rows(t.shape[0])
        return t[lo:hi]

    def gather_rows(self, *ts):
        """Every DP shard's rows of each of ``ts``, in order (the whole
        batch), in one collective."""
        out = coll.all_gather_many(ts, self.mesh, "data", [0] * len(ts))
        return out[0] if len(ts) == 1 else tuple(out)

    def reduce(self, t, *logicals):
        """Sum the partial results of a layer over the mesh axes that the
        rules put any of ``logicals`` on (a no-op where they put none)."""
        axes = {a for name in logicals for a in ("model", "data")
                if self._on(name, a)}
        if not axes:
            return t
        return coll.all_reduce_sum(t, self.mesh,
                                   axes.pop() if len(axes) == 1 else None)

    def local(self, params, axes, logical: Tuple[str, ...] = ("embed",)):
        """``params`` with every dimension of a ``logical`` axis that the
        rules put on 'data' gathered, all leaves in one collective; other
        parts stay.  ``axes`` is the matching subtree of :attr:`axes`;
        leaves it lacks (the absorbed ``w_absorb``, split over heads
        only) are kept.  The default gathers FSDP's 'embed'."""
        if not any(self.spans(name) for name in logical):
            return params
        todo = []                   # (container, key, leaf, dim) to gather

        def copy(node, ax):
            """``node``'s containers copied; the leaves to gather noted."""
            out = dict(node) if isinstance(node, dict) else list(node)
            keys = node.keys() if isinstance(node, dict) else range(len(node))
            for k in keys:
                if isinstance(node, dict) and k not in ax:
                    continue
                v = node[k]
                if not isinstance(v, torch.Tensor):
                    out[k] = copy(v, ax[k])
                    continue
                for dim, name in enumerate(ax[k]):
                    if name in logical and self.spans(name):
                        todo.append((out, k, v, dim))
            return out

        out = copy(params, axes)
        got = coll.all_gather_many([t for *_, t, _ in todo], self.mesh,
                                   "data", [d for *_, d in todo])
        for (box, k, _, _), t in zip(todo, got):
            box[k] = t
        return out
