"""Shared inputs of the repro_torch parity tests: JAX-layout parameter
trees drawn with numpy, so both packages get the same weights without
paying for the JAX package's per-shape random-init compiles."""
import math

import jax
import numpy as np

from repro.nn import module as jnnm


def np_params(defs, seed: int):
    """Numpy leaves for a JAX ``P`` tree, drawn with the JAX init's
    distributions (normal 0.02, embed 1.0, fan-in over all but the last
    dim, ones, zeros; ``scale`` overrides the std)."""
    rng = np.random.default_rng(seed)

    def draw(_, p):
        if p.init == "zeros":
            return np.zeros(p.shape, np.float32)
        if p.init == "ones":
            return np.ones(p.shape, np.float32)
        std = p.scale if p.scale is not None else {
            "normal": 0.02, "embed": 1.0,
        }.get(p.init, max(1, math.prod(p.shape[:-1])) ** -0.5)
        return (rng.standard_normal(p.shape) * std).astype(np.float32)

    return jnnm.map_defs(draw, defs)


def to_jax(tree):
    return jax.tree.map(jax.numpy.asarray, tree)
