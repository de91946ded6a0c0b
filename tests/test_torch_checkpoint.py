"""bf16 checkpoint leaves between the port and the JAX package: the port
stores them as the JAX package's ``np.savez`` stores its ml_dtypes
leaves (2-byte voids), so ``repro.checkpoint.store`` restores a port
checkpoint with the dtype and the bytes of its own.  The port's older
form (``uint16`` bit patterns) is held in ``tests/test_torch_train.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointStore as JStore
from repro_torch.checkpoint import CheckpointStore as TStore


def _values(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((3, 5)).astype(np.float32),
            "layers": [rng.standard_normal(4).astype(np.float32)
                       for _ in range(2)],
            "bias": rng.standard_normal(7).astype(np.float32)}


def _trees(vals):
    """The same bf16 values as a JAX tree (the layers stacked, its
    scanned layout) and as a port tree (a list of layers)."""
    jtree = {"w": jnp.asarray(vals["w"], jnp.bfloat16),
             "layers": {"b": jnp.asarray(np.stack(vals["layers"]),
                                         jnp.bfloat16)},
             "bias": jnp.asarray(vals["bias"], jnp.bfloat16)}
    ttree = {"w": torch.from_numpy(vals["w"]).to(torch.bfloat16),
             "layers": [{"b": torch.from_numpy(v).to(torch.bfloat16)}
                        for v in vals["layers"]],
             "bias": torch.from_numpy(vals["bias"]).to(torch.bfloat16)}
    return jtree, ttree


@pytest.mark.parametrize("seed", [0, 1])
def test_jax_reads_port_bf16_leaves_as_its_own(tmp_path, seed):
    jtree, ttree = _trees(_values(seed))
    TStore(str(tmp_path / "port")).save(2, ttree)
    JStore(str(tmp_path / "jax")).save(2, jtree)
    template = {k: np.asarray(v) if not isinstance(v, dict)
                else {"b": np.asarray(v["b"])} for k, v in jtree.items()}
    got, _ = JStore(str(tmp_path / "port")).restore(2, template)
    own, _ = JStore(str(tmp_path / "jax")).restore(2, template)
    for path in (("w",), ("layers", "b"), ("bias",)):
        a, b = got, own
        for k in path:
            a, b = a[k], b[k]
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype == np.dtype("V2"), path
        assert a.shape == b.shape and a.tobytes() == b.tobytes(), path
    # and the port reads the JAX package's file as its own
    back, _ = TStore(str(tmp_path / "jax")).restore(2, ttree)
    assert back["w"].dtype == torch.bfloat16
    assert torch.equal(back["layers"][1]["b"], ttree["layers"][1]["b"])
