"""Checkpointing: npz store with async save and keep-k GC (port of
``repro.checkpoint.store``, without elastic re-sharding).

Layout, the reference's own, so that an f32 checkpoint written by either
package restores in the other:

    <dir>/step_<n>/arrays.npz   flat {path -> array}, '/' in keys as '__'
    <dir>/step_<n>/meta.json    {step, data_state, meta, bf16, done}

``done`` is written last: a crash mid-save leaves a directory without it,
which ``steps`` skips.  A list in the tree (the port's per-layer
``period`` list, whisper's ``encoder`` and ``decoder``) is stored
stacked along a new leading axis, which is the JAX package's scanned
layout.  numpy has no bfloat16 (the reference relies on ml_dtypes): the
JAX package's ``np.savez`` of its ml_dtypes bf16 leaves stores them as
2-byte voids (``|V2``), and so does the port — the leaves' bit patterns
viewed as ``V2`` — so a bf16
checkpoint written by either package restores in the other with the
same dtype and bytes.  The bf16 keys are also listed under ``bf16`` in
meta.json; a leaf read back as ``|V2``, or listed there (older
checkpoints of the port stored bf16 leaves as ``uint16``), is read as
bf16.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

# how np.savez stores an ml_dtypes bfloat16 leaf of the JAX package
BF16_STORED = np.dtype("V2")


def _to_numpy(t) -> Tuple[np.ndarray, bool]:
    # a copy: the training step updates the live tensors in place while
    # an async save is still writing
    t = torch.as_tensor(t).detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16_STORED), True
    return t.numpy(), False


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """{path: leaf}; a list's elements are flattened alike and stacked."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        parts = [_flatten(v, prefix) for v in tree]
        return {k: [p[k] for p in parts] for k in (parts[0] if parts else {})}
    return {prefix: tree}


def _stack(leaf) -> Tuple[np.ndarray, bool]:
    if isinstance(leaf, list):
        arrs = [_stack(v) for v in leaf]
        return np.stack([a for a, _ in arrs]), arrs[0][1]
    return _to_numpy(leaf)


def _unflatten_into(flat: Dict[str, np.ndarray], template, bf16: set):
    """Rebuild ``template``'s structure from the flat dict as CPU tensors
    (a list in the template takes its elements from the leading axis)."""
    def leaf(key, index):
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key}")
        a = flat[key][index] if index else flat[key]
        a = np.array(a)           # contiguous, writable, shape kept
        if key in bf16 or (a.dtype.kind == "V" and a.dtype.itemsize == 2):
            return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(a)

    def build(node, prefix, index):
        if isinstance(node, dict):
            return {k: build(v, f"{prefix}/{k}", index)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v, prefix, index + (i,))
                              for i, v in enumerate(node))
        return leaf(prefix, index)

    return build(template, "", ())


class CheckpointStore:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    def save(self, step: int, tree, *, data_state: Optional[dict] = None,
             meta: Optional[dict] = None, blocking: bool = True) -> None:
        """Copy the tree to host memory now, then write step_<n>;
        ``blocking=False`` writes on a background thread, so the next
        training steps overlap the serialization."""
        flat, bf16 = {}, []
        for k, v in _flatten(tree).items():
            flat[k], is_bf16 = _stack(v)
            if is_bf16:
                bf16.append(k)
        payload = {"step": int(step), "data_state": data_state or {},
                   "meta": meta or {}, "bf16": bf16}

        def write():
            d = os.path.join(self.dir, f"step_{step:08d}")
            tmp = d + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            np.savez(os.path.join(tmp, "arrays.npz"),
                     **{k.lstrip("/").replace("/", "__"): v
                        for k, v in flat.items()})
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump({**payload, "done": True}, f)
            if os.path.exists(d):
                shutil.rmtree(d)
            os.replace(tmp, d)
            self._gc()

        self.wait()
        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if not m:
                continue
            try:
                with open(os.path.join(self.dir, name, "meta.json")) as f:
                    if json.load(f).get("done"):
                        out.append(int(m.group(1)))
            except (OSError, json.JSONDecodeError):
                continue      # partial save (crash mid-write): skip
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: int, template) -> Tuple[Any, dict]:
        """Load step_<n> into ``template``'s structure: (tree of CPU
        tensors, meta dict)."""
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        with np.load(os.path.join(d, "arrays.npz")) as zf:
            flat = {"/" + k.replace("__", "/"): zf[k] for k in zf.files}
        return _unflatten_into(flat, template, set(meta.get("bf16", []))), meta
