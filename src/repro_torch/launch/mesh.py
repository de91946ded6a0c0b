"""Meshes of ranks over ``torch.distributed`` (port of
``repro.launch.mesh``).

The reference lays a (data, model) grid over the devices of one JAX
process.  Here every mesh position is a process (a rank) of one
``torch.distributed`` world: rank r sits at the row-major coordinates of
r in ``shape`` — for (data, model), data index r // mp and model index
r % mp — and holds one process group per axis, over the ranks that share
its other coordinates (the ranks it reduces or gathers with along that
axis).

    make_mesh(shape, axes)               this rank's Mesh (the world must
                                         be up, of size prod(shape))
    launch(fn, shape, ...)               spawn prod(shape) ranks, run
                                         fn(mesh, *args) in each, return
                                         their results in rank order
    choose_backend(world, device)        'nccl' or 'gloo'

A ``Mesh`` built by hand without groups (``Mesh(axes, shape)``) is a
geometry only: ``nn.sharding.make_rules`` reads nothing else, so tests
can ask for the rules of a (16, 16) mesh with one process.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import os
import pickle
import shutil
import tempfile
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

AXES = ("data", "model")


@dataclasses.dataclass
class Mesh:
    """One rank's view of a mesh: the axes, their sizes, its coordinates
    and a process group per axis and one for the whole mesh, 'world'
    (none for a geometry-only mesh or a one-process world)."""
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    coords: Tuple[int, ...] = ()
    groups: Dict[str, Any] = dataclasses.field(default_factory=dict)
    rank: int = 0
    device: torch.device = torch.device("cpu")

    def __post_init__(self):
        self.axis_names = tuple(self.axis_names)
        self.shape = tuple(int(n) for n in self.shape)
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"axes {self.axis_names} / shape {self.shape} "
                             f"rank mismatch")
        if not self.coords:
            self.coords = (0,) * len(self.shape)
        # per-step collective bytes (nn.collectives adds to it)
        self.collective_bytes = 0

    @property
    def sizes(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    def size(self, axis: str) -> int:
        return self.sizes.get(axis, 1)

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (0 for an absent axis)."""
        if axis not in self.axis_names:
            return 0
        return self.coords[self.axis_names.index(axis)]

    def group(self, axis: Optional[str]):
        """The process group of ``axis``; None: the mesh's whole world."""
        return self.groups.get("world" if axis is None else axis)

    @property
    def world(self) -> int:
        return math.prod(self.shape)


def coords_of(rank: int, shape: Sequence[int]) -> Tuple[int, ...]:
    """Row-major coordinates of ``rank`` in ``shape``."""
    out = []
    for n in reversed(shape):
        out.append(rank % n)
        rank //= n
    return tuple(reversed(out))


def _rank_of(coords: Sequence[int], shape: Sequence[int]) -> int:
    r = 0
    for c, n in zip(coords, shape):
        r = r * n + c
    return r


def make_mesh(shape, axes=AXES, device=None) -> Mesh:
    """This rank's mesh over the running ``torch.distributed`` world,
    which must hold prod(shape) ranks (a one-rank mesh needs no world).
    Every rank creates every axis group, in the same order, as
    ``new_group`` requires; each keeps its own."""
    import torch.distributed as dist

    shape = tuple(int(n) for n in shape)
    world = math.prod(shape)
    device = torch.device(device) if device is not None \
        else torch.device("cpu")
    if not dist.is_available() or not dist.is_initialized():
        if world != 1:
            raise RuntimeError(f"a {shape} mesh needs a torch.distributed "
                               f"world of {world} ranks: start the ranks "
                               f"with launch()")
        return Mesh(tuple(axes), shape, device=device)
    if dist.get_world_size() != world:
        raise RuntimeError(f"mesh {shape} needs {world} ranks, the world "
                           f"has {dist.get_world_size()}")
    rank = dist.get_rank()
    coords = coords_of(rank, shape)
    # a group of its own for the whole mesh, so that several meshes over
    # one world never share a group (each may run in a thread of its own)
    groups = {"world": dist.new_group(list(range(world)))}
    for i, axis in enumerate(axes):
        others = [range(n) for j, n in enumerate(shape) if j != i]
        for rest in itertools.product(*others):
            members = []
            for k in range(shape[i]):
                c = list(rest)
                c.insert(i, k)
                members.append(_rank_of(c, shape))
            g = dist.new_group(members)
            if rank in members:
                groups[axis] = g
    return Mesh(tuple(axes), shape, coords, groups, rank, device)


def choose_backend(world: int, device: str = "cuda") -> str:
    """'nccl' when every rank has a CUDA device of its own; 'gloo' when
    ranks share a device (NCCL refuses two ranks on one) and always on
    the CPU."""
    if torch.device(device).type != "cuda":
        return "gloo"
    return "nccl" if torch.cuda.device_count() >= world else "gloo"


def _rank_main(rank: int, shape, axes, backend: str, device: str,
               tmp: str) -> None:
    import torch.distributed as dist

    with open(os.path.join(tmp, "call.pkl"), "rb") as f:
        fn, args = pickle.load(f)
    world = math.prod(shape)
    dev = torch.device("cpu")
    if torch.device(device).type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        # the ranks share the host's cores: no rank's intra-op pool may
        # take them all (they would spin against each other)
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world, **kw)
    try:
        mesh = make_mesh(shape, axes, device=dev)
        out = fn(mesh, *args)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


# launch() sets the ranks' environment while it starts them: one launch
# at a time may do so (launches may run in threads of one process)
_START = threading.Lock()


def _rank_env(device: str) -> Dict[str, str]:
    """What the ranks' environment adds, read by the ranks as they start:
    gloo binds the address of the host's name unless told an interface,
    and every rank is local; CPU ranks share the host's cores, and an
    intra-op thread that spins while it waits takes a core from another
    rank."""
    env = {"GLOO_SOCKET_IFNAME": "lo"}
    if torch.device(device).type != "cuda":
        env["OMP_WAIT_POLICY"] = "PASSIVE"
    return {k: v for k, v in env.items() if k not in os.environ}


def launch(fn: Callable, shape, *, args: tuple = (), axes=AXES,
           device: str = "cuda", log=print) -> List[Any]:
    """Run ``fn(mesh, *args)`` in prod(``shape``) new ranks, one process
    each (start method 'spawn': CUDA forbids 'fork'), rank r on
    ``cuda:{r % device_count}`` (or the CPU), over the backend
    :func:`choose_backend` picks (logged), and return the ranks' results
    in rank order.  The ranks meet on a ``FileStore`` in a new temporary
    directory (no port is opened).  ``fn`` and ``args`` must pickle (a
    module-level function).  A rank that raises makes this raise
    (``torch.multiprocessing.ProcessRaisedException``, with the rank's
    traceback) once the others are stopped.  This process's environment
    is left as it was."""
    import torch.multiprocessing as mp

    shape = tuple(int(n) for n in shape)
    world = math.prod(shape)
    backend = choose_backend(world, device)
    log(f"[mesh] {'x'.join(map(str, shape))} over {backend}: {world} "
        f"ranks, "
        + (f"{torch.cuda.device_count()} CUDA device(s)"
           if torch.device(device).type == "cuda" else "CPU"))
    tmp = tempfile.mkdtemp(prefix="repro_torch_mesh_")
    try:
        # the call goes through a file: a large argument written to a
        # child's pipe would hold each start until that child has read it
        with open(os.path.join(tmp, "call.pkl"), "wb") as f:
            pickle.dump((fn, args), f)
        with _START:
            env = _rank_env(device)
            os.environ.update(env)
            try:
                ctx = mp.start_processes(
                    _rank_main, nprocs=world, join=False,
                    start_method="spawn",
                    args=(shape, tuple(axes), backend, device, tmp))
            finally:
                for k in env:
                    del os.environ[k]
        while not ctx.join():
            pass
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
