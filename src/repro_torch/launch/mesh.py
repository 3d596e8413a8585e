"""Device meshes over ``torch.distributed`` (the reference's
``launch/mesh.py`` and ``compat.make_mesh``).

The reference is single-controller: one JAX process drives every device of
a ``jax.sharding.Mesh``.  The port runs one process per rank, so a mesh is
built by every rank, collectively, over a process group the caller has
initialised (``torch.distributed.init_process_group``: its address, world
size and rank are the caller's to give).  Ranks are laid out row-major over
the mesh's shape, as ``jax.make_mesh`` lays out device ids: rank ``r`` sits
at ``numpy.unravel_index(r, shape)``.

``Mesh`` keeps the reference's interface where the parallel code reads it
(``shape`` maps each axis name to its extent, ``axis_names``) and adds what
one rank needs: its coordinates, the ``torch.distributed`` process group of
every set of axes (built once here, by every rank in the same order, as
``new_group`` requires), and the ``DeviceMesh`` with the same axis names.
"""
from __future__ import annotations

import itertools
import os
import socket

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_mesh", "make_production_mesh"]


class Mesh:
    """One rank's view of a device mesh (build it with ``make_mesh``)."""

    def __init__(self, shape: tuple[int, ...], axis_names: tuple[str, ...], device: torch.device,
                 device_mesh, groups: dict, backend: str):
        self.shape = dict(zip(axis_names, shape))  # axis name -> extent, as jax's Mesh.shape
        self.axis_names = tuple(axis_names)
        self.device = device
        self.device_mesh = device_mesh
        self.backend = backend
        self.rank = dist.get_rank()
        self.coords = dict(zip(axis_names, (int(c) for c in np.unravel_index(self.rank, shape))))
        self._groups = groups

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, device={self.device}, backend={self.backend!r})"

    def extent(self, axes) -> int:
        """The number of ranks along ``axes`` (a name or a tuple of names)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return int(np.prod([self.shape[a] for a in axes])) if axes else 1

    def index(self, axes) -> int:
        """This rank's row-major index over ``axes``, in the order given (the
        block index the reference's ``axis_index`` arithmetic gives)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, axes):
        """The process group of the ranks that share this rank's coordinates
        on every axis not in ``axes``: a collective over it reduces or
        gathers along ``axes``."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        key = frozenset(axes)
        if key not in self._groups:
            raise KeyError(f"axes {axes} are not axes of {self.axis_names}")
        return self._groups[key]


def _device_identity(device: torch.device) -> tuple:
    if device.type == "cuda":
        props = torch.cuda.get_device_properties(device)
        return socket.gethostname(), str(getattr(props, "uuid", device.index))
    return socket.gethostname(), device.type, os.getpid()


def _world_timeout(backend: str):
    """The default process group's timeout (what the caller gave
    ``init_process_group``).  Raises where torch does not expose it: the
    mesh's groups would otherwise take torch's 30-minute default, and a
    fault on one rank would hang the others that long.  The ``"fake"``
    backend (the dry run's) waits for nothing: None, the default."""
    if backend == "fake":
        return None
    try:
        pg = dist.distributed_c10d._get_default_group()
        return pg._get_backend(torch.device("cuda" if backend == "nccl" else "cpu")).options._timeout
    except (AttributeError, RuntimeError) as e:
        raise RuntimeError(f"make_mesh cannot read the default process group's timeout from this torch "
                           f"({torch.__version__}): {e!r}") from e


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *, device="cuda") -> Mesh:
    """Build the mesh ``shape`` with axis names ``axes`` over the default
    process group; every rank calls it, with the same arguments.

    Every group of the mesh takes the default group's timeout (what the
    caller gave ``init_process_group``), so a collective that a rank never
    joins fails every waiting rank at that timeout; ``new_group`` alone
    would give torch's 30-minute default.

    The world size must equal the product of ``shape``.  ``device`` is where
    this rank's tensors live (``"cuda"``: the current card).  NCCL with two
    ranks on one card is refused with a ``ValueError`` (NCCL's own error
    there is "Duplicate GPU detected" at the first collective): such ranks
    take the gloo backend, which the caller asks for by name."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group (torch.distributed.init_process_group)")
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes) or len(set(axes)) != len(axes):
        raise ValueError(f"mesh shape {shape} and axis names {axes} do not pair up")
    world = dist.get_world_size()
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh {dict(zip(axes, shape))} holds {int(np.prod(shape))} ranks, the world {world}")
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh(device='cuda') needs a CUDA device (device='cpu' runs on the host)")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    backend = str(dist.get_backend())
    timeout = _world_timeout(backend)
    if backend == "nccl" and world > 1:
        probe = dist.new_group(backend="gloo")
        ids = [None] * world
        dist.all_gather_object(ids, _device_identity(device), group=probe)
        dist.destroy_process_group(probe)
        if len(set(ids)) < world:
            raise ValueError(f"backend 'nccl' needs one card per rank, and {world} ranks share "
                             f"{len(set(ids))} card(s): initialise the process group with backend 'gloo' to run "
                             "several ranks on one card")
    from torch.distributed.device_mesh import init_device_mesh

    device_mesh = init_device_mesh(device.type, shape, mesh_dim_names=axes)
    # one group per set of axes, created by every rank in the same order;
    # a group's ranks ascend, which is the row-major order over its axes
    ranks = np.arange(world).reshape(shape)
    me = np.unravel_index(dist.get_rank(), shape)
    groups: dict = {}
    for n in range(1, len(axes) + 1):
        for sub in itertools.combinations(range(len(axes)), n):
            if n == len(axes):
                groups[frozenset(axes)] = dist.group.WORLD
                continue
            rest = [d for d in range(len(axes)) if d not in sub]
            moved = np.moveaxis(ranks, rest, list(range(len(rest))))
            for fixed in itertools.product(*(range(shape[d]) for d in rest)):
                members = sorted(int(r) for r in moved[fixed].reshape(-1))
                g = dist.new_group(members, timeout=timeout)
                if all(me[d] == f for d, f in zip(rest, fixed)):
                    groups[frozenset(axes[d] for d in sub)] = g
    return Mesh(shape, axes, device, device_mesh, groups, backend)


def make_production_mesh(*, multi_pod: bool = False) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """The reference's production mesh as (shape, axis names): 16x16
    ("data", "model") for one pod of 256 chips, 2x16x16 ("pod", "data",
    "model") for two.  ``make_mesh(*make_production_mesh())`` builds it in
    a world of that many ranks."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")

