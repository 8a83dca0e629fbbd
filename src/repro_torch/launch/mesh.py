"""Device meshes of the port, as functions with no module-level state.

A torch process group's world size is fixed when it is set up, so each mesh
is a context manager that sets the group up, yields the ``DeviceMesh`` and
tears the group down again (nothing is touched at import).

* :func:`make_production_mesh` — the reference's production meshes, one pod
  (16, 16) ``("data", "model")`` or two (2, 16, 16) ``("pod", "data",
  "model")``, on torch's *fake* process group: a host-only mesh of 256 or
  512 ranks whose collectives move nothing, for the dry-run over meta
  tensors (:mod:`repro_torch.launch.dryrun`).
* :func:`make_host_mesh` — the devices that exist: an already set-up group's
  ranks, else a world of one (one card: 1 x 1), over NCCL on the card and
  gloo on the CPU.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional


@contextlib.contextmanager
def _group(backend: str, world_size: int, store) -> Iterator[None]:
    import torch.distributed as dist
    if dist.is_initialized():
        raise RuntimeError("a process group is already set up; a mesh of "
                           "this module sets up its own")
    dist.init_process_group(backend, rank=0, world_size=world_size,
                            store=store)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def make_production_mesh(*, multi_pod: bool = False):
    """One pod = 16 x 16 = 256 ranks, mesh (data=16, model=16); multi-pod =
    2 pods = 512 ranks, mesh (pod=2, data=16, model=16); on the fake
    process group (rank 0 of the world), CPU-typed: hold meta tensors on
    it."""
    from torch.distributed.device_mesh import init_device_mesh
    # torch has no public home for the fake group's store: it ships beside
    # the fake backend in its testing package (no test code runs from it)
    from torch.testing._internal.distributed.fake_pg import FakeStore
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = 1
    for n in shape:
        world *= n
    with _group("fake", world, FakeStore()):
        yield init_device_mesh("cpu", shape, mesh_dim_names=axes)


@contextlib.contextmanager
def make_host_mesh(model_parallel: int = 1, *, device: Optional[str] = None):
    """A ``(data, model)`` mesh over this host's ranks: those of a group the
    caller already set up (left up on exit), else a world of one set up
    here (``device`` ``cuda``, the default when a card is there, over
    NCCL; ``cpu`` over gloo) and torn down on exit."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    own = contextlib.nullcontext()
    if not dist.is_initialized():
        own = _group("nccl" if device == "cuda" else "gloo", 1,
                     dist.HashStore())
    with own:
        n = dist.get_world_size()
        if n % model_parallel:
            raise ValueError(f"{n} ranks do not split into model parallel "
                             f"groups of {model_parallel}")
        yield init_device_mesh(device, (n // model_parallel, model_parallel),
                               mesh_dim_names=("data", "model"))
