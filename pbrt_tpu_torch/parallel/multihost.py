"""Process groups, meshes and local worlds (counterpart of
``pbrt_tpu/parallel/multihost.py``).

The reference wires hosts into one JAX runtime with
``jax.distributed.initialize``; here every mesh device is one process in
a ``torch.distributed`` process group, and a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the group's ranks, with
the reference's axis names (``dp`` pixel shards, ``sp`` sample shards,
``tp`` geometry shards).  Sampling is a pure function of (pixel, sample,
dimension), so no rank ever needs another's random state.

Typical use (the same script on every process, launched by ``torchrun``)::

    initialize_multihost()              # reads torchrun's variables
    mesh = global_mesh(sp=2)            # spans every rank of the world
    ShardedRenderer(Renderer(desc, opt), mesh).render()

:func:`run_local_world` spawns a world of processes on one host (the
counterpart of the reference's ``--xla_force_host_platform_device_count``
virtual devices): tests use it with ``gloo`` on the CPU, ``chip_smoke.py``
with ``gloo`` ranks sharing one card or ``nccl``.  Its workers are
functions of this package, so a spawned rank imports nothing else.
"""

from __future__ import annotations

import datetime
import logging
import os
import queue as queue_mod
import tempfile
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from pbrt_tpu_torch import require_device

log = logging.getLogger("pbrt_tpu_torch")

AXES = ("dp", "sp", "tp")

# the device this process computes on in its world, set when it joins one
# (initialize_multihost, or a rank of run_local_world)
_world_device = None


def default_backend(device_type: str = "cuda") -> str:
    """``nccl`` for the card, ``gloo`` for the CPU."""
    return "nccl" if device_type == "cuda" else "gloo"


def initialize_multihost(backend=None, init_method=None, world_size=None, rank=None,
                         device="cuda") -> bool:
    """Join this process to the world's process group -> True, or False
    for a single process (no group is made).

    Given nothing, it reads torchrun's ``WORLD_SIZE`` and ``RANK`` (and
    ``MASTER_ADDR`` / ``MASTER_PORT`` through the ``env://`` method).
    ``device`` is the one this process computes on (the card unless
    given; raises without one); ``backend`` defaults to
    :func:`default_backend` of its type and is never swapped for another
    when it fails: the failure raises.  Safe to call again once the group
    exists (True)."""
    global _world_device
    if dist.is_initialized():
        return dist.get_world_size() > 1
    world_size = int(world_size if world_size is not None
                     else os.environ.get("WORLD_SIZE", "1"))
    if world_size <= 1:
        return False
    rank = int(rank if rank is not None else os.environ["RANK"])
    device = require_device(device)
    backend = backend or default_backend(device.type)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    _world_device = device
    log.info("process group: rank %d/%d (%s, %s)", rank, world_size, backend, device)
    return True


def mesh_device_type() -> str:
    """The device type of this process's mesh: that of the device it
    joined its world with, else the card (raises without one)."""
    return (_world_device or require_device("cuda")).type


def global_mesh(dp=None, sp: int = 1, tp=None, device_type=None):
    """A DeviceMesh over every rank of the world, dp-major: axes ("dp",
    "sp"), or ("dp", "sp", "tp") when ``tp`` is given; ``dp`` None takes
    what the world leaves."""
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    inner = sp * (tp or 1)
    dp = dp or n // inner
    if dp * inner != n:
        raise ValueError(f"mesh dp={dp} sp={sp} tp={tp} does not cover the world's {n} ranks")
    shape, names = ((dp, sp), AXES[:2]) if tp is None else ((dp, sp, tp), AXES)
    return init_device_mesh(device_type or mesh_device_type(), shape, mesh_dim_names=names)


def axis(mesh, name):
    """(process group, size, this rank's index) of the mesh axis ``name``."""
    size = mesh.shape[mesh.mesh_dim_names.index(name)]
    return mesh.get_group(name), size, mesh.get_local_rank(name)


def all_reduce_mesh(tensors: dict, mesh) -> dict:
    """{name: tensor} summed over every axis of ``mesh`` in turn (the
    reference's psum over all axes), as one all-reduce of their
    concatenation an axis (in the widest of their floats) -> {name: sum},
    shapes and dtypes kept."""
    keys = list(tensors)
    flat = torch.cat([tensors[k].reshape(-1) for k in keys])
    for name in mesh.mesh_dim_names:
        group, size, _ = axis(mesh, name)
        if size > 1:
            dist.all_reduce(flat, group=group)
    out, at = {}, 0
    for k in keys:
        n = tensors[k].numel()
        out[k] = flat[at:at + n].reshape(tensors[k].shape).to(tensors[k].dtype)
        at += n
    return out


def process_local_slice(n_lanes: int) -> slice:
    """The rows of a dp-sharded lane batch this process provides: with the
    dp-major meshes of :func:`global_mesh`, rank p of P feeds lanes [p n /
    P, (p + 1) n / P) (``n_lanes`` divisible by P; one process: all)."""
    p = dist.get_rank() if dist.is_initialized() else 0
    n_proc = dist.get_world_size() if dist.is_initialized() else 1
    per = n_lanes // n_proc
    return slice(p * per, (p + 1) * per)


# ---------------------------------------------------------------------------
# Local worlds
# ---------------------------------------------------------------------------


def _rank_main(fn, rank, world_size, backend, device, init_method, timeout_s, results,
               args):
    """One spawned rank: join the group, run ``fn(rank, world_size,
    device, *args)``, report (rank, ok, result or traceback)."""
    global _world_device
    _world_device = torch.device(device)
    torch.set_num_threads(1)
    if str(device).startswith("cuda"):
        torch.cuda.set_device(rank % torch.cuda.device_count())
    try:
        dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                                rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
        try:
            results.put((rank, True, fn(rank, world_size, device, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 -- reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def run_local_world(fn, world_size: int, backend=None, device="cuda", init_file=None,
                    timeout_s: float = 120.0, args=()):
    """Spawn ``world_size`` ranks of ``fn`` on this host and return their
    results, by rank.

    ``device`` is the card unless given (raises without one);
    ``backend`` defaults to :func:`default_backend` of its type.  Each
    rank is a fresh process (start method ``spawn``) with one CPU
    thread, joined to a ``backend`` group through a ``file://`` store at
    ``init_file`` (a new file in the temporary directory unless given, so
    worlds started side by side never share a port), and runs
    ``fn(rank, world_size, device, *args)``; ``fn`` must be importable by
    name.  A rank that raises, or a world that has not finished after
    ``timeout_s`` seconds, fails the call (RuntimeError) and every rank
    still running is killed."""
    device = require_device(device)
    backend = backend or default_backend(device.type)
    device = str(device)
    ctx = torch.multiprocessing.get_context("spawn")
    own_file = init_file is None
    if own_file:
        fd, init_file = tempfile.mkstemp(prefix="pbrt_world_")
        os.close(fd)
        os.unlink(init_file)  # the store creates it
    init_method = "file://" + str(Path(init_file).resolve())
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world_size, backend, device, init_method, timeout_s,
                               results, tuple(args)))
             for r in range(world_size)]
    deadline = time.monotonic() + timeout_s
    out = {}
    try:
        for p in procs:
            p.start()
        while len(out) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise RuntimeError(f"local world of {world_size} ({backend}) missed its "
                                   f"{timeout_s:.0f} s deadline; ranks done: {sorted(out)}")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} of a local world exited with code "
                                       f"{procs[dead[0]].exitcode} before reporting")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of a local world of {world_size} "
                                   f"({backend}) raised:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        if own_file and os.path.exists(init_file):
            os.unlink(init_file)
    return [out[r] for r in range(world_size)]
