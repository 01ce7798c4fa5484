"""Process meshes over torch.distributed, and the collectives of the dist ops.

The JAX package's mesh is an array of devices that one controller drives
(GSPMD).  Here each rank is a process that drives one device and runs the
whole prover (SPMD); a `Mesh` holds the process group, its shape and axis
names (`("chips",)`, or `("hosts", "chips")`), this process's rank in it
and its device.  The dist ops work over the flattened mesh, hosts first
(`compute_axes`), as the JAX package's do.

The backend goes with the device: NCCL between cards, gloo on the CPU
(`multihost.init_from_env`).  A gloo group may also carry CUDA tensors
(several ranks sharing one card): gloo's collectives run on host memory, so
`Mesh.all_to_all` / `all_gather` stage such tensors through it, chosen by
the group's backend, and count the bytes in `COUNTS["staged_bytes"]`.

`COUNTS` also counts the calls of `bintt_dist` and `msm_dist`, as the
kernel wrappers count launches, so that a run can show that the sharded
path ran.
"""

from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

AXIS = "chips"
DCN_AXIS = "hosts"

COUNTS = {"bintt_dist": 0, "msm_dist": 0, "staged_bytes": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def counts() -> dict[str, int]:
    return dict(COUNTS)


class Mesh:
    """The ranks of `group` (None: the default group) as a mesh of `shape`
    named `axis_names`; `rank` is this process's rank in it, `device` the
    device its tensors live on."""

    def __init__(self, group, shape: tuple, axis_names: tuple, rank: int, device):
        self.group = group
        self.shape = tuple(shape)
        self.axis_names = tuple(axis_names)
        self.rank = rank
        self.device = torch.device(device)
        self.backend = dist.get_backend(group)
        if self.backend == "nccl" and self.device.type != "cuda":
            raise ValueError(f"an NCCL mesh needs CUDA tensors, not {self.device}")

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def _to_wire(self, t: torch.Tensor) -> torch.Tensor:
        """`t` where the backend takes it: host memory for gloo (counted
        when it comes from a card), the mesh's device for NCCL."""
        if self.backend != "gloo":
            return t.to(self.device).contiguous()
        if t.device.type != "cpu":
            COUNTS["staged_bytes"] += t.numel() * t.element_size()
        return t.cpu().contiguous()

    def _from_wire(self, t: torch.Tensor, device) -> torch.Tensor:
        if t.device != device and self.backend == "gloo":
            COUNTS["staged_bytes"] += t.numel() * t.element_size()
        return t.to(device)

    def all_to_all(self, send: torch.Tensor) -> torch.Tensor:
        """send [size, ...] -> recv [size, ...]: recv[j] is rank j's
        send[rank], on send's device."""
        w = self._to_wire(send)
        recv = torch.empty_like(w)
        dist.all_to_all_single(recv, w, group=self.group)
        return self._from_wire(recv, send.device)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """t -> [size, *t.shape]: every rank's t in rank order, on t's device."""
        w = self._to_wire(t)
        parts = [torch.empty_like(w) for _ in range(self.size)]
        dist.all_gather(parts, w, group=self.group)
        return self._from_wire(torch.stack(parts), t.device)

    def same_everywhere(self, data: bytes) -> bool:
        """True when every rank passed the same bytes (of one length)."""
        mine = torch.frombuffer(bytearray(data), dtype=torch.uint8)
        got = self.all_gather(mine)
        return bool((got == got[:1]).all())


def _device(device) -> torch.device:
    """The rank's device: `device`, or cuda:LOCAL_RANK (torchrun), or
    cuda:(rank % cards); raises without a card unless the caller names
    the CPU."""
    if device is not None:
        return resolve_device(device)
    local = os.environ.get("LOCAL_RANK")
    idx = int(local) if local is not None else dist.get_rank() % max(1, torch.cuda.device_count())
    return resolve_device(f"cuda:{idx}")


def _require_group() -> None:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call multihost.init_from_env() or "
                           "torch.distributed.init_process_group first")


def _mesh(shape: tuple, axis_names: tuple, device):
    world, n = dist.get_world_size(), math.prod(shape)
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} ranks does not fit a group of {world}")
    # new_group is collective: every rank of the default group calls it
    group = None if n == world else dist.new_group(list(range(n)))
    if dist.get_rank() >= n:
        return None
    return Mesh(group, shape, axis_names, dist.get_rank(), _device(device))


def hosts() -> int:
    """Hosts of the default group: one torch process drives one card, so
    the world size over LOCAL_WORLD_SIZE (torchrun's ranks a host; the
    whole world when unset)."""
    _require_group()
    world = dist.get_world_size()
    return max(1, world // int(os.environ.get("LOCAL_WORLD_SIZE", world)))


def make_mesh(n_devices: int | None = None, device=None) -> Mesh | None:
    """1-D mesh ("chips",) over the first `n_devices` ranks of the default
    group (all of them by default).  Every rank of the group must call it;
    a rank outside the first n gets None."""
    _require_group()
    n = dist.get_world_size() if n_devices is None else n_devices
    return _mesh((n,), (AXIS,), device)


def make_mesh_2d(n_hosts: int | None = None, per_host: int | None = None,
                 device=None) -> Mesh | None:
    """2-D (hosts x chips) mesh over the same ranks, hosts first (the outer
    axis crosses host boundaries); on one host a logical 2-D mesh that
    exercises the same code path."""
    _require_group()
    n_hosts = hosts() if n_hosts is None else n_hosts
    per_host = dist.get_world_size() // n_hosts if per_host is None else per_host
    return _mesh((n_hosts, per_host), (DCN_AXIS, AXIS), device)


def compute_axes(mesh) -> tuple:
    """Every mesh axis, outer (hosts) first: the dist ops run over all of
    them, flattened in rank order."""
    return tuple(mesh.axis_names)


def mesh_size(mesh) -> int:
    return mesh.size


def _block(mesh, n: int, what: str) -> slice:
    if n % mesh.size:
        raise ValueError(f"{what} {n} does not divide by the mesh size {mesh.size}")
    k = n // mesh.size
    return slice(mesh.rank * k, (mesh.rank + 1) * k)


def row_slice(mesh, x_size: int) -> slice:
    """This rank's rows of the X axis of a limb-major [16, x, y] grid
    (`bintt_dist`'s input)."""
    return _block(mesh, x_size, "x_size")


def col_slice(mesh, n: int) -> slice:
    """This rank's block of `n` columns: the Y axis of a grid, or the
    points of an MSM."""
    return _block(mesh, n, "the column count")
