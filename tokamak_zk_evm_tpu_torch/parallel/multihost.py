"""Process groups from the environment, and the meshes over them.

Every process runs the same program (SPMD) and drives one device.  Launch
either with torchrun (one process a card; it sets RANK, WORLD_SIZE,
LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR and MASTER_PORT):

    torchrun --nproc-per-node 4 my_prove.py

or by hand with the JAX package's variables, one process each:

    TZK_COORDINATOR=host0:1234 TZK_NUM_PROCESSES=2 TZK_PROCESS_ID=0 \\
        python my_prove.py

where the script calls `init_from_env()` and proves inside
`context.use_mesh(global_mesh())`.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from .mesh import hosts, make_mesh, make_mesh_2d


def init_from_env(device=None) -> bool:
    """`init_process_group` from TZK_COORDINATOR / TZK_NUM_PROCESSES /
    TZK_PROCESS_ID, or else torchrun's RANK / WORLD_SIZE (MASTER_ADDR /
    MASTER_PORT); a no-op when neither is set or a group exists.  The
    backend goes with `device` (default: this rank's card, cuda:LOCAL_RANK):
    NCCL for CUDA, gloo for the CPU.  Returns True when more than one
    process takes part."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if env.get("TZK_COORDINATOR"):
        init = f"tcp://{env['TZK_COORDINATOR']}"
        world, rank = int(env["TZK_NUM_PROCESSES"]), int(env["TZK_PROCESS_ID"])
    elif "RANK" in env and "WORLD_SIZE" in env:
        init, world, rank = "env://", int(env["WORLD_SIZE"]), int(env["RANK"])
    else:
        return False
    if device is None:
        local = env.get("LOCAL_RANK")
        device = f"cuda:{local}" if local is not None else "cuda"
    dev = resolve_device(device)
    if dev.index is not None:
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method=init,
                            world_size=world, rank=rank)
    return world > 1


def global_mesh(two_d: bool | None = None, device=None):
    """The whole group's mesh: 1-D over every rank, or with `two_d`
    (default: when the group spans more than one host) the (hosts x chips)
    mesh.  One torch process drives one card where one JAX process drives
    a host, so the hosts are the world size over LOCAL_WORLD_SIZE."""
    if two_d is None:
        two_d = hosts() > 1
    return make_mesh_2d(device=device) if two_d else make_mesh(device=device)
