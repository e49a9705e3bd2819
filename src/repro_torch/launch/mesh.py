"""Production meshes.

``make_production_mesh`` is a FUNCTION (not a module constant) so importing
this module never touches process-group state. Neither function builds a
process group: the launcher (the dry-run on the ``"fake"`` backend, a
``torchrun`` job, a test's ``gloo`` ranks, the smoke's one ``nccl`` rank)
initialises ``torch.distributed`` first, with as many ranks as the mesh
has devices.
"""

from __future__ import annotations


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data",
    "model") with ``multi_pod``, over the current process group."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device, shape, mesh_dim_names=axes)


def make_host_mesh(device: str = "cuda"):
    """1×1 ("data", "model") mesh on the card (or the CPU when asked),
    over a one-rank process group — smoke-scale runs. On the card the
    rank's device is selected first, as the communicator expects."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if device == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(device, (1, 1), mesh_dim_names=("data", "model"))
