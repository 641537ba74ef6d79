"""Production mesh builders on a ``torch.distributed`` ``DeviceMesh`` (the
port of ``repro.launch.mesh``).

Functions, not module-level constants: importing this module touches no
process group and no device (the dry run starts its own fake group first).

Single pod : (16, 16)      axes ("data", "model")          — 256 cards
Multi-pod  : (2, 16, 16)   axes ("pod", "data", "model")   — 512 cards

Each builder needs the default process group to be up, with as many ranks
as the mesh has cards (``torch.distributed.init_process_group``; the dry
run's is a fake one). :func:`mesh_axes` reads a mesh's axis sizes, and also
takes a stand-in with a ``shape`` mapping of axis name → size, as the
sharding rules' tests do.
"""

from __future__ import annotations

from typing import Dict

__all__ = ["make_production_mesh", "make_host_mesh", "batch_axes",
           "mesh_axes", "HW"]


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(model: int = 1, device_type: str = "cuda"):
    """A ("data", "model") mesh over every rank of the default group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    model = min(model, n)
    return init_device_mesh(device_type, (n // model, model),
                            mesh_dim_names=("data", "model"))


def mesh_axes(mesh) -> Dict[str, int]:
    """Axis name → size, in the mesh's order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def batch_axes(mesh) -> tuple:
    """Axes the global batch is sharded over."""
    return ("pod", "data") if "pod" in mesh_axes(mesh) else ("data",)


class HW:
    """NVIDIA H100 SXM5 80 GB constants for the roofline, per card, at the
    full 700 W power limit (NVIDIA's H100 data sheet; dense rates, without
    sparsity). A card set to a lower limit runs slower under load."""
    PEAK_BF16_FLOPS = 989e12        # FLOP/s, tensor cores
    PEAK_F32_FLOPS = 67e12          # FLOP/s, outside the tensor cores
    HBM_BW = 3.35e12                # B/s
    NVLINK_BW = 450e9               # B/s each way, to the host's other cards
    HBM_BYTES = 80e9                # 80 GB
