"""Production and debug meshes, as in ``repro.launch.mesh``.

The production targets are meshes of 256 and 512 devices: one pod of
16 x 16 with ``(data, model)`` axes, and 2 pods of 256 with a leading
``pod`` axis (the data-parallel dimension across pods).  They are larger
than any process group here, so ``make_production_mesh`` returns their
``MeshShape``, on which the sharding rules resolve without devices.
``make_debug_mesh`` returns a real ``DeviceMesh`` over the process group
the caller has set up.  Functions, not module constants: importing this
module touches no device and no process group.
"""
from __future__ import annotations

from repro_torch.dist.sharding import MeshShape


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    if multi_pod:
        return MeshShape((2, 16, 16), ("pod", "data", "model"))
    return MeshShape((16, 16), ("data", "model"))


def make_debug_mesh(data: int = 2, model: int = 2, pods: int = 0, device=None):
    """A ``DeviceMesh`` of ``(pods,) data x model`` over the initialized
    default process group, whose world size must be the mesh's size.  Its
    devices are CUDA unless ``device`` says otherwise (``"cpu"`` for a
    gloo world on the CPU), as ``repro_torch.devices.resolve_device`` rules."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.devices import resolve_device

    device_type = resolve_device(device).type
    if pods:
        return init_device_mesh(device_type, (pods, data, model),
                                mesh_dim_names=("pod", "data", "model"))
    return init_device_mesh(device_type, (data, model), mesh_dim_names=("data", "model"))
