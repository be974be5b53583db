"""Production and debug meshes, as in ``repro.launch.mesh``.

The production targets are meshes of 256 and 512 devices: one pod of
16 x 16 with ``(data, model)`` axes, and 2 pods of 256 with a leading
``pod`` axis (the data-parallel dimension across pods).  They are larger
than any process group here, so ``make_production_mesh`` returns their
``MeshShape``, on which the sharding rules resolve without devices.
``make_debug_mesh`` returns a real ``DeviceMesh`` over the process group
the caller has set up.  Functions, not module constants: importing this
module touches no device and no process group.

The roofline constants are one NVIDIA H100 80GB HBM3 (SXM5) at its 700 W
power limit, from NVIDIA's datasheets:

* ``PEAK_FLOPS_BF16``: 989 TFLOP/s, dense BF16 on the tensor cores (the
  H100 SXM datasheet's 1,979 TFLOP/s is with 2:4 sparsity);
* ``HBM_BW``: 3.35 TB/s of HBM3 (the same datasheet);
* ``LINK_BW``: 50 GB/s, one 400 Gb/s NDR InfiniBand adapter per GPU, as in
  a DGX H100 (the DGX H100 datasheet's eight ConnectX-7 ports for eight
  GPUs).  Every axis of both production meshes (16 and 2 x 16 ranks)
  spans more than one 8-GPU NVLink node, so each ring of a collective
  crosses that link, and it bounds the ring; NVLink's 450 GB/s a direction
  inside a node would only shorten the hops that stay there.

They model the card; none is a timing of one.
"""
from __future__ import annotations

from repro_torch.dist.sharding import MeshShape

# NVIDIA H100 80GB HBM3 (SXM5, 700 W) roofline constants, per GPU
PEAK_FLOPS_BF16 = 989e12      # FLOP/s, dense BF16 tensor cores
HBM_BW = 3.35e12              # B/s, HBM3
LINK_BW = 50e9                # B/s, one 400 Gb/s NDR adapter a GPU


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
