"""Production mesh construction (the torch counterpart of
``repro.launch.mesh``).

Functions, never module constants, so importing this module touches no
process group: the dry run joins its fake world first
(``repro_torch.launch.hostdev.fake_world``), and a real run its group.
A mesh is a ``DeviceMesh`` over the first ranks of the default group
(all of them when the sizes agree; a fake world of 512 holds both
production meshes), on ``"cuda"`` by default and ``"cpu"`` when asked
(the tests).
"""
from __future__ import annotations


def _mesh(shape, axes, device: str):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if device not in ("cuda", "cpu"):
        raise ValueError(f"a mesh lives on cuda or cpu, not {device!r}")
    n = 1
    for d in shape:
        n *= d
    if n > dist.get_world_size():
        raise ValueError(f"a {tuple(shape)} mesh needs {n} ranks, the world "
                         f"has {dist.get_world_size()}")
    return DeviceMesh(device, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """Single pod: 16x16 = 256 ranks ("data", "model").
    Multi-pod: 2 pods x 256 = 512 ranks ("pod", "data", "model")."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_host_mesh(data: int = 1, model: int = 1, device: str = "cuda"):
    """A small ("data", "model") mesh (tests, one card)."""
    return _mesh((data, model), ("data", "model"), device)
