"""Kernels of the port: each wrapper launches its CUDA kernel on a CUDA
tensor and runs its plain PyTorch twin on a CPU tensor.

``host_any`` is the host loops' one way to read a device flag;
``host_syncs`` counts those reads (each one waits for the device)."""
import torch

host_syncs = 0


def host_any(mask: torch.Tensor) -> bool:
    """``bool(mask.any())``, counted in ``host_syncs``."""
    global host_syncs
    host_syncs += 1
    return bool(mask.any())
