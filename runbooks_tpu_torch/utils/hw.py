"""Device resolution, H100 peak rates and backend-dependent serving
defaults (the port's counterpart of ``runbooks_tpu.utils.hw``)."""

from __future__ import annotations

from typing import Optional, Union

import torch

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit: the roofline
# ``bound_ms`` of a kernel is the larger of its bytes over HBM_BW and its
# operations over the peak for their type.
H100_PEAK_BF16_FLOPS = 989e12
H100_HBM_BW = 3.35e12             # bytes/s


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: the one the caller named, else
    the current CUDA device. With no device named and no GPU present this
    raises; it never falls back to the CPU on its own."""
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not "
                               "available")
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device found; pass device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def chip_peak_flops(device: Union[str, torch.device]) -> Optional[float]:
    """Dense bf16 peak FLOP/s of the device for MFU: the H100's on CUDA,
    None on the CPU (no MFU is reported there)."""
    return H100_PEAK_BF16_FLOPS if torch.device(device).type == "cuda" \
        else None


def backend_tuning(device: torch.device) -> dict:
    """Backend-dependent serving defaults, decided in one place.

    ``decode_chunk``: decode steps per host round-trip. 8 on CUDA, where a
    host sync per step would dominate small-batch inter-token latency; 1
    on the CPU, where tests want step-at-a-time."""
    on_cuda = torch.device(device).type == "cuda"
    return {"decode_chunk": 8 if on_cuda else 1}
