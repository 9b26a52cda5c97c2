"""The port's hardware spec: one NVIDIA H100.

``H100`` fills the reference's ``HardwareSpec`` fields from NVIDIA's H100
SXM data sheet (dense rates, 700 W). ``vmem_bytes`` — the per-block budget
the kernel fit tests read — is the largest shared memory one block may opt
into on Hopper, 232,448 bytes (227 KB). An H100 PCIe card has fewer SMs, a
lower memory rate and lower peaks than the SXM part, and any card may run
below its 700 W limit, so :func:`probe` reads what the present card reports
and ``chip_smoke.py`` prints it beside these figures.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.config import HardwareSpec

H100 = HardwareSpec(
    name="h100-sxm",
    peak_flops=989e12,          # bf16 dense, H100 SXM data sheet
    hbm_bandwidth=3.35e12,      # HBM3, H100 SXM data sheet
    ici_bandwidth=450e9,        # NVLink 4, per direction, H100 SXM data sheet
    hbm_bytes=80 * 10**9,       # H100 SXM data sheet
    vmem_bytes=232_448,         # opt-in shared memory per block (sm_90)
    mxu_dim=64,                 # rows of one warpgroup MMA (wgmma m64)
)

# dense float32 rate outside the tensor cores, H100 SXM data sheet
H100_FP32_FLOPS = 67e12


def probe(device: int = 0) -> Dict[str, Any]:
    """What the present card reports: name, SM count, opt-in shared memory
    per block and device memory. Raises when no CUDA device is present."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: cannot probe the card")
    props = torch.cuda.get_device_properties(device)
    return {
        "name": props.name,
        "sm_count": props.multi_processor_count,
        "smem_per_block_optin": getattr(props, "shared_memory_per_block_optin",
                                        None),
        "total_memory": props.total_memory,
        "capability": f"{props.major}.{props.minor}",
    }
