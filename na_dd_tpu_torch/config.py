"""Device and dtype selection.

float64 is the default, as ``setup_x64`` makes it in the JAX package: the
parity gate (≤1e-8 relative on the study errors) needs f64 accumulation, and
the H100 runs f64 natively.  float32 is taken on request.  Nothing here reads
the environment.
"""

from __future__ import annotations

import torch

DEFAULT_DTYPE = torch.float64
SUPPORTED_DTYPES = (torch.float64, torch.float32)


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the CUDA card.

    There is no silent CPU fallback: with no card and no explicit device this
    raises, so a run that was meant for the GPU never quietly runs on the CPU.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def resolve_dtype(dtype=None) -> torch.dtype:
    """``dtype`` checked against float64/float32; None means float64."""
    if dtype is None:
        return DEFAULT_DTYPE
    if dtype not in SUPPORTED_DTYPES:
        raise ValueError(f"dtype must be torch.float64 or torch.float32; got {dtype!r}")
    return dtype
