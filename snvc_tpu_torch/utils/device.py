"""Device selection shared by the port's entry points."""

from __future__ import annotations

from typing import Union

import numpy as np
import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """Return ``torch.device(device)``; raise if CUDA is asked for and absent.

    The port runs on the card unless the caller asks for the CPU: a default
    ``"cuda"`` on a host without a GPU is an error, never a silent CPU run.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def compute_dtype(name: str) -> torch.dtype:
    """``VernierConfig.compute_dtype`` string -> torch dtype."""
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def to_device(a, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``device``.  To the card it goes from a
    pinned copy with ``non_blocking=True``, so the host does not wait for
    the work already queued (a copy from pageable memory would)."""
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def constant(values, device: torch.device,
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Small host numbers (a tuple or an array) as a ``dtype`` tensor on
    ``device``, through ``to_device``: ``torch.tensor(values,
    device="cuda")`` copies from pageable memory and so waits for all the
    work queued on the card."""
    return to_device(torch.as_tensor(np.asarray(values, np.float64))
                     .to(dtype), device)
