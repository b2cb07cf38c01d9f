"""Where the port's tensors live.

Every constructor and entry point takes ``device=``, whose default is
``"cuda"``.  The CPU is used only when the caller asks for it; a request for
CUDA on a machine without a usable card raises rather than falling back.
"""

from __future__ import annotations

import torch

DEFAULT = "cuda"


def resolve(device=DEFAULT) -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and this
    process has no CUDA card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch sees no CUDA card; "
            "pass device='cpu' to run on the host")
    return dev
