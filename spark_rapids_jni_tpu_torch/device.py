"""Where the port's tensors live.

Every constructor and entry point takes ``device=``, whose default is
``"cuda"``.  The CPU is used only when the caller asks for it; a request for
CUDA on a machine without a usable card raises rather than falling back.

CUDA's current device belongs to each host thread, and every new thread
starts on card 0.  So ``resolve`` gives a card its index (an index-less
``"cuda"`` names the calling thread's current card), and a thread that works
for a process bound to another card (a rank, ``parallel/ranks.py``) binds
that card before it touches CUDA (``bind``), as the reference binds the
executor's GPU on every JNI entry (``cudf::jni::auto_set_device``).
"""

from __future__ import annotations

import torch

DEFAULT = "cuda"


def resolve(device=DEFAULT) -> torch.device:
    """``device`` as a ``torch.device``, a card always with its index; raises
    when it names CUDA and this process has no CUDA card, or not that
    card."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch sees no CUDA card; "
            "pass device='cpu' to run on the host")
    if dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    n = torch.cuda.device_count()
    if dev.index >= n:
        raise RuntimeError(f"device {device!r} requested but this host has "
                           f"{n} CUDA card(s)")
    return dev


def bind(device) -> torch.device:
    """Make ``device`` (resolved) the calling thread's current CUDA device
    and return it; a CPU device needs nothing."""
    dev = resolve(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def cards_with_tensors() -> list:
    """The indices of the cards on which this process's caching allocator
    has held a tensor (its peak there is above 0): a rank's own card, and
    no other."""
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return []
    return [i for i in range(torch.cuda.device_count())
            if torch.cuda.max_memory_allocated(i) > 0]
