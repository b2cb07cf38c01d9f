"""The device a run uses, and what the result says of it."""

from __future__ import annotations


def sync(torch, device: str) -> None:
    if device.startswith("cuda"):
        torch.cuda.synchronize()


def reset_peak(torch, device: str) -> None:
    if device.startswith("cuda"):
        torch.cuda.reset_peak_memory_stats()


def peak_bytes(torch, device: str) -> int:
    return int(torch.cuda.max_memory_allocated()) \
        if device.startswith("cuda") else 0


def info(torch, device: str, memory_peak_bytes: int) -> dict:
    if device.startswith("cuda"):
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": 1, "memory_peak_bytes": int(memory_peak_bytes)}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}
