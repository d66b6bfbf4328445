"""Host-device copies of the evaluation surface: a pinned host-to-device
copy that does not wait for the stream, and a packed device-to-host copy of
several tensors that waits once."""

from __future__ import annotations

import numpy as np
import torch


def to_device(x: torch.Tensor, device) -> torch.Tensor:
    """A CPU tensor on ``device``; to a card through pinned memory without
    waiting for the stream (a plain ``.to`` from pageable memory
    synchronizes)."""
    device = torch.device(device)
    if device.type == "cpu":
        return x
    return x.pin_memory().to(device, non_blocking=True)


def to_host(tensors: dict) -> dict:
    """{name: numpy array} of ``tensors``, all on one device; from a card in
    one device-to-host copy (each tensor's bytes packed into one buffer),
    so the host waits for the stream once."""
    if not tensors or next(iter(tensors.values())).device.type == "cpu":
        return {k: t.numpy() for k, t in tensors.items()}
    parts = [t.contiguous().reshape(-1).view(torch.uint8) for t in tensors.values()]
    buf = torch.cat(parts).cpu().numpy()
    out, off = {}, 0
    for (k, t), p in zip(tensors.items(), parts):
        n = p.numel()
        dtype = torch.empty((), dtype=t.dtype).numpy().dtype
        out[k] = np.frombuffer(buf[off:off + n].tobytes(), dtype=dtype).reshape(t.shape)
        off += n
    return out
