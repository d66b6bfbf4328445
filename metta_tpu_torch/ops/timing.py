"""Device timing and bounds of the port's kernels on an H100.

:func:`cuda_time_ms` times a callable between CUDA events; :func:`bound_of`
turns the bytes and operations a function needs into the least time the
card could take (NVIDIA's H100 SXM data sheet rates below).
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (NVIDIA data sheet)
# H100 SXM int32 rate outside the tensor cores: half the data sheet's 67 T/s
# float32 rate (64 int32 lanes per SM against 128 float32 lanes), counted alike
INT32_OPS_PER_S = 33.5e12
F32_OPS_PER_S = 67e12          # H100 SXM float32 rate outside the tensor cores
BF16_TC_FLOPS_PER_S = 989e12   # H100 SXM dense bf16 tensor-core rate
RATES = {"int32": INT32_OPS_PER_S, "f32": F32_OPS_PER_S, "bf16": BF16_TC_FLOPS_PER_S}


def cuda_time_ms(fn, reps: int, queue_ahead: bool = True) -> float:
    """Milliseconds per call of ``fn`` between CUDA events around ``reps``
    calls. With ``queue_ahead`` the stream first spins for about 0.25 s, so
    the host queues the calls while the device is busy and the events time
    the device's work alone; without it a wrapper whose host side outlasts its
    kernel is timed at the host's pace."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if queue_ahead:
        torch.cuda._sleep(500_000_000)                 # clock cycles
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_of(nbytes, ops, kind: str = "int32"):
    """(bound ms, what binds, ops ms): ``nbytes`` at 3.35 TB/s against
    ``ops`` operations of type ``kind`` at its peak rate (``RATES``)."""
    bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / RATES[kind]
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations"), ops_ms
