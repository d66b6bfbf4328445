"""Reverse discounted sum over time: CUDA kernel with its gradient, and its
plain version.

Counterpart of ``metta_tpu/ops/discounted_sum.py`` (the Pallas kernel
``_kernel`` behind ``discounted_sum_reverse``). Over time-major [T, B]
float32 arrays::

    out[t] = x[t] + decay[t] * out[t+1]        (t = T-1 .. 0, out[T] = 0)

:func:`discounted_sum` is the wrapper. A CUDA tensor goes through
:class:`DiscountedSum`, whose forward and backward both launch the kernel of
``csrc/discounted_sum.cu`` (the backward runs it forward in time:
``gx[t] = g[t] + decay[t-1]·gx[t-1]``, and ``gdecay[t] = gx[t]·out[t+1]``
where ``decay`` requires grad); a CPU tensor takes
:func:`discounted_sum_plain`, the same recurrence in torch ops, which autograd
differentiates. There is no 128-lane rule: any T and any B.
"""

from __future__ import annotations

import ctypes

import torch

from metta_tpu_torch.ops.build import check_tensor

# Launches of the CUDA kernel (forward and backward), counted where it launches.
launches = 0


def discounted_sum_plain(x, decay):
    """The recurrence as a Python loop over T in torch ops (one multiply and
    one add a step, each rounded, as the kernel does)."""
    run = torch.zeros_like(x[0])
    outs = []
    for t in range(x.shape[0] - 1, -1, -1):
        run = x[t] + decay[t] * run
        outs.append(run)
    return torch.stack(outs[::-1]) if outs else torch.empty_like(x)


_lib = None


def _library():
    global _lib
    if _lib is None:
        from metta_tpu_torch.ops.build import load_library

        lib = load_library("discounted_sum")
        lib.discounted_sum_launch.restype = ctypes.c_int
        lib.discounted_sum_launch.argtypes = (
            [ctypes.c_void_p] * 5                    # x decay out y gdecay
            + [ctypes.c_int] * 3                     # T B forward_in_time
            + [ctypes.c_void_p]                      # stream
        )
        _lib = lib
    return _lib


def launch_discounted_sum(x, decay, forward_in_time: bool = False, y=None):
    """One launch of the kernel on CUDA tensors -> out (and gdecay if ``y``,
    the reverse pass's output, is given; forward in time only)."""
    global launches
    T, B = x.shape if x.dim() == 2 else (-1, -1)
    for name, t in (("x", x), ("decay", decay)) + ((("y", y),) if y is not None else ()):
        check_tensor(name, t, torch.float32, (T, B), x.device)
    if y is not None and not forward_in_time:
        raise ValueError("gdecay is computed forward in time only")
    out = torch.empty_like(x)
    gdecay = torch.empty_like(x) if y is not None else None
    if T == 0 or B == 0:
        return out, gdecay
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.discounted_sum_launch(
            x.data_ptr(), decay.data_ptr(), out.data_ptr(),
            y.data_ptr() if y is not None else None,
            gdecay.data_ptr() if gdecay is not None else None,
            T, B, int(forward_in_time), torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"discounted_sum kernel launch failed: CUDA error {err}")
    launches += 1
    return out, gdecay


class DiscountedSum(torch.autograd.Function):
    """The kernel reverse in time; its backward is the kernel forward in time."""

    @staticmethod
    def forward(ctx, x, decay):
        out, _ = launch_discounted_sum(x, decay)
        ctx.save_for_backward(decay, out)
        return out

    @staticmethod
    def backward(ctx, g):
        decay, out = ctx.saved_tensors
        want_gdecay = ctx.needs_input_grad[1]
        gx, gdecay = launch_discounted_sum(g.contiguous(), decay, forward_in_time=True,
                                           y=out if want_gdecay else None)
        return gx, gdecay


def discounted_sum(x, decay):
    """``out[t] = x[t] + decay[t]·out[t+1]`` over [T, B] float32: the CUDA
    kernel (differentiable) for CUDA tensors, the plain version for CPU
    tensors."""
    if x.device.type == "cpu":
        return discounted_sum_plain(x, decay)
    return DiscountedSum.apply(x, decay)
