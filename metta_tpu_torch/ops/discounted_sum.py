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
:func:`scan_plan` is the kernel's plan for a [T, B] launch: the columns of a
block's tile, the chunks of time it walks and the stages of its ring.
"""

from __future__ import annotations

import ctypes

import torch

from metta_tpu_torch.ops.build import check_tensor

# Launches of the CUDA kernel (forward and backward), counted where it launches.
launches = 0

# The kernel's plan constants (``csrc/discounted_sum.cu``: kChunk, kStride,
# kMaxStages, kMinCols, kMaxCols, kLoaders)
CHUNK = 32              # time steps a stage of the ring holds
STRIDE = 36             # floats a column takes in a stage array (CHUNK and a pad)
MAX_STAGES = 8          # stages of the ring
MIN_COLS, MAX_COLS = 8, 32
LOADERS = 8             # loader warps beside the chain warp
SMS = 132               # an H100 SXM's SMs: the plan's default card


def discounted_sum_plain(x, decay):
    """The recurrence as a Python loop over T in torch ops (one multiply and
    one add a step, each rounded, as the kernel does)."""
    run = torch.zeros_like(x[0])
    outs = []
    for t in range(x.shape[0] - 1, -1, -1):
        run = x[t] + decay[t] * run
        outs.append(run)
    return torch.stack(outs[::-1]) if outs else torch.empty_like(x)


def scan_plan(T: int, B: int, sms: int = SMS):
    """The kernel's plan for [T, B] on a card of ``sms`` SMs (mirrors
    ``csrc/discounted_sum.cu``): tiles of ``cols`` columns (8, 16 or 32, the
    narrowest whose tiles do not outnumber what 8, 16 or 32 columns an SM
    give, so that the grid covers the SMs where B allows), ``blocks`` of them;
    ``chunks`` of ``CHUNK`` steps, walked in a ring of ``stages`` shared-memory
    stages (all of them in flight at T <= 256)."""
    cols = next((c for c in (MIN_COLS, 16) if B <= c * sms), MAX_COLS)
    chunks = -(-T // CHUNK)
    return dict(cols=cols, blocks=-(-B // cols), chunks=chunks,
                stages=min(chunks, MAX_STAGES))


def scan_smem_bytes(cols: int, stages: int, gdecay: bool) -> int:
    """Dynamic shared memory of a launch: a full and an empty mbarrier a stage,
    then the stages, each holding x, decay, (y,) out (and gdecay) transposed,
    ``STRIDE`` floats a column."""
    return 16 * stages + 4 * stages * (5 if gdecay else 3) * cols * STRIDE


_sms = {}


def _card_sms(device) -> int:
    if device not in _sms:
        _sms[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _sms[device]


_lib = None


def _library():
    global _lib
    if _lib is None:
        from metta_tpu_torch.ops.build import load_library

        lib = load_library("discounted_sum")
        lib.discounted_sum_launch.restype = ctypes.c_int
        lib.discounted_sum_launch.argtypes = (
            [ctypes.c_void_p] * 5                    # x decay out y gdecay
            + [ctypes.c_int] * 5                     # T B forward_in_time cols stages
            + [ctypes.c_void_p]                      # stream
        )
        lib.discounted_sum_shape.restype = ctypes.c_int
        lib.discounted_sum_shape.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
        _lib = lib
    return _lib


def launch_shape(T: int, B: int, forward_in_time: bool, gdecay: bool):
    """The CUDA kernel's launch shape for [T, B] on the current card: the
    plan's {cols, blocks, stages}, and {smem bytes, blocks an SM holds, SMs}
    (needs the card)."""
    plan = scan_plan(T, B, _card_sms(torch.cuda.current_device()))
    vals = [ctypes.c_int() for _ in range(3)]
    err = _library().discounted_sum_shape(int(forward_in_time), int(gdecay), plan["cols"],
                                          plan["stages"], *[ctypes.byref(v) for v in vals])
    if err != 0:
        raise RuntimeError(f"discounted_sum_shape failed: CUDA error {err}")
    return dict(cols=plan["cols"], blocks=plan["blocks"], stages=plan["stages"],
                **dict(zip(("smem", "per_sm", "sms"), (v.value for v in vals))))


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
    plan = scan_plan(T, B, _card_sms(x.device))
    with torch.cuda.device(x.device):
        err = lib.discounted_sum_launch(
            x.data_ptr(), decay.data_ptr(), out.data_ptr(),
            y.data_ptr() if y is not None else None,
            gdecay.data_ptr() if gdecay is not None else None,
            T, B, int(forward_in_time), plan["cols"], plan["stages"],
            torch.cuda.current_stream(x.device).cuda_stream,
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
