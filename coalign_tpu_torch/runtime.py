"""Device selection and float settings shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    Raises RuntimeError when no device is named and no GPU is present, so
    nothing quietly carries on on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def configure_cuda():
    """Set the process-wide float and convolution policy of the port on CUDA.

    * Full float32: cuDNN convolutions and CUDA matmuls default to TF32
      (about three decimal digits); the parity with the JAX package and the
      reference recordings, and every number in PERF.md, are full float32.
    * cuDNN autotuning: the input shapes of a served model are fixed, so
      cuDNN times its convolution algorithms once per shape instead of
      taking its heuristic's pick, which in full float32 is a far slower
      FFT convolution for the flagship's trunk (PERF.md).

    These settings hold for the whole process; make_infer_fn calls this on
    CUDA."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = True


def lowp_call(fn, *args):
    """``fn`` (a conv or a product) of tensors, in their dtype. On the CPU a
    bfloat16 call computes its bfloat16 operands in float64 and rounds the
    result once to bfloat16: the JAX package's XLA convolutions and products
    and cuDNN's (on the card) accumulate bfloat16 in float32 and round once,
    where oneDNN's bfloat16 kernels on the CPU round otherwise; float64
    leaves only XLA's float32 summation order between the two packages."""
    x = args[0]
    if x.dtype == torch.bfloat16 and x.device.type == "cpu":
        return fn(*(None if a is None else a.double() for a in args)).to(
            torch.bfloat16)
    return fn(*args)
