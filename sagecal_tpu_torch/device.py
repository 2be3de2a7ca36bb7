"""Device resolution and the numeric precision settings of the port.

Entry points run on ``cuda`` unless the caller asks for the CPU
(``device="cpu"``, or ``--platform cpu`` on the CLI). Without a CUDA
device and without that request they raise: a calibration run never
carries on silently on the CPU.

On the card the pipeline computes in float32 (the JAX package's TPU
dtype); on the CPU it computes in float64 (the JAX package's dtype under
the tests' x64 mode). A reduced ``--dtype-policy`` (bf16, f16) pairs with
float32 on both (``pipeline.py``, ``dtypes.py``).
"""

from __future__ import annotations

import torch

_PRECISION_SET = False


def _set_precision() -> None:
    """Pin float32 matrix products and convolutions to full float32.

    PyTorch's default lets cuDNN convolutions run in TF32 (about three
    decimal digits); the calibration solves need every float32 bit, so
    both switches are set off explicitly, once, here."""
    global _PRECISION_SET
    if _PRECISION_SET:
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _PRECISION_SET = True


def resolve(device=None, index: int | None = None) -> torch.device:
    """``None``/"cuda" -> the CUDA device (raises without one);
    "cpu" -> the CPU. Any other torch device string is passed through.
    ``index`` (a process's rank) picks card ``index % device_count`` when
    the device is a card without an index of its own."""
    _set_precision()
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (or "
            "--platform cpu) to run on the CPU")
    if dev.type == "cuda" and dev.index is None and index is not None:
        dev = torch.device("cuda", int(index) % torch.cuda.device_count())
    return dev


def real_dtype(device: torch.device) -> torch.dtype:
    """float32 on the card, float64 on the CPU."""
    return torch.float32 if device.type == "cuda" else torch.float64


def complex_dtype(real: torch.dtype) -> torch.dtype:
    return torch.complex64 if real == torch.float32 else torch.complex128
