"""Storage / accumulate dtype policy (port of ``sagecal_tpu/dtypes.py``).

- **storage** (``bf16``/``f16``): the [B]-row data (``x8``, the
  sqrt-weights ``wt``, the residual streams) and the Wirtinger factors
  MA/MB take the policy dtype the moment they are made;
- **accumulation** is float32: every Gram product, matvec, JTe, cost and
  norm. Where the JAX package names a float32 accumulator on a
  contraction (``preferred_element_type``, its ``pet``), the port upcasts
  each storage operand to float32 first (:func:`pet`): a product of two
  bf16 values (8-bit mantissas) or two f16 values (11-bit) is exact in
  float32, so only the order of the float32 sums can differ. A PyTorch
  contraction or ``sum`` of bf16 operands returns bf16, so none runs on
  them;
- never reduced: the Jones matrices (complex64), the dense JTJ and its
  factors, the coherencies (complex64), uvw and the fringe phases, and
  the robust nu root-find (float64).

The ``"f32"`` policy is the identity: its storage dtype is the pipeline's
real dtype (float32 on the card, float64 on the CPU) and every helper
here returns its input unchanged, so default runs are bit for bit what
they were without the policy. A reduced policy pairs with the float32
pipeline on the CPU too (``pipeline.py``). Both packages round to bf16 and
f16 to nearest even, so data quantize identically in both.
"""

from __future__ import annotations

import numpy as np
import torch

#: user-facing policy names (``--dtype-policy``)
POLICIES = ("f32", "bf16", "f16")

_REDUCED = {
    "bf16": torch.bfloat16,
    "f16": torch.float16,
}


def validate(policy: str) -> str:
    if policy not in POLICIES:
        raise ValueError(
            f"unknown dtype policy {policy!r}; choose from {POLICIES}")
    return policy


def storage_dtype(policy: str, default=torch.float32):
    """Storage dtype of ``policy``; ``"f32"`` maps to ``default`` (the
    pipeline real dtype, float64 on the CPU)."""
    validate(policy)
    return _REDUCED.get(policy, default)


def is_reduced(dtype) -> bool:
    """True for the sub-float32 storage dtypes (bf16, f16)."""
    return dtype in (torch.bfloat16, torch.float16)


def acc_dtype(dtype):
    """Accumulator dtype paired with storage ``dtype``: float32 for
    reduced storage, the dtype itself otherwise."""
    return torch.float32 if is_reduced(dtype) else dtype


def acc(x):
    """``x`` upcast to its accumulator dtype at the point of reduction;
    ``x`` itself when it is not reduced."""
    return x.float() if is_reduced(x.dtype) else x


def pet(*xs):
    """The operands of a contraction over storage arrays, each upcast to
    float32 (the place of the JAX package's ``preferred_element_type``):
    returns the tuple, each operand unchanged when it is not reduced."""
    return tuple(acc(x) for x in xs)


def to_storage(x, dtype):
    """``x`` in the storage dtype ``dtype``; ``x`` itself when ``dtype``
    is not reduced (so the f32 policy costs the default path nothing)."""
    if not is_reduced(dtype):
        return x
    return x.to(dtype)


def storage_tensor(a, policy: str, default=torch.float32, device="cpu"):
    """Host data staged as a tensor of ``policy``'s storage dtype on
    ``device`` (the place of the JAX package's ``storage_np``: numpy has
    no bf16 without ``ml_dtypes``). Values pass through float32 on the
    way to a reduced dtype, as the JAX package's float32 pipeline stages
    them; ``"f32"`` gives ``default``."""
    st = storage_dtype(policy, default)
    if not is_reduced(st):
        return torch.as_tensor(np.asarray(a), dtype=st, device=device)
    return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                           device=device).to(st)
