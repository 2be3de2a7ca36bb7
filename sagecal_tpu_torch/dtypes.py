"""Storage / accumulate dtype policy (port of ``sagecal_tpu/dtypes.py``).

Only the ``f32`` policy is ported: its storage dtype is the pipeline's
real dtype (float32 on the card, float64 on the CPU). The reduced
policies (``bf16``/``f16``) raise until ROADMAP queue A item 7 ports
them (with queue B item 4).
"""

from __future__ import annotations

import torch

POLICIES = ("f32", "bf16", "f16")


def validate(policy: str) -> str:
    if policy not in POLICIES:
        raise ValueError(
            f"unknown dtype policy {policy!r}; choose from {POLICIES}")
    if policy != "f32":
        raise NotImplementedError(
            f"--dtype-policy {policy} is not ported yet (ROADMAP queue A "
            "item 7: reduced storage policies)")
    return policy


def storage_dtype(policy: str, default=torch.float32):
    """Storage dtype of ``policy``: ``"f32"`` maps to ``default`` (the
    pipeline real dtype, float64 on the CPU)."""
    validate(policy)
    return default


def _check_ported(dtype) -> None:
    if dtype in (torch.bfloat16, torch.float16):
        raise NotImplementedError(
            f"{dtype} storage is not ported yet (ROADMAP queue A item 7: "
            "reduced storage policies)")


def acc_dtype(dtype):
    """Accumulator dtype paired with storage ``dtype``: the dtype itself
    (float32 on the card, float64 on the CPU)."""
    _check_ported(dtype)
    return dtype


def to_storage(x, dtype):
    """``x`` in the storage dtype: the identity for the ported dtypes."""
    _check_ported(dtype)
    return x
