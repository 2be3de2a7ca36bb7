"""Small shared utilities (port of ``sagecal_tpu/utils.py``).

The data and Jones real packings and the batched 2x2 complex algebra
of the model products.
"""

from __future__ import annotations

import numpy as np
import torch


def c2r(x):
    """Complex [...] -> real [..., 2] (a tensor or a numpy array)."""
    if isinstance(x, np.ndarray):
        return np.stack([x.real, x.imag], axis=-1)
    return torch.view_as_real(x.resolve_conj()).clone()


def r2c(x):
    """Real [..., 2] -> complex [...] (a tensor or a numpy array); bf16
    and f16 pairs give complex64, as in the JAX package."""
    if isinstance(x, np.ndarray):
        return x[..., 0] + 1j * x[..., 1]
    if x.dtype in (torch.bfloat16, torch.float16):
        x = x.float()
    return torch.complex(x[..., 0], x[..., 1])


def vis_to_x8(xa: np.ndarray) -> np.ndarray:
    """[B, 2, 2] complex visibilities -> [B, 8] reals in data order
    (XX re, im, XY, YX, YY)."""
    f = xa.reshape(-1, 4)
    return np.stack([f.real, f.imag], -1).reshape(-1, 8)


def mul22(A, B, conj_b: bool = False):
    """Batched 2x2 complex product A @ B (or A @ B^H with ``conj_b``)
    written out elementwise over broadcastable [..., 2, 2] tensors: at
    the solve's row counts this is a handful of elementwise kernels,
    where ``@`` becomes one batched GEMM of 2x2 matrices per row."""
    a00, a01, a10, a11 = A[..., 0, 0], A[..., 0, 1], A[..., 1, 0], \
        A[..., 1, 1]
    if conj_b:
        b00, b01 = B[..., 0, 0].conj(), B[..., 1, 0].conj()
        b10, b11 = B[..., 0, 1].conj(), B[..., 1, 1].conj()
    else:
        b00, b01, b10, b11 = B[..., 0, 0], B[..., 0, 1], B[..., 1, 0], \
            B[..., 1, 1]
    return torch.stack([
        torch.stack([a00 * b00 + a01 * b10, a00 * b01 + a01 * b11], -1),
        torch.stack([a10 * b00 + a11 * b10, a10 * b01 + a11 * b11], -1),
    ], -2)


def gather_jones(J, chunk_idx, sta):
    """Rows' Jones J[chunk_idx, sta] of J [K, N, 2, 2] complex, as an
    ``index_select`` on the real view: its autograd backward is an
    ``index_add_`` instead of the sorting ``index_put_`` of advanced
    indexing."""
    K, N = J.shape[0], J.shape[1]
    Jr = torch.view_as_real(J.resolve_conj()).reshape(K * N, 8)
    rows = Jr.index_select(0, chunk_idx.long() * N + sta.long())
    return torch.view_as_complex(rows.view(-1, 2, 2, 2))


def jones_c2r_np(J: np.ndarray) -> np.ndarray:
    """Host [..., 2, 2] complex Jones -> [..., 8] reals."""
    flat = J.reshape(J.shape[:-2] + (4,))
    return np.stack([flat.real, flat.imag], axis=-1).reshape(
        J.shape[:-2] + (8,))


def jones_r2c_np(p: np.ndarray) -> np.ndarray:
    """Host [..., 8] reals -> [..., 2, 2] complex Jones."""
    pr = p.reshape(p.shape[:-1] + (4, 2))
    return (pr[..., 0] + 1j * pr[..., 1]).reshape(p.shape[:-1] + (2, 2))


def jones_c2r(J):
    """[..., 2, 2] complex Jones -> [..., 8] reals (Re, Im interleaved,
    row-major 00, 01, 10, 11)."""
    return torch.view_as_real(
        J.reshape(J.shape[:-2] + (4,))).reshape(J.shape[:-2] + (8,))


def jones_r2c(p):
    """[..., 8] reals -> [..., 2, 2] complex Jones."""
    pr = p.reshape(p.shape[:-1] + (4, 2))
    return torch.complex(pr[..., 0], pr[..., 1]).reshape(
        p.shape[:-1] + (2, 2))
