"""Carry the JAX package's state across to the port, as numpy arrays.

The functions take plain numpy arrays (or dicts of them) — never JAX
objects — so this module imports no JAX. The tests use them to give
both packages identical inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from sagecal_tpu_torch.io.dataset import VisTile
from sagecal_tpu_torch.rime.predict import SkyArrays, _INT_FIELDS


def sky_from_numpy(fields: dict, device="cpu",
                   real_dtype=torch.float64) -> SkyArrays:
    """``{field: numpy array}`` of a JAX ``SkyArrays`` -> the port's
    :class:`SkyArrays` on ``device``."""
    missing = set(SkyArrays._fields) - set(fields)
    if missing:
        raise KeyError(f"sky_from_numpy: missing fields {sorted(missing)}")
    return SkyArrays(**{
        name: torch.as_tensor(np.array(fields[name]), device=device).to(
            _INT_FIELDS.get(name, real_dtype))
        for name in SkyArrays._fields})


def sky_to_numpy(sky: SkyArrays) -> dict:
    """The port's SkyArrays -> ``{field: numpy array}``."""
    return {name: getattr(sky, name).cpu().numpy()
            for name in SkyArrays._fields}


def jones_from_numpy(J, device="cpu", dtype=torch.complex128):
    """Complex [..., 2, 2] Jones, or its [..., 8] real packing
    ((Re, Im) of 00, 01, 10, 11), -> complex tensor [..., 2, 2]."""
    J = np.array(J)
    if not np.iscomplexobj(J):
        if J.shape[-1] != 8:
            raise ValueError(f"jones_from_numpy: real input must end in 8 "
                             f"(got shape {J.shape})")
        pr = J.reshape(J.shape[:-1] + (4, 2))
        J = (pr[..., 0] + 1j * pr[..., 1]).reshape(J.shape[:-1] + (2, 2))
    return torch.as_tensor(J, device=device).to(dtype)


def tile_from_numpy(**fields) -> VisTile:
    """A JAX ``VisTile``'s fields (numpy arrays and scalars) -> the
    port's :class:`VisTile`."""
    return VisTile(**{k: fields[k] for k in VisTile.__dataclass_fields__
                      if k in fields})


def beaminfo_from_numpy(**fields):
    """A JAX ``rime.beam.BeamInfo``'s fields (numpy arrays and scalars;
    ``ecoeff`` None, a dict of ``ElementCoeffs`` fields, or any object
    with them as attributes) -> the port's ``rime.beam.BeamInfo``."""
    from sagecal_tpu_torch.rime import beam as bm
    ec = fields.get("ecoeff")
    if ec is not None:
        get = ec.get if isinstance(ec, dict) else \
            (lambda k: getattr(ec, k))
        ec = bm.ElementCoeffs(freqs=np.array(get("freqs")),
                              theta=np.array(get("theta")),
                              phi=np.array(get("phi")), M=int(get("M")),
                              beta=float(get("beta")))
    return bm.BeamInfo(
        longitude=np.array(fields["longitude"]),
        latitude=np.array(fields["latitude"]),
        time_jd=np.array(fields["time_jd"]), ra0=float(fields["ra0"]),
        dec0=float(fields["dec0"]), freq0=float(fields["freq0"]),
        elem_xyz=np.array(fields["elem_xyz"]),
        elem_mask=np.array(fields["elem_mask"]), ecoeff=ec)


#: the ADMM runner's state, in the order of the JAX runner's carry
#: (``admm.iter0_post``: JF, YF, Z, rhoF, Yhat, Jprev, Zbar, Xd,
#: rho_upper)
ADMM_CARRY = ("JF", "YF", "Z", "rhoF", "Yhat", "Jprev", "Zbar", "Xd",
              "rho_upper")


def admm_state_from_numpy(carry, device="cpu", dtype=torch.float64) -> dict:
    """The JAX ADMM runner's carry (a sequence of numpy arrays in
    :data:`ADMM_CARRY` order, or a dict of them: [F, M, K, N, 8] per
    subband, [M, P, K, N, 8] for Z, Zbar and Xd, [F, M] for the rhos) ->
    the port runner's state dict (``consensus.admm``'s
    ``run.from_state``) on ``device``."""
    if not isinstance(carry, dict):
        carry = dict(zip(ADMM_CARRY, carry))
    missing = set(ADMM_CARRY) - set(carry)
    if missing:
        raise KeyError(f"admm_state_from_numpy: missing {sorted(missing)}")
    return {k: torch.as_tensor(np.array(carry[k]), device=device).to(dtype)
            for k in ADMM_CARRY}
