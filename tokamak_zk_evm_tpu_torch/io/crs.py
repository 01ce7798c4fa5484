"""CRS (Sigma) persistence over torch tensors.

The port of the JAX package's `io/crs.py`.  Native format: one raw `.npy`
per family component (x and y limb-major [24, N], inf [N]) and a JSON
sidecar, `sigma_meta.json`, for the host points and shape metadata.  Limbs
and masks are written as uint32, the JAX package's dtype (the port holds
the same bit pattern in int32), so a CRS dir written by either package has
the same bytes and is read by the other.  The reference's rkyv archives
(`combined_sigma.rkyv` / `sigma_preprocess.rkyv`) are read and written by
`io/rkyv_crs.py`; `load_sigma_any` prefers an rkyv archive when one is
present.  The legacy single `sigma_families.npz` is still read.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..models.setup import Sigma, Sigma1, Sigma2
from ..utils.device import resolve_device


def _pt_to_json(p):
    if p is None:
        return None
    return [hex(p[0]), hex(p[1])]


def _pt_from_json(v):
    if v is None:
        return None
    return (int(v[0], 16), int(v[1], 16))


def _g2_to_json(p):
    if p is None:
        return None
    return [[hex(c) for c in p[0]], [hex(c) for c in p[1]]]


def _g2_from_json(v):
    if v is None:
        return None
    return (tuple(int(c, 16) for c in v[0]), tuple(int(c, 16) for c in v[1]))


_FAMILIES = (
    "xy_powers", "gamma_inv_o_inst", "eta_inv_li_o_inter_alpha4_kj",
    "delta_inv_li_o_prv",
)


def host_u32(t) -> np.ndarray:
    """A limb or mask tensor as its uint32 bit pattern on the host."""
    return np.ascontiguousarray(t.detach().cpu().numpy()).view(np.uint32)


def save_sigma(sigma: Sigma, path: str):
    """One raw uncompressed .npy per family component (mmap-able on load)
    and `sigma_meta.json`."""
    os.makedirs(path, exist_ok=True)
    for name in _FAMILIES:
        px, py, pinf = getattr(sigma.sigma_1, name)
        for suffix, arr in (("x", px), ("y", py), ("inf", pinf)):
            np.save(os.path.join(path, f"{name}_{suffix}.npy"), host_u32(arr))

    s1 = sigma.sigma_1
    meta = {
        "h_max": s1.h_max,
        "rs_y": s1.rs_y,
        "G": _pt_to_json(sigma.G),
        "H": _g2_to_json(sigma.H),
        "lagrange_KL": _pt_to_json(sigma.lagrange_KL),
        "sigma1_points": {
            "x": _pt_to_json(s1.x), "y": _pt_to_json(s1.y),
            "delta": _pt_to_json(s1.delta), "eta": _pt_to_json(s1.eta),
            "delta_inv_alphak_xh_tx": [[_pt_to_json(p) for p in row] for row in s1.delta_inv_alphak_xh_tx],
            "delta_inv_alpha4_xj_tx": [_pt_to_json(p) for p in s1.delta_inv_alpha4_xj_tx],
            "delta_inv_alphak_yi_ty": [[_pt_to_json(p) for p in row] for row in s1.delta_inv_alphak_yi_ty],
        },
        "sigma2": {
            k: _g2_to_json(getattr(sigma.sigma_2, k))
            for k in ("alpha", "alpha2", "alpha3", "alpha4", "gamma", "delta", "eta", "x", "y")
        },
    }
    with open(os.path.join(path, "sigma_meta.json"), "w") as f:
        json.dump(meta, f)


def load_sigma_any(path: str, params=None, device=None) -> Sigma:
    """Load a CRS dir: prefer the reference rkyv archive, else the npy
    families.  Device families land on `device` (default cuda)."""
    rk = os.path.join(path, "combined_sigma.rkyv")
    if os.path.exists(rk):
        if params is None:
            raise ValueError("loading combined_sigma.rkyv requires setup params")
        from . import rkyv_crs

        return rkyv_crs.read_combined_sigma(rk, params, device=device)
    return load_sigma(path, device)


def load_sigma(path: str, device=None) -> Sigma:
    """Read a CRS dir written by `save_sigma` (of either package): each
    family array mmapped, then one copy to `device` (default cuda)."""
    device = resolve_device(device)
    with open(os.path.join(path, "sigma_meta.json")) as f:
        meta = json.load(f)

    legacy = os.path.join(path, "sigma_families.npz")
    if os.path.exists(legacy) and not os.path.exists(
        os.path.join(path, "xy_powers_x.npy")
    ):
        data = {k: v for k, v in np.load(legacy).items()}
    else:
        # mmapped copy-on-write: no read before the device copy, and torch
        # may wrap the pages (a read-only map it would only warn about)
        data = {
            f"{name}_{suffix}": np.load(
                os.path.join(path, f"{name}_{suffix}.npy"), mmap_mode="c"
            )
            for name in _FAMILIES
            for suffix in ("x", "y", "inf")
        }

    def tensor(arr):
        # the uint32 bit pattern as the port's int32: a view, then one copy
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int32)).to(device)

    def fam(name):
        return tuple(tensor(data[f"{name}_{s}"]) for s in ("x", "y", "inf"))

    sp = meta["sigma1_points"]
    sigma1 = Sigma1(
        xy_powers=fam("xy_powers"),
        h_max=meta["h_max"],
        rs_y=meta["rs_y"],
        gamma_inv_o_inst=fam("gamma_inv_o_inst"),
        eta_inv_li_o_inter_alpha4_kj=fam("eta_inv_li_o_inter_alpha4_kj"),
        delta_inv_li_o_prv=fam("delta_inv_li_o_prv"),
        x=_pt_from_json(sp["x"]),
        y=_pt_from_json(sp["y"]),
        delta=_pt_from_json(sp["delta"]),
        eta=_pt_from_json(sp["eta"]),
        delta_inv_alphak_xh_tx=[[_pt_from_json(p) for p in row] for row in sp["delta_inv_alphak_xh_tx"]],
        delta_inv_alpha4_xj_tx=[_pt_from_json(p) for p in sp["delta_inv_alpha4_xj_tx"]],
        delta_inv_alphak_yi_ty=[[_pt_from_json(p) for p in row] for row in sp["delta_inv_alphak_yi_ty"]],
    )
    sigma2 = Sigma2(**{k: _g2_from_json(v) for k, v in meta["sigma2"].items()})
    return Sigma(
        G=_pt_from_json(meta["G"]),
        H=_g2_from_json(meta["H"]),
        sigma_1=sigma1,
        sigma_2=sigma2,
        lagrange_KL=_pt_from_json(meta["lagrange_KL"]),
    )
