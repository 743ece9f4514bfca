"""Map and Atlas checkpoints as npz files (port of
`orbslam3lib_tpu/models/serialization.py`).

The files use the reference's keys and dtypes: a map's fields under their
own names (`save_map`), an atlas's as `map{i}_{field}` with `_n_maps`,
`_current` and `_dims` (`save_atlas`). So a file written by either package
loads in the other, and this is also how a JAX-written atlas becomes the
port's maps. A field missing from a file (a map saved before the field
existed) takes the empty map's value. `load_*` put the arrays on `device`.
"""
from __future__ import annotations

import numpy as np
import torch

from .atlas import Atlas
from .map_state import FIELDS, MapState, empty_map


def _arrays(m: MapState) -> dict:
    return {k: getattr(m, k).cpu().numpy() for k in FIELDS}


def save_map(m: MapState, path: str) -> None:
    np.savez_compressed(path, **_arrays(m))


def _load_fields(z, prefix: str, like: MapState, device) -> MapState:
    return MapState(**{
        k: (torch.from_numpy(np.array(z[prefix + k])).to(device) if prefix + k in z
            else getattr(like, k).clone())
        for k in FIELDS})


def load_map(path: str, device: torch.device | str = "cpu") -> MapState:
    with np.load(path) as z:
        K, F = z["kf_mp"].shape
        P = z["mp_pos"].shape[0]
        return _load_fields(z, "", empty_map(K, P, F, device=device), device)


def save_atlas(atlas: Atlas, path: str) -> None:
    arrays = {}
    for i, m in enumerate(atlas.maps):
        for k, v in _arrays(m).items():
            arrays[f"map{i}_{k}"] = v
    arrays["_n_maps"] = np.asarray(len(atlas.maps))
    arrays["_current"] = np.asarray(atlas.current)
    arrays["_dims"] = np.asarray(atlas._dims)
    np.savez_compressed(path, **arrays)


def load_atlas(path: str, device: torch.device | str = "cpu") -> Atlas:
    with np.load(path) as z:
        n = int(z["_n_maps"])
        dims = tuple(int(x) for x in z["_dims"])
        atlas = Atlas(*dims, device=device)
        like = atlas.maps[0]
        atlas.maps = [_load_fields(z, f"map{i}_", like, device) for i in range(n)]
        atlas.bad = [False] * n
        atlas.current = int(z["_current"])
    return atlas
