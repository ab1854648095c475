"""The JAX package's FlatScene, as numpy arrays, -> this package's FlatScene.

`flat_from_numpy` carries a scene across unchanged, leaf by leaf, so the
two renderers can be fed the very same arrays (the weights-carried-across
function of this port). It takes any object whose attributes mirror the
FlatScene fields, e.g. `jax.tree.map(np.asarray, flat)`, and needs
nothing from JAX itself.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from platinum_tpu_torch.ops.luts import Luts
from platinum_tpu_torch.render import types as T

_NESTED = {"geometry": T.Geometry, "materials": T.MaterialTable,
           "lights": T.LightTable, "env": T.EnvironmentLight,
           "camera": T.CameraConstants, "luts": Luts,
           "instances": T.InstanceTable}


def _leaf(x, device):
    if x is None or isinstance(x, bool):
        return x
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def _convert(src, cls, device):
    kw = {}
    for f in dataclasses.fields(cls):
        v = getattr(src, f.name, None)
        if f.name in _NESTED and v is not None:
            kw[f.name] = _convert(v, _NESTED[f.name], device)
        elif f.name == "wbvh_parts" and v is not None:
            kw[f.name] = tuple(tuple(_leaf(a, device) for a in part)
                               for part in v)
        else:
            kw[f.name] = _leaf(v, device)
    return cls(**kw)


def flat_from_numpy(flat_np, device) -> T.FlatScene:
    """Port-side FlatScene on `device` from a FlatScene of numpy leaves."""
    return _convert(flat_np, T.FlatScene, device)
