"""What crosses between the JAX package and the port.

This system has no learned weights. What is carried across is
configuration, inputs and sampled state (minimal-set indices, uniforms),
and results on the way back. Everything here takes its argument
duck-typed, so neither package has to be imported to convert the other's
objects: the parity tests use these functions and nothing ad hoc.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rgbd_pose_estimation_tpu_torch.utils import config as _config


def config_from_reference(obj, name: str | None = None):
    """A config of the JAX package → the port's dataclass of the same name.

    ``obj`` is one of that package's config dataclasses (the class name is
    read from its type) or its ``dataclasses.asdict`` form (then ``name``
    says which class it was). Fields are matched by name; nested configs
    (``PipelineConfig``) convert recursively. A field the port's class does
    not have raises, so drift between the two packages is caught at once.
    """
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        name = type(obj).__name__
        values = {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
    elif isinstance(obj, dict):
        if name is None:
            raise ValueError("a dict needs name= (the config class it came from)")
        values = dict(obj)
    else:
        raise TypeError(f"expected a config dataclass or its dict, got {type(obj)!r}")
    cls = getattr(_config, name, None)
    if cls is None or not dataclasses.is_dataclass(cls):
        raise ValueError(f"the port has no config class named {name!r}")
    own = {f.name: f for f in dataclasses.fields(cls)}
    unknown = sorted(set(values) - set(own))
    if unknown:
        raise ValueError(f"{name} has no field(s) {unknown}")
    kwargs = {}
    for key, val in values.items():
        default = own[key].default
        if dataclasses.is_dataclass(default):
            val = config_from_reference(val, type(default).__name__)
        elif isinstance(val, list):
            val = tuple(val)
        kwargs[key] = val
    return cls(**kwargs)


def to_torch(tree, device):
    """Arrays (numpy, or anything ``np.asarray`` takes) and tuples, lists,
    dicts and NamedTuples of them → tensors on ``device``.

    The element type is kept: float32 stays float32, int32 stays int32, bool
    stays bool. Python scalars, strings and ``None`` pass through unchanged.
    """
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return tree
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_torch(v, device) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_torch(v, device) for v in tree)
    # np.array copies: the tensor must own writable memory.
    return torch.from_numpy(np.array(tree)).to(device)


def result_to_numpy(result) -> dict:
    """A ``RansacResult`` (the port's, or the JAX package's) → a dict of
    numpy arrays keyed by field name; static fields (``num_hypotheses``)
    stay Python values."""
    out = {}
    for name in result._fields:
        val = getattr(result, name)
        if isinstance(val, torch.Tensor):
            val = val.detach().cpu().numpy()
        elif not isinstance(val, (bool, int, float, str)):
            val = np.asarray(val)
        out[name] = val
    return out
