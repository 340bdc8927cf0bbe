"""What crosses between the JAX package and the port.

This system has no learned weights. What is carried across is
configuration, inputs, sampled state (minimal-set indices, uniforms) and
tracking state (the camera, a frame's pyramid, a pose), and results on the
way back. Everything here takes its argument
duck-typed, so neither package has to be imported to convert the other's
objects: the parity tests use these functions and nothing ad hoc.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rgbd_pose_estimation_tpu_torch.ba.schur import BAProblem
from rgbd_pose_estimation_tpu_torch.core.camera import CameraIntrinsics
from rgbd_pose_estimation_tpu_torch.icp.dense import IcpFrame
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


def to_numpy(tree):
    """The way back: tensors, and tuples, lists, dicts and NamedTuples of
    them → numpy arrays (on the host, element type kept). Everything else
    passes through unchanged."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_numpy(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_numpy(v) for v in tree)
    return tree


def camera_from_reference(cam) -> CameraIntrinsics:
    """The JAX package's ``CameraIntrinsics`` (or anything with its fields)
    → the port's."""
    return CameraIntrinsics(
        **{f.name: getattr(cam, f.name) for f in dataclasses.fields(CameraIntrinsics)}
    )


def icp_frame_from_reference(frame, device) -> IcpFrame:
    """An ``IcpFrame`` of the JAX package (per-level vertex, normal and photo
    maps as arrays) → the port's ``IcpFrame`` of tensors on ``device``.
    A frame whose leaves are stacked along a leading batch axis (the
    layout of ``icp_track_batch``) converts the same way."""
    return IcpFrame(
        vertices=to_torch(tuple(frame.vertices), device),
        normals=to_torch(tuple(frame.normals), device),
        photo=to_torch(tuple(frame.photo), device),
    )


def keyframes_from_reference(keyframes, device) -> list:
    """The JAX package's ``Keyframe`` list (of ``DenseOdometry`` or built by
    hand) → the port's ``Keyframe`` list: the same indices, host poses and
    cached descriptors, each pyramid as tensors on ``device``, the
    association mass as a float."""
    from rgbd_pose_estimation_tpu_torch.models.odometry import Keyframe

    return [
        Keyframe(
            index=kf.index,
            pose=np.array(kf.pose, np.float32),
            frame=icp_frame_from_reference(kf.frame, device),
            descriptor=None if kf.descriptor is None else np.array(kf.descriptor),
            ref_weight=None if kf.ref_weight is None else float(kf.ref_weight),
        )
        for kf in keyframes
    ]


def ba_problem_from_reference(prob, device) -> BAProblem:
    """The JAX package's ``BAProblem`` (or any NamedTuple with its fields;
    arrays as numpy or anything ``np.asarray`` takes) → the port's, on
    ``device``. Element types are kept; ``None`` fields (no depth, no
    priors) stay ``None``."""
    return BAProblem(**{
        name: to_torch(None if getattr(prob, name) is None else np.asarray(getattr(prob, name)), device)
        for name in BAProblem._fields
    })


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
