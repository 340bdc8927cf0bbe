"""Client of the dense odometry server (``models/odometry.py::DenseOdometry``).

A traffic mix for it is a data file with these keys:

- ``client``: ``"dense_odometry"``, this file's name;
- ``sequences``, ``frames``: how many hard-mode sequences are rendered at
  set-up, and their length;
- ``trans_scale``, ``rot_scale``: the handheld motion's tangent steps (m, rad);
- ``pipeline_depth``: frames in flight in ``process_stream``;
- ``warmup_frames``: frames of the first sequence served once at set-up;
- ``trace_skip``, ``trace_requests``: frames served before the traced
  sub-window opens, and frames served in it.

One client, closed loop: it feeds a sequence's frames as host ``uint16``
depth (the sensor's form) to a fresh server through
``process_stream(pipeline_depth=...)``, and cycles through the sequences
until the window closes; then it stops feeding, and the server returns the
frames already taken. A request is one frame: from the moment the server
pulls it to the moment its pose is yielded.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.frozen.synthetic import handheld_trajectory, kinect_degrade, render_depth
from benchmark.reference import icp_odometry as reference


class Client:
    def __init__(self, config, mix, seed, device):
        self.config, self.mix, self.seed = config, mix, seed
        self.device = torch.device(device)
        self.passes = 0
        # Imported here, not at the top: the harness looks for the card first.
        from rgbd_pose_estimation_tpu_torch.models.odometry import DenseOdometry

        self._server_cls = DenseOdometry

    # --- set-up -----------------------------------------------------------

    def setup(self):
        from rgbd_pose_estimation_tpu_torch.core.camera import CameraIntrinsics
        from rgbd_pose_estimation_tpu_torch.utils.config import IcpConfig, KeyframeConfig

        c = self.config
        cam = c["camera"]
        self.cam = (cam["fx"], cam["fy"], cam["cx"], cam["cy"])
        self.size = (cam["width"], cam["height"])
        icp = dict(c["icp"])
        for key in ("iters_per_level", "source_stride"):
            icp[key] = tuple(icp[key])
        self.icp, self.keyframe = c["icp"], c["keyframe"]
        self.server_args = dict(
            cam=CameraIntrinsics(*self.cam, *self.size),
            icp_cfg=IcpConfig(**icp),
            kf_cfg=KeyframeConfig(**c["keyframe"]),
            depth_scale=c["depth_scale"],
            device=self.device,
        )
        m = self.mix
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed)
        seqs = []
        for _ in range(m["sequences"]):
            poses = handheld_trajectory(gen, m["frames"], m["trans_scale"], m["rot_scale"], self.device)
            depth = kinect_degrade(gen, render_depth(self.cam + self.size, poses))
            sensor = torch.round(depth / c["depth_scale"]).to(torch.int32)
            seqs.append(sensor.cpu().numpy().astype(np.uint16))
        self.sequences = seqs

    def warmup(self):
        frames = self.sequences[0][: self.mix["warmup_frames"]]
        server = self._server_cls(**self.server_args)
        for _ in server.process_stream(iter(frames), pipeline_depth=self.mix["pipeline_depth"]):
            pass

    def counts(self):
        """What the count functions of the per-layer metrics need: per
        pyramid level the fused step's samples a call, the mean number of
        them with a valid depth, and its calls a track."""
        levels = []
        icp = self.icp
        w, h = self.size
        stride_of = icp["source_stride"]
        for lvl in range(icp["levels"]):
            s = stride_of[lvl] if lvl < len(stride_of) else 1
            valid = []
            for seq in self.sequences:
                d = torch.from_numpy(seq.astype(np.int32)) > 0
                for _ in range(lvl):  # a texel of level l is valid where any of its 2x2 is
                    d = d[:, : d.shape[1] // 2 * 2, : d.shape[2] // 2 * 2]
                    d = d.reshape(d.shape[0], d.shape[1] // 2, 2, d.shape[2] // 2, 2).any(4).any(2)
                valid.append(d[:, ::s, ::s].float().sum(dim=(1, 2)).mean())
            lw, lh = w >> lvl, h >> lvl
            levels.append({
                "samples": -(-lh // s) * -(-lw // s),
                "valid_samples": float(sum(valid) / len(valid)),
                "calls": icp["iters_per_level"][lvl],
            })
        return {"fused_step_levels": levels}

    # --- the window -------------------------------------------------------

    def serve(self, deadline, on_complete=None):
        """Serve until ``deadline`` (host clock) or until ``on_complete``
        returns True. Returns one record a frame taken by the server."""
        records = []
        stop = False
        m = self.mix
        while not stop:
            seq = self.passes % len(self.sequences)
            frames = self.sequences[seq]
            pulls = []

            def feed():
                for k in range(len(frames)):
                    if stop or time.perf_counter() >= deadline:
                        return
                    pulls.append(time.perf_counter())
                    yield frames[k]

            server = self._server_cls(**self.server_args)
            for i, pose in server.process_stream(feed(), pipeline_depth=m["pipeline_depth"]):
                t = time.perf_counter()
                records.append({"pass": self.passes, "seq": seq, "index": i, "pose": pose,
                                "t_start": pulls[i], "t_done": t, "ok": bool(np.isfinite(pose).all())})
                if on_complete is not None and on_complete(len(records)):
                    stop = True
            taken = len(pulls)
            done = sum(1 for r in records if r["pass"] == self.passes)
            for i in range(done, taken):  # taken but never returned
                records.append({"pass": self.passes, "seq": seq, "index": i, "pose": None,
                                "t_start": pulls[i], "t_done": None, "ok": False})
            self.passes += 1
            stop = stop or time.perf_counter() >= deadline
        return records

    def release(self):
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # --- the check ----------------------------------------------------------

    def reference_poses(self, seq, precision="float32"):
        c, m = self.config, self.mix
        return reference.odometry_stream(
            self.cam, c["icp"], c["keyframe"], c["depth_scale"], self.sequences[seq],
            m["pipeline_depth"], self.device, precision,
        )

    def check(self, records, control=False):
        """The compared numbers over every returned frame. A frame's gap is
        the largest entry of the difference between the program's and the
        reference's pose of the frame relative to the reference's keyframe
        of it (rotation entries and metres). ``rel_pose_gap_p50`` and
        ``rel_pose_gap_p95`` are the median gap and its 95th percentile,
        ``missing`` the frames taken and never returned. ``control`` judges
        the reference in TF32 instead of the program. Every gap is kept in
        ``self.gaps`` for the readings the limits are set from."""
        by_seq = {}
        for r in records:
            by_seq.setdefault(r["seq"], []).append(r)
        gaps, missing = [], 0
        for seq, recs in sorted(by_seq.items()):
            ref, kf_of = self.reference_poses(seq)
            judged = self.reference_poses(seq, "tf32")[0] if control else None
            by_pass = {}
            for r in recs:
                if r["pose"] is None:
                    missing += 1
                    continue
                by_pass.setdefault(r["pass"], {})[r["index"]] = (
                    judged[r["index"]] if judged is not None else np.asarray(r["pose"], np.float64))
            for poses in by_pass.values():
                for i, P in poses.items():
                    k = kf_of[i]
                    if i == 0:  # the first frame is the origin
                        D_prog, D_ref = P, np.eye(4)
                    elif k in poses:
                        D_prog, D_ref = poses[k] @ reference.inverse(P), ref[k] @ reference.inverse(ref[i])
                    else:
                        D_prog, D_ref = np.full((4, 4), np.inf), np.eye(4)
                    gaps.append(float(np.nan_to_num(np.abs(D_prog - D_ref)[:3].max(), nan=np.inf)))
        self.gaps = gaps
        p50, p95 = np.percentile(gaps, [50, 95]) if gaps else (np.inf, np.inf)
        return {"rel_pose_gap_p50": float(p50), "rel_pose_gap_p95": float(p95), "missing": missing}

