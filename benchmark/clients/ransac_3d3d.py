"""Client of the 3D-3D RANSAC estimator (``ransac/engine.py::estimate_pose_3d3d``).

A traffic mix for it is a data file with these keys:

- ``client``: ``"ransac_3d3d"``, this file's name;
- ``pool``: problems made on the device at set-up and cycled;
- ``correspondences``, ``outlier_frac``, ``noise``: each problem's N, the
  share of its correspondences that are outliers, the inliers' noise (m);
- ``hypotheses``: the caller's budget K of hypotheses an estimate;
- ``warmup_requests``: estimates made once at set-up;
- ``trace_skip``, ``trace_requests``: estimates made before the traced
  sub-window opens, and estimates made in it.

One client, closed loop: each request is one estimate on the next problem
of the pool, and ends when its pose, inlier count and validity have reached
the host.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.frozen.synthetic import synthetic_correspondences
from benchmark.reference import ransac_3d3d as reference


def _sub_seed(seed: int, k: int) -> int:
    return (seed * 1_000_003 + 7919 * k) % (1 << 63)


class Client:
    def __init__(self, config, mix, seed, device):
        self.config, self.mix, self.seed = config, mix, seed
        self.device = torch.device(device)
        self.served = 0
        from rgbd_pose_estimation_tpu_torch.ransac.engine import estimate_pose_3d3d
        from rgbd_pose_estimation_tpu_torch.utils.config import RansacConfig

        self._estimate = estimate_pose_3d3d
        r = config["ransac"]
        self.cfg = RansacConfig(num_hypotheses=mix["hypotheses"], **r)

    def setup(self):
        m = self.mix
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed)
        self.p, self.q, _, _ = synthetic_correspondences(
            gen, m["correspondences"], m["outlier_frac"], m["noise"], batch=(m["pool"],),
            device=self.device)
        self.sampler = torch.Generator(device=self.device)
        self.sampler.manual_seed(_sub_seed(self.seed, 1))

    def _one(self, j):
        res = self._estimate(self.sampler, self.p[j], self.q[j], self.cfg)
        out = torch.cat([res.pose.reshape(16), res.num_inliers.reshape(1),
                         res.valid.to(torch.float32).reshape(1)])
        return out.cpu().numpy()

    def warmup(self):
        for j in range(self.mix["warmup_requests"]):
            self._one(j % self.mix["pool"])

    def counts(self):
        n = self.mix["correspondences"]
        return {"K": self.mix["hypotheses"], "N": n, "N_padded": -(-n // 128) * 128,
                "sample_size": self.config["ransac"]["sample_size"]}

    def serve(self, deadline, on_complete=None):
        """Estimate until ``deadline`` (host clock) or until ``on_complete``
        returns True. Returns one record an estimate."""
        records = []
        while time.perf_counter() < deadline:
            j = self.served % self.mix["pool"]
            t0 = time.perf_counter()
            out = self._one(j)
            t1 = time.perf_counter()
            self.served += 1
            pose = out[:16].reshape(4, 4)
            ok = bool(out[17] > 0.5 and np.isfinite(pose).all())
            records.append({"problem": j, "pose": pose, "inliers": int(out[16]), "valid": ok,
                            "t_start": t0, "t_done": t1, "ok": ok})
            if on_complete is not None and on_complete(len(records)):
                break
        return records

    def release(self):
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_estimate(self, j, precision="float32"):
        r = self.config["ransac"]
        gen = torch.Generator(device=self.device)
        gen.manual_seed(_sub_seed(self.seed, 2 + j))
        return reference.estimate(gen, self.p[j], self.q[j], self.mix["hypotheses"], r["threshold"],
                                  r["refit_rounds"], r["sample_size"], precision)

    def check(self, records, control=False):
        """The compared numbers over every estimate: ``pose_gap``, the
        largest entry of the difference between the program's pose and the
        reference's on the same problem (rotation entries and metres), and
        ``inlier_count_gap``, the largest difference between the inlier
        count the program reports and the count of its own pose's inliers
        that the reference makes. ``control`` judges the reference in TF32
        instead of the program."""
        thr = self.config["ransac"]["threshold"]
        gap, count_gap = 0.0, 0
        for j in sorted({r["problem"] for r in records}):
            T_ref, _ = self.reference_estimate(j)
            T_ref = T_ref.cpu().numpy().astype(np.float64)
            if control:
                T_c, n_c = self.reference_estimate(j, "tf32")
                judged = [(T_c.cpu().numpy(), n_c)]
            else:
                judged = [(r["pose"], r["inliers"]) for r in records if r["problem"] == j]
            for pose, n in judged:
                d = np.abs(np.asarray(pose, np.float64) - T_ref)[:3].max()
                gap = max(gap, float(np.nan_to_num(d, nan=np.inf)))
                T = torch.as_tensor(np.asarray(pose, np.float32), device=self.device)
                count_gap = max(count_gap, abs(n - reference.count_inliers(T, self.p[j], self.q[j], thr)))
        return {"pose_gap": gap, "inlier_count_gap": count_gap}
