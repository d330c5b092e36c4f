"""Detection traffic: generated stereo pairs served through
``DetectRunner.forward``.

The traffic file's parameters: ``pairs`` a request; ``prefetch``:
requests queued on the card before the oldest one's proposals are pulled
to the host (as ``DetectRunner.run`` does); ``pool``: distinct pairs made
from the seed, of which each request takes ``pairs`` distinct ones in a
seeded draw (``max_requests`` draws made before the window, reused past
that); ``max_boxes``, ``score_threshold``, ``nms_iou``: the runner's
settings (the detect CLI's).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, List

import numpy as np
import torch

from portbench.lib import compare, kitti
from portbench.lib.weights import float_shapes, load, make_weights
from portbench.reference import layers as ref_layers
from portbench.reference import stereo as ref_stereo
from portbench.work import flops as work_flops
from portbench.work import kernels as work_kernels

MAP_KEYS = ("cls", "reg", "centerness", "depth")


class Driver:
    """Builds the program for one detection cell, serves its window and
    checks the sampled requests against the reference."""

    def __init__(self, cell, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, seed, device
        self.traffic = cell.traffic
        self.cfg_dict = cell.config["stereo"]
        self.sampled: Dict[int, Dict] = {}
        self.capture = None

    def setup(self):
        from snvc_tpu_torch.config import StereoConfig, load_config
        from snvc_tpu_torch.inference.detect import DetectRunner
        from snvc_tpu_torch.models.stereonet import StereoNet

        t = self.traffic
        cfg = load_config(str(self.cell.config_path), StereoConfig)
        model = StereoNet(cfg, device=self.device)
        load(model, self._weights(model))
        self.runner = DetectRunner(
            model, cfg, max_boxes=t["max_boxes"],
            score_threshold=t["score_threshold"], nms_iou=t["nms_iou"],
            device=self.device)
        model.head.register_forward_hook(self._capture)
        gen = torch.Generator(device=self.device).manual_seed(
            (self.seed + 1) % (2 ** 63))
        self.pool = torch.randint(
            0, 256, (2, t["pool"]) + tuple(cfg.input_size) + (3,),
            generator=gen, dtype=torch.uint8, device=self.device).cpu().numpy()
        rng = np.random.default_rng(self.seed)
        self.draws = [rng.choice(t["pool"], t["pairs"], replace=False)
                      for _ in range(t["max_requests"])]
        self.requests = [dict(n_valid=t["pairs"])] * t["max_requests"]
        self.sample = compare.sample_indices(self.cell.workload["sample"],
                                             self.requests, self.seed)
        for i in (-1, -2):  # the one shape of every request
            [x.cpu() for x in self.runner.forward(self._request(i))]

    def _weights(self, model):
        return make_weights(float_shapes(model), self.seed, self.device,
                            self.cell.config.get("weights", {}).get("scale"))

    def _request(self, i: int) -> Dict:
        idx = self.draws[i % len(self.draws)]
        P = np.repeat(kitti.P_LEFT[None], len(idx), 0)
        return dict(images_left=self.pool[0, idx], images_right=self.pool[1, idx],
                    P_left=P, P_right=np.repeat(kitti.P_RIGHT[None],
                                                len(idx), 0))

    def _capture(self, module, args, out):
        if self.capture is not None:
            self.capture["maps"] = {k: out[k] for k in MAP_KEYS}

    def stages(self):
        return {"encoder": self.runner.model.encoder,
                "head": self.runner.model.head}

    def window(self, seconds: float, tracer) -> Dict:
        pending = deque()
        done = i = 0
        host = dict(prepare=0.0, forward=0.0, pull=0.0)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            t = time.perf_counter()
            req = self._request(i)
            self.capture = (dict(req=req) if i in self.sample else None)
            t1 = time.perf_counter()
            out = self.runner.forward(req)
            t2 = time.perf_counter()
            if self.capture is not None:
                self.capture["out"] = out
                self.sampled[i] = self.capture
            self.capture = None
            pending.append(out)
            if tracer is not None:
                tracer.step()
            t3 = time.perf_counter()
            while len(pending) > self.traffic["prefetch"]:
                [x.cpu() for x in pending.popleft()]
                done += 1
            t4 = time.perf_counter()
            for k, v in (("prepare", t1 - t), ("forward", t2 - t1),
                         ("pull", t4 - t3)):
                host[k] += v
            i += 1
        while pending:
            [x.cpu() for x in pending.popleft()]
            done += 1
        window = time.perf_counter() - t0
        return dict(attempted=i, failed=i - done, metrics=dict(
            detect_pairs_per_s=done * self.traffic["pairs"] / window),
            host_ms={k: 1e3 * v / max(i, 1) for k, v in host.items()})

    def record(self, tracer, stage_ms, summary, peaks) -> Dict:
        cfg = self.cfg_dict
        itemsize = 2 if cfg["compute_dtype"] == "bfloat16" else 4
        d0 = ref_stereo.depth_rows(cfg)[1]
        n = len(tracer.requests())
        return dict(trace=summary, requests=n,
                    units=n * self.traffic["pairs"],
                    flops_per_unit=work_flops.detect_flops_per_pair(cfg),
                    kernel_work=work_kernels.detect_work(
                        cfg, self.traffic["pairs"], itemsize, d0),
                    stage_ms=stage_ms, peaks=peaks)

    def check(self) -> Dict:
        """The compared numbers with the workload's limits."""
        return compare.with_limits(self.numbers("float32"),
                                   self.cell.workload["limits"])

    def numbers(self, precision: str) -> Dict[str, float]:
        program = []
        for i, s in sorted(self.sampled.items()):
            maps = {k: v.float().cpu().numpy() for k, v in s["maps"].items()}
            boxes, scores, _, valid = (x.cpu().numpy() for x in s["out"])
            program.append((s["req"], maps, (boxes, scores, valid)))
        unanswered = len(self.sample - set(self.sampled))
        self.sampled.clear()
        self.runner = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return dict(self.compare(program, precision),
                    unanswered=float(unanswered))

    def reference_maps(self, reqs, precision: str) -> List[Dict]:
        ref = ref_stereo.StereoNet(self.cfg_dict).to(self.device)
        load(ref, self._weights(ref))
        ref_layers.set_precision(ref, precision)
        with ref_layers.strict_float32():
            return [{k: v.numpy() for k, v in ref_stereo.detect(
                ref, req, self.device, self.cell.workload["block"]).items()}
                for req in reqs]

    def compare(self, program: List, precision: str) -> Dict[str, float]:
        t = self.traffic
        refs = self.reference_maps([r for r, _, _ in program], "float32")
        if precision != "float32":  # the control takes the program's place
            got = self.reference_maps([r for r, _, _ in program], precision)
        else:
            got = [m for _, m, _ in program]
        decoded = []
        for (_, maps, (boxes, scores, valid)) in program:
            # pairs whose maps are missing fail on the maps' numbers
            for p in range(min(boxes.shape[0], maps["cls"].shape[0])):
                one = {k: torch.from_numpy(maps[k][p]) for k in
                       ("cls", "reg", "centerness")}
                decoded.append(((boxes[p], scores[p], valid[p]), tuple(
                    x.numpy() for x in ref_stereo.decode(
                        self.cfg_dict, one, t["max_boxes"],
                        t["score_threshold"], t["nms_iou"]))))
        return compare.detect_numbers(list(zip(got, refs)), decoded)
