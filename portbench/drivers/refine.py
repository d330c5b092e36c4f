"""Refinement traffic: generated stereo frames with car proposals, served
through ``RefineRunner``.

The traffic file's parameters:

* ``loop``: ``"run"`` (offline: ``RefineRunner.run(pipeline, writer,
  prefetch)``, the benchmark's pipeline yielding requests until the
  window's time is up, its writer taking each request's outputs) or
  ``"step"`` (a closed loop of one client: ``RefineRunner.step`` per
  request, each waiting for its boxes on the host);
* ``prefetch``: requests queued on the card in ``"run"``;
* ``proposals``: the proposal counts of a block of requests; each block
  of ``len(proposals)`` requests takes every count once, in an order
  drawn from the seed, so every seed serves the same sizes;
* ``frames``: distinct frames made from the seed (a request takes one,
  in a seeded order), ``max_requests``: requests prepared before the
  window (proposals and crop affines; the window reuses them past
  that).

One request is one frame (``frames_per_batch`` 1) with its proposals in
the configuration's ``max_instances`` slots; the rest are padded as the
program's ``RefinementPipeline`` pads them.
"""

from __future__ import annotations

import math
import time
from collections import deque
from typing import Dict, List

import numpy as np
import torch

from portbench.lib import compare, kitti
from portbench.lib.weights import float_shapes, load, make_weights
from portbench.reference import layers as ref_layers
from portbench.reference import vernier as ref_vernier
from portbench.work import flops as work_flops
from portbench.work import kernels as work_kernels

OUTPUT_KEYS = ("ncf", "occupancy", "coordinates")
HOST_KEYS = ("one_part", "all_parts", "confidence", "keep")


def make_frames(n: int, hw, seed: int, device) -> np.ndarray:
    """[2, n, H, W, 3] uint8 left / right images drawn on ``device``."""
    gen = torch.Generator(device=device).manual_seed((seed + 1) % (2 ** 63))
    img = torch.randint(0, 256, (2, n) + tuple(hw) + (3,), generator=gen,
                        dtype=torch.uint8, device=device)
    return img.cpu().numpy()


def make_requests(cfg: Dict, traffic: Dict, seed: int,
                  frames: np.ndarray) -> List[Dict]:
    """The requests' host arrays (the keys ``RefineRunner`` reads, plus
    ``index`` and ``n_valid``)."""
    rng = np.random.default_rng(seed)
    counts = list(traffic["proposals"])
    n = traffic["max_requests"]
    order = np.concatenate([rng.permutation(counts)
                            for _ in range(math.ceil(n / len(counts)))])[:n]
    frame_of = rng.integers(0, frames.shape[1], n)
    I = cfg["max_instances"]
    samples = kitti.car_proposals(rng, n * I).reshape(n, I, 7)
    grid_range = (cfg["y_range"][1] - cfg["y_range"][0],
                  cfg["x_range"][1] - cfg["x_range"][0],
                  cfg["z_range"][1] - cfg["z_range"][0])
    tl, tr = kitti.crop_transforms(samples.reshape(-1, 7), grid_range,
                                   cfg["resolution"], cfg["roi_enlarge"])
    tl, tr = tl.reshape(n, I, 2, 3), tr.reshape(n, I, 2, 3)
    eye = np.eye(2, 3, dtype=np.float32)
    reqs = []
    for i in range(n):
        k = int(order[i])
        f = int(frame_of[i])
        s = np.zeros((I, 7), np.float32)
        s[:k] = samples[i, :k]
        t_l = np.tile(eye, (I, 1, 1))
        t_r = t_l.copy()
        t_l[:k], t_r[:k] = tl[i, :k], tr[i, :k]
        valid = np.zeros(I, bool)
        valid[:k] = True
        reqs.append(dict(
            images_left=frames[0, f:f + 1], images_right=frames[1, f:f + 1],
            P_left=kitti.P_LEFT[None], P_right=kitti.P_RIGHT[None],
            image_idx=np.zeros(I, np.int32), trans_l=t_l, trans_r=t_r,
            samples=s, valid=valid, index=i, n_valid=k))
    return reqs


class Driver:
    """Builds the program for one refinement cell, serves its window and
    checks the sampled requests against the reference."""

    def __init__(self, cell, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, seed, device
        self.traffic = cell.traffic
        self.cfg_dict = cell.config["vernier"]
        self.sampled: Dict[int, Dict] = {}

    # --- set-up ---------------------------------------------------------
    def setup(self):
        from snvc_tpu_torch.config import VernierConfig, load_config
        from snvc_tpu_torch.inference.refine import RefineRunner
        from snvc_tpu_torch.models.vernier import VernierScale

        cfg = load_config(str(self.cell.config_path), VernierConfig)
        with torch.device("meta"):
            model = VernierScale(cfg, device="meta")
        model.to_empty(device=self.device)
        load(model, self._weights(model))
        self.runner = RefineRunner(model, cfg, device=self.device)
        frames = make_frames(self.traffic["frames"], cfg.image_size,
                             self.seed, self.device)
        self.requests = make_requests(self.cfg_dict, self.traffic, self.seed,
                                      frames)
        self.sample = compare.sample_indices(self.cell.workload["sample"],
                                             self.requests, self.seed)
        for req in self.requests[-2:]:  # the one shape of every request
            self.runner.step(req)

    def _weights(self, model):
        return make_weights(float_shapes(model), self.seed, self.device,
                            self.cell.config.get("weights", {}).get("scale"))

    def stages(self):
        return {"encoder": self.runner.model.encoder,
                "head": self.runner.model.head}

    # --- the window -----------------------------------------------------
    def _request(self, i: int) -> Dict:
        req = self.requests[i % len(self.requests)]
        return req if i < len(self.requests) else dict(req, index=i)

    def _keep(self, req, out):
        if req["index"] in self.sample:
            self.sampled[req["index"]] = dict(req=req, out=out)

    def window(self, seconds: float, tracer) -> Dict:
        if self.traffic["loop"] == "run":
            return self._run(seconds, tracer)
        return self._step(seconds, tracer)

    def _run(self, seconds, tracer):
        driver = self
        done = deque()

        class Pipeline:
            def batches(self):
                i = 0
                while True:
                    if i and tracer is not None:
                        tracer.step()
                    if time.perf_counter() - t0 >= seconds:
                        return
                    driver.dispatched = i + 1
                    yield driver._request(i)
                    i += 1

        class Writer:
            def add_batch(self, batch, out):
                done.append(batch["n_valid"])
                driver._keep(batch, out)

        self.dispatched = 0
        t0 = time.perf_counter()
        self.runner.run(Pipeline(), Writer(), progress=False,
                        prefetch=self.traffic["prefetch"])
        window = time.perf_counter() - t0
        return dict(attempted=self.dispatched,
                    failed=self.dispatched - len(done),
                    metrics=dict(refine_inst_per_s=sum(done) / window))

    def _step(self, seconds, tracer):
        lat, i = [], 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            req = self._request(i)
            t = time.perf_counter()
            out = self.runner.step(req)
            lat.append(time.perf_counter() - t)
            self._keep(req, out)
            if tracer is not None:
                tracer.step()
            i += 1
        return dict(attempted=i, failed=0, metrics=dict(
            latency_p90_ms=float(np.percentile(lat, 90)) * 1e3,
            latency_p50_ms=float(np.percentile(lat, 50)) * 1e3))

    # --- the traced run's record ------------------------------------------
    def record(self, tracer, stage_ms, summary, peaks) -> Dict:
        reqs = [self._request(i) for i in tracer.requests()]
        C = ref_vernier.stages(self.cfg_dict["backbone"]["name"])[1][
            "num_channels"][0]
        itemsize = 2 if self.cfg_dict["compute_dtype"] == "bfloat16" else 4
        return dict(trace=summary, requests=len(reqs),
                    units=sum(r["n_valid"] for r in reqs),
                    flops_per_unit=work_flops.refine_flops_per_instance(
                        self.cfg_dict),
                    kernel_work=work_kernels.refine_work(self.cfg_dict, C,
                                                         itemsize),
                    stage_ms=stage_ms, peaks=peaks)

    # --- correctness ----------------------------------------------------
    def _host(self, out) -> Dict[str, np.ndarray]:
        res = {}
        for k in OUTPUT_KEYS + HOST_KEYS:
            v = out[k]
            if isinstance(v, torch.Tensor):
                v = v.float().cpu().numpy()
            res[k] = np.asarray(v, np.float32 if k != "keep" else bool)
        return res

    def check(self) -> Dict:
        """The compared numbers with the workload's limits."""
        return compare.with_limits(self.numbers("float32"),
                                   self.cell.workload["limits"])

    def numbers(self, precision: str) -> Dict[str, float]:
        """The compared numbers of the sampled requests: the program's
        outputs against the float32 reference's, or for the control the
        reference at ``precision`` against the float32 one.  Frees the
        program first."""
        program = {i: (s["req"], self._host(s["out"]))
                   for i, s in sorted(self.sampled.items())}
        unanswered = len(self.sample - set(self.sampled))
        self.sampled.clear()
        self.runner = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return dict(self.compare(program, precision),
                    unanswered=float(unanswered))

    def reference_outputs(self, reqs, precision: str) -> List[Dict]:
        ref = ref_vernier.VernierScale(self.cfg_dict).to(self.device)
        load(ref, self._weights(ref))
        ref_layers.set_precision(ref, precision)
        grid = ref_vernier.grid_local(self.cfg_dict).to(self.device)
        block = self.cell.workload["block"]
        outs = []
        with ref_layers.strict_float32():
            for req in reqs:
                t = {k: torch.as_tensor(req[k]).to(self.device)
                     for k in ("images_left", "images_right", "P_left",
                               "P_right", "image_idx", "trans_l", "trans_r",
                               "samples")}
                outs.append({k: v.numpy() for k, v in ref_vernier.refine(
                    ref, t, grid, block).items()})
        return outs

    def compare(self, program: Dict, precision: str) -> Dict[str, float]:
        items = list(program.values())
        refs = self.reference_outputs([r for r, _ in items], "float32")
        if precision != "float32":  # the control takes the program's place
            got = self.reference_outputs([r for r, _ in items], precision)
        else:
            got = [o for _, o in items]
        numbers = compare.refine_numbers(
            [(r["valid"], g, ref) for (r, _), g, ref in zip(items, got, refs)])
        numbers["finalize_flips"] = sum(
            compare.box_flips(r["valid"], o, self._finalize(r, o))
            for r, o in items)
        return numbers

    def _finalize(self, req, out) -> Dict[str, np.ndarray]:
        """The reference's finalize of the program's own head outputs."""
        t = {k: torch.from_numpy(out[k]).to(self.device)
             for k in ("ncf", "coordinates")}
        with ref_layers.strict_float32():
            res = ref_vernier.finalize(self.cfg_dict, t, torch.from_numpy(
                req["samples"]).to(self.device))
        return {k: v.cpu().numpy() for k, v in res.items()}
