"""Ranks of the port's data-parallel tests (tests/test_torch_parallel*.py).

``run_ranks`` starts each rank with the ``spawn`` method; a rank joins a
gloo group through a ``FileStore`` in the test's temporary directory (no
TCP port, so concurrent test workers cannot collide), runs one of the
functions below with one torch thread and hands its result back through
a file.  The ranks import the port only, never JAX: this module imports
neither, and the JAX witnesses are computed in the test process.
"""

from __future__ import annotations

import contextlib
import multiprocessing
import multiprocessing.connection
import os
import time

import numpy as np
import torch
import torch.distributed as dist


@contextlib.contextmanager
def spawn_ranks(fn, n: int, tmp_dir: str, *args, timeout: float = 150.0):
    """Starts ``fn(rank, *args)`` on ``n`` gloo ranks and yields a
    callable that waits for them and returns their results in rank order,
    so the caller can work while they run.  A rank that fails, or ranks
    that outlive ``timeout`` seconds from their start, fail the wait; on
    leaving the block every rank still running is stopped."""
    ctx = multiprocessing.get_context("spawn")
    os.makedirs(tmp_dir, exist_ok=True)
    store = os.path.join(tmp_dir, "filestore")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, n, store, tmp_dir, args))
             for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout

    def results():
        # until all end, one fails (the others would wait on it) or time
        # is up
        running = list(procs)
        while running and time.monotonic() < deadline:
            multiprocessing.connection.wait(
                [p.sentinel for p in running],
                max(deadline - time.monotonic(), 0.0))
            running = [p for p in procs if p.exitcode is None]
            if any(p.exitcode for p in procs):
                break
        codes = [p.exitcode for p in procs]
        assert codes == [0] * n, (
            f"rank exit codes {codes} (None: still running after "
            f"{timeout} s or stopped when another rank failed)")
        return [torch.load(_result_path(tmp_dir, r), weights_only=False)
                for r in range(n)]

    try:
        yield results
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()


def run_ranks(fn, n: int, tmp_dir: str, *args):
    """``spawn_ranks``, waited for at once."""
    with spawn_ranks(fn, n, tmp_dir, *args) as results:
        return results()


def _result_path(tmp_dir: str, rank: int) -> str:
    return os.path.join(tmp_dir, f"rank{rank}.pt")


def _rank_main(fn, rank, n, store_path, tmp_dir, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, n),
                            rank=rank, world_size=n)
    try:
        torch.save(fn(rank, *args), _result_path(tmp_dir, rank))
    finally:
        dist.destroy_process_group()


def steps_record(state, step, batch, steps: int = 2) -> dict:
    """Metrics of ``steps`` steps; the (summed, clipped) gradients and the
    buffers (BatchNorm statistics) after step 0; the parameters after the
    last step."""
    model = state.model
    metrics, rec = [], {}
    for i in range(steps):
        metrics.append({k: float(v) for k, v in step(state, batch).items()})
        if i == 0:
            rec["grads"] = {n: p.grad.clone()
                            for n, p in model.named_parameters()}
            rec["stats"] = {n: b.clone() for n, b in model.named_buffers()}
    rec["metrics"] = metrics
    rec["params"] = {n: p.detach().clone()
                     for n, p in model.named_parameters()}
    return rec


@contextlib.contextmanager
def vernier_float64(on: bool):
    """The Vernier model computing in float64 while open, as
    tests/test_torch_variants_train.py runs it (its compute dtype patched;
    the sampler's projections, the GroupNorm moments and the losses stay
    float32); the caller makes the model float64 with ``.double()``."""
    from snvc_tpu_torch.models import vernier

    if not on:
        yield
        return
    old = vernier.compute_dtype
    vernier.compute_dtype = lambda name: torch.float64
    try:
        yield
    finally:
        vernier.compute_dtype = old


def vernier_record(cfg, tc, sd, arrays, float64: bool, mesh=None) -> dict:
    """``steps_record`` of the Vernier step from the numpy state dict
    ``sd`` on the numpy batch ``arrays``; data-parallel with ``mesh``."""
    from snvc_tpu_torch.models.vernier import VernierScale
    from snvc_tpu_torch.training.train import (
        batch_to_device,
        create_train_state,
        make_train_step,
    )

    with vernier_float64(float64):
        model = VernierScale(cfg, device="cpu")
        model.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
        if float64:
            model.double()
        state = create_train_state(model, cfg, tc)
        step = make_train_step(cfg, tc, "cpu", mesh=mesh)
        return steps_record(state, step, batch_to_device(arrays, "cpu"))


def vernier_steps(rank, cases) -> list:
    """``vernier_record`` of each (config, TrainConfig, numpy state dict,
    numpy global batch, float64) of ``cases``, data-parallel."""
    from snvc_tpu_torch.parallel.api import initialize_multihost

    mesh = initialize_multihost("gloo", "cpu")
    assert mesh.rank == rank and mesh.n_data == 2
    return [vernier_record(*case, mesh=mesh) for case in cases]


def stereo_record(cfg, tc, sd, arrays, mesh=None) -> dict:
    """``steps_record`` of the stereo step from the numpy state dict
    ``sd`` on the numpy batch ``arrays``; data-parallel with ``mesh``."""
    from snvc_tpu_torch.models.stereonet import StereoNet
    from snvc_tpu_torch.training.train_stereo import (
        create_stereo_state,
        make_stereo_train_step,
        stereo_batch_to_device,
    )

    model = StereoNet(cfg, device="cpu")
    model.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
    state = create_stereo_state(model, tc)
    step = make_stereo_train_step(cfg, tc, "cpu", mesh=mesh)
    return steps_record(state, step, stereo_batch_to_device(arrays, "cpu"))


def stereo_steps(rank, cfg, tc, sd, arrays) -> dict:
    """``stereo_record`` on the global batch ``arrays``, data-parallel."""
    from snvc_tpu_torch.parallel.api import initialize_multihost

    return stereo_record(cfg, tc, sd, arrays,
                         mesh=initialize_multihost("gloo", "cpu"))


def train_vernier_cli(rank, argv) -> dict:
    """``train_vernier.main(argv)`` on this rank: the step it reached and
    its parameters."""
    from snvc_tpu_torch.tools import train_vernier

    rec = train_vernier.main(argv)
    model = rec["state"].model
    return dict(start_step=rec["start_step"], step=rec["step"],
                params={n: p.detach().clone()
                        for n, p in model.named_parameters()})


def as_numpy(arrays) -> dict:
    """A batch or a state dict as numpy arrays, which go to a rank by
    value (tensors would go through shared memory); copies."""
    return {k: np.array(v) for k, v in arrays.items()}
