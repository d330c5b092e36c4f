"""Ranks of the port's data- and tensor-parallel tests
(tests/test_torch_parallel*.py, tests/test_torch_tensor_parallel*.py).

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


@contextlib.contextmanager
def input_shapes(module):
    """The shapes of the first inputs ``module`` is called with while
    open (the list it yields)."""
    shapes = []
    hook = module.register_forward_pre_hook(
        lambda m, args: shapes.append(tuple(args[0].shape)))
    try:
        yield shapes
    finally:
        hook.remove()


@contextlib.contextmanager
def float64_moments(on: bool):
    """GroupNorm's moments in float64 while open (``FastGroupNorm.
    moment_dtype``; float32 otherwise, as JAX's): a float64 step split
    over a model axis sums each moment from slabs, and float32 moments
    would round apart from the whole volume's."""
    from snvc_tpu_torch.models.layers import FastGroupNorm

    if not on:
        yield
        return
    FastGroupNorm.moment_dtype = torch.float64
    try:
        yield
    finally:
        FastGroupNorm.moment_dtype = torch.float32


def vernier_record(cfg, tc, sd, arrays, float64: bool, mesh=None,
                   steps: int = 2) -> dict:
    """``steps_record`` of the Vernier step from the numpy state dict
    ``sd`` on the numpy batch ``arrays``; data-parallel with ``mesh``,
    the voxel's length split over its model axis.  ``voxel_shapes``: the
    shapes of the voxel the head's first conv takes (a step's forward and
    its remat)."""
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
        with input_shapes(model.head.ConvNorm3d_1) as shapes:
            rec = steps_record(state, step, batch_to_device(arrays, "cpu"),
                               steps)
        return dict(rec, voxel_shapes=shapes)


def vernier_steps(rank, cases) -> list:
    """``vernier_record`` of each (config, TrainConfig, numpy state dict,
    numpy global batch, float64) of ``cases``, data-parallel."""
    from snvc_tpu_torch.parallel.api import initialize_multihost

    mesh = initialize_multihost("gloo", "cpu")
    assert mesh.rank == rank and mesh.n_data == 2
    return [vernier_record(*case, mesh=mesh) for case in cases]


def stereo_model(cfg, sd, float64: bool = False):
    """The StereoNet of ``cfg`` on the CPU with the numpy state dict
    ``sd``; with ``float64``, computing in float64 (its compute dtype
    set; the plain K3 / K4 versions, the GroupNorm moments, the depth
    softmax and the RPN maps stay float32)."""
    from snvc_tpu_torch.models.stereonet import StereoNet

    model = StereoNet(cfg, device="cpu")
    model.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
    if float64:
        model.double()
        model.encoder.dtype = model.head.dtype = torch.float64
        head = model.head
        for name in ("bev_zs", "bev_xs", "bev_ys"):  # K4's float32 tables
            setattr(head, name, getattr(head, name).float())
    return model


def stereo_record(cfg, tc, sd, arrays, mesh=None, float64: bool = False,
                  steps: int = 2) -> dict:
    """``steps_record`` of the stereo step from the numpy state dict
    ``sd`` on the numpy batch ``arrays``; data-parallel with ``mesh``,
    the volume's depth split over its model axis; with ``float64``, the
    model in float64 (``stereo_model``) and GroupNorm's moments too
    (``float64_moments``).  ``volume_shapes``: the shapes of the volume
    the 3D stack's first conv takes."""
    from snvc_tpu_torch.training.train_stereo import (
        create_stereo_state,
        make_stereo_train_step,
        stereo_batch_to_device,
    )

    model = stereo_model(cfg, sd, float64)
    state = create_stereo_state(model, tc)
    step = make_stereo_train_step(cfg, tc, "cpu", mesh=mesh)
    with input_shapes(model.head.ConvNorm3d_0) as shapes, \
            float64_moments(float64):
        rec = steps_record(state, step,
                           stereo_batch_to_device(arrays, "cpu"), steps)
    return dict(rec, volume_shapes=shapes)


def stereo_steps(rank, cfg, tc, sd, arrays) -> dict:
    """``stereo_record`` on the global batch ``arrays``, data-parallel."""
    from snvc_tpu_torch.parallel.api import initialize_multihost

    return stereo_record(cfg, tc, sd, arrays,
                         mesh=initialize_multihost("gloo", "cpu"))


def tp_mesh(rank: int, n_model: int):
    """``initialize_multihost``'s mesh of ``n_model`` model ranks, checked
    against its layout ("model" fastest)."""
    from snvc_tpu_torch.parallel.api import initialize_multihost

    mesh = initialize_multihost("gloo", "cpu", n_model=n_model)
    assert (mesh.rank, mesh.n_model) == (rank, n_model)
    assert (mesh.data_index, mesh.model_index) == divmod(rank, n_model)
    return mesh


def tp_stereo(rank, n_model, cfg, tc, sd, arrays, request=None) -> dict:
    """One stereo step in float64 on ``arrays`` (the global batch) over a
    mesh of ``n_model`` model ranks; with ``request``, also
    ``DetectRunner.forward`` on it (float32, a fresh model from ``sd``).
    Rank 0 then computes the one-process references (``one``): the
    same step and runner without a mesh."""
    from snvc_tpu_torch.inference.detect import DetectRunner

    mesh = tp_mesh(rank, n_model)
    rec = dict(step=stereo_record(cfg, tc, sd, arrays, mesh=mesh,
                                  float64=True, steps=1))
    if request is not None:
        runner = DetectRunner(stereo_model(cfg, sd), cfg, device="cpu",
                              score_threshold=0.0, mesh=mesh)
        model = runner.model.head.ConvNorm3d_0
        with input_shapes(model) as shapes:
            out = runner.forward(request)
        rec["detect"] = [t.numpy() for t in out]
        rec["detect_volume_shapes"] = shapes
    if rank == 0:
        rec["one"] = dict(step=stereo_record(cfg, tc, sd, arrays,
                                             float64=True, steps=1))
        if request is not None:
            runner = DetectRunner(stereo_model(cfg, sd), cfg, device="cpu",
                                  score_threshold=0.0)
            rec["one"]["detect"] = [t.numpy()
                                    for t in runner.forward(request)]
    return rec




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


def _layer_cases():
    """name -> (module factory, split axis, input shape, train mode): the
    layers of the port's split stacks at tiny sizes, float64."""
    from snvc_tpu_torch.models import layers as L

    return {
        "conv3d_k3": (lambda: L.Conv3d(4, 6, 3, split_axis=1), 1,
                      (2, 8, 5, 6, 4), False),
        "conv3d_k3_stride2": (lambda: L.Conv3d(4, 6, 3, 2, split_axis=1), 1,
                              (2, 8, 6, 6, 4), False),
        "conv3d_k5_d2_large_tap": (
            lambda: L.Conv3d(4, 6, 5, dilation=2, split_axis=3), 3,
            (1, 5, 4, 16, 4), False),
        "conv3d_k7_large_tap": (lambda: L.Conv3d(4, 6, 7, split_axis=3), 3,
                                (1, 7, 4, 12, 4), False),
        "deconv3d": (lambda: L.ConvTranspose3dFast(4, 6, split_axis=1), 1,
                     (1, 4, 3, 5, 4), False),
        "deconv2d": (lambda: L.ConvTranspose2d(4, 6, split_axis=2), 2,
                     (2, 3, 6, 4), False),
        "convnorm2d": (lambda: L.ConvNorm(4, 8, 3, groups=2, split_axis=2),
                       2, (2, 5, 8, 4), False),
        "convnorm2d_k7": (lambda: L.ConvNorm(4, 8, 7, groups=2,
                                             split_axis=2),
                          2, (2, 5, 8, 4), False),
        # halos of 9 and 5 planes (the split axis's kernel alone)
        "conv3d_k7_d3": (lambda: L.Conv3d(4, 6, (7, 1, 1), dilation=3,
                                          split_axis=1), 1,
                         (1, 16, 3, 3, 4), False),
        "conv3d_k11_length": (lambda: L.Conv3d(4, 6, (1, 1, 11),
                                               split_axis=3), 3,
                              (1, 2, 3, 16, 4), False),
        "groupnorm": (lambda: L.FastGroupNorm(8, 4, split_axis=1), 1,
                      (2, 6, 3, 4, 8), False),
        "batchnorm": (lambda: L.BatchNorm(8, split_axis=1), 1,
                      (2, 6, 3, 4, 8), True),
        "hourglass3d": (lambda: L.Hourglass(4, 3, split_axis=1), 1,
                        (1, 8, 4, 4, 4), False),
        "hourglass_deep2d_batchnorm": (
            lambda: L.HourglassDeep(4, 2, gn=False, split_axis=2), 2,
            (2, 16, 32, 4), True),
    }


LAYER_CASES = tuple(_layer_cases())


@contextlib.contextmanager
def large_tap_any_dtype():
    """``Conv3d`` routes float64 large-tap convs to ``conv3d_large_tap``
    (the K2 wrapper; its plain version on the CPU) while open, as it
    routes bf16 ones."""
    from snvc_tpu_torch.models import layers

    eligible = layers.large_tap_eligible
    layers.large_tap_eligible = (
        lambda k, s, dt, d=1: eligible(k, s, torch.bfloat16, d))
    try:
        yield
    finally:
        layers.large_tap_eligible = eligible


def _rel(a, b) -> float:
    a, b = a.detach(), b.detach()
    assert a.shape == b.shape, (a.shape, b.shape)
    if not b.numel():  # a slab of no plane
        return 0.0
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def layer_setup(name, shape=None):
    """The whole and the split module of layer case ``name`` (equal
    float64 weights, norm scales and biases away from 1, 0), its seeded
    input (of ``shape``, the case's own by default), the seeded weights
    of the output's sum and the case's split axis."""
    from snvc_tpu_torch.models.layers import Hourglass, init_weights

    make, axis, case_shape, train = _layer_cases()[name]
    mods = []
    for _ in range(2):
        m = make().double().train(train)
        init_weights(m, torch.Generator().manual_seed(1))
        g = torch.Generator().manual_seed(2)
        with torch.no_grad():  # norm scales and biases away from 1, 0
            for n, p in m.named_parameters():
                if p.ndim == 1:
                    p.add_(0.1 * torch.randn(p.shape, generator=g,
                                             dtype=p.dtype))
        mods.append(m)
    whole, split = mods
    g = torch.Generator().manual_seed(3)
    x = torch.randn(shape or case_shape, generator=g, dtype=torch.float64)

    def run(mod, inp):
        out = mod(inp)
        return out[0] if isinstance(mod, Hourglass) else out

    xw = x.clone().requires_grad_()
    y = run(whole, xw)
    r = torch.randn(y.shape, generator=g, dtype=torch.float64)
    (y * r).sum().backward()
    return dict(whole=whole, split=split, x=x, xw=xw, y=y, r=r, axis=axis,
                run=run)


def slab_errors(case, dx, ys, split, unit, mesh) -> dict:
    """The split run of ``layer_setup``'s ``case`` (the input slab's
    gradient ``dx``, the output slab ``ys``, ``split``'s parameters with
    their gradients summed over the model positions) against the whole,
    each as the largest difference relative to the whole's scale; the
    slabs' extents beside the whole's."""
    from snvc_tpu_torch.parallel.tensor import shard

    axis = case["axis"]
    y = case["y"]
    # the output's slab of its own extent: in the same units, halved at
    # each stride
    out_unit = max(1, unit * y.shape[axis] // case["x"].shape[axis])
    errs = dict(out=_rel(ys, shard(y, axis, mesh, out_unit)),
                dx=_rel(dx, shard(case["xw"].grad, axis, mesh, unit)),
                extents=(dx.shape[axis], case["x"].shape[axis],
                         ys.shape[axis], y.shape[axis]))
    for (n, p), q in zip(case["whole"].named_parameters(),
                         split.parameters()):
        errs[f"d{n}"] = _rel(q.grad, p.grad)
    for (n, b), c in zip(case["whole"].named_buffers(), split.buffers()):
        errs[n] = _rel(c, b)
    return errs


def _layer_errors(name, mesh, shape=None, unit: int = 1) -> dict:
    """The split module against the whole one, on this rank's slab (of
    ``shape``, in units of ``unit`` planes): the output, the input's
    gradient, the parameters' gradients summed over the model group and
    (train mode) the running statistics, each as the largest difference
    relative to the whole's scale."""
    from snvc_tpu_torch.models.layers import tensor_parallel
    from snvc_tpu_torch.parallel.tensor import shard

    case = layer_setup(name, shape)
    axis, split = case["axis"], case["split"]
    xs = shard(case["x"], axis, mesh, unit).clone().requires_grad_()
    with tensor_parallel(split, mesh):
        ys = case["run"](split, xs)
        out_unit = max(1, unit * case["y"].shape[axis]
                       // case["x"].shape[axis])
        (ys * shard(case["r"], axis, mesh, out_unit)).sum().backward()
    for q in split.parameters():
        if q.grad is None:  # a slab of no plane reaches no weight
            q.grad = torch.zeros_like(q)
        dist.all_reduce(q.grad, group=mesh.model_group)
    return slab_errors(case, xs.grad, ys, split, unit, mesh)


def tp_layers(rank, x, w_halo, w_gather) -> dict:
    """On two ranks: the refusals of ``initialize_multihost`` (an
    ``n_model`` that does not divide the world, one that crosses hosts);
    ``halo_exchange`` (2 planes below, 1 above) and ``gather`` of the
    rank's slab of ``x`` (axis 1) with the gradient of
    sum(halo * w_halo[rank]) + sum(gather * w_gather[rank]); and
    ``_layer_errors`` of every layer case (float64, GroupNorm's moments
    too; the large-tap convs through the K2 wrapper)."""
    from snvc_tpu_torch.parallel.api import initialize_multihost
    from snvc_tpu_torch.parallel.tensor import gather, halo_exchange, shard

    refusals = []
    for n_model, env in ((3, {}), (2, {"LOCAL_WORLD_SIZE": "1"})):
        os.environ.update(env)
        try:
            initialize_multihost("gloo", "cpu", n_model=n_model)
        except ValueError as e:
            refusals.append(str(e))
        finally:
            os.environ.pop("LOCAL_WORLD_SIZE", None)
    mesh = tp_mesh(rank, 2)
    xs = shard(x, 1, mesh).clone().requires_grad_()
    halo = halo_exchange(xs, 1, 2, 1, mesh)
    whole = gather(xs, 1, mesh, x.shape[1])
    ((halo * w_halo[rank]).sum() + (whole * w_gather[rank]).sum()).backward()
    with float64_moments(True), large_tap_any_dtype():
        layers = {name: _layer_errors(name, mesh) for name in LAYER_CASES}
    return dict(refusals=refusals, halo=halo.detach(), gather=whole.detach(),
                dx=xs.grad, layers=layers)


# name -> (layer case, input shape, unit, the two slabs of the split
# axis): short last slabs (also of an odd length under a stride, and
# shorter than the other slab's halo) and empty ones
PADDED_LAYER_CASES = {
    "conv3d_k3_stride2_odd": ("conv3d_k3_stride2", (2, 7, 6, 6, 4), 4,
                              (4, 3)),
    "conv3d_k3_empty": ("conv3d_k3", (2, 3, 5, 6, 4), 4, (3, 0)),
    "conv3d_k5_d2_large_tap_short": ("conv3d_k5_d2_large_tap",
                                     (1, 5, 4, 10, 4), 8, (8, 2)),
    "conv3d_k7_large_tap_empty": ("conv3d_k7_large_tap", (1, 7, 4, 5, 4),
                                  8, (5, 0)),
    "deconv3d_short": ("deconv3d", (1, 3, 3, 5, 4), 2, (2, 1)),
    "deconv2d_empty": ("deconv2d", (2, 3, 6, 4), 8, (6, 0)),
    "convnorm2d_short": ("convnorm2d", (2, 5, 7, 4), 4, (4, 3)),
    "groupnorm_empty": ("groupnorm", (2, 3, 3, 4, 8), 4, (3, 0)),
    "batchnorm_empty": ("batchnorm", (2, 3, 3, 4, 8), 4, (3, 0)),
    "hourglass3d_empty": ("hourglass3d", (1, 4, 8, 8, 4), 4, (4, 0)),
    "hourglass_deep2d_short": ("hourglass_deep2d_batchnorm",
                               (2, 16, 28, 4), 16, (16, 12)),
    "hourglass_deep2d_empty": ("hourglass_deep2d_batchnorm",
                               (2, 16, 12, 4), 16, (12, 0)),
}


def tp_layers_padded(rank, x, w_halo, w_gather, units) -> dict:
    """On two ranks: for each unit of ``units``, ``halo_exchange`` (2
    planes below, 3 above) and ``gather`` of the rank's slab of ``x``
    (axis 1, in that unit: a short slab or an empty one), with the
    gradient of sum(halo * w_halo[rank]) + sum(gather * w_gather[rank]);
    and ``_layer_errors`` of every padded layer case (float64, GroupNorm's
    moments too; the large-tap convs through the K2 wrapper)."""
    from snvc_tpu_torch.parallel.tensor import gather, halo_exchange, shard

    mesh = tp_mesh(rank, 2)
    out = {}
    for unit in units:
        xs = shard(x, 1, mesh, unit).clone().requires_grad_()
        halo = halo_exchange(xs, 1, 2, 3, mesh)
        whole = gather(xs, 1, mesh, x.shape[1], unit)
        ((halo * w_halo[rank][:, :halo.shape[1]]).sum()
         + (whole * w_gather[rank]).sum()).backward()
        out[unit] = dict(halo=halo.detach(), gather=whole.detach(),
                         dx=xs.grad)
    with float64_moments(True), large_tap_any_dtype():
        layers = {name: _layer_errors(case, mesh, shape, unit)
                  for name, (case, shape, unit, _) in
                  PADDED_LAYER_CASES.items()}
    return dict(exchanges=out, layers=layers)


# name -> (layer case, input shape, unit, the slabs of the split axis over
# WIDE_N positions): halos wider than a neighbour's slab, reaching on
# into the slabs beyond (and past a short or an empty last slab)
WIDE_N = 4
WIDE_LAYER_CASES = {
    "conv3d_k5_d2_large_tap_slabs2": ("conv3d_k5_d2_large_tap",
                                      (1, 5, 4, 8, 4), 1, (2, 2, 2, 2)),
    "conv3d_k5_d2_large_tap_short": ("conv3d_k5_d2_large_tap",
                                     (1, 5, 4, 7, 4), 2, (2, 2, 2, 1)),
    "conv3d_k5_d2_large_tap_empty": ("conv3d_k5_d2_large_tap",
                                     (1, 5, 4, 5, 4), 2, (2, 2, 1, 0)),
    "conv3d_k7_large_tap_slabs2": ("conv3d_k7_large_tap", (1, 7, 4, 9, 4),
                                   1, (3, 2, 2, 2)),
    "conv3d_k7_d3_halo9": ("conv3d_k7_d3", (1, 16, 3, 3, 4), 4,
                           (4, 4, 4, 4)),
    "convnorm2d_k7_slabs2": ("convnorm2d_k7", (2, 5, 8, 4), 1,
                             (2, 2, 2, 2)),
    "deconv3d_slabs1": ("deconv3d", (1, 4, 3, 5, 4), 1, (1, 1, 1, 1)),
    "deconv2d_slabs1": ("deconv2d", (2, 3, 4, 4), 1, (1, 1, 1, 1)),
}


def tp_layers_wide(rank) -> dict:
    """On WIDE_N ranks: ``_layer_errors`` of every wide-halo layer case
    (float64, GroupNorm's moments too; the large-tap convs through the
    K2 wrapper)."""
    mesh = tp_mesh(rank, WIDE_N)
    with float64_moments(True), large_tap_any_dtype():
        return {name: _layer_errors(case, mesh, shape, unit)
                for name, (case, shape, unit, _) in
                WIDE_LAYER_CASES.items()}


def one_process_layer_errors(name, mesh, shape=None, unit: int = 1):
    """``layer_setup``'s case ``name`` on the one-process ``mesh``
    (parallel/local.py): each position's replica on its slab (of
    ``shape``, in units of ``unit``), one backward of every position's
    weighted sum.  ``slab_errors`` of each position, in position
    order."""
    import dataclasses

    from snvc_tpu_torch.models.layers import tensor_parallel
    from snvc_tpu_torch.parallel.local import replicas, run_positions
    from snvc_tpu_torch.parallel.tensor import shard

    case = layer_setup(name, shape)
    axis, split = case["axis"], case["split"]
    reps = replicas(split, mesh)
    xl = case["x"].clone().requires_grad_()
    out_unit = max(1, unit * case["y"].shape[axis] // case["x"].shape[axis])

    def position(pos):
        mod = reps[pos.rank]
        xs = shard(xl, axis, pos, unit)
        with tensor_parallel(mod, pos):
            ys = case["run"](mod, xs)
        return ys, (ys * shard(case["r"], axis, pos, out_unit)).sum()

    outs = run_positions(mesh, position)
    sum(loss for _, loss in outs).backward()
    return [slab_errors(case, shard(xl.grad, axis, pos, unit), ys, split,
                        unit, pos)
            for ys, pos in ((ys, dataclasses.replace(mesh, rank=p))
                            for p, (ys, _) in enumerate(outs))]


def tp_vernier(rank, n_model, cases, one_process) -> dict:
    """One Vernier step in float64 (GroupNorm's moments too) for each
    (config, TrainConfig, state dict, batch) of ``cases`` over a mesh of
    ``n_model`` model ranks; rank 0 then takes the one-process step of
    the cases indexed by ``one_process`` (``one``)."""
    mesh = tp_mesh(rank, n_model)
    with float64_moments(True):
        rec = dict(steps=[vernier_record(*case, True, mesh=mesh, steps=1)
                          for case in cases])
        if rank == 0:
            rec["one"] = {i: vernier_record(*cases[i], True, steps=1)
                          for i in one_process}
    return rec
