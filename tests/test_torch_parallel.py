"""The port's data-parallel layer (snvc_tpu_torch/parallel/api.py) against
JAX's (snvc_tpu/parallel/api.py), its serving runners on a mesh, and a
training CLI under two ranks, on the CPU.

* ``instance_batch_specs`` names the fields JAX's does, each split or
  replicated as JAX's is; ``shard_instance_batch`` gives each position
  the rows JAX's ``NamedSharding`` puts on that device of a 2-way mesh.
  An indivisible batch and a "model" axis are refused.
* ``RefineRunner`` on a mesh of two CPU devices equals the one-device
  runner bit for bit (eval mode, with the validation losses).
  ``DetectRunner`` on two frames equals, bit for bit, the one-device
  runner serving each frame alone, which is what each position computes;
  against the one-device runner on both frames at once it agrees within
  float32 rounding, since this host's ``F.conv3d`` (oneDNN) gives other
  bits at batch 1 than at batch 2 (6.9e-5 on a [2, 16, 8, 16, 32]
  input; the boxes 2.3e-5 m apart).
* ``train_vernier`` under two gloo ranks (``--device cpu``, 8 instances:
  4 a rank, see tests/test_torch_parallel_train.py) for 2 steps on a
  2-frame tree: one experiment directory, one checkpoint, one metrics
  line a step (rank 0 writes); ``--resume`` continues on both ranks, which
  hold the same parameters.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from snvc_tpu.config import tiny_vernier_config as jtiny
from snvc_tpu.data.synthetic import synthetic_batch_arrays as jbatch
from snvc_tpu.parallel.api import instance_batch_specs as jspecs
from snvc_tpu.parallel.api import make_mesh as jmake_mesh
from snvc_tpu.parallel.api import shard_instance_batch as jshard
from snvc_tpu_torch.config import tiny_stereo_config, tiny_vernier_config
from snvc_tpu_torch.data.stereo import synthetic_stereo_request
from snvc_tpu_torch.data.synthetic import synthetic_batch_arrays
from snvc_tpu_torch.inference.detect import DetectRunner
from snvc_tpu_torch.inference.refine import RefineRunner
from snvc_tpu_torch.models.stereonet import StereoNet
from snvc_tpu_torch.models.vernier import VernierScale
from snvc_tpu_torch.parallel import api
from tests.torch_parallel_ranks import run_ranks, train_vernier_cli

MESH = api.make_mesh(2, ["cpu", "cpu"])


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_instance_batch_specs_match_jax():
    want = {k: tuple(v) for k, v in jspecs().items()}
    assert api.instance_batch_specs() == want
    assert set(want) == set(synthetic_batch_arrays(
        tiny_vernier_config(max_instances=4)))


def test_shard_instance_batch_matches_jax():
    batch = jbatch(jtiny(max_instances=8), seed=0)
    jmesh = jmake_mesh(n_data=2, n_model=1)
    sharded = jshard(batch, jmesh)
    for i, dev in enumerate(jmesh.devices[:, 0]):
        mine = api.shard_instance_batch(batch, MESH, i)
        assert set(mine) == set(batch)
        for k, arr in sharded.items():
            (shard,) = [s for s in arr.addressable_shards if s.device == dev]
            np.testing.assert_array_equal(mine[k], np.asarray(shard.data),
                                          err_msg=f"{k} position {i}")
            if api.instance_batch_specs()[k]:
                assert mine[k].shape[0] == 4, k
            else:
                assert mine[k] is batch[k], k


def test_shards_refuse_an_indivisible_batch():
    mesh = api.make_mesh(3, ["cpu"] * 3)
    batch = synthetic_batch_arrays(tiny_vernier_config(max_instances=8))
    with pytest.raises(ValueError, match="do not split over 3"):
        api.shard_instance_batch(batch, mesh, 0)
    frames = synthetic_stereo_request(tiny_stereo_config(), frames=2)
    with pytest.raises(ValueError, match="do not split over 3"):
        api.shard_batch(frames, mesh, 0)


def test_make_mesh_refuses_the_model_axis_and_too_few_devices():
    """A model axis the devices cannot hold is refused (the one-process
    data x model mesh itself is built: tests/
    test_torch_tensor_parallel.py)."""
    with pytest.raises(ValueError, match="mesh 1x3 needs more than 2"):
        api.make_mesh(1, ["cpu", "cpu"], n_model=3)
    with pytest.raises(ValueError):
        api.make_mesh(3, ["cpu", "cpu"])
    assert MESH.n_data == 2 and MESH.rank is None


def test_one_process_has_no_data_group(monkeypatch):
    """Without a launcher's RANK and without a group: one process, as
    JAX's single-process case; process 0 writes."""
    monkeypatch.delenv("RANK", raising=False)
    assert not torch.distributed.is_initialized()
    assert api.initialize_multihost("gloo", "cpu") is None
    assert api.process_index() == 0
    x = torch.ones(3, requires_grad=True)
    assert api.global_sum(x, None) is x


def test_runners_and_steps_refuse_the_wrong_mesh():
    group_mesh = api.Mesh(MESH.devices, rank=0)
    cfg = tiny_vernier_config(max_instances=4)
    model = VernierScale(cfg, device="cpu")
    with pytest.raises(ValueError, match="make_mesh"):
        RefineRunner(model, cfg, mesh=group_mesh)
    scfg = tiny_stereo_config()
    with pytest.raises(ValueError, match="make_mesh"):
        DetectRunner(StereoNet(scfg, device="cpu"), scfg, mesh=group_mesh)
    from snvc_tpu_torch.config import TrainConfig
    from snvc_tpu_torch.training.train import make_train_step

    with pytest.raises(ValueError, match="initialize_multihost"):
        make_train_step(cfg, TrainConfig(), "cpu", mesh=MESH)


def _host(out):
    return {k: v for k, v in out.items() if v is not None}


def test_refine_runner_on_a_mesh_equals_one_device():
    cfg = tiny_vernier_config(max_instances=8, image_size=(384, 1280))
    arrays = synthetic_batch_arrays(cfg, seed=0)
    keys = RefineRunner.HOST_OUTPUTS + ("ncf", "occupancy", "coordinates")
    outs = []
    for mesh in (None, MESH):
        model = VernierScale(cfg, device="cpu",
                             generator=torch.Generator().manual_seed(1))
        runner = RefineRunner(model, cfg, device="cpu", mesh=mesh)
        outs.append(_host(runner.step(arrays, with_targets=True,
                                      host_outputs=keys)))
    one, meshed = outs
    assert set(one) == set(meshed) and "ncf" in one
    for k, v in one.items():
        if isinstance(v, dict):
            assert v.keys() == meshed[k].keys()
            for kk in v:
                np.testing.assert_array_equal(meshed[k][kk], v[kk], err_msg=k)
        else:
            np.testing.assert_array_equal(meshed[k], v, err_msg=k)


def test_detect_runner_on_a_mesh_equals_one_device():
    cfg = tiny_stereo_config(z_max=38.0, max_depth=40.0)
    req = synthetic_stereo_request(cfg, seed=0, frames=2)

    def runner(mesh):
        model = StereoNet(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(1))
        return DetectRunner(model, cfg, score_threshold=0.0, device="cpu",
                            mesh=mesh)

    meshed = runner(MESH).forward(req)
    one = runner(None)
    alone = [one.forward({k: v[i:i + 1] for k, v in req.items()})
             for i in range(2)]
    both = one.forward(req)
    for j, got in enumerate(meshed):
        assert got.shape[0] == 2
        assert torch.equal(got, torch.cat([a[j] for a in alone])), j
        torch.testing.assert_close(got.float(), both[j].float(), rtol=0,
                                   atol=1e-3)
    assert bool(meshed[3].any())


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dp_cli"))
    chip_smoke.write_kitti_tree(root, frames=2)
    cfg = tiny_vernier_config(max_instances=8, image_size=(384, 1248),
                              usage="train", sup_type="synthetic")
    with open(os.path.join(root, "vernier.json"), "w") as fh:
        json.dump(dataclasses.asdict(cfg), fh)
    return root


def test_train_vernier_cli_on_two_ranks(tree, tmp_path):
    d = os.path.join(tree, "runs", "vernier")
    argv = ["--model_dir", d, "--data_path", tree, "--split", "val",
            "--config", os.path.join(tree, "vernier.json"),
            "--device", "cpu", "--log_every", "1"]
    first = run_ranks(train_vernier_cli, 2, str(tmp_path / "first"),
                      argv + ["--steps", "2"])
    assert [r["step"] for r in first] == [2, 2]
    assert sorted(os.listdir(d)) == ["checkpoints", "config.json",
                                     "metrics.jsonl", "training.log"]
    assert sorted(os.listdir(os.path.join(d, "checkpoints"))) == [
        "2.pt", "config.json"]
    with open(os.path.join(d, "metrics.jsonl")) as fh:
        assert [json.loads(ln)["step"] for ln in fh] == [1, 2]
    resumed = run_ranks(train_vernier_cli, 2, str(tmp_path / "resumed"),
                        argv + ["--steps", "3", "--resume"])
    assert [(r["start_step"], r["step"]) for r in resumed] == [(2, 3)] * 2
    for n, p in resumed[0]["params"].items():
        assert torch.equal(p, resumed[1]["params"][n]), n
    assert any(not torch.equal(p, first[0]["params"][n])
               for n, p in resumed[0]["params"].items())
    assert sorted(os.listdir(os.path.join(d, "checkpoints"))) == [
        "2.pt", "3.pt", "config.json"]
    with open(os.path.join(d, "metrics.jsonl")) as fh:
        assert [json.loads(ln)["step"] for ln in fh] == [1, 2, 3]
