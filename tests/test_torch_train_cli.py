"""The port's training CLIs (snvc_tpu_torch/tools/train_{vernier,stereo}.py)
with ``--device cpu`` at tiny configs, over chip_smoke.py's seeded KITTI
tree (2 frames x 3 cars, 375x1242, LiDAR):

* the model directory is JAX's ``Experimenter`` layout (config.json,
  training.log, metrics.jsonl, checkpoints/), and ``Experimenter``
  reads a JAX-written config.json;
* checkpoints come at the end of a run, and the loop the CLIs share
  (``tools/_train_loop.train``) writes one every
  ``TrainConfig.checkpoint_every`` steps as well;
* metrics.jsonl has one line a logged step with the keys of JAX's step
  metrics (its losses and ``grad_norm``);
* ``--resume`` restores step, parameters, BatchNorm statistics and AdamW
  state bit for bit; the rate continues; a stereo run stopped and
  resumed ends where an unbroken run ends, bit for bit (its passes are
  ordered by seed + step, as in JAX, and its jitter is seeded by the
  step);
* the checkpoints load into the port's detect and inference_agnostic
  CLIs (``--report_loss`` included), and ``tools/_model_dir.load_model``
  takes both model-directory layouts.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from snvc_tpu.config import VernierConfig as JVernierConfig
from snvc_tpu.config import save_config as jsave_config
from snvc_tpu.models.losses import vernier_losses as jvernier_losses
from snvc_tpu_torch.config import (
    StereoConfig,
    TrainConfig,
    VernierConfig,
    load_config,
    tiny_stereo_config,
    tiny_vernier_config,
)
from snvc_tpu_torch.data.stereo_pipeline import StereoPipeline
from snvc_tpu_torch.models.vernier import VernierScale
from snvc_tpu_torch.tools import detect as cli_detect
from snvc_tpu_torch.tools import inference_agnostic as cli_refine
from snvc_tpu_torch.tools import train_stereo as cli_train_stereo
from snvc_tpu_torch.tools import train_vernier as cli_train_vernier
from snvc_tpu_torch.tools._model_dir import load_model
from snvc_tpu_torch.tools._train_loop import train
from snvc_tpu_torch.training.train import (
    TrainState,
    create_train_state,
    learning_rate,
    load_checkpoint,
    save_checkpoint,
)
from snvc_tpu_torch.utils.logging import Experimenter

VCFG = tiny_vernier_config(max_instances=4, image_size=(384, 1248),
                           usage="train", sup_type="synthetic",
                           use_bbox_head=True, use_part_reg_head=True)
SCFG = tiny_stereo_config(z_max=38.0, max_depth=40.0)
STEREO_KEYS = {"total", "cls", "reg", "centerness", "num_pos", "depth",
               "grad_norm"}  # JAX train_stereo.py:145-160


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One thread (the tier-1 command runs six workers), and the same
    thread count for every run, so the CPU runs repeat bit for bit."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("train_cli"))
    chip_smoke.write_kitti_tree(root, frames=2)
    for name, cfg in (("vernier.json", VCFG), ("stereo.json", SCFG)):
        with open(os.path.join(root, name), "w") as fh:
            json.dump(dataclasses.asdict(cfg), fh)
    return root


def _vernier(tree, model_dir, *extra):
    return cli_train_vernier.main([
        "--model_dir", model_dir, "--data_path", tree, "--split", "val",
        "--config", os.path.join(tree, "vernier.json"), "--device", "cpu",
        "--log_every", "1", *extra])


def _stereo(tree, model_dir, *extra):
    return cli_train_stereo.main([
        "--model_dir", model_dir, "--data_path", tree, "--split", "val",
        "--config", os.path.join(tree, "stereo.json"), "--device", "cpu",
        "--batch_size", "2", "--photometric_aug", "--log_every", "1",
        "--lr", "1e-3", *extra])


def _lines(path):
    with open(path) as fh:
        return [json.loads(ln) for ln in fh]


@pytest.fixture(scope="module")
def vernier_runs(tree):
    d = os.path.join(tree, "runs", "vernier")
    first = _vernier(tree, d, "--steps", "3")
    resumed = _vernier(tree, d, "--steps", "5", "--resume")
    return d, first, resumed


def test_vernier_cli_writes_the_experiment_layout(vernier_runs):
    d, first, resumed = vernier_runs
    assert sorted(os.listdir(d)) == ["checkpoints", "config.json",
                                     "metrics.jsonl", "training.log"]
    # at the end of each run (checkpoint_every is 1000)
    assert sorted(os.listdir(os.path.join(d, "checkpoints"))) == [
        "3.pt", "5.pt", "config.json"]
    assert Experimenter(d).config == VCFG
    assert load_config(os.path.join(d, "checkpoints", "config.json"),
                       VernierConfig) == VCFG
    log = open(os.path.join(d, "training.log")).read()
    assert "step 3:" in log and "resumed from step 3" in log
    assert len(first["save_s"]) == 1 and len(resumed["save_s"]) == 1


def test_vernier_cli_metrics_are_jax_step_metrics(vernier_runs):
    """One line a step, with the keys of JAX's step metrics: its
    ``vernier_losses`` of this config (offset and bbox included) and
    ``grad_norm`` (JAX train.py:141-142)."""
    d, first, resumed = vernier_runs
    rows = _lines(os.path.join(d, "metrics.jsonl"))
    assert [r["step"] for r in rows] == [1, 2, 3, 4, 5]
    B, P = VCFG.max_instances, VCFG.num_parts
    nh, nw, nl = VCFG.grid_resolution
    z = jnp.zeros
    out = dict(ncf=z((B, P, nl, nw)), occupancy=z((B, nh, nw, nl)) + 0.5,
               offset=z((B, 3 * P, nh, nw, nl)), coordinates=z((B, P, 2)),
               bbox=z((B, 5)))
    tgt = dict(ncf=z((B, P, nl, nw)), occupancy=z((B, nh, nw, nl)),
               offset=z((B, 3, P, nh, nw, nl)),
               gt_corners_local=z((B, P, 3)), gt_box_local=z((B, 5)))
    jkeys = set(jvernier_losses(out, tgt, jnp.ones(B, bool),
                                JVernierConfig(use_bbox_head=True,
                                               use_part_reg_head=True))
                 ) | {"grad_norm"}
    for r in rows:
        assert set(r) - {"step"} == jkeys
        assert all(np.isfinite(v) for v in r.values())
    assert rows[:3] == [{"step": i + 1, **m}
                        for i, m in enumerate(first["metrics"])]


def test_vernier_resume_restores_the_state_exactly(vernier_runs, tree):
    d, first, resumed = vernier_runs
    assert first["start_step"] == 0 and first["step"] == 3
    assert resumed["start_step"] == 3 and resumed["step"] == 5
    # the first run's last checkpoint, loaded as --resume loads it (from a
    # directory holding it alone), is the state that run ended with
    only3 = os.path.join(tree, "only3")
    os.makedirs(only3)
    os.link(os.path.join(d, "checkpoints", "3.pt"),
            os.path.join(only3, "3.pt"))
    fresh = create_train_state(
        VernierScale(VCFG, device="cpu",
                     generator=torch.Generator().manual_seed(99)), VCFG,
        TrainConfig())
    _, at = load_checkpoint(only3, fresh)
    assert at == 3
    chip_smoke.assert_states_equal(fresh, first["state"])
    # the resumed run took its rates on from count 3: AdamW's own step
    # counts went on to 5, and the last step's rate is the one at 4
    opt = resumed["state"].optimizer
    assert all(float(s["step"]) == 5.0 for s in opt.state.values())
    want = learning_rate(TrainConfig(total_steps=5), 4)
    assert opt.param_groups[0]["lr"] == want


@pytest.fixture(scope="module")
def stereo_runs(tree, monkeypatch_module):
    """An unbroken 4-step stereo run, and one stopped at 2 and resumed to
    4, with the seed of every pass each asked for."""
    seeds = []
    orig = StereoPipeline.batches

    def recording(self, shuffle=False, seed=0):
        seeds.append(seed)
        return orig(self, shuffle=shuffle, seed=seed)

    monkeypatch_module.setattr(StereoPipeline, "batches", recording)
    runs = {}
    for name, parts in (("whole", [("4", ())]),
                        ("split", [("2", ()), ("4", ("--resume",))])):
        d = os.path.join(tree, "runs", f"stereo_{name}")
        runs[name] = []
        for steps, extra in parts:
            seeds.clear()
            rec = _stereo(tree, d, "--steps", steps, "--seed", "3", *extra)
            runs[name].append((rec, list(seeds)))
        runs[name + "_dir"] = d
    return runs


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_stereo_passes_are_ordered_by_seed_plus_step(stereo_runs):
    """2 frames at batch 2: one batch a pass, so pass k starts at step k
    and is shuffled by seed + k (JAX train_stereo.py:101)."""
    (whole, seeds), = stereo_runs["whole"]
    assert seeds == [3, 4, 5, 6]
    (a, sa), (b, sb) = stereo_runs["split"]
    assert sa == [3, 4] and sb == [5, 6]
    assert b["start_step"] == 2 and b["step"] == 4


def test_stereo_resume_ends_where_an_unbroken_run_ends(stereo_runs):
    (whole, _), = stereo_runs["whole"]
    (_, _), (resumed, _) = stereo_runs["split"]
    chip_smoke.assert_states_equal(whole["state"], resumed["state"])
    assert whole["metrics"][2:] == resumed["metrics"]
    for m in whole["metrics"]:
        assert set(m) == STEREO_KEYS
        assert all(np.isfinite(v) for v in m.values())
    d = stereo_runs["split_dir"]
    assert sorted(os.listdir(os.path.join(d, "checkpoints"))) == [
        "2.pt", "4.pt", "config.json"]
    assert [r["step"] for r in _lines(os.path.join(d, "metrics.jsonl"))] \
        == [1, 2, 3, 4]
    cfg = load_config(os.path.join(d, "config.json"), StereoConfig)
    assert cfg == SCFG.replace(photometric_aug=True)


def test_checkpoints_serve_through_the_clis(tree, vernier_runs,
                                            stereo_runs):
    """detect on the trained stereo directory, inference_agnostic with
    --report_loss on the trained Vernier one (the GT as proposals)."""
    n = cli_detect.main([
        "--model_dir", stereo_runs["whole_dir"], "--data_path", tree,
        "--device", "cpu", "--output_dir", os.path.join(tree, "det"),
        "--max_boxes", "4", "--score_threshold", "0"])
    assert n == 2 * 4
    gt = os.path.join(tree, "training", "label_2")
    props = os.path.join(tree, "gt_props")
    chip_smoke.write_gt_as_predictions(gt, props)
    res = cli_refine.main([
        "--model_dir", vernier_runs[0], "--data_path", tree, "--device",
        "cpu", "--pred_dir", os.path.join(props, "data"), "--output_dir",
        os.path.join(tree, "refined"), "--report_loss", "--prefetch", "1"])
    losses = res["losses"]
    assert len(losses) == 2  # a frame a batch
    for m in losses:
        assert {"ncf", "occupancy", "offset", "coordinates", "bbox",
                "total"} == set(m)
        assert all(np.isfinite(v) for v in m.values())


def test_load_model_takes_both_layouts(tree, vernier_runs):
    """An experiment directory (config.json + checkpoints/) and a flat one
    (<step>.pt beside config.json) give the same model."""
    exp_dir = vernier_runs[0]
    cfg, model, step = load_model(exp_dir, VernierConfig, VernierScale,
                                  "cpu")
    assert cfg == VCFG and step == 5
    flat = os.path.join(tree, "flat_vernier")
    save_checkpoint(flat, create_train_state(model, cfg, TrainConfig()), cfg,
                    7)
    assert sorted(os.listdir(flat)) == ["7.pt", "config.json"]
    cfg2, model2, step2 = load_model(flat, VernierConfig, VernierScale,
                                     "cpu")
    assert cfg2 == cfg and step2 == 7
    for (k, a), b in zip(model.state_dict().items(),
                         model2.state_dict().values()):
        assert torch.equal(a, b), k


class _Linear(torch.nn.Linear):
    device = torch.device("cpu")


def test_train_loop_checkpoints_every_checkpoint_every(tmp_path):
    """The loop alone, with a step that only counts: passes of 3 batches,
    a checkpoint every 2 steps and one at the end, metrics every 3 steps;
    a resumed run goes on from the last checkpoint."""
    exp = Experimenter(str(tmp_path / "exp"), config=VCFG)

    def step_fn(state, batch):
        state.step += 1
        return {"total": torch.tensor(float(state.step))}

    def epoch(step):
        return iter(range(3))

    model = _Linear(2, 2)
    state = TrainState(step=0, model=model, optimizer=torch.optim.AdamW(
        model.parameters()))
    tc = TrainConfig(total_steps=7, checkpoint_every=2)
    rec = train(exp, state, VCFG, tc, step_fn, epoch, False, 3)
    assert rec["step"] == 7 and len(rec["step_s"]) == 7
    assert sorted(os.listdir(exp.checkpoint_dir)) == [
        "2.pt", "4.pt", "6.pt", "7.pt", "config.json"]
    assert len(rec["save_s"]) == 4
    assert rec["metrics"] == [{"total": 3.0}, {"total": 6.0}]
    model = _Linear(2, 2)
    state = TrainState(step=0, model=model, optimizer=torch.optim.AdamW(
        model.parameters()))
    rec = train(exp, state, VCFG, dataclasses.replace(tc, total_steps=9),
                step_fn, epoch, True, 3)
    assert rec["start_step"] == 7 and rec["step"] == 9
    assert sorted(os.listdir(exp.checkpoint_dir)) == [
        "2.pt", "4.pt", "6.pt", "7.pt", "8.pt", "9.pt", "config.json"]
    assert [r["step"] for r in _lines(tmp_path / "exp" / "metrics.jsonl")] \
        == [3, 6, 9]


def test_experimenter_reads_a_jax_config(tmp_path):
    jcfg = JVernierConfig(max_instances=6, use_bbox_head=True)
    jsave_config(jcfg, str(tmp_path / "config.json"))
    exp = Experimenter(str(tmp_path))
    assert exp.config == VernierConfig(max_instances=6, use_bbox_head=True)
    assert exp.checkpoint_dir == str(tmp_path / "checkpoints")
    write = exp.metrics_writer()
    write(1, {"total": 2.5})
    write(2, {"total": 1.5})
    assert _lines(tmp_path / "metrics.jsonl") == [
        {"step": 1, "total": 2.5}, {"step": 2, "total": 1.5}]
    with pytest.raises(FileNotFoundError):
        Experimenter(str(tmp_path / "empty"))


def test_training_clis_default_to_the_card(tree, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the default device is valid")
    for cli, cfg in ((cli_train_vernier, "vernier.json"),
                     (cli_train_stereo, "stereo.json")):
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main(["--model_dir", str(tmp_path / cfg), "--data_path",
                      tree, "--split", "val", "--steps", "1", "--config",
                      os.path.join(tree, cfg)])
