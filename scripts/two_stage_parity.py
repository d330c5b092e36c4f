"""End check of the port's stage 2 with the trained Vernier checkpoint, on
a CPU host with JAX: refine the committed stage-1 proposals
(artifacts/two_stage_r4/proposals, 181 boxes on the 128-frame val split)
with the JAX package and with the port, both in float32 on the CPU, and
score both.

Steps:
  1. re-render the recorded run's val tree,
     ``make_synthetic_kitti(root, 128, 3, seed=1000, split="val")``
     (tools/demo_two_stage.py:473), cached under
     build/two_stage_parity/kitti_val;
  2. convert artifacts/two_stage_r4/vernier_ckpt (step 8000) with
     scripts/convert_jax_checkpoint.py;
  3. refine the proposals with the demo's inference config
     (tools/demo_two_stage.py:349-353: usage "inference", sup_type "real",
     no augmentation, both pred types, argmax decode), once with the JAX
     package and once with the port;
  4. score the proposals and both outputs, each package with its own
     evaluator wrapper, and compare the boxes field by field.

    python scripts/two_stage_parity.py        # ~2 min on 8 CPU cores

Prints one JSON object and writes it to
build/two_stage_parity/result.json.  The recorded run's numbers
(artifacts/two_stage_r4/two_stage.json: proposals 1.3513, refined
all_parts 2.5984, AP3D moderate AP40) came from a bf16 TPU run: the
proposals' value checks the tree and the evaluator; the refined value is a
witness, not a gate.

    python scripts/two_stage_parity.py --witness   # ~6 min

also writes the witnesses the card's ``chip_smoke.py`` phase
``trained_two_stage`` is held to, under
artifacts/two_stage_r4_torch/witness/:
  (a) ``one_part/data``, ``all_parts/data``: JAX's float32 CPU refinement
      of the 181 committed proposals (step 3's output);
  (b) ``stage1/data``: JAX's float32 CPU stage 1 (the trained StereoNet,
      artifacts/two_stage_r4/stereo_ckpt) on the first STAGE1_FRAMES val
      frames at demo_two_stage's stage-1 settings (``--max_proposals 8
      --score_threshold 0.02 --nms_iou 0.25``), beside the port's stage 1
      from the committed conversion (artifacts/two_stage_r4_torch/stereo)
      on the CPU;
  (c) ``witness.json``: both packages' CPU AP3D / APBEV (AP40) of (a) and
      (b), the box comparisons (``snvc_tpu_torch/eval/witness.py``) and
      the settings.
The port's refinement here loads the committed conversion too
(artifacts/two_stage_r4_torch/vernier; tests/test_torch_ckpt_vernier.py
holds it to a fresh conversion bit for bit).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

ART = os.path.join(ROOT, "artifacts", "two_stage_r4")
CONVERTED = os.path.join(ROOT, "artifacts", "two_stage_r4_torch")
WITNESS = os.path.join(CONVERTED, "witness")
WORK = os.path.join(ROOT, "build", "two_stage_parity")
PRED_TYPES = ("one_part", "all_parts")
# box fields h w l x y z ry (KITTI label columns 8-14) agree within this
FIELD_TOL = 1e-3
# stage 1 as demo_two_stage ran it (its --max_proposals, --score_threshold,
# --nms_iou), on the first STAGE1_FRAMES val frames
STAGE1 = dict(max_boxes=8, score_threshold=0.02, nms_iou=0.25)
STAGE1_FRAMES = 16
# box_diffs counts the boxes whose fields part by more than these
BOX_TOL_M, BOX_TOL_DEG = 0.05, 1.0
# refinement batches stage_drift traces, and of those head_layer_drift
DRIFT_BATCHES, LAYER_BATCHES = 16, 4


def _infer_cfg(cfg, dtype="float32"):
    return cfg.replace(usage="inference", sup_type="real", augment=False,
                       pred_type=PRED_TYPES, ncf_decode="argmax",
                       compute_dtype=dtype)


def box_diffs(got, want) -> dict:
    """Per-box differences of two refinements of the same proposals (rows
    h w l x y z ry, in order): the largest of the six metric fields in m
    and the yaw in degrees (wrapped), their medians and maxima, and the
    boxes over BOX_TOL_M or BOX_TOL_DEG."""

    diff = np.abs(got - want)
    metric = diff[:, :6].max(axis=1)
    yaw = np.degrees(np.abs((got[:, 6] - want[:, 6] + np.pi) % (2 * np.pi)
                            - np.pi))
    return dict(median_m=float(np.median(metric)),
                max_m=float(metric.max()),
                median_deg=float(np.median(yaw)), max_deg=float(yaw.max()),
                over=int(((metric > BOX_TOL_M) | (yaw > BOX_TOL_DEG)).sum()))


def _boxes(d):
    out = {}
    for f in sorted(os.listdir(d)):
        with open(os.path.join(d, f)) as fh:
            out[f] = [[float(v) for v in ln.split()[8:15]]
                      for ln in fh.read().splitlines() if ln.strip()]
    return out


def _ap3d(res):
    return res["car"]["detection_3d"]["ap40"]


def _apbev(res):
    return res["car"]["detection_ground"]["ap40"]


def stage1_witness(val_root: str, gt_dir: str) -> dict:
    """(b): JAX's and the port's float32 CPU stage 1 on the first
    STAGE1_FRAMES val frames; JAX's files under WITNESS/stage1; both
    scored, and the port's boxes matched to JAX's."""
    import jax
    import torch

    from scripts.convert_jax_checkpoint import restore_jax_variables
    from snvc_tpu.data.kitti import KittiDataset as JDataset
    from snvc_tpu.eval.kitti_ap import run_kitti_eval as jeval
    from snvc_tpu.inference.detect import DetectRunner as JDetect
    from snvc_tpu_torch.config import StereoConfig
    from snvc_tpu_torch.data.kitti import KittiDataset
    from snvc_tpu_torch.eval.kitti_ap import run_kitti_eval
    from snvc_tpu_torch.eval.witness import compare_matched, read_rows
    from snvc_tpu_torch.inference.detect import DetectRunner
    from snvc_tpu_torch.models.stereonet import StereoNet
    from snvc_tpu_torch.tools._model_dir import read_model_dir

    res = {}
    jcfg, variables, step = restore_jax_variables(
        os.path.join(ART, "stereo_ckpt"))
    jcfg = jcfg.replace(compute_dtype="float32")
    want = os.path.join(WITNESS, "stage1")
    shutil.rmtree(want, ignore_errors=True)
    t = time.perf_counter()
    JDetect(jcfg, variables, **STAGE1).run(
        JDataset(val_root, "val"), want, max_frames=STAGE1_FRAMES,
        prefetch=0)
    res["jax_s"] = round(time.perf_counter() - t, 1)
    del variables
    jax.clear_caches()

    cfg, tree, tstep = read_model_dir(os.path.join(CONVERTED, "stereo"),
                                      StereoConfig)
    assert step == tstep == 4000
    cfg = cfg.replace(compute_dtype="float32")
    model = StereoNet(cfg, device="cpu")
    model.load_state_dict(tree["model"], strict=True)
    got = os.path.join(WORK, "stage1_port")
    shutil.rmtree(got, ignore_errors=True)
    t = time.perf_counter()
    with torch.inference_mode():
        DetectRunner(model, cfg, device="cpu", **STAGE1).run(
            KittiDataset(val_root, "val"), got, max_frames=STAGE1_FRAMES,
            prefetch=0)
    res["port_s"] = round(time.perf_counter() - t, 1)
    frames = sorted(f[:-4] for f in os.listdir(os.path.join(want, "data")))
    assert len(frames) == STAGE1_FRAMES, frames
    cmp = compare_matched(os.path.join(got, "data"),
                          os.path.join(want, "data"), frames,
                          STAGE1["score_threshold"], FIELD_TOL)
    res.update({f"port_vs_jax_{k}": v for k, v in cmp.items()})
    for name, d, ev in (("jax", want, jeval), ("port", got, run_kitti_eval)):
        r = ev(gt_dir, d)
        res[f"ap3d_{name}"], res[f"apbev_{name}"] = _ap3d(r), _apbev(r)
    res["boxes_jax"] = sum(len(b) for b, _ in read_rows(
        os.path.join(want, "data"), frames).values())
    return res


def _rel(a, b) -> float:
    """||a - b|| / ||b|| over the whole arrays (float64)."""
    a, b = (np.asarray(x, np.float64) for x in (a, b))
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _same_argmax(a, b) -> float:
    """The share of (instance, part) NCF maps [I, P, nl, nw] whose argmax
    cells agree."""
    ia = np.asarray(a).reshape(a.shape[0], a.shape[1], -1).argmax(-1)
    ib = np.asarray(b).reshape(b.shape[0], b.shape[1], -1).argmax(-1)
    return float((ia == ib).mean())


def _jax_child_calls(jcfg, head_vars, voxel):
    """JAX's head on ``voxel``, run eagerly, with the first argument and
    the output of each direct child's call recorded (float32 numpy, a
    tuple output's first element), by child name in call order; and the
    head's NCF."""
    import flax.linen as fnn
    import jax.numpy as jnp

    from snvc_tpu.models.vernier import VernierHead as JHead

    calls = {}

    def record(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        m = context.module
        if context.method_name == "__call__" and isinstance(m.parent, JHead):
            y = out[0] if isinstance(out, tuple) else out
            calls[m.name] = tuple(np.array(a.astype(jnp.float32))
                                  for a in (args[0], y))
        return out

    with fnn.intercept_methods(record):
        out = JHead(jcfg).apply(head_vars, voxel)
    return calls, np.asarray(out["ncf"], np.float32)


def _port_child(head, name: str, x):
    """The port's head child ``name`` on ``x``: its main output."""
    import torch

    from snvc_tpu_torch.models.layers import Hourglass, conv2d_nhwc

    child = getattr(head, name)
    if isinstance(child, torch.nn.Conv2d):
        return conv2d_nhwc(x, child)
    if isinstance(child, Hourglass):
        return child(x, None, None)[0]
    return child(x)


def _port_head_with(head, voxel, calls, names):
    """The port's bf16 head on ``voxel`` with each child in ``names``
    returning JAX's recorded output in place of its own: (the input each
    hooked child got, made by the port's own head code, and the NCF)."""
    import torch

    seen = {}
    hooks = []
    for name in calls:
        child = getattr(head, name)

        def pre(mod, args, name=name):
            seen[name] = args[0].float().numpy()

        def post(mod, args, out, name=name):
            y = torch.from_numpy(calls[name][1]).to(torch.bfloat16)
            return (y,) + tuple(out[1:]) if isinstance(out, tuple) else y

        hooks.append(child.register_forward_pre_hook(pre))
        if name in names:
            hooks.append(child.register_forward_hook(post))
    try:
        with torch.inference_mode():
            ncf = head(torch.from_numpy(voxel).to(torch.bfloat16))["ncf"]
    finally:
        for h in hooks:
            h.remove()
    return seen, ncf.float().numpy()


def head_layer_drift(jcfg, head_vars, voxels, heads) -> dict:
    """The bf16 head bisected child by child (``heads``: the port's head
    by dtype, the same weights), on each of JAX's bf16 ``voxels``.
    ``children``: for each direct child of the head, given JAX's bf16
    input to it, the median over the batches of the relative L2
    difference of
      port_vs_jax   the port's bf16 child output from JAX's bf16 output,
      port_rounding the port's bf16 output from its float32 one,
      jax_rounding  JAX's bf16 output from the port's float32 one (the
                    two packages' float32 agree to ~1e-5),
      glue          the input the port's own head code gives the child
                    when every child returns JAX's output, from JAX's
                    input to it (activations, residuals, the occupancy
                    gate, pooling, reshapes; Conv2d children are called
                    outside their module and not hooked: none).
    ``ncf_gap_after``: the median relative L2 difference of the port's
    bf16 NCF from JAX's when the children up to the named one (in call
    order; "none": no child) return JAX's outputs: where the gap between
    the two heads arises."""
    import jax.numpy as jnp
    import torch

    rows, gaps = {}, {}
    for voxel in voxels:
        calls, jncf = _jax_child_calls(jcfg, head_vars,
                                       jnp.asarray(voxel, jnp.bfloat16))
        voxel = np.asarray(voxel, np.float32)
        order = list(calls)
        for i in range(len(order) + 1):
            seen, ncf = _port_head_with(heads["bfloat16"], voxel, calls,
                                        order[:i])
            gaps.setdefault(order[i - 1] if i else "none", []).append(
                _rel(ncf, jncf))
        glue = seen  # every child returning JAX's output
        for name, (x, jb) in calls.items():
            with torch.inference_mode():
                pb = _port_child(heads["bfloat16"], name, torch.from_numpy(
                    x).to(torch.bfloat16)).float().numpy()
                pf = _port_child(heads["float32"], name,
                                 torch.from_numpy(x)).float().numpy()
            r = rows.setdefault(name, {k: [] for k in (
                "port_vs_jax", "port_rounding", "jax_rounding", "glue")})
            r["port_vs_jax"].append(_rel(pb, jb))
            r["port_rounding"].append(_rel(pb, pf))
            r["jax_rounding"].append(_rel(jb, pf))
            if name in glue:
                r["glue"].append(_rel(glue[name], x))
    return {"children": {name: {k: float(np.median(v)) if v else None
                                for k, v in r.items()}
                         for name, r in rows.items()},
            "ncf_gap_after": {k: float(np.median(v))
                              for k, v in gaps.items()}}


def stage_drift(batches, jcfg, variables, tcfg, state, n: int) -> dict:
    """Where the two packages part in bfloat16: the encoder's voxel and
    the head's NCF of the first ``n`` refinement batches, computed by both
    packages in float32 and in bfloat16 from the same weights and
    arrays, and the port's head on JAX's bf16 voxel.  Per pair of runs,
    the median and largest (over the batches) relative L2 difference of
    each tensor and the share of NCF maps whose argmax cells agree (that
    cell is what the argmax decode turns into a box).  ``head_layers``:
    ``head_layer_drift`` on the first LAYER_BATCHES batches."""
    import jax.numpy as jnp
    import torch

    from snvc_tpu.inference.refine import RefineRunner as JRunner
    from snvc_tpu.models.vernier import VernierScale as JVernier
    from snvc_tpu.models.vernier import scope_variables
    from snvc_tpu_torch.inference.refine import RefineRunner
    from snvc_tpu_torch.models.vernier import VernierScale

    runs, port_heads, jax_bf16_voxels = {}, {}, []
    for dt in ("float32", "bfloat16"):
        jc, tc = jcfg.replace(compute_dtype=dt), tcfg.replace(compute_dtype=dt)
        encode, heads, _ = JRunner(JVernier(jc), variables,
                                   jc)._build_programs(False)
        model = VernierScale(tc, device="cpu")
        model.load_state_dict(state, strict=True)
        port_heads[dt] = model.head
        trun = RefineRunner(model, tc, device="cpu")
        jv, jh = (scope_variables(variables, k) for k in ("encoder", "head"))
        for b in batches[:n]:
            arrays = {k: v for k, v in b.arrays().items()}
            jvox = encode(jv, {k: jnp.asarray(v) for k, v in arrays.items()})
            jncf = heads(jh, jvox)["ncf"]
            with torch.inference_mode():
                t_arrays = trun._to_device(arrays, False)
                tvox = trun.encode(t_arrays)
                tncf = trun.heads(tvox)["ncf"]
                runs.setdefault(f"port_{dt}", []).append(
                    (tvox.float().numpy(), tncf.float().numpy()))
                if dt == "bfloat16":  # the port's head on JAX's voxel
                    jax_bf16_voxels.append(jvox)
                    hv = torch.from_numpy(np.asarray(jvox, np.float32)).to(
                        torch.bfloat16)
                    runs.setdefault("port_head_on_jax_voxel", []).append(
                        (None, trun.heads(hv)["ncf"].float().numpy()))
            runs.setdefault(f"jax_{dt}", []).append(
                (np.asarray(jvox, np.float32), np.asarray(jncf, np.float32)))
    pairs = {"jax_bf16_vs_jax_f32": ("jax_bfloat16", "jax_float32"),
             "port_bf16_vs_port_f32": ("port_bfloat16", "port_float32"),
             "port_f32_vs_jax_f32": ("port_float32", "jax_float32"),
             "port_bf16_vs_jax_bf16": ("port_bfloat16", "jax_bfloat16"),
             "port_head_vs_jax_head_on_jax_bf16_voxel": (
                 "port_head_on_jax_voxel", "jax_bfloat16")}
    out = dict(batches=min(n, len(batches)))
    for name, (a, b) in pairs.items():
        row = {}
        for i, what in ((0, "voxel"), (1, "ncf")):
            if runs[a][0][i] is None:
                continue
            r = [_rel(x[i], y[i]) for x, y in zip(runs[a], runs[b])]
            row[f"{what}_rel_median"] = float(np.median(r))
            row[f"{what}_rel_max"] = float(np.max(r))
        row["ncf_same_argmax"] = float(np.mean(
            [_same_argmax(x[1], y[1]) for x, y in zip(runs[a], runs[b])]))
        out[name] = row
    out["head_layers"] = head_layer_drift(
        jcfg.replace(compute_dtype="bfloat16"), jh,
        jax_bf16_voxels[:LAYER_BATCHES], port_heads)
    return out


def write_witness(res, jout, tout, val_root, gt_dir, tcfg, jeval,
                  teval) -> str:
    """(a) JAX's refinement files under WITNESS, (b) ``stage1_witness``,
    (c) witness.json; returns its path."""
    import jax

    refine = {}
    for pt in PRED_TYPES:
        dst = os.path.join(WITNESS, pt, "data")
        shutil.rmtree(os.path.dirname(dst), ignore_errors=True)
        shutil.copytree(os.path.join(jout, pt, "data"), dst)
        refine[pt] = dict(
            boxes=res[f"{pt}_boxes"],
            port_vs_jax_over_tol=res[f"{pt}_boxes_over_tol"],
            ap3d_jax=res[f"{pt}_ap3d_jax"], ap3d_port=res[f"{pt}_ap3d_port"],
            apbev_jax=_apbev(jeval(gt_dir, os.path.join(jout, pt))),
            apbev_port=_apbev(teval(gt_dir, os.path.join(tout, pt))))
    witness = dict(
        note=f"JAX float32 on the CPU (jax {jax.__version__}); AP40 "
        "[easy, moderate, hard] of the Car class",
        val_tree=dict(frames=128, boxes_per_frame=3, seed=1000,
                      split="val"),
        refine=dict(proposals="artifacts/two_stage_r4/proposals/data",
                    checkpoint="artifacts/two_stage_r4/vernier_ckpt (8000)",
                    config=dict(usage=tcfg.usage, sup_type=tcfg.sup_type,
                                augment=tcfg.augment,
                                pred_type=list(tcfg.pred_type),
                                ncf_decode=tcfg.ncf_decode,
                                compute_dtype=tcfg.compute_dtype),
                    field_tol=FIELD_TOL, **refine),
        stage1=dict(checkpoint="artifacts/two_stage_r4/stereo_ckpt (4000)",
                    frames=STAGE1_FRAMES, compute_dtype="float32",
                    field_tol=FIELD_TOL, **STAGE1,
                    **stage1_witness(val_root, gt_dir)))
    path = os.path.join(WITNESS, "witness.json")
    with open(path, "w") as fh:
        json.dump(witness, fh, indent=1)
    return path


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--witness", action="store_true",
                   help="also write the witnesses under " + WITNESS)
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="compute dtype of both refinements (the "
                   "witnesses are float32)")
    args = p.parse_args(argv)
    if args.witness and args.dtype != "float32":
        p.error("--witness writes the float32 witnesses")
    tag = "" if args.dtype == "float32" else "_" + args.dtype

    import jax
    import torch

    jax.config.update("jax_platforms", "cpu")
    from scripts.convert_jax_checkpoint import restore_jax_variables
    from snvc_tpu.data.instance_db import build_db_from_predictions as jdb
    from snvc_tpu.data.kitti import KittiDataset as JDataset
    from snvc_tpu.data.pipeline import RefinementPipeline as JPipe
    from snvc_tpu.data.synthetic import make_synthetic_kitti
    from snvc_tpu.eval.kitti_ap import run_kitti_eval as jeval
    from snvc_tpu.inference.kitti_writer import PredictionWriter as JWriter
    from snvc_tpu.inference.refine import RefineRunner as JRunner
    from snvc_tpu.models.vernier import VernierScale as JVernier
    from snvc_tpu_torch.config import VernierConfig, load_config
    from snvc_tpu_torch.data.instance_db import build_db_from_predictions
    from snvc_tpu_torch.data.kitti import KittiDataset
    from snvc_tpu_torch.data.pipeline import RefinementPipeline
    from snvc_tpu_torch.eval.kitti_ap import run_kitti_eval
    from snvc_tpu_torch.inference.kitti_writer import PredictionWriter
    from snvc_tpu_torch.inference.refine import RefineRunner
    from snvc_tpu_torch.models.vernier import VernierScale
    from snvc_tpu_torch.training.train import load_checkpoint

    torch.set_num_threads(os.cpu_count() or 1)
    t0 = time.perf_counter()
    val_root = os.path.join(WORK, "kitti_val")
    make_synthetic_kitti(val_root, 128, 3, seed=1000, split="val")
    gt_dir = os.path.join(val_root, "training", "label_2")
    # a copy: the evaluator writes its stats files beside the data
    prop_res = os.path.join(WORK, "proposals")
    shutil.rmtree(prop_res, ignore_errors=True)
    shutil.copytree(os.path.join(ART, "proposals", "data"),
                    os.path.join(prop_res, "data"))
    prop_dir = os.path.join(prop_res, "data")
    res = dict(dtype=args.dtype,
               render_s=round(time.perf_counter() - t0, 1))

    # 2. the committed conversion, loaded as the CLIs load it
    ckpt = os.path.join(ART, "vernier_ckpt")
    model_dir = os.path.join(CONVERTED, "vernier")
    tcfg = _infer_cfg(load_config(os.path.join(model_dir, "config.json"),
                                  VernierConfig), args.dtype)
    tree, step = load_checkpoint(model_dir)
    tmodel = VernierScale(tcfg, device="cpu")
    tmodel.load_state_dict(tree["model"], strict=True)
    jcfg, variables, jstep = restore_jax_variables(ckpt)
    jcfg = _infer_cfg(jcfg, args.dtype)
    assert step == jstep == 8000

    # 3. refine in both packages
    t = time.perf_counter()
    jds = JDataset(val_root, "val")
    db = jdb(jds, jcfg, prop_dir)
    jw = JWriter(jcfg)
    JRunner(JVernier(jcfg), variables, jcfg).run(
        JPipe(db, jcfg, training=False, load_lidar=False), writer=jw,
        progress=False)
    jout = jw.write(os.path.join(WORK, "refined_jax" + tag))
    res["jax_refine_s"] = round(time.perf_counter() - t, 1)
    t = time.perf_counter()
    tds = KittiDataset(val_root, "val")
    tdb = build_db_from_predictions(tds, tcfg, prop_dir)
    tw = PredictionWriter(tcfg)
    RefineRunner(tmodel, tcfg, device="cpu").run(
        RefinementPipeline(tdb, tcfg, training=False, load_lidar=False),
        writer=tw, progress=False)
    tout = tw.write(os.path.join(WORK, "refined_port" + tag))
    res["port_refine_s"] = round(time.perf_counter() - t, 1)
    if args.dtype != "float32":
        t = time.perf_counter()
        res["stage_drift"] = stage_drift(
            list(RefinementPipeline(tdb, tcfg, training=False,
                                    load_lidar=False).batches()),
            jcfg, variables, tcfg, tree["model"], DRIFT_BATCHES)
        res["stage_drift_s"] = round(time.perf_counter() - t, 1)
    res["instances"] = len(tdb)

    # 4. score and compare
    res["proposals_ap3d_port"] = _ap3d(run_kitti_eval(gt_dir, prop_res))
    res["proposals_ap3d_jax"] = _ap3d(jeval(gt_dir, prop_res))
    for pt in PRED_TYPES:
        res[f"{pt}_ap3d_port"] = _ap3d(run_kitti_eval(
            gt_dir, os.path.join(tout, pt)))
        res[f"{pt}_ap3d_jax"] = _ap3d(jeval(gt_dir, os.path.join(jout, pt)))
        got = _boxes(os.path.join(tout, pt, "data"))
        want = _boxes(os.path.join(jout, pt, "data"))
        assert list(got) == list(want)
        g = np.array([b for f in got for b in got[f]])
        w = np.array([b for f in want for b in want[f]])
        assert g.shape == w.shape, (g.shape, w.shape)
        diff = np.abs(g - w)
        diff[:, 6] = np.abs((g[:, 6] - w[:, 6] + np.pi) % (2 * np.pi) - np.pi)
        over = diff.max(axis=1) > FIELD_TOL
        res[f"{pt}_boxes"] = len(g)
        res[f"{pt}_boxes_over_tol"] = int(over.sum())
        res[f"{pt}_max_diff_within_tol"] = float(diff[~over].max())
        res[f"{pt}_max_diff_over_tol"] = (float(diff[over].max())
                                          if over.any() else 0.0)
        res[f"{pt}_port_vs_jax"] = box_diffs(g, w)
        res[f"{pt}_moderate_gap"] = round(
            res[f"{pt}_ap3d_port"][1] - res[f"{pt}_ap3d_jax"][1], 4)
    with open(os.path.join(ART, "two_stage.json")) as fh:
        rec = json.load(fh)
    res["recorded_tpu_bf16"] = dict(
        proposals=rec["ap3d_proposals"],
        all_parts=rec["ap3d_refined_all_parts"],
        one_part=rec["ap3d_refined_one_part"])
    if args.witness:
        res["witness"] = write_witness(res, jout, tout, val_root, gt_dir,
                                       tcfg, jeval, run_kitti_eval)
    os.makedirs(WORK, exist_ok=True)
    with open(os.path.join(WORK, f"result{tag}.json"), "w") as fh:
        json.dump(res, fh, indent=1)
    print(json.dumps(res))
    if abs(res["proposals_ap3d_port"][1] - rec["ap3d_proposals"][1]) > 1e-4:
        raise SystemExit("the proposals do not score the recorded AP3D: "
                         "the tree or the evaluator differs")
    # in bfloat16 the two frameworks round at other places (stage_drift
    # measures how far): no gate
    for pt in PRED_TYPES if args.dtype == "float32" else ():
        if abs(res[f"{pt}_moderate_gap"]) > 0.05:
            raise SystemExit(f"{pt}: the port's AP3D moderate is "
                             f"{res[f'{pt}_moderate_gap']} from JAX's")
    return res


if __name__ == "__main__":
    main()
