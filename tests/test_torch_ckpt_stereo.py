"""The trained StereoNet checkpoint (artifacts/two_stage_r4/stereo_ckpt,
step 4000: reslike-det-small, 64 planes over 4-40 m) restored by the JAX
package, converted with scripts/convert_jax_checkpoint.py, and run in both
packages in float32 on the CPU on one seeded 96x320 pair over x +-4 m,
z 4-16 m (the voxel sizes, ``ny`` and the planes fix the weight shapes and
stay as trained): depth, cls, reg and centerness agree within 1e-4 of
each output's scale (max |diff| over max |JAX|), the rule of
test_torch_vernier.py.  The committed conversion
(artifacts/two_stage_r4_torch/stereo: 4000.pt, float32, the model alone,
and config.json) equals the script's fresh conversion bit for bit.
"""

import os

import jax
import numpy as np
import pytest
import torch

from scripts.convert_jax_checkpoint import convert, restore_jax_variables
from snvc_tpu.geometry.calib import Calibration as JCalib
from snvc_tpu.models.stereonet import StereoNet as JNet
from snvc_tpu_torch.config import StereoConfig, load_config
from snvc_tpu_torch.models.stereonet import StereoNet
from snvc_tpu_torch.training.train import load_checkpoint
from snvc_tpu_torch.utils.convert_jax import convert_variables

CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "artifacts", "two_stage_r4", "stereo_ckpt")
COMMITTED = os.path.join(os.path.dirname(CKPT), os.pardir,
                         "two_stage_r4_torch", "stereo")
CUT = dict(input_size=(96, 320), x_min=-4.0, x_max=4.0, z_min=4.0,
           z_max=16.0, compute_dtype="float32")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread: the tier-1 command runs this file
    beside five other workers, and torch's thread pool, one thread a core,
    then runs ~20x slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_trained_stereo_checkpoint_matches_jax(tmp_path):
    jcfg, variables, step = restore_jax_variables(CKPT)
    assert step == 4000 and "batch_stats" not in variables
    jcfg = jcfg.replace(**CUT)
    tcfg = load_config(os.path.join(CKPT, "config.json"),
                       StereoConfig).replace(**CUT)
    model = StereoNet(tcfg, device="cpu")
    model.load_state_dict(convert_variables(variables), strict=True)
    assert sum(p.numel() for p in model.parameters()) == 9979092

    rng = np.random.default_rng(1)
    H, W = tcfg.input_size
    left = rng.standard_normal((1, H, W, 3)).astype(np.float32)
    right = rng.standard_normal((1, H, W, 3)).astype(np.float32)
    s = min(H / 375, W / 1242)
    S = np.diag([s, s, 1.0]).astype(np.float32)
    Pl = (S @ JCalib.default().as_array())[None]
    Pr = (S @ JCalib.default_right().as_array())[None]
    want = jax.jit(JNet(jcfg).apply)(variables, left, right, Pl, Pr)
    with torch.no_grad():
        got = model(*(torch.from_numpy(np.ascontiguousarray(a))
                      for a in (left, right, Pl, Pr)))
    for k in ("depth", "cls", "reg", "centerness"):
        w = np.asarray(want[k])
        g = got[k].numpy()
        assert g.shape == w.shape, k
        scale = np.abs(w).max()
        assert scale > 0, k
        assert np.abs(g - w).max() <= 1e-4 * scale, (k, np.abs(g - w).max()
                                                     / scale)

    out = convert(CKPT, str(tmp_path / "stereo"))
    tree, step = load_checkpoint(str(tmp_path / "stereo"))
    assert out.endswith("4000.pt") and step == 4000
    for k, v in model.state_dict().items():
        assert torch.equal(tree["model"][k], v), k

    # the committed conversion the card loads: the same keys in the same
    # order, the same float32 bits, the same config, nothing else
    committed = torch.load(os.path.join(COMMITTED, "4000.pt"),
                           weights_only=True)
    assert sorted(committed) == ["model", "step"]
    assert committed["step"] == 4000
    assert list(committed["model"]) == list(tree["model"])
    for k, v in tree["model"].items():
        assert committed["model"][k].dtype == torch.float32, k
        assert torch.equal(committed["model"][k], v), k
    assert sorted(os.listdir(COMMITTED)) == ["4000.pt", "config.json"]
    with open(os.path.join(COMMITTED, "config.json")) as a, \
            open(os.path.join(CKPT, "config.json")) as b:
        assert a.read() == b.read()
