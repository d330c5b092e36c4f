"""The trained Vernier checkpoint (artifacts/two_stage_r4/vernier_ckpt,
step 8000: hrnet-tiny, an 8x48x48 grid, 128x128 ROIs) restored by the JAX
package, converted with scripts/convert_jax_checkpoint.py, and run in both
packages in float32 on the CPU on one seeded instance: the NCF, occupancy
and part coordinates agree within 1e-4 of each output's scale (max |diff|
over max |JAX|), the rule of test_torch_vernier.py.  The committed
conversion (artifacts/two_stage_r4_torch/vernier: 8000.pt, float32, the
model alone, and config.json) equals the script's fresh conversion bit
for bit.
"""

import os

import jax
import numpy as np
import pytest
import torch

from scripts.convert_jax_checkpoint import convert, restore_jax_variables
from snvc_tpu.models.vernier import VernierScale as JVernier
from snvc_tpu_torch.config import VernierConfig, load_config
from snvc_tpu_torch.models.vernier import VernierScale
from snvc_tpu_torch.training.train import load_checkpoint
from snvc_tpu_torch.utils.convert_jax import convert_variables

CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "artifacts", "two_stage_r4", "vernier_ckpt")
COMMITTED = os.path.join(os.path.dirname(CKPT), os.pardir,
                         "two_stage_r4_torch", "vernier")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread: the tier-1 command runs this file
    beside five other workers, and torch's thread pool, one thread a core,
    then runs ~20x slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_trained_vernier_checkpoint_matches_jax(tmp_path):
    jcfg, variables, step = restore_jax_variables(CKPT)
    assert step == 8000
    jcfg = jcfg.replace(compute_dtype="float32")
    tcfg = load_config(os.path.join(CKPT, "config.json"),
                       VernierConfig).replace(compute_dtype="float32")
    assert (tcfg.grid_resolution, tcfg.resolution) == ((8, 48, 48),
                                                       (128, 128))
    model = VernierScale(tcfg, device="cpu")
    model.load_state_dict(convert_variables(variables), strict=True)

    rng = np.random.default_rng(0)
    H, W = tcfg.resolution
    nh, nw, nl = tcfg.grid_resolution
    left = rng.standard_normal((1, H, W, 3)).astype(np.float32)
    right = rng.standard_normal((1, H, W, 3)).astype(np.float32)
    gpl = rng.uniform(0, W, (1, nh * nw * nl, 2)).astype(np.float32)
    gpr = (gpl - np.array([8.0, 0.0], np.float32)).astype(np.float32)
    want = jax.jit(JVernier(jcfg).apply)(variables, left, right, gpl, gpr)
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in (left, right, gpl, gpr)))
    for k in ("ncf", "occupancy", "coordinates"):
        w = np.asarray(want[k])
        g = got[k].numpy()
        assert g.shape == w.shape, k
        scale = np.abs(w).max()
        assert scale > 0, k
        assert np.abs(g - w).max() <= 1e-4 * scale, (k, np.abs(g - w).max()
                                                     / scale)

    # the script's output loads into the port's model as the CLIs load it
    out = convert(CKPT, str(tmp_path / "vernier"))
    tree, step = load_checkpoint(str(tmp_path / "vernier"))
    assert out.endswith("8000.pt") and step == 8000
    for k, v in model.state_dict().items():
        assert torch.equal(tree["model"][k], v), k

    # the committed conversion the card loads: the same keys in the same
    # order, the same float32 bits, the same config, nothing else
    committed = torch.load(os.path.join(COMMITTED, "8000.pt"),
                           weights_only=True)
    assert sorted(committed) == ["model", "step"]
    assert committed["step"] == 8000
    assert list(committed["model"]) == list(tree["model"])
    for k, v in tree["model"].items():
        assert committed["model"][k].dtype == torch.float32, k
        assert torch.equal(committed["model"][k], v), k
    assert sorted(os.listdir(COMMITTED)) == ["8000.pt", "config.json"]
    with open(os.path.join(COMMITTED, "config.json")) as a, \
            open(os.path.join(CKPT, "config.json")) as b:
        assert a.read() == b.read()
