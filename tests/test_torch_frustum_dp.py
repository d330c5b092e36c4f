"""K4's gradient with respect to P in the port (``FrustumK4``'s backward,
``frustum_to_voxel_dP``, snvc_tpu_torch/ops/frustum.py) against JAX's VJP
of ``frustum_to_voxel_pallas_diff`` (snvc_tpu/ops/frustum_pallas.py:240-
289: the Pallas forward run by the interpreter, ``interpret=True``, as
JAX's own tests run it, and the XLA VJP of the gather form).

Float32 on the CPU, a small volume ([2, 6, 16, 24, 8], BEV 10 x 12 x 4,
depths past both ends of the planes, columns outside the image, per-
sample P).  Every entry of dP is compared, P[:, 2, :2] included (the
kernel's separable forward assumes those entries zero, their gradient is
not): each entry within 2e-4 of itself (the rows of dP differ in scale
by two orders of magnitude, so a tolerance of the largest entry would
not check the small rows).  The two gather forms differ in their float32
rounding of the coordinates only (the planes: d0 + fd of the static
table here, ``depth_plane_coords`` in JAX).  The volume's
gradient of the same call is held to JAX's too (2e-4 of scale, as in
tests/test_torch_frustum.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snvc_tpu.ops.frustum_pallas import frustum_to_voxel_pallas_diff
from snvc_tpu_torch.ops.frustum import (
    frustum_tables,
    frustum_to_voxel_dP,
    frustum_to_voxel_k4,
)

P_TEST = np.array([[80.0, 0, 48.0, 2.0], [0, 80.0, 32.0, -0.3],
                   [0, 0, 1, 0.005]], np.float32)


def _case(seed):
    rng = np.random.default_rng(seed)
    N, D, Hf, Wf, C = 2, 6, 16, 24, 8
    depths = np.linspace(4.0, 30.0, D).astype(np.float32)
    zs = (4.0 + (np.arange(10) + 0.5) * 2.0).astype(np.float32)
    zs[0], zs[-1] = 2.5, 34.0
    xs = (-6.0 + (np.arange(12) + 0.5) * 1.0).astype(np.float32)
    ys = (-1.0 + (np.arange(4) + 0.5) * 0.8).astype(np.float32)
    vol = rng.standard_normal((N, D, Hf, Wf, C)).astype(np.float32)
    P = np.tile(P_TEST[None], (N, 1, 1))
    P[1, 0, 3] += 0.5
    P[1, 1, 2] -= 3.0
    g = rng.standard_normal((N, 10, 12, 4, C)).astype(np.float32)
    return vol, P, depths, zs, xs, ys, g


def _jax_grads(vol, P, depths, zs, xs, ys, g):
    _, vjp = jax.vjp(lambda v, p: frustum_to_voxel_pallas_diff(
        v, p, depths, zs, xs, ys, 4, interpret=True),
        jnp.asarray(vol), jnp.asarray(P))
    dvol, dP = vjp(jnp.asarray(g))
    return np.asarray(dvol), np.asarray(dP)


def _tables(depths, zs, xs, ys):
    d0, fd = frustum_tables(depths, zs)
    return [torch.from_numpy(np.ascontiguousarray(a))
            for a in (d0, fd, zs, xs, ys)]


@pytest.mark.parametrize("seed", [0, 1])
def test_k4_dP_matches_jax_vjp(seed):
    vol, P, depths, zs, xs, ys, g = _case(seed)
    want_dvol, want_dP = _jax_grads(vol, P, depths, zs, xs, ys, g)
    vt = torch.from_numpy(vol).requires_grad_()
    Pt = torch.from_numpy(P).requires_grad_()
    out = frustum_to_voxel_k4(vt, Pt, *_tables(depths, zs, xs, ys), 4)
    out.backward(torch.from_numpy(g))
    got = Pt.grad.numpy()
    assert got.shape == want_dP.shape == (2, 3, 4)
    assert np.abs(want_dP[:, 2, :2]).min() > 0  # the separable form's zeros
    np.testing.assert_allclose(got, want_dP, rtol=2e-4, atol=0)
    np.testing.assert_allclose(vt.grad.numpy(), want_dvol, rtol=0,
                               atol=2e-4 * np.abs(want_dvol).max())


def test_dP_alone_needs_no_volume_gradient():
    """P's gradient with the volume constant: the volume's backward does
    not run, and ``frustum_to_voxel_dP`` gives the same dP."""
    vol, P, depths, zs, xs, ys, g = _case(2)
    tabs = _tables(depths, zs, xs, ys)
    Pt = torch.from_numpy(P).requires_grad_()
    vt = torch.from_numpy(vol)
    frustum_to_voxel_k4(vt, Pt, *tabs, 4).backward(torch.from_numpy(g))
    assert torch.equal(Pt.grad, frustum_to_voxel_dP(
        torch.from_numpy(g), vt, torch.from_numpy(P), *tabs, 4))
