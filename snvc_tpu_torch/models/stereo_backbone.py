"""2D stereo feature extractor of the global model (port of
snvc_tpu/models/stereo_backbone.py): a ResNet-like trunk of stride 4 with
four spatial-pyramid-pooling branches, giving the 32-channel cost-volume
feature and the RPN image feature.  NHWC in and out.

Children are named as the Flax module names them (``ConvNorm_0`` ...
``ResBlock2d_i`` ... ``Conv_0``), in the order Flax creates them, so JAX
variables load by path (utils/convert_jax.py).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from snvc_tpu_torch.models.layers import ConvNorm, ResBlock2d, conv2d_nhwc

_VARIANTS = {
    # name: (first_dim, dims, blocks, branch_dim, lastconv_dims)
    "reslike-det": (64, (64, 128, 192, 256), (3, 6, 12, 4), 32, (256, 32)),
    "reslike-det-small": (64, (32, 64, 128, 192), (3, 6, 12, 4), 32, (256, 32)),
    "reslike-det-small-fixfirst": (16, (32, 64, 128, 192), (3, 6, 12, 4), 32, (256, 32)),
    "reslike50-det-small-fixfirst": (16, (32, 64, 128, 256), (3, 4, 6, 3), 32, (256, 32)),
    "reslike50-det-tiny": (8, (16, 32, 64, 128), (3, 4, 6, 3), 32, (128, 32)),
    # test-only
    "reslike-micro": (8, (8, 16, 16, 16), (1, 1, 1, 1), 8, (32, 16)),
}

_POOLS = (64, 32, 16, 8)


def _avgpool(x, k: int):
    """Non-overlapping average pooling, floor semantics: crop to a multiple
    of ``k``, then the mean of each k x k window (JAX ``_avgpool``)."""
    N, H, W, C = x.shape
    Ho, Wo = H // k, W // k
    x = x[:, : Ho * k, : Wo * k]
    return x.reshape(N, Ho, k, Wo, k, C).mean(dim=(2, 4))


def _interp_matrix(n_out: int, n_in: int, dtype, device):
    """[n_out, n_in] align_corners=True linear interpolation (hat) weights."""
    if n_in == 1:
        return torch.ones((n_out, 1), dtype=dtype, device=device)
    scale = (n_in - 1) / max(n_out - 1, 1)
    src = torch.arange(n_out, dtype=torch.float32, device=device)[:, None] \
        * scale
    idx = torch.arange(n_in, dtype=torch.float32, device=device)[None, :]
    return torch.clamp(1.0 - (src - idx).abs(), min=0.0).to(dtype)


def _bilinear_resize(x, hw):
    """Separable bilinear upsample, align_corners=True, as two hat-weight
    einsums.

    The JAX function takes this form for sources above 16 x 16 and, for
    the small SPP sources, an explicit loop over source cells (a TPU
    workaround).  Both are the same sum: each output has at most two
    non-zero hat weights per axis, and a zero weight adds an exact zero,
    so the two forms differ only in the rounding order of at most four
    float32 products (a few ulp).  One form serves every size here."""
    N, H, W, C = x.shape
    Ah = _interp_matrix(hw[0], H, x.dtype, x.device)
    Aw = _interp_matrix(hw[1], W, x.dtype, x.device)
    y = torch.einsum("oh,nhwc->nowc", Ah, x)
    return torch.einsum("pw,nowc->nopc", Aw, y)


class StereoFeatureNet(nn.Module):
    """Trunk + SPP branches -> (cost-volume feature, RPN image feature)
    (JAX StereoFeatureNet).  Either output is None when switched off."""

    def __init__(self, backbone: str = "reslike-det-small", gn: bool = True,
                 branch: bool = True, plane_sweep: bool = True,
                 rpn_feature: bool = True, rpn_convdim: int = 64,
                 in_channels: int = 3):
        super().__init__()
        first_dim, dims, blocks, branch_dim, last_dims = _VARIANTS[backbone]
        gn0 = gn if first_dim >= 32 else False
        self.branch = branch
        self._n_conv = 0
        self._n_res = 0

        # stem: stride 2
        self.stem = [self._conv(in_channels, first_dim, 3, 2, 1, gn0),
                     self._conv(first_dim, first_dim, 3, 1, 1, gn0),
                     self._conv(first_dim, first_dim, 3, 1, 1, gn0)]
        cin = first_dim
        layers = []
        specs = ((dims[0], blocks[0], 1, 1, gn if dims[0] >= 32 else False),
                 (dims[1], blocks[1], 2, 1, gn),   # stride 4
                 (dims[2], blocks[2], 1, 1, gn),
                 (dims[3], blocks[3], 1, 2, gn))   # dilated
        for f, n, stride, dil, g in specs:
            layer = []
            for i in range(n):
                layer.append(self._res(cin, f, stride if i == 0 else 1, dil,
                                       g))
                cin = f
            layers.append(layer)
        self.layers = layers
        concat = dims[1] + dims[2] + dims[3]
        self.branches = []
        if branch:
            self.branches = [self._conv(dims[3], branch_dim, 1, 1, 1, gn,
                                        min(32, branch_dim))
                             for _ in _POOLS]
            concat += len(_POOLS) * branch_dim
        # the output convs, kept out of attribute registration so that
        # they keep their Flax names only
        self._out = {}
        if plane_sweep:
            self._out["cv"] = self._conv(concat, last_dims[0], 3, 1, 1, gn)
            self.Conv_0 = nn.Conv2d(last_dims[0], last_dims[1], 1, bias=False)
        if rpn_feature:
            groups = 32 if rpn_convdim % 32 == 0 else 16
            self._out["rpn"] = self._conv(concat, rpn_convdim, 3, 1, 1, gn,
                                          groups)

    def _conv(self, cin, f, k, stride, dilation, gn, groups=32):
        m = ConvNorm(cin, f, k, stride, dilation, gn, groups)
        self.add_module(f"ConvNorm_{self._n_conv}", m)
        self._n_conv += 1
        return m

    def _res(self, cin, f, stride, dilation, gn):
        m = ResBlock2d(cin, f, stride, dilation, gn)
        self.add_module(f"ResBlock2d_{self._n_res}", m)
        self._n_res += 1
        return m

    def forward(self, x):
        h = x
        for m in self.stem:
            h = F.relu(m(h))
        outs = []
        for layer in self.layers:
            for m in layer:
                h = m(h)
            outs.append(h)
        raw, mid, skip = outs[1], outs[2], outs[3]
        feats = [raw, mid, skip]
        if self.branch:
            hw = (skip.shape[1], skip.shape[2])
            for k, m in zip(_POOLS, self.branches):
                kk = min(k, hw[0], hw[1])
                b = F.relu(m(_avgpool(skip, kk)))
                feats.append(_bilinear_resize(b, hw))
        concat = torch.cat(feats, dim=-1)
        cv_feat = rpn_feat = None
        if "cv" in self._out:
            cv_feat = conv2d_nhwc(F.relu(self._out["cv"](concat)), self.Conv_0)
        if "rpn" in self._out:
            rpn_feat = F.relu(self._out["rpn"](concat))
        return cv_feat, rpn_feat
