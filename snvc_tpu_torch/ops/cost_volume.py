"""Plane-sweep stereo cost volume (port of snvc_tpu/ops/cost_volume.py),
and kernel K3.

For each depth plane d the volume concatenates the left features with the
right features read at x - shift[d] (linear in x, zeros outside):
[N, H, W, C] x2 -> [N, D, H', W', 2C], depth-major NDHWC.

  * ``plane_sweep_volume`` / ``_plane_sweep_xla_any``: the JAX package's
    gather form, any ``downsample``, shared [D] or per-sample [N, D]
    shifts.
  * ``plane_sweep_shifted``: the plain version of K3, the contract of
    the Pallas kernel ``_psv_kernel`` (snvc_tpu/ops/cost_volume.py:119, via
    ``_psv_pallas_fwd``), downsample 1:
        out[..., C:] = fs * right[x - ks - 1] + (1 - fs) * right[x - ks],
    ks = floor(s), fs = s - ks, computed in float32 and rounded once.
  * ``plane_sweep_volume_k3``: the wrapper of the CUDA kernel
    (csrc/plane_sweep_volume.cu), differentiable through ``PlaneSweepK3``.
    A CPU tensor goes to ``plane_sweep_shifted``; a CUDA tensor goes to
    the kernel or raises.  No plane (the slab of a model position that
    holds none) gives the empty volume, and zeros backward, without a
    launch.
  * ``plane_sweep_shifted_bwd`` / ``plane_sweep_volume_k3_bwd``: the
    backward, plain and kernel.  JAX takes the VJP of the gather form
    through XLA (``_psv_bwd``, snvc_tpu/ops/cost_volume.py:160-169) and
    gives the shifts a zero gradient; here the shifts get none.

The Pallas kernel streams the right features through VMEM as two dynamic
W-slices per (sample, plane, 128 lanes), in float32, and the left half is
concatenated by a separate XLA pass.  The CUDA kernel writes both halves
in one pass.  A block owns one feature row (n, h) and a group of planes:
it copies the left and right rows into shared memory once, then writes
each plane's [W, 2C] slab, which is contiguous in the output, with
streaming 16-byte stores; the channel group and the first column come
from the thread's index, the plane from a loop, so nothing is divided.
``k3_tiling`` picks the block and the plane group.

Bound: bytes.  At the serving shape ([1, 96, 312, 32] bf16 features, 64
planes) the kernel writes the 245.4 MB volume and reads 3.8 MB, ~0.074 ms
at 3.35 TB/s.

The backward is the transpose: dleft sums the gradient's left half over
the planes, and each dright column gathers the two right-half columns
that read it, x + k_d (weight 1 - f_d) and x + k_d + 1 (weight f_d),
k_d = floor(s_d), f_d = s_d - k_d.  Per plane the shift is uniform, so
the kernel needs no atomics: a block owns a tile of columns of one
feature row and loops over the planes, each thread summing one 16-byte
channel group of one column in float32 registers, written once
(``k3_bwd_tiling``).  Bound: bytes, the gradient read once (245.4 MB at
the training shape, ~0.074 ms).

Both branches of the forward and of the backward declare ``k3_work`` /
``k3_bwd_work`` to an open ``utils.cost`` counter.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from snvc_tpu_torch.ops.stereo_sample_cuda import SMEM_LIMIT, SMEM_PER_SM
from snvc_tpu_torch.utils.cost import Work, declare_kernel


def plane_sweep_volume(left, right, shifts, downsample: int = 1):
    """Gather form (JAX ``plane_sweep_volume``): left/right [N, H, W, C];
    shifts [D] float disparities (>= 0).  Returns [N, D, H//ds, W//ds, 2C].
    The taps are weighted in the features' dtype, as in JAX."""
    N, H, W, C = left.shape
    ds = downsample
    Ho, Wo = H // ds, W // ds
    xs = torch.arange(Wo, dtype=shifts.dtype, device=shifts.device) * ds
    x_src = xs[None, :] - shifts[:, None]  # [D, Wo]
    x0 = torch.floor(x_src)
    frac = (x_src - x0).to(left.dtype)
    x0i = x0.to(torch.int64)

    def tap(xi):
        valid = ((xi >= 0) & (xi < W)).to(left.dtype)
        g = right[:, :, xi.clamp(0, W - 1)]  # [N, H, D, Wo, C]
        return g * valid[None, None, :, :, None]

    r = tap(x0i) * (1.0 - frac)[None, None, :, :, None] \
        + tap(x0i + 1) * frac[None, None, :, :, None]
    r = r[:, ::ds].movedim(2, 1)  # [N, D, Ho, Wo, C]
    lt = left[:, ::ds, ::ds][:, None].expand(r.shape)
    return torch.cat([lt, r], dim=-1)


def _plane_sweep_xla_any(left, right, shifts, downsample: int = 1):
    """Gather form for a shared [D] or a per-sample [N, D] shift table."""
    if shifts.ndim == 2:
        return torch.cat([
            plane_sweep_volume(left[i:i + 1], right[i:i + 1], shifts[i],
                               downsample)
            for i in range(left.shape[0])])
    return plane_sweep_volume(left, right, shifts, downsample)


def k3_work(N: int, D: int, H: int, W: int, C: int, itemsize: int,
            n_shifts: int) -> Work:
    """K3's work for [N, H, W, C] features of ``itemsize`` bytes and
    ``n_shifts`` float32 shifts: both maps and the shifts read once, the
    [N, D, H, W, 2C] volume written once; float32 operations: the lerp of
    the right half, 2 multiplies and an add per element."""
    out = N * D * H * W * 2 * C
    return Work(1.5 * out, (2 * N * H * W * C + out) * itemsize
                + 4 * n_shifts)


def k3_bwd_work(N: int, D: int, H: int, W: int, C: int, itemsize: int,
                n_shifts: int) -> Work:
    """K3's backward: the [N, D, H, W, 2C] gradient and the shifts read
    once, both feature gradients written once; an add per left element and
    plane, two multiplies and two adds per right element and plane."""
    g = N * D * H * W * 2 * C
    return Work(2.5 * g, (g + 2 * N * H * W * C) * itemsize + 4 * n_shifts)


def _shift_table(shifts, N: int):
    if shifts.ndim == 1:
        return shifts[None].expand(N, -1)
    if shifts.ndim != 2 or shifts.shape[0] != N:
        raise ValueError(f"shifts must be [D] or [{N}, D], got "
                         f"{tuple(shifts.shape)}")
    return shifts


def plane_sweep_shifted(left, right, shifts):
    """Plain version of K3 (the Pallas kernel's contract), downsample 1.

    left/right [N, H, W, C]; shifts [D] or [N, D] float32, >= 0.  The right
    half is lerped in float32 and rounded once to the features' dtype;
    taps left of column 0 are zero.  Returns [N, D, H, W, 2C]."""
    N, H, W, C = left.shape
    s = _shift_table(shifts, N).float()
    D = s.shape[1]
    ks = torch.floor(s)
    fs = s - ks
    x = torch.arange(W, device=left.device)
    # ks >= 0 keeps every tap at or left of x; column -1 of the padded row
    # (index 0) is the zero that every tap further left reads
    ksi = ks.clamp(max=W + 1).to(torch.int64)[..., None]  # [N, D, 1]
    i0 = (x - ksi - 1).clamp(min=-1) + 1
    i1 = (x - ksi).clamp(min=-1) + 1
    rpad = F.pad(right.float(), (0, 0, 1, 0))  # [N, H, W + 1, C]
    n = torch.arange(N, device=left.device)[:, None, None]
    a = rpad[n, :, i0].permute(0, 1, 3, 2, 4)  # [N, D, H, W, C]
    b = rpad[n, :, i1].permute(0, 1, 3, 2, 4)
    fs = fs[..., None, None, None]
    r = (a * fs + b * (1.0 - fs)).to(left.dtype)
    lt = left[:, None].expand(N, D, H, W, C)
    return torch.cat([lt, r], dim=-1)


_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
K3_THREADS = 256  # threads a block aims for
K3_MAX_PLANES = 8  # planes a block writes at most
K3_WAVES = 4  # blocks per resident slot of the card, at least


class K3Tiling(NamedTuple):
    """The kernel's launch: ``block`` = (G, BY) threads (G 16-byte channel
    groups of one half, BY first columns), ``planes`` consecutive planes per
    block, ``smem`` bytes of shared memory (both feature rows), ``blocks``
    = N * H * ceil(D / planes) in all, on a grid (H, N, ceil(D / planes))."""
    block: Tuple[int, int]
    planes: int
    smem: int
    blocks: int


def k3_tiling(N: int, D: int, H: int, W: int, C: int, dtype,
              sms: int = 132) -> K3Tiling:
    """The launch of K3 for [N, H, W, C] features of ``dtype`` and D
    planes on a card of ``sms`` SMs: BY = 256 / G threads along the row
    (at most W), and as many planes per block (at most 8) as still give
    every resident block slot of the card 4 blocks, so the last wave's
    tail is short (scripts/k34_variants.py: 1-4 planes a block time alike
    at the serving shape, 8 planes in 768 blocks ~14 % slower).  Raises
    ValueError when the two rows do not fit a block's shared memory or G
    exceeds a block's threads."""
    esize = dtype.itemsize
    vec = 16 // esize
    if C % vec:
        raise ValueError(f"C={C} must be a multiple of {vec}")
    G = C // vec
    if G > 1024:
        raise ValueError(f"plane_sweep_volume: {G} channel groups exceed a "
                         f"block's 1024 threads")
    smem = 2 * W * C * esize
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"plane_sweep_volume: two [{W}, {C}] feature rows ({smem} bytes) "
            f"exceed a block's {SMEM_LIMIT} bytes of shared memory")
    by = max(1, min(W, K3_THREADS // G))
    per_sm = min(2048 // (G * by), SMEM_PER_SM // (smem + 1024), 32)
    planes = max(1, min(K3_MAX_PLANES, D,
                        N * H * D // (K3_WAVES * sms * per_sm)))
    return K3Tiling((G, by), planes, smem, N * H * -(-D // planes))


def plane_sweep_shifted_bwd(grad, shifts, W: int):
    """Plain backward of K3, written as the kernel computes it: grad
    [N, D, H, W, 2C] -> (dleft, dright) [N, H, W, C] in grad's dtype.

        dleft[x]  = sum_d grad[d, x, :C]
        dright[x] = sum_d (1 - f_d) grad[d, x + k_d, C:]
                          + f_d grad[d, x + k_d + 1, C:]

    over in-range columns, k_d = floor(s_d), f_d = s_d - k_d; summed in
    float32 and rounded once."""
    N, D, H, _, C2 = grad.shape
    C = C2 // 2
    s = _shift_table(shifts, N).float()
    ks = torch.floor(s)
    fs = (s - ks)[..., None, None, None]  # [N, D, 1, 1, 1]
    gf = grad.float()
    dleft = gf[..., :C].sum(1)
    # column W of the padded gradient is the zero every tap past the row
    # reads (shifts >= 0 keep every tap at or right of x)
    gpad = F.pad(gf[..., C:], (0, 0, 0, 1))  # [N, D, H, W + 1, C]
    ksi = ks.clamp(max=W + 1).to(torch.int64)[..., None]  # [N, D, 1]
    x = torch.arange(W, device=grad.device)
    i0 = (x + ksi).clamp(max=W)
    i1 = (x + ksi + 1).clamp(max=W)
    n = torch.arange(N, device=grad.device)[:, None, None]
    d = torch.arange(D, device=grad.device)[None, :, None]
    b = gpad[n, d, :, i0].permute(0, 1, 3, 2, 4)  # [N, D, H, W, C]
    a = gpad[n, d, :, i1].permute(0, 1, 3, 2, 4)
    dright = (b * (1.0 - fs) + a * fs).sum(1)
    return dleft.to(grad.dtype), dright.to(grad.dtype)


def _psv_forward(left, right, shifts):
    """The forward of ``PlaneSweepK3``: the plain version on the CPU, the
    kernel on the card."""
    if not left.is_cuda:
        return plane_sweep_shifted(left, right, shifts)
    dt = left.dtype
    if dt not in _DTYPES or right.dtype != dt:
        raise TypeError(f"plane_sweep_volume_k3 takes bf16 or f32 features, "
                        f"got {dt}/{right.dtype}")
    if shifts.dtype != torch.float32:
        raise TypeError(f"shifts must be float32, got {shifts.dtype}")
    if left.ndim != 4 or right.shape != left.shape:
        raise ValueError(f"left {tuple(left.shape)} and right "
                         f"{tuple(right.shape)} must be equal [N, H, W, C]")
    N, H, W, C = left.shape
    table = _shift_table(shifts, N)
    if not all(t.is_cuda and t.device == left.device
               for t in (right, shifts)):
        raise ValueError("left, right and shifts must lie on one CUDA device")
    if not (left.is_contiguous() and right.is_contiguous()
            and shifts.is_contiguous()):
        raise ValueError("left, right and shifts must be contiguous")
    if left.data_ptr() % 16 or right.data_ptr() % 16:
        raise ValueError("left and right must be 16-byte aligned")
    D = table.shape[1]
    out = torch.empty((N, D, H, W, 2 * C), dtype=dt, device=left.device)
    if out.numel() == 0:  # a slab of no plane: no launch
        return out
    t = k3_tiling(N, D, H, W, C, dt, torch.cuda.get_device_properties(
        left.device).multi_processor_count)
    from snvc_tpu_torch._build import error_string, load_library

    lib = load_library("plane_sweep_volume")
    stream = torch.cuda.current_stream(left.device).cuda_stream
    err = lib.snvc_plane_sweep_volume(
        left.data_ptr(), right.data_ptr(), shifts.data_ptr(), out.data_ptr(),
        N, D, H, W, C, 0 if shifts.ndim == 1 else D, t.block[1], t.planes,
        _DTYPES[dt], stream)
    if err != 0:
        raise RuntimeError(f"plane_sweep_volume launch failed: "
                           f"{error_string(lib, err)}")
    plane_sweep_volume_k3.launches += 1
    return out


K3_BWD_THREADS = 256  # threads a backward block aims for


class K3BwdTiling(NamedTuple):
    """The backward's launch: ``block`` = (G, BX) threads (G 16-byte
    channel groups of one half, BX columns), ``blocks`` = N * H *
    ceil(W / BX) in all, on a grid (ceil(W / BX), H, N)."""
    block: Tuple[int, int]
    blocks: int


def k3_bwd_tiling(N: int, H: int, W: int, C: int, dtype,
                  sms: int = 132) -> K3BwdTiling:
    """The launch of K3's backward for a [N, D, H, W, 2C] gradient of
    ``dtype`` on a card of ``sms`` SMs: BX = 256 / G columns a block (at
    most W), halved down to 32 while the grid has fewer than 4 blocks per
    SM.  Raises ValueError when G exceeds a block's threads."""
    vec = 16 // dtype.itemsize
    if C % vec:
        raise ValueError(f"C={C} must be a multiple of {vec}")
    G = C // vec
    if G > 1024:
        raise ValueError(f"plane_sweep_volume_bwd: {G} channel groups "
                         f"exceed a block's 1024 threads")
    bx = max(1, min(W, K3_BWD_THREADS // G))
    while bx > 32 and N * H * -(-W // bx) < 4 * sms:
        bx //= 2
    return K3BwdTiling((G, bx), N * H * -(-W // bx))


def plane_sweep_volume_k3_bwd(grad, shifts, W: int):
    """Backward of K3: grad [N, D, H, W, 2C] and the forward's shifts ->
    (dleft, dright) [N, H, W, C] in grad's dtype.  A CPU tensor goes to
    ``plane_sweep_shifted_bwd``; a CUDA tensor to the kernel, or raises."""
    N, D, H = grad.shape[:3]
    with declare_kernel("K3_bwd", k3_bwd_work, N, D, H, W,
                        grad.shape[-1] // 2, grad.element_size(),
                        shifts.numel()):
        return _k3_bwd(grad, shifts, W)


def _k3_bwd(grad, shifts, W: int):
    if not grad.is_cuda:
        return plane_sweep_shifted_bwd(grad, shifts, W)
    dt = grad.dtype
    if dt not in _DTYPES:
        raise TypeError(f"plane_sweep_volume_k3_bwd takes bf16 or f32, "
                        f"got {dt}")
    if shifts.dtype != torch.float32:
        raise TypeError(f"shifts must be float32, got {shifts.dtype}")
    if grad.ndim != 5 or grad.shape[3] != W or grad.shape[4] % 2:
        raise ValueError(f"grad must be [N, D, H, {W}, 2C], got "
                         f"{tuple(grad.shape)}")
    N, D, H, _, C2 = grad.shape
    C = C2 // 2
    table = _shift_table(shifts, N)
    if table.shape[1] != D:
        raise ValueError(f"{D} planes but {table.shape[1]} shifts")
    if not (shifts.is_cuda and shifts.device == grad.device):
        raise ValueError("grad and shifts must lie on one CUDA device")
    if not (grad.is_contiguous() and shifts.is_contiguous()):
        raise ValueError("grad and shifts must be contiguous")
    if grad.numel() == 0:  # a slab of no plane: zeros, no launch
        dleft = grad.new_zeros((N, H, W, C))
        return dleft, torch.zeros_like(dleft)
    if grad.data_ptr() % 16:
        raise ValueError("grad must be 16-byte aligned")
    t = k3_bwd_tiling(N, H, W, C, dt, torch.cuda.get_device_properties(
        grad.device).multi_processor_count)
    dleft = torch.empty((N, H, W, C), dtype=dt, device=grad.device)
    dright = torch.empty_like(dleft)
    from snvc_tpu_torch._build import error_string, load_library

    lib = load_library("plane_sweep_volume")
    stream = torch.cuda.current_stream(grad.device).cuda_stream
    err = lib.snvc_plane_sweep_volume_bwd(
        grad.data_ptr(), shifts.data_ptr(), dleft.data_ptr(),
        dright.data_ptr(), N, D, H, W, C, 0 if shifts.ndim == 1 else D,
        t.block[1], _DTYPES[dt], stream)
    if err != 0:
        raise RuntimeError(f"plane_sweep_volume_bwd launch failed: "
                           f"{error_string(lib, err)}")
    plane_sweep_volume_k3_bwd.launches += 1
    return dleft, dright


class PlaneSweepK3(torch.autograd.Function):
    """K3 with its backward; the shifts get no gradient (JAX gives them
    zeros)."""

    @staticmethod
    def forward(ctx, left, right, shifts):
        ctx.save_for_backward(shifts)
        ctx.W = left.shape[2]
        return _psv_forward(left, right, shifts)

    @staticmethod
    def backward(ctx, grad):
        (shifts,) = ctx.saved_tensors
        dleft, dright = plane_sweep_volume_k3_bwd(grad.contiguous(), shifts,
                                                  ctx.W)
        need = ctx.needs_input_grad
        return (dleft if need[0] else None, dright if need[1] else None,
                None)


def plane_sweep_volume_k3(left, right, shifts):
    """Kernel K3: [N, H, W, C] x2, shifts [D] or [N, D] float32 (>= 0) ->
    [N, D, H, W, 2C], differentiable in left and right.  See module
    docstring.  A negative shift in a host table raises.  A CUDA table is
    not read back to check it: the caller that holds the values on the
    host checks them (``data/stereo.check_stereo_projections``), and the
    kernel zeroes every tap outside [0, W), so a negative shift reads
    nothing out of bounds."""
    N, H, W, C = left.shape
    with declare_kernel("K3", k3_work, N, shifts.shape[-1], H, W, C,
                        left.element_size(), shifts.numel()):
        if shifts.device.type == "cpu" and bool((shifts < 0).any()):
            raise ValueError("plane-sweep shifts must be >= 0")
        return PlaneSweepK3.apply(left, right, shifts)


plane_sweep_volume_k3.launches = 0
plane_sweep_volume_k3_bwd.launches = 0


def build_cost_volume(left, right, shifts, downsample: int = 1):
    """Dispatcher (JAX ``build_cost_volume``; the reference API asserts
    shift >= 0).  Downsample 1 goes to ``plane_sweep_volume_k3``: kernel K3
    on a CUDA tensor, its plain version on a CPU tensor.  Any other
    downsample takes the gather form."""
    if downsample == 1:
        return plane_sweep_volume_k3(left, right, shifts)
    return _plane_sweep_xla_any(left, right, shifts, downsample)
