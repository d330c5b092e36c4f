"""The work of a program: its flops and the bytes it moves (the
counterpart of JAX's ``_compiled_cost`` / ``_compiled_flops``,
snvc_tpu/inference/refine.py:64-86, and of ``RefineRunner.cost_stats``).

JAX reads both numbers from XLA's cost analysis of a compiled program.
PyTorch runs eagerly and has no compiled program to ask, so
``count_cost`` counts the aten ops that run inside it (a
``TorchDispatchMode``), and each hand-written kernel declares its own work
from its shapes (``declare_kernel``): on the card a kernel is a call that
the dispatcher never sees, on the CPU its plain version is many small aten
ops, and both must count the same.

* ``flops``: 2 per multiply-add of every ``aten.convolution`` (transposed
  ones and ``convolution_backward`` too), ``mm``, ``bmm``, ``addmm``,
  ``baddbmm``, ``mv`` and ``dot`` (``einsum``, ``matmul`` and ``linear``
  reach these).  A convolution counts only the taps that fall inside its
  input: taps on padding, and on the zeros of an input dilation
  (a transposed conv's stride), are not work.  XLA's cost analysis counts
  a convolution so (``conv_taps``), so an MFU read from these flops reads
  as ``bench.py``'s did.  Elementwise ops, reductions and gathers add no
  flops here; XLA adds a few flops for each of them, so XLA's total is
  somewhat larger than the conv-and-dot flops (tests/test_torch_cost.py
  measures the band).  A declared kernel adds the flops it declares.
* ``bytes_accessed``: the bytes of the tensor inputs and outputs of every
  op that returns a tensor, each op read and written once: the traffic
  of eager execution, one launch an op.  It is not XLA's figure, which is
  that of the fused program (an elementwise chain reads its inputs
  once, a layout copy counts); at the tiny test configs the two lie
  within 7 % (tests/test_torch_cost.py).  A declared kernel adds the
  bytes it declares (its inputs read once, its outputs written once).  Not
  counted: views and bare allocations; a copy between devices (JAX
  counts a program's arguments as inputs on the device, and so does
  this count) and the host's pinned staging copy; and ``clone``, the
  copy that only changes a tensor's layout (``reshape`` of a strided
  tensor, ``contiguous``), since whether it runs depends on the strides
  a device's convolutions return, and the card and the CPU must count
  alike.

A counter sees the ops of the thread that opened it, and of the autograd
engine's threads that run its backward; the ops of other threads (the
positions of a one-process mesh) are not counted.  ``by_op`` keeps each
aten op's share, to find where two counts part.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Iterator, NamedTuple

import torch
from torch.utils._python_dispatch import (
    TorchDispatchMode,
    _get_current_dispatch_mode_stack,
)
from torch.utils._pytree import tree_flatten

aten = torch.ops.aten


class Work(NamedTuple):
    """What a kernel declares: its flops and the bytes it moves."""
    flops: float
    bytes_accessed: float


def _counters():
    """The counters open on this thread (the autograd engine's threads
    inherit the dispatch modes of the thread that runs backward)."""
    return [m.counter for m in _get_current_dispatch_mode_stack()
            if isinstance(m, _Mode)]


def conv_taps(n_in: int, n_out: int, k: int, stride: int = 1, pad: int = 0,
              dil: int = 1, transposed: bool = False) -> int:
    """The (output, tap) pairs along one axis whose input lies inside the
    input, as XLA's cost analysis counts them.  A conv's output ``o``
    reads input ``o * stride - pad + t * dil`` at tap ``t``; a transposed
    conv's input ``i`` reaches output ``i * stride - pad + t * dil``, so
    its pairs are the (input, tap) pairs that land inside the output."""
    if transposed:  # pairs (i, t) with 0 <= i * s - p + t * d < n_out
        n_in, n_out = n_out, n_in
    total = 0
    for t in range(k):
        off = t * dil - pad  # input index of output 0 at this tap
        # outputs o with 0 <= o * stride + off <= n_in - 1
        lo = max(0, -(off // stride))
        hi = min(n_out - 1, (n_in - 1 - off) // stride)
        total += max(0, hi - lo + 1)
    return total


def conv_flops(x_shape, w_shape, out_shape, stride, padding, dilation,
               transposed: bool = False, groups: int = 1) -> float:
    """2 x the multiply-adds of an ``aten.convolution`` on channels-first
    ``x_shape`` [N, C, *spatial] with torch's weight ``w_shape`` ([F, C /
    groups, *k], or [C, F / groups, *k] when ``transposed``) giving
    ``out_shape``, counting the taps inside the input only
    (``conv_taps``)."""
    N, C = x_shape[:2]
    spatial = x_shape[2:]
    nd = len(spatial)
    k = w_shape[2:]
    stride, padding, dilation = (
        [v] * nd if isinstance(v, int) else list(v)
        for v in (stride, padding, dilation))
    if transposed:
        F_out = w_shape[1] * groups
    else:
        F_out = w_shape[0]
    taps = math.prod(
        conv_taps(spatial[i], out_shape[2 + i], k[i], stride[i], padding[i],
                  dilation[i], transposed) for i in range(nd))
    return 2.0 * N * F_out * (C // groups) * taps


def conv3d_same_flops(x_shape, kernel, F_out: int, dilation: int = 1
                      ) -> float:
    """2 x the multiply-adds of a stride-1 SAME (torch-symmetric padding)
    3D conv of channels-last ``x_shape`` [N, D, H, W, C] with ``kernel``
    (kd, kh, kw) and ``F_out`` features, taps inside the input only."""
    N, D, H, W, C = x_shape
    taps = math.prod(conv_taps(n, n, k, 1, (k - 1) // 2 * dilation, dilation)
                     for n, k in zip((D, H, W), kernel))
    return 2.0 * N * F_out * C * taps


def _matmul_flops(func, args, out) -> float:
    if func in (aten.mm.default, aten.bmm.default, aten.mv.default,
                aten.dot.default):
        a = args[0]
    else:  # addmm / baddbmm (bias, a, b)
        a = args[1]
    # out [.., M, N] (or [M] / []) times the contracted length
    return 2.0 * out.numel() * a.shape[-1]


def _conv_op_flops(func, args, out) -> float:
    if func is aten.convolution_backward.default:
        grad, x, w = args[:3]
        stride, padding, dilation, transposed = args[4:8]
        groups, mask = args[9], args[10]
        one = conv_flops(x.shape, w.shape, grad.shape, stride, padding,
                         dilation, transposed, groups)
        return one * (int(mask[0]) + int(mask[1]))
    x, w = args[0], args[1]
    stride, padding, dilation, transposed = args[3:7]
    groups = args[8]
    return conv_flops(x.shape, w.shape, out.shape, stride, padding,
                      dilation, transposed, groups)


_MATMULS = {aten.mm.default, aten.bmm.default, aten.addmm.default,
            aten.baddbmm.default, aten.mv.default, aten.dot.default}
_CONVS = {aten.convolution.default, aten.convolution_backward.default}
# ops that allocate without moving data, a view whose schema does not say
# so, layout copies and the host's pinned staging copy
_FREE = {aten.empty.memory_format, aten.empty_strided.default,
         aten.empty_like.default, aten.new_empty.default,
         aten.new_empty_strided.default, aten._unsafe_view.default,
         aten.clone.default, aten._pin_memory.default}


def op_flops(func, args, out) -> float:
    """The flops this module counts for one aten op (see the module
    docstring)."""
    if func in _MATMULS:
        return _matmul_flops(func, args, out)
    if func in _CONVS:
        return _conv_op_flops(func, args, out)
    return 0.0


def op_bytes(func, args, kwargs, out) -> int:
    """The bytes one aten op reads and writes: its tensor inputs and
    outputs (see the module docstring for what moves none)."""
    if func in _FREE or getattr(func, "is_view", False):
        return 0
    outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
    if not outs:  # a query, or .item()
        return 0
    ins = [t for t in tree_flatten((args, kwargs))[0]
           if isinstance(t, torch.Tensor)]
    if len({t.device for t in ins + outs}) > 1:  # a transfer
        return 0
    return sum(t.numel() * t.element_size() for t in ins + outs)


class _Mode(TorchDispatchMode):
    """The dispatch mode of a ``CostCounter``.  An op with a
    CompositeImplicitAutograd decomposition (``conv2d``, ``einsum``,
    ``linear``, which reach this mode whole under ``inference_mode``) is
    decomposed under the mode, so its parts are counted, as they are
    with autograd on."""

    def __init__(self, counter):
        super().__init__()
        self.counter = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in _MATMULS and func not in _CONVS:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        c = self.counter
        if not c._suppress:
            f = op_flops(func, args, out)
            b = op_bytes(func, args, kwargs, out)
            c.flops += f
            c.bytes_accessed += b
            op = c.by_op.setdefault(str(func), [0.0, 0])
            op[0] += f
            op[1] += b
        return out


class CostCounter:
    """Sums ``flops`` and ``bytes_accessed`` over the aten ops and the
    declared kernels that run while it is open; ``by_kernel`` holds each
    declared kernel's share ({"flops", "bytes_accessed", "calls"}) under
    its name."""

    def __init__(self):
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.by_kernel: Dict[str, Dict[str, float]] = {}
        self.by_op: Dict[str, list] = {}  # aten op -> [flops, bytes]
        self._suppress = 0
        self._mode = _Mode(self)

    def __enter__(self):
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)

    def add(self, name: str, work: Work) -> None:
        self.flops += work.flops
        self.bytes_accessed += work.bytes_accessed
        k = self.by_kernel.setdefault(
            name, {"flops": 0.0, "bytes_accessed": 0.0, "calls": 0})
        k["flops"] += work.flops
        k["bytes_accessed"] += work.bytes_accessed
        k["calls"] += 1

    def totals(self) -> Dict[str, float]:
        return {"flops": self.flops, "bytes_accessed": self.bytes_accessed}


# ``with count_cost() as c: ...``, then ``c.flops``, ``c.bytes_accessed``,
# ``c.by_kernel``
count_cost = CostCounter


@contextlib.contextmanager
def declare_kernel(name: str, work: Callable[..., Work], *args,
                   **kwargs) -> Iterator[None]:
    """The region of a kernel entry: while a counter is open, adds
    ``work(*args, **kwargs)`` to it under ``name`` and counts none of the
    aten ops inside, so the kernel and its plain version count alike.
    With no counter open it does nothing (``work`` is not called: a
    formula may read a small table back from the card)."""
    open_ = [c for c in _counters() if not c._suppress]
    if not open_:  # none, or all inside another kernel's region
        yield
        return
    for c in open_:
        c._suppress += 1
    try:
        w = work(*args, **kwargs)
        for c in open_:
            c.add(name, w)
        yield
    finally:
        for c in open_:
            c._suppress -= 1


def program_cost(fn: Callable, *args, **kwargs) -> Dict[str, float]:
    """{"flops", "bytes_accessed"} of one call ``fn(*args, **kwargs)``,
    counted as this module counts (the counterpart of JAX's
    ``_compiled_cost``, snvc_tpu/inference/refine.py:64-80; unlike it,
    never None).  The call runs."""
    with count_cost() as c:
        fn(*args, **kwargs)
    return c.totals()
