"""The one-process form of a data x model mesh: every position of
``make_mesh(n_data, devices, n_model)`` driven by one process, a thread a
position (port of the single-process case of snvc_tpu/parallel/api.py,
where one program spans the mesh and GSPMD inserts the collectives).

``run_positions(mesh, fn)`` calls ``fn(position)`` on one thread per mesh
position.  ``position`` is the mesh with ``rank`` set to that position
and ``local`` to the run's ``Rendezvous``, so the model code reads
``data_index`` / ``model_index`` and calls the collectives of
parallel/api.py and parallel/tensor.py as a rank of a process group
would.  Each collective meets at the rendezvous: the last position of
the group to arrive computes every position's output from every
position's input with plain differentiable ops (``.to`` a device,
``narrow``, ``cat``, ``+``), and the others wake and take theirs.  The
positions' autograd graphs thus join into one graph, whose backward is
the adjoint of each collective by construction: the step calls
``backward`` once, from the caller, on the sum of the positions' losses,
and no backward ever waits on another thread.  (PyTorch's autograd
engine runs every CUDA backward node of a device on one worker thread,
and the CPU ones on the caller's, so a backward that blocks in a
collective, as the rank form's do, would deadlock positions sharing a
device.)  For the same reason nothing rematerializes under this form: a
recompute inside the backward could not meet the other positions
(models/vernier.py turns ``cfg.remat`` off here).

The slabs follow parallel/tensor.py's rule: a position may hold a
short last slab or no plane at all.  Such a position meets the others at
every collective in the same order (its layers make 0-plane outputs
that still depend on their inputs), adds nothing to a gather, zeros to
a sum and -inf to a maximum; a halo that reaches past a short or an
empty neighbour takes what it holds and zeros beyond, and the meeting
refuses a halo that would reach past a slab that is not the last to hold
planes.

Each position runs its own module (``Replicas``): position 0 the module
itself, the others copies of its module tree that use its parameters and
buffers, the same tensors on its device and differentiable copies
(``.to``) on another, so autograd sums every position's gradient into the
one parameter set.  The copies never move BatchNorm's running statistics:
position 0's module updates them once, with the statistics every
position reduced alike.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import threading
import weakref
from typing import Any, Callable, Dict, List, Sequence

import torch
from torch import nn


class _Aborted(RuntimeError):
    """Raised in the positions still waiting when another one failed."""


class _Meeting:
    def __init__(self, n: int):
        self.inputs: List[Any] = [None] * n
        self.arrived = set()
        self.outputs = None
        self.taken = 0


class Rendezvous:
    """The meeting point of the positions of one ``run_positions`` call.
    The k-th collective call of a group's positions meet as one meeting
    (every position runs the same program, so they call the collectives
    of a group in one order)."""

    def __init__(self, n_data: int, n_model: int):
        self.n_data, self.n_model = n_data, n_model
        self._cv = threading.Condition()
        self._meetings: Dict[Any, _Meeting] = {}
        self._calls: Dict[Any, int] = {}
        self._failed = None
        self._finished = set()

    def members(self, kind: str, rank: int) -> Sequence[int]:
        """The positions of ``rank``'s group of ``kind``: "model" (its
        data index's positions), "data" (its model index's) or "world",
        in position order."""
        nm = self.n_model
        if kind == "model":
            d = rank // nm
            return range(d * nm, (d + 1) * nm)
        if kind == "data":
            return range(rank % nm, self.n_data * nm, nm)
        return range(self.n_data * nm)

    def meet(self, kind: str, rank: int, x, fn: Callable[[list], list]):
        """``fn(inputs)[i]``: ``inputs`` are the group's ``x`` in position
        order, ``i`` is ``rank``'s place among them.  The last position to
        arrive calls ``fn``."""
        members = tuple(self.members(kind, rank))
        i = members.index(rank)
        with self._cv:
            seq = self._calls.get((rank, members), 0)
            self._calls[(rank, members)] = seq + 1
            key = (members, seq)
            m = self._meetings.setdefault(key, _Meeting(len(members)))
            m.inputs[i] = x
            m.arrived.add(rank)
            if len(m.arrived) == len(members):
                try:
                    m.outputs = fn(m.inputs)
                except BaseException as e:
                    self._fail(e)
                    raise
                m.inputs = None
                self._cv.notify_all()
            while m.outputs is None:
                if self._failed is not None:
                    raise _Aborted("another mesh position failed")
                gone = self._finished.intersection(members) - m.arrived
                if gone:
                    raise RuntimeError(
                        f"mesh positions {sorted(gone)} finished while "
                        f"position {rank} waits at a collective")
                self._cv.wait()
            m.taken += 1
            if m.taken == len(members):
                del self._meetings[key]
            return m.outputs[i]

    def _fail(self, e: BaseException) -> None:
        self._failed = e
        self._cv.notify_all()

    def fail(self, e: BaseException) -> None:
        with self._cv:
            self._fail(e)

    def finish(self, rank: int) -> None:
        with self._cv:
            self._finished.add(rank)
            self._cv.notify_all()

    # --- the collectives ----------------------------------------------
    def sum(self, x, kind: str, rank: int):
        """``x`` summed over ``rank``'s group of ``kind``, in position
        order, on every member's device."""
        def fn(xs):
            total = xs[0]
            for y in xs[1:]:
                total = total + y.to(total.device)
            return [total.to(y.device) for y in xs]
        return self.meet(kind, rank, x, fn)

    def max(self, x, rank: int):
        """The elementwise maximum over the model group, detached."""
        def fn(xs):
            dev = xs[0].device
            top = torch.stack([y.detach().to(dev) for y in xs]).amax(0)
            return [top.to(y.device) for y in xs]
        return self.meet("model", rank, x, fn)

    def gather(self, x, axis: int, rank: int):
        """The model group's slabs concatenated along ``axis`` (a position
        of no plane adds none)."""
        def fn(xs):
            dev = xs[0].device
            whole = torch.cat([y.to(dev) for y in xs], dim=axis)
            return [whole.to(y.device) for y in xs]
        return self.meet("model", rank, x, fn)

    def halo(self, x, axis: int, lo: int, hi: int, rank: int):
        """Each slab widened by the ``lo`` last planes of the previous
        position and the ``hi`` first of the next, zeros beyond the outer
        ones and beyond the planes of a neighbour that holds fewer (a
        short or an empty last slab: the volume's edge).  Raises where a
        halo would reach past a slab that is not the last to hold
        planes."""
        def edge(src, dst, n, first):
            shape = list(dst.shape)
            shape[axis] = n
            if src is None:
                return dst.new_zeros(shape)
            have = min(n, src.shape[axis])
            part = src.narrow(axis, 0 if first else src.shape[axis] - have,
                              have).to(dst.device)
            shape[axis] = n - have
            pad = dst.new_zeros(shape)
            return torch.cat([part, pad] if first else [pad, part],
                             dim=axis)

        def fn(xs):
            sizes = [y.shape[axis] for y in xs]
            last = max((i for i, L in enumerate(sizes) if L), default=-1)
            narrow = [L for L in sizes[:last]]
            if narrow and min(narrow) < max(lo, hi):
                raise ValueError(
                    f"a halo of ({lo}, {hi}) planes reaches past a slab of "
                    f"{min(narrow)} planes (slabs {sizes})")
            n, out = len(xs), []
            for i, y in enumerate(xs):
                parts = []
                if lo:
                    parts.append(edge(xs[i - 1] if i > 0 else None, y, lo,
                                      False))
                parts.append(y)
                if hi:
                    parts.append(edge(xs[i + 1] if i < n - 1 else None, y,
                                      hi, True))
                out.append(torch.cat(parts, dim=axis))
            return out
        return self.meet("model", rank, x, fn)


def run_positions(mesh, fn: Callable[[Any], Any]) -> list:
    """``fn(position)`` for every position of the one-process ``mesh``
    (``make_mesh``), one thread each, with the caller's grad and
    inference modes and the position's CUDA device current; the results
    in position order.  A position that fails fails every position
    waiting at a collective, and the first failure is raised here."""
    n = len(mesh.devices)
    rv = Rendezvous(mesh.n_data, mesh.n_model)
    results: List[Any] = [None] * n
    errors: List[Any] = [None] * n
    grad = torch.is_grad_enabled()
    inference = torch.is_inference_mode_enabled()

    def body(p: int) -> None:
        dev = mesh.devices[p]
        ctx = (torch.cuda.device(dev) if dev.type == "cuda"
               else contextlib.nullcontext())
        try:
            with torch.inference_mode(inference), \
                    torch.set_grad_enabled(grad), ctx:
                results[p] = fn(dataclasses.replace(mesh, rank=p, local=rv))
        except BaseException as e:
            errors[p] = e
            rv.fail(e)
        finally:
            rv.finish(p)

    threads = [threading.Thread(target=body, args=(p,),
                                name=f"position-{p}") for p in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    first = [e for e in errors if e is not None
             and not isinstance(e, _Aborted)] or [e for e in errors if e]
    if first:
        raise first[0]
    return results


class Replicas:
    """The module of each position of a one-process ``mesh``: ``module``
    itself at position 0 and, at the others, a copy of its module tree
    whose parameters and buffers are ``module``'s, bound by ``bind``.
    The copies' BatchNorms keep their running statistics."""

    def __init__(self, module: nn.Module, mesh):
        from snvc_tpu_torch.models.layers import BatchNorm

        self._module = weakref.ref(module)  # the cache holds no reference
        self.devices = [torch.device(d) for d in mesh.devices]
        shared = {id(t): t for t in
                  list(module.parameters()) + list(module.buffers())}
        self.copies = [copy.deepcopy(module, dict(shared))
                       for _ in self.devices[1:]]
        for c in self.copies:
            for m in c.modules():
                if isinstance(m, BatchNorm):
                    m.stats_frozen = True
        self.bind()

    @property
    def module(self) -> nn.Module:
        return self._module()

    def bind(self) -> None:
        """Points every copy at ``module``'s parameters and buffers as they
        are now, and at its train / eval mode: the same tensors on the
        same device, ``.to`` copies on another (differentiable while
        grad mode is on, so gradients reach ``module``'s parameters)."""
        for dev, c in zip(self.devices[1:], self.copies):
            for src, dst in zip(self.module.modules(), c.modules()):
                dst.training = src.training
                for name, p in src._parameters.items():
                    if p is not None:
                        dst._parameters[name] = p.to(dev)
                for name, b in src._buffers.items():
                    if b is not None:
                        dst._buffers[name] = b.to(dev)

    def __getitem__(self, p: int) -> nn.Module:
        return self.module if p == 0 else self.copies[p - 1]


_REPLICAS: "weakref.WeakKeyDictionary[nn.Module, Replicas]" = \
    weakref.WeakKeyDictionary()


def replicas(module: nn.Module, mesh) -> Replicas:
    """``Replicas(module, mesh)``, made once per module and mesh devices
    and bound anew at every call (the training steps' parameters move in
    place, or move to another device by ``.to``)."""
    r = _REPLICAS.get(module)
    if r is None or r.devices != [torch.device(d) for d in mesh.devices]:
        r = _REPLICAS[module] = Replicas(module, mesh)
    else:
        r.bind()
    return r
