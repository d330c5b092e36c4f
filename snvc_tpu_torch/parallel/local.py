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
the group to arrive computes what every position receives from the
others with plain differentiable ops (``.to`` a device, ``narrow``,
``cat``, ``+``), and each position joins it to its own tensor.  The
positions' autograd graphs thus join into one graph, whose backward is
the adjoint of each collective by construction: the step calls
``backward`` once, from the caller, on the sum of the positions' losses,
and no backward ever waits on another thread.  (PyTorch's autograd
engine runs every CUDA backward node of a device on one worker thread,
and the CPU ones on the caller's, so a backward that blocks in a
collective, as the rank form's do, would deadlock positions sharing a
device.)

A rematerialized block (``torch.utils.checkpoint``, models/vernier.py's
3D hourglass under ``cfg.remat``) recomputes inside that backward, on
autograd's thread, after the positions' threads have ended: it cannot
meet the other positions.  So each of its checkpointed calls keeps a
``collective_log``: in the forward every collective of the position
records what it received from the others (a halo's planes, a sum, a
maximum; never the position's own tensor), and the recompute replays
those records in the same order without meeting.  The recomputed
tensors refill the saved-tensor slots of the graph the forward built,
whose collective edges still join the positions, so the gradients cross
positions as without remat.  The meetings' own ops save no tensor, and
run under saved-tensor hooks of their own besides, so no position's
tensor is packed into another position's checkpoint.

The slabs follow parallel/tensor.py's rule: a position may hold a
short last slab or no plane at all.  Such a position meets the others at
every collective in the same order (its layers make 0-plane outputs
that still depend on their inputs), adds nothing to a gather, zeros to
a sum and -inf to a maximum.  A halo takes its planes from as many
neighbours as it reaches, and zeros only past the volume's ends.

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

from snvc_tpu_torch.parallel.tensor import fill_planes, halo_sources


class _Aborted(RuntimeError):
    """Raised in the positions still waiting when another one failed."""


# this thread's (log, replaying, cursor) while a ``collective_log``
# context is open on it
_LOGGED = threading.local()


class _Logged:
    """While open on a thread, the collectives that thread calls at a
    ``Rendezvous`` append what they receive to ``log`` (``replay``
    False), or take it from ``log`` in order without meeting (``replay``
    True).  Reentrant: a checkpoint enters its recompute context at
    every recompute, and each replays from the first record."""

    def __init__(self, log: list, replay: bool):
        self.log, self.replay = log, replay
        self._outer: list = []

    def __enter__(self):
        self._outer.append(getattr(_LOGGED, "state", None))
        if not self.replay:
            self.log.clear()
        _LOGGED.state = (self.log, self.replay, [0])
        return self

    def __exit__(self, *exc):
        _LOGGED.state = self._outer.pop()
        return False


def collective_log():
    """(record, replay): the two contexts of one checkpointed call on a
    position of a one-process mesh (``torch.utils.checkpoint``'s
    ``context_fn``), sharing one log that lives as long as the
    checkpoint's saved state.  ``record`` around the forward keeps what
    each collective received from the other positions, detached;
    ``replay`` around a recompute hands it back in the same order."""
    log: list = []
    return _Logged(log, False), _Logged(log, True)


class _Meeting:
    def __init__(self, n: int):
        self.inputs: List[Any] = [None] * n
        self.arrived = set()
        self.outputs = None
        self.taken = 0


def _identity(t):
    return t


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
        arrive calls ``fn``, under saved-tensor hooks of its own (its
        thread's checkpoint, if any, must not pack the other positions'
        tensors)."""
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
                    with torch.autograd.graph.saved_tensors_hooks(
                            _identity, _identity):
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

    def _receive(self, name: str, kind: str, rank: int, x,
                fn: Callable[[list], list]) -> tuple:
        """``meet``, where ``fn`` gives each position the tuple of tensors
        it receives from the others (collective ``name``).  Under
        ``collective_log``'s record context the tuple is also logged,
        detached; under its replay context it comes from the log and no
        meeting is held."""
        state = getattr(_LOGGED, "state", None)
        if state is None:
            return self.meet(kind, rank, x, fn)
        log, replay, cursor = state
        if not replay:
            got = self.meet(kind, rank, x, fn)
            log.append((name, tuple((t.detach().clone(), t.requires_grad)
                                    for t in got)))
            return got
        if cursor[0] == len(log) or log[cursor[0]][0] != name:
            raise RuntimeError(
                f"a recompute calls collective {name} at {cursor[0]}, which "
                f"its forward did not ({[n for n, _ in log]})")
        _, got = log[cursor[0]]
        cursor[0] += 1
        # as in the forward: a leaf that requires grad where the received
        # tensor did, so the recompute saves the same tensors
        return tuple(t.detach().requires_grad_(g) for t, g in got)

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
            return [(total.to(y.device),) for y in xs]
        return self._receive("sum", kind, rank, x, fn)[0]

    def max(self, x, rank: int):
        """The elementwise maximum over the model group, detached."""
        def fn(xs):
            dev = xs[0].device
            top = torch.stack([y.detach().to(dev) for y in xs]).amax(0)
            return [(top.to(y.device),) for y in xs]
        return self._receive("max", "model", rank, x, fn)[0]

    def gather(self, x, axis: int, rank: int):
        """The model group's slabs concatenated along ``axis`` (a position
        of no plane adds none)."""
        def fn(xs):
            dev = xs[0].device
            whole = torch.cat([y.to(dev) for y in xs], dim=axis)
            return [(whole.to(y.device),) for y in xs]
        return self._receive("gather", "model", rank, x, fn)[0]

    def halo(self, x, axis: int, lo: int, hi: int, rank: int):
        """Each slab widened by the ``lo`` planes below it and the ``hi``
        above it, taken from as many neighbours as they reach
        (``tensor.halo_sources``), zeros past the volume's ends (before
        the first plane, after the last slab that holds planes).  What a
        position receives is the two halos alone; its own slab joins
        them on its thread."""
        def fn(xs):
            lengths = [y.shape[axis] for y in xs]
            out = []
            for i, y in enumerate(xs):
                sides: tuple = ([], [])
                for side, j, p, t, k in halo_sources(lengths, i, lo, hi):
                    sides[side].append(
                        (t, xs[j].narrow(axis, p, k).to(y.device)))
                out.append((fill_planes(sides[0], lo, axis, y),
                            fill_planes(sides[1], hi, axis, y)))
            return out
        below, above = self._receive("halo", "model", rank, x, fn)
        return torch.cat([below, x, above], dim=axis)


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
