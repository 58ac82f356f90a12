"""Cost counters of one traced call (the port's counterpart of the
reference's ``utils/hlo.py``, which parses XLA's HLO text; there is no HLO
in the port, so the same quantities are counted from torch's dispatcher).

``CostMode`` is a ``TorchDispatchMode`` that sees every aten op of the
call. An op on DTensors is seen twice: once at the DTensor level (global
shapes) and then, after DTensor lowers it, as the local ops and the
collectives one device runs. It counts:

  * ``flops`` — per device: the FLOPs of the local ops (torch's
    ``flop_counter`` formulas: products, convolutions, attention), what
    XLA's ``cost_analysis`` reports per device;
  * ``flops_job`` — whole job, the convention of ``utils/analytic.py``:
    each DTensor op at its global shapes, plus the local ops of the
    shard-by-shard regions (``shard_scope``) times their distinct
    shards, and twice that for a region's backward (``count_backward``:
    its products' two operand gradients). Plain host-side tensors outside
    those regions (positions, masks) are left out; without a mesh it is
    ``flops``;
  * ``bytes_accessed`` — per device: inputs plus outputs of every local
    op that is not a view or a collective. Eager execution is unfused, so
    this is every intermediate's round trip to memory, an upper bound on
    what a fused program (XLA's figure) moves;
  * ``collectives`` — per device, by kind, under ``hlo.py``'s rules: an
    all-reduce counts twice its result bytes (a ring moves ~2x the
    buffer), every other collective its result bytes; plus ``total``;
  * ``op_census`` — local ops by ``hlo.op_census``'s families (``dot``,
    ``convolution``, ``reshape``, ``transpose``, ``copy`` and the
    collectives); XLA's ``fusion`` has no eager counterpart, so the other
    ops count as ``other``.

Eager execution runs every layer, so every layer is counted: there is no
counterpart of the loop-aware (while-trip-count) collective count.

DTensor infers each new op's output layout by running the op on fake
tensors of the *global* shapes, under a fake mode of its own (its
sharding propagation). Those runs are no device's work: ``CostMode``
passes them through uncounted, and ``propagating`` tells other modes
(the dry run's memory tracker) to do the same.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict, List

import torch
from torch.distributed.tensor import DTensor
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode, \
    _get_current_dispatch_mode_stack
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional",
                          "_c10d_functional_autograd", "c10d")
_KINDS = (("reduce_scatter", "reduce-scatter"), ("all_gather", "all-gather"),
          ("allgather", "all-gather"), ("all_reduce", "all-reduce"),
          ("allreduce", "all-reduce"), ("all_to_all", "all-to-all"),
          ("alltoall", "all-to-all"), ("broadcast", "broadcast"))
_FAMILIES = {
    "dot": ("mm", "bmm", "addmm", "baddbmm", "addbmm", "matmul", "linear",
            "dot", "mv"),
    "convolution": ("convolution", "_convolution", "conv1d", "conv2d"),
    "reshape": ("view", "_unsafe_view", "reshape", "unsqueeze", "squeeze",
                "flatten", "expand", "unflatten"),
    "transpose": ("t", "transpose", "permute"),
    "copy": ("copy_", "clone", "_to_copy", "contiguous"),
}
_FAMILY_OF = {op: fam for fam, ops in _FAMILIES.items() for op in ops}

_SCOPES: List[list] = []       # [distinct shards, job FLOPs] per region
_ACTIVE: List["CostMode"] = []  # the CostModes entered


@contextlib.contextmanager
def shard_scope(region: list):
    """Local ops inside run on one of ``region[0]`` distinct shards (a
    ``local_map`` region): ``flops_job`` counts them that many times, and
    ``region[1]`` accumulates what they add."""
    _SCOPES.append(region)
    try:
        yield
    finally:
        _SCOPES.pop()


def count_backward(t: torch.Tensor, flops: float) -> None:
    """Add ``flops`` to ``flops_job`` when ``t``'s gradient is computed:
    a shard-by-shard region's backward, which autograd runs outside the
    region's scope. Nothing is registered unless a ``CostMode`` is
    counting."""
    if _ACTIVE and t.requires_grad:
        def hook(grad):
            for mode in _ACTIVE:
                mode.flops_job += flops
        t.register_hook(hook)


def collective_kind(func) -> str | None:
    """The ``hlo.py`` kind of a collective op, None for any other op."""
    if func.namespace not in _COLLECTIVE_NAMESPACES:
        return None
    name = func._opname
    for key, kind in _KINDS:
        if key in name:
            return kind
    return None


def fake_mode():
    """The innermost fake mode on the dispatch mode stack, or None."""
    for m in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(m, FakeTensorMode):
            return m
    return None


def propagating(entry_fake_mode) -> bool:
    """Whether the op being dispatched is one of DTensor's shape-inference
    runs: a fake mode is active that was not when the counting mode was
    entered (``entry_fake_mode``)."""
    return fake_mode() is not entry_fake_mode


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _flops(func, args, kwargs, out) -> int:
    f = flop_registry.get(func._overloadpacket)
    return int(f(*args, **kwargs, out_val=out)) if f is not None else 0


class CostMode(TorchDispatchMode):
    """Counts one call's costs (see the module docstring). Use as a
    context manager and read ``summary()``."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.flops_job = 0
        self.bytes_accessed = 0
        self.collectives: Dict[str, int] = defaultdict(int)
        self.census: Dict[str, int] = defaultdict(int)
        self.on_mesh = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            # the global view; DTensor then lowers it to the local ops and
            # collectives, which come back through this mode
            self.on_mesh = True
            self.flops_job += _flops(func, args, kwargs, None)
            return NotImplemented
        if propagating(self._fake_on_entry):
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        name = func._overloadpacket.__name__
        kind = collective_kind(func)
        if kind is not None:
            self._collective(kind, out)
            return out
        fl = _flops(func, args, kwargs, out)
        self.flops += fl
        if _SCOPES:
            region = _SCOPES[-1]
            self.flops_job += fl * region[0]
            region[1] += fl * region[0]
        if not func.is_view and name != "wait_tensor":
            self.bytes_accessed += _nbytes(args) + _nbytes(kwargs) \
                + _nbytes(out)
        self.census[_FAMILY_OF.get(name, "other")] += 1
        return out

    def _collective(self, kind: str, out) -> None:
        """One collective of ``kind`` with result(s) ``out``."""
        b = _nbytes(out)
        self.collectives[kind] += 2 * b if kind == "all-reduce" else b
        self.census[kind] += 1

    def __enter__(self):
        self._fake_on_entry = fake_mode()
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def summary(self) -> dict:
        coll = dict(self.collectives)
        coll["total"] = sum(coll.values())
        return {"flops": float(self.flops),
                "flops_job": float(self.flops_job if self.on_mesh
                                   else self.flops),
                "bytes_accessed": float(self.bytes_accessed),
                "collectives": coll, "op_census": dict(self.census)}
