"""Op-trace accounting of one eager call: the port's counterpart of the
JAX package's ``launch/hloanalysis.py``.

The reference parses XLA's optimized HLO text, because
``cost_analysis()`` visits a ``while`` body once and its layer scans
would be undercounted. The port has no HLO: its loops are Python loops
and ``torch.utils.checkpoint`` recomputes in the backward, so every op
that runs is one op to count. :func:`analyze_ops` runs a function under
a ``TorchDispatchMode`` and sums, per chip:

* ``dot_flops`` -- the matmul family (``mm``, ``addmm``, ``bmm``,
  ``baddbmm``, the fused attention ops), with the FLOP formulas of
  ``torch.utils.flop_counter``'s registry; a convolution is not a dot, as
  in the reference;
* ``dot_ops`` -- the same by op and output shape: ``[label, count,
  FLOPs]``, the most FLOPs first (which products a count is made of);
* ``flops`` -- every op that registry knows (dots, convolutions,
  attention); it stands in for ``cost_analysis()["flops"]``;
* ``per_collective`` / ``collective_bytes`` -- operand bytes by the
  reference's kinds (``all-reduce``, ``all-gather``, ``reduce-scatter``,
  ``all-to-all``, ``collective-permute``) from the ``_c10d_functional``
  and ``c10d`` ops; the operand of an all-gather is its input (result /
  group size), of a reduce-scatter its input (result x group size); a
  point-to-point send is a ``collective-permute`` of its buffer;
* ``collective_ops`` -- the same operands by (kind, shape, dtype):
  ``[label, count, bytes]``, the most bytes first, so a record names the
  collectives that move the most (a gather of the logits, of a weight);
* ``bytes_accessed`` -- the bytes of every counted op's tensor inputs
  and outputs (views and meta tensors left out), as ``cost_analysis()``
  sums operands and results;
* ``materialized_bytes`` -- 2 x the bytes of every storage an op
  allocates (written once, read about once), views and in-place results
  left out: in eager mode every op materializes, which is the
  reference's fusion-boundary proxy;
* ``peak_bytes`` -- the most bytes of storages allocated during the call
  that were alive at once (each storage tracked from the op that made it
  to its release; the meta device allocates nothing), and the bytes of
  the storages the call returns;
* ``peak_holders`` -- what holds that peak: the live bytes by the op,
  shape and dtype that made each storage, the largest first, as they
  stood when the live bytes last grew by 1% (so within 1% of the peak).

**Per chip under DTensor.** The mode returns ``NotImplemented`` for a
DTensor, so DTensor unwraps it and the mode sees the local op on this
rank's shards (``CommDebugMode``'s pattern). On the first call of an op
signature DTensor's sharding propagation also runs the op at its global
shape, under a fake tensor mode of its own (the one it finds active, or
a fresh one); ops that run while a fake mode other than the caller's is
active are not counted. So a call on fake tensors (the dry run) passes
its ``FakeTensorMode`` as ``fake_mode`` *without* entering it: the
counter runs each op under that mode itself, and the propagation,
finding no active fake mode, makes its own. In such a trace, small CPU
tensors made from no tensor, and ops on real tensors only, are host
scratch (DTensor's shard-offset arithmetic, read back on the host): they
run real and are not counted.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Callable, Dict, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._pytree import tree_leaves
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

__all__ = ["OpTotals", "OpCounter", "analyze_ops", "argument_bytes"]

_aten = torch.ops.aten
_DOTS = {
    _aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm,
    _aten._scaled_dot_product_flash_attention, _aten._scaled_dot_product_flash_attention_backward,
    _aten._scaled_dot_product_efficient_attention,
    _aten._scaled_dot_product_efficient_attention_backward,
    _aten._scaled_dot_product_cudnn_attention, _aten._scaled_dot_product_cudnn_attention_backward,
    _aten._flash_attention_forward, _aten._flash_attention_backward,
    _aten._efficient_attention_forward, _aten._efficient_attention_backward,
}

#: collective op -> (the reference's kind, the position of its operand:
#: the functional ops' input is arg 0; c10d's in-place ops take the
#: output first, except ``allreduce_`` and ``send``)
_COLLECTIVES = {
    "_c10d_functional.all_reduce": ("all-reduce", 0),
    "_c10d_functional.all_reduce_": ("all-reduce", 0),
    "_c10d_functional.all_reduce_coalesced": ("all-reduce", 0),
    "_c10d_functional.all_reduce_coalesced_": ("all-reduce", 0),
    "_c10d_functional.all_gather_into_tensor": ("all-gather", 0),
    "_c10d_functional.all_gather_into_tensor_out": ("all-gather", 0),
    "_c10d_functional.all_gather_into_tensor_coalesced": ("all-gather", 0),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", 0),
    "_c10d_functional.reduce_scatter_tensor_coalesced": ("reduce-scatter", 0),
    "_c10d_functional.all_to_all_single": ("all-to-all", 0),
    "_c10d_functional_autograd.all_reduce": ("all-reduce", 0),
    "_c10d_functional_autograd.all_gather_into_tensor": ("all-gather", 0),
    "_c10d_functional_autograd.reduce_scatter_tensor": ("reduce-scatter", 0),
    "_c10d_functional_autograd.all_to_all_single": ("all-to-all", 0),
    "c10d.allreduce_": ("all-reduce", 0),
    "c10d.allreduce_coalesced_": ("all-reduce", 0),
    "c10d.allgather_": ("all-gather", 1),
    "c10d._allgather_base_": ("all-gather", 1),
    "c10d.allgather_into_tensor_coalesced_": ("all-gather", 1),
    "c10d.reduce_scatter_": ("reduce-scatter", 1),
    "c10d._reduce_scatter_base_": ("reduce-scatter", 1),
    "c10d.reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "c10d.alltoall_": ("all-to-all", 1),
    "c10d.alltoall_base_": ("all-to-all", 1),
    "c10d.send": ("collective-permute", 0),
}


@dataclasses.dataclass
class OpTotals:
    """Per-chip totals of one call (``HloTotals``' fields, without the
    loop trips an eager trace does not have)."""

    dot_flops: float = 0.0
    flops: float = 0.0
    collective_bytes: float = 0.0
    materialized_bytes: float = 0.0
    bytes_accessed: float = 0.0
    per_collective: Dict[str, Dict[str, float]] = dataclasses.field(default_factory=dict)
    collective_ops: list = dataclasses.field(default_factory=list)
    dot_ops: list = dataclasses.field(default_factory=list)
    peak_bytes: int = 0
    output_bytes: int = 0
    alias_bytes: int = 0
    peak_holders: list = dataclasses.field(default_factory=list)


def _host_scratch(out) -> bool:
    """A small host tensor made from no tensor during a fake trace: index
    arithmetic (DTensor's shard offsets) that is read back on the host, so
    it runs real and is not counted, as are ops on real tensors only."""
    return isinstance(out, torch.Tensor) and out.device.type == "cpu" and out.numel() <= 1 << 16


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _label(name: str, t: torch.Tensor) -> str:
    """``name (shape) dtype``, as records name a tensor."""
    return f"{name} {tuple(t.shape)} {str(t.dtype).replace('torch.', '')}"


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class OpCounter(TorchDispatchMode):
    """The dispatch mode behind :func:`analyze_ops` (see the module's
    docstring). ``arguments``: tensors whose storages exist before the
    call and are not counted as allocated by it."""

    def __init__(self, fake_mode=None, arguments=()):
        super().__init__()
        self.fake_mode = fake_mode
        self.totals = OpTotals()
        self._args = {_storage_key(t) for t in arguments}
        self._live: Dict[int, int] = {}
        self._made: Dict[int, str] = {}
        self._live_bytes = 0
        self._holders_at = 0
        self._coll_ops: Dict[str, list] = {}
        self._dot_ops: Dict[str, list] = {}

    def _release(self, key: int, nbytes: int) -> None:
        if self._live.pop(key, None) is not None:
            self._made.pop(key, None)
            self._live_bytes -= nbytes

    def _track(self, t: torch.Tensor, name: str) -> None:
        if t.is_meta:  # shapes only: nothing is allocated
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._args or key in self._live:
            return
        nbytes = st.nbytes()
        self._live[key] = nbytes
        self._made[key] = _label(name, t)
        self._live_bytes += nbytes
        self.totals.materialized_bytes += 2.0 * nbytes
        self.totals.peak_bytes = max(self.totals.peak_bytes, self._live_bytes)
        if self._live_bytes > 1.01 * self._holders_at:
            self._holders_at = self._live_bytes
            held: Dict[str, int] = {}
            for k, n in self._live.items():
                held[self._made[k]] = held.get(self._made[k], 0) + n
            self.totals.peak_holders = sorted(held.items(), key=lambda kv: -kv[1])[:8]
        weakref.finalize(st, self._release, key, nbytes)

    def _collective(self, name: str, args) -> None:
        kind, pos = _COLLECTIVES[name]
        arg = args[pos] if pos < len(args) else args[0]
        operands = [t for t in tree_leaves(arg) if isinstance(t, torch.Tensor)]
        nbytes = float(sum(_nbytes(t) for t in operands))
        rec = self.totals.per_collective.setdefault(kind, {"count": 0.0, "bytes": 0.0})
        rec["count"] += 1
        rec["bytes"] += nbytes
        self.totals.collective_bytes += nbytes
        for t in operands:
            op = self._coll_ops.setdefault(_label(kind, t), [0, 0.0])
            op[0] += 1
            op[1] += float(_nbytes(t))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        active = torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE)
        if active is not None and active is not self.fake_mode:
            # DTensor's sharding propagation at the global shape
            return func(*args, **kwargs)
        tensors_in = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        if self.fake_mode is None or active is not None:
            out = func(*args, **kwargs)
        elif tensors_in and not any(isinstance(t, FakeTensor) for t in tensors_in):
            return func(*args, **kwargs)  # host scratch (see _host_scratch)
        else:
            with self.fake_mode:
                out = func(*args, **kwargs)
            if not tensors_in and _host_scratch(out):
                return func(*args, **kwargs)
        tensors_out = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        packet = func._overloadpacket
        name = f"{func.namespace}.{packet.__name__}"
        if name in _COLLECTIVES:
            self._collective(name, args)
        elif packet in flop_registry:
            n = flop_registry[packet](*args, **kwargs, out_val=out)
            self.totals.flops += n
            if packet in _DOTS:
                self.totals.dot_flops += n
                op = self._dot_ops.setdefault(_label(name, tensors_out[0]), [0, 0.0])
                op[0] += 1
                op[1] += float(n)
        if not (func.is_view or packet is _aten.lift_fresh):
            self.totals.bytes_accessed += float(
                sum(_nbytes(t) for t in tensors_in + tensors_out if not t.is_meta))
            for t in tensors_out:
                self._track(t, name)
        return out

    def finish(self, result) -> OpTotals:
        """Record the bytes of the storages ``result`` holds (all of them,
        and those that alias an argument), and the collectives and the
        products by shape."""
        for field, ops in (("collective_ops", self._coll_ops), ("dot_ops", self._dot_ops)):
            setattr(self.totals, field, sorted(([k, c, v] for k, (c, v) in ops.items()),
                                               key=lambda e: (-e[2], e[0])))
        seen = set()
        for t in _tensors_of(result):
            key = _storage_key(t)
            if key in seen:
                continue
            seen.add(key)
            nbytes = t.untyped_storage().nbytes()
            self.totals.output_bytes += nbytes
            if key in self._args:
                self.totals.alias_bytes += nbytes
        return self.totals


def _tensors_of(tree) -> list:
    """The local tensors of a result: DTensors by their local shards,
    ``nn.Module`` s by their parameters and buffers."""
    from torch.distributed.tensor import DTensor

    out = []
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.nn.Module):
            out += _tensors_of(list(leaf.parameters()) + list(leaf.buffers()))
        elif isinstance(leaf, DTensor):
            out.append(leaf.to_local())
        elif isinstance(leaf, torch.Tensor):
            out.append(leaf)
    return out


def analyze_ops(fn: Callable, *args, fake_mode=None, **kwargs) -> Tuple[OpTotals, Any]:
    """Run ``fn(*args, **kwargs)`` once under an :class:`OpCounter`;
    returns (its per-chip :class:`OpTotals`, its result). The storages of
    ``args`` are the call's arguments. ``fake_mode``: the
    ``FakeTensorMode`` of ``args`` when the call runs on fake tensors, not
    entered by the caller (every op runs under it, factories included)."""
    counter = OpCounter(fake_mode=fake_mode, arguments=_tensors_of(args))
    with counter:
        result = fn(*args, **kwargs)
    return counter.finish(result), result


def argument_bytes(tree) -> int:
    """Bytes of the distinct local storages of ``tree`` (DTensors count
    their local shards: what one chip holds)."""
    seen: Dict[int, int] = {}
    for t in _tensors_of(tree):
        seen[_storage_key(t)] = t.untyped_storage().nbytes()
    return sum(seen.values())
