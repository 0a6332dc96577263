"""Roofline inputs of one rank's step, read from the ops the step ran on
fake tensors (port of ``repro/launch/hlo_analysis.py``).

The reference compiles the step and reads XLA's ``cost_analysis()``,
``memory_analysis()`` and the collectives in the compiled HLO text.  The
port has no compiler between the step and the card: ``launch/dryrun.py``
runs the step eagerly on fake tensors over a fake process group, and
``record_step`` reads what it ran instead of HLO text:

- every aten op, through a ``TorchDispatchMode`` (``OpRecorder``): its
  input and output bytes and its transcendental elements;
- every c10d collective, which the same mode sees as an op
  (``c10d._allgather_base_`` and the like), mapped to the reference's five
  kinds (``C10D_KINDS``) with its operand bytes summed as the reference
  sums an HLO instruction's operands;
- every launch of a hand-written kernel, which its wrapper records on a
  fake CUDA tensor (``kernels/common.recording_fake_launches``) with the
  FLOPs and bytes of its bound;
- the aten ops' FLOPs by ``torch.utils.flop_counter``'s formulas, the
  ones ``FlopCounterMode`` applies (read in the same mode: a second mode
  would cost every fake op another dispatch);
- the live bytes of the storages the step makes, to their peak.

``collective_bytes``, ``collective_counts`` and ``cost_summary`` return the
reference's dicts from such a record.  Unlike XLA's post-fusion figures,
``bytes_accessed`` is unfused: every op reads its inputs and writes its
outputs once (view ops move nothing), so it bounds XLA's count from above.
``generated_code_size_in_bytes`` is 0: the port runs precompiled aten
kernels and the hand-written kernels' one shared library, built once and
not per step.  No scan: the port's layer loop is Python, so every layer's
ops are recorded (the reference's scan caveat does not arise).
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2,
    "s32": 4, "u32": 4, "s64": 8, "u64": 8, "f16": 2, "bf16": 2, "f32": 4,
    "f64": 8, "c64": 8, "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1,
}
"""The reference's table of HLO element types (the port reads
``element_size`` off each tensor; kept for a reader of both)."""

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

C10D_KINDS = {
    "_allgather_base_": "all-gather",
    "allgather_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "allreduce_": "all-reduce",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
    "send": "collective-permute",
    "recv_": "collective-permute",
}
"""c10d op -> the reference's collective kind."""

# the argument of each c10d op that holds its operands: the input of a
# gather, scatter or exchange, the buffers of an all-reduce, send or recv
_OPERAND_ARG = {"allreduce_": 0, "send": 0, "recv_": 0}

MEMORY_KEYS = ("argument_size_in_bytes", "output_size_in_bytes",
               "temp_size_in_bytes", "generated_code_size_in_bytes",
               "alias_size_in_bytes")

TRANSCENDENTAL = frozenset((
    "exp", "exp2", "expm1", "log", "log2", "log10", "log1p", "tanh",
    "sigmoid", "rsqrt", "sqrt", "sin", "cos", "erf", "erfc", "pow",
    "_softmax", "_log_softmax", "logsumexp", "silu", "gelu", "softplus",
    "silu_backward", "gelu_backward", "_log_softmax_backward_data",
    "logaddexp", "atan2", "reciprocal"))
"""aten ops whose every output element takes a transcendental function (a
division, a root or an exponential), as XLA counts them."""


def tensors_in(tree) -> list[torch.Tensor]:
    """Every tensor in nested dicts, lists, tuples and dataclasses (a
    ``SparseWeight``'s buffers, a ``RowShard``'s block)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree, key=str) for t in tensors_in(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensors_in(v)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [t for f in dataclasses.fields(tree)
                for t in tensors_in(getattr(tree, f.name))]
    return []


def nbytes(tree) -> int:
    """The bytes of every tensor in ``tree`` (each leaf its own elements;
    a view counts the elements it shows)."""
    return sum(t.numel() * t.element_size() for t in tensors_in(tree))


class OpRecorder(TorchDispatchMode):
    """Records every op dispatched under it: FLOPs (``flop_registry``),
    bytes in and out of each non-view op, transcendental elements, c10d
    collectives by kind with their operand bytes, and the live bytes of
    the storages the ops make (``peak_bytes``: their high-water mark; a
    storage counts from the op that made it until it is freed)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.transcendentals = 0
        self.collectives: list[tuple[str, int]] = []
        self.live = 0
        self.peak_bytes = 0
        self._seen: dict[int, weakref.ref] = {}

    def _free(self, key: int, n: int) -> None:
        self.live -= n
        self._seen.pop(key, None)

    def known(self, tensors) -> None:
        """Storages that exist before the step (its arguments): never
        counted as made by an op."""
        for t in tensors:
            s = t.untyped_storage()
            self._seen[id(s)] = weakref.ref(s)

    def _track(self, out) -> None:
        for t in tensors_in(out):
            s = t.untyped_storage()
            key = id(s)
            ref = self._seen.get(key)
            if ref is not None and ref() is s:
                continue       # an argument's, or an in-place op's output
            n = s.nbytes()
            self._seen[key] = weakref.ref(s)
            weakref.finalize(s, self._free, key, n)
            self.live += n
        self.peak_bytes = max(self.peak_bytes, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns, _, op = func._schema.name.partition("::")
        if ns == "prim":               # metadata queries (``t.device``)
            return out
        if ns == "c10d":
            kind = C10D_KINDS.get(op)
            if kind is not None:
                operands = args[_OPERAND_ARG.get(op, 1)]
                self.collectives.append((kind, nbytes(operands)))
            return out
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        flat_in = [a for a in tree_flatten((args, kwargs))[0]
                   if isinstance(a, torch.Tensor)]
        flat_out = [a for a in tree_flatten(out)[0]
                    if isinstance(a, torch.Tensor)]
        if not func.is_view and flat_out:
            self.bytes_accessed += sum(t.numel() * t.element_size()
                                       for t in flat_in + flat_out)
            self.known(flat_in)          # outputs written in place
            self._track(flat_out)
        if op.rstrip("_") in TRANSCENDENTAL:
            self.transcendentals += sum(t.numel() for t in flat_out)
        return out


@dataclasses.dataclass
class StepRecord:
    """What ``record_step`` read off one run of a step."""
    aten_flops: int
    kernel_launches: list
    bytes_accessed: int
    transcendentals: int
    collectives: list
    argument_bytes: int
    output_bytes: int
    alias_bytes: int
    temp_bytes: int

    @property
    def flops(self) -> int:
        return self.aten_flops + sum(k.flops for k in self.kernel_launches)

    def launches_by_plan(self) -> dict:
        """{"<kernel>_<path>": launches} of the hand-written kernels, as
        the wrappers' counters name them (``launches_decode`` ...)."""
        out = defaultdict(int)
        for k in self.kernel_launches:
            base = k.kernel.removesuffix("_int8")
            out[f"{base}_{k.plan.path}{k.kernel[len(base):]}"] += 1
        return dict(out)


def record_step(step, args: tuple, *, held=None, donated: tuple = ()
                ) -> StepRecord:
    """Run ``step(*args)`` once under the recorders and return its record.

    ``held`` is what the rank holds as the step's arguments (default
    ``args``): the train step takes the global batch and cuts its rows, so
    the dry run passes the rows.  ``donated`` are the indices of the
    arguments the step's outputs may take over (the reference's
    ``donate_argnums``: params and optimizer state in training, the caches
    in decode)."""
    from ..kernels.common import recording_fake_launches
    inputs = {id(t.untyped_storage()) for t in tensors_in(args)}
    rec = OpRecorder()
    rec.known(tensors_in(args))
    with recording_fake_launches() as launches, rec:
        outputs = step(*args)
    fresh = {}
    for t in tensors_in(outputs):
        s = t.untyped_storage()
        if id(s) not in inputs:
            fresh[id(s)] = t.numel() * t.element_size()
    return StepRecord(
        aten_flops=int(rec.flops),
        kernel_launches=list(launches),
        bytes_accessed=rec.bytes_accessed + sum(k.bytes for k in launches),
        transcendentals=rec.transcendentals,
        collectives=list(rec.collectives),
        argument_bytes=nbytes(args if held is None else held),
        output_bytes=sum(fresh.values()),
        alias_bytes=sum(nbytes(args[i]) for i in donated),
        temp_bytes=rec.peak_bytes)


def collective_bytes(record: StepRecord) -> dict:
    """Per-collective-kind operand bytes, plus 'total' (the reference's
    dict; kinds the step never called are absent)."""
    out: dict[str, float] = defaultdict(float)
    for kind, n in record.collectives:
        out[kind] += n
    out["total"] = sum(v for k, v in out.items() if k != "total")
    return dict(out)


def collective_counts(record: StepRecord) -> dict:
    """Calls of each of the five kinds (0 where none)."""
    out = {kind: 0 for kind in COLLECTIVES}
    for kind, _ in record.collectives:
        out[kind] += 1
    return out


def cost_summary(record: StepRecord) -> dict:
    """The reference's summary: FLOPs (aten ops by ``FlopCounterMode``'s
    formulas plus the kernels' recorded FLOPs), transcendentals, bytes accessed
    (unfused, plus the kernels' bytes), and the memory analysis' five
    keys: argument (what the rank holds as inputs), output (outputs that
    alias no input), temp (the peak of the storages the step made, above
    the arguments), generated code (0) and alias (the donated inputs)."""
    return {
        "flops": float(record.flops),
        "transcendentals": float(record.transcendentals),
        "bytes_accessed": float(record.bytes_accessed),
        "memory": {
            "argument_size_in_bytes": record.argument_bytes,
            "output_size_in_bytes": record.output_bytes,
            "temp_size_in_bytes": record.temp_bytes,
            "generated_code_size_in_bytes": 0,
            "alias_size_in_bytes": record.alias_bytes,
        },
    }
