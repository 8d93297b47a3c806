"""Per-device cost of one step: the reference's HLO walker, and the
port's own tally of a step run on meta tensors.

The walker (``HloModule``, ``analyze_hlo``) is the JAX package's, copied
as it is (it is plain regex code over XLA's HLO text): it walks the
computation graph from ENTRY, multiplying costs through ``while`` trip
counts and recursing through fusions/calls/conditionals, to produce
per-device dot FLOPs (2*M*N*K per dot) and collective bytes by op kind
(all-reduce counted twice for the ring's reduce+broadcast phases).  It
reads any HLO text; the port makes none.

The port's counterpart is :class:`StepTally`, which gives the walker's
keys for a step that eager PyTorch runs: the step runs once on rank 0 of
a fake process group of the mesh's size, on ``meta`` tensors (shapes and
dtypes, no data, no allocation), its parameters and activations DTensors
as on the real mesh.  (Not ``FakeTensorMode``: its per-operation cost is
about 8x the meta kernels', and on it DTensor planned other all-gathers
than on real tensors, where meta tensors plan the same ones.)  Two
dispatch modes see the step's operations:

  * the outer one sees each DTensor operation at its global shapes and
    defers it to DTensor; it adds the products at those shapes into
    ``global_flops`` (the counterpart of XLA's flat ``cost_analysis``;
    a local region's products run on plain tensors and are not in it);
  * the inner one sees what rank 0 then runs: each local operation on its
    shards, and the collectives (``_c10d_functional``) that DTensor's
    redistributes issue.  Products count by ``torch.utils.flop_counter``'s
    formulas at the local shapes (per-device dot and conv FLOPs, as the
    walker counts partitioned HLO), collectives by their per-rank output
    bytes under the walker's op kinds, and every storage it allocates
    into a tally of live bytes whose maximum is the step's peak.

Each operation is also kept by its kind, op and shapes (``ops``: the
local products' shapes, a collective's output shape and group size, a
DTensor product's global shapes and placements), which the dry run's op
table lists.  On a ``("pod", "data", "model")`` mesh the DTensor mesh
has one dim for pod x data, so a collective over both is one collective
over their combined group (group size pod x data), where two nested
mesh dims would issue two in sequence: XLA's collectives over the
combined replica groups count the same way.

Three DTensor internals are adjusted while a tally runs, none of which
changes what a step computes: the shape propagation DTensor runs at global
shapes is hidden from the tally
(``ShardingPropagator._propagate_tensor_meta_non_cached``); the
strided-shard size helper, which builds index tensors and reads them,
runs outside the tally's modes; and a shard-to-shard redistribute on the
CPU mesh issues the all-to-all a CUDA mesh issues, not the gloo fallback
of an all-gather and a chunk.
"""

from __future__ import annotations

import math
import re
from collections import defaultdict

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1, "s4": 1, "u4": 1,
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_OP_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?([\w\.\-]+)\s*=\s*(\(.*?\)|\S+)\s+([\w\-]+)\((.*)$")
_COMP_HDR_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w\.\-]+)\s*(?:\(|\.)")

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def _type_bytes(type_str: str) -> int:
    """Bytes of an HLO type string (tuples summed)."""
    total = 0
    for m in _SHAPE_RE.finditer(type_str):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def _shape_dims(type_str: str) -> list:
    m = _SHAPE_RE.search(type_str)
    if not m:
        return []
    return [int(d) for d in m.group(2).split(",")] if m.group(2) else []


class HloModule:
    def __init__(self, text: str):
        self.computations: dict[str, list[str]] = {}
        self.entry: str | None = None
        self.shapes: dict[str, str] = {}      # op name -> type string
        self._parse(text)

    _HDR_RE = re.compile(r"^(ENTRY\s+)?%([\w\.\-]+)\s*\(")

    def _parse(self, text: str):
        cur = None
        for line in text.splitlines():
            stripped = line.strip()
            if not stripped:
                continue
            hm = self._HDR_RE.match(line)
            if hm and stripped.endswith("{"):
                cur = hm.group(2)
                self.computations[cur] = []
                if hm.group(1):
                    self.entry = cur
                # parameter shapes from the signature
                arrow = line.rfind("->")
                sig = line[line.find("(") + 1: arrow if arrow > 0 else len(line)]
                for pm in re.finditer(
                        r"%?([\w\.\-]+):\s*((?:\([^)]*\))|\S+?[\]\}])", sig):
                    self.shapes[pm.group(1)] = pm.group(2)
                continue
            if stripped == "}":
                cur = None
                continue
            if cur is not None:
                self.computations[cur].append(line)
                m = _OP_RE.match(line)
                if m:
                    self.shapes[m.group(1)] = m.group(2)

    # -- trip counts ---------------------------------------------------------
    def trip_count(self, cond_name: str) -> int:
        """Heuristic: largest s32/s64 constant in the loop condition."""
        best = 1
        for line in self.computations.get(cond_name, []):
            for m in re.finditer(r"constant\((\d+)\)", line):
                best = max(best, int(m.group(1)))
        return best

    # -- cost walk -------------------------------------------------------------
    def analyze(self) -> dict:
        flops = defaultdict(float)
        coll = defaultdict(float)
        visited_guard: set = set()

        def walk(comp: str, mult: float):
            if (comp, mult) in visited_guard and mult > 1e12:
                return
            for line in self.computations.get(comp, []):
                m = _OP_RE.match(line)
                if not m:
                    continue
                name, otype, opcode, rest = m.groups()
                if opcode == "while":
                    body = re.search(r"body=%?([\w\.\-]+)", rest)
                    # primary: XLA's own known_trip_count backend_config
                    tc = re.search(r'known_trip_count[^0-9]*(\d+)', rest)
                    if tc:
                        trips = int(tc.group(1))
                    else:  # fallback: comparison constant in the condition
                        cond = re.search(r"condition=%?([\w\.\-]+)", rest)
                        trips = self.trip_count(cond.group(1)) if cond else 1
                    if body:
                        walk(body.group(1), mult * trips)
                elif opcode in ("fusion", "call", "async-start"):
                    cm = re.search(r"(?:calls|to_apply|to)=%?([\w\.\-]+)", rest)
                    if cm:
                        walk(cm.group(1), mult)
                elif opcode == "conditional":
                    for cm in re.finditer(
                            r"(?:true_computation|false_computation|branch_computations=\{)([^,}]+)",
                            rest):
                        walk(cm.group(1).strip().lstrip("%"), mult)
                elif opcode in ("dot", "cudnn-dot"):
                    self._dot_flops(name, otype, rest, mult, flops)
                elif opcode == "convolution":
                    # rough: 2 * output elems * (kernel elems per output)
                    out = _shape_dims(otype)
                    flops["convolution"] += mult * 2 * math.prod(out or [0])
                else:
                    for c in COLLECTIVES:
                        if opcode.startswith(c):
                            factor = 2.0 if c == "all-reduce" else 1.0
                            coll[c] += mult * factor * _type_bytes(otype)
                            break

        def _noop(*a):
            pass

        if self.entry:
            walk(self.entry, 1.0)
        return {
            "dot_flops": float(flops["dot"]),
            "conv_flops": float(flops["convolution"]),
            "collective_bytes": dict(coll),
            "total_collective_bytes": float(sum(coll.values())),
        }

    def _dot_flops(self, name, otype, rest, mult, flops):
        out_elems = math.prod(_shape_dims(otype) or [0])
        # contracted extent from lhs shape + lhs_contracting_dims.  Operands
        # appear either bare (``dot(%p0, %p1)``) or with their type inlined
        # (``dot(f32[16,512]{1,0} %convert.33, ...)``) depending on the HLO
        # printer version; accept both.
        ops = re.match(r"\s*(?:(\S*\[[\d,]*\]\S*)\s+)?%?([\w\.\-]+)", rest)
        k = 1
        cm = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", rest)
        if ops and cm and cm.group(1):
            lhs_type = ops.group(1) or self.shapes.get(ops.group(2), "")
            lhs_shape = _shape_dims(lhs_type)
            for d in cm.group(1).split(","):
                di = int(d)
                if di < len(lhs_shape):
                    k *= lhs_shape[di]
        flops["dot"] += mult * 2.0 * out_elems * k


def analyze_hlo(text: str) -> dict:
    return HloModule(text).analyze()


# ---------------------------------------------------------------------------
# the port's tally of one step on meta tensors
# ---------------------------------------------------------------------------
# collective op (its overload packet's name) -> the walker's op kind
_COLLECTIVE_KINDS = {
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd",
                          "c10d", "_dtensor")


def _collective_kind(func):
    if func.namespace not in _COLLECTIVE_NAMESPACES:
        return None
    return _COLLECTIVE_KINDS.get(func._overloadpacket.__name__)


def _tensors(tree) -> list:
    import torch
    from torch.utils._pytree import tree_leaves
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


class _Depth:
    """A reentrant context that counts how deep it is entered."""

    def __init__(self):
        self.n = 0

    def __enter__(self):
        self.n += 1

    def __exit__(self, *exc):
        self.n -= 1


class StepTally:
    """Per-device FLOPs, collective bytes and live bytes of what runs
    inside it, on rank 0 (see the module docstring).

    Build the step's inputs (``meta`` tensors) inside it and hand them to
    :meth:`mark_arguments`, run the step, hand its outputs to
    :meth:`mark_outputs`; then :meth:`walk` gives the walker's dict,
    :meth:`memory` the per-device memory record and ``global_flops`` the
    products at DTensor's global shapes.
    """

    def __init__(self):
        from torch.utils.flop_counter import flop_registry
        self._registry = flop_registry
        self.flops = defaultdict(float)
        self.coll = defaultdict(float)
        # per operation: (kind, op, shapes) -> [count, FLOPs or bytes]
        self.ops = defaultdict(lambda: [0, 0.0])
        self.global_flops = 0.0
        self.n_ops = 0
        self.live = 0
        self.peak = 0
        self._argument_bytes = 0
        self._argument_storages = None
        self._output = None
        self._counting = False
        self._propagating = _Depth()
        self._storages = None
        self._stack = None

    # -- storages ------------------------------------------------------------
    def _track(self, out) -> None:
        import weakref
        for t in _tensors(out):
            st = t.untyped_storage()
            if st in self._storages:
                continue
            n = st.nbytes()
            self.live += n
            self.peak = max(self.peak, self.live)
            self._storages[st] = weakref.ref(st, self._freed(n))

    def _freed(self, n):
        def cb(_ref):
            self.live -= n
        return cb

    # -- the operations --------------------------------------------------------
    def _local(self, func, args, kwargs, out) -> None:
        if self._propagating.n:
            return
        self._track(out)
        if not self._counting:
            return
        self.n_ops += 1
        pk = func._overloadpacket
        if pk in self._registry:
            n = self._registry[pk](*args, **kwargs, out_val=out)
            kind = "conv" if "conv" in pk.__name__ else "dot"
            self.flops[kind] += n
            self._note(kind, pk.__name__, _shapes(args), n)
            return
        kind = _collective_kind(func)
        if kind is not None:
            b = sum(t.numel() * t.element_size() for t in _tensors(out))
            b *= 2.0 if kind == "all-reduce" else 1.0
            self.coll[kind] += b
            self._note(kind, pk.__name__, _shapes(out) + " group "
                       + _group_size(args), b)

    def _note(self, kind, op, shapes, amount) -> None:
        rec = self.ops[(kind, op, shapes)]
        rec[0] += 1
        rec[1] += amount

    def _global(self, func, args, kwargs) -> None:
        pk = func._overloadpacket
        if (self._counting and not self._propagating.n
                and pk in self._registry and "conv" not in pk.__name__):
            n = self._registry[pk](*args, **kwargs, out_val=None)
            self.global_flops += n
            self._note("global", pk.__name__, _shapes(args, placed=True), n)

    # -- context ---------------------------------------------------------------
    def __enter__(self):
        import contextlib

        from torch.distributed.tensor import DTensor, placement_types
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
        from torch.utils._python_dispatch import (TorchDispatchMode,
                                                  _disable_current_modes)
        from torch.utils.weak import WeakIdKeyDictionary

        tally = self
        self._storages = WeakIdKeyDictionary()

        class _Local(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                tally._local(func, args, kwargs, out)
                return out

        class _Outer(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if any(issubclass(t, DTensor) for t in types):
                    tally._global(func, args, kwargs or {})
                    return NotImplemented     # DTensor runs it, locally
                return func(*args, **(kwargs or {}))

        def modeless(fn):
            def run(*a, **k):
                with _disable_current_modes():
                    return fn(*a, **k)
            return run

        def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
            import torch
            group = mesh.get_group(mesh_dim).group_name
            return torch.ops._dtensor.shard_dim_alltoall(
                input, gather_dim, shard_dim, group)

        def hidden(fn):
            def run(*a, **k):
                with tally._propagating:
                    return fn(*a, **k)
            return run

        prop = ShardingPropagator._propagate_tensor_meta_non_cached
        strided = placement_types._StridedShard
        patches = [(ShardingPropagator, "_propagate_tensor_meta_non_cached",
                    hidden(prop))]
        if "shard_dim_alltoall" in vars(placement_types):
            patches.append((placement_types, "shard_dim_alltoall", alltoall))
        for name in ("local_shard_size_and_offset",
                     "_local_shard_size_and_offset"):
            if name in vars(strided):
                patches.append((strided, name,
                                modeless(getattr(strided, name))))
        stack = contextlib.ExitStack()
        for owner, name, value in patches:
            old = vars(owner)[name]
            setattr(owner, name, value)
            stack.callback(setattr, owner, name, old)
        stack.enter_context(_Local())
        stack.enter_context(_Outer())
        self._stack = stack
        return self

    def __exit__(self, *exc):
        self._stack.close()
        self._stack = None
        return False

    # -- the step ----------------------------------------------------------------
    def mark_arguments(self, args) -> None:
        """The step's inputs (built inside the tally): their bytes are the
        record's ``argument_bytes``; counting starts."""
        sts = {id(t.untyped_storage()): t.untyped_storage()
               for t in _tensors(_locals(args))}
        self._argument_storages = sts
        self._argument_bytes = sum(s.nbytes() for s in sts.values())
        self._counting = True

    def mark_outputs(self, out) -> None:
        """The step's outputs; counting stops."""
        self._counting = False
        self._output = {id(t.untyped_storage()): t.untyped_storage()
                        for t in _tensors(_locals(out))}

    def memory(self) -> dict:
        """The per-device record of the reference's ``memory_analysis``:
        ``argument_bytes`` (the inputs' shards on rank 0), ``output_bytes``
        (every output storage), ``alias_bytes`` (those that are input
        storages: a state or caches written in place), ``temp_bytes`` (the
        rest of the peak), and ``peak_bytes`` = argument + output + temp -
        alias, the most live bytes at any point of the step."""
        out = sum(s.nbytes() for s in self._output.values())
        alias = sum(s.nbytes() for k, s in self._output.items()
                    if k in self._argument_storages)
        arg = self._argument_bytes
        temp = self.peak - arg - out + alias
        return {"argument_bytes": int(arg), "output_bytes": int(out),
                "temp_bytes": int(temp), "alias_bytes": int(alias),
                "peak_bytes": int(arg + out + temp - alias)}

    def walk(self) -> dict:
        """The walker's keys for the step (per device)."""
        return {
            "dot_flops": float(self.flops["dot"]),
            "conv_flops": float(self.flops["conv"]),
            "collective_bytes": dict(self.coll),
            "total_collective_bytes": float(sum(self.coll.values())),
        }


def _shapes(tree, placed: bool = False) -> str:
    """The shapes of a call's tensors, ``x``-joined per tensor (with a
    DTensor's placements when ``placed``)."""
    out = []
    for t in _tensors(tree):
        s = "x".join(str(n) for n in t.shape) or "()"
        if placed and hasattr(t, "placements"):
            s += "[" + ",".join(_short(p) for p in t.placements) + "]"
        out.append(s)
    return " ".join(out)


def _short(p) -> str:
    """``S<dim>`` for a shard, else the placement's initial (R, P)."""
    return f"S{p.dim}" if hasattr(p, "dim") else type(p).__name__[0]


def _group_size(args) -> str:
    """The size of the group a functional collective runs over (its last
    string argument names the group), or ``?``."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    names = [a for a in args if isinstance(a, str)]
    return str(_resolve_process_group(names[-1]).size()) if names else "?"


def _locals(tree):
    """Each DTensor of ``tree`` replaced by its local shard."""
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_map
    return tree_map(
        lambda x: x._local_tensor if isinstance(x, DTensor) else x, tree)
