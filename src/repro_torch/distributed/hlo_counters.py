"""Loop-aware counters of one step at one rank: FLOPs, device-memory bytes,
collective link bytes and the peak of live tensor bytes.

The counterpart of `repro/distributed/hlo_counters.py`. The reference
walks the compiled, SPMD-partitioned HLO of a jitted step; the port runs
eagerly and has no HLO, so its "module" is the recorded trace of one step
at one rank: `Recorder`, a `TorchDispatchMode`, sees every aten op and
every collective (c10d's and the functional ones DTensor issues) with
this rank's shapes, and `analyze` sums them by the reference's rules:

  flops   : dot = 2 * prod(out dims) * K (mm, bmm, addmm, ...);
            reduce = input numel; every other op = output numel;
            a hand-written kernel counts its cost (`kernels/cost.py`).
  bytes   : per op, output + operand bytes: in eager mode every aten op
            is one round trip through device memory (the reference's
            `fused_bytes=True` model); views (bitcast, tuple and GTE
            there) and allocations without a write are free.
  link    : all-gather (N-1)/N*out; all-reduce 2(N-1)/N*out;
            reduce-scatter & all-to-all (N-1)/N*in; broadcast and
            point-to-point out; N the size of the op's group.

Kernels. On tensors without data (`FakeTensor`, `meta`) a kernel's entry
in `kernels/ops.py` returns its outputs' shapes and records its cost,
never its plain version; on real tensors it records the same cost and
hides the ops that compute it (`Recorder(kernels="cost")`, the card's
count), or lets them be counted as they run (`kernels="ops"`, what the
CPU runs).

Trip counts. The reference multiplies each while body by its trip count.
The port's time loops (the sLSTM's positions, the mLSTM's query chunks,
the Mamba scan's chunks) run through `counted_loop`: under a recording it
runs the loop for 3 and 4 iterations on tensors of the same shapes and
records count(3) + (n - 3) * (count(4) - count(3)), forward and backward
apart (the backward with the gradients the step really passes, the
inputs' gradients laid out as the loop's autograd leaves them), keeps
the bytes the real loop's autograd saves from forward to backward alive
in one buffer (what a measuring run leaves alive besides its outputs,
under `saved_tensors_hooks` that keep every saved tensor, extrapolated
the same way) and the inputs those hooks see saved, and takes each pass's peak above its start for a moment
(the backward's where its first iterations put it, unless it grows). Outside a recording the loop runs as it is. The microbatch
loop is extrapolated from whole traces: `extrapolate(t1, t2, 1, 2, A)`.

Memory. The recorder follows every storage an op creates (and the
step's arguments, `hold`) until it is freed: `Trace.peak_bytes` is the
peak of live tensor bytes at this rank.
"""
from __future__ import annotations

import dataclasses
import weakref
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_STACK: List["Recorder"] = []

_FREE = {
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "_unsafe_view", "lift_fresh", "set_", "resize_", "detach_",
    "_local_scalar_dense", "is_same_size", "record_stream",
    "wait_tensor", "barrier", "monitored_barrier_",
}
_DOTS = {"mm": (0, 1), "bmm": (0, 1), "addmm": (1, 2), "baddbmm": (1, 2),
         "addbmm": (1, 2), "_addmm_activation": (1, 2), "mv": (0, 1),
         "addmv": (1, 2), "dot": (0, 1), "vdot": (0, 1)}
_REDUCE = {
    "sum", "mean", "amax", "amin", "max", "min", "prod", "var", "var_mean",
    "std", "std_mean", "argmax", "argmin", "any", "all", "norm",
    "linalg_vector_norm", "logsumexp", "cumsum", "cumprod", "logcumsumexp",
    "topk", "sort", "_softmax", "_log_softmax", "_softmax_backward_data",
    "_log_softmax_backward_data", "nansum",
}
_COLLECTIVES = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "broadcast_": "collective-permute", "broadcast": "collective-permute",
    "send": "collective-permute",
    "recv_": "collective-permute", "recv_any_source_": "collective-permute",
}
# c10d's in-place collectives whose first tensor argument is both what
# they read and what they write.
_IN_PLACE = {"allreduce_", "allreduce_coalesced_", "broadcast_", "send",
             "recv_", "recv_any_source_", "all_reduce_",
             "all_reduce_coalesced_"}


def active() -> Optional["Recorder"]:
    """The recorder of the innermost recording, or None."""
    return _STACK[-1] if _STACK else None


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _nbytes(x) -> float:
    return float(sum(t.numel() * t.element_size() for t in _tensors(x)))


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local block; any other tensor as it is."""
    return getattr(t, "_local_tensor", t)


def _group_size(args, kwargs) -> int:
    import torch.distributed as dist

    vals = list(args) + list(kwargs.values())
    for v in vals:
        if isinstance(v, torch.ScriptObject):  # c10d's ops box the group
            try:
                v = dist.ProcessGroup.unbox(v)
            except RuntimeError:
                continue
        if isinstance(v, dist.ProcessGroup):
            return v.size()
    if "group_size" in kwargs:
        return int(kwargs["group_size"])
    ints = [v for v in vals[1:] if isinstance(v, int) and
            not isinstance(v, bool)]
    names = [v for v in vals if isinstance(v, str)]
    if names:
        from torch.distributed.distributed_c10d import _resolve_process_group

        return _resolve_process_group(names[-1]).size()
    return ints[0] if ints else 1


@dataclasses.dataclass
class Rec:
    """One op (or, for a loop or a microbatch extrapolated, a sum of
    calls of it): totals over `calls`."""
    op: str  # "aten.mm", "kernel.flash_attention", "c10d.allreduce_", ...
    kind: str  # "dot", "reduce", "elementwise", "kernel" or a collective's
    calls: float
    flops: float
    dot_flops: float
    out_bytes: float
    in_bytes: float
    group: int = 1

    def key(self) -> Tuple[str, str, int]:
        return self.op, self.kind, self.group

    def vec(self) -> List[float]:
        return [self.calls, self.flops, self.dot_flops, self.out_bytes,
                self.in_bytes]


@dataclasses.dataclass
class Trace:
    """The recorded step at one rank: its ops and the peak of live tensor
    bytes (the arguments `hold` registered included)."""
    records: List[Rec] = dataclasses.field(default_factory=list)
    peak_bytes: float = 0.0
    held_bytes: float = 0.0

    def aggregate(self) -> Dict[Tuple[str, str, int], List[float]]:
        out: Dict[Tuple[str, str, int], List[float]] = {}
        for r in self.records:
            acc = out.setdefault(r.key(), [0.0] * 5)
            for i, v in enumerate(r.vec()):
                acc[i] += v
        return out

    def calls(self, op: str) -> float:
        """How many times `op` ran ("kernel.flash_attention", ...)."""
        return sum(r.calls for r in self.records if r.op == op)


def _from_aggregate(agg) -> List[Rec]:
    return [Rec(op, kind, *v, group=g) for (op, kind, g), v in agg.items()
            if any(v)]


def extrapolate(lo: Trace, hi: Trace, m_lo: int, m_hi: int, n: int
                ) -> Trace:
    """The trace of n iterations from traces of m_lo and m_hi (each op's
    totals linear in the iteration count): lo + (n - m_lo) * (hi - lo) /
    (m_hi - m_lo); the peak is hi's (the steady state)."""
    a, b = lo.aggregate(), hi.aggregate()
    k = (n - m_lo) / (m_hi - m_lo)
    agg = {key: [x + k * (y - x) for x, y in
                 zip(a.get(key, [0.0] * 5), b.get(key, [0.0] * 5))]
           for key in {**a, **b}}
    return Trace(_from_aggregate(agg), hi.peak_bytes, hi.held_bytes)


class _Memory:
    """Live tensor bytes of the storages one recording (or one measuring
    run) made, and their peak."""

    def __init__(self):
        self.now = 0
        self.peak = 0

    def add(self, nb: int) -> None:
        self.now += nb
        self.peak = max(self.peak, self.now)


class Recorder(TorchDispatchMode):
    """Records every aten op and collective of what runs inside it.

    `kernels`: "cost" records a hand-written kernel's entry by its cost
    and hides the ops of whatever computes it (the card's count); "ops"
    lets the plain version's ops be counted on real CPU tensors. On
    tensors without data a kernel always counts its cost. `loops`: trip
    count the time loops (`counted_loop`); without it they run in full.
    Live tensor bytes are followed throughout."""

    def __init__(self, kernels: str = "cost", loops: bool = True):
        super().__init__()
        if kernels not in ("cost", "ops"):
            raise ValueError(kernels)
        self.kernels, self.loops = kernels, loops
        self.trace = Trace()
        self._sink: List[Rec] = self.trace.records
        self._quiet = 0
        self._mem = [_Memory()]  # the innermost takes new storages
        self._owner: Dict[int, Tuple[_Memory, int]] = {}

    def __enter__(self):
        import torch.distributed as dist

        _STACK.append(self)
        # what a collective's backend runs to finish it (gloo's host
        # copies at `wait`) is not this rank's program either
        self._wait = dist.Work.wait

        def wait(work, *a, **kw):
            with self.quiet():
                return self._wait(work, *a, **kw)

        dist.Work.wait = wait
        return super().__enter__()

    def __exit__(self, *exc):
        import torch.distributed as dist

        dist.Work.wait = self._wait
        _STACK.remove(self)
        self.trace.peak_bytes = self._mem[0].peak
        return super().__exit__(*exc)

    # -- memory ------------------------------------------------------------
    def _track(self, tensors) -> None:
        mem = self._mem[-1]
        for t in tensors:
            try:
                st = _local(t).untyped_storage()
            except (RuntimeError, NotImplementedError):
                continue
            k = id(st)
            if k in self._owner:
                continue
            nb = int(st.nbytes())
            self._owner[k] = (mem, nb)
            mem.add(nb)
            weakref.finalize(st, self._free, k)

    def _free(self, k: int) -> None:
        mem, nb = self._owner.pop(k, (None, 0))
        if mem is not None:
            mem.now -= nb

    def hold(self, tree) -> None:
        """Count the storages of `tree`'s tensors (the step's arguments)
        as live from now on."""
        from repro_torch.tree_util import tree_leaves

        before = self._mem[-1].now
        self._track([t for t in tree_leaves(tree)
                     if isinstance(t, torch.Tensor)])
        self.trace.held_bytes += self._mem[-1].now - before

    @property
    def live_bytes(self) -> int:
        return self._mem[0].now

    @property
    def peak_bytes(self) -> int:
        return self._mem[0].peak

    def transient(self, nbytes: float, device) -> None:
        """Take `nbytes` for a moment: a stand-in's peak inside it."""
        if nbytes > 0:
            self._track([torch.empty((int(nbytes),), dtype=torch.uint8,
                                     device=device)])

    # -- counting ----------------------------------------------------------
    def add(self, *recs: Rec) -> None:
        if not self._quiet:
            self._sink.extend(recs)

    def kernel(self, name: str, cost) -> None:
        """Record one call of hand-written kernel `name` by its `Cost`."""
        self.add(Rec(f"kernel.{name}", "kernel", 1.0, cost.ops, 0.0,
                     cost.bytes, 0.0))

    @contextmanager
    def quiet(self):
        """Count nothing inside (a kernel's plain or shape-only route);
        live bytes are still followed."""
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1

    @contextmanager
    def capture(self):
        """Records inside go to a trace of their own, and the storages
        made inside to a memory of their own (yielded: (trace, memory)):
        a loop's measuring runs."""
        sink, quiet = self._sink, self._quiet
        t, mem = Trace(), _Memory()
        self._sink, self._quiet = t.records, 0
        self._mem.append(mem)
        try:
            yield t, mem
        finally:
            self._sink, self._quiet = sink, quiet
            self._mem.remove(mem)
            t.peak_bytes = mem.peak

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        # what a collective's backend runs inside it (gloo's host copies,
        # on its own threads) is not this rank's program
        inside = func.overloadpacket.__name__ in _COLLECTIVES
        self._quiet += inside
        try:
            out = func(*args, **kwargs)
        finally:
            self._quiet -= inside
        if not self._quiet:
            rec = _count(func, args, kwargs, out)
            if rec is not None:
                self._sink.append(rec)
        self._track(_tensors(out))
        return out


def _count(func, args, kwargs, out) -> Optional[Rec]:
    ns = func.namespace
    name = func.overloadpacket.__name__
    op = f"{ns}.{name}"
    if name in _FREE:
        return None
    if name in _COLLECTIVES:
        kind = _COLLECTIVES[name]
        if ns == "c10d":
            src = args[0] if name in _IN_PLACE else args[1]
            dst = args[0]
        else:
            src = args[0]
            dst = args[0] if name.endswith("_") else out
        return Rec(op, kind, 1.0, 0.0, 0.0, _nbytes(dst), _nbytes(src),
                   _group_size(args, kwargs))
    if func.is_view or ns not in ("aten", "prims"):
        return None
    ins = [_local(t) for t in _tensors(list(args) + list(kwargs.values()))]
    outs = [_local(t) for t in _tensors(out)]
    in_b = float(sum(t.numel() * t.element_size() for t in ins))
    out_b = float(sum(t.numel() * t.element_size() for t in outs))
    out_n = float(sum(t.numel() for t in outs))
    if name in _DOTS:
        a_idx, _ = _DOTS[name]
        a = args[a_idx]
        k = a.numel() if a.dim() == 1 else a.shape[-1]
        dot = 2.0 * (outs[0].numel() if outs else 1) * k
        extra = out_n if name.startswith(("add", "badd", "_addmm")) else 0.0
        return Rec(op, "dot", 1.0, dot + extra, dot, out_b, in_b)
    if name in _REDUCE:
        n = float(max((t.numel() for t in ins), default=0))
        return Rec(op, "reduce", 1.0, n, 0.0, out_b, in_b)
    return Rec(op, "elementwise", 1.0, out_n, 0.0, out_b, in_b)


@contextmanager
def kernel_call(name: str, cost: Callable[[], object], shape_only: bool):
    """Around one entry of a hand-written kernel: under a recording,
    record its cost (`cost()`, a `kernels.cost.Cost`) and count nothing of
    what computes it, unless the recording counts the CPU's plain ops
    (`kernels="ops"`) and the inputs hold data."""
    rec = active()
    if rec is None or (rec.kernels == "ops" and not shape_only):
        yield
        return
    rec.kernel(name, cost())
    with rec.quiet():
        yield


# ---------------------------------------------------------------------------
# Trip counts
# ---------------------------------------------------------------------------
def _meta(t):
    if isinstance(t, torch.Tensor):
        return ("t", tuple(t.shape), t.dtype, t.device, t.requires_grad,
                tuple(t.stride()))
    return ("v", t)


def _fresh(metas):
    out = []
    for m in metas:
        if m[0] == "v":
            out.append(m[1])
            continue
        _, shape, dtype, device, grad, stride = m
        t = torch.empty_strided(shape, stride, dtype=dtype, device=device)
        out.append(t.requires_grad_(True) if grad else t)
    return out


_MEASURED = (3, 4)  # the iterations a stand-in's measuring runs take


def _at(v, n: int) -> float:
    """The line through (3, v[0]) and (4, v[1]) at n."""
    m = _MEASURED[0]
    return v[0] + (n - m) * (v[1] - v[0])


def _shape_at(s3, s4, n):
    return tuple(int(_at((a, b), n)) for a, b in zip(s3, s4))


def _layout(t: torch.Tensor):
    """What `_empty_as` reads of `t`: shape, strides, dtype, device."""
    return tuple(t.shape), tuple(t.stride()), t.dtype, t.device


def _empty_as(shape, layout) -> torch.Tensor:
    """An empty tensor of `shape` laid out as `layout`'s tensor: its very
    strides where the shapes agree, else its dimensions in the same order
    (outermost first), dense."""
    ref_shape, stride, dtype, device = layout
    if tuple(shape) == ref_shape:
        return torch.empty_strided(shape, stride, dtype=dtype, device=device)
    order = sorted(range(len(shape)), key=lambda d: -stride[d])
    t = torch.empty([shape[d] for d in order], dtype=dtype, device=device)
    return t.permute([order.index(d) for d in range(len(shape))])


class _TripCounted(torch.autograd.Function):
    """`run(n, *inputs)`'s outputs (empty, of the n-iteration shapes and
    the loop's layout), its counts extrapolated from 3 and 4 iterations,
    its peak inside each pass taken for a moment, and the bytes its
    autograd saves held from forward to backward."""

    @staticmethod
    def forward(ctx, run, n, rec, *inputs):
        ctx.set_materialize_grads(False)
        metas = [_meta(t) for t in inputs]
        counts, outs, peaks, ends = [], [], [], []
        for m in _MEASURED:
            with rec.capture() as (t, mem):
                xs = _fresh(metas)
                keys = {id(_local(x).untyped_storage()): i
                        for i, x in enumerate(xs)
                        if isinstance(x, torch.Tensor)}
                kept = set()

                def pack(x):
                    kept.add(keys.get(id(_local(x).untyped_storage())))
                    return x

                base = mem.now
                mem.peak = base
                # autograd keeps what it saves (no outer hooks, such as a
                # checkpoint's, drop it): what the loop leaves alive at
                # its end is its outputs and what its backward reads, its
                # inputs' storages among them (`kept`)
                with torch.enable_grad(), \
                        torch.autograd.graph.saved_tensors_hooks(
                            pack, lambda x: x):
                    o = run(m, *xs)
                outs.append([_layout(x) for x in o])
                peaks.append(mem.peak - base)
                ends.append(mem.now - base - _nbytes(list(o)))
                del o, xs
            counts.append(t)
        rec.add(*extrapolate(counts[0], counts[1], *_MEASURED, n).records)
        ctx.run, ctx.n, ctx.rec, ctx.metas = run, n, rec, metas
        dev = outs[0][0][3]
        out = tuple(_empty_as(_shape_at(a[0], b[0], n), b)
                    for a, b in zip(outs[0], outs[1]))
        rec.transient(max(_at(peaks, n), _at(ends, n) + _nbytes(list(out)))
                      - _nbytes(list(out)), dev)
        ctx.save_for_backward(torch.empty((max(int(_at(ends, n)), 0),),
                                          dtype=torch.uint8, device=dev),
                              *(inputs[i] for i in sorted(kept - {None})))
        return out

    @staticmethod
    def backward(ctx, *grads):
        rec = ctx.rec
        counts, peaks, got = [], [], []
        for m in _MEASURED:
            with rec.capture() as (t, mem):
                xs = _fresh(ctx.metas)
                with torch.enable_grad():
                    o = ctx.run(m, *xs)
                pairs = [(x, _empty_as(x.shape, _layout(g)))
                         for x, g in zip(o, grads)
                         if g is not None and x.requires_grad]
                want = [x for x, need in zip(xs, ctx.needs_input_grad[3:])
                        if need]
                del t.records[:]
                base = mem.now
                mem.peak = base
                gs = torch.autograd.grad(
                    [p for p, _ in pairs], want, [g for _, g in pairs],
                    allow_unused=True) if pairs and want else ()
                peaks.append(mem.peak - base)
                got = [None if g is None else _layout(g) for g in gs]
                del o, pairs, want, xs, gs
            counts.append(t)
        rec.add(*extrapolate(counts[0], counts[1], *_MEASURED,
                             ctx.n).records)
        # a backward's peak stays where its first iterations put it, or
        # grows with the iterations
        rec.transient(_at([peaks[0], max(peaks)], ctx.n), ctx.metas[0][3])
        # each input's gradient laid out as the loop's autograd leaves it
        got = iter(got)
        out = [None, None, None]
        for need, m in zip(ctx.needs_input_grad[3:], ctx.metas):
            lay = next(got, None) if need else None
            out.append(None if lay is None else _empty_as(lay[0], lay))
        return tuple(out)


def counted_loop(run: Callable, n: int, *inputs) -> tuple:
    """`run(n, *inputs)`, a loop of n iterations whose outputs (a tuple of
    tensors) grow linearly with the iterations it runs. Under a recording
    that counts trip counts (and n > 4), the stand-in `_TripCounted`; each
    iteration must do the same work, with no collective."""
    rec = active()
    if rec is None or not rec.loops or n <= _MEASURED[1]:
        return run(n, *inputs)
    return _TripCounted.apply(run, n, rec, *inputs)


# ---------------------------------------------------------------------------
# The counters
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Counters:
    flops: float = 0.0
    bytes: float = 0.0
    link_bytes: float = 0.0
    coll_counts: Dict[str, float] = dataclasses.field(default_factory=dict)
    coll_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)
    dot_flops: float = 0.0
    # attribution: op name -> total contribution
    bytes_by_op: Dict[str, float] = dataclasses.field(default_factory=dict)
    link_by_op: Dict[str, float] = dataclasses.field(default_factory=dict)
    flops_by_op: Dict[str, float] = dataclasses.field(default_factory=dict)

    def top(self, table: Dict[str, float], n: int = 12):
        return sorted(table.items(), key=lambda kv: -kv[1])[:n]


def link_bytes(kind: str, out_b: float, in_b: float, N: int) -> float:
    """Per-device link bytes of one collective under the ring model."""
    if kind == "all-gather":
        return out_b * (N - 1) / N
    if kind == "all-reduce":
        return 2.0 * out_b * (N - 1) / max(N, 1)
    if kind in ("reduce-scatter", "all-to-all"):
        return in_b * (N - 1) / max(N, 1)
    return out_b  # collective-permute


def analyze(trace: Trace, n_devices: int = 1) -> Counters:
    """The reference's `Counters` of a recorded trace (per-rank numbers).
    A collective's group is its own; `n_devices` is the group of one
    recorded without it."""
    out = Counters()

    def attribute(table, op, v):
        if v:
            table[op] = table.get(op, 0.0) + v

    for r in trace.records:
        b = r.out_bytes + r.in_bytes
        out.bytes += b
        attribute(out.bytes_by_op, r.op, b)
        if r.kind in ("all-gather", "all-reduce", "reduce-scatter",
                      "all-to-all", "collective-permute"):
            link = link_bytes(r.kind, r.out_bytes, r.in_bytes,
                              r.group or n_devices)
            out.coll_counts[r.kind] = out.coll_counts.get(r.kind, 0.0) \
                + r.calls
            out.coll_bytes[r.kind] = out.coll_bytes.get(r.kind, 0.0) + link
            out.link_bytes += link
            attribute(out.link_by_op, r.op, link)
            continue
        out.flops += r.flops
        out.dot_flops += r.dot_flops
        attribute(out.flops_by_op, r.op, r.flops)
    return out

