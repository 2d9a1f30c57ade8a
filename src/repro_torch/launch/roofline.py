"""Roofline terms of one step, counted from the ops it runs.

The counterpart of ``repro/launch/roofline.py``.  The reference compiles
its step and parses the partitioned XLA HLO; in the port the step itself
is the program and each eager op is one launch, so a ``TorchDispatchMode``
(``TraceCounter``) counts the ops as one rank runs them, on the meta
device under a fake world (``launch/mesh.fake_world``): nothing is
allocated and every collective returns at once.  The port's "fusion
boundary" is the op boundary, closer to what the card does than HLO's.

Counted, per device (one rank):

* FLOPs: 2 M N K for every matmul (``mm``, ``addmm``, ``bmm``,
  ``baddbmm``) and the convolutions, by ``torch.utils.flop_counter``'s
  formulas, forward and backward; plus each kernel's own record
  (``kernels/cost.py``, from the wrappers' meta branch).  Split by rate
  class: a matmul's operand dtype (bf16 at the tensor-core peak, f32 at
  the CUDA-core peak), a kernel's own class.
* HBM bytes: operand plus output bytes of every op that moves data.
  Views and aliases (a return with alias info: ``view``, ``t``,
  ``expand``, ``as_strided``, in-place view ops) and allocations
  (``empty*``) are free, like the reference's ``_NO_TRAFFIC``; a gather
  (``embedding``, ``index``) moves its output twice and its indices.
* Collectives: every ``c10d`` op by kind, its output bytes (the
  reference's measure) and its group's ranks, classified as within a host
  of ``GPUS_PER_HOST``, across hosts, or across pods: the counterparts of
  the reference's ICI/DCN split (``_crosses_pod``).
* Memory: the bytes live before the step (``track_args``: parameters,
  optimizer state, caches, the rank's batch) and the peak of the storage
  bytes the step allocates while it runs (a ``weakref.finalize`` on each
  new storage), the counterparts of ``memory_analysis()``'s argument and
  temp sizes; and the step's bytes live when its first backward begins
  (``mem_saved_bytes``: what the forward kept for the backward, remat's
  layer boundaries among them).

Terms (seconds), from ``core/h100.py``:
    compute    = sum over classes of flops / the class's peak
    memory     = hbm_bytes / 3.35e12
    collective = nvlink_bytes / 450e9 + network_bytes / 50e9
"""
from __future__ import annotations

import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..core import h100
from ..kernels import cost

__all__ = ["TraceCounter", "model_flops", "roofline"]

aten = torch.ops.aten

# allocations, and views whose schema carries no alias info
_FREE = {aten.empty.memory_format, aten.empty_like.default,
         aten.empty_strided.default, aten.new_empty.default,
         aten.new_empty_strided.default, aten._unsafe_view.default}
_GATHERS = {aten.embedding.default, aten.index.Tensor,
            aten.index_select.default, aten.gather.default}
_COLL_KINDS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast_": "broadcast", "send": "send/recv", "recv_": "send/recv",
    "recv_any_source_": "send/recv", "gather_": "gather",
    "scatter_": "scatter", "reduce_": "reduce",
}


def _tensors(x, out):
    """Append every tensor in ``x`` (nested lists and tuples) to ``out``."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensors(y, out)
    return out


def _nbytes(t) -> int:
    """The bytes a read of ``t`` moves: its elements, or its storage where
    that is smaller (an expanded view reads each element once)."""
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


def _flop_class(dtype) -> str:
    """The rate class of a matmul with operands of ``dtype``: bf16/f16 on
    the tensor cores, everything else at the f32 CUDA-core rate (the
    port's f32 products run with TF32 off)."""
    return "bf16" if dtype in (torch.bfloat16, torch.float16) else "f32"


class TraceCounter(TorchDispatchMode):
    """Counts what one rank's step runs while active (see the module
    docstring).  ``host_size``: ranks per host; ``pod_size``: ranks per
    pod (0: one pod).  Enter it around the step, after ``track_args`` of
    what lives before it; ``summary()`` gives the counts."""

    def __init__(self, *, host_size: int = h100.GPUS_PER_HOST,
                 pod_size: int = 0):
        super().__init__()
        self.host_size, self.pod_size = host_size, pod_size
        self.flops = defaultdict(float)  # rate class -> flops
        self.matmul_flops = 0.0
        self.kernels: dict = {}  # name -> {"calls", "flops", "bytes"}
        self.hbm_bytes = 0.0
        self.per_kind = defaultdict(float)
        self.by_span = defaultdict(float)  # "host" | "hosts" | "pods"
        self.n_collectives = 0
        self.n_ops = 0
        self.args_bytes = 0
        self._known: set = set()
        self._live: dict = {}
        self._cur = 0
        self.peak = 0
        self.saved = None
        self._groups: dict = {}
        self._rec = None

    # ------------------------------------------------------------ memory
    def track_args(self, *trees) -> int:
        """Count the storages of every tensor in ``trees`` (dicts, lists,
        tuples) as live before the step: their bytes go to ``args_bytes``
        and the step's writes into them are no new memory."""
        todo = list(trees)
        while todo:
            x = todo.pop()
            if isinstance(x, dict):
                todo.extend(x.values())
            elif isinstance(x, (list, tuple)):
                todo.extend(x)
            elif isinstance(x, torch.Tensor):
                st = x.untyped_storage()
                if st._cdata not in self._known:
                    self._known.add(st._cdata)
                    self.args_bytes += st.nbytes()
        return self.args_bytes

    def _free(self, key):
        self._cur -= self._live.pop(key, 0)

    def _allocated(self, t):
        if t.device.type != "meta":
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._known or key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self._cur += n
        if self._cur > self.peak:
            self.peak = self._cur
        weakref.finalize(st, self._free, key)

    # -------------------------------------------------------- dispatch
    def __enter__(self):
        self._rec = cost.recording(self._kernel)
        self._rec.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._rec.__exit__(None, None, None)

    def _kernel(self, name, work):
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                           "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += work.total_flops
        k["bytes"] += work.nbytes
        for c, f in work.flops.items():
            self.flops[c] += f
        self.hbm_bytes += work.nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.saved is None and torch._C._current_graph_task_id() != -1:
            # the first op of the first backward: what lives now is what
            # the forward kept for it
            self.saved = self._cur
        out = func(*args, **kwargs)
        self.n_ops += 1
        outs = _tensors(out, [])
        for t in outs:
            self._allocated(t)
        if func.namespace == "c10d":
            self._collective(func, args)
            return out
        if func in _FREE or torch.Tag.inplace_view in func.tags:
            return out
        rets = func._schema.returns
        if rets and all(r.alias_info is not None
                        and not r.alias_info.is_write for r in rets):
            return out  # a view
        packet = func._overloadpacket
        ins = _tensors(list(args) + list(kwargs.values()), [])
        if packet in flop_registry:
            if len({t.dtype for t in ins}) > 1:
                # the meta device skips the check a device's matmul makes
                raise RuntimeError(f"{func} on mixed dtypes "
                                f"{sorted({str(t.dtype) for t in ins})}")
            f = flop_registry[packet](*args, **kwargs, out_val=out)
            self.flops[_flop_class(ins[0].dtype)] += f
            self.matmul_flops += f
        if func in _GATHERS:
            self.hbm_bytes += (2 * sum(map(_nbytes, outs))
                               + sum(_nbytes(t) for t in ins[1:]))
        elif packet is aten.copy_:
            self.hbm_bytes += 2 * _nbytes(ins[1])
        else:  # an in-place op reads and writes its destination
            self.hbm_bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        return out

    # ------------------------------------------------------ collectives
    def _ranks(self, obj):
        key = id(obj)
        if key not in self._groups:
            from torch._C._distributed_c10d import ProcessGroup
            import torch.distributed as dist

            try:
                pg = ProcessGroup.unbox(obj)
            except RuntimeError:
                return None  # a ReduceOp, not a group
            self._groups[key] = (obj, dist.get_process_group_ranks(pg))
        return self._groups[key][1]

    def span(self, ranks) -> str:
        """"host" (every rank on one host), "hosts" (one pod) or "pods"."""
        if self.pod_size and len({r // self.pod_size for r in ranks}) > 1:
            return "pods"
        return "host" if len({r // self.host_size for r in ranks}) == 1 \
            else "hosts"

    def _collective(self, func, args):
        kind = _COLL_KINDS.get(func._overloadpacket._qualified_op_name
                               .split("::")[-1])
        if kind is None:  # barrier, monitored_barrier
            return
        ranks = None
        for a in args:
            if isinstance(a, torch.ScriptObject):
                ranks = self._ranks(a)
                if ranks is not None:
                    break
        nbytes = sum(map(_nbytes, _tensors(args[0], [])))
        self.per_kind[kind] += nbytes
        self.by_span[self.span(ranks or [0])] += nbytes
        self.n_collectives += 1
        self.hbm_bytes += sum(map(_nbytes, _tensors(list(args), [])))

    # ----------------------------------------------------------- result
    def summary(self) -> dict:
        coll = float(sum(self.per_kind.values()))
        return {
            "flops": float(sum(self.flops.values())),
            "flops_by_class": {k: float(v) for k, v in self.flops.items()
                               if v},
            "matmul_flops": float(self.matmul_flops),
            "kernels": {k: dict(v) for k, v in self.kernels.items()},
            "hbm_bytes": float(self.hbm_bytes),
            "collective_bytes": coll,
            "nvlink_bytes": float(self.by_span["host"]),
            "network_bytes": float(self.by_span["hosts"]
                                   + self.by_span["pods"]),
            "by_span": {k: float(v) for k, v in self.by_span.items() if v},
            "per_kind": {k: float(v) for k, v in self.per_kind.items()
                         if v},
            "n_collectives": self.n_collectives,
            "n_ops": self.n_ops,
            "mem_args_bytes": int(self.args_bytes),
            "mem_temp_bytes": int(self.peak),
            "mem_saved_bytes": int(self.saved or 0),
        }


def roofline(flops, bytes_per_dev: float, coll: dict) -> dict:
    """The roofline terms in seconds (per step, per device), the
    counterpart of the reference's ``roofline``.  ``flops``: {rate class:
    flops} (``core.h100.RATES``), or a number (bf16 tensor-core work);
    ``coll``: ``nvlink_bytes`` and ``network_bytes`` per device (each GPU
    has its own NIC)."""
    if not isinstance(flops, dict):
        flops = {"bf16": flops}
    compute_s = sum(f / h100.RATES[c] for c, f in flops.items())
    memory_s = bytes_per_dev / h100.HBM_BYTES_PER_S
    nvlink_s = coll.get("nvlink_bytes", 0.0) / h100.NVLINK_BYTES_PER_S
    network_s = coll.get("network_bytes", 0.0) / h100.NIC_BYTES_PER_S
    collective_s = nvlink_s + network_s
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s, "nvlink_s": nvlink_s,
             "network_s": network_s}
    terms["bottleneck"] = max(
        (("compute", compute_s), ("memory", memory_s),
         ("collective", collective_s)), key=lambda kv: kv[1])[0]
    terms["step_s"] = max(compute_s, memory_s) + collective_s
    return terms


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N_active*D (train) / 2*N_active*D (inference)."""
    n_active = cfg.param_count(active_only=True)
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch  # decode: one token/seq
