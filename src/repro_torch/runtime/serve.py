"""Policy-driven serving front-end over the batched decode loop (dense
cache or paged pool; greedy or sampled; speculative decode; preemption).

The PyTorch counterpart of ``repro/runtime/serve.py``.  ``ServeEngine``
admits requests through the copied ``Scheduler`` (fcfs / priority / sjf /
drf-fair), prefills each prompt in chunks into the slot's stripe of a
dense (L, B, S, KV, D) cache, and then runs one ragged decode step per
tick over every slot, each at its own position (free slots parked at -1).
The caches are written in place, one K/V row per slot per layer per tick.

``cache="paged"`` swaps the stripes for a shared (L, P, page_size, KV, D)
page pool managed by the copied ``KVCacheManager``: admission reserves the
pages a request can touch (backpressure when the pool is short), a
prefix-cache hit starts prefill at the matched chunk and reads the shared
pages, and a finished request's pages return at once.  The page table is
copied to the device once per decode tick and once per prefill call; the
fused paged prefill kernel reads the prefix through it (its plain version
on the CPU), so no dense per-slot view is kept.  Paged serving needs
``mode="continuous"``.

``mode="continuous"`` (default) admits into any freed slot at once;
``mode="wave"`` is the lockstep baseline: a fresh wave only when every
slot is free, prompts fed token by token, one scalar position.

SSM plans (mamba2) carry conv and SSD state that no position masks, so
they cannot take chunked prefill or the paged pool (``cache="paged"``
raises ``ValueError``): their prompts are fed token by token and a slot's
state is zeroed on admission (wave mode zeroes every cache per wave).

When ``RuntimeKnobs.decode_splits`` is 0 the continuous engine picks the
split-K fan-out per tick from ``(max(pos), live slots)``
(``steps.pick_decode_splits``), on any device: on the card split-K runs
the CUDA split-K kernel, on the CPU its plain version.

``kv_dtype="int8"|"fp8"`` (with ``cache="paged"``) stores the pools
quantized per token and KV head with f32 scale pools beside them: the
engine rebuilds the model with ``RuntimeKnobs.kv_quant`` set, and the
paged kernels read the quantized pools directly.  Shared prefix pages
share their scales, which the same page ids index.

Sampling: a request's ``SamplingParams`` land in per-slot arrays
(``samp_temp``, ``samp_topk``, ``samp_topp``, ``samp_keys``); a tick in
which some live slot samples takes the sampled step, whose greedy rows
stay the bitwise argmax, and an all-greedy tick pays no sampling math.
Each draw folds the token's absolute position into the request's key, so
a seeded request decodes the same tokens in any slot, in wave mode (which
samples from the wave logits) and under speculation or preemption.

Speculative decode (``draft_k > 0``, continuous mode, attention plans):
each tick a host-side drafter (``runtime/draft.py``) proposes up to
``draft_k`` tokens per slot, one verify step scores the feed token and
the drafts at T = draft_k + 1 positions per slot (the chunked decode
kernel at T rows, dense or paged), and the engine emits the longest
confirmed prefix plus the correction token.  The verify block's rows are
bitwise one-token ticks (``transformer._apply_attn_block_decode``), so
the streams equal the plain engine's.  Rejected drafts roll back by
position.  The kernel takes any G * (draft_k + 1) query rows per KV head
(past its largest instance in row tiles, ``decode_attention.row_tiles``),
so the engine checks only what the reference checks of ``draft_k``.

Preemption (``preempt=True``, continuous mode): the scheduler may evict a
running request when a swap strictly improves weighted-DRF fairness; the
engine checkpoints the slot (paged: the detached page chain, zero-copy;
dense: a host copy of the slot's cache stripe) and later resumes the
request in any free slot at its position without re-running prefill.

Disaggregated roles (``role="prefill"|"decode"``, continuous mode,
chunked-prefill plans): a prefill engine completes each prompt inside
admission, emits the first token and never decodes; a decode engine
accepts only handed-off (checkpointed) requests.  ``release()`` checkpoints
a running request out of its slot for the handoff (paged: the detached
page chain, zero-copy; dense: a host copy of the stripe), and
``offer()``/``free_slots()``/``can_accept()``/``live_requests()`` are what
the routers of ``runtime/cluster.py`` and ``runtime/disagg.py`` read.

Sharded serving (``mesh=`` a ``DeviceMesh`` from
``launch.mesh.make_serve_mesh``, or ``mesh_shape``; continuous mode): one
engine over the ranks of a ``(data, model)`` or ``(pod, data, model)``
mesh, each rank a process holding plain local tensors, in the gather form
of ``sharding/rules.py``.  A rank holds its parameter shard (its query
and KV heads, its MLP columns and experts) and the cache of its data
row's slot block with its KV heads: a dense stripe per local slot, or its
host's page sub-pool (``KVCacheManager(num_hosts=...)``; global page ids
are translated to local ones behind a local null page, which takes the
padded and parked writes).  The host loop is SPMD:
every rank runs the same scheduler, drafter and sampler bookkeeping on the
same requests, a device step runs each data row's slots on its ranks
(the attention kernels on the local heads, the seams gathering over
"model"), and one exchange over the data axes then carries the per-slot
tokens to every rank, so every rank's host state stays identical.  A
prefill chunk runs on the data row that owns its slot, and its token is
broadcast.  The split-K fan-out is picked from the global ``(max pos,
live)``.  The streams are bitwise the unsharded engine's where the
products keep their bits under a cut of their rows or columns (see
``PERF.md``).  A checkpoint resumed, or a chain handed off, into a slot
of another data row moves there: a dense snapshot is broadcast from the
row that took it, and a page chain is copied into fresh pages of the
slot's sub-pool and its old pages released (``_carry_pages``).
"""
from __future__ import annotations

import enum
import time
import warnings
from collections import deque
from dataclasses import dataclass, field
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.launch.mesh import data_group, make_serve_mesh
from repro_torch.models.transformer import tree_leaves
from repro_torch.optim.adamw import tree_map
from repro_torch.runtime.draft import get_drafter
from repro_torch.runtime.fault import StepWatchdog
from repro_torch.runtime.kv_pool import KVCacheManager
from repro_torch.runtime.sampling import (SamplingParams, matches_stop,
                                          sample_tokens, speculative_accept)
from repro_torch.runtime.scheduler import Scheduler
from repro_torch.runtime.steps import (compiled_step, pick_decode_splits,
                                       step_cache_stats)
from repro_torch.runtime.telemetry import Telemetry
from repro_torch.sharding import (ServeShardFn, all_gather_cat, block_index,
                                  broadcast_from, local_caches, local_cfg,
                                  mesh_coord, mesh_sizes, model_cuts,
                                  serve_batch_sharding, shard_params)

__all__ = ["Checkpoint", "Request", "RequestHandle", "RequestState",
           "SamplingParams", "ServeConfig", "ServeEngine", "ServeStalled",
           "request_metrics"]


def request_metrics(req: "Request") -> dict:
    """Per-request latency from the lifecycle stamps: time-to-first-token
    (``ttft_s``, includes queue wait) and time-per-output-token
    (``tpot_s``).  Entries whose stamps are not reached yet are omitted."""
    out = {}
    if req.t_submit is not None and req.t_first is not None:
        out["ttft_s"] = req.t_first - req.t_submit
    if req.t_first is not None and req.t_finish is not None \
            and len(req.output) > 1:
        out["tpot_s"] = (req.t_finish - req.t_first) / (len(req.output) - 1)
    return out


def _ckpt_fns(model, max_len: int):
    """(copy_out, copy_in) of a dense checkpoint: one slot's stripe of
    every cache leaf to a host copy, and back in place."""
    axes = model.cache_batch_axes(max_len)

    def copy_out(caches, slot):
        return model.copy_cache_out(caches, slot, axes, device="cpu")

    def copy_in(caches, snap, slot):
        return model.copy_cache_in(caches, snap, slot, axes)

    return copy_out, copy_in


def _tree_to(tree, device):
    """Every tensor of a nested dict on ``device``."""
    return tree_map(lambda t: t.to(device), tree)


class ServeStalled(RuntimeError):
    """``run()`` exhausted its tick budget with requests undrained, or a
    streaming handle stopped making progress."""


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    PREEMPTED = "preempted"
    FINISHED = "finished"


@dataclass
class Checkpoint:
    """A preempted request's resume point.  ``pages`` (paged cache) is
    the detached page chain -- the K/V never left the card; ``kv`` (dense)
    is the host copy of the slot's cache stripe."""

    pos: int  # decode position to resume at
    last_token: int  # the token to feed at ``pos``
    pages: Optional[list] = None
    kv: object = None
    row: int = 0  # sharded: the data row whose ranks hold ``kv``


@dataclass
class Request:
    req_id: int
    prompt: np.ndarray  # (prompt_len,) int32
    max_new_tokens: int = 16
    eos_id: int = -1  # -1: never stops early
    sampling: SamplingParams = field(default_factory=SamplingParams)
    tenant: str = "default"  # drf-fair accounting unit
    priority: int = 0  # higher admits first under policy="priority"
    output: list = field(default_factory=list)
    done: bool = False
    state: RequestState = RequestState.QUEUED
    finish_reason: Optional[str] = None  # "eos" | "stop" | "length"
    preempt_count: int = 0
    # wall-clock lifecycle stamps (time.perf_counter seconds)
    t_submit: Optional[float] = None
    t_first: Optional[float] = None
    t_finish: Optional[float] = None


class RequestHandle:
    """Caller-facing view of a submitted request.  ``tokens()`` streams
    output tokens, driving ``engine.step()`` while it waits; ``result()``
    drains and returns the finished ``Request``."""

    def __init__(self, req: Request, engine: "ServeEngine"):
        self.req = req
        self._engine = engine

    @property
    def state(self) -> RequestState:
        return self.req.state

    @property
    def finish_reason(self) -> Optional[str]:
        return self.req.finish_reason

    @property
    def done(self) -> bool:
        return self.req.done

    @property
    def output(self) -> list:
        return list(self.req.output)

    def tokens(self, max_ticks: int = 100_000) -> Iterator[int]:
        i = stalled = 0
        while True:
            while i < len(self.req.output):
                stalled = 0
                yield self.req.output[i]
                i += 1
            if self.req.done:
                return
            self._engine.step()
            stalled += 1
            if stalled > max_ticks:
                raise ServeStalled(
                    f"request {self.req.req_id} produced no token in "
                    f"{max_ticks} ticks (state={self.req.state.value})")

    def result(self, max_ticks: int = 100_000) -> Request:
        for _ in self.tokens(max_ticks=max_ticks):
            pass
        return self.req

    def metrics(self) -> dict:
        return request_metrics(self.req)


@dataclass(frozen=True)
class ServeConfig:
    """Engine construction knobs (every field of the reference's
    ``ServeConfig``).  ``policy`` names a ``runtime.scheduler``
    admission policy; ``on_stall`` decides whether ``run()`` raises
    (``"raise"``) or warns (``"warn"``) when its tick budget runs out."""

    batch_slots: int = 4
    max_len: int = 128
    mode: str = "continuous"
    prefill_chunk: int = 32
    cache: str = "dense"
    page_size: int = 16
    num_pages: Optional[int] = None
    page_policy: str = "pack"
    prefix_cache: bool = True
    kv_dtype: str = ""
    policy: str = "fcfs"
    on_stall: str = "raise"
    tenant_weights: Optional[dict] = None
    preempt: bool = False
    victim_policy: str = "youngest-first"
    draft_k: int = 0
    drafter: str = "ngram"
    role: str = "unified"
    mesh_shape: Optional[tuple] = None


def _check_mesh(config: ServeConfig) -> None:
    """The reference's check of a mesh."""
    if config.mode != "continuous":
        raise ValueError("sharded serving (mesh / mesh_shape) "
                         "requires mode='continuous'")


def _check_role(config: ServeConfig, model) -> None:
    """The reference's checks of ``role``."""
    if config.role not in ("unified", "prefill", "decode"):
        raise ValueError(f"unknown role {config.role!r} "
                         f"(expected unified/prefill/decode)")
    if config.role != "unified":
        if config.mode != "continuous":
            raise ValueError("disaggregated roles require "
                             "mode='continuous'")
        if not model.supports_chunked_prefill():
            raise ValueError(
                f"disaggregated roles need chunked prefill, unsupported "
                f"for family={model.cfg.family!r} (token-feed prefill "
                f"cannot hand off mid-prompt)")


def _check_speculative(config: ServeConfig, model) -> None:
    """The reference's checks of ``draft_k``."""
    if config.draft_k < 0:
        raise ValueError(f"draft_k must be >= 0: {config.draft_k}")
    if not config.draft_k:
        return
    if config.mode != "continuous":
        raise ValueError("speculative decode (draft_k > 0) requires "
                         "mode='continuous'")
    if not model.supports_speculative():
        raise ValueError(
            f"speculative decode unsupported for "
            f"family={model.cfg.family!r} (SSM state advances one "
            f"token at a time)")
    if config.draft_k + 1 >= config.max_len:
        raise ValueError(f"draft_k {config.draft_k} too deep for "
                         f"max_len {config.max_len}")


class MeshWatchdog(StepWatchdog):
    """The straggler watchdog of a router that every rank of the world
    runs in step (each rank holds every replica's shard and decides every
    placement itself).  ``StepWatchdog`` reads each rank's own clock, so
    the ranks could flag different steps and route apart; this one
    records rank 0's step duration on every rank (a broadcast of a
    float64 on ``device``), so every rank flags the same steps.  Each
    replica step makes one broadcast, in the same order on every rank."""

    def __init__(self, device, **kw):
        super().__init__(**kw)
        self.device = device

    def __call__(self, step: int, metrics):
        now = time.monotonic()
        dt = torch.tensor([now - self._last], dtype=torch.float64,
                          device=self.device)
        torch.distributed.broadcast(dt, src=0)
        self._last = now
        dt = float(dt[0])
        self.times.append(dt)
        hist = self.times[-self.window:-1]
        if len(hist) >= 5:
            med = sorted(hist)[len(hist) // 2]
            if dt > self.threshold * med:
                self.flagged.append((step, dt, med))


def mesh_watchdogs(router, device) -> None:
    """Give each of ``router``'s replica handles a ``MeshWatchdog``, and
    a fresh one at each rejoin (``ReplicaHandle.rejoin`` makes a plain
    ``StepWatchdog``)."""
    for rh in router.replicas:
        rh.watchdog = MeshWatchdog(device)

        def rejoin(tick, rh=rh, plain=rh.rejoin):
            plain(tick)
            rh.watchdog = MeshWatchdog(device)

        rh.rejoin = rejoin


class _RowScheduler(Scheduler):
    """The scheduler of a paged engine whose pool is cut over data rows: a
    resumed (or handed-off) request is admitted into a slot only where the
    slot's row can hold its chain.  A chain from another row's sub-pool
    needs fresh pages on the slot's row, which
    ``ServeEngine._localize_chain`` copies it into: they are taken here,
    at the decision, after evicting the row's prefix pages if need be, so
    that a later admission of the same round cannot take them.  Without
    room the request stays queued, as a fresh request whose pages do not
    fit (the round moves on to the next free slot, which may lie on
    another row).  ``row_deferrals`` counts the admissions so deferred."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.row_deferrals = 0

    def _admit_into(self, s: int, plan, view: list, req=None) -> bool:
        if req is None:
            req = self.queue[self.policy.select(self.queue)]
        if getattr(req, "_preempted", False) and not self._row_pages(s, req):
            self._m_backpressure.inc()
            self.row_deferrals += 1
            return False
        return super()._admit_into(s, plan, view, req=req)

    def _row_pages(self, s: int, req) -> bool:
        """Whether slot ``s``'s row holds ``req``'s chain, or takes fresh
        pages there for it (``req._row_pages``)."""
        kv = self.kv
        pages = req._ckpt_pages
        host = kv.slot_host(s)
        if all(kv.pool.host_of(p) == host for p in pages):
            return True
        short = len(pages) - kv.pool.free_in_host(host)
        if short > 0:
            if (kv.prefix is None
                    or kv.prefix.evictable(host=host) < short):
                return False
            kv.prefix.evict(short, host=host)
        req._row_pages = kv.pool.alloc(len(pages), host=host)
        return True


class ServeEngine:
    def __init__(self, model, params, config: Optional[ServeConfig] = None,
                 *, mesh=None, telemetry=None, replica: int = 0):
        config = config if config is not None else ServeConfig()
        if config.mode not in ("continuous", "wave"):
            raise ValueError(f"unknown mode {config.mode!r}")
        if config.cache not in ("dense", "paged"):
            raise ValueError(f"unknown cache {config.cache!r}")
        if config.on_stall not in ("raise", "warn"):
            raise ValueError(f"unknown on_stall {config.on_stall!r}")
        _check_role(config, model)
        if config.preempt and config.mode != "continuous":
            raise ValueError("preempt=True requires mode='continuous' "
                             "(wave slots drain in lockstep)")
        _check_speculative(config, model)
        if config.kv_dtype:
            if config.cache != "paged":
                raise ValueError("kv_dtype requires cache='paged' (dense "
                                 "caches store at RuntimeKnobs.cache_dtype)")
            if config.kv_dtype not in ("int8", "fp8"):
                raise ValueError(f"unknown kv_dtype {config.kv_dtype!r} "
                                 f"(expected int8/fp8)")
            # quantization is a property of the model's pools: rebuild the
            # model with the knob, so that pool init, the cache writes and
            # attention agree (the knob keys the step cache too)
            if model.knobs.kv_quant != config.kv_dtype:
                model = type(model)(
                    model.cfg, model.knobs.with_(kv_quant=config.kv_dtype),
                    model.device)
        # ---- device mesh: shard this replica without changing its output
        self._num_hosts, self._host = 1, 0
        self._lo, self._hi = 0, config.batch_slots
        self._cache_mesh = None  # the axis sizes that cut the caches
        if mesh is None and config.mesh_shape is not None:
            mesh = make_serve_mesh(config.mesh_shape)
        self.mesh = mesh
        if mesh is not None:
            model, params = self._shard(model, params, mesh, config)
        self.config = config
        self.model = model
        self.params = params
        self.slots = config.batch_slots
        self.max_len = config.max_len
        self.mode = config.mode
        self.role = config.role
        batch_slots, max_len = config.batch_slots, config.max_len
        self.active: list[Optional[Request]] = [None] * batch_slots
        self.pos = np.full(batch_slots, -1, dtype=np.int32)
        self.tokens = np.zeros((batch_slots, 1), dtype=np.int32)
        # per-slot sampling arrays: one step serves any mix of greedy
        # (temp 0) and sampled requests
        self.samp_temp = np.zeros(batch_slots, np.float32)
        self.samp_topk = np.zeros(batch_slots, np.int32)
        self.samp_topp = np.ones(batch_slots, np.float32)
        self.samp_keys = np.zeros((batch_slots, 2), np.uint32)
        self._finished: list[Request] = []
        # checkpoints (dense snapshots, page chains) moved across data rows
        self.moved_across_rows = 0
        self._admit_emitted = 0  # tokens emitted by chunked prefill
        self._decode_one = compiled_step(model, "decode_one")
        # checkpoint/restore (dense): built on first preemption
        self._copy_out = self._copy_in = None
        self.kv: Optional[KVCacheManager] = None
        if config.cache == "paged":
            self._init_paged(config)
        else:
            self.caches = self._new_caches(False, batch_slots, max_len)
            self._step = compiled_step(model, "serve")
            self._step_sampled = compiled_step(model, "serve", sampled=True)
            # chunked prefill: one (1, C) step reused for every slot and
            # offset; C rounded down to a divisor of max_len so padded
            # chunk writes never clamp
            self.chunked = (config.mode == "continuous"
                            and config.prefill_chunk > 1
                            and model.supports_chunked_prefill())
            c = max(1, min(config.prefill_chunk, max_len))
            while max_len % c:
                c -= 1
            self.prefill_chunk = c
            if self.chunked:
                self._prefill = compiled_step(model, "prefill_chunk")
                self._prefill_sampled = compiled_step(
                    model, "prefill_chunk", sampled=True)
        # speculative decode: one verify step of width T = k + 1 per
        # (cache layout, sampled) variant; the drafter is pure host
        self.draft_k = config.draft_k
        if self.draft_k:
            self.drafter = get_drafter(config.drafter)
            spec_kind = ("paged_spec_serve" if config.cache == "paged"
                         else "spec_serve")
            spec_ps = config.page_size if config.cache == "paged" else 0
            self._spec_step = compiled_step(
                model, spec_kind, page_size=spec_ps, draft_len=self.draft_k)
            self._spec_step_sampled = compiled_step(
                model, spec_kind, page_size=spec_ps, draft_len=self.draft_k,
                sampled=True)
            # acceptance telemetry: proposed/accepted draft tokens and
            # the tokens each verify tick emitted
            self.spec_proposed = 0
            self.spec_accepted = 0
            self.spec_emitted = 0
            self.spec_ticks = 0
        sched = (_RowScheduler if self.kv is not None and self._num_hosts > 1
                 else Scheduler)
        self.scheduler = sched(config.policy, slots=batch_slots,
                               max_len=max_len, kv=self.kv,
                               weights=config.tenant_weights,
                               preempt=config.preempt,
                               victim=config.victim_policy)
        # split-K autotune: pick the fan-out per tick from (max(pos), live
        # slots) whatever the device
        self._autotune = (config.mode == "continuous"
                          and model.knobs.decode_splits == 0)
        # SSM state is not position-masked (the plans that cannot chunk
        # their prefill): zero a slot on admission
        self._needs_reset = not model.supports_chunked_prefill()
        if self._needs_reset:
            self._reset = self._make_slot_reset(model, max_len)
        self.bind_telemetry(telemetry, replica=replica)

    def _init_paged(self, config: ServeConfig) -> None:
        """The paged pool: chunk size, page manager, device pools, steps."""
        if config.mode != "continuous":
            raise ValueError("cache='paged' requires mode='continuous'")
        if not self.model.supports_paged_cache():
            raise ValueError(f"paged KV cache unsupported for "
                             f"family={self.model.cfg.family!r}")
        page_size, max_len = config.page_size, config.max_len
        if page_size < 1 or max_len % page_size:
            raise ValueError(f"max_len {max_len} not a multiple of "
                             f"page_size {page_size}")
        # prefill chunks cover whole pages at page-aligned offsets; C also
        # divides max_len so every chunk fits the page table
        c = max(page_size,
                (min(config.prefill_chunk, max_len) // page_size)
                * page_size)
        while max_len % c:
            c -= page_size
        self.prefill_chunk = c
        self.chunked = True
        # dense-equivalent capacity by default (+ the null page)
        num_pages = config.num_pages
        if num_pages is None:
            num_pages = config.batch_slots * (max_len // page_size) + 1
        hosts = self._num_hosts
        if hosts > 1:
            # host sub-pools tile the pool evenly: round capacity UP, so
            # that a caller-sized pool never shrinks
            num_pages = -(-num_pages // hosts) * hosts
        self.kv = KVCacheManager(
            slots=config.batch_slots, max_len=max_len, page_size=page_size,
            num_pages=num_pages, policy=config.page_policy,
            prefix_cache=config.prefix_cache, chunk=c, num_hosts=hosts)
        # a rank holds its host's sub-pool behind a null page of its own
        # (``_page_table``), which takes the writes the null page takes
        # unsharded
        self._host_pages = self.kv.pool.num_pages // hosts
        self.caches = self._new_caches(True, self.kv.pool.num_pages,
                                       page_size)
        self._step = compiled_step(self.model, "paged_serve",
                                   page_size=page_size)
        self._step_sampled = compiled_step(self.model, "paged_serve",
                                           page_size=page_size, sampled=True)
        self._prefill = compiled_step(self.model, "paged_prefill_chunk",
                                      page_size=page_size)
        self._prefill_sampled = compiled_step(
            self.model, "paged_prefill_chunk", page_size=page_size,
            sampled=True)

    @staticmethod
    def _make_slot_reset(model, max_len):
        """Zero one slot of every cache leaf along its batch axis (from
        ``model.cache_batch_axes``: layouts vary across plans), in
        place."""
        axes = model.cache_batch_axes(max_len)

        def reset(caches, slot):
            def zero(c, ax):
                if isinstance(c, dict):
                    for k in c:
                        zero(c[k], ax[k])
                else:
                    c.narrow(ax, slot, 1).zero_()
            zero(caches, axes)
            return caches

        return reset

    def _shard(self, model, params, mesh, config):
        """This rank's local model (its head counts and the seams' hook)
        and parameter shard, its data row and slot block; the groups of
        the host loop's exchange."""
        _check_mesh(config)
        sizes, coord = mesh_sizes(mesh), mesh_coord(mesh)
        dp = serve_batch_sharding(mesh, config.batch_slots)
        if dp is not None:
            self._host, self._num_hosts = block_index(sizes, coord, dp[0])
            per = config.batch_slots // self._num_hosts
            self._lo, self._hi = self._host * per, (self._host + 1) * per
            self._cache_mesh = sizes
        else:  # every data row holds every slot and the whole pool
            self._cache_mesh = {a: 1 if a in ("pod", "data") else n
                                for a, n in sizes.items()}
        cfg = model.cfg
        cuts = model_cuts(mesh, params)
        self._full_model = type(model)(cfg, model.knobs, "meta")
        local = type(model)(
            local_cfg(cfg, sizes, coord["model"], cuts),
            model.knobs.with_(shard_fn=ServeShardFn(mesh, cuts)),
            model.device)
        params = shard_params(params, mesh, cfg)
        params = _tree_to(params, model.device)
        if self._num_hosts > 1:
            self._dp_group = data_group(mesh)
            # the rank of each data row that shares this rank's model
            # index: the source of that row's prefill tokens
            grid = mesh.mesh.reshape(self._num_hosts, sizes["model"])
            self._row_src = grid[:, coord["model"]].tolist()
        return local, params

    def _new_caches(self, paged: bool, n: int, size: int):
        """Zeroed caches of ``n`` slots of ``size`` positions (dense) or
        ``n`` pages of ``size`` tokens (paged).  Sharded: this rank's share
        of them, sized by the rules (``local_caches``), behind a null page
        of its own when the pool is cut over data rows."""
        if self.mesh is None:
            return (self.model.init_cache_paged(n, size) if paged
                    else self.model.init_cache(n, size))
        full = self._full_model
        full = full.init_cache_paged(n, size) if paged else full.init_cache(
            n, size)
        return local_caches(self._cache_mesh, full, paged=paged,
                            kv_heads=self.model.cfg.num_kv_heads,
                            sink=self._num_hosts > 1,
                            device=self.model.device)

    def _local(self, a):
        """The rows of a per-slot host array that this rank computes."""
        return a if self._num_hosts == 1 else a[self._lo:self._hi]

    def _rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every slot's rows of a per-slot result, from the data rows that
        computed them (the host loop's exchange)."""
        if self._num_hosts == 1:
            return t
        return all_gather_cat(t, self._dp_group, dim=0)

    def _owns(self, s: int) -> bool:
        return self._lo <= s < self._hi

    def _row(self, s: int) -> int:
        """The data row that computes slot ``s``."""
        return s // (self._hi - self._lo) if self._num_hosts > 1 else 0

    def _snapshot(self, s: int):
        """A dense checkpoint of slot ``s``: a host copy of its stripe on
        the ranks of its data row (None on the other rows)."""
        if not self._owns(s):
            return None
        self._ensure_ckpt_fns()
        return self._copy_out(self.caches, s - self._lo)

    def _restore(self, s: int, ck: "Checkpoint") -> None:
        """Write a dense checkpoint back into slot ``s``.  Taken on
        another data row, it is first broadcast from that row's rank of
        this rank's model index (every rank of the data group joins)."""
        self._ensure_ckpt_fns()
        snap = ck.kv
        if self._num_hosts > 1 and ck.row != self._row(s):
            if snap is None:  # the shapes of a stripe of this rank's
                snap = self._copy_out(self.caches, 0)
            snap = tree_map(lambda t: broadcast_from(
                t.to(self.model.device), self._row_src[ck.row],
                self._dp_group), snap)
            self.moved_across_rows += 1
        if self._owns(s):
            self.caches = self._copy_in(self.caches, snap, s - self._lo)

    def _to_local(self, pages):
        """Global ids of pages of one host sub-pool as a rank's pool
        indices: page ``h * n + i`` of host ``h`` at ``1 + i``, behind the
        rank's null page at 0.  Unsharded pools keep their ids."""
        pages = np.asarray(pages, np.int64)
        return pages % self._host_pages + 1 if self._num_hosts > 1 else pages

    def _local_pages(self, pages) -> torch.Tensor:
        """``_to_local`` of ``pages`` as int64 on the device."""
        return torch.as_tensor(self._to_local(pages),
                               device=self.model.device)

    def carry_pages(self, src_engine, src_pages, dst_pages) -> None:
        """Copy the K/V of ``src_engine``'s pages ``src_pages`` into this
        engine's ``dst_pages`` (global ids; ``src_engine`` may be this
        engine), every layer and scale leaf.  Sharded over data rows, each
        chain lies in one host sub-pool: a copy within one row stays on
        that row's ranks; across rows, the source row's rank of each model
        index broadcasts the pages over the data group and the destination
        row's ranks write them.  Both engines cut their pools over the
        same data rows of one mesh, or neither does."""
        if src_engine._num_hosts != self._num_hosts:
            raise ValueError(f"page copy between pools cut over "
                             f"{src_engine._num_hosts} and {self._num_hosts} "
                             f"data rows")
        a = 0 if self._num_hosts == 1 else src_engine.kv.pool.host_of(
            src_pages[0])
        b = 0 if self._num_hosts == 1 else self.kv.pool.host_of(dst_pages[0])
        if a == b:
            if self._host == a:
                self.caches = self.model.copy_cache_pages_across(
                    src_engine.caches, self.caches,
                    src_engine._local_pages(src_pages),
                    self._local_pages(dst_pages))
            return
        src_idx = src_engine._local_pages(src_pages)
        dst_idx = self._local_pages(dst_pages)
        for s_leaf, d_leaf in zip(tree_leaves(src_engine.caches),
                                  tree_leaves(self.caches)):
            ax = s_leaf.ndim - 4
            if self._host == a:
                buf = s_leaf.index_select(ax, src_idx)
            else:
                shape = list(s_leaf.shape)
                shape[ax] = len(src_pages)
                buf = torch.empty(shape, dtype=s_leaf.dtype,
                                  device=s_leaf.device)
            buf = broadcast_from(buf, self._row_src[a], self._dp_group)
            if self._host == b:
                d_leaf.index_copy_(ax, dst_idx, buf)

    def _localize_chain(self, s: int) -> None:
        """A chain attached to slot ``s`` from another data row's sub-pool
        (a resumed or handed-off request placed on this row) moves into
        the fresh pages of the slot's sub-pool that the scheduler took for
        it (``_RowScheduler``); the old pages are released.  The port
        computes a slot only against its own row's pages."""
        kv = self.kv
        pages = kv.detach_slot(s)
        host = kv.slot_host(s)
        if all(kv.pool.host_of(p) == host for p in pages):
            kv.attach_slot(s, pages)
            return
        req = self.active[s]
        fresh, req._row_pages = getattr(req, "_row_pages", None), None
        if fresh is None or len(fresh) != len(pages):
            kv.attach_slot(s, pages)
            raise RuntimeError(
                f"a chain of {len(pages)} pages resumed into slot {s} of "
                f"data row {host} without pages taken there")
        self.carry_pages(self, pages, fresh)
        kv.attach_slot(s, fresh)
        kv.release_chain(pages)
        self.moved_across_rows += 1

    def kv_reserved_bytes(self) -> int:
        """Device bytes held by the KV cache (dense stripes, or the page
        pools and their scale pools)."""
        return sum(t.numel() * t.element_size()
                   for t in tree_leaves(self.caches))

    def _page_table(self) -> torch.Tensor:
        """The page table on the model's device (one host-to-device copy;
        every layer of the step reads it).  Sharded over data rows: this
        rank's slot rows in local ids, page ``h * n + i`` of host ``h``'s
        sub-pool at ``1 + i`` and the null page at 0, where the model's
        padded and parked writes go."""
        pt = self.kv.page_table
        if self._num_hosts > 1:
            pt = pt[self._lo:self._hi]
            if ((pt != 0) & (pt // self._host_pages != self._host)).any():
                raise RuntimeError(
                    f"a page chain of data row {self._host} holds a page "
                    f"of another row's sub-pool")
            pt = np.where(pt == 0, 0, self._to_local(pt)).astype(np.int32)
        return torch.as_tensor(pt, device=self.model.device)

    def bind_telemetry(self, telemetry: Optional[Telemetry] = None, *,
                       replica: int = 0) -> None:
        """Bind the engine and its scheduler to a ``Telemetry`` sink (a
        private one by default: metrics on, tracing off)."""
        self.tm = telemetry if telemetry is not None else Telemetry()
        self.replica = int(replica)
        reg = self.tm.registry
        lbl = {"replica": str(self.replica)}
        self._m_ticks = reg.counter(
            "engine_ticks_total", "engine ticks stepped",
            ("replica",)).labels(**lbl)
        self._m_tokens = reg.counter(
            "engine_tokens_total", "output tokens emitted",
            ("replica",)).labels(**lbl)
        self._m_submitted = reg.counter(
            "engine_requests_submitted_total", "requests submitted",
            ("replica",)).labels(**lbl)
        self._m_finished = reg.counter(
            "engine_requests_finished_total",
            "requests finished, by finish reason", ("replica", "reason"))
        reg.gauge("engine_live_slots", "slots holding an active request",
                  ("replica",)).labels(**lbl).set_function(
            lambda: sum(r is not None for r in self.active))
        reg.gauge("engine_queue_depth", "requests awaiting admission",
                  ("replica",)).labels(**lbl).set_function(
            lambda: len(self.scheduler.queue))
        if self.draft_k:
            # function-backed: the spec tick bumps plain attributes; the
            # registry reads them at export time
            for name, attr in (("engine_spec_proposed", "spec_proposed"),
                               ("engine_spec_accepted", "spec_accepted"),
                               ("engine_spec_emitted", "spec_emitted"),
                               ("engine_spec_ticks", "spec_ticks")):
                reg.gauge(name, f"speculative decode: {attr}",
                          ("replica",)).labels(**lbl).set_function(
                    lambda a=attr: getattr(self, a))
        self.scheduler.bind_metrics(reg, self.replica)
        if self.kv is not None:
            self.kv.bind_metrics(reg, self.replica)
        if self.tm.trace.enabled:
            self.tm.trace.set_process_name(self.replica,
                                           f"replica {self.replica}")

    def _set_state(self, req: Request, state: RequestState, **args) -> None:
        req.state = state
        self.tm.req_transition(self.replica, req.req_id, state.name, **args)

    def _tick_telemetry(self, emitted: int) -> None:
        self._m_ticks.inc()
        if emitted:
            self._m_tokens.inc(emitted)
        tr = self.tm.trace
        if not tr.enabled:
            return
        vals = {"live_slots": sum(r is not None for r in self.active),
                "queue_depth": len(self.scheduler.queue)}
        if self.draft_k:
            vals["spec_proposed"] = self.spec_proposed
            vals["spec_accepted"] = self.spec_accepted
        vals["step_cache_hits"] = step_cache_stats()["hits"]
        tr.counter(self.replica, "engine", vals)

    @property
    def queue(self) -> deque:
        """The scheduler's admission queue (read-mostly; use submit())."""
        return self.scheduler.queue

    def submit(self, req: Request) -> RequestHandle:
        if self.role == "decode" and not getattr(req, "_preempted", False):
            raise ValueError(
                "decode-role engines only accept handed-off (checkpointed) "
                "requests; route fresh requests to a prefill replica")
        if not 0 < len(req.prompt) < self.max_len:
            raise ValueError(
                f"prompt length {len(req.prompt)} outside [1, "
                f"{self.max_len - 1}] for max_len={self.max_len}")
        if self.kv is not None and not self.kv.fits_ever(
                len(req.prompt), req.max_new_tokens):
            raise ValueError(
                f"request needs more pages than the pool can ever supply "
                f"(prompt {len(req.prompt)} + max_new {req.max_new_tokens} "
                f"vs {self.kv.pool.capacity} pages of "
                f"{self.kv.page_size})")
        self._set_state(req, RequestState.QUEUED, tenant=req.tenant)
        req.t_submit = time.perf_counter()
        self._m_submitted.inc()
        self.scheduler.submit(req)
        return RequestHandle(req, self)

    # ------------------------------------------------------------ admission
    def _emit(self, req: Request, tok: int):
        if not req.output:
            req.t_first = time.perf_counter()
        req.output.append(tok)

    def _clear_slot(self, s: int):
        """Park slot ``s``: no occupant, pos -1, sampling state neutral
        (finish and preemption both come through here)."""
        self.active[s] = None
        self.pos[s] = -1
        self.tokens[s, 0] = 0
        self.samp_temp[s] = 0.0
        self.samp_topk[s] = 0
        self.samp_topp[s] = 1.0
        self.samp_keys[s] = 0

    def _set_sampling(self, s: int, req: Request):
        sp = req.sampling
        self.samp_temp[s] = sp.temperature
        self.samp_topk[s] = sp.top_k
        self.samp_topp[s] = sp.top_p
        self.samp_keys[s] = sp.key_data(req.req_id)

    def _finish(self, s: int, reason: str):
        req = self.active[s]
        req.done = True
        req.state = RequestState.FINISHED
        req.finish_reason = reason
        req.t_finish = time.perf_counter()
        self.tm.req_end(self.replica, req.req_id, reason=reason,
                        tokens=len(req.output))
        self._m_finished.labels(replica=str(self.replica),
                                reason=reason).inc()
        self._clear_slot(s)
        if self.kv is not None:
            self.kv.free_slot(s)  # pages return to the pool at once
        self.scheduler.on_finish(req)
        self._finished.append(req)

    # ----------------------------------------------------------- preempt
    def _ensure_ckpt_fns(self):
        """The dense checkpoint's copy pair, built on first preemption."""
        if self._copy_out is None:
            self._copy_out, self._copy_in = _ckpt_fns(self.model,
                                                      self.max_len)

    def _execute_preemption(self, pre):
        """Executor half of preemption: capture the slot's device state
        into the request's checkpoint and park the slot.  The scheduler
        already did the host half (page detach, DRF credit, requeue);
        this runs before any admission reuses the slot."""
        s, req = pre.slot, pre.req
        # paged: zero-copy, the detached page chain IS the KV
        kv_snap = None if self.kv is not None else self._snapshot(s)
        req._ckpt = Checkpoint(pos=int(self.pos[s]),
                               last_token=int(self.tokens[s, 0]),
                               pages=getattr(req, "_ckpt_pages", None),
                               kv=kv_snap, row=self._row(s))
        self._set_state(req, RequestState.PREEMPTED, pos=req._ckpt.pos,
                        count=req.preempt_count + 1)
        req.preempt_count += 1
        self._clear_slot(s)

    def _execute_resume(self, s: int, req: Request):
        """Restore a checkpointed request into slot ``s`` at ``pos =
        checkpoint``, no prefill re-run.  Paged: the scheduler remapped
        the page-table row (attach_slot).  Dense: the host copy of the
        stripe is written back whole, so the previous occupant leaves
        nothing behind."""
        ck = req._ckpt
        if self.kv is None:
            self._restore(s, ck)
        elif self._num_hosts > 1:
            self._localize_chain(s)
        self.pos[s] = ck.pos
        self.tokens[s, 0] = ck.last_token
        req._feed = deque()  # type: ignore
        req._ckpt = None
        req._ckpt_pages = None
        req._preempted = False
        req._handoff_kv = 0  # adopted chain now charged via _drf_charged
        self._set_state(req, RequestState.DECODE, resume=True,
                        pos=int(self.pos[s]))

    def release(self, req: Request) -> Checkpoint:
        """Checkpoint a running request out of its slot so that its K/V can
        move to another engine (the disaggregated handoff, and a retiring
        replica's drain).  The capture is preemption's (paged: the slot's
        page chain detached, zero-copy; dense: a host copy of the stripe),
        but the request leaves this engine: its trace span here ends
        (reason "handoff"), the scheduler is credited the full DRF charge
        (slot and chain), and the caller submits the request to the
        destination engine, which resumes it at ``pos = checkpoint``
        without re-running prefill."""
        s = next(i for i, r in enumerate(self.active) if r is req)
        if self.kv is not None:
            req._ckpt_pages = self.kv.detach_slot(s)
            kv_snap = None
        else:
            kv_snap = self._snapshot(s)
        req._ckpt = Checkpoint(pos=int(self.pos[s]),
                               last_token=int(self.tokens[s, 0]),
                               pages=getattr(req, "_ckpt_pages", None),
                               kv=kv_snap, row=self._row(s))
        req.state = RequestState.PREEMPTED
        self.tm.req_end(self.replica, req.req_id, reason="handoff",
                        pos=req._ckpt.pos)
        req.preempt_count += 1
        req._preempted = True
        self._clear_slot(s)
        self.scheduler.on_finish(req)  # full DRF credit: the chain leaves
        return req._ckpt

    def _execute_admission(self, adm):
        """Apply one scheduler decision: checkpoint restore, chunked
        prefill, or token-feed setup when chunking is off."""
        s, req = adm.slot, adm.req
        self.active[s] = req
        self._set_sampling(s, req)
        if adm.resume:
            self._execute_resume(s, req)
            return
        self._set_state(req, RequestState.PREFILL, slot=s)
        if self._needs_reset and self._owns(s):
            self.caches = self._reset(self.caches, s - self._lo)
        if self.chunked:
            # paged: prefill starts where the prefix cache left off; CoW
            # pages (adm.kv.cow) need no device copy, since they span
            # [start, matched) and the first re-run chunk rewrites each of
            # them whole before anything reads them
            self._prefill_slot(s, req,
                               start=0 if adm.kv is None else adm.kv.start)
            if not self._maybe_stop(s):
                self._set_state(req, RequestState.DECODE)
        else:
            req._feed = deque(req.prompt.tolist())  # type: ignore
            self.tokens[s, 0] = req._feed.popleft()
            self.pos[s] = 0

    def _admit_continuous(self):
        """Decide/execute rounds until the scheduler has nothing to admit
        (a prefilled request can finish at once and free its slot).
        Preemptions execute first: a slot is checkpointed before its next
        occupant prefills."""
        while True:
            plan = self.scheduler.decide(self.active)
            if not plan:
                return
            for pre in plan.preemptions:
                self._execute_preemption(pre)
            for adm in plan.admissions:
                self._execute_admission(adm)

    def _prefill_slot(self, s: int, req: Request, start: int = 0):
        """Run prompt tokens [start, prompt_len) through the stack in
        (1, C) chunks, writing the slot's KV in place; the token drawn from
        the last real prompt token's logits (greedy or sampled, per the
        request) seeds decode at pos = prompt_len.  A sampled request's
        earlier chunks take the greedy step (their tokens are not read).

        ``start`` (paged, a multiple of C and <= prompt_len - 1) is where
        the prefix cache left off; the paged step also takes the page
        table, and the prompt's full pages are published for later prefix
        hits afterwards."""
        c = self.prefill_chunk
        prompt = np.asarray(req.prompt, np.int32)
        p = len(prompt)
        n_chunks = max(1, -(-(p - start) // c))
        padded = np.zeros(n_chunks * c, np.int32)
        padded[:p - start] = prompt[start:]
        req._feed = deque()  # type: ignore
        sp = req.sampling
        last_row = (p - start - 1) - (n_chunks - 1) * c
        if self._owns(s):
            extra = () if self.kv is None else (self._page_table(),)
            for ci in range(n_chunks):
                args = (self.params, self.caches,
                        padded[None, ci * c:(ci + 1) * c], s - self._lo,
                        start + ci * c, *extra)
                if ci == n_chunks - 1 and not sp.greedy:
                    nxt, self.caches = self._prefill_sampled(
                        *args, last_row, sp.temperature, sp.top_k, sp.top_p,
                        sp.key_data(req.req_id))
                else:
                    nxt, self.caches = self._prefill(*args)
            tok_t = nxt if not sp.greedy else nxt[last_row]
        else:  # another data row prefills the slot
            tok_t = torch.zeros((), dtype=torch.int32,
                                device=self.model.device)
        if self._num_hosts > 1:
            src = self._row_src[self._row(s)]
            tok_t = broadcast_from(tok_t.to(torch.int32).reshape(()), src,
                                   self._dp_group)
        tok = int(tok_t)
        self.pos[s] = p
        self.tokens[s, 0] = tok
        self._emit(req, tok)
        self._admit_emitted += 1
        if self.kv is not None:
            self.kv.register_prefix(s, prompt)

    def _maybe_stop(self, s: int) -> bool:
        req = self.active[s]
        reason = matches_stop(req.output, req.sampling, req.eos_id)
        if reason is None and (len(req.output) >= req.max_new_tokens
                               or self.pos[s] >= self.max_len - 1):
            reason = "length"
        if reason is not None:
            self._finish(s, reason)
            return True
        return False

    # ----------------------------------------------------------- wave mode
    def _admit_wave(self):
        """Admit a fresh wave only when every slot is free; all slots then
        decode in lockstep at one scalar position, prompts fed token by
        token.  The admission order still follows the policy."""
        if any(r is not None for r in self.active) or not self.queue:
            return
        for leaf in tree_leaves(self.caches):
            leaf.zero_()  # KV stripes, or SSM conv windows and states
        self.pos[:] = 0
        self.tokens[:] = 0
        for adm in self.scheduler.decide(self.active).admissions:
            s, req = adm.slot, adm.req
            self.active[s] = req
            self._set_sampling(s, req)
            self._set_state(req, RequestState.PREFILL, slot=s)
            req._feed = deque(req.prompt.tolist())  # type: ignore
            self.tokens[s, 0] = req._feed.popleft()

    # ------------------------------------------------------------ stepping
    def step(self) -> int:
        """One engine tick = one decode step for every live slot."""
        if self.mode == "wave":
            emitted = self._step_wave()
        else:
            emitted = self._step_continuous()
        self._tick_telemetry(emitted)
        return emitted

    def _step_continuous(self) -> int:
        self._admit_emitted = 0
        self._admit_continuous()
        emitted = self._admit_emitted  # first tokens from chunked prefill
        if self.role == "prefill":
            # a prefill engine never decodes: chunked prefill completed the
            # prompt inside admission and emitted the first token, and the
            # router takes the slot out as a handoff this same tick
            return emitted
        live = sum(r is not None for r in self.active)
        if not live:
            return emitted
        if self.draft_k:
            return self._decode_tick_spec(emitted, live)
        return self._decode_tick_plain(emitted, live)

    def _samp_arrays(self) -> tuple:
        """The per-slot sampling arrays when a live slot samples (finished
        slots reset their temperature to 0), else ()."""
        if not self.samp_temp.max() > 0:
            return ()
        return (self.samp_temp, self.samp_topk, self.samp_topp,
                self.samp_keys)

    def _step_for_splits(self, splits: int, sampled: bool):
        """The decode step at a split-K fan-out, for this engine's cache
        layout, from the shared step cache."""
        if splits <= 1:
            return self._step_sampled if sampled else self._step
        if self.kv is not None:
            return compiled_step(self.model, "paged_serve", sampled=sampled,
                                 page_size=self.kv.page_size,
                                 decode_splits=splits)
        return compiled_step(self.model, "serve", sampled=sampled,
                             decode_splits=splits)

    def _decode_tick_plain(self, emitted: int, live: int) -> int:
        """One single-token decode step for every slot (also what a
        speculative engine runs on a tick where no slot drafted)."""
        samp = self._samp_arrays()
        step = self._step_sampled if samp else self._step
        extra = () if self.kv is None else (self._page_table(),)
        if self._autotune:
            step = self._step_for_splits(pick_decode_splits(
                int(self.pos.max()), live, max_len=self.max_len,
                page_size=0 if self.kv is None else self.kv.page_size),
                bool(samp))
        loc = self._local
        nxt_dev, self.caches = step(self.params, self.caches,
                                    loc(self.tokens), loc(self.pos), *extra,
                                    *(loc(a) for a in samp))
        nxt = self._rows(nxt_dev).cpu().numpy()
        for s, req in enumerate(self.active):
            if req is None:
                continue
            self.pos[s] += 1
            feed = getattr(req, "_feed")
            if feed:  # still consuming the prompt (token-feed path)
                self.tokens[s, 0] = feed.popleft()
                continue
            if req.state is RequestState.PREFILL:  # token-feed path done
                self._set_state(req, RequestState.DECODE)
            tok = int(nxt[s, 0])
            self._emit(req, tok)
            emitted += 1
            self.tokens[s, 0] = tok
            self._maybe_stop(s)
        return emitted

    # ------------------------------------------------------- speculative
    def _draft_cap(self, s: int, req: Request) -> int:
        """Deepest draft slot ``s`` may carry this tick: ``draft_k``; the
        request's remaining budget minus one (the tick emits at least the
        correction token); the ``max_len`` window (after accepting
        everything, pos stays <= max_len - 1); and (paged) the slot's
        mapped page span, so that an off-by-one can reject a draft but
        never write an unheld page."""
        cap = min(self.draft_k,
                  req.max_new_tokens - len(req.output) - 1,
                  self.max_len - 2 - int(self.pos[s]))
        if self.kv is not None:
            cap = min(cap, self.kv.slot_span(s) - 1 - int(self.pos[s]))
        return max(cap, 0)

    def _decode_tick_spec(self, emitted: int, live: int) -> int:
        """One speculative tick: draft per slot (host), verify every draft
        in one T-row step (device), accept the longest confirmed prefix
        plus the correction token (host).

        The emission loop replays the plain tick's order per token --
        advance pos, emit, stop-check -- so eos/stop/length fire at the
        token they would in sequential decode and accepted tokens past a
        stop are dropped.  A tick where no slot drafted takes the plain
        one-token step (bitwise a draft-less verify, at a T-th of the
        work); ``spec_ticks`` counts only the verify dispatches."""
        t_width = self.draft_k + 1
        feed = np.zeros((self.slots, t_width), np.int32)
        feed[:, 0] = self.tokens[:, 0]
        draft_len = np.zeros(self.slots, np.int32)
        for s, req in enumerate(self.active):
            if req is None or getattr(req, "_feed", None):
                continue  # parked / token-feeding slots carry no draft
            cap = self._draft_cap(s, req)
            if cap <= 0:
                continue
            # hand the drafter only its lookback window
            lb = getattr(self.drafter, "lookback", 0)
            out = req.output
            if lb and len(out) >= lb:
                ctx = np.asarray(out[-lb:], np.int32)
            else:
                head = (req.prompt[max(len(req.prompt) + len(out) - lb, 0):]
                        if lb else req.prompt)
                ctx = np.concatenate([np.asarray(head, np.int32),
                                      np.asarray(out, np.int32)])
            d = self.drafter.propose(ctx, cap)
            if len(d):
                feed[s, 1:1 + len(d)] = d
                draft_len[s] = len(d)
        if not draft_len.any():
            return self._decode_tick_plain(emitted, live)
        samp = self._samp_arrays()
        step = self._spec_step_sampled if samp else self._spec_step
        extra = () if self.kv is None else (self._page_table(),)
        loc = self._local
        target_dev, self.caches = step(self.params, self.caches, loc(feed),
                                       loc(self.pos), *extra,
                                       *(loc(a) for a in samp))
        target = self._rows(target_dev).cpu().numpy()  # (B, T) verified
        self.spec_ticks += 1
        for s, req in enumerate(self.active):
            if req is None:
                continue
            fq = getattr(req, "_feed")
            if fq:  # still consuming the prompt (token-feed path)
                self.pos[s] += 1
                self.tokens[s, 0] = fq.popleft()
                continue
            if req.state is RequestState.PREFILL:  # token-feed path done
                self._set_state(req, RequestState.DECODE)
            k_s = int(draft_len[s])
            m = (speculative_accept(feed[s, 1:1 + k_s], target[s, :k_s])
                 if k_s else 0)
            self.spec_proposed += k_s
            self.spec_accepted += m
            for t in range(m + 1):
                self.pos[s] += 1
                tok = int(target[s, t])
                self._emit(req, tok)
                emitted += 1
                self.spec_emitted += 1
                self.tokens[s, 0] = tok
                if self._maybe_stop(s):
                    break  # accepted tokens past a stop are dropped
        return emitted

    def spec_stats(self) -> dict:
        """Speculative-decode telemetry from the ``engine_spec_*`` gauges:
        the draft acceptance rate and the tokens emitted per verify tick
        (1.0 = plain decode)."""
        if not self.draft_k:
            return {"draft_k": 0}
        v = self.tm.registry.value
        lbl = {"replica": str(self.replica)}
        proposed = int(v("engine_spec_proposed", **lbl))
        accepted = int(v("engine_spec_accepted", **lbl))
        emitted = int(v("engine_spec_emitted", **lbl))
        ticks = int(v("engine_spec_ticks", **lbl))
        return {
            "draft_k": self.draft_k,
            "drafter": self.config.drafter,
            "proposed": proposed,
            "accepted": accepted,
            "acceptance_rate": accepted / max(proposed, 1),
            "spec_ticks": ticks,
            "tokens_per_tick": emitted / max(ticks, 1),
        }

    def _step_wave(self) -> int:
        self._admit_wave()
        if not any(r is not None for r in self.active):
            return 0
        pos = int(self.pos.max())  # lockstep position (wave batching)
        logits, self.caches = self._decode_one(self.params, self.caches,
                                               self.tokens, pos)
        samp = self._samp_arrays()
        if samp:
            # sampled wave mode: draw from the wave logits.  A slot's
            # absolute position IS the wave position, so the fold is the
            # continuous step's and a seed gives the same trajectory;
            # greedy rows stay the argmax inside sample_tokens
            nxt = sample_tokens(logits, self.pos, *samp)
        else:
            nxt = logits.argmax(dim=-1)
        nxt = nxt.to("cpu").numpy().astype(np.int32)
        emitted = 0
        for s, req in enumerate(self.active):
            if req is None:
                continue
            self.pos[s] += 1
            feed = getattr(req, "_feed")
            if feed:  # still consuming the prompt
                self.tokens[s, 0] = feed.popleft()
                continue
            if req.state is RequestState.PREFILL:
                self._set_state(req, RequestState.DECODE)
            tok = int(nxt[s])
            self._emit(req, tok)
            emitted += 1
            self.tokens[s, 0] = tok
            self._maybe_stop(s)
        return emitted

    # --------------------------------------------------------- cluster hooks
    def free_slots(self) -> int:
        """Slots a router may target now: parked slots minus the queue the
        engine already owes admissions to."""
        return max(0, sum(r is None for r in self.active)
                   - len(self.scheduler.queue))

    def offer(self) -> dict:
        """Resource offer for a cluster router: free decode slots, free KV
        pages (``None`` for the dense cache, where slots are the only
        currency), the page size and the backlog a placement would queue
        behind.  A pool split over more than one host also advertises
        ``free_pages_by_host``."""
        out = {
            "free_slots": self.free_slots(),
            "free_pages": (None if self.kv is None
                           else self.kv.pool.available),
            "page_size": None if self.kv is None else self.kv.page_size,
            "queue_depth": len(self.scheduler.queue),
        }
        if self.kv is not None and self.kv.num_hosts > 1:
            out["free_pages_by_host"] = self.kv.free_by_host()
        return out

    def live_requests(self) -> list:
        """Every unfinished request this engine holds: running slots plus
        the admission queue (preempted requests waiting to resume
        included).  A router recovering a lost replica replays this set."""
        return ([r for r in self.active if r is not None]
                + [r for r in self.queue])

    def can_accept(self, req: Request) -> bool:
        """Could a router place ``req`` here without queuing it behind
        backpressure?  Host-side sizing only (a free slot and, paged, a
        page fit); the engine's scheduler absorbs any overshoot of several
        placements in one tick as ordinary backpressure."""
        if self.free_slots() < 1:
            return False
        if self.kv is not None:
            return (self.kv.fits_ever(len(req.prompt), req.max_new_tokens)
                    and self.kv.fits_now(req.prompt, req.max_new_tokens))
        return 0 < len(req.prompt) < self.max_len

    def kv_stats(self) -> dict:
        stats = {"cache": self.config.cache,
                 "kv_reserved_bytes": self.kv_reserved_bytes()}
        if self.kv is not None:
            stats.update(self.kv.stats())
        return stats

    def run(self, max_ticks: int = 10_000,
            on_stall: Optional[str] = None) -> list[Request]:
        """Drive the engine until every request drains.  An exhausted
        tick budget raises ``ServeStalled`` (``on_stall="raise"``) or
        warns and returns the partial results (``"warn"``)."""
        stall_mode = on_stall or self.config.on_stall
        if stall_mode not in ("raise", "warn"):
            raise ValueError(f"on_stall must be 'raise' or 'warn': "
                             f"{stall_mode!r}")
        ticks = 0
        while self.queue or any(r is not None for r in self.active):
            if ticks >= max_ticks:
                queued = len(self.queue)
                live = sum(r is not None for r in self.active)
                msg = (f"ServeEngine.run() exhausted {max_ticks} ticks "
                       f"with {queued + live} requests undrained "
                       f"({queued} queued, {live} active)")
                if stall_mode == "raise":
                    raise ServeStalled(msg)
                warnings.warn(msg, RuntimeWarning, stacklevel=2)
                break
            self.step()
            ticks += 1
        finished, self._finished = self._finished, []
        return finished
