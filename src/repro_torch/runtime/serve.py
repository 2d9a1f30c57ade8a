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

Not in this slice (the fields exist and raise ``NotImplementedError``
when set): ``role`` other than "unified", ``mesh_shape``; and
``release()`` (the disaggregated handoff).
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

from repro_torch.models.transformer import tree_leaves
from repro_torch.runtime.draft import get_drafter
from repro_torch.runtime.kv_pool import KVCacheManager
from repro_torch.runtime.sampling import (SamplingParams, matches_stop,
                                          sample_tokens, speculative_accept)
from repro_torch.runtime.scheduler import Scheduler
from repro_torch.runtime.steps import (compiled_step, pick_decode_splits,
                                       step_cache_stats)
from repro_torch.runtime.telemetry import Telemetry

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


def _check_ported(config: ServeConfig) -> None:
    unported = {"role != 'unified'": config.role != "unified",
                "mesh_shape": config.mesh_shape is not None}
    asked = [name for name, on in unported.items() if on]
    if asked:
        raise NotImplementedError(
            f"ServeConfig {', '.join(asked)}: not ported yet (the port "
            f"serves one unsharded engine; see ROADMAP.md)")


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


class ServeEngine:
    def __init__(self, model, params, config: Optional[ServeConfig] = None,
                 *, telemetry=None, replica: int = 0):
        config = config if config is not None else ServeConfig()
        if config.mode not in ("continuous", "wave"):
            raise ValueError(f"unknown mode {config.mode!r}")
        if config.cache not in ("dense", "paged"):
            raise ValueError(f"unknown cache {config.cache!r}")
        if config.on_stall not in ("raise", "warn"):
            raise ValueError(f"unknown on_stall {config.on_stall!r}")
        _check_ported(config)
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
        self.config = config
        self.model = model
        self.params = params
        self.slots = config.batch_slots
        self.max_len = config.max_len
        self.mode = config.mode
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
        self._admit_emitted = 0  # tokens emitted by chunked prefill
        self._decode_one = compiled_step(model, "decode_one")
        # checkpoint/restore (dense): built on first preemption
        self._copy_out = self._copy_in = None
        self.kv: Optional[KVCacheManager] = None
        if config.cache == "paged":
            self._init_paged(config)
        else:
            self.caches = model.init_cache(batch_slots, max_len)
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
        self.scheduler = Scheduler(config.policy, slots=batch_slots,
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
        self.kv = KVCacheManager(
            slots=config.batch_slots, max_len=max_len, page_size=page_size,
            num_pages=num_pages, policy=config.page_policy,
            prefix_cache=config.prefix_cache, chunk=c)
        self.caches = self.model.init_cache_paged(self.kv.pool.num_pages,
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

    def kv_reserved_bytes(self) -> int:
        """Device bytes held by the KV cache (dense stripes, or the page
        pools and their scale pools)."""
        return sum(t.numel() * t.element_size()
                   for t in tree_leaves(self.caches))

    def _page_table(self) -> torch.Tensor:
        """The page table on the model's device (one host-to-device copy;
        every layer of the step reads it)."""
        return torch.as_tensor(self.kv.page_table, device=self.model.device)

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
        if self.kv is not None:
            kv_snap = None  # zero-copy: the detached page chain IS the KV
        else:
            self._ensure_ckpt_fns()
            kv_snap = self._copy_out(self.caches, s)
        req._ckpt = Checkpoint(pos=int(self.pos[s]),
                               last_token=int(self.tokens[s, 0]),
                               pages=getattr(req, "_ckpt_pages", None),
                               kv=kv_snap)
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
            self._ensure_ckpt_fns()
            self.caches = self._copy_in(self.caches, ck.kv, s)
        self.pos[s] = ck.pos
        self.tokens[s, 0] = ck.last_token
        req._feed = deque()  # type: ignore
        req._ckpt = None
        req._ckpt_pages = None
        req._preempted = False
        req._handoff_kv = 0  # adopted chain now charged via _drf_charged
        self._set_state(req, RequestState.DECODE, resume=True,
                        pos=int(self.pos[s]))

    def release(self, req: Request):
        """The disaggregated handoff's checkpoint: not ported yet."""
        raise NotImplementedError(
            "release() (the disaggregated prefill/decode handoff) is not "
            "ported yet (see ROADMAP.md)")

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
        if self._needs_reset:
            self.caches = self._reset(self.caches, s)
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
        extra = () if self.kv is None else (self._page_table(),)
        sp = req.sampling
        last_row = (p - start - 1) - (n_chunks - 1) * c
        nxt = None
        for ci in range(n_chunks):
            args = (self.params, self.caches,
                    padded[None, ci * c:(ci + 1) * c], s, start + ci * c,
                    *extra)
            if ci == n_chunks - 1 and not sp.greedy:
                nxt, self.caches = self._prefill_sampled(
                    *args, last_row, sp.temperature, sp.top_k, sp.top_p,
                    sp.key_data(req.req_id))
            else:
                nxt, self.caches = self._prefill(*args)
        tok = int(nxt if not sp.greedy else nxt[last_row])
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
        nxt_dev, self.caches = step(self.params, self.caches, self.tokens,
                                    self.pos, *extra, *samp)
        nxt = nxt_dev.cpu().numpy()
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
        target_dev, self.caches = step(self.params, self.caches, feed,
                                       self.pos, *extra, *samp)
        target = target_dev.cpu().numpy()  # (B, T) verified tokens
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
