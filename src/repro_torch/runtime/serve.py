"""Policy-driven serving front-end over the batched decode loop (dense
cache, greedy).

The PyTorch counterpart of ``repro/runtime/serve.py``.  ``ServeEngine``
admits requests through the copied ``Scheduler`` (fcfs / priority / sjf /
drf-fair), prefills each prompt in chunks into the slot's stripe of a
dense (L, B, S, KV, D) cache, and then runs one ragged decode step per
tick over every slot, each at its own position (free slots parked at -1).
The caches are written in place, one K/V row per slot per layer per tick.

``mode="continuous"`` (default) admits into any freed slot at once;
``mode="wave"`` is the lockstep baseline: a fresh wave only when every
slot is free, prompts fed token by token, one scalar position.

When ``RuntimeKnobs.decode_splits`` is 0 the continuous engine picks the
split-K fan-out per tick from ``(max(pos), live slots)``
(``steps.pick_decode_splits``), on any device: on the card split-K runs
the CUDA two-phase kernel, on the CPU its plain version.

Not in this slice (the fields exist and raise ``NotImplementedError``
when set): ``cache="paged"``, ``kv_dtype``, ``draft_k``, ``preempt``,
``role`` other than "unified", ``mesh_shape``; requests with
``temperature > 0``.
"""
from __future__ import annotations

import enum
import time
import warnings
from collections import deque
from dataclasses import dataclass, field
from typing import Iterator, Optional

import numpy as np

from repro_torch.runtime.sampling import SamplingParams, matches_stop
from repro_torch.runtime.scheduler import Scheduler
from repro_torch.runtime.steps import (compiled_step, pick_decode_splits,
                                       step_cache_stats)
from repro_torch.runtime.telemetry import Telemetry

__all__ = ["Request", "RequestHandle", "RequestState", "SamplingParams",
           "ServeConfig", "ServeEngine", "ServeStalled", "request_metrics"]


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
    unported = {"cache='paged'": config.cache == "paged",
                "kv_dtype": bool(config.kv_dtype),
                "draft_k > 0": config.draft_k > 0,
                "preempt": config.preempt,
                "role != 'unified'": config.role != "unified",
                "mesh_shape": config.mesh_shape is not None}
    asked = [name for name, on in unported.items() if on]
    if asked:
        raise NotImplementedError(
            f"ServeConfig {', '.join(asked)}: not ported yet (the port "
            f"serves the dense cache; see ROADMAP.md)")


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
        self._finished: list[Request] = []
        self._admit_emitted = 0  # tokens emitted by chunked prefill
        self._decode_one = compiled_step(model, "decode_one")
        self.caches = model.init_cache(batch_slots, max_len)
        self._step = compiled_step(model, "serve")
        # chunked prefill: one (1, C) step reused for every slot and
        # offset; C rounded down to a divisor of max_len so padded chunk
        # writes never clamp
        self.chunked = (config.mode == "continuous"
                        and config.prefill_chunk > 1
                        and model.supports_chunked_prefill())
        c = max(1, min(config.prefill_chunk, max_len))
        while max_len % c:
            c -= 1
        self.prefill_chunk = c
        if self.chunked:
            self._prefill = compiled_step(model, "prefill_chunk")
        self.scheduler = Scheduler(config.policy, slots=batch_slots,
                                   max_len=max_len, kv=None,
                                   weights=config.tenant_weights,
                                   preempt=False,
                                   victim=config.victim_policy)
        # split-K autotune: pick the fan-out per tick from (max(pos), live
        # slots) whatever the device
        self._autotune = (config.mode == "continuous"
                          and model.knobs.decode_splits == 0)
        self.bind_telemetry(telemetry, replica=replica)

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
        self.scheduler.bind_metrics(reg, self.replica)
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
        tr.counter(self.replica, "engine", {
            "live_slots": sum(r is not None for r in self.active),
            "queue_depth": len(self.scheduler.queue),
            "step_cache_hits": step_cache_stats()["hits"]})

    @property
    def queue(self) -> deque:
        """The scheduler's admission queue (read-mostly; use submit())."""
        return self.scheduler.queue

    def submit(self, req: Request) -> RequestHandle:
        if not 0 < len(req.prompt) < self.max_len:
            raise ValueError(
                f"prompt length {len(req.prompt)} outside [1, "
                f"{self.max_len - 1}] for max_len={self.max_len}")
        if not req.sampling.greedy:
            raise NotImplementedError(
                "sampled decoding (temperature > 0) is not ported yet; the "
                "port serves greedy requests (see ROADMAP.md)")
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
        self.active[s] = None
        self.pos[s] = -1
        self.tokens[s, 0] = 0

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
        self.scheduler.on_finish(req)
        self._finished.append(req)

    def _execute_admission(self, adm):
        """Apply one scheduler decision: chunked prefill, or token-feed
        setup when chunking is off."""
        s, req = adm.slot, adm.req
        self.active[s] = req
        self._set_state(req, RequestState.PREFILL, slot=s)
        if self.chunked:
            self._prefill_slot(s, req)
            if not self._maybe_stop(s):
                self._set_state(req, RequestState.DECODE)
        else:
            req._feed = deque(req.prompt.tolist())  # type: ignore
            self.tokens[s, 0] = req._feed.popleft()
            self.pos[s] = 0

    def _admit_continuous(self):
        """Decide/execute rounds until the scheduler has nothing to admit
        (a prefilled request can finish at once and free its slot)."""
        while True:
            plan = self.scheduler.decide(self.active)
            if not plan:
                return
            for adm in plan.admissions:
                self._execute_admission(adm)

    def _prefill_slot(self, s: int, req: Request):
        """Run the prompt through the stack in (1, C) chunks, writing the
        slot's KV stripe in place; the greedy token of the last real
        prompt token seeds decode at pos = prompt_len."""
        c = self.prefill_chunk
        prompt = np.asarray(req.prompt, np.int32)
        p = len(prompt)
        n_chunks = max(1, -(-p // c))
        padded = np.zeros(n_chunks * c, np.int32)
        padded[:p] = prompt
        req._feed = deque()  # type: ignore
        nxt = None
        for ci in range(n_chunks):
            nxt, self.caches = self._prefill(
                self.params, self.caches, padded[None, ci * c:(ci + 1) * c],
                s, ci * c)
        tok = int(nxt[(p - 1) - (n_chunks - 1) * c])
        self.pos[s] = p
        self.tokens[s, 0] = tok
        self._emit(req, tok)
        self._admit_emitted += 1

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
        for leaf in self.caches["stack"].values():
            leaf.zero_()
        self.pos[:] = 0
        self.tokens[:] = 0
        for adm in self.scheduler.decide(self.active).admissions:
            s, req = adm.slot, adm.req
            self.active[s] = req
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
        return self._decode_tick_plain(emitted, live)

    def _decode_tick_plain(self, emitted: int, live: int) -> int:
        """One single-token decode step for every slot."""
        step = self._step
        if self._autotune:
            splits = pick_decode_splits(int(self.pos.max()), live,
                                        max_len=self.max_len)
            if splits > 1:
                step = compiled_step(self.model, "serve",
                                     decode_splits=splits)
        nxt_dev, self.caches = step(self.params, self.caches, self.tokens,
                                    self.pos)
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

    def _step_wave(self) -> int:
        self._admit_wave()
        if not any(r is not None for r in self.active):
            return 0
        pos = int(self.pos.max())  # lockstep position (wave batching)
        logits, self.caches = self._decode_one(self.params, self.caches,
                                               self.tokens, pos)
        nxt = logits.argmax(dim=-1).to("cpu").numpy().astype(np.int32)
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
