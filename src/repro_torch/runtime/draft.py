"""Draft proposers for speculative decode (host side).

A drafter guesses up to ``k`` continuation tokens for a slot from its
token history alone; the engine then scores the whole guess in ONE
multi-token verify step (``steps.make_spec_serve_step``) and keeps the
longest confirmed prefix (``sampling.speculative_accept``).  Drafters are
pure host-side objects registered in ``DRAFTERS`` and resolved by
``get_drafter(name)`` — the same registry pattern as
``core/policies.py`` / ``runtime/scheduler.py``'s admission policies —
so a small-model drafter can slot in later without touching the engine:
the contract is only ``propose(context, k) -> up-to-k tokens``.

``ngram`` (the default) is the model-free **prompt/n-gram lookup**
drafter (prompt-lookup decoding): match the tail n-gram of the slot's
context (prompt + emitted tokens) against its own earlier history and
propose the tokens that followed the most recent earlier occurrence.
Free to compute, and strong exactly where speculation pays — structured
traces that restate their own context (code, templated chat, greedy
decode loops) — while degrading to zero proposals (never wrong output:
rejected drafts cost only the wasted verify columns) on incompressible
streams.
"""
from __future__ import annotations

import numpy as np

__all__ = ["DRAFTERS", "Drafter", "NgramDrafter", "get_drafter"]


class Drafter:
    """Proposes draft continuations from a slot's token history.

    ``lookback`` bounds how much history the engine hands ``propose``
    (0 = unlimited).  Long-running requests would otherwise pay
    O(len(history)) host work per tick — quadratic over a request's
    life — on the path that sits between every device step."""

    name = "base"
    lookback = 0

    def propose(self, context: np.ndarray, k: int) -> np.ndarray:
        """Up to ``k`` proposed continuation tokens (int32, possibly
        empty) for a slot whose history is ``context`` (prompt followed
        by every emitted token — the verified stream, never rejected
        drafts).  Must be a pure function of ``context``: the engine
        replays requests bitwise, so a drafter may not carry hidden
        state across calls."""
        raise NotImplementedError


class NgramDrafter(Drafter):
    """Prompt/n-gram lookup: propose the continuation of the most recent
    earlier occurrence of the context's tail n-gram.

    Tries tail lengths ``max_n .. min_n`` (longer matches first — more
    context agreement, higher acceptance); within a tail length the most
    recent earlier occurrence with a full k-token continuation wins
    (recency beats frequency on decode loops).  Proposes at most ``k``
    tokens and never invents one: every proposal is a token copied from
    the slot's own history.
    """

    name = "ngram"

    def __init__(self, max_n: int = 3, min_n: int = 1,
                 lookback: int = 512):
        assert 1 <= min_n <= max_n, (min_n, max_n)
        self.max_n = max_n
        self.min_n = min_n
        self.lookback = lookback  # most recent tokens searched (0 = all)

    def propose(self, context: np.ndarray, k: int) -> np.ndarray:
        ctx = np.asarray(context, np.int32)
        n_ctx = len(ctx)
        empty = np.zeros(0, np.int32)
        if k <= 0 or n_ctx < self.min_n + 1:
            return empty
        for n in range(min(self.max_n, n_ctx - 1), self.min_n - 1, -1):
            tail = ctx[n_ctx - n:]
            # windows[j] == ctx[j : j + n]; candidate starts j < n_ctx - n
            # (the tail itself is excluded — it has no continuation yet)
            windows = np.lib.stride_tricks.sliding_window_view(ctx, n)
            hits = np.flatnonzero(
                (windows[:n_ctx - n] == tail[None, :]).all(axis=1))
            if hits.size:
                # prefer the most recent occurrence with a full k-token
                # continuation (a match near the context end — e.g. a
                # period-1 decode loop — would otherwise truncate the
                # proposal to the leftover suffix); fall back to the
                # most recent occurrence with whatever follows it
                full = hits[hits + n + k <= n_ctx]
                j = int(full[-1]) if full.size else int(hits[-1])
                return ctx[j + n:j + n + k].copy()
        return empty


DRAFTERS = {
    "ngram": NgramDrafter,
}


def get_drafter(name, **kw) -> Drafter:
    if isinstance(name, Drafter):
        return name
    return DRAFTERS[name](**kw)
