"""Token drafters for in-engine speculative decoding.

The port's own copy of ``repro.launch.spec_decode`` (host-only: no tensors).

Speculative decoding breaks the engine's 1-token-per-step barrier: a cheap
**drafter** proposes up to ``k`` candidate continuation tokens for a stream,
the engine feeds ``[last_token, d_1, .., d_k]`` through ONE masked chunked
verify step (``models.lstm_lm.quant_verify_step``), and the longest draft
prefix whose greedy argmax matches is accepted -- plus the model's own
next token after the accepted prefix, so every verify step emits between 1
and ``k + 1`` tokens while staying **bit-identical** to one-token greedy
decode (each emitted token IS the greedy argmax at its position; drafts only
decide how many positions one dispatch gets to confirm).

Draft quality therefore only affects *speed*, never output: a useless
drafter degrades to ~1 token/step, a perfect one reaches ``k + 1``.

The default :class:`NGramDrafter` is a per-stream suffix cache (prompt
lookup decoding): it matches the stream's most recent ``n``-gram against
earlier occurrences in that same stream's history and proposes the tokens
that followed last time.  Greedy integer LSTM decode frequently falls into
short cycles, and served text is self-repetitive, so this accepts well on
exactly the workloads where decode throughput matters -- with zero model
cost per draft.

:class:`Drafter` is the pluggable interface: anything with
``observe/draft/reset`` can slot in (e.g. a smaller integer LSTM stack
drafting with its own fused step -- see ROADMAP follow-ons).  One drafter
instance serves ONE stream; the engine creates a fresh instance per
stream start so no draft state ever leaks between co-tenant slots.  The
drafter belongs to the STREAM, not the slot: when the scheduler preempts a
stream to the state pool, its drafter travels with the stream's host
bookkeeping and resumes with its suffix history intact -- so speculation
quality (and the bit-exact output) survives any preemption schedule.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple


class Drafter:
    """Per-stream draft-token source (the pluggable speculation interface).

    Lifecycle inside the engine: ``reset()`` when the stream starts,
    ``observe`` for every token the stream's history grows by (the prompt
    at start, then each emitted token), ``draft(k)`` once per generation
    step.  Preemption does NOT reset a drafter -- the instance rides with
    its stream through the state pool and keeps drafting on resume.
    """

    def reset(self) -> None:
        """Forget all history (stream start)."""
        raise NotImplementedError

    def observe(self, tokens: Sequence[int]) -> None:
        """Append ``tokens`` to this stream's history."""
        raise NotImplementedError

    def draft(self, k: int) -> List[int]:
        """Propose up to ``k`` candidate next tokens (possibly none).

        Proposals are *guesses* -- the verify step keeps the output correct
        regardless -- but implementations should return an empty list rather
        than noise when they have no signal, so the engine can skip the
        wide verify dispatch entirely on that step.
        """
        raise NotImplementedError


class NGramDrafter(Drafter):
    """Suffix-match (prompt-lookup) drafter over one stream's own history.

    Keeps the stream's token history plus, for every n-gram of order
    ``1..max_n``, the positions right after its two most recent occurrences.
    ``draft(k)`` matches the longest current suffix (longest order first)
    against its previous occurrence and proposes the up-to-``k`` tokens that
    followed it.  Every proposed token is therefore a token this stream has
    already emitted/observed, and a fresh drafter (empty history) proposes
    nothing -- the two properties ``tests/test_spec_decode.py`` pins.

    O(max_n) per observed token, O(max_n + k) per draft.
    """

    def __init__(self, max_n: int = 3):
        if max_n < 1:
            raise ValueError(f"max_n must be >= 1, got {max_n}")
        self.max_n = max_n
        self.reset()

    def reset(self) -> None:
        self._history: List[int] = []
        # _after[n][gram] = (second-most-recent, most-recent) positions
        # IMMEDIATELY AFTER an occurrence of `gram`; the most recent entry
        # for the current suffix is the suffix itself, so draft() reads the
        # previous one.
        self._after: List[Dict[Tuple[int, ...], Tuple[int, int]]] = [
            {} for _ in range(self.max_n)
        ]

    @property
    def history(self) -> List[int]:
        return list(self._history)

    def observe(self, tokens: Sequence[int]) -> None:
        for t in tokens:
            self._history.append(int(t))
            end = len(self._history)
            for n in range(1, self.max_n + 1):
                if end < n:
                    break
                gram = tuple(self._history[end - n:end])
                idx = self._after[n - 1]
                prev = idx.get(gram)
                idx[gram] = (prev[1] if prev else -1, end)

    def draft(self, k: int) -> List[int]:
        h = self._history
        if k < 1 or not h:
            return []
        end = len(h)
        for n in range(min(self.max_n, end), 0, -1):
            gram = tuple(h[end - n:end])
            # the most-recent recorded position is always the current
            # suffix's own occurrence (observe indexes every suffix), so
            # the match to continue from is the one before it
            prev = self._after[n - 1].get(gram, (-1, -1))[0]
            if prev >= 0:
                return h[prev:prev + k]
        return []
