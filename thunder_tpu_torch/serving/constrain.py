"""Constrained decoding: per-request logit masks as step inputs.

Counterpart of ``thunder_tpu/serving/constrain.py``; the automata are pure
numpy and copied whole.  Structured output (JSON fields, grammar-limited
tool calls, enum answers) is served the way LoRA adapters are: nothing
about a schema reaches a step's identity.  A constrained engine
(``serve(..., constraints=True)``) gives its sampling steps one more input,
a boolean token mask, and every schema, automaton or allow-list is data fed
through that input:

- the engine keeps the automaton on the host, on the request
  (:class:`Constraint` instances are plain Python state machines);
- at every dispatch the host asks each constrained row for its mask(s)
  over the next draw(s) and sends a ``(B, V)`` bool tensor (one per
  iteration for ``decode_steps=N``);
- inside the step the mask is applied as ``logits = where(mask, logits,
  -inf)`` right before the draw, so greedy argmax and temperature sampling
  both respect it;
- at harvest the engine advances the automaton with the emitted token
  (:meth:`Constraint.advance`), so a recovery replay or a preemption resume
  needs no constraint handling: the automaton never lived on the device.

Unconstrained rows in a constrained batch get an all-``True`` mask;
``where(True, logits, -inf)`` returns the logits bitwise, so their tokens
equal an unconstrained engine's.

Multi-step decode (``decode_steps=N``) needs masks for N draws at dispatch
time, before any of those tokens exist.  A constraint can promise that
only when its next-N masks are determined by position alone (stationary
allow-lists; automata whose reachable states agree step by step).
:meth:`Constraint.masks` is the contract: implementations return exact
per-step masks or raise :class:`ConstraintLookaheadError`; the engine
checks at ``submit()``, so an incompatible (constraint, ``decode_steps``)
pair fails there instead of emitting tokens the schema forbids.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "Constraint",
    "ConstraintLookaheadError",
    "TokenSetConstraint",
    "DFAConstraint",
    "sequence_constraint",
]


class ConstraintLookaheadError(ValueError):
    """The constraint cannot exactly predict masks ``n`` draws ahead.

    Raised by :meth:`Constraint.masks` when ``n`` exceeds what the
    automaton can promise without knowing the sampled tokens — the
    engine surfaces it at ``submit()`` for ``decode_steps > 1``.
    """


class Constraint:
    """Base class for host-side decoding automata.

    Subclasses implement :meth:`mask` (allowed tokens *now*) and
    :meth:`advance` (consume one emitted token).  ``vocab_size`` must
    match the model's logit width (``padded_vocab_size``) — the engine
    checks at ``submit()``.
    """

    def __init__(self, vocab_size: int):
        self.vocab_size = int(vocab_size)

    # -- required interface -------------------------------------------------
    def mask(self) -> np.ndarray:
        """``(vocab_size,)`` bool — tokens permitted for the next draw."""
        raise NotImplementedError

    def advance(self, token: int) -> None:
        """Consume one emitted token, moving the automaton forward."""
        raise NotImplementedError

    # -- optional lookahead (multi-step decode) -----------------------------
    def masks(self, n: int) -> np.ndarray:
        """``(n, vocab_size)`` bool — exact masks for the next ``n`` draws.

        The default handles ``n == 1`` via :meth:`mask` and refuses
        longer horizons; subclasses whose masks are position-determined
        override it.
        """
        if n == 1:
            return self.mask()[None]
        raise ConstraintLookaheadError(
            f"{type(self).__name__} cannot predict masks {n} steps ahead; "
            "use decode_steps=1 or a position-determined constraint")


class TokenSetConstraint(Constraint):
    """A stationary allow-list: every draw must come from ``allowed_ids``.

    The simplest useful schema (digits only, yes/no, an enum of tool
    names).  Stationary masks trivially support any ``decode_steps``
    horizon.
    """

    def __init__(self, vocab_size: int, allowed_ids):
        super().__init__(vocab_size)
        ids = np.asarray(sorted(set(int(t) for t in allowed_ids)), dtype=np.int64)
        if ids.size == 0:
            raise ValueError("TokenSetConstraint needs at least one allowed id")
        if ids.min() < 0 or ids.max() >= self.vocab_size:
            raise ValueError(
                f"allowed ids must lie in [0, {self.vocab_size}), got "
                f"[{ids.min()}, {ids.max()}]")
        self._mask = np.zeros(self.vocab_size, dtype=bool)
        self._mask[ids] = True

    def mask(self) -> np.ndarray:
        return self._mask

    def advance(self, token: int) -> None:
        if not self._mask[int(token)]:
            raise ValueError(
                f"token {int(token)} violates TokenSetConstraint")

    def masks(self, n: int) -> np.ndarray:
        return np.broadcast_to(self._mask, (n, self.vocab_size)).copy()


class DFAConstraint(Constraint):
    """A token-level DFA: ``transitions[state, token] -> next state | -1``.

    ``transitions`` is an ``(n_states, vocab_size)`` int array; ``-1``
    marks a forbidden token.  The grammar — a JSON skeleton, a CSV row
    shape, a tool-call syntax — is entirely in the table, which is plain
    data: registering a new grammar compiles nothing.

    Multi-step lookahead is exact when the reachable-state frontier
    agrees on its allowed set at every step (true for position-determined
    grammars such as fixed-shape records); otherwise
    :class:`ConstraintLookaheadError` is raised rather than returning an
    approximate mask.
    """

    def __init__(self, transitions, start: int = 0):
        table = np.asarray(transitions, dtype=np.int64)
        if table.ndim != 2:
            raise ValueError("transitions must be (n_states, vocab_size)")
        super().__init__(table.shape[1])
        if not (0 <= start < table.shape[0]):
            raise ValueError(f"start state {start} out of range")
        bad = (table < -1) | (table >= table.shape[0])
        if bad.any():
            raise ValueError("transitions entries must be -1 or a valid state")
        self._table = table
        self._start = int(start)
        self.state = int(start)

    def mask(self) -> np.ndarray:
        return self._table[self.state] >= 0

    def advance(self, token: int) -> None:
        nxt = int(self._table[self.state, int(token)])
        if nxt < 0:
            raise ValueError(
                f"token {int(token)} forbidden in DFA state {self.state}")
        self.state = nxt

    def reset(self) -> None:
        self.state = self._start

    def masks(self, n: int) -> np.ndarray:
        out = np.zeros((n, self.vocab_size), dtype=bool)
        frontier = {self.state}
        for k in range(n):
            per_state = [self._table[s] >= 0 for s in sorted(frontier)]
            for m in per_state[1:]:
                if not np.array_equal(per_state[0], m):
                    raise ConstraintLookaheadError(
                        f"DFA masks diverge {k} steps ahead "
                        f"(reachable states {sorted(frontier)}); this grammar "
                        "cannot run under decode_steps > 1")
            out[k] = per_state[0]
            frontier = {int(self._table[s, t])
                        for s in frontier
                        for t in np.flatnonzero(self._table[s] >= 0)}
        return out


def sequence_constraint(vocab_size: int, steps, *, cycle: bool = False) -> DFAConstraint:
    """Build a position-determined DFA from per-step allow-lists.

    ``steps`` is a sequence of token-id collections: draw ``k`` must come
    from ``steps[k]``; after the last step the automaton either repeats
    the final step forever (``cycle=False``) or wraps to step 0
    (``cycle=True`` — e.g. ``digit, comma, digit, comma, ...``).  Being
    position-determined, the result supports any ``decode_steps``
    lookahead.
    """
    steps = [sorted(set(int(t) for t in s)) for s in steps]
    if not steps or any(not s for s in steps):
        raise ValueError("steps must be non-empty allow-lists")
    n = len(steps)
    table = np.full((n, vocab_size), -1, dtype=np.int64)
    for k, allowed in enumerate(steps):
        nxt = (k + 1) % n if cycle else min(k + 1, n - 1)
        for t in allowed:
            if not (0 <= t < vocab_size):
                raise ValueError(f"token id {t} out of range")
            table[k, t] = nxt
    return DFAConstraint(table)
