"""Speculative decoding drafts — the port of ``ddl_tpu/serve/speculate.py``
(``propose_draft``, ``greedy_accept``, ``NGRAM_MAX``,
``SPECULATE_METHODS``): n-gram / prompt-lookup drafts that the scheduler
verifies in ONE target-model step, with output equal to plain greedy
decode.

**The draft** (this module, numpy host code, no device work): the longest
suffix n-gram of the known context (``prompt + generated`` for
``"ngram"``, the prompt alone for ``"prompt"``) is searched for its
RIGHTMOST earlier occurrence, and the tokens that followed it become the
draft. Greedy decode of a looping or templated stream revisits its own
n-grams, which is the workload the drafts serve.

**The verify** (``serve.scheduler.Scheduler._speculate_decode``): the
drafts ride FREE SLOTS of the one batched decode call the tick makes
anyway. Draft lane ``i`` aliases the speculating slot's block table
(``engine.alias_slot_pages``: incref, zero copy), feeds draft token ``i``
at position ``n + 1 + i`` and writes its K/V row through the shared
pages; the decode writes every row before it attends and masks on
position, so lane ``i`` attends exactly the history a sequential decode at
that position would. Acceptance (:func:`greedy_accept`) is host arithmetic
on the returned greedy tokens: the longest matching draft prefix plus the
first mismatch, which IS the true greedy token. Rejected lanes leave rows
only beyond the new frontier: position-masked, and overwritten by the
next step that reaches them.

At full occupancy there are no lanes and speculation degrades to plain
decode; every rejected lane is attended-width compute spent for nothing
(``obs.cost.serve_speculate_verify_flops`` prices it, and
``speculate_accepted_total / speculate_proposed_total`` is the measured
acceptance rate).
"""

from __future__ import annotations

import numpy as np

# Longest suffix n-gram tried for a lookup match, longest first: a 3-gram
# hit is stronger evidence of a repeating span than a 1-gram, and the
# cascade keeps the draft non-empty whenever any suffix token recurs.
NGRAM_MAX = 3

SPECULATE_METHODS = ("ngram", "prompt")


def propose_draft(context, k: int, *, method: str = "ngram",
                  prompt_len: int | None = None,
                  max_ngram: int = NGRAM_MAX) -> np.ndarray:
    """Up to ``k`` draft tokens continuing ``context`` (int32, the KNOWN
    tokens: prompt plus everything generated so far, the sampled but not
    yet fed last token included).

    For ``n = max_ngram .. 1``, the context's last ``n`` tokens are searched
    for their RIGHTMOST earlier occurrence in the match source (the whole
    context for ``"ngram"``, ``context[:prompt_len]`` for ``"prompt"``),
    and the tokens following the match become the draft, truncated to ``k``
    and to what the source holds. An empty array when nothing matches (the
    slot then decodes plainly). Deterministic: same context, same draft."""
    if k < 1:
        return np.zeros(0, np.int32)
    if method not in SPECULATE_METHODS:
        raise ValueError(f"unknown speculate method {method!r} "
                         f"(valid: {', '.join(SPECULATE_METHODS)})")
    ctx = np.asarray(context, np.int32)
    c = int(ctx.shape[0])
    if method == "prompt":
        if prompt_len is None:
            raise ValueError("method 'prompt' needs prompt_len")
        src = ctx[:prompt_len]
    else:
        src = ctx
    m = int(src.shape[0])
    for n in range(min(max_ngram, c - 1, m - 1), 0, -1):
        suffix = ctx[c - n:]
        # Rightmost earlier occurrence with at least one continuation token;
        # `j + n < c` keeps the suffix from matching itself.
        limit = min(m - n, c - n)
        for j in range(limit - 1, -1, -1):
            if np.array_equal(src[j:j + n], suffix):
                draft = src[j + n: j + n + k]
                if draft.size:
                    return np.asarray(draft, np.int32)
    return np.zeros(0, np.int32)


def greedy_accept(drafts, verified) -> int:
    """Longest accepted-draft prefix: ``drafts[i]`` is accepted iff it
    equals ``verified[i]``, the token the target model itself produced at
    that position (``verified`` has one MORE entry than ``drafts``: the
    speculating slot's own next token first, then one per lane)."""
    a = 0
    while a < len(drafts) and int(drafts[a]) == int(verified[a]):
        a += 1
    return a


__all__ = ["propose_draft", "greedy_accept", "NGRAM_MAX", "SPECULATE_METHODS"]
