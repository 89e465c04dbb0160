"""Speculative-decoding draft sources — `deeplearning4j_tpu/serving/speculative.py`
in PyTorch.

Plain continuous-batching decode advances every stream one token per
dispatch.  A cheap drafter proposes ``k`` tokens per stream, the engine
scores all of them (plus one bonus position) in one verify-once forward
over the paged KV cache (`ops.paged_attention.paged_attention_chunk`),
and emits the accepted prefix plus the target model's own sample at the
first mismatch, so the output is the plain engine's token for token.

`DraftSource` is the contract (``draft(history, k) -> up to k proposed
tokens``), with two implementations:

- `NGramDrafter` (default, ``"ngram"``) — prompt lookup: the longest
  n-gram suffix of the stream's history is matched against its most
  recent earlier occurrence and the tokens that followed it are
  proposed.  Pure host numpy; the JAX package's drafts, bit for bit.
- `ModelDrafter` (``"model"``) — a small zoo model decodes ``k`` tokens
  greedily, one bucketed full forward per draft token (no KV cache of
  its own), under ``torch.no_grad`` on the draft model's device; on CUDA
  each forward's attention is the flash-forward kernel, and a quantized
  draft model's products are the dequant-matmul kernel.  Greedy drafting
  is deterministic.

Drafts are proposals, never outputs: a drafter returning garbage (the
``serving.draft`` fault site's ``corrupt`` kind) costs acceptance, never
correctness.

Knobs: ``DL4J_TPU_SPEC_K`` (draft length; 0 disables) and
``DL4J_TPU_SPEC_DRAFTER`` (``ngram`` | ``model``), the JAX package's
names, overridden by `GenerationConfig` fields and per request.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from deeplearning4j_tpu_torch.ops.generation import (
    _block_prefill,
    _embed,
    _head_logits,
    _plan,
)
from deeplearning4j_tpu_torch.runtime.flags import bucket_length

log = logging.getLogger("deeplearning4j_tpu_torch")

ENV_SPEC_K = "DL4J_TPU_SPEC_K"
ENV_SPEC_DRAFTER = "DL4J_TPU_SPEC_DRAFTER"

DRAFTER_NAMES = ("ngram", "model")

_EMPTY = np.zeros(0, np.int32)


class DraftSource:
    """The drafter contract: ``draft(history, k)`` returns up to ``k``
    proposed continuation tokens (int32, possibly empty) for a stream
    whose whole history (prompt and every token generated so far) is
    ``history``.  Deterministic for a given history; called from the
    engine thread between dispatches."""

    name = "none"

    def draft(self, history: np.ndarray, k: int) -> np.ndarray:
        raise NotImplementedError


class NGramDrafter(DraftSource):
    """Prompt lookup: find an earlier occurrence of the longest n-gram
    suffix of the history and propose the tokens that followed it,
    preferring the most recent occurrence that still has a full k-token
    continuation."""

    name = "ngram"

    def __init__(self, max_n: int = 3, min_n: int = 1):
        if min_n < 1 or max_n < min_n:
            raise ValueError(f"need 1 <= min_n <= max_n, got "
                             f"[{min_n}, {max_n}]")
        self.max_n = int(max_n)
        self.min_n = int(min_n)

    def draft(self, history: np.ndarray, k: int) -> np.ndarray:
        h = np.asarray(history, np.int32).reshape(-1)
        n_hist = h.shape[0]
        if k <= 0 or n_hist < 2:
            return _EMPTY
        for n in range(min(self.max_n, n_hist - 1), self.min_n - 1, -1):
            suffix = h[n_hist - n:]
            # windows over h[:-1]: the suffix's own occurrence is
            # excluded, every earlier one is a candidate
            win = np.lib.stride_tricks.sliding_window_view(h[:-1], n)
            hits = np.nonzero((win == suffix).all(axis=1))[0]
            if hits.size:
                # the most recent occurrence with a full k-token
                # continuation (one against the end of the history would
                # propose a truncated draft)
                full = hits[hits + n + k <= n_hist]
                i = int(full[-1] if full.size else hits[-1])
                return h[i + n: i + n + k].copy()
        return _EMPTY


class ModelDrafter(DraftSource):
    """Two-model drafting: a small zoo model greedily decodes ``k``
    tokens from the history, one full forward of the history padded to
    its `flags.bucket_length` bucket per draft token."""

    name = "model"

    def __init__(self, model, quantum: int = 16):
        if model.params is None:
            model.init()
        self.model = model
        self._quantum = int(quantum)
        embed, pos, blocks, head = _plan(model)
        self._stack = (embed, pos, tuple(blocks), head)
        names = [l.name for l in model.conf.layers]
        self._embed_name, self._head_name = names[0], names[-1]
        self._pos_name = pos.name if pos is not None else None

    @torch.no_grad()
    def _last_greedy(self, toks_pad, true_len: int) -> int:
        """Greedy next token after the first ``true_len`` ids of the
        (1, t_bucket) ``toks_pad``; pad rows sit after the last real one,
        so causal attention keeps them out of it."""
        embed, pos, blocks, head = self._stack
        params = self.model.compute_params()
        with self.model.program_run("draft", tuple(toks_pad.shape)):
            x = _embed(embed, params[self._embed_name], toks_pad)
            if pos is not None:
                x = pos.apply(params.get(self._pos_name, {}), {}, x)[0]
            for cfg_b in blocks:
                x, _, _ = _block_prefill(cfg_b, params[cfg_b.name], x, None)
            logits = _head_logits(head, params[self._head_name],
                                  x[0, true_len - 1])
        return int(torch.argmax(logits.float()))

    def draft(self, history: np.ndarray, k: int) -> np.ndarray:
        toks = np.asarray(history, np.int32).reshape(-1)
        if k <= 0 or toks.shape[0] < 1:
            return _EMPTY
        _, pos, _, _ = self._stack
        if (pos is not None and pos.learned
                and toks.shape[0] + k > pos.max_length):
            return _EMPTY                 # would overflow the draft PE
        out = []
        for _ in range(k):
            n = toks.shape[0]
            pad = np.zeros((1, bucket_length(n, self._quantum)), np.int64)
            pad[0, :n] = toks
            nxt = self._last_greedy(torch.from_numpy(pad).to(self.model.device), n)
            out.append(nxt)
            toks = np.append(toks, np.int32(nxt))
        return np.asarray(out, np.int32)


def make_drafter(name: str, *, draft_model=None) -> DraftSource:
    """Resolve a drafter by knob value (`DL4J_TPU_SPEC_DRAFTER` /
    `GenerationConfig.spec_drafter`)."""
    name = (name or "ngram").strip().lower()
    if name in ("ngram", "prompt_lookup", "lookup"):
        return NGramDrafter()
    if name == "model":
        if draft_model is None:
            raise ValueError(
                "drafter 'model' needs a draft model "
                "(GenerationConfig.spec_draft_model)")
        return ModelDrafter(draft_model)
    raise ValueError(f"unknown drafter {name!r} (one of {DRAFTER_NAMES})")


def spec_k_from_env(default: int = 0) -> int:
    """`DL4J_TPU_SPEC_K` as an int (0 = speculative decode off)."""
    raw = os.environ.get(ENV_SPEC_K, "").strip()
    if not raw:
        return default
    try:
        k = int(raw)
    except ValueError:
        log.warning("bad %s=%r (want an int); speculative decode off",
                    ENV_SPEC_K, raw)
        return default
    return max(0, k)


def drafter_from_env(default: str = "ngram") -> str:
    return os.environ.get(ENV_SPEC_DRAFTER, "").strip().lower() or default
