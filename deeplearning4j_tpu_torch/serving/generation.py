"""Token-level continuous-batching generation serving — the engine of
`deeplearning4j_tpu/serving/generation.py` in eager PyTorch.

- **one decode step, fixed slot batch** — `GenerationEngine` advances
  ``slots`` sequences one token per step; requests join and leave the
  running batch between steps, never inside one.
- **paged KV** — K/V live in `serving/kv_cache.py` pool pages indexed by
  per-slot page tables; `ops/paged_attention.py` attends one query row
  per slot against them (the paged-attention kernel on CUDA).  An idle
  slot points its whole table at the scratch page and carries seq_len 0.
- **bucketed prefill** — the prompt is padded to a `flags.bucket_length`
  bucket (quantum = a page-size multiple, so prompt K/V lands page
  aligned), runs one dense forward (the flash-forward kernel on CUDA),
  emits the first token (the TTFT moment) and hands its K/V rows to the
  pool.  Prefill returns K/V in f32 whatever the compute dtype, and the
  decode step casts q to f32 before attention, so pages stay f32 (or
  int8) under bf16 compute — as in the JAX engine.
- **the ladder** — admission is a bounded queue (429 when full) and
  KV-pool exhaustion is an explicit ``kv_exhausted`` 429.

Numerics: greedy decode is token-identical to `ops.generation.generate`
at f32 on the CPU (same per-position math), and sampled streams draw on
the same ``(seed, g)`` schedule with the JAX engine's random bits, so a
stream's tokens do not depend on its slot or its neighbours.  Not ported
yet: speculative decoding, the step watchdog, the flight recorder,
tracing and SLO counters, and the ``server=`` / hot-swap attachment.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.ops.generation import (
    _block_prefill,
    _head_logits,
    _ln,
    _pe_rows,
    _plan,
    _sample,
)
from deeplearning4j_tpu_torch.ops.paged_attention import paged_attention
from deeplearning4j_tpu_torch.runtime.flags import bucket_length
from deeplearning4j_tpu_torch.serving.admission import (
    AdmissionQueue,
    ServingError,
    ServingRejected,
    ServingTimeout,
)
from deeplearning4j_tpu_torch.serving.kv_cache import (
    SCRATCH_PAGE,
    KVPoolExhausted,
    PagedKVCache,
)

log = logging.getLogger("deeplearning4j_tpu_torch")


@dataclass
class GenerationConfig:
    """Engine knobs.  ``page_size * max_pages_per_seq`` bounds a stream's
    total length (prompt bucket plus generated tokens)."""

    slots: int = 8                 # decode batch width
    page_size: int = 16            # KV page rows
    num_pages: int = 128           # pool size (page 0 is scratch)
    max_pages_per_seq: int = 8     # page-table width
    kv_dtype: str = "f32"          # f32 | int8 pages
    prefill_quantum: Optional[int] = None   # default: page_size
    max_queue: int = 128
    default_max_new: int = 32
    poll_s: float = 0.02           # idle-queue poll granularity


class GenerationRequest:
    """One admitted stream.  The client waits on `result()`."""

    _next = [0]
    _next_lock = threading.Lock()

    def __init__(self, prompt, max_new: int, *, temperature: float = 0.0,
                 top_k: int = 0, seed: int = 0, stop_tokens: tuple = (),
                 on_token=None):
        with GenerationRequest._next_lock:
            GenerationRequest._next[0] += 1
            self.rid = f"gen-{GenerationRequest._next[0]}"
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.max_new = int(max_new)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.seed = int(seed)
        self.stop_tokens = tuple(int(t) for t in stop_tokens)
        self.on_token = on_token
        self.tokens: list[int] = []
        self.error: Optional[BaseException] = None
        self.cancelled = False
        self.signature = ("generate",)     # AdmissionQueue grouping key
        self.seq = 0
        self.t_submit = time.perf_counter()
        self.ttft_s: Optional[float] = None
        self.outcome: Optional[str] = None
        self._event = threading.Event()
        self._lock = threading.Lock()

    def _record(self, token: int) -> None:
        with self._lock:
            if self.ttft_s is None:
                self.ttft_s = time.perf_counter() - self.t_submit
            self.tokens.append(int(token))
            idx = len(self.tokens) - 1
        if self.on_token is not None:
            try:
                self.on_token(int(token), idx)
            except Exception:
                log.exception("on_token callback raised")

    def tokens_so_far(self) -> list[int]:
        with self._lock:
            return list(self.tokens)

    @property
    def done(self) -> bool:
        return self._event.is_set()

    def cancel(self) -> None:
        self.cancelled = True

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block for completion; returns prompt + generated tokens."""
        if not self._event.wait(timeout):
            self.cancelled = True
            raise ServingTimeout(
                f"generation {self.rid} incomplete after {timeout}s")
        if self.error is not None:
            raise self.error
        return np.concatenate(
            [self.prompt, np.asarray(self.tokens_so_far(), np.int32)])


def _sample_token(logits, temp: float, top_k: int, seed: int, g: int) -> int:
    """`ops.generation._sample` for one (V,) logits row with this
    stream's parameters; ``g`` is the index of the token generated.  The
    (1, V) noise is the JAX engine's (V,) noise: threefry's partitionable
    layout numbers the elements the same way in both shapes."""
    return int(_sample(logits[None], temperature=temp, top_k=top_k,
                       seed=seed, g=g)[0])


class GenerationEngine:
    """Continuous-batching decode engine over a paged KV pool::

        engine = GenerationEngine(model, GenerationConfig()).start()
        req = engine.submit(prompt_ids, max_new_tokens=32)
        out = req.result(timeout=30)        # prompt + generated tokens
        engine.stop()

    Runs on the model's device; the decode loop is one background
    thread that owns every device call after `start`.
    """

    def __init__(self, model, config: Optional[GenerationConfig] = None):
        if model.params is None:
            model.init()
        self.model = model
        self.device = model.device
        self.config = cfg = config or GenerationConfig()
        embed, pos, blocks, head = _plan(model)
        self._stack = (embed, pos, tuple(blocks), head)
        names = [l.name for l in model.conf.layers]
        self._embed_name, self._head_name = names[0], names[-1]
        self._pos_name = pos.name if pos is not None else None
        self._d = embed.n_out
        self._n_heads = blocks[0].n_heads
        self._head_dim = blocks[0].d_model // blocks[0].n_heads

        self.kv = PagedKVCache(
            n_layers=len(blocks), n_heads=self._n_heads,
            head_dim=self._head_dim, num_pages=cfg.num_pages,
            page_size=cfg.page_size, kv_dtype=cfg.kv_dtype,
            device=self.device,
        )
        self._quantum = cfg.prefill_quantum or self.kv.page_size
        if self._quantum % self.kv.page_size:
            raise ValueError(
                f"prefill_quantum {self._quantum} must be a multiple of the "
                f"page size {self.kv.page_size} (prompt KV must land "
                "page-aligned)")

        s, mp = cfg.slots, cfg.max_pages_per_seq
        # host slot state; a step reads copies, so changing it BETWEEN
        # steps is the continuous-batching join
        self._page_tbl = np.full((s, mp), SCRATCH_PAGE, np.int32)
        self._seq_lens = np.zeros(s, np.int32)
        self._last_tok = np.zeros(s, np.int32)
        self._gen_counts = np.zeros(s, np.int32)
        self._temps = np.zeros(s, np.float32)
        self._top_ks = np.zeros(s, np.int32)
        self._seeds = np.zeros(s, np.int64)
        self._slot_req: list[Optional[GenerationRequest]] = [None] * s

        self.queue = AdmissionQueue(cfg.max_queue)
        self._mu = threading.Lock()        # slot state + loop generation
        self._stop = threading.Event()
        self._loop_gen = 0
        self._thread: Optional[threading.Thread] = None
        self._steps = 0
        self._tokens_out = 0
        self._prefills = 0
        self._prefill_s = 0.0          # wall seconds in prefill (host clock)
        self._decode_s = 0.0           # wall seconds in decode steps
        self._stats_lock = threading.Lock()
        self._outcomes: dict[str, int] = {}

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "GenerationEngine":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        with self._mu:
            self._loop_gen += 1
            gen = self._loop_gen
        self._thread = threading.Thread(
            target=self._loop, args=(gen,), name="dl4j-torch-generation",
            daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 30.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
        for req in self.queue.drain():
            self._finish(req, "shutdown",
                         ServingRejected("shutdown", "engine stopped"))
        with self._mu:
            self._fail_active_locked(
                ServingRejected("shutdown", "engine stopped"),
                outcome="shutdown")

    # -- admission ---------------------------------------------------------
    def submit(self, prompt, max_new_tokens: Optional[int] = None, *,
               temperature: float = 0.0, top_k: int = 0, seed: int = 0,
               stop_tokens: tuple = (), on_token=None) -> GenerationRequest:
        """Admit one stream.  Raises `ServingRejected` on a full queue;
        a stream longer than the page table holds is a `ValueError`."""
        max_new = int(max_new_tokens if max_new_tokens is not None
                      else self.config.default_max_new)
        req = GenerationRequest(
            prompt, max_new, temperature=temperature, top_k=top_k,
            seed=seed, stop_tokens=stop_tokens, on_token=on_token)
        self._validate(req)
        if not self.queue.offer(req):
            self._count_outcome("queue_full")
            raise ServingRejected(
                "queue_full",
                f"generation queue at capacity ({self.queue.max_queue})")
        return req

    def _validate(self, req: GenerationRequest) -> None:
        t_p = req.prompt.shape[0]
        if t_p < 1:
            raise ValueError("empty prompt")
        if req.max_new < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if req.prompt.min() < 0 or req.prompt.max() >= self._vocab():
            raise ValueError(f"prompt ids must lie in [0, {self._vocab()})")
        span = max(bucket_length(t_p, self._quantum), t_p + req.max_new)
        if self.kv.pages_for(span) > self.config.max_pages_per_seq:
            cap = self.config.max_pages_per_seq * self.kv.page_size
            raise ValueError(
                f"stream needs {span} KV positions; the page table holds "
                f"{cap} (max_pages_per_seq x page_size)")
        _, pos, _, _ = self._stack
        if pos is not None and pos.learned and span > pos.max_length:
            raise ValueError(
                f"stream needs {span} positions; learned PositionalEncoding "
                f"max_length is {pos.max_length}")

    def _vocab(self) -> int:
        return self._stack[0].n_in

    def generate(self, prompt, max_new_tokens: int, *,
                 temperature: float = 0.0, top_k: int = 0, seed: int = 0,
                 stop_tokens: tuple = (),
                 timeout: Optional[float] = 120.0) -> np.ndarray:
        """Submit one stream, wait, return prompt + generated tokens."""
        return self.submit(
            prompt, max_new_tokens, temperature=temperature, top_k=top_k,
            seed=seed, stop_tokens=stop_tokens).result(timeout)

    # -- device programs ---------------------------------------------------
    @torch.no_grad()
    def _prefill(self, prompt_pad, prompt_len: int, req: GenerationRequest):
        """Bucketed prompt forward; returns (k, v, first_token) with k, v
        (n_layers, t_bucket, H, Dh) f32.  Rows past ``prompt_len`` are
        padding: causal attention keeps them out of every earlier row,
        and their K/V rows sit past seq_len (masked at decode, then
        overwritten as the stream grows into them)."""
        embed, pos, blocks, head = self._stack
        params = self.model.compute_params()
        x = embed._act()(params[self._embed_name]["W"][prompt_pad])
        if pos is not None:
            x = pos.apply(params.get(self._pos_name, {}), x)
        ks, vs = [], []
        for cfg_b in blocks:
            x, k, v = _block_prefill(cfg_b, params[cfg_b.name], x, None)
            ks.append(k[0])
            vs.append(v[0])
        # (1, D) @ W: the same product shape as the dense reference's
        logits = _head_logits(head, params[self._head_name],
                              x[:, prompt_len - 1])[0]
        first = _sample_token(logits, req.temperature, req.top_k, req.seed, 0)
        return torch.stack(ks).float(), torch.stack(vs).float(), first

    def _run_prefill(self, req: GenerationRequest):
        # the JAX engine holds seeds as uint32 and converts this one
        # inside its prefill ``try``: outside [0, 2^32) the stream ends
        # there, as a prefill error
        if not 0 <= req.seed < 2**32:
            raise OverflowError(
                f"Python integer {req.seed} out of bounds for uint32")
        t_p = req.prompt.shape[0]
        t_b = bucket_length(t_p, self._quantum)
        pad = np.zeros((1, t_b), np.int64)
        pad[0, :t_p] = req.prompt
        return self._prefill(torch.from_numpy(pad).to(self.device), t_p, req)

    @torch.no_grad()
    def _step(self, page_tbl, seq_lens, last_tok, seeds, gen_counts, temps,
              top_ks) -> np.ndarray:
        """One token for every slot; the pools are appended in place.
        Arguments are host copies of the slot state."""
        embed, pos, blocks, head = self._stack
        params = self.model.compute_params()
        dev, n_slots = self.device, self.config.slots
        h_, dh, ps = self._n_heads, self._head_dim, self.kv.page_size
        quant = self.kv.kv_dtype == "int8"
        active = seq_lens > 0
        page_of = page_tbl[np.arange(n_slots), seq_lens // ps]
        host = np.stack([seq_lens, seq_lens + 1, page_of, seq_lens % ps,
                         last_tok]).astype(np.int32)
        pos_idx, attend, page_of, row_of, tok = torch.from_numpy(host).to(dev)
        tbl = torch.from_numpy(page_tbl).to(dev)
        E = params[self._embed_name]["W"]
        x_t = embed._act()(E[tok.long()])
        x_t = x_t + _pe_rows(pos, params.get(self._pos_name, {}), pos_idx,
                             self._d).to(x_t.dtype)
        idx = (page_of.long(), row_of.long())
        for li, cfg_b in enumerate(blocks):
            lp = params[cfg_b.name]
            ap = lp["attn"]
            hh = _ln(lp["ln1"], x_t)
            q = (hh @ ap["Wq"]).reshape(n_slots, h_, dh)
            k_t = (hh @ ap["Wk"]).reshape(n_slots, h_, dh)
            v_t = (hh @ ap["Wv"]).reshape(n_slots, h_, dh)
            self.kv.write_rows(li, *idx, k_t, v_t)
            attn = paged_attention(
                q.float().contiguous(), self.kv.k_pages[li],
                self.kv.v_pages[li], tbl, attend,
                k_scale=self.kv.k_scales[li] if quant else None,
                v_scale=self.kv.v_scales[li] if quant else None)
            x_t = x_t + attn.reshape(n_slots, h_ * dh).to(x_t.dtype) @ ap["Wo"]
            hh = _ln(lp["ln2"], x_t)
            hh = cfg_b.ffn_activation(hh @ lp["W1"] + lp["b1"])
            x_t = x_t + (hh @ lp["W2"] + lp["b2"])
        logits = _head_logits(head, params[self._head_name], x_t).float()
        nxt = torch.argmax(logits, dim=-1).cpu().numpy().astype(np.int32)
        for s in np.flatnonzero(active & (temps > 0.0)):
            nxt[s] = _sample_token(logits[s], float(temps[s]), int(top_ks[s]),
                                   int(seeds[s]), int(gen_counts[s]))
        return np.where(active, nxt, 0)

    # -- the decode loop ---------------------------------------------------
    def _loop(self, my_gen: int) -> None:
        try:
            while not self._stop.is_set():
                with self._mu:
                    if self._loop_gen != my_gen:
                        return
                    n_active = sum(r is not None for r in self._slot_req)
                self._refill(my_gen, block=(n_active == 0))
                with self._mu:
                    n_active = sum(r is not None for r in self._slot_req)
                if n_active:
                    self._decode_step(my_gen)
        except Exception as exc:                      # never die silently
            log.exception("generation loop died")
            with self._mu:
                if self._loop_gen == my_gen:
                    self._fail_active_locked(
                        ServingError(f"generation loop died: {exc}"))

    def _free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self._slot_req) if r is None]

    def _refill(self, my_gen: int, block: bool) -> None:
        """Admit queued streams into free slots, strictly between steps."""
        free = self._free_slots()
        if not free or (self.queue.depth == 0 and not block):
            return
        batch = self.queue.take_batch(len(free), linger_s=0.0,
                                      stop=self._stop,
                                      poll_s=self.config.poll_s)
        for req in batch:
            if req.cancelled:
                self._finish(req, "cancelled",
                             ServingRejected("shutdown", "cancelled"))
                continue
            slot = self._free_slots()
            if not slot:
                if not self.queue.offer(req):
                    self._finish(req, "queue_full",
                                 ServingRejected("queue_full", "requeue failed"))
                continue
            self._admit_to_slot(my_gen, slot[0], req)

    def _admit_to_slot(self, my_gen: int, slot: int,
                       req: GenerationRequest) -> None:
        t_p = req.prompt.shape[0]
        span = max(bucket_length(t_p, self._quantum), t_p + req.max_new)
        try:
            self.kv.alloc(req.rid, self.kv.pages_for(span))
        except KVPoolExhausted as exc:
            self._finish(req, "kv_exhausted",
                         ServingRejected("kv_exhausted", str(exc)))
            return
        try:
            t0 = time.perf_counter()
            k, v, first = self._run_prefill(req)
            tbl = self.kv.write_prefill(req.rid, k, v)
            with self._stats_lock:
                self._prefills += 1
                self._prefill_s += time.perf_counter() - t0
        except Exception as exc:
            log.exception("prefill failed")
            self.kv.release(req.rid)
            self._finish(req, "error", ServingError(f"prefill failed: {exc}"))
            return
        req._record(first)
        self._count_tokens(1)
        if req.max_new <= 1 or first in req.stop_tokens:
            self.kv.release(req.rid)
            self._finish(req, "ok")
            return
        with self._mu:
            if self._loop_gen != my_gen:
                self.kv.release(req.rid)
                self._finish(req, "error",
                             ServingError("engine restarted during admit"))
                return
            row = np.full(self.config.max_pages_per_seq, SCRATCH_PAGE, np.int32)
            row[: len(tbl)] = tbl
            self._page_tbl[slot] = row
            self._seq_lens[slot] = t_p
            self._last_tok[slot] = first
            self._gen_counts[slot] = 1
            self._temps[slot] = req.temperature
            self._top_ks[slot] = req.top_k
            self._seeds[slot] = req.seed
            self._slot_req[slot] = req

    def _decode_step(self, my_gen: int) -> None:
        """One token for every live slot, then harvest: stop conditions,
        page release, slot free."""
        with self._mu:
            if self._loop_gen != my_gen:
                return
            args = (self._page_tbl.copy(), self._seq_lens.copy(),
                    self._last_tok.copy(), self._seeds.copy(),
                    self._gen_counts.copy(), self._temps.copy(),
                    self._top_ks.copy())
        self._steps += 1
        t0 = time.perf_counter()
        try:
            nxt = self._step(*args)
        except Exception as exc:
            log.exception("generation decode step failed")
            with self._mu:
                if self._loop_gen == my_gen:
                    self._fail_active_locked(
                        ServingError(f"decode step failed: {exc}"))
            return
        with self._stats_lock:
            self._decode_s += time.perf_counter() - t0
        finished: list[tuple[GenerationRequest, bool]] = []
        n_live = 0
        with self._mu:
            if self._loop_gen != my_gen:
                return
            for s, req in enumerate(self._slot_req):
                if req is None:
                    continue
                if req.cancelled:
                    self._clear_slot(s)
                    finished.append((req, False))
                    continue
                n_live += 1
                tok = int(nxt[s])
                req._record(tok)
                self._seq_lens[s] += 1
                self._gen_counts[s] += 1
                self._last_tok[s] = tok
                if self._gen_counts[s] >= req.max_new or tok in req.stop_tokens:
                    self._clear_slot(s)
                    finished.append((req, True))
        self._count_tokens(n_live)
        for req, ok in finished:
            self.kv.release(req.rid)
            if ok:
                self._finish(req, "ok")
            else:
                self._finish(req, "cancelled",
                             ServingRejected("shutdown", "cancelled"))

    def _clear_slot(self, s: int) -> None:
        """Caller holds self._mu; the caller releases the pages."""
        self._slot_req[s] = None
        self._page_tbl[s, :] = SCRATCH_PAGE
        self._seq_lens[s] = 0
        self._last_tok[s] = 0
        self._gen_counts[s] = 0
        self._temps[s] = 0.0
        self._top_ks[s] = 0
        self._seeds[s] = 0

    def _fail_active_locked(self, exc: BaseException,
                            outcome: str = "error") -> None:
        """Caller holds self._mu: fail every in-flight stream and release
        all of their pages."""
        for s, req in enumerate(self._slot_req):
            if req is None:
                continue
            self._clear_slot(s)
            self.kv.release(req.rid)
            self._finish(req, outcome, exc)

    def _finish(self, req: GenerationRequest, outcome: str,
                exc: Optional[BaseException] = None) -> None:
        """Settle one stream exactly once."""
        with req._lock:
            if req.outcome is not None:
                return
            req.outcome = outcome
        self._count_outcome(outcome)
        if exc is not None:
            req.error = exc
        req._event.set()

    # -- introspection -----------------------------------------------------
    def active_streams(self) -> int:
        with self._mu:
            return sum(r is not None for r in self._slot_req)

    def drain(self, timeout: float = 30.0) -> bool:
        """True when no stream is in flight and the queue is empty
        within ``timeout``."""
        t_end = time.monotonic() + timeout
        while time.monotonic() < t_end:
            if self.active_streams() == 0 and self.queue.depth == 0:
                return True
            time.sleep(self.config.poll_s)
        return False

    def stats(self) -> dict:
        with self._stats_lock:
            outcomes = dict(self._outcomes)
        return {
            "slots": self.config.slots,
            "active_streams": self.active_streams(),
            "queue_depth": self.queue.depth,
            "decode_steps": self._steps,
            "decode_seconds": self._decode_s,
            "prefills": self._prefills,
            "prefill_seconds": self._prefill_s,
            "tokens_generated": self._tokens_out,
            "outcomes": outcomes,
            "kv": self.kv.stats(),
        }

    def _count_tokens(self, n: int) -> None:
        if n <= 0:
            return
        with self._stats_lock:
            self._tokens_out += n

    def _count_outcome(self, outcome: str) -> None:
        with self._stats_lock:
            self._outcomes[outcome] = self._outcomes.get(outcome, 0) + 1
