"""Paged KV cache — a block allocator over a preallocated device pool,
ported from `deeplearning4j_tpu/serving/kv_cache.py`.

Layout (per layer, K and V each)::

    pages:  (num_pages, page_size, n_heads, head_dim)   f32 | int8
    scales: (num_pages, page_size, n_heads)             f32 (int8 only)

Position ``p`` of a request lives at row ``p % page_size`` of pool page
``table[p // page_size]``.  Page 0 is the scratch page idle decode slots
write to; the allocator hands out pages ``1..num_pages-1``.

The pools are device tensors owned by this object.  Where the JAX
package returns fresh arrays from every page write, the port writes the
pages IN PLACE with ``index_put_`` — no second copy of a pool ever
exists.  int8 pages use symmetric per-(position, head) scales
(`quantize_page_rows`), written once with their row and never rescaled.

Allocator state (free list, tables) is host state under one lock;
exhaustion raises `KVPoolExhausted`, which the engine turns into an
explicit 429, never a stall.  The fault site ``kv.alloc`` makes that
path provokable (``raise`` = injected exhaustion).  Speculative decode
adds best-effort overhang pages (`reserve_speculative`, never a 429)
that `truncate_to` and `release` give back.  Occupancy lands on
``dl4jtpu_kv_pages_used`` / ``dl4jtpu_kv_pages_total``, and every
failed allocation on ``dl4jtpu_serving_shed_total{reason="kv_exhausted"}``.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.runtime import faults
from deeplearning4j_tpu_torch.runtime.backend import resolve_device
from deeplearning4j_tpu_torch.runtime.flags import bucket_length

log = logging.getLogger("deeplearning4j_tpu_torch")

#: pool page 0 is the scratch page idle slots write to — never handed out
SCRATCH_PAGE = 0

#: page sizes are quantized to a multiple of this
PAGE_QUANTUM = 8


class KVPoolExhausted(RuntimeError):
    """The pool has no free page for this allocation."""


def quantize_page_rows(a):
    """int8 rows with per-row scales over the last (``head_dim``) axis:
    ``scale = max|row| / 127`` (an all-zero row gets 1.0), ``q =
    clip(round(a / scale), -127, 127)``.  ``torch.round`` rounds half to
    even, as ``jnp.round`` does.  Returns ``(q int8, scale f32)`` with
    ``dequant = q * scale[..., None]``."""
    a = a.float()
    amax = a.abs().amax(dim=-1)
    scale = torch.where(amax > 0.0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(a / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


class PagedKVCache:
    """Pool tensors + the block allocator for one transformer stack::

        kv = PagedKVCache(n_layers=2, n_heads=4, head_dim=32,
                          num_pages=256, page_size=16, device="cuda")
        pages = kv.alloc("req-1", n_pages=3)
        ...
        kv.release("req-1")
    """

    def __init__(self, n_layers: int, n_heads: int, head_dim: int,
                 num_pages: int, page_size: int, kv_dtype: str = "f32",
                 device=None):
        if kv_dtype not in ("f32", "int8"):
            raise ValueError(f"kv_dtype must be f32|int8, got {kv_dtype!r}")
        if num_pages < 2:
            raise ValueError("pool needs >= 2 pages (page 0 is scratch)")
        self.device = resolve_device(device)
        self.n_layers = int(n_layers)
        self.n_heads = int(n_heads)
        self.head_dim = int(head_dim)
        self.page_size = bucket_length(page_size, PAGE_QUANTUM)
        self.num_pages = int(num_pages)
        self.kv_dtype = kv_dtype
        shape = (self.n_layers, self.num_pages, self.page_size,
                 self.n_heads, self.head_dim)
        store = torch.int8 if kv_dtype == "int8" else torch.float32
        self.k_pages = torch.zeros(shape, dtype=store, device=self.device)
        self.v_pages = torch.zeros(shape, dtype=store, device=self.device)
        self.k_scales = self.v_scales = None
        if kv_dtype == "int8":
            # scale 1.0 everywhere: untouched rows dequantize to exact 0
            self.k_scales = torch.ones(shape[:-1], device=self.device)
            self.v_scales = torch.ones(shape[:-1], device=self.device)
        self._lock = threading.Lock()
        self._free: list[int] = list(range(self.num_pages - 1, 0, -1))
        self._tables: dict = {}
        self._spec_extra: dict = {}    # rid -> speculative overhang pages
        self._alloc_failures = 0
        self._gauge_total()
        self._gauge_used(0)

    # -- geometry ----------------------------------------------------------
    def pages_for(self, length: int) -> int:
        return max(1, -(-int(length) // self.page_size))

    def bytes_per_token(self) -> int:
        """Device bytes one position costs across layers and K+V."""
        elems = self.n_layers * 2 * self.n_heads * self.head_dim
        if self.kv_dtype == "int8":
            return elems + self.n_layers * 2 * self.n_heads * 4
        return elems * 4

    # -- allocation --------------------------------------------------------
    def alloc(self, rid, n_pages: int) -> list[int]:
        """Append ``n_pages`` pool pages to ``rid``'s table; raises
        `KVPoolExhausted` (and grants nothing) when the free list is
        short.  Fault site ``kv.alloc``: ``raise`` = injected
        exhaustion."""
        try:
            faults.maybe_fail("kv.alloc")
        except Exception as exc:
            self._count_failure()
            raise KVPoolExhausted(f"injected exhaustion: {exc}") from exc
        n_pages = int(n_pages)
        if n_pages < 0:
            raise ValueError("n_pages must be >= 0")
        with self._lock:
            if n_pages > len(self._free):
                self._alloc_failures += 1
                short = n_pages - len(self._free)
                used = self.num_pages - 1 - len(self._free)
                err = KVPoolExhausted(
                    f"kv pool exhausted: need {n_pages} page(s), "
                    f"{len(self._free)} free ({short} short; "
                    f"{used}/{self.num_pages - 1} in use)")
            else:
                got = [self._free.pop() for _ in range(n_pages)]
                self._tables.setdefault(rid, []).extend(got)
                used = self.num_pages - 1 - len(self._free)
                err = None
        if err is not None:
            self._count_failure()
            raise err
        self._gauge_used(used)
        return got

    def reserve_speculative(self, rid, length: int) -> list[int]:
        """Best-effort overhang for speculative decode: grow ``rid``'s
        table to cover ``length`` positions so draft K/V rows land in
        real pages.  A short free list is not an error here (the stream's
        admission is already funded): it returns ``[]`` without counting
        an allocation failure.  Returns the pages added."""
        with self._lock:
            have = len(self._tables.get(rid, ()))
            need = self.pages_for(length) - have
            if need <= 0 or need > len(self._free):
                return []
            got = [self._free.pop() for _ in range(need)]
            self._tables.setdefault(rid, []).extend(got)
            self._spec_extra[rid] = self._spec_extra.get(rid, 0) + len(got)
            used = self.num_pages - 1 - len(self._free)
        self._gauge_used(used)
        return got

    def truncate_to(self, rid, length: int) -> list[int]:
        """Free ``rid``'s tail pages beyond what ``length`` positions
        need (a stream whose drafter was disabled gives its overhang
        back).  Rows past ``length`` in the kept pages are masked by
        seq_len and overwritten as the stream grows.  Returns the freed
        pages."""
        keep = self.pages_for(length)
        with self._lock:
            pages = self._tables.get(rid)
            if not pages or len(pages) <= keep:
                return []
            freed = pages[keep:]
            del pages[keep:]
            self._free.extend(freed)
            self._spec_extra.pop(rid, None)
            used = self.num_pages - 1 - len(self._free)
        self._gauge_used(used)
        return freed

    def release(self, rid) -> int:
        """Free every page ``rid`` holds.  Idempotent."""
        with self._lock:
            pages = self._tables.pop(rid, None)
            self._spec_extra.pop(rid, None)
            if pages:
                self._free.extend(pages)
            used = self.num_pages - 1 - len(self._free)
        if pages:
            self._gauge_used(used)
        return len(pages or ())

    def table(self, rid) -> list[int]:
        with self._lock:
            return list(self._tables.get(rid, ()))

    # -- introspection -----------------------------------------------------
    @property
    def free_pages(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def used_pages(self) -> int:
        with self._lock:
            return self.num_pages - 1 - len(self._free)

    def occupancy(self) -> float:
        """Fraction of allocatable pages in use, in [0, 1] — the KV term
        of `InferenceServer.shed_pressure`."""
        with self._lock:
            return 1.0 - len(self._free) / max(1, self.num_pages - 1)

    def stats(self) -> dict:
        with self._lock:
            return {
                "num_pages": self.num_pages,
                "page_size": self.page_size,
                "kv_dtype": self.kv_dtype,
                "used_pages": self.num_pages - 1 - len(self._free),
                "free_pages": len(self._free),
                "requests": len(self._tables),
                "spec_reserved_pages": sum(self._spec_extra.values()),
                "alloc_failures": self._alloc_failures,
                "bytes_per_token": self.bytes_per_token(),
            }

    def leak_check(self) -> Optional[str]:
        """None when every non-scratch page is free or owned by exactly
        one table."""
        with self._lock:
            owned = [p for t in self._tables.values() for p in t]
            seen = set(owned)
            if len(seen) != len(owned):
                return "page owned by two tables"
            if seen & set(self._free):
                return "page both free and owned"
            if SCRATCH_PAGE in seen:
                return "scratch page handed out"
            total = len(self._free) + len(owned)
            if total != self.num_pages - 1:
                return (f"{self.num_pages - 1 - total} page(s) leaked "
                        f"({len(self._free)} free + {len(owned)} owned)")
        return None

    # -- device-side page writes (in place) ---------------------------------
    def write_rows(self, layer: int, page_of, row_of, k, v) -> None:
        """Write one K and one V row per entry of ``page_of``/``row_of``
        into ``layer``'s pools (the decode step's append).  k, v:
        (N, n_heads, head_dim)."""
        idx = (page_of, row_of)
        if self.kv_dtype == "int8":
            kq, ks = quantize_page_rows(k)
            vq, vs = quantize_page_rows(v)
            self.k_pages[layer].index_put_(idx, kq)
            self.v_pages[layer].index_put_(idx, vq)
            self.k_scales[layer].index_put_(idx, ks)
            self.v_scales[layer].index_put_(idx, vs)
        else:
            self.k_pages[layer].index_put_(idx, k.float())
            self.v_pages[layer].index_put_(idx, v.float())

    def write_prefill(self, rid, k, v) -> np.ndarray:
        """Write a prompt's K/V rows into ``rid``'s pages.  ``k``/``v``:
        (n_layers, T, n_heads, head_dim) with T a multiple of
        ``page_size``.  Returns the page table as int32."""
        pages = self.table(rid)
        t = int(k.shape[1])
        n = t // self.page_size
        if t % self.page_size or n > len(pages):
            raise ValueError(f"prefill length {t} does not fit {len(pages)} "
                             f"page(s) of {self.page_size}")
        idx = torch.as_tensor(pages[:n], dtype=torch.int64, device=self.device)
        layers = torch.arange(self.n_layers, device=self.device)[:, None]
        ix = (layers, idx[None, :])
        shape = (self.n_layers, n, self.page_size, self.n_heads, self.head_dim)
        k = torch.as_tensor(k, device=self.device)
        v = torch.as_tensor(v, device=self.device)
        if self.kv_dtype == "int8":
            kq, ks = quantize_page_rows(k)
            vq, vs = quantize_page_rows(v)
            self.k_pages.index_put_(ix, kq.reshape(shape))
            self.v_pages.index_put_(ix, vq.reshape(shape))
            self.k_scales.index_put_(ix, ks.reshape(shape[:-1]))
            self.v_scales.index_put_(ix, vs.reshape(shape[:-1]))
        else:
            self.k_pages.index_put_(ix, k.float().reshape(shape))
            self.v_pages.index_put_(ix, v.float().reshape(shape))
        return np.asarray(pages, np.int32)

    # -- telemetry (never on the allocation's critical path) ---------------
    def _count_failure(self) -> None:
        try:
            from deeplearning4j_tpu_torch.observe.metrics import registry

            registry().counter("dl4jtpu_serving_shed_total").inc(
                reason="kv_exhausted")
        except Exception as e:
            log.debug("kv alloc-failure metric failed: %s", e)

    def _gauge_total(self) -> None:
        try:
            from deeplearning4j_tpu_torch.observe.metrics import registry

            registry().gauge("dl4jtpu_kv_pages_total").set(self.num_pages - 1)
        except Exception as e:
            log.debug("kv total gauge failed: %s", e)

    def _gauge_used(self, used: int) -> None:
        try:
            from deeplearning4j_tpu_torch.observe.metrics import registry

            registry().gauge("dl4jtpu_kv_pages_used").set(used)
        except Exception as e:
            log.debug("kv used gauge failed: %s", e)
