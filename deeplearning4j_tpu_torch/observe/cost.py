"""Performance attribution — what did the device DO with the step time?
The port's copy of `deeplearning4j_tpu/observe/cost.py`.

Three pieces, as in the JAX package:

- a process-global **program registry**: `SequentialModel.fit_batch`
  registers its step program (loss and gradients) through
  `register_step_program`.  The registration wrapper captures, on the
  program's FIRST dispatch, its input signature and the compile-tax
  delta (`runtime/compile_stats.py`) that dispatch paid.
- **cost analysis**, computed LAZILY and only on demand (`analyze_model`,
  `program_table`, tests, `chip_smoke.py`).  There is no XLA
  ``cost_analysis`` to ask: the analysis runs the program once more on
  placeholder inputs of the captured signature (zeros of each shape and
  dtype, on the same device) under a counting scope, in which
    * every torch op is counted with the FLOP formulas of
      ``torch.utils.flop_counter.FlopCounterMode`` (its ``flop_registry``:
      matmuls, convolutions, attention; elementwise ops count none) and
      with its bytes — its tensor operands read and its results written
      once, views and ``empty`` left out;
    * every launch of a hand-written kernel (B1-B5) is counted from its
      shapes by the kernel's own ``*_work`` function
      (`runtime/kernels.py` `kernel_call`): a ctypes launch is no torch
      op.  The torch ops a wrapper runs itself (its plain version on the
      CPU) stay out of the count, so a program counts the same on both
      devices.
  ``memory=True`` adds the run's argument, output and peak bytes (the
  caching allocator's peak on the card).  A failure is recorded as a
  reason, never raised into training.
- **dispatch-free analysis** (`analyze_signature`): the planner's
  pricing of a step program before anything ran, from an abstract
  signature, on fake tensors (no device work, no kernel launch);
- **MFU / roofline accounting**: once a program's FLOPs are known, every
  `StepScope` exit derives achieved FLOP/s, MFU against the peak table
  below (``DL4J_TPU_PEAK_FLOPS`` / ``DL4J_TPU_PEAK_MEMBW`` override),
  bytes/s against peak memory bandwidth, and a compute- vs memory-bound
  class — pushed to the ``dl4jtpu_step_*`` gauges and stamped onto the
  ``train_step`` span as ``roofline=``.  The scope's time is the host's
  wall around the step, which waits for the card only where the step
  reads a value back (or tracing syncs it).

Nothing here costs the hot path more than two attribute reads until an
analysis is requested; until then the gauges simply stay unset.

    from deeplearning4j_tpu_torch.observe import cost
    model.fit_batch(batch)                # program registered + dispatched
    for rec in cost.analyze_model(model):
        print(rec.kind, rec.flops, rec.roofline())
"""

from __future__ import annotations

import logging
import os
import threading
import time
import weakref
from typing import Any, Callable, Optional

log = logging.getLogger("deeplearning4j_tpu_torch")

# -- per-device peak table --------------------------------------------------
#
# (dense peak FLOP/s, peak memory bytes/s) PER DEVICE, keyed by
# ``torch.cuda.get_device_name``.  The H100 row is NVIDIA's data sheet
# (SXM, bf16 dense, at the 700 W limit; the port's f32 products run on
# the same tensor cores through bf16 parts).  The CPU row is a
# deliberately rough nominal so CPU MFU reads as an indicative ratio, not
# a hardware claim — override with DL4J_TPU_PEAK_FLOPS /
# DL4J_TPU_PEAK_MEMBW.
PEAKS_BY_DEVICE_KIND = {
    "NVIDIA H100 80GB HBM3": (989.0e12, 3.35e12),
    "cpu": (1.0e11, 5.0e10),
}

_peaks_lock = threading.Lock()
_peaks_cache: dict = {}


def _device_kind() -> str:
    import torch

    if torch.cuda.is_available():
        return torch.cuda.get_device_name(0)
    return "cpu"


def peaks(refresh: bool = False) -> tuple[float, float]:
    """(peak FLOP/s, peak bytes/s) of the device a program runs on (the
    port's programs run on one): the env override first, then the
    device-kind table, then the CPU nominal.  Cached per (kind, env) —
    refresh=True re-reads."""
    kind = _device_kind()
    env_f = os.environ.get("DL4J_TPU_PEAK_FLOPS")
    env_b = os.environ.get("DL4J_TPU_PEAK_MEMBW")
    key = (kind, env_f, env_b)
    with _peaks_lock:
        if not refresh and key in _peaks_cache:
            return _peaks_cache[key]
    if kind in PEAKS_BY_DEVICE_KIND:
        flops, membw = PEAKS_BY_DEVICE_KIND[kind]
    else:
        # unknown accelerator: the CPU nominal would make MFU read
        # ~1000x wrong on a real card — say so loudly, once per kind
        flops, membw = PEAKS_BY_DEVICE_KIND["cpu"]
        with _peaks_lock:
            if ("warned", kind) not in _peaks_cache:
                _peaks_cache[("warned", kind)] = True
                log.warning(
                    "device kind %r is not in cost.PEAKS_BY_DEVICE_KIND;"
                    " MFU/roofline will use the CPU nominal peaks — set "
                    "DL4J_TPU_PEAK_FLOPS / DL4J_TPU_PEAK_MEMBW to this "
                    "part's datasheet numbers", kind,
                )
    if env_f:
        flops = float(env_f)
    if env_b:
        membw = float(env_b)
    out = (flops, membw)
    with _peaks_lock:
        _peaks_cache[key] = out
    return out


def _key_repr(key: Any) -> str:
    try:
        return repr(key)
    except Exception as e:                # exotic key types: best effort
        log.debug("program key repr failed: %s", e)
        return object.__repr__(key)


class _TensorSpec:
    """Shape, dtype, device and requires_grad of one tensor argument."""

    __slots__ = ("shape", "dtype", "device", "requires_grad")

    def __init__(self, t):
        self.shape = tuple(t.shape)
        self.dtype = t.dtype
        self.device = t.device
        self.requires_grad = bool(t.requires_grad)

    def zeros(self):
        import torch

        return torch.zeros(self.shape, dtype=self.dtype, device=self.device,
                           requires_grad=self.requires_grad)


def _signature_of(args):
    """The call's arguments with every tensor (and numpy array) replaced
    by its `_TensorSpec` — metadata reads only, no device sync; a
    `QuantizedTensor` becomes one of specs (the record must not hold a
    swapped-out tree's weights); other leaves (ints, tuples of ints,
    None) are kept as they are."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.quant.qtensor import QuantizedTensor

    if isinstance(args, QuantizedTensor):
        return QuantizedTensor(_signature_of(args.q), _signature_of(args.scale))
    if isinstance(args, torch.Tensor):
        return _TensorSpec(args)
    if isinstance(args, np.ndarray):
        return _TensorSpec(torch.from_numpy(np.ascontiguousarray(args)))
    if isinstance(args, dict):
        return {k: _signature_of(v) for k, v in args.items()}
    if isinstance(args, list):
        return [_signature_of(a) for a in args]
    if isinstance(args, tuple):
        return tuple(_signature_of(a) for a in args)
    return args


def _placeholders(sig):
    """Zeros of every spec in ``sig``, the rest as captured."""
    from deeplearning4j_tpu_torch.quant.qtensor import QuantizedTensor

    if isinstance(sig, _TensorSpec):
        return sig.zeros()
    if isinstance(sig, QuantizedTensor):
        return QuantizedTensor(sig.q.zeros(), sig.scale.zeros())
    if isinstance(sig, dict):
        return {k: _placeholders(v) for k, v in sig.items()}
    if isinstance(sig, list):
        return [_placeholders(a) for a in sig]
    if isinstance(sig, tuple):
        return tuple(_placeholders(a) for a in sig)
    return sig


def _spec_leaves(sig) -> list:
    from deeplearning4j_tpu_torch.quant.qtensor import QuantizedTensor

    if isinstance(sig, _TensorSpec):
        return [sig]
    if isinstance(sig, QuantizedTensor):
        return [sig.q, sig.scale]
    if isinstance(sig, dict):
        return [x for k in sorted(sig) for x in _spec_leaves(sig[k])]
    if isinstance(sig, (list, tuple)):
        return [x for a in sig for x in _spec_leaves(a)]
    return []


def _signature_str(sig) -> str:
    leaves = _spec_leaves(sig)
    parts = [f"{str(l.dtype).replace('torch.', '')}{list(l.shape)}"
             for l in leaves[:12]]
    if len(leaves) > 12:
        parts.append(f"...+{len(leaves) - 12}")
    return " ".join(parts)


def _tensor_bytes(x) -> int:
    import torch

    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(a) for a in x)
    if isinstance(x, dict):
        return sum(_tensor_bytes(a) for a in x.values())
    return 0


class _OpCounter:
    """A counting scope over one program run: torch ops by FLOP formula
    and bytes, hand-written kernels by their ``*_work`` functions."""

    def __init__(self):
        self.op_flops = 0.0
        self.op_bytes = 0.0
        self.kernels: dict = {}

    @property
    def flops(self) -> float:
        return self.op_flops + sum(w[1] for w in self.kernels.values())

    @property
    def bytes(self) -> float:
        return self.op_bytes + sum(w[2] for w in self.kernels.values())

    def run(self, fn, args):
        import torch
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import FlopCounterMode

        from deeplearning4j_tpu_torch.runtime import kernels

        formulas = FlopCounterMode(display=False).flop_registry
        skip = {torch.ops.aten.empty, torch.ops.aten.empty_like,
                torch.ops.aten.empty_strided}
        counter = self

        class _Mode(TorchDispatchMode):
            # `kernels.kernel_call` finds this dict on the mode stack
            kernel_work = counter.kernels

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                if kernels.in_kernel_call():
                    return out
                packet = func._overloadpacket
                formula = formulas.get(packet)
                if formula is not None:
                    counter.op_flops += formula(*args, **kwargs, out_val=out)
                if not func.is_view and packet not in skip:
                    counter.op_bytes += (_tensor_bytes(args)
                                         + _tensor_bytes(kwargs)
                                         + _tensor_bytes(out))
                return out

        with _Mode():
            return fn(*args)


class ProgramRecord:
    """One registered program: identity, first-dispatch compile tax,
    lazily-filled cost / memory numbers, dispatch counters."""

    def __init__(self, program_id: int, owner, kind: str, key: Any,
                 live: Callable[[], bool]):
        self.program_id = program_id
        self.owner_ref = weakref.ref(owner)
        self.owner_name = type(owner).__name__
        self.kind = kind
        self.key = _key_repr(key)
        self.created = time.time()
        self._live = live
        self._lock = threading.Lock()
        # wrapper handle (set by register(); the inner fn is reachable
        # only THROUGH the wrapper the owner caches, so a dead model's
        # programs prune instead of being pinned by this registry)
        self._fn_ref: Optional[weakref.ref] = None
        # first-dispatch capture
        self._sig = None
        self.signature: Optional[str] = None
        self.compile_secs: Optional[float] = None
        self.backend_compiles: Optional[int] = None
        self.persistent_cache_hits: Optional[int] = None
        # dispatch accounting
        self.dispatches = 0
        self.last_dispatch_seconds: Optional[float] = None
        # analysis results
        self.flops: Optional[float] = None
        self.bytes_accessed: Optional[float] = None
        self.kernel_work: Optional[dict] = None   # name -> [calls, flops, bytes]
        self.argument_bytes: Optional[int] = None
        self.output_bytes: Optional[int] = None
        self.temp_bytes: Optional[int] = None
        self.peak_bytes: Optional[int] = None
        self.analysis: str = "pending"     # pending|ok|partial|failed: ...
        self._memory_done = False
        # int8 quantization: as-stored params bytes and the f32
        # equivalent, captured from the owner at registration
        self.params_bytes: Optional[int] = None
        self.params_bytes_f32_equiv: Optional[int] = None
        self.quantized = False
        try:
            params = getattr(owner, "params", None)
            if params is not None:
                from deeplearning4j_tpu_torch.quant.ptq import quantized_bytes

                b = quantized_bytes(params)
                self.params_bytes = b["tree_bytes"]
                if getattr(owner, "_quantized", None) is not None:
                    self.quantized = True
                    self.params_bytes_f32_equiv = (
                        self.params_bytes
                        - b["quantized_bytes"] + b["f32_equiv_bytes"]
                    )
        except Exception as e:
            log.debug("params-bytes capture failed for %s: %s", key, e)

    # -- liveness ----------------------------------------------------------
    def live(self) -> bool:
        owner = self.owner_ref()
        if owner is None:
            return False
        try:
            return bool(self._live())
        except Exception as e:             # owner mutated underneath us
            log.debug("program liveness check failed for %s: %s",
                      self.key, e)
            return False

    # -- first-dispatch capture (called from the wrapper) ------------------
    def _capture_signature(self, args: tuple) -> None:
        try:
            self._sig = _signature_of(args)
            self.signature = _signature_str(self._sig)
        except Exception as e:
            self.analysis = f"failed: signature capture ({e})"

    def _capture_compile_delta(self, before) -> None:
        from deeplearning4j_tpu_torch.runtime import compile_stats

        spent = compile_stats.snapshot() - before
        self.compile_secs = round(spent.compile_secs, 4)
        self.backend_compiles = spent.backend_compiles
        self.persistent_cache_hits = spent.persistent_cache_hits

    # -- lazy analysis -----------------------------------------------------
    def _inner_fn(self):
        wrapper = self._fn_ref() if self._fn_ref is not None else None
        if wrapper is None:
            return None
        return getattr(wrapper, "__wrapped__", None)

    def ensure_analysis(self, memory: bool = False) -> "ProgramRecord":
        """Fill cost (and optionally memory) numbers by one counted run
        of the program on placeholder inputs (the device work of one
        dispatch, no state changed: the registered programs are pure)."""
        with self._lock:
            self._ensure_analysis_locked(memory)
        return self

    def _ensure_analysis_locked(self, memory: bool) -> None:
        if self.analysis.startswith("failed"):
            return
        if self.flops is not None and (not memory or self._memory_done):
            return
        if self._sig is None:
            self.analysis = "pending first dispatch"
            return
        fn = self._inner_fn()
        if fn is None:
            self.analysis = "failed: program evicted"
            return
        import torch

        try:
            args = _placeholders(self._sig)
        except Exception as e:
            self.analysis = f"failed: placeholders ({type(e).__name__}: {e})"
            return
        cuda = [s.device for s in _spec_leaves(self._sig)
                if s.device.type == "cuda"]
        if cuda:
            torch.cuda.synchronize(cuda[0])
            base = torch.cuda.memory_allocated(cuda[0])
            torch.cuda.reset_peak_memory_stats(cuda[0])
        counter = _OpCounter()
        try:
            out = counter.run(fn, args)
        except Exception as e:
            self.analysis = f"failed: counted run ({type(e).__name__}: {e})"
            return
        self.flops = float(counter.flops)
        self.bytes_accessed = float(counter.bytes)
        self.kernel_work = counter.kernels
        self.analysis = "ok"
        if memory and not self._memory_done:
            self.argument_bytes = _tensor_bytes(args)
            self.output_bytes = _tensor_bytes(out)
            if cuda:
                torch.cuda.synchronize(cuda[0])
                self.peak_bytes = (torch.cuda.max_memory_allocated(cuda[0])
                                   - base + self.argument_bytes)
                self.temp_bytes = max(0, self.peak_bytes
                                      - self.argument_bytes
                                      - self.output_bytes)
            else:
                self.analysis = ("partial: peak memory is measured on the "
                                 "card only")
            self._memory_done = True

    # -- derived -----------------------------------------------------------
    def arithmetic_intensity(self) -> Optional[float]:
        if not self.flops or not self.bytes_accessed:
            return None
        return self.flops / self.bytes_accessed

    def roofline(self) -> Optional[str]:
        """'compute-bound' | 'memory-bound' from arithmetic intensity vs
        the machine ridge point (peak FLOPs / peak bandwidth)."""
        ai = self.arithmetic_intensity()
        if ai is None:
            return None
        try:
            pk_f, pk_b = peaks()
        except Exception as e:             # device not initializable
            log.debug("peak lookup failed: %s", e)
            return None
        if not pk_b:
            return None
        return "compute-bound" if ai >= pk_f / pk_b else "memory-bound"

    def as_dict(self) -> dict:
        ai = self.arithmetic_intensity()
        return {
            "id": self.program_id,
            "model": self.owner_name,
            "kind": self.kind,
            "key": self.key,
            "signature": self.signature,
            "dispatches": self.dispatches,
            "compile_secs": self.compile_secs,
            "backend_compiles": self.backend_compiles,
            "persistent_cache_hits": self.persistent_cache_hits,
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "argument_bytes": self.argument_bytes,
            "output_bytes": self.output_bytes,
            "temp_bytes": self.temp_bytes,
            "peak_bytes": self.peak_bytes,
            "arithmetic_intensity": round(ai, 3) if ai else None,
            "roofline": self.roofline(),
            "params_bytes": self.params_bytes,
            "params_bytes_f32_equiv": self.params_bytes_f32_equiv,
            "quantized": self.quantized,
            "last_dispatch_seconds": self.last_dispatch_seconds,
            "analysis": self.analysis,
        }


class ProgramRegistry:
    """Process-global table of registered programs.  Records hold only
    weak references to their owners, so enumeration prunes programs
    whose model died or whose step-fn cache dropped them — eviction is
    observed, not hooked."""

    def __init__(self):
        self._lock = threading.Lock()
        self._records: list[ProgramRecord] = []
        self._next_id = 1

    def register(self, owner, kind: str, key: Any, fn,
                 live: Callable[[], bool]):
        """Wrap ``fn`` for the registry: the wrapper notes every
        dispatch, captures the first call's signature and compile-tax
        delta, and routes the owner's ``_cost_program`` pointer so
        StepScope can attribute the step.  Returns the wrapper (store IT
        in the step-fn cache)."""
        with self._lock:
            rec = ProgramRecord(self._next_id, owner, kind, key, live)
            self._next_id += 1
            self._records.append(rec)
        owner_ref = rec.owner_ref

        def wrapped(*args, **kwargs):
            o = owner_ref()
            if o is not None:
                o._cost_program = rec
            rec.dispatches += 1
            if rec._sig is None:
                from deeplearning4j_tpu_torch.runtime import compile_stats

                rec._capture_signature(args)
                before = compile_stats.snapshot()
                try:
                    return fn(*args, **kwargs)
                finally:
                    rec._capture_compile_delta(before)
            return fn(*args, **kwargs)

        wrapped.__wrapped__ = fn
        wrapped._cost_record = rec
        rec._fn_ref = weakref.ref(wrapped)
        return wrapped

    def programs(self, analyze: bool = False, memory: bool = False
                 ) -> list[ProgramRecord]:
        """Live records (dead owners / evicted step fns pruned)."""
        with self._lock:
            records = list(self._records)
        live = [r for r in records if r.live()]
        if len(live) != len(records):
            dead = {id(r) for r in records} - {id(r) for r in live}
            with self._lock:
                self._records = [
                    r for r in self._records if id(r) not in dead
                ]
        if analyze:
            for r in live:
                r.ensure_analysis(memory=memory)
        return live

    def clear(self) -> None:
        with self._lock:
            self._records.clear()


_REGISTRY: Optional[ProgramRegistry] = None
_REGISTRY_LOCK = threading.Lock()


def registry() -> ProgramRegistry:
    """The process-global program registry (its live-count gauge
    collector installed on first use)."""
    global _REGISTRY
    with _REGISTRY_LOCK:
        if _REGISTRY is None:
            _REGISTRY = ProgramRegistry()
            from deeplearning4j_tpu_torch.observe.metrics import (
                registry as metrics_registry,
            )

            reg = metrics_registry()
            gauge = reg.gauge("dl4jtpu_programs_registered")

            def _collect(r=_REGISTRY, g=gauge):
                # enumeration only — never triggers analysis (a counted
                # run must not ride the scrape path)
                g.set(len(r.programs()))

            reg.register_collector(_collect)
    return _REGISTRY


def register_step_program(model, key: Any, fn):
    """Register a model step program (`SequentialModel._step_program`).
    The record stays live exactly as long as `key` maps to this wrapper
    in the model's ``_step_fns`` cache."""
    kind = key[0] if isinstance(key, tuple) and key else str(key)
    holder: dict = {}
    model_ref = weakref.ref(model)

    def live():
        # weakrefs only: the record must never pin the model (or the
        # step fn, whose closure holds the model) past its natural life
        m = model_ref()
        wr = holder.get("fn")
        if m is None or wr is None:
            return False
        w = wr()
        return w is not None and m._step_fns.get(key) is w

    wrapped = registry().register(model, str(kind), key, fn, live)
    holder["fn"] = weakref.ref(wrapped)
    return wrapped


def register_attr_program(owner, attr: str, kind: str, key: Any, fn):
    """Register a program an object caches in an attribute
    (`datavec.device.DeviceDecode`'s standalone decode): live while the
    attribute still holds the wrapper."""
    holder: dict = {}
    owner_ref = weakref.ref(owner)

    def live():
        o = owner_ref()
        wr = holder.get("fn")
        if o is None or wr is None:
            return False
        w = wr()
        return w is not None and getattr(o, attr, None) is w

    wrapped = registry().register(owner, kind, key, fn, live)
    holder["fn"] = weakref.ref(wrapped)
    return wrapped


class SignatureAnalysis:
    """The result of `analyze_signature`: FLOPs and bytes, or the
    reason it could not price the program (the planner records a reason
    as "do not price this", never as zero cost)."""

    __slots__ = ("flops", "bytes_accessed", "ok", "reason")

    def __init__(self, flops=None, bytes_accessed=None, reason=None):
        self.flops = flops
        self.bytes_accessed = bytes_accessed
        self.ok = flops is not None
        self.reason = reason

    def as_dict(self) -> dict:
        return {"flops": self.flops, "bytes_accessed": self.bytes_accessed,
                "ok": self.ok, "reason": self.reason}


def _fake_args(mode, args):
    """``args`` with every tensor made a fake tensor of ``mode`` (shape,
    dtype, device and requires_grad kept; no data) and every
    `_TensorSpec` one made from it."""
    import torch

    from deeplearning4j_tpu_torch.quant.qtensor import QuantizedTensor

    if isinstance(args, _TensorSpec):
        with mode:
            t = torch.empty(args.shape, dtype=args.dtype, device=args.device)
        return t.requires_grad_() if args.requires_grad else t
    if isinstance(args, torch.Tensor):
        return mode.from_tensor(args)
    if isinstance(args, QuantizedTensor):
        return QuantizedTensor(_fake_args(mode, args.q), _fake_args(mode, args.scale))
    if isinstance(args, dict):
        return {k: _fake_args(mode, v) for k, v in args.items()}
    if isinstance(args, (list, tuple)):
        return type(args)(_fake_args(mode, a) for a in args)
    return args


def analyze_signature(fn, sig) -> SignatureAnalysis:
    """Dispatch-free cost analysis (JAX ``analyze_signature``): run
    ``fn`` once on ``sig`` (the positional arguments: tensors, whose
    values are never read, or `_TensorSpec` placeholders) made fake
    tensors, under a ``FakeTensorMode`` and the op counter.  The fake
    tensors hold no data, so nothing runs on a device; every torch op is
    counted by its FLOP formula and bytes, and every hand-written kernel
    by its ``*_work`` function while its wrapper computes shapes through
    its plain version (`runtime/kernels.py` `route`): no launch, no
    ``nvcc``.  ``fn`` may be a registry wrapper (its ``__wrapped__``
    inner runs, so no dispatch is counted).  The program must be pure
    (the registered step programs are): the real arguments are left as
    they were.  A failure comes back as the result's reason."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    inner = getattr(fn, "__wrapped__", fn)
    if not callable(inner):
        return SignatureAnalysis(
            reason=f"not lowerable: {type(inner).__name__} is not callable")
    mode = FakeTensorMode(allow_non_fake_inputs=False)
    try:
        args = _fake_args(mode, tuple(sig))
    except Exception as e:
        return SignatureAnalysis(reason=f"fake arguments failed ({type(e).__name__}: {e})")
    counter = _OpCounter()
    try:
        with mode:
            counter.run(inner, args)
    except Exception as e:
        return SignatureAnalysis(reason=f"lower failed ({type(e).__name__}: {e})")
    return SignatureAnalysis(flops=float(counter.flops),
                             bytes_accessed=float(counter.bytes))


def analyze_model(model, memory: bool = False) -> list[ProgramRecord]:
    """Cost-analyze every live program owned by `model` (lazy trigger
    for tests, `chip_smoke.py` and reporting)."""
    out = []
    for rec in registry().programs():
        if rec.owner_ref() is model:
            rec.ensure_analysis(memory=memory)
            out.append(rec)
    return out


def program_table(analyze: bool = True, memory: bool = False) -> list[dict]:
    """Every live program as a dict (the JAX package's /api/programs
    payload; the port has no UI server yet, ROADMAP A13)."""
    return [
        r.as_dict()
        for r in registry().programs(analyze=analyze, memory=memory)
    ]


# -- per-step gauge updates (called from StepScope.__exit__) ---------------

_STEP_COST_FAMILIES = None


def _step_cost_families():
    global _STEP_COST_FAMILIES
    if _STEP_COST_FAMILIES is None:
        from deeplearning4j_tpu_torch.observe.metrics import (
            registry as metrics_registry,
        )

        reg = metrics_registry()
        _STEP_COST_FAMILIES = (
            reg.counter("dl4jtpu_step_model_flops_total"),
            reg.gauge("dl4jtpu_step_achieved_flops_per_sec"),
            reg.gauge("dl4jtpu_step_mfu"),
            reg.gauge("dl4jtpu_step_bytes_per_sec"),
            reg.gauge("dl4jtpu_step_membw_util"),
        )
    return _STEP_COST_FAMILIES


def note_step(rec: ProgramRecord, dur: float, span_args: dict,
              n_steps: int = 1) -> None:
    """Attribute one dispatched program execution: FLOPs counter,
    achieved FLOP/s, MFU, bytes/s, bandwidth utilization, and the
    roofline class stamped into the step span's args.  No-op (two
    attribute reads) until the record has been cost-analyzed.
    ``n_steps`` scales the FLOPs/bytes of a program that runs several
    optimizer steps a dispatch."""
    rec.last_dispatch_seconds = round(dur, 6)
    if rec.flops is None:
        return
    n = max(1, int(n_steps))
    flops_total, achieved, mfu, bytes_ps, membw = _step_cost_families()
    work = rec.flops * n
    flops_total.inc(work)
    if dur <= 0:
        return
    ach = work / dur
    achieved.set(ach)
    try:
        pk_f, pk_b = peaks()
    except Exception as e:
        log.debug("peak lookup failed: %s", e)
        return
    if pk_f:
        mfu.set(ach / pk_f)
    if rec.bytes_accessed:
        bps = rec.bytes_accessed * n / dur
        bytes_ps.set(bps)
        if pk_b:
            membw.set(bps / pk_b)
    cls = rec.roofline()
    if cls:
        span_args["roofline"] = cls
