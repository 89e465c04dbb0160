"""One telemetry spine — the port's copy of `deeplearning4j_tpu/observe/`.

Stdlib only (torch is imported lazily, where a signal comes from the
card):

- `observe.metrics`: the thread-safe process-global `MetricsRegistry`
  (counters / gauges / fixed-bucket histograms) with Prometheus text
  exposition; the serving plane's families are pre-declared.
- `observe.trace`: a ring-buffer span recorder emitting Chrome
  trace-event JSON, with causally-linked request chains
  (`chain_is_causal`).
- `observe.slo`: declarative SLO objectives evaluated over the registry
  with multi-window burn-rate alerting; alert state lands on the
  ``dl4jtpu_slo_*`` gauges, ``/healthz`` and ``/v1/status``.

- `observe.cost`: the program registry, a step program's FLOPs and
  bytes from one counted run, MFU and the roofline class on the
  ``dl4jtpu_step_*`` gauges.
- `observe.fleet`: the fleet's merged Prometheus exposition, skew and
  straggler views and cluster trace (`FleetAggregator`), and the worker
  side's `FleetReporter`.

- `observe.health`: `HealthListener` (one device reduction a check:
  non-finite count, global norm, |Δw|) and `DivergenceError`.

    from deeplearning4j_tpu_torch.observe import registry, tracer

    tracer().enable()                      # opt-in span timeline
    engine.generate(prompt, 16)
    print(registry().to_prometheus_text())
"""

from deeplearning4j_tpu_torch.observe.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    registry,
)
from deeplearning4j_tpu_torch.observe.slo import (
    BurnWindow,
    SLObjective,
    SLOEngine,
    active_engine,
)
from deeplearning4j_tpu_torch.observe.trace import (
    StepScope,
    TraceRecorder,
    chain_coverage,
    chain_is_causal,
    merge_chrome_traces,
    step_scope,
    tracer,
)

__all__ = [
    "BurnWindow",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "SLOEngine",
    "SLObjective",
    "StepScope",
    "TraceRecorder",
    "active_engine",
    "chain_coverage",
    "chain_is_causal",
    "merge_chrome_traces",
    "registry",
    "step_scope",
    "tracer",
]
