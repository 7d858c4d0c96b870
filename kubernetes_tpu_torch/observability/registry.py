"""Unified telemetry registry: one labeled namespace over every metric
source the tree grew ad-hoc.

Before this module there were four disjoint telemetry systems:
``utils/trace.py`` COUNTERS (span counts + accumulated wall time),
``utils/metrics.py`` SchedulerMetrics (histograms + counters, one
instance per Scheduler/backend), the extender's ``_counters`` dict
(service counters under their own torn-read-audited lock), and loose
gauges (commit/snapshot generations, the streaming loop's quantum /
backlog / degraded state) that only existed as attributes. Each had its
own render, and only one (the extender's) was scrapeable.

``TelemetryRegistry`` folds them:

- ``snapshot()`` returns ONE flat dict under a labeled namespace —
  ``span.<name>.count`` / ``span.<name>.seconds``,
  ``hist.<prefix>.<name>.count`` / ``.sum``, ``counter.<prefix>.<k>``,
  ``gauge.<name>``, ``recorder.*`` — the exact payload every
  introspection transport serves (HTTP ``/debug/vars``, the binary
  STATS verb, ``VerdictService.debug_snapshot``), so transport parity
  is a dict equality, test-pinned.
- ``render_prometheus()`` is the single Prometheus text render: the
  SchedulerMetrics families verbatim (existing scrape consumers keep
  their names), the service counters as ``<prom_prefix>_<k>_total``,
  gauges by their registered names, plus the span and recorder
  families the old render never exposed.

Torn-read discipline (the r12 audit, inherited): every source snapshots
under ITS OWN lock, sources are read in sequence (never nested), and
the registry itself holds no lock while calling into one — a scrape can
contend with the eval path only for the microseconds one source's
snapshot takes.

Registration is keyed (kind, name): re-registering replaces, so a
replacement ScheduleLoop's gauges supersede the dead loop's instead of
accumulating.
"""

from __future__ import annotations

import threading
from kubernetes_tpu_torch.analysis import lockcheck
from typing import Callable, Dict, List, Optional, Tuple

from kubernetes_tpu_torch.observability.podtrace import TRACER
from kubernetes_tpu_torch.observability.recorder import RECORDER
from kubernetes_tpu_torch.observability.slo import SLO, SLO_FAST
from kubernetes_tpu_torch.utils.trace import COUNTERS


class TelemetryRegistry:
    """One process-local fold over span counters, SchedulerMetrics,
    counter dicts, and gauge providers."""

    def __init__(self, spans=COUNTERS, recorder=RECORDER, tracer=TRACER,
                 slo=SLO, slo_fast=SLO_FAST):
        self._spans = spans
        self._recorder = recorder
        # pod-level black box: the tracer's bound accounting
        # + per-window phase aggregate and the SLO gauges fold in beside
        # the recorder, so "why is p99 moving" is one scrape on any
        # transport
        self._tracer = tracer
        self._slo = slo
        # per-tier objective: the fast lane's 10 ms SLO folds
        # as slo.fast.* beside the bulk slo.* on every transport
        self._slo_fast = slo_fast
        # keyed sources; insertion-ordered so renders are stable. The
        # registration lock guards the MAPS only (a ScheduleLoop swap
        # races a scrape's iteration — dict-changed-size mid-snapshot);
        # provider fns are called OUTSIDE it, so a slow source can never
        # block registration and the per-source lock discipline holds.
        self._reg_lock = lockcheck.make_lock("TelemetryRegistry._reg_lock")
        self._metrics: Dict[str, object] = {}
        self._counters: Dict[str, Tuple[Callable[[], Dict[str, int]],
                                        Optional[str]]] = {}
        self._gauges: Dict[str, Callable[[], Dict[str, float]]] = {}

    # ------------------------------------------------------- registration

    def register_metrics(self, prefix: str, metrics) -> None:
        """A utils.metrics.SchedulerMetrics (or any object exposing
        iterable ``histograms()``/``counters()`` — see below) under a
        namespace prefix."""
        with self._reg_lock:
            self._metrics[prefix] = metrics

    def register_counters(self, prefix: str,
                          fn: Callable[[], Dict[str, int]],
                          prom_prefix: Optional[str] = None) -> None:
        """A counter-dict provider. ``fn`` must snapshot under the
        owner's own lock and return a plain dict. ``prom_prefix`` names
        the Prometheus family stem (``<prom_prefix>_<k>_total``)."""
        with self._reg_lock:
            self._counters[prefix] = (fn, prom_prefix)

    def register_gauges(self, name: str,
                        fn: Callable[[], Dict[str, float]]) -> None:
        """A gauge provider returning {prom_name: value}. Values must be
        cheap host reads (ints/floats already in hand)."""
        with self._reg_lock:
            self._gauges[name] = fn

    def unregister_gauges(self, name: str, only_if=None) -> None:
        """Drop a gauge provider. ``only_if`` guards the handover race:
        a dying owner removes its registration only while it is still
        the one registered (a replacement that re-registered under the
        same key is left in place). Equality, not identity: bound
        methods are re-created per attribute access — ``==`` compares
        (__self__, __func__)."""
        with self._reg_lock:
            if only_if is not None \
                    and self._gauges.get(name) != only_if:
                return
            self._gauges.pop(name, None)

    def _sources(self):
        """Stable copies of the registration maps — iteration happens
        over these, never the live dicts a register/unregister could
        resize mid-scrape."""
        with self._reg_lock:
            return (list(self._metrics.items()),
                    list(self._counters.items()),
                    list(self._gauges.items()))

    # ----------------------------------------------------------- snapshot

    @staticmethod
    def _metric_parts(metrics):
        """(histograms, counters) of a SchedulerMetrics-shaped object —
        duck-typed off utils.metrics so the registry never imports a
        specific metric set."""
        from kubernetes_tpu_torch.utils.metrics import Counter, Histogram
        hists: List = []
        ctrs: List = []
        for v in vars(metrics).values():
            if isinstance(v, Histogram):
                hists.append(v)
            elif isinstance(v, Counter):
                ctrs.append(v)
        return hists, ctrs

    def snapshot(self) -> Dict[str, float]:
        metrics_src, counters_src, gauges_src = self._sources()
        out: Dict[str, float] = {}
        for name, (count, secs) in sorted(self._spans.snapshot().items()):
            out[f"span.{name}.count"] = count
            out[f"span.{name}.seconds"] = round(secs, 6)
        for prefix, metrics in metrics_src:
            hists, ctrs = self._metric_parts(metrics)
            for h in hists:
                count, total = h.totals()
                out[f"hist.{prefix}.{h.name}.count"] = count
                out[f"hist.{prefix}.{h.name}.sum"] = round(total, 6)
            for c in ctrs:
                out[f"counter.{prefix}.{c.name}"] = c.value
        for prefix, (fn, _prom) in counters_src:
            for k, v in sorted(fn().items()):
                out[f"counter.{prefix}.{k}"] = v
        for _name, fn in gauges_src:
            for k, v in sorted(fn().items()):
                out[f"gauge.{k}"] = v
        for k, v in self._recorder.stats().items():
            out[f"recorder.{k}"] = v
        for k, v in self._tracer.stats().items():
            out[f"podtrace.{k}"] = v
        for k, v in self._slo.snapshot().items():
            out[f"slo.{k}"] = v
        for k, v in self._slo_fast.snapshot().items():
            out[f"slo.fast.{k}"] = v
        return out

    # --------------------------------------------------------- Prometheus

    def render_prometheus(self) -> str:
        metrics_src, counters_src, gauges_src = self._sources()
        lines: List[str] = []
        for _prefix, metrics in metrics_src:
            lines.append(metrics.render())
        for _prefix, (fn, prom) in counters_src:
            stem = prom or "tpu"
            snap = fn()
            for k in sorted(snap):
                name = f"{stem}_{k}_total"
                lines.append(f"# TYPE {name} counter\n{name} {snap[k]}")
        for _name, fn in gauges_src:
            for k, v in sorted(fn().items()):
                lines.append(f"# TYPE {k} gauge\n{k} {v}")
        # span family: one labeled pair of counters instead of a family
        # per span name (the span vocabulary is open-ended)
        spans = sorted(self._spans.snapshot().items())
        if spans:
            lines.append("# TYPE tpu_span_count_total counter")
            for name, (count, _secs) in spans:
                lines.append(f'tpu_span_count_total{{span="{name}"}} '
                             f'{count}')
            lines.append("# TYPE tpu_span_seconds_total counter")
            for name, (_count, secs) in spans:
                lines.append(f'tpu_span_seconds_total{{span="{name}"}} '
                             f'{secs:.6f}')
        rec = self._recorder.stats()
        for k in sorted(rec):
            name = f"tpu_flight_recorder_{k}"
            kind = "counter" if k in ("events", "dropped") else "gauge"
            lines.append(f"# TYPE {name} {kind}\n{name} {rec[k]}")
        # pod tracer + SLO families: dots in the phase keys
        # become underscores (Prometheus name grammar)
        trc = self._tracer.stats()
        for k in sorted(trc):
            name = "tpu_podtrace_" + k.replace(".", "_")
            # phase.* values reset per window — gauges, not counters
            # (a counter TYPE would make rate()/increase() misread every
            # rotation as a reset)
            kind = "counter" if (("total" in k or "dropped" in k
                                  or "duplicate" in k or "abandoned" in k)
                                 and not k.startswith("phase.")) \
                else "gauge"
            lines.append(f"# TYPE {name} {kind}\n{name} {trc[k]}")
        slo = self._slo.snapshot()
        for k in sorted(slo):
            name = f"tpu_slo_{k}"
            kind = "counter" if k == "alerts_total" else "gauge"
            lines.append(f"# TYPE {name} {kind}\n{name} {slo[k]}")
        slo_fast = self._slo_fast.snapshot()
        for k in sorted(slo_fast):
            name = f"tpu_slo_fast_{k}"
            kind = "counter" if k == "alerts_total" else "gauge"
            lines.append(f"# TYPE {name} {kind}\n{name} {slo_fast[k]}")
        return "\n".join(lines)


__all__ = ["TelemetryRegistry"]
