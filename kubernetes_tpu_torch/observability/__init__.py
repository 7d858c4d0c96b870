"""Scheduler telemetry: the flight recorder (``recorder``), the sampled
per-pod lifecycle tracer (``podtrace``), the SLO burn-rate monitor
(``slo``) and the one labeled registry that serves them all
(``registry``). Each is off, and costs nothing, until enabled."""

from kubernetes_tpu_torch.observability.podtrace import TRACER, PodTracer
from kubernetes_tpu_torch.observability.recorder import RECORDER, FlightRecorder
from kubernetes_tpu_torch.observability.registry import TelemetryRegistry
from kubernetes_tpu_torch.observability.slo import SLO, SLOMonitor

__all__ = ["FlightRecorder", "PodTracer", "RECORDER", "SLO",
           "SLOMonitor", "TRACER", "TelemetryRegistry"]
