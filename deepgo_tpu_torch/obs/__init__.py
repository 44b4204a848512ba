"""Observability: the process-wide metrics registry, span tracing,
request tracing, workload capture, the flight recorder and the rotating
JSONL sink.

The port's copies of the JAX package's ``obs`` modules that the serving
stack reaches (``registry``, ``spans``, ``tracing``, ``workload``,
``sentinel``, and ``JsonlSink`` of ``exporter``), with plain ``threading``
locks. The HTTP exporter, the torch.profiler/NVTX bridge of spans and the
lock-order checker are not ported yet.
"""

from .registry import (Counter, Gauge, Histogram,  # noqa: F401
                       MetricsRegistry, get_registry)
from .spans import (add_span_listener, attach_context,  # noqa: F401
                    capture_context, current_span_id, get_trace_sink,
                    remove_span_listener, set_trace_sink, span, trace_to)
from .tracing import (TraceContext, TraceRecorder,  # noqa: F401
                      configure_tracing, disable_tracing,
                      get_trace_recorder, start_request, trace_report,
                      tracing_enabled)
from .exporter import JsonlSink, read_events, sink_files  # noqa: F401
from .sentinel import (FlightRecorder, GateConfig,  # noqa: F401
                       configure_flight, evaluate_gate, flight_dump,
                       get_flight_recorder, install_signal_dump)
from .workload import (WorkloadCaptureError, WorkloadRecorder,  # noqa: F401
                       WorkloadToken, analyze_capture, canonical_digest,
                       characterize, configure_workload, disable_workload,
                       exact_digest, format_workload, get_workload_recorder,
                       load_capture, note_request, workload_enabled)
