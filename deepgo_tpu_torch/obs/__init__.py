"""Observability: the process-wide metrics registry, span tracing,
request tracing, workload capture, the flight recorder, the rotating JSONL
sink, and the analysis layer over them.

The port's copies of the JAX package's ``obs`` modules: ``registry``,
``spans`` (bridged onto torch.profiler / NVTX ranges), ``tracing``,
``workload``, ``sentinel``, ``exporter`` (``JsonlSink``, the
Prometheus text renderer and the live ``/metrics`` + ``/healthz`` HTTP
endpoint ``ObsExporter``), ``attribution`` (train wall-clock into named
buckets), ``report`` (the offline run summary), ``slo`` (burn rates),
``timeseries`` / ``anomaly`` / ``federate`` / ``dash`` (the telemetry
plane), and ``costmodel`` (FLOP-counter pricing and MFU against the card's
peak).
"""
from .registry import (Counter, Gauge, Histogram,  # noqa: F401
                       MetricsRegistry, get_registry)
from .spans import (add_span_listener, attach_context,  # noqa: F401
                    capture_context, capturing, current_span_id,
                    get_trace_sink, hot_laps, hot_range, hot_span,
                    remove_span_listener, set_trace_sink, span, trace_to)
from .tracing import (TraceContext, TraceRecorder,  # noqa: F401
                      configure_tracing, disable_tracing,
                      get_trace_recorder, start_request, trace_report,
                      tracing_enabled)
from .exporter import (JsonlSink, ObsExporter,  # noqa: F401
                       health_from_engine, health_from_ledger, read_events,
                       render_prometheus, sink_files, start_exporter)
from .sentinel import (FlightRecorder, GateConfig,  # noqa: F401
                       configure_flight, evaluate_gate, flight_dump,
                       get_flight_recorder, install_signal_dump)
from .workload import (WorkloadCaptureError, WorkloadRecorder,  # noqa: F401
                       WorkloadToken, analyze_capture, canonical_digest,
                       characterize, configure_workload, disable_workload,
                       exact_digest, format_workload, get_workload_recorder,
                       load_capture, note_request, workload_enabled)
from .slo import (GaugeFloorObjective, HealthObjective,  # noqa: F401
                  HistogramLatencyObjective, SLOConfig, SloTracker,
                  parse_slo_spec)
from .attribution import (attribute_run, attribute_snapshot,  # noqa: F401
                          format_attribution)
from .costmodel import (CostEntry, CostLedger, PlatformPeak,  # noqa: F401
                        analytic_flops, analytic_train_flops, detect_peak,
                        dispatch_seconds_by_bucket, evaluate_mfu_floor,
                        format_ledger, get_cost_ledger, set_cost_ledger,
                        standard_ledger)
from .timeseries import (TelemetrySampler, TimeSeriesStore,  # noqa: F401
                         flatten_snapshot, get_live_store, load_samples,
                         series_from_samples, set_live_store)
from .anomaly import (DEFAULT_WATCHLIST, Anomaly,  # noqa: F401
                      AnomalyDetector, WatchSpec)
from .federate import (FederatedView, parse_prometheus,  # noqa: F401
                       scrape_series, store_series, with_labels)
