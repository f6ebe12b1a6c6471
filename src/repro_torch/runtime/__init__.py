"""Runtime layer of the port: the ``REPRO_*`` knobs (``config``), the
telemetry sinks (``telemetry``), span tracing (``tracing``) and the
convergence diagnostics with the live health monitor (``diagnostics``).

``fault_tolerance.degrade_topology`` is not imported here: it builds on
``core``, which imports this package.
"""
from . import config, diagnostics, telemetry, tracing
from .config import RuntimeConfig, configure, get_config, override
from .diagnostics import (DiagnosticsSpec, HealthMonitor, HealthRules,
                          install_health_monitor, resolve_diagnostics)
from .tracing import ChromeTracer, set_tracer, span, tracer_from_spec

__all__ = ["config", "diagnostics", "telemetry", "tracing",
           "RuntimeConfig", "configure", "get_config", "override",
           "DiagnosticsSpec", "HealthMonitor", "HealthRules",
           "install_health_monitor", "resolve_diagnostics",
           "ChromeTracer", "set_tracer", "span", "tracer_from_spec"]
