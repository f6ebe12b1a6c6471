"""Runtime layer of the port: the ``REPRO_*`` knobs (``config``), the
telemetry sinks (``telemetry``), span tracing (``tracing``) and the
convergence diagnostics with the live health monitor (``diagnostics``).

``fault_tolerance`` (the failure runner, the resilient loop) builds on
``core``, which imports this package: its names load on first access
(PEP 562), so importing this package loads neither.
"""
from . import config, diagnostics, telemetry, tracing
from .config import RuntimeConfig, configure, get_config, override
from .diagnostics import (DiagnosticsSpec, HealthMonitor, HealthRules,
                          install_health_monitor, resolve_diagnostics)
from .tracing import ChromeTracer, set_tracer, span, tracer_from_spec

_FAULT_TOLERANCE = ("AgentFailure", "DisconnectedTopologyError",
                    "ResilientLoop", "StragglerMonitor",
                    "deepca_with_failures", "degrade_topology",
                    "kill_agents")


def __getattr__(name):
    if name in _FAULT_TOLERANCE:
        from . import fault_tolerance
        return getattr(fault_tolerance, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["config", "diagnostics", "telemetry", "tracing",
           "RuntimeConfig", "configure", "get_config", "override",
           "DiagnosticsSpec", "HealthMonitor", "HealthRules",
           "install_health_monitor", "resolve_diagnostics",
           "ChromeTracer", "set_tracer", "span", "tracer_from_spec",
           *_FAULT_TOLERANCE]
