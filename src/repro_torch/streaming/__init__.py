"""Streaming subsystem of the port: online subspace tracking and
dynamic-batching serving, on the driver's resumable state contract.

* :mod:`repro_torch.streaming.stream` — deterministic drifting-problem
  generators (slow subspace rotation, abrupt eigengap shifts, per-agent
  sample-arrival covariance updates), drawn as the reference package
  draws them;
* :mod:`repro_torch.streaming.tracker` — :class:`StreamingDeEPCA`,
  warm-start online tracking over a stream via the resumable ``(S, W,
  G_prev, offset)`` state contract, with drift monitoring, adaptive
  iteration escalation, and tracker restarts through ``rebase_carry``;
* :mod:`repro_torch.streaming.service` — :class:`PCAService`, a
  request-queue front-end with shape bucketing + dynamic batching so
  ragged one-shot PCA requests ride
  :meth:`~repro_torch.core.driver.IterationDriver.run_batch`;
* :mod:`repro_torch.streaming.fleet` — :class:`TrackerFleet`, the
  multi-tenant tracker: N drifting streams through one batched window per
  padded-shape bucket, per-tenant drift policy as masked selects and
  join/leave as slot scatters.

Entry points: ``python -m repro_torch.launch.serve --workload pca-stream``
/ ``--workload pca-fleet``.
"""
from .stream import (DriftingStream, EigengapShiftStream, SampleArrivalStream,
                     SlowRotationStream, StreamTick, ragged_requests)
from .tracker import (DriftPolicy, StreamingDeEPCA, TickReport,
                      concat_traces)
from .service import AdmissionPolicy, PCAResponse, PCAService
from .fleet import (FleetTickReport, TenantReport, TrackerFleet,
                    scatter_carry, select_carry)

__all__ = [
    "DriftingStream", "SlowRotationStream", "EigengapShiftStream",
    "SampleArrivalStream", "StreamTick", "ragged_requests",
    "StreamingDeEPCA", "DriftPolicy", "TickReport", "concat_traces",
    "PCAService", "AdmissionPolicy", "PCAResponse",
    "TrackerFleet", "FleetTickReport", "TenantReport",
    "select_carry", "scatter_carry",
]
