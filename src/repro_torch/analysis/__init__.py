"""Static analysis of the port: machine-checked contracts.

The counterpart of the reference's ``repro.analysis``, over
``src/repro_torch``.  Five passes, one CLI (``python -m
repro_torch.analysis``), all reading their ground truth from
:mod:`.registry`:

* :mod:`.lint` — AST passes over the port: single compute sites (with the
  CUDA sources' mirrors registered by file), no bare asserts, env-config
  ownership, and no host sync inside the driver's iteration loops and the
  engines' gossip calls;
* :mod:`.tracecheck` — a ``TorchDispatchMode`` audit of the public entry
  points: f64 never narrows on the no-wire paths, the bf16 wire never
  accumulates in bf16 and never rounds nothing;
* :mod:`.warm` — the reference's seven no-retrace contracts as warm-call
  contracts: in the steady phase no ``P_K(L)`` build beyond a window's
  own, no kernel library opened, no autotune measurement;
* :mod:`.budget` — Hopper models of every kernel's shared memory, threads
  and registers, swept over the choosers and the autotune cache, and held
  against ``cuobjdump`` and the runtime's occupancy on the card;
* :mod:`.deadcode` — import-graph reachability with a reviewed
  quarantine.
"""
from __future__ import annotations

from . import budget, deadcode, lint, registry, report, tracecheck, warm
from .report import PassResult, Violation

__all__ = ["budget", "deadcode", "lint", "registry", "report", "tracecheck",
           "warm", "PassResult", "Violation"]
