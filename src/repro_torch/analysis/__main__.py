"""``python -m repro_torch.analysis`` — run the port's static-analysis
passes.

Flags select passes (``--lint``, ``--tracecheck``, ``--warm``,
``--budget``, ``--deadcode``); no flag (or ``--all``) runs every one.
``--json`` prints machine-readable results in the reference's schema
(``{"ok", "passes": [...]}``).  Exit status 1 when any pass reports a
violation.

The passes that run code (``tracecheck``, ``warm``) run on the card
unless ``--device cpu`` asks for the CPU; the budget pass's card checks
run wherever a card, ``nvcc`` and ``cuobjdump`` are present, whatever
``--device`` says, and are reported as skipped elsewhere.
"""
from __future__ import annotations

import argparse
import json
import sys

from . import budget, deadcode, lint, tracecheck, warm

PASSES = (
    ("lint", lambda device: lint.run(), "AST contract linter over the port"),
    ("tracecheck", lambda device: tracecheck.run(device=device),
     "TorchDispatchMode dtype-flow audits"),
    ("warm", lambda device: warm.run(device=device),
     "warm-call contracts (no build, load or measurement)"),
    ("budget", lambda device: budget.run(), "Hopper resource budgets"),
    ("deadcode", lambda device: deadcode.run(), "import-graph reachability"),
)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's static-analysis passes (contract linter, "
                    "dispatch audit, warm-call contracts, Hopper budgets, "
                    "deadcode)")
    parser.add_argument("--all", action="store_true",
                        help="run every pass (default when no flag given)")
    for name, _, help_ in PASSES:
        parser.add_argument(f"--{name}", action="store_true", help=help_)
    parser.add_argument("--json", action="store_true",
                        help="emit machine-readable JSON")
    parser.add_argument("-v", "--verbose", action="store_true",
                        help="also print skipped units and notes")
    parser.add_argument("--device", default=None,
                        help="where tracecheck and warm run (default: the "
                             "card; 'cpu' for the CPU)")
    args = parser.parse_args(argv)

    selected = [(name, fn) for name, fn, _ in PASSES
                if getattr(args, name)]
    if args.all or not selected:
        selected = [(name, fn) for name, fn, _ in PASSES]

    results = [fn(args.device) for _, fn in selected]
    if args.json:
        print(json.dumps({"ok": all(r.ok for r in results),
                          "passes": [r.to_dict() for r in results]},
                         indent=2))
    else:
        for r in results:
            print(r.render(verbose=args.verbose))
    return 0 if all(r.ok for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
