"""Online decentralized PCA over drifting data, with the PyTorch port.

A population of agents watches a data distribution whose principal
subspace rotates slowly, then jumps.  A warm-started StreamingDeEPCA
tracker follows it with a few gossip-cheap power iterations per tick,
detects the jump, and recovers by escalating and restarting its tracked
state (through the same path that survives agent deaths).

    python examples/streaming_pca_torch.py [--device cpu]

Without ``--device`` it runs on the card; it prints the lines of
``examples/streaming_pca.py``.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch._device import resolve_device   # noqa: E402
from repro_torch.core import deepca, erdos_renyi   # noqa: E402
from repro_torch.streaming import (DriftPolicy,  # noqa: E402
                                   EigengapShiftStream, SlowRotationStream,
                                   StreamingDeEPCA)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    dev = resolve_device(ap.parse_args(argv).device)

    m, d, k = 8, 48, 4
    topo = erdos_renyi(m, p=0.5, seed=0)

    # 1. benign drift: the top-k subspace rotates ~0.03 rad per tick
    stream = SlowRotationStream(m=m, d=d, k=k, n_per_agent=48, rate=0.03,
                                seed=0, device=dev)
    tracker = StreamingDeEPCA(k=k, T_tick=3, K=5, topology=topo,
                              W0=stream.init_W0(),
                              policy=DriftPolicy(target=5e-3), device=dev)
    print("slow rotation: a few warm-started iterations per tick suffice")
    for tick in stream.ticks(6):
        r = tracker.tick(tick.ops, tick.U)
        print(f"  tick {r.tick}: {r.iterations} iters, {r.comm_rounds:.0f} "
              f"rounds, tan_theta={r.stat:.2e}")

    # 2. abrupt change: at tick 3 the subspace jumps and the eigengap
    #    halves; the monitor flags the jump, escalates, and (policy
    #    permitting) restarts the tracker state on the new operators
    shift = EigengapShiftStream(m=m, d=d, k=k, n_per_agent=48, shift_every=3,
                                gap_shift=0.5, seed=0, device=dev)
    tracker = StreamingDeEPCA(k=k, T_tick=3, K=5, topology=topo,
                              W0=shift.init_W0(),
                              policy=DriftPolicy(target=5e-3, jump=4.0,
                                                 restart=7.0,
                                                 max_escalations=6),
                              device=dev)
    print("abrupt eigengap shift at tick 3:")
    for tick in shift.ticks(6):
        r = tracker.tick(tick.ops, tick.U)
        flags = (" DRIFT" if r.drift else "") + \
            (" RESTART" if r.restarted else "")
        print(f"  tick {r.tick}: {r.iterations} iters, {r.comm_rounds:.0f} "
              f"rounds, tan_theta={r.stat:.2e}{flags}")

    quiet = min(r.comm_rounds for r in tracker.reports[1:])
    print(f"adaptive effort: quiet ticks spent {quiet:.0f} rounds, the shift "
          f"tick spent {tracker.reports[3].comm_rounds:.0f}")

    # 3. the tracker state is the deepca resume tuple: hand it to deepca()
    #    to polish the current tick's answer offline, accounting intact
    res = deepca(shift.ops_at(5), topo, shift.init_W0(), k=k, T=10, K=5,
                 U=shift.truth_at(5)[0], state=tracker.state)
    print(f"offline polish from tracker.state: tan_theta="
          f"{float(res.trace.mean_tan_theta[-1]):.2e} "
          f"(cumulative rounds {int(res.trace.comm_rounds[-1])})")


if __name__ == "__main__":
    main()
