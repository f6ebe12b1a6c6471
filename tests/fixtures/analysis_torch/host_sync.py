"""Fixture: host syncs inside the registered hot regions.

In fixture mode the lint matches hot regions by qualified name: this
``IterationDriver._run_static`` reads tensors on the host inside its
iteration loop, ``PowerStep.__call__`` synchronizes the card.  The reads
before the loop are outside the loop-only region and must not fire.
Analyzer input only.
"""
import numpy as np
import torch


class IterationDriver:
    def _run_static(self, carry: torch.Tensor, T: int):
        first = float(carry[0, 0])     # before the loop: allowed
        for _ in range(T):
            carry = carry * 0.5
            if carry.abs().max().item() < 1e-6:      # host-sync: .item()
                break
            scale = float(carry)                     # host-sync: float(t)
            host = np.asarray(carry)                 # host-sync: np.asarray
            carry = carry.cpu().to(carry.device)     # host-sync: .cpu()
        return carry, first, scale, host


class PowerStep:
    def __call__(self, carry: torch.Tensor):
        torch.cuda.synchronize()                     # host-sync
        return carry.tolist()                        # host-sync
