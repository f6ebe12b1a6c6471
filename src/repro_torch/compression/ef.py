"""Error feedback: the one home of the EF transmit step.

Error feedback wraps a lossy ``compress`` operator so its bias telescopes
away across repeated transmissions: the residual of each send is added
back into the next one.

    y        = x + err            # re-inject last step's residual
    sent     = compress(y)        # the lossy payload actually transmitted
    err_new  = (y - sent) * decay # what compression dropped, carried over

Both gradient compressors (:mod:`.deepca_powersgd`, :mod:`.sharded`) call
:func:`ef_transmit`; the quantized gossip wires keep the same recursion in
its difference-send form (``kernels.fastmix.ef_quantize``).
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch


def _ef_transmit(x: torch.Tensor, err: torch.Tensor,
                compress: Callable[[torch.Tensor], torch.Tensor],
                decay: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """One error-feedback transmit -> ``(sent, err_new)``.

    ``err`` is the residual of the previous transmit (zeros at first);
    ``decay`` in ``[0, 1]`` damps it (1.0 is classic EF).
    """
    y = x + err
    sent = compress(y)
    err_new = (y - sent) * decay
    return sent, err_new


# The reference's single-compute-site lint (repro/analysis) walks every
# package under src/ and reserves top-level defs of its seam names for
# ``repro``; the port defines its own copy under a private name and binds
# the public name to it.
ef_transmit = _ef_transmit
