"""Fixture: bypassing the qr_orth seam and the wire rounding seam.

``torch.linalg.qr`` outside ``repro_torch.kernels.cholqr`` skips the
CholeskyQR2 / Householder choice; ``np.linalg.qr`` is allowed only in
the registered data generators; a bf16 or fp8 round trip outside
``quantize_wire`` forks the wire's rounding rule.  Analyzer input only.
"""
import numpy as np
import torch


def orthonormalize(X):
    return torch.linalg.qr(X).Q        # duplicate-compute-site: qr


def orthonormalize_on_host(X):
    return np.linalg.qr(X)[0]          # duplicate-compute-site: qr


def wire_roundtrip(x):
    return x.to(torch.bfloat16).to(x.dtype)      # quantize-wire


def fp8_roundtrip(x):
    return x.to(torch.float8_e4m3fn).float()     # quantize-wire
