"""Fixture: a second home for the Eqn. (3.1) tracking combine, in the
forms the port writes it.

The port's lint must flag each form (its only home is
``repro_torch.kernels.fastmix._tracking_update``) and the shadowing
redefinition of the reserved ``tracking_update`` name.  Analyzer input
only, never imported.
"""
import torch


def sneaky_combine(S, G, G_prev):
    return torch.sub(S + G, G_prev)    # duplicate-compute-site: tracking


def sneaky_operator(S, G, G_prev):
    return (S + G) - G_prev            # duplicate-compute-site: tracking


def sneaky_method(S, G, G_prev):
    return (S + G).sub(G_prev)         # duplicate-compute-site: tracking


def sneaky_in_place(S, G, G_prev):
    x = S + G
    x.sub_(G_prev)                     # duplicate-compute-site: tracking
    return x


def tracking_update(S, G, G_prev):     # reserved name outside its home
    return S
