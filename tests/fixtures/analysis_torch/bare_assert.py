"""Fixture: a bare assert in a validation path of the port.

``python -O`` strips asserts; the port raises instead.  Analyzer input
only.
"""


def validate_shapes(S, G):
    assert S.shape == G.shape, "shape mismatch"     # bare-assert
    return True
