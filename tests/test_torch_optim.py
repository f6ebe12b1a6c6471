"""The port's optimizer and token stream against the reference's
(``repro.optim``, ``repro.data.synthetic``), and the reference's own
substrate tests (``tests/test_substrates.py``: AdamW, the schedule, the
stream, the prefetcher) run on the port.

Tolerances: ``cosine_schedule`` within 1e-6 relative of the reference's
at every step of the grid and bit-equal at nine steps in ten (the two
libraries' fp32 ``cos`` differ in the last bit at a few steps, which ``1 +
cos`` and the products after it carry to at most 3 ulps, 3.6e-7); ``AdamW.update`` over
8 fp32 steps with a schedule and one clipped step, ``mu`` and ``nu`` within
1e-6 of their largest entry and the parameters within 1e-6 absolute (the
global norm sums in another order, ~1e-7 relative); the token stream bit
for bit.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.data import SyntheticTokenStream as RefStream
from repro.data import TokenStreamConfig as RefStreamConfig
from repro.optim import AdamW as RefAdamW
from repro.optim import cosine_schedule as ref_cosine
from repro_torch.data import (PrefetchIterator, SyntheticTokenStream,
                              TokenStreamConfig)
from repro_torch.optim import AdamW, AdamWState, cosine_schedule

torch.set_num_threads(1)

SCHEDULE_RTOL = 1e-6
MOMENT_RTOL = 1e-6
PARAM_ATOL = 1e-6


# ------------------------------------------------ the reference's own tests
def test_adamw_minimizes_quadratic():
    opt = AdamW(lr=0.1, weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0]), "b": torch.tensor(2.0)}
    state = opt.init(params)

    def loss(p):
        return torch.sum(p["w"] ** 2) + p["b"] ** 2

    for _ in range(300):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        grads = dict(zip(leaves, torch.autograd.grad(loss(leaves),
                                                     list(leaves.values()))))
        params, state = opt.update(grads, state, params)
    assert float(loss(params)) < 1e-3
    assert int(state.step) == 300 and state.step.dtype == torch.int32


def test_adamw_grad_clip():
    opt = AdamW(lr=1.0, grad_clip=1e-6, weight_decay=0.0)
    params = {"w": torch.ones(4)}
    before = params["w"].clone()
    state = opt.init(params)
    huge = {"w": torch.full((4,), 1e9)}
    new, _ = opt.update(huge, state, params)
    # clipped: update magnitude bounded by lr regardless of grad scale
    assert float((new["w"] - before).abs().max()) <= 1.5
    assert new["w"] is params["w"]                 # updated in place
    assert torch.equal(huge["w"], torch.full((4,), 1e9))  # grads untouched


def test_cosine_schedule_shape():
    lr = cosine_schedule(1.0, warmup=10, total=100)
    assert float(lr(torch.tensor(0))) == 0.0
    assert abs(float(lr(torch.tensor(10))) - 1.0) < 1e-6
    assert float(lr(torch.tensor(100))) <= 0.11
    assert float(lr(torch.tensor(5))) == pytest.approx(0.5)


def test_stream_deterministic_and_seekable():
    cfg = TokenStreamConfig(vocab=101, seq_len=16, global_batch=4, seed=7)
    a = iter(SyntheticTokenStream(cfg))
    b1, b2 = next(a), next(a)
    s2 = SyntheticTokenStream(cfg)
    s2.seek(1)
    b2b = next(iter(s2))
    np.testing.assert_array_equal(b2["tokens"], b2b["tokens"])
    assert not np.array_equal(b1["tokens"], b2["tokens"])
    assert b1["tokens"].shape == (4, 16)
    np.testing.assert_array_equal(b1["labels"][:, :-1], b1["tokens"][:, 1:])


def test_stream_host_sharding_partitions_batch():
    h0 = TokenStreamConfig(vocab=50, seq_len=8, global_batch=4, seed=1,
                           n_hosts=2, host_id=0)
    b = next(iter(SyntheticTokenStream(h0)))
    assert b["tokens"].shape == (2, 8)
    with pytest.raises(ValueError, match="divide evenly"):
        SyntheticTokenStream(TokenStreamConfig(vocab=50, seq_len=8,
                                               global_batch=3, n_hosts=2))


def test_stream_is_learnable():
    """The Markov process has structure: the labels' entropy is below a
    uniform draw's."""
    cfg = TokenStreamConfig(vocab=64, seq_len=256, global_batch=8, seed=0)
    b = next(iter(SyntheticTokenStream(cfg)))
    _, counts = np.unique(b["labels"], return_counts=True)
    p = counts / counts.sum()
    assert -(p * np.log(p)).sum() < np.log(64) * 0.995


def test_prefetch_iterator_order():
    it = PrefetchIterator(iter(range(50)), depth=4)
    assert list(it) == list(range(50))


# ------------------------------------------------------ against the reference
@pytest.mark.parametrize("host_id", [0, 1])
def test_stream_batches_are_the_references(host_id):
    kw = dict(vocab=257, seq_len=33, global_batch=6, seed=5, n_hosts=2,
              host_id=host_id)
    mine = SyntheticTokenStream(TokenStreamConfig(**kw))
    ref = RefStream(RefStreamConfig(**kw))
    mine.seek(11)
    ref.seek(11)
    for got, want in zip([next(iter(mine)) for _ in range(3)],
                         [next(iter(ref)) for _ in range(3)]):
        for key in ("tokens", "labels"):
            assert got[key].dtype == want[key].dtype == np.int32
            np.testing.assert_array_equal(got[key], want[key])


def test_cosine_schedule_matches_the_reference():
    for peak, warmup, total, floor in ((3e-3, 5, 100, 0.1),
                                       (1.0, 10, 100, 0.1),
                                       (2e-2, 0, 37, 0.0)):
        mine = cosine_schedule(peak, warmup, total, floor)
        ref = ref_cosine(peak, warmup, total, floor)
        steps = range(0, total + 20)
        got = np.array([float(mine(torch.tensor(s))) for s in steps],
                       np.float32)
        want = np.array([float(ref(jnp.asarray(s))) for s in steps],
                        np.float32)
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=SCHEDULE_RTOL, atol=0)
        assert np.mean(got == want) > 0.9


@pytest.mark.parametrize("scheduled", [False, True])
def test_adamw_update_matches_the_reference(scheduled):
    """Eight steps on a random tree, the third with gradients large enough
    to clip; params, moments and step after every step."""
    rng = np.random.default_rng(0)
    shapes = {"w": (8, 5), "b": (5,), "e": (3, 4, 2)}
    init = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    lr_mine = cosine_schedule(1e-2, 2, 10) if scheduled else 1e-2
    lr_ref = ref_cosine(1e-2, 2, 10) if scheduled else 1e-2
    ref, mine = RefAdamW(lr=lr_ref), AdamW(lr=lr_mine)
    rp = {k: jnp.asarray(v) for k, v in init.items()}
    rs = ref.init(rp)
    pp = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    ps = mine.init(pp)
    assert isinstance(ps, AdamWState)
    for step in range(8):
        g = {k: (rng.standard_normal(s) * (3.0 if step == 2 else 0.3))
             .astype(np.float32) for k, s in shapes.items()}
        rp, rs = ref.update({k: jnp.asarray(v) for k, v in g.items()}, rs,
                            rp)
        pp, ps = mine.update({k: torch.from_numpy(v) for k, v in g.items()},
                             ps, pp)
        assert int(ps.step) == int(rs.step) == step + 1
        for key in shapes:
            np.testing.assert_allclose(pp[key].numpy(), np.asarray(rp[key]),
                                       rtol=0, atol=PARAM_ATOL)
            for got, want in ((ps.mu[key], rs.mu[key]),
                              (ps.nu[key], rs.nu[key])):
                want = np.asarray(want)
                np.testing.assert_allclose(
                    got.numpy(), want, rtol=0,
                    atol=MOMENT_RTOL * np.abs(want).max())


def test_adamw_step_is_read_from_a_card_or_host_tensor():
    """A restored state may hold its step on any device: the update reads
    it to the host (a CPU tensor here, as after ``restore(device="cpu")``
    of a reference checkpoint, whose step is int32)."""
    opt = AdamW(lr=0.1)
    params = {"w": torch.ones(3)}
    state = opt.init(params)._replace(step=torch.tensor(4, dtype=torch.int32))
    _, state = opt.update({"w": torch.ones(3)}, state, params)
    assert state.step.device.type == "cpu" and int(state.step) == 5
