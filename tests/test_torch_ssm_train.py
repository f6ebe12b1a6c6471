"""Port parity for training the xLSTM model: the loss and its gradients
against ``jax.grad`` of the reference's, two AdamW steps, and the masked
decay weight that keeps the gradient finite at the published chunk.  The
model is ``tests/test_torch_ssm.py``'s.

Tolerances (``tests/test_torch_train.py``'s where this model meets them):

* the loss within ``LOSS_RTOL``, the first step's loss within
  ``STEP_LOSS_RTOL`` and its parameters within ``STEP_PARAM_ATOL``;
* each gradient leaf within ``XLSTM_GRAD_TOL`` of its largest entry:
  5e-3 in fp32 and 0.25 in bf16, where ``GRAD_TOL`` is 1e-4 and 5e-2.
  The port's readings: fp32 at most 1.98e-3 (``embed``; 45 of 91 leaves
  above 1e-4, the median 9.9e-5), bf16 at most 0.164 (layer 5's
  ``dt_bias``; 25 of 91 above 5e-2, the median 0.033).  The mLSTM's gated
  norm divides rows whose rms is 1e-3 (the first tokens) by that rms, so
  a difference in summation order grows about a thousandfold there: one
  fp32 ulp of nudge moves the reference's own fp32 gradients by up to
  6e-4 of a leaf's largest entry, and its compiled bf16 gradients lie
  0.35 to 2.8 of a leaf's largest entry from its op-by-op ones.  A zero,
  halved or sign-flipped leaf still fails;
* the second step: its loss within ``STEP2_LOSS_RTOL`` (2e-4; read
  5.7e-5) and each leaf's two-step update within ``STEP2_UPDATE_TOL``
  relative Frobenius error (0.25; read at most 0.097, the median 0.011).
  AdamW's update is about ``lr * sign(m)``, and the gradient's rounding
  noise flips that sign on entries whose gradient is near zero.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import models as RM
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.optim import AdamW as RefAdamW
from repro_torch import convert
from repro_torch.compression.deepca_powersgd import tree_leaves
from repro_torch.data import SyntheticTokenStream, TokenStreamConfig
from repro_torch.launch.steps import _grads, make_train_step
from repro_torch.models import model as PM
from repro_torch.optim import AdamW
from test_torch_ssm import (UNUSED, _np, _pair, _tokens, _walk,
                            op_by_op)  # noqa: F401 (a fixture)

# the tensors here are tiny: one thread per test process keeps a
# parallel run's workers from spinning against each other
torch.set_num_threads(1)

#: tests/test_torch_train.py's bounds
LOSS_RTOL = {"float32": 1e-5, "bfloat16": 1e-3}
STEP_LOSS_RTOL, STEP_PARAM_ATOL = 1e-5, 1e-4
#: a gradient leaf, relative to its largest entry (the module docstring)
XLSTM_GRAD_TOL = {"float32": 5e-3, "bfloat16": 0.25}
#: the second AdamW step: its loss, relative, and a leaf's two-step update,
#: relative Frobenius error
STEP2_LOSS_RTOL, STEP2_UPDATE_TOL = 2e-4, 0.25


def _batches(cfg, n: int, batch: int = 4, seq: int = 32):
    it = iter(SyntheticTokenStream(TokenStreamConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=0)))
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_reference(request, dtype):
    """The loss and every gradient leaf against ``jax.grad`` of the
    reference's ``loss_fn`` (bf16: run op by op), each leaf within
    ``XLSTM_GRAD_TOL`` of its largest entry; the mLSTM's ``A_log`` and
    ``D`` get zeros on both sides (torch leaves their ``.grad`` at
    ``None``; the train step's ``_grads`` hands AdamW zeros)."""
    cfg_ref, params, cfg, _ = _pair(dtype)
    if dtype == "bfloat16":
        request.getfixturevalue("op_by_op")
    raw = _batches(cfg, 1)[0]
    want, g_ref = jax.value_and_grad(lambda p: RM.loss_fn(
        cfg_ref, p, {k: jnp.asarray(v) for k, v in raw.items()}))(params)
    lm = convert.lm_params_from_reference(jax.tree.map(np.asarray, params),
                                          cfg, device="cpu")
    got = PM.loss_fn(cfg, lm, {k: torch.from_numpy(v)
                               for k, v in raw.items()})
    got.backward()
    assert abs(got.item() - float(want)) <= LOSS_RTOL[dtype] * float(want)
    grads = _grads(lm)
    for name, p in lm.named_parameters():
        assert (p.grad is None) == name.endswith(UNUSED), name
    g_port = convert.lm_params_to_reference(grads, cfg)
    flat = jax.tree_util.tree_flatten_with_path(g_ref)[0]
    assert len(flat) == len(list(tree_leaves(g_port)))
    for path, g in flat:
        g = _np(g)
        mine = _walk(g_port, path).numpy()
        key = jax.tree_util.keystr(path)
        assert mine.shape == g.shape, key
        if key.endswith(tuple(f"['{u}']" for u in UNUSED)) and \
                "mixer" in key and g.shape[-1] != cfg.d_model:
            assert not g.any() and not mine.any(), key
        np.testing.assert_allclose(
            mine, g, rtol=0, atol=XLSTM_GRAD_TOL[dtype] * np.abs(g).max(),
            err_msg=key)


def test_train_steps_match_reference():
    """Two fp32 steps of ``make_train_step`` against the reference's jitted
    step.  After the first: the loss, and the parameters where the
    gradient is above ``XLSTM_GRAD_TOL`` of its leaf's largest entry (there
    its sign, and so AdamW's first update ``lr * sign(g)``, is the
    reference's), within ``tests/test_torch_train.py``'s bounds.  After
    the second: the loss within ``STEP2_LOSS_RTOL`` and each leaf's
    two-step update within ``STEP2_UPDATE_TOL``.  ``A_log`` and ``D``,
    whose gradient is zero, are compared whole at ``STEP_PARAM_ATOL``
    after each step: weight decay moves them the same on both sides."""
    cfg_ref, params, cfg, _ = _pair("float32")
    batches = _batches(cfg, 2)
    ref_opt, opt = RefAdamW(lr=3e-3), AdamW(lr=3e-3)
    g1 = jax.grad(lambda p: RM.loss_fn(cfg_ref, p, {
        k: jnp.asarray(v) for k, v in batches[0].items()}))(params)
    ref_step = jax.jit(ref_make_train_step(cfg_ref, ref_opt))
    rp, rs = params, ref_opt.init(params)
    lm = convert.lm_params_from_reference(jax.tree.map(np.asarray, params),
                                          cfg, device="cpu")
    step = make_train_step(cfg, opt)
    ps = opt.init({k: p.detach() for k, p in lm.named_parameters()})
    unused = 0
    for n, raw in enumerate(batches, start=1):
        rp, rs, want = ref_step(rp, rs, {k: jnp.asarray(v)
                                         for k, v in raw.items()})
        ps, got = step(lm, ps, {k: torch.from_numpy(v)
                                for k, v in raw.items()})
        rtol = STEP_LOSS_RTOL if n == 1 else STEP2_LOSS_RTOL
        assert abs(float(got) - float(want)) <= rtol * float(want), n
        mine = convert.lm_params_to_reference(lm, cfg)
        for path, w in jax.tree_util.tree_flatten_with_path(rp)[0]:
            key = jax.tree_util.keystr(path)
            got_p, w = _walk(mine, path).detach().numpy(), np.asarray(w)
            before = np.asarray(_walk(params, path))
            if key.endswith(("['A_log']", "['D']")):
                unused += 1
                assert not np.array_equal(w, before), key   # decayed
                np.testing.assert_allclose(got_p, w, rtol=0,
                                           atol=STEP_PARAM_ATOL,
                                           err_msg=f"step {n} {key}")
            elif n == 1:
                g = np.abs(np.asarray(_walk(g1, path)))
                keep = g > XLSTM_GRAD_TOL["float32"] * g.max()
                np.testing.assert_allclose(got_p[keep], w[keep], rtol=0,
                                           atol=STEP_PARAM_ATOL,
                                           err_msg=f"step 1 {key}")
            else:
                upd = w - before
                err = np.linalg.norm((got_p - before) - upd)
                assert err <= STEP2_UPDATE_TOL * np.linalg.norm(upd), key
    assert unused == 2 * 2 * (len(cfg.pattern) - 1)


def test_masked_decay_keeps_gradients_finite_at_chunk_128():
    """At the published chunk (128, one chunk of 128 tokens) the summed log
    decay above the diagonal passes the fp32 ``exp`` range: the
    reference's ``where(mask, exp(dec), 0)`` then has a NaN gradient; the
    port's ``exp(where(mask, dec, -inf))`` gives the same loss and finite
    gradients."""
    cfg_ref, params, cfg, _ = _pair("float32", chunk=128)
    toks = _tokens(cfg, 2, 128, seed=5)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    want, g_ref = jax.value_and_grad(lambda p: RM.loss_fn(
        cfg_ref, p, {k: jnp.asarray(v) for k, v in batch.items()}))(params)
    assert any(np.isnan(np.asarray(g)).any() for g in jax.tree.leaves(g_ref))
    lm = convert.lm_params_from_reference(jax.tree.map(np.asarray, params),
                                          cfg, device="cpu")
    got = PM.loss_fn(cfg, lm, {k: torch.from_numpy(v).long()
                               for k, v in batch.items()})
    got.backward()
    assert abs(got.item() - float(want)) <= LOSS_RTOL["float32"] * \
        float(want)
    for name, p in lm.named_parameters():
        if p.grad is not None:
            assert torch.isfinite(p.grad).all(), name
