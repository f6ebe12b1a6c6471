"""Port parity for jamba-1.5-large-398b (``--arch jamba_1_5_large_398b``):
the hybrid pattern of 8 slots (Mamba in 7, attention in slot 3; the MoE
FFN of 16 experts, top-2, in slots 1, 3, 5 and 7, a dense FFN in the
others), on the reference's ``reduced()`` config (8 layers, d 64, 4
heads, 2 kv heads, head_dim 16, 4 experts of 128, SSD heads of 32, state
4, chunk 8) with the reference's ``init_params(cfg, PRNGKey(0))`` carried
over by ``convert.lm_params_from_reference``.

What is held, and to what:
* the configs and the converter: the reference's tree leaf for leaf, and
  back bit for bit (the 8 slots' stacks);
* fp32 logits within ``FP32_TOL`` = 1e-4 (``tests/test_torch_lm.py``'s
  bound) over 16 tokens (two chunks), a prefill of 16 tokens and 3
  greedy decode steps (logits, tokens, the Mamba state and the attention
  layer's k/v, the cache's ``pos``);
* the loss with the MoE auxiliary loss, fp32 only (a top-2 router in
  bf16 may send a token to another expert on either side), within
  ``tests/test_torch_train.py``'s ``LOSS_RTOL``, and every gradient leaf
  within ``HYBRID_GRAD_TOL`` = 1e-3 of its largest entry, where
  ``GRAD_TOL`` is 1e-4.  This model at init amplifies rounding, as
  xlstm's does (``tests/test_torch_ssm_train.py``): one fp32 ulp added
  to the reference's ``embed`` moves the reference's own fp32 gradients
  by up to 3.11e-4 of a leaf's largest entry (the median 4.8e-5), and
  the port reads at most 3.04e-4 (layer 2's ``A_log``).  A zero, halved
  or sign-flipped leaf still fails;
* 3 AdamW steps of ``make_train_step`` against the reference's jitted
  step: the first step's loss and parameters with
  ``tests/test_torch_train.py``'s bounds (the parameters where the first
  gradient is above ``HYBRID_GRAD_TOL``, not ``SIGN_FLOOR`` = 1e-4, of
  its leaf's largest entry: the floor leaves out the entries whose
  gradient lies within the gradient bound, and the step clips the
  gradient's norm, so ``eps`` weighs in on small entries: an entry at
  1.45e-4 of its leaf's largest, whose gradient the port gives 4.3e-5 of
  that largest entry away, moves 1.04e-4 apart), the later losses within
  ``HYBRID_STEP_LOSS_RTOL`` = 2e-3 (relative) and each leaf's three-step
  update within ``HYBRID_UPDATE_TOL`` = 0.5 relative Frobenius error.
  AdamW's update is about ``lr * sign(m)``, so rounding flips the update
  of entries whose gradient is near zero, and this model amplifies the
  change: with one fp32 ulp taken from the reference's ``embed``, its own
  third loss moves by 4.97e-4 (the second 4.58e-5), 529,091 of the
  710,013 entries that the first-step test keeps move by more than
  ``STEP_PARAM_ATOL`` in three steps, and a leaf's three-step update by
  up to 0.245 (the median 0.128).  The port reads 4.59e-4 (5.5e-5),
  558,877 entries, 0.311 (0.137); the reference's ``loss_fn`` on the
  port's parameters after two steps gives the port's third loss within
  4e-7.  A zero or sign-flipped update reads 1 or 2;
* the serve and trainer CLIs at ``--reduced``.
"""
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import models as RM
from repro.configs import get_reduced as ref_reduced
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.optim import AdamW as RefAdamW
from repro_torch import configs as PC
from repro_torch import convert
from repro_torch.compression.deepca_powersgd import tree_leaves
from repro_torch.launch import serve
from repro_torch.launch import train as train_cli
from repro_torch.launch.steps import _grads, make_train_step
from repro_torch.models import model as PM
from repro_torch.optim import AdamW
from test_torch_train import (LOSS_RTOL, STEP_LOSS_RTOL, STEP_PARAM_ATOL,
                              _batches, _walk)

# the tensors here are tiny: one thread per test process keeps a
# parallel run's workers from spinning against each other
torch.set_num_threads(1)

ARCH = "jamba_1_5_large_398b"
FP32_TOL = 1e-4
#: a gradient leaf, relative to its largest entry (the module docstring)
HYBRID_GRAD_TOL = 1e-3
#: the second and third steps' losses, relative, and a leaf's three-step
#: update, relative Frobenius error (the module docstring)
HYBRID_STEP_LOSS_RTOL, HYBRID_UPDATE_TOL = 2e-3, 0.5


@functools.lru_cache(maxsize=None)
def _pair():
    cfg_ref = dataclasses.replace(ref_reduced(ARCH), dtype="float32")
    cfg = dataclasses.replace(PC.get_reduced(ARCH), dtype="float32")
    params = RM.init_params(cfg_ref, jax.random.PRNGKey(0))
    lm = convert.lm_params_from_reference(jax.tree.map(np.asarray, params),
                                          cfg, device="cpu")
    return cfg_ref, params, cfg, lm


def _tokens(cfg, b: int, s: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)
                                                ).astype(np.int32)


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def test_pattern_and_conversion_round_trip():
    """Layer ``l`` is pattern slot ``l % 8``: Mamba in 7 slots, attention
    in slot 3, the MoE FFN in the odd slots; the port's tree is the
    reference's (keys and shapes), and ``lm_named_from_reference``
    inverts ``lm_params_to_reference`` bit for bit."""
    cfg_ref, params, cfg, lm = _pair()
    kinds = [(PM.layer_spec(cfg, i).mixer, PM.layer_spec(cfg, i).ffn)
             for i in range(cfg.n_layers)]
    assert [m for m, _ in kinds] == ["mamba"] * 3 + ["attn"] + ["mamba"] * 4
    assert [f for _, f in kinds] == ["dense", "moe"] * 4
    tree = convert.lm_params_to_reference(lm, cfg)
    ref_keys = [(jax.tree_util.keystr(p), tuple(x.shape)) for p, x in
                jax.tree_util.tree_flatten_with_path(params)[0]]
    assert [(k, tuple(x.shape)) for k, x in tree_leaves(tree)] == ref_keys
    named = dict(lm.named_parameters())
    back = convert.lm_named_from_reference(tree, cfg)
    assert back.keys() == named.keys()
    for key, x in back.items():
        assert torch.equal(x, named[key]), key


def test_reduced_logits_match_reference():
    cfg_ref, params, cfg, lm = _pair()
    toks = _tokens(cfg, 2, 16, 0)
    want, _, _ = RM.forward(cfg_ref, params, jnp.asarray(toks))
    with torch.no_grad():
        got, _ = PM.forward(cfg, lm, torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=FP32_TOL)


def test_reduced_prefill_and_decode_match_reference():
    """A 16-token prefill (two chunks) into an fp32 cache of 19, then 3
    greedy decode steps: logits within ``FP32_TOL``, the same tokens, and
    the last step's Mamba state (layer 0) and attention k (layer 3)
    within it too."""
    cfg_ref, params, cfg, lm = _pair()
    toks = _tokens(cfg, 2, 16, 1)
    lj, cj = RM.prefill(cfg_ref, params, jnp.asarray(toks), max_seq=19,
                        cache_dtype=jnp.float32)
    lp, cp = PM.prefill(cfg, lm, torch.from_numpy(toks).long(), max_seq=19,
                        cache_dtype=torch.float32)
    for _ in range(3):
        np.testing.assert_allclose(lp.numpy(), _np(lj), rtol=0,
                                   atol=FP32_TOL)
        tok = lp.argmax(-1)[:, None]
        np.testing.assert_array_equal(tok.numpy()[:, 0],
                                      np.asarray(jnp.argmax(lj, -1)))
        lj, cj = RM.decode_step(cfg_ref, params, cj,
                                jnp.asarray(tok.numpy(), jnp.int32))
        lp, cp = PM.decode_step(cfg, lm, cp, tok)
    np.testing.assert_allclose(lp.numpy(), _np(lj), rtol=0, atol=FP32_TOL)
    assert cp["pos"] == int(cj["pos"]) == 19
    np.testing.assert_allclose(cp["layers"][0]["ssm"]["state"].numpy(),
                               _np(cj["groups"][0]["ssm"]["state"][0]),
                               rtol=0, atol=FP32_TOL)
    np.testing.assert_allclose(cp["layers"][3]["kv"]["k"].numpy(),
                               _np(cj["groups"][3]["kv"]["k"][0]), rtol=0,
                               atol=FP32_TOL)
    assert "kv" not in cp["layers"][0] and "ssm" not in cp["layers"][3]


@functools.lru_cache(maxsize=None)
def _train_params():
    cfg_ref = dataclasses.replace(ref_reduced(ARCH), dtype="float32")
    return cfg_ref, RM.init_params(cfg_ref, jax.random.PRNGKey(0))


def _lm(cfg, params):
    return convert.lm_params_from_reference(
        jax.tree.map(np.asarray, params), cfg, device="cpu")


def test_loss_and_grads_match_the_reference():
    """The loss with the 4 MoE layers' auxiliary loss and every gradient
    leaf (the Mamba leaves, the routers and expert stacks) against
    ``jax.value_and_grad`` of the reference's ``loss_fn``, fp32: the loss
    within ``LOSS_RTOL``, each leaf within ``HYBRID_GRAD_TOL`` of its
    largest entry."""
    cfg_ref, params = _train_params()
    cfg = dataclasses.replace(PC.get_reduced(ARCH), dtype="float32")
    raw = _batches(cfg, 1)[0]
    want, g_ref = jax.value_and_grad(lambda p: RM.loss_fn(
        cfg_ref, p, {k: jnp.asarray(v) for k, v in raw.items()}))(params)
    lm = _lm(cfg, params)
    got = PM.loss_fn(cfg, lm, {k: torch.from_numpy(v)
                               for k, v in raw.items()})
    got.backward()
    g_port = convert.lm_params_to_reference(_grads(lm), cfg)
    assert got.dtype == torch.float32
    assert abs(got.item() - float(want)) <= \
        LOSS_RTOL["float32"] * float(want)
    flat = jax.tree_util.tree_flatten_with_path(g_ref)[0]
    assert len(flat) == len(list(tree_leaves(g_port)))
    for path, g in flat:
        g = np.asarray(g, np.float32)
        mine = _walk(g_port, path).numpy()
        key = jax.tree_util.keystr(path)
        assert mine.shape == g.shape, key
        np.testing.assert_allclose(
            mine, g, rtol=0, atol=HYBRID_GRAD_TOL * np.abs(g).max(),
            err_msg=key)


def test_train_steps_match_the_reference():
    """3 fp32 steps of ``make_train_step`` against the reference's jitted
    step: the first loss within ``STEP_LOSS_RTOL`` and the parameters
    after it within ``STEP_PARAM_ATOL`` where the gradient is above
    ``HYBRID_GRAD_TOL`` of its leaf's largest entry (at most 1% of the
    nonzero ones left out: ``tests/test_torch_archs.py``'s test with this
    model's floor); the later losses
    within ``HYBRID_STEP_LOSS_RTOL`` and each leaf's update over the three
    steps within ``HYBRID_UPDATE_TOL`` relative Frobenius error."""
    cfg_ref, params = _train_params()
    cfg = dataclasses.replace(PC.get_reduced(ARCH), dtype="float32")
    batches = _batches(cfg, 3)
    ref_opt, opt = RefAdamW(lr=3e-3), AdamW(lr=3e-3)
    g1 = jax.jit(jax.grad(lambda p: RM.loss_fn(cfg_ref, p, {
        k: jnp.asarray(v) for k, v in batches[0].items()})))(params)
    ref_step = jax.jit(ref_make_train_step(cfg_ref, ref_opt))
    lm = _lm(cfg, params)
    step = make_train_step(cfg, opt)
    rp, rs = params, ref_opt.init(params)
    ps = opt.init({k: p.detach() for k, p in lm.named_parameters()})
    for i, raw in enumerate(batches):
        rp, rs, want = ref_step(rp, rs, {k: jnp.asarray(v)
                                         for k, v in raw.items()})
        ps, got = step(lm, ps, {k: torch.from_numpy(v)
                                for k, v in raw.items()})
        rtol = HYBRID_STEP_LOSS_RTOL if i else STEP_LOSS_RTOL
        assert abs(float(got) - float(want)) <= rtol * float(want), i
        if i:
            continue
        first = convert.lm_params_to_reference(lm, cfg)
        left_out = 0
        for path, w in jax.tree_util.tree_flatten_with_path(rp)[0]:
            g = np.abs(np.asarray(_walk(g1, path)))
            keep = g > HYBRID_GRAD_TOL * g.max()
            left_out += int((~keep & (g != 0)).sum())
            np.testing.assert_allclose(
                _walk(first, path).numpy()[keep], np.asarray(w)[keep],
                rtol=0, atol=STEP_PARAM_ATOL,
                err_msg=jax.tree_util.keystr(path))
        n = sum(x.size for x in jax.tree.leaves(rp))
        assert left_out < 0.01 * n, (left_out, n)
    final = convert.lm_params_to_reference(lm, cfg)
    for path, w in jax.tree_util.tree_flatten_with_path(rp)[0]:
        start = np.asarray(_walk(params, path))
        want_up = np.asarray(w) - start
        got_up = _walk(final, path).numpy() - start
        err = np.linalg.norm(got_up - want_up) / np.linalg.norm(want_up)
        assert err <= HYBRID_UPDATE_TOL, (jax.tree_util.keystr(path), err)


def test_jamba_serves_and_trains_from_the_clis(capsys):
    """``serve --arch jamba-1.5-large-398b --reduced --device cpu`` (a
    16-token prompt: the chunk rule) and the trainer CLI run; a prompt
    that breaks the chunk rule raises ``ValueError`` first."""
    res = serve.main(["--arch", "jamba-1.5-large-398b", "--reduced",
                      "--device", "cpu", "--batch", "2", "--prompt-len",
                      "16", "--gen", "3"])
    assert res["tokens"].shape == (2, 3)
    assert torch.isfinite(res["first_logits"]).all()
    with pytest.raises(ValueError):
        serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                    "--prompt-len", "12"])
    train_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                    "--steps", "2", "--batch", "2", "--seq", "16",
                    "--log-every", "1"])
    out = capsys.readouterr().out
    assert "generated (2, 3)" in out and "final loss" in out
