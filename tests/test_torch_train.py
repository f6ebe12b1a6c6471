"""Port parity for the LM training path: the loss and its gradients, the
train step, and the stacked-layout converter that checkpoints and the
compressors use.

The reduced SmolLM (2 layers, d 64, head_dim 16) with the reference's
``init_params(cfg, PRNGKey(0))`` carried over by
``convert.lm_params_from_reference``, on the reference's token stream.

Tolerances (readings at this seed in brackets):

* fp32 (``dtype="float32"``): ``loss_fn`` within 1e-5 relative [3e-7] and
  every gradient leaf within 1e-4 of its largest entry [1.3e-6]; both
  sides compute in fp32 and sum in other orders;
* bf16 (the published dtype): the loss within 1e-3 relative [8e-5] and
  every gradient leaf within 5e-2 of its largest entry [1.7e-2]: the
  packages round to bf16 at other places (``test_torch_lm.py``'s
  ``LM_BF16_TOL`` for the logits), and the backward compounds it;
* 10 fp32 steps of ``make_train_step`` against the reference's jitted
  step: each loss within 1e-5 relative [2.4e-7] and the final parameters
  within 1e-4 absolute [1.4e-5; lr is 3e-3].  AdamW's first update is
  ``lr * sign(g)``, which a gradient error could flip where ``|g|`` is
  within that error of 0: the parameters are compared only where the
  reference's first gradient is above 1e-4 of its leaf's largest entry,
  a hundred times the fp32 gradient error above, and the test counts how
  many entries that leaves out.
"""
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import models as RM
from repro.checkpoint.checkpoint import _flatten as ref_flatten
from repro.configs import get_reduced as ref_reduced
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.optim import AdamW as RefAdamW
from repro.optim import cosine_schedule as ref_cosine
from repro_torch import configs as PC
from repro_torch import convert
from repro_torch.checkpoint.checkpoint import _flatten as port_flatten
from repro_torch.compression.deepca_powersgd import tree_leaves
from repro_torch.data import SyntheticTokenStream, TokenStreamConfig
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import checkpoint_tree, load_checkpoint_tree
from repro_torch.models import model as PM
from repro_torch.models.layers import cross_entropy
from repro_torch.optim import AdamW, cosine_schedule

torch.set_num_threads(1)

LOSS_RTOL = {"float32": 1e-5, "bfloat16": 1e-3}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
STEP_LOSS_RTOL, STEP_PARAM_ATOL = 1e-5, 1e-4
SIGN_FLOOR = 1e-4


@functools.lru_cache(maxsize=None)
def _pair(dtype: str):
    cfg_ref = dataclasses.replace(ref_reduced("smollm_135m"), dtype=dtype)
    cfg = dataclasses.replace(PC.get_reduced("smollm_135m"), dtype=dtype)
    params = RM.init_params(cfg_ref, jax.random.PRNGKey(0))
    return cfg_ref, params, cfg


def _lm(cfg, params):
    return convert.lm_params_from_reference(
        jax.tree.map(np.asarray, params), cfg, device="cpu")


def _batches(cfg, n: int, batch: int = 4, seq: int = 32):
    it = iter(SyntheticTokenStream(TokenStreamConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=0)))
    return [next(it) for _ in range(n)]


def _walk(tree, path):
    for entry in path:
        tree = tree[entry.key if hasattr(entry, "key") else entry.idx]
    return tree


def test_cross_entropy_is_the_mean_token_nll():
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((2, 5, 7)).astype(
        np.float32)).to(torch.bfloat16)
    labels = torch.from_numpy(rng.integers(0, 7, (2, 5)).astype(np.int32))
    want = torch.nn.functional.cross_entropy(
        logits.float().reshape(-1, 7), labels.long().reshape(-1))
    got = cross_entropy(logits, labels)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_the_reference(dtype):
    cfg_ref, params, cfg = _pair(dtype)
    raw = _batches(cfg, 1)[0]
    want, g_ref = jax.value_and_grad(lambda p: RM.loss_fn(
        cfg_ref, p, {k: jnp.asarray(v) for k, v in raw.items()}))(params)
    lm = _lm(cfg, params)
    got = PM.loss_fn(cfg, lm, {k: torch.from_numpy(v)
                               for k, v in raw.items()})
    assert got.dtype == torch.float32 and got.requires_grad
    got.backward()
    assert abs(got.item() - float(want)) <= LOSS_RTOL[dtype] * float(want)
    g_port = convert.lm_params_to_reference(
        {k: p.grad for k, p in lm.named_parameters()}, cfg)
    flat = jax.tree_util.tree_flatten_with_path(g_ref)[0]
    assert len(flat) == len(list(tree_leaves(g_port)))
    for path, g in flat:
        g = np.asarray(g, np.float32)
        mine = _walk(g_port, path).numpy()
        assert mine.shape == g.shape, jax.tree_util.keystr(path)
        np.testing.assert_allclose(mine, g, rtol=0,
                                   atol=GRAD_TOL[dtype] * np.abs(g).max(),
                                   err_msg=jax.tree_util.keystr(path))


def test_remat_leaves_the_numbers_and_recomputes_each_layer(monkeypatch):
    """Per-layer checkpointing changes no bit of the loss or the
    gradients on the CPU, and runs each block twice per step."""
    cfg_ref, params, cfg = _pair("float32")
    batch = {k: torch.from_numpy(v) for k, v in _batches(cfg, 1)[0].items()}
    out = {}
    real = PM.block_forward
    calls = []

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(PM, "block_forward", counting)
    for remat in (False, True):
        lm = _lm(cfg, params)
        calls.clear()
        logits, _ = PM.forward(cfg, lm, batch["tokens"], remat=remat)
        loss = cross_entropy(logits, batch["labels"])
        loss.backward()
        out[remat] = (loss.detach(), {k: p.grad.clone()
                                      for k, p in lm.named_parameters()},
                      len(calls))
    assert torch.equal(out[False][0], out[True][0])
    for key, g in out[False][1].items():
        assert torch.equal(g, out[True][1][key]), key
    assert out[False][2] == cfg.n_layers and out[True][2] == 2 * cfg.n_layers
    with pytest.raises(ValueError, match="remat"):
        PM.forward(cfg, _lm(cfg, params), batch["tokens"], remat=True,
                   cache=PM.init_cache(cfg, 4, 32, device="cpu"))


def test_train_steps_match_the_reference():
    cfg_ref, params, cfg = _pair("float32")
    batches = _batches(cfg, 10)
    ref_opt = RefAdamW(lr=ref_cosine(3e-3, 5, 10))
    opt = AdamW(lr=cosine_schedule(3e-3, 5, 10))
    g1 = jax.grad(lambda p: RM.loss_fn(cfg_ref, p, {
        k: jnp.asarray(v) for k, v in batches[0].items()}))(params)
    ref_step = jax.jit(ref_make_train_step(cfg_ref, ref_opt))
    lm = _lm(cfg, params)
    step = make_train_step(cfg, opt)
    rp, rs = params, ref_opt.init(params)
    ps = opt.init({k: p.detach() for k, p in lm.named_parameters()})
    for raw in batches:
        rp, rs, want = ref_step(rp, rs, {k: jnp.asarray(v)
                                         for k, v in raw.items()})
        ps, got = step(lm, ps, {k: torch.from_numpy(v)
                                for k, v in raw.items()})
        assert not got.requires_grad
        assert abs(float(got) - float(want)) <= STEP_LOSS_RTOL * float(want)
    assert int(ps.step) == int(rs.step) == 10
    final = convert.lm_params_to_reference(lm, cfg)
    left_out = 0
    for path, want in jax.tree_util.tree_flatten_with_path(rp)[0]:
        g = np.abs(np.asarray(_walk(g1, path)))
        keep = g > SIGN_FLOOR * g.max()
        left_out += int((~keep).sum())
        got = _walk(final, path).numpy()
        np.testing.assert_allclose(got[keep], np.asarray(want)[keep], rtol=0,
                                   atol=STEP_PARAM_ATOL,
                                   err_msg=jax.tree_util.keystr(path))
    n = sum(x.size for x in jax.tree.leaves(rp))
    assert left_out < 0.01 * n, (left_out, n)


def test_stacked_layout_round_trips_with_the_references_keys():
    """``lm_params_to_reference`` gives the reference's tree: its leaf
    keys (the compressors' keystr and the checkpoint's flat keys), shapes
    and dtypes, for the parameters, for gradients and for the AdamW state;
    and ``lm_named_from_reference`` inverts it bit for bit."""
    cfg_ref, params, cfg = _pair("float32")
    lm = PM.init_params(cfg, 3, device="cpu")
    tree = convert.lm_params_to_reference(lm, cfg)
    ref_keys = [(jax.tree_util.keystr(p), tuple(x.shape)) for p, x in
                jax.tree_util.tree_flatten_with_path(params)[0]]
    assert [(k, tuple(x.shape)) for k, x in tree_leaves(tree)] == ref_keys
    back = convert.lm_named_from_reference(tree, cfg)
    named = dict(lm.named_parameters())
    assert back.keys() == named.keys()
    for key, x in back.items():
        assert torch.equal(x, named[key]), key
    grads = {k: torch.randn_like(p) for k, p in named.items()}
    g_tree = convert.lm_params_to_reference(grads, cfg)
    assert [(k, tuple(x.shape)) for k, x in tree_leaves(g_tree)] == ref_keys
    for key, x in convert.lm_named_from_reference(g_tree, cfg).items():
        assert torch.equal(x, grads[key]), key
    # (params, AdamWState) as the checkpoints hold them
    ref_opt = RefAdamW()
    want = ref_flatten((params, ref_opt.init(params)))
    opt = AdamW()
    state = opt.init({k: p.detach() for k, p in named.items()})
    got = port_flatten(checkpoint_tree(cfg, lm, state))
    assert list(got) == list(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        assert got[key].dtype == want[key].dtype, key


def test_checkpoint_tree_loads_back_into_a_model_and_state():
    cfg_ref, params, cfg = _pair("float32")
    src = PM.init_params(cfg, 1, device="cpu")
    opt = AdamW()
    state = opt.init({k: p.detach() for k, p in src.named_parameters()})
    for k in state.mu:
        state.mu[k].normal_()
        state.nu[k].uniform_()
    state = state._replace(step=torch.tensor(7, dtype=torch.int32))
    tree = checkpoint_tree(cfg, src, state)
    dst = PM.init_params(cfg, 2, device="cpu")
    fresh = opt.init({k: p.detach() for k, p in dst.named_parameters()})
    loaded = load_checkpoint_tree(cfg, tree, dst, fresh)
    assert int(loaded.step) == 7 and loaded.step.device.type == "cpu"
    for (k, a), (_, b) in zip(src.named_parameters(), dst.named_parameters()):
        assert torch.equal(a, b), k
    for k in state.mu:
        assert torch.equal(loaded.mu[k], state.mu[k])
        assert torch.equal(loaded.nu[k], state.nu[k])
