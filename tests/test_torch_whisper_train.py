"""Port parity for training the encoder-decoder: the reduced whisper-small
(2 encoder and 2 decoder layers, d 64, 4 heads, head_dim 16, 12 frames)
with the reference's ``init_params(cfg, PRNGKey(0))`` carried over by
``convert.lm_params_from_reference``, on the reference's token stream and
seeded frames.

Tolerances are ``tests/test_torch_train.py``'s (readings at this seed in
brackets):

* the loss within ``LOSS_RTOL`` relative, 1e-5 in fp32 [7.9e-8] and 1e-3
  in bf16 [6.6e-6];
* every gradient leaf, the encoder's included, within ``GRAD_TOL`` of its
  largest entry and within ``GRAD_TOL`` relative Frobenius error: 1e-4 in
  fp32 [1.6e-6, 1.4e-6] and 5e-2 in bf16 [1.7e-2, 1.6e-2];
* two fp32 AdamW steps: each loss within 1e-5 relative and the parameters
  within 1e-4 absolute where the reference's first gradient is above 1e-4
  of its leaf's largest entry (``SIGN_FLOOR``: AdamW's first update is
  ``lr * sign(g)``), fewer than 1% of the entries left out [0.73%];
  entries whose gradient is exactly 0 (embedding rows no token reads)
  are compared, since both sides only decay them;
* the non-causal backward's plain formulas against ``jax.vjp`` of the
  reference's ``_einsum_attention`` and against torch autograd of the
  plain forward, within 1e-5 of max|ref| (``BWD_TOL``, both fp32).
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
from repro.models.attention import _einsum_attention
from repro.optim import AdamW as RefAdamW
from repro_torch import configs as PC
from repro_torch import convert
from repro_torch.compression.deepca_powersgd import tree_leaves
from repro_torch.data import SyntheticTokenStream, TokenStreamConfig
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import train
from repro_torch.launch.steps import _grads, check_batch, make_train_step
from repro_torch.models import model as PM
from repro_torch.models.layers import cross_entropy
from repro_torch.optim import AdamW
from test_torch_flash_attention import (BWD_BF16_TOL, _emulate_bf16_backward,
                                        _emulate_bf16_kernel)

# the tensors here are tiny: one thread per test process keeps a
# parallel run's workers from spinning against each other
torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ARCH = "whisper_small"
LOSS_RTOL = {"float32": 1e-5, "bfloat16": 1e-3}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
STEP_LOSS_RTOL, STEP_PARAM_ATOL = 1e-5, 1e-4
SIGN_FLOOR = 1e-4
BWD_TOL = 1e-5


@functools.lru_cache(maxsize=None)
def _pair(dtype: str):
    cfg_ref = dataclasses.replace(ref_reduced(ARCH), dtype=dtype)
    cfg = dataclasses.replace(PC.get_reduced(ARCH), dtype=dtype)
    params = RM.init_params(cfg_ref, jax.random.PRNGKey(0))
    return cfg_ref, params, cfg


def _lm(cfg, params):
    return convert.lm_params_from_reference(
        jax.tree.map(np.asarray, params), cfg, device="cpu")


def _batches(cfg, n: int, batch: int = 4, seq: int = 32):
    """The trainer's token stream, each batch with frame embeddings drawn
    as the serve draws them (unit normals times 0.02, seeded numpy)."""
    it = iter(SyntheticTokenStream(TokenStreamConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=0)))
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        raw = next(it)
        raw["embeds"] = (rng.standard_normal(
            (batch, cfg.n_frames, cfg.d_model)) * 0.02).astype(np.float32)
        out.append(raw)
    return out


def _jnp(raw):
    return {k: jnp.asarray(v) for k, v in raw.items()}


def _torch(raw):
    return {k: torch.from_numpy(v) for k, v in raw.items()}


def _walk(tree, path):
    for entry in path:
        tree = tree[entry.key if hasattr(entry, "key") else entry.idx]
    return tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_the_reference(dtype):
    """The loss and every gradient leaf (decoder, encoder, embeddings,
    head) against ``jax.value_and_grad`` of the reference's ``loss_fn``;
    every leaf of the port gets a gradient, the encoder's through the
    decoder's cross-attention."""
    cfg_ref, params, cfg = _pair(dtype)
    raw = _batches(cfg, 1)[0]
    want, g_ref = jax.value_and_grad(
        lambda p: RM.loss_fn(cfg_ref, p, _jnp(raw)))(params)
    lm = _lm(cfg, params)
    got = PM.loss_fn(cfg, lm, _torch(raw))
    assert got.dtype == torch.float32 and got.requires_grad
    got.backward()
    assert abs(got.item() - float(want)) <= LOSS_RTOL[dtype] * float(want)
    assert all(p.grad is not None for p in lm.parameters())
    g_port = convert.lm_params_to_reference(_grads(lm), cfg)
    flat = jax.tree_util.tree_flatten_with_path(g_ref)[0]
    assert len(flat) == len(list(tree_leaves(g_port)))
    keys = [jax.tree_util.keystr(path) for path, _ in flat]
    assert sum(k.startswith("['encoder']") for k in keys) == 10
    tol = GRAD_TOL[dtype]
    for (path, g), key in zip(flat, keys):
        g = np.asarray(g, np.float32)
        mine = _walk(g_port, path).numpy()
        assert mine.shape == g.shape, key
        assert np.abs(g).max() > 0, key
        np.testing.assert_allclose(mine, g, rtol=0,
                                   atol=tol * np.abs(g).max(), err_msg=key)
        assert np.linalg.norm(mine - g) <= tol * np.linalg.norm(g), key


def test_train_steps_match_the_reference():
    """Two fp32 steps of ``make_train_step`` against the reference's
    jitted step, the frames in the batch: the losses, then every
    parameter (the encoder's included) where the first gradient's sign
    is the reference's."""
    cfg_ref, params, cfg = _pair("float32")
    batches = _batches(cfg, 2)
    ref_opt, opt = RefAdamW(lr=3e-3), AdamW(lr=3e-3)
    g1 = jax.grad(lambda p: RM.loss_fn(cfg_ref, p, _jnp(batches[0])))(params)
    ref_step = jax.jit(ref_make_train_step(cfg_ref, ref_opt))
    lm = _lm(cfg, params)
    step = make_train_step(cfg, opt)
    rp, rs = params, ref_opt.init(params)
    ps = opt.init({k: p.detach() for k, p in lm.named_parameters()})
    for raw in batches:
        rp, rs, want = ref_step(rp, rs, _jnp(raw))
        ps, got = step(lm, ps, _torch(raw))
        assert not got.requires_grad
        assert abs(float(got) - float(want)) <= STEP_LOSS_RTOL * float(want)
    assert int(ps.step) == int(rs.step) == 2
    final = convert.lm_params_to_reference(lm, cfg)
    left_out, moved = 0, set()
    for path, want in jax.tree_util.tree_flatten_with_path(rp)[0]:
        key = jax.tree_util.keystr(path)
        g = np.abs(np.asarray(_walk(g1, path)))
        # where the gradient is exactly 0 (an embedding row no token of
        # the batches reads) both sides only decay the entry
        keep = (g > SIGN_FLOOR * g.max()) | (g == 0)
        left_out += int((~keep).sum())
        got = _walk(final, path).numpy()
        want = np.asarray(want)
        np.testing.assert_allclose(got[keep], want[keep], rtol=0,
                                   atol=STEP_PARAM_ATOL, err_msg=key)
        if not np.array_equal(got, np.asarray(_walk(params, path))):
            moved.add(key)
    n = sum(x.size for x in jax.tree.leaves(rp))
    assert left_out < 0.01 * n, (left_out, n)
    assert len(moved) == len(jax.tree.leaves(rp))     # every leaf updated


def test_remat_recomputes_each_decoder_layer_and_never_the_encoder(
        monkeypatch):
    """Under ``remat`` (``loss_fn``'s) each decoder block runs twice a
    step (the forward, then its recompute in the backward) and each
    encoder block once, as the reference's ``_encode`` scans its groups
    without remat; the loss and the gradients are bit-equal to a step
    without remat on the CPU."""
    cfg_ref, params, cfg = _pair("float32")
    batch = _torch(_batches(cfg, 1)[0])
    real = PM.block_forward
    calls = []

    def counting(cfg_, spec, *a, **kw):
        calls.append("encoder" if spec == PM.ENCODER_SPEC else "decoder")
        return real(cfg_, spec, *a, **kw)

    monkeypatch.setattr(PM, "block_forward", counting)
    out = {}
    for remat in (False, True):
        lm = _lm(cfg, params)
        calls.clear()
        logits, _ = PM.forward(cfg, lm, batch["tokens"],
                               embeds=batch["embeds"], remat=remat)
        loss = cross_entropy(logits, batch["labels"])
        loss.backward()
        out[remat] = (loss.detach(), {k: p.grad.clone()
                                      for k, p in lm.named_parameters()},
                      calls.count("encoder"), calls.count("decoder"))
    assert out[False][2:] == (cfg.encoder_layers, cfg.n_layers)
    assert out[True][2:] == (cfg.encoder_layers, 2 * cfg.n_layers)
    assert torch.equal(out[False][0], out[True][0])
    for key, g in out[False][1].items():
        assert torch.equal(g, out[True][1][key]), key


def _qkv(b, h, hkv, sq, skv, hd, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32) for shape in (
        (b, h, sq, hd), (b, hkv, skv, hd), (b, hkv, skv, hd), (b, h, sq, hd)))


@pytest.mark.parametrize("h,hkv", [(4, 2), (12, 12)])
@pytest.mark.parametrize("sq,skv", [(33, 100), (8, 12)])
def test_non_causal_backward_plain_matches_the_reference_vjp(sq, skv, h,
                                                             hkv):
    """``flash_attention_backward_plain`` (the backward kernel's oracle)
    with ``causal=False`` at Sq != Skv, GQA 4:2 and 12:12, hd 64, against
    ``jax.vjp`` of the reference's ``_einsum_attention(q, k, v, False)``
    (its training attention, kv heads repeated as its ``sdpa`` repeats
    them) and against torch autograd of the plain forward, fp32."""
    rep = h // hkv
    q, k, v, do = _qkv(2, h, hkv, sq, skv, 64, sq * 100 + skv + h)

    def ref(q_, k_, v_):
        return _einsum_attention(q_, jnp.repeat(k_, rep, axis=1),
                                 jnp.repeat(v_, rep, axis=1), False)

    _, vjp = jax.vjp(ref, *(jnp.asarray(x) for x in (q, k, v)))
    want_jax = vjp(jnp.asarray(do))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, lse = fa.flash_attention_plain(qt, kt, vt, causal=False,
                                        return_lse=True)
    dot = torch.from_numpy(do)
    out.backward(dot)
    got = fa.flash_attention_backward_plain(
        qt.detach(), kt.detach(), vt.detach(), out.detach(), lse, dot,
        causal=False)
    for name, mine, wj, x in zip("qkv", got, want_jax, (qt, kt, vt)):
        wj = np.asarray(wj)
        assert mine.shape == wj.shape
        np.testing.assert_allclose(mine.numpy(), wj, rtol=0,
                                   atol=BWD_TOL * np.abs(wj).max(),
                                   err_msg=f"d{name} vs jax.vjp")
        ta = x.grad.numpy()
        np.testing.assert_allclose(mine.numpy(), ta, rtol=0,
                                   atol=BWD_TOL * np.abs(ta).max(),
                                   err_msg=f"d{name} vs torch autograd")


def test_backward_d_from_the_fp32_output_where_kv_rows_share_a_mean():
    """Why the training path hands the bf16 backward the forward's fp32
    output: where the rows of k and v share a mean as large as their
    spread (whisper's decoder after the cross-attentions), ``D =
    rowsum(dO o)`` from the bf16 o leaves ``dS`` summing to the rounding
    of o over a row, and ``dQ = dS K`` multiplies that by K's mean: the
    emulated kernels' dq (``tests/test_torch_flash_attention.py``'s
    emulations, non-causal) then misses ``BWD_BF16_TOL`` of the exact
    gradient (autograd of the plain forward) [3.1e-2]; from the fp32 o
    it meets it, with dk and dv [5.5e-3, 2.8e-3, 3.1e-3]."""
    rng = np.random.default_rng(6)
    b, h, hkv, sq, skv, hd = 2, 4, 2, 64, 300, 64

    def draw(shape, mean):
        base = rng.standard_normal((shape[0], shape[1], 1, shape[3])) * mean
        return torch.from_numpy((base + rng.standard_normal(shape)).astype(
            np.float32)).bfloat16()

    q = draw((b, h, sq, hd), 0.0)
    k, v = draw((b, hkv, skv, hd), 1.0), draw((b, hkv, skv, hd), 1.0)
    do = draw((b, h, sq, hd), 0.0)
    o32 = _emulate_bf16_kernel(q, k, v, False)
    _, lse = fa.flash_attention_plain(q, k, v, causal=False,
                                      return_lse=True)
    exact = [x.float().requires_grad_() for x in (q, k, v)]
    fa.flash_attention_plain(*exact, causal=False).backward(do.float())

    def errors(o_handed):
        got = _emulate_bf16_backward(q, k, v, o_handed, lse, do,
                                     causal=False)
        return [float((g.float() - x.grad).abs().max() / x.grad.abs().max())
                for g, x in zip(got, exact)]

    from_bf16, from_fp32 = errors(o32.bfloat16()), errors(o32)
    assert from_bf16[0] > BWD_BF16_TOL, from_bf16
    assert max(from_fp32) <= BWD_BF16_TOL, from_fp32


def test_train_step_checks_the_frames():
    """``make_train_step`` refuses an encoder-decoder batch without frame
    embeddings, or with another batch or width, before any forward; the
    trainer CLI refuses whisper (its stream has no frames, as the
    reference's has none)."""
    _, _, cfg = _pair("float32")
    raw = _torch(_batches(cfg, 1)[0])
    check_batch(cfg, raw)
    bad = [{k: x for k, x in raw.items() if k != "embeds"},
           {**raw, "embeds": raw["embeds"][:2]},
           {**raw, "embeds": raw["embeds"][..., :8]}]
    lm = PM.init_params(cfg, 0, device="cpu")
    opt = AdamW(lr=1e-3)
    step = make_train_step(cfg, opt)
    state = opt.init({k: p.detach() for k, p in lm.named_parameters()})
    for batch in bad:
        with pytest.raises(ValueError):
            step(lm, state, batch)
    assert all(p.grad is None for p in lm.parameters())
    with pytest.raises(ValueError, match="frames"):
        train.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                    "--steps", "1"])
