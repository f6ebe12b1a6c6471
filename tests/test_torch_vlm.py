"""Port parity for qwen2-vl-72b (``--arch qwen2_vl_72b``): M-RoPE and the
prepended patch embeddings, on the reference's ``reduced()`` config (2
dense GQA layers, d 64, 4 heads, 2 kv heads, head_dim 16, QKV bias,
M-RoPE sections (2, 3, 3), 8 patches) with the reference's
``init_params(cfg, PRNGKey(0))`` carried over by
``convert.lm_params_from_reference``.

What is held, and to what:
* ``apply_rope`` with (3, B, S) positions at the reduced sections (2, 3,
  3) and the published (16, 24, 24) against the reference's, fp32 within
  ``ROPE_TOL`` = 1e-6 (both take the angles in fp32 and rotate the same
  half-split pairs; cos and sin of the same fp32 angle differ by an ulp);
* ``make_positions``' (3, B, S) grid against the reference's, exactly: at
  offset 0 over the patches and the text, inside the patches, and at a
  decode offset past them, for the reduced 8 patches (grid 2) and the
  published 1024 (grid 32);
* the whole model with patches, fp32: the logits over patches and text
  within ``FP32_TOL`` = 1e-4, a prefill of patches plus 9 tokens and 3
  greedy decode steps (the logits, the tokens, the cache's ``pos``);
* the loss (the text tail's only) and every gradient leaf, fp32 and bf16,
  with ``tests/test_torch_train.py``'s harness and bounds, and 3 AdamW
  steps of ``make_train_step`` against the reference's jitted step;
* the batch and prefill checks of the patches' shape, the serve CLI at
  ``--reduced``, and the trainer CLI's refusal (its stream has no
  patches, as the reference's has none).
"""
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import models as RM
from repro.configs import get_config as ref_get_config
from repro.configs import get_reduced as ref_reduced
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.models import layers as RL
from repro.models import model as RMM
from repro.optim import AdamW as RefAdamW
from repro_torch import configs as PC
from repro_torch import convert
from repro_torch.compression.deepca_powersgd import tree_leaves
from repro_torch.launch import serve
from repro_torch.launch import train as train_cli
from repro_torch.launch.steps import (_grads, check_batch, make_prefill_step,
                                      make_train_step)
from repro_torch.models import layers as PL
from repro_torch.models import model as PM
from repro_torch.optim import AdamW
from test_torch_train import (GRAD_TOL, LOSS_RTOL, SIGN_FLOOR,
                              STEP_LOSS_RTOL, STEP_PARAM_ATOL, _batches,
                              _walk)

# the tensors here are tiny: one thread per test process keeps a
# parallel run's workers from spinning against each other
torch.set_num_threads(1)

ARCH = "qwen2_vl_72b"
FP32_TOL = 1e-4
ROPE_TOL = 1e-6


@functools.lru_cache(maxsize=None)
def _pair(dtype: str = "float32"):
    cfg_ref = dataclasses.replace(ref_reduced(ARCH), dtype=dtype)
    cfg = dataclasses.replace(PC.get_reduced(ARCH), dtype=dtype)
    params = RM.init_params(cfg_ref, jax.random.PRNGKey(0))
    lm = convert.lm_params_from_reference(jax.tree.map(np.asarray, params),
                                          cfg, device="cpu")
    return cfg_ref, params, cfg, lm


def _patches(cfg, b: int, seed: int) -> np.ndarray:
    """(B, n_patches, d) fp32 patch embeddings, drawn as serve draws them
    (``standard_normal * 0.02``) but kept in fp32."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, cfg.n_patches, cfg.d_model)) * 0.02
            ).astype(np.float32)


def _tokens(cfg, b: int, s: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)
                                                ).astype(np.int32)


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


@pytest.mark.parametrize("sections,hd", [((2, 3, 3), 16),
                                         ((16, 24, 24), 128)])
def test_mrope_matches_reference(sections, hd):
    """Each (t, h, w) section rotated by its own position stream, against
    the reference's ``apply_rope`` on (3, B, S) positions that differ per
    stream; the (B, S) path and a (3, B, S) input without sections rotate
    by the first stream, as there; sections that do not cover ``hd // 2``
    raise (the reference asserts)."""
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((2, 11, 3, hd)).astype(np.float32)
    pos = rng.integers(0, 4096, (3, 2, 11)).astype(np.int32)
    want = RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections)
    got = PL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                        sections)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=ROPE_TOL)
    plain = PL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    np.testing.assert_allclose(
        plain.numpy(), _np(RL.apply_rope(jnp.asarray(x), jnp.asarray(pos[0]),
                                         1e6)), rtol=0, atol=ROPE_TOL)
    assert not np.allclose(plain.numpy(), got.numpy(), atol=1e-3)
    with pytest.raises(ValueError, match="sections"):
        PL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                      (sections[0] + 1,) + sections[1:])


@pytest.mark.parametrize("published", [False, True])
@pytest.mark.parametrize("where", ["prompt", "inside", "decode"])
def test_make_positions_matches_reference(published, where):
    """The (3, B, S) grid equals the reference's: the whole prompt (the
    patches, then 5 text tokens) from offset 0, a span inside the
    patches, and one decode step 7 tokens past the patches (text
    positions in all three streams)."""
    cfg_ref = ref_get_config(ARCH) if published else ref_reduced(ARCH)
    cfg = PC.get_config(ARCH) if published else PC.get_reduced(ARCH)
    n = cfg.n_patches
    offset, seq = {"prompt": (0, n + 5), "inside": (n // 2 - 1, 3),
                   "decode": (n + 7, 1)}[where]
    want = np.asarray(RMM.make_positions(cfg_ref, 2, seq, offset))
    got = PM.make_positions(cfg, 2, seq, offset=offset, device="cpu")
    assert got.shape == (3, 2, seq) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    grid = 32 if published else 2
    if where == "decode":
        assert (got == 7 + grid).all()


def test_reduced_logits_match_reference():
    """Patches prepended: logits over the patches and the text, fp32
    within ``FP32_TOL``; the parameters are the reference's leaf for
    leaf (the QKV biases included)."""
    cfg_ref, params, cfg, lm = _pair()
    toks, emb = _tokens(cfg, 2, 12, 0), _patches(cfg, 2, 1)
    want, _, _ = RM.forward(cfg_ref, params, jnp.asarray(toks),
                            embeds=jnp.asarray(emb))
    with torch.no_grad():
        got, _ = PM.forward(cfg, lm, torch.from_numpy(toks).long(),
                            embeds=torch.from_numpy(emb))
    assert got.shape == (2, cfg.n_patches + 12, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=FP32_TOL)
    n = sum(p.numel() for p in lm.parameters())
    assert n == sum(x.size for x in jax.tree.leaves(params))
    assert lm.layers[0].mixer.bq.shape == (cfg.n_heads * cfg.head_dim,)


def test_reduced_prefill_and_decode_match_reference():
    """A prefill of the 8 patches and 9 tokens into an fp32 cache of 20,
    then 3 greedy decode steps past the patches: the logits within
    ``FP32_TOL``, the same tokens, and ``pos`` counting the patches."""
    cfg_ref, params, cfg, lm = _pair()
    toks, emb = _tokens(cfg, 2, 9, 2), _patches(cfg, 2, 3)
    max_seq = cfg.n_patches + 12
    lj, cj = RM.prefill(cfg_ref, params, jnp.asarray(toks),
                        embeds=jnp.asarray(emb), max_seq=max_seq,
                        cache_dtype=jnp.float32)
    lp, cp = PM.prefill(cfg, lm, torch.from_numpy(toks).long(),
                        embeds=torch.from_numpy(emb), max_seq=max_seq,
                        cache_dtype=torch.float32)
    assert cp["pos"] == int(cj["pos"]) == cfg.n_patches + 9
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
    assert cp["pos"] == int(cj["pos"]) == max_seq
    np.testing.assert_allclose(cp["layers"][1]["kv"]["k"].numpy(),
                               _np(cj["groups"][0]["kv"]["k"][1]), rtol=0,
                               atol=FP32_TOL)


@functools.lru_cache(maxsize=None)
def _train_pair(dtype: str):
    cfg_ref = dataclasses.replace(ref_reduced(ARCH), dtype=dtype)
    cfg = dataclasses.replace(PC.get_reduced(ARCH), dtype=dtype)
    return cfg_ref, RM.init_params(cfg_ref, jax.random.PRNGKey(0)), cfg


def _vlm_batches(cfg, n: int) -> list:
    """The trainer's stream (batch 4, seq 32) with seeded patches."""
    return [{**raw, "embeds": _patches(cfg, raw["tokens"].shape[0], 10 + i)}
            for i, raw in enumerate(_batches(cfg, n))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_the_reference(dtype):
    """The text tail's loss and every gradient leaf against
    ``jax.value_and_grad`` of the reference's ``loss_fn``, with
    ``tests/test_torch_train.py``'s bounds."""
    cfg_ref, params, cfg = _train_pair(dtype)
    raw = _vlm_batches(cfg, 1)[0]
    want, g_ref = jax.value_and_grad(lambda p: RM.loss_fn(
        cfg_ref, p, {k: jnp.asarray(v) for k, v in raw.items()}))(params)
    lm = convert.lm_params_from_reference(jax.tree.map(np.asarray, params),
                                          cfg, device="cpu")
    got = PM.loss_fn(cfg, lm, {k: torch.from_numpy(v)
                               for k, v in raw.items()})
    got.backward()
    g_port = convert.lm_params_to_reference(_grads(lm), cfg)
    assert got.dtype == torch.float32
    assert abs(got.item() - float(want)) <= LOSS_RTOL[dtype] * float(want)
    flat = jax.tree_util.tree_flatten_with_path(g_ref)[0]
    assert len(flat) == len(list(tree_leaves(g_port)))
    for path, g in flat:
        g = np.asarray(g, np.float32)
        mine = _walk(g_port, path).numpy()
        key = jax.tree_util.keystr(path)
        assert mine.shape == g.shape, key
        np.testing.assert_allclose(mine, g, rtol=0,
                                   atol=GRAD_TOL[dtype] * np.abs(g).max(),
                                   err_msg=key)


def test_train_steps_match_the_reference():
    """3 fp32 steps of ``make_train_step`` with ``batch["embeds"]`` against
    the reference's jitted step: ``tests/test_torch_archs.py``'s bounds
    (entries whose first gradient is below ``SIGN_FLOOR`` of their leaf's
    largest left out, at most 1% of the nonzero ones)."""
    cfg_ref, params, cfg = _train_pair("float32")
    batches = _vlm_batches(cfg, 3)
    ref_opt, opt = RefAdamW(lr=3e-3), AdamW(lr=3e-3)
    g1 = jax.grad(lambda p: RM.loss_fn(cfg_ref, p, {
        k: jnp.asarray(v) for k, v in batches[0].items()}))(params)
    ref_step = jax.jit(ref_make_train_step(cfg_ref, ref_opt))
    lm = convert.lm_params_from_reference(jax.tree.map(np.asarray, params),
                                          cfg, device="cpu")
    step = make_train_step(cfg, opt)
    rp, rs = params, ref_opt.init(params)
    ps = opt.init({k: p.detach() for k, p in lm.named_parameters()})
    for raw in batches:
        rp, rs, want = ref_step(rp, rs, {k: jnp.asarray(v)
                                         for k, v in raw.items()})
        ps, got = step(lm, ps, {k: torch.from_numpy(v)
                                for k, v in raw.items()})
        assert abs(float(got) - float(want)) <= STEP_LOSS_RTOL * float(want)
    final = convert.lm_params_to_reference(lm, cfg)
    left_out = 0
    for path, want in jax.tree_util.tree_flatten_with_path(rp)[0]:
        g = np.abs(np.asarray(_walk(g1, path)))
        keep = g > SIGN_FLOOR * g.max()
        left_out += int((~keep & (g != 0)).sum())
        got = _walk(final, path).numpy()
        np.testing.assert_allclose(got[keep], np.asarray(want)[keep], rtol=0,
                                   atol=STEP_PARAM_ATOL,
                                   err_msg=jax.tree_util.keystr(path))
    n = sum(x.size for x in jax.tree.leaves(rp))
    assert left_out < 0.01 * n, (left_out, n)


def test_patches_are_checked():
    """A VLM's batch and prefill need (B, n_patches, d) patches: missing
    ones, another count, batch or width raise ``ValueError`` before any
    gradient or cache."""
    _, _, cfg, lm = _pair()
    raw = {k: torch.from_numpy(v) for k, v in _vlm_batches(cfg, 1)[0].items()}
    check_batch(cfg, raw)
    emb = raw["embeds"]
    bad = [None, emb[:, :-1], emb[:2], emb[..., :8]]
    prefill = make_prefill_step(cfg, 64)
    for e in bad:
        batch = {k: x for k, x in raw.items() if k != "embeds"}
        if e is not None:
            batch["embeds"] = e
        with pytest.raises(ValueError, match="patch"):
            check_batch(cfg, batch)
        with pytest.raises(ValueError, match="patch"):
            prefill(lm, raw["tokens"], e)
    assert all(p.grad is None for p in lm.parameters())


def test_serve_cli_draws_patches_and_trainer_refuses(capsys):
    """``serve --arch qwen2-vl-72b --reduced --device cpu`` draws the
    patches after the tokens from the seed's generator (as the reference's
    serve) and sizes the cache for them; the trainer CLI refuses a VLM."""
    cfg = PC.get_reduced(ARCH)
    toks, emb = serve.prompt_inputs(cfg, 2, 8, 0, device="cpu")
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(toks.numpy(),
                                  rng.integers(0, cfg.vocab, (2, 8)))
    want = rng.standard_normal((2, cfg.n_patches, cfg.d_model)) * 0.02
    assert emb.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        emb.float().numpy(),
        torch.as_tensor(want).to(torch.bfloat16).float().numpy())
    res = serve.main(["--arch", "qwen2-vl-72b", "--reduced", "--device",
                      "cpu", "--batch", "2", "--prompt-len", "8", "--gen",
                      "3"])
    assert res["tokens"].shape == (2, 3)
    assert torch.isfinite(res["first_logits"]).all()
    assert "generated (2, 3)" in capsys.readouterr().out
    with pytest.raises(ValueError, match="patches"):
        train_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                        "--steps", "1"])
