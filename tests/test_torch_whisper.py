"""Port parity for the encoder-decoder path: the reduced whisper-small (2
encoder and 2 decoder layers, d 64, 4 heads, head_dim 16, vocab 256, 12
frames) with the reference's ``init_params(cfg, PRNGKey(0))`` carried
across by ``convert.lm_params_from_reference``.

Tolerances are those of ``tests/test_torch_lm.py``: fp32 logits within
atol 1e-4 and identical greedy tokens; bf16 within ``LM_BF16_TOL *
max|logits|``, 5e-2 (the reference's einsum attention rounds the scores
and probabilities to bf16, the flash path keeps them fp32); the port's
decode against its own parallel forward within rtol = atol = 2e-3 (the
reference's ``test_decode_matches_parallel_forward``); the sinusoidal
positions within 1e-6 plus the largest position times 2^-24 (both fp32;
XLA's and torch's fp32 ``pow`` differ by an ulp on a few frequencies,
and the angle ``pos / freq`` carries that relative ulp into sin/cos);
the non-causal attention within 2e-5 of the reference's Pallas kernel in
interpret mode (``tests/test_torch_flash_attention.py``'s fp32 bound).
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
from repro.kernels.flash_attention import flash_attention_single as ref_single
from repro.models.layers import sinusoidal_positions as ref_sinusoidal
from repro_torch import configs as PC
from repro_torch import convert
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve
from repro_torch.models import attention as PA
from repro_torch.models import model as PM
from repro_torch.models.layers import sinusoidal_positions

# the tensors here are tiny: one thread per test process keeps a
# parallel run's workers from spinning against each other
torch.set_num_threads(1)

ARCH = "whisper_small"
LM_BF16_TOL = 5e-2
FP32_TOL = 1e-4
DECODE_TOL = 2e-3
FLASH_TOL = 2e-5


@functools.lru_cache(maxsize=None)
def _pair(dtype: str):
    """The reduced config in ``dtype`` for both packages, the reference's
    seeded parameters and the port's LM holding the same values."""
    cfg_ref = dataclasses.replace(ref_reduced(ARCH), dtype=dtype)
    cfg = dataclasses.replace(PC.get_reduced(ARCH), dtype=dtype)
    params = RM.init_params(cfg_ref, jax.random.PRNGKey(0))
    lm = convert.lm_params_from_reference(jax.tree.map(np.asarray, params),
                                          cfg, device="cpu")
    return cfg_ref, params, cfg, lm


def _inputs(cfg, b: int, s: int, seed: int):
    """Tokens (B, S) and frame embeddings (B, n_frames, d) fp32, numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    frames = (rng.standard_normal((b, cfg.n_frames, cfg.d_model)) * 0.02
              ).astype(np.float32)
    return toks, frames


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _t(toks: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(toks).long()


def _tol(dtype: str, want) -> float:
    return FP32_TOL if dtype == "float32" else \
        LM_BF16_TOL * float(np.abs(_np(want)).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_logits_with_frames(dtype):
    """Teacher-forced logits over every position, with the frames encoded;
    in fp32 also the same greedy token at every position."""
    cfg_ref, params, cfg, lm = _pair(dtype)
    toks, frames = _inputs(cfg, 2, 10, seed=0)
    want, _, _ = RM.forward(cfg_ref, params, jnp.asarray(toks),
                            embeds=jnp.asarray(frames))
    with torch.no_grad():
        got, cache = PM.forward(cfg, lm, _t(toks),
                                embeds=torch.from_numpy(frames))
    assert cache is None and got.shape == (2, 10, cfg.vocab)
    np.testing.assert_allclose(_np(got.float()), _np(want), rtol=0,
                               atol=_tol(dtype, want))
    if dtype == "float32":
        np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                      np.asarray(jnp.argmax(want, -1)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_matches_reference(dtype):
    """Prefill (the encoder's output stored in the cache, in the cache
    dtype), then 3 greedy decode steps that read it back; fp32 runs an fp32
    cache, bf16 the default bf16 one."""
    cfg_ref, params, cfg, lm = _pair(dtype)
    toks, frames = _inputs(cfg, 2, 6, seed=1)
    cdt = (jnp.float32, torch.float32) if dtype == "float32" else \
        (jnp.bfloat16, torch.bfloat16)
    lj, cj = RM.prefill(cfg_ref, params, jnp.asarray(toks),
                        embeds=jnp.asarray(frames), max_seq=10,
                        cache_dtype=cdt[0])
    lp, cp = PM.prefill(cfg, lm, _t(toks), embeds=torch.from_numpy(frames),
                        max_seq=10, cache_dtype=cdt[1])
    tol = _tol(dtype, lj)
    np.testing.assert_allclose(_np(lp.float()), _np(lj), rtol=0, atol=tol)
    assert cp["encoder_out"].dtype == cdt[1]
    assert cp["encoder_out"].shape == (2, cfg.n_frames, cfg.d_model)
    np.testing.assert_allclose(_np(cp["encoder_out"].float()),
                               _np(cj["encoder_out"]), rtol=0,
                               atol=_tol(dtype, cj["encoder_out"]))
    tok = lp.argmax(-1)[:, None]
    for _ in range(3):
        if dtype == "float32":
            np.testing.assert_array_equal(
                tok.numpy(), np.asarray(jnp.argmax(lj, -1))[:, None])
        lj, cj = RM.decode_step(cfg_ref, params, cj,
                                jnp.asarray(tok.numpy(), jnp.int32))
        lp, cp = PM.decode_step(cfg, lm, cp, tok)
        np.testing.assert_allclose(_np(lp.float()), _np(lj), rtol=0,
                                   atol=tol)
        tok = lp.argmax(-1)[:, None]
    assert cp["pos"] == int(cj["pos"]) == 9


def test_decode_matches_parallel_forward():
    """The reference's ``test_decode_matches_parallel_forward`` on the
    port alone: the last decode step's logits against a teacher-forced
    parallel forward (fp32, fp32 cache)."""
    cfg = dataclasses.replace(PC.get_reduced(ARCH), dtype="float32")
    lm = PM.init_params(cfg, 3, device="cpu")
    toks, frames = _inputs(cfg, 1, 8, seed=3)
    toks, frames = _t(toks), torch.from_numpy(frames)
    with torch.no_grad():
        full, _ = PM.forward(cfg, lm, toks, embeds=frames)
    _, cache = PM.prefill(cfg, lm, toks[:, :7], embeds=frames, max_seq=10,
                          cache_dtype=torch.float32)
    step, _ = PM.decode_step(cfg, lm, cache, toks[:, 7:8])
    np.testing.assert_allclose(step.numpy(), full[:, -1].numpy(),
                               rtol=DECODE_TOL, atol=DECODE_TOL)


@pytest.mark.parametrize("seq,d,offset", [(12, 64, 0), (1, 64, 37),
                                          (1500, 768, 0), (5, 768, 448)])
def test_sinusoidal_positions_match_reference(seq, d, offset):
    """Interleaved sin (even columns) and cos (odd), fp32."""
    got = sinusoidal_positions(seq, d, offset)
    want = ref_sinusoidal(seq, d, offset)
    assert got.dtype == torch.float32 and got.shape == (seq, d)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0,
                               atol=1e-6 + (offset + seq) * 2.0 ** -24)
    if offset == 0:           # interleaved: sin 0 = 0 even, cos 0 = 1 odd
        np.testing.assert_array_equal(got[0, 0::2].numpy(), 0.0)
        np.testing.assert_array_equal(got[0, 1::2].numpy(), 1.0)


def test_conversion_round_trip_with_the_encoder():
    """The reference's tree -> the port's LM -> the reference's tree, bit
    for bit, encoder included; layer l of the encoder is row l of its
    stacked slot."""
    _, params, cfg, lm = _pair("float32")
    names = dict(lm.named_parameters())
    assert "encoder.final_norm" in names and \
        "layers.1.cross.wq" in names and "layers.0.norm_cross" in names
    enc = params["encoder"]["groups"][0]
    for layer in range(cfg.encoder_layers):
        np.testing.assert_array_equal(
            names[f"encoder.layers.{layer}.mixer.wk"].detach().numpy(),
            np.asarray(enc["mixer"]["wk"][layer]))
    back = convert.lm_params_to_reference(lm, cfg)
    want = jax.tree_util.tree_flatten_with_path(params)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), back))[0])
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], np.asarray(leaf),
                                      err_msg=jax.tree_util.keystr(path))
    n = sum(p.numel() for p in lm.parameters())
    assert n == sum(x.size for x in jax.tree.leaves(params))


@pytest.mark.parametrize("sq,skv", [(5, 37), (1, 300), (33, 150)])
def test_plain_non_causal_attention_matches_reference_kernel(sq, skv):
    """The plain version the CPU runs for every non-causal call, against
    the reference's Pallas ``flash_attention_single(causal=False)`` in
    interpret mode, at ragged Sq != Skv (cross-attention's shapes)."""
    rng = np.random.default_rng(sq * 1000 + skv)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((sq, 16), (skv, 16), (skv, 16)))
    want = ref_single(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      causal=False, block_q=16, block_kv=16, interpret=True)
    got = fa.flash_attention_plain(*(torch.from_numpy(x)[None, None]
                                     for x in (q, k, v)), causal=False)
    np.testing.assert_allclose(got[0, 0].numpy(), _np(want), rtol=FLASH_TOL,
                               atol=FLASH_TOL)


def test_one_token_prompt_encodes_the_frames():
    """The deliberate difference: the reference's cached forward reads the
    fresh cache's zero ``encoder_out`` for a one-token prompt, so two
    different frame sets give the same logits; the port encodes them."""
    cfg_ref, params, cfg, lm = _pair("float32")
    toks, frames_a = _inputs(cfg, 2, 1, seed=5)
    _, frames_b = _inputs(cfg, 2, 1, seed=6)
    ref = [RM.prefill(cfg_ref, params, jnp.asarray(toks),
                      embeds=jnp.asarray(f), max_seq=4,
                      cache_dtype=jnp.float32) for f in (frames_a, frames_b)]
    np.testing.assert_array_equal(_np(ref[0][0]), _np(ref[1][0]))
    assert not np.asarray(ref[0][1]["encoder_out"]).any()
    port = [PM.prefill(cfg, lm, _t(toks), embeds=torch.from_numpy(f),
                       max_seq=4, cache_dtype=torch.float32)
            for f in (frames_a, frames_b)]
    assert float((port[0][0] - port[1][0]).abs().max()) > 1e-3
    assert port[0][1]["encoder_out"].abs().max() > 0
    # with the frames encoded the port's one-token prefill is the
    # reference's uncached forward
    want, _, _ = RM.forward(cfg_ref, params, jnp.asarray(toks),
                            embeds=jnp.asarray(frames_a))
    np.testing.assert_allclose(port[0][0].numpy(), _np(want)[:, -1],
                               rtol=0, atol=FP32_TOL)


@pytest.mark.parametrize("attention", ["kernel", "plain"])
def test_every_attention_call_takes_the_flash_path(monkeypatch, attention):
    """With ``attention="kernel"`` the encoder's bidirectional blocks, the
    decoder's causal blocks and the cross-attention all call the flash
    wrapper (3 calls a layer pair in a prefill), and a decode step calls
    it once a layer (cross-attention, Sq == 1); ``"plain"`` never."""
    calls = []

    def record(q, k, v, *, causal):
        calls.append((causal, q.shape[2], k.shape[2]))
        return fa.flash_attention(q, k, v, causal=causal)

    monkeypatch.setattr(PA, "flash_attention", record)
    _, _, cfg, lm = _pair("bfloat16")
    toks, frames = _inputs(cfg, 2, 5, seed=7)
    logits, cache = PM.prefill(cfg, lm, _t(toks),
                               embeds=torch.from_numpy(frames), max_seq=8,
                               attention=attention)
    prefill_calls, calls[:] = list(calls), []
    PM.decode_step(cfg, lm, cache, logits.argmax(-1)[:, None],
                   attention=attention)
    if attention == "plain":
        assert prefill_calls == [] and calls == []
        return
    f = cfg.n_frames
    assert prefill_calls == [(False, f, f)] * cfg.encoder_layers + \
        [(True, 5, 5), (False, 5, f)] * cfg.n_layers
    assert calls == [(False, 1, f)] * cfg.n_layers


def test_serve_draws_the_reference_frames():
    """``prompt_inputs`` draws the reference serve's tokens, then its
    frames from the same generator, rounded to bf16 the same way; the
    serve runs on the CPU from them."""
    cfg = PC.get_reduced(ARCH)
    toks, frames = serve.prompt_inputs(cfg, 3, 7, 11, device="cpu")
    rng = np.random.default_rng(11)
    want_toks = rng.integers(0, cfg.vocab, (3, 7))
    want = jnp.asarray(rng.standard_normal((3, cfg.n_frames, cfg.d_model))
                       * 0.02, jnp.bfloat16)
    np.testing.assert_array_equal(toks.numpy(), want_toks)
    assert frames.dtype == torch.bfloat16
    np.testing.assert_array_equal(frames.float().numpy(), _np(want))
    assert torch.equal(toks, serve.prompt_tokens(cfg, 3, 7, 11,
                                                 device="cpu"))
    res = serve.run_lm(ARCH, reduced=True, batch=2, prompt_len=4, gen=3,
                       device="cpu")
    assert res["tokens"].shape == (2, 3)


def test_loss_takes_the_frames():
    """``loss_fn`` with ``batch["embeds"]`` against the reference's (fp32);
    without the frames an encoder-decoder forward raises."""
    cfg_ref, params, cfg, lm = _pair("float32")
    toks, frames = _inputs(cfg, 2, 8, seed=8)
    labels = np.roll(toks, -1, axis=1)
    want = RM.loss_fn(cfg_ref, params, {"tokens": jnp.asarray(toks),
                                        "labels": jnp.asarray(labels),
                                        "embeds": jnp.asarray(frames)})
    got = PM.loss_fn(cfg, lm, {"tokens": _t(toks), "labels": _t(labels),
                               "embeds": torch.from_numpy(frames)})
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    with pytest.raises(ValueError, match="embeds"):
        PM.forward(cfg, lm, _t(toks))
