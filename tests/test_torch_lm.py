"""Port parity for the LM serving path: the reduced SmolLM (2 layers, d 64,
4 heads, 2 kv heads, head_dim 16, vocab 256) with the reference's
``init_params(cfg, PRNGKey(0))`` carried across by
``convert.lm_params_from_reference``.

Tolerances: fp32 (``dtype="float32"``) logits within atol 1e-4 (both sides
compute in fp32; the sums and the RoPE angles are rounded in other
places) and identical greedy tokens; bf16 (the published dtype) within
``LM_BF16_TOL * max|logits|``, 5e-2: bf16 keeps 8 bits, and the packages
round at different places (the reference's einsum attention rounds the
scores and probabilities to bf16, the flash path keeps them fp32), which
the layers compound.  The 4096-token prompt (the reference's chunked
attention there, the flash kernel's plain version here) within 1e-4 in
fp32.
"""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import models as RM
from repro.configs import get_config as ref_get_config
from repro.configs import get_reduced as ref_reduced
from repro_torch import configs as PC
from repro_torch import convert, kernels
from repro_torch.models import model as PM
from repro_torch.models.config import BlockSpec, model_flops_per_token

# the tensors here are tiny: one thread per test process keeps a
# parallel run's workers from spinning against each other
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
LM_BF16_TOL = 5e-2
FP32_TOL = 1e-4


@functools.lru_cache(maxsize=None)
def _pair(dtype: str, n_layers: int = 2):
    """The reduced config in ``dtype`` for both packages, the reference's
    seeded parameters and the port's LM holding the same values."""
    cfg_ref = dataclasses.replace(ref_reduced("smollm_135m"), dtype=dtype,
                                  n_layers=n_layers)
    cfg = dataclasses.replace(PC.get_reduced("smollm_135m"), dtype=dtype,
                              n_layers=n_layers)
    params = RM.init_params(cfg_ref, jax.random.PRNGKey(0))
    lm = convert.lm_params_from_reference(jax.tree.map(np.asarray, params),
                                          cfg, device="cpu")
    return cfg_ref, params, cfg, lm


def _tokens(cfg, b: int, s: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)
                                                ).astype(np.int32)


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def test_configs_match_reference():
    """The copied dataclasses give the reference's fields, parameter count
    and flops per token, for the reduced and the published config."""
    for get_port, get_ref in ((PC.get_reduced, ref_reduced),
                              (PC.get_config, ref_get_config)):
        cfg, cfg_ref = get_port("smollm-135m"), get_ref("smollm_135m")
        assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_ref)
        assert cfg.param_count() == cfg_ref.param_count()
        assert cfg.n_groups == cfg_ref.n_groups
        assert model_flops_per_token(cfg) == RM.model_flops_per_token(cfg_ref)
    full = PC.get_config("smollm_135m")
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.head_dim, full.d_ff, full.vocab) == (30, 576, 9, 3, 64,
                                                      1536, 49152)


def test_registry_raises_for_unported_ids():
    """Every one of the reference's ten ids resolves (none is left
    unported), by its id and by its alias, to the reference's config; an
    unknown id still raises ``ValueError``."""
    from repro.configs import ARCH_IDS as REF_IDS
    from repro.configs import _ALIASES as REF_ALIASES
    assert PC.canonical("smollm-135m") == "smollm_135m"
    assert PC.NOT_PORTED == [] and sorted(PC.ARCH_IDS) == sorted(REF_IDS)
    for arch in REF_IDS:
        assert dataclasses.asdict(PC.get_config(arch)) == \
            dataclasses.asdict(ref_get_config(arch))
    for alias, arch in REF_ALIASES.items():
        assert PC.get_reduced(alias) == PC.get_reduced(arch)
    with pytest.raises(ValueError, match="unknown"):
        PC.get_config("gpt-5")


def _load_block(block, tree) -> None:
    """Load a reference block's nested tree into a port ``Block`` (strict:
    the names and shapes must be the reference's)."""
    flat = {}

    def walk(path, node):
        if isinstance(node, dict):
            for key, child in node.items():
                walk(f"{path}{key}.", child)
        else:
            flat[path[:-1]] = torch.from_numpy(np.array(node))

    walk("", tree)
    block.load_state_dict(flat, strict=True)


@pytest.mark.parametrize("spec", [BlockSpec("mla", "moe"),
                                  BlockSpec("mla", "dense"),
                                  BlockSpec("mla", "none"),
                                  BlockSpec("mla", "dense", cross=True)])
def test_other_blocks_raise_not_implemented(spec):
    """The MLA block kinds, which raised before MLA was ported, now run:
    one block of each on the reduced deepseek-v2's widths, loaded from the
    reference's ``block_init``, gives the reference's ``block_forward``
    output and auxiliary loss in fp32 within ``FP32_TOL`` (the cross
    block over an encoder output of 5 frames)."""
    from repro.models import blocks as RB
    from repro_torch.models import blocks as PB
    cfg_ref = dataclasses.replace(ref_reduced("deepseek_v2_236b"),
                                  dtype="float32", pattern=(spec,))
    cfg = dataclasses.replace(PC.get_reduced("deepseek_v2_236b"),
                              dtype="float32", pattern=(spec,))
    tree = RB.block_init(cfg_ref, spec, jax.random.PRNGKey(3))
    _load_block(PB.Block(cfg, spec, device="cpu"), tree)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32) \
        if spec.cross else None
    pos = np.broadcast_to(np.arange(7, dtype=np.int32), (2, 7))
    want, _, aux_ref = RB.block_forward(
        cfg_ref, spec, tree, jnp.asarray(x), positions=jnp.asarray(pos),
        encoder_out=None if enc is None else jnp.asarray(enc))
    nested = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)
    with torch.no_grad():
        got, _, aux = PB.block_forward(
            cfg, spec, nested, torch.from_numpy(x),
            positions=torch.from_numpy(pos.copy()),
            encoder_out=None if enc is None else torch.from_numpy(enc))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=FP32_TOL)
    assert abs(float(aux) - float(aux_ref)) <= FP32_TOL


@pytest.mark.parametrize("spec", [BlockSpec("attn", "none"),
                                  BlockSpec("mamba", "none"),
                                  BlockSpec("mlstm", "none"),
                                  BlockSpec("slstm", "none")])
def test_one_spec_blocks_match_reference(spec):
    """The block kinds that run since the recurrent mixers were ported: a
    reduced SmolLM (2 layers) whose pattern is that one spec, loaded from
    the reference's seeded parameters, gives its fp32 logits within 1e-4
    (the SSD mixers at the config's defaults: one head of 128, chunk 128,
    so the 24-token prompt is one chunk)."""
    cfg_ref = dataclasses.replace(ref_reduced("smollm_135m"),
                                  dtype="float32", pattern=(spec,))
    cfg = dataclasses.replace(PC.get_reduced("smollm_135m"),
                              dtype="float32", pattern=(spec,))
    params = RM.init_params(cfg_ref, jax.random.PRNGKey(0))
    lm = convert.lm_params_from_reference(jax.tree.map(np.asarray, params),
                                          cfg, device="cpu")
    toks = _tokens(cfg, 2, 24)
    want, _, _ = RM.forward(cfg_ref, params, jnp.asarray(toks))
    with torch.no_grad():
        got, _ = PM.forward(cfg, lm, torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=FP32_TOL)


@pytest.mark.parametrize("field,value", [("first_dense_ff", 32),
                                         ("encoder_layers", 1),
                                         ("n_patches", 4)])
def test_other_model_features_raise_not_implemented(field, value):
    """The model features that raised before they were ported now run,
    each on a reduced SmolLM loaded from the reference's seeded
    parameters, with the reference's fp32 logits within ``FP32_TOL``:
    DeepSeek's dense layer 0 (3 layers, so 2 in the pattern's stack, and
    a layer 0 of FFN width 32); a VLM's 4 prepended patches (plain RoPE:
    no M-RoPE sections); and an encoder-decoder that also sets
    ``n_patches``, whose 6 frames the reference both encodes and
    prepends, as the port does (``embeds`` mean the frames there and the
    patches here, told apart by ``is_encdec`` and ``n_patches``)."""
    extra = {"first_dense_ff": {"n_layers": 3},
             "encoder_layers": {"n_patches": 4, "n_frames": 6},
             "n_patches": {}}[field]
    cfg_ref = dataclasses.replace(ref_reduced("smollm_135m"),
                                  dtype="float32", **{field: value}, **extra)
    cfg = dataclasses.replace(PC.get_reduced("smollm_135m"),
                              dtype="float32", **{field: value}, **extra)
    params = RM.init_params(cfg_ref, jax.random.PRNGKey(0))
    lm = convert.lm_params_from_reference(
        jax.tree.map(np.asarray, params), cfg, device="cpu")
    if field == "first_dense_ff":
        assert lm.layer0.ffn.wo.shape == (value, cfg.d_model)
    toks = _tokens(cfg, 2, 12)
    n = {"first_dense_ff": 0, "encoder_layers": 6, "n_patches": 4}[field]
    emb = np.random.default_rng(5).standard_normal(
        (2, n, cfg.d_model)).astype(np.float32) if n else None
    want, _, _ = RM.forward(cfg_ref, params, jnp.asarray(toks),
                            embeds=None if emb is None else jnp.asarray(emb))
    with torch.no_grad():
        got, _ = PM.forward(cfg, lm, torch.from_numpy(toks).long(),
                            embeds=None if emb is None
                            else torch.from_numpy(emb))
    assert got.shape == (2, n + 12, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0,
                               atol=FP32_TOL)


def test_conversion_unstacks_the_layer_axis():
    """Layer g of the port is group g of the reference's stacked slot 0;
    weights keep their (d_in, d_out) layout and values."""
    cfg_ref, params, cfg, lm = _pair("float32")
    slot = params["groups"][0]
    for g in range(cfg.n_groups):
        layer = lm.layers[g]
        np.testing.assert_array_equal(layer.mixer.wq.detach().numpy(),
                                      np.asarray(slot["mixer"]["wq"][g]))
        np.testing.assert_array_equal(layer.ffn.wo.detach().numpy(),
                                      np.asarray(slot["ffn"]["wo"][g]))
    np.testing.assert_array_equal(lm.embed.detach().numpy(),
                                  np.asarray(params["embed"]))
    n = sum(p.numel() for p in lm.parameters())
    assert n == sum(x.size for x in jax.tree.leaves(params))
    # the analytic count leaves out the final norm's d_model scales
    assert n == cfg.param_count() + cfg.d_model


def test_forward_logits_fp32():
    cfg_ref, params, cfg, lm = _pair("float32")
    toks = _tokens(cfg, 2, 24)
    want, _, _ = RM.forward(cfg_ref, params, jnp.asarray(toks))
    with torch.no_grad():
        got, cache = PM.forward(cfg, lm, torch.from_numpy(toks).long())
    assert cache is None and got.shape == (2, 24, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=FP32_TOL)


def test_prefill_and_greedy_decode_fp32():
    """Prefill logits and the k/v cache, then 8 decode steps: identical
    greedy tokens (fp32 compute, fp32 cache)."""
    cfg_ref, params, cfg, lm = _pair("float32")
    toks = _tokens(cfg, 2, 16, seed=1)
    lj, cj = RM.prefill(cfg_ref, params, jnp.asarray(toks), max_seq=32,
                        cache_dtype=jnp.float32)
    lp, cp = PM.prefill(cfg, lm, torch.from_numpy(toks).long(), max_seq=32,
                        cache_dtype=torch.float32)
    np.testing.assert_allclose(lp.numpy(), _np(lj), rtol=0, atol=FP32_TOL)
    assert cp["pos"] == int(cj["pos"]) == 16
    for name in ("k", "v"):
        want = _np(cj["groups"][0]["kv"][name])       # (groups, B, Hkv, S, hd)
        got = np.stack([cp["layers"][i]["kv"][name].numpy()
                        for i in range(cfg.n_layers)])
        np.testing.assert_allclose(got, want, rtol=0, atol=FP32_TOL)
    tj = jnp.argmax(lj, -1).astype(jnp.int32)[:, None]
    tp = lp.argmax(-1)[:, None]
    for _ in range(8):
        np.testing.assert_array_equal(tp.numpy(), np.asarray(tj))
        lj, cj = RM.decode_step(cfg_ref, params, cj, tj)
        lp, cp = PM.decode_step(cfg, lm, cp, tp)
        np.testing.assert_allclose(lp.numpy(), _np(lj), rtol=0,
                                   atol=FP32_TOL)
        tj = jnp.argmax(lj, -1).astype(jnp.int32)[:, None]
        tp = lp.argmax(-1)[:, None]
    np.testing.assert_array_equal(tp.numpy(), np.asarray(tj))
    assert cp["pos"] == int(cj["pos"]) == 24


def test_prefill_and_decode_bf16():
    """The published dtype: bf16 compute and the default bf16 cache."""
    cfg_ref, params, cfg, lm = _pair("bfloat16")
    toks = _tokens(cfg, 2, 16, seed=2)
    lj, cj = RM.prefill(cfg_ref, params, jnp.asarray(toks), max_seq=24)
    lp, cp = PM.prefill(cfg, lm, torch.from_numpy(toks).long(), max_seq=24)
    assert lp.dtype == torch.bfloat16
    assert cp["layers"][0]["kv"]["k"].dtype == torch.bfloat16
    tol = LM_BF16_TOL * float(np.abs(_np(lj)).max())
    np.testing.assert_allclose(_np(lp.float()), _np(lj), rtol=0, atol=tol)
    tok = lp.argmax(-1)[:, None]
    for _ in range(4):
        lj, cj = RM.decode_step(cfg_ref, params, cj,
                                jnp.asarray(tok.numpy(), jnp.int32))
        lp, cp = PM.decode_step(cfg, lm, cp, tok)
        np.testing.assert_allclose(_np(lp.float()), _np(lj), rtol=0,
                                   atol=tol)
        tok = lp.argmax(-1)[:, None]


def test_long_prompt_one_layer_fp32():
    """One 4096-token prompt (B=1, 1 layer): the reference takes its chunked
    online-softmax attention, the port the flash kernel's plain version."""
    cfg_ref, params, cfg, lm = _pair("float32", n_layers=1)
    toks = _tokens(cfg, 1, 4096, seed=3)
    lj, _ = RM.prefill(cfg_ref, params, jnp.asarray(toks), max_seq=4096,
                       cache_dtype=jnp.float32)
    lp, cp = PM.prefill(cfg, lm, torch.from_numpy(toks).long(), max_seq=4096,
                        cache_dtype=torch.float32)
    np.testing.assert_allclose(lp.numpy(), _np(lj), rtol=0, atol=FP32_TOL)
    assert cp["pos"] == 4096


def test_attention_paths_agree_on_cpu():
    """``attention="plain"`` and the default (the wrapper; its plain version
    on the CPU) give the same logits here, and no kernel launches."""
    _, _, cfg, lm = _pair("float32")
    toks = torch.from_numpy(_tokens(cfg, 2, 12, seed=4)).long()
    kernels.reset_launch_counts()
    a, _ = PM.prefill(cfg, lm, toks, max_seq=12)
    b, _ = PM.prefill(cfg, lm, toks, max_seq=12, attention="plain")
    assert torch.equal(a, b)
    assert kernels.launch_counts()["flash_attention"] == 0


def test_init_params_is_seeded_and_scaled():
    cfg = PC.get_reduced("smollm_135m")
    a = PM.init_params(cfg, 0, device="cpu")
    b = PM.init_params(cfg, 0, device="cpu")
    c = PM.init_params(cfg, 1, device="cpu")
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(),
                                  c.parameters()):
        assert torch.equal(pa, pb), name
        if "norm" in name:
            assert not pa.any(), name          # offsets from 1: zeros
        else:
            assert not torch.equal(pa, pc), name
            d_in = pa.shape[1] if name == "embed" else pa.shape[0]
            assert float(pa.detach().abs().max()) <= 2 * d_in ** -0.5 + 1e-6, \
                name
    assert a.embed.dtype == torch.float32 and not hasattr(a, "lm_head")


def test_cache_and_positions():
    cfg = PC.get_reduced("smollm_135m")
    cache = PM.init_cache(cfg, 3, 20, device="cpu")
    assert cache["pos"] == 0 and len(cache["layers"]) == cfg.n_layers
    assert cache["layers"][0]["kv"]["k"].shape == (3, cfg.n_kv_heads, 20,
                                                   cfg.head_dim)
    assert cache["layers"][0]["kv"]["v"].dtype == torch.bfloat16
    pos = PM.make_positions(cfg, 2, 4, offset=5, device="cpu")
    np.testing.assert_array_equal(pos.numpy(), [[5, 6, 7, 8]] * 2)
    lm = PM.init_params(cfg, 0, device="cpu")
    with pytest.raises(ValueError, match="cache"):
        PM.prefill(cfg, lm, torch.zeros(1, 8, dtype=torch.long), max_seq=4)


def test_serve_cli_on_cpu_reduced():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--workload",
         "lm", "--arch", "smollm_135m", "--reduced", "--device", "cpu",
         "--batch", "2", "--prompt-len", "8", "--gen", "4"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "generated (2, 4)" in out.stdout and "tok/s" in out.stdout
    from repro_torch.launch import serve
    # the pca workloads are served: tiny requests on the CPU
    for workload in ("pca-stream", "pca-fleet"):
        res = serve.main(["--workload", workload, "--device", "cpu",
                          "--m", "4", "--d", "8", "--k-top", "2",
                          "--n-per-agent", "12", "--ticks", "2",
                          "--tick-iters", "1", "--rounds", "2",
                          "--iters", "2", "--requests", "1",
                          "--tenants", "2"])
        assert res["fleet" if workload == "pca-fleet" else "tracker"]
    res = serve.main(["--workload", "pca", "--device", "cpu", "--batch", "1",
                      "--m", "4", "--d", "8", "--k-top", "2", "--iters", "2",
                      "--rounds", "2", "--reps", "1"])
    assert len(res["tans"]) == 1 and res["out"].W.shape == (1, 4, 8, 2)


def test_serve_function_matches_manual_loop():
    """``serve_lm`` is prefill then greedy ``decode_step``s."""
    from repro_torch.launch import serve
    cfg = PC.get_reduced("smollm_135m")
    lm = PM.init_params(cfg, 0, device="cpu")
    toks = serve.prompt_tokens(cfg, 2, 8, 0, device="cpu")
    res = serve.serve_lm(cfg, lm, toks, 5)
    logits, cache = PM.prefill(cfg, lm, toks, max_seq=13)
    tok = logits.argmax(-1)[:, None]
    want = [tok]
    for _ in range(4):
        logits, cache = PM.decode_step(cfg, lm, cache, tok)
        tok = logits.argmax(-1)[:, None]
        want.append(tok)
    assert torch.equal(res["tokens"], torch.cat(want, 1))
    assert res["tokens"].shape == (2, 5) and res["tok_s"] > 0
