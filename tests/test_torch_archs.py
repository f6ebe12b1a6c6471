"""The architectures the port runs beside SmolLM: the dense-GQA yi-34b,
phi3-medium-14b and qwen1.5-110b (QKV bias, untied heads, new head
ratios), llama4-scout-17b-a16e (GQA with the mixture-of-experts FFN:
16 experts, top-1, one shared expert), the encoder-decoder whisper-small
and the recurrent xlstm-350m.

Their configs equal the reference's, published and reduced, with the
reference's parameter counts; the reduced GQA models (dense and llama4),
loaded from the reference's ``init_params(cfg, PRNGKey(0))``, give its
fp32 logits within atol 1e-4 (``tests/test_torch_lm.py``'s bound) and its
greedy tokens, over a prefill and 3 decode steps (fp32 cache).  Training
them is held to the reference with ``tests/test_torch_train.py``'s
harness and bounds: the loss and every gradient leaf, fp32 and bf16 for
the dense-GQA models (readings: fp32 loss 8.2e-8 relative, leaves 1.94e-6
of their largest entry; bf16 loss 2.3e-4, the worst leaf 4.02e-2, qwen1.5's
``bk``, whose gradient nearly cancels), fp32 for llama4 (a top-1 router
in bf16 may send a token to another expert on either side), and 3 AdamW
steps of ``make_train_step``.

llama4's top-1 router takes its gradient from the auxiliary loss alone:
the renormalised gate is ``p / p``, whose derivative is rounding residue.
With ``AUX_LOSS_WEIGHT = 0`` the reference's own router gradient on this
batch reads 3.10e-9 (max abs) and the port's 1.79e-9, where the full
gradient's largest entry is 2.33e-3; so the router leaf is held to
``GRAD_TOL`` of its largest entry plus ``ROUTER_RESIDUE`` = 1e-8 absolute
(three times the reference's residue), and the port's router gradient
to ``AUX_LOSS_WEIGHT`` times the gradient of the summed aux loss within
the same residue.  Whisper's parity is ``tests/test_torch_whisper.py``,
xlstm's ``tests/test_torch_ssm.py``, qwen2-vl's (M-RoPE, the patches)
``tests/test_torch_vlm.py`` and jamba's (the hybrid pattern)
``tests/test_torch_hybrid.py``; their configs are held here.
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
from repro.optim import AdamW as RefAdamW
from repro_torch import configs as PC
from repro_torch import convert
from repro_torch.compression.deepca_powersgd import tree_leaves
from repro_torch.launch import serve
from repro_torch.launch import train as train_cli
from repro_torch.launch.steps import _grads, make_train_step
from repro_torch.models import model as PM
from repro_torch.models.config import model_flops_per_token
from repro_torch.optim import AdamW
from test_torch_train import (GRAD_TOL, LOSS_RTOL, SIGN_FLOOR,
                              STEP_LOSS_RTOL, STEP_PARAM_ATOL, _batches,
                              _walk)

# the tensors here are tiny: one thread per test process keeps a
# parallel run's workers from spinning against each other
torch.set_num_threads(1)

FP32_TOL = 1e-4
#: the reference's ``param_count`` of each published config
PARAM_COUNTS = {"whisper_small": 334_663_680,
                "yi_34b": 34_388_910_080,
                "phi3_medium_14b": 14_659_502_080,
                "qwen1_5_110b": 111_209_086_976,
                "xlstm_350m": 212_938_920,
                "llama4_scout_17b_a16e": 107_769_856_000,
                "qwen2_vl_72b": 72_705_376_256,
                "jamba_1_5_large_398b": 397_528_088_320}
DENSE_GQA = ["yi_34b", "phi3_medium_14b", "qwen1_5_110b"]
LLAMA4 = "llama4_scout_17b_a16e"
#: the GQA models whose logits and decode are held here
GQA = DENSE_GQA + [LLAMA4]
#: (arch, dtype) of the training parity cases (llama4: fp32 only)
TRAIN_CASES = [(a, d) for a in DENSE_GQA for d in ("float32", "bfloat16")
               ] + [(LLAMA4, "float32")]
#: llama4's top-1 router leaf: its bound beyond GRAD_TOL (the docstring)
ROUTER_RESIDUE = 1e-8


@pytest.mark.parametrize("arch", sorted(PARAM_COUNTS))
def test_config_matches_reference(arch):
    """The published and the reduced config field for field, the
    parameter count and the flops per token; the id is registered."""
    assert arch in PC.ARCH_IDS and arch not in PC.NOT_PORTED
    for get_port, get_ref in ((PC.get_reduced, ref_reduced),
                              (PC.get_config, ref_get_config)):
        cfg, cfg_ref = get_port(arch), get_ref(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_ref)
        assert cfg.param_count() == cfg_ref.param_count()
        assert cfg.n_groups == cfg_ref.n_groups
        assert model_flops_per_token(cfg) == \
            RM.model_flops_per_token(cfg_ref)
    assert PC.get_config(arch).param_count() == PARAM_COUNTS[arch]


@functools.lru_cache(maxsize=None)
def _pair(arch: str):
    cfg_ref = dataclasses.replace(ref_reduced(arch), dtype="float32")
    cfg = dataclasses.replace(PC.get_reduced(arch), dtype="float32")
    params = RM.init_params(cfg_ref, jax.random.PRNGKey(0))
    lm = convert.lm_params_from_reference(jax.tree.map(np.asarray, params),
                                          cfg, device="cpu")
    return cfg_ref, params, cfg, lm


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


@pytest.mark.parametrize("arch", GQA)
def test_reduced_logits_match_reference(arch):
    cfg_ref, params, cfg, lm = _pair(arch)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 20)
                                             ).astype(np.int32)
    want, _, _ = RM.forward(cfg_ref, params, jnp.asarray(toks))
    with torch.no_grad():
        got, _ = PM.forward(cfg, lm, torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=FP32_TOL)
    n = sum(p.numel() for p in lm.parameters())
    assert n == sum(x.size for x in jax.tree.leaves(params))


@pytest.mark.parametrize("arch", GQA)
def test_reduced_prefill_and_decode_match_reference(arch):
    cfg_ref, params, cfg, lm = _pair(arch)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 9)
                                             ).astype(np.int32)
    lj, cj = RM.prefill(cfg_ref, params, jnp.asarray(toks), max_seq=12,
                        cache_dtype=jnp.float32)
    lp, cp = PM.prefill(cfg, lm, torch.from_numpy(toks).long(), max_seq=12,
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
    assert cp["pos"] == int(cj["pos"]) == 12


@functools.lru_cache(maxsize=None)
def _train_pair(arch: str, dtype: str):
    cfg_ref = dataclasses.replace(ref_reduced(arch), dtype=dtype)
    cfg = dataclasses.replace(PC.get_reduced(arch), dtype=dtype)
    return cfg_ref, RM.init_params(cfg_ref, jax.random.PRNGKey(0)), cfg


def _lm(cfg, params):
    return convert.lm_params_from_reference(
        jax.tree.map(np.asarray, params), cfg, device="cpu")


def _port_loss_and_grads(cfg, lm, raw):
    """The port's loss and its gradients in the reference's tree."""
    loss = PM.loss_fn(cfg, lm, {k: torch.from_numpy(v)
                                for k, v in raw.items()})
    loss.backward()
    return loss, convert.lm_params_to_reference(_grads(lm), cfg)


@pytest.mark.parametrize("arch,dtype", TRAIN_CASES)
def test_loss_and_grads_match_the_reference(arch, dtype):
    """The loss (with llama4's auxiliary loss) and every gradient leaf
    against ``jax.value_and_grad`` of the reference's ``loss_fn``;
    llama4's router leaf within ``ROUTER_RESIDUE`` more."""
    cfg_ref, params, cfg = _train_pair(arch, dtype)
    raw = _batches(cfg, 1)[0]
    want, g_ref = jax.value_and_grad(lambda p: RM.loss_fn(
        cfg_ref, p, {k: jnp.asarray(v) for k, v in raw.items()}))(params)
    got, g_port = _port_loss_and_grads(cfg, _lm(cfg, params), raw)
    assert got.dtype == torch.float32
    assert abs(got.item() - float(want)) <= LOSS_RTOL[dtype] * float(want)
    flat = jax.tree_util.tree_flatten_with_path(g_ref)[0]
    assert len(flat) == len(list(tree_leaves(g_port)))
    for path, g in flat:
        g = np.asarray(g, np.float32)
        mine = _walk(g_port, path).numpy()
        key = jax.tree_util.keystr(path)
        assert mine.shape == g.shape, key
        atol = GRAD_TOL[dtype] * np.abs(g).max()
        if key.endswith("['router']"):
            atol += ROUTER_RESIDUE
        np.testing.assert_allclose(mine, g, rtol=0, atol=atol, err_msg=key)


def test_top1_router_gradient_is_the_aux_losss():
    """At top-1 the router's gradient of ``loss_fn`` is
    ``AUX_LOSS_WEIGHT`` times that of the layers' summed auxiliary loss,
    within ``ROUTER_RESIDUE``: the cross entropy reaches the router only
    through ``p / p``."""
    cfg_ref, params, cfg = _train_pair(LLAMA4, "float32")
    assert cfg.moe_top_k == 1 and PM.AUX_LOSS_WEIGHT == 0.01
    batch = {k: torch.from_numpy(v) for k, v in _batches(cfg, 1)[0].items()}
    lm = _lm(cfg, params)
    PM.loss_fn(cfg, lm, batch).backward()
    full = {k: p.grad.clone() for k, p in lm.named_parameters()
            if k.endswith("router")}
    lm.zero_grad(set_to_none=True)
    _, _, aux = PM._forward(cfg, lm, batch["tokens"], embeds=None,
                            cache=None, last_only=False, remat=True,
                            attention="kernel")
    aux.backward()
    assert len(full) == cfg.n_layers
    for key, g in full.items():
        want = PM.AUX_LOSS_WEIGHT * dict(lm.named_parameters())[key].grad
        assert float(want.abs().max()) > 100 * ROUTER_RESIDUE, key
        torch.testing.assert_close(g, want, rtol=0, atol=ROUTER_RESIDUE)


@pytest.mark.parametrize("arch", GQA)
def test_train_steps_match_the_reference(arch):
    """3 fp32 steps of ``make_train_step`` against the reference's jitted
    step (``tests/test_torch_train.py``'s test at 3 steps): each loss
    within ``STEP_LOSS_RTOL`` relative, the final parameters within
    ``STEP_PARAM_ATOL`` where the first gradient is above ``SIGN_FLOOR``
    of its leaf's largest entry (AdamW's first update is ``lr *
    sign(g)``), at most 1% of the entries whose first gradient is not
    zero left out.  Entries with a zero first gradient (the untied
    embedding's rows of tokens the first batch lacks, an expert that no
    token chose: zeros, as ``jax.grad`` gives the reference) are not
    compared: a later step's first gradient there may be near zero too."""
    cfg_ref, params, cfg = _train_pair(arch, "float32")
    batches = _batches(cfg, 3)
    ref_opt, opt = RefAdamW(lr=3e-3), AdamW(lr=3e-3)
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


def test_moe_leaves_round_trip_through_the_stacked_layout():
    """``lm_params_to_reference`` gives the reference's tree for llama4
    (the router, the expert stacks, the shared expert: keys and shapes),
    and ``lm_named_from_reference`` inverts it bit for bit."""
    cfg_ref, params, cfg = _train_pair(LLAMA4, "float32")
    lm = PM.init_params(cfg, 3, device="cpu")
    tree = convert.lm_params_to_reference(lm, cfg)
    ref_keys = [(jax.tree_util.keystr(p), tuple(x.shape)) for p, x in
                jax.tree_util.tree_flatten_with_path(params)[0]]
    assert [(k, tuple(x.shape)) for k, x in tree_leaves(tree)] == ref_keys
    assert any(k.endswith("['ffn']['shared']['wo']") for k, _ in ref_keys)
    named = dict(lm.named_parameters())
    back = convert.lm_named_from_reference(tree, cfg)
    assert back.keys() == named.keys()
    for key, x in back.items():
        assert torch.equal(x, named[key]), key


def test_llama4_serves_and_trains_from_the_clis(capsys):
    """``serve --arch llama4_scout_17b_a16e --reduced --device cpu`` and
    the trainer CLI on the reduced config run."""
    res = serve.main(["--arch", LLAMA4, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    assert res["tokens"].shape == (2, 3)
    assert torch.isfinite(res["first_logits"]).all()
    train_cli.main(["--arch", LLAMA4, "--reduced", "--device", "cpu",
                    "--steps", "2", "--batch", "2", "--seq", "16",
                    "--log-every", "1"])
    out = capsys.readouterr().out
    assert "generated (2, 3)" in out and "final loss" in out
