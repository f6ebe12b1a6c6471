"""Port parity for DeepSeek-V2 (``--arch deepseek_v2_236b``): multi-head
latent attention (MLA) and the dense layer 0, on the reference's
``reduced()`` config (3 layers: layer 0 with a dense FFN of 128, then 2
MoE layers of 8 experts, top-2, 2 shared; 4 heads, qk 16 + 8 rope, v 16,
kv_lora 16, q_lora 32) with the reference's ``init_params(cfg,
PRNGKey(0))`` carried over by ``convert.lm_params_from_reference``.

What is held, and to what:
* the flash wrapper's plain version at split head dims (q and k 24, v 16;
  and the published 192 / 128) against the reference's
  ``_einsum_attention`` and ``_chunked_attention`` (fp32 2e-5, bf16 2e-2:
  ``tests/test_torch_flash_attention.py``'s bounds), and the bf16
  kernel's emulated rounding at (192, 128) against the plain version
  (2e-2, the kernel's on-card bound);
* ``mla_forward``'s expanded prefill and 4 absorbed decode steps against
  the reference's ``mla_forward``: the outputs and the ``ckv`` / ``k_pe``
  cache entries, fp32 within ``FP32_TOL`` (1e-4) and bf16 within
  ``LM_BF16_TOL`` (5e-2) of the largest entry;
* the absorbed decode against the port's own expanded form: token S + 1
  decoded from the latent cache against the expanded forward over S + 1
  tokens, in f64 tensors within ``ABSORBED_TOL`` = 1e-5 of max|out|.  Both
  forms run the softmax in fp32 (the reference's ``.astype(float32)``) and
  the RMS norms in fp32, so they agree to fp32 rounding (about 1e-7
  relative per op), not to f64; a wrong absorption (a transposed
  ``w_uk``, a missing rope term) is off by O(1);
* the whole model: fp32 logits within ``FP32_TOL``, a prefill and 4
  greedy decode steps (tokens equal, the caches of layer 0 and of the
  stack), the loss with the MoE auxiliary loss and every gradient leaf
  (layer 0's included) within ``tests/test_torch_train.py``'s bounds, and
  3 AdamW steps of ``make_train_step`` against the reference's jitted
  step;
* the bf16 ``CAST_PARAMS_ONCE`` cast with the norm scales set off zero:
  leaf by leaf, dtype and bits, the reference's rule (every fp32 leaf of
  two or more dimensions of its tree cast; ``layer0`` is outside the
  group stack, so its norm scales stay fp32, while the stacked layers'
  norms, MLA's ``q_norm`` and ``kv_norm`` included, are cast), and layer
  0's block in bf16 on those leaves within ``LM_BF16_TOL``;
* the card's training cut (``CUT``: layer 0 and one stacked layer, 4 of
  the 8 experts; the published config cut to 2 layers and 32 experts
  trains on the card) at the reduced widths: the loss, every gradient and
  3 AdamW steps at the bounds above;
* the converter's round trip with ``layer0``, and the serve and train
  CLIs on the reduced config.
"""
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from repro import models as RM
from repro.configs import get_config as ref_get_config
from repro.configs import get_reduced as ref_reduced
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.models import attention as RA
from repro.models import blocks as RB
from repro.models import model as RMM
from repro.optim import AdamW as RefAdamW
from repro_torch import configs as PC
from repro_torch import convert
from repro_torch.compression.deepca_powersgd import tree_leaves
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve
from repro_torch.launch import train as train_cli
from repro_torch.launch.steps import _grads, make_train_step
from repro_torch.models import attention as PA
from repro_torch.models import blocks as PB
from repro_torch.models import model as PM
from repro_torch.optim import AdamW
from test_torch_flash_attention import _emulate_bf16_kernel
from test_torch_train import (GRAD_TOL, LOSS_RTOL, SIGN_FLOOR,
                              STEP_LOSS_RTOL, STEP_PARAM_ATOL, _batches,
                              _walk)

# the tensors here are tiny: one thread per test process keeps a
# parallel run's workers from spinning against each other
torch.set_num_threads(1)

ARCH = "deepseek_v2_236b"
FP32_TOL = 1e-4
LM_BF16_TOL = 5e-2
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
ABSORBED_TOL = 1e-5
#: the reference's ``param_count`` of the published config
PARAM_COUNT = 235_741_306_880


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


#: The card's training cut of deepseek-v2 (2 of 60 layers, 32 of 160
#: routed experts: PERF.md section 4) at the reduced widths: layer 0 and
#: one stacked MLA + MoE layer, 4 of the reduced config's 8 experts.
CUT = {"n_layers": 2, "n_experts": 4}


@functools.lru_cache(maxsize=None)
def _pair(dtype: str = "float32", cut: bool = False):
    extra = CUT if cut else {}
    cfg_ref = dataclasses.replace(ref_reduced(ARCH), dtype=dtype, **extra)
    cfg = dataclasses.replace(PC.get_reduced(ARCH), dtype=dtype, **extra)
    params = RM.init_params(cfg_ref, jax.random.PRNGKey(0))
    return cfg_ref, params, cfg


def _lm(cfg, params):
    return convert.lm_params_from_reference(
        jax.tree.map(np.asarray, params), cfg, device="cpu")


def _tokens(cfg, b: int, s: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)
                                                ).astype(np.int32)


# ------------------------------------------------------------- the config
def test_config_matches_reference():
    """The published and the reduced config field for field, the
    parameter count and the group count; the id is registered."""
    assert ARCH in PC.ARCH_IDS and ARCH not in PC.NOT_PORTED
    for get_port, get_ref in ((PC.get_reduced, ref_reduced),
                              (PC.get_config, ref_get_config)):
        cfg, cfg_ref = get_port(ARCH), get_ref(ARCH)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(cfg_ref)
        assert cfg.param_count() == cfg_ref.param_count()
        assert cfg.n_groups == cfg_ref.n_groups == cfg.n_layers - 1
    assert PC.get_config(ARCH).param_count() == PARAM_COUNT
    _, params, cfg = _pair()
    lm = _lm(cfg, params)
    assert sum(p.numel() for p in lm.parameters()) == \
        sum(x.size for x in jax.tree.leaves(params))
    assert lm.layer0.ffn.wo.shape == (cfg.first_dense_ff, cfg.d_model)
    assert len(lm.layers) == cfg.scan_layers == 2


# ------------------------------------------------ flash at split head dims
def _qkv(b, h, sq, skv, hd, hdv, dtype, seed):
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(shape).astype(np.float32) for shape in (
        (b, h, sq, hd), (b, h, skv, hd), (b, h, skv, hdv))]
    return ([jnp.asarray(x, getattr(jnp, dtype)) for x in xs],
            [torch.from_numpy(x).to(getattr(torch, dtype)) for x in xs])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd,hdv", [(24, 16), (192, 128)])
def test_plain_flash_at_split_dims_matches_einsum_attention(hd, hdv, causal,
                                                            dtype):
    """The plain version at q and k's hd, v's hdv: the reference's exact
    masked softmax (scale ``hd ** -0.5``, v's dim out)."""
    (qj, kj, vj), (q, k, v) = _qkv(2, 4, 40, 40, hd, hdv, dtype,
                                   hd + causal)
    want = RA._einsum_attention(qj, kj, vj, causal)
    got = fa.flash_attention(q, k, v, causal=causal)       # CPU: plain
    assert got.shape == (2, 4, 40, hdv) and got.dtype == q.dtype
    assert got.transpose(1, 2).is_contiguous()
    np.testing.assert_allclose(got.float().numpy(), _np(want),
                               rtol=FLASH_TOL[dtype], atol=FLASH_TOL[dtype])


def test_plain_flash_at_split_dims_matches_chunked_attention(monkeypatch):
    """Against the reference's online-softmax ``_chunked_attention`` (its
    own ``hdv != hd`` path), with 32-row chunks so that 3 q and 3 kv
    chunks run: fp32, causal and not."""
    monkeypatch.setattr(RA, "_Q_CHUNK", 32)
    monkeypatch.setattr(RA, "_KV_CHUNK", 32)
    (qj, kj, vj), (q, k, v) = _qkv(1, 4, 96, 96, 24, 16, "float32", 5)
    for causal in (True, False):
        want = RA._chunked_attention(qj, kj, vj, causal)
        got = fa.flash_attention_plain(q, k, v, causal=causal)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=2e-5,
                                   atol=2e-5)


@pytest.mark.parametrize("sq,causal", [(333, True), (128, False)])
def test_bf16_kernel_rounding_at_192_128_within_tolerance_of_plain(sq,
                                                                   causal):
    """The bf16 kernel's arithmetic (``_emulate_bf16_kernel``, P rounded
    to bf16 before P V) at MLA's published dims against the plain
    version, within the kernel's on-card bound 2e-2."""
    _, (q, k, v) = _qkv(1, 2, sq, sq, 192, 128, "bfloat16", sq)
    got = _emulate_bf16_kernel(q, k, v, causal).bfloat16()
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=FLASH_TOL["bfloat16"],
                               atol=FLASH_TOL["bfloat16"])


def test_split_dim_shapes_and_the_backwards_refusal():
    """k and v must agree on (B, Hkv, Skv) and q and k on hd; the shared
    memory models of the (192, 128) instances, forward and backward (the
    backward's byte counts from the C's formulas by hand, each within a
    block's 232,448 bytes; the square pairs' unchanged); the backward takes
    (192, 128) and refuses every pair without an instance before any
    build, naming the pair."""
    q, k = torch.zeros(1, 2, 8, 192), torch.zeros(1, 2, 8, 192)
    with pytest.raises(ValueError, match="hd_v"):
        fa.flash_attention(q, k, torch.zeros(1, 2, 7, 128))
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, torch.zeros(1, 2, 8, 128),
                           torch.zeros(1, 2, 8, 128))
    assert fa.forward_smem(192, True, 128) == 2 * (64 * 192 + 2 * 64 * 320)
    assert fa.forward_smem(192, True, 128) == 104 * 1024
    assert fa.forward_smem(192, False, 128) == \
        4 * (2 * 64 * 193 + 64 * 128 + 64 * 65)
    assert fa.forward_smem(128, True) == fa.forward_smem(128, True, 128)
    assert (192, 128) in fa.KERNEL_HEAD_DIM_PAIRS
    assert fa.BACKWARD_HEAD_DIM_PAIRS == ((64, 64), (128, 128), (192, 128))
    # bf16: dQ q, dO, K and V rings, lse and D; dK/dV K, V and two warp
    # groups' two-stage q and dO rings; fp32 rows padded to 193 and 129
    assert fa.backward_smem(192, True, 128) == (123_392, 206_848)
    assert fa.backward_smem(192, False, 128) == (182_016, 198_656)
    assert max(fa.backward_smem(192, True, 128)
               + fa.backward_smem(192, False, 128)) <= 232_448
    assert fa.backward_smem(64, True) == (6 * 64 * 64 * 2 + 512,
                                          10 * 64 * 64 * 2 + 2048)
    assert fa.backward_smem(128, True) == (6 * 64 * 128 * 2 + 512,
                                           10 * 64 * 128 * 2 + 2048)
    for hd in (64, 128):
        tiles = 4 * 64 * (hd + 1) + 128
        assert fa.backward_smem(hd, False) == (
            4 * (tiles + 64 * 65), 4 * (tiles + 2 * 64 * 65))
        assert fa.backward_smem(hd, True) == \
            fa.backward_smem(hd, True, hd)
    fa._check_backward_head_dims(q, torch.zeros(1, 2, 8, 128))
    for hd, hd_v in ((192, 192), (192, 64), (128, 64)):
        qq = torch.zeros(1, 2, 8, hd)
        vv = torch.zeros(1, 2, 8, hd_v)
        with pytest.raises(ValueError, match=rf"got \({hd}, {hd_v}\)"):
            fa._check_backward_head_dims(qq, vv)
        with pytest.raises(ValueError, match=rf"got \({hd}, {hd_v}\)"):
            fa.flash_attention_backward(qq, qq, vv, torch.zeros(1, 2, 8, hd_v),
                                        torch.zeros(1, 2, 8), vv)
    fa._check_backward_head_dims(torch.zeros(1, 2, 8, 64),
                                 torch.zeros(1, 2, 8, 64))


def test_plain_backward_takes_split_dims():
    """The backward's plain formulas at split dims against autograd
    through the plain forward (the oracle a later backward kernel at
    (192, 128) is held to), fp32."""
    _, (q, k, v) = _qkv(1, 2, 24, 24, 24, 16, "float32", 8)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    out, lse = fa.flash_attention_plain(q, k, v, causal=True,
                                        return_lse=True)
    do = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    want = torch.autograd.grad(out, (q, k, v), do)
    got = fa.flash_attention_backward_plain(q.detach(), k.detach(),
                                            v.detach(), out.detach(),
                                            lse.detach(), do, causal=True)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5)


# ------------------------------------------------------------- MLA alone
def _mla_pair(dtype: str, seed: int = 0):
    """The reduced config's MLA weights from the reference's ``mla_init``,
    as a numpy tree (both packages read it)."""
    cfg_ref = dataclasses.replace(ref_reduced(ARCH), dtype=dtype)
    cfg = dataclasses.replace(PC.get_reduced(ARCH), dtype=dtype)
    tree = jax.tree.map(np.asarray, RA.mla_init(cfg_ref,
                                                jax.random.PRNGKey(seed)))
    return cfg_ref, cfg, tree


def _scale(x) -> float:
    return float(np.abs(_np(x)).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_prefill_and_decode_match_reference(dtype):
    """An 8-token prefill (the expanded form) with a cache of 12, then 4
    absorbed decode steps, against the reference's ``mla_forward``: each
    output and, after each step, the whole ``ckv`` and ``k_pe`` cache
    (cache in the compute dtype, as ``prefill`` allocates it)."""
    cfg_ref, cfg, tree = _mla_pair(dtype)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    pj = jax.tree.map(jnp.asarray, tree)
    pt = {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}
    module = PA.MLA(cfg, device="cpu")
    module.load_state_dict(pt, strict=True)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    cj = {"ckv": jnp.zeros((2, 12, cfg.kv_lora_rank), jdt),
          "k_pe": jnp.zeros((2, 12, cfg.qk_rope_dim), jdt)}
    ct = {"ckv": torch.zeros(2, 12, cfg.kv_lora_rank, dtype=tdt),
          "k_pe": torch.zeros(2, 12, cfg.qk_rope_dim, dtype=tdt)}
    tol = FP32_TOL if dtype == "float32" else None
    for start, stop in ((0, 8), (8, 9), (9, 10), (10, 11), (11, 12)):
        pos = np.broadcast_to(np.arange(start, stop, dtype=np.int32),
                              (2, stop - start))
        want, cj = RA.mla_forward(
            cfg_ref, pj, jnp.asarray(x[:, start:stop], jdt),
            positions=jnp.asarray(pos), cache={**cj, "pos": start})
        with torch.no_grad():
            got, ct = PA.mla_forward(
                cfg, pt, torch.from_numpy(x[:, start:stop]).to(tdt),
                positions=torch.from_numpy(pos.copy()),
                cache={**ct, "pos": start})
        assert got.dtype == tdt and got.shape == want.shape
        for a, b in ((got, want), (ct["ckv"], cj["ckv"]),
                     (ct["k_pe"], cj["k_pe"])):
            atol = tol if tol is not None else LM_BF16_TOL * _scale(b)
            np.testing.assert_allclose(a.float().numpy(), _np(b), rtol=0,
                                       atol=atol)


def test_absorbed_decode_matches_the_expanded_form_in_f64():
    """Token S + 1 from the absorbed form against the latent cache of S
    prefilled tokens, against the expanded forward over all S + 1 tokens
    (the port's own two forms), f64 tensors, within ``ABSORBED_TOL`` of
    max|out| (the docstring: fp32 softmax and norms in both)."""
    _, cfg, tree = _mla_pair("float32", seed=1)
    p = {k: torch.from_numpy(np.array(v)).double() for k, v in tree.items()}
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 10, cfg.d_model))).double()
    pos = torch.arange(10, dtype=torch.int32)[None].expand(2, 10)
    with torch.no_grad():
        full, _ = PA.mla_forward(cfg, p, x, positions=pos)
        cache = {"ckv": torch.zeros(2, 10, cfg.kv_lora_rank,
                                    dtype=torch.float64),
                 "k_pe": torch.zeros(2, 10, cfg.qk_rope_dim,
                                     dtype=torch.float64)}
        _, cache = PA.mla_forward(cfg, p, x[:, :9], positions=pos[:, :9],
                                  cache={**cache, "pos": 0})
        last, _ = PA.mla_forward(cfg, p, x[:, 9:], positions=pos[:, 9:],
                                 cache={**cache, "pos": 9})
    assert last.dtype == torch.float64
    err = float((last[:, 0] - full[:, 9]).abs().max())
    assert err <= ABSORBED_TOL * float(full[:, 9].abs().max()), err


# ------------------------------------------------------ the whole model
def test_reduced_logits_match_reference():
    cfg_ref, params, cfg = _pair()
    lm = _lm(cfg, params)
    toks = _tokens(cfg, 2, 20)
    want, _, _ = RM.forward(cfg_ref, params, jnp.asarray(toks))
    with torch.no_grad():
        got, _ = PM.forward(cfg, lm, torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=FP32_TOL)


def test_reduced_prefill_and_greedy_decode_match_reference():
    """A 9-token prefill and 4 greedy decode steps (fp32 cache): the
    logits, the greedy tokens and, at the end, every cache entry (layer 0
    and the stack's, whose groups the port unstacks)."""
    cfg_ref, params, cfg = _pair()
    lm = _lm(cfg, params)
    toks = _tokens(cfg, 2, 9, seed=1)
    lj, cj = RM.prefill(cfg_ref, params, jnp.asarray(toks), max_seq=13,
                        cache_dtype=jnp.float32)
    lp, cp = PM.prefill(cfg, lm, torch.from_numpy(toks).long(), max_seq=13,
                        cache_dtype=torch.float32)
    for _ in range(4):
        np.testing.assert_allclose(lp.numpy(), _np(lj), rtol=0,
                                   atol=FP32_TOL)
        tok = lp.argmax(-1)[:, None]
        np.testing.assert_array_equal(tok.numpy()[:, 0],
                                      np.asarray(jnp.argmax(lj, -1)))
        lj, cj = RM.decode_step(cfg_ref, params, cj,
                                jnp.asarray(tok.numpy(), jnp.int32))
        lp, cp = PM.decode_step(cfg, lm, cp, tok)
    np.testing.assert_allclose(lp.numpy(), _np(lj), rtol=0, atol=FP32_TOL)
    assert cp["pos"] == int(cj["pos"]) == 13
    for key in ("ckv", "k_pe"):
        np.testing.assert_allclose(cp["layer0"]["kv"][key].numpy(),
                                   _np(cj["layer0"]["kv"][key]), rtol=0,
                                   atol=FP32_TOL)
        for g in range(cfg.n_groups):
            np.testing.assert_allclose(cp["layers"][g]["kv"][key].numpy(),
                                       _np(cj["groups"][0]["kv"][key][g]),
                                       rtol=0, atol=FP32_TOL)


def test_loss_and_grads_match_the_reference():
    """The loss (with the MoE auxiliary loss) and every gradient leaf,
    layer 0's included, against ``jax.value_and_grad`` of the reference's
    ``loss_fn``, fp32."""
    _check_loss_and_grads(cut=False)


def test_card_cut_loss_and_grads_match_the_reference():
    """:func:`test_loss_and_grads_match_the_reference` on the card's
    training cut at the reduced widths (``CUT``): layer 0 and one stacked
    layer, 4 experts, in both packages."""
    _, _, cfg = _pair(cut=True)
    assert (cfg.n_layers, cfg.scan_layers, cfg.n_experts) == (2, 1, 4)
    _check_loss_and_grads(cut=True)


def _check_loss_and_grads(cut: bool) -> None:
    cfg_ref, params, cfg = _pair(cut=cut)
    raw = _batches(cfg, 1)[0]
    want, g_ref = jax.value_and_grad(lambda p: RM.loss_fn(
        cfg_ref, p, {k: jnp.asarray(v) for k, v in raw.items()}))(params)
    lm = _lm(cfg, params)
    got = PM.loss_fn(cfg, lm, {k: torch.from_numpy(v)
                               for k, v in raw.items()})
    got.backward()
    g_port = convert.lm_params_to_reference(_grads(lm), cfg)
    assert abs(got.item() - float(want)) <= LOSS_RTOL["float32"] * \
        float(want)
    flat = jax.tree_util.tree_flatten_with_path(g_ref)[0]
    assert len(flat) == len(list(tree_leaves(g_port)))
    keys = [jax.tree_util.keystr(path) for path, _ in flat]
    assert any(k.startswith("['layer0']['mixer']") for k in keys)
    for path, g in flat:
        g = np.asarray(g, np.float32)
        mine = _walk(g_port, path).numpy()
        key = jax.tree_util.keystr(path)
        assert mine.shape == g.shape, key
        np.testing.assert_allclose(mine, g, rtol=0,
                                   atol=GRAD_TOL["float32"] * np.abs(g).max(),
                                   err_msg=key)


def test_train_steps_match_the_reference():
    """3 fp32 AdamW steps of ``make_train_step`` against the reference's
    jitted step, as ``tests/test_torch_archs.py`` holds the GQA models:
    each loss within ``STEP_LOSS_RTOL``, the final parameters within
    ``STEP_PARAM_ATOL`` where the first gradient is above ``SIGN_FLOOR``
    of its leaf's largest entry, at most 1% of the entries whose first
    gradient is not zero left out."""
    _check_train_steps(cut=False)


def test_card_cut_train_steps_match_the_reference():
    """:func:`test_train_steps_match_the_reference` on the card's training
    cut at the reduced widths (``CUT``)."""
    _check_train_steps(cut=True)


def _check_train_steps(cut: bool) -> None:
    cfg_ref, params, cfg = _pair(cut=cut)
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


def _norms_off_zero(params):
    """The reference's tree with every norm scale (``*norm*`` leaves)
    drawn off zero, at values bf16 cannot hold exactly."""
    rng = np.random.default_rng(7)

    def draw(path, x):
        if "norm" in jax.tree_util.keystr(path[-1:]):
            return jnp.asarray(0.1 * rng.standard_normal(x.shape), x.dtype)
        return x
    return jax.tree_util.tree_map_with_path(draw, params)


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for key, node in tree.items():
        name = f"{prefix}{key}"
        out.update(_flat(node, name + ".") if isinstance(node, dict)
                   else {name: node})
    return out


def test_bf16_cast_keeps_layer0_norms_fp32():
    """The port's ``CAST_PARAMS_ONCE`` tree, put back in the reference's
    layout, against the reference's rule applied to its own tree, leaf by
    leaf in dtype and bits (norm scales off zero); then layer 0's block
    in bf16 on those leaves (MLA's expanded form, the dense FFN, fp32
    norm scales) within ``LM_BF16_TOL`` of max|out|.  Not the whole
    model's bf16 logits: its top-2 routers are discontinuous, and one
    bf16 rounding sends a token to another expert (on this batch one
    token of 32 leaves the reference's logits by 0.29 where the others
    stay within 0.05, the fp32 case routes all alike)."""
    assert RMM.CAST_PARAMS_ONCE and PM.CAST_PARAMS_ONCE
    cfg_ref, params, cfg = _pair("bfloat16")
    params = _norms_off_zero(params)
    ref_cast = jax.tree.map(
        lambda a: a.astype(jnp.bfloat16)
        if a.dtype == jnp.float32 and a.ndim >= 2 else a, params)
    lm = _lm(cfg, params)
    tree = PM._param_tree(lm, torch.bfloat16)
    assert tree["layer0"]["norm1"].dtype == torch.float32
    assert tree["layer0"]["mixer"]["kv_norm"].dtype == torch.float32
    assert tree["layer0"]["mixer"]["q_up"].dtype == torch.bfloat16
    assert tree["layers"]["0"]["mixer"]["q_norm"].dtype == torch.bfloat16
    port = convert.lm_params_to_reference(_flat(tree), cfg)
    flat = jax.tree_util.tree_flatten_with_path(ref_cast)[0]
    assert len(flat) == len(list(tree_leaves(port)))
    for path, want in flat:
        key = jax.tree_util.keystr(path)
        got = _walk(port, path)
        assert str(got.dtype).split(".")[-1] == str(want.dtype), key
        np.testing.assert_array_equal(got.float().numpy(), _np(want),
                                      err_msg=key)
    x = np.random.default_rng(4).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16))
    want, _, _ = RB.block_forward(
        cfg_ref, PM.layer0_spec(cfg), ref_cast["layer0"],
        jnp.asarray(x, jnp.bfloat16), positions=jnp.asarray(pos))
    with torch.no_grad():
        got, _, _ = PB.block_forward(
            cfg, PM.layer0_spec(cfg), tree["layer0"],
            torch.from_numpy(x).bfloat16(),
            positions=torch.from_numpy(pos.copy()))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=0,
                               atol=LM_BF16_TOL * _scale(want))


def test_conversion_round_trips_with_layer0():
    """``lm_params_to_reference`` gives the reference's tree (``layer0``
    unstacked, the groups stacked over ``scan_layers``: keys and shapes),
    and ``lm_named_from_reference`` inverts it bit for bit."""
    _, params, cfg = _pair()
    lm = PM.init_params(cfg, 3, device="cpu")
    tree = convert.lm_params_to_reference(lm, cfg)
    ref_keys = [(jax.tree_util.keystr(p), tuple(x.shape)) for p, x in
                jax.tree_util.tree_flatten_with_path(params)[0]]
    assert [(k, tuple(x.shape)) for k, x in tree_leaves(tree)] == ref_keys
    assert "['layer0']['ffn']['wo']" in dict(ref_keys)
    named = dict(lm.named_parameters())
    back = convert.lm_named_from_reference(tree, cfg)
    assert back.keys() == named.keys()
    for key, x in back.items():
        assert torch.equal(x, named[key]), key


def test_deepseek_serves_and_trains_from_the_clis(capsys):
    """``serve --arch deepseek_v2_236b --reduced --device cpu`` and the
    trainer CLI on the reduced config run."""
    res = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    assert res["tokens"].shape == (2, 3)
    assert torch.isfinite(res["first_logits"]).all()
    train_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                    "--steps", "2", "--batch", "2", "--seq", "16",
                    "--log-every", "1"])
    out = capsys.readouterr().out
    assert "generated (2, 3)" in out and "final loss" in out
