"""Port parity for the recurrent mixers (``repro_torch.models.ssm``) and
the xLSTM model: the reduced xlstm-350m (8 layers, d 64, 7 mLSTM + 1
sLSTM, chunk 8, vocab 256) with the reference's ``init_params(cfg,
PRNGKey(0))`` carried across by ``convert.lm_params_from_reference``.

Tolerances:

* fp32 (``dtype="float32"``) forward logits within atol 1e-4 with
  identical greedy tokens (``tests/test_torch_lm.py``'s bound); the
  recurrent state after a prefill and decode steps within the same 1e-4;
* the logits of a prefill, its decode steps and the one-spec models,
  fp32: ``FP32_STEP_TOL``, 2e-4.  They read 1.05e-4 (a 16-token prefill)
  and 1.23e-4 (the mamba one-spec forward, 9 of 8192 logits above 1e-4):
  the mLSTM's gated norm divides rows whose rms is 1e-3 (the first tokens)
  by that rms, so a difference in summation order grows about a
  thousandfold there;
* bf16 (the published dtype) within ``LM_BF16_TOL * max|logits|``, 5e-2,
  against the reference run op by op (``jax.disable_jit()`` and its
  ``UNROLL_GROUPS`` knob), where each package rounds after every
  operation.  The reference's compiled program (its group scan) rounds
  elsewhere: on this model and a 24-token prompt it lies 1.38 from its
  own op-by-op run at max|logits| 3.34, and its bf16 lies 1.09 from its
  fp32.  The port lies 0.016 from the op-by-op run: the recurrence
  carries a rounding difference forward, so the compiled program is no
  yardstick for another implementation's bf16.  With the layers' 1-D
  leaves drawn away from their init values the port and the op-by-op run
  agree bit for bit;
* the decode against the port's own parallel forward: rtol = atol =
  2e-3, the reference's ``test_decode_matches_parallel_forward`` bound;
* ``ssd_chunked``: fp32 within 1e-5 of max|y| (sums in other orders);
  with ``intra_dtype`` bf16 the same bound, since both round the same three
  operands to bf16 and sum their products in fp32.

The loss, gradients and train steps are ``tests/test_torch_ssm_train.py``'s.
"""
import dataclasses
import functools
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import models as RM
from repro.checkpoint.checkpoint import _flatten as ref_flatten
from repro.configs import get_config as ref_get_config
from repro.configs import get_reduced as ref_reduced
from repro.models import model as RMM
from repro.models import ssm as RS
from repro.optim import AdamW as RefAdamW
from repro_torch import configs as PC
from repro_torch import convert, kernels
from repro_torch.checkpoint.checkpoint import _flatten as port_flatten
from repro_torch.compression.deepca_powersgd import tree_leaves
from repro_torch.launch import serve
from repro_torch.launch.train import checkpoint_tree
from repro_torch.models import model as PM
from repro_torch.models import ssm as PS
from repro_torch.models.config import BlockSpec
from repro_torch.optim import AdamW

# the tensors here are tiny: one thread per test process keeps a
# parallel run's workers from spinning against each other
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ARCH = "xlstm_350m"
FP32_TOL = 1e-4
#: fp32 logits of a prefill, a decode step or a one-spec model (read 1.05e-4
#: and 1.23e-4: see the module docstring)
FP32_STEP_TOL = 2e-4
LM_BF16_TOL = 5e-2
DECODE_TOL = 2e-3
CHUNK_TOL = 1e-5
#: the mLSTM leaves the loss never reads
UNUSED = ("A_log", "D")


@functools.lru_cache(maxsize=None)
def _pair(dtype: str, pattern=None, chunk=None):
    """The reduced xlstm in ``dtype`` (``pattern`` and ``chunk`` replaced
    when given) for both packages, the reference's seeded parameters and
    the port's LM holding the same values."""
    extra = {}
    if pattern is not None:
        extra["pattern"] = pattern
    if chunk is not None:
        extra["ssd_chunk"] = chunk
    cfg_ref = dataclasses.replace(ref_reduced(ARCH), dtype=dtype, **extra)
    cfg = dataclasses.replace(PC.get_reduced(ARCH), dtype=dtype, **extra)
    params = RM.init_params(cfg_ref, jax.random.PRNGKey(0))
    lm = convert.lm_params_from_reference(jax.tree.map(np.asarray, params),
                                          cfg, device="cpu")
    return cfg_ref, params, cfg, lm


def _tokens(cfg, b: int, s: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)
                                                ).astype(np.int32)


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _walk(tree, path):
    for entry in path:
        tree = tree[entry.key if hasattr(entry, "key") else entry.idx]
    return tree


@pytest.fixture
def op_by_op(monkeypatch):
    """The reference run op by op: no jit and its groups unrolled."""
    monkeypatch.setattr(RMM, "UNROLL_GROUPS", True)
    with jax.disable_jit():
        yield


def _tol(dtype: str, want) -> float:
    return FP32_TOL if dtype == "float32" else \
        LM_BF16_TOL * float(np.abs(_np(want)).max())


# ------------------------------------------------------------ the model
def test_config_and_tree_match_reference():
    """The registry runs xlstm; the published config's tree (the reference's
    ``eval_shape``) and the port's parameters have the same names, shapes
    and count, 209,828,092 (the analytic ``param_count`` gives 212,938,920:
    it counts an sLSTM as 9 d^2 where the tree holds 8 d^2 + 5 d, two norm
    scales a block where a block without an FFN has one, and leaves out
    the SSD's ``dt_bias`` and ``norm`` and the final norm)."""
    assert ARCH in PC.ARCH_IDS and ARCH not in PC.NOT_PORTED
    cfg_ref = ref_get_config(ARCH)
    shapes = jax.eval_shape(lambda k: RM.init_params(cfg_ref, k),
                            jax.random.PRNGKey(0))
    want = [(jax.tree_util.keystr(p), tuple(x.shape), str(x.dtype))
            for p, x in jax.tree_util.tree_flatten_with_path(shapes)[0]]
    cfg = PC.get_config(ARCH)
    lm = PM.LM(cfg, device="meta")
    got = [(key, tuple(x.shape), str(x.dtype).replace("torch.", ""))
           for key, x in tree_leaves(convert.lm_params_to_reference(
               {k: p for k, p in lm.named_parameters()}, cfg))]
    assert got == want
    n = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    assert n == 209_828_092
    assert PC.get_config(ARCH).param_count() == 212_938_920


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_logits_match_reference(request, dtype):
    cfg_ref, params, cfg, lm = _pair(dtype)
    toks = _tokens(cfg, 2, 24)
    if dtype == "bfloat16":
        request.getfixturevalue("op_by_op")
    want, _, _ = RM.forward(cfg_ref, params, jnp.asarray(toks))
    with torch.no_grad():
        got, cache = PM.forward(cfg, lm, torch.from_numpy(toks).long())
    assert cache is None and got.shape == (2, 24, cfg.vocab)
    np.testing.assert_allclose(_np(got.float()), _np(want), rtol=0,
                               atol=_tol(dtype, want))
    if dtype == "float32":
        np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                      np.asarray(jnp.argmax(want, -1)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(request, dtype):
    """A 16-token prefill (two chunks), then 3 greedy decode steps, fp32
    cache: the logits every step, the greedy tokens and the recurrent
    state (the SSD state and conv window, the sLSTM's h, c, n)."""
    cfg_ref, params, cfg, lm = _pair(dtype)
    if dtype == "bfloat16":
        request.getfixturevalue("op_by_op")
    toks = _tokens(cfg, 2, 16, seed=1)
    lp, cp = PM.prefill(cfg, lm, torch.from_numpy(toks).long(), max_seq=20,
                        cache_dtype=torch.float32)
    got, fed = [lp], []
    for _ in range(3):
        tok = lp.float().argmax(-1)[:, None]
        fed.append(tok.numpy().astype(np.int32))
        lp, cp = PM.decode_step(cfg, lm, cp, tok)
        got.append(lp)

    def reference(p):
        """The reference's logits at each step (fed the port's greedy
        tokens) and its final recurrent state."""
        lj, cj = RM.prefill(cfg_ref, p, jnp.asarray(toks), max_seq=20,
                            cache_dtype=jnp.float32)
        out = [lj]
        for tok in fed:
            lj, cj = RM.decode_step(cfg_ref, p, cj, jnp.asarray(tok))
            out.append(lj)
        return out, cj["groups"], cj["pos"]

    want, states, pos = reference(params)
    for step, (a, b) in enumerate(zip(got, want)):
        tol = FP32_STEP_TOL if dtype == "float32" else _tol(dtype, b)
        np.testing.assert_allclose(_np(a.float()), _np(b), rtol=0, atol=tol,
                                   err_msg=f"step {step}")
        np.testing.assert_array_equal(a.float().argmax(-1).numpy(),
                                      np.asarray(jnp.argmax(b, -1)))
    assert cp["pos"] == int(pos) == 19
    if dtype == "float32":
        width = len(cfg.pattern)
        for i in range(cfg.n_layers):
            g, slot = divmod(i, width)
            for key, x in cp["layers"][i]["ssm"].items():
                np.testing.assert_allclose(
                    x.numpy(), _np(states[slot]["ssm"][key][g]), rtol=0,
                    atol=FP32_TOL, err_msg=f"layer {i} {key}")


@pytest.mark.parametrize("prompt,steps", [(7, 1), (16, 8)])
def test_decode_matches_parallel_forward(prompt, steps):
    """The reference's check at its own case (prefill 7 tokens, decode the
    8th; one chunk) and past a chunk boundary (prefill 16, two chunks, then
    8 teacher-forced steps against a parallel forward over 24, three
    chunks): fp32, fp32 cache."""
    _, _, cfg, lm = _pair("float32")
    toks = torch.from_numpy(_tokens(cfg, 1 if steps == 1 else 2,
                                    prompt + steps, seed=3)).long()
    with torch.no_grad():
        full, _ = PM.forward(cfg, lm, toks)
    _, cache = PM.prefill(cfg, lm, toks[:, :prompt], max_seq=prompt + steps,
                          cache_dtype=torch.float32)
    for t in range(prompt, prompt + steps):
        step, cache = PM.decode_step(cfg, lm, cache, toks[:, t:t + 1])
        np.testing.assert_allclose(step.numpy(), full[:, t].numpy(),
                                   rtol=DECODE_TOL, atol=DECODE_TOL,
                                   err_msg=f"position {t}")


def test_conv_state_keeps_the_promoted_dtype():
    """An fp32 prefill into the default bf16 cache: the fresh conv state is
    bf16 in both packages, the filled one fp32 in both (the concatenate
    promotes it), equal to the reference's; the next decode step then
    gives the reference's logits at the fp32 bound (rounding the state to
    bf16 would move them by about 1e-2)."""
    cfg_ref, params, cfg, lm = _pair("float32")
    toks = _tokens(cfg, 2, 16, seed=4)
    fresh_ref = RM.init_cache(cfg_ref, 2, 20)
    fresh = PM.init_cache(cfg, 2, 20, device="cpu")
    assert fresh["layers"][0]["ssm"]["conv"].dtype == torch.bfloat16
    assert fresh_ref["groups"][0]["ssm"]["conv"].dtype == jnp.bfloat16
    lj, cj = RM.prefill(cfg_ref, params, jnp.asarray(toks), max_seq=20)
    lp, cp = PM.prefill(cfg, lm, torch.from_numpy(toks).long(), max_seq=20)
    want = cj["groups"][0]["ssm"]["conv"]
    got = cp["layers"][0]["ssm"]["conv"]
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(want[0]), rtol=0,
                               atol=FP32_TOL)
    assert cp["layers"][0]["ssm"]["state"].dtype == torch.float32
    tok = lp.argmax(-1)[:, None]
    lj, _ = RM.decode_step(cfg_ref, params, cj,
                           jnp.asarray(tok.numpy(), jnp.int32))
    lp, _ = PM.decode_step(cfg, lm, cp, tok)
    np.testing.assert_allclose(lp.numpy(), _np(lj), rtol=0, atol=FP32_TOL)


def test_chunk_rule_raises_value_error(monkeypatch):
    """A 12-token prompt at chunk 8: the reference asserts, the port
    raises ``ValueError`` (prefill, forward, the scan itself, and the
    serve and train entry points before they allocate anything); 7, 8 and
    16 tokens keep the rule."""
    cfg_ref, params, cfg, lm = _pair("float32")
    toks = _tokens(cfg, 1, 12)
    with pytest.raises(AssertionError):
        RM.prefill(cfg_ref, params, jnp.asarray(toks), max_seq=12)
    t = torch.from_numpy(toks).long()
    with pytest.raises(ValueError, match="ssd_chunk=8"):
        PM.prefill(cfg, lm, t, max_seq=12)
    with pytest.raises(ValueError, match="chunk"):
        PM.forward(cfg, lm, t)
    with pytest.raises(ValueError, match="chunk"):
        PS.ssd_chunked(torch.zeros(1, 12, 1, 2), torch.zeros(1, 12, 1),
                       torch.zeros(1, 12, 3), torch.zeros(1, 12, 3), 8)
    for ok in (7, 8, 16):
        PM.check_sequence(cfg, ok)
    PM.check_sequence(PC.get_reduced("smollm_135m"), 12)   # no SSD mixer

    def no_alloc(*a, **kw):
        raise AssertionError("allocated before the chunk check")

    monkeypatch.setattr(PM, "init_params", no_alloc)
    import repro_torch.models as models
    monkeypatch.setattr(models, "init_params", no_alloc)
    with pytest.raises(ValueError, match="ssd_chunk=8"):
        serve.run_lm(ARCH, reduced=True, batch=1, prompt_len=12, gen=2,
                     device="cpu")
    from repro_torch.launch import train
    monkeypatch.setattr(train, "init_params", no_alloc)
    with pytest.raises(ValueError, match="ssd_chunk=8"):
        train.build(train.parse_args(["--arch", ARCH, "--reduced",
                                      "--device", "cpu", "--seq", "12"]))


# ------------------------------------------------------------ the mixers
@pytest.mark.parametrize("intra", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("h,p", [(1, 5), (3, 33), (5, 8)])
def test_ssd_chunked_matches_reference(h, p, with_h0, intra):
    """Ragged head counts and widths over 3 chunks of 8, with and without an
    initial state; with ``intra_dtype`` bf16 (and B, C in bf16, as the
    model gives them) the three intra-chunk operands round as the
    reference rounds them."""
    rng = np.random.default_rng(h * 100 + p)
    bt, s, n = 2, 24, 4
    x = rng.standard_normal((bt, s, h, p)).astype(np.float32)
    log_a = -np.abs(rng.standard_normal((bt, s, h))).astype(np.float32)
    B = rng.standard_normal((bt, s, n)).astype(np.float32)
    C = rng.standard_normal((bt, s, n)).astype(np.float32)
    h0 = rng.standard_normal((bt, h, n, p)).astype(np.float32) \
        if with_h0 else None
    jdt = jnp.bfloat16 if intra == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if intra == "bfloat16" else torch.float32
    yj, hj = RS.ssd_chunked(jnp.asarray(x), jnp.asarray(log_a),
                            jnp.asarray(B).astype(jdt),
                            jnp.asarray(C).astype(jdt), 8,
                            h0=None if h0 is None else jnp.asarray(h0),
                            intra_dtype=jdt)
    yp, hp = PS.ssd_chunked(torch.from_numpy(x), torch.from_numpy(log_a),
                            torch.from_numpy(B).to(tdt),
                            torch.from_numpy(C).to(tdt), 8,
                            h0=None if h0 is None else torch.from_numpy(h0),
                            intra_dtype=tdt)
    assert yp.dtype == hp.dtype == torch.float32
    for got, want in ((yp, yj), (hp, hj)):
        want = _np(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=CHUNK_TOL * np.abs(want).max())


def test_decode_step_is_the_recurrence():
    """``ssd_decode_step`` against the reference's, and a chunked scan of
    one chunk against the same tokens stepped one at a time."""
    rng = np.random.default_rng(7)
    bt, s, h, n, p = 2, 8, 3, 4, 6
    x = rng.standard_normal((bt, s, h, p)).astype(np.float32)
    log_a = -np.abs(rng.standard_normal((bt, s, h))).astype(np.float32)
    B = rng.standard_normal((bt, s, n)).astype(np.float32)
    C = rng.standard_normal((bt, s, n)).astype(np.float32)
    h0 = rng.standard_normal((bt, h, n, p)).astype(np.float32)
    yj, hj = RS.ssd_decode_step(*(jnp.asarray(a[:, :1]) for a in
                                  (x, log_a, B, C)), jnp.asarray(h0))
    t = [torch.from_numpy(a) for a in (x, log_a, B, C)]
    yp, hp = PS.ssd_decode_step(*(a[:, :1] for a in t),
                                torch.from_numpy(h0))
    np.testing.assert_allclose(yp.numpy(), _np(yj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(hp.numpy(), _np(hj), rtol=0, atol=1e-5)
    y_all, h_all = PS.ssd_chunked(*t, 8, h0=torch.from_numpy(h0))
    state, ys = torch.from_numpy(h0), []
    for i in range(s):
        y, state = PS.ssd_decode_step(*(a[:, i:i + 1] for a in t), state)
        ys.append(y)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y_all.numpy(),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(state.numpy(), h_all.numpy(), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("mixer", ["mamba", "mlstm", "slstm"])
def test_one_spec_models_match_reference(mixer):
    """Each recurrent mixer alone, in a one-spec pattern of 8 layers (the
    mamba kind has no published config here): the forward and a prefill
    plus 2 decode steps at ``FP32_STEP_TOL``."""
    pattern = (BlockSpec(mixer, "none"),)
    cfg_ref, params, cfg, lm = _pair("float32", pattern=pattern)
    toks = _tokens(cfg, 2, 16, seed=6)

    def reference(p):
        out = [RM.forward(cfg_ref, p, jnp.asarray(toks))[0]]
        lj, cj = RM.prefill(cfg_ref, p, jnp.asarray(toks[:, :8]),
                            max_seq=10, cache_dtype=jnp.float32)
        out.append(lj)
        for t in (8, 9):
            lj, cj = RM.decode_step(cfg_ref, p, cj,
                                    jnp.asarray(toks[:, t:t + 1]))
            out.append(lj)
        return out

    want = reference(params)
    with torch.no_grad():
        got = [PM.forward(cfg, lm, torch.from_numpy(toks).long())[0]]
    lp, cp = PM.prefill(cfg, lm, torch.from_numpy(toks[:, :8]).long(),
                        max_seq=10, cache_dtype=torch.float32)
    got.append(lp)
    for t in (8, 9):
        lp, cp = PM.decode_step(cfg, lm, cp,
                                torch.from_numpy(toks[:, t:t + 1]).long())
        got.append(lp)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=0,
                                   atol=FP32_STEP_TOL)


@pytest.mark.parametrize("arch,mixer", [(ARCH, None), (ARCH, "mamba"),
                                        ("smollm_135m", None)])
def test_bf16_cast_rounds_every_layer_leaf(op_by_op, arch, mixer):
    """The reference's ``CAST_PARAMS_ONCE`` casts every leaf of its
    group-stacked tree to bf16, a layer's norm scales and biases (an SSD's
    ``dt_bias``, ``A_log``, ``D``, an sLSTM's ``b``) too; only the final
    norm stays fp32.  With those 1-D leaves drawn away from their init
    values (zeros and ones, exact in bf16), the port's bf16 logits equal
    the op-by-op reference's within ``LM_BF16_TOL`` (keeping them fp32
    leaves it by 1.31 and 0.098 of max|logits| on the xlstm and the mamba
    model), every layer leaf enters the layers in bf16, and the gradient
    of each fp32 master leaf of a layer is a bf16 value, as the
    reference's is."""
    extra = {"n_layers": 2} if arch != ARCH else {}
    if mixer is not None:
        extra["pattern"] = (BlockSpec(mixer, "none"),)
    cfg_ref = dataclasses.replace(ref_reduced(arch), dtype="bfloat16",
                                  **extra)
    cfg = dataclasses.replace(PC.get_reduced(arch), dtype="bfloat16",
                              **extra)
    rng = np.random.default_rng(3)

    def draw(path, a):
        a = np.asarray(a)
        if jax.tree_util.keystr(path).startswith("['groups']") and \
                a.ndim == 2:
            return (a + rng.normal(0, 0.5, a.shape)).astype(np.float32)
        return a

    params = jax.tree_util.tree_map_with_path(
        draw, RM.init_params(cfg_ref, jax.random.PRNGKey(0)))
    lm = convert.lm_params_from_reference(params, cfg, device="cpu")
    toks = _tokens(cfg, 2, 16, seed=7)
    want, _, _ = RM.forward(cfg_ref, params, jnp.asarray(toks))
    with torch.no_grad():
        got, _ = PM.forward(cfg, lm, torch.from_numpy(toks).long())
    np.testing.assert_allclose(_np(got.float()), _np(want), rtol=0,
                               atol=_tol("bfloat16", want))
    tree = PM._param_tree(lm, torch.bfloat16)
    for i, layer in enumerate(tree["layers"].values()):
        for key, x in tree_leaves(layer):
            assert x.dtype == torch.bfloat16, (i, key)
    assert tree["final_norm"].dtype == torch.float32
    PM.loss_fn(cfg, lm, {"tokens": torch.from_numpy(toks).long(),
                         "labels": torch.from_numpy(
                             np.roll(toks, -1, axis=1)).long()}).backward()
    for name, p in lm.named_parameters():
        if name.startswith("layers.") and p.grad is not None:
            assert p.dtype == torch.float32, name
            assert torch.equal(p.grad, p.grad.bfloat16().float()), name


def test_init_follows_the_reference_recipe():
    """The port's own seeded init: ``A_log = log(linspace(1, H))``, ``D``
    ones, zero bias and norms, the conv at N(0, 0.1^2), the sLSTM's
    recurrent weight at a tenth of the input's scale; the fp32 leaves
    stay fp32 in a bf16 model."""
    cfg = PC.get_reduced(ARCH)
    lm = PM.init_params(cfg, 0, device="cpu")
    m, s = lm.layers[0].mixer, lm.layers[7].mixer
    nh = m.A_log.shape[0]
    torch.testing.assert_close(m.A_log, torch.log(torch.linspace(1, nh, nh)))
    assert torch.equal(m.D, torch.ones(nh)) and not m.dt_bias.any()
    assert not m.norm.any() and not s.b.any() and not s.norm.any()
    assert abs(float(m.conv.detach().std()) - 0.1) < 0.03
    ratio = float(s.wh.detach().abs().max() / s.wx.detach().abs().max())
    assert 0.05 < ratio < 0.15
    assert not hasattr(lm.layers[0], "ffn") and not hasattr(lm.layers[0],
                                                            "norm2")
    bf = PM.LM(cfg, device="meta", dtype=torch.bfloat16)
    for name, p in bf.named_parameters():
        fp32 = name.endswith(("dt_bias", "A_log", ".D", "mixer.b"))
        assert p.dtype == (torch.float32 if fp32 else torch.bfloat16), name


def test_cache_holds_no_kv_without_attention():
    """Per block kind: the SSD state and conv window, the sLSTM's h, c, n,
    and no k/v anywhere."""
    cfg = PC.get_reduced(ARCH)
    cache = PM.init_cache(cfg, 3, 64, device="cpu")
    assert len(cache["layers"]) == cfg.n_layers
    din = cfg.ssd_expand * cfg.d_model
    for i, entry in enumerate(cache["layers"]):
        assert list(entry) == ["ssm"]
        if PM.layer_spec(cfg, i).mixer == "slstm":
            assert sorted(entry["ssm"]) == ["c", "h", "n"]
            assert entry["ssm"]["h"].shape == (3, cfg.d_model)
        else:
            assert entry["ssm"]["state"].shape == (
                3, din // cfg.ssd_head_dim, cfg.ssd_d_state,
                cfg.ssd_head_dim + 1)
            assert entry["ssm"]["conv"].shape == (3, cfg.conv_dim - 1, din)
            assert entry["ssm"]["conv"].dtype == torch.bfloat16
    assert PS.ssd_cache_init(cfg, 1, "mamba", device="cpu")["state"].shape \
        [-1] == cfg.ssd_head_dim


def test_conversion_round_trips_the_recurrent_leaves():
    """``lm_params_to_reference`` gives the reference's tree (keys, shapes,
    dtypes: the SSD and sLSTM leaves through the generic walk), and
    ``lm_named_from_reference`` inverts it bit for bit, for parameters,
    gradients and the checkpoint's ``(params, AdamWState)``."""
    cfg_ref, params, cfg, _ = _pair("float32")
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
    want = ref_flatten((params, RefAdamW().init(params)))
    opt = AdamW()
    state = opt.init({k: p.detach() for k, p in named.items()})
    got = port_flatten(checkpoint_tree(cfg, lm, state))
    assert list(got) == list(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        assert got[key].dtype == want[key].dtype, key


# ------------------------------------------------------------ serving
def test_serve_gives_the_references_tokens(capsys, op_by_op):
    """``serve --workload lm --arch xlstm_350m --reduced --batch 2
    --prompt-len 16 --gen 4`` (the reference's ``test_serve_runs``
    arguments): the reference's serve, run op by op with its own seeded
    weights, and the port's ``serve_lm`` on the same weights (carried
    across) and the prompt it draws, give the same greedy tokens."""
    import argparse
    from repro.launch import serve as ref_serve
    ref_serve.serve_lm(argparse.Namespace(arch=ARCH, reduced=True, batch=2,
                                          prompt_len=16, gen=4, seed=0))
    printed = capsys.readouterr().out
    want = [int(v) for v in re.findall(r"-?\d+", printed.split("\n", 1)[1])]
    cfg_ref = ref_reduced(ARCH)
    params = RM.init_params(cfg_ref, jax.random.PRNGKey(0))
    cfg = PC.get_reduced(ARCH)
    lm = convert.lm_params_from_reference(jax.tree.map(np.asarray, params),
                                          cfg, device="cpu")
    toks = serve.prompt_tokens(cfg, 2, 16, 0, device="cpu")
    kernels.reset_launch_counts()
    res = serve.serve_lm(cfg, lm, toks, 4)
    assert not any(kernels.launch_counts().values())
    assert res["tokens"].flatten().tolist() == want


def test_serve_and_train_cli_on_cpu_reduced():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--workload",
         "lm", "--arch", ARCH, "--reduced", "--device", "cpu", "--batch",
         "2", "--prompt-len", "16", "--gen", "4"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "generated (2, 4)" in out.stdout and "tok/s" in out.stdout
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--reduced", "--device", "cpu", "--steps", "3", "--batch", "2",
         "--seq", "32", "--log-every", "1"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    losses = [float(v) for v in re.findall(r"loss (\d+\.\d+)", out.stdout)]
    assert len(losses) == 4 and all(np.isfinite(losses)), out.stdout
