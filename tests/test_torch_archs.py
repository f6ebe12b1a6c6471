"""The architectures the port runs beside SmolLM: the dense-GQA yi-34b,
phi3-medium-14b and qwen1.5-110b (QKV bias, untied heads, new head
ratios), the encoder-decoder whisper-small and the recurrent xlstm-350m.

Their configs equal the reference's, published and reduced, with the
reference's parameter counts; the reduced dense-GQA models, loaded from
the reference's ``init_params(cfg, PRNGKey(0))``, give its fp32 logits
within atol 1e-4 (``tests/test_torch_lm.py``'s bound) and its greedy
tokens, over a prefill and 3 decode steps (fp32 cache).  Whisper's
parity is ``tests/test_torch_whisper.py``, xlstm's
``tests/test_torch_ssm.py``.
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
from repro_torch import configs as PC
from repro_torch import convert
from repro_torch.models import model as PM
from repro_torch.models.config import model_flops_per_token

# the tensors here are tiny: one thread per test process keeps a
# parallel run's workers from spinning against each other
torch.set_num_threads(1)

FP32_TOL = 1e-4
#: the reference's ``param_count`` of each published config
PARAM_COUNTS = {"whisper_small": 334_663_680,
                "yi_34b": 34_388_910_080,
                "phi3_medium_14b": 14_659_502_080,
                "qwen1_5_110b": 111_209_086_976,
                "xlstm_350m": 212_938_920}
DENSE_GQA = ["yi_34b", "phi3_medium_14b", "qwen1_5_110b"]


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


@pytest.mark.parametrize("arch", DENSE_GQA)
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


@pytest.mark.parametrize("arch", DENSE_GQA)
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
