"""The mixture-of-experts FFN (``repro_torch.models.moe``) against the
reference's single-device path, ``repro.models.moe._moe_reference``.

One MoE layer of the reduced llama4-scout (d 64, 4 experts of 128), its
weights drawn by the reference's ``moe_init`` and carried across by
``convert``, on ``default_rng(0).standard_normal((4, 32, 64))``: top-1
with one shared expert (the published routing) and, through
``dataclasses.replace`` on both sides, top-2 with 2 shared experts.

Tolerances (readings, top-1 / top-2, in brackets): the output within
1e-5 * max|out| in fp32 [1.6e-7 / 2.3e-7] and 1e-2 * max|out| in bf16
[8.4e-5 / 1.0e-4]; the auxiliary loss within 1e-6 relative [0 / 0].  The cases: exact ties in the router (an integer-valued router
with two equal columns and inputs on a 1/8 grid, so every logit is exact
whatever the summation order) go to the lower index, as
``jax.lax.top_k`` does; a batch whose router sends most tokens to expert
0 overflows its capacity (drops > 0) and matches; a decode-size call (t =
B tokens, capacity 8) matches.  The masked dense evaluation
(``moe_masked_dense``: each expert takes the first ``capacity``
assignments that chose it, found by ``nonzero``) equals the scatter
dispatch within the fp32 bound, with and without drops.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_reduced as ref_reduced
from repro.models import moe as RMoE
from repro_torch import configs as PC
from repro_torch import convert
from repro_torch.models import moe as PMoE

torch.set_num_threads(1)

ARCH = "llama4_scout_17b_a16e"
OUT_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
AUX_RTOL = 1e-6
#: (moe_top_k, n_shared_experts): the published routing, and top-2 with 2
#: shared experts (deepseek-v2's shape of routing)
ROUTINGS = {"top1": (1, 1), "top2_shared2": (2, 2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _cfgs(routing: str):
    k, shared = ROUTINGS[routing]
    extra = dict(moe_top_k=k, n_shared_experts=shared, dtype="float32")
    return (dataclasses.replace(ref_reduced(ARCH), **extra),
            dataclasses.replace(PC.get_reduced(ARCH), **extra))


def _weights(cfg_ref, router=None):
    """The reference's ``moe_init`` (numpy leaves), ``router`` replacing
    its router."""
    p = jax.tree.map(np.asarray, RMoE.moe_init(cfg_ref,
                                               jax.random.PRNGKey(0)))
    if router is not None:
        p["router"] = np.asarray(router, np.float32)
    return p


def _port_tree(p, dtype: str) -> dict:
    """The weights carried across by ``convert`` onto the CPU."""
    return {key: (_port_tree(v, dtype) if isinstance(v, dict) else
                  convert.array(v, device="cpu").to(TDT[dtype]))
            for key, v in p.items()}


def _run(cfg_ref, cfg, p, x: np.ndarray, dtype: str):
    """(reference out, reference aux, port out, port aux), numpy fp32."""
    pj = jax.tree.map(lambda a: jnp.asarray(a, JDT[dtype]), p)
    want, aux_ref = RMoE._moe_reference(cfg_ref, pj,
                                        jnp.asarray(x, JDT[dtype]))
    tree = _port_tree(p, dtype)
    got, aux = PMoE.moe_forward(cfg, tree,
                                torch.from_numpy(x).to(TDT[dtype]))
    assert got.dtype == TDT[dtype] and aux.dtype == torch.float32
    return (np.asarray(want, np.float32), float(aux_ref),
            got.float().numpy(), float(aux))


def _check(cfg_ref, cfg, p, x, dtype: str = "float32") -> None:
    want, aux_ref, got, aux = _run(cfg_ref, cfg, p, x, dtype)
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=OUT_TOL[dtype] * np.abs(want).max())
    assert abs(aux - aux_ref) <= AUX_RTOL * abs(aux_ref)


def _x(shape=(4, 32, 64)) -> np.ndarray:
    return np.random.default_rng(0).standard_normal(shape).astype(np.float32)


def _drops(cfg, p, x: np.ndarray) -> int:
    """Assignments past their expert's capacity in the port's routing."""
    xf = torch.from_numpy(x.reshape(-1, x.shape[-1]))
    _, _, experts = PMoE.route(cfg, torch.from_numpy(p["router"]), xf)
    counts = torch.bincount(experts.reshape(-1), minlength=cfg.n_experts)
    return int((counts - PMoE.capacity(cfg, xf.shape[0])).clamp(min=0)
               .sum())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("routing", list(ROUTINGS))
def test_moe_matches_the_reference(routing, dtype):
    cfg_ref, cfg = _cfgs(routing)
    p = _weights(cfg_ref)
    assert ("shared" in p) and p["shared"]["wi_gate"].shape == (
        cfg.d_model, cfg.expert_ff * cfg.n_shared_experts)
    _check(cfg_ref, cfg, p, _x(), dtype)


def test_capacity_is_the_references():
    for e, k in ((4, 1), (16, 1), (160, 6), (4, 2)):
        cfg_ref = dataclasses.replace(ref_reduced(ARCH), n_experts=e,
                                      moe_top_k=k)
        cfg = dataclasses.replace(PC.get_reduced(ARCH), n_experts=e,
                                  moe_top_k=k)
        for t in (1, 4, 7, 64, 128, 2048, 4096):
            assert PMoE.capacity(cfg, t) == RMoE._capacity(cfg_ref, t)
    published = PC.get_config(ARCH)
    assert PMoE.capacity(published, 4) == 8          # a decode step, B=4
    assert PMoE.capacity(published, 4 * 512) == 160  # the card's prefill


@pytest.mark.parametrize("routing", list(ROUTINGS))
def test_ties_go_to_the_lower_index(routing):
    """Experts 1 and 3 have equal router columns: every token ranks them
    equal, and both packages put expert 1 first."""
    cfg_ref, cfg = _cfgs(routing)
    rng = np.random.default_rng(3)
    router = rng.integers(-2, 3, (cfg.d_model, cfg.n_experts)) / 8.0
    router[:, 3] = router[:, 1]
    p = _weights(cfg_ref, router)
    x = (rng.integers(-8, 9, (4, 32, cfg.d_model)) / 8.0).astype(np.float32)
    xf = torch.from_numpy(x.reshape(-1, cfg.d_model))
    probs, _, experts = PMoE.route(cfg, torch.from_numpy(p["router"]), xf)
    assert torch.equal(probs[:, 1], probs[:, 3])
    _, ref_idx = jax.lax.top_k(jax.nn.softmax(
        jnp.asarray(x.reshape(-1, cfg.d_model)) @ jnp.asarray(p["router"]),
        axis=-1), cfg.moe_top_k)
    np.testing.assert_array_equal(experts.numpy(), np.asarray(ref_idx))
    # each token's first choice is the lowest index of its largest
    # probability; where 1 and 3 share it, 3 is never first
    top = probs == probs.max(dim=-1, keepdim=True).values
    assert torch.equal(experts[:, 0], top.int().argmax(dim=-1))
    tied_top = (top[:, 1] & top[:, 3]).numpy()
    assert tied_top.sum() > 0
    assert (experts.numpy()[tied_top, 0] != 3).all()
    _check(cfg_ref, cfg, p, x)


@pytest.mark.parametrize("routing", list(ROUTINGS))
def test_overflow_drops_assignments_and_matches(routing):
    """Feature 0 is 1 on every token and the router weights it 3.0 toward
    expert 0: most tokens choose expert 0, far past its capacity (40
    slots for 128 tokens at top-1); the dropped assignments add nothing,
    the shared expert still applies, and both packages agree."""
    cfg_ref, cfg = _cfgs(routing)
    rng = np.random.default_rng(5)
    router = rng.standard_normal((cfg.d_model, cfg.n_experts)) * 0.1
    router[0, 0] = 3.0
    p = _weights(cfg_ref, router)
    x = _x()
    x[..., 0] = 1.0
    assert _drops(cfg, p, x) > 0
    _check(cfg_ref, cfg, p, x)


@pytest.mark.parametrize("routing", list(ROUTINGS))
def test_decode_size_call_matches(routing):
    """A decode step's MoE: t = B = 4 tokens, capacity 8."""
    cfg_ref, cfg = _cfgs(routing)
    assert PMoE.capacity(cfg, 4) == 8
    _check(cfg_ref, cfg, _weights(cfg_ref), _x((4, 1, 64)))


@pytest.mark.parametrize("overflow", [False, True])
@pytest.mark.parametrize("routing", list(ROUTINGS))
def test_masked_dense_evaluation_equals_the_dispatch(routing, overflow):
    cfg_ref, cfg = _cfgs(routing)
    rng = np.random.default_rng(5)
    router = rng.standard_normal((cfg.d_model, cfg.n_experts)) * 0.1
    router[0, 0] = 3.0 if overflow else 0.0
    p = _weights(cfg_ref, router)
    x = _x()
    x[..., 0] = 1.0
    assert (_drops(cfg, p, x) > 0) == overflow
    tree = _port_tree(p, "float32")
    got, _ = PMoE.moe_forward(cfg, tree, torch.from_numpy(x))
    dense = PMoE.moe_masked_dense(cfg, tree, torch.from_numpy(x))
    torch.testing.assert_close(dense, got, rtol=0, atol=OUT_TOL["float32"]
                               * float(got.abs().max()))


def test_init_draws_the_references_scales():
    """``MoE.init``: the router and the shared expert ``d_in ** -0.5``,
    the stacks ``d ** -0.5`` and ``wo`` ``ff ** -0.5`` (truncated normal:
    std 0.88 of the scale), with the reference's shapes."""
    from repro_torch.models.moe import MoE
    cfg = PC.get_reduced(ARCH)
    moe = MoE(cfg, device="cpu")
    moe.init(torch.Generator().manual_seed(0))
    ref = RMoE.moe_init(ref_reduced(ARCH), jax.random.PRNGKey(0))
    d, ff = cfg.d_model, cfg.expert_ff
    scales = {"router": d, "wi_gate": d, "wi_up": d, "wo": ff,
              "shared.wi_gate": d, "shared.wi_up": d, "shared.wo": ff}
    for name, w in moe.named_parameters():
        node = ref
        for key in name.split("."):
            node = node[key]
        assert tuple(w.shape) == node.shape, name
        std = float(w.detach().std()) * scales[name] ** 0.5
        assert 0.8 < std < 0.95, (name, std)
        assert float(w.detach().abs().max()) <= 2 * scales[name] ** -0.5 + 1e-6
