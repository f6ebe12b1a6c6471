"""Plain-torch oracles for the ported kernels (ground truth for tests)."""
from __future__ import annotations

import torch


def gram_ref(x: torch.Tensor) -> torch.Tensor:
    """x (..., n, d) -> x^T x (..., d, d) in fp32."""
    x32 = x.to(torch.float32)
    return x32.mT @ x32


def fastmix_ref(S: torch.Tensor, L: torch.Tensor, eta: float,
                K: int) -> torch.Tensor:
    """Per-round FastMix recursion in fp32 (oracle for the fused kernel)."""
    prev = cur = S.to(torch.float32)
    L = L.to(device=S.device, dtype=torch.float32)
    for _ in range(K):
        mixed = torch.einsum("ij,j...->i...", L, cur)
        prev, cur = cur, (1.0 + eta) * mixed - eta * prev
    return cur


def power_matmul_ref(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(d, d) @ (d, k) in fp32."""
    return a.to(torch.float32) @ w.to(torch.float32)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """Per-head exact softmax attention. q (Sq, hd), k/v (Skv, hd).

    As the reference's oracle, the causal mask is aligned bottom-right
    (``tril(k=Skv-Sq)``); the flash kernel aligns it top-left, so the two
    agree only when Sq == Skv."""
    sq, hd = q.shape
    skv = k.shape[0]
    s = (q.to(torch.float32) @ k.to(torch.float32).T) / torch.sqrt(
        torch.tensor(hd, dtype=torch.float32, device=q.device))
    if causal:
        mask = torch.ones(sq, skv, dtype=torch.bool,
                          device=q.device).tril(diagonal=skv - sq)
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return (p @ v.to(torch.float32)).to(q.dtype)


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool = True) -> torch.Tensor:
    """Batched multi-head oracle. q (B, H, S, hd), k/v (B, Hkv, S, hd);
    kv head ``h // (H // Hkv)`` serves query head h."""
    b, h = q.shape[:2]
    rep = h // k.shape[1]
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    return torch.stack([torch.stack([
        attention_ref(q[i, j], k[i, j], v[i, j], causal=causal)
        for j in range(h)]) for i in range(b)])
