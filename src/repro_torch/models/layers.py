"""Shared neural-net layers (the torch counterpart of
``repro.models.layers``): ``dense`` and the ReLU ``MLPHead`` the recsys
and GNN models use, and the LM layers: RMSNorm, RoPE, chunked causal
GQA attention with an optional sliding window, and the SwiGLU MLP; and
``remat``, the recompute-on-backward wrapper that the LM blocks, the
attention chunks and the GNN processor layers run through.

``repro``'s dense weight is ``(d_in, d_out)``, applied as ``x @ w``;
``nn.Linear`` stores ``(d_out, d_in)``.  The initialisation draws the
same distribution (normal times ``d_in ** -0.5``, zero bias) from an
explicit ``torch.Generator``; without one the layer is left for a
converter to fill (``repro_torch.models.convert``).

Conventions, as in ``repro``: the compute dtype is the input's (bf16 at
the published configs); norms, RoPE, attention scores and softmax run in
float32.  The attention is plain PyTorch: queries in chunks of
``chunk_q`` against the whole K/V, so the (S, S) score matrix is never
built for a long prompt; with ``remat_chunks`` a backward pass
recomputes each chunk's scores and probabilities instead of keeping
them.  ``constrain`` (``repro``'s sharding hint) sits where ``repro``
has it and changes no value: on a ``ModelMesh`` these layers run whole
on every rank; on DTensor parameters and activations (the dry run,
``repro_torch.launch``) DTensor's sharding propagation lays them out
(tensor-parallel over ``"heads"`` and ``"ff"``, FSDP over the data
axes), ``constrain`` reshards where ``repro`` hints, and a projection
whose block is not whole heads is gathered before its split
(:func:`split_heads`).
"""
from __future__ import annotations

import contextvars
import functools
from typing import Callable, Optional, Sequence, Union

import torch
import torch.utils.checkpoint
from torch import nn
from torch.distributed.tensor.experimental import local_map

from repro_torch.distributed.context import (
    constrain,
    grad_placements,
    is_dtensor,
    pinned,
    whole_units,
)


def dense(d_in: int, d_out: int, *, bias: bool = False,
          generator: Optional[torch.Generator] = None, device=None,
          dtype=torch.float32) -> nn.Linear:
    """``nn.Linear(d_in, d_out)``; with ``generator`` its weight is drawn
    as ``repro``'s ``dense_init`` draws it."""
    lin = nn.Linear(d_in, d_out, bias=bias, device=device, dtype=dtype)
    if generator is not None:
        with torch.no_grad():
            lin.weight.normal_(generator=generator).mul_(d_in ** -0.5)
            if bias:
                lin.bias.zero_()
    return lin


def linear(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``lin(x)``.  A DTensor ``x`` whose tokens are split over more than
    one leading dimension (batch x sequence, ``fsdp_ep``'s layout) is
    applied under ``local_map``: each rank multiplies its tokens by the
    gathered weight, as FSDP does (DTensor's own ``linear`` would flatten
    the two splits into one it cannot hold).  Any other DTensor runs
    DTensor's ``linear`` with its output :func:`pinned`, so its weight
    gradient meets the output's gradient in the output's layout."""
    if not is_dtensor(x):
        return lin(x)
    from torch.distributed.tensor import Replicate, Shard

    lead = {p.dim for p in x.placements
            if isinstance(p, Shard) and p.dim < x.dim() - 1}
    if len(lead) < 2:
        return pinned(lin(x))
    pl = [p if isinstance(p, Shard) and p.dim < x.dim() - 1 else Replicate()
          for p in x.placements]
    rep = [Replicate()] * x.device_mesh.ndim
    args = (x, lin.weight) + ((lin.bias,) if lin.bias is not None else ())
    n_w = len(args) - 1
    return local_map(torch.nn.functional.linear, out_placements=pl,
                     in_placements=(pl,) + (rep,) * n_w,
                     in_grad_placements=(pl,) + (grad_placements(rep, pl),)
                     * n_w, device_mesh=x.device_mesh,
                     redistribute_inputs=True)(*args)


class MLPHead(nn.Module):
    """Plain ReLU MLP tower over ``dims`` then a final projection to
    ``out_dim`` (``repro``'s ``mlp_head_init`` / ``mlp_head_apply``)."""

    def __init__(self, dims: Sequence[int], out_dim: int = 1, *,
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        dims = list(dims)
        kw = dict(bias=True, generator=generator, device=device, dtype=dtype)
        self.layers = nn.ModuleList(
            [dense(a, b, **kw) for a, b in zip(dims[:-1], dims[1:])]
            + [dense(dims[-1], out_dim, **kw)]
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers[:-1]:
            x = torch.relu(layer(x))
        return self.layers[-1](x)


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------


def remat(fn: Callable, *args):
    """``fn(*args)``, its activations recomputed in the backward pass
    instead of kept (``repro``'s ``jax.checkpoint``): under
    ``torch.utils.checkpoint`` when gradients are being recorded, a plain
    call otherwise (``no_grad``, ``inference_mode``).

    Non-reentrant, so ``torch.autograd.grad`` (``launch.train``) reaches
    through it and the forward runs once.  Nothing inside draws random
    numbers, so no RNG state is stashed.  The recompute runs in the
    forward's ``contextvars`` context (the installed axis rules and
    mesh): the autograd engine may run it on a thread of its own."""
    if not torch.is_grad_enabled():
        return fn(*args)
    run = functools.partial(contextvars.copy_context().run, fn)
    return torch.utils.checkpoint.checkpoint(
        run, *args, use_reentrant=False, preserve_rng_state=False)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


class RMSNorm(nn.Module):
    """``repro``'s ``rmsnorm_init``: a ``scale`` of ones."""

    def __init__(self, d: int, *, device=None, dtype=torch.float32):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, device=device, dtype=dtype))


def rmsnorm(p: RMSNorm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """float32 mean of squares, ``rsqrt(var + eps)``, times the scale,
    cast back to ``x``'s dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p.scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    """(d_head // 2,) float32 inverse frequencies."""
    half = d_head // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (..., S, H, d_head), positions (..., S) -> rotated x: the halves
    ``[x1 cos - x2 sin, x1 sin + x2 cos]`` (not interleaved), in
    float32, cast back to ``x``'s dtype."""
    d_head = x.shape[-1]
    half = d_head // 2
    freqs = rope_freqs(d_head, theta, x.device)
    ang = positions[..., :, None].float() * freqs  # (..., S, half)
    cos = torch.cos(ang)[..., :, None, :]  # (..., S, 1, half)
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA, causal, optional sliding window), queries in chunks
# ---------------------------------------------------------------------------


def split_heads(x: torch.Tensor, n: int, d: int) -> torch.Tensor:
    """(..., n * d) -> (..., n, d); a DTensor whose block of the last
    dimension is not whole heads has that dimension gathered first."""
    x = whole_units(x, -1, d, f"{n} heads of {d}")
    return x.reshape(*x.shape[:-1], n, d)


def merge_heads(o: torch.Tensor) -> torch.Tensor:
    """(..., n, d) -> (..., n * d), :func:`pinned`: on a DTensor the
    gradient comes back in the merged tensor's own layout, so its split
    into heads on the way back never splits a head the forward kept
    whole (a row-parallel projection hands back a gradient split over
    the width, 20 or 56 heads over 16 ranks)."""
    return pinned(o.reshape(*o.shape[:-2], o.shape[-2] * o.shape[-1]))


def group_heads(q: torch.Tensor, kv: int) -> torch.Tensor:
    """q (..., H, dh) -> (..., KV, H // KV, dh), a DTensor's block of H
    first made whole groups."""
    H = q.shape[-2]
    q = whole_units(q, -2, H // kv, f"{H} query heads in {kv} groups")
    return q.reshape(*q.shape[:-2], kv, H // kv, q.shape[-1])


class Attention(nn.Module):
    """``repro``'s ``attention_init``: ``wq``, ``wk``, ``wv`` (biased with
    ``qkv_bias``) and ``wo``."""

    def __init__(self, d_model: int, n_heads: int, n_kv_heads: int,
                 d_head: int, *, qkv_bias: bool = False,
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.wq = dense(d_model, n_heads * d_head, bias=qkv_bias, **kw)
        self.wk = dense(d_model, n_kv_heads * d_head, bias=qkv_bias, **kw)
        self.wv = dense(d_model, n_kv_heads * d_head, bias=qkv_bias, **kw)
        self.wo = dense(n_heads * d_head, d_model, **kw)


def _init_device(generator: Optional[torch.Generator], device):
    """Where an ``*_init`` builds: ``device``, else the generator's."""
    if device is None and generator is not None:
        return generator.device
    return device


def attention_init(generator: Optional[torch.Generator], d_model: int,
                   n_heads: int, n_kv_heads: int, d_head: int, dtype,
                   qkv_bias: bool = False, device=None) -> Attention:
    return Attention(d_model, n_heads, n_kv_heads, d_head, qkv_bias=qkv_bias,
                     generator=generator,
                     device=_init_device(generator, device), dtype=dtype)


def _chunk_attn(q, k, v, q_pos, kv_pos, window: Optional[int]):
    """One query chunk against the whole K/V.

    q (B, Sq, KV, G, dh); k, v (B, Skv, KV, dh); positions int.  Scores
    in float32, masked scores at -1e30, normalised by ``max(l, 1e-30)``.
    Returns (B, Sq, KV, G, dh) float32."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqkgd,btkd->bkgqt", q.float(), k.float()) * scale
    mask = kv_pos[None, :] <= q_pos[:, None]  # causal (Sq, Skv)
    if window is not None:
        mask &= (q_pos[:, None] - kv_pos[None, :]) < window
    s = s.masked_fill(~mask[None, None, None], -1e30)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)  # noqa: E741
    return torch.einsum("bkgqt,btkd->bqkgd", p / torch.clamp_min(l, 1e-30),
                        v.float())


def attention_blocks(q, n_kv: int, heads: bool = True) -> list:
    """The placements attention runs on for a DTensor ``q (B, S, H, dh)``
    with ``n_kv`` K/V heads: each mesh axis that splits q's batch keeps
    splitting it; one that splits its heads keeps splitting them (and
    K/V's) while the K/V heads still divide (so a rank's query heads are
    whole groups of its K/V heads); anything else is gathered.  With
    ``heads=False`` only the batch stays split."""
    from torch.distributed.tensor import Replicate, Shard

    out, n = [], 1
    for i, p in enumerate(q.placements):
        size = q.device_mesh.shape[i]
        if p == Shard(0):
            out.append(p)
        elif heads and p == Shard(2) and n_kv % (n * size) == 0:
            n *= size
            out.append(p)
        else:
            out.append(Replicate())
    return out


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: Optional[int] = None,
                  q_offset: Union[int, torch.Tensor] = 0,
                  chunk_q: int = 512,
                  remat_chunks: bool = False) -> torch.Tensor:
    """Causal GQA attention, in chunks of ``chunk_q`` queries.

    q (B, Sq, H, dh); k, v (B, Skv, KV, dh).  ``q_offset`` is the
    absolute position of q[0] (prefill continuation, decode).  A ragged
    last chunk is padded and its padding sliced off.  ``remat_chunks``:
    where there are several chunks, each runs through ``remat``, so a
    backward pass keeps no chunk's float32 scores and probabilities (it
    recomputes them one chunk at a time), as ``repro`` checkpoints its
    scan body.  Returns (B, Sq, H, dh) in q's dtype.

    On DTensors it runs under ``local_map`` on each rank's block of the
    batch and of the heads (:func:`attention_blocks`)."""
    if is_dtensor(q):
        pl = attention_blocks(q, k.shape[2])
        fn = functools.partial(gqa_attention, window=window,
                               q_offset=q_offset, chunk_q=chunk_q,
                               remat_chunks=remat_chunks)
        return local_map(fn, out_placements=pl, in_placements=(pl, pl, pl),
                         device_mesh=q.device_mesh,
                         redistribute_inputs=True)(q, k, v)
    B, Sq, H, dh = q.shape
    KV = k.shape[2]
    qg = group_heads(q, KV)
    kv_pos = torch.arange(k.shape[1], dtype=torch.int64, device=q.device)

    if Sq <= chunk_q:
        q_pos = q_offset + torch.arange(Sq, dtype=torch.int64,
                                        device=q.device)
        o = _chunk_attn(qg, k, v, q_pos, kv_pos, window)
        return o.reshape(B, Sq, H, dh).to(q.dtype)

    pad = (-Sq) % chunk_q
    if pad:  # ragged tail: pad queries (outputs sliced off below)
        qg = torch.nn.functional.pad(qg, (0, 0, 0, 0, 0, 0, 0, pad))
    one = (functools.partial(remat, _chunk_attn) if remat_chunks
           else _chunk_attn)
    outs = []
    for i in range((Sq + pad) // chunk_q):
        q_pos = q_offset + i * chunk_q + torch.arange(
            chunk_q, dtype=torch.int64, device=q.device)
        outs.append(one(qg[:, i * chunk_q:(i + 1) * chunk_q], k, v, q_pos,
                        kv_pos, window))
    o = torch.cat(outs, dim=1).reshape(B, Sq + pad, H, dh)[:, :Sq]
    return o.to(q.dtype)


def attention_apply(p: Attention, x: torch.Tensor, *, n_heads: int,
                    n_kv_heads: int, d_head: int, rope_theta: float,
                    window: Optional[int] = None,
                    chunk_q: int = 512) -> torch.Tensor:
    """Self-attention over x (B, S, d_model) with RoPE; returns (B, S, d)."""
    B, S, _ = x.shape
    q = split_heads(linear(p.wq, x), n_heads, d_head)
    k = split_heads(linear(p.wk, x), n_kv_heads, d_head)
    v = split_heads(linear(p.wv, x), n_kv_heads, d_head)
    pos = torch.arange(S, dtype=torch.int64, device=x.device)
    q = apply_rope(q, pos, rope_theta)
    k = apply_rope(k, pos, rope_theta)
    q = constrain(q, "batch", None, "heads", None)
    k = constrain(k, "batch", None, "heads", None)
    o = gqa_attention(q, k, v, window=window, chunk_q=chunk_q)
    return linear(p.wo, merge_heads(o))


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    """``repro``'s ``mlp_init``: ``wi``, ``wg`` (d_model -> d_ff) and ``wo``
    (d_ff -> d_model), no biases."""

    def __init__(self, d_model: int, d_ff: int, *,
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.wi = dense(d_model, d_ff, **kw)
        self.wg = dense(d_model, d_ff, **kw)
        self.wo = dense(d_ff, d_model, **kw)


def mlp_init(generator: Optional[torch.Generator], d_model: int, d_ff: int,
             dtype, device=None) -> MLP:
    return MLP(d_model, d_ff, generator=generator,
               device=_init_device(generator, device), dtype=dtype)


def mlp_apply(p: MLP, x: torch.Tensor) -> torch.Tensor:
    """``wo(silu(wg x) * wi x)``."""
    h = torch.nn.functional.silu(linear(p.wg, x)) * linear(p.wi, x)
    return linear(p.wo, constrain(h, "batch", None, "ff"))
