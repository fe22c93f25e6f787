"""Plain PyTorch versions of the port's attention-family kernels -- flash
attention, paged decode attention, the RWKV-6 WKV recurrence (the
correctness ground truth on the card, and what a CPU tensor runs).

Each ``*_ref`` is a direct, unoptimized statement of the math, the same as the
reference's ``repro/kernels/ref.py``.
"""
from __future__ import annotations

import math

import torch

__all__ = ["flash_attention_ref", "paged_decode_attention_ref", "wkv6_ref",
           "wkv6_chunked_ref"]


def flash_attention_ref(
    q: torch.Tensor,             # (B, S, Hq, D)
    k: torch.Tensor,             # (B, S, Hkv, D)
    v: torch.Tensor,
    causal: bool = True,
    sliding_window: int | None = None,
) -> torch.Tensor:
    """Whole-sequence grouped-query attention; forms the S x S scores."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    rep = Hq // Hkv
    kk = torch.repeat_interleave(k, rep, dim=2)
    vv = torch.repeat_interleave(v, rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk.float()) / math.sqrt(D)
    pos = torch.arange(S, device=q.device)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos[:, None] >= pos[None, :]
    if sliding_window is not None:
        mask &= pos[:, None] - pos[None, :] < sliding_window
    s = torch.where(mask[None, None], s, -math.inf)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vv.float())
    return out.to(q.dtype)


def paged_decode_attention_ref(
    q: torch.Tensor,             # (B, Hq, D) -- one new token per sequence
    k_pages: torch.Tensor,       # (P, page, Hkv, D) page store ("slow tier")
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # (B, pages_per_seq) int32
    lengths: torch.Tensor,       # (B,) valid tokens per sequence
) -> torch.Tensor:
    B, Hq, D = q.shape
    page = k_pages.shape[1]
    Hkv = k_pages.shape[2]
    rep = Hq // Hkv
    ppseq = block_tables.shape[1]
    # a page id is taken as the reference's gather takes an index: a
    # negative id wraps once, then the id is clamped into the store
    n_pages = k_pages.shape[0]
    bt = block_tables.long()
    bt = torch.where(bt < 0, bt + n_pages, bt).clamp(0, n_pages - 1)
    # gather each sequence's pages into a contiguous (B, ppseq*page, Hkv, D)
    k_seq = k_pages[bt].reshape(B, ppseq * page, Hkv, D)
    v_seq = v_pages[bt].reshape(B, ppseq * page, Hkv, D)
    kk = torch.repeat_interleave(k_seq, rep, dim=2)
    vv = torch.repeat_interleave(v_seq, rep, dim=2)
    s = torch.einsum("bhd,bkhd->bhk", q.float(), kk.float()) / math.sqrt(D)
    pos = torch.arange(ppseq * page, device=q.device)
    valid = pos[None, :] < lengths.to(q.device)[:, None]
    s = torch.where(valid[:, None, :], s, -math.inf)
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)
    out = torch.einsum("bhk,bkhd->bhd", p, vv.float())
    return out.to(q.dtype)


def wkv6_ref(
    r: torch.Tensor,             # (B, S, H, D)
    k: torch.Tensor,
    v: torch.Tensor,
    log_w: torch.Tensor,         # (B, S, H, D), <= 0
    u: torch.Tensor,             # (H, D)
) -> torch.Tensor:
    """Sequential WKV recurrence (fp32):
    out_t = r_t . (S_{t-1} + (u*k_t) v_t^T);  S_t = diag(w_t) S_{t-1} + k_t v_t^T
    """
    B, S, H, D = r.shape
    rf, kf, vf = (x.float() for x in (r, k, v))
    wf = torch.exp(log_w.float())
    uf = u.float()
    state = torch.zeros((B, H, D, D), dtype=torch.float32, device=r.device)
    outs = []
    for t in range(S):
        kv = torch.einsum("bhd,bhe->bhde", kf[:, t], vf[:, t])
        outs.append(torch.einsum("bhd,bhde->bhe", rf[:, t],
                                 state + uf[None, :, :, None] * kv))
        state = state * wf[:, t, :, :, None] + kv
    if not outs:
        return torch.empty_like(r)
    return torch.stack(outs, dim=1).to(r.dtype)


def wkv6_chunked_ref(r, k, v, log_w, u, chunk: int = 32,
                     quarter: int = 8) -> torch.Tensor:
    """The chunk arithmetic of ``wkv6``'s ``chunk_tc_bf16`` kernel instance,
    in float32, for the tests.  Chunks of ``chunk`` steps (a ragged last one
    zero-padded); quarters of ``quarter`` steps inside, where the decays are
    products of ``w = exp(log_w)`` that restart at every quarter (r scaled
    from its quarter's start, k to its end).  The intra-chunk scores: the
    second subchunk of ``chunk / 2`` steps against the first as one product
    about their boundary, each quarter against the one before it in its
    subchunk as a product about theirs, the diagonal quarter blocks element
    by element with the decay carried as a running product along t, and
    ``r_t . (u o k_t)`` on the diagonal.  Returns ``(B, S, H, D)`` in float32
    (the kernel then rounds to r's dtype)."""
    B, S, H, D = r.shape
    C, Q = chunk, quarter
    nq, half = C // Q, C // 2
    nc = -(-S // C)
    pad = nc * C - S

    def chunks(x):
        x = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad))
        return x.reshape(B, nc, C, H, D).permute(1, 0, 3, 2, 4)  # c,B,H,C,D

    rc, kc, vc, lwc = (chunks(x) for x in (r, k, v, log_w))
    uf = u.float()[None, :, None, :]                         # 1,H,1,D
    state = torch.zeros(B, H, D, D, dtype=torch.float32, device=r.device)
    ys = []
    for c in range(nc):
        rq = rc[c].reshape(B, H, nq, Q, D)
        kq = kc[c].reshape(B, H, nq, Q, D)
        lq = lwc[c].reshape(B, H, nq, Q, D)
        w = torch.exp(lq)
        tot = torch.exp(lq.sum(3))                           # B,H,nq,D
        one = torch.ones_like(w[:, :, :, :1])
        fwd = torch.cat([one, torch.cumprod(w, 3)[:, :, :, :-1]], 3)
        bwd = torch.cat([torch.flip(torch.cumprod(torch.flip(
            w[:, :, :, 1:], (3,)), 3), (3,)), one], 3)
        rq, kq = rq * fwd, kq * bwd      # r from its quarter's start, k to its end
        ones = torch.ones_like(tot[:, :, :1])
        pre = torch.cumprod(torch.cat([ones, tot[:, :, :-1]], 2), 2)
        post = torch.flip(torch.cumprod(torch.cat(
            [ones, torch.flip(tot, (2,))[:, :, :-1]], 2), 2), (2,))
        r_hat = (rq * pre[:, :, :, None]).reshape(B, H, C, D)
        k_hat = (kq * post[:, :, :, None]).reshape(B, H, C, D)
        a = torch.zeros(B, H, C, C, dtype=torch.float32, device=r.device)
        # the second subchunk against the first, about step chunk/2
        q1 = nq // 2
        r_sub = (rq[:, :, q1:] * torch.cumprod(torch.cat(
            [ones, tot[:, :, q1:-1]], 2), 2)[:, :, :, None]).reshape(
                B, H, half, D)
        k_sub = (kq[:, :, :q1] * torch.flip(torch.cumprod(torch.cat(
            [ones, torch.flip(tot[:, :, 1:q1], (2,))], 2), 2),
            (2,))[:, :, :, None]).reshape(B, H, half, D)
        a[:, :, half:, :half] = r_sub @ k_sub.transpose(-1, -2)
        # inside each subchunk: each quarter against the one before it
        for x in range(nq):
            if x % q1:
                a[:, :, x * Q:(x + 1) * Q, (x - 1) * Q:x * Q] = (
                    rq[:, :, x] @ kq[:, :, x - 1].transpose(-1, -2))
        # the diagonal quarter blocks, element by element
        rr, kk = rc[c].reshape(B, H, nq, Q, D), kc[c].reshape(B, H, nq, Q, D)
        bonus = (rr * uf[:, :, None] * kk).sum(-1)           # B,H,nq,Q
        p = kk.clone()                                       # k_s o prod w
        s_idx = torch.arange(Q, device=r.device)
        diag = torch.diag_embed(bonus)                       # B,H,nq,Q,Q
        for t in range(1, Q):
            at = (rr[:, :, :, t, None, :] * p).sum(-1)       # B,H,nq,Q(s)
            live = s_idx < t
            diag[:, :, :, t, :] = torch.where(live, at, diag[:, :, :, t, :])
            p = torch.where(live[:, None], p * w[:, :, :, t, None, :], p)
        for x in range(nq):
            a[:, :, x * Q:(x + 1) * Q, x * Q:(x + 1) * Q] = diag[:, :, x]
        ys.append(r_hat @ state + a @ vc[c])
        dec = tot.prod(2)                                    # B,H,D
        state = state * dec[..., None] + k_hat.transpose(-1, -2) @ vc[c]
    y = torch.stack(ys, 0).permute(1, 0, 3, 2, 4).reshape(B, nc * C, H, D)
    return y[:, :S]
