"""Chunked large-vocab softmax cross-entropy — the counterpart of
`deeplearning4j_tpu/ops/chunked_xent.py`.

The LM-head loss ``xent(h @ W + b, y)`` would hold (N, V) logits twice
(forward and cotangent).  This op streams the vocab in chunks with an
online-softmax accumulator, so the extra memory is O(N x chunk), and its
backward recomputes each chunk's logits instead of storing them.

The JAX package runs this as two ``lax.scan`` loops outside any Pallas
kernel; here they are Python loops over ``torch.matmul`` of f32 operands
(``h32 @ Wc``, as there).  A vocab the chunk does not divide is padded
with zero columns whose bias is -1e30, so they add exactly 0 to the
softmax.

Under the model axis the head's ``W`` / ``b`` are split by vocabulary
and the loss is vocabulary-parallel: each rank streams its shard
(padded on its own), the row max and the sum of exponentials are
reduced over the model group, the label's logit comes from the rank
whose shard holds it, and in the backward ``dh`` is all-reduced while
``dW`` / ``db`` stay the rank's.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from deeplearning4j_tpu_torch.parallel import context as dp_context

_NEG = -1e30


def _pad_vocab(W, b, chunk):
    pad = (-W.shape[1]) % chunk
    if pad:
        W = F.pad(W, (0, pad))
        b = F.pad(b, (0, pad), value=_NEG)       # exp(-1e30) == 0
    return W, b


class _ChunkedSoftmaxXent(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h, W, b, labels, weights, chunk, group=None):
        h32 = h.float()
        Wp, bp = _pad_vocab(W.float(), b.float(), chunk)
        n = h32.shape[0]
        labels = labels.long()
        if group is not None:
            # ids of this rank's vocabulary shard count from its start;
            # any other id is -1, so it matches no column, not even one
            # of the shard's padding
            labels = labels - dist.get_rank(group) * W.shape[1]
            labels = torch.where((labels >= 0) & (labels < W.shape[1]), labels, -1)
        m = torch.full((n,), _NEG, dtype=torch.float32, device=h.device)
        s = torch.zeros((n,), dtype=torch.float32, device=h.device)
        ly = torch.zeros((n,), dtype=torch.float32, device=h.device)
        for c in range(0, Wp.shape[1], chunk):
            logits = h32 @ Wp[:, c:c + chunk] + bp[c:c + chunk]   # (N, chunk)
            m_new = torch.maximum(m, logits.max(dim=-1).values)
            s = s * torch.exp(m - m_new) + torch.exp(
                logits - m_new[:, None]).sum(dim=-1)
            m = m_new
            idx = labels - c
            in_c = (idx >= 0) & (idx < chunk)
            picked = logits.gather(1, idx.clamp(0, chunk - 1)[:, None])[:, 0]
            ly = ly + torch.where(in_c, picked, 0.0)
        if group is not None:
            mg = m.clone()
            dist.all_reduce(mg, op=dist.ReduceOp.MAX, group=group)
            s = s * torch.exp(m - mg)
            m = mg
            dist.all_reduce(s, group=group)
            dist.all_reduce(ly, group=group)
        w = weights.float()
        # under data parallelism the count of the whole global batch
        wsum = torch.clamp(dp_context.global_count(w.sum()), min=1.0)
        logz = m + torch.log(s)
        ctx.save_for_backward(h, W, b, labels, logz, w, wsum)
        ctx.chunk, ctx.group = chunk, group
        return (w * (logz - ly)).sum() / wsum

    @staticmethod
    def backward(ctx, g):
        h, W, b, labels, logz, w, wsum = ctx.saved_tensors
        chunk = ctx.chunk
        h32 = h.float()
        Wp, bp = _pad_vocab(W.float(), b.float(), chunk)
        v = W.shape[1]
        scale = (g * w / wsum)[:, None]
        dh = torch.zeros_like(h32)
        dW = torch.empty_like(Wp)
        db = torch.empty_like(bp)
        cols = torch.arange(chunk, device=h.device)
        for c in range(0, Wp.shape[1], chunk):
            Wc = Wp[:, c:c + chunk]
            p = torch.exp(h32 @ Wc + bp[c:c + chunk] - logz[:, None])
            onehot = ((labels - c)[:, None] == cols[None, :]).float()
            d = (p - onehot) * scale                              # (N, chunk)
            dh += d @ Wc.T
            dW[:, c:c + chunk] = h32.T @ d
            db[c:c + chunk] = d.sum(dim=0)
        if ctx.group is not None:
            dist.all_reduce(dh, group=ctx.group)     # every shard's share
        return (dh.to(h.dtype), dW[:, :v].to(W.dtype), db[:v].to(b.dtype),
                None, None, None, None)


def chunked_softmax_xent(h, W, b, labels, weights, chunk: int = 8192,
                         vocab_axis: str | None = None):
    """Weighted mean token cross-entropy of softmax(h @ W + b).

    h: (N, D) f32 or bf16 hidden states; W: (D, V); b: (V,); labels: (N,)
    int class ids; weights: (N,) per-token weights (ones for a plain mean,
    zeros mask tokens out).  Returns the scalar weighted-mean loss,
    differentiable in h, W and b.  ``vocab_axis``: the mesh axis whose
    ranks hold consecutive vocabulary shards of ``W`` / ``b`` (rank r
    the columns from r * V_shard), h and the labels whole on each."""
    from deeplearning4j_tpu_torch.parallel import collectives

    group = collectives.group_of(vocab_axis) if vocab_axis else None
    return _ChunkedSoftmaxXent.apply(h, W, b, labels, weights, int(chunk), group)
