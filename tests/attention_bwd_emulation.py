"""The tensor-core attention backward (``paddle_tpu_torch/csrc/
attention_bwd.cu``) emulated on the CPU, shared by the
``tests/test_torch_attention_bwd*.py`` files.

The single pass (modes 2 and 3) is the key-major walk: a block per K
tile, the Q tiles that see it, each split into two 32-query halves with
their own dK/dV partial sums; S^T = K Q^T and dP^T = V dO^T with P^T and
dS^T as A operands; the per-K-tile dQ shares dS K summed in tile order.
The folded statistics launch walks the K tiles of each Q tile in two
32-key halves with their own online softmax. The dK/dV pass (mode 1) is
the key-major walk without the dQ share (16 keys x one 32-query half a
warp), the dQ pass (mode 0) the query-major walk of the forward (16
queries x one 32-key half of every K tile a warp, the two halves'
partial sums added first then second). Every product is
``tf32_emulation.tc_matmul`` (3xTF32, or one TF32 pass).

The products of every tile or patch are independent of each other, so
each emulation computes them as batched matmuls over all tiles at once
(S and dP over the whole score matrix, the patches' dV, dK and dQ terms
over a tile axis). What it keeps in the kernel's order is the
accumulation: each partial sum adds its tiles' terms one tile at a time
in the walk's order, and the partial sums meet in the kernel's order. A
tile the walk skips (past Sq or Sk, or wholly above the diagonal) adds
exact zeros here: its P and dS are 0.
"""

import math

import torch
import torch.nn.functional as F

from paddle_tpu_torch.ops.kernels import attention as tat
from tf32_emulation import tc_matmul

KT = tat.KERNEL_TILE  # keys of a K tile and queries of a Q tile
HALF = KT // 2        # queries of a Q tile each warp takes
GROUP = 16            # rows of a warp's patch: keys (dK/dV), queries (dQ)
_NEG = -1e30


def walk(sq, sk, causal):
    """(K tile, Q tile) pairs in the single pass's order: one block per K
    tile (tile 0, the longest walk when causal, first), each walking the
    Q tiles from its first key on (causal) or from 0."""
    for kt in range(-(-sk // KT)):
        for qt in range(kt if causal else 0, -(-sq // KT)):
            yield kt, qt


def stats_walk(sq, sk, causal):
    """(Q tile, K tile) pairs of the folded statistics launch: one block
    per Q tile (the last, the longest walk when causal, first), each
    walking the K tiles up to its last row (causal) or all of them."""
    for qt in reversed(range(-(-sq // KT))) if causal else \
            range(-(-sq // KT)):
        k_end = min(sk, qt * KT + KT) if causal else sk
        for kt in range(-(-k_end // KT)):
            yield qt, kt


def visible(sq, sk, causal):
    """The (K tile, Q tile) pairs holding a visible (query, key) pair."""
    return {(j // KT, i // KT) for i in range(sq) for j in range(sk)
            if not causal or j <= i}


def dkv_patches(sq, sk, causal):
    """(K tile, Q tile, key group, query half) of the dK/dV pass in its
    order: the single pass's walk (``walk``), each pair split among 8
    warps, 16 keys x 32 queries each; a warp skips a patch past Sk or Sq,
    or whose every query is above every key (causal)."""
    for kt, qt in walk(sq, sk, causal):
        for rg in range(KT // GROUP):
            for qh in range(2):
                kw, qw = kt * KT + GROUP * rg, qt * KT + HALF * qh
                if kw < sk and qw < sq and not (causal and qw + HALF - 1 < kw):
                    yield kt, qt, rg, qh


def dq_patches(sq, sk, causal):
    """(Q tile, K tile, row group, key half) of the dQ pass in its order:
    the query-major walk (``stats_walk``: the longest Q tiles first, K
    tiles wholly above the diagonal never loaded), each pair split among
    8 warps, 16 queries x 32 keys each; a warp skips a half tile past Sk
    or wholly above its rows (causal)."""
    for qt, kt in stats_walk(sq, sk, causal):
        for rg in range(KT // GROUP):
            for kh in range(2):
                w0, k0 = qt * KT + GROUP * rg, kt * KT + HALF * kh
                if not ((causal and k0 > w0 + GROUP - 1) or k0 >= sk):
                    yield qt, kt, rg, kh


def patch_pairs(rows, cols, sq, sk, causal):
    """The visible (query, key) pairs of a patch."""
    return {(i, j) for i in range(*rows) for j in range(*cols)
            if i < sq and j < sk and (not causal or j <= i)}


def bhsd(*ts):
    return [t.to(torch.float32).permute(0, 2, 1, 3) for t in ts]


def _pad(x, dim, size):
    """``x`` zero-padded along ``dim`` to ``size``."""
    extra = size - x.shape[dim]
    if extra == 0:
        return x
    pads = [0, 0] * (x.dim() - 1 - dim % x.dim()) + [0, extra]
    return F.pad(x, pads)


def _tiles(n, size):
    return -(-n // size) * size


def probs(qq, kk, vv, dd, lb, deb, causal, passes):
    """P and dS [B, H, Sq, Sk] of every (query, key) pair: S = Q K^T and
    dP = dO V^T on the emulated tensor cores, one batched product each,
    the causal mask -1e30 before the exp."""
    scale = 1.0 / math.sqrt(qq.shape[-1])
    s = tc_matmul(qq, kk.transpose(-1, -2), passes) * scale
    if causal:
        queries = torch.arange(qq.shape[2])
        keys = torch.arange(kk.shape[2])
        s = torch.where(keys[None, :] <= queries[:, None], s,
                        torch.tensor(_NEG))
    p = torch.exp(s - lb[..., None])
    dp = tc_matmul(dd, vv.transpose(-1, -2), passes)
    return p, p * (dp - deb[..., None]) * scale


def _in_order(terms, axis, n_halves):
    """Partial sums of ``terms`` over the tile axis ``axis`` (tile-major,
    ``n_halves`` halves a tile): a partial per half, its tiles' terms
    added one tile at a time in ascending order; then the halves added
    first to last."""
    n = terms.shape[axis] // n_halves
    parts = []
    for half in range(n_halves):
        acc = torch.zeros_like(terms.select(axis, 0))
        for tile in range(n):
            acc = acc + terms.select(axis, tile * n_halves + half)
        parts.append(acc)
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out


def emulated_single_pass(q, k, v, do, lse, delta, causal, passes=3):
    """The single pass on [B, S, H, D] f32 with lse and delta [B, Sq, H]:
    S^T and dP^T of every pair, P^T = exp(S^T scale - lse), dS^T = P^T
    (dP^T - delta) scale; for each (K tile, 32-query half) its dV and dK
    terms, added into the half's partial sums in Q tile order (half 0 +
    half 1 at the end); each K tile's dQ share dS K over its 64 keys, the
    shares summed in K tile order."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    qb, kb, vb, db = bhsd(q, k, v, do)
    lb, deb = (t.transpose(1, 2) for t in (lse, delta))  # [B, H, Sq]
    p, ds = probs(qb, kb, vb, db, lb, deb, causal, passes)  # [B,H,Sq,Sk]
    sq_p, sk_p = _tiles(sq, KT), _tiles(sk, KT)
    nk, nh = sk_p // KT, sq_p // HALF
    pt = _pad(_pad(p, 2, sq_p), 3, sk_p).transpose(-1, -2)
    dst = _pad(_pad(ds, 2, sq_p), 3, sk_p).transpose(-1, -2)
    # [B, H, K tile, query half-tile, KT keys, HALF queries]
    pt, dst_t = (x.reshape(b, h, nk, KT, nh, HALF).permute(0, 1, 2, 4, 3, 5)
                 for x in (pt, dst))
    qq, dd = (_pad(x, 2, sq_p).reshape(b, h, 1, nh, HALF, d)
              for x in (qb, db))
    dv = _in_order(tc_matmul(pt, dd, passes), 3, 2)
    dk = _in_order(tc_matmul(dst_t, qq, passes), 3, 2)
    # the K tiles' dQ shares [B, H, K tile, Sq_p, D], summed in tile order
    shares = tc_matmul(dst.reshape(b, h, nk, KT, sq_p).transpose(-1, -2),
                       _pad(kb, 2, sk_p).reshape(b, h, nk, KT, d), passes)
    dq = _in_order(shares, 2, 1)
    return (dq[:, :, :sq].permute(0, 2, 1, 3),
            dk.reshape(b, h, sk_p, d)[:, :, :sk].permute(0, 2, 1, 3),
            dv.reshape(b, h, sk_p, d)[:, :, :sk].permute(0, 2, 1, 3))


def merge(s1, s2):
    """Two online-softmax states (max m, l = rowsum(e), a = rowsum(e dP))
    merged, the first then the second."""
    (m1, l1, a1), (m2, l2, a2) = s1, s2
    mt = torch.maximum(m1, m2)
    f1, f2 = torch.exp(m1 - mt), torch.exp(m2 - mt)
    return mt, l1 * f1 + l2 * f2, a1 * f1 + a2 * f2


def emulated_stats(q, k, v, do, causal, passes=3):
    """The folded statistics launch: S and dP of every pair (one batched
    product each), then per Q tile of ``stats_walk`` each K tile's two
    32-key halves in their own running state (a row that has seen only
    masked keys takes its exponentials against 0), the halves merged
    (first, then second) at the end. Returns ``(lse, delta)`` [B, Sq,
    H]."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    qb, kb, vb, db = bhsd(q, k, v, do)
    neg = torch.tensor(_NEG)
    s_all = tc_matmul(qb, kb.transpose(-1, -2), passes) * scale
    if causal:
        s_all = torch.where(torch.arange(sk)[None, :]
                            <= torch.arange(sq)[:, None], s_all, neg)
    dp_all = tc_matmul(db, vb.transpose(-1, -2), passes)
    lse = torch.zeros((b, h, sq))
    delta = torch.zeros((b, h, sq))
    walks = list(stats_walk(sq, sk, causal))
    for qt in range(-(-sq // KT)):
        q0 = qt * KT
        rows = torch.arange(q0, min(q0 + KT, sq))
        halves = []
        for first in (0, HALF):
            m = torch.full((b, h, len(rows)), _NEG)
            l = torch.zeros((b, h, len(rows)))  # noqa: E741
            acc = torch.zeros((b, h, len(rows)))
            for kt in (w[1] for w in walks if w[0] == qt):
                k0 = kt * KT + first
                if k0 >= sk:
                    continue
                s = s_all[:, :, q0:q0 + KT, k0:k0 + HALF]
                dp = dp_all[:, :, q0:q0 + KT, k0:k0 + HALF]
                m_new = torch.maximum(m, s.amax(-1))
                ref = torch.where(m_new == neg, torch.tensor(0.0), m_new)
                alpha = torch.exp(m - ref)
                p = torch.exp(s - ref[..., None])
                l = l * alpha + p.sum(-1)  # noqa: E741
                acc = acc * alpha + (p * dp).sum(-1)
                m = m_new
            halves.append((m, l, acc))
        m, l, acc = merge(*halves)  # noqa: E741
        den = l.clamp_min(1e-30)
        lse[:, :, rows] = m + torch.log(den)
        delta[:, :, rows] = acc / den
    return lse.transpose(1, 2), delta.transpose(1, 2)


def emulated_dkv(q, k, v, do, lse, delta, causal, passes=3):
    """The dK/dV pass on [B, S, H, D] f32: P and dS of every pair, then
    per patch of 16 keys x 32 queries its dV term P^T dO and dK term
    dS^T Q, added into the partial sums of its query half in Q tile
    order; half 0 + half 1 at the end. Returns ``(dk, dv)``."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    qb, kb, vb, db = bhsd(q, k, v, do)
    lb, deb = (t.transpose(1, 2) for t in (lse, delta))
    p, ds = probs(qb, kb, vb, db, lb, deb, causal, passes)
    sq_p, sk_p = _tiles(sq, KT), _tiles(sk, KT)
    ng, nh = sk_p // GROUP, sq_p // HALF
    # [B, H, key group, query half-tile, GROUP keys, HALF queries]
    pt, dst = (_pad(_pad(x, 2, sq_p), 3, sk_p)
               .reshape(b, h, nh, HALF, ng, GROUP).permute(0, 1, 4, 2, 5, 3)
               for x in (p, ds))
    qq, dd = (_pad(x, 2, sq_p).reshape(b, h, 1, nh, HALF, d)
              for x in (qb, db))
    dv = _in_order(tc_matmul(pt, dd, passes), 3, 2)
    dk = _in_order(tc_matmul(dst, qq, passes), 3, 2)
    return tuple(x.reshape(b, h, sk_p, d)[:, :, :sk].permute(0, 2, 1, 3)
                 for x in (dk, dv))


def emulated_dq(q, k, v, do, lse, delta, causal, passes=3):
    """The dQ pass on [B, S, H, D] f32: dS of every pair, then per patch
    of 16 queries x 32 keys its term dS K, added into the partial sum of
    its key half in K tile order; the first half + the second at the
    end."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    qb, kb, vb, db = bhsd(q, k, v, do)
    lb, deb = (t.transpose(1, 2) for t in (lse, delta))
    _, ds = probs(qb, kb, vb, db, lb, deb, causal, passes)
    sq_p, sk_p = _tiles(sq, KT), _tiles(sk, KT)
    ng, nh = sq_p // GROUP, sk_p // HALF
    # [B, H, query group, key half-tile, GROUP queries, HALF keys]
    ds = (_pad(_pad(ds, 2, sq_p), 3, sk_p)
          .reshape(b, h, ng, GROUP, nh, HALF).permute(0, 1, 2, 4, 3, 5))
    kk = _pad(kb, 2, sk_p).reshape(b, h, 1, nh, HALF, d)
    dq = _in_order(tc_matmul(ds, kk, passes), 3, 2)
    return dq.reshape(b, h, sq_p, d)[:, :, :sq].permute(0, 2, 1, 3)
