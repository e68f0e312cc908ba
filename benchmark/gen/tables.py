"""Retrieval tables of the serving cells, drawn on the card from the seed.

Every table has the shape the port's table build gives it at the
configuration's sizes (A aids): five co-visitation types of top-N lists
(`CoVisTables`: neighbour, count, count_pop, perc_pop, count_rel, [A, N]
int32), two kNN tables (neighbour [A, k] int32, squared L2 distance [A, k]
float32, the aid itself first; rows past the `knn_first_n` most frequent
aids empty), cluster popularity (candidates [clusters, slots], their six
ranks, every aid's six general ranks), the item embedding [A, D], and each
test session's cluster and embedding.

Neighbour lists are drawn within the session generator's latent
categories (the `perm` of gen/sessions.py), without replacement, with
probability falling as 1 / (aid + 1) (aid ids are popularity ranks), so
the sources overlap as tables counted from such events do; rarer aids get
shorter lists. Counts fall along a list and with the aid's rank.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from benchmark.reference.retrieval import COVIS_NAMES, CoVisTables, RetrievalContext

I32 = torch.int32
F32 = torch.float32
# share of a popular aid's list that holds a neighbour, by count type
COVIS_DENSITY = {"click_to_click": 1.0, "click_to_cart_or_buy": 0.9, "cart_to_cart": 0.6,
                 "cart_to_buy": 0.5, "buy_to_buy": 0.4}
# aids with an embedding (the vocabulary of the item model), as a share of A
VOCAB_SHARE = 0.7


class SessionTables(NamedTuple):
    """Each test session's cl50 cluster [n] int32 and embedding [n, D]
    float32, on the host (the port's SessionLookup input)."""

    cluster: np.ndarray
    emb: np.ndarray


def _category_members(perm: torch.Tensor, cat: int) -> torch.Tensor:
    """[A, cat] int64: the aids of each aid's latent category."""
    A = perm.shape[0]
    perm_inv = torch.argsort(perm)
    base = perm // cat * cat
    slots = (base[:, None] + torch.arange(cat, device=perm.device)[None, :]).clamp(max=A - 1)
    return perm_inv[slots]


def _draw_lists(members: torch.Tensor, n: int, g: torch.Generator,
                self_first: bool) -> torch.Tensor:
    """[A, n] int64 neighbours: n of each row's category members without
    replacement (Gumbel top-n) with weight 1 / (aid + 1), the row's own aid
    left out, or put first with `self_first`."""
    A = members.shape[0]
    rows = torch.arange(A, device=members.device)
    u = torch.rand(members.shape, generator=g, device=members.device).clamp_(1e-12, 1 - 1e-7)
    key = -torch.log1p(members.to(F32)) - torch.log(-torch.log(u))
    key = torch.where(members == rows[:, None], -torch.inf, key)
    # a category cut at A - 1 repeats its last aid: keep one copy
    dup = torch.cat([torch.zeros_like(members[:, :1], dtype=torch.bool),
                     members[:, 1:] == members[:, :-1]], dim=1)
    key = torch.where(dup, -torch.inf, key)
    k = n - 1 if self_first else n
    top = torch.topk(key, k, dim=1)
    nbr = torch.gather(members, 1, top.indices)
    nbr = torch.where(torch.isfinite(top.values), nbr, -1)
    if self_first:
        nbr = torch.cat([rows[:, None], nbr], dim=1)
    return nbr


def _rank_share(A: int, device) -> torch.Tensor:
    """[A] float32 in (0, 1]: 1 for the most popular aid, falling to 0 with
    the log of the popularity rank."""
    a = torch.arange(A, device=device, dtype=F32)
    return (1.0 - torch.log1p(a) / math.log(A)).clamp(min=0.0)


def covis_tables(perm: torch.Tensor, cat: int, first_n: Dict[str, int],
                 g: torch.Generator) -> Tuple[CoVisTables, ...]:
    A = perm.shape[0]
    dev = perm.device
    members = _category_members(perm, cat)
    share = _rank_share(A, dev)
    base = (5000.0 / torch.arange(1, A + 1, device=dev, dtype=F32) ** 0.6).clamp(min=2.0)
    out = []
    for name in COVIS_NAMES:
        N = first_n[name]
        nbr = _draw_lists(members, N, g, self_first=False)
        n_valid = (N * (1.5 * COVIS_DENSITY[name] * share)).floor().clamp(0, N)
        col = torch.arange(N, device=dev)[None, :]
        ok = (col < n_valid[:, None]) & (nbr >= 0)
        cnt = (base[:, None] * (col + 1).to(F32) ** -0.7).floor().clamp(min=1.0)
        cnt = torch.where(ok, cnt, 0.0)
        top = float(base[min(10, A - 1)])
        count_pop = ((cnt - 1.0).clamp(min=0.0) / max(top - 1.0, 1.0)).clamp(max=1.0) * 10_000
        perc_pop = (1.0 - torch.log1p(cnt) / math.log1p(float(base[0]))) * 10_000
        count_rel = cnt / cnt[:, :1].clamp(min=1.0) * 100
        out.append(CoVisTables(
            neighbor=torch.where(ok, nbr, -1).to(I32),
            count=cnt.to(I32),
            count_pop=torch.where(ok, count_pop, 0.0).to(I32),
            perc_pop=torch.where(ok, perc_pop, 0.0).to(I32),
            count_rel=torch.where(ok, count_rel, 0.0).to(I32),
        ))
    return tuple(out)


def knn_table(perm: torch.Tensor, cat: int, k: int, first_n: int,
              g: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    A = perm.shape[0]
    dev = perm.device
    nbr = _draw_lists(_category_members(perm, cat), k, g, self_first=True)
    d = torch.sort(torch.rand((A, k), generator=g, device=dev) * 1.8 + 0.2, dim=1).values
    d[:, 0] = 0.0
    d = torch.where(nbr >= 0, d, 0.0)
    q = (torch.arange(A, device=dev) < min(first_n, A))[:, None]
    return torch.where(q, nbr, -1).to(I32), torch.where(q, d, 0.0).to(F32)


def popularity(A: int, n_clusters: int, slots: int, keep_top_k: int, rank_clip: int,
               g: torch.Generator, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(candidate [C, slots] int32, ranks [C, slots, 6] int32, aid_rank
    [A, 6] int32): per cluster a pool of popular aids ranked six ways; an
    aid stays a candidate where its best rank is at most keep_top_k."""
    pool_from = min(A, 20_000)
    w = -torch.log1p(torch.arange(pool_from, device=device, dtype=F32))
    u = torch.rand((n_clusters, pool_from), generator=g, device=device).clamp_(1e-12, 1 - 1e-7)
    pool = torch.topk(w[None, :] - torch.log(-torch.log(u)), slots, dim=1).indices  # [C, T]
    noise = torch.rand((n_clusters, slots, 6), generator=g, device=device)
    key = pool[:, :, None].to(F32) * (0.5 + noise)
    ranks = torch.argsort(torch.argsort(key, dim=1), dim=1) + 1
    ranks = ranks.clamp(max=rank_clip)
    best = ranks.amin(dim=2)
    order = torch.argsort(best, dim=1, stable=True)
    pool = torch.gather(pool, 1, order)
    ranks = torch.gather(ranks, 1, order[:, :, None].expand(-1, -1, 6))
    keep = torch.gather(best, 1, order) <= keep_top_k
    cand = torch.where(keep, pool, -1).to(I32)
    ranks = torch.where(keep[:, :, None], ranks, rank_clip).to(I32)
    a = torch.arange(A, device=device, dtype=F32)[:, None]
    jitter = torch.exp(0.3 * torch.randn((A, 6), generator=g, device=device))
    aid_rank = ((a + 1) * jitter).floor().clamp(1, rank_clip).to(I32)
    return cand, ranks, aid_rank


def aid_embedding(perm: torch.Tensor, cat: int, dim: int, g: torch.Generator) -> torch.Tensor:
    """[A, D] float32: a category centre plus noise; aids past the
    vocabulary (the rarest share) are zero rows, as the item model leaves
    them."""
    A = perm.shape[0]
    dev = perm.device
    n_cat = (A + cat - 1) // cat
    centre = torch.randn((n_cat, dim), generator=g, device=dev)
    emb = 0.3 * (centre[perm // cat] + 0.5 * torch.randn((A, dim), generator=g, device=dev))
    in_vocab = torch.arange(A, device=dev) < int(VOCAB_SHARE * A)
    return torch.where(in_vocab[:, None], emb, 0.0).contiguous()


def session_tables(stream, aid_emb: torch.Tensor, n_clusters: int,
                   g: torch.Generator) -> SessionTables:
    """Each session's cluster (uniform) and embedding (the mean of its
    visible aids' embeddings)."""
    dev = aid_emb.device
    n = stream.n_sessions
    sess = torch.from_numpy(stream.session.astype(np.int64)).to(dev)
    aid = torch.from_numpy(stream.aid.astype(np.int64)).to(dev)
    emb = torch.zeros((n, aid_emb.shape[1]), device=dev).index_add_(0, sess, aid_emb[aid])
    cnt = torch.bincount(sess, minlength=n).clamp(min=1).to(F32)
    emb = emb / cnt[:, None]
    cluster = torch.randint(0, n_clusters, (n,), generator=g, device=dev, dtype=torch.int32)
    return SessionTables(cluster.cpu().numpy(), emb.cpu().numpy())


def retrieval_context(stream, cfg: dict, g: torch.Generator) -> RetrievalContext:
    """Every table of the configuration `cfg` (its "tables" group)."""
    t = cfg["tables"]
    perm, cat = stream.perm, cfg["sessions"]["cat_size"]
    A = perm.shape[0]
    pop = popularity(A, t["pop_clusters"], t["pop_slots"], t["pop_keep_top_k"],
                     t["pop_rank_clip"], g, perm.device)
    return RetrievalContext(
        covis=covis_tables(perm, cat, t["covis_first_n"], g),
        knn_all=knn_table(perm, cat, t["knn_k"], t["knn_first_n_aids"], g),
        knn_1_2=knn_table(perm, cat, t["knn_k"], t["knn_first_n_aids"], g),
        pop_cl50_cand=pop[0],
        pop_cl50_ranks=pop[1],
        pop_cl1_rank=pop[2],
        aid_emb=aid_embedding(perm, cat, t["emb_dim"], g),
    )
