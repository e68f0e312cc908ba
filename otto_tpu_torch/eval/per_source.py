"""Per-source retrieval evaluation (C14).

Counterpart of otto_tpu/eval/per_source.py: the recall ceiling of every
candidate source (src_any, src_self, the five co-visitation sources, the
two w2vec sources, cluster popularity) and of each "source & not self",
at 20, 100, 200 and all candidate columns, plus per-source
candidate-count statistics. Two paths give the same report:

- the host path, `eval_retrieved_by_source` over batches kept whole (the
  batch runner): each batch's source flags are packed on its device into
  one uint16 per candidate (`SrcFlagBatch.from_batch`), so only [S, C]
  uint16 crosses to the host, never the [S, C, F] features;
- the streamed path, `DeviceSourceEval`: each batch folds its packed meta
  (cand + source flags) and its label bits into integer hit counters and
  count histograms on the device; `finalize` pulls a few KB once.
  Integer counters make the result exact and the same on every device.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from otto_tpu_torch.config import TYPE2ID, TYPE_WEIGHTS, TYPES
from otto_tpu_torch.data.schema import Labels
from otto_tpu_torch.engine.retrieval import FEATURE_INDEX, SOURCE_FLAGS, RetrievedBatch
from otto_tpu_torch.eval.recall import recall_at_k

# bit order of the packed meta's flags
SOURCES = SOURCE_FLAGS


class SrcFlagBatch:
    """What the per-source report reads of a retrieval batch: its sessions,
    its candidates [S, C] and the source flags packed into one uint16 per
    candidate (bit k = SOURCES[k]), all on the host."""

    __slots__ = ("session", "cand", "flags")

    def __init__(self, session, cand, flags):
        # flags: [S, C] uint16 bitmask (packed) or [S, C, n_src] bool
        self.session, self.cand, self.flags = session, cand, flags

    def src(self, name: str) -> np.ndarray:
        k = SOURCES.index(name)
        if self.flags.ndim == 2:
            return (self.flags >> k) & 1 > 0
        return self.flags[:, :, k]

    @classmethod
    def from_batch(cls, b: RetrievedBatch) -> "SrcFlagBatch":
        """Pack b's flags on its device; pull the [S, C] uint16 and b.cand."""
        return cls(b.session, b.cand, _pack_flags_program(b.feats).cpu().numpy())


def _pack_flags_program(feats: torch.Tensor) -> torch.Tensor:
    """[S, C, F] features -> [S, C] uint16 source-flag bits, on feats'
    device."""
    idx = torch.tensor([FEATURE_INDEX[s] for s in SOURCES], device=feats.device)
    bits = (feats[:, :, idx] > 0).to(torch.int32)
    w = 1 << torch.arange(len(SOURCES), dtype=torch.int32, device=feats.device)
    return (bits * w).sum(dim=-1, dtype=torch.int32).to(torch.uint16)


def _masked_cands(batches, mask_fn):
    sess, cands = [], []
    for b in batches:
        sess.append(b.session)
        cands.append(np.where(mask_fn(b), b.cand, -1))
    return np.concatenate(sess), np.concatenate(cands)


def _src(b: SrcFlagBatch, name: str) -> np.ndarray:
    return b.src(name)


def eval_retrieved_by_source(
    batches: List,
    labels: Labels,
    cutoffs: Sequence[int] = (20, 100, 200),
    include_not_self: bool = True,
) -> Dict[str, Dict]:
    """batches: RetrievedBatch or SrcFlagBatch (a RetrievedBatch is packed
    on its device first) -> {source: {type: {topK: recall}}} plus the
    candidates-per-session stats of each source under '_counts'."""
    batches = [b if isinstance(b, SrcFlagBatch) else SrcFlagBatch.from_batch(b)
               for b in batches]
    report: Dict[str, Dict] = {}
    filters = {s: (lambda b, s=s: _src(b, s)) for s in SOURCES}
    if include_not_self:
        for s in SOURCES:
            if s in ("src_any", "src_self"):
                continue
            filters[f"{s} & not self"] = lambda b, s=s: _src(b, s) & ~_src(b, "src_self")
    for name, mask_fn in filters.items():
        sess, cands = _masked_cands(batches, mask_fn)
        report[name] = recall_at_k(sess, cands, labels, cutoffs)

    counts: Dict[str, Dict[str, float]] = {}
    for s in SOURCES:
        per_session = np.concatenate([(_src(b, s) & (b.cand >= 0)).sum(axis=1)
                                      for b in batches])
        counts[s] = {
            "mean": float(per_session.mean()),
            "min": int(per_session.min()),
            "p50": float(np.percentile(per_session, 50)),
            "p95": float(np.percentile(per_session, 95)),
            "max": int(per_session.max()),
        }
    report["_counts"] = counts
    return report


class DeviceSourceEval:
    """Running [n_filters, 3 types, n_cutoffs] hit counters and
    [n_sources, C+1] per-session candidate-count histograms. A hit is a
    label candidate flagged by the filter's source within the first
    `cutoff` candidate columns; per-session hits and truths are both capped
    at `truth_cap` (20), as recall@20 caps them."""

    CUTOFFS = (20, 100, 200)  # + "all" = C

    def __init__(self, n_cols: int, device, truth_cap: int = 20):
        self.n_cols = n_cols
        self.truth_cap = truth_cap
        self.filter_names = list(SOURCES) + [
            f"{s} & not self" for s in SOURCES if s not in ("src_any", "src_self")
        ]
        dev = torch.device(device)
        self._bits = torch.tensor(
            [SOURCES.index(n.split(" & ")[0]) for n in self.filter_names], device=dev)
        self._not_self = torch.tensor(
            [n.endswith("not self") for n in self.filter_names], device=dev)
        self._lims = torch.tensor(list(self.CUTOFFS) + [n_cols], device=dev)
        self.hits = torch.zeros((len(self.filter_names), 3, len(self.CUTOFFS) + 1),
                                dtype=torch.int64, device=dev)
        self.hist = torch.zeros((len(SOURCES), n_cols + 1), dtype=torch.int64, device=dev)

    def update(self, meta: torch.Tensor, tbits: torch.Tensor) -> None:
        """Fold one batch: meta [S, C] int32 (pack_meta), tbits [S, C]
        uint8 label bits (bit t = type t)."""
        n_src = len(SOURCES)
        S, C = meta.shape
        valid = (meta >> n_src) > 0                            # cand + 1 > 0
        flag = ((meta[None] >> self._bits[:, None, None]) & 1) > 0   # [nf, S, C]
        self_f = ((meta >> SOURCES.index("src_self")) & 1) > 0
        m = flag & valid & ~(self._not_self[:, None, None] & self_f)
        lab = torch.stack([((tbits >> t) & 1) > 0 for t in range(3)])   # [3, S, C]
        # hits within each cutoff: prefix counts along the columns
        cnt = (m[:, None] & lab[None]).to(torch.int32).cumsum(-1)        # [nf, 3, S, C]
        at = (self._lims.clamp(max=C) - 1)
        per_lim = cnt[..., at]                                            # [nf, 3, S, L]
        self.hits += per_lim.clamp(max=self.truth_cap).sum(2)
        # per-source candidate counts -> histograms
        n_cand = m[:n_src].sum(-1)                                        # [n_src, S]
        cell = n_cand + torch.arange(n_src, device=meta.device)[:, None] * (self.n_cols + 1)
        self.hist += torch.bincount(
            cell.reshape(-1), minlength=n_src * (self.n_cols + 1)
        ).view(n_src, self.n_cols + 1)

    def finalize(self, labels: Labels) -> Dict[str, Dict]:
        """-> {filter: {type: {topK: recall}}} and '_counts' {source: mean,
        min, p50, p95, max of candidates per session}, otto_tpu's report,
        plus '_ceiling' (the src_any filter: the whole candidate set)."""
        hits = self.hits.cpu().numpy()
        hist = self.hist.cpu().numpy()
        # denominators: capped truth counts per type over every labelled
        # session
        denom = np.zeros(3, np.int64)
        for tid in range(3):
            lab = labels.for_type(tid)
            if len(lab):
                _, cnt = np.unique(lab.session, return_counts=True)
                denom[tid] = np.minimum(cnt, self.truth_cap).sum()
        keys = [f"top{c}" for c in self.CUTOFFS] + ["topall"]

        report: Dict[str, Dict] = {}
        for fi, name in enumerate(self.filter_names):
            by_type: Dict[str, Dict[str, float]] = {}
            for tname, tid in TYPE2ID.items():
                by_type[tname] = {
                    k: (float(hits[fi, tid, li]) / denom[tid] if denom[tid] else 0.0)
                    for li, k in enumerate(keys)
                }
            by_type["total"] = {
                k: sum(TYPE_WEIGHTS[t] * by_type[t][k] for t in TYPES) for k in keys
            }
            report[name] = by_type

        counts: Dict[str, Dict[str, float]] = {}
        for si, s in enumerate(SOURCES):
            h = hist[si]
            n = int(h.sum())
            vals = np.arange(len(h))
            nz = np.nonzero(h)[0]
            cum = np.cumsum(h)

            def pctl(q):
                # np.percentile's 'linear' rule, exact from the histogram
                t = q / 100.0 * (n - 1)
                f, c = int(np.floor(t)), int(np.ceil(t))
                lo = float(vals[np.searchsorted(cum, f + 1)])
                hi = float(vals[np.searchsorted(cum, c + 1)])
                return lo + (hi - lo) * (t - f)

            counts[s] = {
                "mean": float((h * vals).sum() / max(n, 1)),
                "min": int(nz[0]) if len(nz) else 0,
                "p50": pctl(50),
                "p95": pctl(95),
                "max": int(nz[-1]) if len(nz) else 0,
            }
        report["_counts"] = counts
        report["_ceiling"] = report["src_any"]
        return report


def format_report(report: Dict[str, Dict], k: int = 20) -> str:
    lines = [f"{'source':<34} {'type':<8} top20    top100   top200   topall"]
    for src, by_type in report.items():
        if src.startswith("_"):
            continue
        for tname in ("clicks", "carts", "orders", "total"):
            r = by_type[tname]
            lines.append(
                f"{src:<34} {tname:<8} "
                f"{r['top20']:.4f}   {r['top100']:.4f}   "
                f"{r['top200']:.4f}   {r['topall']:.4f}"
            )
    return "\n".join(lines)
