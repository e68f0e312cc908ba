"""Configuration of the ported stages.

Counterpart of otto_tpu/config.py for what the ported modules read: the
event types and recall weights, the co-visitation counting and
popularity settings, the retrieval caps, negative downsampling, the GBDT
ranker's trees and training, the MLP ranker's tower and training, the
word2vec models (SGNS training and their kNN tables), k-means, the data
split, the device mesh, and the root Config with its JSON round trip.
Names and defaults are otto_tpu's; tests/test_torch_host.py holds them
equal.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Dict, List, Optional, Tuple

TYPES: Tuple[str, ...] = ("clicks", "carts", "orders")
TYPE2ID: Dict[str, int] = {t: i for i, t in enumerate(TYPES)}
# weighted recall@20 (the OTTO metric)
TYPE_WEIGHTS: Dict[str, float] = {"clicks": 0.1, "carts": 0.3, "orders": 0.6}

# submission cutoff
KEEP_TOP_K = 20

HOUR = 60 * 60
DAY = 24 * HOUR

# co-visitation neighbours read per session aid at retrieval time, by
# table, in the tables' order (otto_tpu's CoVisConfig.retrieval_first_n)
COVIS_FIRST_N: Dict[str, int] = {
    "click_to_click": 10,
    "click_to_cart_or_buy": 10,
    "cart_to_cart": 20,
    "cart_to_buy": 20,
    "buy_to_buy": 20,
}


@dataclasses.dataclass(frozen=True)
class CoVisConfig:
    """Co-visitation counting: which event pairs count, how they are pruned
    and how many neighbours each aid keeps. The counting-machinery defaults
    (`host_spill`, `spill_prune_min_rows`, `pair_budget`, `max_run_rows`)
    are otto_tpu's: the spill-time prune depends on which pairs share a
    run, so other values give other tables."""

    # pair window: min_time_to_next <= ts_next - ts_this <= max_time_to_next
    min_time_to_next: int = -DAY
    max_time_to_next: int = DAY
    # per count type |dt| cap
    max_time_to_next_by_type: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {
            "click_to_click": 12 * HOUR,
            "click_to_cart_or_buy": DAY,
            "cart_to_cart": DAY,
            "cart_to_buy": DAY,
            "buy_to_buy": DAY,
        }
    )
    # (type_this, types_next) per count type
    count_types: Dict[str, Tuple[int, Tuple[int, ...]]] = dataclasses.field(
        default_factory=lambda: {
            "click_to_click": (0, (0,)),
            "click_to_cart_or_buy": (0, (1, 2)),
            "cart_to_cart": (1, (1,)),
            "cart_to_buy": (1, (2,)),
            "buy_to_buy": (2, (2,)),
        }
    )
    # global min count for a pair to be kept
    min_count_to_save: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {
            "click_to_click": 10,
            "click_to_cart_or_buy": 5,
            "cart_to_cart": 2,
            "cart_to_buy": 2,
            "buy_to_buy": 2,
        }
    )
    # min count applied to partial aggregates (spilled runs, overflowing
    # bounded tables)
    min_count_in_part: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {"click_to_click": 2, "click_to_cart_or_buy": 2}
    )
    # cap on pairs kept per table
    max_pairs_to_save: int = 300_000_000
    # neighbours kept per aid in each retrieval table
    retrieval_first_n: Dict[str, int] = dataclasses.field(
        default_factory=lambda: dict(COVIS_FIRST_N)
    )
    # per-type capacity of the device-only bounded table (host_spill=False)
    accumulator_capacity: int = 1 << 23
    # True: fully merged runs spill losslessly to host memory and the
    # global merge and prune happen there; False: a bounded device table
    # with per-type in-part pruning on overflow
    host_spill: bool = True
    # spilled runs of at least this many rows drop pairs below their type's
    # min_count_in_part first; 0 disables
    spill_prune_min_rows: int = 4_000_000
    # pair-grid lanes per microbatch (the ladder's run size)
    pair_budget: int = 1 << 22
    # largest ladder run, in rows
    max_run_rows: int = 1 << 26

    @property
    def names(self) -> List[str]:
        return list(self.count_types.keys())


@dataclasses.dataclass(frozen=True)
class PopularityConfig:
    """Cluster popularity: candidates are the aids whose best rank is at
    most keep_top_k; ranks clip at rank_clip; `recent` is the last
    recent_window seconds before the newest event."""

    keep_top_k: int = KEEP_TOP_K
    recent_window: int = 7 * DAY
    rank_clip: int = 999


@dataclasses.dataclass(frozen=True)
class RetrievalConfig:
    """Candidate retrieval caps."""

    # recency-adaptive trim: the aid at recency order r keeps its top
    # max(trim_min, trim_max_at_order_1 - slope * (r - 1)) ranked pairs
    trim_max_at_order_1: int = 20
    trim_min: int = 3
    trim_min_at_order: int = 20
    max_session_aids: int = 32      # kept unique aids per session
    max_candidates: int = 512       # padded candidate set per session
    session_len_buckets: Tuple[int, ...] = (8, 32, 128, 512)


@dataclasses.dataclass(frozen=True)
class RankerConfig:
    """The LambdaRank MLP tower (models/ranker.py) and what pass A reads:
    negative downsampling. otto_tpu's names and defaults."""

    hidden_dims: Tuple[int, ...] = (256, 128, 64)
    dropout: float = 0.0
    learning_rate: float = 1e-3
    weight_decay: float = 1e-5
    epochs: int = 16
    batch_sessions: int = 256            # session groups a step
    max_group: int = 128                 # padded candidates a group
    eval_at: int = 20                    # valid ndcg@eval_at
    seed: int = 42
    sigma: float = 1.0                   # LambdaRank pairwise logistic scale
    # linear warmup over this share of the steps, then cosine decay to
    # end_lr_frac * learning_rate
    warmup_frac: float = 0.05
    end_lr_frac: float = 0.05
    # stop after this many epochs without a better valid ndcg (0: run
    # every epoch); the best epoch's weights are kept either way
    early_stop_epochs: int = 4
    # score listwise: each candidate's input gains x - mean and x - max
    # over its session's valid candidates
    group_context: bool = False

    neg_to_pos_ratio: int = 40
    max_neg_per_session: int = 100
    # compute the downsample keep bits on the device beside the label join
    # (random draws from a torch.Generator, so other rows than the host
    # selection's numpy stream; off by default)
    device_select: bool = False


@dataclasses.dataclass(frozen=True)
class HSTUConfig:
    """The HSTU multi-task ranker's shape (models/hstu.py;
    `ranker_backend="hstu"`): d_model-wide tokens through n_blocks blocks
    of n_heads pointwise-attention heads (d_qk-wide queries and keys,
    d_v-wide values), history capped at its last max_seq_len events,
    relative position biases for 0..max_seq_len and time-gap biases for
    buckets 0..n_time_buckets, attention divided by the constant n_scale.
    A saved ranker carries its shape; the port only serves one (no
    training)."""

    d_model: int = 256
    n_heads: int = 4
    d_qk: int = 64
    d_v: int = 64
    n_blocks: int = 8
    max_seq_len: int = 200
    n_time_buckets: int = 128
    n_scale: float = 200.0
    eps: float = 1e-6


@dataclasses.dataclass(frozen=True)
class MLAMoEConfig:
    """The MLA + MoE decoder ranker's shape (models/mla_moe.py;
    `ranker_backend="mla_moe"`), under the keys of a DeepSeek-V3-style
    config.json; the defaults are Moonlight-16B-A3B's
    (huggingface.co/moonshotai/Moonlight-16B-A3B, config.json). Latent
    attention without a query latent (q_lora_rank None); the first
    first_k_dense_replace layers dense, the others n_routed_experts
    experts, num_experts_per_tok a token, chosen by sigmoid scores plus a
    correction bias, and n_shared_experts experts' width of shared MLP.
    The other settings are the ranker's: histories keep their last
    max_seq_len events and kv_norm_eps is the latent's RMSNorm eps. A
    saved ranker carries its shape; the port only serves one (no
    training)."""

    hidden_size: int = 2048
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    q_lora_rank: Optional[int] = None
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    n_routed_experts: int = 64
    num_experts_per_tok: int = 6
    n_shared_experts: int = 2
    first_k_dense_replace: int = 1
    routed_scaling_factor: float = 2.446
    scoring_func: str = "sigmoid"
    topk_method: str = "noaux_tc"
    norm_topk_prob: bool = True
    n_group: int = 1
    topk_group: int = 1
    rope_theta: float = 50000.0
    rms_norm_eps: float = 1e-5
    kv_norm_eps: float = 1e-6
    max_seq_len: int = 200

    def __post_init__(self):
        fixed = {"q_lora_rank": None, "scoring_func": "sigmoid", "topk_method": "noaux_tc",
                 "norm_topk_prob": True, "n_group": 1, "topk_group": 1}
        wrong = {k: getattr(self, k) for k, v in fixed.items() if getattr(self, k) != v}
        if wrong:
            raise ValueError(f"MLAMoEConfig: the ranker takes only {fixed}, not {wrong}")
        if self.qk_rope_head_dim % 2 or not 0 < self.num_experts_per_tok <= self.n_routed_experts:
            raise ValueError("MLAMoEConfig: qk_rope_head_dim must be even and "
                             "0 < num_experts_per_tok <= n_routed_experts")


@dataclasses.dataclass(frozen=True)
class GBDTConfig:
    """Histogram-GBDT lambdarank: the trees' shape (what scoring reads) and
    the training settings, with otto_tpu's names and defaults: 150 trees,
    depth 4, lr 0.25, colsample 0.25, subsample 0.5, min_child_samples 20,
    ndcg@20."""

    n_trees: int = 150
    max_depth: int = 4
    n_bins: int = 64
    learning_rate: float = 0.25
    colsample: float = 0.25          # feature fraction per tree
    subsample: float = 0.5           # row (bagging) fraction per tree
    min_child_samples: int = 20
    min_child_hessian: float = 1e-3
    lambda_l2: float = 0.0
    sigma: float = 1.0               # lambdarank logistic scale
    ndcg_at: int = 20                # truncation of the |dNDCG| pair weights
    lambda_norm: bool = True         # per-query lambda normalisation
    max_group: int = 128             # padded candidates per session group
    seed: int = 42
    # valid ndcg@ndcg_at every eval_every trees (0: once, at the end)
    eval_every: int = 25
    # stop when valid ndcg has not improved for this many trees; the best
    # iteration's trees are kept (0: off)
    early_stopping_rounds: int = 0
    # seeded caps on the session groups trained on / evaluated (0: none)
    max_train_groups: int = 1 << 18
    max_valid_groups: int = 1 << 16
    row_chunk: int = 1 << 14         # read by otto_tpu's histograms only
    group_chunk: int = 1 << 10       # groups per lambda chunk; groups pad to it

    @staticmethod
    def from_dict(d: dict) -> "GBDTConfig":
        """From a saved ranker's config dict, otto_tpu's or the port's: each
        field cast to its declared type; keys this config lacks are ignored
        and fields the dict lacks keep their defaults."""
        cast = {"int": int, "float": float, "bool": bool}
        return GBDTConfig(**{f.name: cast[f.type](d[f.name])
                             for f in dataclasses.fields(GBDTConfig) if f.name in d})


@dataclasses.dataclass(frozen=True)
class Word2VecConfig:
    """An item-embedding model: its vocabulary filter and width, the SGNS
    training settings and the kNN search over its table. Names and
    defaults are otto_tpu's; the port leaves out its `padded_dim` (an MXU
    tile width)."""

    name: str = "w2v-all"
    types: Tuple[int, ...] = (0, 1, 2)   # event types in the corpus
    vector_size: int = 100
    window: int = 10
    min_count: int = 5
    negatives: int = 8                    # SGNS negatives per positive
    batch_size: int = 65536               # pairs per step
    epochs: int = 5
    learning_rate: float = 0.25           # Adagrad base lr (per-row adaptive)
    min_learning_rate: float = 0.05       # host sampler's linear decay end
    subsample_t: float = 1e-3             # frequent-word subsampling threshold
    ns_exponent: float = 0.75             # unigram^0.75 negative table
    seed: int = 42
    # 'device': pairs sampled on the device from the flat corpus; 'host':
    # numpy pairs per epoch (skipgram_pairs)
    sampler: str = "device"
    # negatives: 'pair' draws `negatives` per positive (dense whole-table
    # gradients), 'chunk' shares a drawn pool within chunks of pairs;
    # 'auto' takes 'chunk' at >= 100k words or >= 5M corpus positions
    neg_sharing: str = "auto"
    # contexts per sampled center in chunk mode (0 / 1: per-pair sampling)
    block_k: int = 4
    # 'adagrad' (per-row adaptive) or 'sgd': gensim's plain SGD, its rate
    # falling linearly from sgd_alpha to sgd_min_alpha over the run, held
    # for each steps_per_dispatch steps; block steps only (other step kinds
    # train with Adagrad, as otto_tpu's do). A batch sums the gradients of
    # a word's duplicate occurrences, and without Adagrad's per-row scale
    # the summed step can diverge (NaN on the 200-word topics fixture at
    # alpha 0.05, otto_tpu/config.py:212-220)
    optimizer: str = "adagrad"
    sgd_alpha: float = 0.025
    sgd_min_alpha: float = 1e-4
    # an epoch runs ceil(steps / steps_per_dispatch) * steps_per_dispatch
    # steps, as otto_tpu's fixed-size dispatches do; the port dispatches
    # step by step, and keeps the field for that step count
    steps_per_dispatch: int = 64
    knn_k: int = 20
    knn_first_n_aids: int = 600_000      # queries: the most frequent words

    def __post_init__(self):
        if self.optimizer not in ("adagrad", "sgd"):
            raise ValueError(
                f"word2vec optimizer {self.optimizer!r}: 'adagrad' or 'sgd'")


# the two embedding models, in build order; the first is the main model
# whose table serves as the item embeddings
W2VEC_MODELS: Dict[str, Word2VecConfig] = {
    "w2v-all": Word2VecConfig(name="w2v-all", types=(0, 1, 2)),
    "w2v-1-2": Word2VecConfig(name="w2v-1-2", types=(1, 2)),
}


@dataclasses.dataclass(frozen=True)
class KMeansConfig:
    """Session clustering."""

    n_clusters_to_find: Tuple[int, ...] = (50,)
    max_iter: int = 100
    tol: float = 1e-3
    seed: int = 42


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset / split settings."""

    test_days: int = 7                    # the local split's test window
    chunk_sessions: int = 100_000         # ingestion chunk
    seed: int = 42


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device mesh layout: 'data' (sessions and batches split over ranks)
    and 'model' (row-sharded embedding tables). data_parallel -1 puts every
    rank the model axis leaves on the data axis."""

    data_axis: str = "data"
    model_axis: str = "model"
    data_parallel: int = -1
    model_parallel: int = 1


@dataclasses.dataclass(frozen=True)
class Config:
    """The root configuration, with otto_tpu's section names; otto_tpu's
    TPU-only fields are left out of their sections."""

    work_dir: str = "artifacts"
    covis: CoVisConfig = dataclasses.field(default_factory=CoVisConfig)
    retrieval: RetrievalConfig = dataclasses.field(default_factory=RetrievalConfig)
    w2vec: Dict[str, Word2VecConfig] = dataclasses.field(
        default_factory=lambda: dict(W2VEC_MODELS))
    kmeans: KMeansConfig = dataclasses.field(default_factory=KMeansConfig)
    popularity: PopularityConfig = dataclasses.field(default_factory=PopularityConfig)
    ranker: RankerConfig = dataclasses.field(default_factory=RankerConfig)
    gbdt: GBDTConfig = dataclasses.field(default_factory=GBDTConfig)
    # the rankers' model class: a key of pipeline.runner.RANKER_BACKENDS
    ranker_backend: str = "gbdt"
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)

    def replace(self, **kw) -> "Config":
        """A copy with the named sections or fields replaced."""
        return dataclasses.replace(self, **kw)


DEFAULT = Config()


def config_to_json(cfg: Config, path: str) -> None:
    with open(path, "w") as fh:
        json.dump(dataclasses.asdict(cfg), fh, indent=2)


def _tuples(obj):
    """JSON turns tuples into lists; every sequence field is a Tuple."""
    if isinstance(obj, list):
        return tuple(_tuples(x) for x in obj)
    if isinstance(obj, dict):
        return {k: _tuples(v) for k, v in obj.items()}
    return obj


def _section(cls, d: dict):
    """cls from a stored section: fields it lacks keep their defaults, and
    stored keys it does not have (otto_tpu's TPU-only fields) are ignored."""
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in d.items() if k in names})


def config_from_json(path: str) -> Config:
    """A config.json of either package -> the port's Config."""
    with open(path) as fh:
        d = _tuples(json.load(fh))
    return Config(
        work_dir=d.get("work_dir", "artifacts"),
        covis=_section(CoVisConfig, d["covis"]),
        retrieval=_section(RetrievalConfig, d["retrieval"]),
        w2vec={k: _section(Word2VecConfig, v) for k, v in d["w2vec"].items()},
        kmeans=_section(KMeansConfig, d["kmeans"]),
        popularity=_section(PopularityConfig, d["popularity"]),
        ranker=_section(RankerConfig, d["ranker"]),
        gbdt=_section(GBDTConfig, d["gbdt"]),
        ranker_backend=d.get("ranker_backend", "gbdt"),
        data=_section(DataConfig, d["data"]),
        mesh=_section(MeshConfig, d.get("mesh", {})),
    )


def stale_sections(cfg: Config, stored: dict) -> List[str]:
    """The sections of `cfg` (all but work_dir and mesh, which shape no
    artifact) that a stored config.json (as loaded) does not hold: a field
    the port has must be stored with the same value, and the w2vec models
    must be the same names in the same order. Stored fields the port lacks
    are not compared."""
    cur = json.loads(json.dumps(dataclasses.asdict(cfg)))   # as stored: lists
    cur.pop("work_dir")
    cur.pop("mesh")

    def same_fields(c, s):
        return isinstance(s, dict) and all(k in s and s[k] == v for k, v in c.items())

    stale = []
    for name, c in cur.items():
        s = stored.get(name)
        if name == "w2vec":
            same = (isinstance(s, dict) and list(s) == list(c)
                    and all(same_fields(c[m], s[m]) for m in c))
        elif isinstance(c, dict):
            same = same_fields(c, s)
        else:
            same = s == c
        if not same:
            stale.append(name)
    return stale


def setup_logging(work_dir: Optional[str] = None, level: int = logging.INFO) -> None:
    """Log to stderr and, with a work dir, to its `logs.log`."""
    handlers: List[logging.Handler] = [logging.StreamHandler()]
    if work_dir is not None:
        os.makedirs(work_dir, exist_ok=True)
        handlers.append(logging.FileHandler(os.path.join(work_dir, "logs.log")))
    logging.basicConfig(
        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s",
        handlers=handlers, level=level, force=True)
