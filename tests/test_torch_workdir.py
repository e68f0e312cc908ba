"""The runner's work-dir guard and submission re-parse check against
otto_tpu's Pipeline (otto_tpu/pipeline/runner.py:116-146 and 1026-1031).

A work dir keeps `config.json` and `meta.json` (n_aids) beside the
artifacts they shaped. With use_cache, a rerun under another config or
n_aids is refused; fields the port does not have (otto_tpu's TPU-only
ones, such as `trees_per_dispatch` and `padded_dim`) are not compared, so
a work dir that otto_tpu's Pipeline started at the defaults is accepted.
"""
import dataclasses
import json
import logging

import numpy as np
import pytest

from otto_tpu import config as ref_config
from otto_tpu.pipeline.runner import Pipeline
from otto_tpu_torch import config
from otto_tpu_torch.data.schema import Labels
from otto_tpu_torch.pipeline import runner
import torch_threads  # noqa: F401

N_AIDS = 1000


def test_reference_default_work_dir_is_accepted(tmp_path):
    Pipeline(cfg=ref_config.Config(), work_dir=str(tmp_path), n_aids=N_AIDS)
    runner.check_work_dir(str(tmp_path), config.Config(), N_AIDS, use_cache=True)
    got = config.config_from_json(str(tmp_path / "config.json"))
    assert got == config.Config()
    with pytest.raises(ValueError, match="n_aids=1000"):
        runner.check_work_dir(str(tmp_path), config.Config(), N_AIDS + 1, use_cache=True)


def test_config_json_round_trip(tmp_path):
    cfg = config.Config(
        retrieval=config.RetrievalConfig(session_len_buckets=(8, 64)),
        w2vec={"b": config.Word2VecConfig(name="b", types=(1, 2), window=3),
               "a": config.Word2VecConfig(name="a", knn_first_n_aids=10)},
        gbdt=config.GBDTConfig(n_trees=7), ranker_backend="gbdt")
    config.config_to_json(cfg, str(tmp_path / "c.json"))
    back = config.config_from_json(str(tmp_path / "c.json"))
    assert back == cfg and list(back.w2vec) == ["b", "a"]
    assert config.stale_sections(cfg, json.load(open(tmp_path / "c.json"))) == []


CHANGES = {
    "gbdt": dict(gbdt=config.GBDTConfig(n_trees=7)),
    "ranker": dict(ranker=config.RankerConfig(neg_to_pos_ratio=20)),
    "w2vec": dict(w2vec=dict(reversed(list(config.W2VEC_MODELS.items())))),
    "covis": dict(covis=dataclasses.replace(config.CoVisConfig(), pair_budget=1 << 12)),
    "data": dict(data=config.DataConfig(test_days=3)),
}


@pytest.mark.parametrize("section", sorted(CHANGES))
def test_rerun_with_changed_config_raises(tmp_path, section):
    wd = str(tmp_path)
    runner.check_work_dir(wd, config.Config(), N_AIDS, use_cache=True)
    changed = config.Config(**CHANGES[section])
    with pytest.raises(ValueError, match=rf"\['{section}'\]"):
        runner.check_work_dir(wd, changed, N_AIDS, use_cache=True)
    runner.check_work_dir(wd, changed, N_AIDS, use_cache=False)     # rewrites
    runner.check_work_dir(wd, changed, N_AIDS, use_cache=True)


def test_rerun_with_changed_n_aids_raises(tmp_path):
    wd = str(tmp_path)
    runner.check_work_dir(wd, config.Config(), N_AIDS, use_cache=True)
    with pytest.raises(ValueError, match="n_aids"):
        runner.check_work_dir(wd, config.Config(), N_AIDS * 2, use_cache=True)
    assert json.load(open(tmp_path / "meta.json")) == {"n_aids": N_AIDS}


def test_run_streaming_refuses_before_any_work(tmp_path):
    """A rerun with another GBDTConfig is refused before the build (no
    events are even read)."""
    runner.check_work_dir(str(tmp_path), config.Config(), N_AIDS, use_cache=True)
    with pytest.raises(ValueError, match="gbdt"):
        runner.run_streaming(None, None, None, N_AIDS, str(tmp_path), "cpu",
                             cfg=config.Config(gbdt=config.GBDTConfig(n_trees=7)))


def test_reparse_mismatch_warns_and_returns(tmp_path, monkeypatch, caplog):
    """otto_tpu logs a re-parse mismatch and returns the metrics."""
    sessions = np.array([1, 2, 3], np.int32)
    aids = np.tile(np.arange(20, dtype=np.int32), (3, 1))
    preds = {t: (sessions, aids) for t in config.TYPES}
    labels = Labels(np.array([1, 2, 3]), np.array([0, 1, 2]), np.array([0, 1, 2]))
    want = runner.submit_and_eval(str(tmp_path), preds, labels)
    assert want["total"] > 0
    monkeypatch.setattr(runner.rank_engine, "read_submission", lambda path: {})
    with caplog.at_level(logging.WARNING, logger=runner.log.name):
        got = runner.submit_and_eval(str(tmp_path), preds, labels)
    assert got == want
    assert "re-parse mismatch" in caplog.text
