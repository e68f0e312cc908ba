"""The overlapped consumer (pipelined_consume) and the Pipeline's guards.

pipelined_consume must hand the batches to the consumer in order, on a
worker thread one batch behind, and give the sequential loop's results;
an error in the consumer or in the producer is raised in the caller and
leaves no thread behind. A Pipeline resolves its device (the card by
default: without one it raises), runs either ranker backend and guards
its work dir, as otto_tpu's does."""
import dataclasses
import json
import threading

import numpy as np
import pytest
import torch

from otto_tpu_torch import config
from otto_tpu_torch.data.synthetic import SyntheticSpec
from otto_tpu_torch.models.ranker import Ranker
from otto_tpu_torch.pipeline import cli, runner


class Batch:
    """What pipelined_consume reads of a retrieval batch."""

    def __init__(self, i):
        self.i = i
        self.feats = torch.full((2, 3, 4), float(i))
        self.session = np.array([i])


def _threads():
    return {t.name for t in threading.enumerate()}


@pytest.mark.parametrize("overlap", [True, False])
def test_batches_reach_the_consumer_in_order(overlap):
    seen, packed = [], []

    def pack(b):
        packed.append(b.i)
        return b.feats.sum()

    def consume(b, meta):
        seen.append((b.i, float(meta), threading.current_thread().name))

    seconds = runner.pipelined_consume((Batch(i) for i in range(9)), consume, pack=pack,
                                       overlap=overlap)
    assert [s[0] for s in seen] == packed == list(range(9))
    assert [s[1] for s in seen] == [24.0 * i for i in range(9)]
    worker = "pipeline-consume" if overlap else threading.current_thread().name
    assert {s[2] for s in seen} == {worker}
    assert set(seconds) == {"produce", "consume", "wait"}
    assert "pipeline-consume" not in _threads()


def test_overlap_under_thread_switches():
    """Many batches with the interpreter switching threads every few
    bytecodes: each batch consumed once, in order, the producer's and the
    consumer's counters whole; the worker ends within its time."""
    import sys
    import time

    state = {"packed": 0, "consumed": 0}
    order = []

    def pack(b):
        state["packed"] += 1
        return b.i

    def consume(b, meta):
        state["consumed"] += 1
        order.append(meta)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t0 = time.perf_counter()
        runner.pipelined_consume((Batch(i) for i in range(400)), consume, pack=pack)
    finally:
        sys.setswitchinterval(old)
    assert time.perf_counter() - t0 < 60
    assert state == {"packed": 400, "consumed": 400} and order == list(range(400))
    assert "pipeline-consume" not in _threads()


@pytest.mark.parametrize("overlap", [True, False])
def test_consumer_error_is_raised_in_the_caller(overlap):
    produced = []

    def batches():
        for i in range(50):
            produced.append(i)
            yield Batch(i)

    def consume(b, meta):
        if b.i == 3:
            raise ValueError("consumer failed on batch 3")

    with pytest.raises(ValueError, match="batch 3"):
        runner.pipelined_consume(batches(), consume, overlap=overlap)
    # the producer stops soon after: at most the batches in flight
    assert len(produced) <= 7
    assert "pipeline-consume" not in _threads()


def test_producer_error_is_raised_and_the_worker_joined():
    seen = []

    def batches():
        yield Batch(0)
        yield Batch(1)
        raise KeyError("retrieval failed")

    with pytest.raises(KeyError, match="retrieval failed"):
        runner.pipelined_consume(batches(), lambda b, m: seen.append(b.i))
    assert seen == [0, 1]
    assert "pipeline-consume" not in _threads()


def test_pipeline_guards(tmp_path):
    cfg = config.Config()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            runner.Pipeline(cfg, str(tmp_path / "a"), 100)
        assert not (tmp_path / "a" / "config.json").exists()
    # the MLP backend at a tiny size: trains three towers, serves them
    mlp = dataclasses.replace(cli.tiny_config(), ranker_backend="mlp")
    torch_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        metrics = runner.run_synthetic(mlp, str(tmp_path / "b"),
                                       SyntheticSpec(n_sessions=150, n_aids=120, seed=7),
                                       batch_sessions=64, device="cpu")
    finally:
        torch.set_num_threads(torch_threads)
    assert 0.0 < metrics["total"] <= metrics["ceiling_total"]
    rankers = runner.Pipeline(mlp, str(tmp_path / "b"), 120, device="cpu").load_rankers()
    assert set(rankers) == set(config.TYPES)
    assert all(isinstance(r, Ranker) and r.cfg == mlp.ranker for r in rankers.values())
    assert not list((tmp_path / "b").glob("ranker-gbdt-*"))
    with pytest.raises(FileNotFoundError, match="no trained mlp ranker"):
        runner.Pipeline(mlp, str(tmp_path / "d"), 100, device="cpu").load_rankers()
    pipe = runner.Pipeline(cfg, str(tmp_path / "c"), 100, device="cpu")
    assert pipe.device == torch.device("cpu") and pipe.stage_log == []
    assert json.load(open(tmp_path / "c" / "meta.json")) == {"n_aids": 100}
    assert not pipe._cached("covis.pkl")
    with pytest.raises(ValueError, match="n_aids"):
        runner.Pipeline(cfg, str(tmp_path / "c"), 99, device="cpu")
    with pytest.raises(FileNotFoundError, match="no trained gbdt ranker"):
        pipe.load_rankers()
    runner.Pipeline(cfg, str(tmp_path / "c"), 99, use_cache=False, device="cpu")
