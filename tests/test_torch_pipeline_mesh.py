"""The port's pipeline on a mesh of ranks: mesh-size invariance of both
runners and of pass A's rows, the CLI under torchrun, and the mesh's
errors.

Mirrors tests/test_pipeline_mesh.py (its sharded-counter case is in
test_torch_parallel.py) and the mesh cases of tests/test_mesh_stages.py:
`parse_mesh_spec` and `run-synthetic --mesh`. Four ranks start once (gloo,
a FileStore under tmp_path) and run, on test_pipeline_mesh.py's events
and configuration: Pipeline(mesh=data=4).run_streaming; pass_a on data=4
and on data=2 (a 2x2 mesh) from its cache, with numpy and with device
selection; and the batch runner Pipeline(mesh=data=4).run on a work dir
seeded with the streaming run's tables, with labels and inference-only.
The one-rank runs are the same calls in this process.

Unlike otto_tpu's mesh (whose dp GBDT bags each shard's rows on its own),
the port draws one device's negatives and one device's GBDT bags on any
number of ranks, so every output is one rank's: the artifacts, reports,
pass A's rows, the rankers' arrays and the submission byte-equal, the
ceilings within 1e-12 and the ranked metrics within 1e-12.
"""
import argparse
import json
import pickle
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
import torch_threads
from otto_tpu.data.split import split_events
from otto_tpu.data.synthetic import SyntheticSpec, generate
from otto_tpu_torch.config import TYPES
from otto_tpu_torch.data.schema import Labels
from otto_tpu_torch.parallel import distributed
from otto_tpu_torch.parallel.distributed import spawn_ranks
from otto_tpu_torch.pipeline import cli
from otto_tpu_torch.pipeline.runner import Pipeline

REPO = Path(__file__).resolve().parents[1]
CEILINGS = ("ceiling_clicks", "ceiling_carts", "ceiling_orders", "ceiling_total")
RANKED = ("clicks", "carts", "orders", "total")
ARTIFACTS = ("covis.pkl", "w2v-wall.npz", "w2v-w12.npz", "knn-wall.npz", "knn-w12.npz",
             "session_emb.npz", "clusters.npz", "eval_retrieved.json",
             "eval_retrieved_sources.json", "config.json", "meta.json")
# what the batch runner writes, besides the seeded tables and the rankers
BATCH_FILES = ("eval_retrieved.json", "eval_retrieved_sources.json", "submission.csv",
               "eval_submission.json") + tuple(f"feat-importance-{t}.csv" for t in TYPES)
PASS_A_FILES = ("eval_retrieved.json", "eval_retrieved_sources.json", "passA-metrics.json")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four ranks' results ([rank r's dict]) and this process's
    one-rank runs of the same calls, in one tmp dir."""
    tmp = tmp_path_factory.mktemp("pipeline_mesh")
    spec = SyntheticSpec(n_sessions=1200, n_aids=600, mean_len=10, span_days=21, seed=17)
    sp = split_events(generate(spec), 7, 42)
    cols = ("session", "aid", "ts", "type")
    inp = {"train": {k: getattr(sp.train, k) for k in cols},
           "test": {k: getattr(sp.test, k) for k in cols},
           "labels": (sp.labels.session, sp.labels.aid, sp.labels.type)}
    with open(tmp / "inputs.pkl", "wb") as fh:
        pickle.dump(inp, fh)
    spawn_ranks(ranks.run_pipeline, 4, args=(str(tmp),), device="cpu",
                threads=torch_threads.THREADS, store_path=str(tmp / "store"))
    n = []
    for r in range(4):
        with open(tmp / f"rank{r}.pkl", "rb") as fh:
            n.append(pickle.load(fh))
    train, test, labels = (ranks.ev_of(inp["train"]), ranks.ev_of(inp["test"]),
                           Labels(*inp["labels"]))
    one = Pipeline(cfg=ranks.pipeline_cfg(), work_dir=str(tmp / "one"), n_aids=600,
                   device="cpu")
    streaming = one.run_streaming(train, test, labels, batch_sessions=64)
    pass_a = {sel: ranks.run_pass_a(str(tmp), inp, 1, sel) for sel in (False, True)}
    ranks.seed_tables(str(tmp / "one"), str(tmp / "one-batch"))
    batch = Pipeline(cfg=ranks.pipeline_cfg(), work_dir=str(tmp / "one-batch"), n_aids=600,
                     device="cpu").run(train, test, labels, batch_sessions=64)
    return types.SimpleNamespace(tmp=tmp, n=n, streaming=streaming, pass_a=pass_a,
                                 batch=batch)


def _npz_equal(a: Path, b: Path) -> None:
    """Two .npz files hold the same arrays, byte for byte (the files
    themselves carry their write times)."""
    za, zb = np.load(a), np.load(b)
    assert sorted(za.files) == sorted(zb.files)
    for k in za.files:
        assert za[k].dtype == zb[k].dtype and za[k].shape == zb[k].shape, k
        assert za[k].tobytes() == zb[k].tobytes(), k


def _metrics_equal_one_rank(runs, runner):
    """Every rank returns one rank's metrics: the same pass A rows and GBDT
    bags leave nothing to differ in the ranked metrics."""
    m_1 = getattr(runs, runner)
    for m in runs.n:
        assert m[runner] == runs.n[0][runner]   # every rank returns the same metrics
    m = runs.n[0][runner]
    for k in CEILINGS:
        assert abs(m[k] - m_1[k]) < 1e-12, (k, m[k], m_1[k])
    for k in RANKED:
        assert abs(m[k] - m_1[k]) < 1e-12, (k, m[k], m_1[k])
    assert m["total"] > 0.2


def _same_files(runs, suffix):
    one = {p.name for p in (runs.tmp / f"one{suffix}").iterdir()} - {"logs.log"}
    four = {p.name for p in (runs.tmp / f"four{suffix}").iterdir()} - {"logs.log"}
    strip = {n for n in one | four if n.startswith("eval-submission-")}
    assert one - strip == four - strip


def test_pipeline_mesh_invariance(runs):
    _metrics_equal_one_rank(runs, "streaming")


def test_batch_runner_mesh_invariance(runs):
    _metrics_equal_one_rank(runs, "batch")


@pytest.mark.parametrize("name", ARTIFACTS)
def test_mesh_artifacts_equal_one_rank(runs, name):
    assert (runs.tmp / "four" / name).read_bytes() == (runs.tmp / "one" / name).read_bytes()


def test_mesh_writes_the_one_rank_files(runs):
    _same_files(runs, "")


def test_batch_runner_mesh_writes_the_one_rank_files(runs):
    _same_files(runs, "-batch")


@pytest.mark.parametrize("runner", ["", "-batch"])
@pytest.mark.parametrize("tname", TYPES)
def test_mesh_rankers_equal_one_rank(runs, runner, tname):
    """dp GBDT from one device's rows and bags: one device's trees."""
    name = f"ranker-gbdt-{tname}.npz"
    _npz_equal(runs.tmp / f"four{runner}" / name, runs.tmp / f"one{runner}" / name)


@pytest.mark.parametrize("name", BATCH_FILES)
def test_batch_runner_mesh_files_equal_one_rank(runs, name):
    """Pipeline(mesh=).run is the batch runner: C14's reports over every
    rank's batches in one device's order, the submission and its eval."""
    got = (runs.tmp / "four-batch" / name).read_bytes()
    assert got == (runs.tmp / "one-batch" / name).read_bytes()
    if name == "submission.csv":
        assert all(r["submission"] == got for r in runs.n)


def test_batch_runner_mesh_inference_only(runs):
    """The rerun without labels scores with the work dir's rankers and
    writes the labelled run's submission (and one rank's)."""
    assert all(r["inference"] == {} for r in runs.n)
    got = (runs.tmp / "four-batch" / "submission.csv").read_bytes()
    assert got == runs.n[0]["submission"]
    assert got == (runs.tmp / "one-batch" / "submission.csv").read_bytes()
    assert (runs.tmp / "four-batch" / "ranker-gbdt-clicks.npz").exists()


@pytest.mark.parametrize("case", ranks.PASS_A_CASES, ids=lambda c: f"data{c[0]}-{c[1]}")
def test_pass_a_rows_equal_one_rank(runs, case):
    """pass_a on 4 and on 2 data ranks draws one device's negatives (numpy:
    the one-device rng moved to each batch's draws; device selection: the
    generator seeded by the global batch index): rows, reports and
    metrics are one rank's."""
    n_data, sel = case
    got_dir = Path(ranks.pass_a_dir(str(runs.tmp), n_data, sel))
    want_dir = Path(ranks.pass_a_dir(str(runs.tmp), 1, sel))
    for r in runs.n:
        assert r["pass_a"][case] == runs.pass_a[sel]
    for tname in TYPES:
        _npz_equal(got_dir / f"downsampled-{tname}.npz", want_dir / f"downsampled-{tname}.npz")
    for name in PASS_A_FILES:
        assert (got_dir / name).read_bytes() == (want_dir / name).read_bytes()


# ---------------------------------------------------------------------------
# the CLI (tests/test_mesh_stages.py)
# ---------------------------------------------------------------------------
def test_parse_mesh_spec():
    assert cli.parse_mesh_spec(None) is None
    assert cli.parse_mesh_spec("") is None
    assert cli.parse_mesh_spec("data=4") == {"data_parallel": 4, "model_parallel": 1}
    assert cli.parse_mesh_spec("data=4,model=2") == {"data_parallel": 4, "model_parallel": 2}
    assert cli.parse_mesh_spec("model=2") == {"data_parallel": -1, "model_parallel": 2}
    with pytest.raises(ValueError):
        cli.parse_mesh_spec("rows=2")
    with pytest.raises(ValueError):
        cli.parse_mesh_spec("data")


@pytest.mark.parametrize("mesh,want", [("data=2", 2), ("data=2,model=2", 4), ("model=2", 2)])
def test_build_mesh_names_both_sizes(mesh, want):
    """One process has world size 1: a larger mesh raises, naming both."""
    with pytest.raises(ValueError, match=f"wants {want} ranks but the world size is 1"):
        cli.build_mesh(argparse.Namespace(mesh=mesh, device="cpu"))


@pytest.mark.parametrize("mesh", [None, "data=1", "data=1,model=1", "data=-1"])
def test_build_mesh_single_device_runs_unsharded(mesh):
    assert cli.build_mesh(argparse.Namespace(mesh=mesh, device="cpu")) is None


def test_cli_mesh_run_synthetic(tmp_path):
    """`run-synthetic --mesh data=2` under torchrun: two CPU ranks run the
    whole pipeline and rank 0 prints the metrics once."""
    env = torch_threads.child_env(PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         "2", "-m", "otto_tpu_torch.pipeline.cli", "run-synthetic", "--tiny", "--device",
         "cpu", "--mesh", "data=2", "--sessions", "400", "--aids", "300",
         "--batch-sessions", "64", "--work-dir", str(tmp_path / "work")],
        capture_output=True, text=True, env=env, cwd=str(tmp_path), timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    metrics = json.loads(out.stdout)
    assert metrics["ceiling_total"] > 0.2
    assert metrics["total"] > 0.05


def test_cli_world_size_mismatch_fails(tmp_path):
    env = torch_threads.child_env(PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         "2", "-m", "otto_tpu_torch.pipeline.cli", "run-synthetic", "--tiny", "--device",
         "cpu", "--mesh", "data=4", "--sessions", "50", "--work-dir", str(tmp_path / "w")],
        capture_output=True, text=True, env=env, cwd=str(tmp_path), timeout=300)
    assert out.returncode != 0
    assert "wants 4 ranks but the world size is 2" in out.stderr


# ---------------------------------------------------------------------------
# failures end the run
# ---------------------------------------------------------------------------
def test_dead_rank_and_oversized_mesh_fail(tmp_path):
    with pytest.raises(Exception, match="rank 1 dies"):
        spawn_ranks(ranks.fail_on_rank_one, 2, args=(str(tmp_path),), device="cpu",
                    threads=torch_threads.THREADS, store_path=str(tmp_path / "store"))
    for r in range(2):
        assert (tmp_path / f"rank{r}.txt").read_text() == "mesh 4x1 != 2 devices"


def test_failed_process_group_start_raises(tmp_path):
    with pytest.raises(Exception):
        distributed.init_distributed("cpu", backend="no-such-backend", rank=0, world_size=1,
                                     store_path=str(tmp_path / "store"))
    assert not torch.distributed.is_initialized()


def test_single_process_is_a_no_op(monkeypatch):
    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.init_distributed("cpu") is None
    assert not torch.distributed.is_initialized()


def test_model_axis_stays_on_one_host():
    """global_mesh's rule: model_parallel divides the ranks of a host (one
    here) before any mesh is made."""
    with pytest.raises(ValueError, match="must divide local device count 1"):
        distributed.global_mesh(2)


# ---------------------------------------------------------------------------
# a mesh's device is the caller's, never a quiet switch
# ---------------------------------------------------------------------------
MISMATCHES = [("cuda", "cpu"), ("cpu", "cuda:0"), ("cuda:1", "cuda:0")]


@pytest.mark.parametrize("device,mesh_device", MISMATCHES)
@pytest.mark.parametrize("entry", ["Pipeline", "run_streaming", "build_retriever"])
def test_device_other_than_the_mesh_raises(tmp_path, entry, device, mesh_device):
    """A stage given a mesh on one device and `device` naming another
    raises before any work (a rank started on the card would otherwise run
    on the mesh's CPU with `device` still reading "cuda")."""
    from otto_tpu_torch.pipeline import runner

    mesh = types.SimpleNamespace(device=torch.device(mesh_device), is_main=True)
    ev = ranks.ev_of({k: np.zeros(0, np.int64) for k in ("session", "aid", "ts", "type")})
    with pytest.raises(ValueError, match="is not the mesh's device"):
        if entry == "Pipeline":
            Pipeline(cfg=ranks.pipeline_cfg(), work_dir=str(tmp_path), n_aids=10,
                     device=device, mesh=mesh)
        elif entry == "run_streaming":
            runner.run_streaming(ev, ev, None, 10, str(tmp_path), device, mesh=mesh)
        else:
            runner.build_retriever(ev, ev, 10, device, mesh=mesh)
    assert not any(tmp_path.iterdir())   # nothing written


@pytest.mark.parametrize("device,mesh_device", [("cpu", "cpu"), ("cuda", "cuda:0"),
                                                ("cuda:0", "cuda:0")])
def test_device_of_the_mesh_accepted(device, mesh_device):
    from otto_tpu_torch.pipeline.runner import check_mesh_device

    check_mesh_device(device, types.SimpleNamespace(device=torch.device(mesh_device)))


def test_make_mesh_defaults_to_the_started_device(tmp_path):
    """make_mesh() takes the device init_distributed started the rank on;
    for a process group started otherwise, the current CUDA device, never
    the CPU on its own (here, without a card: an error)."""
    import torch.distributed as dist

    from otto_tpu_torch.parallel.mesh import make_mesh

    distributed.init_distributed("cpu", rank=0, world_size=1,
                                 store_path=str(tmp_path / "store1"))
    try:
        assert make_mesh().device == torch.device("cpu")
        assert distributed.global_mesh().device == torch.device("cpu")
    finally:
        dist.destroy_process_group()
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store2"), 1),
                            rank=0, world_size=1)
    try:
        if torch.cuda.is_available():
            assert make_mesh().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                make_mesh()
        assert make_mesh(device="cpu").device == torch.device("cpu")
    finally:
        dist.destroy_process_group()


def test_backend_follows_the_device():
    assert distributed.pick_backend("cpu") == "gloo"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            distributed.rank_device("cuda", "nccl")
