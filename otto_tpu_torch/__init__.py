"""otto_tpu_torch — the otto_tpu session recommender on PyTorch and CUDA.

A port of `otto_tpu` (JAX on a TPU) to PyTorch on an NVIDIA H100, module
by module under the same paths. `otto_tpu` stays the reference: every
ported module is tested against it on the same inputs. The port imports
`torch` and never `jax`, and nothing of `otto_tpu` either: the host layer
the serving path reads (`config`, `data.{schema,batching,split}`,
`eval.recall`) has its counterparts here, held equal to otto_tpu's by
tests, and `data.synthetic` generates sessions on the device.

Ported so far:
- the per-session serving path — retrieval (Stages A-E), GBDT scoring,
  top-20 selection, the submission file and recall@20 — on K1
  `ops/kernels/gather.py` (row gather) and K2 `ops/kernels/segscan.py`
  (segmented scan);
- the table build (`pipeline.runner.build_retriever`): co-visitation
  counting (`engine/covis.py`, torch sorts and scans on the device, the
  run merge on the host in C++ from `native/kmerge.cc`), SGNS word2vec
  training (`models/word2vec.py`, sampled on the device), item kNN tables
  on K3 `ops/kernels/mips.py` (exact top-k search), session embeddings
  on K4 `ops/kernels/dma_gather.py` (table row gather), k-means session
  clusters and cluster popularity (`engine/popularity.py`);
- the heuristic co-visitation baseline (`engine/baseline.py`);
- the training path (`pipeline.runner.pass_a`, `train_ranker_cached`,
  `run_streaming`): the label join, per-source retrieval eval and
  negative downsampling of pass A, and GBDT LambdaRank training of the
  three rankers (`models/gbdt.py`).
The four hand-written CUDA kernels are built from `csrc/` at first use.
otto_tpu's tables, models and rankers cross over through
`otto_tpu_torch.convert`.
"""

__version__ = "0.1.0"
