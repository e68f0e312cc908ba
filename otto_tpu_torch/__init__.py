"""otto_tpu_torch — the otto_tpu session recommender on PyTorch and CUDA.

A port of `otto_tpu` (JAX on a TPU) to PyTorch on an NVIDIA H100, module
by module under the same paths. `otto_tpu` stays the reference: every
ported module is tested against it on the same inputs. The port imports
`torch` and never `jax`, and nothing of `otto_tpu` either: the host layer
the serving path reads (`config`, `data.{schema,batching,split}`,
`eval.recall`) has its counterparts here, held equal to otto_tpu's by
tests, and `data.synthetic` generates sessions on the device.

Ported so far: the per-session serving path — retrieval (Stages A-E),
GBDT scoring, top-20 selection, the submission file and recall@20 — with
two hand-written CUDA kernels: K1 `ops/kernels/gather.py` (row gather)
and K2 `ops/kernels/segscan.py` (segmented scan), built from `csrc/` at
first use. The table-building stages and training are still otto_tpu's;
their numpy output crosses over through `otto_tpu_torch.convert`.
"""

__version__ = "0.1.0"
