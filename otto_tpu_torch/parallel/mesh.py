"""The (data, model) mesh over torch.distributed ranks.

Counterpart of otto_tpu/parallel/mesh.py. otto_tpu lays one jax Mesh over
the devices of a single controller and shards arrays onto it; the port
runs one process per device (SPMD), each running the same program on its
own share, and a MeshContext tells a rank where it sits:

  data  - sessions, events, query rows and ranker groups split over ranks;
  model - rows of the word2vec tables split over ranks.

Ranks are laid out row-major: rank = data_rank * n_model + model_rank. The
data group joins the ranks of one model column, the model group those of
one data row. otto_tpu's shardings become plain helpers: `data_slice` (this
rank's contiguous share of a leading axis), `gather_data` (the shares back
in rank order) and `gather_varlen` / `gather_arrays` (rows of any count per
rank). Every collective runs on the tensors' own device: NCCL or gloo, no
host copy on the way; host arrays gathered under gloo stay on the host.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass
class MeshContext:
    """A rank's view of the mesh: `mesh` the DeviceMesh with dims
    (data_axis, model_axis), `device` the torch device this rank runs on."""

    mesh: object   # torch.distributed.device_mesh.DeviceMesh
    device: torch.device
    data_axis: str = "data"
    model_axis: str = "model"

    @property
    def n_data(self) -> int:
        return self.mesh.size(0)

    @property
    def n_model(self) -> int:
        return self.mesh.size(1)

    @property
    def n_devices(self) -> int:
        return self.mesh.size()

    @property
    def data_rank(self) -> int:
        return self.mesh.get_local_rank(self.data_axis)

    @property
    def model_rank(self) -> int:
        return self.mesh.get_local_rank(self.model_axis)

    @property
    def data_group(self):
        return self.mesh.get_group(self.data_axis)

    @property
    def model_group(self):
        return self.mesh.get_group(self.model_axis)

    @property
    def is_main(self) -> bool:
        """Rank 0 of the world: the one that writes files and prints."""
        return dist.get_rank() == 0

    def data_slice(self, n: int, rank: Optional[int] = None) -> slice:
        """A data rank's contiguous share of n rows: near-equal slices in
        rank order, the first n % n_data ranks one row longer."""
        return split_slice(n, self.n_data, self.data_rank if rank is None else rank)

    def gather_data(self, t: torch.Tensor, async_op: bool = False):
        """The data ranks' equal-shape tensors concatenated on dim 0 in rank
        order (all_gather over the data group; as bytes, so any dtype).
        With async_op, a function that waits for the gather and returns
        it: the caller goes on while it runs."""
        return gather_equal(t, self.data_group, self.n_data, async_op)

    def gather_varlen(self, t: torch.Tensor) -> torch.Tensor:
        """gather_data for tensors whose leading dims differ by rank (one
        host sync for the lengths)."""
        return gather_varlen(t, self.data_group, self.n_data)

    def gather_arrays(self, *arrays) -> List[np.ndarray]:
        """Host arrays or tensors of any row count per data rank -> each
        concatenated over the data ranks in rank order, as host arrays on
        every rank (with one data rank they are the gather). They travel
        on this rank's device under NCCL, through the host, where they
        end, under gloo."""
        if self.n_data == 1:
            return [_host(a) for a in arrays]
        return [gather_varlen(_on(a, self._travel()), self.data_group, self.n_data)
                .cpu().numpy() for a in arrays]

    def _travel(self):
        return self.device if dist.get_backend(self.data_group) == "nccl" else "cpu"

    def gather_arrays_to_first(self, *arrays) -> Optional[List[np.ndarray]]:
        """gather_arrays received by data rank 0 alone; the other ranks get
        None; they travel as gather_arrays's do."""
        if self.n_data == 1:
            return [_host(a) for a in arrays]
        got = [gather_varlen(_on(a, self._travel()), self.data_group, self.n_data, dst=0)
               for a in arrays]
        return None if self.data_rank else [g.cpu().numpy() for g in got]

    def all_sum(self, t: torch.Tensor, group=None) -> torch.Tensor:
        """In-place SUM all-reduce over the data group (or `group`)."""
        dist.all_reduce(t, group=self.data_group if group is None else group)
        return t

    def all_max(self, t: torch.Tensor, group=None) -> torch.Tensor:
        dist.all_reduce(t, op=dist.ReduceOp.MAX,
                        group=self.data_group if group is None else group)
        return t


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _on(a, device) -> torch.Tensor:
    if not torch.is_tensor(a):
        a = torch.from_numpy(np.ascontiguousarray(a))
    return a.to(device)


def split_slice(n: int, parts: int, i: int) -> slice:
    """Part i of n rows cut into `parts` contiguous near-equal slices."""
    q, r = divmod(n, parts)
    lo = i * q + min(i, r)
    return slice(lo, lo + q + (1 if i < r else 0))


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A tensor's elements as a flat uint8 tensor (a view where it can be)."""
    if not t.numel():
        return torch.empty(0, dtype=torch.uint8, device=t.device)
    return t.contiguous().reshape(-1).view(torch.uint8)


def gather_equal(t: torch.Tensor, group, n: int, async_op: bool = False):
    """The n ranks' equal-shape tensors concatenated on dim 0 in rank order
    (all_gather; as bytes, so any dtype); with async_op, a function that
    waits for it and returns that."""
    raw = _bytes(t)
    out = [torch.empty_like(raw) for _ in range(n)]
    work = dist.all_gather(out, raw, group=group, async_op=async_op)

    def result() -> torch.Tensor:
        if work is not None:
            work.wait()
        return torch.cat([o.view(t.dtype).view(t.shape) for o in out])

    return result if async_op else result()


def gather_varlen(t: torch.Tensor, group, n: int, dst: Optional[int] = None
                  ) -> Optional[torch.Tensor]:
    """All-gather of tensors whose dim 0 differs by rank -> concatenated in
    rank order. Rows travel as bytes (padded to the longest), so every
    dtype goes through gloo and NCCL alike. With `dst` (a rank of the
    group) only that rank receives them (dist.gather); the others get
    None."""
    t = t.contiguous()
    rows = torch.tensor([t.shape[0]], dtype=torch.int64, device=t.device)
    sizes = [torch.empty_like(rows) for _ in range(n)]
    dist.all_gather(sizes, rows, group=group)
    sizes = [int(s) for s in sizes]
    row_bytes = int(np.prod(t.shape[1:], dtype=np.int64)) * t.element_size()
    raw = _bytes(t)
    buf = torch.zeros(max(sizes) * row_bytes, dtype=torch.uint8, device=t.device)
    buf[:raw.numel()] = raw
    if dst is None:
        out = [torch.empty_like(buf) for _ in range(n)]
        dist.all_gather(out, buf, group=group)
    else:
        out = [torch.empty_like(buf) for _ in range(n)] \
            if dist.get_rank(group) == dst else None
        dist.gather(buf, out, dst=dist.get_global_rank(group, dst), group=group)
        if out is None:
            return None
    parts = [o[:s * row_bytes].view(t.dtype).view(s, *t.shape[1:])
             for o, s in zip(out, sizes)]
    return torch.cat(parts)


# (the world group, the device init_distributed started this rank on)
_started_on: Optional[tuple] = None


def set_rank_device(device: torch.device) -> None:
    """Record the device this rank's process group was started for."""
    global _started_on
    _started_on = (dist.group.WORLD, torch.device(device))


def rank_device_default() -> torch.device:
    """This rank's device when the caller names none: the one
    init_distributed started the current process group on, else the
    current CUDA device (raises without a card: the port never picks the
    CPU on its own)."""
    from otto_tpu_torch.device import resolve

    if _started_on is not None and _started_on[0] is dist.group.WORLD:
        return _started_on[1]
    return resolve("cuda")


def make_mesh(
    data_parallel: int = -1,
    model_parallel: int = 1,
    device=None,
    data_axis: str = "data",
    model_axis: str = "model",
) -> MeshContext:
    """A (data, model) mesh over every rank of the initialised process
    group (init_distributed first). data_parallel = -1 means every rank the
    model axis leaves; a 1x1 mesh is valid. `device`: this rank's device
    (default: the one init_distributed started this rank on, else the
    current CUDA device, whatever the backend)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call init_distributed first")
    n = dist.get_world_size()
    if data_parallel == -1:
        if n % model_parallel != 0:
            raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
        data_parallel = n // model_parallel
    if data_parallel * model_parallel != n:
        raise ValueError(f"mesh {data_parallel}x{model_parallel} != {n} devices")
    nccl = dist.get_backend() == "nccl"
    device = rank_device_default() if device is None else torch.device(device)
    if nccl and device.type != "cuda":
        raise ValueError(f"make_mesh: an NCCL mesh needs a CUDA device, not {device}")
    mesh = init_device_mesh("cuda" if nccl else "cpu", (data_parallel, model_parallel),
                            mesh_dim_names=(data_axis, model_axis))
    return MeshContext(mesh=mesh, device=torch.device(device), data_axis=data_axis,
                       model_axis=model_axis)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m

