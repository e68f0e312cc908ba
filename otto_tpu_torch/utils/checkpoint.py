"""Checkpoint / resume for training state.

Counterpart of otto_tpu/utils/checkpoint.py. The state is a dict of
named tensors (a torch.Generator's state is one: `get_state()`), written
with `torch.save` beside a step counter and an optional JSON-able `meta`
fingerprint. A checkpoint that does not fit the caller's template (other
names or shapes) or its expected meta is discarded with a warning, not
restored: one written under another vocabulary would otherwise index
tables of the wrong size.
"""
from __future__ import annotations

import json
import logging
import os
import tempfile
from typing import Dict, Optional, Tuple

import torch

log = logging.getLogger(__name__)

State = Dict[str, torch.Tensor]


def save_checkpoint(path: str, state: State, step: int,
                    meta: Optional[dict] = None) -> None:
    """Atomically write `state` (copied to the CPU), `step` and `meta`:
    the file appears complete or not at all."""
    payload = {
        "state": {k: v.detach().cpu() for k, v in state.items()},
        "step": int(step),
        "meta": None if meta is None else json.dumps(meta, sort_keys=True),
    }
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    os.close(fd)
    try:
        torch.save(payload, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_checkpoint(path: str, like: State,
                    expect_meta: Optional[dict] = None) -> Optional[Tuple[State, int]]:
    """-> (state on the devices of `like`'s tensors, step), or None when
    there is no file, or it is discarded: its tensors differ from `like`'s
    in number, names or shapes, or its meta from `expect_meta`."""
    if not os.path.exists(path):
        return None
    z = torch.load(path, map_location="cpu", weights_only=True)
    got = z["state"]
    if len(got) != len(like) or set(got) != set(like):
        log.warning("checkpoint %s discarded: tensors %s stored, %s expected",
                    path, sorted(got), sorted(like))
        return None
    for k, want in like.items():
        if tuple(got[k].shape) != tuple(want.shape):
            log.warning("checkpoint %s discarded: %s shape %s != expected %s",
                        path, k, tuple(got[k].shape), tuple(want.shape))
            return None
    if expect_meta is not None:
        stored = None if z["meta"] is None else json.loads(z["meta"])
        want_meta = json.loads(json.dumps(expect_meta, sort_keys=True))
        if stored != want_meta:
            log.warning("checkpoint %s discarded: meta %s != expected %s",
                        path, stored, want_meta)
            return None
    return {k: got[k].to(like[k].device) for k in like}, int(z["step"])
