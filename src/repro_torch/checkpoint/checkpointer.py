"""Sharded, async, two-phase-commit checkpointing (the reference's
``repro.checkpoint.checkpointer``, same files on disk).

  * 2PC (§4.3): a checkpoint is written to ``step_N.tmp-*`` (Prepare), then
    committed by one atomic directory rename (Commit). A crash between the
    phases leaves only tmp garbage, which restore ignores.
  * group commit: one manifest covers every array of the shard; the commit
    is one rename whatever the number of arrays.
  * ``hot_update_order`` persistence (§5.3): the journal records the
    monotone step order; restore reads the latest *committed* entry, and a
    crash during restore is idempotent.

Arrays are stored as one ``shard_{host}.npz`` plus ``manifest.json``, one
array a leaf in the reference's leaf order (:func:`repro_torch.tree.leaves`:
sorted dict keys, NamedTuple fields in order, a layer group's repeats in
index order). numpy has no bfloat16, so a bf16 leaf is stored as its
uint16 bits and the manifest's ``dtypes`` names it; restore reads it back
bit for bit. (The reference stores such a leaf as numpy dtype ``V2`` and
cannot restore it.) Files of f32, integer and int8 leaves restore in either
package.

Sharded state: a DTensor leaf is saved whole (gathered on every rank: each
rank calls ``save``, and only the one built with ``writer=True`` writes),
and restored into the placement of its ``like`` leaf, the reference's
``device_put(val, ref.sharding)``.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Optional

import numpy as np
import torch

from .. import tree
from ..device import is_dtensor, resolve
from .journal import Journal


def _to_host(x) -> tuple[np.ndarray, str]:
    """A leaf as (a numpy copy to store, its dtype's name); a DTensor is
    gathered whole first (a collective)."""
    if isinstance(x, torch.Tensor):
        t = (x.full_tensor() if is_dtensor(x) else x).detach().to("cpu")
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16).copy(), \
                "bfloat16"
        return t.numpy().copy(), str(t.dtype).removeprefix("torch.")
    a = np.array(x)
    return a, a.dtype.name


def _from_host(arr: np.ndarray, dtype_name: Optional[str]) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


class Checkpointer:
    def __init__(self, directory: str, host_id: int = 0, async_save=True,
                 writer: bool = True):
        self.dir = directory
        self.host_id = host_id
        self.writer = writer        # False: save gathers, writes nothing
        os.makedirs(directory, exist_ok=True)
        self.journal = Journal(os.path.join(directory, "journal.jsonl"))
        self._pool = ThreadPoolExecutor(max_workers=1) if async_save else None
        self._pending: Optional[Future] = None

    # ------------------------------------------------------------- save
    def save(self, step: int, tree_: Any, blocking: bool = False):
        """Two-phase save; async unless ``blocking``. The leaves are copied
        to the host before this returns."""
        host = [_to_host(x) for x in tree.leaves(tree_)]
        if not self.writer:
            return
        order = self.journal.assign(step)

        def work():
            final = os.path.join(self.dir, f"step_{step:08d}")
            tmp = tempfile.mkdtemp(prefix=f"step_{step:08d}.tmp-",
                                   dir=self.dir)
            try:
                np.savez(os.path.join(tmp, f"shard_{self.host_id}.npz"),
                         *(a for a, _ in host))
                manifest = {
                    "step": step,
                    "order": order,
                    "n_leaves": len(host),
                    "hosts": 1,
                    "dtypes": [d for _, d in host],
                }
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f)
                    f.flush()
                    os.fsync(f.fileno())
                # ---- Commit phase: single atomic rename ----
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)
                self.journal.commit(step, order)
            except Exception:
                shutil.rmtree(tmp, ignore_errors=True)
                raise

        if self._pool is not None and not blocking:
            self.wait()                       # keep commit order (dep list)
            self._pending = self._pool.submit(work)
        else:
            self.wait()
            work()

    def wait(self):
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    # ---------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        return self.journal.latest_committed()

    def restore(self, step: Optional[int], like: Any, device=None) -> Any:
        """Restore into the structure of ``like`` (a tree of tensors): each
        leaf at its ``like`` leaf's dtype, on that leaf's device, or on
        ``device`` when one is named (resolved as every entry point does:
        "cuda" needs the card); a DTensor ``like`` leaf gets its placement.
        ``step`` None takes the latest committed one."""
        dev = None if device is None else resolve(device)
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError("no committed checkpoint")
        final = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(final, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(final, f"shard_{self.host_id}.npz")) as d:
            arrays = [d[k] for k in d.files]
        dtypes = manifest.get("dtypes", [None] * len(arrays))
        like_leaves = tree.leaves(like)
        if len(arrays) != len(like_leaves):
            raise ValueError(f"checkpoint has {len(arrays)} leaves, "
                             f"expected {len(like_leaves)}")
        out = []
        for arr, name, ref in zip(arrays, dtypes, like_leaves):
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"checkpoint leaf of shape {arr.shape}, "
                                 f"expected {tuple(ref.shape)}")
            val = _from_host(arr, name).to(device=dev or ref.device,
                                           dtype=ref.dtype)
            if is_dtensor(ref):
                from torch.distributed.tensor import distribute_tensor
                val = distribute_tensor(val, ref.device_mesh, ref.placements,
                                        src_data_rank=None)
            out.append(val)
        return tree.unflatten(like, out)

    def gc(self, keep: int = 3):
        steps = self.journal.committed_steps()
        for s in steps[:-keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)
