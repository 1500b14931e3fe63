"""Atomic, asynchronous checkpoints in the JAX package's on-disk layout.

Layout:  <dir>/step_<N>/
           manifest.json       — keys, shapes, dtypes, step, extra
           shard_0.npz         — every leaf (one host), "/" in keys as "|"
         <dir>/LATEST          — atomically updated pointer

The torch counterpart of ``repro.train.checkpoint.CheckpointManager``: a
tree is flattened to the keys JAX gives it (dict keys sorted, a NamedTuple's
fields by name, ``None`` left out), so a checkpoint written by either
package restores through the other.  Each step is written to
``.tmp-step_<N>`` and ``os.replace``d; the copy to host memory is
synchronous, the file I/O runs on a writer thread; the ``keep`` newest steps
are retained and stale temporary directories of crashed writers swept.
``restore`` loads into the tensors of the tree it is given, in place, one
leaf at a time: at full width a second copy of the state would not fit the
card.  Under FSDP rank 0 writes the leaves whole (gathered), and on restore
each rank keeps its shard of each (``restore``'s ``shard``).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

SEP = "/"
_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.float16: "float16", torch.int32: "int32",
                torch.int64: "int64"}


def flatten_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(key, leaf) pairs in JAX's flattening order."""
    join = (lambda k: f"{prefix}{SEP}{k}") if prefix else str
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in flatten_with_paths(tree[k], join(k))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [kv for k, v in zip(tree._fields, tree)
                for kv in flatten_with_paths(v, join(k))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in flatten_with_paths(v, join(i))]
    if tree is None:
        return []
    return [(prefix, tree)]


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(array, dtype name); bfloat16 as its raw uint16 bits (npz has none)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), _DTYPE_NAMES.get(t.dtype, str(t.numpy().dtype))


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_write: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree, extra: Optional[Dict] = None) -> str:
        self.wait()                       # one in-flight write at a time
        flat = flatten_with_paths(tree)
        arrays: Dict[str, np.ndarray] = {}
        dtypes: Dict[str, str] = {}
        for k, v in flat:                 # device -> host now
            arrays[k], dtypes[k] = _to_numpy(v)
        manifest = {
            "step": step,
            "keys": [k for k, _ in flat],
            "shapes": {k: list(a.shape) for k, a in arrays.items()},
            "dtypes": dtypes,
            "extra": extra or {},
        }

        def write():
            final = os.path.join(self.dir, f"step_{step:08d}")
            tmp = os.path.join(self.dir, f".tmp-step_{step:08d}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            np.savez(os.path.join(tmp, "shard_0.npz"),
                     **{k.replace("/", "|"): v for k, v in arrays.items()})
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f, sort_keys=True, allow_nan=False)
            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)
            lat_tmp = os.path.join(self.dir, ".LATEST.tmp")
            with open(lat_tmp, "w") as f:
                f.write(os.path.basename(final))
            os.replace(lat_tmp, os.path.join(self.dir, "LATEST"))
            self._gc()
            self._clean_stale_tmp()

        if self.async_write:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()
        return os.path.join(self.dir, f"step_{step:08d}")

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = sorted(d for d in os.listdir(self.dir)
                       if d.startswith("step_"))
        for d in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    def _clean_stale_tmp(self) -> None:
        """Remove ``.tmp-step_*`` leftovers from writers that crashed
        mid-save (the completed ``os.replace`` means none belong to us)."""
        for d in sorted(os.listdir(self.dir)):
            if d.startswith(".tmp-step_"):
                shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    # --------------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        lat = os.path.join(self.dir, "LATEST")
        if not os.path.exists(lat):
            return None
        with open(lat) as f:
            name = f.read().strip()
        if not os.path.isdir(os.path.join(self.dir, name)):
            return None
        return int(name.split("_")[1])

    def restore(self, tree, step: Optional[int] = None,
                shard: Optional[Callable[[str, torch.Tensor],
                                         torch.Tensor]] = None
                ) -> Tuple[Any, Dict]:
        """Load step ``step`` (default: the latest) into the tensors of
        ``tree``, in place (each keeps its device and dtype), one leaf at a
        time; ``shard(key, leaf)``, if given, is the part of each whole
        leaf that ``tree`` holds.  Returns (tree, manifest)."""
        self.wait()
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoint under {self.dir}")
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(d, "shard_0.npz")) as data, \
                torch.no_grad():
            files = set(data.files)
            for key, like in flatten_with_paths(tree):
                name = key.replace("/", "|")
                if name not in files:
                    raise KeyError(f"checkpoint missing leaf {key!r}")
                arr = data[name]
                if manifest["dtypes"].get(key) == "bfloat16" \
                        and arr.dtype == np.uint16:
                    t = torch.from_numpy(arr.view(np.int16)).view(
                        torch.bfloat16)
                else:
                    t = torch.from_numpy(np.array(arr))     # 0-d kept 0-d
                if shard is not None:
                    t = shard(key, t)
                if tuple(t.shape) != tuple(like.shape):
                    raise ValueError(f"leaf {key!r}: checkpoint shape "
                                     f"{arr.shape} != {tuple(like.shape)}")
                like.copy_(t)
        return tree, manifest
