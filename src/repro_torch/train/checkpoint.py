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
card.  Sharded (``save_leaves``), the leaves come one at a time, each
gathered whole by every rank together, and rank 0 hands each host copy to
the writer thread through a queue a few leaves deep (no rank ever holds
the whole state; the last leaves are written while training goes on); on
restore each rank keeps its shard of each (``restore``'s ``shard``).
"""
from __future__ import annotations

import itertools
import json
import os
import queue
import shutil
import threading
import zipfile
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

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
    LEAVES_IN_FLIGHT = 4        # host copies queued for the writer thread

    def __init__(self, directory: str, keep: int = 3, async_write: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree, extra: Optional[Dict] = None) -> str:
        self.wait()                       # one in-flight write at a time
        flat = [(k, _to_numpy(v)) for k, v in flatten_with_paths(tree)]
        if self.async_write:              # device -> host now, files later
            self._thread = threading.Thread(
                target=self._write, args=(step, flat, extra), daemon=True)
            self._thread.start()
        else:
            self._write(step, flat, extra)
        return os.path.join(self.dir, f"step_{step:08d}")

    def save_leaves(self, step: int,
                    leaves: Iterable[Tuple[str, Optional[torch.Tensor]]],
                    extra: Optional[Dict] = None,
                    write: bool = True) -> Optional[str]:
        """Write the (key, whole leaf) pairs of ``leaves`` as they come: each
        leaf's host copy goes to the writer thread through a queue of
        ``LEAVES_IN_FLIGHT`` leaves (synchronously without ``async_write``),
        so that host memory holds a few leaves and the writes overlap the
        next gathers; ``write`` False (the ranks that only take part in the
        gathers): iterate, write nothing, return None."""
        self.wait()
        if not write:
            for _ in leaves:
                pass
            return None
        flat = ((k, _to_numpy(v)) for k, v in leaves)
        if not self.async_write:
            self._write(step, flat, extra)
        else:
            q: queue.Queue = queue.Queue(maxsize=self.LEAVES_IN_FLIGHT)

            def drain():
                while (item := q.get()) is not None:
                    yield item
            self._thread = threading.Thread(
                target=self._write, args=(step, drain(), extra), daemon=True)
            self._thread.start()
            for item in itertools.chain(flat, [None]):
                while True:
                    try:
                        q.put(item, timeout=1.0)
                        break
                    except queue.Full:
                        if not self._thread.is_alive():
                            raise RuntimeError(f"checkpoint step {step}: "
                                               f"the writer thread died")
        return os.path.join(self.dir, f"step_{step:08d}")

    def _write(self, step: int, flat, extra: Optional[Dict]) -> None:
        """The npz (members written one at a time, as ``np.savez`` writes
        them), then the manifest, ``os.replace`` and ``LATEST``."""
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = os.path.join(self.dir, f".tmp-step_{step:08d}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        keys, shapes, dtypes = [], {}, {}
        with zipfile.ZipFile(os.path.join(tmp, "shard_0.npz"), "w",
                             compression=zipfile.ZIP_STORED,
                             allowZip64=True) as zf:
            for k, (arr, dtype) in flat:
                keys.append(k)
                shapes[k], dtypes[k] = list(arr.shape), dtype
                with zf.open(k.replace("/", "|") + ".npy", "w",
                             force_zip64=True) as f:
                    np.lib.format.write_array(f, np.asanyarray(arr),
                                              allow_pickle=False)
                del arr
        manifest = {"step": step, "keys": keys, "shapes": shapes,
                    "dtypes": dtypes, "extra": extra or {}}
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
