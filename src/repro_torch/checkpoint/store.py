"""Checkpointing for federated state, ported from ``repro/checkpoint/store.py``.

npz-based with a JSON manifest; atomic writes (tmp + rename) for BOTH
payloads and the manifest, so a crash at any instant leaves the store
loadable: a partial tmp file is ignored on read, and a manifest entry
whose payload never landed is skipped by :meth:`CheckpointStore.latest`.
Retains the last ``keep`` round checkpoints per tag.  Site checkpoints
store the stacked tree once (not S copies of the global model) — exactly
what the FL round state is.

Crash-resumable socket jobs (``FederatedJob.run(resume=True)``) layer on
top: the driver keeps a store at ``checkpoint_dir`` (the "global" tag, and
the aggregation server's per-site ``downref{i}``) and each site keeps its
own sub-store at ``checkpoint_dir/site{i}``: independent manifests, so
concurrently crashing writers never corrupt each other.  The resume round
is the newest round present in *every* participating store (see
``repro_torch.api``); :meth:`load` fetches an exact round,
:meth:`saved_rounds` enumerates what survived.

Trees are the port's nested dicts and lists (:mod:`repro_torch.tree`);
tensor leaves are saved from the host, and loads return numpy leaves.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.tree import tree_map, tree_unflatten


def _host(leaf) -> np.ndarray:
    if hasattr(leaf, "detach"):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten_with_paths(tree, prefix: str = "", out=None, leaf=_host) -> Dict[str, Any]:
    """Path-keyed leaves in flatten order (dict keys sorted, lists in order)."""
    out = {} if out is None else out
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten_with_paths(tree[k], f"{prefix}/{k}" if prefix else str(k), out, leaf)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten_with_paths(v, f"{prefix}/{i}" if prefix else str(i), out, leaf)
    else:
        out[prefix] = leaf(tree)
    return out


def save_pytree(path: Path, tree: Any):
    """Atomic npz save of a pytree (flat path-keyed arrays + treedef).

    Writes through an explicit file handle — ``np.savez`` given a *name*
    appends ``.npz``, which previously forced rename juggling that could
    pick the wrong candidate; a handle writes exactly where told.  The
    tmp file lands in the target directory so ``os.replace`` is a
    same-filesystem atomic rename; a crash inside the write window
    leaves only a ``*.tmp`` dropping that readers never look at.
    """
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    flat = _flatten_with_paths(tree)
    treedef = repr(tree_map(lambda _: None, tree))
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, __treedef__=np.frombuffer(treedef.encode(),
                                                  dtype=np.uint8), **flat)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_pytree(path: Path, like: Any) -> Any:
    """Load into the structure of ``like`` (leaf order = like's paths)."""
    data = np.load(path)
    paths = _flatten_with_paths(like, leaf=lambda _: None)
    return tree_unflatten(like, [data[p] for p in paths])


def _atomic_write_text(path: Path, text: str):
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


class CheckpointStore:
    """Round-indexed checkpoint directory with a manifest.

    Thread-safe for concurrent saves from one process (the aggregation
    server checkpoints from a connection thread while the driver owns
    the same store).  Cross-process writers must use distinct roots —
    see the per-site sub-stores in ``repro_torch.api``.
    """

    def __init__(self, root: Path, keep: int = 3):
        self.root = Path(root)
        self.keep = keep
        self.root.mkdir(parents=True, exist_ok=True)
        self.manifest_path = self.root / "manifest.json"
        self.manifest: Dict[str, Any] = {"rounds": {}}
        self._lock = threading.Lock()
        if self.manifest_path.exists():
            self.manifest = json.loads(self.manifest_path.read_text())

    def save(self, tag: str, round_index: int, tree: Any,
             meta: Optional[dict] = None):
        with self._lock:
            fn = self.root / f"{tag}_round{round_index:06d}.npz"
            save_pytree(fn, tree)
            rounds = self.manifest["rounds"].setdefault(tag, [])
            # a re-save of the same round (server ckpt grid meeting the
            # final explicit save) replaces its entry instead of growing
            rounds[:] = [r for r in rounds if r["round"] != round_index]
            rounds.append({"round": round_index, "file": fn.name,
                           "meta": meta or {}})
            # retention
            while len(rounds) > self.keep:
                old = rounds.pop(0)
                old_fn = self.root / old["file"]
                if old_fn.exists():
                    old_fn.unlink()
            _atomic_write_text(self.manifest_path,
                               json.dumps(self.manifest, indent=2))

    def _records(self, tag: str) -> List[dict]:
        """Manifest records whose payload actually exists on disk — an
        entry whose file was lost to a crash window is skipped, not
        raised on."""
        return [rec for rec in self.manifest["rounds"].get(tag, [])
                if (self.root / rec["file"]).exists()]

    def saved_rounds(self, tag: str) -> List[int]:
        return sorted(rec["round"] for rec in self._records(tag))

    def latest(self, tag: str, like: Any):
        recs = self._records(tag)
        if not recs:
            return None, -1
        rec = max(recs, key=lambda r: r["round"])
        return load_pytree(self.root / rec["file"], like), rec["round"]

    def meta(self, tag: str, round_index: int) -> dict:
        """A checkpoint's manifest metadata without loading its payload —
        resume paths validate the ``engine`` tag here before committing
        to a structure-shaped load."""
        for rec in self._records(tag):
            if rec["round"] == round_index:
                return rec.get("meta", {})
        raise KeyError(f"no checkpoint for tag {tag!r} round {round_index} "
                       f"in {self.root}")

    def load(self, tag: str, round_index: int, like: Any
             ) -> Tuple[Any, dict]:
        """Load the checkpoint for an exact round; returns (tree, meta)."""
        for rec in self._records(tag):
            if rec["round"] == round_index:
                return (load_pytree(self.root / rec["file"], like),
                        rec.get("meta", {}))
        raise KeyError(f"no checkpoint for tag {tag!r} round {round_index} "
                       f"in {self.root}")
