"""Checkpoint / resume for MPC-stack state — aux-subsystem parity.

The reference has nothing to persist (SURVEY.md §5: deterministic in-place
transforms); this framework's long-running artifacts are controller setups
(condensed-QP factors), solver warm starts, and rollout snapshots. Saved as
a flat ``.npz`` of pytree leaves + a structural manifest — dependency-free,
portable across hosts; `orbax` can layer on top for multi-host async saves
when running on pods.

Structure validation: compatibility is checked against
a **manifest** of leaf count, per-leaf key paths (``jax.tree_util.keystr``
— container keys/indices, so same-shaped trees with different keys are
rejected), and per-leaf shapes/dtypes — never against ``str(treedef)``
(whose repr changes across JAX versions). The manifest is read from
ATTRIBUTES only (``.shape``/``.dtype``), so validating against a large
on-device template costs no device→host transfer and ``like`` may be a
``jax.eval_shape`` skeleton. Pre-r4 checkpoints (treedef-string format)
keep their original exact-string check.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import jax

__all__ = ["save_pytree", "load_pytree"]


def _leaf_spec(l):
    shape = getattr(l, "shape", None)
    dtype = getattr(l, "dtype", None)
    if shape is None or dtype is None:  # plain python scalar leaf
        arr = np.asarray(l)
        shape, dtype = arr.shape, arr.dtype
    return {"shape": [int(d) for d in shape], "dtype": str(dtype)}


def _manifest(tree):
    """(paths, specs) from attributes only — no device transfer."""
    path_leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    paths = [jax.tree_util.keystr(p) for p, _ in path_leaves]
    specs = [_leaf_spec(l) for _, l in path_leaves]
    return paths, specs


def save_pytree(path: str, tree: Any) -> None:
    """Persist any pytree of arrays (controller, warm-start, trajectory)."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    arrays = {f"leaf_{i}": np.asarray(l) for i, l in enumerate(leaves)}
    paths, specs = _manifest(tree)
    meta = json.dumps(
        {
            "nleaves": len(leaves),
            "paths": paths,
            "leaves": specs,
            "treedef": str(treedef),  # informational only
        }
    )
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    np.savez_compressed(
        path, __manifest__=np.frombuffer(meta.encode(), dtype=np.uint8), **arrays
    )


def load_pytree(path: str, like: Any) -> Any:
    """Restore a pytree saved by :func:`save_pytree`; ``like`` supplies the
    tree structure (arrays or a ``jax.eval_shape`` skeleton). Raises
    ``ValueError`` when the saved leaf count, any key path, or any leaf's
    shape/dtype does not match ``like``'s structure."""
    data = np.load(path, allow_pickle=False)
    like_leaves, treedef = jax.tree_util.tree_flatten(like)
    if "__manifest__" in data.files:
        meta = json.loads(bytes(data["__manifest__"]).decode())
        saved_n = meta["nleaves"]
        if saved_n != len(like_leaves):
            raise ValueError(
                f"checkpoint structure mismatch: saved {saved_n} leaves, "
                f"expected {len(like_leaves)}\n saved treedef: "
                f"{meta.get('treedef', '<unknown>')}\n expected: {treedef}"
            )
        want_paths, want_specs = _manifest(like)
        for i, (sp, wp) in enumerate(zip(meta.get("paths", want_paths), want_paths)):
            if sp != wp:
                raise ValueError(
                    f"checkpoint structure mismatch at leaf {i}: saved key "
                    f"path {sp!r}, expected {wp!r}"
                )
        for i, (s, w) in enumerate(zip(meta["leaves"], want_specs)):
            if s["shape"] != w["shape"] or s["dtype"] != w["dtype"]:
                raise ValueError(
                    f"checkpoint leaf {i} mismatch: saved "
                    f"{s['dtype']}{s['shape']}, expected {w['dtype']}{w['shape']}"
                )
    else:  # pre-r4 format: only leaf count is reliable — treedef REPRs
        # drift across JAX versions AND across library versions (e.g.
        # LinearMPC gained an aux field in r4), so a string mismatch with a
        # matching leaf count warns loudly instead of rejecting a
        # structurally-loadable checkpoint.
        saved_n = len([k for k in data.files if k.startswith("leaf_")])
        saved_def = (
            bytes(data["__treedef__"]).decode()
            if "__treedef__" in data.files
            else "<unknown>"
        )
        if saved_n != len(like_leaves):
            raise ValueError(
                f"checkpoint structure mismatch: saved {saved_n} leaves, "
                f"expected {len(like_leaves)}\n saved treedef: {saved_def}\n "
                f"expected: {treedef}"
            )
        if saved_def != str(treedef):
            import warnings

            warnings.warn(
                "pre-r4 checkpoint treedef repr differs from the template's "
                f"(saved: {saved_def!r}); loading by leaf position — verify "
                "the structures really correspond",
                stacklevel=2,
            )
        # Per-leaf shape/dtype check: the npz arrays carry both,
        # so a structurally different checkpoint with a matching leaf COUNT
        # must still be rejected rather than mis-assigning leaves.
        want_specs = [_leaf_spec(l) for l in like_leaves]
        for i, w in enumerate(want_specs):
            arr = data[f"leaf_{i}"]
            if list(arr.shape) != w["shape"] or str(arr.dtype) != w["dtype"]:
                raise ValueError(
                    f"checkpoint leaf {i} mismatch: saved "
                    f"{arr.dtype}{list(arr.shape)}, expected "
                    f"{w['dtype']}{w['shape']}"
                )
    leaves = [jax.numpy.asarray(data[f"leaf_{i}"]) for i in range(saved_n)]
    return jax.tree_util.tree_unflatten(treedef, leaves)
