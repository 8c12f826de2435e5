"""Checkpoint / resume for the engine carry.

The reference has no persistence at all (SURVEY.md §5.4) — its state dies
with the Stabilizer instance.  Here the carry is already an explicit pytree
of arrays, so checkpointing is a flat serialization: every leaf to one
``.npz`` entry, restored onto device with the same treedef.  Works for
single-stream, vmapped multi-stream, and (leaves re-sharded by the caller)
mesh-sharded carries.

Leaves are keyed by their **pytree path** (e.g. ``.frames``,
``.orb_ref.desc``), not position: adding a field to ``EngineCarry`` in a
later version must not silently shift older checkpoints' leaves against the
template (load matches by name, fills fields missing from the checkpoint
from the template, and warns about both directions of drift).
"""

from __future__ import annotations

import json
import warnings

import jax
import numpy as np

from video_stabilization.engine.state import EngineCarry


def _leaf_paths(tree):
    """(path_string, leaf) pairs via jax's keypath API."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(path), leaf) for path, leaf in flat]


def save_carry(path: str, carry: EngineCarry) -> None:
    """Serialize a carry pytree to ``path`` (.npz), leaves keyed by name."""
    arrays = {}
    meta = []
    for i, (name, leaf) in enumerate(_leaf_paths(carry)):
        if hasattr(leaf, "dtype") and "key" in str(leaf.dtype):
            # typed PRNG keys serialize via their raw uint32 data
            arrays[f"leaf_{i}"] = np.asarray(jax.random.key_data(leaf))
            meta.append({"kind": "prng_key", "name": name})
        else:
            arrays[f"leaf_{i}"] = np.asarray(leaf)
            meta.append({"kind": "array", "name": name})
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8
    )
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrays)


def load_carry(path: str, template: EngineCarry) -> EngineCarry:
    """Restore a carry saved by :func:`save_carry`.

    ``template`` (e.g. a fresh ``init_carry``) provides the treedef and
    target shapes; shape mismatches (different config) raise.  Fields the
    checkpoint lacks (older engine version) keep the template's value with a
    warning; extra checkpoint fields are ignored with a warning.
    """
    data = np.load(path)
    meta = json.loads(bytes(data["__meta__"]).decode())
    t_flat, treedef = jax.tree_util.tree_flatten_with_path(template)

    if meta and isinstance(meta[0], str):
        # pre-naming format: positional kinds only.  Refuse on any layout
        # drift instead of silently zipping leaves against the wrong fields.
        if len(meta) != len(t_flat):
            raise ValueError(
                f"checkpoint {path} is from an older engine version "
                f"({len(meta)} leaves, current carry has {len(t_flat)}); "
                "positional restore would misalign fields — re-create it "
                "with the current version"
            )
        entries = {
            f"leaf_{i}": {"kind": kind, "name": jax.tree_util.keystr(p)}
            for i, (kind, (p, _)) in enumerate(zip(meta, t_flat))
        }
    else:
        entries = {f"leaf_{i}": m for i, m in enumerate(meta)}

    by_name = {m["name"]: (key, m["kind"]) for key, m in entries.items()}
    leaves = []
    for p, t_leaf in t_flat:
        name = jax.tree_util.keystr(p)
        if name not in by_name:
            warnings.warn(
                f"checkpoint {path} has no entry for carry field {name} "
                "(saved by an older engine version); keeping the fresh "
                "template value for it"
            )
            leaves.append(t_leaf)
            continue
        key, kind = by_name.pop(name)
        arr = data[key]
        if kind == "prng_key":
            leaves.append(jax.random.wrap_key_data(jax.numpy.asarray(arr)))
        else:
            if tuple(arr.shape) != tuple(t_leaf.shape):
                raise ValueError(
                    f"checkpoint field {name} shape {tuple(arr.shape)} != "
                    f"config shape {tuple(t_leaf.shape)}"
                )
            leaves.append(jax.numpy.asarray(arr, t_leaf.dtype))
    for name in by_name:
        warnings.warn(
            f"checkpoint {path} field {name} does not exist in this engine "
            "version; ignored"
        )
    return jax.tree_util.tree_unflatten(treedef, leaves)
