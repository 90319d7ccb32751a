"""Checkpoint / resume for model params and optimizer state (orbax-backed).

The reference is stateless benchmark binaries — it has nothing to checkpoint
(SURVEY.md section 5.4) — but a serving/training framework needs durable
state: save/restore of the param pytree (+ optimizer state + step counter),
resumable across process restarts and usable under a sharded mesh (orbax
restores to the sharding of a provided abstract template).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import jax

try:  # optional: training and serving run without it; checkpointing needs it
    import orbax.checkpoint as ocp

    _HAS_ORBAX = True
except Exception:  # pragma: no cover - exercised only without orbax
    _HAS_ORBAX = False


def _config_to_dict(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    # dtypes are not JSON-serializable; store the canonical name
    for key, val in d.items():
        if hasattr(val, "dtype") or str(val).startswith("<class 'jax"):
            d[key] = str(val)
    if "dtype" in d:
        import jax.numpy as jnp

        d["dtype"] = jnp.dtype(cfg.dtype).name
    return d


def save_checkpoint(
    path: str,
    params: Any,
    *,
    step: int = 0,
    opt_state: Any = None,
    config=None,
) -> str:
    """Write an atomic checkpoint directory: params (+ opt_state) via orbax,
    config + step as JSON sidecars. Returns the checkpoint path."""
    if not _HAS_ORBAX:
        raise RuntimeError(
            "checkpointing needs the orbax-checkpoint package, which is "
            "not installed"
        )
    path = os.path.abspath(path)
    ckptr = ocp.StandardCheckpointer()
    # params and opt_state are SEPARATE items so a params-only restore (the
    # serving case) works against a checkpoint written during training
    ckptr.save(os.path.join(path, "params"), params, force=True)
    if opt_state is not None:
        ckptr.save(os.path.join(path, "opt_state"), opt_state, force=True)
    ckptr.wait_until_finished()
    meta = {"step": int(step)}
    if config is not None:
        meta["config"] = _config_to_dict(config)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    return path


def restore_checkpoint(
    path: str,
    *,
    params_template: Any | None = None,
    opt_state_template: Any | None = None,
) -> dict:
    """Restore {params, opt_state?, step, config?} from `path`.

    Templates (abstract or concrete pytrees) drive dtype/shape/sharding of
    the restored arrays: pass pytrees of jax.ShapeDtypeStruct with shardings
    to restore directly into a mesh layout. Without a template, orbax
    restores with the saved metadata on the default device."""
    if not _HAS_ORBAX:
        raise RuntimeError(
            "checkpointing needs the orbax-checkpoint package, which is "
            "not installed"
        )
    path = os.path.abspath(path)
    ckptr = ocp.StandardCheckpointer()

    def _template(t):
        if t is None or _is_abstract(t):
            return t
        return jax.tree.map(ocp.utils.to_shape_dtype_struct, t)

    out = {
        "params": ckptr.restore(
            os.path.join(path, "params"), _template(params_template)
        )
    }
    opt_dir = os.path.join(path, "opt_state")
    if os.path.exists(opt_dir):
        out["opt_state"] = ckptr.restore(
            opt_dir, _template(opt_state_template)
        )
    meta_path = os.path.join(path, "meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        out["step"] = meta.get("step", 0)
        if "config" in meta:
            out["config"] = meta["config"]
    return out


def _is_abstract(tree: Any) -> bool:
    leaves = jax.tree.leaves(tree)
    return bool(leaves) and isinstance(leaves[0], jax.ShapeDtypeStruct)
