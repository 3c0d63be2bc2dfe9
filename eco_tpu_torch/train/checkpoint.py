"""Snapshot / restore -- the .caffemodel/.solverstate equivalent.

Twin of ``eco_tpu/train/checkpoint.py``, writing the same files: the learned
net and the solver state (Solver::Snapshot, solver.cpp:522-546),

- ``<prefix>_iter_N.model.npz``  -- params + BN state (deployable alone)
- ``<prefix>_iter_N.solverstate.npz`` -- history + iter (+ model path)

as flat ``layer/param`` npz keys (``/`` and ``%`` in names escaped as
``%2F`` and ``%25``), with every weight in the reference's layout
(``convert/bridge.py``).  So a snapshot written by either package loads in
the other.  ``restore_weights`` is the name-based multi-file transfer init
(``--weights=a.npz,b.npz``, Net::CopyTrainedLayersFrom): later files win on
name collisions, missing layers keep their values, shape mismatches raise.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Mapping, Sequence

import numpy as np

from eco_tpu_torch.convert.bridge import params_from_jax, params_to_jax


def _esc(name: str) -> str:
    """Escape the key separator: Caffe layer names may contain '/'
    (e.g. 'conv1/7x7_s2' in stock BN-Inception prototxts)."""
    return name.replace("%", "%25").replace("/", "%2F")


def _unesc(name: str) -> str:
    return name.replace("%2F", "/").replace("%25", "%")


def _flatten(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{_esc(k)}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, key + "/"))
        else:
            out[key] = np.asarray(v)
    return out


def _unflatten(flat: Mapping[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        parts = [_unesc(p) for p in key.split("/")]
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _subtree(flat: Mapping[str, np.ndarray], prefix: str) -> dict:
    return _unflatten({k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)})


def _device_of(tree: Mapping):
    for lp in tree.values():
        for v in lp.values():
            return v.device
    return "cuda"


def save_model(path: str, params, state) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    jp, js = params_to_jax(None, params, state)
    flat = {f"params/{k}": v for k, v in _flatten(jp).items()}
    flat.update({f"state/{k}": v for k, v in _flatten(js).items()})
    np.savez(path, **flat)


def load_model(path: str, *, device="cuda"):
    """(params, state) as tensors on ``device``, in this package's layout."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    return params_from_jax(None, _subtree(flat, "params/"), _subtree(flat, "state/"),
                           device=device)


def snapshot(prefix: str, train_state, it: int) -> tuple[str, str]:
    """Write model + solver state at iteration ``it``; returns both paths."""
    model_path = f"{prefix}_iter_{it}.model.npz"
    solver_path = f"{prefix}_iter_{it}.solverstate.npz"
    save_model(model_path, train_state.params, train_state.state)
    os.makedirs(os.path.dirname(solver_path) or ".", exist_ok=True)
    history, _ = params_to_jax(None, train_state.history, {})
    flat = {f"history/{k}": v for k, v in _flatten(history).items()}
    flat["iter"] = np.asarray(int(it), np.int64)
    flat["__manifest__"] = np.frombuffer(
        json.dumps({"learned_net": os.path.basename(model_path)}).encode(), np.uint8
    )
    np.savez(solver_path, **flat)
    return model_path, solver_path


def restore(solver_path: str, train_state):
    """Resume from a .solverstate (Solver::Restore, solver.cpp:549-560) onto
    the device of ``train_state``'s params."""
    with np.load(solver_path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    manifest = json.loads(bytes(flat.pop("__manifest__").tobytes()).decode())
    it = int(flat.pop("iter"))
    device = _device_of(train_state.params)
    history, _ = params_from_jax(None, _subtree(flat, "history/"), {}, device=device)
    model_path = os.path.join(os.path.dirname(solver_path), manifest["learned_net"])
    params, state = load_model(model_path, device=device)
    return dataclasses.replace(train_state, params=params, state=state,
                               history=history, it=it)


def restore_weights(paths: str | Sequence[str], params, state):
    """Name-based transfer from one or more model files (comma list ok).

    Matches layers by name like CopyTrainedLayersFrom; layers absent from the
    files keep their current (random) values -- how the reference initializes
    ECO from the 2D + 3D pretrained caffemodels.
    """
    if isinstance(paths, str):
        paths = [p for p in paths.split(",") if p]
    new_params = {k: dict(v) for k, v in params.items()}
    new_state = {k: dict(v) for k, v in state.items()}
    loaded_layers = set()
    device = _device_of(params)
    for path in paths:
        p, s = load_model(path, device=device)
        for lname, lp in p.items():
            if lname in new_params:
                for pname, v in lp.items():
                    cur = new_params[lname][pname]
                    if tuple(v.shape) != tuple(cur.shape):
                        raise ValueError(
                            f"{path}: layer {lname}/{pname} shape {tuple(v.shape)} "
                            f"!= model {tuple(cur.shape)}"
                        )
                    new_params[lname][pname] = v
                loaded_layers.add(lname)
        for lname, ls in s.items():
            if lname in new_state:
                for sname, v in ls.items():
                    new_state[lname][sname] = v
    return new_params, new_state, sorted(loaded_layers)
