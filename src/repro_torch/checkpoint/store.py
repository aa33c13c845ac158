"""Atomic, manifest-versioned checkpoints in the reference's layout
(twin of ``repro.checkpoint.store``; a checkpoint either package writes,
the other restores).

Layout:
    <dir>/step_<N:08d>/       leaf_<i:05d>.npy per leaf + manifest.msgpack
    <dir>/LATEST              text file: highest durable step

* **atomic**: leaves write into ``step_<N>.tmp``; the manifest is
  fsynced, then one ``os.rename`` publishes the step, and ``LATEST``
  goes through ``LATEST.tmp`` and ``os.replace``.  A stale ``.tmp``
  never shadows a published step.
* **template-keyed**: leaves are stored by their path string
  (``jax.tree_util.keystr``'s form, ``repro_torch.pytree``) and
  restored into a template tree: a missing leaf raises ``KeyError``, a
  shape that differs ``ValueError``.
* bf16 is stored as its ``uint16`` bits and ``float8_e4m3fn`` as its
  ``uint8`` bits, with the logical dtype in the manifest; a
  ``QLinear``'s fields are ordinary leaves.

The manifest is written and read by ``codec`` (the bytes of
``msgpack.packb``).  Leaves are indexed in the reference's flatten
order, so a tree of the reference's structure (``bridge.params_to_repro``)
gives the reference's files byte for byte.
"""
from __future__ import annotations

import os
import shutil
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch import pytree
from repro_torch.checkpoint.codec import packb, unpackb

Tree = Any

# numpy has no bf16: store the raw bits, the logical dtype in the manifest
# (logical dtype -> (torch view dtype, numpy view dtype))
_BITCAST = {torch.bfloat16: (torch.int16, np.uint16),
            torch.float8_e4m3fn: (torch.uint8, np.uint8)}
_BY_NAME = {"bfloat16": (torch.bfloat16, np.int16),
            "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8)}


def _dtype_name(t: torch.dtype) -> str:
    return str(t).removeprefix("torch.")


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    if not isinstance(leaf, torch.Tensor):
        arr = np.asarray(leaf)
        return arr, arr.dtype.name
    t = leaf.detach().contiguous().cpu()
    if t.dtype in _BITCAST:
        tv, nv = _BITCAST[t.dtype]
        return t.view(tv).numpy().view(nv), _dtype_name(t.dtype)
    return t.numpy(), _dtype_name(t.dtype)


def _from_numpy(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name in _BY_NAME:
        td, nv = _BY_NAME[dtype_name]
        return torch.from_numpy(arr.view(nv)).view(td)
    return torch.from_numpy(arr)


def _leafname(i: int) -> str:
    return f"leaf_{i:05d}.npy"


def save_checkpoint(ckpt_dir: str, step: int, tree: Tree,
                    extra: Optional[dict] = None) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    manifest = {"step": step, "extra": extra or {}, "leaves": []}
    for i, (path, leaf) in enumerate(pytree.leaves_with_path(tree)):
        arr, dtype_name = _to_numpy(leaf)
        np.save(os.path.join(tmp, _leafname(i)), arr)
        manifest["leaves"].append({
            "path": path,
            "file": _leafname(i),
            "shape": list(arr.shape),
            "dtype": dtype_name,
        })
    with open(os.path.join(tmp, "manifest.msgpack"), "wb") as f:
        f.write(packb(manifest))
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)

    latest_tmp = os.path.join(ckpt_dir, "LATEST.tmp")
    with open(latest_tmp, "w") as f:
        f.write(str(step))
        f.flush()
        os.fsync(f.fileno())
    os.replace(latest_tmp, os.path.join(ckpt_dir, "LATEST"))
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    p = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return int(f.read().strip())


def restore_checkpoint(ckpt_dir: str, template: Tree,
                       step: Optional[int] = None, device=None
                       ) -> Tuple[Tree, int]:
    """Restore into ``template``'s structure (its leaves give the paths
    and shapes; tensors on the ``meta`` device will do).  Each leaf goes
    to ``device``, by default its template tensor's device (the CPU for
    a ``meta`` or non-tensor template leaf), in the stored dtype."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.msgpack"), "rb") as f:
        manifest = unpackb(f.read())

    by_path = {e["path"]: e for e in manifest["leaves"]}
    out = []
    for key, tpl in pytree.leaves_with_path(template):
        if key not in by_path:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = np.load(os.path.join(d, by_path[key]["file"]))
        expect = tuple(getattr(tpl, "shape", arr.shape))
        if tuple(arr.shape) != expect:
            raise ValueError(f"shape mismatch at {key}: "
                             f"{arr.shape} vs {expect}")
        dev = device
        if dev is None:
            dev = (tpl.device if isinstance(tpl, torch.Tensor)
                   and tpl.device.type != "meta" else "cpu")
        out.append(_from_numpy(arr, by_path[key]["dtype"]).to(dev))
    return pytree.unflatten(template, out), step
