"""Carry JAX weights into the port.

The port's parameter names follow the JAX parameter tree, so the map is
mechanical: the tree's path joined by ``.`` is the state_dict key, with
three leaf renames:

  * ``kernel`` -> ``weight``: a dense (in, out) kernel transposed to
    (out, in), a convolution's HWIO kernel to torch's OIHW;
  * ``scale`` (LayerNorm, GroupNorm) -> ``weight``;
  * ``embedding`` (Embed) -> ``weight``.

``decoder/layers_3/cross_attn/key/kernel`` thus becomes
``decoder.layers_3.cross_attn.key.weight``. A reference PyTorch checkpoint
(vit_pytorch and ``nn.TransformerDecoder`` names) comes in through
``tools/convert_torch_checkpoint.convert_state_dict`` (to the JAX tree),
then :func:`state_dict_from_jax`.

Only numpy and zipfile are used: no JAX is needed to read a ``params.npz``
(``/``-joined keys, as ``videocad_tpu/infer/export.py`` writes it) or the
``params.npz`` and ``config.json`` inside a ``.vcdx`` artifact.
"""

from __future__ import annotations

import io
import json
import zipfile
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

_LEAF_RENAMES = {"kernel": "weight", "scale": "weight", "embedding": "weight"}
# The models' flax ``Embed`` modules (VideoCADFormer's, the decision
# transformer's): their 2-D ``weight`` is an ``embedding``, not a kernel.
_EMBED_MODULES = ("timestep_embedding", "embed_timestep")


def _walk(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _walk(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def state_dict_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """JAX param tree (nested dicts of arrays) -> the port's state_dict."""
    out = {}
    for path, leaf in _walk(tree):
        arr = np.asarray(leaf, dtype=np.float32)
        name = path[-1]
        if name == "kernel":
            if arr.ndim == 2:
                arr = arr.T
            elif arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)       # HWIO -> OIHW
            else:
                raise ValueError(f"{'/'.join(path)}: expected a 2-D or 4-D "
                                 f"kernel, got shape {arr.shape}")
        key = ".".join(path[:-1] + (_LEAF_RENAMES.get(name, name),))
        if key in out:
            raise ValueError(f"two JAX leaves map to {key}")
        out[key] = torch.from_numpy(np.array(arr, order="C"))
    return out


def jax_tree_from_state_dict(state_dict: Mapping[str, torch.Tensor]
                             ) -> Dict[str, Any]:
    """The inverse of :func:`state_dict_from_jax`, to numpy: a state_dict
    (or any name -> tensor map of that layout, such as the gradients) ->
    the JAX tree of float32 arrays. A ``weight`` becomes ``kernel``
    when it is 2-D (transposed) or 4-D (OIHW -> HWIO), ``scale`` when it
    is 1-D, and ``embedding`` when its module is one of the models' flax
    ``Embed`` modules (``_EMBED_MODULES``)."""
    return unflatten(flat_jax_params(state_dict))


def flat_jax_params(state_dict: Mapping[str, torch.Tensor]
                    ) -> Dict[str, np.ndarray]:
    """:func:`jax_tree_from_state_dict` flattened by ``/``-joined tree
    paths: the keys of a JAX ``params.npz``."""
    flat = {}
    for key, value in state_dict.items():
        arr = value.detach().to(torch.float32).cpu().numpy()
        *path, name = key.split(".")
        if name == "weight":
            if path and path[-1] in _EMBED_MODULES:
                name = "embedding"
            elif arr.ndim == 2:
                name, arr = "kernel", arr.T
            elif arr.ndim == 4:
                name, arr = "kernel", arr.transpose(2, 3, 1, 0)
            else:
                name = "scale"
        flat["/".join(path + [name])] = np.array(arr, order="C")
    return flat


def unflatten(flat: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    """``/``-joined keys -> nested dicts (``export._unflatten_params``)."""
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        node = tree
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return tree


def _read_npz(data) -> Dict[str, Any]:
    with np.load(data, allow_pickle=False) as npz:
        return unflatten({k: npz[k] for k in npz.files})


def load_jax_params(path: str) -> Tuple[Dict[str, Any], Optional[Dict]]:
    """Read JAX weights: a ``params.npz`` of ``/``-joined keys, or a
    ``.vcdx`` artifact (a zip holding ``params.npz`` and ``config.json``).

    Returns (param tree, model config dict or None).
    """
    # A plain .npz is itself a zip, of .npy members.
    with zipfile.ZipFile(path) as zf:
        names = set(zf.namelist())
        if "params.npz" in names:
            tree = _read_npz(io.BytesIO(zf.read("params.npz")))
            config = (json.loads(zf.read("config.json"))
                      if "config.json" in names else None)
            return tree, config
    return _read_npz(path), None
