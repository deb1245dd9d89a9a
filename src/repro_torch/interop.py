"""State carried across from the reference package, as numpy arrays.

The port imports nothing of ``repro``; a caller that holds both reads
the reference's state into numpy (uint32 words, Python ints) and hands
it here:

* :func:`directory_from_state` installs per-edge session keys, the epoch
  and the managed counters into a port :class:`KeyDirectory`, so the
  port seals and opens under the reference's keys;
* :func:`window_from_numpy` / :func:`window_to_numpy` move a sealed
  window across, so a window sealed in one package opens in the other;
* :func:`lm_params_from_numpy` turns the reference's LM parameter pytree
  into the port's, so both packages serve the same weights.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.attest.directory import KeyDirectory, SessionState
from repro_torch.core.enclave import SealedWindow
from repro_torch.crypto.keys import StageKey
from repro_torch.models.api import param_template
from repro_torch.models.layers import ParamSpec
from repro_torch.u32 import from_numpy, to_numpy


def directory_from_state(sessions: Mapping[str, Mapping[int, np.ndarray]],
                         *, epoch: int = 0,
                         counters: Optional[Mapping[str, int]] = None,
                         transcripts: Optional[Mapping[str, bytes]] = None,
                         epoch_history: int = 8) -> KeyDirectory:
    """A port KeyDirectory holding the given sessions.

    ``sessions``: ``{edge: {epoch: (8,) uint32 key words}}``; each edge
    is live at ``epoch`` with its managed counter at ``counters[edge]``
    (0 by default).  ``transcripts`` (the handshake transcripts) let
    :meth:`KeyDirectory.advance_epoch` ratchet exactly as the reference
    does.  Stage ids follow the edges' order, as the pipeline numbers
    its edges."""
    d = KeyDirectory(epoch_history=epoch_history)
    d.epoch = int(epoch)
    for sid, (edge, keys) in enumerate(sessions.items()):
        st = SessionState(
            edge=edge, left=f"{edge}/left", right=f"{edge}/right",
            transcript=b"" if transcripts is None else transcripts[edge],
            epoch=int(epoch),
            chunks=0 if counters is None else int(counters.get(edge, 0)),
            keys={int(e): StageKey(key=np.asarray(k, np.uint32)
                                   .view(np.int32).copy(), stage_id=sid)
                  for e, k in keys.items()})
        st.key_at(st.epoch)                 # the live epoch must be there
        d._sessions[edge] = st
    return d


def window_from_numpy(words: np.ndarray, tags: Optional[np.ndarray],
                      counters: Sequence[int], epochs: Sequence[int],
                      meta: Tuple, device="cuda") -> SealedWindow:
    """A port :class:`SealedWindow` from (B, n_words) uint32 words and
    (B, 2) uint32 tags (None in plain mode), per-row counters and
    epochs, and the reference's framing ``meta`` (shape, dtype, pad)."""
    words = np.asarray(words)
    item_shape, dtype, pad = meta
    return SealedWindow(
        words=from_numpy(words, device),
        tags=None if tags is None else from_numpy(tags, device),
        counters=[int(c) for c in counters],
        epochs=[int(e) for e in epochs],
        meta=(tuple(int(s) for s in item_shape), str(dtype), int(pad)),
        n_words=int(words.shape[1]))


def window_to_numpy(win: SealedWindow) -> Dict[str, object]:
    """The inverse: ``{"words", "tags", "counters", "epochs", "meta"}``
    with uint32 arrays, ready for the reference's ``SealedWindow``."""
    return {"words": to_numpy(win.words),
            "tags": None if win.tags is None else to_numpy(win.tags),
            "counters": list(win.counters), "epochs": list(win.epochs),
            "meta": win.meta}


def _tensor_from_numpy(a: np.ndarray, what: str, device) -> torch.Tensor:
    if a.dtype.name == "bfloat16" and a.dtype.itemsize == 2:
        # ml_dtypes' bfloat16 (numpy has no bf16 of its own): the same 16
        # bits through an int16 view, exact, without importing ml_dtypes
        return torch.from_numpy(a.view(np.int16).copy()) \
            .view(torch.bfloat16).to(device)
    if a.dtype == np.float32:
        return torch.from_numpy(a.copy()).to(device)
    raise ValueError(f"{what}: expected bfloat16 or float32, got {a.dtype}")


def lm_params_from_numpy(tree: Mapping, cfg, device="cuda") -> Dict:
    """The reference's parameter pytree (nested dicts of numpy arrays, as
    ``jax.tree.map(np.asarray, params)`` gives them) -> the port's params
    for ``cfg``, same keys, same stacked ``(L, ...)`` layer layout.

    bf16 leaves (``ml_dtypes.bfloat16``, which ``torch.from_numpy``
    refuses) cross bit for bit through an ``int16`` view and come out as
    ``torch.bfloat16``; f32 leaves stay f32.  Every key and shape must be
    the port template's (:func:`repro_torch.models.api.param_template`)."""
    def walk(spec, node, path):
        if isinstance(spec, ParamSpec):
            a = np.asarray(node)
            if tuple(a.shape) != spec.shape:
                raise ValueError(f"{path}: shape {a.shape}, the template "
                                 f"says {spec.shape}")
            return _tensor_from_numpy(a, path, device)
        if not isinstance(node, Mapping) or set(node) != set(spec):
            got = sorted(node) if isinstance(node, Mapping) else type(node)
            raise ValueError(f"{path or 'params'}: keys {got}, the template "
                             f"has {sorted(spec)}")
        return {k: walk(spec[k], node[k], f"{path}/{k}") for k in spec}
    return walk(param_template(cfg), tree, "")
