"""Mesh contexts: logical-axis sharding rules resolved against a mesh.

Port of ``repro/dist/meshctx.py``.  A :class:`Mesh` is the named axis
sizes in the reference's order plus the one device every shard lives on
(the port runs W workers of an axis on one card); :func:`make_mesh` is
the counterpart of ``jax.make_mesh`` and :func:`make_smoke_mesh` of the
reference's ``launch/mesh.py``.  A :class:`MeshContext` bundles a mesh
with the MaxText-style rules of
:class:`repro_torch.configs.base.ShardingConfig` and answers "how is this
tensor laid out?".  Resolution semantics (``spec_for``), the reference's:

* each logical dim maps to a tuple of candidate mesh axes, tried in order;
* axes missing from the mesh are skipped (a single-pod mesh simply ignores
  the ``pod`` axis in a ``("pod", "data")`` rule);
* eligible axes are accumulated greedily while their combined size still
  divides the dim — ``("data", "model")`` over a 16x16 mesh shards a
  256-row batch 256 ways as the tuple entry ``("data", "model")``;
* an axis is never used twice within one spec (first dim wins, later dims
  replicate);
* if no candidate divides the dim: under ``strict`` (or
  ``allow_uneven=False``) the dim replicates; otherwise the first free
  candidate is used anyway and the ragged shard is padded.

``spec_for`` returns the tuple of entries that ``tuple(PartitionSpec)``
gives in the reference.  The reference's ``sharding`` (a
``NamedSharding``) has no counterpart: one device holds every shard.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

SpecEntry = Union[None, str, Tuple[str, ...]]


@dataclass(frozen=True)
class Mesh:
    """Named worker axes (``shape``: axis -> size, in order) whose shards
    all live on ``device``."""

    shape: Dict[str, int]
    device: torch.device

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)


def _device(device) -> torch.device:
    """``device`` with its index (a CUDA device without one is the
    current device), so it compares equal to its tensors' device."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device="cuda") -> Mesh:
    """The counterpart of ``jax.make_mesh(shape, axes)``: W = prod(shape)
    workers, all on ``device``."""
    if len(shape) != len(axes) or len(set(axes)) != len(axes):
        raise ValueError(f"make_mesh: shape {tuple(shape)} and distinct "
                         f"axes {tuple(axes)} must pair up")
    if any(int(s) < 1 for s in shape):
        raise ValueError(f"make_mesh: axis sizes must be >= 1, got "
                         f"{tuple(shape)}")
    return Mesh({a: int(s) for a, s in zip(axes, shape)}, _device(device))


def make_smoke_mesh(n: int = 1, device="cuda") -> Mesh:
    """A small ("data", "model") mesh of ``n`` workers (tests/examples)."""
    model = 2 if n % 2 == 0 else 1
    return make_mesh((n // model, model), ("data", "model"), device)


def check_on_mesh(what: str, x: torch.Tensor, mesh: Mesh) -> None:
    """Refuse a tensor that is not on the mesh's device (nothing moves
    between devices unless the caller moves it)."""
    if x.device != mesh.device:
        raise ValueError(f"{what}: tensor on {x.device}, the mesh's shards "
                         f"live on {mesh.device}")


@dataclass
class MeshContext:
    """A mesh plus the logical-axis -> mesh-axis sharding rules.

    Deliberately *not* frozen: callers (shape overrides, tests) re-point
    ``rules`` at a per-shape variant of the base rule set.
    """

    mesh: Mesh
    rules: Dict[str, Tuple[str, ...]]
    allow_uneven: bool = True

    # ------------------------------------------------------- introspection

    def axis_size(self, name: str) -> int:
        """Size of a mesh axis; absent axes count as 1 (unsharded)."""
        return int(self.mesh.shape.get(name, 1))

    @property
    def dp_axes(self) -> Tuple[str, ...]:
        """The pure data-parallel axes present in this mesh."""
        return tuple(a for a in ("pod", "data") if a in self.mesh.shape)

    # ---------------------------------------------------------- resolution

    def spec_for(self, dims: Sequence[Optional[str]],
                 shape: Sequence[int], *, strict: bool = False
                 ) -> Tuple[SpecEntry, ...]:
        """Resolve logical dim names against the mesh -> one entry a dim
        (None, an axis name, or a tuple of axis names)."""
        if len(dims) != len(shape):
            raise ValueError(f"spec_for: {len(dims)} dim names for shape "
                             f"{tuple(shape)}")
        used: set = set()
        return tuple(self._resolve_dim(name, int(dim), used, strict)
                     for name, dim in zip(dims, shape))

    def _resolve_dim(self, name: Optional[str], dim: int, used: set,
                     strict: bool) -> SpecEntry:
        if name is None:
            return None
        candidates = self.rules.get(name, ())
        group: list = []
        prod = 1
        for ax in candidates:
            if ax not in self.mesh.shape or ax in used or ax in group:
                continue
            size = self.axis_size(ax)
            if dim % (prod * size) == 0:
                group.append(ax)
                prod *= size
        if not group and self.allow_uneven and not strict:
            # divisibility fallback: the ragged last shard is padded
            group = [ax for ax in candidates
                     if ax in self.mesh.shape and ax not in used][:1]
        if not group:
            return None
        used.update(group)
        return group[0] if len(group) == 1 else tuple(group)

    # --------------------------------------------------------- conveniences

    def constrain(self, x: torch.Tensor,
                  dims: Sequence[Optional[str]]) -> torch.Tensor:
        """The reference's ``with_sharding_constraint`` by logical dim
        names: a checked identity, since one device holds every shard."""
        check_on_mesh("constrain", x, self.mesh)
        self.spec_for(dims, x.shape)
        return x


def local_mesh_context(n_devices: int = 0, rules=None,
                       allow_uneven: bool = True, device="cuda"
                       ) -> MeshContext:
    """A smoke-mesh context (tests/examples): ``n_devices`` workers (one
    when 0: the port's one device) on ``device``."""
    from repro_torch.configs.base import ShardingConfig

    if rules is None:
        rules = ShardingConfig().lookup()
    return MeshContext(mesh=make_smoke_mesh(n_devices or 1, device),
                       rules=dict(rules), allow_uneven=allow_uneven)
