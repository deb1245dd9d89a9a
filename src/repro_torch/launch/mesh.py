"""The deployment mesh (port of ``repro/launch/mesh.py``).

The reference's production mesh is a TPU v5e pod, 16 x 16 chips (or two
pods, 2 x 16 x 16).  The port runs on one card: its production mesh is
that card, shape (1, 1) with the reference's axes ("data", "model"),
built with :func:`repro_torch.dist.meshctx.make_mesh`.  Functions, not
constants, so that importing this module touches no device.
"""
from __future__ import annotations

from repro_torch.dist.meshctx import Mesh, make_mesh, make_smoke_mesh

__all__ = ["make_production_mesh", "make_smoke_mesh"]


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    """The one card's mesh: shape (1, 1), axes ("data", "model")."""
    if multi_pod:
        raise ValueError(
            "make_production_mesh: the reference's multi-pod layout (2 x 16 "
            "x 16, axes pod/data/model) waits for a multi-card "
            "torch.distributed configuration; the port's dist/ is "
            "single-process and its production mesh is one card")
    return make_mesh((1, 1), ("data", "model"), device)
